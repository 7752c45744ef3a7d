"""The downlink control kernels (csrc/pdcch_rx.cu) on the CPU.

The plain twins (``_pcfich_decode_plain``, ``_pdcch_extract_llr_plain``,
``_pdcch_blind_bits_plain``) equal the code they were before the kernels
and the public functions on the CPU, at 6, 25 and 100 PRB, 1, 2 and 4
ports, CFI 1-3 and both cyclic prefixes. The kernels' arithmetic, in
NumPy float32 on the tables the wrappers upload, reproduces the twins:
the PCFICH and the region's LLRs to float32 rounding (the complex
division rounds otherwise in PyTorch's CPU kernels) and the CFI exactly;
the de-rate-matching gather, the descrambling signs, the cached
candidates and the CRC16 by syndromes exactly. The wrappers refuse what
the kernels do not take, and a ``ue_dl_tm4_batch`` call's control ranges
hold nothing but the two launches. The kernels themselves run only on a
card, where ``chip_smoke.py --phases pdcch_rx`` holds them to the twins.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from empower_srslte_tpu_torch.models import dci as dci_mod
from empower_srslte_tpu_torch.models import pcfich, pdcch, ra, regs
from empower_srslte_tpu_torch.models.dci import format1_size
from empower_srslte_tpu_torch.models.enb_dl import enb_dl_tm4, tm4_draws
from empower_srslte_tpu_torch.models.pdsch import PdschConfig
from empower_srslte_tpu_torch.models.ue_dl import ue_dl_tm4_batch
from empower_srslte_tpu_torch.ops.equalizer import MimoType, eq_sfbc, \
    eq_sfbc_fstd
from empower_srslte_tpu_torch.ops.fec.convcoder import (TRAIN_LEN,
                                                        viterbi_decode_plain)
from empower_srslte_tpu_torch.ops.fec.rm_conv import rm_conv_rx
from empower_srslte_tpu_torch.ops.modem import Mod, demod_soft
from empower_srslte_tpu_torch.ops.scrambling import descramble_llrs
from empower_srslte_tpu_torch.runtime import trace
from empower_srslte_tpu_torch.utils.cell import CP, Cell
from empower_srslte_tpu_torch.utils.crc import CRC16
from empower_srslte_tpu_torch.utils.device import device_table
from empower_srslte_tpu_torch.utils.sequence import (cinit_pcfich,
                                                     cinit_pdcch)

from tests.torch_fake_launch import fake_launches

RNTI, SF_IDX, BATCH = 0x1234, 3, 2
#: (PRB, ports, CFI, CP) of the twin cases: every bandwidth, port count
#: and CFI, and the extended CP
CASES = [(prb, ports, cfi, CP.NORM) for prb in (6, 25, 100)
         for ports in (1, 2, 4) for cfi in (1, 2, 3)] \
    + [(25, 2, 2, CP.EXT), (6, 4, 3, CP.EXT)]
#: CPU ops that launch no kernel on a card (views, metadata, allocation)
NO_LAUNCH = {"aten::slice", "aten::view", "aten::select", "aten::reshape",
             "aten::as_strided", "aten::unsqueeze", "aten::expand",
             "aten::alias", "aten::detach", "aten::empty", "aten::unbind",
             "aten::squeeze", "aten::_reshape_alias", "aten::empty_strided"}


def _case_id(c):
    prb, ports, cfi, cp = c
    return f"{prb}prb_{ports}p_cfi{cfi}_{cp.value}"


def _stimulus(prb, ports, cfi, cp, snr_db=20.0, seed=0):
    """One PDCCH (format 1A at the first candidate of L 4 or less) and the
    PCFICH over a flat channel per port, with noise: -> (cell, grid
    [BATCH, S, K], h [BATCH, P, S, K], noise, the DCI bits)."""
    rng = np.random.default_rng(seed)
    cell = Cell(nof_prb=prb, nof_ports=ports, id=prb + ports + cfi, cp=cp)
    size = dci_mod.format0_1a_size(prb)
    bits = torch.as_tensor(rng.integers(0, 2, (BATCH, size)), dtype=torch.int8)
    n_cce = regs.pdcch_nof_cces(cell, cfi)
    l, cce = next(c for c in pdcch.ue_search_candidates(RNTI, SF_IDX, n_cce)
                  if c[0] <= 4)
    tx = torch.zeros((BATCH, ports, cell.nsymb_sf, cell.nof_re),
                     dtype=torch.complex64)
    tx = pcfich.pcfich_put(tx, cfi, cell, SF_IDX)
    tx = tx + pdcch.pdcch_encode(bits, RNTI, cce, l, cell, cfi, SF_IDX)
    hv = (rng.standard_normal((BATCH, ports))
          + 1j * rng.standard_normal((BATCH, ports))) / np.sqrt(2 * ports)
    h = torch.as_tensor(hv.astype(np.complex64))[..., None, None].expand(
        BATCH, ports, cell.nsymb_sf, cell.nof_re).contiguous()
    n0 = 10 ** (-snr_db / 10)
    shape = (BATCH, cell.nsymb_sf, cell.nof_re)
    noise = np.sqrt(n0 / 2) * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape))
    grid = (tx * h).sum(1) + torch.as_tensor(noise.astype(np.complex64))
    return cell, grid, h, torch.full((BATCH,), n0, dtype=torch.float32), bits


# --- the code of the three stages before the kernels, as it was -----------


def _parent_pcfich_decode(grid, h, cell, sf_idx, noise_est=0.0):
    idx = device_table(("pcfich_re", cell), grid.device,
                       lambda: pcfich._re_indices(cell))
    y = grid[..., 0, :][..., idx]
    has_ports = h.dim() == grid.dim() + 1
    if not has_ports or h.shape[-3] == 1:
        hh = (h[..., 0, 0, :] if has_ports else h[..., 0, :])[..., idx]
        x = y * torch.conj(hh) / torch.clamp(hh.abs() ** 2 + noise_est,
                                             min=1e-12)
    else:
        hp = [h[..., p, 0, :][..., idx][..., None, :]
              for p in range(h.shape[-3])]
        eq = eq_sfbc if len(hp) == 2 else eq_sfbc_fstd
        x, _csi = eq(y[..., None, :], *hp)
    llr = descramble_llrs(demod_soft(x, Mod.QPSK),
                          cinit_pcfich(2 * sf_idx, cell.id))
    signs = device_table("cfi_signs", grid.device, lambda: (
        1.0 - 2.0 * pcfich.CFI_CODEWORDS.astype(np.float32)))
    corr = torch.einsum("...k,ck->...c", llr, signs)
    cfi = torch.argmax(corr, dim=-1) + 1
    return cfi, corr.max(-1).values / llr.abs().sum(-1)


def _parent_pdcch_extract_llr(grid, h, cell, cfi, sf_idx, noise_est=0.0,
                              ng=1.0):
    """As it was, but on 4 ports: SFBC-FSTD (TS 36.211 6.8.4), where the
    code before the kernels took SFBC on ports 0 and 1."""
    idx = pdcch._region_idx(cell, cfi, ng, grid.device)
    y = grid.reshape(*grid.shape[:-2], -1)[..., idx]
    if h.dim() == grid.dim() + 1 and h.shape[-3] >= 2:
        hf = h.reshape(*h.shape[:-2], -1)
        hp = [hf[..., p, :][..., idx][..., None, :]
              for p in range(h.shape[-3])]
        eq = eq_sfbc_fstd if len(hp) == 4 else eq_sfbc
        x, csi = eq(y[..., None, :], *hp)
        llr = demod_soft(x, Mod.QPSK) * torch.repeat_interleave(csi, 2, -1)
    else:
        if h.dim() == grid.dim() + 1:
            h = h[..., 0, :, :]
        hh = h.reshape(*h.shape[:-2], -1)[..., idx]
        x = y * torch.conj(hh) / torch.clamp(hh.abs() ** 2 + noise_est,
                                             min=1e-12)
        llr = demod_soft(x, Mod.QPSK) \
            * torch.repeat_interleave(hh.abs() ** 2, 2, -1)
    return descramble_llrs(llr, cinit_pdcch(2 * sf_idx, cell.id))


def _parent_pdcch_blind_bits(llr, cands, size):
    k = size + 16
    by_l: dict = {}
    for l, cce in cands:
        by_l.setdefault(l, []).append(cce)
    parts, order = [], []
    for l, cces in by_l.items():
        e = l * pdcch.BITS_PER_CCE
        seg = torch.stack(
            [llr[..., c * pdcch.BITS_PER_CCE:c * pdcch.BITS_PER_CCE + e]
             for c in cces], dim=-2)
        parts.append(rm_conv_rx(seg, k))
        order.extend((l, c) for c in cces)
    bits = viterbi_decode_plain(torch.cat(parts, dim=-3))
    perm = [order.index(c) for c in cands]
    if perm != list(range(len(cands))):
        bits = bits[..., torch.as_tensor(perm), :]
    return bits


def _parent_ue_search_candidates(rnti, sf_idx, n_cce):
    out = []
    for l, m_max in ((4, 4), (8, 2)):
        for m in range(m_max):
            if m * l + l <= n_cce:
                out.append((l, m * l))
    y = rnti
    for _ in range(sf_idx + 1):
        y = (39827 * y) % 65537
    for l, m_max in ((1, 6), (2, 6), (4, 2), (8, 2)):
        if n_cce // l == 0:
            continue
        for m in range(m_max):
            cce = l * ((y + m) % (n_cce // l))
            if cce + l <= n_cce:
                out.append((l, cce))
    return list(dict.fromkeys(out))


# --- the kernels' arithmetic in NumPy float32 ------------------------------


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _sfbc(ye, yo, h0, h1, odd):
    scale = np.float32(np.sqrt(2.0))
    if not odd:
        a, b = _cmul((h0[0], -h0[1]), ye), _cmul(h1, (yo[0], -yo[1]))
        x = (a[0] + b[0], a[1] + b[1])
    else:
        a, b = _cmul((h0[0], -h0[1]), yo), _cmul(h1, (ye[0], -ye[1]))
        x = (a[0] - b[0], a[1] - b[1])
    hh = np.maximum(h0[0] * h0[0] + h0[1] * h0[1]
                    + (h1[0] * h1[0] + h1[1] * h1[1]), np.float32(1e-20))
    return (x[0] / hh * scale, x[1] / hh * scale), hh


def _mrc(y, h, noise):
    x = _cmul(y, (h[0], -h[1]))
    d = np.maximum(h[0] * h[0] + h[1] * h[1] + noise, np.float32(1e-12))
    return x[0] / d, x[1] / d


def _ri(z):
    return (z.real.astype(np.float32), z.imag.astype(np.float32))


def emulate_ctrl(grid, h, cell, sf_idx, noise, cfi):
    """``ctrl_llr_kernel`` on the uploaded tables: grid [N, S, K], h [N, P,
    S, K], noise [N] -> (cfi [N], corr [N], llr [N, 2 n_re])."""
    n, ports = grid.shape[0], h.shape[1]
    g = grid.reshape(n, -1).numpy()
    hf = h.reshape(n, ports, -1).numpy()
    nz = noise.numpy().astype(np.float32)[:, None]
    pcf = pcfich._re_indices(cell).astype(np.int32)
    sg = pcfich.kernel_signs(cell, sf_idx)
    i = np.arange(16)
    if ports == 1:
        x = _mrc(_ri(g[:, pcf]), _ri(hf[:, 0, pcf]), nz)
    else:
        e = i & ~1
        pa = np.where(i & 2, 1, 0) if ports == 4 else np.zeros(16, int)
        pb = pa + 2 if ports == 4 else np.ones(16, int)
        ke, ko = pcf[e], pcf[e + 1]
        ye, yo = _ri(g[:, ke]), _ri(g[:, ko])
        ha = _ri(hf[:, pa, ke])
        hb = _ri(hf[:, pb, ke])
        x0, _ = _sfbc(ye, yo, ha, hb, False)
        x1, _ = _sfbc(ye, yo, ha, hb, True)
        odd = (i & 1).astype(bool)
        x = (np.where(odd, x1[0], x0[0]), np.where(odd, x1[1], x0[1]))
    s_llr = np.stack(x, -1).reshape(n, 32) * sg[:32]
    corr = np.zeros((n, 3), np.float32)
    for c in range(3):
        for j in range(32):
            corr[:, c] += s_llr[:, j] * sg[32 * (c + 1) + j]
    cfi_hat = np.argmax(corr, -1) + 1
    mag = np.zeros(n, np.float32)
    for j in range(32):
        mag += np.abs(s_llr[:, j])
    re, sgn = pdcch.region_signs(cell, cfi, 1.0, sf_idx)
    ke, ko = re[0::2], re[1::2]
    ye, yo = _ri(g[:, ke]), _ri(g[:, ko])
    if ports >= 2:
        # SFBC-FSTD on 4 ports: a quadruplet's first pair on ports 0 and
        # 2, its second on 1 and 3
        q = np.arange(len(ke))
        pa = q & 1 if ports == 4 else np.zeros(len(ke), int)
        pb = pa + 2 if ports == 4 else np.ones(len(ke), int)
        ha, hb = _ri(hf[:, pa, ke]), _ri(hf[:, pb, ke])
        x0, csi = _sfbc(ye, yo, ha, hb, False)
        x1, _ = _sfbc(ye, yo, ha, hb, True)
        v = [x0[0] * csi, x0[1] * csi, x1[0] * csi, x1[1] * csi]
    else:
        he, ho = _ri(hf[:, 0, ke]), _ri(hf[:, 0, ko])
        x0, x1 = _mrc(ye, he, nz), _mrc(yo, ho, nz)
        we = he[0] * he[0] + he[1] * he[1]
        wo = ho[0] * ho[0] + ho[1] * ho[1]
        v = [x0[0] * we, x0[1] * we, x1[0] * wo, x1[1] * wo]
    llr = np.stack(v, -1).reshape(n, -1) * sgn
    return cfi_hat, corr.max(-1) / mag, llr


def emulate_derm(llr, cands, k):
    """The blind kernel's de-rate-matching on ``derm_inverse``: llr [N,
    n_llr] -> [N, n_cand, 3, K], each position's repetitions below E added
    in ascending order from 0."""
    inv = pdcch.derm_inverse(k)
    table = pdcch.candidate_table(tuple(cands))
    out = np.zeros((llr.shape[0], len(cands), 3 * k), np.float32)
    for c, (first, e) in enumerate(table):
        seg = llr[:, first:first + e]
        acc = np.zeros((llr.shape[0], 3 * k), np.float32)
        for r in range(-(-e // (3 * k))):
            pos = inv + r * 3 * k
            acc = acc + np.where(pos < e, seg[:, np.minimum(pos, e - 1)],
                                 np.float32(0))
        out[:, c] = acc
    return out.reshape(llr.shape[0], len(cands), 3, k)


def emulate_crc(bits, size, rnti):
    """The blind kernel's CRC check: the set bits' syndromes XORed, against
    the RNTI mask's (``size_table``'s header)."""
    k = size + 16
    tab = pdcch.size_table((size,), rnti)
    syn = tab[tab[2] + 3 * k:tab[2] + 4 * k]
    crc = np.bitwise_xor.reduce(np.where(bits.astype(bool), syn, 0), -1)
    return crc == tab[3]


def emulate_blind(llr, cands, sizes, rnti):
    """``pdcch_blind_kernel``: -> (bits per size, ok [n_sizes, N, n_cand],
    hits [N])."""
    bits, oks = [], []
    for size in sizes:
        d = emulate_derm(llr, cands, size + 16)
        b = viterbi_decode_plain(torch.as_tensor(d)).numpy()
        bits.append(b)
        oks.append(emulate_crc(b, size, rnti))
    ok = np.stack(oks)
    return bits, ok, ok.sum((0, 2))


# --- tests -----------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_twins_equal_the_code_before_the_kernels(case):
    prb, ports, cfi, cp = case
    cell, grid, h, n0, bits = _stimulus(*case)
    for hh in ((h, h[:, 0]) if ports == 1 else (h,)):
        want = _parent_pcfich_decode(grid, hh, cell, SF_IDX, n0[:, None])
        for got in (pcfich._pcfich_decode_plain(grid, hh, cell, SF_IDX,
                                                n0[:, None]),
                    pcfich.pcfich_decode(grid, hh, cell, SF_IDX,
                                         n0[:, None])):
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        assert (want[0] == cfi).all()
        want = _parent_pdcch_extract_llr(grid, hh, cell, cfi, SF_IDX,
                                         n0[:, None])
        for fn in (pdcch._pdcch_extract_llr_plain, pdcch.pdcch_extract_llr):
            assert torch.equal(fn(grid, hh, cell, cfi, SF_IDX, n0[:, None]),
                               want)
    llr = want
    cands = pdcch.ue_search_candidates(RNTI, SF_IDX,
                                       regs.pdcch_nof_cces(cell, cfi))
    for size in (dci_mod.format0_1a_size(prb), dci_mod.format1_size(prb)):
        want = _parent_pdcch_blind_bits(llr, cands, size)
        assert torch.equal(pdcch._pdcch_blind_bits_plain(llr, cands, size),
                           want)
        assert torch.equal(pdcch.pdcch_blind_bits(llr, list(cands), size),
                           want)
    hits = pdcch.pdcch_blind_decode(grid[0], h[0] if ports > 1 else h[0, 0],
                                    cell, cfi, SF_IDX, RNTI,
                                    (dci_mod.format0_1a_size(prb),),
                                    noise_est=float(n0[0]))
    assert [bytes(x.payload) for x in hits] == [bytes(bits[0].numpy())]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_a_arithmetic_reproduces_the_twins(case):
    """On the uploaded tables, the kernel's combining, demapping,
    descrambling and correlation give the twins' LLRs to float32 rounding
    (1e-6 of the largest magnitude: the CPU's complex division and
    |h|^2 round otherwise) and the same CFI."""
    prb, ports, cfi, cp = case
    cell, grid, h, n0, _ = _stimulus(*case, seed=prb + cfi)
    cfi_hat, corr, llr = emulate_ctrl(grid, h, cell, SF_IDX, n0, cfi)
    want_cfi, want_corr = pcfich._pcfich_decode_plain(grid, h, cell, SF_IDX,
                                                      n0[:, None])
    want_llr = pdcch._pdcch_extract_llr_plain(grid, h, cell, cfi, SF_IDX,
                                              n0[:, None]).numpy()
    np.testing.assert_array_equal(cfi_hat, want_cfi.numpy())
    np.testing.assert_allclose(corr, want_corr.numpy(), rtol=1e-5)
    assert llr.shape == want_llr.shape
    err = np.abs(llr - want_llr).max() / np.abs(want_llr).max()
    assert err <= 1e-6, err


def test_kernel_a_cfi_on_noise_alone():
    """Where no PCFICH is sent the correlation picks a codeword all the
    same: the first maximum, as the twin's argmax."""
    cell = Cell(nof_prb=25, nof_ports=2, id=7)
    g = torch.Generator().manual_seed(3)
    shape = (64, cell.nsymb_sf, cell.nof_re)
    grid = torch.complex(torch.randn(shape, generator=g),
                         torch.randn(shape, generator=g))
    h = torch.complex(torch.randn((64, 2, *shape[1:]), generator=g),
                      torch.randn((64, 2, *shape[1:]), generator=g))
    cfi_hat, _, _ = emulate_ctrl(grid, h, cell, 1, torch.zeros(64), 1)
    want, _ = pcfich._pcfich_decode_plain(grid, h, cell, 1)
    np.testing.assert_array_equal(cfi_hat, want.numpy())


@pytest.mark.parametrize("prb", (6, 25, 100))
def test_tables_reproduce_the_plain_tables(prb):
    """The descrambling signs are ``descramble_llrs``' and the PCFICH's
    and region's RE indices the plain gathers'; the candidates are the
    uncached search space, in its order."""
    cell = Cell(nof_prb=prb, nof_ports=2, id=11)
    for sf in range(10):
        sg = pcfich.kernel_signs(cell, sf)
        ones = torch.ones(32)
        np.testing.assert_array_equal(
            sg[:32], descramble_llrs(ones, cinit_pcfich(2 * sf, cell.id)))
        np.testing.assert_array_equal(
            sg[32:].reshape(3, 32), 1 - 2 * pcfich.CFI_CODEWORDS)
        for cfi in (1, 2, 3):
            re, sgn = pdcch.region_signs(cell, cfi, 1.0, sf)
            np.testing.assert_array_equal(re,
                                          pdcch._region_re_indices(cell, cfi))
            np.testing.assert_array_equal(
                sgn, descramble_llrs(torch.ones(2 * len(re)),
                                     cinit_pdcch(2 * sf, cell.id)))
            n_cce = regs.pdcch_nof_cces(cell, cfi)
            assert n_cce == len(regs.pdcch_reg_map(cell, cfi)) // 9
            for rnti in (RNTI, 0xFFFF, 61):
                cands = pdcch.ue_search_candidates(rnti, sf, n_cce)
                assert list(cands) == _parent_ue_search_candidates(
                    rnti, sf, n_cce)
                assert pdcch.ue_search_candidates(rnti, sf, n_cce) is cands
                np.testing.assert_array_equal(
                    pdcch.candidate_table(cands),
                    [(72 * c, 72 * l) for l, c in cands])


#: every K a DCI size of 6-100 PRB gives (formats 0/1A, 1, 1C, 2)
KS = sorted({s + 16 for p in (6, 15, 25, 50, 75, 100)
             for s in (dci_mod.format0_1a_size(p), dci_mod.format1_size(p),
                       dci_mod.format1c_size(p), dci_mod.format2_size(p))})


@pytest.mark.parametrize("k", KS)
def test_derm_gather_reproduces_rm_conv_rx(k):
    """At every aggregation level: exactly on integer LLRs (any order of
    the sums is exact), exactly on float LLRs up to 4 repetitions, and
    beyond that to float32 rounding (PyTorch's CPU sum splits its tail
    columns 4 ways; the kernel adds in ascending order)."""
    rng = np.random.default_rng(k)
    cands = ((1, 0), (2, 2), (4, 4), (8, 8))
    for ints in (True, False):
        llr = rng.standard_normal((3, 16 * 72)) * 8
        llr = (np.round(llr) if ints else llr).astype(np.float32)
        got = emulate_derm(llr, cands, k)
        for c, (l, cce) in enumerate(cands):
            seg = torch.as_tensor(llr[:, 72 * cce:72 * (cce + l)])
            want = rm_conv_rx(seg, k).numpy()
            if ints or -(-72 * l // (3 * k)) <= 4:
                np.testing.assert_array_equal(got[:, c], want)
            else:
                np.testing.assert_allclose(got[:, c], want, rtol=0,
                                           atol=4e-7 * np.abs(want).max())


@pytest.mark.parametrize("size", sorted({k - 16 for k in KS}))
def test_crc_syndromes_reproduce_dci_crc_ok(size):
    rng = np.random.default_rng(size)
    for rnti in (RNTI, 0xFFFF, 0):
        payload = rng.integers(0, 2, (64, size)).astype(np.int8)
        good = np.stack([CRC16.attach_np(p, rnti) for p in payload])
        bits = np.concatenate([good, rng.integers(0, 2, (64, size + 16))])
        bits[70:74] = good[:4]
        bits[80, :] = 0
        want = pdcch.dci_crc_ok(torch.as_tensor(bits), size, rnti).numpy()
        np.testing.assert_array_equal(emulate_crc(bits, size, rnti), want)
        assert want[:64].all() and want[70:74].all()


@pytest.mark.parametrize("snr_db", (20.0, -3.0))
@pytest.mark.parametrize("case", [(100, 2, 1, CP.NORM), (6, 4, 3, CP.EXT),
                                  (25, 1, 2, CP.NORM)], ids=_case_id)
def test_kernel_b_arithmetic_reproduces_the_twin(case, snr_db):
    """The kernel's de-rate-matching, Viterbi and CRC give the twin's bits
    and CRC flags (at -3 dB some candidates are noise), and the pass
    count ``control_rx`` returns; the bits equal wherever the
    de-rate-matched input does (ascending sums: all but 5 or more
    repetitions)."""
    prb, ports, cfi, cp = case
    cell, grid, h, n0, _ = _stimulus(*case, snr_db=snr_db, seed=prb)
    llr = pdcch._pdcch_extract_llr_plain(grid, h, cell, cfi, SF_IDX,
                                         n0[:, None])
    cands = pdcch.ue_search_candidates(RNTI, SF_IDX,
                                       regs.pdcch_nof_cces(cell, cfi))
    sizes = (dci_mod.format0_1a_size(prb), dci_mod.format1_size(prb))
    bits, ok, hits = emulate_blind(llr.numpy(), cands, sizes, RNTI)
    n_det = torch.zeros(BATCH, dtype=torch.int64)
    for i, size in enumerate(sizes):
        want = pdcch._pdcch_blind_bits_plain(llr, cands, size)
        want_ok = pdcch.dci_crc_ok(want, size, RNTI).numpy()
        n_det = n_det + pdcch.dci_crc_ok(want, size, RNTI).sum(-1)
        same_in = (emulate_derm(llr.numpy(), cands, size + 16)
                   == torch.stack([rm_conv_rx(
                       llr[:, 72 * c:72 * (c + l)], size + 16)
                       for l, c in cands], 1).numpy()).all((-1, -2))
        assert same_in[:, [l <= 4 for l, _ in cands]].all()
        assert (bits[i] == want.numpy()).all(-1)[same_in].all()
        np.testing.assert_array_equal(ok[i][same_in], want_ok[same_in])
    _, got_det = pdcch.control_rx(grid, h, cell, cfi, SF_IDX, RNTI, sizes, n0)
    assert torch.equal(got_det, n_det)
    if snr_db > 0:
        np.testing.assert_array_equal(hits, n_det.numpy())
        assert (hits >= 1).all()


def test_blind_plan_and_size_table():
    ks = (44, 55)
    warps, smem = pdcch.blind_plan(ks, 18)
    assert warps == 18                  # 36 jobs: two rounds of 18 warps
    assert smem == 18 * pdcch.blind_warp_bytes(55, TRAIN_LEN)
    assert pdcch.blind_plan((44,), 5) == (5, 5 * pdcch.blind_warp_bytes(
        44, TRAIN_LEN))
    assert pdcch.blind_plan((44, 55, 31, 67), 22)[0] == 30   # 88 jobs
    for bad in (((), 3), ((44,), 0), ((44,) * 5, 3), ((129,), 3)):
        with pytest.raises(ValueError):
            pdcch.blind_plan(*bad)
    tab = pdcch.size_table((28, 39), RNTI)
    off = 2 * pdcch.SIZE_HDR
    for i, k in enumerate(ks):
        assert tuple(tab[4 * i:4 * i + 3]) == (k, min(TRAIN_LEN, k), off)
        np.testing.assert_array_equal(tab[off:off + 3 * k],
                                      pdcch.derm_inverse(k))
        np.testing.assert_array_equal(tab[off + 3 * k:off + 4 * k],
                                      pdcch.crc16_syndromes(k))
        off += 4 * k
    assert len(tab) == off


def test_no_launch_without_a_card(monkeypatch):
    """The control stages on the CPU take the plain twins: not one launch,
    and none counted in the tracing registry."""
    cell, grid, h, n0, _ = _stimulus(25, 2, 2, CP.NORM)
    trace.reset()
    trace.enable()
    try:
        pdcch.control_rx(grid, h, cell, 2, SF_IDX, RNTI, (25,), n0)
        pcfich.pcfich_decode(grid, h, cell, SF_IDX)
        pdcch.pdcch_blind_decode(grid[0], h[0], cell, 2, SF_IDX, RNTI, (25,))
    finally:
        trace.disable()
    assert not trace.launch_shapes("ctrl_llr")
    assert not trace.launch_shapes("pdcch_blind")
    assert trace.launch_counts() == {}


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    cell, grid, h, n0, _ = _stimulus(6, 2, 1, CP.NORM)
    llr = pdcch._pdcch_extract_llr_plain(grid, h, cell, 1, SF_IDX)
    cands = pdcch.ue_search_candidates(RNTI, SF_IDX,
                                       regs.pdcch_nof_cces(cell, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pdcch.ctrl_llr_cuda(grid, h, cell, SF_IDX)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pdcch.pdcch_blind_cuda(llr, cands, (19,), RNTI)
    monkeypatch.setattr(pdcch, "_on_card", lambda t: True)
    launched = fake_launches(monkeypatch, pdcch.CTRL_LLR, pdcch.PDCCH_BLIND)
    refusals = [
        ("complex64", dict(grid=grid.to(torch.complex128))),
        ("complex64", dict(h=h.real.contiguous())),
        ("grid shape", dict(grid=grid[..., :-2])),
        ("h shape", dict(h=h[:1])),
        ("1, 2 or 4 ports", dict(h=torch.cat([h, h[:, :1]], 1))),
        ("contiguous", dict(grid=grid.transpose(-1, -2).contiguous()
                            .transpose(-1, -2))),
        ("float32", dict(noise_est=n0.double())),
        ("noise values", dict(noise_est=torch.ones(3))),
    ]
    for match, kw in refusals:
        args = dict(grid=grid, h=h, noise_est=0.0) | kw
        with pytest.raises(ValueError, match=match):
            pdcch.ctrl_llr_cuda(args["grid"], args["h"], cell, SF_IDX,
                                args["noise_est"], region=(1, 1.0))
    with pytest.raises(ValueError, match="float32"):
        pdcch.pdcch_blind_cuda(llr.double(), cands, (19,), RNTI)
    with pytest.raises(ValueError, match="contiguous last dim"):
        pdcch.pdcch_blind_cuda(llr.t().contiguous().t(), cands, (19,), RNTI)
    with pytest.raises(ValueError, match="reaches past"):
        pdcch.pdcch_blind_cuda(llr[:, :72], cands, (19,), RNTI)
    with pytest.raises(ValueError, match="out of range"):
        pdcch.pdcch_blind_cuda(llr, cands, (19,) * 5, RNTI)
    assert launched == []


@pytest.fixture(scope="module")
def tm4_small():
    torch.manual_seed(0)
    cell = Cell(nof_prb=6, nof_ports=2, id=1)
    mod, tbs = ra.mcs_to_tbs(10, 6)
    cfg = PdschConfig(cell=cell, sf_idx=1, cfi=2, rnti=RNTI, mod=mod,
                      mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=2)
    plan = cfg.plan(tbs)
    d = tm4_draws(2, tbs, format1_size(6), cell.sf_sample_len)
    noise = torch.complex(torch.as_tensor(d["nz_re"]),
                          torch.as_tensor(d["nz_im"]))
    samples = enb_dl_tm4(torch.as_tensor(d["tb"]), torch.as_tensor(d["tb2"]),
                         torch.as_tensor(d["h2"]), noise, cfg, plan,
                         torch.as_tensor(d["dci_bits"]), 0, 4)
    return samples, cfg, plan


def _inside(e, r) -> bool:
    return (e is not r and r.time_range.start <= e.time_range.start
            and e.time_range.end <= r.time_range.end)


def test_control_ranges_launch_nothing_but_the_two_kernels(tm4_small,
                                                           monkeypatch):
    """With the card's path taken (the launches recorded, not made), a
    ``ue_dl_tm4_batch`` call's control ranges hold one launch of each
    kernel, counted in the tracing registry, and no op that would launch
    anything else; on the CPU the same call decodes the CFI and the DCI."""
    samples, cfg, plan = tm4_small
    res = ue_dl_tm4_batch(samples, cfg, plan)
    assert (res.cfi == cfg.cfi).all() and (res.dci_hits >= 1).all()
    monkeypatch.setattr(pdcch, "_on_card", lambda t: True)
    launched = fake_launches(monkeypatch, pdcch.CTRL_LLR, pdcch.PDCCH_BLIND)
    ue_dl_tm4_batch(samples, cfg, plan)                # tables built
    launched.clear()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ue_dl_tm4_batch(samples, cfg, plan)
        counted = trace.launch_counts()
    assert [name for name, _dev, _args in launched] == ["ctrl_llr",
                                                        "pdcch_blind"]
    assert counted == {"ctrl_llr": 1, "pdcch_blind": 1}
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ranges = [e for e in cpu if e.name in ("ue_dl.pdcch_llr",
                                           "ue_dl.pdcch_blind_search")]
    assert len(ranges) == 2
    held = {e.name for e in cpu for r in ranges
            if e.name.startswith("aten::") and _inside(e, r)}
    assert held and held <= NO_LAUNCH, held - NO_LAUNCH
