"""Port vs JAX reference: the PUCCH RM (20, O) code, PUCCH formats
1/1a/1b/2/2a/2b and the UCI payload helpers (``tests/test_pucch_uci.py``
and ``tests/test_csi_feedback.py`` TestCqiPayloads / TestFormat2Subband).

Inputs are numpy draws handed to both packages. Encoded grids agree to
1e-6 (both build them on the host). The JAX decoders accumulate in numpy
scalars, the port in complex64 tensors: d, the energy and the format-2
LLRs agree to 1e-5 relative; hard decisions (bits, ACKs, SR, RM
payloads) are equal. The JAX format-2 decoder does not return its LLRs,
so the test rebuilds them from the JAX package's own sequences with the
JAX decoder's arithmetic (``_jax_f2_llrs``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.models import pucch as jp
from empower_srslte_tpu.models import uci as juci
from empower_srslte_tpu.stack.enb import SR_DETECT_THRESHOLD
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch.models import pucch as pp
from empower_srslte_tpu_torch.models import uci
from empower_srslte_tpu_torch.utils.cell import Cell

RTOL = 1e-5
F1 = ("1", "1a", "1b")
F2 = ("2", "2a", "2b")


def _cfgs(fmt, n_pucch=5, sf_idx=3, prb=25, cell_id=11, n_rb_2=0):
    kw = dict(sf_idx=sf_idx, n_pucch=n_pucch, format=fmt, n_rb_2=n_rb_2)
    return (pp.PucchConfig(cell=Cell(nof_prb=prb, id=cell_id), **kw),
            jp.PucchConfig(cell=JCell(nof_prb=prb, id=cell_id), **kw))


def _noise(rng, shape, amp):
    return (amp * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
            ).astype(np.complex64)


def _f1_bits(fmt, rng):
    return tuple(int(b) for b in rng.integers(0, 2, {"1": 1, "1a": 1,
                                                      "1b": 2}[fmt]))


@pytest.mark.parametrize("o", range(1, 14))
def test_rm20_encode_and_ml_decode_match_jax(o, rng):
    bits = rng.integers(0, 2, size=(6, o)).astype(np.int8)
    cw = uci.rm_encode(bits, 20)
    np.testing.assert_array_equal(cw, juci.rm_encode(bits, 20))
    clean = (1.0 - 2.0 * cw).astype(np.float32) * 4
    np.testing.assert_array_equal(
        uci.rm_decode(torch.as_tensor(clean), 20, o).numpy(), bits)
    noisy = (1.0 - 2.0 * cw + 1.2 * rng.normal(size=cw.shape)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        uci.rm_decode(torch.as_tensor(noisy), 20, o).numpy(),
        np.asarray(juci.rm_decode(jnp.asarray(noisy), 20, o)))


def test_rm32_still_matches_and_bad_length_raises(rng):
    bits = rng.integers(0, 2, size=(3, 11)).astype(np.int8)
    np.testing.assert_array_equal(uci.rm_encode(bits, 32),
                                  juci.rm_encode(bits, 32))
    with pytest.raises(ValueError):
        uci.rm_encode(bits, 24)


def test_cell_shift_pattern_matches_jax():
    for cid in (0, 11, 301):
        np.testing.assert_array_equal(pp.n_cs_cell(Cell(nof_prb=6, id=cid)),
                                      jp.n_cs_cell(JCell(nof_prb=6, id=cid)))


@pytest.mark.parametrize("fmt", F1 + F2)
def test_encode_matches_jax(fmt, rng):
    for n_pucch, sf in ((0, 0), (5, 3), (17, 7), (40, 9)):
        cfg, jcfg = _cfgs(fmt, n_pucch=n_pucch, sf_idx=sf, n_rb_2=1)
        assert [cfg.prb(s) for s in (0, 1)] == [jcfg.prb(s) for s in (0, 1)]
        if fmt in F1:
            bits = _f1_bits(fmt, rng)
            got = pp.pucch_f1_encode(cfg, bits, device="cpu")
            want = jp.pucch_f1_encode(jcfg, bits)
        else:
            payload = rng.integers(0, 2, 9).astype(np.int8)
            ack = tuple(int(b) for b in rng.integers(0, 2, {"2": 0, "2a": 1,
                                                             "2b": 2}[fmt]))
            got = pp.pucch_f2_encode(cfg, payload, ack, device="cpu")
            want = jp.pucch_f2_encode(jcfg, payload, ack)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("fmt,bits", [("1", (1,)), ("1", ()), ("1a", (0,)),
                                      ("1a", (1,)), ("1b", (0, 1)),
                                      ("1b", (1, 1))])
def test_f1_decode_matches_jax(fmt, bits, rng):
    """A batch of noisy subframes: d and the energy per subframe equal to
    JAX's to 1e-5, and the bits (SR presence for format 1) equal. Format 1
    with no bits is an absent SR (noise only): JAX's |d| > 0.5 presence
    bit then reads noise, so the stack decides SR on the energy too
    (``stack/enb.py:478``), which must stay below its threshold there and
    clear it when an SR is sent."""
    cfg, jcfg = _cfgs(fmt)
    sent = 1.0 if bits else 0.0
    grid = sent * np.asarray(jp.pucch_f1_encode(jcfg, bits or (1,)))
    h = 0.8 * np.exp(1j * 0.7)
    rx = (grid * h + _noise(rng, (4, *grid.shape), 0.05)).astype(np.complex64)
    d, e = pp.pucch_f1_decode(torch.as_tensor(rx), cfg)
    got_bits = pp.pucch_f1_bits(d, fmt).numpy()
    for b in range(rx.shape[0]):
        jd, je = jp.pucch_f1_decode(rx[b], jcfg)
        np.testing.assert_allclose(complex(d[b]), jd, rtol=RTOL)
        np.testing.assert_allclose(float(e[b]), je, rtol=RTOL)
        assert tuple(got_bits[b]) == jp.pucch_f1_bits(jd, fmt)
        if bits:
            assert tuple(got_bits[b]) == bits
    if fmt == "1":
        sr = (e > SR_DETECT_THRESHOLD) & (d.real > 0.5)
        assert bool(sr.all()) if bits else not bool(sr.any())


def test_f1_orthogonal_users_share_a_prb(rng):
    """Four users on distinct (cyclic shift, cover) resources of one PRB
    pair, each with its own channel: every user's d matches JAX's and its
    bits are its own."""
    users = [("1a", 0, (0,)), ("1a", 3, (1,)), ("1b", 14, (1, 0)),
             ("1", 27, (1,))]
    cfgs = [_cfgs(f, n_pucch=n, sf_idx=2) for f, n, _ in users]
    grid = sum(np.asarray(jp.pucch_f1_encode(jc, bits))
               * np.exp(1j * (0.3 + i))
               for i, ((_, jc), (_, _, bits)) in enumerate(zip(cfgs, users)))
    rx = (grid + _noise(rng, grid.shape, 0.02)).astype(np.complex64)
    for (cfg, jcfg), (fmt, _, bits) in zip(cfgs, users):
        d, e = pp.pucch_f1_decode(torch.as_tensor(rx), cfg)
        jd, je = jp.pucch_f1_decode(rx, jcfg)
        np.testing.assert_allclose(complex(d), jd, rtol=RTOL)
        np.testing.assert_allclose(float(e), je, rtol=RTOL)
        assert tuple(pp.pucch_f1_bits(d, fmt).tolist()) == bits


def _jax_f2_llrs(rx, jcfg, nof_ack):
    """The 20 LLRs and d_ack of JAX's ``pucch_f2_decode`` (its arithmetic,
    its sequences)."""
    nsym = jcfg.cell.nsymb_slot
    shift = jcfg.n_pucch % 12
    llrs, d_ack = [], 0j
    for slot in range(2):
        k0 = 12 * jcfg.prb(slot)
        z = {l: np.sum(rx[slot * nsym + l, k0:k0 + 12]
                       * np.conj(jp._alpha_seq(jcfg, slot, l, shift))) / 12.0
             for l in range(nsym)}
        r0, r1 = jp.F2_DMRS_SYMS
        h = z[r0] if nof_ack else np.mean([z[r0], z[r1]])
        d_ack += z[r1] * np.conj(h) / max(abs(h) ** 2, 1e-12)
        for l in jp.F2_DATA_SYMS:
            d = z[l] * np.conj(h) / max(abs(h) ** 2, 1e-12) * np.sqrt(2)
            llrs.extend([d.real, d.imag])
    return np.asarray(llrs), d_ack


@pytest.mark.parametrize("fmt,ack,nof_bits", [
    ("2", (), 4), ("2", (), 11), ("2", (), 13), ("2a", (0,), 8),
    ("2a", (1,), 8), ("2b", (0, 0), 8), ("2b", (1, 0), 5),
    ("2b", (0, 1), 8), ("2b", (1, 1), 8)])
def test_f2_decode_matches_jax(fmt, ack, nof_bits, rng):
    cfg, jcfg = _cfgs(fmt, n_pucch=3, sf_idx=2, cell_id=1)
    payload = rng.integers(0, 2, nof_bits).astype(np.int8)
    grid = np.asarray(jp.pucch_f2_encode(jcfg, payload, ack))
    h = 1.1 * np.exp(-1j * 0.4)
    rx = (grid * h + _noise(rng, (3, *grid.shape), 0.05)) \
        .astype(np.complex64)
    out = pp.pucch_f2_decode(torch.as_tensor(rx), cfg, nof_bits,
                             nof_ack=len(ack), return_energy=True)
    llrs, d_ack, _ = pp.pucch_f2_soft(torch.as_tensor(rx), cfg, len(ack))
    for b in range(rx.shape[0]):
        want = jp.pucch_f2_decode(rx[b], jcfg, nof_bits, nof_ack=len(ack),
                                  return_energy=True)
        np.testing.assert_array_equal(out[0][b].numpy(), want[0])
        np.testing.assert_array_equal(out[0][b].numpy(), payload)
        np.testing.assert_allclose(float(out[-1][b]), want[-1], rtol=RTOL)
        if ack:
            assert tuple(out[1][b].tolist()) == want[1] == ack
        j_llrs, j_ack = _jax_f2_llrs(rx[b], jcfg, len(ack))
        np.testing.assert_allclose(llrs[b].numpy(), j_llrs, rtol=RTOL,
                                   atol=RTOL * np.abs(j_llrs).max())
        np.testing.assert_allclose(complex(d_ack[b]), j_ack, rtol=RTOL)


def test_f2_users_share_a_prb_and_plain_decode(rng):
    """A CQI, an RI and a 2b user on cyclic shifts 0, 3 and 6 of one
    PRB pair; plain ``pucch_f2_decode`` returns the bits alone."""
    users = [("2", 0, 4, ()), ("2", 3, 1, ()), ("2b", 6, 4, (1, 0))]
    cfgs = [_cfgs(f, n_pucch=n, sf_idx=4, prb=6, cell_id=1)
            for f, n, _, _ in users]
    payloads = [rng.integers(0, 2, nb).astype(np.int8)
                for _, _, nb, _ in users]
    grid = sum(np.asarray(jp.pucch_f2_encode(jc, p, u[3]))
               * np.exp(1j * 0.9 * i)
               for i, ((_, jc), p, u) in enumerate(zip(cfgs, payloads,
                                                        users)))
    rx = (grid + _noise(rng, grid.shape, 0.02)).astype(np.complex64)
    for (cfg, jcfg), p, (_, _, nb, ack) in zip(cfgs, payloads, users):
        if ack:
            bits, got_ack = pp.pucch_f2_decode(torch.as_tensor(rx), cfg, nb,
                                               nof_ack=2)
            assert tuple(got_ack.tolist()) == ack
        else:
            bits = pp.pucch_f2_decode(torch.as_tensor(rx), cfg, nb)
            np.testing.assert_array_equal(bits.numpy(),
                                          jp.pucch_f2_decode(rx, jcfg, nb))
        np.testing.assert_array_equal(bits.numpy(), p)


def _wideband():
    for cqi in range(16):
        bits = uci.cqi_pack_wideband(cqi)
        np.testing.assert_array_equal(bits, juci.cqi_pack_wideband(cqi))
        assert uci.cqi_unpack_wideband(bits) == cqi
        assert uci.cqi_unpack_wideband(torch.as_tensor(bits)) == cqi


def _ue_subband():
    for args in ((9, 1, 5, 3), (15, 3, 0, 2), (0, 0, 7, 4)):
        bits = uci.cqi_pack_ue_subband(*args)
        np.testing.assert_array_equal(bits, juci.cqi_pack_ue_subband(*args))
        assert uci.cqi_unpack_ue_subband(bits, args[3]) == args[:3] == \
            juci.cqi_unpack_ue_subband(bits, args[3])


def _format2_subband():
    for cqi, label, two in ((11, 3, True), (7, 1, False), (0, 2, True)):
        bits = uci.cqi_pack_format2_subband(cqi, label, two)
        np.testing.assert_array_equal(
            bits, juci.cqi_pack_format2_subband(cqi, label, two))
        assert len(bits) == 4 + (2 if two else 1)
        assert uci.cqi_unpack_format2_subband(bits, two) == (cqi, label)


def _ri():
    for ri, n in ((1, 1), (2, 1), (3, 2), (4, 2)):
        bits = uci.ri_pack(ri, n)
        np.testing.assert_array_equal(bits, juci.ri_pack(ri, n))
        assert uci.ri_unpack(bits, n) == ri == juci.ri_unpack(bits, n)
        assert uci.ri_unpack(torch.as_tensor(bits), n) == ri


def _equal(name, *args, want):
    """``name(*args)`` of both packages gives ``want``."""
    def case():
        assert getattr(uci, name)(*args) == getattr(juci, name)(*args) \
            == want
    return case


def _hl_roundtrip(u, wb, sbs, n_prb):
    bits = u.cqi_pack_hl_subband(wb, sbs, n_prb)
    assert len(bits) == u.cqi_hl_subband_nof_bits(n_prb)
    got = u.cqi_unpack_hl_subband(bits, n_prb)
    return got[0], list(got[1])


def _hl_saturation():
    """The higher-layer subband report's 2-bit differential clamps to
    offsets {-1..2}."""
    assert _hl_roundtrip(uci, 10, [3, 15, 10], 12) == \
        _hl_roundtrip(juci, 10, [3, 15, 10], 12) == (10, [8, 11, 10])


#: the UCI payload helpers, each case held to the JAX package's (``tests/
#: test_csi_feedback.py::TestCqiPayloads``' values among them)
PAYLOAD_CASES = {
    "wideband": _wideband, "ue_subband": _ue_subband,
    "format2_subband": _format2_subband, "ri": _ri,
    **{f"hl_subband_size_prb{n}": _equal("cqi_hl_subband_size", n, want=k)
       for n, k in ((6, 6), (25, 4), (50, 6), (100, 8))},
    **{f"nof_subbands_prb{n}": _equal("cqi_nof_subbands", n, want=k)
       for n, k in ((25, 7), (100, 13))},
    "hl_subband_saturation": _hl_saturation,
}


@pytest.mark.parametrize("case", sorted(PAYLOAD_CASES))
def test_payload_helpers_match_jax(case):
    PAYLOAD_CASES[case]()


def test_cqi_report_over_format2_round_trip(rng):
    """The stack's periodic CQI and RI occasions: pack, format 2 on the
    air, decode, unpack (``stack/enb.py:497-527``)."""
    cfg, _ = _cfgs("2", n_pucch=2, sf_idx=5, prb=6)
    for payload, unpack, want in ((uci.cqi_pack_wideband(13),
                                   uci.cqi_unpack_wideband, 13),
                                  (uci.ri_pack(2), uci.ri_unpack, 2)):
        grid = pp.pucch_f2_encode(cfg, payload, device="cpu") * (0.6 - 0.5j)
        grid = grid + torch.as_tensor(_noise(rng, grid.shape, 0.05))
        bits, energy = pp.pucch_f2_decode(grid, cfg, len(payload),
                                          return_energy=True)
        assert unpack(bits) == want and float(energy) > 0.3
