"""The plain receiver of a 4-port cell's transmit-diversity (TM2) downlink,
and its control channels, from the specification.

It imports nothing of the program, of ``phybench.frozen`` or of JAX:
plain PyTorch in float64 / complex128 (TF32 off, though nothing here
multiplies matrices on a card), and the NumPy pieces beside it that the
benchmark already holds as the specification (``spec``, ``dl_control``,
``dl_pdsch``, ``dl_tx``). Four CRS ports, a normal cyclic prefix, a
subframe other than 0 and 5; from the samples [B, rx, sf_len] of one
subframe each:

* OFDM: ``dl_pdsch.ofdm_demod`` (TS 36.211 6.12);
* CRS (6.10.1) of ports 0-3: ports 0 and 1 on symbols 0, 4, 7 and 11,
  ports 2 and 3 on symbols 1 and 8 (v = 3 (n_s mod 2) and 3 + 3 (n_s
  mod 2)). The estimator is the one ``dl_pdsch`` documents (srsLTE's
  ``chest_dl.c``): a least-squares estimate at every pilot, the
  three-tap average along each pilot row, linear interpolation in
  frequency and in time between the port's own pilot rows, extrapolated
  at the edges, so ports 2 and 3 interpolate between their two symbols.
  No noise estimate: transmit diversity's combining does not weigh by
  one;
* the PDSCH REs (6.3.5), every port's CRS left out;
* the inverse of SFBC-FSTD (6.3.3.3, 6.3.4.3): in each quadruplet of
  REs the first pair carries d(4i), d(4i+1) on ports 0 and 2, the second
  d(4i+2), d(4i+3) on ports 1 and 3; each pair is Alamouti-combined over
  the rx antennas with the channel of its first RE for both REs, scaled
  by sqrt(2) / (|h_a|^2 + |h_b|^2), and its LLRs weighted by that gain
  (the CSI weighting of srsLTE's ``pdsch.c``). srsLTE 18.09's
  ``precoding.c`` takes each RE's own channel; the program takes the
  pair's first, and so does this receiver: a departure of both, noted;
* the piecewise-linear max-log LLRs (``spec.llrs``), the descrambling
  of 6.3.1, and the DL-SCH with the E split of TS 36.212 5.1.4.1.2 at
  N_L 2, the layers of transmit diversity (``spec.e_sizes(..., n_l=2)``),
  de-rate-matched by ``spec.derm`` and decoded by the float32
  max-log-MAP of ``spec.sch_decode``.

Each stage's output passes through ``spec.Rounding``: unchanged for the
reference, bfloat16 for the control.

Beside the receiver, a 4-port cell's control channels as 36.211 sends
them: the REGs of 6.2.4 (symbols 0 and 1 hold CRS on 4 ports), the PCFICH
(6.7) and the PDCCH (6.8.4) on SFBC-FSTD, the PHICH (6.9.2) on SFBC-FSTD
with its port pairs alternating on (i + n_group) mod 2, the PBCH (6.6.3)
on SFBC-FSTD, and the PDCCH region's combined LLRs; and the PDSCH a
transmitter sends (``pdsch_ports``: ``dl_tx``'s DL-SCH with its E split
on N_L 2, scrambling and mapper, then SFBC-FSTD), which the CPU tests
hold the benchmark's transmitter to.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import dl_control, dl_pdsch, dl_tx, spec

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPLX = torch.complex128
N_RB_MAX = 110
#: the PBCH's coded bits in 40 ms (normal CP), and its CRC mask on 4
#: ports (36.212 Table 5.3.1.1-1)
PBCH_BITS, PBCH_MASK4 = 1920, 0x5555


def _round(rnd: spec.Rounding, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(rnd(t.numpy())) if rnd.lower else t


# --- CRS and the PDSCH's REs, 36.211 6.10.1 and 6.3.5 -----------------------


@functools.lru_cache(maxsize=64)
def crs(cell_id: int, nof_prb: int, sf_idx: int, port: int) -> tuple:
    """Port 0-3's CRS in one subframe: (symbols, first subcarrier of each
    row, values [rows, 2 N_RB]), as ``dl_pdsch.crs`` gives ports 0 and
    1; ports 2 and 3 at l = 1 of each slot."""
    if port < 2:
        return dl_pdsch.crs(cell_id, nof_prb, sf_idx, port)
    syms, offs, vals = [], [], []
    for slot in range(2):
        ns, l = 2 * sf_idx + slot, 1
        c_init = ((1 << 10) * (7 * (ns + 1) + l + 1) * (2 * cell_id + 1)
                  + 2 * cell_id + 1)
        c = spec.gold(c_init, 4 * N_RB_MAX).astype(np.float64)
        m = np.arange(2 * nof_prb) + N_RB_MAX - nof_prb
        v = 3 * (ns % 2) + (0 if port == 2 else 3)
        syms.append(7 * slot + l)
        offs.append((v + cell_id % 6) % 6)
        vals.append(((1 - 2 * c[2 * m]) + 1j * (1 - 2 * c[2 * m + 1]))
                    / math.sqrt(2))
    return np.asarray(syms), np.asarray(offs), np.stack(vals)


@functools.lru_cache(maxsize=16)
def pdsch_res(cell_id: int, nof_prb: int, cfi: int,
              sf_idx: int) -> np.ndarray:
    """Flat grid indices of a 4-port cell's PDSCH REs, subcarrier first
    (6.3.5): after the control region, every port's CRS left out."""
    if sf_idx in (0, 5):
        raise NotImplementedError("subframes 0 and 5 carry sync and PBCH")
    used = np.ones((14, 12 * nof_prb), bool)
    used[:cfi + 1 if nof_prb <= 10 else cfi] = False
    for p in range(4):
        syms, offs, _ = crs(cell_id, nof_prb, sf_idx, p)
        for s, o in zip(syms, offs):
            used[s, o::6] = False
    s, k = np.nonzero(used)
    return s * 12 * nof_prb + k


def _avg3(h: torch.Tensor) -> torch.Tensor:
    """The three-tap average along the last axis, the ends repeated."""
    pad = torch.cat([h[..., :1], h, h[..., -1:]], -1)
    return 0.3333 * pad[..., :-2] + 0.3334 * pad[..., 1:-1] \
        + 0.3333 * pad[..., 2:]


def _linear(x_known: np.ndarray, values: torch.Tensor, x: np.ndarray,
            axis: int) -> torch.Tensor:
    """Piecewise-linear through ``values`` at the increasing positions
    ``x_known`` along ``axis``, extrapolated from the two end points."""
    j = np.clip(np.searchsorted(x_known, x, side="right") - 1, 0,
                len(x_known) - 2)
    w = torch.as_tensor((x - x_known[j]) / (x_known[j + 1] - x_known[j]))
    lo = values.index_select(axis, torch.as_tensor(j))
    hi = values.index_select(axis, torch.as_tensor(j + 1))
    shape = [1] * values.dim()
    shape[axis] = len(x)
    w = w.reshape(shape)
    return (1 - w) * lo + w * hi


def chest(grid: torch.Tensor, cell_id: int, nof_prb: int, sf_idx: int,
          port: int) -> torch.Tensor:
    """grid [..., 14, K] -> the port's channel [..., 14, K]."""
    syms, offs, vals = crs(cell_id, nof_prb, sf_idx, port)
    ls = torch.stack([grid[..., s, o::6][..., :2 * nof_prb]
                      for s, o in zip(syms, offs)], -2) \
        * torch.as_tensor(np.conj(vals))
    h = _avg3(ls)                                          # [..., rows, M]
    k = np.arange(12 * nof_prb, dtype=np.float64)
    rows = torch.stack([_linear(o + 6.0 * np.arange(h.shape[-1]),
                                h[..., i, :], k, -1)
                        for i, o in enumerate(offs)], -2)
    return _linear(syms.astype(np.float64), rows, np.arange(14.0), -2)


# --- transmit diversity on 4 ports, 36.211 6.3.3.3 and 6.3.4.3 -------------


def tx_diversity4(d) -> torch.Tensor:
    """Four ports: symbols [..., n] (n a multiple of 4) -> [..., 4, n].
    Layer l carries d(4i + l); in each quadruplet the pair (x0, x1) goes
    on ports 0 and 2, (x2, x3) on ports 1 and 3, scaled 1/sqrt(2)."""
    d = torch.as_tensor(d, dtype=CPLX)
    x = d.reshape(*d.shape[:-1], -1, 4)
    y = torch.zeros((*d.shape[:-1], 4, d.shape[-1] // 4, 4), dtype=CPLX)
    y[..., 0, :, 0], y[..., 2, :, 0] = x[..., 0], -x[..., 1].conj()
    y[..., 0, :, 1], y[..., 2, :, 1] = x[..., 1], x[..., 0].conj()
    y[..., 1, :, 2], y[..., 3, :, 2] = x[..., 2], -x[..., 3].conj()
    y[..., 1, :, 3], y[..., 3, :, 3] = x[..., 3], x[..., 2].conj()
    return y.reshape(*d.shape[:-1], 4, d.shape[-1]) / math.sqrt(2)


def combine4(y: torch.Tensor, h: torch.Tensor) -> tuple:
    """The inverse of ``tx_diversity4`` over the rx antennas: y [..., rx,
    n] and h [..., rx, 4, n] -> (d [..., n], gain [..., n]): each pair
    Alamouti-combined with its first RE's channel, scaled by sqrt(2) over
    its gain |h_a|^2 + |h_b|^2 summed over rx, which is its CSI."""
    q = y.reshape(*y.shape[:-1], -1, 4)                    # [..., rx, n/4, 4]
    hq = h.reshape(*h.shape[:-1], -1, 4)             # [..., rx, 4, n/4, 4]
    xs, gains = [], []
    for pair, (pa, pb) in enumerate(((0, 2), (1, 3))):
        ye, yo = q[..., 2 * pair], q[..., 2 * pair + 1]
        ha, hb = hq[..., pa, :, 2 * pair], hq[..., pb, :, 2 * pair]
        gain = (ha.abs() ** 2 + hb.abs() ** 2).sum(-2)
        x0 = (ha.conj() * ye + hb * yo.conj()).sum(-2)
        x1 = (ha.conj() * yo - hb * ye.conj()).sum(-2)
        scale = math.sqrt(2) / gain
        xs += [x0 * scale, x1 * scale]
        gains += [gain, gain]
    return (torch.stack(xs, -1).reshape(*xs[0].shape[:-1], -1),
            torch.stack(gains, -1).reshape(*xs[0].shape[:-1], -1))


def pdsch_ports(tb_bits, conf: dict) -> torch.Tensor:
    """TB bits [B, tbs] -> the 4 ports' PDSCH grid [B, 4, 14, 12 N_RB]
    complex128 (6.3): the DL-SCH with its E split on N_L 2
    (``dl_tx.dlsch``), scrambling (6.3.1), the mapper (7.1,
    ``dl_tx.modulate``), layer mapping and SFBC-FSTD (``tx_diversity4``)
    onto ``pdsch_res``; every other RE 0."""
    prb, cid, sf = conf["nof_prb"], conf["cell_id"], conf["sf_idx"]
    res = torch.as_tensor(pdsch_res(cid, prb, conf["cfi"], sf))
    qm = dl_pdsch.qm_of_mcs(conf["mcs"])
    g = len(res) * qm
    e = dl_tx.dlsch(torch.as_tensor(tb_bits), g, qm, n_l=2)
    c_init = (conf["rnti"] << 14) + (sf << 9) + cid
    d = dl_tx.modulate(e ^ torch.tensor(spec.gold(c_init, g),
                                        dtype=torch.int64), qm)
    grid = torch.zeros((len(e), 4, 14 * 12 * prb), dtype=CPLX)
    grid[..., res] = tx_diversity4(d)
    return grid.reshape(len(e), 4, 14, 12 * prb)


# --- the receiver ----------------------------------------------------------


def sch_softbuffers(llr: np.ndarray, tbs: int, qm: int, n_l: int,
                    rv: int = 0) -> list:
    """``spec.sch_softbuffers`` with the E split at N_L ``n_l``."""
    c, ks, f = spec.segmentation(tbs)
    out, off = [], 0
    for r, (k, e) in enumerate(zip(ks, spec.e_sizes(llr.shape[-1], c, qm,
                                                    n_l))):
        out.append(spec.derm(llr[..., off:off + e], k, f if r == 0 else 0,
                             rv))
        off += e
    assert off == llr.shape[-1]
    return out


def receive(samples, conf: dict, lower: bool = False) -> dict:
    """samples [B, rx, sf_len] -> dict(soft [1, B, C, 3 (K+4)] the
    de-rate-matched LLRs, bits [1, B, tbs] uint8, crc [1, B] bool,
    iterations [1, B, C])."""
    rnd = spec.Rounding(lower)
    prb, cid, sf = conf["nof_prb"], conf["cell_id"], conf["sf_idx"]
    if conf["nof_ports"] != 4 or conf["nof_codewords"] != 1:
        raise NotImplementedError("four ports, one codeword")
    grid = _round(rnd, dl_tx.demodulate(samples, prb))     # [B, rx, 14, K]
    h = _round(rnd, torch.stack([chest(grid, cid, prb, sf, p)
                                 for p in range(4)], -3))  # [B, rx, 4, 14, K]
    re = torch.as_tensor(pdsch_res(cid, prb, conf["cfi"], sf))
    y = grid.flatten(-2)[..., re]                          # [B, rx, M]
    hp = h.flatten(-2)[..., re]                            # [B, rx, 4, M]
    x, gain = combine4(y, hp)
    x, gain = _round(rnd, x), _round(rnd, gain)
    qm = dl_pdsch.qm_of_mcs(conf["mcs"])
    llr = spec.llrs(x.numpy(), qm) * np.repeat(gain.numpy(), qm, -1)
    llr = rnd(llr)
    c_init = (conf["rnti"] << 14) + (sf << 9) + cid
    llr = llr * spec.signs(c_init, llr.shape[-1])
    soft = [rnd(s) for s in sch_softbuffers(llr[None], conf["tbs"], qm, 2)]
    bits, ok, its = spec.sch_decode(soft, conf["tbs"],
                                    conf["max_iterations"])
    return dict(soft=np.stack(soft, -2), bits=bits, crc=ok, iterations=its)


# --- the control channels on 4 ports, 36.211 6.2.4 and 6.6-6.9 -------------


def regs(nof_prb: int, cell_id: int, nsymb: int) -> list:
    """(l, first subcarrier, the REG's 4 subcarriers) of every REG of a
    4-port cell's control region: in symbols 0 and 1 two of six
    subcarriers a PRB, the CRS left out; in later symbols three of
    four."""
    out = []
    for l in range(nsymb):
        for prb in range(nof_prb):
            if l < 2:
                for half in (0, 6):
                    k0 = 12 * prb + half
                    out.append((l, k0, [k0 + i for i in range(6)
                                        if i % 3 != cell_id % 3]))
            else:
                for q in (0, 4, 8):
                    k0 = 12 * prb + q
                    out.append((l, k0, list(range(k0, k0 + 4))))
    return out


def control_layout(conf: dict, ng: float = 1.0) -> dict:
    """``dl_tx.control_layout`` on a 4-port cell's REGs: the PCFICH's
    four, each PHICH group's three and the PDCCH's quadruplets in order
    (6.8.5: frequency first, then time), and the CCEs."""
    prb, cid, cfi = conf["nof_prb"], conf["cell_id"], conf["cfi"]
    nsymb = cfi + 1 if prb <= 10 else cfi
    every = regs(prb, cid, nsymb)
    sym0 = [r for r in every if r[0] == 0]
    kbar = 6 * (cid % (2 * prb))
    starts = [(kbar + (i * prb // 2) * 6) % (12 * prb) for i in range(4)]
    pcfich = [next(r for r in sym0 if r[1] == s) for s in starts]
    rest0 = [r for r in sym0 if r not in pcfich]
    n0 = len(rest0)
    groups = [[rest0[(cid + m + (i * n0) // 3) % n0] for i in range(3)]
              for m in range(math.ceil(ng * prb / 8))]
    taken = {(r[0], r[1]) for r in pcfich} | {(r[0], r[1]) for grp in groups
                                               for r in grp}
    free = sorted((r for r in every if (r[0], r[1]) not in taken),
                  key=lambda r: (r[1], r[0]))
    return dict(nsymb=nsymb, pcfich=pcfich, phich=groups, pdcch=free,
                n_cce=len(free) // 9)


def _pdcch_order(m_quad: int, cell_id: int) -> list:
    """The quadruplet each REG of the PDCCH takes (6.8.5): the sub-block
    interleaver of 36.212 5.1.4.2.1 on the quadruplets, then the cyclic
    shift by N_ID."""
    r = math.ceil(m_quad / 32)
    idx = np.concatenate([np.full(32 * r - m_quad, -1), np.arange(m_quad)])
    order = idx.reshape(r, 32)[:, list(dl_control.CONV_PERM)].T.reshape(-1)
    order = order[order >= 0]
    return [int(order[(m + cell_id) % m_quad]) for m in range(m_quad)]


def phich_ports(hi: int, group: int, seq: int, sf_idx: int,
                cell_id: int) -> torch.Tensor:
    """One HI's 12 symbols on the 4 ports [4, 12] (6.9.2, normal CP):
    SFBC-FSTD per quadruplet i, with the pairs on ports 0, 2 and 1, 3
    where (i + n_group) mod 2 is 0, and on 1, 3 and 0, 2 where it is 1."""
    y = tx_diversity4(dl_tx.phich_symbols(hi, seq, sf_idx, cell_id))
    for i in range(3):
        if (i + group) % 2:
            y[:, 4 * i:4 * i + 4] = y[[1, 0, 3, 2], 4 * i:4 * i + 4]
    return y


def control_region(conf: dict, dcis: list, phichs: list = (),
                   ng: float = 1.0) -> torch.Tensor:
    """The four ports' control region [4, nsymb, 12 N_RB] complex128: the
    CFI (6.7), each HI of ``phichs`` as (hi, group, sequence) (6.9) and
    each DCI of ``dcis`` as (payload bits, aggregation level, first CCE)
    (6.8, 36.212 5.3.3), all on SFBC-FSTD; every other RE 0."""
    prb, cid, sf, cfi = (conf["nof_prb"], conf["cell_id"], conf["sf_idx"],
                         conf["cfi"])
    lay = control_layout(conf, ng)
    out = torch.zeros((4, lay["nsymb"], 12 * prb), dtype=CPLX)

    def put(reg, quad):                   # four symbols a port onto a REG
        l, _k0, ks = reg
        out[:, l, ks] += quad

    bits = np.resize(dl_control.CFI_CODEWORDS[cfi], 32)
    c_init = ((sf + 1) * (2 * cid + 1) << 9) + cid
    y = tx_diversity4(dl_control.qpsk(bits ^ spec.gold(c_init, 32)))
    for i, reg in enumerate(lay["pcfich"]):
        put(reg, y[:, 4 * i:4 * i + 4])
    for hi, group, seq in phichs:
        y = phich_ports(hi, group, seq, sf, cid)
        for i, reg in enumerate(lay["phich"][group]):
            put(reg, y[:, 4 * i:4 * i + 4])
    m_quad = len(lay["pdcch"])
    total = 8 * m_quad
    seq = spec.gold((sf << 9) + cid, total)
    sym = np.zeros(total // 2, complex)
    rnti = np.array(dl_tx._bits(conf["rnti"], 16))
    for payload, level, cce in dcis:
        a = np.asarray(payload, np.int64)
        p = spec.crc_bits(a.astype(np.uint8), spec.CRC16).astype(np.int64)
        e = 72 * level
        coded = dl_control.conv_rate_match(
            dl_control.conv_encode(np.concatenate([a, p ^ rnti])), e)
        first = 72 * cce
        sym[first // 2:(first + e) // 2] = dl_control.qpsk(
            coded ^ seq[first:first + e])
    quads = tx_diversity4(sym).reshape(4, m_quad, 4)
    for reg, q in zip(lay["pdcch"], _pdcch_order(m_quad, cid)):
        put(reg, quads[:, q])
    return out


def pdcch_llrs(grid0: torch.Tensor, h0: torch.Tensor, conf: dict,
               ng: float = 1.0) -> torch.Tensor:
    """The PDCCH region's LLRs at one rx antenna: grid0 [..., 14, K] and
    h0 [..., 4, 14, K] -> [..., 2 n_re] in the order of the multiplexed
    PDCCH symbols d(i): each quadruplet's REs from its REG, combined as
    ``combine4`` does, QPSK LLRs (positive <=> bit 0) weighted by the
    pair's gain, descrambled (6.8.2)."""
    lay = control_layout(conf, ng)
    m_quad = len(lay["pdcch"])
    flat = np.empty(4 * m_quad, np.int64)
    k_all = 12 * conf["nof_prb"]
    for (l, _k0, ks), q in zip(lay["pdcch"], _pdcch_order(m_quad,
                                                          conf["cell_id"])):
        flat[4 * q:4 * q + 4] = [l * k_all + k for k in ks]
    idx = torch.as_tensor(flat)
    x, gain = combine4(grid0.flatten(-2)[..., None, idx],
                       h0.flatten(-2)[..., None, :, idx])
    llr = torch.stack([x.real, x.imag], -1).flatten(-2) \
        * gain.repeat_interleave(2, -1)
    sgn = spec.signs((conf["sf_idx"] << 9) + conf["cell_id"], llr.shape[-1])
    return llr * torch.as_tensor(sgn)


def pbch_ports(mib_bits, nof_prb: int, cell_id: int, sfn: int) -> tuple:
    """The PBCH of one radio frame on a 4-port cell (6.6, 36.212 5.3.1):
    the MIB's CRC16 masked for 4 ports, the tail-biting convolutional
    code rate-matched to 1920 bits, scrambled with c_init = N_ID over the
    40 ms, this frame's quarter (SFN mod 4) in QPSK on SFBC-FSTD. ->
    (flat grid indices of subframe 0's 240 REs in 6.6.4's order: slot 1's
    symbols 0-3 over the central 72 subcarriers, the 4-port CRS REs left
    out; the symbols [4, 240])."""
    a = np.asarray(mib_bits, np.int64)
    p = spec.crc_bits(a.astype(np.uint8), spec.CRC16).astype(np.int64)
    mask = np.array(dl_tx._bits(PBCH_MASK4, 16))
    coded = dl_control.conv_rate_match(
        dl_control.conv_encode(np.concatenate([a, p ^ mask])), PBCH_BITS)
    q = sfn % 4
    quarter = slice(q * PBCH_BITS // 4, (q + 1) * PBCH_BITS // 4)
    d = dl_control.qpsk((coded ^ spec.gold(cell_id, PBCH_BITS))[quarter])
    k_all, mid = 12 * nof_prb, 6 * nof_prb
    res = [(7 + l) * k_all + k for l in range(4)
           for k in range(mid - 36, mid + 36)
           if not (l < 2 and (k - cell_id) % 3 == 0)]
    assert len(res) == 240
    return np.asarray(res), tx_diversity4(d)
