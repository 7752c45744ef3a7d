"""The eNB's downlink subframe as TS 36.211/36.212 compose it, from the
transport blocks to the two antenna ports' samples: the plain transmitter
that the benchmark holds the port's ``enb_dl_tx_batch`` to.

It imports nothing of the program, of ``phybench.frozen`` or of JAX:
plain PyTorch on the CPU in float64 / complex128, and the NumPy pieces
beside it that the benchmark already holds as the specification
(``spec``, ``dl_control``, ``dl_pdsch``). Two antenna ports, a normal
cyclic prefix, a subframe other than 0 and 5.

* DL-SCH (36.212 5.3.2): CRC24A, code block segmentation with its filler
  bits and CRC24B (5.1.1-5.1.2, ``spec``), the turbo encoder (5.1.3.2)
  over ``spec.trellis`` and ``spec.qpp`` with its trellis termination,
  and rate matching (5.1.4.1) through ``spec.circular_buffer`` /
  ``spec.selection`` (N_cb the whole buffer);
* PDSCH (36.211 6.3): scrambling (6.3.1, ``spec.gold``), the QPSK /
  16QAM / 64QAM mapper (7.1.3-7.1.5), layer mapping for spatial
  multiplexing (6.3.3.2), precoding with ``dl_pdsch.precoder`` (6.3.4.2)
  and the REs of ``dl_pdsch.pdsch_res`` (6.3.5);
* the CRS of ``dl_pdsch.crs`` on each port (6.10.1);
* the PCFICH (6.7) and the PDCCHs (6.8, with 36.212 5.3.3: a format-1
  payload as given, and a format-0 grant packed here from 5.3.3.1.1 and
  36.213 8.1.1), on ``dl_control.regs`` through ``conv_encode``,
  ``conv_rate_match``, ``qpsk`` and ``tx_diversity``; the format-0 DCI
  on a candidate of the UE-specific search space (36.213 9.1.1);
* the PHICH (6.9; 36.212 5.3.5; 36.213 9.1.2 for its group and
  sequence);
* the OFDM baseband signal (6.12).

``transmit`` returns the grid, the samples and, for each RE, half the
least distance between two points of the signal the grid places there
(``radius``): a nearest-point decision on a value closer than that to
the grid's cannot pick another point. ``lower`` stores the grid and the
samples in bfloat16: the control.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import dl_control, dl_pdsch, spec

CPLX = torch.complex128


# --- DL-SCH, TS 36.212 5.3.2 -----------------------------------------------


@functools.lru_cache(maxsize=1)
def _rsc_tables() -> tuple:
    """(next state, parity) [8 * 2] of the constituent encoder by
    2 state + input, read off ``spec.trellis``."""
    prev, u, p = spec.trellis()
    nxt = np.zeros((8, 2), np.int64)
    par = np.zeros((8, 2), np.int64)
    for s_next in range(8):
        for j in range(2):
            nxt[prev[s_next, j], u[s_next, j]] = s_next
            par[prev[s_next, j], u[s_next, j]] = p[s_next, j]
    return torch.as_tensor(nxt.reshape(-1)), torch.as_tensor(par.reshape(-1))


def _rsc(c: torch.Tensor) -> tuple:
    """One constituent encoder over c [N, K] int64 -> (z [N, K], the tail's
    inputs x [N, 3] and parities z [N, 3]). The tail's input is the
    feedback a2 + a3, which drives the register to 0 (5.1.3.2.2)."""
    nxt, par = _rsc_tables()
    n, k = c.shape
    s = torch.zeros(n, dtype=torch.int64)
    z = torch.empty_like(c)
    for i in range(k):
        j = 2 * s + c[:, i]
        z[:, i] = par[j]
        s = nxt[j]
    xt, zt = [], []
    for _ in range(3):
        u = ((s >> 1) & 1) ^ (s & 1)
        j = 2 * s + u
        xt.append(u)
        zt.append(par[j])
        s = nxt[j]
    assert not s.any()
    return z, torch.stack(xt, -1), torch.stack(zt, -1)


def turbo_encode(c: torch.Tensor) -> torch.Tensor:
    """Code blocks c [N, K] 0/1 -> d [N, 3, K + 4] int64 (5.1.3.2): the
    systematic bits, the two encoders' parities (the second over the QPP
    interleaved block), and the tails placed as 5.1.3.2.2 reads."""
    k = c.shape[-1]
    c = c.to(torch.int64)
    z, x_t, z_t = _rsc(c)
    z2, x2_t, z2_t = _rsc(c[:, torch.as_tensor(spec.qpp(k))])
    d0 = torch.cat([c, x_t[:, :1], z_t[:, 1:2], x2_t[:, :1], z2_t[:, 1:2]], -1)
    d1 = torch.cat([z, z_t[:, :1], x_t[:, 2:], z2_t[:, :1], x2_t[:, 2:]], -1)
    d2 = torch.cat([z2, x_t[:, 1:2], z_t[:, 2:], x2_t[:, 1:2], z2_t[:, 2:]],
                   -1)
    return torch.stack([d0, d1, d2], -2)


def dlsch(tb: torch.Tensor, g: int, qm: int, n_l: int = 1,
          rv: int = 0) -> torch.Tensor:
    """TB bits [B, tbs] -> the codeword's G bits [B, G] (5.3.2.1-5.3.2.5):
    CRC24A, segmentation (the filler bits, 0 for the CRCs and the encoder,
    lead the first block, whose rate matching skips them), CRC24B when
    there is more than one block, turbo encoding, rate matching with E of
    5.1.4.1.2 for ``n_l`` layers, concatenation in block order."""
    tb = tb.to(torch.int64)
    b, tbs = tb.shape
    a = torch.cat([tb, torch.as_tensor(spec.crc_bits(
        tb.numpy().astype(np.uint8), spec.CRC24A), dtype=torch.int64)], -1)
    c, ks, f = spec.segmentation(tbs)
    blocks, pos = [], 0
    for r, k in enumerate(ks):
        fr = f if r == 0 else 0
        take = k - fr - (24 if c > 1 else 0)
        cb = torch.cat([torch.zeros((b, fr), dtype=torch.int64),
                        a[:, pos:pos + take]], -1)
        pos += take
        if c > 1:
            cb = torch.cat([cb, torch.as_tensor(spec.crc_bits(
                cb.numpy().astype(np.uint8), spec.CRC24B),
                dtype=torch.int64)], -1)
        blocks.append(cb)
    assert pos == tbs + 24
    # the blocks of one K through the encoder together
    coded = [None] * c
    for k in set(ks):
        idx = [r for r in range(c) if ks[r] == k]
        d = turbo_encode(torch.cat([blocks[r] for r in idx]))
        for j, r in enumerate(idx):
            coded[r] = d[j * b:(j + 1) * b].reshape(b, -1)
    out = []
    for r, (k, e) in enumerate(zip(ks, spec.e_sizes(g, c, qm, n_l))):
        sel = spec.selection(k, f if r == 0 else 0, rv, e)
        out.append(coded[r][:, torch.as_tensor(sel)])
    return torch.cat(out, -1)


# --- the PDSCH, TS 36.211 6.3 ---------------------------------------------


def modulate(bits: torch.Tensor, qm: int) -> torch.Tensor:
    """Gray-mapped QPSK, 16QAM or 64QAM (7.1.3-7.1.5): [..., M qm] ->
    [..., M] complex128. I takes the even bits, Q the odd ones; the first
    pair gives the signs, the later pairs the amplitude."""
    b = 1.0 - 2.0 * bits.to(torch.float64).reshape(*bits.shape[:-1], -1, qm)
    if qm == 2:
        i, q, norm = b[..., 0], b[..., 1], math.sqrt(2)
    elif qm == 4:
        i = b[..., 0] * (2 - b[..., 2])
        q = b[..., 1] * (2 - b[..., 3])
        norm = math.sqrt(10)
    elif qm == 6:
        i = b[..., 0] * (4 - b[..., 2] * (2 - b[..., 4]))
        q = b[..., 1] * (4 - b[..., 3] * (2 - b[..., 5]))
        norm = math.sqrt(42)
    else:
        raise ValueError(qm)
    return torch.complex(i, q) / norm


def _spacing(qm: int) -> float:
    """The least distance between two points of the constellation."""
    return 2 / math.sqrt({2: 2, 4: 10, 6: 42}[qm])


def pdsch_ports(tbs_bits: list, conf: dict) -> tuple:
    """Each codeword's TB bits [B, tbs] -> (the two ports' PDSCH symbols
    [B, 2, M] in 6.3.5's order, the radius of a port's symbols [2]).
    One codeword maps onto two layers d(2i), d(2i + 1), two codewords one
    layer each (Table 6.3.3.2-1)."""
    prb, cid, sf = conf["nof_prb"], conf["cell_id"], conf["sf_idx"]
    qm, ncw = dl_pdsch.qm_of_mcs(conf["mcs"]), len(tbs_bits)
    if conf["nof_layers"] != 2:
        raise NotImplementedError("two layers")
    res = dl_pdsch.pdsch_res(cid, prb, 2, conf["cfi"], sf)
    n_l = 2 // ncw                       # layers of each codeword
    g = len(res) * qm * n_l
    cws = []
    for q, tb in enumerate(tbs_bits):
        e = dlsch(torch.as_tensor(tb), g, qm, n_l)
        c_init = (conf["rnti"] << 14) + (q << 13) + (sf << 9) + cid
        cws.append(modulate(e ^ torch.tensor(
            spec.gold(c_init, g), dtype=torch.int64), qm))
    if ncw == 2:
        x = torch.stack(cws, -2)                           # [B, 2, M]
    else:
        x = torch.stack([cws[0][..., 0::2], cws[0][..., 1::2]], -2)
    w = torch.as_tensor(dl_pdsch.precoder(conf["pmi"]), dtype=CPLX)
    y = torch.einsum("pl,blm->bpm", w, x)
    radius = torch.tensor([_spacing(qm) / 2 * min(
        abs(complex(v)) for v in w[p] if abs(complex(v)) > 0)
        for p in range(2)], dtype=torch.float64)
    return y, radius


def pdsch_g(conf: dict, ncw: int) -> int:
    """G, the bits each codeword carries."""
    res = dl_pdsch.pdsch_res(conf["cell_id"], conf["nof_prb"], 2,
                             conf["cfi"], conf["sf_idx"])
    return len(res) * dl_pdsch.qm_of_mcs(conf["mcs"]) * (2 // ncw)


# --- DCIs and the search space, TS 36.212 5.3.3 and 36.213 9.1.1 ----------

#: payload sizes a zero bit is appended to (36.212 5.3.3.1.2)
AMBIGUOUS = (12, 14, 16, 20, 24, 26, 32, 40, 44, 56)


def _bits(value: int, n: int) -> list:
    return [(value >> (n - 1 - i)) & 1 for i in range(n)]


def riv(nof_prb: int, start: int, length: int) -> int:
    """The resource indication value (36.213 8.1.1, 7.1.6.3)."""
    if length - 1 <= nof_prb // 2:
        return nof_prb * (length - 1) + start
    return nof_prb * (nof_prb - length + 1) + (nof_prb - 1 - start)


def format1a_size(nof_prb: int) -> int:
    """Format 1A, FDD (5.3.3.1.3): flag, localized/distributed, RIV, MCS,
    HARQ process (3), NDI, RV, TPC."""
    n = 1 + 1 + math.ceil(math.log2(nof_prb * (nof_prb + 1) / 2)) \
        + 5 + 3 + 1 + 2 + 2
    return n + (n in AMBIGUOUS)


def format0(nof_prb: int, start: int, length: int, mcs: int,
            n_dmrs: int = 0) -> np.ndarray:
    """A format-0 grant, FDD, no hopping (5.3.3.1.1): flag 0, hopping flag
    0, the RIV, MCS and RV, NDI 0, TPC 0, the DMRS cyclic shift field
    (``n_dmrs``; 000 gives n_DMRS 0), CQI request 0, zeros up to format
    1A's size."""
    n_riv = math.ceil(math.log2(nof_prb * (nof_prb + 1) / 2))
    bits = ([0, 0] + _bits(riv(nof_prb, start, length), n_riv)
            + _bits(mcs, 5) + [0] + [0, 0] + _bits(n_dmrs, 3) + [0])
    size = format1a_size(nof_prb)
    if len(bits) > size:
        raise ValueError("format 0 larger than format 1A")
    return np.asarray(bits + [0] * (size - len(bits)), np.int64)


def format1_size(nof_prb: int) -> int:
    """Format 1, resource allocation type 0 or 1 (5.3.3.1.2): the RA header
    above 10 PRB, the RBG bitmap, MCS, HARQ process (3), NDI, RV, TPC; one
    zero more where the size equals format 0/1A's or an ambiguous one."""
    p = 1 if nof_prb <= 10 else 2 if nof_prb <= 26 else 3 \
        if nof_prb <= 63 else 4
    n = (nof_prb > 10) + math.ceil(nof_prb / p) + 5 + 3 + 1 + 2 + 2
    while n == format1a_size(nof_prb) or n in AMBIGUOUS:
        n += 1
    return n


def ue_candidates(rnti: int, sf_idx: int, n_cce: int, level: int) -> list:
    """First CCEs of the UE-specific search space's candidates at
    aggregation level ``level`` in subframe ``sf_idx`` (36.213 9.1.1:
    Y_k = 39827 Y_(k-1) mod 65537, Y_-1 = n_RNTI)."""
    y = rnti
    for _ in range(sf_idx + 1):
        y = (39827 * y) % 65537
    m = {1: 6, 2: 6, 4: 2, 8: 2}[level]
    return [level * ((y + i) % (n_cce // level)) for i in range(m)]


def phich_resource(nof_prb: int, prb_start: int, n_dmrs: int = 0,
                   ng: float = 1.0) -> tuple:
    """(group, sequence) of a PUSCH's HI (36.213 9.1.2, normal CP):
    (I_PRB + n_DMRS) mod N_group, (floor(I_PRB / N_group) + n_DMRS) mod 8."""
    n_group = math.ceil(ng * nof_prb / 8)
    return ((prb_start + n_dmrs) % n_group,
            (prb_start // n_group + n_dmrs) % 8)


# --- the control region, TS 36.211 6.7-6.9 ---------------------------------

#: the PHICH's orthogonal sequences, normal CP (Table 6.9.1-2)
PHICH_W = ((1, 1, 1, 1), (1, -1, 1, -1), (1, 1, -1, -1), (1, -1, -1, 1),
           (1j, 1j, 1j, 1j), (1j, -1j, 1j, -1j), (1j, 1j, -1j, -1j),
           (1j, -1j, -1j, 1j))


def phich_symbols(hi: int, seq: int, sf_idx: int,
                  cell_id: int) -> torch.Tensor:
    """d(0..11) of one HI (6.9.1): the three coded bits <HI, HI, HI>
    (36.212 5.3.5), BPSK (7.1.1: b -> (1 - 2b)(1 + j)/sqrt(2)), each
    spread by w(i mod 4) and scrambled with c_init = (floor(n_s / 2) + 1)
    (2 N_ID + 1) 2^9 + N_ID."""
    z = (1 - 2 * hi) * (1 + 1j) / math.sqrt(2)
    c_init = ((sf_idx + 1) * (2 * cell_id + 1) << 9) + cell_id
    c = spec.gold(c_init, 12)
    return torch.tensor([PHICH_W[seq][i % 4] * (1 - 2 * int(c[i])) * z
                         for i in range(12)], dtype=CPLX)


def control_layout(conf: dict, ng: float = 1.0) -> dict:
    """The control region's REGs (6.2.4): the PCFICH's four, each PHICH
    group's three (6.9.3, normal duration) and the PDCCH's, in the order
    the quadruplets go (6.8.5: frequency first, then time)."""
    prb, cid, cfi = conf["nof_prb"], conf["cell_id"], conf["cfi"]
    nsymb = cfi + 1 if prb <= 10 else cfi
    every = dl_control.regs(prb, cid, nsymb)
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


def phich_region(conf: dict, phichs: list, ng: float = 1.0
                 ) -> torch.Tensor:
    """The HIs of ``phichs`` as (hi, group, sequence) on the two ports'
    control region [2, nsymb, 12 N_RB] (6.9): a group's HIs summed,
    transmit diversity (6.9.2, normal CP), the quadruplets on the group's
    REGs in turn (6.9.3), every other RE 0."""
    lay = control_layout(conf, ng)
    out = torch.zeros((2, lay["nsymb"], 12 * conf["nof_prb"]), dtype=CPLX)
    for hi, group, seq in phichs:
        y = dl_control.tx_diversity(phich_symbols(
            hi, seq, conf["sf_idx"], conf["cell_id"]).numpy())
        for i, (l, _k0, ks) in enumerate(lay["phich"][group]):
            out[:, l, ks] += torch.as_tensor(y[:, 4 * i:4 * i + 4])
    return out


def control_region(conf: dict, dcis: list, phichs: list,
                   ng: float = 1.0) -> torch.Tensor:
    """The two ports' control region [2, nsymb, 12 N_RB] complex128: the
    CFI, each HI of ``phichs`` as (hi, group, sequence) and each DCI of
    ``dcis`` as (payload bits, aggregation level, first CCE), every other
    RE 0."""
    prb, cid, sf, cfi = (conf["nof_prb"], conf["cell_id"], conf["sf_idx"],
                         conf["cfi"])
    lay = control_layout(conf, ng)
    out = torch.zeros((2, lay["nsymb"], 12 * prb), dtype=CPLX)

    def put(reg, quad):                   # four symbols a port onto a REG
        l, _k0, ks = reg
        out[:, l, ks] += torch.as_tensor(quad, dtype=CPLX)

    # PCFICH (6.7, 36.212 5.3.4)
    bits = np.resize(dl_control.CFI_CODEWORDS[cfi], 32)
    c_init = ((sf + 1) * (2 * cid + 1) << 9) + cid
    y = dl_control.tx_diversity(dl_control.qpsk(bits ^ spec.gold(c_init,
                                                                  32)))
    for i, reg in enumerate(lay["pcfich"]):
        put(reg, y[:, 4 * i:4 * i + 4])
    out += phich_region(conf, phichs, ng)
    # PDCCH (6.8, 36.212 5.3.3): each DCI with its CRC16 masked by the
    # RNTI, convolutional coding and rate matching, at its first CCE
    m_quad = len(lay["pdcch"])
    total = 8 * m_quad
    seq = spec.gold((sf << 9) + cid, total)
    sym = np.zeros(total // 2, complex)
    rnti = np.array(_bits(conf["rnti"], 16))
    for payload, level, cce in dcis:
        a = np.asarray(payload, np.int64)
        p = spec.crc_bits(a.astype(np.uint8), spec.CRC16).astype(np.int64)
        e = 72 * level
        coded = dl_control.conv_rate_match(
            dl_control.conv_encode(np.concatenate([a, p ^ rnti])), e)
        first = 72 * cce
        sym[first // 2:(first + e) // 2] = dl_control.qpsk(
            coded ^ seq[first:first + e])
    quads = dl_control.tx_diversity(sym).reshape(2, m_quad, 4)
    r = math.ceil(m_quad / 32)
    idx = np.concatenate([np.full(32 * r - m_quad, -1), np.arange(m_quad)])
    order = idx.reshape(r, 32)[:, list(dl_control.CONV_PERM)].T.reshape(-1)
    order = order[order >= 0]
    for m in range(m_quad):
        put(lay["pdcch"][m], quads[:, order[(m + cid) % m_quad]])
    return out


# --- the subframe and its OFDM signal, TS 36.211 6.10 and 6.12 -------------


def ofdm(grid: torch.Tensor, nof_prb: int) -> torch.Tensor:
    """grid [..., 14, 12 N_RB] -> samples [..., 14 N + the prefixes] (6.12):
    subcarrier k(-) = k + 6 N_RB of k < 0 and k(+) = k + 6 N_RB - 1 of
    k > 0 at frequency k, none at DC, each symbol's cyclic prefix (160 and
    144 samples at N = 2048) its last samples. The 1/N of the inverse DFT
    is not in 6.12: the scale is the implementation's, and the port's
    (an inverse FFT whose forward FFT gives the grid back)."""
    n = spec.FFT[nof_prb]
    half = 6 * nof_prb
    bins = torch.zeros((*grid.shape[:-1], n), dtype=CPLX)
    bins[..., n - half:] = grid[..., :half]
    bins[..., 1:1 + half] = grid[..., half:]
    sym = torch.fft.ifft(bins, dim=-1)
    pieces = []
    for l in range(14):
        cp = (160 if l % 7 == 0 else 144) * n // 2048
        pieces += [sym[..., l, n - cp:], sym[..., l, :]]
    return torch.cat(pieces, -1)


def transmit(tbs_bits: list, conf: dict, dl_dci, hi: int,
             lower: bool = False) -> dict:
    """Subframes of the configuration's grants from each codeword's TB
    bits [B, tbs], the format-1 payload ``dl_dci`` and the HI ``hi`` ->
    dict(grid [B, 2, 14, 12 N_RB], samples [B, 2, sf_len], radius
    [2, 14, 12 N_RB]): the downlink grant's DCI at its level and CCE, the
    format-0 grant packed here at its CCE, the HI at the uplink grant's
    PHICH, CFI, CRS and PDSCH. With ``lower`` the grid and the samples are
    stored in bfloat16."""
    prb, cid, sf = conf["nof_prb"], conf["cell_id"], conf["sf_idx"]
    ng = conf["phich_ng"]
    if conf["nof_ports"] != 2 or sf in (0, 5):
        raise NotImplementedError("two ports, a subframe other than 0, 5")
    lay = control_layout(conf, ng)
    if len(dl_dci) != format1_size(prb):
        raise ValueError("the downlink DCI is not format 1's size")
    if conf["ul_dci_cce"] not in ue_candidates(
            conf["rnti"], sf, lay["n_cce"], conf["ul_dci_l"]):
        raise ValueError("the format-0 DCI is off the UE's search space")
    ul = format0(prb, conf["ul_prb_start"], conf["ul_n_prb"],
                 conf["ul_mcs"], conf["n_dmrs"])
    group, seq = phich_resource(prb, conf["ul_prb_start"], conf["n_dmrs"],
                                ng)
    ctrl = control_region(
        conf, [(dl_dci, conf["dci_l"], conf["dci_cce"]),
               (ul, conf["ul_dci_l"], conf["ul_dci_cce"])],
        [(hi, group, seq)], ng)
    b = len(tbs_bits[0])
    grid = torch.zeros((b, 2, 14, 12 * prb), dtype=CPLX)
    grid[:, :, :lay["nsymb"]] = ctrl
    y, pdsch_r = pdsch_ports(tbs_bits, conf)
    res = torch.as_tensor(dl_pdsch.pdsch_res(cid, prb, 2, conf["cfi"], sf))
    grid.view(b, 2, -1)[..., res] = y
    # the radius of every RE: that of the signal there, and at an RE with
    # nothing on it the least of any signal's
    empty = min(float(pdsch_r.min()), 0.5)
    radius = torch.full((2, 14, 12 * prb), empty, dtype=torch.float64)
    radius[:, :lay["nsymb"]][ctrl != 0] = 0.5     # PCFICH, PHICH, PDCCH
    radius.view(2, -1)[:, res] = pdsch_r[:, None]
    for p in range(2):
        syms, offs, vals = dl_pdsch.crs(cid, prb, sf, p)
        for s, o, v in zip(syms, offs, vals):
            grid[:, p, s, o::6] = torch.as_tensor(v, dtype=CPLX)
            radius[p, s, o::6] = math.sqrt(2) / 2
    if lower:
        grid = torch.as_tensor(spec.bf16(grid.numpy()))
    samples = ofdm(grid, prb)
    if lower:
        samples = torch.as_tensor(spec.bf16(samples.numpy()))
    return dict(grid=grid, samples=samples, radius=radius)


def demodulate(samples, nof_prb: int) -> torch.Tensor:
    """The grid [..., 14, 12 N_RB] complex128 of samples [..., sf_len],
    by ``dl_pdsch.ofdm_demod`` (an unnormalised FFT a symbol)."""
    return torch.as_tensor(dl_pdsch.ofdm_demod(np.asarray(samples),
                                               nof_prb))


def decided_apart(samples, ref: dict, nof_prb: int) -> int:
    """REs, over every subframe, port, symbol and subcarrier, where the
    grid of ``samples`` [B, 2, sf_len] lies at least ``radius`` from the
    reference's grid: a nearest-point decision there can pick another
    point of the RE's signal."""
    got = demodulate(samples, nof_prb)
    return int(((got - ref["grid"]).abs() >= ref["radius"]).sum())
