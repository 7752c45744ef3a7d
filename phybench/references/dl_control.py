"""The downlink control region as TS 36.211/36.212 define it: PCFICH and
one PDCCH, for two antenna ports and a normal cyclic prefix.

It imports nothing of the program and nothing of ``phybench.frozen``. The
benchmark's transmitter is a copy of the port's encoders; the test that
holds its control region to this one, resource element by resource
element, is what makes the window's counts of CFIs read wrong and DCIs
missed a check of the port against the specification and not against
itself.

* REGs (6.2.4): in symbol 0 two of six subcarriers a PRB (four REs each,
  the CRS of ports 0 and 1 left out), in later symbols three of four.
* PCFICH (6.7, 36.212 5.3.4): the CFI's 32-bit codeword, scrambled,
  QPSK, transmit diversity, on the four REGs from k = 6 (N_ID mod
  2 N_RB) a quarter of the band apart.
* PHICH (6.9.3, normal duration): ceil(N_g N_RB / 8) groups of three REGs
  in symbol 0, at n_i = (N_ID + m + floor(i n_0 / 3)) mod n_0 among the
  REGs the PCFICH leaves; left empty, as the benchmark sends no HARQ
  indicators.
* PDCCH (6.8, 36.212 5.3.3): the DCI with its CRC16 masked by the RNTI,
  the tail-biting convolutional code (133, 171, 165 octal), its rate
  matching (5.1.4.2), the CCEs' bits placed at the PDCCH's first CCE,
  scrambled over the whole region, QPSK, transmit diversity, the
  quadruplets through the sub-block interleaver and a cyclic shift of
  N_ID, and onto the remaining REGs in order of frequency, then time.
"""

from __future__ import annotations

import math

import numpy as np

from . import spec

CFI_CODEWORDS = {1: [0, 1, 1], 2: [1, 0, 1], 3: [1, 1, 0]}
#: the convolutional code's sub-block interleaver permutation (Table
#: 5.1.4-2)
CONV_PERM = (1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
             0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30)
#: the generators 133, 171, 165 (octal): taps on c_k, c_{k-1}, ...
GENERATORS = [[int(b) for b in format(g, "07b")] for g in (0o133, 0o171,
                                                             0o165)]


def regs(nof_prb: int, cell_id: int, nsymb: int) -> list:
    """(l, first subcarrier, the REG's 4 subcarriers) of every REG of the
    control region's ``nsymb`` symbols."""
    out = []
    for l in range(nsymb):
        for prb in range(nof_prb):
            if l == 0:
                rs = cell_id % 3
                for half in (0, 6):
                    k0 = 12 * prb + half
                    out.append((l, k0, [k0 + i for i in range(6)
                                        if i % 3 != rs]))
            else:
                for q in (0, 4, 8):
                    k0 = 12 * prb + q
                    out.append((l, k0, list(range(k0, k0 + 4))))
    return out


def qpsk(bits: np.ndarray) -> np.ndarray:
    b = np.asarray(bits, np.float64)
    return ((1 - 2 * b[0::2]) + 1j * (1 - 2 * b[1::2])) / math.sqrt(2)


def tx_diversity(d: np.ndarray) -> np.ndarray:
    """Two ports (6.3.3.3, 6.3.4.3): symbols [n] -> [2, n]."""
    x0, x1 = d[0::2], d[1::2]
    y = np.zeros((2, len(d)), complex)
    y[0, 0::2], y[1, 0::2] = x0, -np.conj(x1)
    y[0, 1::2], y[1, 1::2] = x1, np.conj(x0)
    return y / math.sqrt(2)


def conv_encode(c: np.ndarray) -> np.ndarray:
    """Tail-biting, rate 1/3: -> [3, K]."""
    k = len(c)
    return np.stack([sum(g[j] * np.roll(c, j) for j in range(7)) % 2
                     for g in GENERATORS])


def conv_rate_match(d: np.ndarray, e: int) -> np.ndarray:
    """[3, K] -> E bits (5.1.4.2)."""
    k = d.shape[1]
    r = math.ceil(k / 32)
    nd = 32 * r - k
    streams = []
    for s in range(3):
        y = np.concatenate([np.full(nd, -1), d[s]])
        mat = y.reshape(r, 32)[:, list(CONV_PERM)]
        streams.append(mat.T.reshape(-1))
    w = np.concatenate(streams)
    w = w[w >= 0]
    return np.resize(w, e)


def control_region(conf: dict, dci_bits, ng: float = 1.0) -> np.ndarray:
    """The two ports' control region [2, nsymb, 12 N_RB] complex128:
    PCFICH and the one PDCCH of ``dci_bits`` at the configuration's CCE
    and aggregation level, every other RE 0."""
    prb, cid, sf, cfi = (conf["nof_prb"], conf["cell_id"], conf["sf_idx"],
                         conf["cfi"])
    nsymb = cfi + 1 if prb <= 10 else cfi
    out = np.zeros((2, nsymb, 12 * prb), complex)
    every = regs(prb, cid, nsymb)
    sym0 = [r for r in every if r[0] == 0]

    def put(reg, quad):                   # four symbols a port onto a REG
        l, _k0, ks = reg
        out[:, l, ks] = quad

    # PCFICH
    bits = np.resize(CFI_CODEWORDS[cfi], 32)
    c_init = ((sf + 1) * (2 * cid + 1) << 9) + cid
    y = tx_diversity(qpsk(bits ^ spec.gold(c_init, 32)))
    kbar = 6 * (cid % (2 * prb))
    starts = [(kbar + (i * prb // 2) * 6) % (12 * prb) for i in range(4)]
    pcfich = [next(r for r in sym0 if r[1] == s) for s in starts]
    for i, reg in enumerate(pcfich):
        put(reg, y[:, 4 * i:4 * i + 4])
    # PHICH groups' REGs, left empty
    rest0 = [r for r in sym0 if r not in pcfich]
    n0 = len(rest0)
    phich = {(rest0[(cid + m + (i * n0) // 3) % n0][1], 0)
             for m in range(math.ceil(ng * prb / 8)) for i in range(3)}
    # PDCCH
    free = sorted((r for r in every if r not in pcfich
                   and (r[1], r[0]) not in phich), key=lambda r: (r[1], r[0]))
    m_quad = len(free)
    a = np.asarray(dci_bits, np.int64)
    p = spec.crc_bits(a.astype(np.uint8), spec.CRC16).astype(np.int64)
    rnti = np.array([(conf["rnti"] >> (15 - i)) & 1 for i in range(16)])
    e = 72 * conf["dci_l"]
    coded = conv_rate_match(conv_encode(np.concatenate([a, p ^ rnti])), e)
    total = 8 * m_quad
    first = 72 * conf["dci_cce"]
    seq = spec.gold((sf << 9) + cid, total)
    sym = np.zeros(total // 2, complex)
    sym[first // 2:(first + e) // 2] = qpsk(coded ^ seq[first:first + e])
    y = tx_diversity(sym)                                   # [2, 4 M_quad]
    quads = y.reshape(2, m_quad, 4)
    # sub-block interleaver on the quadruplets, then the cyclic shift
    r = math.ceil(m_quad / 32)
    nd = 32 * r - m_quad
    idx = np.concatenate([np.full(nd, -1), np.arange(m_quad)])
    order = idx.reshape(r, 32)[:, list(CONV_PERM)].T.reshape(-1)
    order = order[order >= 0]
    for m in range(m_quad):
        put(free[m], quads[:, order[(m + cid) % m_quad]])
    return out
