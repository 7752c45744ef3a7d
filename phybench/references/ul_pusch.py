"""The plain receiver of the PUSCH with UCI, from the specification.

It imports nothing of the program and nothing of ``phybench.frozen``. From
the samples [B, sf_len] at one eNB antenna:

* SC-FDMA (TS 36.211 5.6): per symbol the normal cyclic prefix dropped,
  the half-subcarrier shift undone from the start of the symbol's useful
  part, an unnormalised FFT, subcarriers k = 0..12 N_RB - 1 at
  frequencies k - 6 N_RB (no DC gap in the uplink);
* the DMRS (5.5.2.1) in symbol 3 of each slot: the Zadoff-Chu base
  sequence of group u = (N_ID + delta_ss) mod 30 (no group or sequence
  hopping) and the cyclic shift n_cs = (n_DMRS(1) + n_DMRS(2) +
  n_PN(ns)) mod 12; a least-squares estimate, the three-tap average
  (1/3 each, ends repeated) across the allocation, linear interpolation
  in time between the two DMRS symbols, extrapolated;
* the MMSE x = y conj(h) / (|h|^2 + N0), the unitary IDFT of the
  transform precoding (5.3.3), the piecewise-linear max-log LLRs
  weighted by the symbol's mean |h|^2, and the descrambling (5.3.1);
* UCI on the PUSCH (TS 36.212 5.2.2.6-5.2.2.8): the numbers of coded
  HARQ-ACK, RI and CQI symbols, the channel interleaver's RI and ACK
  positions (the ACK's LLRs, which puncture the data, set to 0), and
  the UL-SCH's bits after the CQI's;
* the UL-SCH decode as ``spec.sch_decode``.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from . import spec

#: beta offsets by I_offset, TS 36.213 Tables 8.6.3-1 (HARQ-ACK), -2 (RI)
#: and -3 (CQI; I_offset 0 and 1 reserved)
BETA_ACK = (2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0, 12.625, 15.875,
            20.0, 31.0, 50.0, 80.0, 126.0)
BETA_RI = (1.25, 1.625, 2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0, 12.625,
           15.875, 20.0)
BETA_CQI = (None, None, 1.125, 1.25, 1.375, 1.625, 1.75, 2.0, 2.25, 2.5,
            2.875, 3.125, 3.5, 4.0, 5.0, 6.25)
#: the channel interleaver's column sets, normal cyclic prefix
RI_COLUMNS, ACK_COLUMNS = (1, 4, 7, 10), (2, 3, 8, 9)
DMRS_SYMBOLS = (3, 10)


def qm_of_mcs(mcs: int) -> int:
    """Modulation order of a PUSCH MCS (TS 36.213 Table 8.6.1-1)."""
    return 2 if mcs <= 10 else 4 if mcs <= 20 else 6


def sc_fdma_demod(samples: np.ndarray, nof_prb: int) -> np.ndarray:
    """[..., sf_len] -> grid [..., 14, 12 N_RB] complex128."""
    n = spec.FFT[nof_prb]
    cp0, cp = 160 * n // 2048, 144 * n // 2048
    starts, pos = [], 0
    for sym in range(14):
        pos += cp0 if sym % 7 == 0 else cp
        starts.append(pos)
        pos += n
    x = np.stack([samples[..., s:s + n] for s in starts], -2)
    x = x.astype(np.complex128) * np.exp(-1j * np.pi * np.arange(n) / n)
    f = np.fft.fft(x, axis=-1)
    k = np.arange(12 * nof_prb) - 6 * nof_prb
    return f[..., k % n]


def n_pn(cell_id: int, delta_ss: int, ns: int) -> int:
    """n_PN(ns) = sum_i c(8 N_symb ns + i) 2^i, c_init = floor(N_ID / 30)
    2^5 + f_ss (5.5.2.1.1)."""
    f_ss = (cell_id + delta_ss) % 30
    c = spec.gold(((cell_id // 30) << 5) + f_ss, 8 * 7 * 20)
    return sum(int(c[8 * 7 * ns + i]) << i for i in range(8))


def _largest_prime_below(m: int) -> int:
    p = m - 1
    while any(p % d == 0 for d in range(2, int(p ** 0.5) + 1)):
        p -= 1
    return p


@functools.lru_cache(maxsize=16)
def dmrs(cell_id: int, n_prb: int, sf_idx: int, n_dmrs: int = 0,
         delta_ss: int = 0) -> np.ndarray:
    """The PUSCH DMRS of both slots [2, 12 n_prb] for an allocation of
    at least 3 PRB (5.5.1.1, 5.5.2.1.1)."""
    m = 12 * n_prb
    if n_prb < 3:
        raise NotImplementedError("1-2 PRB take the tabled sequences")
    u, v = (cell_id + delta_ss) % 30, 0
    nzc = _largest_prime_below(m)
    q_bar = nzc * (u + 1) / 31
    q = math.floor(q_bar + 0.5) + v * (-1) ** math.floor(2 * q_bar)
    i = np.arange(nzc)
    xq = np.exp(-1j * np.pi * q * i * (i + 1) / nzc)
    n = np.arange(m)
    out = []
    for slot in range(2):
        ncs = (n_dmrs + n_pn(cell_id, delta_ss, 2 * sf_idx + slot)) % 12
        out.append(np.exp(2j * np.pi * ncs / 12 * n) * xq[n % nzc])
    return np.stack(out)


def chest(grid: np.ndarray, conf: dict) -> np.ndarray:
    """grid [..., 14, K] -> the allocation's channel [..., 14, 12 n_prb]."""
    k0, m = 12 * conf["prb_start"], 12 * conf["n_prb"]
    r = dmrs(conf["cell_id"], conf["n_prb"], conf["sf_idx"])
    h = [grid[..., s, k0:k0 + m] * np.conj(r[i])
         for i, s in enumerate(DMRS_SYMBOLS)]
    h = [(np.concatenate([x[..., :1], x[..., :-1]], -1) + x
          + np.concatenate([x[..., 1:], x[..., -1:]], -1)) / 3 for x in h]
    t = ((np.arange(14) - DMRS_SYMBOLS[0])
         / (DMRS_SYMBOLS[1] - DMRS_SYMBOLS[0]))[:, None]
    return h[0][..., None, :] * (1 - t) + h[1][..., None, :] * t


@functools.lru_cache(maxsize=16)
def uci_layout(n_prb: int, qm: int, tbs: int, o_ack: int, o_ri: int,
               o_cqi: int, i_ack: int, i_ri: int, i_cqi: int) -> dict:
    """Coded symbols of each UCI field and the channel interleaver: ->
    dict(q_ack, q_ri, q_cqi (Q'), ack (positions in the interleaver's
    output bits), data (the output position of each of the CQI + UL-SCH
    bits g, in order))."""
    m_sc, n_symb = 12 * n_prb, 12
    c, ks, _f = spec.segmentation(tbs)
    k_sum = sum(ks)
    q_ack = min(math.ceil(o_ack * m_sc * n_symb * BETA_ACK[i_ack] / k_sum),
                4 * m_sc) if o_ack else 0
    q_ri = min(math.ceil(o_ri * m_sc * n_symb * BETA_RI[i_ri] / k_sum),
               4 * m_sc) if o_ri else 0
    l_crc = 0 if o_cqi <= 11 else 8
    q_cqi = min(math.ceil((o_cqi + l_crc) * m_sc * n_symb * BETA_CQI[i_cqi]
                          / k_sum), m_sc * n_symb - q_ri) if o_cqi else 0
    rows = m_sc                       # R'_mux: H'_total / C_mux symbols

    def out_pos(r, col):              # read out column by column
        return (col * rows + r) * qm + np.arange(qm)

    def field(count, cols):
        return [(rows - 1 - i // 4, cols[(3 * i) % 4]) for i in range(count)]

    ri_cells = set(field(q_ri, RI_COLUMNS))
    data = [out_pos(r, col) for r in range(rows) for col in range(n_symb)
            if (r, col) not in ri_cells]
    ack = [out_pos(r, col) for r, col in field(q_ack, ACK_COLUMNS)]
    return dict(q_ack=q_ack, q_ri=q_ri, q_cqi=q_cqi,
                ack=np.concatenate(ack) if ack else np.zeros(0, int),
                data=np.concatenate(data))


def receive(samples: np.ndarray, conf: dict, n0: float, o_cqi: int,
            lower: bool = False) -> dict:
    """samples [B, sf_len] -> dict(soft [B, C, 3 (K+4)] the UL-SCH's
    de-rate-matched LLRs, bits [B, tbs] uint8, crc [B] bool, iterations
    [B, C])."""
    rnd = spec.Rounding(lower)
    prb, cid, sf = conf["nof_prb"], conf["cell_id"], conf["sf_idx"]
    k0, m, tbs = 12 * conf["prb_start"], 12 * conf["n_prb"], conf["tbs"]
    qm = qm_of_mcs(conf["mcs"])
    grid = rnd(sc_fdma_demod(np.asarray(samples), prb))
    h = rnd(chest(grid, conf))
    data_syms = [s for s in range(14) if s not in DMRS_SYMBOLS]
    y, hh = grid[..., data_syms, k0:k0 + m], h[..., data_syms, :]
    h2 = np.abs(hh) ** 2
    x = y * np.conj(hh) / (h2 + n0)
    x = rnd(np.fft.ifft(x, axis=-1) * math.sqrt(m))
    llr = spec.llrs(x, qm) * np.repeat(h2.mean(-1)[..., None], m * qm, -1)
    llr = rnd(llr.reshape(llr.shape[0], -1))
    c_init = (conf["rnti"] << 14) + (sf << 9) + cid
    llr = llr * spec.signs(c_init, llr.shape[-1])
    lay = uci_layout(conf["n_prb"], qm, tbs, len(conf["ack"]),
                     1 if conf.get("ri") is not None else 0, o_cqi,
                     conf.get("i_offset_ack", 2), conf.get("i_offset_ri", 2),
                     conf.get("i_offset_cqi", 7))
    llr = llr.copy()
    llr[:, lay["ack"]] = 0.0
    g = llr[:, lay["data"]]
    soft = [rnd(s) for s in spec.sch_softbuffers(g[:, lay["q_cqi"] * qm:],
                                                 tbs, qm)]
    bits, ok, its = spec.sch_decode(soft, tbs, conf["max_iterations"])
    return dict(soft=np.stack(soft, -2), bits=bits, crc=ok, iterations=its)
