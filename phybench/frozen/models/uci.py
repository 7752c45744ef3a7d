"""UCI on PUSCH: Reed-Muller block codes, CQI payloads and the UCI layout
(36.212 5.2.2.6-5.2.2.8).

Capability parity with lib/src/phy/phch/uci.c (RM (32,O) for PUSCH-borne
CQI, conv-coded CQI with CRC8 for O > 11, RI/HARQ-ACK bit patterns),
cqi.c payload pack/unpack and sch.c's UL-SCH channel interleaver.
Counterpart of the JAX package's models/uci.py: the static per-grant
layout (Q' sizes, RI/ACK positions, the interleaver permutation) is
computed on the host with numpy, decoding is torch. Short CQI decodes
by ML correlation against all 2^O codewords (one matrix product); long
CQI by conv de-rate-matching, the Viterbi kernel (ops/fec/viterbi37.py
on the card) and CRC8. The PUCCH format-2 RM (20,O) code decodes the
same way as the short CQI, against its own basis.
"""

from __future__ import annotations

import functools
import math
import pathlib

import numpy as np
import torch

from ..ops.fec.convcoder import conv_encode
from ..ops.fec.rm_conv import _selection
from ..utils.crc import CRC8

_DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


@functools.lru_cache(maxsize=2)
def _basis(n: int) -> np.ndarray:
    """RM basis [n, 11 or 13]: PUSCH's (32, O) or PUCCH's (20, O)."""
    if n not in (20, 32):
        raise ValueError(f"RM ({n}, O): n must be 20 or 32")
    return np.load(_DATA / f"rm{n}_basis.npy")


def rm_encode(bits: np.ndarray, n_out: int = 32) -> np.ndarray:
    """RM (n_out, O) encode on the host: bits [..., O] -> [..., n_out]
    (O <= 11 for n_out 32, O <= 13 for n_out 20)."""
    o = bits.shape[-1]
    return np.mod(np.asarray(bits) @ _basis(n_out)[:, :o].T, 2) \
        .astype(np.int8)


def cqi_hl_subband_size(nof_prb: int) -> int:
    """Higher-layer-configured subband size k (36.213 Table 7.2.1-3)."""
    if nof_prb <= 7:
        return nof_prb            # wideband only; one "subband"
    if nof_prb <= 26:
        return 4
    if nof_prb <= 63:
        return 6
    return 8


def cqi_nof_subbands(nof_prb: int) -> int:
    return math.ceil(nof_prb / cqi_hl_subband_size(nof_prb))


def cqi_diff_encode(offset: int) -> int:
    if offset <= -1:
        return 3
    return min(offset, 2)


def cqi_pack_hl_subband(wb_cqi: int, sb_cqis, nof_prb: int) -> np.ndarray:
    """Aperiodic higher-layer-configured subband report (single codeword,
    no PMI): 4-bit wideband + 2-bit differential per subband."""
    n = cqi_nof_subbands(nof_prb)
    if len(sb_cqis) != n:
        raise ValueError(f"{len(sb_cqis)} subband CQIs, want {n}")
    bits = [(wb_cqi >> (3 - i)) & 1 for i in range(4)]
    for sb in sb_cqis:
        d = cqi_diff_encode(wb_cqi - int(sb))
        bits += [(d >> 1) & 1, d & 1]
    return np.array(bits, np.int8)


#: 36.213 Table 8.6.3-1/2/3 beta offsets (sch.c:48-58)
BETA_HARQ_OFFSET = (2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0,
                    12.625, 15.875, 20.0, 31.0, 50.0, 80.0, 126.0, -1.0)
BETA_RI_OFFSET = (1.25, 1.625, 2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0,
                  12.625, 15.875, 20.0, -1.0, -1.0, -1.0)
BETA_CQI_OFFSET = (-1.0, -1.0, 1.125, 1.25, 1.375, 1.625, 1.75, 2.0, 2.25,
                   2.5, 2.875, 3.125, 3.5, 4.0, 5.0, 6.25)

#: Bit-level codes used in RI/ACK patterns (uci.c encode_ri_ack)
UCI_BIT_0, UCI_BIT_1, UCI_BIT_REPETITION, UCI_BIT_PLACEHOLDER = 0, 1, 2, 3

#: Column sets for ACK (around DMRS) and RI placement (uci.c:504-534)
ACK_COLUMNS_NORM = (2, 3, 8, 9)
ACK_COLUMNS_EXT = (1, 2, 6, 7)
RI_COLUMNS_NORM = (1, 4, 7, 10)
RI_COLUMNS_EXT = (0, 3, 5, 8)


def q_prime_ri_ack(o: int, o_cqi: int, beta: float, m_sc_init: int,
                   n_symb_init: int, k_sum: int, m_sc: int) -> int:
    """Q' for RI or HARQ-ACK (36.212 5.2.2.6 / uci.c:548-571).

    k_sum = sum of code-block sizes of the UL-SCH TB; 0 when PUSCH carries
    UCI only (then the CQI payload rules 5.2.4.1 apply).
    """
    if k_sum == 0:
        k_sum = o_cqi if o_cqi <= 11 else o_cqi + 8
    x = int(np.ceil(o * m_sc_init * n_symb_init * beta / k_sum))
    return min(x, 4 * m_sc)


def q_prime_cqi(o: int, beta: float, q_ri: int, m_sc_init: int,
                n_symb_init: int, k_sum: int, m_sc: int,
                n_symb: int) -> int:
    """Q' for CQI/PMI (uci.c:270-287). L = 0 (O<11) or 8 (CRC8 appended)."""
    l = 0 if o < 11 else 8
    if k_sum > 0:
        x = int(np.ceil((o + l) * m_sc_init * n_symb_init * beta / k_sum))
    else:
        x = 1 << 30
    return min(x, m_sc * n_symb - q_ri)


def ri_ack_positions(q_prime: int, qm: int, rows: int, normal_cp: bool,
                     ack: bool) -> np.ndarray:
    """Bit positions in the q vector for Q' RI/ACK symbols
    (uci.c:499-545): symbol i sits at row = rows-1-i//4,
    col = column_set[(3i) % 4], position = (row + rows*col)*Qm + k."""
    if ack:
        cols = ACK_COLUMNS_NORM if normal_cp else ACK_COLUMNS_EXT
    else:
        cols = RI_COLUMNS_NORM if normal_cp else RI_COLUMNS_EXT
    pos = np.empty((q_prime, qm), np.int64)
    for i in range(q_prime):
        row = rows - 1 - i // 4
        col = cols[(3 * i) % 4]
        pos[i] = (row + rows * col) * qm + np.arange(qm)
    return pos.reshape(-1)


def ri_ack_pattern(values, qm: int) -> np.ndarray:
    """Coded bit pattern for 1- or 2-bit RI/ACK (uci.c encode_ri_ack):
    codes (UCI_BIT_*) of length qm (1 bit) or 3*qm (2 bits); symbol i of
    Q' uses pattern[(i*qm) % len : ... + qm]."""
    values = np.atleast_1d(np.asarray(values)).astype(np.int64)
    if len(values) == 1:
        pat = np.full(qm, UCI_BIT_PLACEHOLDER, np.int64)
        pat[0] = UCI_BIT_1 if values[0] else UCI_BIT_0
        if qm > 1:
            pat[1] = UCI_BIT_REPETITION
        return pat
    b0, b1 = int(values[0]), int(values[1])
    b2 = b0 ^ b1
    pat = np.full(3 * qm, UCI_BIT_PLACEHOLDER, np.int64)
    for m, (x, y) in enumerate([(b0, b1), (b2, b0), (b1, b2)]):
        pat[m * qm] = x
        if qm > 1:
            pat[m * qm + 1] = y
    return pat


def ulsch_interleaver_perm(h_prime_total: int, n_symb: int, qm: int,
                           ri_positions: np.ndarray) -> np.ndarray:
    """perm[g_idx] -> q bit position (36.212 5.2.2.8; ulsch_interleave_gen
    sch.c:550-568). The (data+CQI) stream is written row-major (row, col,
    k) skipping RI positions; q position of matrix entry (row, col, k) is
    (row + rows*col)*Qm + k."""
    rows = h_prime_total // n_symb
    j, i, k = np.meshgrid(np.arange(rows), np.arange(n_symb), np.arange(qm),
                          indexing="ij")
    scan = ((j + rows * i) * qm + k).reshape(-1)   # scan order -> q position
    ri_mask = np.zeros(h_prime_total * qm, bool)
    if len(ri_positions):
        ri_mask[ri_positions] = True
    return scan[~ri_mask[scan]]


def encode_cqi_pusch(cqi_bits: np.ndarray, n_out_bits: int) -> np.ndarray:
    """Coded CQI stream for PUSCH on the host (36.212 5.2.2.6.4-5;
    uci.c:289-390). O <= 11: RM (32, O) cyclically repeated to
    n_out_bits; O > 11: CRC8 + rate-1/3 tail-biting conv code + conv rate
    matching."""
    o = len(cqi_bits)
    if o <= 11:
        cw = rm_encode(np.asarray(cqi_bits, np.int8), 32)
        return np.tile(cw, -(-n_out_bits // 32))[:n_out_bits]
    with_crc = CRC8.attach_np(np.asarray(cqi_bits, np.int8))
    d = conv_encode(torch.as_tensor(with_crc)).numpy()      # [3, K]
    k = d.shape[-1]
    return d.reshape(3 * k)[_selection(k, n_out_bits)].astype(np.int8)


