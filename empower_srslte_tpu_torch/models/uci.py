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

from ..ops.fec.convcoder import conv_encode, viterbi_decode
from ..ops.fec.rm_conv import _selection, rm_conv_rx
from ..runtime import trace
from ..utils.crc import CRC8
from ..utils.device import device_table

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


@functools.lru_cache(maxsize=64)
def _codebook(n_out: int, o: int) -> np.ndarray:
    """All 2^O codewords as +-1 rows [2^O, n_out]."""
    msgs = ((np.arange(1 << o)[:, None] >> np.arange(o)[None, :]) & 1) \
        .astype(np.int8)
    return (1.0 - 2.0 * rm_encode(msgs, n_out)).astype(np.float32)


def rm_decode(llrs: torch.Tensor, n_out: int, o: int) -> torch.Tensor:
    """ML decode: llrs [..., n_out] (positive <=> bit 0) -> bits [..., o]
    int8; one correlation against the full codebook, first maximum."""
    cb = device_table(("rm_codebook", n_out, o), llrs.device,
                      lambda: _codebook(n_out, o))
    best = torch.argmax(torch.matmul(llrs, cb.t()), dim=-1)
    shifts = device_table(("rm_shifts", o), llrs.device,
                          lambda: np.arange(o, dtype=np.int64))
    return ((best[..., None] >> shifts) & 1).to(torch.int8)


def cqi_pack_wideband(cqi: int, differential: int = 0) -> np.ndarray:
    """Wideband CQI report payload (cqi.c format): 4-bit CQI."""
    return np.array([(cqi >> (3 - i)) & 1 for i in range(4)], np.int8)


def _host_bits(bits) -> np.ndarray:
    """A payload as int64 numpy bits on the host (a decoder's tensor is
    read back here: the unpackers return Python ints)."""
    if isinstance(bits, torch.Tensor):
        bits = bits.detach().cpu().numpy()
    return np.asarray(bits).astype(np.int64)


def cqi_unpack_wideband(bits) -> int:
    out = 0
    for b in _host_bits(bits)[:4]:
        out = (out << 1) | int(b)
    return out


# --- subband CQI (36.213 7.2.1, 36.212 Tables 5.2.2.6.2-1/2;
#     cqi.c:45-79 srslte_cqi_hl_subband_pack) ---------------------------------

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


def cqi_hl_subband_nof_bits(nof_prb: int) -> int:
    return 4 + 2 * cqi_nof_subbands(nof_prb)


#: 2-bit subband differential CQI (36.213 Table 7.2.1-2):
#: offset = wideband - subband; codes 0..3 <-> offset {0, 1, >=2, <=-1}
CQI_DIFF_OFFSET = (0, 1, 2, -1)


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


def cqi_unpack_hl_subband(bits: np.ndarray, nof_prb: int):
    """-> (wideband_cqi, [per-subband cqi]) inverting the 2-bit
    differentials with their representative offsets."""
    n = cqi_nof_subbands(nof_prb)
    bits = np.asarray(bits).astype(np.int64)
    wb = int((bits[0] << 3) | (bits[1] << 2) | (bits[2] << 1) | bits[3])
    sbs = []
    for i in range(n):
        d = int((bits[4 + 2 * i] << 1) | bits[5 + 2 * i])
        sbs.append(max(0, min(15, wb - CQI_DIFF_OFFSET[d])))
    return wb, sbs


def cqi_pack_ue_subband(wb_cqi: int, sb_diff: int, position: int,
                        l_bits: int) -> np.ndarray:
    """UE-selected subband report (cqi.c:81-91): wideband 4 + diff 2 +
    L-bit best-subband position label."""
    bits = [(wb_cqi >> (3 - i)) & 1 for i in range(4)]
    bits += [(sb_diff >> 1) & 1, sb_diff & 1]
    bits += [(position >> (l_bits - 1 - i)) & 1 for i in range(l_bits)]
    return np.array(bits, np.int8)


def cqi_unpack_ue_subband(bits, l_bits: int):
    bits = _host_bits(bits)
    wb = int((bits[0] << 3) | (bits[1] << 2) | (bits[2] << 1) | bits[3])
    diff = int((bits[4] << 1) | bits[5])
    pos = 0
    for b in bits[6:6 + l_bits]:
        pos = (pos << 1) | int(b)
    return wb, diff, pos


def cqi_pack_format2_subband(subband_cqi: int, subband_label: int,
                             label_2_bits: bool = True) -> np.ndarray:
    """Periodic UE-selected subband report on PUCCH format 2 (36.213
    mode 2-0; cqi.c:117 srslte_cqi_format2_subband_pack): 4-bit subband
    CQI + 1/2-bit bandwidth-part label."""
    n = 2 if label_2_bits else 1
    bits = [(subband_cqi >> (3 - i)) & 1 for i in range(4)]
    bits += [(subband_label >> (n - 1 - i)) & 1 for i in range(n)]
    return np.array(bits, np.int8)


def cqi_unpack_format2_subband(bits, label_2_bits: bool = True):
    bits = _host_bits(bits)
    cqi = int((bits[0] << 3) | (bits[1] << 2) | (bits[2] << 1) | bits[3])
    n = 2 if label_2_bits else 1
    label = 0
    for b in bits[4:4 + n]:
        label = (label << 1) | int(b)
    return cqi, label


def ri_pack(ri: int, nof_bits: int = 1) -> np.ndarray:
    """Periodic RI payload for PUCCH format 2 (phch_worker.cc:1086
    uci_data.uci_ri on the RI occasion): rank-1 -> bit 0, rank-2 -> 1."""
    v = ri - 1
    return np.array([(v >> (nof_bits - 1 - i)) & 1
                     for i in range(nof_bits)], np.int8)


def ri_unpack(bits, nof_bits: int = 1) -> int:
    v = 0
    for b in _host_bits(bits)[:nof_bits]:
        v = (v << 1) | int(b)
    return v + 1


# --- UCI on PUSCH (36.212 5.2.2.6-5.2.2.8; sch.c:550-985, uci.c:491-720) -----

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


def decode_cqi_pusch(llrs: torch.Tensor, o: int, n_out_bits: int):
    """llrs [..., n_out_bits] -> (bits [..., o] int8, crc_ok [...] bool).

    Short (O <= 11): fold the cyclic repeats and ML-correlate
    (decode_cqi_short uci.c:392); there is no CRC, so crc_ok is all True.
    Long: conv de-rate-matching, Viterbi, CRC8. Runs in the profiler
    range ``uci.cqi_decode``.
    """
    with trace.span("uci.cqi_decode"):
        lead = llrs.shape[:-1]
        if o <= 11:
            nfull, rem = divmod(n_out_bits, 32)
            acc = llrs.new_zeros((*lead, 32))
            if nfull:
                acc = acc + llrs[..., :nfull * 32].reshape(
                    *lead, nfull, 32).sum(-2)
            if rem:
                acc[..., :rem] += llrs[..., nfull * 32:]
            ok = torch.ones(lead, dtype=torch.bool, device=llrs.device)
            return rm_decode(acc, 32, o), ok
        bits = viterbi_decode(rm_conv_rx(llrs, o + 8))
        return bits[..., :o], CRC8.check(bits)
