"""Resource allocation and MCS/TBS mapping (36.213 7.1.7, 36.211 RA types).

Capability parity with lib/src/phy/phch/ra.c: RIV pack/unpack for RA type
2, type-0 RBG bitmaps, the I_MCS -> (Qm, I_TBS) mapping and the 36.213
Table 7.1.7.2.1-1 transport block sizes (stored as binary spec data in
the package's data/ directory, loaded once).
"""

from __future__ import annotations

import functools
import math
import pathlib

import numpy as np

from ..ops.modem import Mod

_DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


@functools.lru_cache(maxsize=1)
def tbs_table() -> np.ndarray:
    """[27 I_TBS, 110 N_PRB] transport block sizes (36.213 7.1.7.2.1-1)."""
    return np.load(_DATA / "tbs_table.npy")


@functools.lru_cache(maxsize=1)
def tbs_format1c_table() -> np.ndarray:
    return np.load(_DATA / "tbs_format1c.npy")


def mcs_to_qm_itbs(i_mcs: int, dl: bool = True) -> tuple[Mod, int]:
    """I_MCS -> (modulation, I_TBS), 36.213 Table 7.1.7.1-1 (DL) /
    8.6.1-1 (UL)."""
    if dl:
        if i_mcs <= 9:
            return Mod.QPSK, i_mcs
        if i_mcs <= 16:
            return Mod.QAM16, i_mcs - 1
        if i_mcs <= 28:
            return Mod.QAM64, i_mcs - 2
        raise ValueError(f"reserved I_MCS {i_mcs}")
    if i_mcs <= 10:
        return Mod.QPSK, i_mcs
    if i_mcs <= 20:
        return Mod.QAM16, i_mcs - 1
    if i_mcs <= 28:
        return Mod.QAM64, i_mcs - 2
    raise ValueError(f"reserved I_MCS {i_mcs}")


def tbs_lookup(i_tbs: int, n_prb: int) -> int:
    return int(tbs_table()[i_tbs, n_prb - 1])


def mcs_to_tbs(i_mcs: int, n_prb: int, dl: bool = True) -> tuple[Mod, int]:
    mod, i_tbs = mcs_to_qm_itbs(i_mcs, dl)
    return mod, tbs_lookup(i_tbs, n_prb)


# --- RA type 2 (contiguous allocation via RIV) ------------------------------


def riv_encode(n_prb_cell: int, start: int, length: int) -> int:
    """RIV from (start, length), 36.213 7.1.6.3."""
    if length - 1 <= n_prb_cell // 2:
        return n_prb_cell * (length - 1) + start
    return n_prb_cell * (n_prb_cell - length + 1) + (n_prb_cell - 1 - start)


def riv_decode(riv: int, n_prb_cell: int) -> tuple[int, int]:
    """RIV -> (start, length)."""
    length = riv // n_prb_cell + 1
    start = riv % n_prb_cell
    if start + length > n_prb_cell:
        length = n_prb_cell - length + 2
        start = n_prb_cell - 1 - start
    return start, length


def riv_nof_bits(n_prb_cell: int) -> int:
    return math.ceil(math.log2(n_prb_cell * (n_prb_cell + 1) / 2))


def prb_mask_type2(n_prb_cell: int, start: int, length: int) -> tuple[bool, ...]:
    mask = [False] * n_prb_cell
    for i in range(start, start + length):
        mask[i] = True
    return tuple(mask)


# --- RA type 0 (RBG bitmap) -------------------------------------------------


def rbg_size(n_prb_cell: int) -> int:
    """P, 36.213 Table 7.1.6.1-1."""
    if n_prb_cell <= 10:
        return 1
    if n_prb_cell <= 26:
        return 2
    if n_prb_cell <= 63:
        return 3
    return 4


def prb_mask_type0(n_prb_cell: int, rbg_bitmap: int) -> tuple[bool, ...]:
    """MSB-first RBG bitmap -> PRB mask."""
    p = rbg_size(n_prb_cell)
    n_rbg = math.ceil(n_prb_cell / p)
    mask = [False] * n_prb_cell
    for g in range(n_rbg):
        if (rbg_bitmap >> (n_rbg - 1 - g)) & 1:
            for i in range(g * p, min((g + 1) * p, n_prb_cell)):
                mask[i] = True
    return tuple(mask)


# --- RA type 2 distributed (DVRB; 36.211 6.2.3.2, 36.213 7.1.6.3) -----------


def type2_ngap(n_prb_cell: int, ngap_is_1: bool = True) -> int:
    """N_gap (36.211 Table 6.2.3.2-1; ra.c:656-676)."""
    if n_prb_cell <= 10:
        return n_prb_cell // 2
    if n_prb_cell == 11:
        return 4
    if n_prb_cell <= 19:
        return 8
    if n_prb_cell <= 26:
        return 12
    if n_prb_cell <= 44:
        return 18
    if n_prb_cell <= 49:
        return 27
    if n_prb_cell <= 63:
        return 27 if ngap_is_1 else 9
    if n_prb_cell <= 79:
        return 32 if ngap_is_1 else 16
    return 48 if ngap_is_1 else 16


def type2_n_rb_step(n_prb_cell: int) -> int:
    """N_RB_step for format 1C (36.213 Table 7.1.6.3-1)."""
    return 2 if n_prb_cell < 50 else 4


def type2_n_vrb_dl(n_prb_cell: int, ngap_is_1: bool = True) -> int:
    """Number of distributed VRBs (36.211 6.2.3.2; ra.c:687-694)."""
    ngap = type2_ngap(n_prb_cell, ngap_is_1)
    if ngap_is_1:
        return 2 * min(ngap, n_prb_cell - ngap)
    return (n_prb_cell // ngap) * 2 * ngap


def type2_riv_decode(riv: int, n_prb_cell: int,
                     nof_vrb: int) -> tuple[int, int]:
    """RIV -> (RB_start, L_crb) against an N_vrb that may differ from the
    cell bandwidth (distributed mode; ra.c:644-652)."""
    length = riv // n_prb_cell + 1
    start = riv % n_prb_cell
    if length > nof_vrb - start:
        length = n_prb_cell - riv // n_prb_cell + 1
        start = n_prb_cell - riv % n_prb_cell - 1
    return start, length


def prb_mask_type2_dist(n_prb_cell: int, rb_start: int, l_crb: int,
                        ngap_is_1: bool = True):
    """Distributed VRB -> PRB mapping (36.211 6.2.3.2; ra.c:353-420).

    Returns (mask_slot0, mask_slot1) — distributed allocations hop
    between slots.
    """
    p = rbg_size(n_prb_cell)
    if ngap_is_1:
        n_tilde_vrb = type2_n_vrb_dl(n_prb_cell, True)
        n_gap = type2_ngap(n_prb_cell, True)
    else:
        n_tilde_vrb = 2 * type2_n_vrb_dl(n_prb_cell, True)
        n_gap = type2_ngap(n_prb_cell, False)
    n_row = math.ceil(n_tilde_vrb / (4 * p)) * p
    n_null = 4 * n_row - n_tilde_vrb
    m0 = [False] * n_prb_cell
    m1 = [False] * n_prb_cell
    for i in range(l_crb):
        n_vrb = i + rb_start
        ntv = n_vrb % n_tilde_vrb
        base = n_tilde_vrb * (n_vrb // n_tilde_vrb)
        nt_prb = 2 * n_row * (ntv % 2) + ntv // 2 + base
        nt2_prb = n_row * (ntv % 4) + ntv // 4 + base
        if n_null and ntv >= n_tilde_vrb - n_null and ntv % 2 == 1:
            odd = nt_prb - n_row
        elif n_null and ntv >= n_tilde_vrb - n_null and ntv % 2 == 0:
            odd = nt_prb - n_row + n_null // 2
        elif n_null and ntv < n_tilde_vrb - n_null and ntv % 4 >= 2:
            odd = nt2_prb - n_null // 2
        else:
            odd = nt2_prb
        even = (odd + n_tilde_vrb // 2) % n_tilde_vrb \
            + n_tilde_vrb * (n_vrb // n_tilde_vrb)
        for val, m in ((odd, m0), (even, m1)):
            prb = val if val < n_tilde_vrb // 2 \
                else val + n_gap - n_tilde_vrb // 2
            if prb >= n_prb_cell:
                raise ValueError("distributed VRB exceeds bandwidth")
            m[prb] = True
    return tuple(m0), tuple(m1)
