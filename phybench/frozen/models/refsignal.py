"""Cell-specific reference signals (CRS), 36.211 6.10.1.

Capability parity with lib/src/phy/ch_estimation/refsignal_dl.c: pilot
symbol sequences r_{l,ns}(m) from the Gold generator and their RE
positions per antenna port. Everything is precomputed host-side per
(cell, subframe) into numpy index/value tables used by the channel
estimator (gather) and the eNB grid composer (scatter).
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils.cell import Cell
from ..utils.sequence import cinit_crs, prs_sequence

#: Largest downlink bandwidth in PRB (sequence is generated for this and
#: windowed to the cell bandwidth, 36.211 6.10.1.1).
MAX_PRB = 110


def crs_symbol_indices(cell: Cell, port: int) -> tuple[int, ...]:
    """Slot-symbol indices carrying CRS for this port (36.211 6.10.1.2)."""
    if port in (0, 1):
        return (0, cell.nsymb_slot - 3)
    return (1,)


def _v(port: int, l: int, ns: int) -> int:
    """Frequency shift v per port/symbol (36.211 6.10.1.2)."""
    if port == 0:
        return 0 if l == 0 else 3
    if port == 1:
        return 3 if l == 0 else 0
    if port == 2:
        return 3 * (ns % 2)
    return 3 + 3 * (ns % 2)


@functools.lru_cache(maxsize=512)
def crs_pilots(cell: Cell, sf_idx: int, port: int):
    """(re_idx[nsym_crs, 2*nof_prb], symbols[nsym_crs], values same shape).

    re_idx: subcarrier index of each pilot within the subframe grid;
    symbols: subframe-symbol index of each pilot row; values: the QPSK
    pilot symbols r_{l,ns}(m) windowed to this bandwidth.
    """
    v_shift = cell.id % 6
    nsym_slot = cell.nsymb_slot
    rows_sym = []
    rows_idx = []
    rows_val = []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        for l in crs_symbol_indices(cell, port):
            c_init = cinit_crs(ns, l, cell.id, cell.cp.value == "normal")
            r = prs_sequence(c_init, 2 * MAX_PRB)
            m = np.arange(2 * cell.nof_prb)
            m_prime = m + MAX_PRB - cell.nof_prb
            k = 6 * m + (_v(port, l, ns) + v_shift) % 6
            rows_sym.append(slot * nsym_slot + l)
            rows_idx.append(k.astype(np.int32))
            rows_val.append(r[m_prime])
    return (np.stack(rows_idx), np.asarray(rows_sym, np.int32),
            np.stack(rows_val))


@functools.lru_cache(maxsize=512)
def crs_mask(cell: Cell, sf_idx: int = 0) -> np.ndarray:
    """Boolean [nsymb_sf, nof_re]: True where ANY configured port's CRS
    (or its paired-port hole) sits — these REs are excluded from PDSCH.

    Matches the reference's mapping rule (pdsch_cp skips CRS REs of all
    cell ports, lib/src/phy/phch/pdsch.c:95-214): with >1 port, both
    shifts of the port pair are reserved on CRS symbols.
    """
    mask = np.zeros((cell.nsymb_sf, cell.nof_re), dtype=bool)
    ports = {1: (0,), 2: (0, 1), 4: (0, 1, 2, 3)}[cell.nof_ports]
    for p in ports:
        idx, syms, _ = crs_pilots(cell, sf_idx, p)
        for row, s in enumerate(syms):
            mask[s, idx[row]] = True
    return mask
