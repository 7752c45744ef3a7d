"""Uplink demodulation reference signals (DMRS) and base sequences,
36.211 5.5, and the PUSCH channel estimate.

Capability parity with lib/src/phy/ch_estimation/refsignal_ul.c and
ul_rs_tables.h: Zadoff-Chu base sequences with cyclic extension for
allocations >= 3 PRB, the 30 special QPSK-phase sequences for 1-2 PRB
(the spec tables in ``data/ul_rs_phi{12,24}.npy``), group assignment
u = (f_gh + f_ss) mod 30 with group hopping (phy_common.c:342) and
sequence hopping v (refsignal_ul.c:154), cyclic shifts, and PUSCH DMRS
placement on the middle SC-FDMA symbol of each slot. Counterpart of the
JAX package's models/refsignal_ul.py:1-215, with the sounding reference
signal (SRS) on the last SC-FDMA symbol; the sequences are built on the
host (numpy, cached), placement and channel estimates are torch.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

from ..utils.cell import CP, Cell
from ..utils.sequence import gold_sequence

_DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


def _largest_prime_below(n: int) -> int:
    def is_prime(x):
        if x < 2:
            return False
        for d in range(2, int(x ** 0.5) + 1):
            if x % d == 0:
                return False
        return True

    p = n - 1
    while not is_prime(p):
        p -= 1
    return p


@functools.lru_cache(maxsize=1024)
def base_sequence(u: int, v: int, m_sc: int) -> np.ndarray:
    """r_{u,v}(n), length m_sc (36.211 5.5.1.1/5.5.1.2)."""
    if m_sc in (12, 24):
        phi = np.load(_DATA / f"ul_rs_phi{m_sc}.npy")[u]
        return np.exp(1j * phi * np.pi / 4).astype(np.complex64)
    nzc = _largest_prime_below(m_sc)
    q_bar = nzc * (u + 1) / 31.0
    # q = floor(q_bar + 1/2) + v * (-1)^floor(2 q_bar)  (36.211 5.5.1.1)
    q = int(np.floor(q_bar + 0.5) + v * (-1) ** int(np.floor(2 * q_bar)))
    m = np.arange(nzc)
    xq = np.exp(-1j * np.pi * q * m * (m + 1) / nzc)
    n = np.arange(m_sc)
    return xq[n % nzc].astype(np.complex64)


# --- group / sequence hopping (36.211 5.5.1.3/5.5.1.4;
# --- phy_common.c:342 srslte_group_hopping_f_gh and
# --- refsignal_ul.c:154 generate_srslte_sequence_hopping_v) -----------------


@functools.lru_cache(maxsize=64)
def group_hopping_f_gh(cell_id: int) -> np.ndarray:
    """f_gh(ns) mod 30 for the 20 slots of a frame: 8 Gold bits per slot
    with c_init = floor(cell_id/30)."""
    c = gold_sequence(cell_id // 30, 160).astype(np.int64)
    weights = (1 << np.arange(8)).astype(np.int64)
    return (c.reshape(20, 8) @ weights) % 30


@functools.lru_cache(maxsize=64)
def sequence_hopping_v(cell_id: int, delta_ss: int = 0) -> np.ndarray:
    """v(ns) for the 20 slots: one Gold bit per slot with
    c_init = floor(cell_id/30)*2^5 + f_ss (applies when m_sc >= 6 PRB)."""
    c_init = ((cell_id // 30) << 5) + ((cell_id % 30) + delta_ss) % 30
    return gold_sequence(c_init, 20).astype(np.int64)


def dmrs_u_v(cell_id: int, ns: int, n_prb: int, delta_ss: int = 0,
             group_hopping: bool = False,
             sequence_hopping: bool = False) -> tuple[int, int]:
    """(u, v) for slot ns: u = (f_gh + f_ss) mod 30; v from the hopping
    sequence for >= 6-PRB allocations without group hopping."""
    f_gh = int(group_hopping_f_gh(cell_id)[ns]) if group_hopping else 0
    u = (f_gh + (cell_id % 30) + delta_ss) % 30
    v = 0
    if n_prb >= 6 and sequence_hopping and not group_hopping:
        v = int(sequence_hopping_v(cell_id, delta_ss)[ns])
    return u, v


def pusch_dmrs_symbols(cell: Cell) -> tuple[int, int]:
    """Subframe-symbol indices carrying PUSCH DMRS (symbol 3 of each slot
    for normal CP, 2 for extended; 36.211 5.5.2.1.2)."""
    l = 3 if cell.cp is CP.NORM else 2
    return (l, cell.nsymb_slot + l)


def n_pn(cell_id: int, ns: int, delta_ss: int = 0) -> int:
    """n_PN(ns) = sum_i c(8 N_symb ns + i) 2^i, c_init = floor(N_ID/30) 2^5
    + f_ss (36.211 5.5.2.1.1; srsLTE refsignal_ul.c generate_n_prs)."""
    c_init = ((cell_id // 30) << 5) + ((cell_id % 30) + delta_ss) % 30
    c = gold_sequence(c_init, 8 * 7 * 20).astype(np.int64)
    return int(sum(int(c[8 * 7 * ns + i]) << i for i in range(8)))


@functools.lru_cache(maxsize=256)
def pusch_dmrs(cell: Cell, n_prb: int, cyclic_shift: int = 0,
               delta_ss: int = 0, sf_idx: int = 0,
               group_hopping: bool = False,
               sequence_hopping: bool = False) -> np.ndarray:
    """[2, 12*n_prb] complex64 DMRS sequences for the two slots of
    subframe ``sf_idx`` (36.211 5.5.1.3/5.5.2.1.1; refsignal_ul.c:368).
    alpha = 2*pi*n_cs/12 with n_cs = (cyclic_shift + n_PN(ns)) mod 12.
    Unlike the port, whose n_cs leaves n_PN(ns) out, this is the
    specification's cyclic shift."""
    m_sc = 12 * n_prb
    n = np.arange(m_sc)
    slots = []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        alpha = 2 * np.pi * ((cyclic_shift + n_pn(cell.id, ns, delta_ss))
                             % 12) / 12.0
        u, v = dmrs_u_v(cell.id, ns, n_prb, delta_ss, group_hopping,
                        sequence_hopping)
        r = base_sequence(u, v, m_sc)
        slots.append((np.exp(1j * alpha * n) * r).astype(np.complex64))
    return np.stack(slots)


