"""Uplink demodulation reference signals (DMRS) and base sequences,
36.211 5.5, and the PUSCH channel estimate.

Capability parity with lib/src/phy/ch_estimation/refsignal_ul.c and
ul_rs_tables.h: Zadoff-Chu base sequences with cyclic extension for
allocations >= 3 PRB, the 30 special QPSK-phase sequences for 1-2 PRB
(the spec tables in ``data/ul_rs_phi{12,24}.npy``), group assignment
u = (f_gh + f_ss) mod 30 with group hopping (phy_common.c:342) and
sequence hopping v (refsignal_ul.c:154), cyclic shifts with the PUSCH
DMRS's pseudo-random n_PN(ns) (5.5.2.1.1, refsignal_ul.c generate_n_prs,
which the JAX package leaves out), and PUSCH DMRS placement on the middle
SC-FDMA symbol of each slot. Counterpart of the JAX package's
models/refsignal_ul.py:1-215, with the sounding reference signal (SRS) on
the last SC-FDMA symbol; the sequences are built on the host (numpy,
cached), placement and channel estimates are torch.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from ..runtime import trace
from ..utils.cell import CP, Cell
from ..utils.device import device_table
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


@functools.lru_cache(maxsize=64)
def n_pn(cell: Cell, delta_ss: int = 0) -> np.ndarray:
    """n_PN(ns) for the 20 slots of a frame: n_PN(ns) = sum_i c(8 N_symb
    ns + i) 2^i, with c_init = floor(N_ID / 30) 2^5 + f_ss^PUSCH and
    f_ss^PUSCH = (N_ID + delta_ss) mod 30 (36.211 5.5.2.1.1;
    refsignal_ul.c generate_n_prs)."""
    c_init = ((cell.id // 30) << 5) + ((cell.id % 30) + delta_ss) % 30
    n_symb = cell.nsymb_slot
    c = gold_sequence(c_init, 8 * n_symb * 20).astype(np.int64)
    slots = c.reshape(20, 8 * n_symb)[:, :8]
    return slots @ (1 << np.arange(8)).astype(np.int64)


@functools.lru_cache(maxsize=256)
def pusch_dmrs(cell: Cell, n_prb: int, cyclic_shift: int = 0,
               delta_ss: int = 0, sf_idx: int = 0,
               group_hopping: bool = False,
               sequence_hopping: bool = False) -> np.ndarray:
    """[2, 12*n_prb] complex64 DMRS sequences for the two slots of
    subframe ``sf_idx`` (36.211 5.5.1.3/5.5.2.1.1; refsignal_ul.c:368).
    ``cyclic_shift`` is n_DMRS(1) + n_DMRS(2); slot ns takes
    alpha = 2 pi n_cs / 12 with n_cs = (cyclic_shift + n_PN(ns)) mod 12."""
    m_sc = 12 * n_prb
    n = np.arange(m_sc)
    pn = n_pn(cell, delta_ss)
    slots = []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        alpha = 2 * np.pi * ((cyclic_shift + int(pn[ns])) % 12) / 12.0
        u, v = dmrs_u_v(cell.id, ns, n_prb, delta_ss, group_hopping,
                        sequence_hopping)
        r = base_sequence(u, v, m_sc)
        slots.append((np.exp(1j * alpha * n) * r).astype(np.complex64))
    return np.stack(slots)


def chest_ul_pusch(grid: torch.Tensor, cell: Cell, prb_start: int,
                   n_prb: int, cyclic_shift: int = 0,
                   prb_start_slot1: int | None = None, sf_idx: int = 0,
                   delta_ss: int = 0, group_hopping: bool = False,
                   sequence_hopping: bool = False) -> torch.Tensor:
    """LS channel estimate over the PUSCH allocation from the two DMRS
    symbols, 3-tap frequency smoothing, linear time interpolation
    (chest_ul.c analog).

    grid [..., nsymb, nre] -> h [..., nsymb, 12*n_prb] (allocation only).
    With frequency hopping (``prb_start_slot1``) each slot's DMRS sits on
    its own allocation, so each slot's estimate is held instead of
    interpolated across the hop.
    """
    m_sc = 12 * n_prb
    k0 = 12 * prb_start
    k1 = 12 * (prb_start if prb_start_slot1 is None else prb_start_slot1)
    key = ("pusch_dmrs_conj", cell, n_prb, cyclic_shift, delta_ss, sf_idx,
           group_hopping, sequence_hopping)
    dmrs_c = device_table(key, grid.device, lambda: np.conj(pusch_dmrs(
        cell, n_prb, cyclic_shift, delta_ss, sf_idx, group_hopping,
        sequence_hopping)))
    l0, l1 = pusch_dmrs_symbols(cell)
    h0 = grid[..., l0, k0:k0 + m_sc] * dmrs_c[0]
    h1 = grid[..., l1, k1:k1 + m_sc] * dmrs_c[1]

    def smooth(h):
        pad = torch.cat([h[..., :1], h, h[..., -1:]], dim=-1)
        return (pad[..., :-2] + pad[..., 1:-1] + pad[..., 2:]) / 3.0

    h0, h1 = smooth(h0), smooth(h1)
    nsymb = cell.nsymb_sf
    if prb_start_slot1 is not None and prb_start_slot1 != prb_start:
        t = (np.arange(nsymb) >= cell.nsymb_slot).astype(np.float32)
    else:
        t = ((np.arange(nsymb) - l0) / float(l1 - l0)).astype(np.float32)
    t = device_table(("chest_ul_t", tuple(t.tolist())), grid.device,
                     lambda: t[:, None])
    return h0[..., None, :] * (1 - t) + h1[..., None, :] * t


# --- SRS: sounding reference signals (36.211 5.5.3) -------------------------


@functools.lru_cache(maxsize=256)
def srs_sequence(cell: Cell, n_prb_srs: int, cyclic_shift: int = 0,
                 sf_idx: int = 0, group_hopping: bool = False) -> np.ndarray:
    """r_SRS over the sounding bandwidth: comb-2 -> M_sc = 12*n_prb/2
    subcarriers (refsignal_ul.c srs path; SRS rides slot 2*sf with the
    same f_gh group hopping as PUSCH DMRS)."""
    m_sc = 12 * n_prb_srs // 2
    u, _ = dmrs_u_v(cell.id, 2 * sf_idx, 0, 0, group_hopping, False)
    r = base_sequence(u, 0, m_sc)
    n = np.arange(m_sc)
    alpha = 2 * np.pi * cyclic_shift / 8.0
    return (np.exp(1j * alpha * n) * r).astype(np.complex64)


def _srs_tables(cell: Cell, n_prb_srs: int, prb_start: int, comb: int,
                cyclic_shift: int):
    """(flat indices of the SRS REs in the last symbol, the sequence).
    Both ends build the sequence with sf_idx 0, as the JAX package's
    ``srs_put`` / ``srs_chest`` do."""
    seq = srs_sequence(cell, n_prb_srs, cyclic_shift)
    k = 12 * prb_start + comb + 2 * np.arange(len(seq))
    return ((cell.nsymb_sf - 1) * cell.nof_re + k).astype(np.int64), seq


def srs_put(grid: torch.Tensor, cell: Cell, n_prb_srs: int,
            prb_start: int = 0, comb: int = 0,
            cyclic_shift: int = 0) -> torch.Tensor:
    """Insert SRS in the last SC-FDMA symbol (comb-2 spacing) of
    [..., nsymb, nre]: the SRS REs are set, overwriting what was there,
    as the JAX package's overlay does."""
    key = ("srs", cell, n_prb_srs, prb_start, comb, cyclic_shift)
    idx = device_table(key + ("idx",), grid.device, lambda: _srs_tables(
        cell, n_prb_srs, prb_start, comb, cyclic_shift)[0])
    seq = device_table(key + ("seq",), grid.device, lambda: _srs_tables(
        cell, n_prb_srs, prb_start, comb, cyclic_shift)[1])
    flat = grid.reshape(*grid.shape[:-2], -1).clone()
    flat[..., idx] = seq
    return flat.reshape(grid.shape)


def srs_chest(grid: torch.Tensor, cell: Cell, n_prb_srs: int,
              prb_start: int = 0, comb: int = 0,
              cyclic_shift: int = 0) -> torch.Tensor:
    """LS channel estimate at the SRS comb positions -> h [..., M_sc]
    (profiler range ``srs.chest``)."""
    key = ("srs", cell, n_prb_srs, prb_start, comb, cyclic_shift)
    idx = device_table(key + ("idx",), grid.device, lambda: _srs_tables(
        cell, n_prb_srs, prb_start, comb, cyclic_shift)[0])
    seq_c = device_table(key + ("conj",), grid.device, lambda: np.conj(
        _srs_tables(cell, n_prb_srs, prb_start, comb, cyclic_shift)[1]))
    with trace.span("srs.chest"):
        return grid.reshape(*grid.shape[:-2], -1)[..., idx] * seq_c
