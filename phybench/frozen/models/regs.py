"""Control-region resource element groups (REGs), 36.211 6.2.4/6.7.4/6.8.5/6.9.3.

Capability parity with lib/src/phy/phch/regs.c (815 LoC of REG bookkeeping
for PCFICH/PHICH/PDCCH): builds, per (cell, cfi, Ng), the REG inventory of
the control region, the PCFICH's 4 quarter-spaced REGs, the PHICH group
REGs, and the PDCCH's interleaved+shifted CCE-to-RE map. Everything is
host-side numpy producing flat RE index tables consumed by gathers.
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils.cell import Cell

RE_PER_REG = 4
REG_PER_CCE = 9
RE_PER_CCE = RE_PER_REG * REG_PER_CCE  # 36


@functools.lru_cache(maxsize=256)
def symbol_regs(cell: Cell, l: int) -> tuple[tuple[int, ...], ...]:
    """REGs of OFDM symbol l: tuple of per-REG RE-subcarrier 4-tuples.

    Symbol 0 always excludes the two CRS shifts (8 usable REs -> 2 REGs
    per PRB); symbol 1 excludes them only with 4 ports; symbols 2/3 are
    CRS-free in the control region (36.211 6.2.4).
    """
    vshift = cell.id % 6
    has_crs = l == 0 or (l == 1 and cell.nof_ports == 4)
    regs = []
    for prb in range(cell.nof_prb):
        base = prb * 12
        if has_crs:
            ks = [base + k for k in range(12) if (k - vshift) % 3 != 0]
        else:
            ks = [base + k for k in range(12)]
        for g in range(len(ks) // 4):
            regs.append(tuple(ks[4 * g : 4 * g + 4]))
    return tuple(regs)


@functools.lru_cache(maxsize=256)
def pcfich_regs(cell: Cell) -> tuple[int, ...]:
    """Indices (into symbol_regs(cell, 0)) of the PCFICH's 4 REGs
    (36.211 6.7.4: quarter-band spacing, cell-id offset)."""
    nre = cell.nof_re
    k_bar = 6 * (cell.id % (2 * cell.nof_prb))
    regs0 = symbol_regs(cell, 0)
    first_re = [r[0] for r in regs0]
    out = []
    for i in range(4):
        k = (k_bar + (i * cell.nof_prb // 2) * 6) % nre
        # REG whose first RE is the largest <= k
        j = int(np.searchsorted(first_re, k, side="right") - 1)
        out.append(j % len(regs0))
    return tuple(out)


def nof_phich_groups(cell: Cell, ng: float = 1.0) -> int:
    """N_group_PHICH = ceil(Ng * NRB / 8) for normal CP (36.211 6.9)."""
    import math

    n = math.ceil(ng * cell.nof_prb / 8)
    return n if cell.cp.value == "normal" else 2 * n


@functools.lru_cache(maxsize=256)
def phich_regs(cell: Cell, ng: float = 1.0) -> tuple[tuple[int, ...], ...]:
    """Per-group triplets of REG indices (into symbol_regs(cell, 0)),
    normal PHICH duration (36.211 6.9.3)."""
    regs0 = symbol_regs(cell, 0)
    taken = set(pcfich_regs(cell))
    avail = [i for i in range(len(regs0)) if i not in taken]
    n0 = len(avail)
    groups = []
    for m in range(nof_phich_groups(cell, ng)):
        trip = []
        for i in range(3):
            ni = (cell.id + m + (i * n0) // 3) % n0
            trip.append(avail[ni])
        groups.append(tuple(trip))
    return tuple(groups)


@functools.lru_cache(maxsize=256)
def nof_ctrl_symbols(cell: Cell, cfi: int) -> int:
    """Control-region OFDM symbols for a CFI value: cfi+1 on narrow
    cells (<=10 PRB, 36.211 Table 6.7-1; regs.c regs_pdcch_init
    ``nof_ctrl_symbols = cfi+2`` with its 0-based cfi)."""
    return cfi + 1 if cell.nof_prb <= 10 else cfi


def pdcch_reg_map(cell: Cell, cfi: int, ng: float = 1.0) -> np.ndarray:
    """Flat RE indices [n_pdcch_regs, 4] of the PDCCH REGs, in the
    POST-interleaving order: quadruplet j of the PDCCH multiplexed
    sequence maps to row j (36.211 6.8.5: sub-block interleave the REG
    sequence with the conv column permutation, cyclic-shift by cell id,
    assign to unused REGs in frequency-major order).

    Mapping direction per regs.c regs_pdcch_init: quadruplet m (the
    m-th matrix cell in row-major order) transmits on the physical REG
    whose frequency-order index is (k_of_m - cell_id) mod N, where
    k_of_m is m's position in the permuted column-major read-out.
    """
    from ..ops.fec.rm_conv import NCOLS, PERM_CONV

    nre = cell.nof_re
    # inventory: unused REGs as (k', l) sorted by k' then l
    used0 = set(pcfich_regs(cell))
    for trip in phich_regs(cell, ng):
        used0 |= set(trip)
    items = []
    for l in range(nof_ctrl_symbols(cell, cfi)):
        regs = symbol_regs(cell, l)
        for i, r in enumerate(regs):
            if l == 0 and i in used0:
                continue
            items.append((r[0], l, r))
    items.sort(key=lambda t: (t[0], t[1]))
    m = len(items)

    # sub-block interleaver permutation of 0..m-1 (row-column with the
    # conv pattern, NULLs dropped): perm[k] = original index of the k-th
    # element in the permuted column-major read-out
    r_rows = -(-m // NCOLS)
    kp = r_rows * NCOLS
    nd = kp - m
    j = np.arange(kp, dtype=np.int64)
    y = (j % r_rows) * NCOLS + PERM_CONV[j // r_rows]
    pos = y - nd
    perm = pos[pos >= 0]
    inv = np.empty(m, np.int64)               # inv[m] = k_of_m
    inv[perm] = np.arange(m)

    out = np.zeros((m, RE_PER_REG), np.int32)
    for q in range(m):
        k0, l, res = items[(inv[q] - cell.id) % m]
        out[q] = [l * nre + k for k in res]
    return out


