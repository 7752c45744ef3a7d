"""DCI formats: pack/unpack and grant resolution (36.212 5.3.3).

Capability parity with lib/src/phy/phch/dci.c and dci_sz_table.h: formats
0 (UL grant), 1A (compact DL) and 1 (full type-0 DL) with the
size-equalization rules (0/1A padded to equal length; ambiguous sizes
bumped). Pure host-side bit packing over numpy; the blind-decoded payloads
come from pdcch.py.
"""

from __future__ import annotations

import math


from . import ra

#: Payload sizes that must be avoided (36.212 5.3.3.1.2 ambiguity set).
AMBIGUOUS_SIZES = {12, 14, 16, 20, 24, 26, 32, 40, 44, 56}


def format0_1a_size(n_prb_cell: int) -> int:
    """Common size of formats 0 and 1A after equalization."""
    riv_bits = ra.riv_nof_bits(n_prb_cell)
    # format 1A: flag(1)+local/dist(1)+RIV+MCS(5)+HARQ(3)+NDI(1)+RV(2)+TPC(2)
    s1a = 1 + 1 + riv_bits + 5 + 3 + 1 + 2 + 2
    # format 0: flag(1)+hop(1)+RIV+MCS(5)+NDI(1)+TPC(2)+DMRS(3)+CQI(1)
    s0 = 1 + 1 + riv_bits + 5 + 1 + 2 + 3 + 1
    size = max(s0, s1a)
    while size in AMBIGUOUS_SIZES:
        size += 1
    return size


def format1_size(n_prb_cell: int) -> int:
    """Format 1: RBG bitmap + MCS(5)+HARQ(3)+NDI(1)+RV(2)+TPC(2)."""
    n_rbg = math.ceil(n_prb_cell / ra.rbg_size(n_prb_cell))
    size = (1 if n_prb_cell > 10 else 0) + n_rbg + 5 + 3 + 1 + 2 + 2
    if size in AMBIGUOUS_SIZES or size == format0_1a_size(n_prb_cell):
        size += 1
    return size


