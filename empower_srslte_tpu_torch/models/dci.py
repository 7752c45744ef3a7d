"""DCI formats: pack/unpack and grant resolution (36.212 5.3.3).

Capability parity with lib/src/phy/phch/dci.c and dci_sz_table.h: formats
0 (UL grant), 1A (compact DL) and 1 (full type-0 DL) with the
size-equalization rules (0/1A padded to equal length; ambiguous sizes
bumped). Pure host-side bit packing over numpy; the blind-decoded payloads
come from pdcch.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..utils.bits import bits_to_uint, uint_to_bits
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


@dataclass
class DciDl:
    """A resolved DL grant (format 1/1A content)."""

    format: str
    mcs: int
    harq_pid: int
    ndi: int
    rv: int
    prb_mask: tuple[bool, ...]
    #: TPC command; for SI/P/RA-RNTI format 1A its LSB selects
    #: N_prb_1A in {2, 3} for the TBS lookup (36.212 5.3.3.1.3)
    tpc: int = 0

    @property
    def n_prb(self) -> int:
        return sum(self.prb_mask)

    @property
    def n_prb_1a(self) -> int:
        return 3 if (self.tpc & 1) else 2


@dataclass
class DciUl:
    """A resolved UL grant (format 0 content)."""

    mcs: int
    ndi: int
    riv_start: int
    riv_len: int
    dmrs_cyclic_shift: int
    #: aperiodic CSI request bit (36.212 5.3.3.1.1; dci.c format0)
    cqi_request: int = 0


def pack_format1a(n_prb_cell: int, start: int, length: int, mcs: int,
                  harq_pid: int = 0, ndi: int = 0, rv: int = 0,
                  tpc: int = 0) -> np.ndarray:
    riv_bits = ra.riv_nof_bits(n_prb_cell)
    fields = [
        (1, 1),                       # flag: 1 = format 1A
        (1, 1),                       # localized VRB
        (ra.riv_encode(n_prb_cell, start, length), riv_bits),
        (mcs, 5), (harq_pid, 3), (ndi, 1), (rv, 2), (tpc, 2),
    ]
    bits = np.concatenate([uint_to_bits(v, n) for v, n in fields])
    pad = format0_1a_size(n_prb_cell) - len(bits)
    return np.concatenate([bits, np.zeros(pad, np.int8)])


def unpack_format1a(bits: np.ndarray, n_prb_cell: int) -> DciDl | None:
    if bits_to_uint(bits[0:1]) != 1:
        return None                   # it's a format 0
    riv_bits = ra.riv_nof_bits(n_prb_cell)
    p = 2
    riv = bits_to_uint(bits[p : p + riv_bits]); p += riv_bits
    mcs = bits_to_uint(bits[p : p + 5]); p += 5
    harq = bits_to_uint(bits[p : p + 3]); p += 3
    ndi = bits_to_uint(bits[p : p + 1]); p += 1
    rv = bits_to_uint(bits[p : p + 2]); p += 2
    tpc = bits_to_uint(bits[p : p + 2]); p += 2
    start, length = ra.riv_decode(riv, n_prb_cell)
    if start + length > n_prb_cell:
        return None
    return DciDl("1A", mcs, harq, ndi, rv,
                 ra.prb_mask_type2(n_prb_cell, start, length), tpc=tpc)


def pack_format0(n_prb_cell: int, start: int, length: int, mcs: int,
                 ndi: int = 0, tpc: int = 0, dmrs: int = 0,
                 cqi_req: int = 0) -> np.ndarray:
    riv_bits = ra.riv_nof_bits(n_prb_cell)
    fields = [
        (0, 1), (0, 1),
        (ra.riv_encode(n_prb_cell, start, length), riv_bits),
        (mcs, 5), (ndi, 1), (tpc, 2), (dmrs, 3), (cqi_req, 1),
    ]
    bits = np.concatenate([uint_to_bits(v, n) for v, n in fields])
    pad = format0_1a_size(n_prb_cell) - len(bits)
    return np.concatenate([bits, np.zeros(pad, np.int8)])


def unpack_format0(bits: np.ndarray, n_prb_cell: int) -> DciUl | None:
    if bits_to_uint(bits[0:1]) != 0:
        return None
    riv_bits = ra.riv_nof_bits(n_prb_cell)
    p = 2
    riv = bits_to_uint(bits[p : p + riv_bits]); p += riv_bits
    mcs = bits_to_uint(bits[p : p + 5]); p += 5
    ndi = bits_to_uint(bits[p : p + 1]); p += 1
    p += 2  # tpc
    dmrs = bits_to_uint(bits[p : p + 3]); p += 3
    cqi_req = bits_to_uint(bits[p : p + 1]); p += 1
    start, length = ra.riv_decode(riv, n_prb_cell)
    if start + length > n_prb_cell:
        return None
    return DciUl(mcs, ndi, start, length, dmrs, cqi_req)


def pack_format1(n_prb_cell: int, rbg_bitmap: int, mcs: int,
                 harq_pid: int = 0, ndi: int = 0, rv: int = 0,
                 tpc: int = 0) -> np.ndarray:
    n_rbg = math.ceil(n_prb_cell / ra.rbg_size(n_prb_cell))
    fields = []
    if n_prb_cell > 10:
        fields.append((0, 1))         # RA header: type 0
    fields += [(rbg_bitmap, n_rbg), (mcs, 5), (harq_pid, 3), (ndi, 1),
               (rv, 2), (tpc, 2)]
    bits = np.concatenate([uint_to_bits(v, n) for v, n in fields])
    pad = format1_size(n_prb_cell) - len(bits)
    return np.concatenate([bits, np.zeros(pad, np.int8)])


def unpack_format1(bits: np.ndarray, n_prb_cell: int) -> DciDl | None:
    n_rbg = math.ceil(n_prb_cell / ra.rbg_size(n_prb_cell))
    p = 1 if n_prb_cell > 10 else 0
    bitmap = bits_to_uint(bits[p : p + n_rbg]); p += n_rbg
    mcs = bits_to_uint(bits[p : p + 5]); p += 5
    harq = bits_to_uint(bits[p : p + 3]); p += 3
    ndi = bits_to_uint(bits[p : p + 1]); p += 1
    rv = bits_to_uint(bits[p : p + 2]); p += 2
    mask = ra.prb_mask_type0(n_prb_cell, bitmap)
    if not any(mask):
        return None
    return DciDl("1", mcs, harq, ndi, rv, mask)


def format2_size(n_prb_cell: int, nof_ports: int = 2,
                 open_loop: bool = False) -> int:
    """Formats 2 (TM4) / 2A (TM3): RA header + RBG bitmap + TPC(2) +
    HARQ(3) + swap flag(1) + 2x[MCS(5)+NDI(1)+RV(2)] + precoding info."""
    n_rbg = math.ceil(n_prb_cell / ra.rbg_size(n_prb_cell))
    precoding = (0 if open_loop else 3) if nof_ports == 2 else 6
    size = ((1 if n_prb_cell > 10 else 0) + n_rbg + 2 + 3 + 1
            + 2 * (5 + 1 + 2) + precoding)
    while size in AMBIGUOUS_SIZES or size in (
            format0_1a_size(n_prb_cell), format1_size(n_prb_cell)):
        size += 1
    return size


@dataclass
class DciDl2:
    """Resolved MIMO DL grant (format 2/2A)."""

    prb_mask: tuple[bool, ...]
    mcs: tuple[int, int]
    rv: tuple[int, int]
    ndi: tuple[int, int]
    harq_pid: int
    swap: int
    pmi: int

    @property
    def n_prb(self) -> int:
        return sum(self.prb_mask)


def pack_format2(n_prb_cell: int, rbg_bitmap: int, mcs: tuple[int, int],
                 harq_pid: int = 0, ndi=(0, 0), rv=(0, 0), pmi: int = 0,
                 swap: int = 0, open_loop: bool = False) -> np.ndarray:
    n_rbg = math.ceil(n_prb_cell / ra.rbg_size(n_prb_cell))
    fields = []
    if n_prb_cell > 10:
        fields.append((0, 1))
    fields += [(rbg_bitmap, n_rbg), (0, 2), (harq_pid, 3), (swap, 1)]
    for i in range(2):
        fields += [(mcs[i], 5), (ndi[i], 1), (rv[i], 2)]
    if not open_loop:
        fields.append((pmi, 3))
    bits = np.concatenate([uint_to_bits(v, n) for v, n in fields])
    pad = format2_size(n_prb_cell, open_loop=open_loop) - len(bits)
    return np.concatenate([bits, np.zeros(pad, np.int8)])


def unpack_format2(bits: np.ndarray, n_prb_cell: int,
                   open_loop: bool = False) -> DciDl2 | None:
    n_rbg = math.ceil(n_prb_cell / ra.rbg_size(n_prb_cell))
    p = 1 if n_prb_cell > 10 else 0
    bitmap = bits_to_uint(bits[p : p + n_rbg]); p += n_rbg
    p += 2  # tpc
    harq = bits_to_uint(bits[p : p + 3]); p += 3
    swap = bits_to_uint(bits[p : p + 1]); p += 1
    mcs, ndi, rv = [], [], []
    for _ in range(2):
        mcs.append(bits_to_uint(bits[p : p + 5])); p += 5
        ndi.append(bits_to_uint(bits[p : p + 1])); p += 1
        rv.append(bits_to_uint(bits[p : p + 2])); p += 2
    pmi = 0 if open_loop else bits_to_uint(bits[p : p + 3])
    mask = ra.prb_mask_type0(n_prb_cell, bitmap)
    if not any(mask):
        return None
    return DciDl2(mask, tuple(mcs), tuple(rv), tuple(ndi), harq, swap, pmi)


# --- Formats 1B / 1D (compact + precoding; dci.c:777-832, 1008-1120) ---------


def tpmi_bits(nof_ports: int) -> int:
    return 2 if nof_ports <= 2 else 4


def format1b_size(n_prb_cell: int, nof_ports: int = 2) -> int:
    """Format 1B/1D: format-1A fields minus the flag bit, plus
    TPMI + PMI-confirm/power-offset (dci.c dci_format1B_sizeof)."""
    n = format0_1a_size(n_prb_cell) - 1 + tpmi_bits(nof_ports) + 1
    while n in AMBIGUOUS_SIZES:
        n += 1
    return n


format1d_size = format1b_size


@dataclass
class DciDlPrecoded:
    """Resolved format 1B/1D grant (single codeword + codebook info)."""

    format: str
    mcs: int
    harq_pid: int
    ndi: int
    rv: int
    pinfo: int                 # TPMI
    flag: int                  # 1B: PMI confirmation; 1D: power offset
    dist: bool
    prb_mask: tuple[bool, ...]           # slot 0
    prb_mask_slot1: tuple[bool, ...]     # slot 1 (differs when distributed)

    @property
    def n_prb(self) -> int:
        return sum(self.prb_mask)


def _pack_format1b1d(n_prb_cell: int, start: int, length: int, mcs: int,
                     harq_pid: int, ndi: int, rv: int, pinfo: int,
                     flag: int, dist: bool, ngap_is_1: bool,
                     nof_ports: int) -> np.ndarray:
    riv_bits = ra.riv_nof_bits(n_prb_cell)
    fields = [(1 if dist else 0, 1)]
    nb_gap = 0
    if dist and n_prb_cell >= 50:
        nb_gap = 1
        fields.append((0 if ngap_is_1 else 1, 1))
    fields += [
        (ra.riv_encode(n_prb_cell, start, length), riv_bits - nb_gap),
        (mcs, 5), (harq_pid, 3), (ndi, 1), (rv, 2), (0, 2),
        (pinfo, tpmi_bits(nof_ports)), (flag, 1),
    ]
    bits = np.concatenate([uint_to_bits(v, n) for v, n in fields])
    pad = format1b_size(n_prb_cell, nof_ports) - len(bits)
    return np.concatenate([bits, np.zeros(pad, np.int8)])


def pack_format1b(n_prb_cell: int, start: int, length: int, mcs: int,
                  harq_pid: int = 0, ndi: int = 0, rv: int = 0,
                  pinfo: int = 0, pmi_confirm: int = 0, dist: bool = False,
                  ngap_is_1: bool = True, nof_ports: int = 2) -> np.ndarray:
    return _pack_format1b1d(n_prb_cell, start, length, mcs, harq_pid, ndi,
                            rv, pinfo, pmi_confirm, dist, ngap_is_1,
                            nof_ports)


def pack_format1d(n_prb_cell: int, start: int, length: int, mcs: int,
                  harq_pid: int = 0, ndi: int = 0, rv: int = 0,
                  pinfo: int = 0, power_offset: int = 0, dist: bool = False,
                  ngap_is_1: bool = True, nof_ports: int = 2) -> np.ndarray:
    return _pack_format1b1d(n_prb_cell, start, length, mcs, harq_pid, ndi,
                            rv, pinfo, power_offset, dist, ngap_is_1,
                            nof_ports)


def _unpack_format1b1d(bits: np.ndarray, n_prb_cell: int, fmt: str,
                       nof_ports: int) -> DciDlPrecoded | None:
    riv_bits = ra.riv_nof_bits(n_prb_cell)
    p = 0
    dist = bool(bits_to_uint(bits[p : p + 1])); p += 1
    ngap_is_1 = True
    nb_gap = 0
    if dist and n_prb_cell >= 50:
        nb_gap = 1
        ngap_is_1 = bits_to_uint(bits[p : p + 1]) == 0; p += 1
    riv = bits_to_uint(bits[p : p + riv_bits - nb_gap])
    p += riv_bits - nb_gap
    mcs = bits_to_uint(bits[p : p + 5]); p += 5
    harq = bits_to_uint(bits[p : p + 3]); p += 3
    ndi = bits_to_uint(bits[p : p + 1]); p += 1
    rv = bits_to_uint(bits[p : p + 2]); p += 2
    p += 2  # TPC
    pinfo = bits_to_uint(bits[p : p + tpmi_bits(nof_ports)])
    p += tpmi_bits(nof_ports)
    flag = bits_to_uint(bits[p : p + 1])
    nof_vrb = n_prb_cell if not dist else \
        ra.type2_n_vrb_dl(n_prb_cell, ngap_is_1)
    start, length = ra.type2_riv_decode(riv, n_prb_cell, nof_vrb)
    if start + length > nof_vrb:
        return None
    if dist:
        try:
            m0, m1 = ra.prb_mask_type2_dist(n_prb_cell, start, length,
                                            ngap_is_1)
        except ValueError:
            return None
    else:
        m0 = m1 = ra.prb_mask_type2(n_prb_cell, start, length)
    return DciDlPrecoded(fmt, mcs, harq, ndi, rv, pinfo, flag, dist, m0, m1)


def unpack_format1b(bits: np.ndarray, n_prb_cell: int,
                    nof_ports: int = 2) -> DciDlPrecoded | None:
    return _unpack_format1b1d(bits, n_prb_cell, "1B", nof_ports)


def unpack_format1d(bits: np.ndarray, n_prb_cell: int,
                    nof_ports: int = 2) -> DciDlPrecoded | None:
    return _unpack_format1b1d(bits, n_prb_cell, "1D", nof_ports)


# --- Format 1C (very compact, distributed only; dci.c:1122-1206) -------------


def format1c_size(n_prb_cell: int) -> int:
    n_vrb = ra.type2_n_vrb_dl(n_prb_cell, True)
    step = ra.type2_n_rb_step(n_prb_cell)
    n = ra.riv_nof_bits(n_vrb // step) + 5
    if n_prb_cell >= 50:
        n += 1
    return n


@dataclass
class DciDl1C:
    """Resolved format 1C grant: i_tbs indexes the 7.1.7.2.3 TBS table."""

    i_tbs: int
    dist: bool
    prb_mask: tuple[bool, ...]
    prb_mask_slot1: tuple[bool, ...]

    @property
    def n_prb(self) -> int:
        return sum(self.prb_mask)


def pack_format1c(n_prb_cell: int, start: int, length: int, i_tbs: int,
                  ngap_is_1: bool = True) -> np.ndarray:
    """start/length in PRBs; both must be multiples of N_RB_step."""
    step = ra.type2_n_rb_step(n_prb_cell)
    assert start % step == 0 and length % step == 0 and length > 0
    n_vrb = ra.type2_n_vrb_dl(n_prb_cell, ngap_is_1)
    n_vrb_p = n_vrb // step
    fields = []
    if n_prb_cell >= 50:
        fields.append((0 if ngap_is_1 else 1, 1))
    riv = ra.riv_encode(n_vrb_p, start // step, length // step)
    fields += [(riv, ra.riv_nof_bits(ra.type2_n_vrb_dl(n_prb_cell, True)
                                     // step)),
               (i_tbs, 5)]
    return np.concatenate([uint_to_bits(v, n) for v, n in fields])


def unpack_format1c(bits: np.ndarray, n_prb_cell: int) -> DciDl1C | None:
    p = 0
    ngap_is_1 = True
    if n_prb_cell >= 50:
        ngap_is_1 = bits_to_uint(bits[p : p + 1]) == 0; p += 1
    step = ra.type2_n_rb_step(n_prb_cell)
    n_vrb = ra.type2_n_vrb_dl(n_prb_cell, ngap_is_1)
    n_vrb_p = n_vrb // step
    nbits = ra.riv_nof_bits(ra.type2_n_vrb_dl(n_prb_cell, True) // step)
    riv = bits_to_uint(bits[p : p + nbits]); p += nbits
    i_tbs = bits_to_uint(bits[p : p + 5])
    start_p, len_p = ra.type2_riv_decode(riv, n_vrb_p, n_vrb_p)
    if start_p + len_p > n_vrb_p:
        return None
    try:
        m0, m1 = ra.prb_mask_type2_dist(n_prb_cell, start_p * step,
                                        len_p * step, ngap_is_1)
    except ValueError:
        return None
    return DciDl1C(i_tbs, True, m0, m1)
