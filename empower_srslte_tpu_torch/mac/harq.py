"""HARQ entities and processes (srsenb/src/mac/scheduler_harq.cc,
srsue/src/mac/dl_harq.cc parity).

8 stop-and-wait processes per direction; DL retransmissions cycle the
redundancy version 0 -> 2 -> 3 -> 1 (the standard rv_idx sequence) and the
PHY's per-CB softbuffers (models/sch.py) carry the combined LLRs.

UL processes carry the adaptive/non-adaptive retransmission distinction of
the reference (ul_harq_proc::set_alloc / re_alloc,
scheduler_harq.cc:200-214): a non-adaptive retx reuses the previous PRB
allocation and is signalled on PHICH only; an adaptive retx moves the
allocation and needs a new DCI format 0.  Max-retx exhaustion discards the
TB (harq_proc::set_ack, scheduler_harq.cc:104-105) and is surfaced to the
owner via ``max_retx_events`` for the RLF path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

NOF_HARQ_PROC = 8
#: rv sequence for retransmissions (36.213 7.1.7.1 convention).
RV_SEQ = (0, 2, 3, 1)
MAX_RETX = 4


@dataclass
class DlHarqProcess:
    pid: int
    active: bool = False
    ndi: int = 0
    n_tx: int = 0
    tbs: int = 0
    mcs: int = 0
    max_retx: int = MAX_RETX
    softbuffers: object = None     # per-CB device arrays, models/sch.py
    #: second-TB state for 2-codeword (TM3/TM4) grants: the reference keeps
    #: per-tb ndi/ack arrays (scheduler_harq.h ndi[2]); tb1 mirrors tb0's
    #: process lifetime but toggles independently.
    ndi1: int = 0
    tbs1: int = 0
    active1: bool = False

    @property
    def rv(self) -> int:
        return RV_SEQ[(self.n_tx - 1) % 4] if self.n_tx else 0

    def new_tx(self, tbs: int, mcs: int, tbs1: int = 0) -> None:
        self.active = True
        self.ndi ^= 1
        self.n_tx = 1
        self.tbs = tbs
        self.mcs = mcs
        self.softbuffers = None
        if tbs1:
            self.active1 = True
            self.ndi1 ^= 1
            self.tbs1 = tbs1

    def retx(self) -> None:
        assert self.active
        self.n_tx += 1

    def ack(self, ok: bool) -> bool:
        """Process feedback; returns True if a retransmission is needed.

        Exhausting max_retx discards the TB, matching the reference's
        "maximum number of retx exceeded" warning path
        (scheduler_harq.cc:104-108).
        """
        if ok or self.n_tx >= self.max_retx:
            self.active = False
            self.active1 = False
            self.softbuffers = None
            return False
        return True


@dataclass
class DlHarqEntity:
    max_retx: int = MAX_RETX
    processes: list = None
    #: pids whose TB was discarded on max-retx (drained by the owner; feeds
    #: the RLF accounting like the reference's discard warning).
    max_retx_events: list = field(default_factory=list)

    def __post_init__(self):
        if self.processes is None:
            self.processes = [DlHarqProcess(i, max_retx=self.max_retx)
                              for i in range(NOF_HARQ_PROC)]

    def set_max_retx(self, n: int) -> None:
        """harq_proc::set_max_retx (scheduler_harq.cc:57)."""
        self.max_retx = n
        for p in self.processes:
            p.max_retx = n

    def get_empty(self) -> DlHarqProcess | None:
        for p in self.processes:
            if not p.active:
                return p
        return None

    def pending_retx(self) -> DlHarqProcess | None:
        for p in self.processes:
            if p.active and p.n_tx > 0 and getattr(p, "_needs_retx", False):
                return p
        return None

    def feedback(self, pid: int, ok: bool) -> None:
        p = self.processes[pid]
        hit_cap = not ok and p.n_tx >= p.max_retx
        p._needs_retx = p.ack(ok)
        if hit_cap:
            self.max_retx_events.append(pid)


@dataclass
class UlHarqProcess:
    """UL HARQ process (ul_harq_proc, scheduler_harq.cc:195-262)."""

    pid: int
    active: bool = False
    ndi: int = 0
    n_tx: int = 0
    tbs: int = 0
    mcs: int = 0
    max_retx: int = MAX_RETX
    #: (start_prb, n_prb) of the current allocation.
    alloc: tuple = (0, 0)
    #: True when the pending retx was moved to a new allocation and must be
    #: signalled with a DCI 0 (re_alloc); False = PHICH-only non-adaptive
    #: retx on the same PRBs (set_alloc).
    is_adaptive: bool = False
    softbuffers: object = None
    _needs_retx: bool = False

    @property
    def rv(self) -> int:
        return RV_SEQ[(self.n_tx - 1) % 4] if self.n_tx else 0

    def new_tx(self, alloc: tuple, tbs: int, mcs: int) -> None:
        self.active = True
        self.ndi ^= 1
        self.n_tx = 1
        self.tbs = tbs
        self.mcs = mcs
        self.alloc = alloc
        self.is_adaptive = False
        self.softbuffers = None
        self._needs_retx = False

    def retx(self, alloc: tuple | None = None) -> None:
        """Retransmit: same allocation (non-adaptive) unless ``alloc``
        moves it (adaptive, needs DCI)."""
        assert self.active
        self.n_tx += 1
        if alloc is not None and alloc != self.alloc:
            self.alloc = alloc
            self.is_adaptive = True
        else:
            self.is_adaptive = False
        self._needs_retx = False

    def crc_result(self, ok: bool) -> bool:
        """Process the PUSCH decode result; True = retx needed."""
        if ok or self.n_tx >= self.max_retx:
            self.active = False
            self.softbuffers = None
            self._needs_retx = False
            return False
        self._needs_retx = True
        return True


@dataclass
class UlHarqEntity:
    max_retx: int = MAX_RETX
    processes: list = None
    max_retx_events: list = field(default_factory=list)

    def __post_init__(self):
        if self.processes is None:
            self.processes = [UlHarqProcess(i, max_retx=self.max_retx)
                              for i in range(NOF_HARQ_PROC)]

    def set_max_retx(self, n: int) -> None:
        self.max_retx = n
        for p in self.processes:
            p.max_retx = n

    def proc(self, tti: int) -> UlHarqProcess:
        """UL is synchronous: process index is tied to the TTI."""
        return self.processes[tti % NOF_HARQ_PROC]

    def get_empty(self) -> UlHarqProcess | None:
        for p in self.processes:
            if not p.active:
                return p
        return None

    def pending_retx(self) -> UlHarqProcess | None:
        for p in self.processes:
            if p.active and p._needs_retx:
                return p
        return None

    def crc_info(self, pid: int, ok: bool) -> None:
        p = self.processes[pid]
        hit_cap = not ok and p.n_tx >= p.max_retx
        p.crc_result(ok)
        if hit_cap:
            self.max_retx_events.append(pid)
