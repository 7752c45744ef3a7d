"""MAC downlink/uplink scheduler (srsenb/src/mac/scheduler.cc parity).

The ``Scheduler`` produces per-TTI grant lists (sched::dl_sched /
ul_sched, scheduler.h:128-129) through a pluggable metric interface
(scheduler.h:61-75); ``RrMetric`` is the reference's time-domain
round-robin RBG allocator (dl_metric_rr::new_tti,
scheduler_metric.cc:79). Per-UE state tracks CQI -> MCS and buffer
status (scheduler_ue.cc), HARQ via mac/harq.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..models import ra
from ..ops.dft_precoding import valid_prb
from .harq import DlHarqEntity, UlHarqEntity

#: CQI index -> highest I_MCS whose spectral efficiency fits (36.213-ish
#: conservative mapping, mirroring the reference's cqi_to_mcs behavior).
CQI_TO_MCS = (0, 0, 2, 4, 6, 8, 11, 13, 15, 18, 20, 22, 24, 26, 28, 28)

#: UL SNR window for closed-loop TPC (sched_ue::tpc_inc/tpc_dec,
#: scheduler_ue.cc:445-459: +-1 dB hysteresis around the target).
UL_SNR_TARGET_DB = 10.0


@dataclass
class UeState:
    rnti: int
    cqi: int = 7
    buffer_bytes: int = 0
    harq: DlHarqEntity = field(default_factory=DlHarqEntity)
    ul_harq: UlHarqEntity = field(default_factory=UlHarqEntity)
    slice_id: int = 0
    ul_buffer_bytes: int = 0          # from BSR (sched::ul_bsr)
    sr_pending: bool = False          # from SR (sched::ul_sr_info:444)
    ul_cqi: int = 7                   # from PUSCH SNR (scheduler_ue.cc:1222)
    #: one-shot TPC commands latched by ul_snr_info, consumed into the next
    #: DCI (next_tpc_pusch/pucch, scheduler_ue.cc:119-120,546,755; the
    #: value is the DCI TPC field: 0=-1dB, 1=0dB, 2=+1dB, 3=+3dB).
    next_tpc_pusch: int = 1
    next_tpc_pucch: int = 1
    #: TTIs since the last CQI report; drives aperiodic CQI requests.
    cqi_age: int = 0

    def max_mcs(self) -> int:
        return CQI_TO_MCS[min(self.cqi, 15)]

    def max_ul_mcs(self) -> int:
        return min(CQI_TO_MCS[min(self.ul_cqi, 15)], 24)


@dataclass
class DlGrant:
    rnti: int
    rbg_bitmap: int
    n_prb: int
    mcs: int
    tbs: int
    harq_pid: int
    rv: int = 0
    ndi: int = 0
    tpc_pucch: int = 1


@dataclass
class UlGrant:
    """One DCI-format-0 uplink grant (sched_interface::ul_sched_data)."""

    rnti: int
    start_prb: int
    n_prb: int
    mcs: int
    tbs: int
    harq_pid: int
    rv: int = 0
    ndi: int = 0
    tpc_pusch: int = 1
    cqi_request: bool = False
    #: False for a non-adaptive retx: no DCI is sent, the grant only
    #: reserves the PRBs (UE retransmits on PHICH NACK alone).
    needs_dci: bool = True


class RrMetric:
    """Round-robin RBG allocation across UEs with data
    (dl_metric_rr analog)."""

    def __init__(self):
        self._next = 0

    def new_tti(self, ues: list[UeState], n_rbg: int, tti: int):
        """Returns {rnti: rbg_bitmap} covering all RBGs round-robin.

        UEs with a pending HARQ retransmission count as active even with
        an empty buffer (the reference allocates retx before new data,
        dl_metric_rr::new_tti / sched_ue::get_pending_dl_harq)."""
        active = [u for u in ues
                  if u.buffer_bytes > 0 or u.harq.pending_retx() is not None]
        if not active:
            return {}
        alloc: dict[int, int] = {u.rnti: 0 for u in active}
        start = self._next % len(active)
        per = max(1, n_rbg // len(active))
        g = 0
        order = active[start:] + active[:start]
        for u in order:
            take = min(per, n_rbg - g)
            for i in range(take):
                alloc[u.rnti] |= 1 << (n_rbg - 1 - (g + i))
            g += take
            if g >= n_rbg:
                break
        # leftover RBGs to the first UE in order
        while g < n_rbg:
            alloc[order[0].rnti] |= 1 << (n_rbg - 1 - g)
            g += 1
        self._next += 1
        return {r: b for r, b in alloc.items() if b}


class Scheduler:
    """Grant production for one cell (sched class analog)."""

    def __init__(self, nof_prb: int, metric=None, max_mcs: int = 28):
        self.nof_prb = nof_prb
        self.p = ra.rbg_size(nof_prb)
        self.n_rbg = math.ceil(nof_prb / self.p)
        self.metric = metric or RrMetric()
        self.max_mcs = max_mcs
        self.ues: dict[int, UeState] = {}

    def add_ue(self, rnti: int, **kw) -> UeState:
        ue = UeState(rnti=rnti, **kw)
        self.ues[rnti] = ue
        return ue

    def rem_ue(self, rnti: int) -> None:
        self.ues.pop(rnti, None)

    def dl_buffer_state(self, rnti: int, nof_bytes: int) -> None:
        self.ues[rnti].buffer_bytes = nof_bytes

    def cqi_info(self, rnti: int, cqi: int) -> None:
        ue = self.ues[rnti]
        ue.cqi = cqi
        ue.cqi_age = 0

    # ---- uplink state inputs (sched::ul_* entry points) -----------------

    def ul_bsr(self, rnti: int, nof_bytes: int) -> None:
        """Buffer status report (sched::ul_bsr, scheduler.cc:402)."""
        self.ues[rnti].ul_buffer_bytes = nof_bytes

    def ul_sr_info(self, rnti: int) -> None:
        """Scheduling request (sched::ul_sr_info, scheduler.cc:444)."""
        self.ues[rnti].sr_pending = True

    def ul_crc_info(self, rnti: int, pid: int, ok: bool) -> None:
        """PUSCH decode result -> UL HARQ (sched::ul_crc_info)."""
        self.ues[rnti].ul_harq.crc_info(pid, ok)

    def ul_snr_info(self, rnti: int, snr_db: float) -> None:
        """Closed-loop power control: latch a one-shot TPC command when
        the PUSCH SNR leaves the +-1 dB window around the target
        (sched_ue::tpc_inc/tpc_dec, scheduler_ue.cc:445-459), and derive
        the UL CQI used for link adaptation (scheduler_ue.cc:1222)."""
        ue = self.ues[rnti]
        if snr_db < UL_SNR_TARGET_DB - 1.0:
            ue.next_tpc_pusch = 3
            ue.next_tpc_pucch = 3
        elif snr_db > UL_SNR_TARGET_DB + 1.0:
            ue.next_tpc_pusch = 0
            ue.next_tpc_pucch = 0
        ue.ul_cqi = max(0, min(15, int(snr_db / 2) + 2))

    def dl_sched(self, tti: int) -> list[DlGrant]:
        """One TTI of downlink grants (sched::dl_sched analog)."""
        for ue in self.ues.values():
            ue.cqi_age += 1
        alloc = self.metric.new_tti(list(self.ues.values()), self.n_rbg, tti)
        grants = []
        for rnti, bitmap in alloc.items():
            ue = self.ues[rnti]
            mask = ra.prb_mask_type0(self.nof_prb, bitmap)
            n_prb = sum(mask)
            if n_prb == 0:
                continue
            tpc = ue.next_tpc_pucch
            proc = ue.harq.pending_retx()
            if proc is not None:
                proc.retx()
                proc._needs_retx = False
                ue.next_tpc_pucch = 1
                grants.append(DlGrant(rnti, bitmap, n_prb, proc.mcs,
                                      proc.tbs, proc.pid, proc.rv, proc.ndi,
                                      tpc_pucch=tpc))
                continue
            proc = ue.harq.get_empty()
            if proc is None:
                continue
            mcs = min(ue.max_mcs(), self.max_mcs)
            _, tbs = ra.mcs_to_tbs(mcs, n_prb)
            # shrink MCS until the TB fits the buffer reasonably
            while mcs > 0 and tbs // 8 > max(ue.buffer_bytes, 1) * 2:
                mcs -= 1
                _, tbs = ra.mcs_to_tbs(mcs, n_prb)
            proc.new_tx(tbs, mcs)
            ue.buffer_bytes = max(0, ue.buffer_bytes - tbs // 8)
            ue.next_tpc_pucch = 1
            grants.append(DlGrant(rnti, bitmap, n_prb, mcs, tbs, proc.pid,
                                  0, proc.ndi, tpc_pucch=tpc))
        return grants

    def harq_feedback(self, rnti: int, pid: int, ok: bool) -> None:
        self.ues[rnti].harq.feedback(pid, ok)

    #: aperiodic CQI request threshold in TTIs: ask when the DL CQI is
    #: older than this on the next UL grant.
    CQI_MAX_AGE = 20

    @staticmethod
    def _shrink_valid(n: int) -> int:
        """Largest m <= n with m = 2^a 3^b 5^c (dft_precoding.c:95)."""
        while n > 1 and not valid_prb(n):
            n -= 1
        return max(n, 1)

    def ul_sched(self, tti: int) -> list[UlGrant]:
        """One TTI of uplink grants (sched::ul_sched analog).

        Order mirrors the reference: pending HARQ retransmissions first
        (non-adaptive on the same PRBs when still free, adaptive re-alloc
        otherwise, ul_harq_proc::set_alloc/re_alloc), then new
        transmissions for UEs with BSR data or a pending SR.  PUSCH
        allocations are contiguous and sized to valid DFT lengths
        (2^a 3^b 5^c).
        """
        grants: list[UlGrant] = []
        # PRB occupancy map for this TTI (True = taken)
        used = [False] * self.nof_prb

        def take(start, n):
            for i in range(start, start + n):
                used[i] = True

        def fits(start, n):
            return (0 <= start and start + n <= self.nof_prb
                    and not any(used[start:start + n]))

        def find_hole(n):
            run = 0
            for i in range(self.nof_prb):
                run = 0 if used[i] else run + 1
                if run >= n:
                    return i - n + 1
            return None

        # ---- 1. retransmissions --------------------------------------
        for ue in self.ues.values():
            proc = ue.ul_harq.pending_retx()
            if proc is None:
                continue
            start, n = proc.alloc
            if fits(start, n):
                proc.retx()                      # non-adaptive, PHICH only
                take(start, n)
                grants.append(UlGrant(ue.rnti, start, n, proc.mcs, proc.tbs,
                                      proc.pid, proc.rv, proc.ndi,
                                      needs_dci=False))
            else:
                hole = find_hole(n)
                if hole is None:
                    continue                     # retry next TTI
                proc.retx(alloc=(hole, n))       # adaptive: new DCI 0
                take(hole, n)
                tpc = ue.next_tpc_pusch
                ue.next_tpc_pusch = 1
                grants.append(UlGrant(ue.rnti, hole, n, proc.mcs, proc.tbs,
                                      proc.pid, proc.rv, proc.ndi,
                                      tpc_pusch=tpc, needs_dci=True))

        # ---- 2. new transmissions (BSR data or pending SR) ------------
        pending = [u for u in self.ues.values()
                   if (u.ul_buffer_bytes > 0 or u.sr_pending)
                   and u.ul_harq.get_empty() is not None]
        if pending:
            free = used.count(False)
            share = max(1, free // len(pending))
            for ue in pending:
                want = max(1, min(share,
                                  -(-max(ue.ul_buffer_bytes, 8) * 8 // 300)))
                n = self._shrink_valid(min(want, free))
                hole = find_hole(n)
                if hole is None:
                    continue
                mcs = min(ue.max_ul_mcs(), self.max_mcs)
                _, tbs = ra.mcs_to_tbs(mcs, n, dl=False)
                while mcs > 0 and tbs // 8 > max(ue.ul_buffer_bytes, 8) * 2:
                    mcs -= 1
                    _, tbs = ra.mcs_to_tbs(mcs, n, dl=False)
                proc = ue.ul_harq.get_empty()
                proc.new_tx((hole, n), tbs, mcs)
                take(hole, n)
                tpc = ue.next_tpc_pusch
                ue.next_tpc_pusch = 1
                cqi_req = ue.cqi_age > self.CQI_MAX_AGE
                ue.sr_pending = False            # sched.cc:978 unset_sr
                ue.ul_buffer_bytes = max(
                    0, ue.ul_buffer_bytes - tbs // 8)
                grants.append(UlGrant(ue.rnti, hole, n, mcs, tbs, proc.pid,
                                      0, proc.ndi, tpc_pusch=tpc,
                                      cqi_request=cqi_req, needs_dci=True))
        return grants
