"""MAC layer: scheduling, HARQ, RAN slicing, controller telemetry.

Capability parity with srsenb/src/mac (scheduler.cc, scheduler_metric.cc,
scheduler_harq.cc, scheduler_ue.cc), the EmPOWER fork's RAN slicing
(srsenb/src/ran/ran.cc, srsenb/src/mac/scheduler_RAN.cc) and the
empower_agent telemetry surface (srsenb/src/agent/empower_agent.cc).
Host-side control logic feeding grant plans to the batched PHY.
"""

from .harq import DlHarqEntity, DlHarqProcess, UlHarqEntity, UlHarqProcess
from .scheduler import DlGrant, RrMetric, Scheduler, UeState, UlGrant
from .ran import RanSlicer, Slice
from .scheduler_ran import DuoDynamicMetric, MultiSliceMetric, RanMetric
from .agent import EmpowerAgent
from .procs import BsrProc, PhrProc, SrProc, TtiTimers, UlSchConfig

__all__ = [
    "DlHarqEntity", "DlHarqProcess", "UlHarqEntity", "UlHarqProcess",
    "DlGrant", "UlGrant", "RrMetric", "Scheduler",
    "UeState", "RanSlicer", "Slice", "DuoDynamicMetric", "MultiSliceMetric",
    "RanMetric", "EmpowerAgent",
    "BsrProc", "PhrProc", "SrProc", "TtiTimers", "UlSchConfig",
]
