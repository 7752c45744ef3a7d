"""EmPOWER controller agent analog (srsenb/src/agent/empower_agent.cc
parity).

The reference's agent runs a thread speaking the emage protocol to an
external EmPOWER controller (em_start, empower_agent.cc:2617), streaming
UE reports, RRC measurement relays, cell PRB-utilization reports
(em_prb_report, empower_agent.h:69-87) and RAN-slice reports, and
accepting slice configuration. Here the same telemetry surface is exposed
as JSON over a pluggable transport (UDP socket or callback), and the MAC
hook ``process_dl_results`` counts PRBs from the issued grants exactly
like the reference's DCI accounting (empower_agent.h:257,344-348). A
``dummy`` transport mirrors dummy_agent.cc when no controller is present.
"""

from __future__ import annotations

import json
import socket
import time
from dataclasses import asdict, dataclass

from .ran import RanSlicer
from .scheduler import DlGrant


@dataclass
class PrbReport:
    """Cell PRB utilization over a report interval (em_prb_report)."""

    tti_window: int = 0
    dl_prb_used: int = 0
    dl_prb_total: int = 0
    ul_prb_used: int = 0
    ul_prb_total: int = 0


@dataclass
class UeReport:
    rnti: int
    slice_id: int
    cqi: int
    dl_tbs_acc: int = 0
    dl_grants: int = 0


class EmpowerAgent:
    """Telemetry collector + slice-config endpoint."""

    def __init__(self, slicer: RanSlicer | None = None,
                 controller_addr: tuple[str, int] | None = None,
                 callback=None):
        self.slicer = slicer or RanSlicer()
        self._cb = callback
        self._sock = None
        self._dest = controller_addr
        if controller_addr:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._prb = PrbReport()
        self._ues: dict[int, UeReport] = {}

    # --- MAC hook (mac.cc calls per TTI, empower_agent process_DL_results) --

    def process_dl_results(self, tti: int, grants: list[DlGrant],
                           nof_prb_cell: int, ues=None) -> None:
        self._prb.tti_window += 1
        self._prb.dl_prb_total += nof_prb_cell
        for g in grants:
            self._prb.dl_prb_used += g.n_prb
            r = self._ues.get(g.rnti)
            if r is None:
                cqi = ues[g.rnti].cqi if ues and g.rnti in ues else 0
                r = self._ues[g.rnti] = UeReport(
                    rnti=g.rnti, slice_id=self.slicer.slice_of(g.rnti),
                    cqi=cqi)
            r.dl_tbs_acc += g.tbs
            r.dl_grants += 1

    def process_ul_results(self, tti: int, n_prb_used: int,
                           nof_prb_cell: int) -> None:
        """UL PRB accounting (the reference counts DCI0 grants the same
        way it counts DL allocations, empower_agent.h:344-348)."""
        self._prb.ul_prb_used += n_prb_used
        self._prb.ul_prb_total += nof_prb_cell

    # --- controller-facing reports (empower_agent report senders) -----------

    def emit_reports(self) -> dict:
        report = {
            "ts": time.time(),
            "prb": asdict(self._prb),
            "ues": [asdict(u) for u in self._ues.values()],
            "slices": [
                {"slice_id": s.slice_id, "plmn": s.plmn,
                 "resources": s.resources, "users": sorted(s.users)}
                for s in self.slicer.slices()
            ],
        }
        payload = json.dumps(report).encode()
        if self._sock and self._dest:
            self._sock.sendto(payload, self._dest)
        if self._cb:
            self._cb(report)
        self._prb = PrbReport()
        self._ues = {}
        return report

    # --- controller commands (slice config set/get) -------------------------

    def handle_command(self, cmd: dict) -> dict:
        op = cmd.get("op")
        if op == "add_slice":
            self.slicer.add_slice(cmd["slice_id"], cmd.get("plmn", 0),
                                  cmd.get("resources", 0))
        elif op == "rem_slice":
            self.slicer.rem_slice(cmd["slice_id"])
        elif op == "set_resources":
            self.slicer.set_slice_resources(cmd["slice_id"], cmd["resources"])
        elif op == "assoc_user":
            self.slicer.add_user(cmd["rnti"], cmd["slice_id"])
        else:
            return {"ok": False, "error": f"unknown op {op}"}
        return {"ok": True}
