"""Drive eNB and UE stacks TTI by TTI over one IQ air.

``StackDrive`` runs N ``EnbStack``\\ s and M ``UeStack``\\ s the way the
over-the-air tests route their air:

* with an ``Air`` (one eNB): the UEs' uplink signals are summed and pass
  ``air.ul`` (with the UE's timing advance when there is one UE), and
  every UE reads the one ``air.dl`` of the eNB's downlink
  (``tests/test_stack.py``, ``tests/test_multi_ue.py``);
* without one: every UE reads the sum of the eNBs' downlinks, each scaled
  by its entry of ``gains``, and every eNB hears the UEs' summed uplink as
  it is (``tests/test_handover_ota.py``, ``tests/test_idle_reselect.py``).
  The gains say which eNB serves the UEs: changing them between TTIs
  moves the UEs (a handover, a reselection).

``dl_filter`` is a channel applied to each UE's downlink (the CSI test's
two-tap echo). ``sync`` is called after each stack's TTI before its clock
stops (``torch.cuda.synchronize`` on the card), so ``ms_enb`` / ``ms_ue``
hold each stack's host-clock time per TTI. ``watch`` maps a name to a
condition (a function of nothing): ``event_tti[name]`` becomes the first
TTI after which the condition holds.

    drive = StackDrive([enb], [ue1, ue2], air=Air(cell.sf_sample_len))
    drive.run(200, until=lambda tti: len(enb.ul_gtpu) >= 2)
"""

from __future__ import annotations

import time

import numpy as np


class StackDrive:
    def __init__(self, enbs, ues, air=None, gains=None, dl_filter=None,
                 sync=None, watch=None):
        if air is not None and len(enbs) != 1:
            raise ValueError("an Air links one eNB with its UEs")
        self.enbs, self.ues = list(enbs), list(ues)
        self.air = air
        self.gains = (list(gains) if gains is not None
                      else [1.0] * len(self.enbs))
        self.dl_filter = dl_filter
        self.sync = sync
        self.watch = dict(watch or {})
        #: the TTI to run next
        self.tti = 0
        #: each UE's last uplink signal (None before its first)
        self.ul = [None] * len(self.ues)
        #: each eNB's last downlink signal, as it sent it
        self.dl = [None] * len(self.enbs)
        self.ms_enb = [[] for _ in self.enbs]
        self.ms_ue = [[] for _ in self.ues]
        self.event_tti: dict = {}

    def _timed(self, times: list, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if self.sync is not None:
            self.sync()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    def ul_sum(self):
        """The UEs' uplink signals summed (None before any UE sent)."""
        total = None
        for u in self.ul:
            if u is not None:
                total = u if total is None else total + u
        return total

    def step(self) -> None:
        """One TTI: every eNB, then every UE."""
        tti, ul = self.tti, self.ul_sum()
        if self.air is not None and ul is not None:
            adv = self.ues[0].timing_advance if len(self.ues) == 1 else 0
            ul = self.air.ul(ul, advance=adv)
        self.dl = [self._timed(ms, enb.tti, tti, ul)
                   for ms, enb in zip(self.ms_enb, self.enbs)]
        if self.air is not None:
            dl = self.air.dl(self.dl[0])
        else:
            dl = sum(g * x for g, x in zip(self.gains, self.dl)
                     ).astype(np.complex64)
        for i, ue in enumerate(self.ues):
            rx = dl if self.dl_filter is None else self.dl_filter(dl)
            self.ul[i] = self._timed(self.ms_ue[i], ue.tti, tti, rx)
        for name, cond in self.watch.items():
            if name not in self.event_tti and cond():
                self.event_tti[name] = tti
        self.tti += 1

    def run(self, max_tti: int, until=None, before=None) -> int:
        """Step until ``until(tti)`` is true after TTI ``tti``, or until
        TTI ``max_tti`` (counted from the drive's first TTI);
        ``before(tti)`` runs ahead of each TTI (an air that changes).
        -> the TTIs run so far."""
        while self.tti < max_tti:
            tti = self.tti
            if before is not None:
                before(tti)
            self.step()
            if until is not None and until(tti):
                break
        return self.tti
