"""Two-level RAN-slicing MAC schedulers (EmPOWER fork:
srsenb/src/mac/scheduler_RAN.cc parity, behind -DHAVE_RAN_SLICER).

Slice-level schedulers divide the TTI's RBGs between slices:

* ``MultiSliceMetric`` — credit-based multi-tenant scheduler
  (scheduler_RAN.cc:477-...): each slice holds credits proportional to its
  configured resources; slices spend credits per allocated RBG, replenished
  each window.
* ``DuoDynamicMetric`` — the duodynamic scheduler
  (scheduler_RAN.h:357-423): a movable PRBG "switch" splits the band
  between tenants A and B; the switch drifts toward the more loaded tenant
  over a load-measurement window.

Within each slice a round-robin user scheduler (scheduler_RAN.h:424)
assigns that slice's RBGs to its users. Both are drop-in ``metric``
plugins for mac.scheduler.Scheduler (the reference packages them as a
metric_dl plugin, scheduler_RAN.h:450-552).
"""

from __future__ import annotations

from dataclasses import dataclass

from .ran import DEFAULT_SLICE_ID, RanSlicer
from .scheduler import UeState


def _rr_users(users: list[UeState], rbgs: list[int], state: dict,
              n_rbg_total: int) -> dict[int, int]:
    """Round-robin the given RBG indices among the slice's active users."""
    active = [u for u in users
              if u.buffer_bytes > 0 or u.harq.pending_retx() is not None]
    if not active or not rbgs:
        return {}
    key = tuple(sorted(u.rnti for u in active))
    start = state.get(key, 0) % len(active)
    order = active[start:] + active[:start]
    state[key] = start + 1
    alloc: dict[int, int] = {}
    for i, g in enumerate(rbgs):
        u = order[i % len(order)]
        alloc[u.rnti] = alloc.get(u.rnti, 0) | (1 << (n_rbg_total - 1 - g))
    return alloc


class RanMetric:
    """Base: slice-aware metric plugging into Scheduler.metric."""

    def __init__(self, slicer: RanSlicer):
        self.slicer = slicer
        self._user_rr_state: dict = {}

    def slice_rbgs(self, tti: int, n_rbg: int) -> dict[int, list[int]]:
        raise NotImplementedError

    def new_tti(self, ues: list[UeState], n_rbg: int, tti: int):
        by_slice: dict[int, list[UeState]] = {}
        for u in ues:
            by_slice.setdefault(self.slicer.slice_of(u.rnti), []).append(u)
        out: dict[int, int] = {}
        for slice_id, rbgs in self.slice_rbgs(tti, n_rbg).items():
            users = by_slice.get(slice_id, [])
            for rnti, bm in _rr_users(users, rbgs, self._user_rr_state,
                                      n_rbg).items():
                out[rnti] = out.get(rnti, 0) | bm
        return out


class MultiSliceMetric(RanMetric):
    """Credit-based multi-slice scheduler (scheduler_RAN.cc 'multi')."""

    def __init__(self, slicer: RanSlicer, window_ttis: int = 10):
        super().__init__(slicer)
        self.window = window_ttis
        self._credits: dict[int, float] = {}

    def slice_rbgs(self, tti: int, n_rbg: int) -> dict[int, list[int]]:
        slices = [s for s in self.slicer.slices() if s.users or
                  s.slice_id == DEFAULT_SLICE_ID]
        total_res = sum(max(s.resources, 1) for s in slices)
        if tti % self.window == 0 or not self._credits:
            # replenish proportional to configured resources
            for s in slices:
                self._credits[s.slice_id] = (
                    max(s.resources, 1) / total_res * n_rbg * self.window)
        out: dict[int, list[int]] = {s.slice_id: [] for s in slices}
        order = sorted(slices, key=lambda s: -self._credits.get(s.slice_id, 0))
        g = 0
        while g < n_rbg and order:
            for s in sorted(order, key=lambda s: -self._credits.get(s.slice_id, 0)):
                if g >= n_rbg:
                    break
                if self._credits.get(s.slice_id, 0) <= 0:
                    continue
                out[s.slice_id].append(g)
                self._credits[s.slice_id] -= 1
                g += 1
            if all(self._credits.get(s.slice_id, 0) <= 0 for s in order):
                # everyone exhausted: hand the rest to the default slice
                while g < n_rbg:
                    out.setdefault(DEFAULT_SLICE_ID, []).append(g)
                    g += 1
        return out


@dataclass
class _DuoState:
    switch: int = 0                # RBG index splitting A (left) / B (right)
    load_a: float = 0.0
    load_b: float = 0.0


class DuoDynamicMetric(RanMetric):
    """Two-tenant scheduler with a movable PRBG switch
    (scheduler_RAN.h:357-423 'duodynamic')."""

    def __init__(self, slicer: RanSlicer, slice_a: int, slice_b: int,
                 window_ttis: int = 20, step: int = 1):
        super().__init__(slicer)
        self.a = slice_a
        self.b = slice_b
        self.window = window_ttis
        self.step = step
        self._state = _DuoState()

    def observe_load(self, load_a: float, load_b: float) -> None:
        """Feed demand (e.g. buffer bytes) for the adaptation window."""
        st = self._state
        st.load_a = 0.9 * st.load_a + 0.1 * load_a
        st.load_b = 0.9 * st.load_b + 0.1 * load_b

    def slice_rbgs(self, tti: int, n_rbg: int) -> dict[int, list[int]]:
        st = self._state
        if st.switch == 0:
            st.switch = n_rbg // 2
        # report loads from the slicer's users automatically
        if tti % self.window == 0:
            if st.load_a > 1.5 * st.load_b and st.switch < n_rbg - 1:
                st.switch = min(n_rbg - 1, st.switch + self.step)
            elif st.load_b > 1.5 * st.load_a and st.switch > 1:
                st.switch = max(1, st.switch - self.step)
        return {self.a: list(range(0, st.switch)),
                self.b: list(range(st.switch, n_rbg))}
