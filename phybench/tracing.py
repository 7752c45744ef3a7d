"""Reading a ``torch.profiler`` trace of the receiver's calls.

The arithmetic is that of the port's ``profile_main_path.trace``: a
kernel belongs to the program range (a ``record_function`` span such as
``ue_dl.chest_noise``) that its launch call, matched by correlation id,
was made in, here the innermost one. Two changes: the device's busy time
is the union of the intervals of every device operation (kernels, copies
and fills), not their sum, so overlapping work counts once; and a range's
host time is its self time, its span less the part its child ranges
cover. Every value is a total over the traced calls; the metric files
divide by the number of calls.
"""

from __future__ import annotations

import bisect
import re

#: a program range: ``layer.stage`` in lower case
RANGE = re.compile(r"^[a-z_0-9]+\.[a-z_0-9]+$")
#: CUDA runtime calls that block the host until the device catches up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def _union(spans) -> list:
    """Merge [start, end] spans -> disjoint sorted spans."""
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(spans) -> float:
    return sum(e - s for s, e in _union(spans))


class Trace:
    """The events of ``calls`` traced calls, whose wall time (host clock,
    from the first call's start to the last call's results on the host)
    was ``wall_s``. Times are in seconds."""

    def __init__(self, events, wall_s: float, calls: int):
        from torch.autograd import DeviceType

        self.wall_s, self.calls = wall_s, calls
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        self.ranges = [(e.name, e.time_range.start * 1e-6,
                        e.time_range.end * 1e-6)
                       for e in cpu if RANGE.match(e.name)]
        self.device_ops = [e for e in events
                           if e.device_type == DeviceType.CUDA
                           and not e.is_user_annotation]
        launch = {e.id: e.time_range.start * 1e-6 for e in cpu
                  if e.name.startswith("cu")}
        self.syncs = sum(1 for e in cpu if e.name in SYNCS)
        self._nest()
        self.owner = {id(k): self.range_at(launch.get(k.id))
                      for k in self.device_ops}

    def _nest(self):
        """Sort the ranges by start and find each one's parent."""
        self._by_start = sorted(self.ranges, key=lambda r: r[1])
        self._starts = [r[1] for r in self._by_start]
        self._parent: list = []
        stack: list = []
        for i, (_n, s, _e) in enumerate(self._by_start):
            while stack and self._by_start[stack[-1]][2] < s:
                stack.pop()
            self._parent.append(stack[-1] if stack else None)
            stack.append(i)

    def range_at(self, t) -> str | None:
        """The innermost range open at host time ``t``, or None."""
        if t is None:
            return None
        i = bisect.bisect_right(self._starts, t) - 1
        while i is not None and i >= 0:
            if self._by_start[i][2] >= t:
                return self._by_start[i][0]
            i = self._parent[i]
        return None

    @staticmethod
    def _span(k) -> tuple:
        return k.time_range.start * 1e-6, k.time_range.end * 1e-6

    def kernels(self) -> list:
        """Device operations that are kernels (not copies or fills)."""
        return [k for k in self.device_ops
                if not k.name.startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return _covered(self._span(k) for k in self.device_ops)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.wall_s

    def host_s(self, names) -> float:
        """Self time of the ranges named ``names``: each span less the
        union of the other ranges inside it."""
        total = 0.0
        for name, s, e in self.ranges:
            if name not in names:
                continue
            kids = [(max(s, cs), min(e, ce)) for cn, cs, ce in self.ranges
                    if (cs, ce, cn) != (s, e, name) and cs >= s and ce <= e]
            total += (e - s) - _covered(kids)
        return total

    def device_s(self, names) -> float:
        """Device time of the operations launched inside ``names``."""
        return sum(k.device_time * 1e-6 for k in self.device_ops
                   if self.owner[id(k)] in names)

    def has_ranges(self, names) -> bool:
        return any(r[0] in names for r in self.ranges)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps of the device, each named by the innermost
        program range the host was in when the gap began ("host" when in
        none)."""
        by_name: dict = {}
        for k in self.device_ops:
            by_name[k.name] = by_name.get(k.name, 0.0) + k.device_time * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = _union(self._span(k) for k in self.device_ops)
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[self.range_at(s) or "host", e - s] for s, e in gaps[:top]]
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": named}
