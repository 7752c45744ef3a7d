"""tti_p95_ms: the 95th percentile, over every one-subframe call of the
window, of the call's host-clock time, from the call to its results on
the host, in ms (1 ms keeps up with the air; 4 ms is the HARQ
deadline)."""

from phybench.stats import p95


def read(win) -> float:
    return p95(win.latencies) * 1e3
