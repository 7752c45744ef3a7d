"""batch_p95_ms: the 95th percentile, over every call of the window, of
one batch call's host-clock time, from the call to its results on the
host, in ms."""

from phybench.stats import p95


def read(win) -> float:
    return p95(win.latencies) * 1e3
