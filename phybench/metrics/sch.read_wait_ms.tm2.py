"""sch.read_wait_ms.tm2: host time inside the turbo decoder's early-stop
reads (``turbo.stop_read``: the device-to-host read of the "every code
block passed" flag, where the host waits for the card to drain its
queue), in ms per call.

Layer: DL-SCH and UL-SCH. Moves mbps. Ranges: turbo.stop_read.
"""

RANGES = ("turbo.stop_read",)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
