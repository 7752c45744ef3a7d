"""device.idle_share.tti: the share of the traced calls' wall time in
which no device operation ran (1 less the union of their intervals over
the wall time), in %.

Layer: device. Moves tti_p95_ms.
"""


def read(trace, ctx):
    if not trace.device_ops:
        return None
    return 100.0 * trace.idle_share()
