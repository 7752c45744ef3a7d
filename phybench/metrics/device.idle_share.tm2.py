"""device.idle_share.tm2: the share of the TM2 receiver's traced calls'
wall time in which no device operation ran (1 less the union of their
intervals over the wall time), in %.

Layer: device. Moves mbps.
"""


def read(trace, ctx):
    if not trace.device_ops:
        return None
    return 100.0 * trace.idle_share()
