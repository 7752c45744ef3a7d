"""shared_channel.device_ms.ul: device time of the operations launched inside
the ranges of the PUSCH's per-RE MMSE, transform de-precoding, soft
demapping and descrambling, in ms per call.

Layer: shared channel. Moves mbps. Ranges: pusch.eq_demod.
"""

RANGES = ('pusch.eq_demod',)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
