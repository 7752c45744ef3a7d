"""shared_channel.device_ms.tm2: device time of the operations launched inside the ranges of the PDSCH's SFBC-FSTD combining, soft demapper and descrambling, in ms per call.

Layer: shared channel. Moves mbps. Ranges: pdsch.eq_demod.
"""

RANGES = ('pdsch.eq_demod',)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
