"""shared_channel.host_ms.tm2: host self time (each range's span less its child ranges) of the PDSCH's SFBC-FSTD combining, soft demapper and descrambling, in ms per call.

Layer: shared channel. Moves mbps. Ranges: pdsch.eq_demod.
"""

RANGES = ('pdsch.eq_demod',)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
