"""shared_channel.host_ms.ul: host self time (each range's span less its child
ranges) of the PUSCH's per-RE MMSE, transform de-precoding, soft demapping
and descrambling, in ms per call.

Layer: shared channel. Moves mbps. Ranges: pusch.eq_demod.
"""

RANGES = ('pusch.eq_demod',)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
