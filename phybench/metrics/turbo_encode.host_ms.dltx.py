"""turbo_encode.host_ms.dltx: host self time (each range's span less its child
ranges) of the DL-SCH's turbo encoder, in ms per call of the eNB's downlink
transmitter.

Layer: DL-SCH and UL-SCH. Moves mbps. Ranges: dlsch.turbo_encode.
"""

RANGES = ('dlsch.turbo_encode',)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
