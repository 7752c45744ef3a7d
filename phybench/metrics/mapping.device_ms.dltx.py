"""mapping.device_ms.dltx: device time of the operations launched inside the
ranges of the PDSCH's scrambling, modulation, layer mapping, precoding and
RE placement, in ms per call of the eNB's downlink transmitter.

Layer: shared channel. Moves mbps. Ranges: pdsch.map.
"""

RANGES = ('pdsch.map',)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
