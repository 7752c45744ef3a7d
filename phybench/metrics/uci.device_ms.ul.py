"""uci.device_ms.ul: device time of the operations launched inside the ranges
of the UCI demultiplexing (HARQ-ACK and RI decode, the channel
de-interleaver) and the CQI decode, in ms per call.

Layer: UCI. Moves mbps. Ranges: pusch.uci_demux, uci.cqi_decode.
"""

RANGES = ('pusch.uci_demux', 'uci.cqi_decode')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
