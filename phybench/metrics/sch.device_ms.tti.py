"""sch.device_ms.tti: device time of the operations launched inside the ranges of de-rate-matching, the turbo decode and the CRC and reassembly, in ms per call.

Layer: DL-SCH and UL-SCH. Moves tti_p95_ms. Ranges: dlsch.derm, dlsch.turbo_decode, dlsch.crc_reassembly.
"""

RANGES = ('dlsch.derm', 'dlsch.turbo_decode', 'dlsch.crc_reassembly')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
