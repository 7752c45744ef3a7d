"""sch.host_ms.tti: host self time (each range's span less its child ranges) of de-rate-matching, the turbo decode and the CRC and reassembly, in ms per call.

Layer: DL-SCH and UL-SCH. Moves tti_p95_ms. Ranges: dlsch.derm, dlsch.turbo_decode, dlsch.crc_reassembly.
"""

RANGES = ('dlsch.derm', 'dlsch.turbo_decode', 'dlsch.crc_reassembly')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
