"""sch_tx.host_ms.dltx: host self time (each range's span less its child
ranges) of the DL-SCH encode's CRCs, segmentation and rate matching, in ms
per call of the eNB's downlink transmitter.

Layer: DL-SCH and UL-SCH. Moves mbps. Ranges: dlsch.crc_attach,
dlsch.rate_match.
"""

RANGES = ('dlsch.crc_attach', 'dlsch.rate_match')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
