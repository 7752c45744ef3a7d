"""tx.glue_host_ms.dltx: host self time of the transmitter's root range
``enb_dl.tx_batch`` (its span less every range inside it): the transmitter's
Python between its stages, in ms per call.

Layer: transmitter. Moves mbps. Ranges: enb_dl.tx_batch.
"""

RANGES = ("enb_dl.tx_batch",)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
