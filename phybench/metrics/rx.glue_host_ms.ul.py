"""rx.glue_host_ms.ul: host self time of the eNB receiver's root range
``enb_ul.pusch_batch`` (its span less every range inside it): the receiver's
Python between its stages, in ms per call.

Layer: receiver. Moves mbps. Ranges: enb_ul.pusch_batch.
"""

RANGES = ("enb_ul.pusch_batch",)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
