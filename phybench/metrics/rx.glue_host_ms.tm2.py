"""rx.glue_host_ms.tm2: host self time of the TM2 receiver's root range
``ue_dl.tm2_batch`` (its span less every range inside it): the
receiver's Python between its stages, in ms per call.

Layer: receiver. Moves mbps. Ranges: ue_dl.tm2_batch.
"""

RANGES = ("ue_dl.tm2_batch",)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
