"""rx.glue_host_ms.tput: host self time of the receiver's root range
``ue_dl.tm4_batch`` (its span less every range inside it): the
receiver's Python between its stages, in ms per call.

Layer: receiver. Moves mbps. Ranges: ue_dl.tm4_batch.
"""

RANGES = ("ue_dl.tm4_batch",)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
