"""control.host_ms.tm2: host self time (each range's span less its child ranges) of the PCFICH and the PDCCH region's SFBC-FSTD LLRs and the PDCCH blind search, in ms per call.

Layer: control. Moves mbps. Ranges: ue_dl.pdcch_llr, ue_dl.pdcch_blind_search.
"""

RANGES = ('ue_dl.pdcch_llr', 'ue_dl.pdcch_blind_search')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
