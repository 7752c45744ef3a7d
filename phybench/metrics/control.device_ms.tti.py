"""control.device_ms.tti: device time of the operations launched inside the ranges of the PCFICH, the PDCCH and its blind search, the UCI demux and the CQI decode, in ms per call.

Layer: control. Moves tti_p95_ms. Ranges: ue_dl.pcfich, ue_dl.pdcch_llr, ue_dl.pdcch_blind_search, pusch.uci_demux, uci.cqi_decode.
"""

RANGES = ('ue_dl.pcfich', 'ue_dl.pdcch_llr', 'ue_dl.pdcch_blind_search', 'pusch.uci_demux', 'uci.cqi_decode')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
