"""front_end.device_ms.tti: device time of the operations launched inside the ranges of the OFDM FFT and the channel and noise estimates, in ms per call.

Layer: front end. Moves tti_p95_ms. Ranges: ue_dl.ofdm_rx, ue_dl.chest_noise, enb_ul.fft, pusch.chest.
"""

RANGES = ('ue_dl.ofdm_rx', 'ue_dl.chest_noise', 'enb_ul.fft', 'pusch.chest')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
