"""front_end.host_ms.tput: host self time (each range's span less its child ranges) of the OFDM FFT and the channel and noise estimates, in ms per call.

Layer: front end. Moves mbps. Ranges: ue_dl.ofdm_rx, ue_dl.chest_noise, enb_ul.fft, pusch.chest.
"""

RANGES = ('ue_dl.ofdm_rx', 'ue_dl.chest_noise', 'enb_ul.fft', 'pusch.chest')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
