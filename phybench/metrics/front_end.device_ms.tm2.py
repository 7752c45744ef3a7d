"""front_end.device_ms.tm2: device time of the operations launched inside the ranges of the OFDM FFT and the 4-port channel and noise estimates, in ms per call.

Layer: front end. Moves mbps. Ranges: ue_dl.ofdm_rx, ue_dl.chest_noise.
"""

RANGES = ('ue_dl.ofdm_rx', 'ue_dl.chest_noise')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
