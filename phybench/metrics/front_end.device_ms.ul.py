"""front_end.device_ms.ul: device time of the operations launched inside the
ranges of the uplink's SC-FDMA demodulation and its PUSCH DMRS channel
estimate, in ms per call.

Layer: front end. Moves mbps. Ranges: enb_ul.fft, pusch.chest.
"""

RANGES = ('enb_ul.fft', 'pusch.chest')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
