"""front_end.host_ms.ul: host self time (each range's span less its child
ranges) of the uplink's SC-FDMA demodulation and its PUSCH DMRS channel
estimate, in ms per call.

Layer: front end. Moves mbps. Ranges: enb_ul.fft, pusch.chest.
"""

RANGES = ('enb_ul.fft', 'pusch.chest')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
