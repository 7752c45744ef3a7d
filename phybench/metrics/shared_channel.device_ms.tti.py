"""shared_channel.device_ms.tti: device time of the operations launched inside the ranges of the PDSCH/PUSCH equalizer, despreading and soft demapper, in ms per call.

Layer: shared channel. Moves tti_p95_ms. Ranges: pdsch.eq_demod, pusch.eq_demod.
"""

RANGES = ('pdsch.eq_demod', 'pusch.eq_demod')


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
