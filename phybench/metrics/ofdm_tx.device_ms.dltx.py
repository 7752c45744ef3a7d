"""ofdm_tx.device_ms.dltx: device time of the operations launched inside the
ranges of the OFDM modulator of both antenna ports, in ms per call of the
eNB's downlink transmitter.

Layer: front end. Moves mbps. Ranges: enb_dl.ofdm_tx.
"""

RANGES = ('enb_dl.ofdm_tx',)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
