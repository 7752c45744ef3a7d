"""ofdm_tx.host_ms.dltx: host self time (each range's span less its child
ranges) of the OFDM modulator of both antenna ports, in ms per call of the
eNB's downlink transmitter.

Layer: front end. Moves mbps. Ranges: enb_dl.ofdm_tx.
"""

RANGES = ('enb_dl.ofdm_tx',)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
