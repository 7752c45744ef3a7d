"""control_tx.host_ms.dltx: host self time (each range's span less its child
ranges) of the control region's composition (the CRS, the PCFICH, the PHICH
and both PDCCHs), in ms per call of the eNB's downlink transmitter.

Layer: control. Moves mbps. Ranges: enb_dl.control_tx.
"""

RANGES = ('enb_dl.control_tx',)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.host_s(RANGES) / trace.calls * 1e3
