"""control_tx.device_ms.dltx: device time of the operations launched inside the
ranges of the control region's composition (the CRS, the PCFICH, the PHICH
and both PDCCHs), in ms per call of the eNB's downlink transmitter.

Layer: control. Moves mbps. Ranges: enb_dl.control_tx.
"""

RANGES = ('enb_dl.control_tx',)


def read(trace, ctx):
    if not trace.has_ranges(RANGES):
        return None
    return trace.device_s(RANGES) / trace.calls * 1e3
