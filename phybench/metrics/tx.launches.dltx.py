"""tx.launches.dltx: device kernels launched per call of the eNB's downlink
transmitter (copies and fills not counted).

Layer: transmitter. Moves mbps.
"""


def read(trace, ctx):
    n = len(trace.kernels())
    return n / trace.calls if n else None
