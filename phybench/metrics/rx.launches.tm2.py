"""rx.launches.tm2: device kernels launched per call of the TM2 receiver
(copies and fills not counted).

Layer: receiver. Moves mbps.
"""


def read(trace, ctx):
    n = len(trace.kernels())
    return n / trace.calls if n else None
