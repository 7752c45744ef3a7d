"""rx.launches.tput: device kernels launched per call (copies and fills
not counted).

Layer: receiver. Moves mbps.
"""


def read(trace, ctx):
    n = len(trace.kernels())
    return n / trace.calls if n else None
