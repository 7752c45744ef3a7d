"""rx.launches.tti: device kernels launched per call (copies and fills
not counted).

Layer: receiver. Moves tti_p95_ms.
"""


def read(trace, ctx):
    n = len(trace.kernels())
    return n / trace.calls if n else None
