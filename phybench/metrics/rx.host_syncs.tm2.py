"""rx.host_syncs.tm2: CUDA runtime calls per call of the TM2 receiver that
block the host until the device catches up (stream, device and event
synchronizes; a copy to the host makes one).

Layer: receiver. Moves mbps.
"""


def read(trace, ctx):
    return trace.syncs / trace.calls if trace.syncs else None
