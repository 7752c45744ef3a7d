"""tx.host_syncs.dltx: CUDA runtime calls per call of the eNB's downlink
transmitter that block the host until the device catches up (stream, device
and event synchronizes; the call's wait for its samples makes one).

Layer: transmitter. Moves mbps.
"""


def read(trace, ctx):
    return trace.syncs / trace.calls if trace.syncs else None
