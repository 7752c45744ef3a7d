"""rx.cold_events.tm2: first-use events the port counted while the traced
calls of the TM2 receiver ran (its counter registry,
``runtime.trace.counts()``: device tables built, kernel libraries
loaded, allocator segments added, cuFFT plans made, full garbage
collections), summed over the kinds, per call. 0 in a steady state.
None where the port keeps no such registry.

Layer: receiver. Moves mbps.
"""

from empower_srslte_tpu_torch.runtime import trace as port_trace


def read(trace, ctx):
    counts = getattr(port_trace, "counts", None)
    if counts is None:
        return None
    return sum(counts().values()) / trace.calls
