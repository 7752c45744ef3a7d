"""The benchmark's inputs: one transmitter per configuration kind, built
from the frozen copy in ``phybench.frozen`` and drawing on the device
from the run's seed."""
