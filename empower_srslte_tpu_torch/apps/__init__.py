"""Command-line entry points of the port (``python -m
empower_srslte_tpu_torch.apps.<name>``)."""
