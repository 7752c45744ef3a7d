"""Measurement tools of the port (each runs on the CUDA card)."""
