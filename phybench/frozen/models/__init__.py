"""Frozen copy: see ``phybench.frozen``."""
