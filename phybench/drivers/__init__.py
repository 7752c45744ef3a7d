"""One driver per receiver entry of the port, found by the name a
configuration gives under ``driver``."""
