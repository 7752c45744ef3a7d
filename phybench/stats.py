"""Statistics of a window's calls."""

from __future__ import annotations

import numpy as np


def p95(values) -> float:
    """The 95th percentile of every value (numpy's linear interpolation
    between the two nearest ranks)."""
    if not len(values):
        raise ValueError("no calls in the window")
    return float(np.percentile(np.asarray(values, np.float64), 95))
