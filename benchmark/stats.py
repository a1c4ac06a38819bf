"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every value, numpy's linear one."""
    if not len(values):
        raise ValueError("percentile of no values")
    return float(np.percentile(values, q))


def rate(completed: int, window_s: float) -> float:
    """Work completed in the window over the window's whole length."""
    if window_s <= 0:
        raise ValueError("a window of no length")
    return completed / window_s
