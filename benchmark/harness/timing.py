"""The arithmetic of the end-to-end metrics: a rate over all the work and
all the time, and a percentile over all requests."""

from __future__ import annotations

import math
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """All the work done in the window over the window's whole length."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank *q*-th percentile (0 < q <= 100) of all *values*:
    the smallest value with at least q% of them at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100.0 * len(ordered))) - 1]
