"""The arithmetic of the end-to-end metrics: tails over every request and
rates over the whole window."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``, in
    which a missing sample (a request that failed or never answered) is
    ``math.inf`` and so sorts above every answer."""
    if not values:
        return math.nan
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return count / seconds


def in_window(times, start: float, end: float) -> int:
    """How many of ``times`` fall inside [start, end]."""
    return sum(1 for t in times if start <= t <= end)
