"""Rates and percentiles of a run, from host-clock timestamps (seconds)."""
from __future__ import annotations

import math


def quantile(values, q: float) -> float:
    """The q-quantile of `values` by linear interpolation between order
    statistics (numpy's default): position q (n - 1) in the sorted list."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float:
    return quantile(values, 0.5)


def rate(count: float, start: float, end: float) -> float:
    """`count` per second over [start, end]."""
    if end <= start:
        raise ValueError(f"empty interval [{start}, {end}]")
    return count / (end - start)


def gaps(times) -> list:
    """Differences of consecutive timestamps."""
    return [b - a for a, b in zip(times, times[1:])]
