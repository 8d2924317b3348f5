"""Window arithmetic: rates over a whole window, tails over all requests,
and the spread of repeated runs."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, Optional, Sequence


def rate(work: float, seconds: float) -> float:
    """Work over the whole window: every unit completed, every second of
    the window, the final sync included."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, by linear
    interpolation between closest ranks (numpy's default rule). A failed
    request is passed as ``math.inf``: it misses every limit."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return xs[hi] if pos > lo else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values: Iterable[float]) -> Optional[float]:
    xs = list(values)
    return sum(xs) / len(xs) if xs else None


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2)
