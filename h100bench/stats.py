"""The arithmetic that turns a window's readings into metrics."""

from __future__ import annotations

import math
import statistics


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile of all ``values``: the smallest
    value with at least q % of them at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100.0 * len(ordered))) - 1]


def spread(values: list[float]) -> float:
    """The distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union(intervals: list[tuple[int, int]], lo: int,
          hi: int) -> list[tuple[int, int]]:
    """The union of ``intervals`` clipped to [lo, hi), sorted and
    disjoint."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
