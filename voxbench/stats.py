"""The rate and tail arithmetic of the end-to-end metrics, on host-clock
timestamps in seconds.

A tail is the nearest-rank percentile of every sample of the window (never
a statistic of chunk medians); a rate is the work over all of the window's
time.
"""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all values."""
    if not values:
        raise ValueError("no samples")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[k - 1])


def rate(count: int, t0: float, t1: float) -> float:
    """Work per second over the window [t0, t1]."""
    if t1 <= t0:
        raise ValueError(f"empty window [{t0}, {t1}]")
    return count / (t1 - t0)


def intervals(done, t0: float) -> list[float]:
    """The gaps between consecutive completions, the first from the
    window's start."""
    out, prev = [], t0
    for t in done:
        out.append(t - prev)
        prev = t
    return out


def latencies(handed, done) -> list[float]:
    """Each frame's time from its camera being handed over to its screen
    being done."""
    if len(handed) != len(done):
        raise ValueError(f"{len(handed)} cameras, {len(done)} screens")
    return [d - h for h, d in zip(handed, done)]
