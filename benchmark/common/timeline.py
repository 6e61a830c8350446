"""Reductions of a traced window: the union of device intervals (busy
time), the idle gaps between them, and the percentile rule."""

from __future__ import annotations

import bisect
import math
from collections import defaultdict
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]

#: the gaps that ``label_gaps`` names, longest first
LONGEST = 20000
#: host events before a gap's middle that ``label_gaps`` looks through
SCAN = 4000


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Disjoint, sorted cover of the intervals: overlapping operations
    (several streams, or a copy beside a kernel) count once."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of the union of the intervals within [lo, hi]."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it (so the p90 of 100 values is the 90th
    smallest, and 10 lie beyond it)."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def label_gaps(gap_list: Sequence[Interval],
               host: Sequence[Tuple[str, float, float]]) -> List[List]:
    """[[what the host was doing, idle seconds], ...] summed by label over
    the ``LONGEST`` gaps, largest first.  A gap's label is the innermost
    host event (operator, runtime call or range) that spans its middle;
    ``host`` holds (name, start, end) in the gaps' unit (seconds).  Where
    the nearest ``SCAN`` events before the middle hold none that spans
    it, the shortest long event (over 1 ms: a request's range) that does
    names it."""
    events = sorted(host, key=lambda e: e[1])
    starts = [e[1] for e in events]
    outer = sorted((e for e in events if e[2] - e[1] > 1e-3),
                   key=lambda e: e[2] - e[1])
    total = defaultdict(float)
    for a, b in sorted(gap_list, key=lambda g: g[0] - g[1])[:LONGEST]:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = next((events[j][0] for j in range(i, max(-1, i - SCAN), -1)
                     if events[j][2] >= mid), None)
        if name is None:
            name = next((e[0] for e in outer if e[1] <= mid <= e[2]),
                        "host: none")
        total[name] += b - a
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])]
