"""The arithmetic of the metrics that read the program's own spans: the
``torch.profiler`` ranges ``gesture_diffusion_torch`` opens around its
phases (``generate/sample``, ``generate/window``, ``sampler/step``, ...),
found among a traced window's host events on the device trace's clock.
A program without a span gives no intervals, and its readers None."""

from __future__ import annotations

from typing import List, Sequence

from . import timeline
from .timeline import Interval


def intervals(rec, name: str) -> List[Interval]:
    """(start_s, end_s) of each ``name`` span inside the traced window, in
    start order."""
    lo, hi = rec["window"]
    return sorted((a, b) for n, a, b in rec["host"]
                  if n == name and a >= lo and b <= hi)


def idle_s(rec, spans: Sequence[Interval]) -> float:
    """Seconds inside ``spans`` in which no operation ran on the device:
    each span's length less the device's busy time over it."""
    device = [(a, b) for _, a, b, _ in rec["device"]]
    return sum((b - a) - timeline.busy(device, a, b) for a, b in spans)


def self_s(rec, name: str, children: Sequence[str]) -> float:
    """Seconds of the ``name`` spans that none of their ``children`` spans
    covers: the span's own host work."""
    inner = [iv for child in children for iv in intervals(rec, child)]
    return sum((b - a) - timeline.busy(inner, a, b)
               for a, b in intervals(rec, name))
