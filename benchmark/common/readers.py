"""The arithmetic of the per-layer metrics, over a traced window's
records: ``device`` [(name, start_s, end_s, kind)], ``host`` [(name,
start_s, end_s)], ``window`` (start_s, end_s), ``requests`` (the traced
requests' records) and ``work`` (the traffic's count of what they
needed).  A reader that finds nothing to read returns None."""

from __future__ import annotations

import sys
from typing import Optional

from . import timeline
from .peaks import PEAK_BYTES, PEAK_FLOPS

FUSED = "fused_ddim_kernel"


def _inside(rec):
    lo, hi = rec["window"]
    return [d for d in rec["device"] if d[2] > lo and d[1] < hi]


def _kernels(rec):
    return [d for d in _inside(rec) if "kernel" in d[3]]


def window_s(rec) -> float:
    lo, hi = rec["window"]
    return hi - lo


def busy_s(rec) -> float:
    lo, hi = rec["window"]
    return timeline.busy([(a, b) for _, a, b, _ in rec["device"]], lo, hi)


def idle_pct(rec) -> float:
    return 100.0 * (1.0 - busy_s(rec) / window_s(rec))


def mfu_pct(rec) -> Optional[float]:
    """The work the configuration needs over the traced seconds at the
    card's peak."""
    flops = rec["work"].get("flops")
    if not flops:
        return None
    return 100.0 * flops / (window_s(rec) * PEAK_FLOPS)


def other_ms_per_window(rec) -> Optional[float]:
    """Device ms a window in every operation but the fused sampler's."""
    windows = rec["work"].get("windows")
    if not windows or not rec["work"].get("fused_flops"):
        return None
    ops = [d for d in _inside(rec) if FUSED not in d[0]]
    return 1e3 * sum(b - a for _, a, b, _ in ops) / windows


def fused_roofline_pct(rec) -> Optional[float]:
    """The least time of one fused call (operations at the peak rate or
    bytes at the peak bandwidth, the larger) over its device time."""
    w = rec["work"]
    calls = [d for d in _kernels(rec) if FUSED in d[0]]
    if not calls or not w.get("fused_flops"):
        return None
    per_call = sum(b - a for _, a, b, _ in calls) / len(calls)
    t_ops = w["fused_flops"] / PEAK_FLOPS
    t_bytes = w["fused_bytes"] / PEAK_BYTES
    bound = "operations" if t_ops >= t_bytes else "bytes"
    print(f"fused roofline: bound by {bound} ({max(t_ops, t_bytes)!r} s) over "
          f"{per_call!r} s a launch, {len(calls)} launches traced, "
          f"{w.get('launches')} counted by the program", file=sys.stderr)
    return 100.0 * max(t_ops, t_bytes) / per_call


def steps(rec) -> Optional[int]:
    """Eager denoiser steps in the traced window (None on the fused path)."""
    w = rec["work"]
    if w.get("fused_flops") or not w.get("windows"):
        return None
    return w["windows"] * w["steps"]


def kernels_per_step(rec) -> Optional[float]:
    n = steps(rec)
    return None if not n else len(_kernels(rec)) / n


def busy_ms_per_step(rec) -> Optional[float]:
    n = steps(rec)
    return None if not n else 1e3 * busy_s(rec) / n


def dispatch_ms(rec) -> Optional[float]:
    vals = [r["dispatch_s"] for r in rec["requests"] if "dispatch_s" in r]
    return 1e3 * sum(vals) / len(vals) if vals else None
