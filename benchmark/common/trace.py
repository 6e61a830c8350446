"""The traced run's records: ``torch.profiler`` over the traced requests,
reduced to device operations and host events on one clock (seconds).

Device operations are the events the profiler puts on the card's
timeline (kernels, copies, sets); the card-side shadows of host ranges
(user annotations) are not operations.  The traced window is the
benchmark's own ``bench/window`` range."""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench/window"


@contextlib.contextmanager
def traced(enabled: bool, holder: dict):
    """Profile the block when ``enabled``; ``holder["records"]`` then holds
    (device operations, host events, window) after it."""
    if not enabled:
        yield
        return
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    holder["records"] = reduce(prof)


def _is_annotation(ev) -> bool:
    if getattr(ev, "is_user_annotation", None) and ev.is_user_annotation():
        return True
    kind = str(ev.activity_type()) if hasattr(ev, "activity_type") else ""
    return "annotation" in kind.lower()


def reduce(prof):
    """(device [(name, start_s, end_s, kind)], host [(name, start_s,
    end_s)], (window start, window end)) of a finished profile."""
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        a = ev.start_ns() * 1e-9
        b = a + ev.duration_ns() * 1e-9
        name = ev.name()
        if "cuda" in str(ev.device_type()).lower():
            if not _is_annotation(ev):
                kind = (str(ev.activity_type()).lower()
                        if hasattr(ev, "activity_type") else "kernel")
                device.append((name, a, b, kind))
        else:
            host.append((name, a, b))
            if name == WINDOW:
                window = (a, b)
    if window is None:
        raise RuntimeError("the trace has no bench/window range")
    return device, host, window


def top_ops(device, lo: float, hi: float, n: int = 10):
    """[[operation name, seconds], ...]: the device operations that took
    most time in [lo, hi], summed by name."""
    total = defaultdict(float)
    for name, a, b, _ in device:
        if b > lo and a < hi:
            total[name[:200]] += min(b, hi) - max(a, lo)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
