"""Profiling helpers: the program's named spans, a device trace around a
block and synchronised timing of a function.

Port of ``gesture_diffusion_tpu/utils/profiling.py`` over
``torch.profiler``.  The JAX module's ``enable_compilation_cache`` (XLA's
persistent compile cache) has no counterpart: PyTorch runs eagerly, and
the port's one compiled artifact, the kernel library, is cached by
``ops/kernel_build.py`` under a hash of its source and flags.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

#: what ``span`` returns while no profiler records: one shared context
#: that does nothing
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """Context for a phase of the program named ``name``: a
    ``torch.profiler`` range while a profiler records, so the phase lands
    in the same trace as the device's operations, else a shared no-op.
    It keeps no clock of its own and never waits for the device; with no
    profiler on it costs one check (a bare ``record_function`` costs tens
    of times more)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with ``torch.profiler`` (CPU, and CUDA when
    present) and write a Chrome/TensorBoard trace under ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def _synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out``."""
    devices = set()

    def visit(x):
        if torch.is_tensor(x):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(out)
    for d in devices:
        torch.cuda.synchronize(d)


def time_fn(
    fn: Callable,
    *args,
    repetitions: int = 10,
    warmup: int = 3,
    trace_dir: Optional[str] = None,
):
    """Warm-up calls, then timed calls, each ending when the devices of its
    output are done (host clock).

    :return: (mean_ms, std_ms, last_output)"""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _synchronize(out)
    ctx = trace(trace_dir) if trace_dir else contextlib.nullcontext()
    timings = np.zeros(repetitions)
    with ctx:
        for rep in range(repetitions):
            t0 = time.perf_counter()
            out = fn(*args)
            _synchronize(out)
            timings[rep] = (time.perf_counter() - t0) * 1e3
    return float(timings.mean()), float(timings.std()), out
