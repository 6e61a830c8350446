"""Learning-rate schedules as plain functions of the 0-based update index.

Port of ``gesture_diffusion_tpu/training/lr_schedule.py``: "noamxf"
(d_model^-0.5 times the Transformer warm-up, BEAT's choice with base lr 1),
"noam" (the StyleGestures decay, with an optional floor after warm-up) and
"const".  Update k reads ``schedule(k)``, as optax reads its schedule at
the update count.  noamxf already holds the +1 of torch's scheduler, which
steps once at construction, so the trainer sets each param group's ``lr``
to ``schedule(k)`` itself before ``optimizer.step()``; ``LambdaLR`` would
add the offset a second time.

The arithmetic is float32, as in the JAX package, so the values are the
JAX schedule's.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..utils.parsing import parse_steps

Schedule = Callable[[int], float]
_F32 = np.float32


def noam_xf_schedule(base_lr: float, d_model: int, warmup_steps: int) -> Schedule:
    scale = _F32(base_lr * float(d_model) ** -0.5)
    warm = _F32(warmup_steps) ** _F32(-1.5)

    def schedule(step: int) -> float:
        cur = _F32(step) + _F32(1.0)
        return float(scale * min(cur ** _F32(-0.5), cur * warm))

    return schedule


def noam_decay_schedule(base_lr: float, warmup_steps: int,
                        minimum: Optional[float] = None) -> Schedule:
    warmup = _F32(warmup_steps)
    root, warm = warmup ** _F32(0.5), warmup ** _F32(-1.5)

    def schedule(step: int) -> float:
        cur = max(_F32(step), _F32(1.0))
        lr = _F32(base_lr) * (root * min(cur ** _F32(-0.5), cur * warm))
        if minimum is not None and cur > warmup:
            lr = max(lr, _F32(minimum))
        return float(lr)

    return schedule


def build_lr_schedule(scheduler_params, base_lr: float) -> Schedule:
    """From the config's ``Train.Scheduler`` block (may be None)."""
    if scheduler_params is None:
        return lambda step: base_lr
    stype = scheduler_params.get("type", "const")
    if stype == "const":
        return lambda step: base_lr
    if stype == "noam":
        return noam_decay_schedule(
            base_lr, parse_steps(scheduler_params.warmup_steps),
            scheduler_params.get("minimum"))
    if stype == "noamxf":
        return noam_xf_schedule(
            base_lr, scheduler_params.d_model,
            parse_steps(scheduler_params.warmup_steps))
    raise ValueError(f"Unsupported lr scheduler type: {stype}")
