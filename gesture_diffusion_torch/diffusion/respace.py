"""Timestep respacing ("ddimN", "fast27", comma sections, "path:").

Port of ``gesture_diffusion_tpu/diffusion/respace.py``: the respaced
:class:`Schedule` comes with a ``timestep_map`` (respaced index -> original
timestep) that samplers apply before the model's timestep embedding.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Set, Tuple

import numpy as np
import torch

from .gaussian import Schedule, make_schedule
from .schedules import get_named_beta_schedule


def space_timesteps(num_timesteps: int, section_counts) -> Set[int]:
    """Choose which original timesteps to keep (reference semantics)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("path:"):
            return set(int(s) for s in np.load(section_counts[len("path:"):]))
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer stride")
        if section_counts == "fast27":
            steps = space_timesteps(num_timesteps, "10,10,3,2,2")
            steps.remove(num_timesteps - 1)
            steps.add(num_timesteps - 3)
            return steps
        section_counts = [int(x) for x in section_counts.split(",")]
    elif isinstance(section_counts, int):
        section_counts = [section_counts]

    size_per, extra = divmod(num_timesteps, len(section_counts))
    start_idx = 0
    all_steps: list[int] = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


def respaced_schedule(base_betas: np.ndarray, use_timesteps: Iterable[int]
                      ) -> Tuple[Schedule, torch.Tensor]:
    """Recompute betas over the kept steps.

    :return: (schedule over the kept steps, int64 timestep_map mapping the
             respaced index -> original timestep index).
    """
    use = set(int(t) for t in use_timesteps)
    acp = np.cumprod(1.0 - np.asarray(base_betas, dtype=np.float64))
    last = 1.0
    new_betas, timestep_map = [], []
    for i, a in enumerate(acp):
        if i in use:
            new_betas.append(1.0 - a / last)
            last = a
            timestep_map.append(i)
    return (make_schedule(np.array(new_betas)),
            torch.tensor(timestep_map, dtype=torch.int64))


def make_diffusion(
    noise_schedule: str,
    diffusion_steps: int,
    timestep_respacing: "str | Sequence[int] | None" = None,
    is_training: bool = False,
) -> Tuple[Schedule, torch.Tensor]:
    """Config-level factory: training always uses the full schedule; eval
    honours ``timestep_respacing``."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if not timestep_respacing or is_training:
        timestep_respacing = [diffusion_steps]
    return respaced_schedule(
        betas, space_timesteps(diffusion_steps, timestep_respacing))
