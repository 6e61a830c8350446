"""The system under test: the port's model and ``Generator`` built from a
frozen configuration, as the port's CLI builds them for serving, with the
benchmark's weights loaded.  The port is imported here and nowhere else
in the harness's shared code."""

from __future__ import annotations

from typing import Optional

import torch


def build_generator(cfg: dict, state_dict, device,
                    fused_dtype: Optional[torch.dtype] = None):
    """``Generator`` of ``gesture_diffusion_torch`` over the respaced
    schedule of ``cfg``, its model loaded with ``state_dict`` (strict:
    every name must be the program's)."""
    from gesture_diffusion_torch.generation.generator import Generator
    from gesture_diffusion_torch.models.factory import build_all
    from gesture_diffusion_torch.utils.json_config import JsonConfig

    bundle = build_all(JsonConfig(cfg), cfg["d_pose"], device=device)
    bundle.model.load_state_dict(state_dict)
    return Generator(bundle.model, bundle.eval_schedule,
                     bundle.eval_timestep_map, fused_dtype=fused_dtype,
                     device=device)


def fused_launches() -> int:
    """The program's counter of fused-kernel launches."""
    from gesture_diffusion_torch.ops import fused_sampler

    return fused_sampler.launches
