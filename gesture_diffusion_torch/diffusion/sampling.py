"""The scan DDIM sampler: a Python step loop over ``model_fn``.

Port of ``gesture_diffusion_tpu/diffusion/sampling.py::ddim_sample_loop``.
``model_fn`` closes over the speech memory, so the encoder runs once per
clip.  This is the sampler of ``Generator(use_fused=False)``; the serving
path runs the fused kernel instead (``ops/fused_sampler.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .gaussian import (Schedule, _gather, predict_eps_from_xstart,
                       predict_xstart_from_eps)

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
DenoiseFn = Callable[[torch.Tensor], torch.Tensor]


def wrap_respaced(model_fn: ModelFn,
                  timestep_map: Optional[torch.Tensor]) -> ModelFn:
    """Map respaced timestep indices to original-process indices before the
    model's sinusoidal embedding sees them."""
    if timestep_map is None:
        return model_fn

    def wrapped(x, t):
        return model_fn(x, timestep_map.to(t.device)[t])

    return wrapped


@torch.no_grad()
def ddim_sample_loop(
    sched: Schedule,
    model_fn: ModelFn,
    noise: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    denoise_fn: Optional[DenoiseFn] = None,
    timestep_map: Optional[torch.Tensor] = None,
    eta: float = 0.0,
    step_noise: Optional[Callable[[int], torch.Tensor]] = None,
) -> torch.Tensor:
    """DDIM sampling (Song et al. eq. 12), deterministic at eta=0.

    At eta > 0 each step's z is ``step_noise(i)`` when given (tests inject
    the JAX package's draws), else drawn from ``generator``."""
    model_fn = wrap_respaced(model_fn, timestep_map)
    sched = sched.to(noise.device)
    n = noise.shape[0]
    x = noise
    for i in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((n,), i, dtype=torch.int64, device=x.device)
        eps = model_fn(x, t)
        pred_x_start = predict_xstart_from_eps(sched, x, t, eps)
        if denoise_fn is not None:
            pred_x_start = denoise_fn(pred_x_start)
            # re-derive eps from the blended x0_hat (identical to the model
            # eps without a blend, so skipped then)
            eps = predict_eps_from_xstart(sched, x, t, pred_x_start)
        a_prev = _gather(sched.alphas_cumprod_prev, t, x.ndim)
        if eta == 0.0:
            x = pred_x_start * torch.sqrt(a_prev) + torch.sqrt(1.0 - a_prev) * eps
            continue
        a_bar = _gather(sched.alphas_cumprod, t, x.ndim)
        sigma = (eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_bar))
                 * torch.sqrt(1.0 - a_bar / a_prev))
        mean_pred = (pred_x_start * torch.sqrt(a_prev)
                     + torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0))
                     * eps)
        z = (step_noise(i) if step_noise is not None else
             torch.randn(x.shape, generator=generator, device=x.device,
                         dtype=x.dtype))
        keep_noise = 1.0 if i != 0 else 0.0
        x = mean_pred + keep_noise * sigma * z
    return x
