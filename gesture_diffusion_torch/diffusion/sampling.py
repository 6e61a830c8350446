"""The scan samplers and the bpd evaluation: Python step loops over
``model_fn``.

Port of ``gesture_diffusion_tpu/diffusion/sampling.py``
(``ddpm_sample_loop``, ``ddim_sample_loop``, ``prior_bpd``, ``bpd_loop``).
``model_fn`` closes over the speech memory, so the encoder runs once per
clip.  These are the samplers of ``Generator(use_fused=False)`` and of
every decoder the fused kernel does not serve (all but the oneway one);
a oneway ``Generator`` runs the fused kernel instead
(``ops/fused_sampler.py``).  Each step of the two samplers is a
``sampler/step`` span (``utils/profiling.py::span``): ``model_fn`` and
the update.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .gaussian import (DenoiseFn, ModelFn, Schedule, _gather, mean_flat,
                       p_mean_variance, predict_eps_from_xstart,
                       predict_xstart_from_eps, q_mean_variance,
                       q_posterior_mean_variance, q_sample)
from .losses import continuous_gaussian_log_likelihood, normal_kl
from ..utils.profiling import span


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
def ddpm_sample_loop(
    sched: Schedule,
    model_fn: ModelFn,
    noise: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    denoise_fn: Optional[DenoiseFn] = None,
    timestep_map: Optional[torch.Tensor] = None,
    step_noise: Optional[Callable[[int], torch.Tensor]] = None,
) -> torch.Tensor:
    """Ancestral DDPM sampling, x_T -> x_0.  Each step's z is
    ``step_noise(i)`` when given (tests inject the JAX package's draws),
    else drawn from ``generator``; no noise is added at i == 0."""
    model_fn = wrap_respaced(model_fn, timestep_map)
    sched = sched.to(noise.device)
    n = noise.shape[0]
    x = noise
    for i in range(sched.num_timesteps - 1, -1, -1):
        with span("sampler/step"):
            t = torch.full((n,), i, dtype=torch.int64, device=x.device)
            out = p_mean_variance(sched, model_fn, x, t, denoise_fn=denoise_fn)
            z = (step_noise(i) if step_noise is not None else
                 torch.randn(x.shape, generator=generator, device=x.device,
                             dtype=x.dtype))
            keep_noise = 1.0 if i != 0 else 0.0
            x = (out["mean"]
                 + keep_noise * torch.exp(0.5 * out["log_variance"]) * z)
    return x


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
        with span("sampler/step"):
            t = torch.full((n,), i, dtype=torch.int64, device=x.device)
            eps = model_fn(x, t)
            pred_x_start = predict_xstart_from_eps(sched, x, t, eps)
            if denoise_fn is not None:
                pred_x_start = denoise_fn(pred_x_start)
                # re-derive eps from the blended x0_hat (identical to the
                # model eps without a blend, so skipped then)
                eps = predict_eps_from_xstart(sched, x, t, pred_x_start)
            a_prev = _gather(sched.alphas_cumprod_prev, t, x.ndim)
            if eta == 0.0:
                x = (pred_x_start * torch.sqrt(a_prev)
                     + torch.sqrt(1.0 - a_prev) * eps)
                continue
            a_bar = _gather(sched.alphas_cumprod, t, x.ndim)
            sigma = (eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_bar))
                     * torch.sqrt(1.0 - a_bar / a_prev))
            mean_pred = (pred_x_start * torch.sqrt(a_prev)
                         + torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2,
                                                  min=0.0)) * eps)
            z = (step_noise(i) if step_noise is not None else
                 torch.randn(x.shape, generator=generator, device=x.device,
                             dtype=x.dtype))
            keep_noise = 1.0 if i != 0 else 0.0
            x = mean_pred + keep_noise * sigma * z
    return x


def prior_bpd(sched: Schedule, x_start: torch.Tensor) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, I)) in bits/dim, (N,)."""
    n = x_start.shape[0]
    t = torch.full((n,), sched.num_timesteps - 1, dtype=torch.int64,
                   device=x_start.device)
    qt_mean, _, qt_log_var = q_mean_variance(sched, x_start, t)
    kl = normal_kl(qt_mean, qt_log_var, 0.0, 0.0)
    return mean_flat(kl) / math.log(2.0)


def timestep_noise(seed: int, t: int, shape, device,
                   dtype=torch.float32) -> torch.Tensor:
    """The bpd sweep's noise at timestep ``t``: a function of (seed, t)
    only, from a generator of its own, so that blocking the timesteps
    differently changes no number."""
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + t)
    return torch.randn(tuple(shape), generator=g, device=device, dtype=dtype)


@torch.no_grad()
def bpd_loop(
    sched: Schedule,
    model_fn: ModelFn,
    x_start: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    timestep_map: Optional[torch.Tensor] = None,
    t_block: int = 1,
    noise: Optional[torch.Tensor] = None,
) -> dict:
    """The variational bound over all timesteps.

    :param t_block: timesteps per model call.  The per-t terms are
        independent given ``x_start``, so ``t_block=k`` stacks k timesteps
        into one batch-``k*N`` call, ``T/k`` times.  ``model_fn`` must take
        any batch size (a caller with per-example conditioning tiles it k
        times, see ``Generator.eval_bpd``).
    :param noise: (T, N, ...) noise indexed by timestep, replacing the
        draws (tests inject the JAX package's).  Without it one seed is
        drawn from ``generator`` and timestep t gets
        ``timestep_noise(seed, t)``.
    :return: dict with total_bpd (N,), prior_bpd (N,), and per-timestep
        vb / x_start_mse / mse of shape (N, T) ordered from t = T-1 down
        to 0.
    """
    model_fn = wrap_respaced(model_fn, timestep_map)
    sched = sched.to(x_start.device)
    n, dev = x_start.shape[0], x_start.device
    T = sched.num_timesteps
    k = int(t_block)
    if k < 1 or T % k:
        raise ValueError(f"t_block {k} must divide num_timesteps {T}")
    if noise is not None and tuple(noise.shape) != (T,) + tuple(x_start.shape):
        raise ValueError(f"noise shape {tuple(noise.shape)} must be "
                         f"{(T,) + tuple(x_start.shape)}")
    seed = None
    if noise is None:
        gdev = generator.device if generator is not None else "cpu"
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=gdev))
    xs = x_start if k == 1 else torch.cat([x_start] * k, dim=0)   # (k*N, ...)

    vbs, x0_mses, mses = [], [], []
    for i in range(T // k):
        # block i covers t = T-1-i*k, ..., T-(i+1)*k (descending)
        ts = [T - 1 - (i * k + j) for j in range(k)]
        t = torch.tensor(ts, dtype=torch.int64, device=dev).repeat_interleave(n)
        z = torch.cat([noise[tt].to(dev) if noise is not None else
                       timestep_noise(seed, tt, x_start.shape, dev, x_start.dtype)
                       for tt in ts], dim=0)
        x_t = q_sample(sched, xs, t, z)
        true_mean, _, true_log_var = q_posterior_mean_variance(sched, xs, x_t, t)
        out = p_mean_variance(sched, model_fn, x_t, t)
        kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = mean_flat(kl) / math.log(2.0)
        decoder_nll = -continuous_gaussian_log_likelihood(
            xs, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        vb = torch.where(t == 0, decoder_nll, kl)
        eps = predict_eps_from_xstart(sched, x_t, t, out["pred_x_start"])
        vbs.append(vb.reshape(k, n))
        x0_mses.append(mean_flat((out["pred_x_start"] - xs) ** 2).reshape(k, n))
        mses.append(mean_flat((eps - z) ** 2).reshape(k, n))

    vb = torch.cat(vbs, dim=0).t()                 # (N, T), t = T-1 .. 0
    prior = prior_bpd(sched, x_start)
    return {
        "total_bpd": vb.sum(dim=1) + prior,
        "prior_bpd": prior,
        "vb": vb,
        "x_start_mse": torch.cat(x0_mses, dim=0).t(),
        "mse": torch.cat(mses, dim=0).t(),
    }
