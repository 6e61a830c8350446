"""Gaussian diffusion as functions over a coefficient table: the forward
process q, the posterior, the model's reverse step p and the eps <-> x0
conversions.

Port of ``gesture_diffusion_tpu/diffusion/gaussian.py``: every table is computed
on the host in float64 and stored as float32 tensors (CPU by default;
``Schedule.to`` moves it).  Model evaluation is ``model_fn(x_t, t) ->
eps``, so the caller closes over the conditioning memory.  Layout is
batch-first (N, T, C).  Variance type is FIXED_SMALL with epsilon
prediction.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]   # (x_t, t) -> eps
DenoiseFn = Callable[[torch.Tensor], torch.Tensor]             # x0_hat -> x0_hat


class Schedule(NamedTuple):
    """Per-timestep diffusion coefficients, each of shape (T,) float32."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "Schedule":
        return Schedule(*(t.to(device) for t in self))


def make_schedule(betas: np.ndarray) -> Schedule:
    """Build the coefficient table (host fp64 math, fp32 storage)."""
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    # variance is 0 at t=0; clip the log as the reference does
    post_log_var = np.log(np.append(posterior_variance[1],
                                    posterior_variance[1:]))
    # short linear schedules can reach beta == 1 (acp == 0, 1/acp == inf),
    # as in the reference; only numpy's divide-by-zero warning is silenced
    with np.errstate(divide="ignore"):
        arrays = dict(
            betas=betas,
            alphas_cumprod=acp,
            alphas_cumprod_prev=acp_prev,
            sqrt_alphas_cumprod=np.sqrt(acp),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp),
            log_one_minus_alphas_cumprod=np.log(1.0 - acp),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1.0),
            posterior_variance=posterior_variance,
            posterior_log_variance_clipped=post_log_var,
            posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
            posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(alphas)
            / (1.0 - acp),
        )
    return Schedule(**{k: torch.from_numpy(v.astype(np.float32))
                       for k, v in arrays.items()})


def _gather(coef: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """coef[t] broadcast to an ndim-rank tensor with batch leading."""
    out = coef.to(t.device)[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def q_mean_variance(sched: Schedule, x_start: torch.Tensor, t: torch.Tensor):
    """Mean, variance and log-variance of q(x_t | x_0)."""
    mean = _gather(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
    variance = _gather(1.0 - sched.alphas_cumprod, t, x_start.ndim)
    log_variance = _gather(sched.log_one_minus_alphas_cumprod, t, x_start.ndim)
    return mean, variance, log_variance


def q_sample(sched: Schedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Sample q(x_t | x_0).  t == -1 passes x_start through (the
    continuity-loss convention of the reference)."""
    x_t = (_gather(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
           + _gather(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
           * noise)
    t_b = t.reshape(t.shape + (1,) * (x_start.ndim - t.ndim))
    return torch.where(t_b == -1, x_start, x_t)


def q_posterior_mean_variance(sched: Schedule, x_start: torch.Tensor,
                              x_t: torch.Tensor, t: torch.Tensor):
    """Mean, variance and clipped log-variance of q(x_{t-1} | x_t, x_0)."""
    mean = (_gather(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
            + _gather(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)
    variance = _gather(sched.posterior_variance, t, x_t.ndim)
    log_variance = _gather(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, variance, log_variance


def predict_xstart_from_eps(sched: Schedule, x_t: torch.Tensor,
                            t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return (_gather(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - _gather(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps)


def predict_eps_from_xstart(sched: Schedule, x_t: torch.Tensor,
                            t: torch.Tensor,
                            x_start: torch.Tensor) -> torch.Tensor:
    return ((_gather(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
             - x_start)
            / _gather(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))


def p_mean_variance(sched: Schedule, model_fn: ModelFn, x: torch.Tensor,
                    t: torch.Tensor, denoise_fn: Optional[DenoiseFn] = None,
                    cond_fn: Optional[DenoiseFn] = None) -> dict:
    """Model mean/variance of p(x_{t-1} | x_t) with epsilon prediction and
    FIXED_SMALL variance.  ``denoise_fn`` is applied to the predicted x0
    (seed-pose blending); ``raw_x_start`` keeps the prediction before it."""
    eps = model_fn(x, t)
    if cond_fn is not None:
        eps = cond_fn(eps)
    pred_x_start = predict_xstart_from_eps(sched, x, t, eps)
    raw_x_start = pred_x_start
    if denoise_fn is not None:
        pred_x_start = denoise_fn(pred_x_start)
    mean, variance, log_variance = q_posterior_mean_variance(
        sched, pred_x_start, x, t)
    return {
        "mean": mean,
        "variance": variance,
        "log_variance": log_variance,
        "eps": eps,
        "pred_x_start": pred_x_start,
        "raw_x_start": raw_x_start,
    }


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def training_losses(sched: Schedule, model_fn: ModelFn, x_start: torch.Tensor,
                    t: torch.Tensor, noise: torch.Tensor) -> dict:
    """Epsilon-MSE diffusion loss plus the tensors the auxiliary losses
    read: per-example ``mse`` (N,), ``eps``, ``x_t``, ``pred_x_start`` and
    the posterior ``model_mean``."""
    x_t = q_sample(sched, x_start, t, noise)
    eps = model_fn(x_t, t)
    mse = mean_flat((eps - noise) ** 2)
    pred_x_start = predict_xstart_from_eps(sched, x_t, t, eps)
    model_mean, _, _ = q_posterior_mean_variance(sched, pred_x_start, x_t, t)
    return {
        "mse": mse,
        "eps": eps,
        "x_t": x_t,
        "pred_x_start": pred_x_start,
        "model_mean": model_mean,
    }
