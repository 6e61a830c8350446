"""Gaussian diffusion coefficient tables and the eps <-> x0 conversions.

Port of ``gesture_diffusion_tpu/diffusion/gaussian.py``: every table is
computed on the host in float64 and stored as float32 tensors (CPU by
default; ``Schedule.to`` moves it).  Layout is batch-first (N, T, C).
Variance type is FIXED_SMALL with epsilon prediction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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
