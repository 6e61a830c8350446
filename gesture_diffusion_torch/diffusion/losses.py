"""Gaussian likelihood helpers for the variational bound (bpd).

Port of ``gesture_diffusion_tpu/diffusion/losses.py``: the
continuous-variable NLL, not the discretised image variant.
"""

from __future__ import annotations

import math

import torch


def _tensor(x, like: torch.Tensor) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(
        x, dtype=like.dtype, device=like.device)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL( N(mean1, e^logvar1) || N(mean2, e^logvar2) ), elementwise.  Any
    argument may be a scalar, as long as one is a tensor."""
    like = next(v for v in (mean1, logvar1, mean2, logvar2) if torch.is_tensor(v))
    mean1, logvar1, mean2, logvar2 = (_tensor(v, like) for v in
                                      (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def log_standard_normal_pdf(x: torch.Tensor) -> torch.Tensor:
    return -(x ** 2) / 2.0 - 0.5 * math.log(2.0 * math.pi)


def continuous_gaussian_log_likelihood(x, *, means, log_scales):
    """log-density of the standardised residual (x - means) e^{-log_scales}
    under N(0, 1), elementwise, in nats.  Like the reference it leaves out
    the -log_scales Jacobian term; kept for metric parity."""
    centered = (x - means) * torch.exp(-log_scales)
    return log_standard_normal_pdf(centered)
