"""Loss assembly, the gradient tail of a train step, and its optimizer.

Port of ``gesture_diffusion_tpu/training/train_state.py``: the diffusion
epsilon-MSE plus the optional speed losses (a 1-D Gaussian W2 between the
mean |delta pose| curves, its smooth-L1 form, and a speed constraint),
importance weights on the denoise term, and norm-then-value gradient
clipping with the JAX package's 1e-12, not ``clip_grad_norm_``'s 1e-6,
and AdamW with optax's settings under the config's learning-rate schedule.
(N, T, C) layout.  There is no train-state pytree: the model, its
BatchNorm buffers and the optimizer hold the state.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..diffusion.gaussian import ModelFn, Schedule, training_losses
from ..parallel.mesh import active_group, all_reduce_sum
from .lr_schedule import build_lr_schedule


def wasserstein_distance_1d(xs: torch.Tensor, ys: torch.Tensor,
                            eps: float = 1e-12) -> torch.Tensor:
    """W2 between Gaussian fits of two 1-D samples."""
    var1, mu1 = torch.var_mean(xs, unbiased=False)
    var2, mu2 = torch.var_mean(ys, unbiased=False)
    dist_quad = (mu1 - mu2) ** 2 + (var1 + var2 - 2.0 * torch.sqrt(var1 * var2))
    return torch.sqrt(torch.clamp(dist_quad, min=eps))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def _speeds(x_start: torch.Tensor, pred: torch.Tensor):
    """The (T-1,) mean |x[t+1] - x[t]| over batch and channels of the clean
    poses and of the prediction.  Under a process group the mean is over
    the global batch, as the JAX package's batch-sharded step takes it:
    the per-frame sums are all-reduced with their gradient (each rank
    holds as many rows), so the nonlinear terms built on the curves are
    the global ones."""
    group = active_group()
    if group is None:
        return tuple(torch.diff(x, dim=1).abs().mean(dim=(0, 2))
                     for x in (x_start, pred))
    d = torch.stack([torch.diff(x_start, dim=1).abs(),
                     torch.diff(pred, dim=1).abs()])
    count = d.shape[1] * d.shape[3] * group[1]
    return (all_reduce_sum(d.sum(dim=(1, 3))) / count).unbind(0)


def assemble_losses(
    sched: Schedule,
    model_fn: ModelFn,
    x_start: torch.Tensor,                 # (N, T, C)
    t: torch.Tensor,                       # (N,)
    noise: torch.Tensor,
    loss_params: Optional[Dict[str, float]] = None,
    weights: Optional[torch.Tensor] = None,
    with_per_example: bool = False,
) -> Dict[str, torch.Tensor]:
    """Total loss and its terms, under the JAX package's keys.

    :param weights: (N,) importance weights of the denoise term (the
        loss-aware schedule sampler); the speed terms are batch statistics
        (of the global batch under a process group, ``_speeds``) and stay
        unweighted.
    :param with_per_example: add the unweighted (N,) mse under
        ``"mse_per_example"`` for the sampler's history."""
    returns = training_losses(sched, model_fn, x_start, t, noise)
    mse = returns["mse"]
    denoise = (mse * weights).mean() if weights is not None else mse.mean()
    losses = {"loss": denoise, "denoise": denoise}
    if with_per_example:
        losses["mse_per_example"] = mse

    pred_x_start = returns["pred_x_start"]
    loss_params = loss_params or {}
    if {"speed_loss", "speed_l1_loss"} & set(loss_params):
        speed, speed_pred = _speeds(x_start, pred_x_start)
    for name, weight in loss_params.items():
        if name == "speed_loss":
            term = wasserstein_distance_1d(speed, speed_pred)
            losses["speed"] = term
        elif name == "speed_l1_loss":
            term = smooth_l1(speed_pred, speed)
            losses["speed_l1"] = term
        elif name == "speed_constraint_loss":
            term = torch.diff(pred_x_start, dim=1).abs().mean()
            losses["speed_constraint"] = term
        else:
            raise ValueError(f"Unsupported loss: {name}")
        losses["loss"] = losses["loss"] + weight * term
    return losses


def global_norm(grads: Sequence[torch.Tensor],
                sharded: Sequence[torch.Tensor] = (), group=None) -> torch.Tensor:
    """The 2-norm of all gradients together (one device scalar).  Under
    tensor parallelism ``grads`` are the whole (replicated) ones and
    ``sharded`` this rank's slices of the split ones, whose squares are
    summed over the model ``group``: each element counts once."""
    norms = torch._foreach_norm(list(grads))
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(norms))
    import torch.distributed as dist

    part = torch.stack(torch._foreach_norm(list(sharded))).square().sum()
    dist.all_reduce(part, group=group)
    return torch.sqrt(torch.stack(norms).square().sum() + part)


@torch.no_grad()
def clip_gradients(grads: Sequence[torch.Tensor], grad_norm: torch.Tensor,
                   grad_norm_clip_value: Optional[float],
                   grad_clip_value: Optional[float]) -> None:
    """In place: scale by min(1, c / (norm + 1e-12)) with ``grad_norm``
    the norm before clipping, then clip each element to +-value."""
    if grad_norm_clip_value is not None:
        scale = torch.clamp(grad_norm_clip_value / (grad_norm + 1e-12), max=1.0)
        torch._foreach_mul_(list(grads), scale)
    if grad_clip_value is not None:
        for g in grads:
            g.clamp_(-grad_clip_value, grad_clip_value)


def make_adamw(params, lr: float, weight_decay: float) -> torch.optim.AdamW:
    """``optax.adamw``'s settings spelled out, since torch's defaults differ
    (its weight_decay is 0.01): b1 0.9, b2 0.999, eps 1e-8 added to
    sqrt(v_hat), decoupled decay scaled by the learning rate, on every
    parameter.  ``fused``: one multi-tensor kernel per step; the per-list
    path spends about 10 ms of host time a step on this model's 360
    tensors (torch.profiler on an H100, PERF.md)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay, amsgrad=False,
                             fused=True)


def make_optimizer(model: nn.Module, train_params=None
                   ) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """AdamW over ``model``'s parameters and the learning-rate schedule of
    the config's ``Train`` block (lr 1e-2 and no decay without one, as the
    JAX package's ``build_all``).  The train step sets the learning rate
    from the schedule before every update.
    :return: (optimizer, lr_schedule)"""
    train_params = train_params or {}
    lr_schedule = build_lr_schedule(train_params.get("Scheduler"),
                                    train_params.get("lr", 1e-2))
    optimizer = make_adamw(model.parameters(), lr_schedule(0),
                           float(train_params.get("weight_decay") or 0.0))
    return optimizer, lr_schedule
