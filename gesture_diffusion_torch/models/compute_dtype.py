"""Layers that compute in a dtype of their own: flax's ``dtype=``.

A flax ``nn.Dense(dtype=bf16)`` casts its input, kernel and bias to bf16
and returns bf16; ``nn.Conv`` does the same; ``nn.LayerNorm(dtype=bf16)``
takes its statistics in float32 and returns bf16.  The parameters stay in
their own dtype (float32), and so do their gradients and the optimizer.
These subclasses keep the torch modules' names and state dicts and take a
``compute_dtype``; ``None`` is the torch module unchanged.
``torch.autocast`` is not used for the whole model: its op policy returns
``layer_norm`` in float32 where flax returns ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def as_torch_dtype(name: "str | torch.dtype | None") -> Optional[torch.dtype]:
    """``"bfloat16"`` (a config's spelling) -> ``torch.bfloat16``."""
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, name)


def _cast_params(module: nn.Module, dtype: torch.dtype):
    bias = None if module.bias is None else module.bias.to(dtype)
    return module.weight.to(dtype), bias


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), *_cast_params(self, dt))


class Conv1d(nn.Conv1d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), *_cast_params(self, dt))


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), *_cast_params(self, dt))


class LayerNorm(nn.LayerNorm):
    """Statistics and the affine map in float32 at least, the output in
    ``compute_dtype``."""

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(normalized_shape, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.layer_norm(x, self.normalized_shape, *_cast_params(self, x.dtype),
                            self.eps).to(dt)
