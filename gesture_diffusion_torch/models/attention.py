"""Primer-EZ transformer primitives, batch-first (N, T, C).

Port of ``gesture_diffusion_tpu/models/attention.py``: the squared-ReLU
feed-forward, the kernel-3 depthwise temporal conv on Q/K/V whose taps are
shared across heads (with the JAX package's custom gradient, as an
``autograd.Function``), and the sinusoidal positional encoding.  Dropout
sits where the JAX modules have it (after the positional encoding, on the
attention probabilities, on the FF hidden layer) and is the identity in
``eval()``.  Module and parameter names follow the reference checkpoint
(``query.0.linear``, ``query.1.conv``, ``feed_forward.layer1``, ...).
``dtype`` is flax's compute dtype (``models/compute_dtype.py``): the
projections run in it, the scores in float32, and the probabilities times
the values accumulate in float32 before the cast to it, as the JAX module
computes them.  Under tensor parallelism (``parallel/tp.py``) the
projections are swapped for column- and row-parallel ones, a rank holds
``heads / n_model`` heads (``PrepareForMultiHeadAttention.heads``), and
the depthwise conv, whose taps every head shares, stays whole on every
rank: its gradient is summed over the model group (``model_group``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .compute_dtype import Linear


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = F.relu(x)
    return r * r


def sinusoidal_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) in fp64 math; sin on even, cos on odd channels."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    two_i = np.arange(0, d_model, 2, dtype=np.float64)
    div = np.exp(two_i * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)[:, : d_model // 2]  # odd d_model safe
    return pe


class PositionalEncoding(nn.Module):
    def __init__(self, d_model: int, dropout: float = 0.0, max_len: int = 5000):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_position_encoding(max_len, d_model)),
            persistent=False)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.pe[: x.shape[1]].to(x.dtype))


def _shift_prev(x: torch.Tensor) -> torch.Tensor:
    """x[t-1] along axis 1, zero at t = 0."""
    return F.pad(x[:, :-1], (0, 0, 0, 0, 1, 0))


def _shift_next(x: torch.Tensor) -> torch.Tensor:
    """x[t+1] along axis 1, zero at the last t."""
    return F.pad(x[:, 1:], (0, 0, 0, 0, 0, 1))


class _DepthwiseConv3(torch.autograd.Function):
    """Saves only x and w; the shifted copies are recomputed in backward,
    as the JAX package's ``_dwc3_bwd`` does."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _shift_prev(x) * w[0] + x * w[1] + _shift_next(x) * w[2] + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # dL/dx[t] = g[t+1]*w0 + g[t]*w1 + g[t-1]*w2
            dx = _shift_next(g) * w[0] + g * w[1] + _shift_prev(g) * w[2]
        if ctx.needs_input_grad[1]:
            dw = torch.stack([(g * _shift_prev(x)).sum((0, 1, 2)),
                              (g * x).sum((0, 1, 2)),
                              (g * _shift_next(x)).sum((0, 1, 2))]).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2))
        return dx, dw, db


def depthwise_conv3(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """y[t] = w0*x[t-1] + w1*x[t] + w2*x[t+1] + b over axis 1 of
    (N, T, H, Dk); w (3, Dk) shared across heads, b (Dk,)."""
    return _DepthwiseConv3.apply(x, w, b)


class PrepareForMultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, heads: int, d_k: int, bias: bool = True,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        self.heads, self.d_k = heads, d_k
        self.linear = Linear(d_model, heads * d_k, bias=bias, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.linear(x)
        return y.view(*y.shape[:-1], self.heads, self.d_k)


class SpatialDepthWiseConv(nn.Module):
    """Kernel-3 depthwise conv over time on (N, T, H, Dk), weights shared
    across heads; stored as the reference's grouped Conv1d (d_k, 1, 3)."""

    def __init__(self, d_k: int):
        super().__init__()
        self.conv = nn.Conv1d(d_k, d_k, 3, padding=1, groups=d_k)
        # tensor parallelism over heads: the group whose ranks hold the
        # other heads, over which the taps' gradient is summed
        self.model_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.conv.weight, self.conv.bias
        if self.model_group is not None:
            from ..parallel.tp import copy_to_model

            weight = copy_to_model(weight, self.model_group)
            bias = copy_to_model(bias, self.model_group)
        w = weight[:, 0, :].t().to(x.dtype)      # (3, d_k)
        return depthwise_conv3(x, w, bias.to(x.dtype))


class MultiHeadAttention(nn.Module):
    """Softmax attention with the Primer depthwise conv on Q/K/V; scores
    in fp32, masked entries at finfo(float32).min, dropout on the
    probabilities."""

    def __init__(self, heads: int, d_model: int, dropout: float = 0.0,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        assert d_model % heads == 0
        self.heads = heads
        self.d_k = d_model // heads
        self.dtype = dtype

        def proj():
            return nn.Sequential(
                PrepareForMultiHeadAttention(d_model, heads, self.d_k,
                                             dtype=dtype),
                SpatialDepthWiseConv(self.d_k))

        self.query, self.key, self.value = proj(), proj(), proj()
        self.output = Linear(d_model, d_model, compute_dtype=dtype)
        self.dropout = nn.Dropout(dropout)

    def forward(self, query, key, value, mask=None) -> torch.Tensor:
        q, k, v = self.query(query), self.key(key), self.value(value)
        scale = 1.0 / math.sqrt(self.d_k)
        scores = torch.einsum("nihd,njhd->nijh", q.float(), k.float()) * scale
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
        attn = self.dropout(torch.softmax(scores, dim=2))
        if self.dtype is None:
            out = torch.einsum("nijh,njhd->nihd", attn.to(v.dtype), v)
        else:
            # flax: operands in dtype, accumulated in float32, cast back
            out = torch.einsum("nijh,njhd->nihd", attn.to(self.dtype).float(),
                               v.float()).to(self.dtype)
        return self.output(out.reshape(*out.shape[:-2], -1))


class FeedForward(nn.Module):
    """d -> 4d -> d with squared ReLU, dropout on the hidden layer."""

    def __init__(self, d_model: int, expansion: int = 4, dropout: float = 0.0,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        self.layer1 = Linear(d_model, expansion * d_model, compute_dtype=dtype)
        self.layer2 = Linear(expansion * d_model, d_model, compute_dtype=dtype)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer2(self.dropout(squared_relu(self.layer1(x))))
