"""The MMDiT decoder: Stable Diffusion 3 Medium's joint-stream transformer
(Esser et al., "Scaling Rectified Flow Transformers for High-Resolution
Image Synthesis", arXiv:2403.03206; diffusers' ``SD3Transformer2DModel``
and ``JointTransformerBlock``) as a pose denoiser, batch-first.

Two streams with weights of their own run through every block: the
sample (the pose frames, x) and the context (the speech memory).  The
decoder reads the memory that ``GestureDenoiser.denoise`` hands every
decoder, ``[step token ; speech memory]``, as the conditioning vector
``c`` (row 0, the step embedding) and the context (rows 1 and on).

Block i (c' = SiLU(c), computed once a step; norm = LayerNorm without an
affine, eps 1e-6; mod(z, a, b) = norm(z) (1 + b) + a):

    shift, scale, gate, shift', scale', gate' = chunk6(norm1.linear(c'))
    (and the context's from norm1_context.linear(c'))
    q, k, v = to_q/k/v(mod(x, shift, scale)) ; add_q/k/v_proj(mod(ctx, ...))
    o = softmax(q k^T / sqrt(dk)) v over [x ; ctx], split back
    x   = x + gate * to_out.0(o_x)
    x   = x + gate' * ff(mod(x, shift', scale'))
    ctx = the same with to_add_out, ff_context and the context's chunks

``ff`` is Linear (4x) -> tanh-GELU -> Linear.  The last block is
``context_pre_only``: its context stream gets only q, k and v, from an
``AdaLayerNormContinuous`` (scale first, then shift, from a Linear to 2
chunks); it has no ``to_add_out`` and no context MLP.  The output is
``proj_out(norm_out(x))``, ``norm_out`` being an
``AdaLayerNormContinuous`` too.

Departures from SD3, at the input and output edges only: pose frames come
in through a Linear (``pos_embed.proj``) in place of the 2x2 patch conv;
positions are 1-D sin-cos over frames (DiT's
``get_1d_sincos_pos_embed_from_grid``, sin half first), none on the
context; ``context_embedder`` reads the d_model-wide speech memory in
place of T5's 4096 channels; there is no pooled-text projection, so c is
the step embedding alone; ``proj_out`` gives the pose channels.

Module names are diffusers'.  Every parameter is a ``Linear``: the norms
are ``F.layer_norm`` calls and the positional table a non-persistent
buffer, so the state dict holds weights and biases alone.  ``dtype`` is
the compute dtype of every projection (``models/compute_dtype.py``); the
norms take their statistics in float32 at least.  In float32 (``dtype``
None or float32) the blocks' Linears, ``context_embedder`` and
``norm_out.linear`` are ``ops/f32_linear.py::F32x3Linear``s, float32
products on the tensor cores as three TF32 products (each stream's q, k
and v as one launch, ``F32x3Group``); ``pos_embed.proj`` and
``proj_out`` (the 126 pose channels in and out, 0.3% of the products;
pos_embed's input rows are 504 bytes, not the 16-byte multiple TMA
reads) stay ``F.linear``.  Spans (``mmdit/block``
around each block; inside it ``mmdit/modulation``,
``mmdit/joint_attention`` and ``mmdit/feed_forward``) land under the
scan sampler's ``sampler/step``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.f32_linear import F32x3Group, F32x3Linear
from ..utils.profiling import span
from .compute_dtype import Linear

LN_EPS = 1e-6
#: frames the positional table holds (the port's other tables hold as many)
MAX_FRAMES = 5000


def sincos_1d(n: int, d: int) -> torch.Tensor:
    """(n, d) float32 1-D sin-cos positions, sin half first, float64 math
    (DiT's ``get_1d_sincos_pos_embed_from_grid``)."""
    omega = 1.0 / 10000.0 ** (torch.arange(d // 2, dtype=torch.float64)
                              / (d / 2.0))
    out = torch.arange(n, dtype=torch.float64)[:, None] * omega[None]
    return torch.cat([out.sin(), out.cos()], dim=1).float()


def block_linear(d_in: int, d_out: int, dtype: Optional[torch.dtype]):
    """A Linear of the blocks: the split-TF32 product in float32, else the
    compute-dtype ``Linear``."""
    if dtype in (None, torch.float32):
        return F32x3Linear(d_in, d_out)
    return Linear(d_in, d_out, compute_dtype=dtype)


def norm(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """LayerNorm without an affine over the last axis, statistics in
    float32 at least, the result in ``dtype`` (x's own when None)."""
    y = F.layer_norm(x.to(torch.promote_types(x.dtype, torch.float32)),
                     x.shape[-1:], eps=LN_EPS)
    return y.to(dtype or x.dtype)


def modulate(x, shift, scale, dtype):
    """norm(x) (1 + scale) + shift, the chunks broadcast over time."""
    return torch.addcmul(shift[:, None], norm(x, dtype), 1.0 + scale[:, None])


class AdaLayerNormZero(nn.Module):
    """``Linear(c')`` -> 6 chunks: shift, scale, gate for the attention,
    then shift, scale, gate for the MLP."""

    def __init__(self, d: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.linear = block_linear(d, 6 * d, dtype)

    def forward(self, x, silu_c):
        shift, scale, gate, shift2, scale2, gate2 = self.linear(
            silu_c).chunk(6, dim=1)
        return modulate(x, shift, scale, self.dtype), (gate, shift2, scale2,
                                                       gate2)


class AdaLayerNormContinuous(nn.Module):
    """``Linear(c')`` -> 2 chunks: scale first, then shift."""

    def __init__(self, d: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.linear = block_linear(d, 2 * d, dtype)

    def forward(self, x, silu_c):
        scale, shift = self.linear(silu_c).chunk(2, dim=1)
        return modulate(x, shift, scale, self.dtype)


class GELUProj(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype=None):
        super().__init__()
        self.proj = block_linear(d_in, d_out, dtype)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """``net.0.proj`` (4x), tanh-GELU, dropout, ``net.2``."""

    def __init__(self, d: int, dropout: float = 0.0, dtype=None):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(d, 4 * d, dtype), nn.Dropout(dropout),
                                  block_linear(4 * d, d, dtype)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class JointAttention(nn.Module):
    """One attention over [x ; ctx], each stream with its own q, k, v and
    output projections; ``to_add_out`` only where the context goes on."""

    def __init__(self, d: int, heads: int, context_pre_only: bool,
                 dropout: float = 0.0, dtype=None):
        super().__init__()
        self.heads, self.dropout = heads, dropout
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj"):
            setattr(self, name, block_linear(d, d, dtype))
        self.to_out = nn.ModuleList([block_linear(d, d, dtype)])
        self.to_add_out = (None if context_pre_only
                           else block_linear(d, d, dtype))
        # in float32 each stream's q, k and v are one launch
        self.qkv = self.add_qkv = None
        if isinstance(self.to_q, F32x3Linear):
            self.qkv = F32x3Group(self.to_q, self.to_k, self.to_v)
            self.add_qkv = F32x3Group(self.add_q_proj, self.add_k_proj,
                                      self.add_v_proj)

    def _qkv(self, x, ctx):
        if self.qkv is not None:
            return self.qkv(x).chunk(3, dim=-1), self.add_qkv(ctx).chunk(3, dim=-1)
        return ((self.to_q(x), self.to_k(x), self.to_v(x)),
                (self.add_q_proj(ctx), self.add_k_proj(ctx), self.add_v_proj(ctx)))

    def forward(self, x, ctx):
        n, t_x, d = x.shape
        h = self.heads

        def heads(a, b):
            return torch.cat([a, b], dim=1).view(n, -1, h, d // h).transpose(1, 2)

        (qx, kx, vx), (qc, kc, vc) = self._qkv(x, ctx)
        q, k, v = heads(qx, qc), heads(kx, kc), heads(vx, vc)
        o = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.dropout if self.training else 0.0)
        o = o.transpose(1, 2).reshape(n, -1, d)
        out_x = self.to_out[0](o[:, :t_x])
        out_ctx = None if self.to_add_out is None else self.to_add_out(o[:, t_x:])
        return out_x, out_ctx


class JointTransformerBlock(nn.Module):
    def __init__(self, d: int, heads: int, context_pre_only: bool,
                 dropout: float = 0.0, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLayerNormZero(d, dtype)
        self.norm1_context = (AdaLayerNormContinuous(d, dtype)
                              if context_pre_only else AdaLayerNormZero(d, dtype))
        self.attn = JointAttention(d, heads, context_pre_only, dropout, dtype)
        self.ff = FeedForward(d, dropout, dtype)
        self.ff_context = (None if context_pre_only
                           else FeedForward(d, dropout, dtype))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, ctx, silu_c):
        """(x, ctx) after the block; ctx is None after the last one."""
        dt = self.dtype
        with span("mmdit/block"):
            with span("mmdit/modulation"):
                zx, (gate, shift2, scale2, gate2) = self.norm1(x, silu_c)
                if self.context_pre_only:
                    zc = self.norm1_context(ctx, silu_c)
                else:
                    zc, (cgate, cshift2, cscale2, cgate2) = self.norm1_context(
                        ctx, silu_c)
            with span("mmdit/joint_attention"):
                ax, actx = self.attn(zx, zc)
            with span("mmdit/feed_forward"):
                x = torch.addcmul(x, gate[:, None], self.dropout(ax))
                x = torch.addcmul(x, gate2[:, None], self.dropout(
                    self.ff(modulate(x, shift2, scale2, dt))))
                if self.context_pre_only:
                    return x, None
                ctx = torch.addcmul(ctx, cgate[:, None], self.dropout(actx))
                ctx = torch.addcmul(ctx, cgate2[:, None], self.dropout(
                    self.ff_context(modulate(ctx, cshift2, cscale2, dt))))
        return x, ctx


class MMDiT(nn.Module):
    """``forward(x, memory)``: (N, T, d_x) poses and (N, 1 + M, d_memory)
    [step token ; speech memory] -> (N, T, d_out)."""

    def __init__(self, d_x: int, d_memory: int, d_model: int, heads: int,
                 n_layers: int, d_out: int, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if d_model % heads:
            raise ValueError(f"d_model {d_model} is not a multiple of {heads} "
                             "heads")
        self.pos_embed = nn.Module()
        self.pos_embed.proj = Linear(d_x, d_model, compute_dtype=dtype)
        self.register_buffer("pos_table", sincos_1d(MAX_FRAMES, d_model),
                             persistent=False)
        self.context_embedder = block_linear(d_memory, d_model, dtype)
        self.transformer_blocks = nn.ModuleList(
            JointTransformerBlock(d_model, heads, i == n_layers - 1, dropout,
                                  dtype)
            for i in range(n_layers))
        self.norm_out = AdaLayerNormContinuous(d_model, dtype)
        self.proj_out = Linear(d_model, d_out, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        silu_c = F.silu(memory[:, 0])
        x = self.pos_embed.proj(x)
        x = x + self.pos_table[:x.shape[1]].to(x.dtype)
        ctx = self.context_embedder(memory[:, 1:])
        for block in self.transformer_blocks:
            x, ctx = block(x, ctx, silu_c)
        return self.proj_out(self.norm_out(x, silu_c))
