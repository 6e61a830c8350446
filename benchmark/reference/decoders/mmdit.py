"""The MMDiT decoder: Stable Diffusion 3 Medium's joint-stream transformer
(Esser et al., arXiv:2403.03206; published configuration
huggingface.co/stabilityai/stable-diffusion-3-medium-diffusers,
``transformer/config.json``: 24 blocks, 24 heads of 64, hidden 1536,
feed-forward 4x with tanh-GELU, no QK-norm), written from the paper and
diffusers' ``JointTransformerBlock`` in plain float32 torch.

The memory the denoiser hands a decoder is [step token ; speech memory]:
row 0 is the conditioning vector c, rows 1 and on the context stream.
With c' = SiLU(c), norm = LayerNorm without an affine (eps 1e-6) and
mod(z, a, b) = norm(z) (1 + b) + a, block i computes

    sa, ba, ga, sm, bm, gm = chunk6(norm1.linear(c'))        # AdaLayerNormZero
    (the context's six from norm1_context.linear(c'))
    q = [to_q(mod(x, sa, ba)) ; add_q_proj(mod(ctx, ...))], k and v alike
    o = softmax(q k^T / sqrt(64)) v per head, split back into o_x, o_ctx
    x   = x + ga * to_out.0(o_x)
    x   = x + gm * ff(mod(x, sm, bm))        ff = net.2(gelu_tanh(net.0.proj))
    ctx = ctx + ga' * to_add_out(o_ctx)
    ctx = ctx + gm' * ff_context(mod(ctx, sm', bm'))

The last block is ``context_pre_only``: its context gets
mod(ctx, shift, scale) with scale, shift = chunk2(norm1_context.linear(c'))
(``AdaLayerNormContinuous``: scale first), gives only q, k and v, and has
no ``to_add_out`` and no ``ff_context``.  The output is
proj_out(mod(x, shift, scale)) with scale, shift = chunk2(norm_out.linear(c')).

Departures from SD3, all at the edges: the pose frames enter through a
Linear (``pos_embed.proj``, d_pose -> d_model) in place of the 2x2 patch
conv; positions are 1-D sin-cos over frames (DiT's
``get_1d_sincos_pos_embed_from_grid``, sin half first, float64 math) in
place of the cropped 2-D table, none on the context;
``context_embedder`` reads the d_model-wide speech memory in place of
T5's 4096 channels; no pooled-text projection, so c is the step
embedding alone (the denoiser's cos-first sinusoid and Linear-SiLU-Linear,
SD3's ``Timesteps(flip_sin_to_cos=True)`` + ``TimestepEmbedding`` with
d_model frequencies in place of 256); DDIM on the system's schedule in
place of rectified flow; ``proj_out`` gives the pose channels.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..model import LN_EPS, RLinear


@functools.lru_cache(maxsize=None)
def positions(n: int, d: int, device) -> torch.Tensor:
    """(n, d): 1-D sin-cos, sin half first, float64 math; made once for
    each size and device."""
    omega = 1.0 / 10000.0 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
    out = np.arange(n, dtype=np.float64)[:, None] * omega[None]
    pe = np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)
    return torch.from_numpy(pe).to(device)


def mod(z, shift, scale):
    return F.layer_norm(z, z.shape[-1:], eps=LN_EPS) * (1.0 + scale[:, None]) \
        + shift[:, None]


class AdaLayerNormZero(nn.Module):
    def __init__(self, d: int, operand):
        super().__init__()
        self.linear = RLinear(d, 6 * d, operand)

    def forward(self, z, silu_c):
        """(mod(z, shift, scale), gate, shift', scale', gate')."""
        shift, scale, gate, shift2, scale2, gate2 = self.linear(silu_c).chunk(6, 1)
        return mod(z, shift, scale), gate, shift2, scale2, gate2


class AdaLayerNormContinuous(nn.Module):
    def __init__(self, d: int, operand):
        super().__init__()
        self.linear = RLinear(d, 2 * d, operand)

    def forward(self, z, silu_c):
        scale, shift = self.linear(silu_c).chunk(2, 1)
        return mod(z, shift, scale)


class Proj(nn.Module):
    def __init__(self, d_in: int, d_out: int, operand):
        super().__init__()
        self.proj = RLinear(d_in, d_out, operand)


class FeedForward(nn.Module):
    def __init__(self, d: int, operand):
        super().__init__()
        self.net = nn.ModuleList([Proj(d, 4 * d, operand), nn.Identity(),
                                  RLinear(4 * d, d, operand)])

    def forward(self, z):
        return self.net[2](F.gelu(self.net[0].proj(z), approximate="tanh"))


class Attention(nn.Module):
    def __init__(self, d: int, heads: int, operand, pre_only: bool):
        super().__init__()
        self.heads, self.operand = heads, operand
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj"):
            setattr(self, name, RLinear(d, d, operand))
        self.to_out = nn.ModuleList([RLinear(d, d, operand)])
        if not pre_only:
            self.to_add_out = RLinear(d, d, operand)

    def forward(self, zx, zc):
        r, h = self.operand.fn, self.heads
        n, t_x, d = zx.shape

        def split(a, b):
            return torch.cat([a, b], dim=1).view(n, -1, h, d // h)

        q = split(self.to_q(zx), self.add_q_proj(zc))
        k = split(self.to_k(zx), self.add_k_proj(zc))
        v = split(self.to_v(zx), self.add_v_proj(zc))
        s = torch.einsum("nihd,njhd->nijh", r(q), r(k)) / math.sqrt(d // h)
        p = torch.softmax(s, dim=2)
        o = torch.einsum("nijh,njhd->nihd", r(p), r(v)).reshape(n, -1, d)
        return o[:, :t_x], o[:, t_x:]


class Block(nn.Module):
    def __init__(self, d: int, heads: int, operand, pre_only: bool):
        super().__init__()
        self.pre_only = pre_only
        self.norm1 = AdaLayerNormZero(d, operand)
        self.norm1_context = (AdaLayerNormContinuous(d, operand) if pre_only
                              else AdaLayerNormZero(d, operand))
        self.attn = Attention(d, heads, operand, pre_only)
        self.ff = FeedForward(d, operand)
        if not pre_only:
            self.ff_context = FeedForward(d, operand)

    def forward(self, x, ctx, silu_c):
        zx, gate, shift2, scale2, gate2 = self.norm1(x, silu_c)
        if self.pre_only:
            zc = self.norm1_context(ctx, silu_c)
        else:
            zc, cgate, cshift2, cscale2, cgate2 = self.norm1_context(ctx, silu_c)
        ox, oc = self.attn(zx, zc)
        x = x + gate[:, None] * self.attn.to_out[0](ox)
        x = x + gate2[:, None] * self.ff(mod(x, shift2, scale2))
        if self.pre_only:
            return x, None
        ctx = ctx + cgate[:, None] * self.attn.to_add_out(oc)
        ctx = ctx + cgate2[:, None] * self.ff_context(mod(ctx, cshift2, cscale2))
        return x, ctx


class Decoder(nn.Module):
    def __init__(self, cfg: dict, d_pose: int, d: int, operand):
        super().__init__()
        heads, n_layers = cfg["heads"], cfg["n_layers"]
        self.pos_embed = Proj(d_pose, d, operand)
        self.context_embedder = RLinear(d, d, operand)
        self.transformer_blocks = nn.ModuleList(
            Block(d, heads, operand, i == n_layers - 1) for i in range(n_layers))
        self.norm_out = AdaLayerNormContinuous(d, operand)
        self.proj_out = RLinear(d, d_pose, operand)

    def forward(self, x, memory):
        silu_c = F.silu(memory[:, 0])
        x = self.pos_embed.proj(x)
        x = x + positions(x.shape[1], x.shape[2], x.device)
        ctx = self.context_embedder(memory[:, 1:])
        for block in self.transformer_blocks:
            x, ctx = block(x, ctx, silu_c)
        return self.proj_out(self.norm_out(x, silu_c))
