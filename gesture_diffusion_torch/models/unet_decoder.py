"""1-D GLIDE-style UNet decoder with audio cross-attention.

Port of ``gesture_diffusion_tpu/models/unet_decoder.py``.  The UNet runs
in torch's (N, C, T) layout inside and takes and returns (N, T, C):

  * ``ResBlock``: GroupNorm(32, eps 1e-5, statistics in float32 at
    least) + SiLU + conv, FiLM scale and shift from the step embedding,
    zero-initialised output conv (JAX's ``ResBlock1D``; with its other
    options, GLIDE's ResBlock);
  * ``UNetAttentionBlock``: self-attention over time with the audio
    stream's keys and values prepended (GLIDE's text-conditioning
    pattern); the fused QKV projection is split head-major, (heads,
    3 * d_k) per frame, and q and k are each scaled by d_k^-1/4;
  * ``UNet``: input, middle and output blocks with skip concatenation,
    downsampling by a stride-2 conv (padding 1), upsampling by a
    nearest-neighbour resize and a conv (JAX's ``UNet1D`` at ``dims=1``;
    its other options, 2-D signals, conv-free resampling, resampling
    ResBlocks and head widths, are GLIDE's, for
    ``models/glide_unet.py``);
  * ``UNetAttn``: memory[:, 0] is the diffusion-step token (through the
    time-embedding MLP), memory[:, 1:] the audio stream; the window is
    zero-padded symmetrically so that T keeps halving (``_pad_lengths``)
    and cropped after the UNet.

Module names are the reference checkpoint's (GLIDE's ``input_blocks``,
``middle_block``, ``output_blocks``, ``out``, ``time_embed``; a ResBlock's
``in_layers`` / ``emb_layers`` / ``out_layers`` / ``skip_connection``;
1x1 ``Conv1d`` projections ``qkv``, ``encoder_kv``, ``proj_out``).
``dtype`` is the compute dtype of every conv, projection and GroupNorm
output (``models/compute_dtype.py``), None for the parameters' own.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .compute_dtype import Conv1d, Conv2d, Linear

GN_GROUPS, GN_EPS = 32, 1e-5


class GroupNorm32(nn.GroupNorm):
    """GLIDE's ``GroupNorm32``: statistics in float32 at least (a bf16 or
    fp16 input is normalised in float32, as flax computes it), the output
    in ``compute_dtype``, else in the input's dtype."""

    def __init__(self, *args, compute_dtype: "torch.dtype | None" = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(
            x.to(torch.promote_types(x.dtype, torch.float32))).to(
                self.compute_dtype or x.dtype)


def group_norm(channels: int, dtype: "torch.dtype | None" = None) -> nn.GroupNorm:
    return GroupNorm32(GN_GROUPS, channels, eps=GN_EPS, compute_dtype=dtype)


def conv_nd(dims: int, *args, **kwargs) -> nn.Module:
    """A 1-D or 2-D conv (``compute_dtype`` as a keyword)."""
    return (Conv1d, Conv2d)[dims - 1](*args, **kwargs)


def zero_(module: nn.Module) -> nn.Module:
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


class TimestepBlock(nn.Module):
    """A block whose forward takes the step embedding: ``forward(x, emb)``."""


class ResBlock(TimestepBlock):
    """GLIDE's ResBlock (``unet.py:96-198``): GroupNorm + SiLU + conv in,
    FiLM (scale-shift norm) or additive step conditioning, zero-initialised
    output conv.  With ``up`` / ``down`` the conv-free resample is applied
    to both the branch (after its norm and SiLU, before its conv) and the
    skip.  The decoder's blocks are ``dims=1, use_scale_shift_norm=True``
    (JAX's ``ResBlock1D``)."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0,
                 out_channels: Optional[int] = None, use_conv: bool = False,
                 use_scale_shift_norm: bool = False, dims: int = 2,
                 up: bool = False, down: bool = False,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        out_channels = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(
            group_norm(channels, dtype), nn.SiLU(),
            conv_nd(dims, channels, out_channels, 3, padding=1,
                    compute_dtype=dtype))
        self.updown = up or down
        if up:
            self.h_upd = Upsample(channels, False, dims)
            self.x_upd = Upsample(channels, False, dims)
        elif down:
            self.h_upd = Downsample(channels, False, dims)
            self.x_upd = Downsample(channels, False, dims)
        else:
            self.h_upd = self.x_upd = nn.Identity()
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, (2 if use_scale_shift_norm else 1)
                              * out_channels, compute_dtype=dtype))
        self.out_layers = nn.Sequential(
            group_norm(out_channels, dtype), nn.SiLU(), nn.Dropout(dropout),
            zero_(conv_nd(dims, out_channels, out_channels, 3, padding=1,
                          compute_dtype=dtype)))
        if out_channels == channels:
            self.skip_connection = nn.Identity()
        elif use_conv:
            self.skip_connection = conv_nd(dims, channels, out_channels, 3,
                                           padding=1, compute_dtype=dtype)
        else:
            self.skip_connection = conv_nd(dims, channels, out_channels, 1,
                                           compute_dtype=dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """x: (N, C, *spatial); emb: (N, emb_channels)."""
        if self.updown:
            h = self.h_upd(self.in_layers[:-1](x))
            x = self.x_upd(x)
            h = self.in_layers[-1](h)
        else:
            h = self.in_layers(x)
        e = self.emb_layers(emb).to(h.dtype)
        e = e.reshape(e.shape + (1,) * (h.dim() - 2))
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = self.out_layers[0](h) * (1 + scale) + shift
            h = self.out_layers[1:](h)
        else:
            h = self.out_layers(h + e)
        return self.skip_connection(x) + h


class UNetAttentionBlock(nn.Module):
    """GLIDE's AttentionBlock (``unet.py:201-278``): self-attention over
    the flattened signal, with the encoder's keys and values prepended
    when the block has ``encoder_channels``; heads by count, or by width
    with ``num_head_channels``."""

    def __init__(self, channels: int, num_heads: int = 1,
                 num_head_channels: int = -1,
                 encoder_channels: Optional[int] = None,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        if num_head_channels != -1:
            if channels % num_head_channels:
                raise ValueError(f"channels {channels} not divisible by head "
                                 f"width {num_head_channels}")
            num_heads = channels // num_head_channels
        self.heads = num_heads
        self.norm = group_norm(channels, dtype)
        self.qkv = Conv1d(channels, 3 * channels, 1, compute_dtype=dtype)
        if encoder_channels is not None:
            self.encoder_kv = Conv1d(encoder_channels, 2 * channels, 1,
                                     compute_dtype=dtype)
        self.proj_out = zero_(Conv1d(channels, channels, 1, compute_dtype=dtype))

    def forward(self, x: torch.Tensor,
                encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, C, *spatial); encoder_out: (N, C_enc, T_enc)."""
        n, c = x.shape[:2]
        h = x.reshape(n, c, -1)
        t = h.shape[2]
        d_k = c // self.heads
        qkv = self.qkv(self.norm(h)).view(n, self.heads, 3 * d_k, t)
        q, k, v = qkv.split(d_k, dim=2)
        if encoder_out is not None:
            ekv = self.encoder_kv(encoder_out)
            ek, ev = ekv.view(n, self.heads, 2 * d_k, -1).split(d_k, dim=2)
            k = torch.cat([ek, k], dim=-1)
            v = torch.cat([ev, v], dim=-1)
        scale = d_k ** -0.25
        scores = torch.einsum("nhdi,nhdj->nhij", q.float() * scale,
                              k.float() * scale)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("nhij,nhdj->nhdi", attn, v).reshape(n, c, t)
        return (h + self.proj_out(out)).reshape(x.shape)


class Downsample(nn.Module):
    """Halves the signal: a stride-2 conv (padding 1), or without
    ``use_conv`` a 2-wide average pool."""

    def __init__(self, channels: int, use_conv: bool = True, dims: int = 1,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        self.op = (conv_nd(dims, channels, channels, 3, stride=2, padding=1,
                           compute_dtype=dtype)
                   if use_conv else (nn.AvgPool1d, nn.AvgPool2d)[dims - 1](2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    """Doubles the signal: a nearest-neighbour resize, then (with
    ``use_conv``) a conv."""

    def __init__(self, channels: int, use_conv: bool = True, dims: int = 1,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        self.conv = (conv_nd(dims, channels, channels, 3, padding=1,
                             compute_dtype=dtype)
                     if use_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return x if self.conv is None else self.conv(x)


class TimestepEmbedSequential(nn.ModuleList):
    """GLIDE's ``TimestepEmbedSequential``: each module gets what it
    takes (the step embedding, the encoder's stream, or neither)."""

    def forward(self, h, emb, encoder_out):
        for layer in self:
            if isinstance(layer, TimestepBlock):
                h = layer(h, emb)
            elif isinstance(layer, UNetAttentionBlock):
                h = layer(h, encoder_out)
            else:
                h = layer(h)
        return h


class UNet(nn.Module):
    """GLIDE's ``UNetModel`` body (``unet.py:280-527``) without the step
    entry: input, middle and output blocks with skip concatenation,
    attention at the given downsample rates, (N, C, *spatial) in and out.
    ``forward`` takes the step embedding (``model_channels`` wide).  The
    decoder's UNet (JAX's ``UNet1D``) is ``dims=1``,
    ``use_scale_shift_norm=True``; ``models/glide_unet.py::GlideUNet``
    adds the step and label embeddings."""

    def __init__(self, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int], dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, dims: int = 2, num_heads: int = 1,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False,
                 encoder_channels: Optional[int] = None,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        mc, attn_res = model_channels, set(attention_resolutions)
        if num_heads_upsample == -1:
            num_heads_upsample = num_heads

        def res(ch, out, **kw):
            return ResBlock(ch, mc, dropout, out, dims=dims,
                            use_scale_shift_norm=use_scale_shift_norm,
                            dtype=dtype, **kw)

        def attn(ch, heads):
            return UNetAttentionBlock(ch, heads, num_head_channels,
                                      encoder_channels, dtype)

        ch = channel_mult[0] * mc
        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(
            [conv_nd(dims, in_channels, ch, 3, padding=1, compute_dtype=dtype)])])
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                block = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attn_res:
                    block.append(attn(ch, num_heads))
                self.input_blocks.append(TimestepEmbedSequential(block))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(
                    [res(ch, ch, down=True) if resblock_updown
                     else Downsample(ch, conv_resample, dims, dtype)]))
                chans.append(ch)
                ds *= 2

        self.middle_block = TimestepEmbedSequential(
            [res(ch, ch), attn(ch, num_heads), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                block = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in attn_res:
                    block.append(attn(ch, num_heads_upsample))
                if level and i == num_res_blocks:
                    block.append(res(ch, ch, up=True) if resblock_updown
                                 else Upsample(ch, conv_resample, dims, dtype))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(block))

        self.out = nn.Sequential(
            group_norm(ch, dtype), nn.SiLU(),
            zero_(conv_nd(dims, ch, out_channels, 3, padding=1,
                          compute_dtype=dtype)))

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, C, *spatial); emb: (N, model_channels); encoder_out:
        (N, C_enc, T_enc)."""
        hs, h = [], x
        for block in self.input_blocks:
            h = block(h, emb, encoder_out)
            hs.append(h)
        h = self.middle_block(h, emb, encoder_out)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, encoder_out)
        return self.out(h)


def _pad_lengths(window_len: int, n_levels: int) -> Tuple[int, int]:
    """Symmetric pad so T keeps halving cleanly."""
    def ok(length: int) -> bool:
        for _ in range(n_levels):
            length /= 2
        return length % 2 == 0

    t = window_len
    while not ok(t):
        t += 1
    if window_len % 2 != 0:
        raise NotImplementedError("uneven window length not supported")
    pad = (t - window_len) // 2
    return pad, pad


class UNetAttn(UNet):
    """The decoder: memory[:, 0] is the diffusion-step token (through the
    time-embedding MLP; its width is model_channels, as in the reference's
    GLIDE), memory[:, 1:] is the audio stream used as encoder K/V.
    ``n_layers`` is the number of ResBlocks per level."""

    def __init__(self, d_x: int, d_memory: int, d_model: int, heads: int,
                 n_layers: int, d_out: int, dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4),
                 attention_resolutions: Sequence[int] = (1, 2, 4),
                 window_len: int = 40, dtype: "torch.dtype | None" = None):
        super().__init__(d_x, d_model, d_out, n_layers, attention_resolutions,
                         dropout, channel_mult, dims=1, num_heads=heads,
                         use_scale_shift_norm=True, encoder_channels=d_memory,
                         dtype=dtype)
        self.time_embed = nn.Sequential(
            Linear(d_memory, d_model, compute_dtype=dtype), nn.SiLU(),
            Linear(d_model, d_model, compute_dtype=dtype))
        self.pad = _pad_lengths(window_len, len(channel_mult) - 1)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """x: (N, T, d_x); memory: (N, 1 + T_audio, d_memory) -> (N, T, d_out)."""
        emb = self.time_embed(memory[:, 0])
        lo, hi = self.pad
        h = F.pad(x, (0, 0, lo, hi)).transpose(1, 2)
        h = super().forward(h, emb, memory[:, 1:].transpose(1, 2))
        return h[:, :, lo:h.shape[2] - hi].transpose(1, 2)
