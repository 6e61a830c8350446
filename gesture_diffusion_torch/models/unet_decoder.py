"""1-D GLIDE-style UNet decoder with audio cross-attention.

Port of ``gesture_diffusion_tpu/models/unet_decoder.py``.  The UNet runs
in torch's (N, C, T) layout inside and takes and returns (N, T, C):

  * ``ResBlock1D``: GroupNorm(32, eps 1e-5) + SiLU + conv, FiLM scale and
    shift from the step embedding, zero-initialised output conv;
  * ``UNetAttentionBlock``: self-attention over time with the audio
    stream's keys and values prepended (GLIDE's text-conditioning
    pattern); the fused QKV projection is split head-major, (heads,
    3 * d_k) per frame, and q and k are each scaled by d_k^-1/4;
  * ``UNet1D``: input, middle and output blocks with skip concatenation,
    downsampling by a stride-2 conv (padding 1), upsampling by a
    nearest-neighbour resize and a conv;
  * ``UNetAttn``: memory[:, 0] is the diffusion-step token (through the
    time-embedding MLP), memory[:, 1:] the audio stream; the window is
    zero-padded symmetrically so that T keeps halving (``_pad_lengths``)
    and cropped after the UNet.

Module names are the reference checkpoint's (GLIDE's ``input_blocks``,
``middle_block``, ``output_blocks``, ``out``, ``time_embed``; a ResBlock's
``in_layers`` / ``emb_layers`` / ``out_layers`` / ``skip_connection``;
1x1 ``Conv1d`` projections ``qkv``, ``encoder_kv``, ``proj_out``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

GN_GROUPS, GN_EPS = 32, 1e-5


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, channels, eps=GN_EPS)


def zero_(module: nn.Module) -> nn.Module:
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


class ResBlock1D(nn.Module):
    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 dropout: float = 0.0):
        super().__init__()
        self.in_layers = nn.Sequential(
            group_norm(channels), nn.SiLU(),
            nn.Conv1d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_channels))
        self.out_layers = nn.Sequential(
            group_norm(out_channels), nn.SiLU(), nn.Dropout(dropout),
            zero_(nn.Conv1d(out_channels, out_channels, 3, padding=1)))
        self.skip_connection = (
            nn.Identity() if channels == out_channels
            else nn.Conv1d(channels, out_channels, 1))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """x: (N, C, T); emb: (N, emb_channels)."""
        h = self.in_layers(x)
        scale, shift = self.emb_layers(emb)[..., None].chunk(2, dim=1)
        h = self.out_layers[0](h) * (1 + scale) + shift
        for layer in self.out_layers[1:]:
            h = layer(h)
        return self.skip_connection(x) + h


class UNetAttentionBlock(nn.Module):
    def __init__(self, channels: int, heads: int, encoder_channels: int):
        super().__init__()
        self.heads = heads
        self.norm = group_norm(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.encoder_kv = nn.Conv1d(encoder_channels, 2 * channels, 1)
        self.proj_out = zero_(nn.Conv1d(channels, channels, 1))

    def forward(self, x: torch.Tensor,
                encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, C, T); encoder_out: (N, C_enc, T_enc)."""
        n, c, t = x.shape
        d_k = c // self.heads
        qkv = self.qkv(self.norm(x)).view(n, self.heads, 3 * d_k, t)
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
        return x + self.proj_out(out)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv1d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Block(nn.ModuleList):
    """GLIDE's ``TimestepEmbedSequential``: each module gets what it
    takes (the step embedding, the audio stream, or neither)."""

    def forward(self, h, emb, encoder_out):
        for layer in self:
            if isinstance(layer, ResBlock1D):
                h = layer(h, emb)
            elif isinstance(layer, UNetAttentionBlock):
                h = layer(h, encoder_out)
            else:
                h = layer(h)
        return h


class UNet1D(nn.Module):
    """Input, middle and output blocks with skip concatenation, 1-D over
    time, (N, C, T) in and out."""

    def __init__(self, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int], encoder_channels: int,
                 channel_mult: Sequence[int] = (1, 2, 4, 8), num_heads: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        mc, attn_res = model_channels, set(attention_resolutions)

        def res(ch_in, ch_out):
            return ResBlock1D(ch_in, mc, ch_out, dropout)

        def attn(ch):
            return UNetAttentionBlock(ch, num_heads, encoder_channels)

        ch = channel_mult[0] * mc
        self.input_blocks = nn.ModuleList(
            [_Block([nn.Conv1d(in_channels, ch, 3, padding=1)])])
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                block = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attn_res:
                    block.append(attn(ch))
                self.input_blocks.append(_Block(block))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(_Block([Downsample(ch)]))
                chans.append(ch)
                ds *= 2

        self.middle_block = _Block([res(ch, ch), attn(ch), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                block = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in attn_res:
                    block.append(attn(ch))
                if level and i == num_res_blocks:
                    block.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(_Block(block))

        self.out = nn.Sequential(
            group_norm(ch), nn.SiLU(),
            zero_(nn.Conv1d(ch, out_channels, 3, padding=1)))

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                encoder_out: Optional[torch.Tensor]) -> torch.Tensor:
        hs = []
        h = x
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


class UNetAttn(UNet1D):
    """The decoder: memory[:, 0] is the diffusion-step token (through the
    time-embedding MLP; its width is model_channels, as in the reference's
    GLIDE), memory[:, 1:] is the audio stream used as encoder K/V.
    ``n_layers`` is the number of ResBlocks per level."""

    def __init__(self, d_x: int, d_memory: int, d_model: int, heads: int,
                 n_layers: int, d_out: int, dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4),
                 attention_resolutions: Sequence[int] = (1, 2, 4),
                 window_len: int = 40):
        super().__init__(d_x, d_model, d_out, n_layers, attention_resolutions,
                         d_memory, channel_mult, heads, dropout)
        self.time_embed = nn.Sequential(nn.Linear(d_memory, d_model), nn.SiLU(),
                                        nn.Linear(d_model, d_model))
        self.pad = _pad_lengths(window_len, len(channel_mult) - 1)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """x: (N, T, d_x); memory: (N, 1 + T_audio, d_memory) -> (N, T, d_out)."""
        emb = self.time_embed(memory[:, 0])
        lo, hi = self.pad
        h = F.pad(x, (0, 0, lo, hi)).transpose(1, 2)
        h = super().forward(h, emb, memory[:, 1:].transpose(1, 2))
        return h[:, :, lo:h.shape[2] - hi].transpose(1, 2)
