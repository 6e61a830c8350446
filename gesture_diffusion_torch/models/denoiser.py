"""The conditional gesture denoiser (epsilon predictor).

Port of ``gesture_diffusion_tpu/models/denoiser.py`` for every decoder
of the JAX factory (``oneway_cross_attention``, ``cross_attention``,
``cross_attention_gcn``, ``unet_attention``), plus the port's own
``mmdit`` (SD3-Medium's joint-stream transformer, ``models/mmdit.py``,
which the JAX package lacks), and all three model types:

  * ``encode_memory(wav)`` — timestep-independent speech conditioning, run
    once per clip by the samplers;
  * ``inpaint_projection(pose, mask)`` — the inpaint type's additive
    conditioning, timestep-independent too, so the fused sampler computes
    it once per call;
  * ``denoise(x_t, t, speech_memory)`` — the per-step work: sinusoidal
    timestep token + cross-attention decoder (+ the inpaint projection);
  * ``forward(x_t, t, wav)`` composes them.

Model types: "default" memory = [t-token ; low ; mid ; high] along time;
"s2g_v2" left-zero-pads the three streams to the longest, concatenates
them on channels and blends them with ``blend_layer``; "inpaint" is
"default" plus x += MLP([seed_pose * mask ; mask]), an MLP that starts at
zero (GLIDE-style).  Layout (N, T, C).

The decoder is ``pose_decoder``, under the reference checkpoint's module
names.  Every decoder is called as ``pose_decoder(x_t, memory)`` with
memory = [step token ; speech memory]; ``mmdit`` reads row 0 as the
conditioning vector of its modulations and the rest as its context
stream, the others attend to all of it.  Train mode (``model.train()``)
turns on dropout (step encoder, inpaint MLP, speech streams, decoder)
and the batch statistics of the encoder's BatchNorms.
``encoder_dtype="bfloat16"`` runs the SE-ResNet
trunk in bf16 and everything after it in f32: the blend layer and the
decoder take the speech memory promoted to f32.  ``dtype="bfloat16"``
(``Train.dtype``) runs the whole model in bf16 as flax does: every
projection, LayerNorm and head computes in bf16 on float32 parameters
(``models/compute_dtype.py``), the step embedding is cast to bf16, and
the trunk takes ``encoder_dtype or dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .compute_dtype import Linear, as_torch_dtype
from .decoders import CrossAttention, OnewayCrossAttention
from .gcn_decoder import CrossAttentionGCN
from .mmdit import MMDiT
from .speech_encoder import HA2GSpeechEncoder
from .unet_decoder import UNetAttn

MODEL_TYPES = ("default", "s2g_v2", "inpaint")
DECODER_TYPES = ("oneway_cross_attention", "cross_attention",
                 "cross_attention_gcn", "unet_attention", "mmdit")


def timestep_freqs(dim: int, max_period: float = 10000.0,
                   device=None) -> torch.Tensor:
    """(dim//2,) float32 sinusoid frequencies of the timestep embedding,
    shared with the fused sampler's token table."""
    half = dim // 2
    return torch.exp(-math.log(max_period)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / half)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, (N,) -> (N, dim); cos first, then sin."""
    args = t.float()[:, None] * timestep_freqs(dim, max_period, t.device)[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class DiffusionStepEncoder(nn.Module):
    def __init__(self, d_model: int, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        self.proj = nn.Sequential(Linear(d_model, d_model, compute_dtype=dtype),
                                  nn.SiLU(),
                                  Linear(d_model, d_model, compute_dtype=dtype))
        self.dropout = nn.Dropout(dropout)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.d_model).to(
            self.dtype or self.proj[0].weight.dtype)
        return self.dropout(self.proj(emb))


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    d_pose: int
    d_model: int = 256
    heads: int = 8
    n_layers: int = 4
    dropout: float = 0.0
    model_type: str = "s2g_v2"            # default | s2g_v2 | inpaint
    decoder_type: str = "oneway_cross_attention"   # one of DECODER_TYPES
    pose_seed_len: int = 10               # inpaint only
    dtype: Optional[str] = None           # "bfloat16": the whole model
    encoder_dtype: Optional[str] = None   # "bfloat16": the conv trunk only
    # cross_attention_gcn extras
    graph_layout: str = "beat"
    graph_strategy: str = "spatial"
    # unet_attention extras (n_layers is the ResBlocks per level)
    channel_mult: tuple = (1, 2, 4)
    attention_resolutions: tuple = (1, 2, 4)
    window_len: int = 40


class GestureDenoiser(nn.Module):
    def __init__(self, cfg: DenoiserConfig):
        super().__init__()
        if cfg.decoder_type not in DECODER_TYPES:
            raise ValueError(f"Unsupported decoder type {cfg.decoder_type}")
        if cfg.model_type not in MODEL_TYPES:
            raise ValueError(f"Unsupported model_type {cfg.model_type}")
        self.cfg = cfg
        dt = as_torch_dtype(cfg.dtype)
        self.speech_encoder = HA2GSpeechEncoder(
            cfg.d_model, cfg.dropout, as_torch_dtype(cfg.encoder_dtype) or dt)
        self.diffusion_step_encoder = DiffusionStepEncoder(cfg.d_model,
                                                           cfg.dropout, dt)
        common = dict(d_x=cfg.d_pose, d_memory=cfg.d_model,
                      d_model=cfg.d_model, heads=cfg.heads,
                      n_layers=cfg.n_layers, d_out=cfg.d_pose,
                      dropout=cfg.dropout, dtype=dt)
        if cfg.decoder_type == "oneway_cross_attention":
            self.pose_decoder = OnewayCrossAttention(**common)
        elif cfg.decoder_type == "cross_attention":
            self.pose_decoder = CrossAttention(**common)
        elif cfg.decoder_type == "mmdit":
            self.pose_decoder = MMDiT(**common)
        elif cfg.decoder_type == "cross_attention_gcn":
            self.pose_decoder = CrossAttentionGCN(
                graph_layout=cfg.graph_layout,
                graph_strategy=cfg.graph_strategy, **common)
        else:
            self.pose_decoder = UNetAttn(
                channel_mult=tuple(cfg.channel_mult),
                attention_resolutions=tuple(cfg.attention_resolutions),
                window_len=cfg.window_len, **common)
        if cfg.model_type == "s2g_v2":
            self.blend_layer = Linear(3 * cfg.d_model, cfg.d_model,
                                      compute_dtype=dt)
        if cfg.model_type == "inpaint":
            # the reference checkpoint's name for the conditioning MLP
            self.proj = nn.Sequential(
                Linear(cfg.d_pose + 1, cfg.d_model, compute_dtype=dt), nn.SiLU(),
                Linear(cfg.d_model, cfg.d_model, compute_dtype=dt), nn.SiLU(),
                Linear(cfg.d_model, cfg.d_pose, compute_dtype=dt),
                nn.Dropout(cfg.dropout))
            for lin in (self.proj[0], self.proj[2], self.proj[4]):
                nn.init.zeros_(lin.weight)
                nn.init.zeros_(lin.bias)

    def encode_memory(self, wav: torch.Tensor) -> torch.Tensor:
        """(N, T_wav) -> (N, T_mem, d_model) speech memory (no t-token)."""
        low, mid, high = self.speech_encoder(wav)
        if self.cfg.model_type == "s2g_v2":
            longest = max(s.shape[1] for s in (low, mid, high))
            streams = [F.pad(s, (0, 0, longest - s.shape[1], 0))
                       for s in (low, mid, high)]
            return self.blend_layer(
                torch.cat(streams, dim=-1).to(self.blend_layer.weight.dtype))
        return torch.cat([low, mid, high], dim=1)

    def inpaint_projection(self, inpaint_pose: torch.Tensor,
                           inpaint_mask: torch.Tensor) -> torch.Tensor:
        """The inpaint type's additive conditioning,
        MLP([pose * mask ; mask]) -> (N, T, d_pose); dropout is the
        identity in eval mode."""
        return self.proj(torch.cat([inpaint_pose * inpaint_mask, inpaint_mask],
                                   dim=-1))

    def denoise(self, x_t: torch.Tensor, t: torch.Tensor,
                speech_memory: torch.Tensor,
                inpaint_pose: Optional[torch.Tensor] = None,   # (N, T, d_pose)
                inpaint_mask: Optional[torch.Tensor] = None,   # (N, T, 1)
                ) -> torch.Tensor:
        if self.cfg.model_type == "inpaint":
            if inpaint_pose is None or inpaint_mask is None:
                raise ValueError("inpaint model requires inpaint tensors")
            x_t = x_t + self.inpaint_projection(inpaint_pose, inpaint_mask)
        t_token = self.diffusion_step_encoder(t)[:, None]     # (N, 1, D)
        # promote, never truncate the step embedding to the memory dtype
        mdt = torch.promote_types(t_token.dtype, speech_memory.dtype)
        memory = torch.cat([t_token.to(mdt), speech_memory.to(mdt)], dim=1)
        return self.pose_decoder(x_t, memory)

    def forward(self, x_t: torch.Tensor, t: torch.Tensor, wav: torch.Tensor,
                inpaint_pose: Optional[torch.Tensor] = None,
                inpaint_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.denoise(x_t, t, self.encode_memory(wav), inpaint_pose,
                            inpaint_mask)
