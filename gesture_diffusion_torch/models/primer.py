"""Generic Primer-EZ transformer stacks (encoder and decoder), batch-first.

Port of ``gesture_diffusion_tpu/models/primer.py`` (the reference's
``models/modules/transformer.py``: ``EmbeddingsWithPositionalEncoding``
:183, ``TransformerLayer`` :196, ``PrimerEZEncoder`` :248,
``PrimerEZDecoder`` :297).  No call path of the reference uses them; they
are part of its model zoo.  Built from the same primitives as the oneway
decoder (``models/attention.py``: the dconv-QKV attention and the
squared-ReLU feed-forward), with LayerNorm eps 1e-6 as in the JAX package.

The embedding scales the linear projection by sqrt(d_model) before adding
the sinusoidal encoding (unlike the decoders' ``PositionalEncoding``).
Masks are boolean, broadcastable to (N, T_q, T_k, 1), True = attend: the
batch-first form of the reference's [T_q, T_k, N].  Module names are the
reference's (``pe.linear``, ``layers.{i}.self_attn``, ``src_attn``,
``feed_forward``, ``norm_self_attn`` / ``norm_src_attn`` / ``norm_ff``,
``out_layers.{0,1}``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from .attention import (FeedForward, MultiHeadAttention,
                        sinusoidal_position_encoding)
from .decoders import LN_EPS

__all__ = ["EmbedWithPositionalEncoding", "PrimerLayer", "PrimerEZEncoder",
           "PrimerEZDecoder"]


class EmbedWithPositionalEncoding(nn.Module):
    """Linear embedding scaled by sqrt(d_model), plus the sinusoidal PE."""

    def __init__(self, d_x: int, d_model: int, max_len: int = 5000):
        super().__init__()
        self.d_model = d_model
        self.linear = nn.Linear(d_x, d_model)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_position_encoding(max_len, d_model)),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.linear(x)
        return h * math.sqrt(self.d_model) + self.pe[: x.shape[1]].to(h.dtype)


class PrimerLayer(nn.Module):
    """Pre-LN residual layer: self-attention, [attention to ``src``,] FF;
    dropout on each sublayer's output."""

    def __init__(self, d_model: int, heads: int, dropout: float = 0.0,
                 with_src: bool = False):
        super().__init__()
        self.with_src = with_src
        self.norm_self_attn = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(heads, d_model, dropout)
        if with_src:
            self.norm_src_attn = nn.LayerNorm(d_model, eps=LN_EPS)
            self.src_attn = MultiHeadAttention(heads, d_model, dropout)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.feed_forward = FeedForward(d_model, dropout=dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                src: Optional[torch.Tensor] = None,
                src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        z = self.norm_self_attn(x)
        x = x + self.dropout(self.self_attn(z, z, z, mask=mask))
        if self.with_src:
            if src is None:
                raise ValueError("a decoder layer needs the memory")
            z = self.norm_src_attn(x)
            x = x + self.dropout(self.src_attn(z, src, src, mask=src_mask))
        z = self.norm_ff(x)
        return x + self.dropout(self.feed_forward(z))


class _PrimerStack(nn.Module):
    def __init__(self, d_x: int, d_model: int, heads: int, n_layers: int,
                 dropout: float, d_out: Optional[int], with_src: bool):
        super().__init__()
        self.pe = EmbedWithPositionalEncoding(d_x, d_model)
        self.layers = nn.ModuleList(
            [PrimerLayer(d_model, heads, dropout, with_src)
             for _ in range(n_layers)])
        self.out_layers = nn.Sequential(nn.LayerNorm(d_model, eps=LN_EPS),
                                        nn.Linear(d_model, d_out or d_model))


class PrimerEZEncoder(_PrimerStack):
    """Embedding + PE, n self-attention layers, LayerNorm + Linear head
    (``d_out`` defaults to d_model)."""

    def __init__(self, d_x: int, d_model: int, heads: int, n_layers: int,
                 dropout: float = 0.0, d_out: Optional[int] = None):
        super().__init__(d_x, d_model, heads, n_layers, dropout, d_out, False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, T, d_x) -> (N, T, d_out)."""
        h = self.pe(x)
        for layer in self.layers:
            h = layer(h, mask=mask)
        return self.out_layers(h)


class PrimerEZDecoder(_PrimerStack):
    """Embedding + PE, n {self-attention, attention to the memory, FF}
    layers, LayerNorm + Linear head."""

    def __init__(self, d_x: int, d_model: int, heads: int, n_layers: int,
                 dropout: float = 0.0, d_out: Optional[int] = None):
        super().__init__(d_x, d_model, heads, n_layers, dropout, d_out, True)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, T, d_x); memory: (N, T_mem, d_model) -> (N, T, d_out)."""
        h = self.pe(x)
        for layer in self.layers:
            h = layer(h, mask=mask, src=memory, src_mask=src_mask)
        return self.out_layers(h)
