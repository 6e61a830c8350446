"""Cross-attention pose decoders, batch-first.

Port of ``gesture_diffusion_tpu/models/decoders.py``:
  * ``OnewayCrossAttention`` — the BEAT decoder: N layers of pre-LN
    {self-attn -> cross-attn(x -> memory) -> squared-ReLU FF};
  * ``CrossAttention`` — the joint-stream decoder (TED-Expressive): each
    layer runs self-attention on x and on the memory, then one attention
    over the concatenation [x ; memory], splits it back and runs the FF on
    x, and on the memory in every layer but the last.  One positional
    encoding runs over [x ; memory], so memory tokens continue x's
    position index.

Dropout sits on each sublayer's output before the residual add and after
the positional encoding (the identity in ``eval()``).  LayerNorm eps is
1e-6 (the JAX package's flax default, and the fused kernel's ``LN_EPS``),
not torch's 1e-5.  Module names are the reference checkpoint's.
``dtype`` is the compute dtype of every projection and LayerNorm
(``models/compute_dtype.py``), None for the parameters' own.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .attention import FeedForward, MultiHeadAttention, PositionalEncoding
from .compute_dtype import LayerNorm, Linear

LN_EPS = 1e-6


class OnewayCrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, dropout: float = 0.0,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        self.norm_self_attn = LayerNorm(d_model, LN_EPS, dtype)
        self.self_attn = MultiHeadAttention(heads, d_model, dropout, dtype)
        self.norm_cross_attn = LayerNorm(d_model, LN_EPS, dtype)
        self.cross_attn = MultiHeadAttention(heads, d_model, dropout, dtype)
        self.norm_ff = LayerNorm(d_model, LN_EPS, dtype)
        self.feed_forward = FeedForward(d_model, dropout=dropout, dtype=dtype)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        z = self.norm_self_attn(x)
        x = x + self.dropout(self.self_attn(z, z, z))
        z = self.norm_cross_attn(x)
        x = x + self.dropout(self.cross_attn(z, memory, memory))
        return x + self.dropout(self.feed_forward(self.norm_ff(x)))


class OnewayCrossAttention(nn.Module):
    def __init__(self, d_x: int, d_memory: int, d_model: int, heads: int,
                 n_layers: int, d_out: int, dropout: float = 0.0,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        self.emb_x = Linear(d_x, d_model, compute_dtype=dtype)
        self.emb_mem = Linear(d_memory, d_model, compute_dtype=dtype)
        self.pe = PositionalEncoding(d_model, dropout)
        self.layers = nn.ModuleList(
            OnewayCrossAttentionLayer(d_model, heads, dropout, dtype)
            for _ in range(n_layers))
        self.out_layers = nn.Sequential(
            LayerNorm(d_model, LN_EPS, dtype),
            Linear(d_model, d_out, compute_dtype=dtype))

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = self.pe(self.emb_x(x))
        memory = self.pe(self.emb_mem(memory))
        for layer in self.layers:
            x = layer(x, memory)
        return self.out_layers(x)


class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, dropout: float = 0.0,
                 ff_memory: bool = True, dtype: "torch.dtype | None" = None):
        super().__init__()
        self.norm_self_attn = LayerNorm(d_model, LN_EPS, dtype)
        self.self_attn = MultiHeadAttention(heads, d_model, dropout, dtype)
        self.norm_self_attn_mem = LayerNorm(d_model, LN_EPS, dtype)
        self.self_attn_mem = MultiHeadAttention(heads, d_model, dropout, dtype)
        self.norm_cross_attn = LayerNorm(d_model, LN_EPS, dtype)
        self.cross_attn = MultiHeadAttention(heads, d_model, dropout, dtype)
        self.norm_ff = LayerNorm(d_model, LN_EPS, dtype)
        self.feed_forward = FeedForward(d_model, dropout=dropout, dtype=dtype)
        self.ff_memory = ff_memory
        if ff_memory:
            self.norm_ff_mem = LayerNorm(d_model, LN_EPS, dtype)
            self.feed_forward_mem = FeedForward(d_model, dropout=dropout,
                                                dtype=dtype)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, memory: torch.Tensor
                ) -> "tuple[torch.Tensor, torch.Tensor]":
        z = self.norm_self_attn(x)
        x = x + self.dropout(self.self_attn(z, z, z))
        z = self.norm_self_attn_mem(memory)
        memory = memory + self.dropout(self.self_attn_mem(z, z, z))
        t_x = x.shape[1]
        h = torch.cat([x, memory], dim=1)
        z = self.norm_cross_attn(h)
        h = h + self.dropout(self.cross_attn(z, z, z))
        x, memory = h[:, :t_x], h[:, t_x:]
        x = x + self.dropout(self.feed_forward(self.norm_ff(x)))
        if self.ff_memory:
            memory = memory + self.dropout(
                self.feed_forward_mem(self.norm_ff_mem(memory)))
        return x, memory


class CrossAttention(nn.Module):
    def __init__(self, d_x: int, d_memory: int, d_model: int, heads: int,
                 n_layers: int, d_out: int, dropout: float = 0.0,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        self.emb_x = Linear(d_x, d_model, compute_dtype=dtype)
        self.emb_mem = Linear(d_memory, d_model, compute_dtype=dtype)
        self.pe = PositionalEncoding(d_model, dropout)
        self.layers = nn.ModuleList(
            CrossAttentionLayer(d_model, heads, dropout,
                                ff_memory=i < n_layers - 1, dtype=dtype)
            for i in range(n_layers))
        self.out_layers = nn.Sequential(
            LayerNorm(d_model, LN_EPS, dtype),
            Linear(d_model, d_out, compute_dtype=dtype))

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x, memory = self.emb_x(x), self.emb_mem(memory)
        t_x = x.shape[1]
        h = self.pe(torch.cat([x, memory], dim=1))
        x, memory = h[:, :t_x], h[:, t_x:]
        for layer in self.layers:
            x, memory = layer(x, memory)
        return self.out_layers(x)
