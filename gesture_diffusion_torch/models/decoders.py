"""The oneway cross-attention pose decoder, batch-first.

Port of ``gesture_diffusion_tpu/models/decoders.py::OnewayCrossAttention``:
N layers of pre-LN {self-attn -> cross-attn(x -> memory) -> squared-ReLU
FF}, with dropout on each sublayer's output before the residual add and
after the positional encoding (the identity in ``eval()``).  LayerNorm eps
is 1e-6 (the JAX package's flax default, and the fused
kernel's ``LN_EPS``), not torch's 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .attention import FeedForward, MultiHeadAttention, PositionalEncoding

LN_EPS = 1e-6


class OnewayCrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.norm_self_attn = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(heads, d_model, dropout)
        self.norm_cross_attn = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MultiHeadAttention(heads, d_model, dropout)
        self.norm_ff = nn.LayerNorm(d_model, eps=LN_EPS)
        self.feed_forward = FeedForward(d_model, dropout=dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        z = self.norm_self_attn(x)
        x = x + self.dropout(self.self_attn(z, z, z))
        z = self.norm_cross_attn(x)
        x = x + self.dropout(self.cross_attn(z, memory, memory))
        return x + self.dropout(self.feed_forward(self.norm_ff(x)))


class OnewayCrossAttention(nn.Module):
    def __init__(self, d_x: int, d_memory: int, d_model: int, heads: int,
                 n_layers: int, d_out: int, dropout: float = 0.0):
        super().__init__()
        self.emb_x = nn.Linear(d_x, d_model)
        self.emb_mem = nn.Linear(d_memory, d_model)
        self.pe = PositionalEncoding(d_model, dropout)
        self.layers = nn.ModuleList(
            OnewayCrossAttentionLayer(d_model, heads, dropout)
            for _ in range(n_layers))
        self.out_layers = nn.Sequential(nn.LayerNorm(d_model, eps=LN_EPS),
                                        nn.Linear(d_model, d_out))

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = self.pe(self.emb_x(x))
        memory = self.pe(self.emb_mem(memory))
        for layer in self.layers:
            x = layer(x, memory)
        return self.out_layers(x)
