"""Vertex-factored cross-attention decoder with ST-GCN residuals.

Port of ``gesture_diffusion_tpu/models/gcn_decoder.py``: pose features
are reshaped (N, T, V, d_model/V); each layer applies a pre-LN
K-partition graph convolution residual on the vertex axis, then the
joint-stream cross-attention of :class:`.decoders.CrossAttentionLayer` on
the flattened features.  Module names are the reference checkpoint's: the
graph convolution is a 1x1 ``Conv2d`` (``layers.{i}.gcn.conv``) whose
output channels are partition-major, and the attention blocks sit in the
layer itself; the out head is a plain ``Linear`` (``out_layers``), with
no LayerNorm.  ``dtype`` is the compute dtype, as in ``decoders.py``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.graph import build_graph
from .attention import PositionalEncoding
from .compute_dtype import LayerNorm, Linear
from .decoders import LN_EPS, CrossAttentionLayer


class GraphConv(nn.Module):
    """K-partition graph conv (temporal kernel 1): a 1x1 conv C -> K*C_out,
    then the contraction with the (K, V, V) adjacency."""

    def __init__(self, in_channels: int, out_channels: int, n_partitions: int,
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        self.out_channels, self.n_partitions = out_channels, n_partitions
        self.conv = nn.Conv2d(in_channels, out_channels * n_partitions, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        """x: (N, T, V, C) -> (N, T, V, out_channels)."""
        w, b = self.conv.weight[:, :, 0, 0], self.conv.bias
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        y = F.linear(x, w, b)
        y = y.unflatten(-1, (self.n_partitions, self.out_channels))
        return torch.einsum("ntvkc,kvw->ntwc", y, A.to(y.dtype))


class CrossAttentionGCNLayer(CrossAttentionLayer):
    def __init__(self, d_model: int, n_vertices: int, n_partitions: int,
                 heads: int, dropout: float = 0.0, ff_memory: bool = True,
                 dtype: "torch.dtype | None" = None):
        super().__init__(d_model, heads, dropout, ff_memory, dtype)
        dv = d_model // n_vertices
        self.norm_gcn = LayerNorm(dv, LN_EPS, dtype)
        self.gcn = GraphConv(dv, dv, n_partitions, dtype)

    def forward(self, x: torch.Tensor, A: torch.Tensor, memory: torch.Tensor
                ) -> "tuple[torch.Tensor, torch.Tensor]":
        """x: (N, T, V, d_model/V); memory: (N, T_mem, d_model)."""
        x = x + self.dropout(self.gcn(self.norm_gcn(x), A))
        n, t, v, dv = x.shape
        x, memory = super().forward(x.reshape(n, t, v * dv), memory)
        return x.reshape(n, t, v, dv), memory


class CrossAttentionGCN(nn.Module):
    """Per-vertex input/output embeddings, one positional encoding over
    [x ; memory], N GCN + attention layers (the last skips the memory
    feed-forward)."""

    def __init__(self, d_x: int, d_memory: int, d_model: int, heads: int,
                 n_layers: int, d_out: int, dropout: float = 0.0,
                 graph_layout: str = "beat", graph_strategy: str = "spatial",
                 dtype: "torch.dtype | None" = None):
        super().__init__()
        A = torch.from_numpy(build_graph(graph_layout, graph_strategy))
        n_partitions, v, _ = A.shape
        if d_model % v or d_x % v or d_out % v:
            raise ValueError(f"d_model {d_model}, d_x {d_x} and d_out {d_out} "
                             f"must be divisible by the {v} vertices")
        # float64, as the layout computes it; cast to the activations' dtype
        self.register_buffer("A", A, persistent=False)
        self.n_vertices, self.d_model = v, d_model
        dv = d_model // v
        self.emb_x = Linear(d_x // v, dv, compute_dtype=dtype)
        self.emb_mem = Linear(d_memory, d_model, compute_dtype=dtype)
        self.pe = PositionalEncoding(d_model, dropout)
        self.layers = nn.ModuleList(
            CrossAttentionGCNLayer(d_model, v, n_partitions, heads, dropout,
                                   ff_memory=i < n_layers - 1, dtype=dtype)
            for i in range(n_layers))
        self.out_layers = Linear(dv, d_out // v, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        n, t, _ = x.shape
        v = self.n_vertices
        x = self.emb_x(x.reshape(n, t, v, -1)).reshape(n, t, self.d_model)
        h = self.pe(torch.cat([x, self.emb_mem(memory)], dim=1))
        x, memory = h[:, :t].reshape(n, t, v, -1), h[:, t:]
        for layer in self.layers:
            x, memory = layer(x, self.A, memory)
        return self.out_layers(x).reshape(n, t, -1)
