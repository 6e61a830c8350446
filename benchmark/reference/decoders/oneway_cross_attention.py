"""The oneway cross-attention decoder: in each layer self-attention,
cross-attention to the memory and the FF, with sinusoidal positions added
to x and to the memory from 0 each."""

from __future__ import annotations

import torch.nn as nn

from ..model import Attention, FeedForward, RLinear, norm, positions


class Layer(nn.Module):
    def __init__(self, d: int, heads: int, operand):
        super().__init__()
        self.norm_self_attn, self.norm_cross_attn, self.norm_ff = (
            norm(d), norm(d), norm(d))
        self.self_attn = Attention(heads, d, operand)
        self.cross_attn = Attention(heads, d, operand)
        self.feed_forward = FeedForward(d, operand)

    def forward(self, x, mem):
        z = self.norm_self_attn(x)
        x = x + self.self_attn(z, z)
        x = x + self.cross_attn(self.norm_cross_attn(x), mem)
        return x + self.feed_forward(self.norm_ff(x))


class Decoder(nn.Module):
    def __init__(self, cfg: dict, d_pose: int, d: int, operand):
        super().__init__()
        heads, n_layers = cfg.get("heads", 8), cfg.get("n_layers", 4)
        self.emb_x = RLinear(d_pose, d, operand)
        self.emb_mem = RLinear(d, d, operand)
        self.layers = nn.ModuleList(Layer(d, heads, operand)
                                    for _ in range(n_layers))
        self.out_layers = nn.Sequential(norm(d), RLinear(d, d_pose, operand))

    def forward(self, x, mem):
        x, mem = self.emb_x(x), self.emb_mem(mem)
        x = x + positions(x.shape[1], x.shape[2], x.device)
        mem = mem + positions(mem.shape[1], mem.shape[2], mem.device)
        for layer in self.layers:
            x = layer(x, mem)
        return self.out_layers(x)
