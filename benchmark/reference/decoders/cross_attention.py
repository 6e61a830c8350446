"""The joint-stream cross-attention decoder: in each layer self-attention
on x and on the memory, one attention over [x ; memory] (one positional
encoding over the joined sequence), and the FF on x, and on the memory in
every layer but the last."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..model import Attention, FeedForward, RLinear, norm, positions


class Layer(nn.Module):
    def __init__(self, d: int, heads: int, operand, ff_memory: bool):
        super().__init__()
        self.norm_self_attn, self.norm_self_attn_mem = norm(d), norm(d)
        self.norm_cross_attn, self.norm_ff = norm(d), norm(d)
        self.self_attn = Attention(heads, d, operand)
        self.self_attn_mem = Attention(heads, d, operand)
        self.cross_attn = Attention(heads, d, operand)
        self.feed_forward = FeedForward(d, operand)
        self.ff_memory = ff_memory
        if ff_memory:
            self.norm_ff_mem = norm(d)
            self.feed_forward_mem = FeedForward(d, operand)

    def forward(self, x, mem):
        z = self.norm_self_attn(x)
        x = x + self.self_attn(z, z)
        z = self.norm_self_attn_mem(mem)
        mem = mem + self.self_attn_mem(z, z)
        h = torch.cat([x, mem], dim=1)
        z = self.norm_cross_attn(h)
        h = h + self.cross_attn(z, z)
        x, mem = h[:, :x.shape[1]], h[:, x.shape[1]:]
        x = x + self.feed_forward(self.norm_ff(x))
        if self.ff_memory:
            mem = mem + self.feed_forward_mem(self.norm_ff_mem(mem))
        return x, mem


class Decoder(nn.Module):
    def __init__(self, cfg: dict, d_pose: int, d: int, operand):
        super().__init__()
        heads, n_layers = cfg.get("heads", 8), cfg.get("n_layers", 4)
        self.emb_x = RLinear(d_pose, d, operand)
        self.emb_mem = RLinear(d, d, operand)
        self.layers = nn.ModuleList(Layer(d, heads, operand, i < n_layers - 1)
                                    for i in range(n_layers))
        self.out_layers = nn.Sequential(norm(d), RLinear(d, d_pose, operand))

    def forward(self, x, mem):
        x, mem = self.emb_x(x), self.emb_mem(mem)
        h = torch.cat([x, mem], dim=1)
        h = h + positions(h.shape[1], h.shape[2], h.device)
        x, mem = h[:, :x.shape[1]], h[:, x.shape[1]:]
        for layer in self.layers:
            x, mem = layer(x, mem)
        return self.out_layers(x)
