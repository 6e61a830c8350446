"""s2g_v2: the three streams left-padded in time to the longest, joined
on channels and blended by ``blend_layer``."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def attach(model: nn.Module, d_model: int) -> None:
    model.blend_layer = nn.Linear(3 * d_model, d_model)


def memory(model: nn.Module, low, mid, high):
    n = max(s.shape[1] for s in (low, mid, high))
    return model.blend_layer(torch.cat(
        [F.pad(s, (0, 0, n - s.shape[1], 0)) for s in (low, mid, high)],
        dim=-1))
