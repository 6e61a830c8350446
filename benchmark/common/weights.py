"""Weights made from the seed, on the device, in the type they are served
in (bfloat16 values held in float32 tensors).

Every floating tensor of the reference's state dict is drawn from one
uniform draw of a ``torch.Generator`` on the device: Glorot-uniform
weights of linear and conv layers (a depthwise conv's fan is its
kernel), biases in [-0.02, 0.02], BatchNorm affines near identity and
running statistics off (0, 1), LayerNorm scales powers of two (1/2, 1
or 2) and LayerNorm shifts in [-0.1, 0.1].  A cell may ask for LayerNorm
shifts of 0 (``layernorm_shifts`` false in its traffic): a pack that
folds each LayerNorm's affine into the next projection then holds the
same bfloat16 values as the reference, where a folded shift would be
rounded to bfloat16.  The other tensors are the same either way.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn


def _entries(model: nn.Module):
    """(state-dict name, shape, kind, fan) of every floating tensor."""
    out = []
    for prefix, mod in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            w = mod.weight
            if isinstance(mod, nn.Conv1d) and mod.groups > 1:
                fan = w.shape[2] + w.shape[2]
            else:
                rf = w[0, 0].numel() if w.ndim > 2 else 1
                fan = (w.shape[1] + w.shape[0]) * rf
            out.append((pre + "weight", tuple(w.shape), "glorot", fan))
            if mod.bias is not None:
                out.append((pre + "bias", tuple(mod.bias.shape), "bias", 0))
        elif isinstance(mod, nn.LayerNorm):
            out.append((pre + "weight", tuple(mod.weight.shape), "pow2", 0))
            out.append((pre + "bias", tuple(mod.bias.shape), "ln_shift", 0))
        elif isinstance(mod, nn.BatchNorm2d):
            c = (mod.num_features,)
            out += [(pre + "weight", c, "bn_scale", 0),
                    (pre + "bias", c, "bn_shift", 0),
                    (pre + "running_mean", c, "bn_shift", 0),
                    (pre + "running_var", c, "bn_var", 0)]
    return out


@torch.no_grad()
def make_state_dict(model: nn.Module, seed: int, device,
                    layernorm_shifts: bool = True) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` (the reference, any device) drawn from
    ``seed`` on ``device``: same seed, same weights."""
    entries = _entries(model)
    sizes = [math.prod(shape) for _, shape, _, _ in entries]
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    u = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    exps = torch.randint(-1, 2, (sum(sizes),), generator=g, device=device)
    sd, at = {}, 0
    for (name, shape, kind, fan), size in zip(entries, sizes):
        x = u[at:at + size].view(shape)
        if kind == "glorot":
            x = x * math.sqrt(6.0 / fan)
        elif kind == "bias":
            x = 0.02 * x
        elif kind == "pow2":
            x = torch.exp2(exps[at:at + size].view(shape).float())
        elif kind == "ln_shift":
            x = 0.1 * x if layernorm_shifts else torch.zeros(shape, device=device)
        elif kind == "bn_scale":
            x = 1.0 + 0.1 * x
        elif kind == "bn_shift":
            x = 0.1 * x
        elif kind == "bn_var":
            x = 1.0 + 0.2 * x
        sd[name] = x.to(torch.bfloat16).float().contiguous()
        at += size
    for name, buf in model.state_dict().items():
        if name not in sd:      # BatchNorm's num_batches_tracked
            sd[name] = torch.zeros(buf.shape, dtype=buf.dtype, device=device)
    return sd
