"""The denoiser, plain torch, eval mode (no dropout, BatchNorm on its
running statistics).

Speech encoder (HA2G): the mel image -> a 3x3 conv stem -> SE-ResNet
stages of [3, 4, 6, 3] basic blocks with [32, 64, 128, 256] filters ->
three taps (after stages 2, 3, 4), each a head of pixel shuffle, a valid
conv, BatchNorm and a Linear over the channel-major (channel, freq)
flattening -> one shared Linear 32 -> d_model: the low, mid and high
streams.  The model type joins the streams into the speech memory; each
type is a module of ``model_types/``, found by the configuration's
``Model.type``: ``attach(model, d_model)`` adds its parameters,
``memory(model, low, mid, high)`` joins.

Denoiser step: memory = [step token ; speech memory], where the token is
SiLU-MLP(sinusoidal(t)), cos half first, then the decoder.  Each decoder
is a module of ``decoders/``, found by ``Model.Decoder.type``:
``Decoder(cfg, d_pose, d_model, operand)`` with ``forward(x, memory)``.
The building blocks they share are here (pre-LN, LayerNorm eps 1e-6):
every attention projects Q, K, V, then runs a kernel-3 depthwise conv
over time on each (taps shared by the heads, zero padded),
softmax(QK^T/sqrt(dk))V and an output projection; the FF is a
squared-ReLU MLP (4x).
"""

from __future__ import annotations

import functools
import importlib
import math
from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .audio import frontend

LN_EPS = 1e-6


class Operand:
    """The rounding applied to each operand of the decoder's products; the
    identity computes them in float32."""

    def __init__(self):
        self.fn: Callable[[torch.Tensor], torch.Tensor] = lambda x: x


class RLinear(nn.Linear):
    def __init__(self, d_in: int, d_out: int, operand: Operand, bias=True):
        super().__init__(d_in, d_out, bias=bias)
        self.operand = operand

    def forward(self, x):
        r = self.operand.fn
        return F.linear(r(x), r(self.weight), self.bias)


@functools.lru_cache(maxsize=None)
def positions(n: int, d: int, device) -> torch.Tensor:
    """(n, d): sin on even channels, cos on odd ones, float64 math; made
    once for each size and device."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(1e4) / d))
    pe = np.zeros((n, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)[:, : d // 2]
    return torch.from_numpy(pe).to(device)


# ----------------------------------------------------------------- encoder
class SELayer(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(c, c // 8), nn.ReLU(),
                                nn.Linear(c // 8, c), nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class SEBasicBlock(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, c, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(c)
        self.se = SELayer(c)
        self.downsample = None
        if stride != 1 or cin != c:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, c, 1, stride=stride, bias=False),
                nn.BatchNorm2d(c))

    def forward(self, x):
        y = self.bn1(F.relu(self.conv1(x)))
        y = self.se(self.bn2(self.conv2(y)))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class Trunk(nn.Module):
    HEADS = (("low", 64, 2, 1, 64), ("mid", 32, 3, 2, 64),
             ("high", 16, 3, 4, 64))   # tag, channels, kernel, shuffle, H in

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(32)
        cin = 32
        for k, (c, blocks) in enumerate(zip((32, 64, 128, 256), (3, 4, 6, 3)),
                                        start=1):
            stage = []
            for b in range(blocks):
                stage.append(SEBasicBlock(cin, c, 2 if k > 1 and b == 0 else 1))
                cin = c
            setattr(self, f"layer{k}", nn.Sequential(*stage))
        for tag, c, kern, _, h in self.HEADS:
            setattr(self, f"conv_{tag}", nn.Conv2d(c, c, kern))
            setattr(self, f"bn_{tag}", nn.BatchNorm2d(c))
            setattr(self, f"fc_{tag}", nn.Linear(c * (h - kern + 1), 32))

    def head(self, i: int, x):
        tag, _, _, r, _ = self.HEADS[i]
        if r > 1:
            x = F.pixel_shuffle(x, r)
        y = getattr(self, f"bn_{tag}")(F.relu(getattr(self, f"conv_{tag}")(x)))
        y = y.permute(0, 3, 1, 2)
        return getattr(self, f"fc_{tag}")(y.reshape(y.shape[0], y.shape[1], -1))

    def forward(self, mel):
        x = self.layer1(self.bn1(F.relu(self.conv1(mel[:, None]))))
        f1 = self.layer2(x)
        f2 = self.layer3(f1)
        f3 = self.layer4(f2)
        return self.head(0, f1), self.head(1, f2), self.head(2, f3)


class WavEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.feat_extractor = Trunk()


class SpeechEncoder(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.wav_encoder = WavEncoder()
        self.wav_proj_layer = nn.Linear(32, d_model)

    def forward(self, wav):
        streams = self.wav_encoder.feat_extractor(frontend(wav))
        return tuple(self.wav_proj_layer(s) for s in streams)


# ------------------------------- the decoders' building blocks
class Proj(nn.Module):
    def __init__(self, d: int, operand: Operand):
        super().__init__()
        self.linear = RLinear(d, d, operand)


class DConv(nn.Module):
    def __init__(self, dk: int):
        super().__init__()
        self.conv = nn.Conv1d(dk, dk, 3, padding=1, groups=dk)

    def forward(self, x):
        """(N, T, H, dk): w0 x[t-1] + w1 x[t] + w2 x[t+1] + b, zero ends."""
        w = self.conv.weight[:, 0, :].t()
        prev = F.pad(x[:, :-1], (0, 0, 0, 0, 1, 0))
        nxt = F.pad(x[:, 1:], (0, 0, 0, 0, 0, 1))
        return prev * w[0] + x * w[1] + nxt * w[2] + self.conv.bias


class Attention(nn.Module):
    def __init__(self, heads: int, d: int, operand: Operand):
        super().__init__()
        self.heads, self.dk, self.operand = heads, d // heads, operand
        for name in ("query", "key", "value"):
            setattr(self, name, nn.ModuleList([Proj(d, operand),
                                               DConv(self.dk)]))
        self.output = RLinear(d, d, operand)

    def project(self, name: str, x):
        lin, conv = getattr(self, name)
        y = lin.linear(x)
        return conv(y.view(*y.shape[:-1], self.heads, self.dk))

    def forward(self, q_in, kv_in):
        r = self.operand.fn
        q, k = self.project("query", q_in), self.project("key", kv_in)
        v = self.project("value", kv_in)
        s = torch.einsum("nihd,njhd->nijh", r(q), r(k)) / math.sqrt(self.dk)
        p = torch.softmax(s, dim=2)
        o = torch.einsum("nijh,njhd->nihd", r(p), r(v))
        return self.output(o.reshape(*o.shape[:-2], -1))


class FeedForward(nn.Module):
    def __init__(self, d: int, operand: Operand):
        super().__init__()
        self.layer1 = RLinear(d, 4 * d, operand)
        self.layer2 = RLinear(4 * d, d, operand)

    def forward(self, x):
        return self.layer2(F.relu(self.layer1(x)) ** 2)


def norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class StepEncoder(nn.Module):
    def __init__(self, d: int, operand: Operand):
        super().__init__()
        self.d = d
        self.proj = nn.Sequential(RLinear(d, d, operand), nn.SiLU(),
                                  RLinear(d, d, operand))

    def forward(self, t):
        half = self.d // 2
        freqs = torch.exp(-math.log(1e4) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        a = t.float()[:, None] * freqs[None]
        return self.proj(torch.cat([torch.cos(a), torch.sin(a)], dim=-1))


def found(folder: str, name: str, what: str):
    """The reference module ``<folder>/<name>.py`` of a configuration's
    ``what``."""
    try:
        return importlib.import_module(f"{__package__}.{folder}.{name}")
    except ModuleNotFoundError as err:
        raise ValueError(f"no reference for {what} {name!r}: add "
                         f"benchmark/reference/{folder}/{name}.py") from err


class Denoiser(nn.Module):
    """The served model: ``encode(wav)`` once per window, ``denoise(x, t,
    memory)`` once per step."""

    def __init__(self, model_type: str, decoder: dict, d_pose: int,
                 d_model: int):
        super().__init__()
        self.model_type = model_type
        self.join = found("model_types", model_type, "model type")
        self.operand = Operand()
        self.speech_encoder = SpeechEncoder(d_model)
        self.diffusion_step_encoder = StepEncoder(d_model, self.operand)
        self.pose_decoder = found("decoders", decoder["type"], "decoder").Decoder(
            decoder, d_pose, d_model, self.operand)
        self.join.attach(self, d_model)

    def encode(self, wav):
        return self.join.memory(self, *self.speech_encoder(wav))

    def denoise(self, x, t, memory):
        token = self.diffusion_step_encoder(t)[:, None]
        return self.pose_decoder(x, torch.cat([token, memory], dim=1))


def build(cfg: dict, device="cpu") -> Denoiser:
    """The reference for a frozen configuration (``benchmark/configs``),
    in eval mode on ``device``; its parameters are uninitialised until a
    state dict is loaded."""
    m = cfg["Model"]
    with torch.device("meta"):
        model = Denoiser(m.get("type", "s2g_v2"), m["Decoder"], cfg["d_pose"],
                         m["d_model"])
    return model.to_empty(device=device).eval()
