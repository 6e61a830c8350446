"""HA2G hierarchical speech encoder (NCHW inside the conv trunk).

Port of ``gesture_diffusion_tpu/models/speech_encoder.py``:

  mel spectrogram (frozen front-end, ``ops/audio.py``)
    -> 3x3 conv stem -> SE-ResNet [3,4,6,3] with filters [32,64,128,256]
    -> taps after layer2/3/4
    -> per-tap head: (pixel-shuffle to realign time) + valid conv + BN
       + Linear over the channel-major flattened (channel, freq) axis
    -> shared Linear 32 -> d_model giving the (low, mid, high) streams.

The mel image is (N, 1, freq, time).  Module names follow the reference
checkpoint (``wav_encoder.feat_extractor.layer{k}.{b}.conv1``, ...).
``SEBottleneck`` (the reference's other residual block, which the trunk
does not use) is here too.

Training follows flax, not torch's stock BatchNorm: see ``BatchNorm2d``.
With ``encoder_dtype="bfloat16"`` the trunk and the projection run under
``torch.autocast`` in bf16 (f32 parameters, BN statistics in f32), as flax
``dtype=bfloat16`` computes them; the mel front-end stays in f32 and the
three streams come out in bf16.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.audio import speech_frontend
from ..parallel.mesh import active_group, all_reduce_sum

BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose train mode is flax's ``nn.BatchNorm(momentum=0.9)``.

    Both normalise by the batch's biased variance.  They differ in the
    running statistics: torch moves ``running_var`` towards the unbiased
    variance (n/(n-1) times larger), flax towards the biased one.  So the
    statistics are computed here, in f32 whatever the input dtype, and the
    running averages moved by hand: new = 0.9 old + 0.1 batch (torch's
    momentum 0.1 is flax's 0.9).  Eval mode is torch's own.

    Under a process group (``torch.distributed``, a group of one included)
    the batch is the global one, as in the JAX package's batch-sharded
    step: the mean and then the centred second moment are summed over the
    ranks with two all-reduces that carry the gradient
    (``parallel.mesh.all_reduce_sum``), so every rank
    normalises and moves its running statistics by the same numbers.
    ``torch.nn.SyncBatchNorm`` does not serve: it refuses CPU tensors and
    moves ``running_var`` towards the unbiased variance."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if active_group() is not None:
            return self._global_forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(
                x.to(torch.promote_types(x.dtype, torch.float32)),
                dim=(0, 2, 3), unbiased=False)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
        self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        self.num_batches_tracked.add_(1)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Statistics of the global batch; every rank holds as many rows
        (the data split makes it so), hence the count."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xf.numel() // xf.shape[1] * active_group()[1]
        mean = all_reduce_sum(xf.sum(dim=(0, 2, 3))) / count
        centred = xf - mean[None, :, None, None]
        var = all_reduce_sum((centred * centred).sum(dim=(0, 2, 3))) / count
        self._update_running(mean.detach(), var.detach())
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = (y * self.weight.to(y.dtype)[None, :, None, None]
             + self.bias.to(y.dtype)[None, :, None, None])
        return y.to(x.dtype)


class SELayer(nn.Module):
    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction),
                                nn.ReLU(),
                                nn.Linear(channels // reduction, channels),
                                nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class SEBasicBlock(nn.Module):
    """conv-relu-bn / conv-bn-se / +residual / relu (reference order)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.se = SELayer(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(F.relu(self.conv1(x)))
        y = self.se(self.bn2(self.conv2(y)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class SEBottleneck(nn.Module):
    """1x1 reduce / 3x3 / 1x1 expand (x4) bottleneck with SE, conv-bn-relu
    order (reference ``ResNetBlocks.py:40-78``).  The trunk builds
    SEBasicBlocks only; this block is part of the reference's model zoo.
    The projection (1x1 conv + BN, ``downsample``) is built when the
    stride or the width changes."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.se = SELayer(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
                BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.se(self.bn3(self.conv3(y)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


def _stride2(h: int) -> int:
    """Height after a 3x3, stride-2, pad-1 conv."""
    return (h - 1) // 2 + 1


class SEResNetEncoder(nn.Module):
    """SE-ResNet-34-ish trunk over the mel image with three temporal taps."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 filters: Sequence[int] = (32, 64, 128, 256),
                 n_out: int = 32, n_mels: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(1, filters[0], 3, padding=1)
        self.bn1 = BatchNorm2d(filters[0])
        inplanes = filters[0]
        for k, (planes, blocks) in enumerate(zip(filters, layers), start=1):
            stride = 1 if k == 1 else 2
            stage = []
            for b in range(blocks):
                stage.append(SEBasicBlock(inplanes, planes,
                                          stride if b == 0 else 1))
                inplanes = planes
            setattr(self, f"layer{k}", nn.Sequential(*stage))
        h2 = _stride2(n_mels)
        h3, h4 = _stride2(h2), _stride2(_stride2(h2))
        # (tag, conv in = out channels, kernel, pixel-shuffle factor, H in)
        heads = (("low", filters[1], 2, 1, h2),
                 ("mid", filters[1] // 2, 3, 2, h3 * 2),
                 ("high", filters[1] // 4, 3, 4, h4 * 4))
        self._shuffle = {}
        for tag, ch, kern, r, h in heads:
            setattr(self, f"conv_{tag}", nn.Conv2d(ch, ch, kern))
            setattr(self, f"bn_{tag}", BatchNorm2d(ch))
            setattr(self, f"fc_{tag}", nn.Linear(ch * (h - kern + 1), n_out))
            self._shuffle[tag] = r

    def _head(self, tag: str, x: torch.Tensor) -> torch.Tensor:
        r = self._shuffle[tag]
        if r > 1:
            x = F.pixel_shuffle(x, r)
        y = getattr(self, f"bn_{tag}")(F.relu(getattr(self, f"conv_{tag}")(x)))
        # (N, C, H, W) -> (N, W, C*H): channel-major flatten
        y = y.permute(0, 3, 1, 2)
        y = y.reshape(y.shape[0], y.shape[1], -1)
        return getattr(self, f"fc_{tag}")(y)

    def forward(self, mel: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """mel: (N, n_mels, T_spec) -> three (N, T_i, n_out) streams."""
        x = self.bn1(F.relu(self.conv1(mel[:, None])))
        x = self.layer1(x)
        f1 = self.layer2(x)
        f2 = self.layer3(f1)
        f3 = self.layer4(f2)
        return self._head("low", f1), self._head("mid", f2), self._head("high", f3)


class _WavEncoder(nn.Module):
    """Holds the trunk under the reference's ``wav_encoder.feat_extractor``
    name."""

    def __init__(self):
        super().__init__()
        self.feat_extractor = SEResNetEncoder()


class HA2GSpeechEncoder(nn.Module):
    """Waveform -> three (N, T_i, d_model) feature streams, with dropout
    before the shared projection."""

    def __init__(self, d_model: int, dropout: float = 0.0,
                 encoder_dtype: "torch.dtype | None" = None):
        super().__init__()
        self.wav_encoder = _WavEncoder()
        self.wav_proj_layer = nn.Linear(32, d_model)
        self.dropout = nn.Dropout(dropout)
        self.encoder_dtype = encoder_dtype

    def forward(self, wav: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mel = speech_frontend(wav).to(self.wav_proj_layer.weight.dtype)
        with torch.autocast(wav.device.type, dtype=self.encoder_dtype,
                            enabled=self.encoder_dtype is not None):
            streams = self.wav_encoder.feat_extractor(mel)
            return tuple(self.wav_proj_layer(self.dropout(s)) for s in streams)
