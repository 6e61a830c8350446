"""Fréchet Gesture Distance (FGD) evaluation in embedding space.

Port of ``gesture_diffusion_tpu/generation/fgd.py``: a convolutional
motion autoencoder (``MotionAE``) maps pose windows to latent features;
generated and real feature distributions are compared with the Fréchet
distance (the stable form), beside the latent L1 distance and a diversity
score (``EmbeddingSpaceEvaluator``).

The autoencoder needs no pretrained weights: ``train_motion_ae`` fits it
on any windowed dataset (L1 reconstruction, Adam at optax's defaults).
Activations are (N, T, C) as in flax; each 1-D convolution runs on
(N, C, T) inside, and the encoder flattens its last feature map
time-major, as the flax encoder does.  Module names follow flax's
(``Conv_i`` -> ``convs.{i}``, ``LayerNorm_i`` -> ``norms.{i}``,
``Dense_i`` -> ``fcs.{i}``), so ``interop.motion_ae_state_dict_from_jax``
carries a flax net's variables over by name.  Nets are saved with
``torch.save`` (``.pt``); a JAX ``.msgpack`` net loads too
(``load_jax_motion_ae``) and is never retrained over.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from scipy import linalg

from ..utils.device import resolve_device

LN_EPS = 1e-6           # flax's LayerNorm default
SLOPE = 0.2             # leaky ReLU


def _sqrtm(a: np.ndarray) -> np.ndarray:
    """scipy.linalg.sqrtm across API generations: before 1.16 it needs
    disp=False to keep the ill-conditioned products this module retries
    with an eps offset quiet (and then returns an (X, errest) tuple); 1.16
    deprecated the parameter."""
    import scipy

    if tuple(int(x) for x in scipy.__version__.split(".")[:2]) < (1, 16):
        out = linalg.sqrtm(a, disp=False)
        return out[0] if isinstance(out, tuple) else out
    return linalg.sqrtm(a)


def _conv(conv: nn.Conv1d, h: torch.Tensor) -> torch.Tensor:
    """(N, T, C) through a Conv1d, back to (N, T', C')."""
    return conv(h.transpose(1, 2)).transpose(1, 2)


class PoseEncoderConv(nn.Module):
    """(N, T, C) -> (N, latent_dim): three valid convs (strides 1, 1, 2)
    with LayerNorm and leaky ReLU, a fourth conv, then three Dense."""

    def __init__(self, length: int, pose_dim: int, latent_dim: int = 32):
        super().__init__()
        chans, t = [pose_dim, 32, 64, 64, 32], length
        strides = (1, 1, 2, 1)
        self.convs = nn.ModuleList(
            nn.Conv1d(chans[i], chans[i + 1], 3, stride=s)
            for i, s in enumerate(strides))
        for s in strides:
            t = (t - 3) // s + 1
        self.norms = nn.ModuleList(nn.LayerNorm(c, eps=LN_EPS) for c in chans[1:4])
        self.fcs = nn.ModuleList([nn.Linear(32 * t, 256), nn.Linear(256, 128),
                                  nn.Linear(128, latent_dim)])

    def forward(self, poses: torch.Tensor) -> torch.Tensor:
        h = poses
        for conv, norm in zip(self.convs, self.norms):
            h = F.leaky_relu(norm(_conv(conv, h)), SLOPE)
        h = _conv(self.convs[3], h).flatten(1)        # time-major, as flax
        h = F.leaky_relu(self.fcs[0](h), SLOPE)
        h = F.leaky_relu(self.fcs[1](h), SLOPE)
        return self.fcs[2](h)


class PoseDecoderConv(nn.Module):
    """(N, latent_dim) -> (N, length, pose_dim): two Dense, a (length, 4)
    map, two same-padded convs with LayerNorm and leaky ReLU, a last
    conv."""

    def __init__(self, length: int, pose_dim: int, latent_dim: int = 32):
        super().__init__()
        self.length = length
        self.fcs = nn.ModuleList([nn.Linear(latent_dim, 128),
                                  nn.Linear(128, length * 4)])
        self.convs = nn.ModuleList([nn.Conv1d(4, 32, 3, padding=1),
                                    nn.Conv1d(32, 32, 3, padding=1),
                                    nn.Conv1d(32, pose_dim, 3, padding=1)])
        self.norms = nn.ModuleList(nn.LayerNorm(32, eps=LN_EPS) for _ in range(2))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.fcs[0](feat), SLOPE)
        h = self.fcs[1](h).view(feat.shape[0], self.length, 4)
        for conv, norm in zip(self.convs, self.norms):
            h = F.leaky_relu(norm(_conv(conv, h)), SLOPE)
        return _conv(self.convs[2], h)


class MotionAE(nn.Module):
    def __init__(self, length: int, pose_dim: int, latent_dim: int = 32):
        super().__init__()
        self.length, self.pose_dim, self.latent_dim = length, pose_dim, latent_dim
        self.encoder = PoseEncoderConv(length, pose_dim, latent_dim)
        self.decoder = PoseDecoderConv(length, pose_dim, latent_dim)

    def forward(self, poses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """:return: (reconstruction, latent features)."""
        feat = self.encoder(poses)
        return self.decoder(feat), feat

    def encode(self, poses: torch.Tensor) -> torch.Tensor:
        return self.encoder(poses)


def train_motion_ae(poses: np.ndarray, latent_dim: int = 32, steps: int = 2000,
                    batch_size: int = 64, lr: float = 5e-4, seed: int = 0,
                    device=None) -> MotionAE:
    """Fit the embedding net to ``poses`` (N, T, C) with an L1
    reconstruction objective: ``steps`` Adam steps (optax's defaults:
    betas 0.9 / 0.999, eps 1e-8) on batches drawn without replacement from
    ``np.random.default_rng(seed)``, as the JAX function draws them.
    Returns the net in eval mode on ``device`` (the card by default)."""
    dev = resolve_device(device)
    n, t, c = poses.shape
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MotionAE(t, c, latent_dim)
    model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    data = torch.from_numpy(np.ascontiguousarray(poses, np.float32)).to(dev)
    rng = np.random.default_rng(seed)
    bs = min(batch_size, n)
    for _ in range(steps):
        batch = data[torch.from_numpy(rng.choice(n, bs, replace=False)).to(dev)]
        recon, _ = model(batch)
        loss = (recon - batch).abs().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return model.eval()


def save_motion_ae(path: str, model: MotionAE) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {"length": model.length, "pose_dim": model.pose_dim,
            "latent_dim": model.latent_dim}
    tmp = path + ".tmp"
    torch.save({"meta": meta, "state_dict": model.state_dict()}, tmp)
    os.replace(tmp, path)


def load_motion_ae(path: str, device=None) -> MotionAE:
    raw = torch.load(path, map_location="cpu", weights_only=True)
    meta = raw["meta"]
    model = MotionAE(int(meta["length"]), int(meta["pose_dim"]),
                     int(meta["latent_dim"]))
    model.load_state_dict(raw["state_dict"])
    return model.to(resolve_device(device)).eval()


def load_jax_motion_ae(path: str, device=None) -> MotionAE:
    """The JAX package's net (``save_motion_ae``'s flax msgpack:
    ``{"meta", "variables"}``) as the port's ``MotionAE``."""
    from ..interop import flax_msgpack, motion_ae_state_dict_from_jax

    raw = flax_msgpack.load(path)
    meta = raw["meta"]
    model = MotionAE(int(meta["length"]), int(meta["pose_dim"]),
                     int(meta["latent_dim"]))
    model.load_state_dict(motion_ae_state_dict_from_jax(raw["variables"]))
    return model.to(resolve_device(device)).eval()


def motion_ae_path(path: str) -> str:
    """Where the port keeps the net configured at ``path``: beside it,
    with the suffix replaced by ``.pt``."""
    return os.path.splitext(path)[0] + ".pt"


def load_or_train_motion_ae(path: "str | None", train_poses: np.ndarray,
                            latent_dim: int = 32, steps: int = 2000,
                            device=None) -> MotionAE:
    """The net saved at ``motion_ae_path(path)`` if it is there; else the
    JAX package's net at ``path`` (flax msgpack) if it is there; else one
    trained on ``train_poses`` (seed 0) and saved at
    ``motion_ae_path(path)``, so consecutive evaluations score with the
    same net."""
    if path:
        pt = motion_ae_path(path)
        if os.path.exists(pt):
            return load_motion_ae(pt, device)
        if os.path.exists(path):
            return load_jax_motion_ae(path, device)
    model = train_motion_ae(train_poses, latent_dim=latent_dim, steps=steps,
                            device=device)
    if path:
        save_motion_ae(pt, model)
    return model


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)), stable form."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


class EmbeddingSpaceEvaluator:
    """Accumulate (generated, real) pose windows; score FGD, latent L1 and
    diversity."""

    def __init__(self, model: MotionAE):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.reset()

    def reset(self) -> None:
        self.real_feat_list: List[np.ndarray] = []
        self.generated_feat_list: List[np.ndarray] = []

    def get_no_of_samples(self) -> int:
        return sum(len(f) for f in self.real_feat_list)

    @torch.no_grad()
    def _encode(self, poses) -> np.ndarray:
        x = torch.as_tensor(np.asarray(poses, np.float32), device=self.device)
        return self.model.encode(x).cpu().numpy()

    def push_samples(self, generated_poses, real_poses) -> None:
        self.generated_feat_list.append(self._encode(generated_poses))
        self.real_feat_list.append(self._encode(real_poses))

    def get_scores(self) -> Tuple[float, float]:
        """:return: (frechet_distance, mean latent L1 distance)."""
        gen = np.vstack(self.generated_feat_list)
        real = np.vstack(self.real_feat_list)
        try:
            fd = calculate_frechet_distance(
                gen.mean(0), np.cov(gen, rowvar=False),
                real.mean(0), np.cov(real, rowvar=False))
        except ValueError:
            fd = 1e10
        feat_dist = float(np.mean(np.sum(np.abs(real - gen), axis=-1)))
        return fd, feat_dist

    def get_diversity_scores(self, max_samples: int = 500,
                             seed: int = 0) -> float:
        feats = np.vstack(self.generated_feat_list)[:max_samples]
        rng = np.random.default_rng(seed)
        shuffled = feats[rng.permutation(len(feats))]
        return float(np.mean(np.sum(np.abs(feats - shuffled), axis=-1)))
