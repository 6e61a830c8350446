"""Inputs made from the seed: speech-like audio, initial noise and seed
poses.  Every draw is a function of (seed, stream, index) alone, so the
reference regenerates exactly what a request was given."""

from __future__ import annotations

import math

import numpy as np
import torch


def substream(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream named by ``keys`` under ``seed``."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, *keys])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *keys: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(substream(seed, *keys))


def speech(seed: int, n: int, samples: int, device, sr: int = 16000):
    """(n, samples) float32 speech-like audio: Gaussian noise under a
    4 Hz syllable envelope with a random phase per clip, in [-1, 1]."""
    g = generator(seed, 1, device=device)
    phase = torch.rand((n, 1), generator=g, device=device) * 6.0
    t = torch.arange(samples, device=device, dtype=torch.float32) / sr
    env = 0.5 + 0.5 * torch.sin(2.0 * math.pi * 4.0 * t[None] + phase)
    noise = torch.randn((n, samples), generator=g, device=device)
    return (0.3 * env * noise).clamp_(-1.0, 1.0)


def request_draws(seed: int, r: int, windows: int, n: int, t: int, c: int,
                  seed_len: int, device):
    """(noise (windows, n, t, c), seed poses (n, seed_len, c)) of request
    ``r``: each window's x_T and the first window's seed poses."""
    g = generator(seed, 2, r, device=device)
    noise = torch.randn((windows, n, t, c), generator=g, device=device)
    init = torch.randn((n, seed_len, c), generator=g, device=device)
    return noise, init
