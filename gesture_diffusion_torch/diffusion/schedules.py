"""Beta schedules, computed on host in float64.

Capability parity with the reference's named schedules
(``models/modules/gaussian_diffusion.py:20-60``): "linear" (Ho et al.,
scaled by 1000/T so any T behaves like the original 1000-step schedule) and
"squaredcos_cap_v2" (improved-DDPM cosine).
"""

from __future__ import annotations

import numpy as np


def linear_betas(num_timesteps: int) -> np.ndarray:
    scale = 1000.0 / num_timesteps
    return np.linspace(scale * 1e-4, scale * 2e-2, num_timesteps, dtype=np.float64)


def cosine_betas(num_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    def alpha_bar(t: float) -> float:
        return np.cos(t * np.pi / 2.0) ** 2

    ts = np.arange(num_timesteps, dtype=np.float64)
    t1 = ts / num_timesteps
    t2 = (ts + 1) / num_timesteps
    return np.minimum(1.0 - alpha_bar(t2) / alpha_bar(t1), max_beta)


def get_named_beta_schedule(name: str, num_timesteps: int) -> np.ndarray:
    if name == "linear":
        return linear_betas(num_timesteps)
    if name == "squaredcos_cap_v2":
        return cosine_betas(num_timesteps)
    raise NotImplementedError(f"unknown beta schedule: {name}")
