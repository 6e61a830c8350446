"""Named, per-step random streams.

The numpy half is an exact copy of ``gesture_diffusion_tpu/utils/rng.py``
(``_stream_salt``, ``RngStream.numpy``), so the port's epoch shuffles equal
the JAX trainer's bit for bit.  In place of ``jax.random`` keys the port
hands out ``torch.Generator``s, one per (seed, stream, step), on the
device that draws from them: t, noise and dropout of a train step are a
function of the run's seed and the step alone, so a resumed run draws what
an uninterrupted one would.  They are not ``jax.random``'s numbers; the
parity tests inject t and noise.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def _stream_salt(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


class RngStream:
    """A root seed plus named, per-step sub-streams."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def numpy(self, name: str, step: "int | None" = None) -> np.random.Generator:
        """Host-side generator (data shuffling), as the JAX package derives it."""
        salt = _stream_salt(name) ^ (0 if step is None else (step + 0x9E3779B9))
        return np.random.default_rng((self.seed, salt))

    def seed_of(self, name: str, step: "int | None" = None) -> int:
        """A 63-bit seed that is a function of (seed, name, step)."""
        digest = hashlib.sha256(f"{self.seed}/{name}/{step}".encode()).digest()
        return int.from_bytes(digest[:8], "little") >> 1

    def torch(self, name: str, step: "int | None" = None,
              device="cpu") -> torch.Generator:
        """A generator on ``device`` seeded with ``seed_of(name, step)``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed_of(name, step))
        return gen
