"""Feature standardisation (sklearn ``StandardScaler`` capability).

A copy of ``gesture_diffusion_tpu/ops/scaler.py`` (numpy only), kept here
so the port never imports the JAX package: explicit mean/scale arrays,
saved to and loaded from .npz, so a ``scaler.npz`` written by either
package loads in the other.  ``from_sklearn_joblib`` reads the reference's
``scaler.jl``; joblib is imported only for such a file.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StandardScaler:
    mean: np.ndarray   # (C,)
    scale: np.ndarray  # (C,) std with zeros replaced by 1

    @classmethod
    def fit(cls, x: np.ndarray) -> "StandardScaler":
        """x: (N, C)."""
        mean = x.mean(axis=0)
        std = x.std(axis=0)
        scale = np.where(std == 0.0, 1.0, std)
        return cls(mean=mean, scale=scale)

    def transform(self, x):
        return (x - self.mean) / self.scale

    def inverse_transform(self, x):
        return x * self.scale + self.mean

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, mean=self.mean, scale=self.scale)

    @classmethod
    def load(cls, path: str) -> "StandardScaler":
        if path.endswith((".jl", ".joblib")):
            return cls.from_sklearn_joblib(path)
        with np.load(path) as z:
            return cls(mean=z["mean"], scale=z["scale"])

    @classmethod
    def from_sklearn_joblib(cls, path: str) -> "StandardScaler":
        import joblib

        sk = joblib.load(path)
        return cls(mean=np.asarray(sk.mean_), scale=np.asarray(sk.scale_))
