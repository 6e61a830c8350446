"""Tensor ops: rotation, quaternion and pivot math, the feature scaler,
``audio`` (mel front-end) and ``fused_sampler`` (the fused DDIM kernel and
its plain version).  Import ``audio`` and ``fused_sampler`` directly: the
models import ``audio``, and ``fused_sampler`` imports the models."""

from . import pivots, quaternions, rotation
from .scaler import StandardScaler

__all__ = ["pivots", "quaternions", "rotation", "StandardScaler"]
