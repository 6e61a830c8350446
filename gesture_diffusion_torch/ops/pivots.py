"""Planar pivot (heading) angles as plain torch functions.

Port of ``gesture_diffusion_tpu/ops/pivots.py``.  A pivot is a rotation
angle about the normal of a plane (by default the ground plane xz); pivots
are (...,) tensors in radians, on the input's device and in its dtype.
"""

from __future__ import annotations

import torch

from .quaternions import from_angle_axis, qrotate

_AXES = {"x": 0, "y": 1, "z": 2}


def wrap_angle(ps: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(ps), torch.cos(ps))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrap-around-aware angle addition."""
    return wrap_angle(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return wrap_angle(a - b)


def from_directions(ds: torch.Tensor, plane: str = "xz") -> torch.Tensor:
    """(..., 3) directions -> (...,) angles: atan2(plane[0], plane[1])."""
    return torch.atan2(ds[..., _AXES[plane[0]]], ds[..., _AXES[plane[1]]])


def from_quaternions(qs: torch.Tensor, forward: str = "z",
                     plane: str = "xz") -> torch.Tensor:
    """(..., 4) quaternions -> (...,) headings: the forward unit vector,
    rotated and projected on the plane."""
    d = torch.zeros(qs.shape[:-1] + (3,), dtype=qs.dtype, device=qs.device)
    d[..., _AXES[forward]] = 1.0
    return from_directions(qrotate(qs, d), plane=plane)


def to_quaternions(ps: torch.Tensor, plane: str = "xz") -> torch.Tensor:
    """(...,) angles -> (..., 4) rotations about the plane's normal (the
    axis left when the two plane components are zeroed)."""
    axis = torch.ones(ps.shape + (3,), dtype=ps.dtype, device=ps.device)
    axis[..., _AXES[plane[0]]] = 0.0
    axis[..., _AXES[plane[1]]] = 0.0
    return from_angle_axis(ps, axis)


def to_directions(ps: torch.Tensor, plane: str = "xz") -> torch.Tensor:
    """(...,) angles -> (..., 3) unit directions in the plane."""
    out = torch.zeros(ps.shape + (3,), dtype=ps.dtype, device=ps.device)
    out[..., _AXES[plane[0]]] = torch.sin(ps)
    out[..., _AXES[plane[1]]] = torch.cos(ps)
    return out


def interpolate(ps: torch.Tensor, ws: torch.Tensor,
                plane: str = "xz") -> torch.Tensor:
    """Weighted circular mean over axis 0."""
    dirs = torch.sum(to_directions(ps, plane) * ws[..., None], dim=0)
    return from_directions(dirs[None], plane)[0]
