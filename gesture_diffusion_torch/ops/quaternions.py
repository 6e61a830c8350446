"""Batched quaternion algebra as plain torch functions.

Port of ``gesture_diffusion_tpu/ops/quaternions.py``.  Quaternions are
(..., 4) tensors, scalar first (w, x, y, z); every function broadcasts over
leading dimensions, runs on the input's device and computes in the input's
dtype.  The mocap transforms hand them float32, as the JAX package
computes.

Conventions (the reference pymo class's):
  * ``qmul`` is the Hamilton product;
  * ``qlog`` / ``qexp`` use the half-angle convention (the log of a unit
    quaternion is axis * theta / 2), ``qlog`` unifying the pole (w >= 0)
    first;
  * ``slerp`` takes the short arc and falls back to lerp when
    1 - cos < 0.01;
  * ``from_euler`` / ``to_euler`` take any intrinsic (``world=False``) or
    extrinsic (``world=True``) Tait-Bryan order.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .rotation import rotmat_to_euler, rotmat_to_quat

_EPS = 1e-10

_AXES = {"x": 0, "y": 1, "z": 2}


def qid(shape=(), device=None) -> torch.Tensor:
    """Identity quaternion(s), (*shape, 4) float32, on ``device`` (the
    card by default)."""
    q = torch.zeros(tuple(shape) + (4,), device=resolve_device(device))
    q[..., 0] = 1.0
    return q


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ r, (..., 4) each."""
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    return torch.stack([
        qw * rw - qx * rx - qy * ry - qz * rz,
        qw * rx + qx * rw + qy * rz - qz * ry,
        qw * ry - qx * rz + qy * rw + qz * rx,
        qw * rz + qx * ry - qy * rx + qz * rw,
    ], dim=-1)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (the inverse of a unit quaternion)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(_norm(q, keepdim=True), min=_EPS)


def qabs(q: torch.Tensor) -> torch.Tensor:
    """Unify to the w >= 0 pole."""
    qn = qnormalize(q)
    return torch.where(qn[..., :1] < 0, -qn, qn)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qrotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4): the
    expansion of q ⊗ (0, v) ⊗ q*."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def qdot(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.sum(q * r, dim=-1)


def qlog(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3) half-angle log map."""
    n = qabs(q)
    im = n[..., 1:]
    lens = _norm(im)
    scale = torch.atan2(lens, n[..., 0]) / (lens + 1e-10)
    return im * scale[..., None]


def qexp(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) half-angle vectors -> (..., 4); |w| == 0 is pinned to 1e-3,
    as the reference does."""
    t = _norm(w)
    safe_t = torch.where(t == 0, torch.full_like(t, 1e-3), t)
    ls = torch.sin(safe_t) / safe_t
    q = torch.cat([torch.cos(safe_t)[..., None], w * ls[..., None]], dim=-1)
    return qnormalize(q)


def slerp(q0: torch.Tensor, q1: torch.Tensor, a) -> torch.Tensor:
    """Spherical interpolation along the short arc; ``a`` broadcasts
    against the quaternion batch shape."""
    a = torch.as_tensor(a, dtype=q0.dtype, device=q0.device)
    cos = torch.sum(q0 * q1, dim=-1)
    neg = cos < 0.0
    cos = torch.abs(cos)
    q1 = torch.where(neg[..., None], -q1, q1)

    linear = (1.0 - cos) < 0.01
    omega = torch.arccos(torch.clamp(
        torch.where(linear, torch.zeros_like(cos), cos), -1.0, 1.0))
    sinom = torch.clamp(torch.sin(omega), min=_EPS)
    w0 = torch.where(linear, 1.0 - a, torch.sin((1.0 - a) * omega) / sinom)
    w1 = torch.where(linear, a, torch.sin(a * omega) / sinom)
    return w0[..., None] * q0 + w1[..., None] * q1


def between(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """The quaternion rotating v0 onto v1."""
    a = _cross(v0, v1)
    w = (torch.sqrt(torch.sum(v0 ** 2, -1) * torch.sum(v1 ** 2, -1))
         + torch.sum(v0 * v1, -1))
    return qnormalize(torch.cat([w[..., None], a], dim=-1))


def from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Angles (...,) about axes (..., 3), each axis normalised with +1e-10."""
    axis = axis / (_norm(axis, keepdim=True) + 1e-10)
    half = angle / 2.0
    xyz = axis * torch.sin(half)[..., None]
    w = torch.cos(half)[..., None].expand(*xyz.shape[:-1], 1)
    return torch.cat([w, xyz], dim=-1)


def angle_axis(q: torch.Tensor):
    """(..., 4) -> (angles, axes); sin(angle / 2) == 0 is pinned to 1e-3,
    as the reference does."""
    n = qnormalize(q)
    s = torch.sqrt(torch.clamp(1.0 - n[..., 0] ** 2, min=0.0))
    s = torch.where(s == 0, torch.full_like(s, 1e-3), s)
    angles = 2.0 * torch.arccos(torch.clamp(n[..., 0], -1.0, 1.0))
    return angles, n[..., 1:] / s[..., None]


def _axis_quat(angle: torch.Tensor, axis_idx: int) -> torch.Tensor:
    half = angle / 2.0
    zero = torch.zeros_like(half)
    parts = [torch.cos(half), zero, zero, zero]
    parts[1 + axis_idx] = torch.sin(half)
    return torch.stack(parts, dim=-1)


def from_euler(es: torch.Tensor, order: str = "xyz",
               world: bool = False) -> torch.Tensor:
    """(..., 3) radians -> (..., 4).  world=False (intrinsic):
    q = q_{order[0]} ⊗ q_{order[1]} ⊗ q_{order[2]}; world=True reverses
    the composition."""
    q0 = _axis_quat(es[..., 0], _AXES[order[0].lower()])
    q1 = _axis_quat(es[..., 1], _AXES[order[1].lower()])
    q2 = _axis_quat(es[..., 2], _AXES[order[2].lower()])
    return qmul(q2, qmul(q1, q0)) if world else qmul(q0, qmul(q1, q2))


def to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def from_rotmat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4), w >= 0 (the branchless Shepperd of
    ``ops.rotation``)."""
    return rotmat_to_quat(m)


def to_euler(q: torch.Tensor, order: str = "xyz",
             degrees: bool = False) -> torch.Tensor:
    """(..., 4) -> (..., 3) intrinsic Tait-Bryan angles in the given order."""
    return rotmat_to_euler(to_rotmat(qnormalize(q)), degrees=degrees,
                           order=order.upper())


def average(qs: torch.Tensor) -> torch.Tensor:
    """Chordal L2 mean of (N, 4) quaternions: the eigenvector of the
    largest eigenvalue of sum q q^T.  Its sign is arbitrary (LAPACK and
    cuSOLVER may pick either)."""
    system = torch.einsum("ni,nj->ij", qs, qs)
    _, v = torch.linalg.eigh(system)
    return v[:, -1]


def interpolate(qs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Weighted blend in log space over axis 0."""
    logs = qlog(qs)
    mean = torch.sum(logs * ws[..., None], dim=0) / torch.sum(ws)
    return qexp(mean)
