"""Batched 3-D rotation conversions as plain torch functions.

Port of ``gesture_diffusion_tpu/ops/rotation.py``: every function takes
and returns tensors with any leading batch dims, on any device, and
computes in the input's dtype.  The data path hands them float32, as the
JAX package computes: the branch choices below (the Shepperd ``argmax``,
the unroll's ``d_swap < d_stay``) are discrete, and float64 would break
near-ties differently from the reference.

Conventions (the BVH/BEAT ones):
  * Euler order "XYZ" is *intrinsic* X-then-Y-then-Z:
    R = Rx(a) @ Ry(b) @ Rz(c) (scipy ``Rotation.from_euler("XYZ")``).
  * Ortho-6D (Zhou et al., eq. 14): the first two *columns* of R,
    flattened row-major as [m00, m01, m10, m11, m20, m21].
  * "Exponential map" / log-rot is the rotation vector axis*angle in
    radians.

The temporal unroll is a prefix parity: a frame's representation is
flipped iff an odd number of swap points precede it.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


# ---------------------------------------------------------------------------
# euler <-> rotation matrix
# ---------------------------------------------------------------------------

_AXIS_INDEX = {"X": 0, "Y": 1, "Z": 2}


def _parse_order(order: str):
    """'XYZ'-style intrinsic Tait-Bryan order -> (i, j, k, sign); sign is
    +1 for even permutations of (0, 1, 2), -1 for odd."""
    idx = tuple(_AXIS_INDEX[a] for a in order.upper())
    if len(idx) != 3 or len(set(idx)) != 3:
        raise ValueError(f"order must be a permutation of XYZ, got {order!r}")
    i, j, k = idx
    sign = 1.0 if (j - i) % 3 == 1 else -1.0
    return i, j, k, sign


def _rows(rows) -> torch.Tensor:
    """R rows of C (...,) tensors -> (..., R, C)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _axis_rotmat(angle: torch.Tensor, axis: int) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == 1:
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    else:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    return _rows(rows)


def euler_to_rotmat(euler: torch.Tensor, degrees: bool = True,
                    order: str = "XYZ") -> torch.Tensor:
    """(..., 3) intrinsic euler angles -> (..., 3, 3) rotation matrices."""
    e = torch.deg2rad(euler) if degrees else euler
    a, b, c = e[..., 0], e[..., 1], e[..., 2]
    if order.upper() != "XYZ":
        i, j, k, _ = _parse_order(order)
        return _axis_rotmat(a, i) @ _axis_rotmat(b, j) @ _axis_rotmat(c, k)
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    # R = Rx(a) @ Ry(b) @ Rz(c), expanded analytically
    return _rows([
        [cb * cc, -cb * sc, sb],
        [ca * sc + sa * sb * cc, ca * cc - sa * sb * sc, -sa * cb],
        [sa * sc - ca * sb * cc, sa * cc + ca * sb * sc, ca * cb],
    ])


def rotmat_to_euler(m: torch.Tensor, degrees: bool = True,
                    order: str = "XYZ") -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) intrinsic euler angles in the given order.

    For R = R_i(a) @ R_j(b) @ R_k(c) with Levi-Civita sign s:
    b = asin(s * m[i,k]); a = atan2(-s*m[j,k], m[k,k]);
    c = atan2(-s*m[i,j], m[i,i]).  Gimbal-locked matrices (|m[i,k]| ~ 1)
    put all twist into the first angle (c = 0), as scipy does."""
    i, j, k, s = _parse_order(order)
    b = torch.arcsin(torch.clamp(s * m[..., i, k], -1.0, 1.0))
    locked = torch.abs(m[..., i, k]) > 1.0 - 1e-7
    a = torch.where(
        locked,
        torch.atan2(s * m[..., k, j], m[..., j, j]),
        torch.atan2(-s * m[..., j, k], m[..., k, k]),
    )
    c = torch.where(locked, torch.zeros_like(b),
                    torch.atan2(-s * m[..., i, j], m[..., i, i]))
    e = torch.stack([a, b, c], dim=-1)
    return torch.rad2deg(e) if degrees else e


# ---------------------------------------------------------------------------
# ortho-6D (Zhou et al.)
# ---------------------------------------------------------------------------

def rotmat_to_ortho6d(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): first two columns, row-major interleaved."""
    return m[..., :, :2].reshape(*m.shape[:-2], 6)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=_EPS)


def ortho6d_to_rotmat(o6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) via Gram-Schmidt on the two raw columns."""
    cols = o6.reshape(*o6.shape[:-1], 3, 2)
    x_raw, y_raw = cols[..., 0], cols[..., 1]
    x = _normalize(x_raw)
    z = _normalize(torch.linalg.cross(x, y_raw, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def euler_to_ortho6d(euler: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    return rotmat_to_ortho6d(euler_to_rotmat(euler, degrees))


def ortho6d_to_euler(o6: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    return rotmat_to_euler(ortho6d_to_rotmat(o6), degrees)


# ---------------------------------------------------------------------------
# quaternion bridge (scalar-first, for stable log/exp maps)
# ---------------------------------------------------------------------------

def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) unit quaternion (w, x, y, z), w >= 0.

    Branchless Shepperd: all four candidate quaternions, then the one
    seeded by the largest diagonal combination (``argmax`` takes the first
    of equal seeds, as ``jnp.argmax`` does)."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    d21, d02, d10 = (m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1])
    s01, s02, s12 = (m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1])
    seeds = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                         1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    # each candidate is scaled by 4*component^2 (always >= 0)
    cases = _rows([
        [seeds[..., 0], d21, d02, d10],
        [d21, seeds[..., 1], s01, s02],
        [d02, s01, seeds[..., 2], s12],
        [d10, s02, s12, seeds[..., 3]],
    ])                                                     # (..., 4 cases, 4)
    best = torch.argmax(seeds, dim=-1)
    q = torch.gather(cases, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    q = _normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w,x,y,z) -> (..., 3) rotation vector, angle in [0, pi]."""
    # the w >= 0 pole first: for w < 0 the raw formula returns the long-way
    # vector with angle in (pi, 2pi]
    q = torch.where(q[..., :1] < 0, -q, q)
    w = q[..., 0]
    v = q[..., 1:]
    vnorm = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vnorm, w)
    # scale = angle / sin(angle/2); Taylor for small angles: 2 + angle^2/12
    small = vnorm < 1e-6
    scale = torch.where(small, 2.0 + angle * angle / 12.0,
                        angle / torch.where(small, torch.ones_like(vnorm), vnorm))
    return v * scale[..., None]


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _rows([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def rotvec_to_rotmat(rv: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vector -> (..., 3, 3) via Rodrigues; I + skew(rv)
    below an angle of 1e-8."""
    theta = torch.linalg.vector_norm(rv, dim=-1, keepdim=True)
    small = theta < 1e-8
    axis = rv / torch.where(small, torch.ones_like(theta), theta)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    t = theta[..., 0]
    c, s = torch.cos(t), torch.sin(t)
    C = 1.0 - c
    m = _rows([
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ])
    eye = torch.eye(3, dtype=m.dtype, device=m.device).expand(m.shape)
    return torch.where(small[..., None], eye + _skew(rv), m)


def rotmat_to_rotvec(m: torch.Tensor) -> torch.Tensor:
    return quat_to_rotvec(rotmat_to_quat(m))


# ---------------------------------------------------------------------------
# euler <-> expmap ("log_rot") and temporal unroll
# ---------------------------------------------------------------------------

def euler_to_rotvec(euler: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    """Reference ``euler2log_rot`` (``data_utils.py:101-107``)."""
    return rotmat_to_rotvec(euler_to_rotmat(euler, degrees))


def rotvec_to_euler(rv: torch.Tensor, degrees: bool = True) -> torch.Tensor:
    """Reference ``log_rot2euler`` (``data_utils.py:110-115``)."""
    return rotmat_to_euler(rotvec_to_rotmat(rv), degrees)


def unroll_rotvec(rv: torch.Tensor) -> torch.Tensor:
    """Temporal expmap unroll over axis -2 (time).

    (axis, theta) and (-axis, 2*pi - theta) encode the same rotation.  A
    swap point is a frame t where the flipped form of frame t+1 lies closer
    to frame t than its own form (full vector distance); a frame is flipped
    iff an odd number of swap points precede it.

    :param rv: (..., T, 3) per-joint rotation-vector tracks.
    :return: (..., T, 3) unrolled tracks encoding identical rotations.
    """
    ang = torch.linalg.vector_norm(rv, dim=-1)                  # (..., T)
    alt = 2.0 * math.pi - ang
    safe = torch.clamp(ang, min=_EPS)
    alt_rv = -rv / safe[..., None] * alt[..., None]             # flipped form
    d_stay = torch.linalg.vector_norm(rv[..., 1:, :] - rv[..., :-1, :], dim=-1)
    d_swap = torch.linalg.vector_norm(alt_rv[..., 1:, :] - rv[..., :-1, :],
                                      dim=-1)
    swap = (d_swap < d_stay).to(torch.int32)
    flips = torch.cat([torch.zeros_like(swap[..., :1]),
                       torch.cumsum(swap, dim=-1)], dim=-1)     # (..., T)
    return torch.where((flips % 2).bool()[..., None], alt_rv, rv)


def unroll_log_rot(rv: torch.Tensor) -> torch.Tensor:
    """Per-joint (T, 3) track unroll, under the reference's name."""
    return unroll_rotvec(rv)
