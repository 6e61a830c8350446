"""Composable mocap transforms over :class:`BvhData` tracks.

Port of ``gesture_diffusion_tpu/data/mocap_transforms.py`` (the reference's
sklearn-style pymo suite, ``datasets/pymo/preprocessing.py:19-1320``).  Each
class keeps the fit / transform / inverse_transform protocol, so an sklearn
``Pipeline`` composes them unchanged (this module does not import sklearn).
The work is vectorised over frames, with no pandas and no per-frame loop.

Column model: a track's motion is a single (T, C) float64 array with
"{joint}_{channel}" names.  Transforms that add or remove channels rewrite
the channel table in place of the columns they consume, in the JAX
module's canonical order (file order).

Precision follows the JAX module exactly, which mixes float64 numpy with
float32 jnp.  The rotation math (``ops.rotation``, ``ops.quaternions``,
``ops.pivots``) runs in float32 torch on the transform's ``device`` (the
card unless the caller passes ``device="cpu"``): the float64 columns are
rounded to float32 where the JAX module hands them to a jnp op.  Everything
the JAX module computes in numpy stays float64 numpy on the host here: the
column bookkeeping, ``np.deg2rad`` before ``from_euler``, the float64
positions a joint's float32 offset is added to, the Gaussian smoothing and
the root integrations' ``np.cumsum`` (``_cumsum0``).  A float32 cumsum over
a 70 s recording drifts visibly from that; float64 rotation math would
break the discrete near-ties (Shepperd's ``argmax``, the unroll's swap
test, the gimbal test) the other way from the JAX package.

Reference defects reproduced deliberately, as the JAX module does:
  * ``RootCentricPositionNormalizer`` excludes joints by *substring* match on
    the root name, and its inverse shifts the root even though the transform
    never un-shifted it (``preprocessing.py:1043,1078``).
  * ``EulerReorder`` feeds X/Y/Z-ordered euler values into the joint's
    channel-order rotation composition (``preprocessing.py:494-495``), a
    distinction without effect on the XYZ-ordered BEAT data.
"""

from __future__ import annotations

import copy as _copy
from typing import Dict, Sequence

import numpy as np
import torch

from ..ops import pivots as piv
from ..ops import quaternions as quat
from ..ops import rotation as rot
from ..utils.device import resolve_device
from .bvh import BvhData

__all__ = [
    "MocapParameterizer", "Mirror", "EulerReorder", "JointSelector",
    "Numpyfier", "Slicer", "RootTransformer", "RootCentricPositionNormalizer",
    "Flattener", "ConstantsRemover", "ListStandardScaler", "ListMinMaxScaler",
    "DownSampler", "ReverseTime", "TemplateTransform",
]

_ROT_CHANNELS = ("Xrotation", "Yrotation", "Zrotation")
_POS_CHANNELS = ("Xposition", "Yposition", "Zposition")


# ---------------------------------------------------------------------------
# column helpers
# ---------------------------------------------------------------------------

def _columns(track: BvhData) -> "Dict[str, np.ndarray]":
    """Name -> (T,) column view, insertion-ordered."""
    return {f"{j}_{c}": track.values[:, i]
            for i, (j, c) in enumerate(track.channel_names)}


def _rebuild(track: BvhData, cols: "Dict[str, np.ndarray]") -> BvhData:
    """New track with the given named columns (dict order = column order)."""
    new = track.clone()
    names = list(cols)
    new.channel_names = [tuple(n.rsplit("_", 1)) for n in names]
    if names:
        new.values = np.stack([np.asarray(cols[n], dtype=np.float64)
                               for n in names], axis=1)
    else:
        new.values = np.zeros((track.n_frames, 0))
    return new


def _has_rotations(cols, joint) -> bool:
    return all(f"{joint}_{c}" in cols for c in _ROT_CHANNELS)


def _rot_order(track: BvhData, joint: str) -> str:
    order = track.joints[joint].order
    return order if len(order) == 3 else "XYZ"


def _euler_deg(cols, joint: str, order: str) -> np.ndarray:
    """(T, 3) euler degrees in the joint's channel order."""
    return np.stack([cols[f"{joint}_{a}rotation"] for a in order], axis=1)


def _cumsum0(x: np.ndarray) -> np.ndarray:
    """[0, x[1], x[1] + x[2], ...]: the root integrations (numpy, in x's
    dtype, as the JAX module sums)."""
    return np.concatenate([[0.0], np.cumsum(x[1:])])


class _OnDevice:
    """The device the rotation math runs on, and the two crossings: numpy
    into float32 on the device (where the JAX module hands an array to a
    jnp op) and back."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device, torch.float32)

    @staticmethod
    def _np(x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy()


# ---------------------------------------------------------------------------
# MocapParameterizer — preprocessing.py:19-354
# ---------------------------------------------------------------------------

class MocapParameterizer(_OnDevice):
    """param_type in {'euler', 'expmap', 'position', 'expmap2pos'}; 'quat'
    passes through, as 'euler' does."""

    def __init__(self, param_type: str = "euler", device=None):
        super().__init__(device)
        self.param_type = param_type

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        if self.param_type in ("euler", "quat"):
            return X
        if self.param_type == "expmap":
            return [self._to_expmap(t) for t in X]
        if self.param_type == "position":
            return [self._to_pos(t) for t in X]
        if self.param_type == "expmap2pos":
            return [self._expmap_to_pos(t) for t in X]
        raise ValueError(
            f"param types: euler, quat, expmap, position, expmap2pos; "
            f"got {self.param_type!r}")

    def inverse_transform(self, X, copy=None):
        if self.param_type in ("euler", "position"):
            return X      # the reference prints 'positions 2 eulers is not supported'
        if self.param_type == "expmap":
            return [self._expmap_to_euler(t) for t in X]
        raise ValueError(f"cannot invert param type {self.param_type!r}")

    # -- euler -> expmap (ref _to_expmap, :257-308) ----------------------
    def _to_expmap(self, track: BvhData) -> BvhData:
        cols = _columns(track)
        out: Dict[str, np.ndarray] = {}
        done = set()
        for name in cols:
            joint, chan = name.rsplit("_", 1)
            if (chan not in _ROT_CHANNELS or "Nub" in joint
                    or not _has_rotations(cols, joint)):
                out[name] = cols[name]
                continue
            if joint in done:
                continue
            done.add(joint)
            # the first rotation channel of a full triple: alpha/beta/gamma
            # go here, in place of the three euler columns
            order = _rot_order(track, joint)
            e = self._t(_euler_deg(cols, joint, order))
            rv = self._np(rot.unroll_rotvec(rot.rotmat_to_rotvec(
                rot.euler_to_rotmat(e, degrees=True, order=order))))
            out[f"{joint}_alpha"] = rv[:, 0]
            out[f"{joint}_beta"] = rv[:, 1]
            out[f"{joint}_gamma"] = rv[:, 2]
        return _rebuild(track, out)

    # -- expmap -> euler (ref _expmap_to_euler, :310-354) ----------------
    def _expmap_to_euler(self, track: BvhData) -> BvhData:
        cols = _columns(track)
        out: Dict[str, np.ndarray] = {}
        for name in cols:
            joint, chan = name.rsplit("_", 1)
            if chan == "alpha" and "Nub" not in joint:
                order = _rot_order(track, joint)
                rv = np.stack([cols[f"{joint}_{p}"]
                               for p in ("alpha", "beta", "gamma")], axis=1)
                e = self._np(rot.rotmat_to_euler(
                    rot.rotvec_to_rotmat(self._t(rv)), degrees=True, order=order))
                for i, axis in enumerate(order):
                    out[f"{joint}_{axis}rotation"] = e[:, i]
            elif chan in ("alpha", "beta", "gamma") and "Nub" not in joint:
                continue
            else:
                out[name] = cols[name]
        return _rebuild(track, out)

    # -- euler -> positions (ref _to_pos, :61-149) -----------------------
    def _to_pos(self, track: BvhData) -> BvhData:
        cols = _columns(track)
        T = track.n_frames
        g_quat: Dict[str, torch.Tensor] = {}
        g_pos: Dict[str, np.ndarray] = {}
        out: Dict[str, np.ndarray] = {}
        for joint, info in track.joints.items():   # file order == DFS order
            if _has_rotations(cols, joint):
                order = _rot_order(track, joint)
                e = np.deg2rad(_euler_deg(cols, joint, order))
            else:
                order = "XYZ"
                e = np.zeros((T, 3))
            q = quat.from_euler(self._t(e), order.lower(), world=False)
            if all(f"{joint}_{c}" in cols for c in _POS_CHANNELS):
                p = np.stack([cols[f"{joint}_{c}"] for c in _POS_CHANNELS], axis=1)
            else:
                p = np.zeros((T, 3))
            if info.parent is None:
                # ref :123-126: the root's position channels as they are,
                # no offset
                g_quat[joint] = q
                g_pos[joint] = p
            else:
                pq = g_quat[info.parent]
                g_quat[joint] = quat.qmul(pq, q)
                k = p + info.offset
                g_pos[joint] = g_pos[info.parent] + self._np(
                    quat.qrotate(pq, self._t(k)))
            for i, c in enumerate(_POS_CHANNELS):
                out[f"{joint}_{c}"] = g_pos[joint][:, i]
        return _rebuild(track, out)

    # -- expmap -> positions (ref _expmap_to_pos, :180-255) --------------
    def _expmap_to_pos(self, track: BvhData) -> BvhData:
        """The reference's matrix FK, bug for bug: globals composed
        REVERSED (G_j = R_j @ G_parent) and offsets rotated as row vectors
        (``preprocessing.py:235-241``), which applies every local rotation
        inverted; it is the documented behaviour of 'expmap2pos'.  Each
        joint's expmap columns are matched by exact name, where the
        reference matches by substring (``preprocessing.py:212``) and so
        reads the wrong joint for Spine / Spine1, Head / HeadEnd, ...  The
        products are numpy's, in float32 and float64, as in JAX."""
        cols = _columns(track)
        T = track.n_frames
        g_mat: Dict[str, np.ndarray] = {}
        g_pos: Dict[str, np.ndarray] = {}
        out: Dict[str, np.ndarray] = {}
        for joint, info in track.joints.items():
            if "Nub" not in joint and f"{joint}_alpha" in cols:
                rv = np.stack([cols[f"{joint}_{p}"]
                               for p in ("alpha", "beta", "gamma")], axis=1)
            else:
                rv = np.zeros((T, 3))
            R = self._np(rot.rotvec_to_rotmat(self._t(rv)))
            if info.parent is None:
                g_mat[joint] = R
                g_pos[joint] = np.zeros((T, 3))    # ref :227-232: root at origin
            else:
                Gp = g_mat[info.parent]
                g_mat[joint] = np.einsum("tij,tjk->tik", R, Gp)
                q = np.einsum("j,tjk->tk", info.offset, Gp)
                g_pos[joint] = g_pos[info.parent] + q
            for i, c in enumerate(_POS_CHANNELS):
                out[f"{joint}_{c}"] = g_pos[joint][:, i]
        return _rebuild(track, out)


# ---------------------------------------------------------------------------
# Mirror — preprocessing.py:356-449
# ---------------------------------------------------------------------------

class Mirror:
    """Mirror about a world axis, swapping Left*/Right* joint tracks.

    ``append=True`` (the reference default) returns the originals followed
    by the mirrored copies.  Output columns: the root positions and all
    non-Nub X/Y/Zrotation channels (the reference drops any other)."""

    def __init__(self, axis: str = "X", append: bool = True):
        self.axis = axis
        self.append = append

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        signs = {"X": np.array([1.0, -1.0, -1.0]),
                 "Y": np.array([-1.0, 1.0, -1.0]),
                 "Z": np.array([-1.0, -1.0, 1.0])}[self.axis]
        Q = list(X) if self.append else []
        for track in X:
            cols = _columns(track)
            root = track.root_name
            out: Dict[str, np.ndarray] = {}
            for i, c in enumerate(_POS_CHANNELS):
                out[f"{root}_{c}"] = -signs[i] * cols[f"{root}_{c}"]
            swap = {}
            for joint in track.joints:
                if "Nub" in joint or not _has_rotations(cols, joint):
                    continue
                if "Left" in joint:
                    swap[joint] = joint.replace("Left", "Right")
                elif "Right" in joint:
                    swap[joint] = joint.replace("Right", "Left")
                else:
                    swap[joint] = joint
            for joint, src in swap.items():
                for i, c in enumerate(_ROT_CHANNELS):
                    out[f"{joint}_{c}"] = signs[i] * cols[f"{src}_{c}"]
            Q.append(_rebuild(track, out))
        return Q

    def inverse_transform(self, X, copy=None, start_pos=None):
        return X


# ---------------------------------------------------------------------------
# EulerReorder — preprocessing.py:451-557
# ---------------------------------------------------------------------------

class EulerReorder(_OnDevice):
    """Re-express every joint's euler triple in a new rotation order."""

    def __init__(self, new_order: str, device=None):
        super().__init__(device)
        self.new_order = new_order

    def fit(self, X, y=None):
        self.orig_skeleton = _copy.deepcopy(X[0].joints)
        return self

    def transform(self, X, y=None):
        Q = []
        for track in X:
            cols = _columns(track)
            out: Dict[str, np.ndarray] = {}
            new = track.clone()
            done = set()
            for name in cols:
                joint, chan = name.rsplit("_", 1)
                if (chan not in _ROT_CHANNELS or "Nub" in joint
                        or not _has_rotations(cols, joint)):
                    out[name] = cols[name]
                    continue
                if joint in done:
                    continue
                done.add(joint)
                order = _rot_order(track, joint)
                # bug-compat (ref :494): values read in X, Y, Z column order
                # but composed as angles about order[0..2]
                e_xyz = np.stack([cols[f"{joint}_{a}rotation"] for a in "XYZ"],
                                 axis=1)
                if order == self.new_order:
                    e_new = e_xyz
                else:
                    m = rot.euler_to_rotmat(self._t(e_xyz), degrees=True,
                                            order=order)
                    e_new = self._np(rot.rotmat_to_euler(
                        m, degrees=True, order=self.new_order))
                for i, axis in enumerate(self.new_order):
                    out[f"{joint}_{axis}rotation"] = e_new[:, i]
                new.joints[joint].order = self.new_order
                rot_seq = iter(self.new_order)
                new.joints[joint].channels = [
                    f"{next(rot_seq)}rotation" if c in _ROT_CHANNELS else c
                    for c in new.joints[joint].channels]
            rebuilt = _rebuild(track, out)
            rebuilt.joints = new.joints
            Q.append(rebuilt)
        return Q

    def inverse_transform(self, X, copy=None, start_pos=None):
        return X


# ---------------------------------------------------------------------------
# JointSelector — preprocessing.py:559-612
# ---------------------------------------------------------------------------

class JointSelector:
    """Keep only the named joints' channels, with an inverse_transform that
    restores the dropped channels at their first-frame values."""

    def __init__(self, joints: Sequence[str], include_root: bool = False):
        self.joints = list(joints)
        self.include_root = include_root

    def fit(self, X, y=None):
        t0 = X[0]
        selected = ([t0.root_name] if self.include_root else []) + self.joints
        self.selected_joints = selected
        self.selected_channels = [
            f"{j}_{c}" for j, c in t0.channel_names
            if j in selected and "Nub" not in j]
        cols = _columns(t0)
        self.not_selected = [n for n in cols if n not in self.selected_channels]
        self.not_selected_values = {n: float(cols[n][0]) for n in self.not_selected}
        self.orig_skeleton = _copy.deepcopy(t0.joints)
        return self

    def transform(self, X, y=None):
        Q = []
        for track in X:
            cols = _columns(track)
            out = {n: cols[n] for n in self.selected_channels}
            t2 = _rebuild(track, out)
            t2.joints = {k: v for k, v in track.clone().joints.items()
                         if k in self.selected_joints}
            for j in t2.joints.values():
                j.children = [c for c in j.children if c in t2.joints]
            Q.append(t2)
        return Q

    def inverse_transform(self, X, copy=None):
        Q = []
        for track in X:
            cols = _columns(track)
            T = track.n_frames
            for n in self.not_selected:
                cols[n] = np.full(T, self.not_selected_values[n])
            t2 = _rebuild(track, cols)
            t2.joints = _copy.deepcopy(self.orig_skeleton)
            Q.append(t2)
        return Q


# ---------------------------------------------------------------------------
# Numpyfier / Slicer — preprocessing.py:615-707
# ---------------------------------------------------------------------------

class Numpyfier:
    def fit(self, X, y=None):
        self.org_mocap_ = X[0].clone()
        self.org_mocap_.values = self.org_mocap_.values[:0]
        return self

    def transform(self, X, y=None):
        return np.array([t.values for t in X])

    def inverse_transform(self, X, copy=None):
        Q = []
        for arr in X:
            t = self.org_mocap_.clone()
            t.values = np.asarray(arr)
            Q.append(t)
        return Q


class Slicer(Numpyfier):
    """Overlapping fixed-size windows over each track."""

    def __init__(self, window_size: int, overlap: float = 0.5):
        self.window_size = window_size
        self.overlap = overlap

    def transform(self, X, y=None):
        Q = []
        for track in X:
            vals = track.values
            overlap_frames = int(self.overlap * self.window_size)
            step = self.window_size - overlap_frames
            n = (vals.shape[0] - overlap_frames) // step
            for i in range(max(n, 0)):
                Q.append(vals[i * step:i * step + self.window_size])
        return np.array(Q)


# ---------------------------------------------------------------------------
# RootTransformer — preprocessing.py:709-1017
# ---------------------------------------------------------------------------

def _gaussian_smooth(x: np.ndarray, sigma: float) -> np.ndarray:
    from scipy.ndimage import gaussian_filter1d
    return gaussian_filter1d(x, sigma, axis=0, mode="nearest")


class RootTransformer(_OnDevice):
    """Root-trajectory re-parameterisations (the reference's spelling,
    'abdolute' included, so configs written against it keep working):
      * 'abdolute_translation_deltas': x/z positions -> frame deltas;
      * 'pos_rot_deltas': heading-normalised pose plus planar velocity and
        angular-velocity channels (Holden-style);
      * 'hip_centric': the root trajectory zeroed."""

    def __init__(self, method: str, position_smoothing: float = 0,
                 rotation_smoothing: float = 0, device=None):
        super().__init__(device)
        self.method = method
        self.position_smoothing = position_smoothing
        self.rotation_smoothing = rotation_smoothing

    def fit(self, X, y=None):
        return self

    # ------------------------------------------------------------------
    def transform(self, X, y=None):
        return [self._forward(t) for t in X]

    def _forward(self, track: BvhData) -> BvhData:
        root = track.root_name
        cols = _columns(track)
        xp, yp, zp = (f"{root}_{c}" for c in _POS_CHANNELS)

        if self.method == "abdolute_translation_deltas":
            out = dict(cols)
            x, z = cols[xp], cols[zp]
            if self.position_smoothing > 0:
                x_sm = _gaussian_smooth(x, self.position_smoothing)
                z_sm = _gaussian_smooth(z, self.position_smoothing)
                dx = np.diff(x_sm, prepend=x_sm[0])
                dz = np.diff(z_sm, prepend=z_sm[0])
                out[xp] = x - x_sm
                out[zp] = z - z_sm
            else:
                dx = np.diff(x, prepend=x[0])
                dz = np.diff(z, prepend=z[0])
                out.pop(xp)
                out.pop(zp)
            if len(dx) > 1:                     # ref :753: the first delta
                dx[0] = dx[1]                   # copied (guarded: the
                dz[0] = dz[1]                   # reference fails on 1 frame)
            out[f"{root}_dXposition"] = dx
            out[f"{root}_dZposition"] = dz
            return _rebuild(track, out)

        if self.method == "pos_rot_deltas":
            order = _rot_order(track, root)
            positions = np.stack([cols[xp], cols[yp], cols[zp]], axis=1)
            rotations = np.deg2rad(_euler_deg(cols, root, order))
            quats = quat.from_euler(self._t(rotations), order.lower(),
                                    world=False)

            reference = positions * np.array([1.0, 0.0, 1.0])
            if self.position_smoothing > 0:
                reference = _gaussian_smooth(reference, self.position_smoothing)
            velocity = np.diff(reference, axis=0)
            velocity = np.vstack([velocity[:1], velocity])

            positions = positions - reference

            forward = self._np(quat.qrotate(quats, self._t([0.0, 0.0, 1.0])))
            forward[:, 1] = 0.0
            if self.rotation_smoothing > 0:
                forward = _gaussian_smooth(forward, self.rotation_smoothing)
            forward = forward / np.linalg.norm(forward, axis=-1, keepdims=True)

            target = np.tile(np.array([0.0, 0.0, 1.0]), (len(forward), 1))
            rotation = quat.between(self._t(target), self._t(forward))
            inv = quat.qinv(rotation)
            positions = self._np(quat.qrotate(inv, self._t(positions)))
            new_rotations = quat.qmul(inv, quats)
            velocity = self._np(quat.qrotate(inv, self._t(velocity)))
            rvel = self._np(piv.from_quaternions(
                quat.qmul(rotation[1:], quat.qinv(rotation[:-1]))))
            rvel = np.concatenate([rvel[:1], rvel])

            eulers = np.rad2deg(self._np(rot.rotmat_to_euler(
                quat.to_rotmat(quat.qnormalize(new_rotations)),
                degrees=False, order=order)))

            out = dict(cols)
            out[xp], out[yp], out[zp] = positions.T
            out[f"{root}_dXposition"] = velocity[:, 0]
            out[f"{root}_dZposition"] = velocity[:, 2]
            for i, axis in enumerate(order):
                out[f"{root}_{axis}rotation"] = eulers[:, i]
            out[f"{root}_dYrotation"] = rvel
            return _rebuild(track, out)

        if self.method == "hip_centric":
            out = dict(cols)
            zeros = np.zeros(track.n_frames)
            for c in _POS_CHANNELS + _ROT_CHANNELS:
                name = f"{root}_{c}"
                if name in out:
                    out[name] = zeros
            return _rebuild(track, out)

        raise ValueError(f"unknown RootTransformer method {self.method!r}")

    # ------------------------------------------------------------------
    def inverse_transform(self, X, copy=None, start_pos=None):
        startx, startz = (0.0, 0.0) if start_pos is None else start_pos
        return [self._backward(t, startx, startz) for t in X]

    def _backward(self, track: BvhData, startx: float, startz: float) -> BvhData:
        root = track.root_name
        cols = _columns(track)
        xp, yp, zp = (f"{root}_{c}" for c in _POS_CHANNELS)

        if self.method == "abdolute_translation_deltas":
            # ref :919-924: the deltas integrated, the duplicated first
            # one skipped
            recx = startx + _cumsum0(cols[f"{root}_dXposition"])
            recz = startz + _cumsum0(cols[f"{root}_dZposition"])
            out = dict(cols)
            if self.position_smoothing > 0:
                out[xp] = cols[xp] + recx
                out[zp] = cols[zp] + recz
            else:
                out[xp] = recx
                out[zp] = recz
            out.pop(f"{root}_dXposition")
            out.pop(f"{root}_dZposition")
            return _rebuild(track, out)

        if self.method == "pos_rot_deltas":
            order = _rot_order(track, root)
            positions = np.stack([cols[xp], cols[yp], cols[zp]], axis=1)
            rotations = np.deg2rad(_euler_deg(cols, root, order))
            quats = quat.from_euler(self._t(rotations), order.lower(),
                                    world=False)
            dx = cols[f"{root}_dXposition"]
            dz = cols[f"{root}_dZposition"]
            dry = cols[f"{root}_dYrotation"]

            # ref :980-987: every increment turns about the fixed y axis,
            # so the cumulative quaternion is that of the cumulative angle
            rec_ry = quat.from_angle_axis(self._t(_cumsum0(dry)),
                                          self._t([0.0, 1.0, 0.0]))
            dp = self._np(quat.qrotate(
                rec_ry, self._t(np.stack([dx, np.zeros_like(dx), dz], axis=1))))
            rec_xp = _cumsum0(dp[:, 0])
            rec_zp = _cumsum0(dp[:, 2])

            rec_r = quat.qmul(rec_ry, quats)
            pp = self._np(quat.qrotate(rec_ry, self._t(positions)))
            rec_xp = rec_xp + pp[:, 0]
            rec_zp = rec_zp + pp[:, 2]
            eulers = np.rad2deg(self._np(rot.rotmat_to_euler(
                quat.to_rotmat(quat.qnormalize(rec_r)),
                degrees=False, order=order)))

            out = dict(cols)
            out[xp] = rec_xp
            out[zp] = rec_zp
            for i, axis in enumerate(order):
                out[f"{root}_{axis}rotation"] = eulers[:, i]
            out.pop(f"{root}_dYrotation")
            out.pop(f"{root}_dXposition")
            out.pop(f"{root}_dZposition")
            return _rebuild(track, out)

        return track


# ---------------------------------------------------------------------------
# RootCentricPositionNormalizer — preprocessing.py:1020-1088
# ---------------------------------------------------------------------------

def _floor_projection(track: BvhData, cols) -> np.ndarray:
    root = track.root_name
    return np.stack([cols[f"{root}_Xposition"], np.zeros(track.n_frames),
                     cols[f"{root}_Zposition"]], axis=1)


class RootCentricPositionNormalizer:
    """Subtract the root's floor projection from every other joint position."""

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        Q = []
        for track in X:
            root = track.root_name
            cols = _columns(track)
            proj = _floor_projection(track, cols)
            out: Dict[str, np.ndarray] = {}
            # bug-compat (ref :1043): substring exclusion, so any joint whose
            # name CONTAINS the root's keeps absolute coordinates
            for joint in track.joints:
                if root in joint:
                    continue
                for i, c in enumerate(_POS_CHANNELS):
                    out[f"{joint}_{c}"] = cols[f"{joint}_{c}"] - proj[:, i]
            for c in _POS_CHANNELS:
                out[f"{root}_{c}"] = cols[f"{root}_{c}"]
            Q.append(_rebuild(track, out))
        return Q

    def inverse_transform(self, X, copy=None):
        Q = []
        for track in X:
            cols = _columns(track)
            proj = _floor_projection(track, cols)
            # bug-compat (ref :1078): the inverse shifts EVERY joint, the
            # root the transform left absolute included
            out = {f"{joint}_{c}": cols[f"{joint}_{c}"] + proj[:, i]
                   for joint in track.joints
                   for i, c in enumerate(_POS_CHANNELS)}
            Q.append(_rebuild(track, out))
        return Q


# ---------------------------------------------------------------------------
# array-level transforms — preprocessing.py:1090-1319
# ---------------------------------------------------------------------------

class Flattener:
    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        return np.concatenate(X, axis=0)


class ConstantsRemover:
    """Drop the columns whose std over the FIRST track (ddof=1, as pandas)
    is below eps; the inverse restores them at their first-frame values."""

    def __init__(self, eps: float = 1e-6):
        self.eps = eps

    def fit(self, X, y=None):
        t0 = X[0]
        cols = _columns(t0)
        # pandas' std of a single row is NaN and "NaN < eps" is False: the
        # reference KEEPS every column of a 1-frame track
        stds = {n: (np.std(v, ddof=1) if len(v) > 1 else np.nan)
                for n, v in cols.items()}
        self.const_dims_ = [n for n, s in stds.items() if s < self.eps]
        self.const_values_ = {n: float(cols[n][0]) for n in self.const_dims_}
        return self

    def transform(self, X, y=None):
        Q = []
        for track in X:
            cols = _columns(track)
            out = {n: v for n, v in cols.items() if n not in self.const_dims_}
            Q.append(_rebuild(track, out))
        return Q

    def inverse_transform(self, X, copy=None):
        Q = []
        for track in X:
            cols = _columns(track)
            for n in self.const_dims_:
                cols[n] = np.full(track.n_frames, self.const_values_[n])
            Q.append(_rebuild(track, cols))
        return Q


class _ListScalerBase:
    """Fit and apply over lists of arrays or BvhData tracks (the
    reference's is_DataFrame flag, by type)."""

    def __init__(self, is_DataFrame: bool = False):
        self.is_DataFrame = is_DataFrame   # kept for the reference's signature

    def _flat(self, X) -> np.ndarray:
        return np.concatenate(
            [t.values if isinstance(t, BvhData) else np.asarray(t) for t in X],
            axis=0)

    def _apply(self, X, fn):
        Q = []
        for t in X:
            if isinstance(t, BvhData):
                t2 = t.clone()
                t2.values = fn(t.values)
                Q.append(t2)
            else:
                Q.append(fn(np.asarray(t)))
        if any(isinstance(t, BvhData) for t in X):
            return Q
        if len({q.shape for q in Q}) == 1:
            return np.array(Q)
        return Q        # ragged track lengths stay a list


class ListStandardScaler(_ListScalerBase):
    def fit(self, X, y=None):
        flat = self._flat(X)
        self.data_mean_ = np.mean(flat, axis=0)
        self.data_std_ = np.std(flat, axis=0)
        return self

    def transform(self, X, y=None):
        return self._apply(X, lambda v: (v - self.data_mean_) / self.data_std_)

    def inverse_transform(self, X, copy=None):
        return self._apply(X, lambda v: v * self.data_std_ + self.data_mean_)


class ListMinMaxScaler(_ListScalerBase):
    def fit(self, X, y=None):
        flat = self._flat(X)
        self.data_max_ = np.max(flat, axis=0)
        self.data_min_ = np.min(flat, axis=0)
        return self

    def transform(self, X, y=None):
        rng = self.data_max_ - self.data_min_
        return self._apply(X, lambda v: (v - self.data_min_) / rng)

    def inverse_transform(self, X, copy=None):
        rng = self.data_max_ - self.data_min_
        return self._apply(X, lambda v: v * rng + self.data_min_)


class DownSampler:
    """Integer-stride fps downsampling (the final frame dropped, as the
    reference's ``[ii:-1:rate]`` slice drops it); ``keep_all=True`` emits
    every phase offset as a track of its own."""

    def __init__(self, tgt_fps: int, keep_all: bool = False):
        self.tgt_fps = tgt_fps
        self.keep_all = keep_all

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        Q = []
        for track in X:
            orig_fps = round(1.0 / track.framerate)
            rate = orig_fps // self.tgt_fps
            if orig_fps % self.tgt_fps != 0:
                raise ValueError(
                    f"orig fps {orig_fps} not divisible by target {self.tgt_fps}")
            for ii in range(rate):
                t2 = track.clone()
                t2.values = track.values[ii:-1:rate].copy()
                t2.framerate = 1.0 / self.tgt_fps
                Q.append(t2)
                if not self.keep_all:
                    break
        return Q

    def inverse_transform(self, X, copy=None):
        return X


class ReverseTime:
    def __init__(self, append: bool = True):
        self.append = append

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        Q = list(X) if self.append else []
        for track in X:
            t2 = track.clone()
            t2.values = track.values[::-1].copy()
            Q.append(t2)
        return Q

    def inverse_transform(self, X, copy=None):
        return X


class TemplateTransform:
    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        return X
