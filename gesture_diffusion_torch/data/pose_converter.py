"""PoseTypeConverter: scaled representation -> dir-vec / euler.

Port of ``gesture_diffusion_tpu/data/pose_converter.py``, numpy in and
out: ctor ``(scaler_path, hierarchy_path, joint_names)``; ``angle_pairs``
(bone-index pairs for the beat metrics);
``scaled_{ortho6d,log_rot,euler}_to_dir_vec`` (inverse-standardise, then
representation -> euler -> FK -> unit bone directions, (N, T, B*3)) and
``scaled_{ortho6d,log_rot}_to_euler`` (euler degrees for BVH export).
The conversions run on the host in float32 through the port's torch
``ops/rotation.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import rotation as rot
from ..ops.scaler import StandardScaler
from .skeleton import Skeleton


def _f32(x: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


class PoseTypeConverter:
    def __init__(
        self,
        scaler_path: Optional[str],
        hierarchy_path: str,
        joint_names: Optional[Sequence[str]] = None,
    ):
        """:param joint_names: the subset of skeleton joints the pose vector
        covers, in pose-vector order.  Defaults to all non-end-site joints
        except the root (the BEAT configuration drops root translation and
        predicts rotations for the selected joints only)."""
        self.scaler = StandardScaler.load(scaler_path) if scaler_path else None
        self.skeleton = Skeleton.from_hierarchy_file(hierarchy_path)
        if joint_names is None:
            joint_names = [
                n for i, n in enumerate(self.skeleton.names)
                if not self.skeleton.is_end_site[i] and self.skeleton.parents[i] >= 0
            ]
        self.joint_names = list(joint_names)

    @property
    def angle_pairs(self) -> List[List[int]]:
        return self.skeleton.angle_pairs()

    # -- helpers -----------------------------------------------------------
    def _inverse_scale(self, x: np.ndarray) -> np.ndarray:
        if self.scaler is None:
            return np.asarray(x)
        shape = x.shape
        return self.scaler.inverse_transform(
            np.asarray(x).reshape(-1, shape[-1])).reshape(shape)

    def _euler_to_dir_vec(self, eulers: np.ndarray) -> np.ndarray:
        """(N, T, K, 3) euler degrees for the joint subset -> (N, T, B*3)."""
        full = self.skeleton.expand_rotations(eulers, self.joint_names)
        vec = self.skeleton.direction_vectors(full)
        return vec.reshape(*vec.shape[:-2], -1)

    # -- representation decoders ------------------------------------------
    def _unscaled_to_euler(self, pose: np.ndarray, representation: str) -> np.ndarray:
        """(N, T, C) unscaled -> (N, T, K, 3) euler degrees."""
        n, t, c = pose.shape
        if representation == "6d":
            o6 = _f32(pose.reshape(n, t, -1, 6))
            return rot.ortho6d_to_euler(o6).numpy()
        if representation == "log_rot":
            rv = _f32(pose.reshape(n, t, -1, 3))
            return rot.rotvec_to_euler(rv).numpy()
        if representation == "euler":
            return pose.reshape(n, t, -1, 3)
        raise ValueError(f"Unsupported pose representation: {representation}")

    # -- public API (reference call-site names) ---------------------------
    def scaled_ortho6d_to_dir_vec(self, pose: np.ndarray) -> np.ndarray:
        return self._euler_to_dir_vec(
            self._unscaled_to_euler(self._inverse_scale(pose), "6d"))

    def scaled_log_rot_to_dir_vec(self, pose: np.ndarray) -> np.ndarray:
        return self._euler_to_dir_vec(
            self._unscaled_to_euler(self._inverse_scale(pose), "log_rot"))

    def scaled_euler_to_dir_vec(self, pose: np.ndarray) -> np.ndarray:
        return self._euler_to_dir_vec(
            self._unscaled_to_euler(self._inverse_scale(pose), "euler"))

    def scaled_ortho6d_to_euler(self, pose: np.ndarray) -> np.ndarray:
        """(T, C) or (N, T, C) scaled -> same-rank euler degrees (flattened
        joint dim), for BVH export."""
        return self._to_euler_flat(pose, "6d")

    def scaled_log_rot_to_euler(self, pose: np.ndarray) -> np.ndarray:
        return self._to_euler_flat(pose, "log_rot")

    def _to_euler_flat(self, pose: np.ndarray, representation: str) -> np.ndarray:
        pose = np.asarray(pose)
        squeezed = pose.ndim == 2
        if squeezed:
            pose = pose[None]
        e = self._unscaled_to_euler(self._inverse_scale(pose), representation)
        e = e.reshape(*e.shape[:-2], -1)
        return e[0] if squeezed else e
