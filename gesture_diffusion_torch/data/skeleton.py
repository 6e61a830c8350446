"""Skeleton structure + batched forward kinematics.

Port of ``gesture_diffusion_tpu/data/skeleton.py``: one structure derived
from the hierarchy text (flat parent-index arrays, rest offsets) and a
matrix FK batched over (..., J, 3) euler frames.  Numpy in and out; the
local rotation matrices come from the port's torch ``ops/rotation.py`` in
float32 on the CPU, as the JAX package computes them in float32.

Rotation convention is the BVH/BEAT one: local R = Rx @ Ry @ Rz (intrinsic
XYZ, degrees), global R_g(j) = R_g(parent) @ R_local(j), position
p(j) = p(parent) + R_g(parent) @ offset(j).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import rotation as rot
from .bvh import BvhData, parse_bvh


@dataclasses.dataclass
class Skeleton:
    names: List[str]                  # file order, root first ("End Site" kept)
    parents: np.ndarray               # (J,) int, -1 for root
    offsets: np.ndarray               # (J, 3) float
    is_end_site: np.ndarray           # (J,) bool

    @classmethod
    def from_bvh(cls, data: BvhData) -> "Skeleton":
        names = list(data.joints)
        index = {n: i for i, n in enumerate(names)}
        parents = np.array([
            -1 if j.parent is None else index[j.parent]
            for j in data.joints.values()
        ])
        offsets = np.stack([j.offset for j in data.joints.values()])
        ends = np.array([j.is_end_site for j in data.joints.values()])
        return cls(names, parents, offsets, ends)

    @classmethod
    def from_hierarchy_file(cls, path: str) -> "Skeleton":
        return cls.from_bvh(parse_bvh(path))

    @property
    def n_joints(self) -> int:
        return len(self.names)

    def joint_index(self, name: str) -> int:
        return self.names.index(name)

    # ------------------------------------------------------------------
    def expand_rotations(
        self, eulers: np.ndarray, joint_names: Sequence[str]
    ) -> np.ndarray:
        """Scatter per-joint euler tracks for a SUBSET of joints into the
        full (..., J, 3) layout, zeros elsewhere.

        Replaces the reference's hand-coded zero-insertion index patterns
        for the 45/41-joint subsets (``vis_skeleton.py:164-204``): the
        mapping is derived from names, so any subset works.
        """
        eulers = np.asarray(eulers)
        *batch, k, three = eulers.shape
        assert k == len(joint_names) and three == 3, (
            f"expected (..., {len(joint_names)}, 3), got {eulers.shape}")
        full = np.zeros((*batch, self.n_joints, 3), eulers.dtype)
        for i, name in enumerate(joint_names):
            full[..., self.joint_index(name), :] = eulers[..., i, :]
        return full

    # ------------------------------------------------------------------
    def forward_kinematics(self, eulers_full: np.ndarray) -> np.ndarray:
        """(..., J, 3) euler degrees -> (..., J, 3) global positions.

        End sites have no channels; pass zeros in their slots (their local
        rotation is irrelevant — only the offset matters).
        """
        local = rot.euler_to_rotmat(torch.as_tensor(
            np.asarray(eulers_full), dtype=torch.float32)).numpy()  # (..., J, 3, 3)
        *batch, J, _, _ = local.shape
        glob = np.zeros_like(local)
        pos = np.zeros((*batch, J, 3), local.dtype)
        for j in range(J):
            p = self.parents[j]
            if p < 0:
                glob[..., j, :, :] = local[..., j, :, :]
                pos[..., j, :] = 0.0
            else:
                glob[..., j, :, :] = glob[..., p, :, :] @ local[..., j, :, :]
                pos[..., j, :] = pos[..., p, :] + np.einsum(
                    "...ij,j->...i", glob[..., p, :, :], self.offsets[j])
        return pos

    # ------------------------------------------------------------------
    def bones(self) -> List[Tuple[int, int]]:
        """(parent_idx, child_idx) for every non-root node, file order."""
        return [(int(self.parents[j]), j)
                for j in range(self.n_joints) if self.parents[j] >= 0]

    def direction_vectors(self, eulers_full: np.ndarray,
                          normalize: bool = True) -> np.ndarray:
        """(..., J, 3) euler degrees -> (..., B, 3) unit bone directions
        (child position - parent position), one per non-root node."""
        pos = self.forward_kinematics(eulers_full)
        pairs = self.bones()
        parents = np.array([p for p, _ in pairs])
        childs = np.array([c for _, c in pairs])
        vec = pos[..., childs, :] - pos[..., parents, :]
        if normalize:
            norm = np.linalg.norm(vec, axis=-1, keepdims=True)
            vec = vec / np.maximum(norm, 1e-8)
        return vec

    def angle_pairs(self) -> List[List[int]]:
        """Pairs of bone indices sharing a joint (parent bone, child bone) —
        the articulation angles consumed by the beat metrics
        (``models/eval_utils.py:24``)."""
        pairs = self.bones()
        bone_of_child = {c: i for i, (_, c) in enumerate(pairs)}
        out = []
        for i, (p, _) in enumerate(pairs):
            if p in bone_of_child:                 # parent joint is itself a child
                out.append([bone_of_child[p], i])
        return out
