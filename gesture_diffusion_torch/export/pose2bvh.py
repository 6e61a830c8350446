"""Pose -> BVH export.

    python -m gesture_diffusion_torch.export.pose2bvh --sample-dir DIR \
        --bvh-dir OUT --hierarchy hierarchy_upper.txt [--filter]

Port of ``gesture_diffusion_tpu/export/pose2bvh.py`` (the reference's
``utils/pose2bvh.py:16-95``): prepend a constant root translation,
optionally low-pass the motion in unrolled expmap space (Butterworth,
cutoff 2 Hz, order 2, fs 18), and write the BVH with a hierarchy header
(either a template file's verbatim text — the reference's mode — or
regenerated from a parsed skeleton via ``data.bvh``).  Host work: numpy
and scipy, with the rotation conversions of the smoothing through the
port's torch ``ops/rotation.py`` on the CPU in float32, as the JAX package
computes them in float32.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np
import torch
from scipy.signal import butter, filtfilt

from ..ops import rotation as rot


def butter_lowpass_filter(data: np.ndarray, cutoff: float = 2.0,
                          fs: float = 18.0, order: int = 2) -> np.ndarray:
    normal_cutoff = cutoff / 0.5 / fs
    b, a = butter(order, normal_cutoff, btype="low", analog=False)
    return filtfilt(b, a, data)


def smooth_pose_euler(pose: np.ndarray) -> np.ndarray:
    """(T, J*3) euler degrees -> same, low-passed in unrolled expmap space
    (``pose2bvh.py:38-42``)."""
    t = len(pose)
    eul = torch.as_tensor(np.asarray(pose).reshape(t, -1, 3), dtype=torch.float32)
    rv = rot.unroll_rotvec(rot.euler_to_rotvec(eul).transpose(0, 1))  # (J, T, 3)
    rv = rv.transpose(0, 1).reshape(t, -1).numpy()
    filtered = np.stack([butter_lowpass_filter(track) for track in rv.T], axis=1)
    back = rot.rotvec_to_euler(torch.as_tensor(
        filtered.reshape(t, -1, 3), dtype=torch.float32)).numpy()
    return back.reshape(t, -1)


def pose2bvh(
    bvh_filepath: str,
    pose: np.ndarray,                         # (T, C) euler degrees
    hierarchy: "Sequence[str] | str",         # header lines or text
    fps: int = 20,
    root_translation: Sequence[float] = (0, 0, 0),
    filter: bool = False,
) -> None:
    if filter:
        pose = smooth_pose_euler(pose)
    n_frames = len(pose)
    translation = np.tile(np.asarray(root_translation, float)[None], (n_frames, 1))
    motion = np.concatenate([translation, pose], axis=1)
    if not isinstance(hierarchy, str):
        hierarchy = "".join(hierarchy)
    header = hierarchy + f"MOTION\nFrames: {n_frames}\nFrame Time: {1 / fps}"
    os.makedirs(os.path.dirname(bvh_filepath) or ".", exist_ok=True)
    np.savetxt(bvh_filepath, motion, header=header, comments="")


def pose2bvh_consistent(
    bvh_filepath: str,
    pose: np.ndarray,                         # (T, K*3) euler degrees, subset
    hierarchy_path: str,
    joint_names: Sequence[str],
    fps: int = 20,
    root_translation: Sequence[float] = (0, 0, 0),
    filter: bool = False,
) -> None:
    """Structurally valid BVH export for a joint SUBSET.

    The reference writes the subset's 126 columns under a header declaring
    156 channels (``pose2bvh.py:27-53`` + hierarchy_upper.txt) — its
    exported files cannot be parsed back.  Here the pose is scattered into
    the full hierarchy layout (zero rotations for non-predicted joints,
    channel order taken from the template) so every declared channel has a
    value.
    """
    from ..data.bvh import hierarchy_text, parse_bvh
    from ..data.skeleton import Skeleton

    if filter:
        pose = smooth_pose_euler(pose)
    data = parse_bvh(hierarchy_path)
    skeleton = Skeleton.from_bvh(data)
    t = len(pose)
    full = skeleton.expand_rotations(pose.reshape(t, -1, 3), list(joint_names))

    columns = []
    for joint, channel in data.channel_names:
        j = skeleton.joint_index(joint)
        if channel.endswith("position"):
            columns.append(np.full(t, root_translation["XYZ".index(channel[0])],
                                   dtype=float))
        else:
            columns.append(full[:, j, "XYZ".index(channel[0])])
    motion = np.stack(columns, axis=1)
    header = hierarchy_text(data) + \
        f"MOTION\nFrames: {t}\nFrame Time: {1 / fps}"
    os.makedirs(os.path.dirname(bvh_filepath) or ".", exist_ok=True)
    np.savetxt(bvh_filepath, motion, header=header, comments="")


def sample2bvh_batch(
    sample_dir_path: str,
    bvh_dir_path: str,
    hierarchy_path: str,
    filter: bool = False,
    wav_sr: int = 16000,
    joint_names: Optional[Sequence[str]] = None,
) -> List[str]:
    """Convert every sample_{i}.pkl ({"pose", "out", "wav"}) into gt/out BVH
    pairs + a wav file (``pose2bvh.py:56-84``).  With ``joint_names`` the
    structurally consistent exporter is used; without, the reference's
    verbatim-header mode."""
    from scipy.io import wavfile

    with open(hierarchy_path) as f:
        hierarchy = f.read()

    def export(path, pose, do_filter):
        if joint_names is not None:
            pose2bvh_consistent(path, pose, hierarchy_path, joint_names,
                                filter=do_filter)
        else:
            pose2bvh(path, pose, hierarchy, filter=do_filter)

    os.makedirs(bvh_dir_path, exist_ok=True)
    written = []
    for sample_path in sorted(glob.glob(os.path.join(sample_dir_path, "*.pkl"))):
        base = os.path.basename(sample_path)[:-len(".pkl")]
        with open(sample_path, "rb") as f:
            sample = pickle.load(f)
        gt_path = os.path.join(bvh_dir_path, base + "-gt.bvh")
        out_path = os.path.join(bvh_dir_path, base + "-out.bvh")
        export(gt_path, np.asarray(sample["pose"]), False)
        export(out_path, np.asarray(sample["out"]), filter)
        wav_path = os.path.join(bvh_dir_path, base + ".wav")
        wavfile.write(wav_path, wav_sr, np.asarray(sample["wav"]))
        written += [gt_path, out_path, wav_path]
    return written


def main(argv=None):
    from argparse import ArgumentParser

    p = ArgumentParser(description="Convert generated sample pickles to BVH.")
    p.add_argument("--sample-dir", type=str, required=True, metavar="PATH")
    p.add_argument("--bvh-dir", type=str, required=True, metavar="PATH")
    p.add_argument("--hierarchy", type=str, required=True, metavar="PATH")
    p.add_argument("--filter", action="store_true", default=False)
    args = p.parse_args(argv)
    sample2bvh_batch(args.sample_dir, args.bvh_dir, args.hierarchy, args.filter)


if __name__ == "__main__":
    main()
