"""Skeleton visualisation: stick-figure stills and animations.

Port of ``gesture_diffusion_tpu/export/vis_skeleton.py``: the node tree, FK
and zero-insertion for joint subsets all come from the port's
``data.Skeleton`` (derived from the hierarchy text).  ``draw_stickfigure``
and ``draw_stickfigure3d`` draw one frame of a position-parameterised
track (``data.mocap_transforms.MocapParameterizer('position')`` output).

Output formats: .mp4 and .avi write video WITH the speech audio muxed in
(the muxers of ``export/mp4.py`` and ``export/avi.py``, no ffmpeg); .gif
uses the pillow writer; any other path gets a directory of PNG frames.  For
the other outputs audio is written alongside as .wav.  The renderers need
matplotlib (and Pillow for JPEG frames and GIFs), imported when called:
``pose_to_positions`` needs neither.  The stick figures force no
matplotlib backend: they return axes for interactive or notebook display.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..data.skeleton import Skeleton


def pose_to_positions(
    skeleton: Skeleton,
    pose_euler: np.ndarray,               # (T, K*3) euler degrees, subset
    joint_names: Sequence[str],
) -> np.ndarray:
    """(T, K*3) -> (T, J, 3) global positions (zeros scattered into
    non-predicted joints, replacing ``vis_skeleton.py:149-204``)."""
    t = len(pose_euler)
    eul = skeleton.expand_rotations(
        pose_euler.reshape(t, -1, 3), list(joint_names))
    return skeleton.forward_kinematics(eul)


def plot_skeleton(positions: np.ndarray, skeleton: Skeleton,
                  output_path: str = "skeleton.jpg", lim: float = 100.0) -> None:
    """positions: (J, 3) one frame -> matplotlib 3-D scatter + bones."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(dpi=150)
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(positions[:, 0], positions[:, 2], zs=positions[:, 1], s=2)
    for p, c in skeleton.bones():
        ax.plot([positions[p, 0], positions[c, 0]],
                [positions[p, 2], positions[c, 2]],
                [positions[p, 1], positions[c, 1]], c="blue", linewidth=0.5)
    ax.set_xlabel("x"); ax.set_ylabel("z"); ax.set_zlabel("y")
    ax.set_xlim(-lim, lim); ax.set_ylim(lim, -lim); ax.set_zlim(-lim, lim)
    plt.savefig(output_path)
    plt.close(fig)


def make_skeleton_video(
    positions: np.ndarray,                # (T, J, 3)
    skeleton: Skeleton,
    output_path: str,
    fps: int = 20,
    wav: Optional[np.ndarray] = None,
    wav_sr: int = 16000,
    lim: float = 100.0,
) -> str:
    """Animate the skeleton.  .mp4 and .avi mux the audio into the file
    (MJPEG + PCM; .mp4 is the reference's container,
    ``vis_skeleton.py:283-339``, written by the native ISO-BMFF muxer in
    export/mp4.py — no ffmpeg); .gif uses the pillow writer; otherwise a
    directory of PNG frames.  For other outputs audio (if given) is saved
    next to it as .wav.  Returns the path written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    fig = plt.figure(dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    bones = skeleton.bones()

    def draw(i):
        ax.clear()
        pos = positions[i]
        ax.scatter(pos[:, 0], pos[:, 2], zs=pos[:, 1], s=2)
        for p, c in bones:
            ax.plot([pos[p, 0], pos[c, 0]], [pos[p, 2], pos[c, 2]],
                    [pos[p, 1], pos[c, 1]], c="blue", linewidth=0.5)
        ax.set_xlim(-lim, lim); ax.set_ylim(lim, -lim); ax.set_zlim(-lim, lim)

    if output_path.endswith((".avi", ".mp4")):
        def frames():
            for i in range(len(positions)):
                draw(i)
                fig.canvas.draw()
                buf = np.asarray(fig.canvas.buffer_rgba())
                # copy: buffer_rgba() is a live view of the Agg renderer's
                # single buffer, overwritten by the next canvas.draw() — a
                # consumer that materialises the iterator would otherwise
                # see N aliases of the LAST frame
                yield buf[:, :, :3].copy()

        if output_path.endswith(".mp4"):
            from .mp4 import write_mp4 as writer
        else:
            from .avi import write_avi as writer
        writer(output_path, frames(), fps=fps,
               audio=None if wav is None else np.asarray(wav),
               sample_rate=wav_sr)
        plt.close(fig)
        return output_path

    if wav is not None:
        from scipy.io import wavfile

        wav_path = os.path.splitext(output_path)[0] + ".wav"
        wavfile.write(wav_path, wav_sr, np.asarray(wav))

    if output_path.endswith(".gif"):
        anim = FuncAnimation(fig, draw, frames=len(positions),
                             interval=1000 / fps)
        anim.save(output_path, writer=PillowWriter(fps=fps))
        plt.close(fig)
        return output_path

    os.makedirs(output_path, exist_ok=True)
    for i in range(len(positions)):
        draw(i)
        fig.savefig(os.path.join(output_path, f"frame_{i:05d}.png"))
    plt.close(fig)
    return output_path


def _position_columns(track):
    cols = {name: i for i, name in enumerate(track.column_names)}

    def at(joint: str, axis: str, frame: int) -> float:
        return float(track.values[frame, cols[f"{joint}_{axis}position"]])

    return at


def draw_stickfigure(track, frame: int, joints=None, draw_names: bool = False,
                     ax=None, figsize=(8, 8)):
    """2-D stick figure of one frame of a position-parameterised
    ``BvhData`` track, the reference's notebook helper
    (``pymo/viz_tools.py:13-47``).  No backend is forced: a global
    ``matplotlib.use("Agg")`` would stop inline rendering."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111)
    joints_to_draw = list(joints) if joints is not None else list(track.joints)
    at = _position_columns(track)
    for joint in joints_to_draw:
        x, y = at(joint, "X", frame), at(joint, "Y", frame)
        ax.scatter(x=x, y=y, alpha=0.6, c="b", marker="o")
        for c in track.joints[joint].children:
            if c in joints_to_draw:
                ax.plot([x, at(c, "X", frame)], [y, at(c, "Y", frame)],
                        "k-", lw=2)
        if draw_names:
            ax.annotate(joint, (x + 0.1, y + 0.1))
    return ax


def draw_stickfigure3d(track, frame: int, joints=None,
                       draw_names: bool = False, ax=None, figsize=(8, 8)):
    """3-D variant (``pymo/viz_tools.py:49-87``), y up; no backend forced,
    as in ``draw_stickfigure``."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111, projection="3d")
    joints_to_draw = list(joints) if joints is not None else list(track.joints)
    at = _position_columns(track)
    for joint in joints_to_draw:
        x, y, z = (at(joint, a, frame) for a in "XYZ")
        ax.scatter(xs=x, ys=z, zs=y, alpha=0.6, c="b", marker="o")
        for c in track.joints[joint].children:
            if c in joints_to_draw:
                ax.plot([x, at(c, "X", frame)], [z, at(c, "Z", frame)],
                        [y, at(c, "Y", frame)], "k-", lw=2)
        if draw_names:
            ax.text(x, z, y, joint)
    return ax


def visualize_sample_skeleton(
    sample_path: str,
    hierarchy_path: str,
    joint_names: Sequence[str],
    output_path: str,
    fps: int = 20,
    which: str = "out",
    wav_sr: int = 16000,
) -> str:
    """Render one generated sample pickle ({"pose","out","wav"}) to an
    animation (``vis_skeleton.py:339`` equivalent).  ``wav_sr`` must match
    the rate the sample's wav was stored at (config ``Data.wav_sr``) or the
    muxed audio plays pitch-shifted."""
    import pickle

    with open(sample_path, "rb") as f:
        sample = pickle.load(f)
    skeleton = Skeleton.from_hierarchy_file(hierarchy_path)
    positions = pose_to_positions(
        skeleton, np.asarray(sample[which]), joint_names)
    return make_skeleton_video(
        positions, skeleton, output_path, fps=fps,
        wav=sample.get("wav"), wav_sr=wav_sr)
