"""Export in the port against the JAX package: foot-contact features, BVH
export (verbatim-header and consistent modes, smoothing, the batch over
sample pickles and its ``python -m`` entry point), the AVI and MP4 muxers,
forward kinematics for the renderer and the skeleton video; and one CLI
chain on the CPU from a toy corpus to BVH files.

The hierarchy template is the flagship's, pruned from
``tests/golden/synth_fullbody.bvh`` by ``cli.hierarchy_template`` as prep
derives it from a corpus BVH.  The writers are byte-equal to the JAX
package's.  What goes through float32 rotations (the low-pass smoothing,
forward kinematics) is held to the data path's tolerances: torch and XLA
round float32 sin and cos differently in the last bits."""

import contextlib
import importlib
import io
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.data.skeleton import Skeleton as JaxSkeleton
from gesture_diffusion_tpu.export import avi as jax_avi
from gesture_diffusion_tpu.export import features as jax_features
from gesture_diffusion_tpu.export import mp4 as jax_mp4
from gesture_diffusion_tpu.export import vis_skeleton as jax_vis
from gesture_diffusion_torch import cli
from gesture_diffusion_torch.data.bvh import parse_bvh
from gesture_diffusion_torch.data.skeleton import Skeleton
from gesture_diffusion_torch.export import (avi, features, mp4, read_avi_structure,
                                            read_mp4_structure, vis_skeleton)
from torch_port_common import write_toy_recording

torch.set_num_threads(1)

# the submodules, not the functions of the same name that the packages export
pose2bvh = importlib.import_module("gesture_diffusion_torch.export.pose2bvh")
jax_pose2bvh = importlib.import_module("gesture_diffusion_tpu.export.pose2bvh")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "synth_fullbody.bvh")
with open(os.path.join(REPO, "configs", "beat-ours.json")) as f:
    BEAT = json.load(f)["Data"]
JOINTS = BEAT["joints"]
# tests/test_torch_port_data.py's: float32 rotations, torch against XLA
ROT_TOL, DEG_TOL = 1e-5, 1e-3


@pytest.fixture(scope="module")
def hierarchy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hier") / "hierarchy_upper.txt")
    with open(path, "w") as f:
        f.write(cli.hierarchy_template(GOLDEN, JOINTS, BEAT["hierarchy_extra_joints"]))
    return path


def _pose(seed, t=60, lim=60.0):
    return np.random.default_rng(seed).uniform(
        -lim, lim, (t, 3 * len(JOINTS))).astype(np.float32)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _motion(path):
    """The MOTION block's numbers of a BVH file, whatever its header says."""
    text = open(path).read()
    return np.loadtxt(io.StringIO(text.split("Frame Time:")[1].split("\n", 1)[1]))


# -- features --------------------------------------------------------------------

SIGNALS = {
    "velocity": np.cumsum(np.random.default_rng(0).normal(size=600)) * 0.01,
    "height": 1.0 + np.sin(np.linspace(0, 30, 700)) + 0.05 * np.random.default_rng(1).normal(size=700),
    "flat": np.zeros(50),
    "short": np.array([0.0, 1.0]),
}


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_features_match_jax(name):
    x = SIGNALS[name]
    for thres, dist in ((0.3, 1), (0.1, 5), (-0.5, 30)):
        np.testing.assert_array_equal(features.peak_indexes(x, thres, dist),
                                      jax_features.peak_indexes(x, thres, dist))
    for a, b in zip(features.get_foot_contact_idxs(x, 0.02, 40),
                    jax_features.get_foot_contact_idxs(x, 0.02, 40)):
        np.testing.assert_array_equal(a, b)
    ours = features.create_foot_contact_signal(x, start=1, t=0.02, min_dist=40)
    np.testing.assert_array_equal(
        ours, jax_features.create_foot_contact_signal(x, start=1, t=0.02, min_dist=40))
    if name == "velocity":
        # the negative threshold of the down-peaks keeps every local maximum
        assert x.min() < 0 and len(features.get_foot_contact_idxs(x)[1]) > 0
        assert set(np.unique(ours)) == {0, 1}


# -- BVH export ----------------------------------------------------------------

def test_pose2bvh_files_equal_jax(hierarchy, tmp_path):
    """The verbatim-header mode and the consistent mode, byte for byte;
    with the low-pass filter, the numbers to DEG_TOL."""
    pose = _pose(0)
    with open(hierarchy) as f:
        text = f.read()
    for filt in (False, True):
        a, b = str(tmp_path / f"ours-{filt}.bvh"), str(tmp_path / f"ref-{filt}.bvh")
        pose2bvh.pose2bvh(a, pose, text, fps=20, root_translation=(1, 2, 3), filter=filt)
        jax_pose2bvh.pose2bvh(b, pose, text, fps=20, root_translation=(1, 2, 3), filter=filt)
        c, d = str(tmp_path / f"c-ours-{filt}.bvh"), str(tmp_path / f"c-ref-{filt}.bvh")
        pose2bvh.pose2bvh_consistent(c, pose, hierarchy, JOINTS, filter=filt)
        jax_pose2bvh.pose2bvh_consistent(d, pose, hierarchy, JOINTS, filter=filt)
        if not filt:
            assert _bytes(a) == _bytes(b) and _bytes(c) == _bytes(d)
        else:
            assert np.abs(_motion(a) - _motion(b)).max() < DEG_TOL
            assert np.abs(parse_bvh(c).values - parse_bvh(d).values).max() < DEG_TOL
    back = parse_bvh(str(tmp_path / "c-ours-False.bvh"))
    for k, joint in enumerate(JOINTS):
        for axis, col in enumerate("XYZ"):
            i = back.column_names.index(f"{joint}_{col}rotation")
            np.testing.assert_array_equal(back.values[:, i], pose[:, 3 * k + axis])


def test_smooth_pose_euler_matches_jax():
    pose = _pose(1, t=120)
    ours, ref = pose2bvh.smooth_pose_euler(pose), jax_pose2bvh.smooth_pose_euler(pose)
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == pose.shape
    d = np.abs(ours - ref).max()
    print(f"smooth_pose_euler, the port against JAX: max|d| {d:.3e} degrees")
    assert d < DEG_TOL
    assert np.abs(np.diff(ours, axis=0)).mean() < np.abs(np.diff(pose, axis=0)).mean()
    np.testing.assert_array_equal(pose2bvh.butter_lowpass_filter(pose[:, 0]),
                                  jax_pose2bvh.butter_lowpass_filter(pose[:, 0]))


def _samples(directory, n=2, t=40, sr=16000):
    os.makedirs(directory)
    for i in range(n):
        wav = np.random.default_rng(10 + i).uniform(-0.5, 0.5, t * sr // 20).astype(np.float32)
        with open(os.path.join(directory, f"sample_{i}.pkl"), "wb") as f:
            pickle.dump({"pose": _pose(20 + i, t), "out": _pose(30 + i, t), "wav": wav}, f)


@pytest.mark.parametrize("consistent", [False, True])
def test_sample2bvh_batch_equals_jax(hierarchy, tmp_path, consistent):
    _samples(tmp_path / "samples")
    names = JOINTS if consistent else None
    ours = pose2bvh.sample2bvh_batch(str(tmp_path / "samples"), str(tmp_path / "ours"),
                                     hierarchy, joint_names=names)
    ref = jax_pose2bvh.sample2bvh_batch(str(tmp_path / "samples"), str(tmp_path / "ref"),
                                        hierarchy, joint_names=names)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref]
    assert len(ours) == 6
    for a, b in zip(ours, ref):
        assert _bytes(a) == _bytes(b), a


def test_pose2bvh_entry_point(hierarchy, tmp_path):
    """``python -m gesture_diffusion_torch.export.pose2bvh`` writes what
    the JAX package's batch writes."""
    _samples(tmp_path / "samples", n=1)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "gesture_diffusion_torch.export.pose2bvh",
         "--sample-dir", str(tmp_path / "samples"), "--bvh-dir", str(tmp_path / "ours"),
         "--hierarchy", hierarchy], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = jax_pose2bvh.sample2bvh_batch(str(tmp_path / "samples"), str(tmp_path / "ref"),
                                        hierarchy)
    for path in ref:
        assert _bytes(path) == _bytes(str(tmp_path / "ours" / os.path.basename(path)))


# -- muxers, kinematics, the video ---------------------------------------------

def _frames(n=3, h=24, w=30):
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.stack([(yy * 4 + xx * 2 + 9 * i) % 256, (xx * 5 + i) % 256,
                      np.full_like(xx, 40 * i)], -1).astype(np.uint8) for i in range(n)]


@pytest.mark.parametrize("kind", ["avi-raw", "avi-mjpeg", "mp4"])
@pytest.mark.parametrize("audio", ["none", "float", "int16-stereo"])
def test_muxers_equal_jax(tmp_path, kind, audio):
    sound = {"none": None,
             "float": np.linspace(-1.2, 1.2, 2401).astype(np.float32),
             "int16-stereo": np.random.default_rng(3).integers(
                 -2000, 2000, (2000, 2)).astype(np.int16)}[audio]
    a, b = str(tmp_path / f"ours.{kind[:3]}"), str(tmp_path / f"ref.{kind[:3]}")
    if kind == "mp4":
        mp4.write_mp4(a, iter(_frames()), fps=10, audio=sound, sample_rate=8000)
        jax_mp4.write_mp4(b, iter(_frames()), fps=10, audio=sound, sample_rate=8000)
        info = read_mp4_structure(a)
        assert info == jax_mp4.read_mp4_structure(b)
        assert info["n_traks"] == (1 if sound is None else 2)
    else:
        codec = kind.split("-")[1]
        avi.write_avi(a, iter(_frames()), fps=10, audio=sound, sample_rate=8000, codec=codec)
        jax_avi.write_avi(b, iter(_frames()), fps=10, audio=sound, sample_rate=8000,
                          codec=codec)
        info = read_avi_structure(a)
        assert info == jax_avi.read_avi_structure(b) and info["video_frames"] == 3
    assert _bytes(a) == _bytes(b)
    with pytest.raises(ValueError, match="uint8"):
        avi.write_avi(str(tmp_path / "x.avi"), [np.zeros((4, 4, 3))], fps=10, codec="raw")


def test_pose_to_positions_matches_jax(hierarchy):
    pose = _pose(4, t=30, lim=90.0)
    ours = vis_skeleton.pose_to_positions(Skeleton.from_hierarchy_file(hierarchy), pose, JOINTS)
    ref = jax_vis.pose_to_positions(JaxSkeleton.from_hierarchy_file(hierarchy), pose, JOINTS)
    assert ours.shape == ref.shape == (30, len(parse_bvh(hierarchy).joints), 3)
    assert ours.dtype == ref.dtype
    d = np.abs(ours - ref).max()
    print(f"pose_to_positions, the port against JAX: max|d| {d:.3e} "
          f"(max|ref| {np.abs(ref).max():.1f})")
    assert d < ROT_TOL * np.abs(ref).max()


@pytest.mark.parametrize("suffix", [".avi", ".mp4"])
def test_skeleton_video_with_audio(hierarchy, tmp_path, suffix):
    """Three rendered frames of the flagship skeleton with the speech
    muxed in: the structure read back, and the frames distinct (the Agg
    buffer is copied per frame)."""
    sample = tmp_path / "sample_0.pkl"
    with open(sample, "wb") as f:
        pickle.dump({"pose": _pose(5, 3), "out": _pose(6, 3, lim=80.0),
                     "wav": np.zeros(2400, np.float32)}, f)
    out = vis_skeleton.visualize_sample_skeleton(
        str(sample), hierarchy, JOINTS, str(tmp_path / f"v{suffix}"), fps=20)
    if suffix == ".avi":
        info = read_avi_structure(out)
        assert info["video_frames"] == 3 and info["streams"] == 2
        assert info["audio_bytes"] == 2400 * 2
        blob, payloads = _bytes(out), []
        at = blob.find(b"movi") + 4         # the chunks of the movi list
        while blob[at:at + 4] in (b"00dc", b"01wb"):
            size = int.from_bytes(blob[at + 4:at + 8], "little")
            if blob[at:at + 4] == b"00dc":
                payloads.append(blob[at + 8:at + 8 + size])
            at += 8 + size + size % 2
        assert len(payloads) == len(set(payloads)) == 3
    else:
        info = read_mp4_structure(out)
        video, sound = info["traks"]
        assert video["n_samples"] == 3 and sound["n_samples"] == 2400
        blob, start = _bytes(out), video["chunk_offset"]
        offsets = np.cumsum([0] + video["sizes"]) + start
        assert len({blob[a:b] for a, b in zip(offsets[:-1], offsets[1:])}) == 3


# -- one CLI chain on the CPU ----------------------------------------------------

def test_cli_chain_from_corpus_to_bvh(tmp_path):
    """A toy corpus (5 recordings of 30 s, 2 joints: 8/1/1 samples of 10 s)
    through the port's prep -> data -> train (one epoch: 8 steps of 5
    windows) -> gen on the CPU, then ``sample2bvh_batch`` over the samples:
    every exported BVH parses back to the pickle's euler poses exactly."""
    root = tmp_path / "BEAT"
    os.makedirs(root / "1")
    for i in range(5):
        write_toy_recording(root / "1", f"1_wayne_0_{i}_{i}", seed=i)
    with open(os.path.join(REPO, "configs", "beat-ours.json")) as f:
        raw = json.load(f)
    raw["Data"].update({
        "src_dir_path": str(root), "joints": ["Spine"], "sample_duration": 10.0,
        "pose_stride_len": 40,
        "spt_dir_path": str(tmp_path / "spt"), "dst_dir_path": str(tmp_path / "dst"),
        "hierarchy_path": str(tmp_path / "spt" / "hierarchy_upper.txt")})
    raw["Model"]["d_model"] = 32
    raw["Model"]["Decoder"].update({"heads": 4, "n_layers": 1})
    raw["Model"]["Diffusion"].update({"diffusion_steps": 50, "timestep_respacing": "ddim10"})
    raw["Train"].update({"batch_size": 5, "max_training_steps": "8",
                         "early_stop_threshold_in_step": "8"})
    raw["Train"]["Scheduler"]["d_model"] = 32
    raw["Meta"] = {"project": "smoke", "log_dir": str(tmp_path / "log"), "name": "corpus"}
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(raw))
    for phase in ("prep", "data", "train", "gen"):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["--phase", phase, "--config", str(cfg), "--device", "cpu"])
    samples = tmp_path / "log" / "corpus" / "results" / "samples"
    assert os.listdir(samples) == ["sample_0.pkl"]
    written = pose2bvh.sample2bvh_batch(str(samples), str(tmp_path / "bvh"),
                                        raw["Data"]["hierarchy_path"], joint_names=["Spine"])
    assert len(written) == 3
    for i in range(1):
        with open(samples / f"sample_{i}.pkl", "rb") as f:
            s = pickle.load(f)
        assert s["out"].shape == s["pose"].shape == (200, 3) and np.isfinite(s["out"]).all()
        for tag in ("gt", "out"):
            back = parse_bvh(str(tmp_path / "bvh" / f"sample_{i}-{tag}.bvh"))
            assert back.n_frames == 200 and back.framerate == 1 / 20
            for axis, col in enumerate("XYZ"):
                np.testing.assert_array_equal(
                    back.values[:, back.column_names.index(f"Spine_{col}rotation")],
                    s["pose" if tag == "gt" else "out"][:, axis])
