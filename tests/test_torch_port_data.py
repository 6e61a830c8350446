"""Port vs JAX: the data path and the beat metrics, on the CPU.

Rotations (``ops/rotation.py``), the scaler, BVH parsing and writing, the
skeleton's forward kinematics, ``PoseTypeConverter``, the windowed
dataset (``data/pipeline.py``) and ``generation/eval_utils.py``, each on
the same seeded inputs or golden BVH files through both packages.

Tolerances, per function (float32 on both sides):
  * rotation matrices, ortho-6D, rotation vectors, quaternions: 1e-5 abs;
  * euler degrees: 1e-3 abs away from gimbal lock; near it the angles are
    ill-conditioned, so the matrices they encode are compared (1e-5);
  * bone direction vectors: 1e-5 abs; FK positions: 1e-5 of max |p|;
  * the scaled windowed dataset: 1e-5 abs;
  * the onset envelope: 1e-4 of its max, with equal picked frames;
  * angle-change rates and beat scores: 1e-6.
Numpy-only functions (parsing, resampling, windowing, peak picking) are
held to equality.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.data import bvh as jax_bvh
from gesture_diffusion_tpu.data import pipeline as jax_pipeline
from gesture_diffusion_tpu.data.pose_converter import PoseTypeConverter as JaxPTC
from gesture_diffusion_tpu.data.skeleton import Skeleton as JaxSkeleton
from gesture_diffusion_tpu.generation import eval_utils as jax_eval
from gesture_diffusion_tpu.ops import rotation as jax_rot
from gesture_diffusion_tpu.ops.scaler import StandardScaler as JaxScaler
from gesture_diffusion_torch.data import bvh
from gesture_diffusion_torch.data import pipeline
from gesture_diffusion_torch.data.pose_converter import PoseTypeConverter
from gesture_diffusion_torch.data.skeleton import Skeleton
from gesture_diffusion_torch.generation import eval_utils
from gesture_diffusion_torch.ops import rotation as rot
from gesture_diffusion_torch.ops.scaler import StandardScaler
from gesture_diffusion_torch.training import ArrayDataset

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FULLBODY = os.path.join(GOLD, "synth_fullbody.bvh")
TOY = os.path.join(GOLD, "toy_chain.bvh")
ROT_TOL, DEG_TOL, DIR_TOL, DATA_TOL, ONSET_TOL, BEAT_TOL = (
    1e-5, 1e-3, 1e-5, 1e-5, 1e-4, 1e-6)
# the flagship config's 41 joints (configs/beat-ours.json)
FLAGSHIP_JOINTS = [
    "Spine1", "Spine2", "Spine3",
    "RightShoulder", "RightArm", "RightForeArm", "RightHand",
    "RightHandMiddle1", "RightHandMiddle2", "RightHandMiddle3",
    "RightHandRing1", "RightHandRing2", "RightHandRing3",
    "RightHandPinky1", "RightHandPinky2", "RightHandPinky3",
    "RightHandIndex1", "RightHandIndex2", "RightHandIndex3",
    "RightHandThumb1", "RightHandThumb2", "RightHandThumb3",
    "LeftShoulder", "LeftArm", "LeftForeArm", "LeftHand",
    "LeftHandMiddle1", "LeftHandMiddle2", "LeftHandMiddle3",
    "LeftHandRing1", "LeftHandRing2", "LeftHandRing3",
    "LeftHandPinky1", "LeftHandPinky2", "LeftHandPinky3",
    "LeftHandIndex1", "LeftHandIndex2", "LeftHandIndex3",
    "LeftHandThumb1", "LeftHandThumb2", "LeftHandThumb3"]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _j(fn, *args, **kw):
    """The JAX function, jitted (one compile instead of one per op)."""
    jitted = jax.jit(fn, static_argnames=tuple(kw))
    return np.asarray(jitted(*(jnp.asarray(a) for a in args), **kw))


def _e(fn, *args, **kw):
    """The JAX function op by op, as the JAX package's data path runs it.
    Used for the euler extraction: its gimbal-lock test is a float32
    comparison with 1 - 1e-7, and on the rotation (-45, -90, 20) |m[0,2]|
    ties it; the jitted JAX function breaks the tie the other way from the
    eager one (and the port), and the recovered matrix moves by 0.42."""
    return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))


def _p(fn, *args, **kw):
    return fn(*(_t(a) for a in args), **kw).numpy()


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# -- rotations ----------------------------------------------------------------

def _eulers(seed=0, n=256):
    """Seeded XYZ eulers in degrees, plus rows at theta ~ pi (half turns
    about each axis and about diagonals) and near gimbal lock (b ~ +-90)."""
    rng = np.random.default_rng(seed)
    rand = rng.uniform(-180, 180, (n, 3))
    rand[:, 1] = rng.uniform(-85, 85, n)
    half_turns = np.array([[180, 0, 0], [0, 180, 0], [0, 0, 180],
                           [179.99, 0.01, 0], [180, 0, 180], [-180, 0, 0],
                           [90, 0, 180], [179.9, -0.05, 179.9]])
    gimbal = np.array([[30, 90, 10], [-45, -90, 20], [10, 89.999, -5],
                       [120, -89.9995, 60], [0, 90, 0], [170, 89.99, -170]])
    return rand.astype(np.float32), half_turns.astype(np.float32), \
        gimbal.astype(np.float32)


@pytest.mark.parametrize("order", ["XYZ", "ZXY", "YZX", "ZYX"])
def test_euler_rotmat_round_trip_matches_jax(order):
    rand, half, gimbal = _eulers()
    for e in (rand, half, gimbal):
        m_ref = _j(jax_rot.euler_to_rotmat, e, order=order)
        m = _p(rot.euler_to_rotmat, e, order=order)
        assert _max_abs(m, m_ref) < ROT_TOL
    # away from gimbal lock the angles themselves; near it the matrices
    # the recovered angles encode
    for e in (rand, half):
        m_ref = _j(jax_rot.euler_to_rotmat, e, order=order)
        ours = _p(rot.rotmat_to_euler, m_ref, order=order)
        ref = _e(jax_rot.rotmat_to_euler, m_ref, order=order)
        wrapped = (ours - ref + 180.0) % 360.0 - 180.0   # +-180 is one angle
        assert np.abs(wrapped).max() < DEG_TOL
    m_g = _j(jax_rot.euler_to_rotmat, gimbal, order=order)
    e_ours = _p(rot.rotmat_to_euler, m_g, order=order)
    e_ref = _e(jax_rot.rotmat_to_euler, m_g, order=order)
    assert _max_abs(_p(rot.euler_to_rotmat, e_ours, order=order),
                    _j(jax_rot.euler_to_rotmat, e_ref, order=order)) < ROT_TOL


def test_rotation_conversions_match_jax():
    """ortho-6D, the Shepperd quaternion, rotation vectors and Rodrigues,
    over random, half-turn (theta ~ pi) and gimbal-locked rotations."""
    rand, half, gimbal = _eulers(1)
    eul = np.concatenate([rand, half, gimbal])
    m = _j(jax_rot.euler_to_rotmat, eul)
    assert _max_abs(_p(rot.euler_to_ortho6d, eul),
                    _j(jax_rot.euler_to_ortho6d, eul)) < ROT_TOL
    o6 = _j(jax_rot.rotmat_to_ortho6d, m)
    o6_raw = o6 * np.random.default_rng(2).uniform(0.5, 2.0, o6.shape).astype(np.float32)
    assert _max_abs(_p(rot.ortho6d_to_rotmat, o6_raw),
                    _j(jax_rot.ortho6d_to_rotmat, o6_raw)) < ROT_TOL
    q = _p(rot.rotmat_to_quat, m)
    assert _max_abs(q, _j(jax_rot.rotmat_to_quat, m)) < ROT_TOL
    assert (q[:, 0] >= 0).all()
    rv = _p(rot.rotmat_to_rotvec, m)
    assert _max_abs(rv, _j(jax_rot.rotmat_to_rotvec, m)) < ROT_TOL
    assert _max_abs(_p(rot.euler_to_rotvec, eul),
                    _j(jax_rot.euler_to_rotvec, eul)) < ROT_TOL
    assert np.linalg.norm(rv, axis=-1).max() <= np.pi + 1e-5
    # w < 0 quaternions and tiny angles (the Taylor branch)
    qn = -q[:16]
    assert _max_abs(_p(rot.quat_to_rotvec, qn), _j(jax_rot.quat_to_rotvec, qn)) < ROT_TOL
    tiny = np.random.default_rng(3).normal(0, 1e-9, (8, 3)).astype(np.float32)
    rvs = np.concatenate([rv, tiny])
    assert _max_abs(_p(rot.rotvec_to_rotmat, rvs),
                    _j(jax_rot.rotvec_to_rotmat, rvs)) < ROT_TOL
    # rotvec -> euler: the matrices the angles encode (gimbal rows included)
    ours = _p(rot.euler_to_rotmat, _p(rot.rotvec_to_euler, rv))
    assert _max_abs(ours, _j(jax_rot.euler_to_rotmat, _e(jax_rot.rotvec_to_euler, rv))) < ROT_TOL
    jitted = _j(jax_rot.euler_to_rotmat, _j(jax_rot.rotvec_to_euler, rv))
    worst = int(np.abs(ours - jitted).max(axis=(1, 2)).argmax())
    print(f"rotvec -> euler -> matrix, the port against the jitted JAX function: "
          f"max|d| {_max_abs(ours, jitted):.3e} at euler {eul[worst]}")


def _tracks():
    """(J, T, 3) rotation-vector tracks: each a fixed axis turned through
    0 .. 3 pi (crossing theta = pi twice), plus noisy tracks near pi."""
    rng = np.random.default_rng(4)
    t = np.linspace(0.0, 3 * np.pi, 61)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    turning = axes[:, None, :] * t[None, :, None]
    near_pi = axes[:, None, :] * (np.pi + rng.normal(0, 0.05, (6, 61, 1)))
    return np.concatenate([turning, near_pi]).astype(np.float32)


def test_unroll_matches_jax_through_pi():
    """The prefix-parity unroll on tracks through theta = pi: the swap
    decisions are discrete, so the outputs agree to float noise or a swap
    broke a near-tie the other way (a 2 pi jump, which fails here)."""
    tracks = _tracks()
    # each frame in its canonical form first (angle in [0, pi]), as the
    # data path feeds it
    rv = _j(jax_rot.rotmat_to_rotvec, _j(jax_rot.rotvec_to_rotmat, tracks))
    ours = _p(rot.unroll_log_rot, rv)
    ref = _j(jax_rot.unroll_log_rot, rv)
    assert _max_abs(ours, ref) < ROT_TOL
    assert _max_abs(_p(rot.rotvec_to_rotmat, ours), _j(jax_rot.rotvec_to_rotmat, rv)) < 1e-4
    # the turning tracks, unrolled, are continuous through theta = pi (up
    # to 2 pi: the double cover has no form for an angle beyond it)
    assert np.linalg.norm(np.diff(ours[:6, :36], axis=1), axis=-1).max() < 0.5


def test_convert_representation_matches_jax():
    rand, half, gimbal = _eulers(5, n=64)
    eul = np.concatenate([rand, half, gimbal]).reshape(2, 13, 3 * 3)
    for rep in ("euler", "6d", "log_rot"):
        ours = pipeline.convert_representation(eul, rep)
        ref = jax_pipeline.convert_representation(eul, rep)
        assert ours.shape == ref.shape and ours.dtype == ref.dtype, rep
        assert _max_abs(ours, ref) < ROT_TOL, rep
    with pytest.raises(ValueError, match="Unsupported"):
        pipeline.convert_representation(eul, "quat")


# -- scaler -------------------------------------------------------------------

def test_scaler_matches_jax_and_files_cross_load(tmp_path):
    x = np.random.default_rng(6).normal(2.0, 3.0, (500, 9)).astype(np.float32)
    x[:, 4] = 1.5                                    # constant column: scale 1
    ours, ref = StandardScaler.fit(x), JaxScaler.fit(x)
    np.testing.assert_array_equal(ours.mean, ref.mean)
    np.testing.assert_array_equal(ours.scale, ref.scale)
    assert ours.scale[4] == 1.0
    np.testing.assert_array_equal(ours.transform(x), ref.transform(x))
    np.testing.assert_array_equal(ours.inverse_transform(x), ref.inverse_transform(x))
    ours.save(str(tmp_path / "a.npz"))
    ref.save(str(tmp_path / "b.npz"))
    for path in ("a.npz", "b.npz"):
        for cls in (StandardScaler, JaxScaler):
            back = cls.load(str(tmp_path / path))
            np.testing.assert_array_equal(back.mean, ours.mean)
            np.testing.assert_array_equal(back.scale, ours.scale)


# -- BVH ----------------------------------------------------------------------

def _same_bvh(ours, ref):
    assert list(ours.joints) == list(ref.joints)
    for name, j in ours.joints.items():
        r = ref.joints[name]
        assert (j.parent, j.channels, j.order, j.children, j.is_end_site) == \
            (r.parent, r.channels, r.order, r.children, r.is_end_site), name
        np.testing.assert_array_equal(j.offset, r.offset)
    assert ours.root_name == ref.root_name and ours.framerate == ref.framerate
    assert ours.channel_names == ref.channel_names
    np.testing.assert_array_equal(ours.values, ref.values)


@pytest.mark.parametrize("path", [FULLBODY, TOY], ids=["fullbody", "toy"])
def test_parse_bvh_and_hierarchy_text_match_jax(path, tmp_path):
    ours, ref = bvh.parse_bvh(path), jax_bvh.parse_bvh(path)
    _same_bvh(ours, ref)
    assert ours.n_frames > 0
    assert bvh.hierarchy_text(ours) == jax_bvh.hierarchy_text(ref)
    assert bvh.hierarchy_channel_order(ours) == jax_bvh.hierarchy_channel_order(ref)
    with open(path) as f:
        _same_bvh(bvh.parse_bvh(f.read(), is_text=True), ref)
    # written by the port, read by both
    out = str(tmp_path / "out.bvh")
    bvh.write_bvh(ours, out)
    _same_bvh(bvh.parse_bvh(out), jax_bvh.parse_bvh(out))
    jax_bvh.write_bvh(ref, str(tmp_path / "ref.bvh"))
    with open(out) as a, open(str(tmp_path / "ref.bvh")) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("joints", [
    FLAGSHIP_JOINTS + ["Neck", "Neck1"], ["RightHand", "Head"], ["Hips"]],
    ids=["flagship", "two", "root"])
def test_prune_hierarchy_matches_jax(joints):
    ours, ref = bvh.parse_bvh(FULLBODY), jax_bvh.parse_bvh(FULLBODY)
    keep = bvh.ancestor_closure(ours, joints)
    assert keep == jax_bvh.ancestor_closure(ref, joints)
    pruned = bvh.prune_hierarchy(ours, keep)
    _same_bvh(pruned, jax_bvh.prune_hierarchy(ref, keep))
    assert bvh.hierarchy_text(pruned) == jax_bvh.hierarchy_text(
        jax_bvh.prune_hierarchy(ref, keep))
    with pytest.raises(ValueError, match="unknown joints"):
        bvh.ancestor_closure(ours, ["NoSuchJoint"])


def test_toy_chain_prune_and_parse_errors():
    toy = bvh.parse_bvh(TOY)
    names = [n for n, j in toy.joints.items() if not j.is_end_site]
    keep = bvh.ancestor_closure(toy, names[:2])
    assert keep == jax_bvh.ancestor_closure(jax_bvh.parse_bvh(TOY), names[:2])
    assert bvh.hierarchy_text(bvh.prune_hierarchy(toy, keep)) == \
        jax_bvh.hierarchy_text(jax_bvh.prune_hierarchy(jax_bvh.parse_bvh(TOY), keep))
    with pytest.raises(ValueError, match="root"):
        bvh.prune_hierarchy(toy, set(names[1:2]))
    with open(TOY) as f:
        text = f.read()
    with pytest.raises(ValueError, match="truncated"):
        bvh.parse_bvh(text[:-40], is_text=True)
    with pytest.raises(ValueError, match="end of file"):
        bvh.parse_bvh("HIERARCHY\nROOT Hips\n{", is_text=True)


def test_load_from_bvh_flagship_joints_matches_jax(tmp_path):
    ours, dur = pipeline.load_from_bvh(FULLBODY, FLAGSHIP_JOINTS)
    ref, ref_dur = jax_pipeline.load_from_bvh(FULLBODY, FLAGSHIP_JOINTS)
    np.testing.assert_array_equal(ours, ref)
    assert ours.shape == (7, 123) and dur == ref_dur
    hips, _ = pipeline.load_from_bvh(FULLBODY, ["Hips", "Spine"])
    np.testing.assert_array_equal(hips, jax_pipeline.load_from_bvh(
        FULLBODY, ["Hips", "Spine"])[0])
    assert hips.shape == (7, 6)
    with pytest.raises(ValueError, match="Framerate"):
        pipeline.load_from_bvh(FULLBODY, expected_framerate=0.01)


# -- skeleton and the pose converter -----------------------------------------

def test_skeleton_matches_jax():
    data = bvh.parse_bvh(FULLBODY)
    ours, ref = Skeleton.from_bvh(data), JaxSkeleton.from_bvh(jax_bvh.parse_bvh(FULLBODY))
    assert ours.names == ref.names
    np.testing.assert_array_equal(ours.parents, ref.parents)
    np.testing.assert_array_equal(ours.offsets, ref.offsets)
    assert ours.bones() == ref.bones() and ours.angle_pairs() == ref.angle_pairs()
    eul = np.random.default_rng(7).uniform(-40, 40, (3, 5, len(FLAGSHIP_JOINTS), 3))
    full = ours.expand_rotations(eul, FLAGSHIP_JOINTS)
    np.testing.assert_array_equal(full, ref.expand_rotations(eul, FLAGSHIP_JOINTS))
    pos, pos_ref = ours.forward_kinematics(full), ref.forward_kinematics(full)
    assert pos.dtype == pos_ref.dtype
    assert _max_abs(pos, pos_ref) < ROT_TOL * np.abs(pos_ref).max()
    assert _max_abs(ours.direction_vectors(full), ref.direction_vectors(full)) < DIR_TOL


@pytest.fixture(scope="module")
def converter_case(tmp_path_factory):
    """A flagship hierarchy template written by the port from the golden
    BVH, a scaler per representation fit on seeded eulers, and a scaled
    batch in each representation."""
    tmp = tmp_path_factory.mktemp("ptc")
    skel = bvh.parse_bvh(FULLBODY)
    keep = bvh.ancestor_closure(skel, FLAGSHIP_JOINTS + ["Neck", "Neck1"])
    hier = str(tmp / "hierarchy.txt")
    with open(hier, "w") as f:
        f.write(bvh.hierarchy_text(bvh.prune_hierarchy(skel, keep)))
    eul = np.random.default_rng(8).uniform(-50, 50, (2, 12, 41 * 3)).astype(np.float32)
    cases = {}
    for rep in ("euler", "6d", "log_rot"):
        x = pipeline.convert_representation(eul, rep)
        scaler = StandardScaler.fit(x.reshape(-1, x.shape[-1]))
        path = str(tmp / f"scaler_{rep}.npz")
        scaler.save(path)
        cases[rep] = (path, scaler.transform(x).astype(np.float32))
    return hier, cases


@pytest.mark.parametrize("method,rep,tol", [
    ("scaled_euler_to_dir_vec", "euler", DIR_TOL),
    ("scaled_ortho6d_to_dir_vec", "6d", DIR_TOL),
    ("scaled_log_rot_to_dir_vec", "log_rot", DIR_TOL),
    ("scaled_ortho6d_to_euler", "6d", DEG_TOL),
    ("scaled_log_rot_to_euler", "log_rot", DEG_TOL)])
def test_pose_converter_matches_jax(converter_case, method, rep, tol):
    hier, cases = converter_case
    scaler_path, x = cases[rep]
    ours = PoseTypeConverter(scaler_path, hier, joint_names=FLAGSHIP_JOINTS)
    ref = JaxPTC(scaler_path, hier, joint_names=FLAGSHIP_JOINTS)
    assert ours.angle_pairs == ref.angle_pairs and len(ours.angle_pairs) > 30
    out, out_ref = getattr(ours, method)(x), getattr(ref, method)(x)
    assert out.shape == out_ref.shape
    assert _max_abs(out, out_ref) < tol
    if method.endswith("_euler"):                   # one (T, C) sequence
        assert _max_abs(getattr(ours, method)(x[0]), out_ref[0]) < tol


# -- resampling, windowing and the windowed dataset ---------------------------

@pytest.mark.parametrize("n,duration,fps", [(480, 4.0, 20), (481, 4.0, 20),
                                            (100, 3.3, 20), (7, 1.0, 30)])
def test_resample_pose_seq_equals_jax(n, duration, fps):
    x = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    ours = pipeline.resample_pose_seq(x, duration, fps)
    np.testing.assert_array_equal(ours, jax_pipeline.resample_pose_seq(x, duration, fps))
    assert ours.dtype == np.float32
    with pytest.raises(ValueError, match=">= 2 frames"):
        pipeline.resample_pose_seq(x[:1], duration, fps)


@pytest.mark.parametrize("window,stride,fps,sr", [(40, 20, 20, 16000),
                                                  (40, 40, 20, 16000),
                                                  (34, 7, 15, 16000)])
def test_window_slice_equals_jax(window, stride, fps, sr):
    rng = np.random.default_rng(window + stride)
    poses = rng.normal(size=(2, 83, 4)).astype(np.float32)
    wavs = rng.normal(size=(2, int(83 / fps * sr))).astype(np.float32)
    ours = pipeline.window_slice(poses, wavs, window, stride, fps, sr)
    ref = jax_pipeline.window_slice(poses, wavs, window, stride, fps, sr)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def _samples(spt, split, n=3, seconds=4, n_joints=2, seed=0):
    rng = np.random.default_rng(seed)
    pose = rng.uniform(-170, 170, (n, seconds * 120, n_joints * 3)).astype(np.float32)
    wav = rng.normal(0, 0.3, (n, seconds * 16000)).astype(np.float32)
    os.makedirs(spt, exist_ok=True)
    path = os.path.join(spt, f"{split}_samples.pkl")
    with open(path, "wb") as f:
        pickle.dump({"hid": np.zeros(n), "pose": pose, "wav": wav}, f)
    return path


@pytest.mark.parametrize("rep", ["log_rot", "6d", "euler"])
def test_processed_datasets_match_jax_and_cross_load(tmp_path, rep):
    """Train/val/test through both packages from the same samples: the
    windows, the sequences and the scaler; then each package's cache is
    read by the other as its own."""
    spt = str(tmp_path / "spt")
    for i, split in enumerate(("train", "val", "test")):
        _samples(spt, split, seed=i)
    kw = dict(pose_fps=20, wav_sr=16000, spt_dir_path=spt, pose_window_len=40,
              pose_stride_len=20, pose_representation=rep)
    ours = pipeline.load_processed_datasets(dst_dir_path=str(tmp_path / "a"), **kw)
    ref = jax_pipeline.load_processed_datasets(dst_dir_path=str(tmp_path / "b"), **kw)
    for o, r in zip(ours, ref):
        assert o.poses.shape == r.poses.shape and o.poses.dtype == r.poses.dtype
        assert _max_abs(o.poses, r.poses) < DATA_TOL
        np.testing.assert_array_equal(o.wavs, r.wavs)
        assert o.get_dims() == r.get_dims() and len(o) == len(r)
    c = {"6d": 12}.get(rep, 6)
    assert ours[0].poses.shape == (12, 40, c) and ours[1].poses.shape == (6, 40, c)
    assert _max_abs(ours[2].get_seqs()["pose"], ref[2].get_seqs()["pose"]) < DATA_TOL
    arrays = ours[0].as_arrays()
    assert isinstance(arrays, ArrayDataset) and len(arrays) == 12
    # the other package's caches load as they are
    swapped = jax_pipeline.load_processed_datasets(dst_dir_path=str(tmp_path / "a"), **kw)
    np.testing.assert_array_equal(swapped[0].poses, ours[0].poses)
    swapped = pipeline.load_processed_datasets(dst_dir_path=str(tmp_path / "b"), **kw)
    np.testing.assert_array_equal(swapped[2].pose_seqs, ref[2].pose_seqs)
    with open(tmp_path / "a" / "scaler_params.json") as f:
        assert f.read() == (tmp_path / "b" / "scaler_params.json").read_text()


def test_windowed_dataset_cache_reuse_and_stale_rebuild(tmp_path, capsys):
    spt, dst = str(tmp_path / "spt"), str(tmp_path / "dst")
    train = _samples(spt, "train")
    ds = pipeline.WindowedDataset(train, dst, 40, 20, 20, 16000, "log_rot")
    assert ds.poses.shape == (12, 40, 6) and ds.wavs.shape == (12, 32000)
    data_path = os.path.join(dst, "train_data.pkl")
    mtime = os.stat(data_path).st_mtime_ns
    again = pipeline.WindowedDataset(train, dst, 40, 20, 20, 16000, "log_rot")
    np.testing.assert_array_equal(again.poses, ds.poses)
    assert os.stat(data_path).st_mtime_ns == mtime          # read, not rebuilt
    stale = pipeline.WindowedDataset(train, dst, 20, 20, 20, 16000, "log_rot")
    assert stale.poses.shape[1] == 20
    assert "different params" in capsys.readouterr().out
    # a param-less (reference-era) cache is trusted as it is
    with open(data_path, "rb") as f:
        cached = pickle.load(f)
    del cached["params"]
    with open(data_path, "wb") as f:
        pickle.dump(cached, f)
    trusted = pipeline.WindowedDataset(train, dst, 40, 20, 20, 16000, "log_rot")
    np.testing.assert_array_equal(trusted.poses, stale.poses)


def test_windowed_dataset_stale_seqs_rebuild(tmp_path):
    """A _seqs.pkl can be stale on its own (built under params A while the
    _data.pkl alone was rebuilt under B): a keep_seqs load under B rebuilds."""
    spt, dst = str(tmp_path / "spt"), str(tmp_path / "dst")
    train, test = _samples(spt, "train"), _samples(spt, "test", seed=1)
    pipeline.WindowedDataset(train, dst, 40, 20, 20, 16000, "log_rot")
    pipeline.WindowedDataset(test, dst, 40, 20, 20, 16000, "log_rot", keep_seqs=True)
    os.remove(os.path.join(dst, "test_data.pkl"))
    pipeline.WindowedDataset(train, dst, 40, 20, 10, 16000, "log_rot")
    pipeline.WindowedDataset(test, dst, 40, 20, 10, 16000, "log_rot")
    ds = pipeline.WindowedDataset(test, dst, 40, 20, 10, 16000, "log_rot",
                                  keep_seqs=True)
    assert ds.pose_seqs.shape[1] == 40                     # 4 s at 10 fps


def test_windowed_dataset_heals_corrupt_cache(tmp_path, capsys):
    spt, dst = str(tmp_path / "spt"), str(tmp_path / "dst")
    args = (_samples(spt, "train"), dst, 40, 20, 20, 16000, "log_rot")
    ds = pipeline.WindowedDataset(*args)
    data_path = os.path.join(dst, "train_data.pkl")
    with open(data_path, "rb") as f:
        good = f.read()
    for bad in (good[: len(good) // 2], b"\x80\x04garbage", pickle.dumps([1, 2, 3])):
        with open(data_path, "wb") as f:
            f.write(bad)
        np.testing.assert_array_equal(pipeline.WindowedDataset(*args).poses, ds.poses)
        assert "unreadable cache" in capsys.readouterr().out
    np.testing.assert_array_equal(pipeline.WindowedDataset(*args).poses, ds.poses)
    assert "unreadable cache" not in capsys.readouterr().out
    assert not [p for p in os.listdir(dst) if p.endswith(".tmp")]


def test_windowed_dataset_refusals(tmp_path):
    """The scaler sidecar: a split built under other (fps, representation)
    refuses the scaler; no scaler at all, a corrupt or a missing samples
    pickle each name their remedy."""
    spt, dst = str(tmp_path / "spt"), str(tmp_path / "dst")
    train, val = _samples(spt, "train"), _samples(spt, "val", seed=1)
    with pytest.raises(ValueError, match="build the train split first"):
        pipeline.WindowedDataset(val, dst, 40, 20, 20, 16000, "log_rot")
    pipeline.WindowedDataset(train, dst, 40, 20, 20, 16000, "log_rot")
    with pytest.raises(ValueError, match="rebuild the train split"):
        pipeline.WindowedDataset(val, dst, 20, 10, 10, 16000, "log_rot")
    with pytest.raises(ValueError, match="rebuild the train split"):
        pipeline.WindowedDataset(val, dst, 40, 20, 20, 16000, "6d")
    assert pipeline.WindowedDataset(val, dst, 20, 10, 20, 16000,
                                    "log_rot").poses.shape[1] == 20
    bad = os.path.join(spt, "bad_samples.pkl")
    with open(bad, "wb") as f:
        f.write(b"not a pickle")
    with pytest.raises(ValueError, match="re-run the prep phase"):
        pipeline.WindowedDataset(bad, dst, 40, 20, 20, 16000, "log_rot")
    with pytest.raises(FileNotFoundError, match="not found; run the prep"):
        pipeline.WindowedDataset(os.path.join(spt, "nope_samples.pkl"), dst,
                                 40, 20, 20, 16000, "log_rot")


# -- beat metrics ----------------------------------------------------------------

def _speech(seed, seconds=4.0, sr=16000):
    """Noise bursts under a syllable-rate envelope: clear onsets."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    env = (np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6)) > 0.3).astype(np.float32)
    return (0.3 * env * rng.normal(size=t.size)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_onsets_match_jax(seed):
    wav = _speech(seed)
    env, env_ref = eval_utils.onset_strength(wav, 16000), jax_eval.onset_strength(wav, 16000)
    assert env.shape == env_ref.shape
    assert _max_abs(env, env_ref) < ONSET_TOL * np.abs(env_ref).max()
    on, on_ref = eval_utils.onset_detect(wav, 16000), jax_eval.onset_detect(wav, 16000)
    assert len(on_ref) > 3
    np.testing.assert_array_equal(on, on_ref)
    x = np.random.default_rng(seed).normal(size=200)
    np.testing.assert_array_equal(eval_utils.peak_pick(x, 3, 1, 5, 6, 0.1, 2),
                                  jax_eval.peak_pick(x, 3, 1, 5, 6, 0.1, 2))


def test_beat_metrics_match_jax(converter_case):
    hier, cases = converter_case
    ptc = PoseTypeConverter(cases["log_rot"][0], hier, joint_names=FLAGSHIP_JOINTS)
    rng = np.random.default_rng(9)
    n, t = 3, 80
    eul = np.cumsum(rng.normal(0, 4, (n, t, 41 * 3)), axis=1).astype(np.float32)
    dv = ptc.scaled_euler_to_dir_vec(eul).reshape(n, t, -1, 3)
    dv_pred = ptc.scaled_euler_to_dir_vec(
        eul + rng.normal(0, 3, eul.shape).astype(np.float32)).reshape(n, t, -1, 3)
    pairs = ptc.angle_pairs
    groups, weights = [list(range(0, 20)), list(range(20, len(pairs)))], [1.0, 0.5]
    for g, w in ((None, None), (groups, weights)):
        rate = eval_utils.compute_angle_change_rate(dv, pairs, g, w)
        rate_ref = jax_eval.compute_angle_change_rate(dv, pairs, g, w)
        assert _max_abs(rate, rate_ref) < BEAT_TOL
    beats = eval_utils.extract_motion_beat_times(rate[0], 20, 0.03)
    np.testing.assert_array_equal(beats, jax_eval.extract_motion_beat_times(rate_ref[0], 20, 0.03))
    assert len(beats) > 2
    wavs = np.stack([_speech(s) for s in range(n)])
    bc = eval_utils.beat_consistency_score(dv, 20, pairs, wavs, 16000)
    bc_ref = jax_eval.beat_consistency_score(dv, 20, pairs, wavs, 16000)
    br = eval_utils.beat_recall_score(dv_pred, dv, 20, pairs)
    br_ref = jax_eval.beat_recall_score(dv_pred, dv, 20, pairs)
    assert np.isfinite([bc, br]).all()
    assert abs(bc - bc_ref) < BEAT_TOL and abs(br - br_ref) < BEAT_TOL
