"""Windowed dataset construction (the ``data`` phase).

Port of ``gesture_diffusion_tpu/data/pipeline.py``.  This is host work by
design: numpy arrays in, numpy arrays out, and the rotation conversions
run through the port's torch ``ops/rotation.py`` on the CPU in float32, as
the JAX package pins them to its CPU backend.  The artifacts have the JAX
package's names and keys and hold numpy arrays, so a ``dst_dir_path``
built by either package loads in the other:

  {split}_samples.pkl : {"hid": (N,), "pose": (N, T60, C_euler), "wav": (N, T_wav60)}
  {split}_data.pkl    : {"wav": (M, T_wav_win), "pose": (M, T_win, C), "params"}
  {split}_seqs.pkl    : {"hid", "wav", "pose", "params"} full sequences (test split)
  scaler.npz          : StandardScaler fit on train (the reference's
                        scaler.jl is also readable)
  scaler_params.json  : the (pose_fps, representation) the scaler was fit with
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import rotation as rot
from ..ops.scaler import StandardScaler
from ..training.data import ArrayDataset
from .bvh import parse_bvh


def load_from_bvh(
    bvh_path: str,
    joints: Optional[List[str]] = None,
    tgt_fps: int = 20,
    expected_framerate: float = 0.008333,
) -> Tuple[np.ndarray, float]:
    """Parse + downsample + joint-select (``data_utils.py:175-203``).

    DownSampler semantics (pymo ``preprocessing.py:1244-1276``): integer
    frame stride ``round(1/framerate) // tgt_fps`` over frames [0, -1)
    (the final frame is dropped).
    """
    data = parse_bvh(bvh_path)
    if expected_framerate is not None and abs(data.framerate - expected_framerate) > 1e-9:
        raise ValueError(f"Framerate exception: {data.framerate}")
    orig_fps = round(1.0 / data.framerate)
    if orig_fps % tgt_fps != 0:
        raise ValueError(f"orig fps {orig_fps} not divisible by tgt {tgt_fps}")
    rate = orig_fps // tgt_fps
    values = data.values[0:-1:rate]
    if joints is not None:
        cols = data.joint_columns(joints)
        values = values[:, cols]
        if "Hips" in joints or "hips" in joints:
            values = values[:, 3:]  # drop root translation
    duration = values.shape[0] / tgt_fps
    return values, duration


def resample_pose_seq(poses: np.ndarray, duration_in_sec: float,
                      tgt_fps: int) -> np.ndarray:
    """Linear resampling to tgt_fps (``data_utils.py:667-677`` semantics:
    sample points ``arange(0, n, n/expected_n)``, linear interp with
    LINEAR EXTRAPOLATION past the last frame — interp1d
    ``fill_value="extrapolate"``: clamping ``idx0`` to ``n-2`` and letting
    ``frac`` exceed 1 continues the last segment's slope, which clamping
    at the last frame did not (tail frames were held flat whenever
    ``expected_n`` does not divide ``n``)."""
    n = len(poses)
    if n < 2:
        raise ValueError(
            f"resample_pose_seq needs >= 2 frames, got {n}")  # ref: interp1d raises too
    expected_n = duration_in_sec * tgt_fps
    x_new = np.arange(0, n, n / expected_n)
    idx0 = np.clip(np.floor(x_new).astype(int), 0, n - 2)
    idx1 = idx0 + 1
    frac = (x_new - idx0).astype(poses.dtype if hasattr(poses, "dtype") else np.float64)
    out = poses[idx0] * (1 - frac)[:, None] + poses[idx1] * frac[:, None]
    return out.astype(poses.dtype) if hasattr(poses, "dtype") else out


def convert_representation(poses: np.ndarray, representation: str) -> np.ndarray:
    """(N, T, C_euler) euler degrees -> (N, T, C_repr), with the temporal
    expmap unroll for log_rot.  Host-side data prep: float32 torch ops on
    the CPU, whatever device the model runs on."""
    n, t, c = poses.shape
    if representation == "euler":
        return poses
    eul = torch.as_tensor(np.asarray(poses).reshape(n, t, -1, 3),
                          dtype=torch.float32)
    if representation == "6d":
        return rot.euler_to_ortho6d(eul).numpy().reshape(n, t, -1)
    if representation == "log_rot":
        rv = rot.euler_to_rotvec(eul)                    # (N, T, J, 3)
        rv = rot.unroll_rotvec(rv.transpose(1, 2))       # per-joint unroll over T
        return rv.transpose(1, 2).numpy().reshape(n, t, -1)
    raise ValueError(f"Unsupported pose_representation {representation}")


def window_slice(
    poses: np.ndarray,          # (N, T, C) scaled
    wavs: np.ndarray,           # (N, T_wav)
    pose_window_len: int,
    pose_stride_len: int,
    pose_fps: int,
    wav_sr: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Strided window extraction with zero padding (``dataset.py:82-121``):
    chunks per sample = ceil(T / stride); pose and wav windows start at the
    same wall-clock time."""
    n, t, c = poses.shape
    num_chunks = int(np.ceil(t / pose_stride_len))
    wav_window_len = int(pose_window_len / pose_fps * wav_sr)

    poses = np.concatenate(
        [poses, np.zeros((n, pose_window_len, c), poses.dtype)], axis=1)
    wavs = np.concatenate(
        [wavs, np.zeros((n, wav_window_len), wavs.dtype)], axis=1)

    pose_starts = np.arange(num_chunks) * pose_stride_len          # (K,)
    pose_idx = pose_starts[:, None] + np.arange(pose_window_len)   # (K, W)
    wav_starts = (pose_starts / pose_fps * wav_sr).astype(int)
    wav_idx = wav_starts[:, None] + np.arange(wav_window_len)

    pose_windows = poses[:, pose_idx].reshape(-1, pose_window_len, c)
    wav_windows = wavs[:, wav_idx].reshape(-1, wav_window_len)
    return pose_windows, wav_windows


def _load_cache(path: str, keys: Tuple[str, ...]) -> Optional[dict]:
    """Read a derived-artifact pickle; None (→ rebuild) if it is corrupt.

    A truncated or foreign ``_data.pkl``/``_seqs.pkl`` (killed run, disk
    full) used to crash every subsequent phase with a bare UnpicklingError
    until the file was deleted by hand — but these are CACHES, rebuildable
    from ``_samples.pkl``, so degrade instead of dying."""
    try:
        with open(path, "rb") as f:
            loaded = pickle.load(f)
        if not isinstance(loaded, dict) or any(k not in loaded for k in keys):
            raise ValueError(f"missing keys (expected {keys})")
        return loaded
    except FileNotFoundError:
        return None
    except Exception as e:
        print(f"[Warning] {path}: unreadable cache ({type(e).__name__}: "
              f"{e}); rebuilding")
        return None


def _dump_cache(path: str, payload: dict) -> None:
    """Atomic cache write: a killed run leaves the old file (or nothing),
    never a truncated pickle."""
    # pid-suffixed tmp: concurrent builders of the same split (multihost
    # prep on a shared filesystem) must not write through one shared tmp
    # file — last os.replace wins, nobody crashes, no torn pickle
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


class WindowedDataset:
    """TrainDataset-equivalent: cached windowed tensors.

    :ivar wavs:  (M, T_wav_win) float32
    :ivar poses: (M, T_win, C) float32 (standard-scaled representation)
    """

    def __init__(
        self,
        samples_path: str,
        dst_dir_path: str,
        pose_window_len: int,
        pose_stride_len: int,
        pose_fps: int,
        wav_sr: int,
        pose_representation: str,
        keep_seqs: bool = False,
    ):
        base = os.path.basename(samples_path)
        data_path = os.path.join(
            dst_dir_path, base.replace("_samples.pkl", "_data.pkl"))
        seq_path = os.path.join(
            dst_dir_path, base.replace("_samples.pkl", "_seqs.pkl"))
        scaler_path = os.path.join(dst_dir_path, "scaler.npz")
        legacy_scaler = os.path.join(dst_dir_path, "scaler.jl")

        params = {"pose_window_len": pose_window_len,
                  "pose_stride_len": pose_stride_len, "pose_fps": pose_fps,
                  "wav_sr": wav_sr, "pose_representation": pose_representation}
        if os.path.exists(data_path) and (not keep_seqs or os.path.exists(seq_path)):
            cached = _load_cache(data_path, ("wav", "pose"))
            seqs = _load_cache(seq_path, ("hid", "wav", "pose")) if keep_seqs \
                else None
            # a cache built with different window/fps/representation params
            # must not be silently reused (it has the wrong shapes or, for
            # a different representation of the same dim, wrong VALUES).
            # BOTH pickles are validated: seqs.pkl can be stale independently
            # of data.pkl (built under old params with keep_seqs=True, then
            # data.pkl alone rebuilt with keep_seqs=False).  Param-less
            # caches (reference-era pickles) are trusted as-is.
            stale = [p for p, c in [(data_path, cached), (seq_path, seqs)]
                     if c is not None and c.get("params", params) != params]
            if not stale and cached is not None and (not keep_seqs
                                                     or seqs is not None):
                self.wavs, self.poses = cached["wav"], cached["pose"]
                if keep_seqs:
                    self.hid_seqs, self.wav_seqs, self.pose_seqs = (
                        seqs["hid"], seqs["wav"], seqs["pose"])
                return
            if stale:
                print(f"[Warning] {', '.join(stale)} built with different "
                      f"params than {params} requested; rebuilding")

        os.makedirs(dst_dir_path, exist_ok=True)
        try:
            with open(samples_path, "rb") as f:
                samples = pickle.load(f)
            if not isinstance(samples, dict) or "pose" not in samples \
                    or "wav" not in samples:
                raise ValueError("not a {hid, pose, wav} samples dict")
        except FileNotFoundError:
            # a missing input is not a corrupt one — name the real remedy
            raise FileNotFoundError(
                f"{samples_path}: samples pickle not found; run the prep "
                "phase first (--phase prep)") from None
        except Exception as e:
            # unlike the _data/_seqs caches this is a real input artifact —
            # it cannot be rebuilt from here, so fail with the remedy
            raise ValueError(
                f"{samples_path}: corrupt or unrecognised samples pickle "
                f"({type(e).__name__}: {e}); re-run the prep phase") from e
        hids = samples.get("hid")
        poses = np.asarray(samples["pose"])
        wavs = np.asarray(samples["wav"])

        duration = wavs.shape[1] / wav_sr
        poses = np.stack([resample_pose_seq(x, duration, pose_fps) for x in poses])
        poses = convert_representation(poses, pose_representation)

        # the scaler is fitted on the TRAIN split's resampled+converted
        # sequences, so its validity is keyed on (pose_fps, representation)
        # only — window/stride changes don't touch it.  A non-train rebuild
        # under new params must NOT silently normalise with a scaler fitted
        # under the old ones (wrong stats, or a shape crash); the sidecar
        # records what the scaler was fitted with.  Sidecar-less scalers
        # (reference-era .jl / earlier .npz) are trusted as-is.
        scaler_params = {"pose_fps": pose_fps,
                         "pose_representation": pose_representation}
        sidecar = os.path.join(dst_dir_path, "scaler_params.json")
        n, t, c = poses.shape
        if "train" in base:
            scaler = StandardScaler.fit(poses.reshape(n * t, c))
            scaler.save(scaler_path)
            with open(sidecar, "w") as f:
                json.dump(scaler_params, f)
        else:
            if os.path.exists(sidecar):
                with open(sidecar) as f:
                    fitted_with = json.load(f)
                if fitted_with != scaler_params:
                    raise ValueError(
                        f"scaler in {dst_dir_path} was fitted with "
                        f"{fitted_with} but {scaler_params} requested; "
                        "rebuild the train split first")
            if os.path.exists(scaler_path):
                scaler = StandardScaler.load(scaler_path)
            elif os.path.exists(legacy_scaler):
                scaler = StandardScaler.load(legacy_scaler)
            else:
                raise ValueError(
                    f"no scaler in {dst_dir_path} (expected scaler.npz or "
                    "the reference's scaler.jl): build the train split "
                    "first — it fits and saves the scaler")
        poses = scaler.transform(poses.reshape(n * t, c)).reshape(n, t, c)

        if keep_seqs:
            self.hid_seqs, self.wav_seqs, self.pose_seqs = hids, wavs, poses
            _dump_cache(seq_path, {"hid": hids, "wav": wavs, "pose": poses,
                                   "params": params})

        self.poses, self.wavs = window_slice(
            poses, wavs, pose_window_len, pose_stride_len, pose_fps, wav_sr)
        _dump_cache(data_path, {"wav": self.wavs, "pose": self.poses,
                                "params": params})

    # -- reference API ------------------------------------------------------
    def __len__(self):
        return len(self.wavs)

    def get_dims(self):
        return {"d_pose": self.poses.shape[2]}

    def get_samples(self):
        return {"pose": self.poses, "wav": self.wavs}

    def get_seqs(self):
        return {"hid": self.hid_seqs, "pose": self.pose_seqs, "wav": self.wav_seqs}

    def as_arrays(self) -> ArrayDataset:
        return ArrayDataset({"wav": self.wavs, "pose": self.poses})


def load_processed_datasets(
    pose_fps: int,
    wav_sr: int,
    spt_dir_path: str,
    dst_dir_path: str,
    pose_window_len: int,
    pose_stride_len: int,
    pose_representation: str,
):
    """Train/val/test construction (``dataset_creation.py:32-69``: val/test
    use stride == window so windows don't overlap; test keeps sequences)."""
    common = dict(pose_fps=pose_fps, wav_sr=wav_sr,
                  pose_representation=pose_representation,
                  dst_dir_path=dst_dir_path, pose_window_len=pose_window_len)
    train = WindowedDataset(
        os.path.join(spt_dir_path, "train_samples.pkl"),
        pose_stride_len=pose_stride_len, **common)
    val = WindowedDataset(
        os.path.join(spt_dir_path, "val_samples.pkl"),
        pose_stride_len=pose_window_len, **common)
    test = WindowedDataset(
        os.path.join(spt_dir_path, "test_samples.pkl"),
        pose_stride_len=pose_window_len, keep_seqs=True, **common)
    return train, val, test
