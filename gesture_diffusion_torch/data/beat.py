"""BEAT dataset prep: recordings -> 60 s sample pickles (the `prep` phase).

Port of ``gesture_diffusion_tpu/data/beat.py`` (numpy and scipy only), so
that a machine without JAX goes from the corpus to trained models.  The
pickles it writes are those of the JAX package, array for array: the same
5 s sync, per-recording begin-time offsets, word-id track, chunking and
split.  The 8:1:1 split is sklearn's stratified ``train_test_split``,
reproduced in numpy index for index (``stratified_train_test_split``), so
that the port needs no sklearn.

Audio: scipy's wav read, librosa's 2**(bits-1) scaling, and a polyphase
resample to the target rate, mono float32 in [-1, 1]; TextGrid words come
from :mod:`.textgrid`.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from math import ceil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pipeline import load_from_bvh
from .textgrid import read_textgrid
from .vocab import Vocab

# Per-recording audio begin-time corrections for speaker 1 ("wayne"),
# measured by the reference authors (``data_utils.py:312-355``).  Keys are
# substrings of the recording path.
WAV_BEGIN_TIME_OFFSETS: Dict[str, float] = {
    "1_wayne_0_1_8": 0.3, "1_wayne_0_9_16": 1.0, "1_wayne_0_17_24": 0.5,
    "1_wayne_0_25_32": 0.8, "1_wayne_0_33_40": 0.5, "1_wayne_0_41_48": 0.5,
    "1_wayne_0_49_56": 1.0, "1_wayne_0_57_64": 0.5, "1_wayne_0_65_72": 0.3,
    "1_wayne_0_73_80": 0.2, "1_wayne_0_81_86": 0.5, "1_wayne_0_87_94": 1.0,
    "1_wayne_0_95_102": 0.5, "1_wayne_0_103_110": 1.0, "1_wayne_0_111_118": 0.7,
    "1_wayne_1_3_4": 1.0, "1_wayne_1_11_12": 0.8,
}
UNSYNCABLE = ("1_wayne_1_1_2",)
BASE_TIME = 5.0


def load_wav(path: str, target_sr: int) -> np.ndarray:
    """Mono float32 in [-1, 1] at target_sr (librosa.load equivalent)."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.dtype.kind == "i":
        # librosa (util.buf_to_float) scales by 2**(bits-1) = 32768 for
        # int16, NOT iinfo.max = 32767: int16 min maps to exactly -1.0
        data = data.astype(np.float32) / float(2 ** (8 * data.dtype.itemsize - 1))
    elif data.dtype.kind == "u":
        # unsigned PCM is centered on 2**(bits-1) (128 for u8)
        half = float(2 ** (8 * data.dtype.itemsize - 1))
        data = (data.astype(np.float32) - half) / half
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != target_sr:
        g = np.gcd(sr, target_sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return data


def load_from_face(facial_path: str, src_fps: int = 60, tgt_fps: int = 15):
    """BEAT facial JSON -> (T, n_weights) at tgt_fps (``data_utils.py:206-221``)."""
    reduce_factor = int(src_fps / tgt_fps)
    with open(facial_path) as f:
        facial_data = json.load(f)
    weights = [frame["weights"]
               for i, frame in enumerate(facial_data["frames"])
               if i % reduce_factor == 0]
    arr = np.array(weights)
    return arr, len(arr) / tgt_fps


def _build_vocab(src_dir_path: str, human_ids: Sequence[int],
                 word_vec_path: Optional[str], spt_dir_path: str) -> Vocab:
    """Index every TextGrid word for the given speakers and pickle the
    vocab (shared by both split variants; ``data_utils.py:232-247``)."""
    vocab = Vocab("word")
    vocab.load_word_vectors(word_vec_path)
    for hid in human_ids:
        for tg_path in sorted(glob.glob(
                os.path.join(src_dir_path, str(hid), "*.TextGrid"))):
            for iv in read_textgrid(tg_path)[0]:
                if iv.mark:
                    vocab.index_word(iv.mark)
    with open(os.path.join(spt_dir_path, "vocab.pkl"), "wb") as f:
        pickle.dump(vocab, f)
    return vocab


def _require_modalities(bvh_path: str) -> Tuple[str, str]:
    """(wav_path, tg_path) next to a .bvh; FileNotFoundError if absent."""
    wav_path = bvh_path[:-4] + ".wav"
    tg_path = bvh_path[:-4] + ".TextGrid"
    for p, what in [(wav_path, "wav"), (tg_path, "TextGrid")]:
        if not os.path.exists(p):
            raise FileNotFoundError(f"{what} file not found for {bvh_path}")
    return wav_path, tg_path


def _concat_split(lists: Dict[str, list], what: str) -> Dict[str, np.ndarray]:
    """Concatenate per-recording sample lists; a clear error instead of
    np.concatenate's 'need at least one array' when a split ended up with
    no recordings (every file skip-logged, or no official-split match)."""
    empty = [k for k, v in lists.items() if not v]
    if empty:
        raise ValueError(
            f"no samples collected for {what} (keys {empty}): every matching "
            "recording failed or none matched — see split_dataset.log")
    return {k: np.concatenate(v, axis=0) for k, v in lists.items()}


def split_dataset(
    src_dir_path: str,
    human_ids: Sequence[int],
    wav_sr: int,
    sample_duration: float,
    spt_dir_path: str,
    pose_fps: int = 20,
    joints: Optional[List[str]] = None,
    word_vec_path: Optional[str] = None,
    use_face: bool = False,
    face_fps: int = 15,
    seed: int = 0,
) -> None:
    """Walk BEAT/{hid}/*.bvh, sync modalities, chunk to sample_duration,
    stratified 8:1:1 split, write {train,val,test}_samples.pkl + vocab.pkl."""
    os.makedirs(spt_dir_path, exist_ok=True)
    log_path = os.path.join(spt_dir_path, "split_dataset.log")
    log = open(log_path, "w")

    vocab = _build_vocab(src_dir_path, human_ids, word_vec_path, spt_dir_path)

    # ---- chunk every recording ------------------------------------------
    lists: Dict[str, list] = {"hid": [], "pose": [], "wav": [], "word_id": []}
    if use_face:
        lists["face"] = []

    for hid in human_ids:
        for bvh_path in sorted(glob.glob(os.path.join(src_dir_path, str(hid), "*.bvh"))):
            if any(tag in bvh_path for tag in UNSYNCABLE):
                # skipped as in the JAX package, and logged (the JAX log
                # has no line for it)
                print(f"[Info] Skipped (unsyncable): {bvh_path}")
                print(f"[Info] Skipped (unsyncable): {bvh_path}", file=log)
                continue
            try:
                wav_path, tg_path = _require_modalities(bvh_path)
                poses, pose_dur = load_from_bvh(bvh_path, joints, pose_fps)
                wav = load_wav(wav_path, wav_sr)
                wav_dur = len(wav) / wav_sr

                pose_begin = BASE_TIME
                wav_begin = BASE_TIME + next(
                    (v for k, v in WAV_BEGIN_TIME_OFFSETS.items() if k in bvh_path), 0.0)
                poses = poses[int(pose_begin * pose_fps):]
                pose_dur -= pose_begin
                wav = wav[int(wav_begin * wav_sr):]
                wav_dur -= wav_begin

                durations = [pose_dur, wav_dur]
                faces = None
                if use_face:
                    faces, face_dur = load_from_face(bvh_path[:-4] + ".json",
                                                     tgt_fps=face_fps)
                    faces = faces[int(BASE_TIME * face_fps):]
                    durations.append(face_dur - BASE_TIME)

                # word-id track at pose fps
                word_ids = np.zeros((len(poses),))
                for iv in read_textgrid(tg_path)[0]:
                    if not iv.mark:
                        continue
                    sf = int((iv.min_time - BASE_TIME) * pose_fps)
                    ef = int((iv.max_time - BASE_TIME) * pose_fps)
                    if sf >= 0:
                        word_ids[sf:ef] = vocab.get_word_index(iv.mark)

                shorter = min(durations)
                poses = poses[: int(shorter * pose_fps)]
                word_ids = word_ids[: int(shorter * pose_fps)]
                wav = wav[: int(shorter * wav_sr)]
                if use_face:
                    # int(shorter * face_fps), NOT the reference's
                    # int(shorter) * face_fps (data_utils.py floors the
                    # SECONDS, under-allocating the face track for
                    # fractional durations and crashing the window
                    # gather below) — deviation: consistent with the
                    # pose/wav truncation two lines up
                    faces = faces[: int(shorter * face_fps)]

                starts = np.arange(0, shorter, sample_duration)[:-1]
                pw = int(sample_duration * pose_fps)
                ww = int(sample_duration * wav_sr)
                fw = int(sample_duration * face_fps)
                n_samples = len(starts)
                if n_samples == 0:
                    raise ValueError(f"recording shorter than {sample_duration}s")

                p_idx = np.stack([np.arange(int(st * pose_fps), int(st * pose_fps) + pw)
                                  for st in starts])
                w_idx = np.stack([np.arange(int(st * wav_sr), int(st * wav_sr) + ww)
                                  for st in starts])
                lists["hid"].append(np.full(n_samples, hid))
                lists["pose"].append(poses[p_idx])
                lists["wav"].append(wav[w_idx])
                lists["word_id"].append(word_ids[p_idx])
                if use_face:
                    f_idx = np.stack([np.arange(int(st * face_fps),
                                                int(st * face_fps) + fw)
                                      for st in starts])
                    lists["face"].append(faces[f_idx])
                print(f"[Info] Processed: {bvh_path}", file=log)
            except Exception as msg:  # skip-and-log per recording (ref :423-425)
                print(f"[Error] {msg} {bvh_path}")
                print(f"[Error] {msg} {bvh_path}", file=log)
    log.close()

    data = _concat_split(lists, "the dataset")
    _stratified_split_and_save(data, spt_dir_path, seed)


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``utils.extmath._approximate_mode``: the per-class draw
    counts, floored shares of ``n_draws`` topped up by remainder, ties in
    the remainder broken at random from ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_train_test_split(
    x: np.ndarray, test_size: float, stratify: np.ndarray, random_state: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``sklearn.model_selection.train_test_split(x, test_size=test_size,
    shuffle=True, stratify=stratify, random_state=random_state)`` for one
    array and a float ``test_size``: (x[train], x[test]), the indices drawn
    as sklearn 1.x's ``StratifiedShuffleSplit`` draws them, in its order,
    from one ``np.random.RandomState(random_state)``.  Raises where sklearn
    raises: a size outside (0, 1), an empty train set, a class of fewer
    than 2 members, fewer train or test rows than classes."""
    x, y = np.asarray(x), np.asarray(stratify)
    n = len(x)
    if not 0 < test_size < 1:
        raise ValueError(
            "The 'test_size' parameter of train_test_split must be a float in "
            "the range (0.0, 1.0), an int in the range [1, inf) or None. Got "
            f"{test_size!r} instead.")
    n_test = ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and train_size=None, "
            "the resulting train set will be empty. Adjust any of the "
            "aforementioned parameters.")
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is "
            "too few. The minimum number of groups for any class cannot be "
            "less than 2. Classes with too few members are: "
            f"{classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or "
                         f"equal to the number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or "
                         f"equal to the number of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return x[rng.permutation(train)], x[rng.permutation(test)]


def _stratified_split_and_save(data: Dict[str, np.ndarray], spt_dir_path: str,
                               seed: int = 0) -> None:
    """8:1:1 stratified by hid, random_state 0 (``data_utils.py:436-450``),
    always stratified, as the JAX package and the reference split: a
    single-speaker corpus draws another permutation than a plain shuffle."""
    keys = list(data)
    idx = np.arange(len(data["hid"]))
    train_idx, rest_idx = stratified_train_test_split(
        idx, 0.2, data["hid"], seed)
    test_idx, val_idx = stratified_train_test_split(
        rest_idx, 0.5, data["hid"][rest_idx], seed)
    for split, sel in [("train", train_idx), ("val", val_idx), ("test", test_idx)]:
        obj = {k: data[k][sel] for k in keys}
        with open(os.path.join(spt_dir_path, f"{split}_samples.pkl"), "wb") as f:
            pickle.dump(obj, f)


# Official BEAT split (https://github.com/PantoMatrix/BEAT/issues/6): for
# 4-hour speakers, these recording indices form the test/val sets
# (reference ``data_utils.py:522-527``).
OFFICIAL_SPLIT_4H = {
    "test_seq": (1, 2, 3, 4, 5, 6, 7, 8, 65, 73, 81, 87, 95, 103, 111),
    "test_conv": (1,),
    "val_seq": (56, 57, 58, 59, 60, 61, 62, 63, 64, 72, 80, 86, 94, 102,
                110, 118),
    "val_conv": (12,),
}
FOUR_HOUR_SPEAKERS = (1, 2, 3, 4, 6, 7, 8, 9, 11, 21)


def split_dataset_official(
    src_dir_path: str,
    human_ids: Sequence[int],
    wav_sr: int,
    sample_duration: float,
    spt_dir_path: str,
    pose_fps: int = 20,
    joints: Optional[List[str]] = None,
    word_vec_path: Optional[str] = None,
) -> None:
    """Official-split prep variant (``data_utils.py:464-664``): recordings
    are routed to train/val/test by their filename indices
    ``{hid}_{name}_{type}_{i}_{i}`` instead of a random stratified split;
    no begin-time sync is applied."""
    os.makedirs(spt_dir_path, exist_ok=True)
    log = open(os.path.join(spt_dir_path, "split_dataset.log"), "w")

    vocab = _build_vocab(src_dir_path, human_ids, word_vec_path, spt_dir_path)

    splits = {s: {"hid": [], "pose": [], "wav": [], "word_id": []}
              for s in ("train", "val", "test")}
    for hid in human_ids:
        if hid not in FOUR_HOUR_SPEAKERS:
            raise NotImplementedError(
                f"official split indices only known for 4-hour speakers, got {hid}")
        idx = OFFICIAL_SPLIT_4H
        for bvh_path in sorted(glob.glob(os.path.join(src_dir_path, str(hid), "*.bvh"))):
            try:
                wav_path, tg_path = _require_modalities(bvh_path)
                poses, pose_dur = load_from_bvh(bvh_path, joints, pose_fps)
                wav = load_wav(wav_path, wav_sr)
                word_ids = np.zeros((len(poses),))
                for iv in read_textgrid(tg_path)[0]:
                    if iv.mark:
                        sf = int(iv.min_time * pose_fps)
                        if 0 <= sf < len(word_ids):
                            word_ids[sf] = vocab.get_word_index(iv.mark)

                shorter = min(pose_dur, len(wav) / wav_sr)
                poses = poses[: int(shorter * pose_fps)]
                word_ids = word_ids[: int(shorter * pose_fps)]
                wav = wav[: int(shorter * wav_sr)]

                starts = np.arange(0, shorter, sample_duration)[:-1]
                if len(starts) == 0:
                    raise ValueError(f"recording shorter than {sample_duration}s")
                pw, ww = int(sample_duration * pose_fps), int(sample_duration * wav_sr)
                p_idx = np.stack([np.arange(int(st * pose_fps),
                                            int(st * pose_fps) + pw) for st in starts])
                w_idx = np.stack([np.arange(int(st * wav_sr),
                                            int(st * wav_sr) + ww) for st in starts])

                parts = os.path.basename(bvh_path)[:-4].split("_")
                ty, i1, i2 = parts[-3], int(parts[-2]), int(parts[-1])
                if i1 != i2:
                    raise ValueError("last two numbers of file name must agree")
                if ty == "0":
                    split = ("test" if i1 in idx["test_seq"] else
                             "val" if i1 in idx["val_seq"] else "train")
                elif ty == "1":
                    split = ("test" if i1 in idx["test_conv"] else
                             "val" if i1 in idx["val_conv"] else "train")
                else:
                    raise ValueError(f"Unsupported recording type -> {ty}")

                splits[split]["hid"].append(np.full(len(starts), hid))
                splits[split]["pose"].append(poses[p_idx])
                splits[split]["wav"].append(wav[w_idx])
                splits[split]["word_id"].append(word_ids[p_idx])
                print(f"[Info] Processed ({split}): {bvh_path}", file=log)
            except Exception as msg:
                print(f"[Error] {msg} {bvh_path}")
                print(f"[Error] {msg} {bvh_path}", file=log)
    log.close()

    for split, lists in splits.items():
        obj = _concat_split(lists, f"split '{split}'")
        with open(os.path.join(spt_dir_path, f"{split}_samples.pkl"), "wb") as f:
            pickle.dump(obj, f)


def preprocess_data(
    src_dir_path: str,
    human_ids: Sequence[int],
    pose_fps: int,
    wav_sr: int,
    sample_duration: float,
    spt_dir_path: str,
    joints: Optional[List[str]] = None,
    word_vec_path: Optional[str] = None,
) -> None:
    """Phase entry point (``dataset_creation.py:7-29``), with the signature
    the CLI actually uses — fixing the reference's pose_fps-kwarg crash.
    A missing corpus raises ``FileNotFoundError`` (the JAX package asserts,
    with the same message)."""
    if not os.path.exists(src_dir_path):
        raise FileNotFoundError(f"Source data not found at {src_dir_path}")
    if os.path.exists(spt_dir_path) and os.listdir(spt_dir_path):
        raise FileExistsError(
            f"Data already exists at {spt_dir_path}. Manually remove before recreating.")
    split_dataset(
        src_dir_path=src_dir_path, human_ids=human_ids, wav_sr=wav_sr,
        sample_duration=sample_duration, spt_dir_path=spt_dir_path,
        pose_fps=pose_fps, joints=joints, word_vec_path=word_vec_path)
