"""Beat-alignment evaluation metrics.

Port of ``gesture_diffusion_tpu/generation/eval_utils.py`` (numpy on the
host): mean-absolute-angle-change (MAAC) normalised bone-angle change
rates, local-minima motion-beat extraction, beat consistency (motion beats
against audio onsets, Gaussian sigma=0.1) and beat recall (predicted
against ground-truth motion beats).

Audio onsets follow librosa's ``onset.onset_detect`` (librosa is not a
dependency): Slaney-mel power spectral flux with librosa's center
compensation, then adaptive peak picking with librosa's default
window/threshold parameters.  The mel comes from the port's
``ops/audio.py::mel_spectrogram`` (float32 torch FFT).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.audio import mel_spectrogram


# ---------------------------------------------------------------------------
# audio onsets (librosa-equivalent)
# ---------------------------------------------------------------------------

def onset_strength(wav: np.ndarray, sr: int, n_fft: int = 2048,
                   hop_length: int = 512, n_mels: int = 128) -> np.ndarray:
    """Spectral-flux onset envelope over a dB mel spectrogram; one value
    per hop frame.  Mirrors librosa ``onset.onset_strength`` defaults
    (its published 0.10 algorithm; librosa is not a dependency): Slaney-scale,
    Slaney-normalised mel basis (htk=False, norm="slaney" — NOT the HTK
    basis the speech encoder uses), power_to_db(ref=1, amin=1e-10,
    top_db=80), lag-1 positive flux averaged over mel bands, and front
    zero-padding of ``lag + n_fft // (2 * hop)`` frames (center
    compensation) truncated back to the frame count."""
    mel = mel_spectrogram(
        torch.from_numpy(np.asarray(wav)[None].astype(np.float32)),
        sample_rate=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
        htk=False, norm="slaney")[0].numpy()
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    db = np.maximum(db, db.max() - 80.0)
    flux = np.maximum(0.0, db[:, 1:] - db[:, :-1]).mean(axis=0)
    lag = 1
    pad = lag + n_fft // (2 * hop_length)
    return np.concatenate([np.zeros(pad), flux])[: db.shape[1]]


def peak_pick(x: np.ndarray, pre_max: int, post_max: int, pre_avg: int,
              post_avg: int, delta: float, wait: int) -> np.ndarray:
    """librosa ``util.peak_pick`` semantics: local max over
    [i-pre_max, i+post_max), above moving mean + delta, >= wait apart."""
    n = len(x)
    peaks = []
    last = -1 - wait
    for i in range(n):
        lo, hi = max(0, i - pre_max), min(n, i + post_max + 1)
        if x[i] != x[lo:hi].max():
            continue
        alo, ahi = max(0, i - pre_avg), min(n, i + post_avg + 1)
        if x[i] < x[alo:ahi].mean() + delta:
            continue
        if i - last <= wait:
            continue
        peaks.append(i)
        last = i
    return np.array(peaks, dtype=int)


def onset_detect(wav: np.ndarray, sr: int, hop_length: int = 512) -> np.ndarray:
    """Audio onset times in seconds (librosa ``onset_detect(units='time')``
    default parameterisation)."""
    env = onset_strength(wav, sr, hop_length=hop_length)
    if env.max() > env.min():
        env = (env - env.min()) / (env.max() - env.min())
    s = sr / hop_length
    frames = peak_pick(
        env,
        pre_max=int(0.03 * s), post_max=int(0.0 * s) + 1,
        pre_avg=int(0.10 * s), post_avg=int(0.10 * s) + 1,
        delta=0.07, wait=int(0.03 * s))
    return frames * hop_length / sr


# ---------------------------------------------------------------------------
# motion beats
# ---------------------------------------------------------------------------

def compute_angle_change_rate(
    dir_vec_seq_batch: np.ndarray,           # (N, T, J, 3)
    angle_pairs: Sequence[Sequence[int]],
    joint_groups: Optional[Sequence[Sequence[int]]] = None,
    group_weights: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """(N, T) MAAC-normalised, group-weighted angle change rate
    (``eval_utils.py:8-53``); frame 0 is zero."""
    assert dir_vec_seq_batch.ndim == 4
    n, t, j, d = dir_vec_seq_batch.shape
    if joint_groups is None:
        joint_groups = [np.arange(len(angle_pairs))]
        group_weights = [1.0]

    flat = dir_vec_seq_batch.reshape(-1, j, 3)
    i1, i2 = zip(*angle_pairs)
    v1, v2 = flat[:, list(i1)], flat[:, list(i2)]

    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)

    dot = np.clip((unit(v1) * unit(v2)).sum(-1), -1.0, 1.0)
    angle = (np.arccos(dot) / math.pi).reshape(n, t, -1)
    diff = np.abs(np.diff(angle, axis=1))                   # (N, T-1, P)
    maac = diff.mean(axis=(0, 1), keepdims=True)
    rate = np.divide(diff, maac, out=np.zeros_like(diff), where=maac != 0)

    weights = np.zeros_like(rate)
    for group, w in zip(joint_groups, group_weights):
        weights[:, :, list(group)] = w
    rate = (weights * rate).mean(axis=-1)
    return np.concatenate([np.zeros((n, 1)), rate], axis=1)


def extract_motion_beat_times(angle_change_rate: np.ndarray, motion_fps: int,
                              thres: float) -> np.ndarray:
    """Local minima deeper than ``thres`` -> beat times in seconds
    (``eval_utils.py:56-72``)."""
    x = angle_change_rate
    times = [
        t / motion_fps
        for t in range(2, len(x) - 1)
        if x[t] < x[t - 1] and x[t] < x[t + 1]
        and (x[t - 1] - x[t] >= thres or x[t + 1] - x[t] >= thres)
    ]
    return np.array(times)


def _gaussian_recall(query_times: np.ndarray, key_times: np.ndarray,
                     sigma: float) -> float:
    """mean over query of exp(-min_dist^2 / (2 sigma^2)) against keys."""
    if len(key_times) == 0:
        return 0.0
    d2 = (query_times[:, None] - key_times[None, :]) ** 2
    return float(np.mean(np.exp(-d2.min(axis=1) / (2.0 * sigma**2))))


def beat_consistency_score(
    dir_vec_seq_batch: np.ndarray,            # (N, T, J, 3)
    motion_fps: int,
    angle_pairs: Sequence[Sequence[int]],
    wav_seq_batch: np.ndarray,                # (N, T_wav)
    wav_sr: int,
    joint_groups=None,
    group_weights=None,
    motion_beat_threshold: float = 0.03,
    sigma: float = 0.1,
) -> float:
    """How well audio onsets land near motion beats (``eval_utils.py:75-113``)."""
    rate = compute_angle_change_rate(
        dir_vec_seq_batch, angle_pairs, joint_groups, group_weights)
    scores = []
    for b in range(len(dir_vec_seq_batch)):
        motion_beats = extract_motion_beat_times(
            rate[b], motion_fps, motion_beat_threshold)
        if len(motion_beats) == 0:
            continue
        audio_beats = onset_detect(np.asarray(wav_seq_batch[b]), wav_sr)
        if len(audio_beats) == 0:
            continue
        scores.append(_gaussian_recall(audio_beats, motion_beats, sigma))
    return float(np.mean(scores)) if scores else float("nan")


def beat_recall_score(
    pred_dir_vec_seq_batch: np.ndarray,
    target_dir_vec_seq_batch: np.ndarray,
    motion_fps: int,
    angle_pairs: Sequence[Sequence[int]],
    joint_groups=None,
    group_weights=None,
    motion_beat_threshold: float = 0.03,
    sigma: float = 0.1,
) -> float:
    """How well predicted motion beats recall ground-truth beats
    (``eval_utils.py:116-160``)."""
    pred_rate = compute_angle_change_rate(
        pred_dir_vec_seq_batch, angle_pairs, joint_groups, group_weights)
    tgt_rate = compute_angle_change_rate(
        target_dir_vec_seq_batch, angle_pairs, joint_groups, group_weights)
    scores = []
    for pr, tr in zip(pred_rate, tgt_rate):
        pred_beats = extract_motion_beat_times(pr, motion_fps, motion_beat_threshold)
        tgt_beats = extract_motion_beat_times(tr, motion_fps, motion_beat_threshold)
        if len(tgt_beats) == 0:
            continue
        scores.append(_gaussian_recall(tgt_beats, pred_beats, sigma))
    return float(np.mean(scores)) if scores else float("nan")
