"""Mocap feature extraction: foot-contact signals.

A copy of ``gesture_diffusion_tpu/export/features.py`` (numpy only), kept
here so the port never imports the JAX package: the reference's
peakutils-based up/down peak picking on a foot-height or velocity signal
(``pymo/features.py:12-43``), with the same thresholded-local-maximum
semantics written in numpy, turned into a binary contact track.
"""

from __future__ import annotations

from typing import List

import numpy as np


def peak_indexes(signal: np.ndarray, thres: float = 0.3,
                 min_dist: int = 1) -> np.ndarray:
    """peakutils.indexes semantics: strict local maxima above
    ``min + thres * (max - min)``, greedily separated by ``min_dist``."""
    signal = np.asarray(signal, float)
    if len(signal) < 3:
        return np.array([], dtype=int)
    with np.errstate(invalid="ignore"):
        # inf threshold on a flat signal -> nan floor -> no peaks (the
        # same silent outcome peakutils produces); suppress the warning
        floor = signal.min() + thres * (signal.max() - signal.min())
    cand = np.where(
        (signal[1:-1] > signal[:-2]) & (signal[1:-1] > signal[2:])
        & (signal[1:-1] > floor))[0] + 1
    if min_dist <= 1 or len(cand) == 0:
        return cand
    keep: List[int] = []
    for i in cand[np.argsort(-signal[cand])]:   # highest first
        if all(abs(i - j) >= min_dist for j in keep):
            keep.append(i)
    return np.array(sorted(keep), dtype=int)


def get_foot_contact_idxs(signal: np.ndarray, t: float = 0.02,
                          min_dist: int = 120):
    """:return: [up_indices, down_indices] — peaks of the signal and of its
    negation (reference ``features.py:12-16``).

    Bug-compat: the reference passes ``thres=t/min(signal)`` for the
    down-peaks — NEGATIVE whenever the signal dips below zero (the usual
    case for a velocity trace), and peakutils does not clamp it, so the
    floor lands below the minimum and EVERY strict local maximum of
    ``-signal`` survives thresholding.  Reproduced exactly (a positive
    ``t/|min|`` was a silent deviation that suppressed down-peaks).  A
    zero max/min maps to an infinite threshold (numpy division), which
    peakutils turns into 'no peaks' — also matched."""
    signal = np.asarray(signal, float)
    with np.errstate(divide="ignore"):
        up = peak_indexes(signal, thres=float(t / np.float64(signal.max())),
                          min_dist=min_dist)
        down = peak_indexes(-signal, thres=float(t / np.float64(signal.min())),
                            min_dist=min_dist)
    return [up, down]


def create_foot_contact_signal(signal: np.ndarray, start: int = 1,
                               t: float = 0.02, min_dist: int = 120
                               ) -> np.ndarray:
    """Binary contact track: 0 after a down-peak, 1 after an up-peak
    (reference ``features.py:19-33``)."""
    up, down = get_foot_contact_idxs(signal, t, min_dist)
    up_set, down_set = set(up.tolist()), set(down.tolist())
    out = np.empty(len(signal), dtype=int)
    c = start
    for f in range(len(signal)):
        if f in down_set:
            c = 0
        elif f in up_set:
            c = 1
        out[f] = c
    return out
