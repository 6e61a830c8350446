"""Waveform front-end: pre-emphasis + mel spectrogram + instance norm.

Port of ``gesture_diffusion_tpu/ops/audio.py`` (the frozen torchaudio
pipeline of the reference's speech encoder):

  * pre-emphasis y[t] = x[t] - 0.97*x[t-1], with y[0] using x[1];
  * STFT: center=True reflect padding, periodic Hann window, n_fft 1024,
    hop 512, power-2 magnitude;
  * HTK mel filterbank (norm None), f_min 0, f_max sr/2;
  * +1e-6, then instance normalisation over time (eps 1e-5, no affine).

``mel_filterbank`` is a copy of the JAX package's numpy function.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pre_emphasis(wav: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """(N, T) -> (N, T)."""
    prev = torch.cat([wav[:, 1:2], wav[:, :-1]], dim=1)
    return wav - coef * prev


def hann_window(n: int, device=None) -> torch.Tensor:
    """Periodic Hann (torch ``hann_window(periodic=True)``), built in fp64."""
    k = np.arange(n)
    return torch.from_numpy(
        (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)
    ).to(device)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


# Slaney mel scale (librosa's default, htk=False): linear below 1 kHz at
# 3/200 mel/Hz, logarithmic above with step log(6.4)/27
_SLANEY_F_SP = 200.0 / 3.0
_SLANEY_MIN_LOG_HZ = 1000.0
_SLANEY_MIN_LOG_MEL = _SLANEY_MIN_LOG_HZ / _SLANEY_F_SP     # = 15.0
_SLANEY_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    return np.where(
        f >= _SLANEY_MIN_LOG_HZ,
        _SLANEY_MIN_LOG_MEL + np.log(np.maximum(f, 1e-12)
                                     / _SLANEY_MIN_LOG_HZ) / _SLANEY_LOGSTEP,
        f / _SLANEY_F_SP)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    return np.where(
        m >= _SLANEY_MIN_LOG_MEL,
        _SLANEY_MIN_LOG_HZ * np.exp(_SLANEY_LOGSTEP
                                    * (m - _SLANEY_MIN_LOG_MEL)),
        m * _SLANEY_F_SP)


def mel_filterbank(
    n_freqs: int, n_mels: int, sample_rate: int,
    f_min: float = 0.0, f_max: "float | None" = None,
    htk: bool = True, norm: "str | None" = None,
) -> np.ndarray:
    """(n_freqs, n_mels) triangular mel filterbank.

    Defaults (htk=True, norm=None) match the speech encoder's front-end;
    htk=False + norm="slaney" is librosa's default basis."""
    f_max = sample_rate / 2.0 if f_max is None else f_max
    hz_to_mel = _hz_to_mel_htk if htk else _hz_to_mel_slaney
    mel_to_hz = _mel_to_hz_htk if htk else _mel_to_hz_slaney
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)                              # (n_mels + 2,)
    f_diff = np.diff(f_pts)                               # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        # area normalisation: each triangle scaled to ~constant energy
        fb *= (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]
    elif norm is not None:
        raise ValueError(f"unknown mel norm {norm!r}")
    return fb.astype(np.float32)


def frame_signal(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Center-padded (reflect) framing: (N, T) -> (N, n_frames, n_fft)."""
    pad = n_fft // 2
    x = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(1, n_fft, hop)


def mel_spectrogram(
    wav: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop_length: int = 512,
    n_mels: int = 128,
    htk: bool = True,
    norm: "str | None" = None,
) -> torch.Tensor:
    """(N, T_wav) -> (N, n_mels, n_frames), power spectrogram x mel fbank."""
    frames = frame_signal(wav.float(), n_fft, hop_length)
    frames = frames * hann_window(n_fft, wav.device)
    spec = torch.fft.rfft(frames, dim=-1).abs() ** 2     # (N, F, n_fft/2+1)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate,
                                         htk=htk, norm=norm)).to(wav.device)
    return (spec @ fb).transpose(1, 2)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(batch, channel) normalisation over the trailing time axis."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def speech_frontend(wav: torch.Tensor, n_mels: int = 128) -> torch.Tensor:
    """Full frozen front-end: (N, T_wav) -> (N, n_mels, n_frames)."""
    mel = mel_spectrogram(pre_emphasis(wav), n_mels=n_mels) + 1e-6
    return instance_norm(mel)
