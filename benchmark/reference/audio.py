"""The speech encoder's frozen front-end, plain torch.

pre-emphasis y[t] = x[t] - 0.97 x[t-1] (y[0] uses x[1]); STFT with
centre reflect padding, a periodic Hann window, n_fft 1024, hop 512,
power 2; an HTK mel filterbank of 128 bands from 0 Hz to sr/2 without
normalisation; + 1e-6; instance normalisation over time (eps 1e-5).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, N_MELS, SR = 1024, 512, 128, 16000


def mel_filterbank(n_freqs: int = N_FFT // 2 + 1, n_mels: int = N_MELS,
                   sr: int = SR) -> np.ndarray:
    """(n_freqs, n_mels) HTK triangles, float64 math, float32 out."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0),
                                  n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def frontend(wav: torch.Tensor) -> torch.Tensor:
    """(N, T_wav) float audio -> (N, 128, frames) normalised mel image."""
    wav = wav.float()
    x = wav - 0.97 * torch.cat([wav[:, 1:2], wav[:, :-1]], dim=1)
    x = F.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(1, N_FFT, HOP)
    k = np.arange(N_FFT)
    window = torch.from_numpy(
        (0.5 - 0.5 * np.cos(2.0 * np.pi * k / N_FFT)).astype(np.float32)
    ).to(wav.device)
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    fb = torch.from_numpy(mel_filterbank()).to(wav.device)
    mel = (power @ fb).transpose(1, 2) + 1e-6
    mean = mel.mean(dim=-1, keepdim=True)
    var = mel.var(dim=-1, keepdim=True, unbiased=False)
    return (mel - mean) * torch.rsqrt(var + 1e-5)
