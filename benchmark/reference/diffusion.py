"""DDIM sampling of the reference model: the linear schedule, ``ddimN``
respacing, the deterministic DDIM loop (eta 0) with the x0 blend of the
seed poses, and the chaining of windows over a long clip.

Schedule: betas linear from 1e-4 to 2e-2 (scaled by 1000 / T); respacing
keeps the steps range(0, T, stride) whose count is N and recomputes the
betas from the kept cumulative products; the model sees the original
timestep.  Tables in float64, stored as float32.

Step (Song et al., eq. 12, eta 0): x0 = sqrt(1/acp) x - sqrt(1/acp - 1)
eps; the blend x0 <- (1 - r) m s + (r m + 1 - m) x0 with seed poses s,
mask m and the per-frame ramp r (trans_factor -> 1 over the seed frames),
then eps <- (sqrt(1/acp) x - x0) / sqrt(1/acp - 1); x <- sqrt(acp_prev) x0
+ sqrt(1 - acp_prev) eps.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


class Schedule:
    def __init__(self, steps: int, respacing: str = ""):
        base = np.linspace(1e-4 * 1000 / steps, 2e-2 * 1000 / steps, steps,
                           dtype=np.float64)
        keep = range(steps)
        if respacing:
            if not respacing.startswith("ddim"):
                raise ValueError(f"no reference for respacing {respacing!r}")
            want = int(respacing[4:])
            stride = next((s for s in range(1, steps)
                           if len(range(0, steps, s)) == want), None)
            if stride is None:
                raise ValueError(f"no stride gives {want} of {steps} steps")
            keep = range(0, steps, stride)
        acp_all = np.cumprod(1.0 - base)
        acp = acp_all[list(keep)]
        prev = np.append(1.0, acp[:-1])
        self.tmap = list(keep)
        self.c0 = np.sqrt(1.0 / acp).astype(np.float32)
        self.c1 = np.sqrt(1.0 / acp - 1.0).astype(np.float32)
        self.c2 = np.sqrt(prev).astype(np.float32)
        self.c3 = np.sqrt(1.0 - prev).astype(np.float32)

    def __len__(self):
        return len(self.tmap)


def seed_ramp(trans_factor: Optional[float], seed_len: int, window: int):
    """(1, T, 1) float32 ramp, or None (the seed frames copied hard)."""
    if trans_factor is None:
        return None
    r = np.concatenate([np.linspace(trans_factor, 1.0, seed_len,
                                    endpoint=False), np.ones(window - seed_len)])
    return torch.from_numpy(r[None, :, None].astype(np.float32))


def stepper(model, memory, x_like, t_like):
    """``eps(x, t)``: ``model.denoise`` against ``memory``.  On the card
    the step is captured once as a CUDA graph and replayed: the same
    kernels on the same operands, without the host launching each one.
    The returned tensor is overwritten by the next call."""
    if x_like.device.type != "cuda":
        return lambda x, t: model.denoise(x, t, memory)
    sx, st = x_like.clone(), t_like.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):              # warm-up: workspaces, position tables
            model.denoise(sx, st, memory)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = model.denoise(sx, st, memory)

    def eps(x, t):
        sx.copy_(x)
        st.copy_(t)
        graph.replay()
        return out

    return eps


@torch.no_grad()
def ddim(model, sched: Schedule, wav, noise, seed=None, ramp=None):
    """One window: (N, T_wav) audio and (N, T, C) x_T -> (N, T, C) poses.
    ``seed`` (N, k, C): the previous window's last k poses, blended into
    the first k frames of every step's x0."""
    memory = model.encode(wav)
    x = noise.float()
    blend = None
    if seed is not None:
        n, t, c = x.shape
        k = seed.shape[1]
        s = torch.zeros_like(x)
        s[:, :k] = seed
        m = torch.zeros((n, t, 1), device=x.device)
        m[:, :k] = 1.0
        r = 0.0 if ramp is None else ramp.to(x.device)
        blend = ((1.0 - r) * m * s, r * m + (1.0 - m))
    t = torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
    step = stepper(model, memory, x, t)
    for i in reversed(range(len(sched))):
        t.fill_(sched.tmap[i])
        eps = step(x, t)
        c0, c1 = float(sched.c0[i]), float(sched.c1[i])
        x0 = c0 * x - c1 * eps
        if blend is not None:
            x0 = blend[0] + blend[1] * x0
            eps = (c0 * x - x0) / c1
        x = float(sched.c2[i]) * x0 + float(sched.c3[i]) * eps
    return x


def window_plan(wav_len: int, sr: int, fps: int, window: int, seed_len: int):
    """(output frames, windows) of a clip of ``wav_len`` samples: whole
    seconds of audio, windows at a stride of window - seed_len."""
    frames = wav_len // sr * fps
    stride = window - seed_len
    n = math.ceil(frames / stride)
    if (frames - seed_len) % stride == 0:
        n -= 1
    return frames, n


@torch.no_grad()
def sequence(model, sched: Schedule, wavs, noise, init, cfg: dict):
    """A batch of long clips, window by window, each window seeded with
    the previous one's tail (the first with ``init``).

    :param wavs: (N, T_wav) audio.
    :param noise: (windows, N, T, C) the x_T of each window.
    :param init: (N, seed_len, C) seed poses of the first window.
    :param cfg: the frozen configuration.
    :return: (N, frames, C) poses; with ``smooth_transition`` each seam's
        first seed_len frames crossfade from the previous window's tail."""
    data, gen = cfg["Data"], cfg["Model"]["Generate"]
    sr, fps, window = data["wav_sr"], data["pose_fps"], data["pose_window_len"]
    k = gen["pose_seed_len"]
    frames, n_win = window_plan(wavs.shape[1], sr, fps, window, k)
    stride = window - k
    wav_win = int(sr * window / fps)
    ramp = seed_ramp(gen.get("trans_factor"), k, window)
    tail, outs = init, []
    for w in range(n_win):
        start = int(w * stride / fps * sr)
        chunk = wavs[:, start:start + wav_win]
        chunk = torch.nn.functional.pad(chunk, (0, wav_win - chunk.shape[1]))
        x = ddim(model, sched, chunk, noise[w], tail, ramp)
        outs.append(x)
        tail = x[:, -k:]
    parts = []
    for w, x in enumerate(outs):
        if gen.get("smooth_transition") and w > 0:
            a = (torch.arange(k, dtype=torch.float32, device=x.device)
                 / k)[None, :, None]
            head = x[:, :k] * a + outs[w - 1][:, -k:] * (1.0 - a)
            x = torch.cat([head, x[:, k:]], dim=1)
        parts.append(x[:, :-k] if w < n_win - 1 else x)
    return torch.cat(parts, dim=1)[:, :frames]
