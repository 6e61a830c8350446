"""Sampling-time API: single windows, long sequences, latency.

Port of ``gesture_diffusion_tpu/generation/generator.py`` (the serving
path):

  * ``generate_sample`` — the speech memory is encoded once per clip, then
    the whole reverse process runs in the fused DDIM kernel
    (``ops/fused_sampler.py``) or, with ``use_fused=False``, in the scan
    sampler (the ``nn.Module`` stepped by ``ddim_sample_loop``);
  * seed-pose continuation through the x0 blend with the ``trans_factor``
    per-frame ramp;
  * ``generate_sequence`` — long audio in overlapping windows, window i
    seeded from the tail of window i-1, optional crossfade at the seams;
  * ``eval_infer_time`` — warm-up, then timed reps that end in a
    device synchronise.

Unlike the JAX Generator there is no silent fallback: with
``use_fused=True`` every batch goes through the kernel on the card (or
its plain version for a CPU Generator), and a kernel that cannot run
raises.  Compute-dtype policy: ``fused_dtype`` (default bfloat16) is both
the packed weight dtype and the dtype the operands of every product are
rounded to; accumulation, LayerNorm, softmax, the residual stream and the
diffusion state stay float32 (see ``ops/fused_sampler.py``).

All layouts are (N, T, C).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..diffusion import ddim_sample_loop
from ..diffusion.gaussian import Schedule
from ..models.attention import sinusoidal_position_encoding
from ..models.denoiser import GestureDenoiser
from ..ops.fused_sampler import (ddim_coefficients, fused_ddim_sample,
                                 pack_oneway_denoiser)
from ..utils.device import resolve_device


def window_plan(wav_len: int, wav_sr: int, pose_fps: int,
                pose_window_len: int, pose_seed_len: int) -> Tuple[int, int]:
    """(seq_len, num_div) of the overlapped-window plan for ``wav_len``
    audio samples.  Output length truncates to whole seconds of audio, as
    the reference does; sub-second audio plans nothing."""
    if not pose_seed_len < pose_window_len:
        raise ValueError(
            f"pose_seed_len ({pose_seed_len}) must be < pose_window_len "
            f"({pose_window_len}) — stride would be <= 0")
    seq_len = wav_len // wav_sr * pose_fps
    stride = pose_window_len - pose_seed_len
    if seq_len == 0:
        return 0, 0
    num_div = int(np.ceil(seq_len / stride))
    if (seq_len - pose_seed_len) % stride == 0:
        num_div -= 1
    if num_div <= 0:
        raise ValueError(
            f"audio too short for the window plan: {seq_len} output frames "
            f"but 0 windows (window={pose_window_len}, seed={pose_seed_len}"
            f", fps={pose_fps}); provide at least one more second of audio")
    return seq_len, num_div


def crossfade_head(x: np.ndarray, prev_tail: np.ndarray,
                   seed_len: int) -> np.ndarray:
    """Linear blend of a window's first ``seed_len`` frames with the
    previous window's raw tail."""
    ratio = (np.arange(seed_len, dtype=np.float32) / seed_len)[None, :, None]
    head = x[:, :seed_len] * ratio + prev_tail * (1.0 - ratio)
    return np.concatenate([head, x[:, seed_len:]], axis=1)


def make_trans_ramp(trans_factor: Optional[float], pose_seed_len: int,
                    window_len: int) -> Optional[np.ndarray]:
    """(1, T, 1) per-frame seed-adherence ramp: trans_factor -> 1 over the
    seed frames, then 1.  None -> hard seed copy."""
    if trans_factor is None:
        return None
    if not 0.0 <= trans_factor <= 1.0:
        raise ValueError(f"trans_factor {trans_factor} must be in [0, 1]")
    ramp = np.linspace(trans_factor, 1.0, pose_seed_len, endpoint=False)
    full = np.concatenate([ramp, np.ones(window_len - pose_seed_len)])
    return full[None, :, None].astype(np.float32)


class Generator:
    def __init__(
        self,
        model: GestureDenoiser,
        sched: Schedule,
        timestep_map: Optional[torch.Tensor] = None,
        use_fused: bool = True,
        fused_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        """:param use_fused: sample through the fused DDIM kernel (the
        default); False is the caller's explicit choice of the scan
        sampler.
        :param fused_dtype: weight and product-operand dtype of the fused
        path (bfloat16 by default; the CUDA kernel takes only bfloat16).
        :param device: the card unless ``"cpu"`` is asked for."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.sched = sched.to(self.device)
        self.num_steps = self.sched.num_timesteps
        self.timestep_map = (None if timestep_map is None
                             else torch.as_tensor(timestep_map).to(self.device))
        self.use_fused = bool(use_fused)
        self.fused_dtype = fused_dtype or torch.bfloat16
        #: which path produced the last ``generate_sample`` output:
        #: "fused" (the fused sampler) or "scan" (the module step loop)
        self.last_sample_path = None
        self._packed = None
        self._packed_key = None
        self._tmap = (self.timestep_map if self.timestep_map is not None
                      else torch.arange(self.num_steps, device=self.device))
        self._coefs = ddim_coefficients(self.sched).to(self.device)
        self._pe = torch.from_numpy(sinusoidal_position_encoding(
            5000, model.cfg.d_model)).to(self.device)

    def update_variables(self, state_dict) -> None:
        """Load new weights (e.g. after further training).  Use this rather
        than loading into ``self.model`` directly: the fused path packs the
        weights once and caches the pack, which this drops."""
        self.model.load_state_dict(state_dict)
        self._packed = None
        self._packed_key = None

    # ------------------------------------------------------------------
    @staticmethod
    def _host(x) -> torch.Tensor:
        return x if torch.is_tensor(x) else torch.from_numpy(
            np.ascontiguousarray(x))

    def _tensor(self, x) -> torch.Tensor:
        return self._host(x).to(self.device, torch.float32)

    def _wavs(self, wav) -> torch.Tensor:
        """Float audio in [-1, 1]; integer PCM (32768x the trained scale)
        is refused rather than cast, whether it came as an array or a
        list."""
        wav = self._host(wav)
        if not wav.dtype.is_floating_point:
            raise TypeError(f"wav has dtype {wav.dtype}: expected float "
                            "audio in [-1, 1]")
        return self._tensor(wav)

    def _memory_rows(self, wavs: torch.Tensor) -> torch.Tensor:
        """(N, 1 + m_s, D) f32: a zero token slot, then
        emb_mem(speech) + pe[1:]."""
        speech = self.model.encode_memory(wavs)
        emm = self.model.pose_decoder.emb_mem
        m_s = speech.shape[1]
        rows = speech @ emm.weight.t() + emm.bias + self._pe[1:m_s + 1]
        slot = torch.zeros_like(rows[:, :1])
        return torch.cat([slot, rows], dim=1).float()

    def fused_args(self, wavs, pose_dim, pose_window_len, noise, ip=None,
                   im=None, ramp=None) -> dict:
        """Keyword arguments of ``fused_ddim_sample`` for one window batch
        (device tensors in): the cached pack, padded x_T, memory rows, the
        blend tensors (None for the identity blend) and the schedule."""
        cfg = self.model.cfg
        key = (pose_dim, pose_window_len)
        if self._packed is None or self._packed_key != key:
            self._packed = pack_oneway_denoiser(
                self.model, pose_dim, pose_window_len,
                weight_dtype=self.fused_dtype)
            self._packed_key = key
        n = noise.shape[0]
        dp_pad = self._packed.w_embx.shape[0]

        def embed(val, fill=0.0):
            out = torch.full((n, pose_window_len, dp_pad), fill,
                             dtype=torch.float32, device=self.device)
            out[:, :, :pose_dim] = val
            return out

        blend_a = blend_b = None
        if ip is not None:
            tf = 0.0 if ramp is None else ramp
            blend_a = embed((1.0 - tf) * im * ip)
            blend_b = embed((tf * im + (1.0 - im)).expand(ip.shape), fill=1.0)
        return dict(packed=self._packed, x_T=embed(noise),
                    mem_rows=self._memory_rows(wavs), tmap=self._tmap,
                    coefs=self._coefs, blend_a=blend_a, blend_b=blend_b,
                    n_layers=cfg.n_layers, heads=cfg.heads,
                    num_steps=self.num_steps, compute_dtype=self.fused_dtype)

    def _fused_sample(self, wavs, pose_dim, pose_window_len, noise, ip, im,
                      ramp):
        out = fused_ddim_sample(**self.fused_args(
            wavs, pose_dim, pose_window_len, noise, ip, im, ramp))
        return out[:, :, :pose_dim]

    def _scan_sample(self, wavs, noise, ip, im, ramp):
        memory = self.model.encode_memory(wavs)

        def model_fn(x, t):
            return self.model.denoise(x, t, memory)

        denoise_fn = None
        if ip is not None:
            tf = 0.0 if ramp is None else ramp

            def denoise_fn(x0_hat):
                return ((1.0 - tf) * im * ip + tf * im * x0_hat
                        + (1.0 - im) * x0_hat)

        return ddim_sample_loop(self.sched, model_fn, noise,
                                denoise_fn=denoise_fn,
                                timestep_map=self.timestep_map)

    @torch.no_grad()
    def generate_sample(
        self,
        wavs,                                   # (N, T_wav)
        pose_dim: int,
        pose_window_len: int,
        generator: Optional[torch.Generator] = None,
        noise=None,                             # (N, T, C)
        inpaint_poses=None,                     # (N, T, C)
        inpaint_masks=None,                     # (N, T, 1)
        sample_alg: str = "ddim",
        trans_factor: Optional[float] = None,
        pose_seed_len: Optional[int] = None,
    ) -> torch.Tensor:
        """One window batch -> (N, T, C) float32 poses on the device.
        Without ``noise`` the initial noise is drawn from ``generator``."""
        if sample_alg == "ddpm":
            raise NotImplementedError(
                "DDPM sampling is not ported yet (ROADMAP.md, queue 2: "
                "stochastic DDPM)")
        if sample_alg != "ddim":
            raise ValueError(f"unknown sample_alg {sample_alg!r}")
        wavs = self._wavs(wavs)
        if wavs.ndim != 2:
            raise ValueError(f"wavs must be (N, T_wav), got {tuple(wavs.shape)}")
        n = wavs.shape[0]
        ip = im = ramp = None
        if inpaint_poses is not None:
            if inpaint_masks is None:
                raise ValueError("Provide inpaint_masks.")
            ip, im = self._tensor(inpaint_poses), self._tensor(inpaint_masks)
            if trans_factor is not None:
                if pose_seed_len is None:
                    raise ValueError("trans_factor needs pose_seed_len")
                ramp = self._tensor(make_trans_ramp(
                    trans_factor, pose_seed_len, pose_window_len))
        if noise is None:
            gdev = generator.device if generator is not None else self.device
            noise = torch.randn((n, pose_window_len, pose_dim),
                                generator=generator, device=gdev)
        noise = self._tensor(noise)
        if self.use_fused:
            out = self._fused_sample(wavs, pose_dim, pose_window_len, noise,
                                     ip, im, ramp)
            self.last_sample_path = "fused"
            return out
        out = self._scan_sample(wavs, noise, ip, im, ramp)
        self.last_sample_path = "scan"
        return out

    # ------------------------------------------------------------------
    def generate_sequence(
        self,
        wav_seqs,                              # (N, T_wav_long)
        wav_sr: int,
        pose_dim: int,
        pose_fps: int,
        pose_window_len: int,
        pose_seed_len: int,
        generator: Optional[torch.Generator] = None,
        smooth_trans: bool = True,
        trans_factor: Optional[float] = None,
        init_poses=None,                       # (N, seed_len, C)
        sample_alg: str = "ddim",
        batch_size: int = 64,
        noise_fn: Optional[Callable[[int, int], object]] = None,
    ) -> np.ndarray:
        """Long audio -> (N, T_seq, C) numpy poses by overlapped windows
        with seed-pose continuation.  ``noise_fn(batch_start, window)``,
        when given, supplies each window's initial noise (N_b, T, C)."""
        wav_seqs = self._wavs(wav_seqs).cpu().numpy()
        if wav_seqs.ndim != 2:
            raise ValueError("wav_seqs must be (N, T_wav)")
        n_seq, wav_seq_len = wav_seqs.shape
        seq_len, num_div = window_plan(wav_seq_len, wav_sr, pose_fps,
                                       pose_window_len, pose_seed_len)
        if num_div == 0:
            return np.zeros((n_seq, 0, pose_dim), np.float32)
        stride = pose_window_len - pose_seed_len
        wav_window_len = int(wav_sr * pose_window_len / pose_fps)

        outs = []
        for b0 in range(0, n_seq, batch_size):
            wav_seq = wav_seqs[b0:b0 + batch_size]
            nb = len(wav_seq)
            mask = np.zeros((nb, pose_window_len, 1), np.float32)
            mask[:, :pose_seed_len] = 1.0
            samples = []
            prev_tail = (None if init_poses is None else
                         np.asarray(init_poses[b0:b0 + batch_size], np.float32))
            pose_start = 0
            for d in range(num_div):
                wav_start = int(pose_start / pose_fps * wav_sr)
                window = wav_seq[:, wav_start:wav_start + wav_window_len]
                if window.shape[1] < wav_window_len:   # zero-pad last window
                    window = np.pad(
                        window, ((0, 0), (0, wav_window_len - window.shape[1])))
                ip = im = None
                if prev_tail is not None:
                    ip = np.zeros((nb, pose_window_len, pose_dim), np.float32)
                    ip[:, :pose_seed_len] = prev_tail
                    im = mask
                sample = self.generate_sample(
                    window, pose_dim, pose_window_len, generator=generator,
                    noise=None if noise_fn is None else noise_fn(b0, d),
                    inpaint_poses=ip, inpaint_masks=im,
                    sample_alg=sample_alg, trans_factor=trans_factor,
                    pose_seed_len=pose_seed_len).cpu().numpy()
                samples.append(sample)
                prev_tail = sample[:, -pose_seed_len:]
                pose_start += stride

            combined = []
            for i, x in enumerate(samples):
                if smooth_trans and i > 0:
                    x = crossfade_head(
                        x, samples[i - 1][:, -pose_seed_len:], pose_seed_len)
                combined.append(x[:, :-pose_seed_len]
                                if i < len(samples) - 1 else x)
            outs.append(np.concatenate(combined, axis=1)[:, :seq_len])
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def eval_infer_time(
        self,
        wavs,
        pose_dim: int,
        pose_window_len: int,
        sample_alg: str = "ddim",
        repetitions: int = 10,
        warmup: int = 10,
        return_raw: bool = False,
    ):
        """:return: (mean_ms, std_ms, steps_per_sec)[, raw ms array] over
        timed reps, each ending in a device synchronise."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        for _ in range(warmup):
            self.generate_sample(wavs, pose_dim, pose_window_len,
                                 generator=gen, sample_alg=sample_alg)
        self._sync()
        timings = np.zeros(repetitions)
        for rep in range(repetitions):
            t0 = time.perf_counter()
            self.generate_sample(wavs, pose_dim, pose_window_len,
                                 generator=gen, sample_alg=sample_alg)
            self._sync()
            timings[rep] = (time.perf_counter() - t0) * 1e3
        stats = (float(timings.mean()), float(timings.std()),
                 float(self.num_steps / (timings.mean() / 1e3)))
        return stats + (timings,) if return_raw else stats
