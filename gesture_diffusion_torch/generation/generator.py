"""Sampling-time API: single windows, long sequences, streaming, bpd,
latency.

Port of ``gesture_diffusion_tpu/generation/generator.py`` (the serving
path), for every decoder, all three model types (s2g_v2, default,
inpaint) and both sampling algorithms (ddim, ddpm):

  * ``generate_sample`` — the speech memory is encoded once per clip, then
    the whole reverse process runs in the fused kernel
    (``ops/fused_sampler.py``) or in a scan sampler (the ``nn.Module``
    stepped by ``ddim_sample_loop`` or ``ddpm_sample_loop``).  The model
    chooses, as the JAX Generator's ``_fused_enabled`` does: the kernel
    fuses the oneway decoder only, so every other decoder (cross-attention,
    GCN, UNet) runs the scan sampler; a oneway model takes the scan only
    when the caller passes ``use_fused=False``;
  * seed-pose continuation through the x0 blend with the ``trans_factor``
    per-frame ramp; for the inpaint model type the same seed poses and mask
    also feed its conditioning MLP, computed once per call (``x_add``);
  * ``generate_sequence`` — long audio in overlapping windows, window i
    seeded from the tail of window i-1, optional crossfade at the seams;
  * ``stream`` / ``GestureStream`` — the same plan as a push API: windows
    are launched as their audio arrives, the seed tail stays on the device,
    and results come to the host only when more than ``max_in_flight``
    windows are pending;
  * ``eval_bpd`` — the variational bound over all timesteps, with the
    memory encoded once;
  * ``eval_infer_time`` — warm-up, then timed reps that end in a
    device synchronise.

Over a device mesh (``parallel.make_mesh``, the data axis only) the fused
path splits each batch into one shard per device: each device holds its
own copy of the packed weights, token table and coefficients and samples
its clips in one kernel launch, with no collectives (clips are
independent), and the outputs are gathered on the mesh's first device.
The launches are queued without a synchronise between them, so on
distinct GPUs they overlap.  A shard draws the unsharded batch's DDPM
noise for its clips (the kernel's ``clip_base``), so the sharded output is
the unsharded one's.  A batch that does not divide runs unsharded on the
first device; the scan path and ``eval_bpd`` run there too, as the JAX
Generator's do.

Unlike the JAX Generator there is no silent fallback: for a oneway model
with ``use_fused=True`` every batch goes through the kernel on the card
(or its plain version for a CPU Generator), and a kernel that cannot run
raises.  Compute-dtype policy, the JAX Generator's: with ``fused_dtype``
None (the default) the pack holds bfloat16 weights and each launch
computes in float32 when the batch a device holds, ``n_local``, has
gcd(n_local, 8) <= 2 (one or two clips: ``generate_sample`` at batch 1,
the stream and ``generate_sequence`` of one or two clips, the CLI's
eval-time), else in bfloat16; an explicit ``fused_dtype`` is both the
weight dtype and the compute dtype of every launch.  ``n_local`` is the
batch of one shard under a mesh that splits it, else the whole batch.
The JAX Generator sends a batch with n_local > 2 and gcd(n_local, 8) < 4
(3, 5, 6, 7, ...) to its float32 scan sampler; the port keeps it on the
kernel, where the policy computes it in float32, the closer of the two
dtypes to that scan.  Whatever the compute dtype, accumulation,
LayerNorm, softmax, the residual stream and the diffusion state stay
float32 (see ``ops/fused_sampler.py``).

Phases are spans (``utils/profiling.py::span``: ``torch.profiler`` ranges
while a profiler records, else nothing): ``generate/sample`` around each
``generate_sample``, holding ``generate/inputs`` (arguments to device
tensors, the noise, the ramp, the DDPM seed), ``generate/memory`` (the
speech memory), on the fused path ``generate/prepare`` (pack, padded x_T,
blend tensors, ``x_add``) and ``fused/launch`` (``ops/fused_sampler.py``),
on the scan path a ``sampler/step`` a step; ``generate/sequence`` around
``generate_sequence``, holding a ``generate/window`` a window (with
``generate/to_host``: the wait for its poses and their copy to the host)
and a ``generate/stitch`` a batch.

Randomness: initial noise and, for DDPM, the per-step noise come from the
caller's ``torch.Generator``.  The fused DDPM path draws one seed from it
and the kernel derives every step's noise from that seed
(``ops/fused_sampler.py::fused_noise``); the scan path draws each step's
z from the generator itself.

All layouts are (N, T, C).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..diffusion import bpd_loop, ddim_sample_loop, ddpm_sample_loop
from ..diffusion.gaussian import Schedule
from ..models.attention import sinusoidal_position_encoding
from ..models.denoiser import GestureDenoiser
from ..ops.f32_linear import drop_packs
from ..ops.fused_sampler import (ddim_coefficients, ddpm_coefficients,
                                 fused_ddim_sample, pack_oneway_denoiser)
from ..parallel.mesh import Mesh, replicate, split_batch
from ..utils.device import resolve_device
from ..utils.profiling import span


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


def check_data_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` unless it has an axis other than "data" of size above 1:
    each device would run a duplicate kernel instance."""
    if mesh is None:
        return None
    if "data" not in mesh.shape:
        raise ValueError(f"Generator mesh needs a 'data' axis, got "
                         f"{dict(mesh.shape)}")
    extra = {k: v for k, v in mesh.shape.items() if k != "data" and v > 1}
    if extra:
        raise ValueError(
            f"Generator mesh must be data-only; non-trivial axes {extra} "
            "would run duplicate kernel instances. Pass a mesh whose only "
            "axis > 1 is 'data'.")
    return mesh


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
        mesh: Optional[Mesh] = None,
    ):
        """:param use_fused: sample a oneway model through the fused kernel
        (the default); False is the caller's explicit choice of a scan
        sampler.  Other decoders have no fused kernel and always take the
        scan sampler, whatever ``use_fused`` says.
        :param fused_dtype: weight and product-operand dtype of the fused
        path at every batch; None (the default): bfloat16 weights and the
        compute dtype chosen per launch (module docstring).
        :param device: the card unless ``"cpu"`` is asked for.
        :param mesh: a data-axis mesh to split the fused path's batches
        over (module docstring); the model and every other path live on
        its first device, which ``device``, if given, must be."""
        self.mesh = check_data_mesh(mesh)
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.devices[0]}")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.sched = sched.to(self.device)
        self.num_steps = self.sched.num_timesteps
        self.timestep_map = (None if timestep_map is None
                             else torch.as_tensor(timestep_map).to(self.device))
        self.use_fused = bool(use_fused)
        #: whether generate_sample runs the fused kernel: the caller's
        #: use_fused, for a model whose decoder the kernel fuses
        self.fused = self.use_fused and self.model.cfg.decoder_type == \
            "oneway_cross_attention"
        self.fused_dtype = fused_dtype
        #: which path produced the last ``generate_sample`` output:
        #: "fused" (the fused sampler) or "scan" (the module step loop)
        self.last_sample_path = None
        self._packed = None
        self._packed_key = None
        self._replicas = {}       # mesh devices -> (pack, tmap, coefs) each
        self._tmap = (self.timestep_map if self.timestep_map is not None
                      else torch.arange(self.num_steps, device=self.device))
        self._coefs = {"ddim": ddim_coefficients(self.sched).to(self.device),
                       "ddpm": ddpm_coefficients(self.sched).to(self.device)}
        self._pe = torch.from_numpy(sinusoidal_position_encoding(
            5000, model.cfg.d_model)).to(self.device)

    def update_variables(self, state_dict) -> None:
        """Load new weights (e.g. after further training).  Use this rather
        than loading into ``self.model`` directly: the fused path packs the
        weights once and caches the pack, which this drops, and with it
        the kernel-side transposed copies kept for the pack's lifetime
        (``ops/fused_sampler.py::kernel_weights``), and the split-TF32
        weight packs of the model's ``F32x3Linear``s
        (``ops/f32_linear.py::drop_packs``)."""
        self.model.load_state_dict(state_dict)
        drop_packs(self.model)
        self._packed = None
        self._packed_key = None
        self._replicas = {}

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
        with span("generate/memory"):
            speech = self.model.encode_memory(wavs).float()
            emm = self.model.pose_decoder.emb_mem
            m_s = speech.shape[1]
            rows = speech @ emm.weight.t() + emm.bias + self._pe[1:m_s + 1]
            slot = torch.zeros_like(rows[:, :1])
            return torch.cat([slot, rows], dim=1).float()

    def _inpaint_model(self) -> bool:
        return self.model.cfg.model_type == "inpaint"

    def fused_args(self, wavs, pose_dim, pose_window_len, noise, ip=None,
                   im=None, ramp=None, sample_alg: str = "ddim",
                   seed=0, mesh: Optional[Mesh] = None) -> dict:
        """Keyword arguments of ``fused_ddim_sample`` for one window batch
        (device tensors in): the cached pack, padded x_T, memory rows, the
        blend tensors (None for the identity blend), the inpaint type's
        ``x_add``, the schedule of ``sample_alg``, and the compute dtype
        the policy chooses for the batch a device holds when ``mesh`` (the
        Generator's by default) splits the batch.  Only for a Generator
        that samples through the fused kernel (``self.fused``): the pack
        and the memory rows read the oneway decoder's weights."""
        if not self.fused:
            raise ValueError(
                f"no fused kernel for this Generator (decoder "
                f"{self.model.cfg.decoder_type!r}, use_fused={self.use_fused}): "
                "it samples with the scan sampler")
        cfg = self.model.cfg
        mem_rows = self._memory_rows(wavs)
        with span("generate/prepare"):
            key = (pose_dim, pose_window_len)
            if self._packed is None or self._packed_key != key:
                self._packed = pack_oneway_denoiser(
                    self.model, pose_dim, pose_window_len,
                    weight_dtype=self.fused_dtype or torch.bfloat16)
                self._packed_key = key
                self._replicas = {}
            n = noise.shape[0]
            dp_pad = self._packed.w_embx.shape[0]
            mesh = self.mesh if mesh is None else mesh
            shards = 1 if mesh is None else mesh.shape["data"]
            n_local = n // shards if n % shards == 0 else n
            compute_dtype = self.fused_dtype or (
                torch.float32 if math.gcd(n_local, 8) <= 2 else torch.bfloat16)

            def embed(val, fill=0.0):
                out = torch.full((n, pose_window_len, dp_pad), fill,
                                 dtype=torch.float32, device=self.device)
                out[:, :, :pose_dim] = val
                return out

            blend_a = blend_b = x_add = None
            if ip is not None:
                tf = 0.0 if ramp is None else ramp
                blend_a = embed((1.0 - tf) * im * ip)
                blend_b = embed((tf * im + (1.0 - im)).expand(ip.shape),
                                fill=1.0)
            if self._inpaint_model():
                if ip is None or im is None:
                    raise ValueError("inpaint model requires inpaint tensors")
                # timestep-independent, so computed once per call; pad lanes 0
                x_add = embed(self.model.inpaint_projection(ip, im).float())
            x_T = embed(noise)
        return dict(packed=self._packed, x_T=x_T,
                    mem_rows=mem_rows, tmap=self._tmap,
                    coefs=self._coefs[sample_alg], blend_a=blend_a,
                    blend_b=blend_b, n_layers=cfg.n_layers, heads=cfg.heads,
                    num_steps=self.num_steps, compute_dtype=compute_dtype,
                    stochastic=sample_alg == "ddpm", seed=seed, x_add=x_add)

    def _fused_sample(self, wavs, pose_dim, pose_window_len, noise, ip, im,
                      ramp, sample_alg, seed, mesh=None):
        args = self.fused_args(wavs, pose_dim, pose_window_len, noise, ip, im,
                               ramp, sample_alg, seed, mesh)
        n = noise.shape[0]
        shards = 1 if mesh is None else mesh.shape["data"]
        if shards == 1 or n % shards:
            return fused_ddim_sample(**args)[:, :, :pose_dim]
        if mesh.devices not in self._replicas:
            self._replicas[mesh.devices] = replicate(
                (self._packed, self._tmap, self._coefs), mesh)
        pieces = split_batch({k: args[k] for k in (
            "x_T", "mem_rows", "blend_a", "blend_b", "x_add")}, mesh)
        outs = []
        for s, (dev, piece, (packed, tmap, coefs)) in enumerate(zip(
                mesh.devices, pieces, self._replicas[mesh.devices])):
            local = dict(args, **piece, packed=packed, tmap=tmap,
                         coefs=coefs[sample_alg], clip_base=s * (n // shards))
            if torch.is_tensor(seed):
                local["seed"] = seed.to(dev)
            # queued, not waited for: shards on distinct GPUs overlap
            outs.append(fused_ddim_sample(**local))
        return torch.cat([o.to(self.device) for o in outs])[:, :, :pose_dim]

    def _model_fn(self, memory, inpaint_pose=None, inpaint_mask=None):
        """``model_fn(x, t) -> eps`` over the hoisted memory (and, for the
        inpaint model type, its conditioning tensors)."""
        extra = {}
        if self._inpaint_model():
            if inpaint_pose is None or inpaint_mask is None:
                raise ValueError("inpaint model requires inpaint tensors")
            extra = {"inpaint_pose": inpaint_pose, "inpaint_mask": inpaint_mask}

        def model_fn(x, t):
            return self.model.denoise(x, t, memory, **extra)

        return model_fn

    def _scan_sample(self, wavs, noise, ip, im, ramp, sample_alg, generator,
                     z_fn):
        with span("generate/memory"):
            memory = self.model.encode_memory(wavs)
        model_fn = self._model_fn(memory, ip, im)
        denoise_fn = None
        if ip is not None:
            tf = 0.0 if ramp is None else ramp

            def denoise_fn(x0_hat):
                return ((1.0 - tf) * im * ip + tf * im * x0_hat
                        + (1.0 - im) * x0_hat)

        if sample_alg == "ddim":
            return ddim_sample_loop(self.sched, model_fn, noise,
                                    denoise_fn=denoise_fn,
                                    timestep_map=self.timestep_map)
        step_noise = None
        if z_fn is not None:
            def step_noise(i):
                return self._tensor(z_fn(i))
        elif generator is not None and generator.device != self.device:
            def step_noise(i):
                return torch.randn(noise.shape, generator=generator,
                                   device=generator.device).to(self.device)
        return ddpm_sample_loop(self.sched, model_fn, noise,
                                generator=generator, denoise_fn=denoise_fn,
                                timestep_map=self.timestep_map,
                                step_noise=step_noise)

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
        z_fn: Optional[Callable[[int], object]] = None,
        mesh: Optional[Mesh] = None,
    ) -> torch.Tensor:
        """One window batch -> (N, T, C) float32 poses on the device.
        Without ``noise`` the initial noise is drawn from ``generator``.
        ``sample_alg="ddpm"`` draws its per-step noise from ``generator``
        too: the fused path one seed for the kernel's own noise, the scan
        path every step's z, or ``z_fn(step)`` when given (scan path only;
        tests inject the JAX package's draws).  ``mesh`` (the Generator's
        by default) splits the fused path's batch over its devices."""
        with span("generate/sample"):
            if sample_alg not in ("ddim", "ddpm"):
                raise ValueError(f"unknown sample_alg {sample_alg!r}")
            if z_fn is not None and self.fused:
                raise ValueError("z_fn feeds the scan sampler only "
                                 "(use_fused=False)")
            with span("generate/inputs"):
                wavs = self._wavs(wavs)
                if wavs.ndim != 2:
                    raise ValueError(f"wavs must be (N, T_wav), got "
                                     f"{tuple(wavs.shape)}")
                n = wavs.shape[0]
                ip = im = ramp = None
                if inpaint_poses is not None:
                    if inpaint_masks is None:
                        raise ValueError("Provide inpaint_masks.")
                    ip = self._tensor(inpaint_poses)
                    im = self._tensor(inpaint_masks)
                    if trans_factor is not None:
                        if pose_seed_len is None:
                            raise ValueError("trans_factor needs pose_seed_len")
                        ramp = self._tensor(make_trans_ramp(
                            trans_factor, pose_seed_len, pose_window_len))
                if self._inpaint_model() and ip is None:
                    raise ValueError("inpaint model requires inpaint tensors")
                gdev = generator.device if generator is not None else self.device
                if noise is None:
                    noise = torch.randn((n, pose_window_len, pose_dim),
                                        generator=generator, device=gdev)
                noise = self._tensor(noise)
                seed = 0
                if self.fused and sample_alg == "ddpm":
                    # stays a tensor: no host round trip on the dispatch path
                    seed = torch.randint(0, 2 ** 31 - 1, (1,),
                                         generator=generator, device=gdev,
                                         dtype=torch.int64).to(self.device)
            if self.fused:
                out = self._fused_sample(
                    wavs, pose_dim, pose_window_len, noise, ip, im, ramp,
                    sample_alg, seed,
                    self.mesh if mesh is None else check_data_mesh(mesh))
                self.last_sample_path = "fused"
            else:
                out = self._scan_sample(wavs, noise, ip, im, ramp, sample_alg,
                                        generator, z_fn)
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
        mesh: Optional[Mesh] = None,
    ) -> np.ndarray:
        """Long audio -> (N, T_seq, C) numpy poses by overlapped windows
        with seed-pose continuation.  ``noise_fn(batch_start, window)``,
        when given, supplies each window's initial noise (N_b, T, C).
        ``mesh`` as for ``generate_sample``."""
        with span("generate/sequence"):
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
                prev_tail = (None if init_poses is None else np.asarray(
                    init_poses[b0:b0 + batch_size], np.float32))
                pose_start = 0
                for d in range(num_div):
                    with span("generate/window"):
                        wav_start = int(pose_start / pose_fps * wav_sr)
                        window = wav_seq[:, wav_start:wav_start + wav_window_len]
                        if window.shape[1] < wav_window_len:   # zero-pad last
                            window = np.pad(window, (
                                (0, 0), (0, wav_window_len - window.shape[1])))
                        ip = im = None
                        if prev_tail is not None:
                            ip = np.zeros((nb, pose_window_len, pose_dim),
                                          np.float32)
                            ip[:, :pose_seed_len] = prev_tail
                            im = mask
                        sample = self.generate_sample(
                            window, pose_dim, pose_window_len,
                            generator=generator,
                            noise=None if noise_fn is None else noise_fn(b0, d),
                            inpaint_poses=ip, inpaint_masks=im,
                            sample_alg=sample_alg, trans_factor=trans_factor,
                            pose_seed_len=pose_seed_len, mesh=mesh)
                        with span("generate/to_host"):
                            sample = sample.cpu().numpy()
                        samples.append(sample)
                        prev_tail = sample[:, -pose_seed_len:]
                        pose_start += stride

                with span("generate/stitch"):
                    combined = []
                    for i, x in enumerate(samples):
                        if smooth_trans and i > 0:
                            x = crossfade_head(
                                x, samples[i - 1][:, -pose_seed_len:],
                                pose_seed_len)
                        combined.append(x[:, :-pose_seed_len]
                                        if i < len(samples) - 1 else x)
                    outs.append(np.concatenate(combined, axis=1)[:, :seq_len])
            return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------
    def stream(
        self,
        wav_sr: int,
        pose_dim: int,
        pose_fps: int,
        pose_window_len: int,
        pose_seed_len: int,
        generator: Optional[torch.Generator] = None,
        smooth_trans: bool = True,
        trans_factor: Optional[float] = None,
        init_poses=None,
        sample_alg: str = "ddim",
        max_in_flight: int = 4,
        noise_fn: Optional[Callable[[int, int], object]] = None,
        mesh: Optional[Mesh] = None,
    ) -> "GestureStream":
        """Streaming counterpart of :meth:`generate_sequence`: push audio
        chunks of any size, receive pose chunks as they complete.

        Windows are launched as soon as enough audio is buffered, the
        seed-pose tail is carried across windows on the device, and the
        host only waits when more than ``max_in_flight`` windows are
        outstanding.  The output equals ``generate_sequence`` on the same
        audio with the same ``noise_fn`` (called as ``noise_fn(0, window)``)
        or the same generator state, provided the offline call's
        ``batch_size >= N``: the offline path draws noise per
        (batch chunk, window), the stream per window for the whole batch.
        ``mesh`` (the Generator's by default) splits each window's batch
        over its devices, as ``generate_sample`` does.
        """
        return GestureStream(self, wav_sr, pose_dim, pose_fps,
                             pose_window_len, pose_seed_len, rng=generator,
                             smooth_trans=smooth_trans,
                             trans_factor=trans_factor, init_poses=init_poses,
                             sample_alg=sample_alg,
                             max_in_flight=max_in_flight, noise_fn=noise_fn,
                             mesh=mesh)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_bpd(
        self,
        poses,                                 # (N, T, C)
        wavs,                                  # (N, T_wav)
        generator: Optional[torch.Generator] = None,
        pose_seed_len: Optional[int] = None,
        t_block: int = 1,
        noise=None,                            # (T_steps, N, T, C)
    ) -> dict:
        """The variational bound in bits/dim (``diffusion.bpd_loop``) with
        the speech memory encoded once.

        :param t_block: timesteps per model call: k timesteps batch into
            one (k*N)-row call with the memory (and the inpaint tensors)
            tiled k times.  A ``t_block`` that does not divide the
            timestep count is clamped down to the largest divisor.  Each
            timestep's noise is a function of (seed, t) only, so
            ``t_block`` changes the speed and never the numbers (up to
            float32 summation order).
        :param noise: per-timestep noise, indexed by timestep, replacing
            the draws from ``generator`` (tests inject the JAX package's).
        """
        T = self.num_steps
        t_block = max(k for k in range(1, min(max(int(t_block), 1), T) + 1)
                      if T % k == 0)
        poses, wavs = self._tensor(poses), self._wavs(wavs)
        memory = self.model.encode_memory(wavs)
        ip = im = None
        if self._inpaint_model():
            if pose_seed_len is None:
                raise ValueError("an inpaint model needs pose_seed_len")
            ip = poses
            im = torch.zeros(poses.shape[:2] + (1,), device=self.device)
            im[:, :pose_seed_len] = 1.0
        if t_block > 1:
            memory = torch.cat([memory] * t_block, dim=0)
            if ip is not None:
                ip = torch.cat([ip] * t_block, dim=0)
                im = torch.cat([im] * t_block, dim=0)
        return bpd_loop(self.sched, self._model_fn(memory, ip, im), poses,
                        generator=generator, timestep_map=self.timestep_map,
                        t_block=t_block,
                        noise=None if noise is None else self._tensor(noise))

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


class GestureStream:
    """Incremental window-by-window gesture generation over pushed audio.

    Reproduces ``Generator.generate_sequence``'s window, seed and crossfade
    semantics as a push API:

        stream = generator.stream(sr, d_pose, fps, window, seed_len, gen)
        for audio_chunk in mic:               # any chunk size
            for poses in stream.push(audio_chunk):
                play(poses)                   # (N, stride, d_pose)
        for poses in stream.flush():
            play(poses)                       # last chunk: up to window_len

    ``push`` chunks are exactly ``stride`` frames; ``flush``'s final chunk
    carries everything still owed and can be up to ``pose_window_len``
    frames (the plan truncates to whole seconds), so size playback buffers
    for ``pose_window_len``, not ``stride``.

    Pipelining: a window's reverse process is launched as soon as its audio
    is buffered.  On the card a launch is asynchronous on the current
    stream, so the dispatch path holds no synchronise and no copy to the
    host: the seed tail of window d-1 is sliced from its sample as a device
    tensor, and samples are pulled to the host only when more than
    ``max_in_flight`` windows are outstanding, or at flush.
    """

    def __init__(self, generator: Generator, wav_sr: int, pose_dim: int,
                 pose_fps: int, pose_window_len: int, pose_seed_len: int,
                 rng: Optional[torch.Generator] = None,
                 smooth_trans: bool = True,
                 trans_factor: Optional[float] = None, init_poses=None,
                 sample_alg: str = "ddim", max_in_flight: int = 4,
                 noise_fn: Optional[Callable[[int, int], object]] = None,
                 mesh: Optional[Mesh] = None):
        if not pose_seed_len < pose_window_len:
            raise ValueError(
                f"pose_seed_len ({pose_seed_len}) must be < pose_window_len "
                f"({pose_window_len}) — stride would be <= 0")
        self.gen = generator
        self.wav_sr = wav_sr
        self.pose_dim = pose_dim
        self.pose_fps = pose_fps
        self.window_len = pose_window_len
        self.seed_len = pose_seed_len
        self.stride = pose_window_len - pose_seed_len
        self.wav_window_len = int(wav_sr * pose_window_len / pose_fps)
        self.smooth_trans = smooth_trans
        self.trans_factor = trans_factor
        self.sample_alg = sample_alg
        self.max_in_flight = max(1, max_in_flight)
        self._rng = rng
        self._noise_fn = noise_fn
        self._mesh = check_data_mesh(mesh)
        self._init_tail = (None if init_poses is None
                           else generator._tensor(init_poses))
        self._buf = []                  # received audio chunks (np)
        self._buf_offset = 0            # absolute index of _buf[0][..., 0]
        self._received = 0
        self._n = None                  # batch size, fixed by first push
        self._next_div = 0              # next window index to dispatch
        self._in_flight = []            # device samples, dispatch order
        self._last_dispatched = None    # device sample of the newest window
        self._emitted_idx = 0           # next window index to emit
        self._prev_np = None            # last materialised sample (np)
        self._emitted_frames = 0
        self._mask = None               # (N, T, 1) device seed mask
        self._finished = False

    # -- internals -----------------------------------------------------
    def _audio(self, start: int, end: int) -> np.ndarray:
        """Buffered audio [start:end) zero-padded to the window length."""
        full = np.concatenate(self._buf, axis=-1)
        s = start - self._buf_offset
        window = full[..., s:s + min(end, self._received) - start]
        if window.shape[-1] < end - start:
            window = np.pad(window, [(0, 0)] * (window.ndim - 1)
                            + [(0, end - start - window.shape[-1])])
        return window

    def _compact(self) -> None:
        """Drop buffered chunks wholly before the next window's start so a
        long-running stream holds O(window) audio, not O(stream)."""
        keep_from = int(self._next_div * self.stride
                        / self.pose_fps * self.wav_sr)
        while self._buf and (self._buf_offset + self._buf[0].shape[-1]
                             <= keep_from):
            self._buf_offset += self._buf[0].shape[-1]
            self._buf.pop(0)

    def _num_divisions(self, wav_len: int) -> int:
        return window_plan(wav_len, self.wav_sr, self.pose_fps,
                           self.window_len, self.seed_len)[1]

    def _dispatch_ready(self, final_len: Optional[int] = None) -> None:
        """Launch every window whose audio is available (all remaining ones
        when ``final_len`` marks the end of the stream)."""
        while True:
            d = self._next_div
            wav_start = int(d * self.stride / self.pose_fps * self.wav_sr)
            wav_end = wav_start + self.wav_window_len
            if final_len is None:
                # launch only windows certainly in the FINAL plan.  Both
                # checks are needed: the plan can SHRINK as audio grows
                # (the -1 correction of window_plan), so membership in
                # today's plan alone is unsafe, and the plan truncates to
                # whole seconds, so arrival of the audio alone is unsafe; a
                # fully arrived window that is in today's plan stays in
                # every later plan.  A degenerate plan on the partial
                # audio (window_plan raises when it owes frames but plans
                # no window) just means nothing is confirmed yet.
                try:
                    confirmed = self._num_divisions(self._received)
                except ValueError:
                    confirmed = 0
                if wav_end > self._received or d >= confirmed:
                    return
            elif d >= self._num_divisions(final_len):
                return
            wavs = self._audio(wav_start, wav_end)
            ip = im = None
            prev = self._init_tail if d == 0 else self._last_dispatched
            if prev is not None:
                dev = self.gen.device
                if self._mask is None:
                    self._mask = torch.zeros(self._n, self.window_len, 1,
                                             device=dev)
                    self._mask[:, :self.seed_len] = 1.0
                ip = torch.zeros(self._n, self.window_len, self.pose_dim,
                                 device=dev)
                ip[:, :self.seed_len] = prev[:, -self.seed_len:]
                im = self._mask
            sample = self.gen.generate_sample(
                wavs, self.pose_dim, self.window_len, generator=self._rng,
                noise=None if self._noise_fn is None else self._noise_fn(0, d),
                inpaint_poses=ip, inpaint_masks=im,
                sample_alg=self.sample_alg, trans_factor=self.trans_factor,
                pose_seed_len=self.seed_len, mesh=self._mesh)
            self._in_flight.append(sample)
            self._last_dispatched = sample
            self._next_div += 1

    def _emit(self, final: bool, seq_len: Optional[int] = None) -> np.ndarray:
        """Bring the oldest in-flight sample to the host and build its
        output chunk (stride frames; the final chunk is trimmed to
        seq_len)."""
        raw = self._in_flight.pop(0).cpu().numpy()
        x = raw
        if self.smooth_trans and self._emitted_idx > 0:
            x = crossfade_head(raw, self._prev_np[:, -self.seed_len:],
                               self.seed_len)
        self._prev_np = raw
        self._emitted_idx += 1
        if final:
            # the plan guarantees 1 <= remaining <= window_len; the clamp
            # turns a planning bug into an empty chunk, not extra frames
            chunk = x[:, : max(0, seq_len - self._emitted_frames)]
        else:
            chunk = x[:, : self.stride]
        self._emitted_frames += chunk.shape[1]
        return chunk

    # -- public API ----------------------------------------------------
    def push(self, audio) -> list:
        """Feed an audio chunk (shape ``(T,)`` or ``(N, T)``, float audio
        in [-1, 1]); returns the pose chunks completed so far, each exactly
        ``(N, stride, pose_dim)``.  Waits for the card only when more than
        ``max_in_flight`` windows are pending."""
        if self._finished:
            raise RuntimeError("stream already flushed")
        if torch.is_tensor(audio):
            audio = audio.detach().cpu().numpy()
        chunk = np.asarray(audio)
        # refused after the conversion, so that plain lists of integer PCM
        # (32768x the trained scale) are caught like integer arrays
        if not np.issubdtype(chunk.dtype, np.floating):
            raise TypeError(f"audio has dtype {chunk.dtype}: expected float "
                            "audio in [-1, 1]")
        chunk = chunk.astype(np.float32, copy=False)
        if chunk.ndim == 1:
            chunk = chunk[None]
        if self._n is None:
            self._n = chunk.shape[0]
        if chunk.shape[0] != self._n:
            raise ValueError("batch size changed mid-stream")
        self._buf.append(chunk)
        self._received += chunk.shape[-1]
        self._dispatch_ready()
        self._compact()
        out = []
        # a popped window is final only if it is the stream's last, which is
        # not known before flush; so at least one window stays pending here
        while len(self._in_flight) > self.max_in_flight:
            out.append(self._emit(final=False))
        return out

    def flush(self) -> list:
        """End of audio: launch the remaining (zero-padded) windows and
        return all remaining pose chunks (the final one up to
        ``pose_window_len`` frames).  The total emitted length equals
        ``generate_sequence``'s output for the same audio."""
        if self._finished:
            raise RuntimeError("stream already flushed")
        self._finished = True
        if self._n is None:
            return []
        self._dispatch_ready(final_len=self._received)
        seq_len = window_plan(self._received, self.wav_sr, self.pose_fps,
                              self.window_len, self.seed_len)[0]
        out = []
        while self._in_flight:
            out.append(self._emit(final=not self._in_flight[1:],
                                  seq_len=seq_len))
        return out
