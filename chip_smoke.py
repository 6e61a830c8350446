#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gesture_diffusion_torch``) on one
NVIDIA GPU: the flagship BEAT serving path end to end, at full width.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build every CUDA kernel of the path from ``gesture_diffusion_torch/csrc``
     (nvcc at first use, into ``build/torch_kernels/``);
  2. build the flagship model of ``configs/beat-ours.json`` (s2g_v2, HA2G
     encoder, 4-layer oneway decoder, d_model 256, d_pose 123, 40-frame
     windows, 1000 DDIM steps) with weights from a seeded generator;
  3. hold the fused DDIM kernel against its plain version on the same
     packed bf16 weights and inputs (ddim50, batches 1/3/64, identity and
     x0 blend), and print both against the float32 scan sampler;
  4. the main path: ``Generator.generate_sample`` at 1000 steps for batches
     1 and 64, then ``generate_sequence`` over two 10 s clips seeded with
     initial poses (7 windows, all on the x0-blend branch), with launch
     counts read around it;
  5. print the kernels' JSON line and, last, the device line.

Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
D_POSE, WINDOW, SEED_LEN, FPS, SR = 123, 40, 10, 20, 16000
TRANS_FACTOR = 0.575
KERNEL_BAR = 5e-3        # max |kernel - plain| / max |plain|, see phase 3
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (H100 SXM data sheet)
H100_HBM_BPS = 3.35e12    # HBM3 bandwidth (H100 SXM data sheet)


def log(*args):
    print(*args, flush=True)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def seeded_audio(seed: int, n: int, seconds: float) -> np.ndarray:
    """Speech-like test audio: noise bursts under a syllable-rate envelope."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 6, (n, 1)))
    return (0.3 * env * rng.normal(size=(n, t.size))).astype(np.float32)


def fused_ddim_flops(n, t, nm, d, dp, f, layers, steps) -> float:
    """Operations of the fused sampler's products (2 per multiply-add)."""
    per_layer = (2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d     # self
                 + 2 * t * d * d + 2 * nm * d * 2 * d + 2 * 2 * t * nm * d
                 + 2 * t * d * d                                          # cross
                 + 2 * 2 * t * d * f)                                     # FF
    per_step = 2 * t * dp * d + layers * per_layer + 2 * t * d * dp
    return float(n) * steps * per_step


def fused_ddim_bytes(args: dict) -> float:
    """Bytes the kernel must move: each input read once, the output written
    once (the pack's kernel-side weights, bf16 memory and token table)."""
    p = args["packed"]
    n, t, dp = args["x_T"].shape
    nm, d = args["mem_rows"].shape[1:]
    s = args["num_steps"]
    skip = ("w_sp1", "b_sp1", "w_sp2", "b_sp2", "w_emm", "b_emm", "pe_m0")
    weights = sum(w.numel() * w.element_size()
                  for k, w in p._asdict().items() if k not in skip)
    blend = 2 * n * t * dp * 4 if args["blend_a"] is not None else 0
    return float(weights + 2 * n * t * dp * 4 + n * nm * d * 2 + s * d * 2
                 + s * 16 + blend)


def bound_ms(args: dict) -> tuple:
    p = args["packed"]
    n, t, dp = args["x_T"].shape
    nm, d = args["mem_rows"].shape[1:]
    ops = fused_ddim_flops(n, t, nm, d, dp, p.ff_w1.shape[2], args["n_layers"],
                           args["num_steps"])
    t_ops = ops / H100_BF16_FLOPS * 1e3
    t_bytes = fused_ddim_bytes(args) / H100_HBM_BPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gesture_diffusion_torch.generation import Generator, make_trans_ramp
    from gesture_diffusion_torch.models import build_all
    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.ops import kernel_build
    from gesture_diffusion_torch.utils import JsonConfig

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    fs._library()
    path, secs, ptxas = kernel_build.BUILD_INFO["fused_ddim"]
    log(f"[build] fused_ddim: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {secs:.1f} s) -> {os.path.relpath(path, REPO)}")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")
    if fs.smem_bytes(WINDOW, 32, 256, 128, 512) != \
            fs._library().fused_ddim_smem_bytes(WINDOW, 32, 256, 128, 512):
        raise AssertionError("Python and CUDA shared-memory plans disagree")

    # comparisons in true float32 (no TF32 in matmuls or cuDNN convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 2: the flagship model -----------------------------------------
    cfg = JsonConfig(os.path.join(REPO, "configs", "beat-ours.json"))
    bundle = build_all(cfg, D_POSE, device=dev,
                       generator=torch.Generator().manual_seed(0))
    model = bundle.model
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] beat-ours: {n_params} parameters, "
        f"{bundle.eval_schedule.num_timesteps} DDIM steps, d_pose {D_POSE}, "
        f"window {WINDOW}")
    gen_seed = torch.Generator(device=dev).manual_seed(1)

    def batch_inputs(n, seed, blend):
        wav = torch.from_numpy(seeded_audio(seed, n, WINDOW / FPS)).to(dev)
        noise = torch.randn((n, WINDOW, D_POSE), generator=gen_seed, device=dev)
        ip = im = ramp = None
        if blend:
            ip = torch.zeros(n, WINDOW, D_POSE, device=dev)
            ip[:, :SEED_LEN] = 0.5 * torch.randn(n, SEED_LEN, D_POSE,
                                                 generator=gen_seed, device=dev)
            im = torch.zeros(n, WINDOW, 1, device=dev)
            im[:, :SEED_LEN] = 1.0
            ramp = torch.from_numpy(make_trans_ramp(
                TRANS_FACTOR, SEED_LEN, WINDOW)).to(dev)
        return wav, noise, ip, im, ramp

    # -- phase 3: kernel against its plain version (and the f32 scan) --------
    s50, t50 = make_diffusion("linear", 1000, "ddim50")
    g50 = Generator(model, s50, t50, use_fused=True, device=dev)
    scan50 = Generator(model, s50, t50, use_fused=False, device=dev)
    worst_rel = worst_abs = 0.0
    for n in (1, 3, 64):
        for blend in (False, True):
            wav, noise, ip, im, ramp = batch_inputs(n, 10 + n, blend)
            with torch.no_grad():
                args = g50.fused_args(wav, D_POSE, WINDOW, noise, ip, im, ramp)
                k = fs.fused_ddim_sample(**args)
                torch.cuda.synchronize()
                p = fs.fused_ddim_sample_plain(**args)
                p32 = fs.fused_ddim_sample_plain(
                    **{**args, "compute_dtype": torch.float32})
            scan = scan50.generate_sample(wav, D_POSE, WINDOW, noise=noise,
                                          inpaint_poses=ip, inpaint_masks=im,
                                          trans_factor=TRANS_FACTOR if blend else None,
                                          pose_seed_len=SEED_LEN)
            kk, pp = k[..., :D_POSE], p[..., :D_POSE]
            r, a = rel(kk, pp), float((kk - pp).abs().max())
            worst_rel, worst_abs = max(worst_rel, r), max(worst_abs, a)
            log(f"[kernel-vs-plain] ddim50 batch {n:2d} "
                f"{'x0-blend' if blend else 'identity'}: max|d|/max|ref| "
                f"{r:.3e} (max|d| {a:.3e}, max|ref| {float(pp.abs().max()):.3e}); "
                f"floor plain-bf16 vs plain-f32-operands {rel(pp, p32[..., :D_POSE]):.3e}; "
                f"kernel vs fp32 scan {rel(kk, scan):.3e}")
            if not torch.isfinite(k).all() or r > KERNEL_BAR:
                raise AssertionError(
                    f"fused kernel off its plain version: {r:.3e} > bar {KERNEL_BAR}")
    log(f"[kernel-vs-plain] bar {KERNEL_BAR:.0e} (max|d|/max|ref|), worst "
        f"{worst_rel:.3e}")

    # device time of the kernel and of the plain version, 1000 steps
    gen = Generator(model, bundle.eval_schedule, bundle.eval_timestep_map,
                    device=dev)
    timings = {}
    for n in (1, 64):
        wav, noise, _, _, _ = batch_inputs(n, 20 + n, False)
        with torch.no_grad():
            args = gen.fused_args(wav, D_POSE, WINDOW, noise)
            ms = cuda_ms(lambda: fs.fused_ddim_sample(**args), reps=2)
            plain = cuda_ms(lambda: fs.fused_ddim_sample_plain(**args), reps=1)
        b, by = bound_ms(args)
        timings[n] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"[kernel-time] batch {n:2d}, 1000 steps: kernel {ms:.3f} ms, "
            f"plain {plain:.3f} ms, bound {b:.3f} ms ({by}) [{smi}]")

    # -- phase 4: the main path ----------------------------------------------
    fs.launches = 0
    for n in (1, 64):
        wav = seeded_audio(30 + n, n, WINDOW / FPS)
        before = fs.launches
        mean_ms, std_ms, steps_s = gen.eval_infer_time(
            wav, D_POSE, WINDOW, repetitions=3, warmup=1)
        out = gen.generate_sample(wav, D_POSE, WINDOW, generator=gen_seed)
        launched = fs.launches - before
        ok = (gen.last_sample_path == "fused"
              and tuple(out.shape) == (n, WINDOW, D_POSE)
              and bool(torch.isfinite(out).all()))
        log(f"[generate_sample] batch {n:2d}, 1000 steps: {mean_ms:.1f} ms "
            f"(std {std_ms:.1f}, {steps_s:.0f} steps/s), last_sample_path="
            f"{gen.last_sample_path}, kernel launches +{launched} [{smi}]")
        if not ok or launched != 5:
            raise AssertionError(f"generate_sample batch {n} did not run the "
                                 f"fused kernel as expected (launches {launched})")

    wav_long = seeded_audio(50, 2, 10.0)
    init = 0.5 * torch.randn(2, SEED_LEN, D_POSE, generator=gen_seed,
                             device=dev).cpu().numpy()
    before = fs.launches
    t0 = time.perf_counter()
    seq = gen.generate_sequence(wav_long, SR, D_POSE, FPS, WINDOW, SEED_LEN,
                                generator=gen_seed, trans_factor=TRANS_FACTOR,
                                init_poses=init, smooth_trans=False)
    seq_s = time.perf_counter() - t0
    launched = fs.launches - before
    log(f"[generate_sequence] 2 clips x 10 s: {seq_s * 1e3:.1f} ms, output "
        f"{seq.shape}, kernel launches +{launched} (x0-blend branch) [{smi}]")
    if seq.shape != (2, 200, D_POSE) or not np.isfinite(seq).all() or launched != 7:
        raise AssertionError("generate_sequence did not give 7 fused windows of "
                             "finite poses")
    main_launches = fs.launches
    if main_launches == 0:
        raise AssertionError("the main path launched no fused kernel")

    kernels = [{
        "name": "fused_ddim_sample",
        "route": "cuda",
        "source": "gesture_diffusion_torch/csrc/fused_ddim.cu",
        "replaces": "gesture_diffusion_tpu/ops/fused_sampler.py:705",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "bar": KERNEL_BAR,
        "ms": timings[64]["ms"],
        "plain_ms": timings[64]["plain_ms"],
        "bound_ms": timings[64]["bound_ms"],
        "bound_by": timings[64]["bound_by"],
        "library_ms": None,
        "shape": "batch 64, T 40, n_mem 32, 1000 steps",
        "batch1": timings[1],
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
