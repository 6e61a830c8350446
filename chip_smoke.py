#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gesture_diffusion_torch``) on one
NVIDIA GPU: the BEAT serving path end to end, at full width, for all three
model types and both sampling algorithms.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build every CUDA kernel of the path from ``gesture_diffusion_torch/csrc``
     (nvcc at first use, into ``build/torch_kernels/``);
  2. build the models of ``configs/beat-ours.json`` (HA2G encoder, 4-layer
     oneway decoder, d_model 256, d_pose 123, 40-frame windows, 1000 steps):
     the flagship s2g_v2 and, with ``Model.type`` overridden, default and
     inpaint (92 memory rows), all with weights from a seeded generator;
  3. hold the fused kernel against its plain version on the same packed
     bf16 weights and inputs (ddim50, batches 1/3/64), at the planned
     cluster size and at every size the plan can choose (1, 2, 4, 8 blocks
     per clip, forced): DDIM with the identity and the x0 blend (also
     printed against the float32 scan sampler), x_add, DDPM with either
     blend, the 92-row memory, and all of them at once; check that the
     Python cluster plan is the library's; print the moments of the
     kernel's noise and check it bit for bit against the plain version's
     at every cluster size;
  4. time the kernel, its plain version and the bound at 1000 steps,
     batches 1 and 64, for each variant, at the planned cluster size;
  5. the main paths, each with the launch count set to 0 before it and read
     after it (the cluster size used at batches 1 and 64 is printed and
     must be above 1): the flagship ``generate_sample`` (DDIM) at batches 1 and 64
     and ``generate_sequence`` over two 10 s clips; the default type
     (DDIM, 92 memory rows); the inpaint type with DDPM and a seed blend;
     the flagship with DDPM; ``GestureStream`` against ``generate_sequence``
     on the same noise; ``eval_bpd`` at two ``t_block``s (no hand-written
     kernel on that path);
  6. print the kernels' JSON line and, last, the device line.

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
# eval_bpd at two t_blocks: the model runs at batch 8 or 400, so cuBLAS and
# cuDNN sum in float32 in another order; relative to max |vb|
BPD_BAR = 1e-3
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (H100 SXM data sheet)
H100_HBM_BPS = 3.35e12    # HBM3 bandwidth (H100 SXM data sheet)
TPU_KERNEL = "gesture_diffusion_tpu/ops/fused_sampler.py"


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


def fused_flops(n, t, nm, d, dp, f, layers, steps, hoisted=True) -> float:
    """Operations of the fused sampler's products (2 per multiply-add).
    Only memory rows 0 and 1 change with the step, so the function needs
    the memory K/V of all ``nm`` rows once per call and of two rows per
    step (``hoisted``); without it, all rows are counted on every step."""
    kv_rows = 2 if hoisted else nm
    per_layer = (2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d     # self
                 + 2 * t * d * d + 2 * kv_rows * d * 2 * d
                 + 2 * 2 * t * nm * d + 2 * t * d * d                     # cross
                 + 2 * 2 * t * d * f)                                     # FF
    per_step = 2 * t * dp * d + layers * per_layer + 2 * t * d * dp
    once = layers * 2 * nm * d * 2 * d if hoisted else 0
    return float(n) * (steps * per_step + once)


def fused_bytes(args: dict) -> float:
    """Bytes the kernel must move: each input read once, the output written
    once (the pack's kernel-side weights, bf16 memory and token table)."""
    p = args["packed"]
    n, t, dp = args["x_T"].shape
    nm, d = args["mem_rows"].shape[1:]
    s = args["num_steps"]
    skip = ("w_sp1", "b_sp1", "w_sp2", "b_sp2", "w_emm", "b_emm", "pe_m0")
    weights = sum(w.numel() * w.element_size()
                  for k, w in p._asdict().items() if k not in skip)
    optional = sum(n * t * dp * 4 for k in ("blend_a", "blend_b", "x_add")
                   if args[k] is not None)
    return float(weights + 2 * n * t * dp * 4 + n * nm * d * 2 + s * d * 2
                 + s * 4 * args["coefs"].shape[1] + optional)


def bound_ms(args: dict) -> tuple:
    """(ms, "operations" | "bytes", ms if the memory K/V were recomputed on
    every step): the least time the card could take for one call."""
    p = args["packed"]
    n, t, dp = args["x_T"].shape
    nm, d = args["mem_rows"].shape[1:]
    shape = (n, t, nm, d, dp, p.ff_w1.shape[2], args["n_layers"],
             args["num_steps"])
    t_ops = fused_flops(*shape) / H100_BF16_FLOPS * 1e3
    t_every = fused_flops(*shape, hoisted=False) / H100_BF16_FLOPS * 1e3
    t_bytes = fused_bytes(args) / H100_HBM_BPS * 1e3
    return ((t_ops, "operations", t_every) if t_ops >= t_bytes
            else (t_bytes, "bytes", t_every))


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of fn() over reps calls (CUDA events), after one
    warm-up call unless the caller has warmed fn's code already."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn, reps: int = 3, warmup: int = 1):
    """(mean ms, std ms, last result) of fn() on the host clock, each call
    ending in a device synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times)), float(np.std(times)), out


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
    for t in (8, WINDOW, 49, 64):
        nbytes, fc, half = fs.smem_plan(t, 256, 128, 1024)
        if nbytes != fs._library().fused_ddim_smem_bytes(t, 256, 128, fc,
                                                         int(half)):
            raise AssertionError("Python and CUDA shared-memory plans disagree")
    if fs.scratch_elems(92, 256, 4) != \
            fs._library().fused_ddim_scratch_elems(92, 256, 4):
        raise AssertionError("Python and CUDA scratch sizes disagree")
    nbytes = fs.smem_plan(WINDOW, 256, 128, 1024)[0]
    occupancy = {c: fs.max_clusters(fs._library(), c, nbytes, dev)
                 for c in fs.CLUSTER_SIZES}
    plans = {n: fs.cluster_plan(n, 8, occupancy.__getitem__)
             for n in (1, 3, 16, 17, 33, 64, 67, 128)}
    log(f"[build] clusters of C blocks ({nbytes} bytes each) the card runs at "
        f"once: {occupancy}; planned C by batch: {plans}")
    for n, c in plans.items():
        if fs._library().fused_ddim_cluster_size(n, 8, nbytes) != c:
            raise AssertionError(f"Python and CUDA cluster plans disagree at "
                                 f"batch {n}")

    # comparisons in true float32 (no TF32 in matmuls or cuDNN convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 2: the models -------------------------------------------------
    def bundle_of(model_type):
        cfg = JsonConfig(os.path.join(REPO, "configs", "beat-ours.json"))
        cfg.set("Model.type", model_type)
        return build_all(cfg, D_POSE, device=dev,
                         generator=torch.Generator().manual_seed(0))

    bundles = {mt: bundle_of(mt) for mt in ("s2g_v2", "default", "inpaint")}
    bundle = bundles["s2g_v2"]
    model = bundle.model
    for mt, b in bundles.items():
        log(f"[model] beat-ours, type {mt}: "
            f"{sum(p.numel() for p in b.model.parameters())} parameters, "
            f"{b.eval_schedule.num_timesteps} steps, d_pose {D_POSE}, "
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

    def seed_kw(n):
        """Seed poses for the x0 blend, as generate_sample takes them."""
        _, _, ip, im, _ = batch_inputs(n, 0, True)
        return dict(inpaint_poses=ip, inpaint_masks=im,
                    trans_factor=TRANS_FACTOR, pose_seed_len=SEED_LEN)

    # -- phase 3: kernel against its plain version (and the f32 scan) --------
    s50, t50 = make_diffusion("linear", 1000, "ddim50")
    g50 = {mt: Generator(b.model, s50, t50, use_fused=True, device=dev)
           for mt, b in bundles.items()}
    scan50 = Generator(model, s50, t50, use_fused=False, device=dev)
    worst = {}               # variant -> [worst relative, worst absolute]
    worst_c = {}             # cluster size -> worst relative

    def check(variant, label, args, scan=None):
        with torch.no_grad():
            k = fs.fused_ddim_sample(**args)
            planned = fs.last_cluster
            forced = {c: fs._fused_ddim_cuda(**args, cluster=c)
                      for c in fs.CLUSTER_SIZES}
            torch.cuda.synchronize()
            p = fs.fused_ddim_sample_plain(**args)
        kk, pp = k[..., :D_POSE], p[..., :D_POSE]
        r, a = rel(kk, pp), float((kk - pp).abs().max())
        per_c = {c: rel(kc[..., :D_POSE], pp) for c, kc in forced.items()}
        w = worst.setdefault(variant, [0.0, 0.0])
        w[0], w[1] = max(w[0], r, *per_c.values()), max(
            w[1], a, *(float((kc[..., :D_POSE] - pp).abs().max())
                       for kc in forced.values()))
        for c, rc in per_c.items():
            worst_c[c] = max(worst_c.get(c, 0.0), rc)
        extra = ""
        if scan is not None:
            with torch.no_grad():
                p32 = fs.fused_ddim_sample_plain(
                    **{**args, "compute_dtype": torch.float32})
            extra = (f"; floor plain-bf16 vs plain-f32-operands "
                     f"{rel(pp, p32[..., :D_POSE]):.3e}; kernel vs fp32 scan "
                     f"{rel(kk, scan):.3e}")
        log(f"[kernel-vs-plain] ddim50 {label}: max|d|/max|ref| {r:.3e} at "
            f"the planned C={planned} (max|d| {a:.3e}, max|ref| "
            f"{float(pp.abs().max()):.3e}); forced C "
            + ", ".join(f"{c}: {rc:.3e}" for c, rc in per_c.items()) + extra)
        finite = all(bool(torch.isfinite(x).all()) for x in (k, *forced.values()))
        if not finite or max(r, *per_c.values()) > KERNEL_BAR:
            raise AssertionError(
                f"fused kernel off its plain version: {r:.3e} (forced C: "
                f"{per_c}) > bar {KERNEL_BAR}")

    for n in (1, 3, 64):
        for blend in (False, True):
            wav, noise, ip, im, ramp = batch_inputs(n, 10 + n, blend)
            with torch.no_grad():
                args = g50["s2g_v2"].fused_args(wav, D_POSE, WINDOW, noise, ip,
                                                im, ramp)
            scan = scan50.generate_sample(wav, D_POSE, WINDOW, noise=noise,
                                          inpaint_poses=ip, inpaint_masks=im,
                                          trans_factor=TRANS_FACTOR if blend else None,
                                          pose_seed_len=SEED_LEN)
            check("ddim", f"batch {n:2d} {'x0-blend' if blend else 'identity'}",
                  args, scan)

    # the further variants: (variant, label, model type, blend, DDPM,
    # hand-made x_add)
    cases = (("x_add", "x_add + x0-blend (n_mem 32)", "s2g_v2", True, False, True),
             ("stochastic", "DDPM identity (n_mem 32)", "s2g_v2", False, True, False),
             ("stochastic", "DDPM x0-blend (n_mem 32)", "s2g_v2", True, True, False),
             ("long", "DDIM identity, default type (n_mem 92)", "default", False,
              False, False),
             ("x_add", "DDPM + x0-blend + x_add, inpaint type (n_mem 92)",
              "inpaint", True, True, False))
    for variant, label, mt, blend, ddpm, hand_xadd in cases:
        for n in (1, 3, 64):
            wav, noise, ip, im, ramp = batch_inputs(n, 40 + n, blend)
            with torch.no_grad():
                args = g50[mt].fused_args(
                    wav, D_POSE, WINDOW, noise, ip, im, ramp,
                    sample_alg="ddpm" if ddpm else "ddim",
                    seed=torch.tensor([1234 + n], device=dev))
            if hand_xadd:
                xa = torch.zeros_like(args["x_T"])
                xa[..., :D_POSE] = 0.3 * torch.randn(
                    n, WINDOW, D_POSE, generator=gen_seed, device=dev)
                args["x_add"] = xa
            if mt != "s2g_v2" and args["mem_rows"].shape[1] != 92:
                raise AssertionError(f"{mt} memory has "
                                     f"{args['mem_rows'].shape[1]} rows, not 92")
            if (args["x_add"] is not None) != (hand_xadd or mt == "inpaint"):
                raise AssertionError("x_add is not where it should be")
            check(variant, f"batch {n:2d} {label}", args)
    worst_all = max(w[0] for w in worst.values())
    log(f"[kernel-vs-plain] bar {KERNEL_BAR:.0e} (max|d|/max|ref|), worst "
        f"{worst_all:.3e}; by variant: "
        + ", ".join(f"{k} {w[0]:.3e}" for k, w in worst.items())
        + "; by forced cluster size: "
        + ", ".join(f"C={c} {w:.3e}" for c, w in worst_c.items()))

    # the kernel's noise: one step with coefficients (0, 0, 0, 0, 1) gives z
    with torch.no_grad():
        wav, noise, _, _, _ = batch_inputs(64, 77, False)
        args = g50["s2g_v2"].fused_args(wav, D_POSE, WINDOW, noise,
                                        sample_alg="ddpm", seed=(9 << 32) | 4242)
        args.update(tmap=args["tmap"][:1], num_steps=1, coefs=torch.tensor(
            [[0.0, 0.0, 0.0, 0.0, 1.0]], device=dev))
        z = fs.fused_ddim_sample(**args)
        zp = fs.fused_noise((9 << 32) | 4242, 0, 64, WINDOW, z.shape[2], dev)
        zc = {c: fs._fused_ddim_cuda(**args, cluster=c) for c in fs.CLUSTER_SIZES}
    z_equal = {c: bool(torch.equal(v, zp)) for c, v in zc.items()}
    log(f"[kernel-noise] z equals the plain version's bit for bit, by forced "
        f"cluster size: {z_equal}")
    if not all(z_equal.values()):
        raise AssertionError("the kernel's noise depends on the cluster size "
                             "or differs from the plain version's")
    zm, zs = float(z.mean()), float(z.std())
    zskew = float((((z - zm) / zs) ** 3).mean())
    zdiff = float((z - zp).abs().max())
    log(f"[kernel-noise] {z.numel()} draws of one launch: mean {zm:.4e}, std "
        f"{zs:.5f}, skew {zskew:.4e}, max|z| {float(z.abs().max()):.3f}; "
        f"max|kernel z - plain z| {zdiff:.3e} (logf/cosf against torch.log/cos)")
    if abs(zm) > 0.02 or abs(zs - 1.0) > 0.02 or abs(zskew) > 0.05 or zdiff > 1e-4:
        raise AssertionError("the kernel's noise is not the plain version's N(0, 1)")

    # -- phase 4: device time of the kernel and of the plain version ---------
    gens = {mt: Generator(b.model, b.eval_schedule, b.eval_timestep_map,
                          device=dev) for mt, b in bundles.items()}
    gen = gens["s2g_v2"]
    timings = {}
    for variant, mt, blend, alg in (("ddim", "s2g_v2", False, "ddim"),
                                    ("long", "default", False, "ddim"),
                                    ("stochastic", "s2g_v2", False, "ddpm"),
                                    ("x_add", "inpaint", True, "ddpm")):
        for n in (1, 64):
            wav, noise, ip, im, ramp = batch_inputs(n, 20 + n, blend)
            with torch.no_grad():
                args = gens[mt].fused_args(wav, D_POSE, WINDOW, noise, ip, im,
                                           ramp, sample_alg=alg, seed=5)
                ms = cuda_ms(lambda: fs.fused_ddim_sample(**args), reps=2)
                cluster = fs.last_cluster
                # the plain version's code is warm from phase 3
                plain = cuda_ms(lambda: fs.fused_ddim_sample_plain(**args),
                                reps=1, warmup=False)
            b, by, every = bound_ms(args)
            timings[variant, n] = dict(ms=ms, plain_ms=plain, bound_ms=b,
                                       bound_by=by, cluster=cluster)
            log(f"[kernel-time] {mt} {alg}{' x0-blend' if blend else ''}, n_mem "
                f"{args['mem_rows'].shape[1]}, batch {n:2d}, 1000 steps: kernel "
                f"{ms:.3f} ms (clusters of {cluster}), plain {plain:.3f} ms, bound {b:.3f} ms ({by}; "
                f"{every:.3f} ms with the memory K/V counted on every step) "
                f"[{smi}]")

    # -- phase 5: the main paths ---------------------------------------------
    launches = {}
    used = {}                # (variant, batch) -> cluster size of the launch

    def sample_path(variant, mt, alg, batches, blend):
        """generate_sample at 1000 steps: 1 warm-up, 3 timed, 1 checked."""
        g = gens[mt]
        fs.launches = 0
        for n in batches:
            wav = seeded_audio(30 + n, n, WINDOW / FPS)
            kw = seed_kw(n) if blend else {}
            before = fs.launches

            def call():
                return g.generate_sample(wav, D_POSE, WINDOW, generator=gen_seed,
                                         sample_alg=alg, **kw)

            mean_ms, std_ms, _ = host_ms(call)
            out = call()
            launched = fs.launches - before
            used[variant, n] = fs.last_cluster
            ok = (g.last_sample_path == "fused"
                  and tuple(out.shape) == (n, WINDOW, D_POSE)
                  and bool(torch.isfinite(out).all()))
            log(f"[generate_sample] {mt} {alg}{' x0-blend' if blend else ''}, "
                f"batch {n:2d}, 1000 steps: {mean_ms:.1f} ms (std {std_ms:.1f}, "
                f"{1e6 / mean_ms:.0f} steps/s), last_sample_path="
                f"{g.last_sample_path}, kernel launches +{launched}, clusters "
                f"of {fs.last_cluster} [{smi}]")
            if not ok or launched != 5:
                raise AssertionError(
                    f"generate_sample {mt} {alg} batch {n} did not run the fused "
                    f"kernel as expected (launches {launched})")
        launches[variant] = launches.get(variant, 0) + fs.launches

    sample_path("ddim", "s2g_v2", "ddim", (1, 64), False)
    log(f"[cluster] blocks per clip on the main path: batch 1 "
        f"C={used['ddim', 1]}, batch 64 C={used['ddim', 64]}")
    if used["ddim", 1] < 2 or used["ddim", 64] < 2:
        raise AssertionError("the main path did not launch clusters of more "
                             "than one block at batches 1 and 64")

    fs.launches = 0
    wav_long = seeded_audio(50, 2, 10.0)
    init = 0.5 * torch.randn(2, SEED_LEN, D_POSE, generator=gen_seed,
                             device=dev).cpu().numpy()
    t0 = time.perf_counter()
    seq = gen.generate_sequence(wav_long, SR, D_POSE, FPS, WINDOW, SEED_LEN,
                                generator=gen_seed, trans_factor=TRANS_FACTOR,
                                init_poses=init, smooth_trans=False)
    seq_s = time.perf_counter() - t0
    log(f"[generate_sequence] 2 clips x 10 s: {seq_s * 1e3:.1f} ms, output "
        f"{seq.shape}, kernel launches +{fs.launches} (x0-blend branch) [{smi}]")
    if seq.shape != (2, 200, D_POSE) or not np.isfinite(seq).all() \
            or fs.launches != 7:
        raise AssertionError("generate_sequence did not give 7 fused windows of "
                             "finite poses")
    launches["ddim"] += fs.launches

    sample_path("long", "default", "ddim", (1, 64), False)
    sample_path("x_add", "inpaint", "ddpm", (1, 64), True)
    sample_path("stochastic", "s2g_v2", "ddpm", (1,), False)

    # streaming: the same windows as generate_sequence, pushed in 0.5 s chunks
    noises = [torch.randn(2, WINDOW, D_POSE, generator=gen_seed, device=dev)
              for _ in range(7)]
    kw = dict(noise_fn=lambda b0, d: noises[d], trans_factor=TRANS_FACTOR,
              init_poses=init)
    fs.launches = 0
    t0 = time.perf_counter()
    offline = gen.generate_sequence(wav_long, SR, D_POSE, FPS, WINDOW, SEED_LEN,
                                    **kw)
    offline_s, offline_launches = time.perf_counter() - t0, fs.launches
    fs.launches = 0
    t0 = time.perf_counter()
    stream = gen.stream(SR, D_POSE, FPS, WINDOW, SEED_LEN, max_in_flight=4, **kw)
    chunks, first_s = [], None
    for i in range(0, wav_long.shape[1], SR // 2):
        got = stream.push(wav_long[:, i:i + SR // 2])
        if got and first_s is None:
            first_s = time.perf_counter() - t0
        chunks.extend(got)
    chunks.extend(stream.flush())
    stream_s, stream_launches = time.perf_counter() - t0, fs.launches
    streamed = np.concatenate(chunks, axis=1)
    same = streamed.shape == offline.shape and np.array_equal(streamed, offline)
    log(f"[stream] 2 clips x 10 s in 0.5 s chunks, max_in_flight 4: "
        f"{stream_s * 1e3:.1f} ms ({len(chunks)} chunks, first after "
        f"{'flush' if first_s is None else f'{first_s * 1e3:.1f} ms'}), kernel "
        f"launches +{stream_launches}; generate_sequence on the same noise "
        f"{offline_s * 1e3:.1f} ms, launches +{offline_launches}; outputs "
        f"equal exactly: {same} [{smi}]")
    if not same or stream_launches != 7 or offline_launches != 7:
        raise AssertionError("the stream does not equal generate_sequence in 7 "
                             "fused windows")
    launches["ddim"] += stream_launches + offline_launches

    # bpd: plain torch ops only, no hand-written kernel on this path
    poses = 0.5 * torch.randn(8, WINDOW, D_POSE, generator=gen_seed, device=dev)
    wav8 = seeded_audio(60, 8, WINDOW / FPS)
    fs.launches = 0
    bpd = {}
    for k in (1, 50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bpd[k] = gen.eval_bpd(poses, wav8, t_block=k,
                              generator=torch.Generator(device=dev).manual_seed(7))
        torch.cuda.synchronize()
        bpd[k]["seconds"] = time.perf_counter() - t0
    gap = rel(bpd[50]["vb"], bpd[1]["vb"])
    log(f"[eval_bpd] flagship, batch 8, 1000 timesteps: t_block 1 "
        f"{bpd[1]['seconds'] * 1e3:.1f} ms, t_block 50 "
        f"{bpd[50]['seconds'] * 1e3:.1f} ms; max|d vb|/max|vb| {gap:.3e} (bar "
        f"{BPD_BAR:.0e}), mean total_bpd {float(bpd[1]['total_bpd'].mean()):.4e}; "
        f"plain torch ops, no hand-written kernel (launches +{fs.launches}) "
        f"[{smi}]")
    if (gap > BPD_BAR or tuple(bpd[1]["vb"].shape) != (8, 1000)
            or not torch.isfinite(bpd[1]["total_bpd"]).all() or fs.launches):
        raise AssertionError("eval_bpd depends on t_block or is not finite")

    for variant, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path launched no {variant} kernel")

    what = {
        "ddim": ("fused_ddim_sample", f"{TPU_KERNEL}:705",
                 "s2g_v2, DDIM, T 40, n_mem 32"),
        "long": ("fused_ddim_sample[long memory]", f"{TPU_KERNEL}:314",
                 "default type, DDIM, T 40, n_mem 92"),
        "stochastic": ("fused_ddim_sample[stochastic]", f"{TPU_KERNEL}:535",
                       "s2g_v2, DDPM, T 40, n_mem 32"),
        "x_add": ("fused_ddim_sample[x_add]", f"{TPU_KERNEL}:474",
                  "inpaint type, DDPM, x0 blend, x_add, T 40, n_mem 92"),
    }
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "gesture_diffusion_torch/csrc/fused_ddim.cu",
        "replaces": replaces,
        "launches": launches[variant],
        "max_abs_err": worst[variant][1],
        "max_rel_err": worst[variant][0],
        "bar": KERNEL_BAR,
        **timings[variant, 64],
        "library_ms": None,
        "shape": f"batch 64, {shape}, 1000 steps",
        "batch1": timings[variant, 1],
    } for variant, (name, replaces, shape) in what.items()]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
