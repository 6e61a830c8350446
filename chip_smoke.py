#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gesture_diffusion_torch``) on one
NVIDIA GPU: the BEAT serving path end to end, at full width, for all three
model types and both sampling algorithms; training and the phase CLI; a
user's run from a BEAT corpus tree to BVH files and video; the
TED-Expressive configuration and the other decoders, which no fused
kernel serves; the pymo mocap transforms and the model zoo's other stacks.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build every CUDA kernel of the path from ``gesture_diffusion_torch/csrc``
     (nvcc at first use, into ``build/torch_kernels/``): the fused
     sampler's bf16 and float32 instantiations, and beside them, in a
     second nvcc started at the same time and cached as the package's
     library is, ``tests/fixtures/fused_ddim_bf16_only.cu`` (the source
     before the float32 instantiation) for phase 4b;
  2. build the models of ``configs/beat-ours.json`` (HA2G encoder, 4-layer
     oneway decoder, d_model 256, d_pose 123, 40-frame windows, 1000 steps):
     the flagship s2g_v2 and, with ``Model.type`` overridden, default and
     inpaint (92 memory rows), all with weights from a seeded generator;
  3. hold the fused kernel against its plain version on the same packed
     bf16 weights and inputs (ddim50, batches 1/3/64), at the planned
     cluster size and at every size the plan can choose (1, 2, 4, 8 blocks
     per clip, forced): DDIM with the identity and the x0 blend (also
     printed against the float32 scan sampler), x_add, DDPM with either
     blend, the 92-row memory, and all of them at once; then the same for
     the float32 instantiation on the bf16 pack and on an f32 pack, held
     to 1e-4 (or twice the plain version's own distance between the card
     and the CPU, printed, where that is over 5e-5); check that the
     Python cluster plans are the library's; print the moments of the
     kernel's noise and check it bit for bit against the plain version's
     at every cluster size and in every instantiation;
  4. time the kernel, its plain version and the bound at 1000 steps,
     batches 1 and 64, for each variant of the bf16 instantiation and for
     the float32 one on bf16 and on f32 weights, at the planned cluster
     size (the float32 bound: bf16 over 3 passes on bf16 weights, TF32
     over 3 on f32 ones; ``flops_rate``); 4b. hold the bf16 instantiation
     bit for bit against the bf16-only source at ddim50 (DDIM, DDPM with
     the x0 blend, batches 1 and 64, every cluster size);
  5. the main paths, each with the launch count set to 0 before it and read
     after it (the cluster size used at batches 1 and 64 is printed and
     must be above 1), under the Generator's default compute-dtype policy
     (float32 at one or two clips, else bf16; each line names the
     instantiations it launched): the flagship ``generate_sample`` (DDIM)
     at batches 1 and 64, at batch 1 also with ``fused_dtype`` bf16 and
     float32, and ``generate_sequence`` over two 10 s clips; the default type
     (DDIM, 92 memory rows), the inpaint type with DDPM and a seed blend
     and the flagship with DDPM, each at batches 1 and 64;
     ``GestureStream`` against ``generate_sequence`` on the same noise;
     ``eval_bpd`` at two ``t_block``s (no hand-written kernel on that
     path).  The launches are counted by row of the kernels line
     (``counted``): the bf16 instantiation's by variant, the float32 one's
     by pack; every row must have launches here, and again over phases
     5-16;
  6. training at full width (``configs/beat-ours.json``, batch 64, T 40,
     32 000-sample wav, 1000 diffusion steps) on seeded synthetic data of
     8 batches, through ``Trainer.train``: windows/s (one epoch's steps
     queued through ``Trainer.train_steps``, one synchronise at the end),
     the synchronised step's ms and peak memory for the config's bf16
     encoder and for f32, each step's loss and grad_norm; one step at batch
     4 on the card against the same step on the CPU (TF32 off, one mel); a
     resumed Trainer's next step against the uninterrupted run's; and the
     trained weights served through the fused kernel
     (``Generator.update_variables``), held against its plain version.  The training path launches no hand-written kernel;
  7. the phase CLI (``gesture_diffusion_torch/cli.py``) in process, on the
     card: ``configs/beat-ours.json`` at full width with ``Data.synthetic``
     (41 joints, 16/8/2 samples of 20 s) and a hierarchy template pruned
     from ``tests/golden/synth_fullbody.bvh``, through prep, data, train
     (20 steps at batch 64), eval (bpd, samples, beat metrics), eval-time
     and gen; each phase's wall seconds, the artifacts' shapes and keys,
     ``path=fused``, and the fused kernel's launches in eval, eval-time
     and gen (each above 0); then the kernel against its plain version at
     the CLI's shapes on the trained weights, 1000 steps, at the planned
     and every forced cluster size: eval's batch of 20 test windows and
     gen's first window of the 2 test sequences with the x0 blend;
  8. the corpus ends of a user's run (``corpus_paths``, ``[corpus]``
     lines), on the card: a synthetic BEAT tree at the corpus's sizes
     (10 usable recordings of 70 s, the 75-joint skeleton at 120 fps as
     17 MB BVHs, int16 wavs at 48 kHz, word TextGrids, plus the unsyncable
     recording and one without a TextGrid, both skipped and logged), then
     the CLI's prep, data, train (32 steps at batch 30) and gen on
     ``configs/beat-ours.json`` at full width with 60 s samples: each
     phase's wall seconds, 8/1/1 samples, the artifacts, gen's fused
     launches; the native BVH parser against its numpy route (equal, MB/s
     of each) and prep's parts on one recording; the kernel against its
     plain version at gen's shapes on the trained weights; then
     ``sample2bvh_batch`` (every predicted joint's rotation columns parse
     back equal to the sample), ``pose_to_positions`` and a raw AVI with
     the speech (no matplotlib or Pillow on this path);
  9. ``configs/tedexp-ours.json`` at full width (``tedexp_paths``; the
     10-layer cross-attention decoder, d_model 512, d_pose 126, 34-frame
     windows at 15 fps), which no fused kernel serves: ``generate_sample``
     at batches 1 and 32 on a ddim250 schedule (ms a step: the scan's
     steps cost alike) and ``generate_sequence`` over
     2 x 10 s at ddim50, on the scan sampler; one ``denoise`` call and a 50-step sample
     on the card against the CPU (TF32 off); queued training at batch 32
     (windows/s, peak MB) and one batch-4 step against the CPU (phase 6's
     bars); the phase CLI on ``Data.synthetic`` (42 joints in euler, 8/4/4
     samples of 20 s, 6 train steps, the schedule respaced to ddim50) with
     eval's FGD, latent distance and diversity; 0 fused-kernel launches;
  9b. the float32 MMDiT (``mmdit_paths``, ``[mmdit]`` lines) at the
     tedexp-mmdit cell's widths (d_model 1536, 24 heads) cut to 3 blocks,
     at its batch of 16 (544 frame rows, 1648 speech-memory rows, 16
     modulation rows): ``generate_sample`` on the scan sampler with the
     split-TF32 GEMM's launches counted from 0 (every block Linear,
     ``context_embedder`` and ``norm_out.linear`` once a step, q/k/v one
     launch a stream); every launch of one ``denoise`` call against
     ``f32x3_linear_plain`` and float64 on its inputs, and timed beside its
     bound and ``F.linear`` in float32 (``[mmdit-gemm]`` lines);
  10. the GCN and UNet decoders at smoke widths (``decoder_paths``; no
     shipped configuration uses them): one forward, one train step and one
     50-step ``generate_sample`` each, on the card against the CPU;
  11. the pymo mocap stack (``mocap_paths``, ``[mocap]`` lines): one 70 s
     recording at 120 fps over the 75-joint skeleton through the
     transforms on the card and on the CPU (expmap, positions, the expmap
     inverse, pos_rot_deltas with smoothing and its inverse, the absolute
     translation deltas, Mirror, EulerReorder, DownSampler -> JointSelector
     -> Numpyfier): the largest difference of each and its seconds on
     both, near-tie flips counted and held to their rotation; the golden
     pymo output on the card; [corpus] gen's BVH in positions on the card,
     written as the HTML player;
  12. the model zoo's other stacks at full width (``zoo_paths``, ``[zoo]``):
     the GLIDE UNet at glide-text2im's 64x64 base widths, the Primer-EZ
     encoder and decoder at the flagship decoder's, SEBottleneck at the
     trunk's last stage, each in float32 against float64 on the card;
  13. data parallelism on the one card (``multi_paths``, ``[multi-*]``):
     the DDP trainer over NCCL at world size 1 against the plain trainer
     (8 steps at batch 64, f32 and the bf16 encoder, and the ms a step of
     each over 5 windows); two ranks over
     gloo sharing cuda:0, spawned as subprocesses, one step of 32 rows each
     against the one-process step on the global batch of 64 (phase 6's
     bars), the loss-aware sampler's ragged gather; the Generator over
     ``make_mesh(devices=[cuda:0, cuda:0])`` at batch 64 (DDIM, DDPM,
     inpaint DDPM with the x0 blend) against the unsharded batch, 2
     launches each, batch 3 unsharded, the stream against
     ``generate_sequence`` over the mesh, the kernel at ``clip_base`` 0
     and 32 against its plain version; the CLI's ``Train.world_size: 2``
     refused on one card with ``make_mesh``'s error;
  14. tensor parallelism on the one card (``tp_paths``, ``[tp]``): beat-ours
     at full width split over a model axis (``parallel/tp.py``) in 1 x 2
     and 2 x 2 (data x model) gloo ranks sharing cuda:0, spawned as
     subprocesses, one step of each layout against the one-process step
     on the global batch of 64 (phase 6's bars), 40 kernels split, ms a
     step a rank (overhead, not scaling); the 2 x 2 ranks' checkpoint
     (whole tensors) in a plain Generator through the fused kernel
     against the one-process step's weights;
  15. the whole-model compute dtype (``dtype_paths``, ``[dtype-*]``): beat-ours
     training at batch 64 in f32, with the bf16 encoder and with
     ``Train.dtype`` bf16 (windows/s, peak MB); one bf16 step at batch 4 on
     the card and on the CPU against the CPU's float64 step (the bars of
     ``tests/test_torch_port_dtype.py``, the CPU in JAX's place); the
     bf16-trained model through the fused kernel (held against its plain
     version) and through the scan path; tedexp's scan step in bf16 beside
     f32 at batches 1 and 32;
  16. a JAX checkpoint (``jax_chkpt_paths``, ``[jax-chkpt]``): the committed
     ``tests/fixtures/jax_chkpt`` checkpoint, written by the JAX package's
     ``save_checkpoint``, through the CLI's prep, data, eval-time and gen
     on the card with no ``.pt`` beside it (fused launches counted); the
     card's scan sample on its weights against the JAX sample recorded
     beside it (1e-4, TF32 off); the kernel at its shapes;
  17. print the launches of each instantiation over the main paths (each
     must be above 0), the kernels' JSON line (the four variants of the
     bf16 instantiation, then the float32 one on bf16 and on f32 weights,
     then the split-TF32 GEMM from phase 9b) and, last, the device line.

    python3 chip_smoke.py --only corpus tedexp mmdit decoders mocap zoo multi tp dtype jax-chkpt

runs phases 8 to 16 alone (no kernel phases, no result line), to try
them.

Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
D_POSE, WINDOW, SEED_LEN, FPS, SR = 123, 40, 10, 20, 16000
TRANS_FACTOR = 0.575
KERNEL_BAR = 5e-3        # max |kernel - plain| / max |plain|, see phase 3
TRAIN_BATCH, TRAIN_BATCHES, TRAIN_EPOCHS = 64, 8, 3
# one step, card against CPU with TF32 off, one mel: cuDNN and the CPU sum
# the convolution gradients in other orders.  float32: the loss and the BN
# statistics to 1e-4, the gradient norm to 1e-3, every gradient outside the
# SE-ResNet trunk to 1e-3 of its max|g|.  The trunk's train-mode gradients
# are ill-conditioned on random weights (float32 on the card and on the
# CPU alike is off the float64 result by percents), so in float32 the
# card's trunk is held to TRAIN_TRUNK_RATIO times the CPU's own float32
# error, and every gradient is held to 1e-3 in float64
TRAIN_LOSS_BAR, TRAIN_NORM_BAR, TRAIN_GRAD_BAR = 1e-4, 1e-3, 1e-3
TRAIN_TRUNK_RATIO = 2.0
TRUNK = "speech_encoder.wav_encoder.feat_extractor."
# eval_bpd at two t_blocks: the model runs at batch 8 or 400, so cuBLAS and
# cuDNN sum in float32 in another order; relative to max |vb|
BPD_BAR = 1e-3
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak (H100 SXM data sheet)
H100_TF32_FLOPS = 494.7e12  # dense TF32 tensor-core peak (H100 SXM data sheet)
H100_HBM_BPS = 3.35e12    # HBM3 bandwidth (H100 SXM data sheet)
TPU_KERNEL = "gesture_diffusion_tpu/ops/fused_sampler.py"
# the float32 instantiation against its plain version (float32 on the card,
# TF32 off), ddim50: 1e-4 of max|ref|, unless the plain version's own
# distance from the CPU's run is over F32_FLOOR; then twice that distance
F32_BAR, F32_FLOOR = 1e-4, 5e-5
#: the bar of float32-compute comparisons, set in phase 3 from that distance
f32_bar = [F32_BAR]
# the bf16 instantiation as it was before the float32 one was added, built
# beside the package's source and held bit for bit against it
BF16_ONLY = os.path.join(REPO, "tests", "fixtures", "fused_ddim_bf16_only.cu")


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
    once (the pack's weights as the pack holds them, the memory rows and
    the token table in the compute dtype)."""
    p = args["packed"]
    n, t, dp = args["x_T"].shape
    nm, d = args["mem_rows"].shape[1:]
    s = args["num_steps"]
    ob = 4 if args["compute_dtype"] == torch.float32 else 2
    skip = ("w_sp1", "b_sp1", "w_sp2", "b_sp2", "w_emm", "b_emm", "pe_m0")
    weights = sum(w.numel() * w.element_size()
                  for k, w in p._asdict().items() if k not in skip)
    optional = sum(n * t * dp * 4 for k in ("blend_a", "blend_b", "x_add")
                   if args[k] is not None)
    return float(weights + 2 * n * t * dp * 4 + n * nm * d * ob + s * d * ob
                 + s * 4 * args["coefs"].shape[1] + optional)


def flops_rate(args: dict) -> float:
    """The card's rate for the call's products: bf16 on the tensor cores,
    or for float32 compute the fastest float32-accurate product the tensor
    cores offer.  On bf16 weights: TF32 over 2 passes (a_hi*w + a_lo*w, the
    weight exact in TF32), or bf16 over 3 (the activation split into three
    bf16 pieces, within 2^-25 of it together, each piece times the exact
    bf16 weight exact in the f32 accumulator); bf16 over 3 is faster.  On
    f32 weights: TF32 over 3 passes (hi*hi + hi*lo + lo*hi) or bf16 over 6,
    the same rate."""
    if args["compute_dtype"] != torch.float32:
        return H100_BF16_FLOPS
    if args["packed"].w_embx.dtype == torch.float32:
        return max(H100_TF32_FLOPS / 3, H100_BF16_FLOPS / 6)
    return max(H100_TF32_FLOPS / 2, H100_BF16_FLOPS / 3)


def bound_ms(args: dict) -> tuple:
    """(ms, "operations" | "bytes", ms if the memory K/V were recomputed on
    every step): the least time the card could take for one call."""
    p = args["packed"]
    n, t, dp = args["x_T"].shape
    nm, d = args["mem_rows"].shape[1:]
    shape = (n, t, nm, d, dp, p.ff_w1.shape[2], args["n_layers"],
             args["num_steps"])
    t_ops = fused_flops(*shape) / flops_rate(args) * 1e3
    t_every = fused_flops(*shape, hoisted=False) / flops_rate(args) * 1e3
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


def make_check(worst: dict, worst_c: dict):
    """Phase 3's comparison of the fused kernel with its plain version on
    the same arguments, at the planned and at every forced cluster size:
    ``check(variant, label, args, scan=None, steps=...)`` logs the errors,
    folds them into ``worst`` (variant -> [relative, absolute]; float32
    compute under "f32" or, on an f32 pack, "f32w", whatever the variant)
    and ``worst_c`` (cluster size -> relative), and raises above the bar
    of the compute dtype (KERNEL_BAR for bf16, ``f32_bar`` for float32).
    Its launches are comparisons: it leaves the launch counts as it found
    them.  A cluster size is forced where it divides the heads (the
    flagship's 8 take every size)."""
    from gesture_diffusion_torch.ops import fused_sampler as fs

    def check(variant, label, args, scan=None, steps="ddim50"):
        f32 = args["compute_dtype"] == torch.float32
        if f32:
            label = f"float32 compute ({variant}) {label}"
            variant = ("f32w" if args["packed"].w_embx.dtype == torch.float32
                       else "f32")
        bar = f32_bar[0] if f32 else KERNEL_BAR
        counts = fs.launches, dict(fs.launches_by_dtype)
        with torch.no_grad():
            k = fs.fused_ddim_sample(**args)
            planned = fs.last_cluster
            forced = {c: fs._fused_ddim_cuda(**args, cluster=c)
                      for c in fs.CLUSTER_SIZES if args["heads"] % c == 0}
            torch.cuda.synchronize()
            p = fs.fused_ddim_sample_plain(**args)
        fs.launches, fs.launches_by_dtype = counts[0], counts[1]
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
        log(f"[kernel-vs-plain] {steps} {label}: max|d|/max|ref| {r:.3e} at "
            f"the planned C={planned} (max|d| {a:.3e}, max|ref| "
            f"{float(pp.abs().max()):.3e}); forced C "
            + ", ".join(f"{c}: {rc:.3e}" for c, rc in per_c.items()) + extra)
        finite = all(bool(torch.isfinite(x).all()) for x in (k, *forced.values()))
        if not finite or max(r, *per_c.values()) > bar:
            raise AssertionError(
                f"fused kernel off its plain version ({label}): {r:.3e} "
                f"(forced C: {per_c}) > bar {bar:.3e}")

    return check


def reset_counts():
    """Set the fused kernel's launch counts to 0, just before a main path."""
    from gesture_diffusion_torch.ops import fused_sampler as fs
    fs.launches, fs.launches_by_dtype = 0, {}


def counted(variant: str, into: dict = None) -> dict:
    """The launches since ``reset_counts()`` by row of the kernels line,
    added into ``into``: the bf16 instantiation's under ``variant``, the
    float32 one's under "f32" (bf16 weights) or "f32w" (f32 weights)."""
    from gesture_diffusion_torch.ops import fused_sampler as fs
    into = {} if into is None else into
    for (compute, weights), k in fs.launches_by_dtype.items():
        row = (variant if compute != torch.float32
               else "f32w" if weights == torch.float32 else "f32")
        into[row] = into.get(row, 0) + k
    return into


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def synthetic_training_set(n: int, seed: int, window: int = WINDOW,
                           fps: int = FPS, d_pose: int = D_POSE):
    """Speech-like audio and smooth poses that follow its loudness, so the
    loss has something to learn."""
    from gesture_diffusion_torch.training import ArrayDataset

    rng = np.random.default_rng(seed)
    wav = seeded_audio(seed, n, window / fps)
    per_frame = wav.shape[1] // window
    env = np.abs(wav[:, :window * per_frame]).reshape(n, window, -1).mean(-1)
    drift = np.cumsum(rng.normal(0, 0.1, (n, window, d_pose)), axis=1)
    pose = 0.3 * drift + 4.0 * env[..., None] * rng.normal(1, 0.2, (1, 1, d_pose))
    return ArrayDataset({"wav": wav, "pose": pose.astype(np.float32)})


def steps_card_vs_cpu(models: dict, weights: dict, sched, train_cfg, batch: dict,
                      t: torch.Tensor, noise: torch.Tensor, dev, dtype) -> dict:
    """One ``make_train_step`` step from the same weights, batch, t and
    noise on the CPU and on the card (``models`` maps "cpu" and "card" to a
    callable that gives the model there), in ``dtype``.  Returns the loss's
    and the norm's relative differences, the BN statistics' max|d|/max|ref|,
    the worst gradient (max|d| over the tensor's max|g|, floored at 1e-2 of
    the largest) outside and inside the SE-ResNet trunk with its name, the
    CPU step's seconds, and both gradient sets."""
    from gesture_diffusion_torch.training import make_optimizer, make_train_step

    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        model = models[name]()
        model.load_state_dict(weights)
        model.to(dtype)
        step = make_train_step(model, sched.to(d), *make_optimizer(model, train_cfg))
        t0 = time.perf_counter()
        m = step({"wav": batch["wav"].to(d), "pose": batch["pose"].to(d, dtype)},
                 0, t=t.to(d), noise=noise.to(d, dtype))
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
                 if "running_" in k}
        out[name] = ({k: float(v) for k, v in m.items()}, grads, stats,
                     time.perf_counter() - t0)
    (mc, gc, sc, cpu_s), (mg, gg, sg, _) = out["cpu"], out["card"]
    top = max(float(v.abs().max()) for v in gc.values())
    # the key projections' dconv biases have a gradient of 0 in exact
    # arithmetic (the softmax removes a constant shift): float noise here
    ratio = {k: float((gg[k] - v).abs().max()) / max(float(v.abs().max()),
                                                    1e-2 * top)
             for k, v in gc.items()}
    return dict(
        loss=abs(mg["loss"] - mc["loss"]) / abs(mc["loss"]),
        norm=abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"],
        outside=max((r, k) for k, r in ratio.items() if not k.startswith(TRUNK)),
        trunk=max((r, k) for k, r in ratio.items() if k.startswith(TRUNK)),
        bn=max(float((sg[k] - sc[k]).abs().max() / sc[k].abs().max()) for k in sc),
        cpu_s=cpu_s, grads=(gc, gg))


def shared_mel(wav: torch.Tensor):
    """A context in which the encoder on either device reads the CPU's mel
    of ``wav``: the mel front-end is float32 FFTs (cuFFT on the card), and
    the trunk's train-mode gradient amplifies that input difference."""
    import contextlib

    from gesture_diffusion_torch.models import speech_encoder

    @contextlib.contextmanager
    def ctx():
        mel = speech_encoder.speech_frontend(wav)
        frontend = speech_encoder.speech_frontend
        speech_encoder.speech_frontend = lambda w: mel.to(w.device)
        try:
            yield
        finally:
            speech_encoder.speech_frontend = frontend

    return ctx()


def train_vs_cpu_checks(models: dict, weights: dict, sched, train_cfg,
                        batch: dict, t, noise, dev,
                        trunk_ratio: float = TRAIN_TRUNK_RATIO) -> dict:
    """Phase 6's [train-vs-cpu] comparison, float32 and float64 on one mel,
    with its bars (the card's float32 trunk error held to ``trunk_ratio``
    times the CPU's); returns the numbers and ``ok``."""
    with shared_mel(batch["wav"]):
        f32 = steps_card_vs_cpu(models, weights, sched, train_cfg, batch, t,
                                noise, dev, torch.float32)
        f64 = steps_card_vs_cpu(models, weights, sched, train_cfg, batch, t,
                                noise, dev, torch.float64)
    worst64 = max(f64["outside"], f64["trunk"])
    # the trunk's float32 gradients against the float64 result (the CPU's;
    # the card's float64 is within 1e-6 of it): the card's float32 error
    # against the CPU's own
    exact = f64["grads"][0]

    def trunk_err(grads):
        return max(float((grads[k].double() - exact[k]).abs().max()
                         / exact[k].abs().max()) for k in exact if k.startswith(TRUNK))

    cpu_err, card_err = (trunk_err(g) for g in f32["grads"])
    ok = not (f32["loss"] > TRAIN_LOSS_BAR or f32["bn"] > TRAIN_LOSS_BAR
              or f32["norm"] > TRAIN_NORM_BAR or f32["outside"][0] > TRAIN_GRAD_BAR
              or worst64[0] > TRAIN_GRAD_BAR or card_err > trunk_ratio * cpu_err)
    return dict(f32=f32, f64=f64, worst64=worst64, cpu_err=cpu_err,
                card_err=card_err, ok=ok)


def describe_train_vs_cpu(r: dict) -> str:
    f32, f64, worst64 = r["f32"], r["f64"], r["worst64"]
    return (f"float32: loss rel {f32['loss']:.2e}, grad_norm rel {f32['norm']:.2e}, "
            f"BN running statistics max|d|/max|ref| {f32['bn']:.2e}, worst gradient "
            f"max|d|/max|g| outside the SE-ResNet trunk {f32['outside'][0]:.2e} "
            f"({f32['outside'][1]}), in the trunk {f32['trunk'][0]:.2e} "
            f"({f32['trunk'][1]}); the trunk's float32 against float64: the card "
            f"{r['card_err']:.2e}, the CPU {r['cpu_err']:.2e}; float64: loss rel "
            f"{f64['loss']:.2e}, worst gradient {worst64[0]:.2e} ({worst64[1]}); "
            f"the CPU step took {f32['cpu_s']:.1f} s (f32), {f64['cpu_s']:.1f} s (f64)")


def train_paths(dev, smi):
    """Phase 6: training at full width.  Returns a summary dict; raises on
    any failed check."""
    import tempfile

    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.generation import Generator
    from gesture_diffusion_torch.models import build_all
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.training import (Trainer, iter_batches,
                                                  make_optimizer)
    from gesture_diffusion_torch.utils import JsonConfig, RngStream

    cfg = JsonConfig(os.path.join(REPO, "configs", "beat-ours.json"))
    enc_dtype = cfg.Train.get("encoder_dtype")
    train_ds = synthetic_training_set(TRAIN_BATCH * TRAIN_BATCHES, 70)
    val_ds = synthetic_training_set(TRAIN_BATCH, 71)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    summary = {}

    def bundle(encoder_dtype):
        return build_all(cfg, D_POSE, device=dev, encoder_dtype=encoder_dtype,
                         generator=torch.Generator().manual_seed(0))

    def trainer_of(b, log_dir):
        return Trainer(b.model, b.schedule, *make_optimizer(b.model, cfg.Train),
                       train_ds, val_ds, TRAIN_BATCH, log_dir, seed=0,
                       log_step_gap=1, device=dev)

    # -- [train]: Trainer.train over TRAIN_EPOCHS epochs with each step
    # synchronised and timed, then one epoch's batches queued through
    # Trainer.train_steps with one synchronise at the end: the training
    # throughput, windows/s; the synchronised step is a per-layer figure ----
    block = list(iter_batches(train_ds, TRAIN_BATCH, shuffle=False))
    trainers = {}
    runs = (("bf16 encoder", enc_dtype, False), ("f32", None, False),
            ("f32, cuDNN TF32 on (torch's default)", None, True))
    fs.launches = 0
    for i, (label, encoder_dtype, tf32) in enumerate(runs):
        torch.backends.cudnn.allow_tf32 = tf32
        b = bundle(encoder_dtype)
        trainer = trainer_of(b, os.path.join(tmp.name, f"run{i}"))
        step_ms, inner = [], trainer._train_step

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        trainer._train_step = timed
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer.train(TRAIN_EPOCHS)
        wall = time.perf_counter() - t0
        trainer._train_step = inner
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_steps(block)
        torch.cuda.synchronize()
        queued_ms = (time.perf_counter() - t0) * 1e3 / len(block)
        trainer.save()                  # [train-resume] resumes from here
        peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        records = trainer.logger.read_all()
        steps = [r for r in records if "train/loss" in r]
        vals = [r["val/loss"] for r in records if "val/loss" in r]
        med, mean = float(np.median(step_ms[1:])), float(np.mean(step_ms[1:]))
        log(f"[train] beat-ours {label}, batch {TRAIN_BATCH}: "
            f"{TRAIN_BATCH * 1e3 / queued_ms:.1f} windows/s ({queued_ms:.2f} ms "
            f"a step over {len(block)} steps queued, one synchronise); "
            f"synchronised step {med:.2f} ms median, {mean:.2f} mean after the "
            f"first of {len(step_ms)} in {TRAIN_EPOCHS} epochs (first {step_ms[0]:.1f} ms, "
            f"min {min(step_ms[1:]):.2f}, max {max(step_ms[1:]):.2f}; the epochs "
            f"{wall:.1f} s with validation and checkpoints), peak "
            f"{peak_mb:.0f} MB allocated; TF32 matmul "
            f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN {tf32} [{smi}]")
        log(f"[train]   loss by step: "
            + " ".join(f"{r['train/loss']:.4f}" for r in steps))
        log(f"[train]   grad_norm by step: "
            + " ".join(f"{r['train/grad_norm']:.3f}" for r in steps))
        log(f"[train]   lr at steps 0, 1, 2: "
            + " ".join(f"{r['train/lr']:.4e}" for r in steps[:3])
            + f"; val loss by epoch: " + " ".join(f"{v:.4f}" for v in vals))
        finite = all(np.isfinite([r["train/loss"], r["train/grad_norm"]]).all()
                     for r in steps) and all(np.isfinite(vals))
        if len(steps) != (TRAIN_EPOCHS + 1) * TRAIN_BATCHES or not finite:
            raise AssertionError(f"training ({label}) took {len(steps)} steps "
                                 "or gave a non-finite loss or norm")
        summary[label] = dict(windows_per_s=TRAIN_BATCH * 1e3 / queued_ms,
                              queued_ms=queued_ms, synced_ms=med,
                              peak_mb=peak_mb, first_ms=step_ms[0])
        trainers[label] = trainer
    torch.backends.cudnn.allow_tf32 = False
    log(f"[train] hand-written kernel launches in training: {fs.launches} "
        "(the training path is library ops: cuDNN, cuBLAS, AdamW)")
    if fs.launches:
        raise AssertionError("training launched the fused sampler")

    # -- [train-vs-cpu]: one step at batch 4, the card against the CPU -----
    cpu_b = build_all(cfg, D_POSE, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v[:4]) for k, v in train_ds.data.items()}
    g = torch.Generator().manual_seed(5)
    t = torch.randint(0, cpu_b.schedule.num_timesteps, (4,), generator=g)
    noise = torch.randn(batch["pose"].shape, generator=g)
    weights = {k: v.clone() for k, v in cpu_b.model.state_dict().items()}
    r = train_vs_cpu_checks({"cpu": lambda: cpu_b.model,
                             "card": lambda: bundle(None).model},
                            weights, cpu_b.schedule, cfg.Train, batch, t, noise, dev)
    log(f"[train-vs-cpu] one step, batch 4, full width, TF32 off, card against "
        f"CPU, one mel. {describe_train_vs_cpu(r)} [{smi}]")
    if not r["ok"]:
        raise AssertionError("the card's train step is off the CPU's")
    f32 = r["f32"]
    summary["vs_cpu"] = dict(loss=f32["loss"], grad_norm=f32["norm"],
                             outside=f32["outside"][0], trunk=f32["trunk"][0],
                             bn=f32["bn"], worst_f64=r["worst64"][0],
                             trunk_f32_card=r["card_err"], trunk_f32_cpu=r["cpu_err"])

    # -- [train-resume]: a fresh Trainer from the checkpoint takes the same
    # next step as the run that wrote it ----------------------------------
    first = trainers["bf16 encoder"]
    resumed = trainer_of(bundle(enc_dtype), first.log_dir)
    if (resumed.train_step_count, resumed.epochs_run) != (
            first.train_step_count, first.epochs_run):
        raise AssertionError("the resumed Trainer is not where the run stopped")
    nxt = next(iter_batches(train_ds, TRAIN_BATCH,
                            rng=RngStream(0).numpy("shuffle", first.epochs_run)))
    before = {k: v.clone() for k, v in first.model.state_dict().items()}
    torch.backends.cudnn.deterministic = True
    try:
        ma = first.train_steps([nxt])[0]
        mb = resumed.train_steps([nxt])[0]
    finally:
        torch.backends.cudnn.deterministic = False
    sa, sb = first.model.state_dict(), resumed.model.state_dict()
    moved = max(float((p.detach() - before[k]).abs().max())
                for k, p in first.model.named_parameters())
    param_d = max(float((sa[k].float() - sb[k].float()).abs().max()) for k in sa)
    same = float(ma["loss"]) == float(mb["loss"]) and \
        float(ma["grad_norm"]) == float(mb["grad_norm"])
    log(f"[train-resume] step {first.train_step_count - 1} after a resume from "
        f"epoch {first.epochs_run - 1}'s checkpoint (cuDNN deterministic): loss "
        f"{float(mb['loss']):.6f} vs {float(ma['loss']):.6f}, grad_norm "
        f"{float(mb['grad_norm']):.4f} vs {float(ma['grad_norm']):.4f}, equal: "
        f"{same}; max|param diff| {param_d:.3e} against the step's largest "
        f"update {moved:.3e}")
    if not same or param_d > 0.0:
        raise AssertionError("the resumed run's next step differs")
    summary["resume_equal"] = same

    # -- [train-to-serve]: trained weights through the fused kernel --------
    s50, t50 = make_diffusion("linear", 1000, "ddim50")
    serve = Generator(bundle(None).model, s50, t50, use_fused=True, device=dev)
    serve.update_variables(first.best_params)
    wav = torch.from_numpy(seeded_audio(80, 1, WINDOW / FPS)).to(dev)
    z = torch.randn((1, WINDOW, D_POSE), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(8))
    fs.launches = 0
    sample = serve.generate_sample(wav, D_POSE, WINDOW, noise=z)
    torch.cuda.synchronize()
    launched = fs.launches
    with torch.no_grad():
        plain = fs.fused_ddim_sample_plain(**serve.fused_args(wav, D_POSE, WINDOW, z))
    r = rel(sample, plain[..., :D_POSE])
    log(f"[train-to-serve] best_params -> Generator.update_variables -> "
        f"generate_sample, ddim50, batch 1: path {serve.last_sample_path}, "
        f"kernel launches +{launched}, kernel vs plain max|d|/max|ref| "
        f"{r:.3e} (bar {KERNEL_BAR:.0e}), output {tuple(sample.shape)} "
        f"finite {bool(torch.isfinite(sample).all())}")
    if (launched != 1 or serve.last_sample_path != "fused" or r > KERNEL_BAR
            or not torch.isfinite(sample).all()):
        raise AssertionError("the trained weights do not serve through the kernel")
    summary["serve_rel"] = r
    tmp.cleanup()
    return summary


CLI_PHASES = ("prep", "data", "train", "eval", "eval-time", "gen")
CLI_SECONDS, CLI_SPLITS = 20, {"n_train": 16, "n_val": 8, "n_test": 2}
CLI_STEPS = 20           # 5 steps an epoch at batch 64: 4 epochs
BPD_KEYS = ("total_bpd", "prior_bpd", "vb", "x_start_mse", "mse")


def cli_paths(smi, check) -> dict:
    """Phase 7: the port's phase CLI end to end at full width, in process,
    on the card (no --device): ``configs/beat-ours.json`` with
    ``Data.synthetic`` (41 joints, 20 s samples) and a hierarchy template
    pruned from ``tests/golden/synth_fullbody.bvh``.  Then the kernel at
    the CLI's shapes on the trained weights, through ``check`` (phase 3's
    comparison with the plain version).  Returns the fused kernel's
    launches in eval, eval-time and gen by row of the kernels line
    (``counted``); raises on any failed check."""
    import contextlib
    import io
    import pickle
    import tempfile

    from gesture_diffusion_torch import cli
    from gesture_diffusion_torch.generation import make_trans_ramp
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.utils import JsonConfig

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    root = tmp.name
    with open(os.path.join(REPO, "configs", "beat-ours.json")) as f:
        raw = json.load(f)
    data = raw["Data"]
    data.update({
        "synthetic": {**CLI_SPLITS, "seconds": CLI_SECONDS,
                      "n_joints": len(data["joints"])},
        "sample_duration": float(CLI_SECONDS),
        "spt_dir_path": os.path.join(root, "spt"),
        "dst_dir_path": os.path.join(root, "dst"),
        "hierarchy_path": os.path.join(root, "spt", "hierarchy_upper.txt")})
    raw["Train"].update({"max_training_steps": str(CLI_STEPS),
                         "early_stop_threshold_in_step": str(CLI_STEPS)})
    raw["Meta"] = {"project": "chip-smoke", "log_dir": os.path.join(root, "log"),
                   "name": "beat-ours"}
    # the template ensure_hierarchy_template derives from a corpus BVH
    hierarchy = cli.hierarchy_template(
        os.path.join(REPO, "tests", "golden", "synth_fullbody.bvh"),
        data["joints"], data["hierarchy_extra_joints"])
    os.makedirs(data["spt_dir_path"])
    with open(data["hierarchy_path"], "w") as f:
        f.write(hierarchy)
    cfg_path = os.path.join(root, "beat-ours.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    log(f"[cli] beat-ours, d_pose {3 * len(data['joints'])}, Data.synthetic "
        f"{CLI_SPLITS} x {CLI_SECONDS} s, {CLI_STEPS} train steps at batch "
        f"{raw['Train']['batch_size']}, hierarchy of "
        f"{hierarchy.count('ROOT ') + hierarchy.count('JOINT ')} joints")

    seconds, printed, launched, rows = {}, {}, {}, {}
    for phase in CLI_PHASES:
        out = io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["--phase", phase, "--config", cfg_path, "--seed", "0"])
        torch.cuda.synchronize()
        seconds[phase] = time.perf_counter() - t0
        launched[phase] = fs.launches
        counted("ddim", rows)
        printed[phase] = out.getvalue()
        for line in printed[phase].splitlines():
            if line.startswith("[Info] Epoch") or "path=" in line:
                log(f"[cli]   {line}")
        log(f"[cli] --phase {phase}: {seconds[phase]:.2f} s wall, fused kernel "
            f"launches +{launched[phase]} [{smi}]")

    def load(*parts):
        with open(os.path.join(root, *parts), "rb") as f:
            return pickle.load(f)

    # data: the windows, the test sequences and the scaler
    n_win = {s: CLI_SPLITS[f"n_{s}"] * CLI_SECONDS * FPS // WINDOW
             for s in ("val", "test")}
    n_win["train"] = CLI_SPLITS["n_train"] * CLI_SECONDS * FPS // (WINDOW // 2)
    shapes = {}
    for split in ("train", "val", "test"):
        d = load("dst", f"{split}_data.pkl")
        shapes[split] = (d["pose"].shape, d["wav"].shape)
        if shapes[split] != ((n_win[split], WINDOW, D_POSE),
                             (n_win[split], WINDOW * SR // FPS)):
            raise AssertionError(f"{split}_data.pkl has shapes {shapes[split]}")
    seqs = load("dst", "test_seqs.pkl")
    n_test = CLI_SPLITS["n_test"]
    with np.load(os.path.join(root, "dst", "scaler.npz")) as z:
        scaler_ok = z["mean"].shape == z["scale"].shape == (D_POSE,)
    if (seqs["pose"].shape != (n_test, CLI_SECONDS * FPS, D_POSE)
            or seqs["wav"].shape != (n_test, CLI_SECONDS * SR) or not scaler_ok):
        raise AssertionError("test_seqs.pkl or scaler.npz has the wrong shapes")
    log(f"[cli] data: {shapes}, test_seqs.pkl {seqs['pose'].shape} / "
        f"{seqs['wav'].shape}, scaler.npz ({D_POSE},)")

    # train: the checkpoint and the metrics JSONL
    log_dir = os.path.join(root, "log", "beat-ours")
    with open(os.path.join(log_dir, "chkpts", "chkpt_seed0.pt.meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(log_dir, f"metrics_{meta['run_id']}.jsonl")) as f:
        records = [json.loads(line) for line in f]
    val = [r["val/loss"] for r in records if "val/loss" in r]
    log(f"[cli] train: chkpt_seed0.pt at step {meta['train_step']}, "
        f"{meta['epochs_run']} epochs, val/loss {['%.4f' % v for v in val]}, "
        f"metrics_{meta['run_id']}.jsonl {len(records)} records")
    if (meta["train_step"] != CLI_STEPS or not os.path.exists(
            os.path.join(log_dir, "chkpts", "chkpt_seed0.pt"))
            or not np.isfinite(val).all() or not val):
        raise AssertionError("the train phase left no sound checkpoint")

    # eval: eval_results.json's keys, finite, and the test record in the JSONL
    with open(os.path.join(log_dir, "results", "eval_results.json")) as f:
        results = json.load(f)
    want = {f"test/{k}" for k in BPD_KEYS + ("beat_consistency", "beat_recall")}
    with open(os.path.join(log_dir, f"metrics_{meta['run_id']}.jsonl")) as f:
        last = json.loads(f.read().splitlines()[-1])
    generated = load("log", "beat-ours", "results", "generated.pkl")
    log(f"[cli] eval: {json.dumps(results)}; generated.pkl {generated['out'].shape}")
    if (set(results) != want or not np.isfinite(list(results.values())).all()
            or any(last.get(k) != v for k, v in results.items())
            or generated["out"].shape != (n_win["test"], WINDOW, D_POSE)
            or not np.isfinite(generated["out"]).all()):
        raise AssertionError("eval_results.json or generated.pkl is not right")

    # eval-time: the fused path; gen: euler degrees for every test sequence
    if "path=fused" not in printed["eval-time"]:
        raise AssertionError("eval-time did not time the fused kernel")
    samples = [load("log", "beat-ours", "results", "samples", f"sample_{i}.pkl")
               for i in range(n_test)]
    for s in samples:
        out = s["out"]
        if (out.shape != (CLI_SECONDS * FPS, D_POSE) or not np.isfinite(out).all()
                or np.abs(out).max() > 180.0 + 1e-3):
            raise AssertionError(f"sample out {out.shape} is not finite euler "
                                 "degrees of the sequence's length")
    log(f"[cli] gen: {n_test} x sample_i.pkl, out {samples[0]['out'].shape} euler "
        f"degrees, max |out| {max(np.abs(s['out']).max() for s in samples):.2f}")
    served = {p: launched[p] for p in ("eval", "eval-time", "gen")}
    log(f"[cli] fused kernel launches: {served}; prep/data/train "
        f"{launched['prep'] + launched['data'] + launched['train']}")
    if launched["eval"] < 1 or launched["gen"] < 1 or launched["eval-time"] < 1:
        raise AssertionError("eval, eval-time or gen did not launch the fused kernel")
    log(f"[cli] phases, wall s: "
        + ", ".join(f"{p} {seconds[p]:.2f}" for p in CLI_PHASES)
        + f"; all {sum(seconds.values()):.2f} [{smi}]")

    # the kernel at the CLI's shapes, on the trained weights (best_params,
    # the last BN statistics) and the 1000-step schedule: eval's batch of
    # every test window (identity blend), and gen's first window of each
    # test sequence (x0 blend on the sequence's seed poses)
    config = JsonConfig(cfg_path)
    config.set("Meta.seed", 0)
    with contextlib.redirect_stdout(io.StringIO()):
        _, test_ds, trained = cli.load_eval_objs(config)
    dev = trained.device
    draw = torch.Generator(device=dev).manual_seed(3)
    test = test_ds.get_samples()
    n_eval, n_gen = test["wav"].shape[0], seqs["pose"].shape[0]
    ip = torch.zeros(n_gen, WINDOW, D_POSE, device=dev)
    ip[:, :SEED_LEN] = torch.from_numpy(seqs["pose"][:, :SEED_LEN]).to(dev)
    im = torch.zeros(n_gen, WINDOW, 1, device=dev)
    im[:, :SEED_LEN] = 1.0
    ramp = torch.from_numpy(make_trans_ramp(TRANS_FACTOR, SEED_LEN, WINDOW)).to(dev)
    with torch.no_grad():
        eval_args = trained.fused_args(
            torch.from_numpy(test["wav"]).to(dev), D_POSE, WINDOW,
            torch.randn(n_eval, WINDOW, D_POSE, generator=draw, device=dev))
        gen_args = trained.fused_args(
            torch.from_numpy(seqs["wav"][:, :WINDOW * SR // FPS]).to(dev), D_POSE,
            WINDOW, torch.randn(n_gen, WINDOW, D_POSE, generator=draw, device=dev),
            ip, im, ramp)
    steps = trained.num_steps
    check("ddim", f"batch {n_eval:2d} identity (eval's batch, trained weights)",
          eval_args, steps=f"[cli] {steps} steps")
    check("ddim", f"batch {n_gen:2d} x0-blend (gen's first window, trained weights)",
          gen_args, steps=f"[cli] {steps} steps")
    tmp.cleanup()
    return rows


# -- phase 8: the corpus ends of a user's run ------------------------------------
# A synthetic BEAT tree at the corpus's sizes: 10 usable recordings of 70 s
# (one name carries a begin-time offset), the unsyncable one and one without
# a TextGrid; each BVH holds the 75-joint skeleton at 120 fps as %.4f text,
# about 17 MB, each wav int16 at 48 kHz (resampled to Data.wav_sr by prep)
CORPUS_SECONDS, CORPUS_WAV_SR = 70, 48000
CORPUS_USABLE = [f"1_wayne_0_{i}_{i}" for i in range(1, 10)] + ["1_wayne_0_9_16"]
CORPUS_UNSYNCABLE, CORPUS_NO_TEXTGRID = "1_wayne_1_1_2", "1_wayne_0_30_30"
CORPUS_SPLITS = {"train": 8, "val": 1, "test": 1}
# the one val sample holds 30 windows, and the Trainer drops a short batch
# (as the JAX trainer does): at the config's batch of 64 it would validate
# on nothing
CORPUS_BATCH, CORPUS_STEPS = 30, 32     # two epochs of 16 steps
CORPUS_WORDS = ("so", "the", "gesture", "we", "you", "really", "think", "about",
                "this", "going", "right", "hand", "here", "that", "know", "yeah")
CORPUS_VIDEO_FRAMES = 20


def textgrid_text(words, seconds: float) -> str:
    """A long-format Praat TextGrid, one word tier: ``words`` as (xmin,
    xmax, mark), the gaps between them as empty intervals."""
    ivs, t = [], 0.0
    for xmin, xmax, mark in words:
        if xmin > t:
            ivs.append((t, xmin, ""))
        ivs.append((xmin, xmax, mark))
        t = xmax
    if t < seconds:
        ivs.append((t, seconds, ""))
    body = "".join(
        f"        intervals [{i + 1}]:\n            xmin = {a}\n"
        f"            xmax = {b}\n            text = \"{m}\"\n"
        for i, (a, b, m) in enumerate(ivs))
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
            f"xmin = 0\nxmax = {seconds}\ntiers? <exists>\nsize = 1\nitem []:\n"
            '    item [1]:\n        class = "IntervalTier"\n        name = "words"\n'
            f"        xmin = 0\n        xmax = {seconds}\n"
            f"        intervals: size = {len(ivs)}\n" + body)


def corpus_header():
    """The HIERARCHY text of ``tests/golden/synth_fullbody.bvh`` (75
    joints) and its number of channels."""
    with open(os.path.join(REPO, "tests", "golden", "synth_fullbody.bvh")) as f:
        golden = f.read()
    header = golden[:golden.index("MOTION")]
    return header, sum(int(part.split()[0]) for part in header.split("CHANNELS")[1:])


def recording_bvh(rng, heading: bool = False) -> str:
    """The BVH text of one synthetic recording of CORPUS_SECONDS at 120 fps
    over the 75-joint skeleton: every channel a slow sinusoid plus noise.
    With ``heading`` the root turns as far as 155 degrees either way about
    the vertical, upright within 5 degrees, so that its XYZ euler angles
    pass the gimbal at a Yrotation of +-90."""
    header, n_channels = corpus_header()
    n_frames = CORPUS_SECONDS * 120
    t = np.arange(n_frames)[:, None] / 120.0
    motion = (rng.uniform(-30, 30, n_channels)
              + 15 * np.sin(2 * np.pi * rng.uniform(0.2, 1.5, n_channels) * t
                            + rng.uniform(0, 6, n_channels))
              + rng.normal(0, 1, (n_frames, n_channels)))
    if heading:                     # the root's channels: X Y Z position, X Y Z rotation
        s = t[:, 0]
        motion[:, 3] = 5 * np.sin(2 * np.pi * 0.3 * s)
        motion[:, 4] = np.rad2deg(2.7 * np.sin(2 * np.pi * 0.013 * s)
                                  + 0.2 * np.sin(2 * np.pi * 0.11 * s + 1))
        motion[:, 5] = 4 * np.sin(2 * np.pi * 0.23 * s + 2)
    row = " ".join(["%.4f"] * n_channels) + "\n"
    return (header + f"MOTION\nFrames: {n_frames}\nFrame Time: 0.008333\n"
            + "".join(row % tuple(r) for r in motion.tolist()))


def write_corpus(src: str) -> int:
    """The synthetic BEAT recordings of speaker 1 under ``src``; returns
    the bytes of BVH text written."""
    from scipy.io import wavfile

    os.makedirs(src)
    bvh_bytes = 0
    names = CORPUS_USABLE + [CORPUS_UNSYNCABLE, CORPUS_NO_TEXTGRID]
    for k, name in enumerate(names):
        rng = np.random.default_rng(100 + k)
        text = recording_bvh(rng)
        base = os.path.join(src, name)
        with open(base + ".bvh", "w") as f:
            f.write(text)
        bvh_bytes += len(text)
        n_wav = CORPUS_SECONDS * CORPUS_WAV_SR
        env = 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * np.arange(n_wav) / CORPUS_WAV_SR)
        wav = np.clip(0.3 * env * rng.normal(size=n_wav), -1, 1)
        wavfile.write(base + ".wav", CORPUS_WAV_SR, (wav * 32767).astype(np.int16))
        if name != CORPUS_NO_TEXTGRID:
            starts = np.arange(1.0, CORPUS_SECONDS - 1.0, 0.6)
            words = [(round(float(a), 3), round(float(a) + 0.45, 3),
                      CORPUS_WORDS[rng.integers(len(CORPUS_WORDS))]) for a in starts]
            with open(base + ".TextGrid", "w") as f:
                f.write(textgrid_text(words, float(CORPUS_SECONDS)))
    return bvh_bytes


def corpus_paths(smi, check) -> tuple:
    """Phase 8: a user's run from the corpus to BVH files and video, on the
    card, through the port: a synthetic BEAT tree at the corpus's sizes;
    the CLI's prep -> data -> train -> gen (no --device) on
    ``configs/beat-ours.json`` at full width (41 joints, 60 s samples);
    the native BVH parser against its numpy route; the kernel at gen's
    shapes on the trained weights through ``check``; then
    ``sample2bvh_batch`` with an exact round trip, forward kinematics and
    a raw AVI with the speech.  Returns gen's fused-kernel launches by row
    of the kernels line (``counted``) and the generated BVH of the test
    sequence, parsed back."""
    import contextlib
    import io
    import pickle
    import tempfile

    from gesture_diffusion_torch import cli, native
    from gesture_diffusion_torch.data import beat
    from gesture_diffusion_torch.data.bvh import parse_bvh
    from gesture_diffusion_torch.data.pipeline import load_from_bvh
    from gesture_diffusion_torch.data.skeleton import Skeleton
    from gesture_diffusion_torch.export import (read_avi_structure,
                                                sample2bvh_batch, write_avi)
    from gesture_diffusion_torch.export.vis_skeleton import pose_to_positions
    from gesture_diffusion_torch.generation import make_trans_ramp
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.training import steps_per_epoch
    from gesture_diffusion_torch.utils import JsonConfig

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_")
    root = tmp.name
    src = os.path.join(root, "BEAT", "1")
    t0 = time.perf_counter()
    bvh_bytes = write_corpus(src)
    log(f"[corpus] wrote {len(CORPUS_USABLE) + 2} recordings of {CORPUS_SECONDS} s "
        f"({bvh_bytes / 1e6:.1f} MB of BVH text, wavs int16 at {CORPUS_WAV_SR} Hz) "
        f"in {time.perf_counter() - t0:.2f} s")

    with open(os.path.join(REPO, "configs", "beat-ours.json")) as f:
        raw = json.load(f)
    data = raw["Data"]
    data.update({
        "src_dir_path": os.path.join(root, "BEAT"),
        "spt_dir_path": os.path.join(root, "spt"),
        "dst_dir_path": os.path.join(root, "dst"),
        "hierarchy_path": os.path.join(root, "spt", "hierarchy_upper.txt")})
    raw["Train"].update({"batch_size": CORPUS_BATCH,
                         "max_training_steps": str(CORPUS_STEPS),
                         "early_stop_threshold_in_step": str(CORPUS_STEPS)})
    raw["Meta"] = {"project": "chip-smoke", "log_dir": os.path.join(root, "log"),
                   "name": "corpus"}
    cfg_path = os.path.join(root, "beat-ours.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    sr, fps, seconds = data["wav_sr"], data["pose_fps"], data["sample_duration"]
    n_pose, n_wav = int(seconds * fps), int(seconds * sr)

    walls, printed, launched = {}, {}, {}
    for phase in ("prep", "data", "train", "gen"):
        out = io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["--phase", phase, "--config", cfg_path, "--seed", "0"])
        torch.cuda.synchronize()
        walls[phase] = time.perf_counter() - t0
        launched[phase] = fs.launches
        if phase == "gen":
            rows = counted("ddim")
        printed[phase] = out.getvalue()
        for line in printed[phase].splitlines():
            if line.startswith(("[Error]", "[Info] Skipped", "[Info] Epoch",
                                "[Info] Hierarchy")):
                log(f"[corpus]   {line}")
        log(f"[corpus] --phase {phase}: {walls[phase]:.2f} s wall, fused kernel "
            f"launches +{launched[phase]} [{smi}]")

    # prep: the three splits, the vocab, the template, the two skipped
    def load(*parts):
        with open(os.path.join(root, *parts), "rb") as f:
            return pickle.load(f)

    counts = {}
    for split in ("train", "val", "test"):
        d = load("spt", f"{split}_samples.pkl")
        n = counts[split] = len(d["hid"])
        want = {"hid": (n,), "pose": (n, n_pose, D_POSE), "wav": (n, n_wav),
                "word_id": (n, n_pose)}
        got = {k: tuple(v.shape) for k, v in d.items()}
        if (got != want or not np.isfinite(d["pose"]).all()
                or d["word_id"].max() <= 3):
            raise AssertionError(f"{split}_samples.pkl: {got}, want {want} with "
                                 "finite poses and indexed words")
    vocab = load("spt", "vocab.pkl")
    hierarchy = parse_bvh(data["hierarchy_path"])
    with open(os.path.join(root, "spt", "split_dataset.log")) as f:
        split_log = f.read()
    skipped = {
        CORPUS_UNSYNCABLE: f"[Info] Skipped (unsyncable): {os.path.join(src, CORPUS_UNSYNCABLE)}.bvh",
        CORPUS_NO_TEXTGRID: "[Error] TextGrid file not found for {0} {0}".format(
            os.path.join(src, CORPUS_NO_TEXTGRID) + ".bvh")}
    log(f"[corpus] prep: samples per split {counts} (want {CORPUS_SPLITS}), "
        f"{vocab.n_words} words in vocab.pkl, hierarchy_upper.txt of "
        f"{sum(not j.is_end_site for j in hierarchy.joints.values())} joints, "
        f"{split_log.count('[Info] Processed')} recordings processed")
    if (counts != CORPUS_SPLITS or vocab.n_words <= len(CORPUS_WORDS)
            or not set(data["joints"]) <= set(hierarchy.joints)
            or split_log.count("[Info] Processed") != len(CORPUS_USABLE)
            or not all(line in split_log.splitlines() for line in skipped.values())):
        raise AssertionError("prep wrote the wrong splits, vocab, template or log")

    # data and train at the corpus's sizes
    n_train = counts["train"] * -(-n_pose // data["pose_stride_len"])
    per_epoch = steps_per_epoch(n_train, CORPUS_BATCH)
    steps = per_epoch * max(1, round(CORPUS_STEPS / per_epoch))
    log_dir = os.path.join(root, "log", "corpus")
    with open(os.path.join(log_dir, "chkpts", "chkpt_seed0.pt.meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(log_dir, f"metrics_{meta['run_id']}.jsonl")) as f:
        val = [json.loads(line)["val/loss"] for line in f if "val/loss" in line]
    train_windows = load("dst", "train_data.pkl")["pose"].shape
    log(f"[corpus] data: train windows {train_windows}; train: {meta['train_step']} "
        f"steps at batch {CORPUS_BATCH}, val/loss {['%.4f' % v for v in val]}")
    if (train_windows != (n_train, WINDOW, D_POSE) or meta["train_step"] != steps
            or not val or not np.isfinite(val).all()):
        raise AssertionError("the data or train phase did not run at the corpus's sizes")

    # gen: the kernel served every window of the test sequence
    samples_dir = os.path.join(log_dir, "results", "samples")
    sample = load("log", "corpus", "results", "samples", "sample_0.pkl")
    if (sorted(os.listdir(samples_dir)) != ["sample_0.pkl"]
            or sample["out"].shape != (n_pose, D_POSE)
            or not np.isfinite(sample["out"]).all()
            or np.abs(sample["out"]).max() > 180.0 + 1e-3):
        raise AssertionError("gen wrote no sound sample for the test sequence")
    busy = {p: launched[p] for p in ("prep", "data", "train")}
    if launched["gen"] < 1 or any(busy.values()):
        raise AssertionError(f"fused launches: gen {launched['gen']}, others {busy}")
    log(f"[corpus] gen: sample_0.pkl out {sample['out'].shape}, fused kernel "
        f"launches {launched['gen']} (prep/data/train {busy})")
    log("[corpus] phases, wall s: " + ", ".join(
        f"{p} {w:.2f}" for p, w in walls.items())
        + f"; all {sum(walls.values()):.2f} [{smi}]")

    # the native parser against its numpy route on one corpus BVH, and
    # where prep's time goes on one recording
    first = os.path.join(src, CORPUS_USABLE[0])
    with open(first + ".bvh", "rb") as f:
        text = f.read()
    block = text[text.index(b"Frame Time:"):].split(b"\n", 1)[1]
    want = CORPUS_SECONDS * 120 * corpus_header()[1]
    rates, parsed = {}, {}
    for name, fn in (("native", native.parse_floats),
                     ("numpy", native.parse_floats_plain)):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            parsed[name] = fn(block, want)
            best = min(best, time.perf_counter() - t0)
        rates[name] = (len(block) / 1e6 / best, best)
    same = (parsed["native"].size == want
            and np.array_equal(parsed["native"], parsed["numpy"]))
    parts = {}
    for name, fn in (("load_from_bvh", lambda: load_from_bvh(first + ".bvh", data["joints"], fps)),
                     ("load_wav", lambda: beat.load_wav(first + ".wav", sr)),
                     ("split", lambda: beat.stratified_train_test_split(
                         np.arange(10), 0.2, np.ones(10), 0))):
        t0 = time.perf_counter()
        fn()
        parts[name] = time.perf_counter() - t0
    log(f"[corpus] BVH MOTION block parse ({len(block) / 1e6:.2f} MB, {want} floats): "
        f"native {rates['native'][0]:.1f} MB/s ({rates['native'][1] * 1e3:.1f} ms), "
        f"numpy {rates['numpy'][0]:.1f} MB/s ({rates['numpy'][1] * 1e3:.1f} ms); "
        f"equal: {same}. One recording in prep: load_from_bvh "
        f"{parts['load_from_bvh'] * 1e3:.1f} ms, load_wav (read, resample "
        f"{CORPUS_WAV_SR} -> {sr}) {parts['load_wav'] * 1e3:.1f} ms; the split "
        f"{parts['split'] * 1e3:.3f} ms [{smi}]")
    if not same:
        raise AssertionError("the native BVH parser disagrees with its numpy route")

    # the kernel at gen's shapes on the trained weights: the first window
    # of the test sequence, x0 blend on its seed poses
    config = JsonConfig(cfg_path)
    config.set("Meta.seed", 0)
    with contextlib.redirect_stdout(io.StringIO()):
        _, test_ds, trained = cli.load_eval_objs(config)
    dev = trained.device
    seqs = test_ds.get_seqs()
    n_gen = seqs["pose"].shape[0]
    ip = torch.zeros(n_gen, WINDOW, D_POSE, device=dev)
    ip[:, :SEED_LEN] = torch.from_numpy(np.asarray(seqs["pose"])[:, :SEED_LEN]).to(dev)
    im = torch.zeros(n_gen, WINDOW, 1, device=dev)
    im[:, :SEED_LEN] = 1.0
    ramp = torch.from_numpy(make_trans_ramp(TRANS_FACTOR, SEED_LEN, WINDOW)).to(dev)
    draw = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        gen_args = trained.fused_args(
            torch.from_numpy(np.asarray(seqs["wav"])[:, :WINDOW * SR // FPS]).to(dev),
            D_POSE, WINDOW, torch.randn(n_gen, WINDOW, D_POSE, generator=draw, device=dev),
            ip, im, ramp)
    check("ddim", f"batch {n_gen:2d} x0-blend (corpus gen's first window, trained "
          "weights)", gen_args, steps=f"[corpus] {trained.num_steps} steps")

    # export: BVH files that parse back to the sample's euler poses exactly,
    # forward kinematics, and a raw AVI with the speech
    t0 = time.perf_counter()
    written = sample2bvh_batch(samples_dir, os.path.join(root, "bvh"),
                               data["hierarchy_path"], wav_sr=sr,
                               joint_names=data["joints"])
    export_s = time.perf_counter() - t0
    exact = len(written) == 3
    for path in written:
        if not path.endswith(".bvh"):
            continue
        back = parse_bvh(path)
        if not path.endswith("-gt.bvh"):
            generated = back
        pose = sample["pose" if path.endswith("-gt.bvh") else "out"]
        for k, joint in enumerate(data["joints"]):
            for axis, c in enumerate("XYZ"):
                col = back.column_names.index(f"{joint}_{c}rotation")
                exact &= np.array_equal(back.values[:, col], pose[:, 3 * k + axis])
    skeleton = Skeleton.from_hierarchy_file(data["hierarchy_path"])
    positions = pose_to_positions(skeleton, sample["out"], data["joints"])
    # frames drawn in numpy (matplotlib is not needed): the joints of the
    # first second projected on x/y
    xy = positions[:CORPUS_VIDEO_FRAMES, :, :2]
    lim = np.abs(positions[..., :2]).max() + 1e-6
    frames = []
    for f in xy:
        img = np.zeros((96, 128, 3), np.uint8)
        px = np.clip(((f / lim) * [60, -44] + [64, 48]).astype(int), 0, [127, 95])
        img[px[:, 1], px[:, 0]] = 255
        frames.append(img)
    avi_path = write_avi(os.path.join(root, "sample_0.avi"), frames, fps=fps,
                         audio=sample["wav"][:CORPUS_VIDEO_FRAMES * sr // fps],
                         sample_rate=sr, codec="raw")
    info = read_avi_structure(avi_path)
    log(f"[corpus] export: {len(written)} files in {export_s:.2f} s, BVH round trip "
        f"exact: {exact}; pose_to_positions {positions.shape}; raw AVI "
        f"{info['video_frames']} frames, {info['audio_bytes']} audio bytes")
    if (not exact or positions.shape != (n_pose, skeleton.n_joints, 3)
            or not np.isfinite(positions).all() or info["video_frames"] != len(frames)
            or info["streams"] != 2
            or info["audio_bytes"] != 2 * CORPUS_VIDEO_FRAMES * sr // fps
            or len({fr.tobytes() for fr in frames}) < 2):
        raise AssertionError("export: BVH round trip, kinematics or AVI not right")
    tmp.cleanup()
    return rows, generated


# -- phase 9: TED-Expressive ---------------------------------------------------
TED_BATCH, TED_TRAIN_BATCHES = 32, 4
# the card against the CPU, TF32 off: one denoise call on one speech memory
# (the products sum in other orders through 10 layers) and a 50-step DDIM
# sample (the error grows with the steps), relative to max |ref|
TED_DENOISE_BAR, TED_SAMPLE_BAR = 1e-4, 1e-3
# the train step against the CPU keeps phase 6's bars but one: on tedexp's
# shapes the card's float32 trunk gradient is 2.1-3.0 times as far from
# float64 as the CPU's, under cuDNN's default, deterministic and native
# convolutions alike (tools/trunk_precision.py; beat's reads 1.0), while
# the float64 step agrees to 6e-6 in every gradient; so the trunk's
# float32 error is held to 4 times the CPU's here
TED_TRUNK_RATIO = 4.0
TED_CLI_SECONDS = 20
# generate_sample on the schedule respaced to TED_SAMPLE_RESPACING: the
# scan sampler's steps are host-bound and alike (24-50 ms each), so 250 of
# them time a step as well as 1000 did, in a quarter of the script's time
TED_SAMPLE_RESPACING = "ddim250"
# generate_sequence: 2 x 10 s (five windows, four seams) on the schedule
# respaced to TED_SEQ_RESPACING; at 1000 host-bound scan steps a window
# takes 38-48 s, which generate_sample's ms a step already gives
TED_SEQ_SECONDS, TED_SEQ_RESPACING = 10.0, "ddim50"
TED_CLI_SPLITS = {"n_train": 8, "n_val": 4, "n_test": 4}
TED_CLI_STEPS = 6        # one epoch: 8 x 27 windows at batch 32
# eval-time alone makes 20 calls of the whole reverse process: the CLI run
# respaces its schedule (the serving timings above run all 1000 steps)
TED_CLI_RESPACING = "ddim50"
TED_FGD_STEPS = 500
FGD_KEYS = ("fgd", "feat_dist", "diversity")


def tedexp_paths(smi, dev) -> dict:
    """Phase 9: ``configs/tedexp-ours.json`` at full width (the 10-layer
    cross-attention decoder, d_model 512, 8 heads, d_pose 126 (42 joints in
    euler), 34-frame windows at 15 fps, 1000 steps) with random seeded
    weights, through the port's entry points: serving (``generate_sample``
    at batches 1 and 32, ``generate_sequence`` over 2 x 10 s at ddim50,
    all on the
    scan sampler), the card against the CPU (one ``denoise`` call, a
    50-step DDIM sample, one train step), queued training at the config's
    batch of 32, and the phase CLI on ``Data.synthetic``.  Returns a
    summary; raises on any failed check, including any launch of the
    fused kernel, which has no variant for this decoder."""
    import contextlib
    import io
    import pickle
    import tempfile

    from gesture_diffusion_torch import cli
    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.generation import Generator, window_plan
    from gesture_diffusion_torch.models import build_all
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.training import (Trainer, iter_batches,
                                                  make_optimizer)
    from gesture_diffusion_torch.utils import JsonConfig

    cfg_path = os.path.join(REPO, "configs", "tedexp-ours.json")
    cfg = JsonConfig(cfg_path)
    data, gen_cfg = cfg.Data, cfg.Model.Generate
    window, fps, seed_len = data.pose_window_len, data.pose_fps, gen_cfg.pose_seed_len
    d_pose = 126                      # 42 joints in euler, as the config says
    summary = {}
    fs.launches = 0

    def bundle(device):
        return build_all(cfg, d_pose, device=device,
                         generator=torch.Generator().manual_seed(0))

    b, cpu_b = bundle(dev), bundle("cpu")
    dec = cfg.Model.Decoder
    log(f"[tedexp] model: {cfg.Model.type} type, {dec.type} decoder, "
        f"{dec.n_layers} layers, d_model {cfg.Model.d_model}, {dec.heads} heads, "
        f"d_pose {d_pose}, window {window} at {fps} fps, "
        f"{b.eval_schedule.num_timesteps} steps, "
        f"{sum(p.numel() for p in b.model.parameters())} parameters")

    # -- the card against the CPU, TF32 off ---------------------------------
    wav1 = seeded_audio(90, 1, window / fps)
    g = torch.Generator().manual_seed(91)
    x = torch.randn(1, window, d_pose, generator=g)
    with torch.no_grad():
        memory = cpu_b.model.encode_memory(torch.from_numpy(wav1))
        t = torch.tensor([517])
        ref = cpu_b.model.denoise(x, t, memory)
        out = b.model.denoise(x.to(dev), t.to(dev), memory.to(dev)).cpu()
    r_denoise = rel(out, ref)
    s50, t50 = make_diffusion("linear", 1000, "ddim50")
    samples = {}
    for name, model, d in (("cpu", cpu_b.model, "cpu"), ("card", b.model, dev)):
        g50 = Generator(model, s50, t50, device=d)
        t0 = time.perf_counter()
        samples[name] = g50.generate_sample(wav1, d_pose, window, noise=x).cpu()
        samples[name + "_s"] = time.perf_counter() - t0
        if g50.last_sample_path != "scan":
            raise AssertionError("the tedexp model did not take the scan sampler")
    r_sample = rel(samples["card"], samples["cpu"])
    log(f"[tedexp] card against CPU, TF32 off: denoise (t 517, batch 1, one "
        f"speech memory) max|d|/max|ref| {r_denoise:.3e} (bar "
        f"{TED_DENOISE_BAR:.0e}, max|ref| {float(ref.abs().max()):.3e}); "
        f"ddim50 generate_sample {r_sample:.3e} (bar {TED_SAMPLE_BAR:.0e}); "
        f"the card's call {samples['card_s'] * 1e3:.1f} ms, the CPU's "
        f"{samples['cpu_s'] * 1e3:.1f} ms [{smi}]")
    if (r_denoise > TED_DENOISE_BAR or r_sample > TED_SAMPLE_BAR
            or not torch.isfinite(samples["card"]).all()):
        raise AssertionError("the tedexp model on the card is off the CPU's")
    summary.update(denoise_rel=r_denoise, ddim50_rel=r_sample)

    # -- serving: the scan sampler, TED_SAMPLE_RESPACING's steps ---------------
    gen = Generator(b.model, *make_diffusion("linear", 1000, TED_SAMPLE_RESPACING),
                    device=dev)
    draw = torch.Generator(device=dev).manual_seed(92)
    for n in (1, TED_BATCH):
        wav = seeded_audio(93 + n, n, window / fps)
        mean_ms, _, out = host_ms(lambda: gen.generate_sample(
            wav, d_pose, window, generator=draw), reps=1, warmup=0)
        log(f"[tedexp] generate_sample ddim, batch {n:2d}, "
            f"{gen.num_steps} steps ({TED_SAMPLE_RESPACING}): {mean_ms:.1f} ms "
            f"({mean_ms / gen.num_steps:.3f} ms a step, "
            f"{n * 1e3 * gen.num_steps / mean_ms:.1f} windows' steps/s), "
            f"last_sample_path={gen.last_sample_path} [{smi}]")
        if (gen.last_sample_path != "scan" or tuple(out.shape) != (n, window, d_pose)
                or not torch.isfinite(out).all()):
            raise AssertionError(f"tedexp generate_sample at batch {n} failed")
        summary[f"sample_ms_{n}"] = mean_ms
    wav_long = seeded_audio(96, 2, TED_SEQ_SECONDS)
    seq_len, num_div = window_plan(wav_long.shape[1], SR, fps, window, seed_len)
    seq_gen = Generator(b.model, *make_diffusion("linear", 1000, TED_SEQ_RESPACING),
                        device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = seq_gen.generate_sequence(wav_long, SR, d_pose, fps, window, seed_len,
                                    generator=draw,
                                    smooth_trans=bool(gen_cfg.smooth_transition),
                                    trans_factor=gen_cfg.trans_factor)
    seq_ms = (time.perf_counter() - t0) * 1e3
    log(f"[tedexp] generate_sequence 2 clips x {TED_SEQ_SECONDS:g} s, seed "
        f"{seed_len}, smooth "
        f"transition, trans_factor {gen_cfg.trans_factor}: {seq_ms:.1f} ms for "
        f"{num_div} windows of {seq_gen.num_steps} steps ({TED_SEQ_RESPACING}: "
        f"respaced, not comparable with a time of 1000-step windows), "
        f"output {seq.shape}, last_sample_path={seq_gen.last_sample_path} "
        f"[{smi}]")
    if (seq.shape != (2, seq_len, d_pose) or not np.isfinite(seq).all()
            or seq_gen.last_sample_path != "scan"):
        raise AssertionError("tedexp generate_sequence failed")
    summary["sequence_ms"] = seq_ms

    # -- training: the config's batch of 32, queued ---------------------------
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tedexp_")
    train_ds = synthetic_training_set(TED_BATCH * TED_TRAIN_BATCHES, 97,
                                      window, fps, d_pose)
    val_ds = synthetic_training_set(TED_BATCH, 98, window, fps, d_pose)
    tb = bundle(dev)
    trainer = Trainer(tb.model, tb.schedule, *make_optimizer(tb.model, cfg.Train),
                      train_ds, val_ds, TED_BATCH, os.path.join(tmp.name, "train"),
                      seed=0, log_step_gap=1, device=dev)
    block = list(iter_batches(train_ds, TED_BATCH, shuffle=False))
    trainer.train_steps(block[:1])                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    metrics = trainer.train_steps(block)
    torch.cuda.synchronize()
    queued_ms = (time.perf_counter() - t0) * 1e3 / len(block)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    losses = [float(m["loss"]) for m in metrics]
    log(f"[tedexp] train, batch {TED_BATCH}: {TED_BATCH * 1e3 / queued_ms:.1f} "
        f"windows/s ({queued_ms:.2f} ms a step over {len(block)} steps queued, "
        f"one synchronise), peak {peak_mb:.0f} MB allocated; loss by step "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; grad_norm {float(metrics[-1]['grad_norm']):.3f} [{smi}]")
    if not np.isfinite(losses).all():
        raise AssertionError("tedexp training gave a non-finite loss")
    summary.update(windows_per_s=TED_BATCH * 1e3 / queued_ms, peak_mb=peak_mb)
    del trainer, tb

    batch = {k: torch.from_numpy(v[:4]) for k, v in train_ds.data.items()}
    g = torch.Generator().manual_seed(99)
    t = torch.randint(0, cpu_b.schedule.num_timesteps, (4,), generator=g)
    noise = torch.randn(batch["pose"].shape, generator=g)
    weights = {k: v.clone() for k, v in cpu_b.model.state_dict().items()}
    r = train_vs_cpu_checks({"cpu": lambda: cpu_b.model,
                             "card": lambda: bundle(dev).model},
                            weights, cpu_b.schedule, cfg.Train, batch, t, noise, dev,
                            trunk_ratio=TED_TRUNK_RATIO)
    log(f"[tedexp] train step against the CPU, batch 4, full width, TF32 off, "
        f"one mel. {describe_train_vs_cpu(r)}; the card's float32 trunk error "
        f"is {r['card_err'] / r['cpu_err']:.2f} times the CPU's (bar "
        f"{TED_TRUNK_RATIO}) [{smi}]")
    if not r["ok"]:
        raise AssertionError("the tedexp train step on the card is off the CPU's")
    summary["train_vs_cpu_outside"] = r["f32"]["outside"][0]

    # -- the phase CLI on Data.synthetic --------------------------------------
    root = tmp.name
    with open(cfg_path) as f:
        raw = json.load(f)
    raw["Data"].update({
        "synthetic": {**TED_CLI_SPLITS, "seconds": TED_CLI_SECONDS,
                      "n_joints": d_pose // 3},
        "sample_duration": float(TED_CLI_SECONDS),
        "spt_dir_path": os.path.join(root, "spt"),
        "dst_dir_path": os.path.join(root, "dst")})
    raw["Model"]["Diffusion"]["timestep_respacing"] = TED_CLI_RESPACING
    raw["Train"].update({"max_training_steps": str(TED_CLI_STEPS),
                         "early_stop_threshold_in_step": str(TED_CLI_STEPS)})
    raw["Eval"]["fgd"].update({
        "eval_net_path": os.path.join(root, "fgd", "fgd_ae.msgpack"),
        "train_steps": TED_FGD_STEPS})
    raw["Meta"] = {"project": "chip-smoke", "log_dir": os.path.join(root, "log"),
                   "name": "tedexp-ours"}
    cli_cfg = os.path.join(root, "tedexp-ours.json")
    with open(cli_cfg, "w") as f:
        json.dump(raw, f)
    log(f"[tedexp-cli] tedexp-ours, d_pose {d_pose}, Data.synthetic "
        f"{TED_CLI_SPLITS} x {TED_CLI_SECONDS} s, no hierarchy_path, "
        f"{TED_CLI_STEPS} train steps at batch {raw['Train']['batch_size']}, "
        f"schedule respaced to {TED_CLI_RESPACING}, FGD net {TED_FGD_STEPS} steps")
    seconds, printed = {}, {}
    launched_before = fs.launches
    for phase in CLI_PHASES:
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["--phase", phase, "--config", cli_cfg, "--seed", "0"])
        torch.cuda.synchronize()
        seconds[phase] = time.perf_counter() - t0
        printed[phase] = out.getvalue()
        for line in printed[phase].splitlines():
            if line.startswith("[Info] Epoch") or "path=" in line:
                log(f"[tedexp-cli]   {line}")
        log(f"[tedexp-cli] --phase {phase}: {seconds[phase]:.2f} s wall [{smi}]")

    def load(*parts):
        with open(os.path.join(root, *parts), "rb") as f:
            return pickle.load(f)

    shapes = {s: load("dst", f"{s}_data.pkl")["pose"].shape
              for s in ("train", "val", "test")}
    if any(v[1:] != (window, d_pose) or not v[0] for v in shapes.values()):
        raise AssertionError(f"the data phase's windows are {shapes}")
    log_dir = os.path.join(root, "log", "tedexp-ours")
    with open(os.path.join(log_dir, "chkpts", "chkpt_seed0.pt.meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(log_dir, "results", "eval_results.json")) as f:
        results = json.load(f)
    want = {f"test/{k}" for k in BPD_KEYS + FGD_KEYS}
    generated = load("log", "tedexp-ours", "results", "generated.pkl")
    n_test = TED_CLI_SPLITS["n_test"]
    outs = [load("log", "tedexp-ours", "results", "samples", f"sample_{i}.pkl")["out"]
            for i in range(n_test)]
    log(f"[tedexp-cli] data {shapes}; train: step {meta['train_step']}, "
        f"{meta['epochs_run']} epochs; eval: {json.dumps(results)}; "
        f"generated.pkl {generated['out'].shape}; gen: {n_test} x sample_i.pkl "
        f"{outs[0].shape}")
    launched = fs.launches - launched_before
    log(f"[tedexp-cli] phases, wall s: "
        + ", ".join(f"{p} {seconds[p]:.2f}" for p in CLI_PHASES)
        + f"; all {sum(seconds.values()):.2f}; fused kernel launches +{launched} [{smi}]")
    problems = [what for what, bad in (
        ("eval_results.json keys", set(results) != want),
        ("a non-finite metric", not np.isfinite(list(results.values())).all()),
        ("FGD's failed-sqrtm value", results.get("test/fgd", 0.0) >= 1e10),
        ("no FGD net saved", not os.path.exists(os.path.join(root, "fgd", "fgd_ae.pt"))),
        ("generated.pkl's shape",
         generated["out"].shape != (shapes["test"][0], window, d_pose)),
        ("eval-time not on the scan", "path=scan" not in printed["eval-time"]),
        ("gen's samples", any(o.shape != (TED_CLI_SECONDS * fps, d_pose)
                              or not np.isfinite(o).all() for o in outs)),
        ("no train step", not meta["train_step"])) if bad]
    if problems:
        raise AssertionError(f"the tedexp CLI run is not right: {problems}")
    summary["cli_s"] = seconds
    tmp.cleanup()
    log(f"[tedexp] fused kernel launches in the phase: {fs.launches}")
    if fs.launches:
        raise AssertionError("the tedexp path launched the fused kernel")
    return summary


# -- phase 10: the GCN and UNet decoders at smoke widths ----------------------
# no shipped configuration uses either: beat-ours (s2g_v2, 1000 steps) with
# its decoder replaced
DECODER_SMOKE = {
    "cross_attention_gcn": (dict(type="cross_attention_gcn", heads=4, n_layers=4,
                                 graph_layout="beat", graph_strategy="spatial"),
                            300, 225),
    "unet_attention": (dict(type="unet_attention", num_heads=8, num_res_blocks=2,
                            channel_mult=[1, 2, 4], attention_resolutions=[1, 2, 4],
                            window_len=WINDOW), 256, D_POSE),
}
DECODER_BAR = 1e-4       # the card against the CPU, TF32 off, of max |ref|


# -- phase 9b: the float32 MMDiT's split-TF32 products -----------------------
# configs/tedexp-ours.json with the tedexp-mmdit cell's decoder (SD3-Medium's
# widths: d_model 1536, 24 heads) cut to MMDIT_BLOCKS blocks, the last one
# context_pre_only, so every Linear shape of the cell runs: at its batch of
# 16, 34 frames (544 rows), 103 speech-memory rows (1648), the modulation's 16
MMDIT_BLOCKS, MMDIT_BATCH, MMDIT_RESPACING = 3, 16, "ddim5"
MMDIT_SHAPES = {(1648, 1536, 1536), (1648, 1536, 4608), (1648, 1536, 6144),
                (1648, 6144, 1536), (544, 1536, 1536), (544, 1536, 4608),
                (544, 1536, 6144), (544, 6144, 1536), (16, 1536, 9216),
                (16, 1536, 3072)}
# every launch against f32x3_linear_plain on its inputs: F32X3_BAR plus the
# plain version's own distance from float64 (its float32 sums run on cuBLAS);
# against float64: F32X3_BAR (float32's own accuracy at these shapes)
F32X3_BAR = 1.5e-6
F32X3_SOURCE = "gesture_diffusion_torch/csrc/f32x3_gemm.cu"


def gemm_bound_ms(m: int, k: int, n: int) -> tuple:
    """(ms, "operations" | "bytes"): the least time of the split-TF32
    product y = x w^T + b, x (m, k), w (n, k): its three TF32 products'
    operations at the TF32 peak, or the bytes the product needs (x, the
    float32 weight, the bias and y once each) at HBM's rate."""
    ops = 3 * 2.0 * m * n * k / H100_TF32_FLOPS * 1e3
    nbytes = 4.0 * (m * k + n * k + n + m * n) / H100_HBM_BPS * 1e3
    return (ops, "operations") if ops >= nbytes else (nbytes, "bytes")


def rel64(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max |y - ref| / max |ref| in float64, for a float64 ``ref``."""
    return float((y.double() - ref).abs().max() / ref.abs().max())


def mmdit_paths(smi, dev) -> dict:
    """Phase 9b: the float32 MMDiT (``models/mmdit.py``) at the
    tedexp-mmdit cell's widths and shapes (MMDIT_BLOCKS blocks, seeded
    full-mantissa weights) on the scan sampler, whose block Linears,
    ``context_embedder`` and ``norm_out.linear`` run the split-TF32 GEMM.
    ``generate_sample`` at batch MMDIT_BATCH over MMDIT_RESPACING, with
    ``f32_linear.launches`` set to 0 just before it and read after it: every
    such Linear once a step, a stream's q, k and v as one launch.  Then one
    ``denoise`` call with every launch caught: each, grouped or not, against
    ``f32x3_linear_plain`` and float64 on its inputs (F32X3_BAR), launched
    again alone (bit-equal) and timed (CUDA events) beside its bound
    (``gemm_bound_ms``) and ``F.linear`` in float32 (cuBLAS, TF32 off).
    Returns the kernels line's row: its ms, bound and library ms are sums
    over that step's launches; ``max_rel_err`` is the largest distance from
    the plain version and ``bar`` the bar that launch was held to."""
    import torch.nn.functional as F

    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.generation import Generator
    from gesture_diffusion_torch.models import build_all
    from gesture_diffusion_torch.ops import f32_linear as fl
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.utils import JsonConfig

    cfg = JsonConfig(os.path.join(REPO, "configs", "tedexp-ours.json"))
    cfg.set("Model.d_model", 1536)
    cfg.set("Model.Decoder.type", "mmdit")
    cfg.set("Model.Decoder.heads", 24)
    cfg.set("Model.Decoder.n_layers", MMDIT_BLOCKS)
    window, fps, d_pose = cfg.Data.pose_window_len, cfg.Data.pose_fps, 126
    t0 = time.perf_counter()
    b = build_all(cfg, d_pose, device=dev,
                  generator=torch.Generator().manual_seed(0))
    model = b.model
    ops = [m for m in model.modules() if isinstance(m, fl.F32x3Linear)]
    log(f"[mmdit] float32 MMDiT at the cell's widths, {MMDIT_BLOCKS} blocks: "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"{len(ops)} split-TF32 Linears; built in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- the scan sampler, launches counted from 0 ------------------------------
    gen = Generator(model, *make_diffusion("linear", 1000, MMDIT_RESPACING),
                    device=dev)
    wav = seeded_audio(97, MMDIT_BATCH, window / fps)
    draw = torch.Generator(device=dev).manual_seed(98)
    gen.generate_sample(wav, d_pose, window, generator=draw)    # packs, code
    torch.cuda.synchronize()
    fs.launches = fl.launches = 0
    mean_ms, _, out = host_ms(lambda: gen.generate_sample(
        wav, d_pose, window, generator=draw), reps=1, warmup=0)
    launched, want = fl.launches, (len(ops) - 4 * MMDIT_BLOCKS) * gen.num_steps
    log(f"[mmdit] generate_sample batch {MMDIT_BATCH}, {gen.num_steps} steps "
        f"({MMDIT_RESPACING}): {mean_ms:.1f} ms, last_sample_path="
        f"{gen.last_sample_path}, split-TF32 launches +{launched} (want "
        f"{want}: {len(ops)} Linears less 4 a block, q/k/v grouped, x "
        f"{gen.num_steps} steps), fused-kernel launches +{fs.launches} [{smi}]")
    if (gen.last_sample_path != "scan" or launched != want or fs.launches
            or tuple(out.shape) != (MMDIT_BATCH, window, d_pose)
            or not torch.isfinite(out).all()):
        raise AssertionError("the float32 MMDiT did not run its products "
                             "through the split-TF32 GEMM as expected")

    # -- one denoise call, every launch caught ----------------------------------
    g = torch.Generator(device=dev).manual_seed(99)
    x_t = torch.randn(MMDIT_BATCH, window, d_pose, device=dev, generator=g)
    t = torch.randint(0, 1000, (MMDIT_BATCH,), device=dev, generator=g)
    caught, on_card = [], fl._on_card

    def catch(x, packs, linears):
        y = on_card(x, packs, linears)
        caught.append((x.reshape(-1, x.shape[-1]).clone(), linears,
                       y.reshape(-1, y.shape[-1]).clone()))
        return y

    fl._on_card = catch
    try:
        with torch.no_grad():
            memory = model.encode_memory(torch.from_numpy(wav).to(dev))
            model.denoise(x_t, t, memory)
    finally:
        fl._on_card = on_card
    rows, worst = {}, dict(plain=0.0, bar=F32X3_BAR, abs=0.0, f64=0.0)
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    with torch.no_grad():
        for x, linears, y in caught:
            w = torch.cat([lin.weight for lin in linears])
            bias = torch.cat([lin.bias for lin in linears])
            (m, k), n = x.shape, w.shape[0]
            pack = fl.pack_weight(w)
            plain = fl.f32x3_linear_plain(x, w, bias)
            ref = x.double() @ w.double().T + bias.double()
            own, e64 = rel64(plain, ref), rel64(y, ref)
            e_plain = rel(y, plain)
            again = fl.f32x3_gemm(x, pack, bias)
            ms = cuda_ms(lambda: fl.f32x3_gemm(x, pack, bias), reps=10)
            plain_ms = cuda_ms(lambda: fl.f32x3_linear_plain(x, w, bias), reps=3)
            library_ms = cuda_ms(lambda: F.linear(x, w, bias), reps=10)
            bound, by = gemm_bound_ms(m, k, n)
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", bound), ("library_ms", library_ms)):
                totals[key] += v
            r = rows.setdefault((m, k, n, len(linears)), dict(
                count=0, ms=0.0, library_ms=0.0, bound=bound, by=by,
                plain=0.0, f64=0.0, own=0.0))
            r["count"] += 1
            r["ms"] += ms
            r["library_ms"] += library_ms
            r["plain"], r["f64"], r["own"] = (max(r["plain"], e_plain),
                                              max(r["f64"], e64), max(r["own"], own))
            if e_plain >= worst["plain"]:
                worst.update(plain=e_plain, bar=F32X3_BAR + own)
            worst.update(f64=max(worst["f64"], e64),
                         abs=max(worst["abs"], float((y - plain).abs().max())))
            if (e_plain > F32X3_BAR + own or e64 > F32X3_BAR
                    or not torch.equal(again, y)):
                raise AssertionError(
                    f"split-TF32 GEMM ({m}, {k}, {n}) x{len(linears)}: against "
                    f"the plain version {e_plain:.3e} (bar {F32X3_BAR:.1e} + "
                    f"{own:.3e}), against float64 {e64:.3e} (bar "
                    f"{F32X3_BAR:.1e}), launched again bit-equal: "
                    f"{torch.equal(again, y)}")
    for (m, k, n, grouped), r in sorted(rows.items(), reverse=True):
        log(f"[mmdit-gemm] ({m}, {k}, {n}) "
            f"{'grouped q/k/v' if grouped > 1 else 'one Linear'} x{r['count']}: "
            f"kernel {r['ms'] / r['count']:.4f} ms, bound {r['bound']:.4f} ms "
            f"({r['by']}), F.linear float32 {r['library_ms'] / r['count']:.4f} "
            f"ms; against plain {r['plain']:.3e} (bar {F32X3_BAR:.1e} + the "
            f"plain version's own {r['own']:.3e}), against float64 "
            f"{r['f64']:.3e} [{smi}]")
    seen = {(m, k, n) for m, k, n, _ in rows}
    log(f"[mmdit-gemm] one denoise step, {len(caught)} launches: kernel "
        f"{totals['ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms, F.linear "
        f"float32 {totals['library_ms']:.3f} ms, plain {totals['plain_ms']:.3f} "
        f"ms; worst against plain {worst['plain']:.3e}, against float64 "
        f"{worst['f64']:.3e} [{smi}]")
    if len(caught) != want // gen.num_steps or not MMDIT_SHAPES <= seen:
        raise AssertionError(f"the denoise call launched {len(caught)} products "
                             f"at {sorted(seen)}, not the cell's shapes "
                             f"{sorted(MMDIT_SHAPES)}")
    return {
        "name": "f32x3_gemm",
        "route": "cuda",
        "source": F32X3_SOURCE,
        "replaces": None,
        "launches": launched,
        "max_abs_err": worst["abs"],
        "max_rel_err": worst["plain"],
        "bar": worst["bar"],
        "max_rel_err_float64": worst["f64"],
        "bar_float64": F32X3_BAR,
        **totals,
        "bound_by": "operations or bytes, by launch",
        "shape": f"the tedexp-mmdit cell's widths, {MMDIT_BLOCKS} blocks, batch "
                 f"{MMDIT_BATCH}: one denoise step's {len(caught)} launches "
                 f"(the ms are their sums)",
    }


def decoder_paths(smi, dev) -> dict:
    """Phase 10: for each decoder, one forward, one train step and one
    50-step ``generate_sample`` on the card against the CPU (TF32 off, one
    mel), at smoke widths; all finite and within DECODER_BAR.  Returns the
    numbers; raises on any failed check."""
    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.generation import Generator
    from gesture_diffusion_torch.models import build_all
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.utils import JsonConfig

    with open(os.path.join(REPO, "configs", "beat-ours.json")) as f:
        base = json.load(f)
    s50, t50 = make_diffusion("linear", 1000, "ddim50")
    summary = {}
    fs.launches = 0
    for name, (decoder, d_model, d_pose) in DECODER_SMOKE.items():
        raw = json.loads(json.dumps(base))
        raw["Model"]["Decoder"] = decoder
        raw["Model"]["d_model"] = d_model
        cfg = JsonConfig(raw)

        def bundle(device):
            return build_all(cfg, d_pose, device=device,
                             generator=torch.Generator().manual_seed(0))

        b, cpu_b = bundle(dev), bundle("cpu")
        data = synthetic_training_set(4, 100, WINDOW, FPS, d_pose).data
        batch = {k: torch.from_numpy(v) for k, v in data.items()}
        g = torch.Generator().manual_seed(101)
        t = torch.randint(0, cpu_b.schedule.num_timesteps, (4,), generator=g)
        x = torch.randn(batch["pose"].shape, generator=g)
        weights = {k: v.clone() for k, v in cpu_b.model.state_dict().items()}
        with shared_mel(batch["wav"]), torch.no_grad():
            ref = cpu_b.model(x, t, batch["wav"])
            out = b.model(x.to(dev), t.to(dev), batch["wav"].to(dev)).cpu()
            samples = {}
            for side, model, d in (("cpu", cpu_b.model, "cpu"), ("card", b.model, dev)):
                g50 = Generator(model, s50, t50, device=d)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                samples[side] = g50.generate_sample(batch["wav"], d_pose, WINDOW,
                                                    noise=x).cpu()
                torch.cuda.synchronize()
                samples[side + "_ms"] = (time.perf_counter() - t0) * 1e3
                samples[side + "_path"] = g50.last_sample_path
        r_fwd, r_sample = rel(out, ref), rel(samples["card"], samples["cpu"])
        step = train_vs_cpu_checks({"cpu": lambda: cpu_b.model,
                                    "card": lambda: bundle(dev).model},
                                   weights, cpu_b.schedule, cfg.Train, batch, t, x,
                                   dev)
        f32 = step["f32"]
        log(f"[decoders] {name} (d_model {d_model}, d_pose {d_pose}, "
            f"{sum(p.numel() for p in b.model.parameters())} parameters; no "
            f"shipped configuration): card against CPU, TF32 off, one mel, "
            f"max|d|/max|ref|: forward {r_fwd:.3e}; train step loss rel "
            f"{f32['loss']:.2e}, worst gradient outside the trunk "
            f"{f32['outside'][0]:.2e} ({f32['outside'][1]}), in the trunk "
            f"{f32['trunk'][0]:.2e}, float64 worst {step['worst64'][0]:.2e}; "
            f"ddim50 generate_sample {r_sample:.3e} (path "
            f"{samples['card_path']}, {samples['card_ms']:.1f} ms on the card, "
            f"{samples['cpu_ms']:.1f} on the CPU); bar {DECODER_BAR:.0e} [{smi}]")
        finite = all(bool(torch.isfinite(v).all())
                     for v in (out, samples["card"]))
        if (not finite or samples["card_path"] != "scan" or r_fwd > DECODER_BAR
                or r_sample > DECODER_BAR or f32["loss"] > DECODER_BAR
                or f32["outside"][0] > DECODER_BAR or not step["ok"]):
            raise AssertionError(f"the {name} decoder on the card is off the CPU's")
        summary[name] = dict(forward=r_fwd, sample=r_sample,
                             step_outside=f32["outside"][0])
    log(f"[decoders] fused kernel launches in the phase: {fs.launches}")
    if fs.launches:
        raise AssertionError("a decoder without a fused kernel launched it")
    return summary


# -- phase 11: the pymo mocap stack -------------------------------------------
# the card against the CPU, both through the port in float32: positions to
# 1e-4 of max |CPU|, angles to 1e-3 degrees (expmap and pivot columns, in
# radians, to the same angle).  A frame whose joint rotation is the same on
# both sides in another representation (a near-tie of the unroll, of
# Shepperd's argmax or of the gimbal test that the two sides' sin/cos break
# apart) is counted as a flip and held to the rotation instead: its matrix
# within the angle bar plus, for euler angles, MOCAP_GIMBAL_ULPS float32
# ulps over |cos| of the middle angle (asin's slope there; the port against
# JAX on the CPU needs 5, tests/test_torch_port_mocap.py)
MOCAP_POS_BAR, MOCAP_ANGLE_BAR, MOCAP_GIMBAL_ULPS = 1e-4, 1e-3, 8
# the golden npz of the reference pymo, at the JAX test's own tolerance
# (tests/test_mocap_transforms.py::_check)
GOLDEN_ATOL, GOLDEN_RTOL = 2e-3, 2e-4
MOCAP_FPS = 20           # DownSampler's target: the config's pose_fps


def _rotmats(vals: np.ndarray, kind: str) -> np.ndarray:
    """(T, 3) euler degrees in ``kind``'s order, or rotation vectors
    (``kind`` "expmap") -> (T, 3, 3), float64."""
    from scipy.spatial.transform import Rotation

    if kind == "expmap":
        return Rotation.from_rotvec(vals).as_matrix()
    return Rotation.from_euler(kind, vals, degrees=True).as_matrix()


def mocap_compare(card, cpu) -> dict:
    """The card's track against the CPU's, column by name: the channel
    tables must be equal; positions and angles within their bars, flipped
    representations held to their rotation.  Returns the worst errors and
    the flips as (joint, frames, first frame, worst float32 ulps over
    |cos| of the middle angle)."""
    if card.channel_names != cpu.channel_names:
        raise AssertionError("the card's channel table differs from the CPU's")
    cols = {n: i for i, n in enumerate(cpu.column_names)}
    pos = [i for n, i in cols.items() if n.endswith("position")]
    scale = max(float(np.abs(cpu.values[:, pos]).max()), 1e-30) if pos else 1.0
    out = {"pos": 0.0, "ang": 0.0, "flips": []}
    if pos:
        out["pos"] = float(np.abs(card.values[:, pos] - cpu.values[:, pos]).max()) / scale
    rad_bar = np.deg2rad(MOCAP_ANGLE_BAR)
    for joint, info in cpu.joints.items():
        # (columns, rotation kind, in radians)
        for names, kind, radians in (
                ([f"{joint}_{p}" for p in ("alpha", "beta", "gamma")], "expmap", True),
                ([f"{joint}_{a}rotation" for a in info.order], info.order, False),
                ([f"{joint}_dYrotation"], None, True)):
            if len(names) not in (1, 3) or not all(n in cols for n in names):
                continue
            idx = [cols[n] for n in names]
            a, b = card.values[:, idx], cpu.values[:, idx]
            d = np.abs(a - b).max(axis=1)
            if radians:
                d = np.rad2deg(d)
            bad = np.flatnonzero(d > MOCAP_ANGLE_BAR)
            if bad.size and kind is not None:
                same = np.abs(_rotmats(a[bad], kind) - _rotmats(b[bad], kind)
                              ).reshape(bad.size, -1).max(axis=1)
                slack = np.zeros(bad.size)
                if kind != "expmap":     # a float32 ulp through asin's slope
                    slack = (np.finfo(np.float32).eps
                             / np.abs(np.cos(np.deg2rad(b[bad, 1]))))
                ulps = float((same / slack).max()) if slack.any() else 0.0
                if (same > rad_bar + MOCAP_GIMBAL_ULPS * slack).any():
                    raise AssertionError(
                        f"{joint}: {bad.size} frames off the CPU's rotation by "
                        f"{same.max():.3e} ({ulps:.1f} ulps over |cos beta|)")
                out["flips"].append((joint, int(bad.size), int(bad[0]), round(ulps, 2)))
                d[bad] = 0.0
            elif bad.size:
                raise AssertionError(f"{names[0]} off the CPU's by {d.max():.3e}")
            out["ang"] = max(out["ang"], float(d.max()))
    if out["pos"] > MOCAP_POS_BAR:
        raise AssertionError(f"positions off the CPU's by {out['pos']:.3e} of max |CPU|")
    return out


def golden_on_card(dev) -> dict:
    """The transforms on the card over tests/golden/synth_fullbody.bvh (and
    toy_chain.bvh for the expmap2pos tag) against the reference pymo's
    output, tag by tag, at the JAX test's tolerance.  Returns the number of
    tags and columns held and the worst |d| / (atol + rtol |ref|)."""
    from gesture_diffusion_torch.data import mocap_transforms as mt
    from gesture_diffusion_torch.data.bvh import parse_bvh

    gold = os.path.join(REPO, "tests", "golden")
    golden = np.load(os.path.join(gold, "pymo_transforms.npz"))
    track = parse_bvh(os.path.join(gold, "synth_fullbody.bvh"))
    toy = parse_bvh(os.path.join(gold, "toy_chain.bvh"))
    outs = {}
    mp = mt.MocapParameterizer("expmap", device=dev)
    outs["expmap"] = mp.transform([track])
    outs["expmap_inv"] = mp.inverse_transform(outs["expmap"])
    outs["toy_expmap2pos"] = mt.MocapParameterizer("expmap2pos", device=dev).transform(
        mp.transform([toy]))
    outs["position"] = mt.MocapParameterizer("position", device=dev).transform([track])
    for axis in "XY":
        outs[f"mirror{axis}"] = mt.Mirror(axis, append=False).transform([track])
    outs["reorderZXY"] = mt.EulerReorder("ZXY", device=dev).fit([track]).transform([track])
    for method, ps, rs in (("abdolute_translation_deltas", 0, 0),
                           ("abdolute_translation_deltas", 4, 0),
                           ("pos_rot_deltas", 0, 0), ("pos_rot_deltas", 5, 2),
                           ("hip_centric", 0, 0)):
        rt = mt.RootTransformer(method, ps, rs, device=dev)
        tag = f"root_{method}_{ps}_{rs}"
        outs[tag] = rt.transform([track])
        if method != "hip_centric":
            outs[tag + "_inv"] = rt.inverse_transform(outs[tag], start_pos=(3.0, -2.0))
    rcp = mt.RootCentricPositionNormalizer()
    outs["rootcentric"] = rcp.transform(outs["position"])
    outs["rootcentric_inv"] = rcp.inverse_transform(outs["rootcentric"])
    const = track.clone()
    const.values[:, const.column_names.index("Hips_Xposition")] = 1.25
    cr = mt.ConstantsRemover().fit([const])
    outs["constants"] = cr.transform([const])
    outs["constants_inv"] = cr.inverse_transform(outs["constants"])
    dropped = sorted(n.decode() for n in golden["constants/dropped"])
    if sorted(cr.const_dims_) != dropped:
        raise AssertionError("ConstantsRemover dropped other columns than pymo")
    worst, n_cols = 0.0, 0
    for tag, tracks in outs.items():
        got = dict(zip(tracks[0].column_names, tracks[0].values.T))
        want = {k.split("/", 1)[1]: golden[k] for k in golden.files
                if k.startswith(tag + "/") and not k.endswith("/dropped")}
        if not want or set(got) != set(want):
            raise AssertionError(f"golden {tag}: the column sets differ")
        for name, ref in want.items():
            margin = float((np.abs(got[name] - ref)
                            / (GOLDEN_ATOL + GOLDEN_RTOL * np.abs(ref))).max())
            worst, n_cols = max(worst, margin), n_cols + 1
    if worst > 1.0:
        raise AssertionError(f"the card's transforms miss pymo's golden output "
                             f"({worst:.3f} of the tolerance)")
    return {"tags": len(outs), "columns": n_cols, "worst": worst}


def mocap_paths(smi, dev, generated=None) -> dict:
    """Phase 11: the pymo mocap stack on the card against the CPU on one
    BEAT-sized recording (CORPUS_SECONDS at 120 fps, the 75-joint skeleton,
    written as write_corpus writes one), pymo's golden output on the card,
    and ``generated`` (the BVH [corpus]'s gen wrote; the recording's first
    1200 frames when that phase did not run) moved to positions on the
    card and written as the HTML player.  Raises on any failed check."""
    import re

    from gesture_diffusion_torch.data import mocap_transforms as mt
    from gesture_diffusion_torch.data.bvh import parse_bvh
    from gesture_diffusion_torch.export import render_mocap_player_html
    from gesture_diffusion_torch.ops import fused_sampler as fs

    fs.launches = 0
    track = parse_bvh(recording_bvh(np.random.default_rng(100), heading=True),
                      is_text=True)
    n_sites = sum(j.is_end_site for j in track.joints.values())
    log(f"[mocap] recording: {track.n_frames} frames at "
        f"{round(1 / track.framerate)} fps, {len(track.joints) - n_sites} joints "
        f"and {n_sites} end sites, {track.values.shape[1]} channels")
    with open(os.path.join(REPO, "configs", "beat-ours.json")) as f:
        joints = json.load(f)["Data"]["joints"]          # the flagship's 41

    def chain(pos):
        ds = mt.DownSampler(MOCAP_FPS).transform(pos)
        sel = mt.JointSelector(joints, include_root=True).fit(ds).transform(ds)
        return mt.Numpyfier().fit(sel).transform(sel)

    def run(device):
        """name -> (output, seconds) for each transform on ``device``."""
        out = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            out[name] = (result, time.perf_counter() - t0)
            return result

        expmap = mt.MocapParameterizer("expmap", device=device)
        exp = timed("expmap", lambda: expmap.transform([track]))
        timed("expmap inverse", lambda: expmap.inverse_transform(exp))
        pos = timed("position", lambda: mt.MocapParameterizer(
            "position", device=device).transform([track]))
        prd = mt.RootTransformer("pos_rot_deltas", 5, 2, device=device)
        fwd = timed("pos_rot_deltas (5, 2)", lambda: prd.transform([track]))
        timed("pos_rot_deltas inverse", lambda: prd.inverse_transform(fwd))
        timed("abdolute_translation_deltas", lambda: mt.RootTransformer(
            "abdolute_translation_deltas", device=device).transform([track]))
        timed("Mirror('X')", lambda: mt.Mirror("X", append=False).transform([track]))
        timed("EulerReorder('ZXY')", lambda: mt.EulerReorder(
            "ZXY", device=device).fit([track]).transform([track]))
        timed("DownSampler -> JointSelector -> Numpyfier", lambda: chain(pos))
        return out

    # a short clip first: the first launches of a process load the kernels
    warm = track.clone()
    warm.values = warm.values[:10]
    mt.MocapParameterizer("expmap", device=dev).transform([warm])
    card, cpu = run(dev), run("cpu")
    flips_all = []
    for name, (got, card_s) in card.items():
        ref, cpu_s = cpu[name]
        if isinstance(ref, np.ndarray):
            scale = float(np.abs(ref).max())
            r = {"pos": float(np.abs(got - ref).max()) / scale, "ang": 0.0, "flips": []}
            if got.shape != ref.shape or r["pos"] > MOCAP_POS_BAR:
                raise AssertionError(f"{name}: the card's array is off the CPU's")
        else:
            r = mocap_compare(got[0], ref[0])
        flips_all += [(name, *f) for f in r["flips"]]
        log(f"[mocap] {name}: card {card_s:.3f} s, CPU {cpu_s:.3f} s; card vs CPU "
            f"positions {r['pos']:.3e} of max|CPU| (bar {MOCAP_POS_BAR:.0e}), angles "
            f"{r['ang']:.3e} deg (bar {MOCAP_ANGLE_BAR:.0e}); flips "
            f"{sum(f[1] for f in r['flips'])} [{smi}]")
    log(f"[mocap] near-tie flips (transform, joint, frames, first frame, ulps over "
        f"|cos beta|), each held to its rotation: {flips_all or 'none'}")

    g = golden_on_card(dev)
    log(f"[mocap] golden pymo output on the card: {g['tags']} tags, {g['columns']} "
        f"columns, worst |d| {g['worst']:.3f} of atol {GOLDEN_ATOL:.0e} + rtol "
        f"{GOLDEN_RTOL:.0e} |ref|")

    source = "[corpus] gen's BVH"
    if generated is None:
        generated = track.clone()
        generated.values = generated.values[:1200]
        source = "the recording's first 1200 frames ([corpus] did not run)"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pos = mt.MocapParameterizer("position", device=dev).transform([generated])[0]
    page = render_mocap_player_html(pos, frame_time=generated.framerate)
    player_s = time.perf_counter() - t0
    frames = json.loads(re.search(r"var frames = (\[.*?\]);\s*//", page, re.S).group(1))
    shown = json.loads(re.search(r"var joints = (\[.*?\]);", page).group(1))
    log(f"[mocap] player of {source}: {len(frames)} frames x {len(shown)} joints "
        f"(track {generated.n_frames} x {len(generated.joints)}), {len(page)} bytes "
        f"of HTML in {player_s:.2f} s")
    if (len(frames) != generated.n_frames or shown != list(generated.joints)
            or any(len(f) != 3 * len(shown) for f in frames)
            or not np.isfinite(pos.values).all()):
        raise AssertionError("the player page does not hold the track")
    if fs.launches:
        raise AssertionError("the mocap stack launched the fused kernel")
    return {"flips": flips_all, "golden": g}


# -- phase 12: the model zoo's other stacks at full width ---------------------
ZOO_BAR = 1e-4           # max |f32 - f64| / max |f64|, on the card, TF32 off
# glide-text2im's 64x64 base model (model_and_diffusion_defaults in
# glide_text2im/model_creation.py): attention_resolutions "32,16,8" at 64
# are the downsample rates 2, 4, 8; its text transformer (xf_width 512,
# text_ctx 128) is not built: encoder_out stands in for its output
GLIDE_BASE = dict(in_channels=3, model_channels=192, out_channels=6,
                  num_res_blocks=3, attention_resolutions=(2, 4, 8),
                  channel_mult=(1, 2, 3, 4), num_head_channels=64,
                  use_scale_shift_norm=True, resblock_updown=True,
                  encoder_channels=512, dims=2)
GLIDE_BATCH, GLIDE_SIZE, GLIDE_TOKENS = 2, 64, 128
ZOO_BATCH = 64


def _randomise_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Zero-initialised weights (GLIDE's output convs) drawn at 1/sqrt(fan
    in), and BatchNorm statistics drawn, from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                fan_in = p[0].numel() if p.dim() > 1 else p.numel()
                p.copy_(torch.randn(p.shape, generator=g) * fan_in ** -0.5)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    return model


def zoo_paths(smi, dev) -> dict:
    """Phase 12: the GLIDE UNet at glide-text2im's base widths, the Primer-EZ
    encoder and decoder at the flagship decoder's, and SEBottleneck at the
    last stage of the HA2G trunk, each in float32 (TF32 off) against its
    own float64 forward on the card; parameters, forward ms (CUDA events),
    peak MB, and the forward's operations (``FlopCounterMode``) with the
    rate they were done at.  Raises above ZOO_BAR."""
    from torch.utils.flop_counter import FlopCounterMode

    from gesture_diffusion_torch.models.glide_unet import GlideUNet
    from gesture_diffusion_torch.models.primer import PrimerEZDecoder, PrimerEZEncoder
    from gesture_diffusion_torch.models.speech_encoder import (SEBottleneck,
                                                               SEResNetEncoder)
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.ops.audio import speech_frontend

    fs.launches = 0
    g = torch.Generator().manual_seed(12)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    # the spatial size the trunk's last stage sees for a 40-frame window
    trunk = SEResNetEncoder().to(dev).eval()
    seen = {}

    def hook(module, inputs, output):
        seen["x"] = output.shape

    trunk.layer4.register_forward_hook(hook)
    with torch.no_grad():
        trunk(speech_frontend(torch.zeros(1, WINDOW * SR // FPS, device=dev)))
    h4, w4 = seen["x"][2:]
    causal = torch.tril(torch.ones(WINDOW, WINDOW, dtype=torch.bool, device=dev))
    cases = {
        "GlideUNet (glide-text2im base 64x64)": (
            lambda: GlideUNet(**GLIDE_BASE),
            (randn(GLIDE_BATCH, 3, GLIDE_SIZE, GLIDE_SIZE),
             torch.randint(0, 1000, (GLIDE_BATCH,), generator=g).to(dev)),
            {"encoder_out": randn(GLIDE_BATCH, GLIDE_BASE["encoder_channels"],
                                  GLIDE_TOKENS)}),
        "PrimerEZEncoder": (
            lambda: PrimerEZEncoder(D_POSE, 256, 8, 4),
            (randn(ZOO_BATCH, WINDOW, D_POSE),), {}),
        "PrimerEZDecoder (causal mask)": (
            lambda: PrimerEZDecoder(D_POSE, 256, 8, 4, d_out=D_POSE),
            (randn(ZOO_BATCH, WINDOW, D_POSE), randn(ZOO_BATCH, 32, 256)),
            {"mask": causal[None, :, :, None]}),
        "SEBottleneck 256->64->256": (
            lambda: SEBottleneck(256, 64), (randn(ZOO_BATCH, 256, h4, w4),), {}),
        "SEBottleneck 256->64->256, stride-2 projection": (
            lambda: SEBottleneck(256, 64, stride=2),
            (randn(ZOO_BATCH, 256, h4, w4),), {}),
    }
    out = {}
    for k, (name, (make, args, kwargs)) in enumerate(cases.items()):
        torch.manual_seed(k)
        with torch.device(dev):
            model = make()
        # .to: a buffer made from numpy (Primer's positional table) is
        # built on the host whatever the default device
        model = _randomise_(model.to(dev), k).eval()
        n_params = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            y32 = model(*args, **kwargs)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            ms = cuda_ms(lambda: model(*args, **kwargs), reps=5)
            with FlopCounterMode(display=False) as counter:
                model(*args, **kwargs)
            gflop = counter.get_total_flops() / 1e9
            model64 = model.double()
            y64 = model64(*[a.double() if a.is_floating_point() else a for a in args],
                          **{k2: (v.double() if v.is_floating_point() else v)
                             for k2, v in kwargs.items()})
        r = float((y32.double() - y64).abs().max() / y64.abs().max())
        out[name] = dict(params=n_params, ms=ms, peak_mb=peak, rel=r, gflop=gflop)
        log(f"[zoo] {name}: {n_params} parameters, input "
            f"{tuple(args[0].shape)}, forward {ms:.3f} ms (CUDA events, float32, "
            f"TF32 off; {gflop:.3f} GFLOP, {gflop / ms:.2f} TFLOP/s), peak "
            f"{peak:.1f} MB above the weights, max|f32 - f64| / max|f64| "
            f"{r:.3e} (bar {ZOO_BAR:.0e}) [{smi}]")
        if not bool(torch.isfinite(y32).all()) or r > ZOO_BAR:
            raise AssertionError(f"{name}: float32 off float64 by {r:.3e}")
        del model, model64, y32, y64
        torch.cuda.empty_cache()
    if fs.launches:
        raise AssertionError("the zoo launched the fused kernel")
    return out


MULTI_BATCH, MULTI_STEPS = 64, 8
# NCCL world 1 against the plain trainer, f32, TF32 off: the losses 1e-5;
# the BN statistics phase 6's 1e-4 (per channel a sum over 2 M values,
# centred two-pass here, cuDNN's own way there), the gradient norm phase
# 6's 1e-3 (the SE-ResNet trunk's train-mode gradient amplifies the
# BatchNorm's rounding); the parameters by mean|d| over their mean movement,
# 1e-2, since Adam's step lr * m / (sqrt(v) + eps) turns the rounding of a
# near-zero gradient (the trunk's ill-conditioned ones, the key dconv
# biases' exact zeros) into a whole step of either sign
MULTI_BAR, MULTI_PARAM_BAR = 1e-5, 1e-2
# the bf16 encoder (the flagship's Train.encoder_dtype): the global
# BatchNorm rounds some bf16 outputs apart from cuDNN's, which the trunk
# amplifies; the losses within 2**-8 (bf16's unit roundoff), the BN
# statistics, grad_norm and parameters within MULTI_BF16_RATIO times the
# plain trainer's own bf16 distance from its f32 run on the same batches
MULTI_BF16_LOSS_BAR, MULTI_BF16_RATIO = 2.0 ** -8, 2.0
MULTI_WINDOWS = 5        # timed windows of MULTI_STEPS queued steps a side
MULTI_TIMEOUT = 300      # s, the two gloo ranks together

# one rank of [multi]'s two gloo ranks sharing a device: one step of its
# half of the global batch (f32, TF32 off, the parent's mel of its rows),
# the sampler's ragged gather, then MULTI_STEPS timed steps
_MULTI_RANK = r"""
import sys, time
rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dev = __import__("torch").device(sys.argv[4])
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from gesture_diffusion_torch.diffusion.resample import LossSecondMomentResampler
from gesture_diffusion_torch.models import build_all, speech_encoder
from gesture_diffusion_torch.parallel import active_group, init_distributed
from gesture_diffusion_torch.training import make_optimizer, make_train_step
from gesture_diffusion_torch.utils import JsonConfig

assert init_distributed(f"localhost:{port}", 2, rank, backend="gloo",
                        device=dev) == rank
inp = torch.load(f"{work}/inputs.pt", weights_only=True)
n = inp["pose"].shape[0] // 2
rows = slice(rank * n, (rank + 1) * n)
mel = inp["mel"][rows].to(dev)
speech_encoder.speech_frontend = lambda w: mel
cfg = JsonConfig(inp["config"])
b = build_all(cfg, inp["d_pose"], device=dev, encoder_dtype=None)
b.model.load_state_dict(inp["state"])
step = make_train_step(b.model, b.schedule, *make_optimizer(b.model, cfg.Train))
batch = {"pose": inp["pose"][rows].to(dev), "wav": inp["wav"][rows].to(dev)}
m = step(batch, 0, t=inp["t"].to(dev), noise=inp["noise"].to(dev))
out = {"metrics": {k: float(v) for k, v in m.items()},
       "grads": {k: p.grad.detach().cpu().clone()
                 for k, p in b.model.named_parameters()},
       "stats": {k: v.detach().cpu().clone() for k, v in b.model.state_dict().items()
                 if "running_" in k}}
s = LossSecondMomentResampler(1000, history_per_term=2)
g = np.random.default_rng(rank)
for k in ((5, 3), (2, 0))[rank]:
    s.update_with_local_losses(g.integers(0, 1000, k), g.gamma(2.0, 1.0, k))
out["hist"] = torch.from_numpy(s._loss_history.copy())
out["counts"] = torch.from_numpy(s._loss_counts.copy())
ms = []
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
for i in range(%(steps)d):
    sync()
    t0 = time.perf_counter()
    step(batch, 1 + i)
    sync()
    ms.append((time.perf_counter() - t0) * 1e3)
out["ms"] = ms
out["world"] = list(active_group())
torch.save(out, f"{work}/out_{rank}.pt")
torch.distributed.destroy_process_group()
print("DONE", rank, flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def multi_paths(smi, dev, check) -> dict:
    """Phase 13: data-parallel training and sharded serving on one card.
    Returns the fused launches of its main paths by row of the kernels
    line (``counted``); raises on any failed check."""
    import tempfile

    import torch.distributed as dist

    from gesture_diffusion_torch import cli
    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.generation import Generator
    from gesture_diffusion_torch.models import build_all, speech_encoder
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.parallel import init_distributed, make_mesh
    from gesture_diffusion_torch.training import Trainer, iter_batches, make_optimizer
    from gesture_diffusion_torch.utils import JsonConfig

    cfg = JsonConfig(os.path.join(REPO, "configs", "beat-ours.json"))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_multi_")
    launches = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def bundle(encoder_dtype=None):
        return build_all(cfg, D_POSE, device=dev, encoder_dtype=encoder_dtype,
                         generator=torch.Generator().manual_seed(0))

    # -- [multi-nccl]: the DDP path at world size 1 against the plain trainer
    train_ds = synthetic_training_set(MULTI_BATCH * MULTI_STEPS, 90)
    val_ds = synthetic_training_set(MULTI_BATCH, 91)
    block = list(iter_batches(train_ds, MULTI_BATCH, shuffle=False))
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for enc in (None, "bfloat16"):
            for label in ("plain", "nccl"):
                if label == "nccl":
                    init_distributed(f"localhost:{_free_port()}", 1, 0, device=dev)
                    if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo"):
                        raise AssertionError("world 1 on the card is not NCCL")
                b = bundle(enc)
                init = {k: v.detach().clone() for k, v in b.model.named_parameters()}
                trainer = Trainer(b.model, b.schedule, *make_optimizer(b.model, cfg.Train),
                                  train_ds, val_ds, MULTI_BATCH,
                                  os.path.join(tmp.name, f"{label}_{enc}"), seed=0,
                                  device=dev)
                metrics = trainer.train_steps(block)
                state = {k: v.detach().clone() for k, v in b.model.state_dict().items()}
                windows = []
                for _ in range(MULTI_WINDOWS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.train_steps(block)
                    torch.cuda.synchronize()
                    windows.append((time.perf_counter() - t0) * 1e3 / len(block))
                runs[label, enc] = dict(
                    loss=[float(m["loss"]) for m in metrics],
                    norm=[float(m["grad_norm"]) for m in metrics],
                    state=state, init=init, ms=windows)
                if label == "nccl":
                    dist.destroy_process_group()
                del b, trainer
    finally:
        torch.backends.cudnn.deterministic = False
        if dist.is_initialized():
            dist.destroy_process_group()

    def distances(x, y):
        """loss and grad_norm max rel over the steps, the BN statistics'
        max|d|/max|ref|, the parameters' mean|d| over x's mean movement."""
        moved = torch.cat([(x["state"][k] - v).abs().flatten()
                           for k, v in x["init"].items()]).mean()
        return dict(
            loss=max(abs(p - q) / abs(p) for p, q in zip(x["loss"], y["loss"])),
            norm=max(abs(p - q) / abs(p) for p, q in zip(x["norm"], y["norm"])),
            bn=max(float((y["state"][k] - v).abs().max() / v.abs().max())
                   for k, v in x["state"].items() if "running_" in k),
            params=float(torch.cat([(y["state"][k] - x["state"][k]).abs().flatten()
                                    for k in x["init"]]).mean() / moved))

    def spread(ms):
        return (f"median {float(np.median(ms)):.2f} (min {min(ms):.2f}, max "
                f"{max(ms):.2f})")

    f32 = distances(runs["plain", None], runs["nccl", None])
    bf16 = distances(runs["plain", "bfloat16"], runs["nccl", "bfloat16"])
    own = distances(runs["plain", "bfloat16"], runs["plain", None])
    bars32 = dict(loss=MULTI_BAR, norm=TRAIN_NORM_BAR, bn=TRAIN_LOSS_BAR,
                  params=MULTI_PARAM_BAR)
    bars16 = {k: MULTI_BF16_RATIO * v for k, v in own.items()}
    bars16["loss"] = MULTI_BF16_LOSS_BAR
    for enc, found, bars in ((None, f32, bars32), ("bfloat16", bf16, bars16)):
        a, b_ = runs["plain", enc], runs["nccl", enc]
        ratio = float(np.median(b_["ms"]) / np.median(a["ms"]))
        log(f"[multi-nccl] beat-ours encoder {enc or 'f32'} (TF32 off, cuDNN "
            f"deterministic), batch {MULTI_BATCH}, {MULTI_STEPS} steps from the "
            f"same weights and batches: DDP over NCCL at world size 1 against the "
            f"plain trainer: "
            + ", ".join(f"{k} {v:.3e} (bar {bars[k]:.2e})" for k, v in found.items())
            + f" (loss, grad_norm: max rel; BN running statistics: max|d|/max|ref|; "
            f"parameters: mean|d| over their mean movement); ms a step, "
            f"{MULTI_WINDOWS} windows of {MULTI_STEPS} steps queued, one "
            f"synchronise each: plain {spread(a['ms'])}, DDP {spread(b_['ms'])} "
            f"({ratio:.3f}x the median: what DDP costs on one card) [{smi}]")
        log(f"[multi-nccl]   losses plain: " + " ".join(f"{x:.5f}" for x in a["loss"])
            + "; DDP: " + " ".join(f"{x:.5f}" for x in b_["loss"]))
        if any(found[k] > bars[k] for k in found):
            raise AssertionError(f"DDP at world size 1 is off the plain trainer "
                                 f"(encoder {enc or 'f32'})")
    log(f"[multi-nccl] the bf16 bars' base, the plain bf16 trainer against the "
        f"plain f32 one: " + ", ".join(f"{k} {v:.3e}" for k, v in own.items()))

    # -- [multi-gloo]: two ranks sharing cuda:0, one step at batch 64 -----
    b = bundle()
    state = {k: v.detach().cpu() for k, v in b.model.state_dict().items()}
    ds = synthetic_training_set(MULTI_BATCH, 92)
    batch = {k: torch.from_numpy(v) for k, v in ds.data.items()}
    g = torch.Generator().manual_seed(93)
    t = torch.randint(0, b.schedule.num_timesteps, (MULTI_BATCH,), generator=g)
    noise = torch.randn(batch["pose"].shape, generator=g)
    mel = speech_encoder.speech_frontend(batch["wav"].to(dev)).float()
    work = tmp.name
    torch.save({"config": cfg.to_dict(), "d_pose": D_POSE, "state": state,
                "pose": batch["pose"], "wav": batch["wav"], "t": t,
                "noise": noise, "mel": mel.cpu()}, os.path.join(work, "inputs.pt"))
    port = _free_port()
    script = _MULTI_RANK % {"repo": REPO, "steps": MULTI_STEPS}
    spawn_s = _spawn(script, lambda r: [str(r), str(port), work, str(dev)], 2,
                     MULTI_TIMEOUT, "the two gloo ranks")
    outs = [torch.load(os.path.join(work, f"out_{r}.pt"), weights_only=True)
            for r in range(2)]

    # the one-process step on the global batch, f32 and f64, the same mel
    ref = one_process_steps(bundle, state, cfg, batch, t, noise, mel, dev)
    (m32, g32, s32), (_, g64, _) = ref[torch.float32], ref[torch.float64]
    s32 = {k: v for k, v in s32.items() if "running_" in k}
    o = outs[0]
    loss_d = abs(o["metrics"]["loss"] - m32["loss"]) / abs(m32["loss"])
    norm_d = abs(o["metrics"]["grad_norm"] - m32["grad_norm"]) / m32["grad_norm"]
    bn_d = max(float((o["stats"][k] - v).abs().max() / v.abs().max())
               for k, v in s32.items())
    top = max(float(v.abs().max()) for v in g32.values())
    outside = max((float((o["grads"][k] - v).abs().max())
                   / max(float(v.abs().max()), 1e-2 * top), k)
                  for k, v in g32.items() if not k.startswith(TRUNK))

    def trunk_err(grads):
        return max(float((grads[k].double() - g64[k]).abs().max() / g64[k].abs().max())
                   for k in g64 if k.startswith(TRUNK))

    ranks_err, single_err = trunk_err(o["grads"]), trunk_err(g32)
    same_ranks = all(torch.equal(outs[0]["grads"][k], outs[1]["grads"][k])
                     for k in outs[0]["grads"])
    hist_equal = (torch.equal(outs[0]["hist"], outs[1]["hist"])
                  and torch.equal(outs[0]["counts"], outs[1]["counts"]))
    ms = [float(np.median(x["ms"])) for x in outs]
    log(f"[multi-gloo] beat-ours f32 (TF32 off), global batch {MULTI_BATCH}: two "
        f"ranks of {MULTI_BATCH // 2} over gloo, both on {dev} (subprocesses, "
        f"{spawn_s:.1f} s with start-up), one step against the one-process step "
        f"on the same global batch, t, noise and mel: loss rel {loss_d:.2e}, "
        f"grad_norm rel {norm_d:.2e}, BN max|d|/max|ref| {bn_d:.2e} (bar "
        f"{TRAIN_LOSS_BAR:.0e}); worst gradient outside the trunk "
        f"{outside[0]:.2e} of max|g| ({outside[1]}; bar {TRAIN_GRAD_BAR:.0e}); the "
        f"trunk's f32 against f64: two ranks {ranks_err:.2e}, one process "
        f"{single_err:.2e} (bar {TRAIN_TRUNK_RATIO:g}x); the ranks' gradients "
        f"equal: {same_ranks}; world {outs[0]['world']} [{smi}]")
    log(f"[multi-gloo] the loss-aware sampler after the ragged gather (5 + 2 "
        f"then 3 + 0 pairs): histories bit-equal on both ranks: {hist_equal}, "
        f"{int(outs[0]['counts'].sum())} entries; ms a step, two ranks sharing "
        f"one card (correctness and overhead, not a scaling number): rank 0 "
        f"{ms[0]:.1f}, rank 1 {ms[1]:.1f} median of {MULTI_STEPS} "
        f"synchronised steps [{smi}]")
    if (loss_d > TRAIN_LOSS_BAR or bn_d > TRAIN_LOSS_BAR or norm_d > TRAIN_NORM_BAR
            or outside[0] > TRAIN_GRAD_BAR
            or ranks_err > TRAIN_TRUNK_RATIO * single_err
            or not same_ranks or not hist_equal or outs[0]["world"] != [0, 2]):
        raise AssertionError("two gloo ranks are off the one-process step")

    # -- [multi-serve]: the Generator over a mesh of two shards on one card
    mesh = make_mesh(devices=[dev, dev])
    serve = {}
    for mt in ("s2g_v2", "inpaint"):
        cfg_t = JsonConfig(os.path.join(REPO, "configs", "beat-ours.json"))
        cfg_t.set("Model.type", mt)
        bt = build_all(cfg_t, D_POSE, device=dev,
                       generator=torch.Generator().manual_seed(0))
        serve[mt] = (Generator(bt.model, bt.eval_schedule, bt.eval_timestep_map,
                               mesh=mesh),
                     Generator(bt.model, bt.eval_schedule, bt.eval_timestep_map,
                               device=dev))
    wav = seeded_audio(94, MULTI_BATCH, WINDOW / FPS)
    gen_noise = torch.Generator(device=dev).manual_seed(95)
    ip = torch.zeros(MULTI_BATCH, WINDOW, D_POSE, device=dev)
    ip[:, :SEED_LEN] = 0.5 * torch.randn(MULTI_BATCH, SEED_LEN, D_POSE,
                                         generator=gen_noise, device=dev)
    im = torch.zeros(MULTI_BATCH, WINDOW, 1, device=dev)
    im[:, :SEED_LEN] = 1.0
    blend = dict(inpaint_poses=ip, inpaint_masks=im, trans_factor=TRANS_FACTOR,
                 pose_seed_len=SEED_LEN)
    real_cuda = fs._fused_ddim_cuda
    for variant, mt, alg, kw in (("ddim", "s2g_v2", "ddim", {}),
                                 ("stochastic", "s2g_v2", "ddpm", {}),
                                 ("x_add", "inpaint", "ddpm", blend)):
        sharded, whole = serve[mt]
        results = {}
        for forced in (None, 2):
            if forced is not None:
                fs._fused_ddim_cuda = lambda *a, **k: real_cuda(*a, **k, cluster=forced)
            try:
                for name, gen in (("sharded", sharded), ("whole", whole)):
                    reset_counts()
                    t0 = time.perf_counter()
                    out = gen.generate_sample(
                        wav, D_POSE, WINDOW, sample_alg=alg,
                        generator=torch.Generator(device=dev).manual_seed(96), **kw)
                    torch.cuda.synchronize()
                    results[name, forced] = (out, fs.launches, fs.last_cluster,
                                             (time.perf_counter() - t0) * 1e3)
                    counted(variant, launches)
            finally:
                fs._fused_ddim_cuda = real_cuda
        r = rel(results["sharded", None][0], results["whole", None][0])
        exact = torch.equal(results["sharded", 2][0], results["whole", 2][0])
        n_sh = results["sharded", None][1]
        log(f"[multi-serve] {mt} {alg}{' x0-blend' if kw else ''}, batch "
            f"{MULTI_BATCH} over make_mesh(devices=[{dev}, {dev}]), 1000 steps: "
            f"sharded {results['sharded', None][3]:.1f} ms ({n_sh} kernel launches, "
            f"clusters of {results['sharded', None][2]}), unsharded "
            f"{results['whole', None][3]:.1f} ms (clusters of "
            f"{results['whole', None][2]}); max|d|/max|ref| {r:.3e} at the planned "
            f"C (bar {KERNEL_BAR:.0e}); bit-equal at forced C=2: {exact} [{smi}]")
        if n_sh != 2 or results["whole", None][1] != 1 or r > KERNEL_BAR or not exact:
            raise AssertionError(f"the sharded {mt} {alg} sample is off the "
                                 "unsharded one or did not launch twice")
    sharded, whole = serve["s2g_v2"]
    reset_counts()
    three = sharded.generate_sample(wav[:3], D_POSE, WINDOW,
                                    generator=torch.Generator(device=dev).manual_seed(97))
    torch.cuda.synchronize()
    n3 = fs.launches
    counted("ddim", launches)
    log(f"[multi-serve] batch 3 does not divide over 2 shards: {n3} launch "
        f"(unsharded on the first device), output {tuple(three.shape)}")
    if n3 != 1 or not torch.isfinite(three).all():
        raise AssertionError("batch 3 did not run unsharded")

    # the stream over the mesh against generate_sequence over it, 2 x 10 s
    wav_long = seeded_audio(98, 2, 10.0)
    noises = [torch.randn(2, WINDOW, D_POSE, generator=gen_noise, device=dev)
              for _ in range(7)]
    kw = dict(noise_fn=lambda b0, d: noises[d], trans_factor=TRANS_FACTOR,
              mesh=mesh)
    reset_counts()
    offline = whole.generate_sequence(wav_long, SR, D_POSE, FPS, WINDOW, SEED_LEN, **kw)
    n_off = fs.launches
    counted("ddim", launches)
    reset_counts()
    stream = whole.stream(SR, D_POSE, FPS, WINDOW, SEED_LEN, **kw)
    chunks = []
    for i in range(0, wav_long.shape[1], SR // 2):
        chunks.extend(stream.push(wav_long[:, i:i + SR // 2]))
    chunks.extend(stream.flush())
    n_str = fs.launches
    counted("ddim", launches)
    streamed = np.concatenate(chunks, axis=1)
    same = streamed.shape == offline.shape and np.array_equal(streamed, offline)
    log(f"[multi-serve] stream(mesh=) against generate_sequence(mesh=), 2 x 10 s: "
        f"equal exactly: {same}; launches {n_str} and {n_off} (7 windows x 2 "
        f"shards)")
    if not same or n_str != 14 or n_off != 14:
        raise AssertionError("the stream over the mesh differs from "
                             "generate_sequence over it")

    # the kernel at clip_base 0 and > 0 against its plain version, and the
    # shard's z against the whole batch's
    s50, t50 = make_diffusion("linear", 1000, "ddim50")
    g50 = Generator(serve["s2g_v2"][1].model, s50, t50, device=dev)
    wav_t = torch.from_numpy(seeded_audio(99, MULTI_BATCH, WINDOW / FPS)).to(dev)
    noise50 = torch.randn(MULTI_BATCH, WINDOW, D_POSE, generator=gen_noise, device=dev)
    with torch.no_grad():
        args = g50.fused_args(wav_t, D_POSE, WINDOW, noise50, sample_alg="ddpm",
                              seed=torch.tensor([4321], device=dev))
    half = MULTI_BATCH // 2
    for base in (0, half):
        shard = dict(args, clip_base=base)
        for k in ("x_T", "mem_rows"):
            shard[k] = args[k][base:base + half].contiguous()
        check("stochastic", f"batch {half} DDPM, clip_base {base}", shard)
    # a comparison: the launch counts are left as they were found
    counts = fs.launches, dict(fs.launches_by_dtype)
    with torch.no_grad():
        one = dict(args, tmap=args["tmap"][:1], num_steps=1, coefs=torch.tensor(
            [[0.0, 0.0, 0.0, 0.0, 1.0]], device=dev), clip_base=half,
            x_T=args["x_T"][half:].contiguous(), mem_rows=args["mem_rows"][half:].contiguous())
        z = fs.fused_ddim_sample(**one)
        whole_z = fs.fused_noise(torch.tensor([4321], device=dev), 0, MULTI_BATCH,
                                 WINDOW, z.shape[2], dev)
    fs.launches, fs.launches_by_dtype = counts
    z_same = torch.equal(z, whole_z[half:])
    log(f"[multi-serve] the kernel's z at clip_base {half} equals the whole "
        f"batch's z of clips {half}..{MULTI_BATCH - 1} bit for bit: {z_same}")
    if not z_same:
        raise AssertionError("clip_base does not continue the batch's noise")

    # -- [multi-cli]: Train.world_size on a one-card machine -------------
    cfg2 = JsonConfig(os.path.join(REPO, "configs", "beat-ours.json"))
    cfg2.set("Train.world_size", 2)
    cfg2.set("Meta.seed", 0)
    try:
        cli.train_model(cfg2, device=dev)
    except ValueError as e:
        message = str(e)
    else:
        raise AssertionError("Train.world_size 2 trained on one card")
    auto = cli.world_size(cfg, dev)
    log(f"[multi-cli] Train.world_size 2 with {torch.cuda.device_count()} GPU: "
        f"ValueError {message!r}; \"auto\" -> {auto} process (phase 7's train ran "
        f"it in this one)")
    if "needs 2 devices, have 1" not in message or auto != torch.cuda.device_count():
        raise AssertionError("the CLI's world_size is not make_mesh's")
    tmp.cleanup()
    return launches


# -- phase 14: tensor parallelism on one card -----------------------------------
TP_LAYOUTS = ((1, 2), (2, 2))     # (n_data, n_model) gloo ranks on one card
TP_BATCH = 64
TP_STEPS = 3                      # timed steps a rank after the compared one
TP_TIMEOUT = 300                  # s, the ranks of one layout together

# one rank of [tp]: beat-ours at full width sharded over the model axis,
# one step of its data row's rows (f32, TF32 off, the parent's mel), the
# gradients and the stepped weights gathered whole, then TP_STEPS timed
_TP_RANK = r"""
import sys, time
rank, world, n_data, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4], sys.argv[5])
dev = __import__("torch").device(sys.argv[6])
sys.path.insert(0, %(repo)r)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from gesture_diffusion_torch.models import build_all, speech_encoder
from gesture_diffusion_torch.parallel import (active_group, apply_tensor_parallel,
                                              full_state_dict, gather_full,
                                              init_distributed, make_mesh)
from gesture_diffusion_torch.training import make_optimizer, make_train_step
from gesture_diffusion_torch.utils import JsonConfig

init_distributed(f"localhost:{port}", world, rank, backend="gloo", device=dev)
mesh = make_mesh(n_data, world // n_data, [dev] * world)
row = active_group()[0]
inp = torch.load(f"{work}/inputs.pt", weights_only=True)
n = inp["pose"].shape[0] // n_data
rows = slice(row * n, (row + 1) * n)
mel = inp["mel"][rows].to(dev)
speech_encoder.speech_frontend = lambda w: mel
cfg = JsonConfig(inp["config"])
b = build_all(cfg, inp["d_pose"], device=dev, encoder_dtype=None)
b.model.load_state_dict(inp["state"])
plan = apply_tensor_parallel(b.model, mesh)
step = make_train_step(b.model, b.schedule, *make_optimizer(b.model, cfg.Train))
batch = {"pose": inp["pose"][rows].to(dev), "wav": inp["wav"][rows].to(dev)}
m = step(batch, 0, t=inp["t"].to(dev), noise=inp["noise"].to(dev))
grads = gather_full(b.model, {k: p.grad for k, p in b.model.named_parameters()})
state = full_state_dict(b.model)
out = {"metrics": {k: float(v) for k, v in m.items()},
       "grads": {k: v.detach().cpu().clone() for k, v in grads.items()},
       "state": {k: v.detach().cpu().clone() for k, v in state.items()},
       "kernels": sum(1 for k, v in plan.items()
                      if v != "replicated" and k.endswith("weight"))}
ms = []
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
for i in range(%(steps)d):
    sync()
    t0 = time.perf_counter()
    step(batch, 1 + i)
    sync()
    ms.append((time.perf_counter() - t0) * 1e3)
out["ms"] = ms
if rank == 0:
    torch.save(out, f"{work}/out_{world}.pt")
torch.distributed.destroy_process_group()
print("DONE", rank, flush=True)
"""


def _spawn(script: str, argv_of, n: int, timeout: float, what: str) -> float:
    """Run ``n`` copies of ``script`` (``argv_of(r)`` their arguments) to
    their end; returns the seconds they took, raises on a failure."""
    import signal

    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", script, *argv_of(r)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
        raise AssertionError(f"{what} did not end in {timeout} s")
    for p, (_, err) in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"{what} failed (exit {p.returncode}):\n"
                                 f"{err[-4000:]}")
    return time.perf_counter() - t0


def one_process_steps(bundle, state, cfg, batch, t, noise, mel, dev) -> dict:
    """The one-process step on the global batch in float32 and float64 on
    one mel: dtype -> (metrics, gradients, state after the step)."""
    from gesture_diffusion_torch.models import speech_encoder
    from gesture_diffusion_torch.training import make_optimizer, make_train_step

    ref = {}
    frontend = speech_encoder.speech_frontend
    speech_encoder.speech_frontend = lambda w: mel
    try:
        for dtype in (torch.float32, torch.float64):
            b = bundle()
            model = b.model
            model.load_state_dict(state)
            model.to(dtype)
            step = make_train_step(model, b.schedule, *make_optimizer(model, cfg.Train))
            m = step({"pose": batch["pose"].to(dev, dtype), "wav": batch["wav"].to(dev)},
                     0, t=t.to(dev), noise=noise.to(dev, dtype))
            ref[dtype] = ({k: float(v) for k, v in m.items()},
                          {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                          {k: v.detach().cpu().float() for k, v in model.state_dict().items()})
            del b, model, step
    finally:
        speech_encoder.speech_frontend = frontend
    return ref


def tp_paths(smi, dev, check) -> dict:
    """Phase 14: tensor parallelism (``parallel/tp.py``) on one card.
    Returns the fused launches of its serving path by row of the kernels
    line (``counted``); raises on any failed check."""
    import tempfile

    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.generation import Generator
    from gesture_diffusion_torch.models import build_all, speech_encoder
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.utils import JsonConfig

    cfg = JsonConfig(os.path.join(REPO, "configs", "beat-ours.json"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tp_")

    def bundle():
        return build_all(cfg, D_POSE, device=dev, encoder_dtype=None,
                         generator=torch.Generator().manual_seed(0))

    state = {k: v.detach().cpu() for k, v in bundle().model.state_dict().items()}
    ds = synthetic_training_set(TP_BATCH, 110)
    batch = {k: torch.from_numpy(v) for k, v in ds.data.items()}
    g = torch.Generator().manual_seed(111)
    t = torch.randint(0, 1000, (TP_BATCH,), generator=g)
    noise = torch.randn(batch["pose"].shape, generator=g)
    mel = speech_encoder.speech_frontend(batch["wav"].to(dev)).float()
    torch.save({"config": cfg.to_dict(), "d_pose": D_POSE, "state": state,
                "pose": batch["pose"], "wav": batch["wav"], "t": t, "noise": noise,
                "mel": mel.cpu()}, os.path.join(tmp.name, "inputs.pt"))
    ref = one_process_steps(bundle, state, cfg, batch, t, noise, mel, dev)
    (m32, g32, s32), (_, g64, _) = ref[torch.float32], ref[torch.float64]
    top = max(float(v.abs().max()) for v in g32.values())

    def trunk_err(grads):
        return max(float((grads[k].double() - g64[k].double()).abs().max()
                         / g64[k].abs().max()) for k in g64 if k.startswith(TRUNK))

    single_err = trunk_err(g32)
    script = _TP_RANK % {"repo": REPO, "steps": TP_STEPS}
    outs = {}
    for n_data, n_model in TP_LAYOUTS:
        world = n_data * n_model
        port = _free_port()
        secs = _spawn(script, lambda r: [str(r), str(world), str(n_data), str(port),
                                         tmp.name, str(dev)],
                      world, TP_TIMEOUT, f"the {n_data}x{n_model} tensor-parallel ranks")
        o = torch.load(os.path.join(tmp.name, f"out_{world}.pt"), weights_only=True)
        outs[world] = o
        loss_d = abs(o["metrics"]["loss"] - m32["loss"]) / abs(m32["loss"])
        norm_d = abs(o["metrics"]["grad_norm"] - m32["grad_norm"]) / m32["grad_norm"]
        bn_d = max(float((o["state"][k] - v).abs().max() / v.abs().max())
                   for k, v in s32.items() if "running_" in k)
        outside = max((float((o["grads"][k] - v).abs().max())
                       / max(float(v.abs().max()), 1e-2 * top), k)
                      for k, v in g32.items() if not k.startswith(TRUNK))
        tp_err = trunk_err(o["grads"])
        log(f"[tp] beat-ours f32 (TF32 off), global batch {TP_BATCH}, "
            f"{n_data}x{n_model} gloo ranks (data x model) all on {dev} "
            f"(subprocesses, {secs:.1f} s with start-up), {o['kernels']} kernels "
            f"split over the model axis: one step against the one-process step "
            f"on the same batch, t, noise and mel: loss rel {loss_d:.2e}, "
            f"grad_norm rel {norm_d:.2e}, BN max|d|/max|ref| {bn_d:.2e} (bar "
            f"{TRAIN_LOSS_BAR:.0e}, norm {TRAIN_NORM_BAR:.0e}); worst gradient "
            f"outside the trunk {outside[0]:.2e} of max|g| ({outside[1]}; bar "
            f"{TRAIN_GRAD_BAR:.0e}); the trunk's f32 against f64: the ranks "
            f"{tp_err:.2e}, one process {single_err:.2e} (bar "
            f"{TRAIN_TRUNK_RATIO:g}x); rank 0's step {float(np.median(o['ms'])):.1f} "
            f"ms median of {TP_STEPS} synchronised (overhead of {world} ranks "
            f"sharing one card, not scaling) [{smi}]")
        if (loss_d > TRAIN_LOSS_BAR or bn_d > TRAIN_LOSS_BAR or norm_d > TRAIN_NORM_BAR
                or outside[0] > TRAIN_GRAD_BAR or tp_err > TRAIN_TRUNK_RATIO * single_err
                or o["kernels"] != 10 * cfg.Model.Decoder.n_layers):
            raise AssertionError(f"the {n_data}x{n_model} tensor-parallel step is "
                                 "off the one-process step")

    # the 2x2 run's checkpoint (whole tensors) through the fused kernel,
    # against the one-process step's weights
    s50, t50 = make_diffusion("linear", 1000, "ddim50")
    gen = Generator(bundle().model, s50, t50, device=dev)
    wav = seeded_audio(112, 8, WINDOW / FPS)
    noise50 = torch.randn(8, WINDOW, D_POSE, generator=torch.Generator(device=dev)
                          .manual_seed(113), device=dev)
    samples, launches, rows = [], 0, {}
    for weights in (outs[4]["state"], ref[torch.float32][2]):
        gen.update_variables({k: v.to(dev) for k, v in weights.items()})
        reset_counts()
        samples.append(gen.generate_sample(wav, D_POSE, WINDOW, noise=noise50))
        torch.cuda.synchronize()
        launches += fs.launches
        counted("ddim", rows)
    r = rel(samples[0], samples[1])
    log(f"[tp] the 2x2 ranks' checkpoint (full_state_dict: whole tensors under "
        f"the reference's names) in a plain Generator, ddim50 batch 8 through "
        f"the fused kernel: max|d|/max|ref| {r:.3e} against the one-process "
        f"step's weights (bar {KERNEL_BAR:.0e}); {launches} launches")
    if r > KERNEL_BAR or launches != 2:
        raise AssertionError("the tensor-parallel checkpoint does not serve as "
                             "the one-process one")
    tmp.cleanup()
    return rows


# -- phase 15: the whole-model compute dtype (Train.dtype) -------------------------
DTYPE_RATIO, DTYPE_FLOOR = 2.0, 2.0 ** -8   # tests/test_torch_port_dtype.py's
DTYPE_DRAWS = 2
DTYPE_NORM_BAND = (0.8, 1.25)
TED_DTYPE_BATCHES = (1, 32)


def _grad_groups(names):
    heads = tuple(f"{TRUNK}{kind}_{tag}." for kind in ("conv", "bn", "fc")
                  for tag in ("low", "mid", "high"))
    trunk = [k for k in names if k.startswith(TRUNK)]
    return {"trunk body": [k for k in trunk if not k.startswith(heads)],
            "trunk heads": [k for k in trunk if k.startswith(heads)],
            "rest": [k for k in names if not k.startswith(TRUNK)]}


def _l2(grads, ref, names) -> float:
    num = sum(float(((grads[k].double() - ref[k].double()) ** 2).sum()) for k in names)
    return (num / sum(float((ref[k].double() ** 2).sum()) for k in names)) ** 0.5


def _norm_ratio(grads, ref, names) -> float:
    return (sum(float((grads[k].double() ** 2).sum()) for k in names)
            / sum(float((ref[k].double() ** 2).sum()) for k in names)) ** 0.5


def dtype_paths(smi, dev, check) -> dict:
    """Phase 15: ``Train.dtype: "bfloat16"`` on the card.  Returns the fused
    launches of its serving path by row of the kernels line (``counted``);
    raises on any failed check."""
    import tempfile

    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.generation import Generator
    from gesture_diffusion_torch.models import build_all
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.training import (Trainer, iter_batches,
                                                  make_optimizer, make_train_step)
    from gesture_diffusion_torch.utils import JsonConfig

    cfg = JsonConfig(os.path.join(REPO, "configs", "beat-ours.json"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dtype_")

    def bundle(device=dev, **kw):
        return build_all(cfg, D_POSE, device=device,
                         generator=torch.Generator().manual_seed(0), **kw)

    # -- [dtype-train]: windows/s of the three settings, one call ------------
    train_ds = synthetic_training_set(TRAIN_BATCH * TRAIN_BATCHES, 120)
    val_ds = synthetic_training_set(TRAIN_BATCH, 121)
    block = list(iter_batches(train_ds, TRAIN_BATCH, shuffle=False))
    trained = None
    for i, (label, kw) in enumerate((("f32", {}),
                                     ("bf16 encoder", dict(encoder_dtype="bfloat16")),
                                     ("Train.dtype bf16", dict(dtype="bfloat16")))):
        b = bundle(**kw)
        trainer = Trainer(b.model, b.schedule, *make_optimizer(b.model, cfg.Train),
                          train_ds, val_ds, TRAIN_BATCH,
                          os.path.join(tmp.name, f"run{i}"), seed=0, device=dev)
        trainer.train_steps(block)          # first calls: cuDNN plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        metrics = trainer.train_steps(block)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(block)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        losses = [float(m["loss"]) for m in metrics]
        log(f"[dtype-train] beat-ours {label}, batch {TRAIN_BATCH}: "
            f"{TRAIN_BATCH * 1e3 / ms:.1f} windows/s ({ms:.2f} ms a step over "
            f"{len(block)} steps queued, one synchronise, after a first block), "
            f"peak {peak:.0f} MB allocated; losses "
            + " ".join(f"{x:.4f}" for x in losses) + f" (TF32 off) [{smi}]")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{label} training gave a non-finite loss")
        if kw.get("dtype"):
            trained = b
        del trainer

    # -- [dtype-vs-cpu]: one bf16 step at batch 4, card and CPU, against the
    # CPU's float64 step ---------------------------------------------------------
    weights = {k: v.detach().cpu() for k, v in bundle().model.state_dict().items()}
    ds4 = synthetic_training_set(4 * DTYPE_DRAWS, 122)
    sched = trained.schedule
    found = {"card": [], "cpu": []}
    for i in range(DTYPE_DRAWS):
        batch = {k: torch.from_numpy(v[4 * i:4 * i + 4]) for k, v in ds4.data.items()}
        g = torch.Generator().manual_seed(123 + i)
        t = torch.randint(0, 1000, (4,), generator=g)
        noise = torch.randn(batch["pose"].shape, generator=g)
        runs = {}
        with shared_mel(batch["wav"]):
            for name, d, dtype, kw in (
                    ("card", dev, torch.float32, dict(dtype="bfloat16")),
                    ("cpu", torch.device("cpu"), torch.float32, dict(dtype="bfloat16")),
                    ("f64", torch.device("cpu"), torch.float64, {})):
                model = bundle(torch.device("cpu"), **kw).model
                model.load_state_dict(weights)
                model.to(d, dtype)
                step = make_train_step(model, sched.to(d), *make_optimizer(model, cfg.Train))
                m = step({"wav": batch["wav"].to(d), "pose": batch["pose"].to(d, dtype)},
                         0, t=t.to(d), noise=noise.to(d, dtype))
                runs[name] = ({k: float(v) for k, v in m.items()},
                              {k: p.grad.detach().cpu() for k, p in model.named_parameters()})
        ref_m, ref_g = runs["f64"]
        groups = _grad_groups(list(ref_g))
        for side in ("card", "cpu"):
            m, grads = runs[side]
            found[side].append(dict(
                **{k: abs(m[k] - v) / abs(v) for k, v in ref_m.items() if k != "grad_norm"},
                **{f"grad {g_}": _l2(grads, ref_g, sel) for g_, sel in groups.items()},
                **{f"norm {g_}": _norm_ratio(grads, ref_g, sel)
                   for g_, sel in groups.items()}))
    mean = {side: {k: float(np.mean([f[k] for f in rows])) for k in rows[0]}
            for side, rows in found.items()}
    failures = []
    for k, v in mean["card"].items():
        if k.startswith("norm"):
            if k != "norm trunk body" and not all(
                    DTYPE_NORM_BAND[0] <= f[k] <= DTYPE_NORM_BAND[1] for f in found["card"]):
                failures.append(k)
            continue
        bar = DTYPE_RATIO * mean["cpu"][k]
        if not k.startswith("grad"):
            bar = max(bar, DTYPE_FLOOR)
        if v > bar:
            failures.append(k)
    log(f"[dtype-vs-cpu] beat-ours Train.dtype bf16, batch 4, TF32 off, one mel, "
        f"mean of {DTYPE_DRAWS} draws of t and noise, against the CPU's float64 "
        f"step (loss terms rel, gradient groups |d|/|ref|, norms |g|/|ref|): "
        + ", ".join(f"{k} card {v:.3e} / CPU {mean['cpu'][k]:.3e}"
                    for k, v in mean["card"].items())
        + f"; bar {DTYPE_RATIO:g}x the CPU's (losses floored at 2^-8), norms "
        f"outside the trunk body in {DTYPE_NORM_BAND} [{smi}]")
    if failures:
        raise AssertionError(f"the card's bf16 step is off the CPU's: {failures}")

    # -- [dtype-serve]: the bf16-trained model through the kernel and the scan
    s50, t50 = make_diffusion("linear", 1000, "ddim50")
    wav = seeded_audio(124, 8, WINDOW / FPS)
    noise50 = torch.randn(8, WINDOW, D_POSE, generator=torch.Generator(device=dev)
                          .manual_seed(125), device=dev)
    fused = Generator(trained.model, s50, t50, device=dev)
    scan = Generator(trained.model, s50, t50, use_fused=False, device=dev)
    reset_counts()
    a = fused.generate_sample(wav, D_POSE, WINDOW, noise=noise50)
    torch.cuda.synchronize()
    launches, rows = fs.launches, counted("ddim")
    b_ = scan.generate_sample(wav, D_POSE, WINDOW, noise=noise50)
    log(f"[dtype-serve] the Train.dtype bf16 model after {2 * TRAIN_BATCHES} "
        f"steps, ddim50 batch 8: fused kernel ({launches} launch, f32 weights "
        f"packed as for any model) and the scan path in bf16, max|d|/max|ref| "
        f"{rel(b_, a):.3e} between them; finite {bool(torch.isfinite(a).all())}, "
        f"{bool(torch.isfinite(b_).all())}")
    with torch.no_grad():
        args = fused.fused_args(torch.from_numpy(wav).to(dev), D_POSE, WINDOW, noise50)
    check("ddim", "Train.dtype bf16-trained, batch 8", args)
    if launches != 1 or not (torch.isfinite(a).all() and torch.isfinite(b_).all()):
        raise AssertionError("the bf16-trained model does not serve")

    # -- [dtype-tedexp]: the scan step in bf16 beside f32 ---------------------
    ted = JsonConfig(os.path.join(REPO, "configs", "tedexp-ours.json"))
    ted_pose = 126
    ted_window, ted_fps = 34, 15
    row = []
    for label, kw in (("f32", {}), ("bf16", dict(dtype="bfloat16"))):
        tb = build_all(ted, ted_pose, device=dev,
                       generator=torch.Generator().manual_seed(0), **kw)
        gen = Generator(tb.model, s50, t50, use_fused=False, device=dev)
        for n in TED_DTYPE_BATCHES:
            w = seeded_audio(126, n, ted_window / ted_fps)
            z = torch.randn(n, ted_window, ted_pose, device=dev)
            gen.generate_sample(w, ted_pose, ted_window, noise=z)   # first call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gen.generate_sample(w, ted_pose, ted_window, noise=z)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 50
            row.append(f"{label} batch {n} {ms:.2f}")
            if not torch.isfinite(out).all():
                raise AssertionError(f"tedexp {label} sample is not finite")
        del tb, gen
    log(f"[dtype-tedexp] tedexp-ours at full width, the scan sampler, ms a "
        f"step (ddim50 generate_sample over 50, after a first call): "
        + "; ".join(row) + f" [{smi}]")
    tmp.cleanup()
    return rows


# -- phase 16: a JAX checkpoint served by the port ---------------------------------
JAX_CHKPT_BAR = 1e-4     # the card's scan sample against JAX's, TF32 off


def jax_chkpt_paths(smi, dev, check) -> dict:
    """Phase 16: the committed JAX checkpoint (``tests/fixtures/jax_chkpt``,
    written by the JAX package's ``save_checkpoint``) through the port's
    eval-time and gen phases on the card and against the JAX sample
    recorded beside it.  Returns the fused launches by row of the kernels
    line (``counted``); raises on any failed check."""
    import contextlib
    import io
    import lzma
    import pickle
    import shutil
    import tempfile

    from gesture_diffusion_torch import cli
    from gesture_diffusion_torch.generation import Generator
    from gesture_diffusion_torch.interop import flax_msgpack, jax_checkpoint_state_dict
    from gesture_diffusion_torch.models import build_all
    from gesture_diffusion_torch.ops import fused_sampler as fs
    from gesture_diffusion_torch.utils import JsonConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fixture = os.path.join(REPO, "tests", "fixtures", "jax_chkpt")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_jax_chkpt_")
    root = tmp.name
    with open(os.path.join(fixture, "config.json")) as f:
        raw = json.load(f)
    for key in ("spt_dir_path", "dst_dir_path", "hierarchy_path"):
        raw["Data"][key] = os.path.join(root, raw["Data"][key])
    raw["Meta"]["log_dir"] = os.path.join(root, raw["Meta"]["log_dir"])
    run = os.path.join(raw["Meta"]["log_dir"], raw["Meta"]["name"])
    chkpts = os.path.join(run, "chkpts")
    os.makedirs(chkpts)
    msgpack_path = os.path.join(chkpts, "chkpt_seed0.msgpack")
    with lzma.open(os.path.join(fixture, "chkpt_seed0.msgpack.xz")) as src, \
            open(msgpack_path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    shutil.copy(os.path.join(fixture, "chkpt_seed0.msgpack.meta.json"), chkpts)
    with open(raw["Data"]["hierarchy_path"], "w") as f:
        f.write(cli.hierarchy_template(
            os.path.join(REPO, "tests", "golden", "synth_fullbody.bvh"),
            raw["Data"]["joints"], raw["Data"]["hierarchy_extra_joints"]))
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    launches, times, printed, rows = {}, {}, {}, {}
    for phase in ("prep", "data", "eval-time", "gen"):
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["--phase", phase, "--config", cfg_path])
        torch.cuda.synchronize()
        times[phase], launches[phase] = time.perf_counter() - t0, fs.launches
        if phase in ("eval-time", "gen"):
            counted("ddim", rows)
        printed[phase] = out.getvalue()
    samples = os.path.join(run, "results", "samples")
    outs = [pickle.load(open(os.path.join(samples, f), "rb"))["out"]
            for f in sorted(os.listdir(samples))]
    log(f"[jax-chkpt] the JAX package's checkpoint (chkpt_seed0.msgpack, "
        f"{os.path.getsize(msgpack_path)} bytes, no .pt beside it) through the "
        f"port's CLI on the card: "
        + ", ".join(f"{p} {s:.2f} s" for p, s in times.items())
        + f"; fused launches eval-time {launches['eval-time']}, gen "
        f"{launches['gen']}; {len(outs)} generated sequences "
        f"{[o.shape for o in outs]} [{smi}]")
    if ("Load the JAX package's chkpt" not in printed["gen"]
            or "path=fused" not in printed["eval-time"]
            or not launches["eval-time"] or not launches["gen"]
            or len(outs) != 2 or not all(np.isfinite(o).all() for o in outs)):
        raise AssertionError("the JAX checkpoint did not serve through the CLI")

    # the recorded JAX sample, and the kernel at its shapes
    config = JsonConfig(cfg_path)
    bundle = build_all(config, 12, device=dev)
    variables = jax_checkpoint_state_dict(flax_msgpack.load(msgpack_path),
                                          bundle.model.cfg)
    rec = np.load(os.path.join(fixture, "sample.npz"))
    wav = torch.from_numpy(rec["wav"]).to(dev)
    noise = torch.from_numpy(rec["noise"]).to(dev)
    scan = Generator(bundle.model, bundle.eval_schedule, bundle.eval_timestep_map,
                     use_fused=False, device=dev)
    scan.update_variables(variables)
    ours = scan.generate_sample(wav, 12, noise.shape[1], noise=noise)
    r = rel(ours.cpu(), torch.from_numpy(rec["sample"]))
    log(f"[jax-chkpt] the card's scan sample (ddim50, batch 2, TF32 off) on the "
        f"checkpoint's weights against the JAX Generator's recorded sample: "
        f"max|d|/max|ref| {r:.3e} (bar {JAX_CHKPT_BAR:.0e}) [{smi}]")
    fused = Generator(bundle.model, bundle.eval_schedule, bundle.eval_timestep_map,
                      device=dev)
    fused.update_variables(variables)
    with torch.no_grad():
        args = fused.fused_args(wav, 12, noise.shape[1], noise)
    check("ddim", "the JAX checkpoint, batch 2", args)
    if r > JAX_CHKPT_BAR:
        raise AssertionError("the port serves the JAX checkpoint off JAX's sample")
    tmp.cleanup()
    return rows


LATER_PHASES = {"multi": multi_paths, "tp": tp_paths, "dtype": dtype_paths,
                "jax-chkpt": jax_chkpt_paths}


def bits_phase(smi, dev, gen, ref_so: str, batch_inputs) -> dict:
    """Phase 4b: the package's bf16 instantiation against the bf16-only
    source (``BF16_ONLY``, built in phase 1) on the same inputs, bit for
    bit: the flagship's weights through ``gen`` (bf16 at every batch),
    ddim50 DDIM with the identity blend and DDPM with the x0 blend, batches
    1 and 64, at the planned and at every forced cluster size.  Its
    launches are comparisons: it leaves the launch counts as it found
    them.  Raises unless every output is bit-equal."""
    import ctypes
    import re

    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.generation import Generator
    from gesture_diffusion_torch.ops import fused_sampler as fs

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from fused_ddim_compare import _Interface

    with open(BF16_ONLY) as f:
        n_dims = int(re.search(r"#define N_DIMS (\d+)", f.read()).group(1))
    own = fs._library()
    ref = _Interface(fs.bind_library(ctypes.CDLL(ref_so)), n_dims)
    s50, t50 = make_diffusion("linear", 1000, "ddim50")
    g = Generator(gen.model, s50, t50, fused_dtype=torch.bfloat16, device=dev)
    counts = fs.launches, dict(fs.launches_by_dtype)
    equal = {}
    try:
        for n in (1, 64):
            for alg, blend in (("ddim", False), ("ddpm", True)):
                wav, noise, ip, im, ramp = batch_inputs(n, 60 + n, blend)
                with torch.no_grad():
                    args = g.fused_args(wav, D_POSE, WINDOW, noise, ip, im, ramp,
                                        sample_alg=alg,
                                        seed=torch.tensor([2468 + n], device=dev))
                    for c in (None,) + fs.CLUSTER_SIZES:
                        outs = []
                        for lib in (ref, own):
                            fs._LIB = lib
                            outs.append(fs._fused_ddim_cuda(**args, cluster=c))
                        torch.cuda.synchronize()
                        equal[f"{alg} batch {n} C {c or 'planned'}"] = \
                            torch.equal(*outs)
    finally:
        fs._LIB = own
        fs.launches, fs.launches_by_dtype = counts[0], counts[1]
    log(f"[kernel-bits] bf16 instantiation against "
        f"{os.path.relpath(BF16_ONLY, REPO)} (ddim50; DDIM identity, DDPM "
        f"x0-blend; batches 1, 64; planned and forced C): bit-equal in "
        f"{sum(equal.values())} of {len(equal)}"
        + ("" if all(equal.values()) else
           f"; differ: {[k for k, v in equal.items() if not v]}") + f" [{smi}]")
    if not all(equal.values()):
        raise AssertionError("the bf16 instantiation is not bit-equal to the "
                             "bf16-only source")
    return equal


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="+",
                        choices=("corpus", "tedexp", "mmdit", "decoders", "mocap",
                                 "zoo", "multi", "tp", "dtype", "jax-chkpt"),
                        help="run only these phases (no kernel phases; "
                        "corpus builds the kernel for its gen) and print no "
                        "result line: for trying a phase")
    args = parser.parse_args(argv)
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
    if args.only:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for name in args.only:
            t0 = time.perf_counter()
            if name == "corpus":
                corpus_paths(smi, make_check({}, {}))
            elif name in LATER_PHASES:
                LATER_PHASES[name](smi, dev, make_check({}, {}))
            else:
                {"tedexp": tedexp_paths, "mmdit": mmdit_paths,
                 "decoders": decoder_paths, "mocap": mocap_paths,
                 "zoo": zoo_paths}[name](smi, dev)
            log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")
        log(f"[done] {time.perf_counter() - t_start:.1f} s (--only: no result line)")
        return 0

    # -- phase 1: build ------------------------------------------------------
    # the package's source (both instantiations) and, beside it, the
    # bf16-only source that phase 4b holds the bf16 instantiation to; one
    # nvcc each, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref_build = pool.submit(
            kernel_build._build, "fused_ddim_bf16_only", pathlib.Path(BF16_ONLY),
            kernel_build.BUILD_DIR, kernel_build._nvcc, kernel_build.NVCC_FLAGS)
        fs._library()
        ref_so = str(ref_build.result())
    path, secs, ptxas = kernel_build.BUILD_INFO["fused_ddim"]
    log(f"[build] fused_ddim: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {secs:.1f} s) -> {os.path.relpath(path, REPO)}; "
        f"{os.path.relpath(BF16_ONLY, REPO)} built beside it (nvcc "
        f"{kernel_build.BUILD_INFO['fused_ddim_bf16_only'][1]:.1f} s) -> "
        f"{os.path.relpath(ref_so, REPO)}")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")
    lib = fs._library()
    for f32 in (False, True):
        for t in (8, WINDOW, 49, 64):
            for c in fs.CLUSTER_SIZES:
                nbytes, fc, half = fs.smem_plan(t, 256, 128, 1024, f32, c)
                if nbytes != lib.fused_ddim_smem_bytes(
                        t, 256, 128, fc, int(half), int(f32), c) or (
                        f32 and fs.attention_shared(t, 256, 128, fc, half, c)
                        != bool(lib.fused_ddim_attention_shared(
                            t, 256, 128, fc, int(half), c))):
                    raise AssertionError("Python and CUDA shared-memory plans "
                                         f"disagree at T {t}, C {c}")
        for t in (0, WINDOW):
            if fs.scratch_elems(92, 256, 4, t) != \
                    lib.fused_ddim_scratch_elems(92, 256, 4, t):
                raise AssertionError("Python and CUDA scratch sizes disagree")
        plan = {c: fs.smem_plan(WINDOW, 256, 128, 1024, f32, c)
                for c in fs.CLUSTER_SIZES}
        occupancy = {c: fs.max_clusters(lib, c, plan[c][0], dev, f32)
                     for c in fs.CLUSTER_SIZES}
        plans = {n: fs.cluster_plan(n, 8, occupancy.__getitem__)
                 for n in (1, 3, 16, 17, 33, 64, 67, 128)}
        where = {c: ("shared" if fs.attention_shared(WINDOW, 256, 128, fc, half, c)
                     else "global") for c, (_, fc, half) in plan.items()}
        log(f"[build] {'float32' if f32 else 'bf16'} instantiation at T "
            f"{WINDOW}: bytes a block by C {({c: b for c, (b, _, _) in plan.items()})}"
            + (f", attention operands by C {where}" if f32 else "")
            + f"; clusters of C blocks the card runs at once: {occupancy}; "
            f"planned C by batch: {plans}")
        for n, c in plans.items():
            if lib.fused_ddim_cluster_size(n, 8, WINDOW, 256, 128, 1024,
                                           int(f32)) != c:
                raise AssertionError(f"Python and CUDA cluster plans disagree "
                                     f"at batch {n}")

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
    # the bf16 instantiation through Generators that compute in bf16 at
    # every batch; the float32 one on the same bf16 packs and on f32 packs
    s50, t50 = make_diffusion("linear", 1000, "ddim50")
    g50 = {mt: Generator(b.model, s50, t50, use_fused=True,
                         fused_dtype=torch.bfloat16, device=dev)
           for mt, b in bundles.items()}
    g50w = {mt: Generator(b.model, s50, t50, use_fused=True,
                          fused_dtype=torch.float32, device=dev)
            for mt, b in bundles.items()}
    scan50 = Generator(model, s50, t50, use_fused=False, device=dev)
    worst = {}               # variant -> [worst relative, worst absolute]
    worst_c = {}             # cluster size -> worst relative

    check = make_check(worst, worst_c)

    # the further variants: (variant, label, model type, blend, DDPM,
    # hand-made x_add)
    cases = (("x_add", "x_add + x0-blend (n_mem 32)", "s2g_v2", True, False, True),
             ("stochastic", "DDPM identity (n_mem 32)", "s2g_v2", False, True, False),
             ("stochastic", "DDPM x0-blend (n_mem 32)", "s2g_v2", True, True, False),
             ("long", "DDIM identity, default type (n_mem 92)", "default", False,
              False, False),
             ("x_add", "DDPM + x0-blend + x_add, inpaint type (n_mem 92)",
              "inpaint", True, True, False))

    def variant_checks(gmap, compute, batches):
        """Every variant at every batch of ``batches`` through ``check``,
        with ``compute`` as the compute dtype (bf16 also against the f32
        scan sampler)."""
        for n in batches:
            for blend in (False, True):
                wav, noise, ip, im, ramp = batch_inputs(n, 10 + n, blend)
                with torch.no_grad():
                    args = gmap["s2g_v2"].fused_args(wav, D_POSE, WINDOW, noise,
                                                     ip, im, ramp)
                args["compute_dtype"] = compute
                scan = None
                if compute == torch.bfloat16:
                    scan = scan50.generate_sample(
                        wav, D_POSE, WINDOW, noise=noise, inpaint_poses=ip,
                        inpaint_masks=im,
                        trans_factor=TRANS_FACTOR if blend else None,
                        pose_seed_len=SEED_LEN)
                check("ddim", f"batch {n:2d} {'x0-blend' if blend else 'identity'}",
                      args, scan)
        for variant, label, mt, blend, ddpm, hand_xadd in cases:
            for n in batches:
                wav, noise, ip, im, ramp = batch_inputs(n, 40 + n, blend)
                with torch.no_grad():
                    args = gmap[mt].fused_args(
                        wav, D_POSE, WINDOW, noise, ip, im, ramp,
                        sample_alg="ddpm" if ddpm else "ddim",
                        seed=torch.tensor([1234 + n], device=dev))
                args["compute_dtype"] = compute
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

    variant_checks(g50, torch.bfloat16, (1, 3, 64))
    bf16_worst = {k: w for k, w in worst.items()}
    worst_all = max(w[0] for w in bf16_worst.values())
    log(f"[kernel-vs-plain] bar {KERNEL_BAR:.0e} (max|d|/max|ref|), worst "
        f"{worst_all:.3e}; by variant: "
        + ", ".join(f"{k} {w[0]:.3e}" for k, w in bf16_worst.items())
        + "; by forced cluster size: "
        + ", ".join(f"C={c} {w:.3e}" for c, w in worst_c.items()))

    # the float32 instantiation: its bar from the plain version's own
    # distance between the card and the CPU (float32, TF32 off), then every
    # variant on a bf16 pack (the JAX default at one or two clips a device)
    # and on an f32 pack (fused_dtype=float32)
    wav, noise, _, _, _ = batch_inputs(3, 13, False)
    with torch.no_grad():
        args = g50["s2g_v2"].fused_args(wav, D_POSE, WINDOW, noise)
        args["compute_dtype"] = torch.float32
        on_card = fs.fused_ddim_sample_plain(**args)
        cpu_args = {k: (v.cpu() if torch.is_tensor(v) else v)
                    for k, v in args.items()}
        cpu_args["packed"] = fs.PackedDenoiser(*(t.cpu() for t in args["packed"]))
        on_cpu = fs.fused_ddim_sample_plain(**cpu_args)
    plain_gap = rel(on_card.cpu(), on_cpu)
    f32_bar[0] = 2 * plain_gap if plain_gap > F32_FLOOR else F32_BAR
    log(f"[kernel-vs-plain] float32 compute: the plain version on the card "
        f"against the CPU (batch 3, ddim50, bf16 weights, TF32 off) "
        f"max|d|/max|ref| {plain_gap:.3e}; the bar {f32_bar[0]:.3e} ({F32_BAR:.0e}, "
        f"or twice that distance where it is over {F32_FLOOR:.0e})")
    worst_c.clear()
    variant_checks(g50, torch.float32, (1, 3, 64))
    variant_checks(g50w, torch.float32, (1, 3, 64))
    log(f"[kernel-vs-plain] float32 compute, bar {f32_bar[0]:.3e}: worst on "
        f"bf16 weights {worst['f32'][0]:.3e}, on f32 weights "
        f"{worst['f32w'][0]:.3e}; by forced cluster size: "
        + ", ".join(f"C={c} {w:.3e}" for c, w in worst_c.items()))

    # the kernel's noise: one step with coefficients (0, 0, 0, 0, 1) gives z,
    # in each instantiation (bf16; float32 on bf16 and on f32 weights)
    with torch.no_grad():
        wav, noise, _, _, _ = batch_inputs(64, 77, False)
        zc = {}
        for tag, g, compute in (("bf16", g50, torch.bfloat16),
                                ("f32", g50, torch.float32),
                                ("f32w", g50w, torch.float32)):
            args = g["s2g_v2"].fused_args(wav, D_POSE, WINDOW, noise,
                                          sample_alg="ddpm",
                                          seed=(9 << 32) | 4242)
            args.update(tmap=args["tmap"][:1], num_steps=1, coefs=torch.tensor(
                [[0.0, 0.0, 0.0, 0.0, 1.0]], device=dev), compute_dtype=compute)
            if tag == "bf16":
                z = fs.fused_ddim_sample(**args)
            for c in fs.CLUSTER_SIZES:
                zc[tag, c] = fs._fused_ddim_cuda(**args, cluster=c)
        zp = fs.fused_noise((9 << 32) | 4242, 0, 64, WINDOW, z.shape[2], dev)
    z_equal = {k: bool(torch.equal(v, zp)) for k, v in zc.items()}
    log(f"[kernel-noise] z equals the plain version's bit for bit, by "
        f"instantiation and forced cluster size: {z_equal}")
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
    # the bf16 rows through Generators that compute in bf16 at every batch;
    # the float32 rows on the flagship's bf16 pack (compute set to float32)
    # and on its f32 pack (fused_dtype=float32)
    gens = {mt: Generator(b.model, b.eval_schedule, b.eval_timestep_map,
                          device=dev) for mt, b in bundles.items()}
    gen = gens["s2g_v2"]
    gens_bf16 = {mt: Generator(b.model, b.eval_schedule, b.eval_timestep_map,
                               fused_dtype=torch.bfloat16, device=dev)
                 for mt, b in bundles.items()}
    gen_f32w = Generator(model, bundle.eval_schedule, bundle.eval_timestep_map,
                         fused_dtype=torch.float32, device=dev)
    timings = {}
    for variant, g, blend, alg, compute in (
            ("ddim", gens_bf16["s2g_v2"], False, "ddim", torch.bfloat16),
            ("long", gens_bf16["default"], False, "ddim", torch.bfloat16),
            ("stochastic", gens_bf16["s2g_v2"], False, "ddpm", torch.bfloat16),
            ("x_add", gens_bf16["inpaint"], True, "ddpm", torch.bfloat16),
            ("f32", gens_bf16["s2g_v2"], False, "ddim", torch.float32),
            ("f32w", gen_f32w, False, "ddim", torch.float32)):
        mt = g.model.cfg.model_type
        for n in (1, 64):
            wav, noise, ip, im, ramp = batch_inputs(n, 20 + n, blend)
            with torch.no_grad():
                args = g.fused_args(wav, D_POSE, WINDOW, noise, ip, im,
                                    ramp, sample_alg=alg, seed=5)
                args["compute_dtype"] = compute
                ms = cuda_ms(lambda: fs.fused_ddim_sample(**args),
                             reps=2 if compute == torch.bfloat16 else 1)
                cluster = fs.last_cluster
                placed = fs.last_plan["attention"]
                # the plain version's code is warm from phase 3
                plain = cuda_ms(lambda: fs.fused_ddim_sample_plain(**args),
                                reps=1, warmup=False)
            b, by, every = bound_ms(args)
            timings[variant, n] = dict(ms=ms, plain_ms=plain, bound_ms=b,
                                       bound_by=by, cluster=cluster,
                                       attention=placed)
            weights = str(args["packed"].w_embx.dtype).replace("torch.", "")
            log(f"[kernel-time] {mt} {alg}{' x0-blend' if blend else ''}, n_mem "
                f"{args['mem_rows'].shape[1]}, compute "
                f"{str(compute).replace('torch.', '')} on {weights} weights, "
                f"batch {n:2d}, 1000 steps: kernel "
                f"{ms:.3f} ms (clusters of {cluster}, attention operands in "
                f"{placed}), plain {plain:.3f} ms, bound {b:.3f} ms ({by}; "
                f"{every:.3f} ms with the memory K/V counted on every step) "
                f"[{smi}]")

    # -- phase 4b: the bf16 instantiation against the bf16-only source -------
    bits_phase(smi, dev, gens_bf16["s2g_v2"], ref_so, batch_inputs)

    # -- phase 5: the main paths ---------------------------------------------
    # launches by row of the kernels line (``counted``): each path's, its
    # counts set to 0 just before it (comparisons leave them as they were)
    launches = {}
    used = {}                # (variant, batch) -> cluster size of the launch
    rows = ("ddim", "long", "stochastic", "x_add", "f32", "f32w")

    def instantiations() -> str:
        """The instantiations launched since the counts were reset."""
        return ", ".join(
            f"{str(c).replace('torch.', '')} compute on "
            f"{str(w).replace('torch.', '')} weights x{k}"
            for (c, w), k in fs.launches_by_dtype.items())

    def gate(where: str):
        missing = [r for r in rows if not launches.get(r)]
        log(f"[launches] {where}, by row of the kernels line (the bf16 "
            f"instantiation by variant; f32 and f32w the float32 one on bf16 "
            f"and on f32 weights): {launches}")
        if missing:
            raise AssertionError(f"{where} launched no kernel of the rows "
                                 f"{missing}")

    def sample_path(variant, mt, alg, batches, blend, g=None, tag=""):
        """generate_sample at 1000 steps: 1 warm-up, 3 timed, 1 checked;
        through ``gens[mt]`` (the default policy) unless ``g`` is given."""
        g = gens[mt] if g is None else g
        for n in batches:
            wav = seeded_audio(30 + n, n, WINDOW / FPS)
            kw = seed_kw(n) if blend else {}

            def call():
                return g.generate_sample(wav, D_POSE, WINDOW, generator=gen_seed,
                                         sample_alg=alg, **kw)

            reset_counts()
            mean_ms, std_ms, _ = host_ms(call)
            out = call()
            launched = fs.launches
            counted(variant, launches)
            used[variant, n] = fs.last_cluster
            ok = (g.last_sample_path == "fused"
                  and tuple(out.shape) == (n, WINDOW, D_POSE)
                  and bool(torch.isfinite(out).all()))
            log(f"[generate_sample] {mt} {alg}{' x0-blend' if blend else ''}"
                f"{tag}, batch {n:2d}, 1000 steps: {mean_ms:.1f} ms (std "
                f"{std_ms:.1f}, {1e6 / mean_ms:.0f} steps/s), last_sample_path="
                f"{g.last_sample_path}, kernel launches +{launched} "
                f"({instantiations()}), clusters of {fs.last_cluster} [{smi}]")
            if not ok or launched != 5:
                raise AssertionError(
                    f"generate_sample {mt} {alg} batch {n} did not run the fused "
                    f"kernel as expected (launches {launched})")

    sample_path("ddim", "s2g_v2", "ddim", (1, 64), False)
    log(f"[cluster] blocks per clip on the main path: batch 1 "
        f"C={used['ddim', 1]}, batch 64 C={used['ddim', 64]}")
    if used["ddim", 1] < 2 or used["ddim", 64] < 2:
        raise AssertionError("the main path did not launch clusters of more "
                             "than one block at batches 1 and 64")
    # batch 1 with the compute dtype set: bf16 (the bf16 instantiation) and
    # float32 (the float32 one on f32 weights), beside the default above
    sample_path("ddim", "s2g_v2", "ddim", (1,), False, gens_bf16["s2g_v2"],
                " fused_dtype=bfloat16")
    sample_path("ddim", "s2g_v2", "ddim", (1,), False, gen_f32w,
                " fused_dtype=float32")

    reset_counts()
    wav_long = seeded_audio(50, 2, 10.0)
    init = 0.5 * torch.randn(2, SEED_LEN, D_POSE, generator=gen_seed,
                             device=dev).cpu().numpy()
    t0 = time.perf_counter()
    seq = gen.generate_sequence(wav_long, SR, D_POSE, FPS, WINDOW, SEED_LEN,
                                generator=gen_seed, trans_factor=TRANS_FACTOR,
                                init_poses=init, smooth_trans=False)
    seq_s = time.perf_counter() - t0
    log(f"[generate_sequence] 2 clips x 10 s: {seq_s * 1e3:.1f} ms, output "
        f"{seq.shape}, kernel launches +{fs.launches} ({instantiations()}; "
        f"x0-blend branch) [{smi}]")
    if seq.shape != (2, 200, D_POSE) or not np.isfinite(seq).all() \
            or fs.launches != 7:
        raise AssertionError("generate_sequence did not give 7 fused windows of "
                             "finite poses")
    counted("ddim", launches)

    sample_path("long", "default", "ddim", (1, 64), False)
    sample_path("x_add", "inpaint", "ddpm", (1, 64), True)
    sample_path("stochastic", "s2g_v2", "ddpm", (1, 64), False)

    # streaming: the same windows as generate_sequence, pushed in 0.5 s chunks
    noises = [torch.randn(2, WINDOW, D_POSE, generator=gen_seed, device=dev)
              for _ in range(7)]
    kw = dict(noise_fn=lambda b0, d: noises[d], trans_factor=TRANS_FACTOR,
              init_poses=init)
    reset_counts()
    t0 = time.perf_counter()
    offline = gen.generate_sequence(wav_long, SR, D_POSE, FPS, WINDOW, SEED_LEN,
                                    **kw)
    offline_s, offline_launches = time.perf_counter() - t0, fs.launches
    counted("ddim", launches)
    reset_counts()
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
    counted("ddim", launches)
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

    # bpd: plain torch ops only, no hand-written kernel on this path
    poses = 0.5 * torch.randn(8, WINDOW, D_POSE, generator=gen_seed, device=dev)
    wav8 = seeded_audio(60, 8, WINDOW / FPS)
    reset_counts()
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

    gate("phase 5")

    # -- phase 6: training -----------------------------------------------------
    t0 = time.perf_counter()
    train_paths(dev, smi)
    log(f"[train] phase took {time.perf_counter() - t0:.1f} s")

    # -- phase 7: the phase CLI ----------------------------------------------
    t0 = time.perf_counter()
    counts = cli_paths(smi, check)
    for row, k in counts.items():
        launches[row] += k
    log(f"[cli] phase took {time.perf_counter() - t0:.1f} s")

    # -- phase 8: the corpus ends of a user's run -----------------------------
    t0 = time.perf_counter()
    counts, generated = corpus_paths(smi, check)
    for row, k in counts.items():
        launches[row] += k
    log(f"[corpus] phase took {time.perf_counter() - t0:.1f} s")

    # -- phase 9: TED-Expressive; phase 10: the GCN and UNet decoders --------
    t0 = time.perf_counter()
    tedexp_paths(smi, dev)
    log(f"[tedexp] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gemm_row = mmdit_paths(smi, dev)
    log(f"[mmdit] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    decoder_paths(smi, dev)
    log(f"[decoders] phase took {time.perf_counter() - t0:.1f} s")

    # -- phase 11: the pymo mocap stack; phase 12: the model zoo ---------------
    t0 = time.perf_counter()
    mocap_paths(smi, dev, generated)
    log(f"[mocap] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zoo_paths(smi, dev)
    log(f"[zoo] phase took {time.perf_counter() - t0:.1f} s")

    # -- phases 13 to 16: data and tensor parallelism, Train.dtype, a JAX
    # checkpoint; each main path's launches counted from 0 in its phase ----
    for name, paths in LATER_PHASES.items():
        t0 = time.perf_counter()
        for row, k in paths(smi, dev, check).items():
            launches[row] += k
        log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")

    gate("the main paths of phases 5-16")
    what = {
        "ddim": ("fused_ddim_sample", f"{TPU_KERNEL}:705",
                 "s2g_v2, DDIM, T 40, n_mem 32"),
        "long": ("fused_ddim_sample[long memory]", f"{TPU_KERNEL}:314",
                 "default type, DDIM, T 40, n_mem 92"),
        "stochastic": ("fused_ddim_sample[stochastic]", f"{TPU_KERNEL}:535",
                       "s2g_v2, DDPM, T 40, n_mem 32"),
        "x_add": ("fused_ddim_sample[x_add]", f"{TPU_KERNEL}:474",
                  "inpaint type, DDPM, x0 blend, x_add, T 40, n_mem 92"),
        "f32": ("fused_ddim_sample[float32 compute, bf16 weights]",
                f"{TPU_KERNEL}:578", "s2g_v2, DDIM, T 40, n_mem 32"),
        "f32w": ("fused_ddim_sample[float32 compute, f32 weights]",
                 f"{TPU_KERNEL}:578", "s2g_v2, DDIM, T 40, n_mem 32"),
    }
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "gesture_diffusion_torch/csrc/fused_ddim.cu",
        "replaces": replaces,
        "launches": launches[variant],
        "max_abs_err": worst[variant][1],
        "max_rel_err": worst[variant][0],
        "bar": f32_bar[0] if variant.startswith("f32") else KERNEL_BAR,
        **timings[variant, 64],
        "library_ms": None,
        "shape": f"batch 64, {shape}, 1000 steps",
        "batch1": timings[variant, 1],
    } for variant, (name, replaces, shape) in what.items()] + [gemm_row]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
