"""Where the flagship train step's time goes, on one NVIDIA GPU.

Builds ``configs/beat-ours.json`` at full width with seeded random weights
(d_pose 123, 40-frame windows of 32 000 samples, batch ``--batch``) and,
for each encoder dtype, runs ``make_train_step`` itself:

  * the step's wall time: ``--steps`` steps queued without a synchronise
    and one at the end, and the median of steps each ended by one;
  * a ``torch.profiler`` trace of ``--steps`` steps: the host time of the
    step's three ranges (``train_step/forward``, ``/backward``,
    ``/optimizer``), the kernels launched per step, the device's busy time
    per step (the sum of kernel times) and the top kernels and host
    operators; the full tables go to ``--out``.

    python3 -m gesture_diffusion_torch.training.step_profile [--batch 64]
        [--steps 5] [--encoder-dtype bfloat16 none] [--out chiprun_out]

With ``--ddp`` it prices the data-parallel step at world size 1 instead
(a process group of one over NCCL), by parts: four variants of the step,
built side by side under the group and timed in turns over 5 windows
of ``--steps`` queued steps each,

  * plain: the single-process step (no DDP, the local BatchNorm);
  * DDP: the data-parallel step as training runs it;
  * DDP, local BN: the DDP wrapper and its reducer with the local
    BatchNorm;
  * global BN alone: the global BatchNorm without the DDP wrapper;

so (global BN alone - plain) is the global BatchNorm's share of DDP's
cost and (DDP, local BN - plain) the wrapper's and its reducer's; and a
trace of the plain and the DDP step: kernels a step, the device's busy
ms, the NCCL kernels' ms and count a step, and the host ms of the
all-reduce calls.

    python3 -m gesture_diffusion_torch.training.step_profile --ddp
        [--steps 8]

TF32 is off for matmuls and cuDNN.  Run it from the repository's root.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

D_POSE, WINDOW, WAV = 123, 40, 32000        # 41 joints x 3; 2 s at 16 kHz
RANGES = ("train_step/forward", "train_step/backward", "train_step/optimizer")
WINDOWS = 5                  # --ddp: timed windows of each variant


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--encoder-dtype", nargs="+", default=["bfloat16", "none"])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--ddp", action="store_true",
                    help="price the data-parallel step at world size 1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.ddp:
        return ddp_parts(args)
    from torch.profiler import ProfilerActivity, profile

    from ..models import build_all
    from ..utils import JsonConfig
    from .train_state import make_optimizer
    from .trainer import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = JsonConfig(os.path.join("configs", "beat-ours.json"))
    rng = np.random.default_rng(0)
    batch = {"wav": torch.from_numpy(rng.normal(0, 0.3, (args.batch, WAV))
                                     .astype(np.float32)).to(dev),
             "pose": torch.from_numpy(rng.normal(0, 0.5, (args.batch, WINDOW, D_POSE))
                                      .astype(np.float32)).to(dev)}
    os.makedirs(args.out, exist_ok=True)
    for name in args.encoder_dtype:
        enc = None if name == "none" else name
        bundle = build_all(cfg, D_POSE, device=dev, encoder_dtype=enc,
                           generator=torch.Generator().manual_seed(0))
        optimizer, lr_schedule = make_optimizer(bundle.model, cfg.get("Train"))
        step = make_train_step(bundle.model, bundle.schedule.to(dev), optimizer,
                               lr_schedule)
        for i in range(3):                  # cuDNN and cuBLAS warm up
            step(batch, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            i += 1
            step(batch, i)
        torch.cuda.synchronize()
        queued = (time.perf_counter() - t0) / args.steps * 1e3
        synced = []
        for _ in range(args.steps):
            i += 1
            t0 = time.perf_counter()
            step(batch, i)
            torch.cuda.synchronize()
            synced.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                i += 1
                step(batch, i)
            torch.cuda.synchronize()
        kernels = device_work(prof)
        busy = sum(e.device_time for e in kernels) / args.steps / 1e3
        table = prof.key_averages()
        host = {k: max(e.cpu_time_total for e in table if e.key == k)
                / args.steps / 1e3 for k in RANGES}
        label = enc or "f32"
        print(f"[train-profile] beat-ours, encoder {label}, batch {args.batch}: "
              f"step {queued:.2f} ms queued ({args.batch * 1e3 / queued:.1f} "
              f"windows/s), {float(np.median(synced)):.2f} ms synchronised "
              f"(median of {args.steps}); traced, host ms a step: "
              + ", ".join(f"{k.split('/')[1]} {host[k]:.2f}" for k in RANGES)
              + f"; {len(kernels) / args.steps:.0f} kernels a step, the device "
              f"busy {busy:.2f} ms a step [{smi}]", flush=True)
        print(table.table(sort_by="self_cuda_time_total", row_limit=15), flush=True)
        print(table.table(sort_by="cpu_time_total", row_limit=12), flush=True)
        with open(os.path.join(args.out, f"train_profile_{label}.txt"), "w") as f:
            f.write(table.table(sort_by="self_cuda_time_total", row_limit=60))
            f.write(table.table(sort_by="cpu_time_total", row_limit=60))
    return 0


def device_work(prof) -> list:
    """The kernels and copies of a trace.  The device track also holds one
    annotation per ``record_function`` range (the step's, DDP's), spanning
    its kernels; each has a host event of its name, which no kernel has."""
    events = prof.events()
    host = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in host]


VARIANTS = {                 # name: (DDP wrapper, global BatchNorm)
    "plain": (False, False),
    "DDP": (True, True),
    "DDP, local BN": (True, False),
    "global BN alone": (False, True),
}


def ddp_parts(args) -> int:
    """``--ddp``: the four variants of the step under a group of one."""
    import contextlib
    import socket
    from unittest import mock

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ..models import build_all, speech_encoder
    from ..parallel import init_distributed
    from ..utils import JsonConfig
    from . import trainer as trainer_module
    from .train_state import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = JsonConfig(os.path.join("configs", "beat-ours.json"))
    rng = np.random.default_rng(0)
    batch = {"wav": torch.from_numpy(rng.normal(0, 0.3, (args.batch, WAV))
                                     .astype(np.float32)).to(dev),
             "pose": torch.from_numpy(rng.normal(0, 0.5, (args.batch, WINDOW, D_POSE))
                                      .astype(np.float32)).to(dev)}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    init_distributed(f"localhost:{port}", 1, 0, device=dev)
    os.makedirs(args.out, exist_ok=True)

    def local_bn(on: bool):
        """The BatchNorm's local path under the group."""
        if on:
            return mock.patch.object(speech_encoder, "active_group", lambda: None)
        return contextlib.nullcontext()

    try:
        for name in args.encoder_dtype:
            enc = None if name == "none" else name
            label = enc or "f32"
            steps = {}
            for variant, (ddp, global_bn) in VARIANTS.items():
                bundle = build_all(cfg, D_POSE, device=dev, encoder_dtype=enc,
                                   generator=torch.Generator().manual_seed(0))
                optimizer, lr_schedule = make_optimizer(bundle.model, cfg.get("Train"))
                # without the wrapper the step is the single-process one: it
                # neither wraps the model nor averages its losses over ranks
                build = (contextlib.nullcontext() if ddp else mock.patch.object(
                    trainer_module, "active_group", lambda: None))
                with build:
                    step = trainer_module.make_train_step(
                        bundle.model, bundle.schedule.to(dev), optimizer, lr_schedule)

                def run(k, step=step, global_bn=global_bn):
                    with local_bn(not global_bn):
                        step(batch, k)

                steps[variant] = run
            for variant, run in steps.items():   # cuDNN and cuBLAS warm up
                for k in range(3):
                    run(k)
            torch.cuda.synchronize()
            times = {v: [] for v in steps}
            k = 3
            for _ in range(WINDOWS):
                for variant, run in steps.items():
                    t0 = time.perf_counter()
                    for _ in range(args.steps):
                        run(k)
                        k += 1
                    torch.cuda.synchronize()
                    times[variant].append((time.perf_counter() - t0) / args.steps * 1e3)
            med = {v: float(np.median(t)) for v, t in times.items()}
            extra = med["DDP"] - med["plain"]
            print(f"[ddp-profile] beat-ours, encoder {label}, batch {args.batch}, "
                  f"world size 1 over NCCL; ms a step, {WINDOWS} windows of "
                  f"{args.steps} queued steps, the variants in turns: "
                  + "; ".join(f"{v} median {med[v]:.2f} (min {min(t):.2f}, max "
                              f"{max(t):.2f})" for v, t in times.items())
                  + f"; DDP costs {extra:.2f} ms a step, of which the global "
                  f"BatchNorm {med['global BN alone'] - med['plain']:.2f} and the "
                  f"DDP wrapper with its reducer "
                  f"{med['DDP, local BN'] - med['plain']:.2f} [{smi}]", flush=True)
            for variant in ("plain", "DDP"):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.steps):
                        steps[variant](k)
                        k += 1
                    torch.cuda.synchronize()
                work = device_work(prof)
                copies = [e for e in work if e.name.startswith("Memcpy")]
                nccl = [e for e in work if "nccl" in e.name.lower()]
                table = prof.key_averages()
                reduce = [e for e in table if e.key == "c10d::allreduce_"]
                n = args.steps
                print(f"[ddp-profile]   {variant}, encoder {label}, traced: "
                      f"{(len(work) - len(copies)) / n:.0f} kernels and "
                      f"{len(copies) / n:.0f} copies a step, the device busy "
                      f"{sum(e.device_time for e in work) / n / 1e3:.2f} ms a "
                      f"step; NCCL kernels {len(nccl) / n:.0f} a step "
                      f"({sum(e.device_time for e in nccl) / n / 1e3:.3f} ms; "
                      f"at world size 1 NCCL copies instead); "
                      f"{sum(e.count for e in reduce) / n:.0f} all-reduce calls "
                      f"a step taking {sum(e.cpu_time_total for e in reduce) / n / 1e3:.2f} "
                      f"host ms; host ops' self time "
                      f"{sum(e.self_cpu_time_total for e in table) / n / 1e3:.2f} ms "
                      f"a step (under the profiler)", flush=True)
                slug = variant.replace(" ", "_").replace(",", "")
                with open(os.path.join(args.out, f"ddp_profile_{label}_{slug}.txt"),
                          "w") as f:
                    f.write(table.table(sort_by="self_cuda_time_total", row_limit=40))
                    f.write(table.table(sort_by="cpu_time_total", row_limit=40))
            del steps
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
