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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--encoder-dtype", nargs="+", default=["bfloat16", "none"])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
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
        # the device track also holds one annotation per range, spanning
        # its kernels: not a kernel
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in RANGES]
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


if __name__ == "__main__":
    sys.exit(main())
