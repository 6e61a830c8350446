"""Where a scan-sampler step's time goes, on one NVIDIA GPU.

Builds a configuration (``configs/tedexp-ours.json`` by default: the
10-layer cross-attention decoder, which no fused kernel serves) at full
width with seeded random weights and, for each batch, runs the program's
own ``ddim_sample_loop`` over the configuration's schedule respaced to
``--steps`` steps (the memory encoded once, as ``Generator`` does), once
to warm up and once under ``torch.profiler``.  From the traced loop:

  * the host ms of a step: the mean length of its ``sampler/step`` spans;
  * the kernels and copies launched and the device's busy ms (the sum of
    their times), each a step;
  * the top kernels and host operators; the full tables go to ``--out``.

    python3 -m gesture_diffusion_torch.generation.scan_profile
        [--config configs/tedexp-ours.json] [--d-pose 126] [--batch 1 32]
        [--steps 20] [--out build/profiles]

TF32 is off for matmuls and cuDNN.  Run it from the repository's root.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

STEP = "sampler/step"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join("configs", "tedexp-ours.json"))
    ap.add_argument("--d-pose", type=int, default=126)
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 32])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join("build", "profiles"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from ..diffusion import ddim_sample_loop, make_diffusion
    from ..models import build_all
    from ..training.step_profile import device_work
    from ..utils import JsonConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = JsonConfig(args.config)
    window, fps = cfg.Data.pose_window_len, cfg.Data.pose_fps
    b = build_all(cfg, args.d_pose, device=dev,
                  generator=torch.Generator().manual_seed(0))
    diff = cfg.Model.Diffusion
    sched, tmap = make_diffusion(diff.noise_schedule, diff.diffusion_steps,
                                 f"ddim{args.steps}")
    sched, tmap = sched.to(dev), tmap.to(dev)
    os.makedirs(args.out, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.config))[0]
    rng = np.random.default_rng(0)
    for n in args.batch:
        wav = torch.from_numpy(rng.normal(0, 0.3, (n, int(cfg.Data.wav_sr * window / fps)))
                               .astype(np.float32)).to(dev)
        noise = torch.randn(n, window, args.d_pose, device=dev)
        with torch.no_grad():
            memory = b.model.encode_memory(wav)

            def model_fn(x, t):
                return b.model.denoise(x, t, memory)

            def sample():
                return ddim_sample_loop(sched, model_fn, noise, timestep_map=tmap)

            sample()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                sample()
                torch.cuda.synchronize()
        kernels = device_work(prof)
        busy = sum(e.device_time for e in kernels) / args.steps / 1e3
        steps = [e.time_range.elapsed_us() for e in prof.events()
                 if e.name == STEP and e.device_type == torch.autograd.DeviceType.CPU]
        table = prof.key_averages()
        print(f"[scan-profile] {name}, batch {n}, memory {memory.shape[1]} rows, "
              f"ddim{args.steps}, traced: the {STEP} span {np.mean(steps) / 1e3:.3f} ms "
              f"of host a step ({len(steps)} spans), {len(kernels) / args.steps:.0f} "
              f"kernels a step, the device busy {busy:.3f} ms a step [{smi}]",
              flush=True)
        print(table.table(sort_by="self_cuda_time_total", row_limit=12), flush=True)
        with open(os.path.join(args.out, f"scan_profile_{name}_b{n}.txt"), "w") as f:
            f.write(table.table(sort_by="self_cuda_time_total", row_limit=60))
            f.write(table.table(sort_by="cpu_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
