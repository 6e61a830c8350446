"""Where a scan-sampler step's time goes, on one NVIDIA GPU.

Builds a configuration (``configs/tedexp-ours.json`` by default: the
10-layer cross-attention decoder, which no fused kernel serves) at full
width with seeded random weights and, for each batch, times the step that
``ddim_sample_loop`` repeats (one ``denoise`` call on the speech memory and
the DDIM update):

  * the step's wall time: ``--steps`` steps queued without a synchronise
    and one at the end;
  * a ``torch.profiler`` trace of ``--steps`` steps: the kernels launched
    per step, the device's busy time per step (the sum of kernel times),
    its idle share of the queued step, and the top kernels and host
    operators; the full tables go to ``--out``.

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
import time

import numpy as np
import torch


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

    from ..diffusion.gaussian import _gather, predict_xstart_from_eps
    from ..models import build_all
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
    sched = b.eval_schedule.to(dev)
    os.makedirs(args.out, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.config))[0]
    rng = np.random.default_rng(0)
    for n in args.batch:
        wav = torch.from_numpy(rng.normal(0, 0.3, (n, int(cfg.Data.wav_sr * window / fps)))
                               .astype(np.float32)).to(dev)
        x = torch.randn(n, window, args.d_pose, device=dev)
        with torch.no_grad():
            memory = b.model.encode_memory(wav)

            def step(i):
                t = torch.full((n,), (sched.num_timesteps - 1 - i) % sched.num_timesteps,
                               dtype=torch.int64, device=dev)
                eps = b.model.denoise(x, t, memory)
                x0 = predict_xstart_from_eps(sched, x, t, eps)
                a_prev = _gather(sched.alphas_cumprod_prev, t, x.ndim)
                return x0 * torch.sqrt(a_prev) + torch.sqrt(1.0 - a_prev) * eps

            for i in range(3):
                step(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(args.steps):
                step(i)
            torch.cuda.synchronize()
            queued = (time.perf_counter() - t0) / args.steps * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(args.steps):
                    step(i)
                torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time for e in kernels) / args.steps / 1e3
        table = prof.key_averages()
        print(f"[scan-profile] {name}, batch {n}, memory {memory.shape[1]} rows: "
              f"step {queued:.3f} ms queued; traced: {len(kernels) / args.steps:.0f} "
              f"kernels a step, the device busy {busy:.3f} ms a step, idle "
              f"{100 * (1 - busy / queued):.1f}% of the queued step [{smi}]",
              flush=True)
        print(table.table(sort_by="self_cuda_time_total", row_limit=12), flush=True)
        with open(os.path.join(args.out, f"scan_profile_{name}_b{n}.txt"), "w") as f:
            f.write(table.table(sort_by="self_cuda_time_total", row_limit=60))
            f.write(table.table(sort_by="cpu_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
