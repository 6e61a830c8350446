#!/usr/bin/env python3
"""How far apart two correct bf16 runs of the fused DDIM sampler land.

On one NVIDIA GPU, with the flagship model (beat-ours, seeded random
weights) at batch 3, T 40, n_mem 32, for the first S steps of the ddim10
and ddim50 schedules, prints max|a - b| / max|b| for:

  * the CUDA kernel against the plain version on the card;
  * the plain version on the card against the plain version on the CPU
    (same bf16 policy, f32 sums in another order);
  * bf16 against float32 product operands (the plain version on the card).

    python3 tools/fused_ddim_precision.py
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gesture_diffusion_torch.diffusion import make_diffusion  # noqa: E402
from gesture_diffusion_torch.models import build_all  # noqa: E402
from gesture_diffusion_torch.ops import fused_sampler as fs  # noqa: E402
from gesture_diffusion_torch.utils import JsonConfig  # noqa: E402


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.cpu(), b.cpu()
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    model = build_all(JsonConfig(os.path.join(REPO, "configs", "beat-ours.json")),
                      123, device="cuda",
                      generator=torch.Generator().manual_seed(0)).model
    packed = fs.pack_oneway_denoiser(model, 123, 40)
    packed_cpu = fs.PackedDenoiser(*(t.cpu() for t in packed))
    g = torch.Generator(device="cuda").manual_seed(1)
    n = 3
    x = torch.zeros(n, 40, 128, device="cuda")
    x[..., :123] = torch.randn(n, 40, 123, generator=g, device="cuda")
    mem = torch.randn(n, 32, 256, generator=g, device="cuda")
    mem[:, 0] = 0.0
    for spec in ("ddim10", "ddim50"):
        sched, tmap = make_diffusion("linear", 1000, spec)
        coefs = fs.ddim_coefficients(sched)
        for s in (1, 2, 5, sched.num_timesteps):
            tm, cf = tmap[-s:].cuda(), coefs[-s:].cuda()   # first s steps
            args = (None, None, 4, 8, s)
            k = fs.fused_ddim_sample(packed, x, mem, tm, cf, *args)
            p = fs.fused_ddim_sample_plain(packed, x, mem, tm, cf, *args)
            pc = fs.fused_ddim_sample_plain(packed_cpu, x.cpu(), mem.cpu(),
                                            tm.cpu(), cf.cpu(), *args)
            p32 = fs.fused_ddim_sample_plain(packed, x, mem, tm, cf, *args,
                                             compute_dtype=torch.float32)
            print(f"{spec} first {s:2d} steps: kernel-vs-plain {rel(k, p):.3e}  "
                  f"plain-card-vs-plain-cpu {rel(p, pc):.3e}  "
                  f"bf16-vs-f32-operands {rel(p, p32):.3e}  "
                  f"max|x| {float(p.abs().max()):.1f} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
