#!/usr/bin/env python3
"""Where the fused DDIM kernel's time goes, on one NVIDIA GPU.

Builds a kernel source once per variant of its timing hooks: all on
("all"), attention skipped, matmul k-loops skipped, both skipped, and the
k-loops with the activation (A) or weight (B) fragments held at k-step 0,
which takes that operand's loads out of the loop.  Each build then runs
the flagship shapes through the package's wrapper: beat-ours, T 40, n_mem 32, seeded random weights, the
first ``--steps`` steps of the 1000-step schedule.  It prints device
microseconds per step (CUDA events) for batches 1 and 64.  A skipped build
computes garbage; only its time is read.

    python3 tools/fused_ddim_breakdown.py [--steps 200] [--source a.cu ...]

Sources default to the package's ``csrc/fused_ddim.cu``.  Several sources
(e.g. the parent commit's, from ``git show``) are timed in turns in one
process, on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gesture_diffusion_torch.diffusion import make_diffusion  # noqa: E402
from gesture_diffusion_torch.models import build_all  # noqa: E402
from gesture_diffusion_torch.ops import fused_sampler as fs  # noqa: E402
from gesture_diffusion_torch.ops import kernel_build  # noqa: E402
from gesture_diffusion_torch.utils import JsonConfig  # noqa: E402

VARIANTS = (("all", ()), ("no_attn", ("-DFUSED_DDIM_SKIP_ATTN",)),
            ("no_mma", ("-DFUSED_DDIM_SKIP_MMA",)),
            ("neither", ("-DFUSED_DDIM_SKIP_ATTN", "-DFUSED_DDIM_SKIP_MMA")),
            ("fixed_a", ("-DFUSED_DDIM_FIXED_A",)),
            ("fixed_b", ("-DFUSED_DDIM_FIXED_B",)))


def build(src: str, tag: str, flags) -> ctypes.CDLL:
    out = os.path.join(REPO, "build", "torch_kernels", f"breakdown-{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS[:-2], *flags,
                    "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    lib.fused_ddim_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    lib.fused_ddim_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--source", nargs="*", default=[
        os.path.join(REPO, "gesture_diffusion_torch", "csrc", "fused_ddim.cu")])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    model = build_all(JsonConfig(os.path.join(REPO, "configs", "beat-ours.json")),
                      123, device="cuda",
                      generator=torch.Generator().manual_seed(0)).model
    packed = fs.pack_oneway_denoiser(model, 123, 40)
    sched, tmap = make_diffusion("linear", 1000)
    s = args.steps
    tm = tmap[-s:].cuda()
    cf = fs.ddim_coefficients(sched)[-s:].cuda()
    libs = [(f"{i}:{name}", build(src, f"{i}-{name}", flags))
            for i, src in enumerate(args.source) for name, flags in VARIANTS]
    g = torch.Generator(device="cuda").manual_seed(1)
    for n in (1, 64):
        x = torch.zeros(n, 40, 128, device="cuda")
        x[..., :123] = torch.randn(n, 40, 123, generator=g, device="cuda")
        mem = torch.randn(n, 32, 256, generator=g, device="cuda")
        for tag, lib in libs:
            fs._LIB = lib

            def run():
                return fs.fused_ddim_sample(packed, x, mem, tm, cf, None, None,
                                            4, 8, s)

            run()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize()
            print(f"source {tag:10s} batch {n:2d}: "
                  f"{e0.elapsed_time(e1) / s * 1e3:8.1f} us/step [{smi}]",
                  flush=True)
    fs._LIB = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
