#!/usr/bin/env python3
"""Where the fused DDIM kernel's time goes, on one NVIDIA GPU.

Builds a kernel source once per variant of its timing hooks: all on
("all"), attention skipped, matmul k-loops skipped, both skipped, and the
k-loops with the activation (A) or weight (B) fragments held at k-step 0,
which takes that operand's loads out of the loop.  Each build then runs
the flagship shapes through the package's wrapper: beat-ours, T 40,
``--n-mem`` memory rows (32, the flagship's, by default; 92 is the default
and inpaint model types'), seeded random weights, the first ``--steps``
steps of the 1000-step schedule.  It prints device microseconds per step
(CUDA events) for batches 1 and 64, each at the cluster size the wrapper
plans for it (``cluster_plan``: 8 at batch 1, 2 at batch 64 on an H100)
or at each size that ``--cluster`` forces, and names the size on every
line.  A skipped build computes garbage; only its time is read.

    python3 tools/fused_ddim_breakdown.py [--steps 200] [--n-mem 32 92]
        [--cluster 1 8] [--variant fast=-use_fast_math ...] [--only all ...]
        [--source a.cu ...]

Sources default to the package's ``csrc/fused_ddim.cu``.  Several sources
(e.g. the parent commit's, from ``git show``) are timed in turns in one
process, on one card; each must have the C interface of the package's
wrapper (``fused_ddim_launch`` with its pointer and dimension counts).
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


def build_all_variants(sources, variants=VARIANTS) -> list:
    """[(tag, library)] for every source and variant; one nvcc each, all
    started together."""
    out_dir = os.path.join(REPO, "build", "torch_kernels")
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for i, src in enumerate(sources):
        for name, flags in variants:
            out = os.path.join(out_dir, f"breakdown-{i}-{name}.so")
            jobs.append((f"{i}:{name}", out, subprocess.Popen(
                [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS[:-2], *flags,
                 "-o", out, src])))
    failed = [tag for tag, _, proc in jobs if proc.wait() != 0]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    return [(tag, fs.bind_library(ctypes.CDLL(out))) for tag, out, _ in jobs]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--n-mem", type=int, nargs="*", default=[32],
                    help="memory rows (token row included), one run each")
    ap.add_argument("--variant", nargs="*", default=[], metavar="NAME=FLAGS",
                    help="further builds, e.g. fast=-use_fast_math "
                         "(comma-separated nvcc flags)")
    ap.add_argument("--only", nargs="*", default=None, metavar="NAME",
                    help="build only these variants (e.g. all neither)")
    ap.add_argument("--cluster", type=int, nargs="*", default=[None],
                    help="blocks per clip to force, one run each (default: "
                         "the planned size)")
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
    extra = tuple((v.split("=", 1)[0], tuple(v.split("=", 1)[1].split(",")))
                  for v in args.variant)
    variants = tuple(v for v in VARIANTS + extra
                     if args.only is None or v[0] in args.only)
    libs = build_all_variants(args.source, variants)
    g = torch.Generator(device="cuda").manual_seed(1)
    for n, n_mem in ((n, m) for m in args.n_mem for n in (1, 64)):
        x = torch.zeros(n, 40, 128, device="cuda")
        x[..., :123] = torch.randn(n, 40, 123, generator=g, device="cuda")
        mem = torch.randn(n, n_mem, 256, generator=g, device="cuda")
        for (tag, lib), cluster in ((t, c) for t in libs for c in args.cluster):
            fs._LIB = lib

            def run():
                return fs._fused_ddim_cuda(packed, x, mem, tm, cf, None, None,
                                           4, 8, s, torch.bfloat16,
                                           cluster=cluster)

            run()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize()
            print(f"source {tag:10s} n_mem {n_mem:3d} batch {n:2d} cluster "
                  f"{fs.last_cluster}: {e0.elapsed_time(e1) / s * 1e3:8.1f} "
                  f"us/step [{smi}]", flush=True)
    fs._LIB = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
