#!/usr/bin/env python3
"""Where the fused DDIM kernel's time goes, on one NVIDIA GPU.

Builds a kernel source once per variant of its timing hooks: all on
("all"), attention skipped, matmul k-loops skipped, both skipped, and the
k-loops with the activation (A) or weight (B) fragments held at k-step 0,
which takes that operand's loads out of the loop.  Each build then runs
the flagship shapes through a wrapper: beat-ours, T 40, ``--n-mem``
memory rows (32, the flagship's, by default; 92 is the default and
inpaint model types'), seeded random weights, the first ``--steps`` steps
of the 1000-step schedule, in each ``--compute`` dtype: bfloat16 on the
bf16 pack, float32 on each pack of ``--weights`` (bf16: the Generator's
default at one or two clips; f32: ``fused_dtype=float32``).  It prints
device microseconds per step (CUDA events) for batches 1 and 64, each at
the cluster size the wrapper plans for it (``cluster_plan``: 8 at batch
1, 2 at batch 64 on an H100) or at each size that ``--cluster`` forces,
and names the size, the FF chunk, the staging, (float32) where the
attention operands live and the cluster barriers a step on every line.
``--variant noln=-DFUSED_DDIM_SKIP_LN`` prices LayerNorm: the bf16
instantiation skips its rows, the float32 one its statistics (its rows
are written with mean 0 and rstd 1).  A skipped build computes
garbage; only its time is read.

    python3 tools/fused_ddim_breakdown.py [--steps 200] [--n-mem 32 92]
        [--compute bfloat16 float32] [--weights bf16 f32] [--cluster 1 8]
        [--ff-chunk 0 512] [--variant fast=-use_fast_math ...]
        [--only all ...] [--source a.cu TREE ...]

A source is a kernel file, run through this package's wrapper, or the
root of another checkout (a parent commit's ``git archive`` unpacked
under ``build/``), whose ``csrc/fused_ddim.cu`` runs through that
checkout's own ``ops/fused_sampler.py``, loaded beside this package's
under another module name: a source of another weight layout or C
interface is marshalled as its own wrapper marshals it.  Sources default
to this package's ``csrc/fused_ddim.cu``; several are timed in turns in
one process, on one card (``--source TREE new.cu new.cu TREE``).
``--ff-chunk`` forces the float32 instantiation's FF hidden chunk (with
full-strip staging where it fits, else half strips; 0 is the planned one)
on sources run through this package's wrapper.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
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
KERNEL = os.path.join("gesture_diffusion_torch", "csrc", "fused_ddim.cu")
LAYERS, FFN = 4, 1024          # beat-ours' decoder
WRAPPER = os.path.join("gesture_diffusion_torch", "ops", "fused_sampler.py")


def wrapper_of(source: str):
    """(kernel file, wrapper module) of a source: a ``.cu`` file runs
    through this package's wrapper; a checkout's root through its own,
    loaded under another name in this package's ``ops`` (its relative
    imports resolve to this package's models, whose functions it shares)."""
    if not os.path.isdir(source):
        return source, fs
    name = f"gesture_diffusion_torch.ops._fused_sampler_{len(_TREES)}"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(source, WRAPPER))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    _TREES.append(mod)
    return os.path.join(source, KERNEL), mod


_TREES: list = []


def build_all_variants(sources, variants=VARIANTS) -> list:
    """[(tag, library, wrapper)] for every source (in the order given, a
    repeated one again) and variant; one nvcc for each distinct source and
    variant, all started together."""
    out_dir = os.path.join(REPO, "build", "torch_kernels")
    os.makedirs(out_dir, exist_ok=True)
    distinct = list(dict.fromkeys(os.path.abspath(s) for s in sources))
    jobs = {}
    for i, source in enumerate(distinct):
        src, mod = wrapper_of(source)
        for name, flags in variants:
            out = os.path.join(out_dir, f"breakdown-{i}-{name}.so")
            jobs[source, name] = (f"{i}:{name}", out, mod, subprocess.Popen(
                [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS[:-2], *flags,
                 "-o", out, src]))
    failed = [tag for tag, _, _, proc in jobs.values() if proc.wait() != 0]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    libs = {key: (tag, mod.bind_library(ctypes.CDLL(out)), mod)
            for key, (tag, out, mod, _) in jobs.items()}
    return [libs[os.path.abspath(s), name] for s in sources
            for name, _ in variants]


def forced_chunk(mod, fc: int):
    """``smem_plan`` of ``mod`` with the FF chunk fixed at ``fc``: full-strip
    staging where that fits, else half strips."""
    plan = mod.smem_plan

    def fixed(t, d_model, dp_pad, ffn, f32=False, cluster=1):
        for half in (False, True):
            nbytes = mod.smem_bytes(t, d_model, dp_pad, fc, half, f32, cluster)
            if nbytes <= mod.SMEM_LIMIT:
                return nbytes, fc, half
        return plan(t, d_model, dp_pad, ffn, f32, cluster)

    return fixed


def barriers(mod, plan, f32: bool) -> int:
    """Cluster barriers a step of the last launch.  A tree whose wrapper
    has no ``cluster_barriers`` is one from before the float32
    instantiation normalised every row in every block: every LayerNorm's
    rows cross blocks there."""
    local = f32 and hasattr(mod, "cluster_barriers")
    return fs.cluster_barriers(LAYERS, FFN, plan["ff_chunk"], plan["cluster"],
                               local)


def describe(mod, f32: bool) -> str:
    """The last launch's plan, as far as the wrapper records it, and its
    cluster barriers a step."""
    plan = getattr(mod, "last_plan", None)
    if plan is None:
        return f"cluster {mod.last_cluster}"
    return (f"cluster {plan['cluster']}, FF chunk {plan['ff_chunk']}, "
            f"{'half' if plan['half'] else 'full'} strips"
            + (f", attention operands in {plan['attention']}" if f32 else "")
            + f", {barriers(mod, plan, f32)} cluster barriers a step")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--n-mem", type=int, nargs="*", default=[32],
                    help="memory rows (token row included), one run each")
    ap.add_argument("--compute", nargs="*", default=["bfloat16"],
                    choices=("bfloat16", "float32"),
                    help="instantiations to time (bfloat16 on the bf16 pack, "
                         "float32 on each pack of --weights)")
    ap.add_argument("--weights", nargs="*", default=["bf16"],
                    choices=("bf16", "f32"),
                    help="packs the float32 instantiation runs on")
    ap.add_argument("--variant", nargs="*", default=[], metavar="NAME=FLAGS",
                    help="further builds, e.g. fast=-use_fast_math "
                         "(comma-separated nvcc flags)")
    ap.add_argument("--only", nargs="*", default=None, metavar="NAME",
                    help="build only these variants (e.g. all neither)")
    ap.add_argument("--cluster", type=int, nargs="*", default=[None],
                    help="blocks per clip to force, one run each (default: "
                         "the planned size)")
    ap.add_argument("--ff-chunk", type=int, nargs="*", default=[0],
                    help="FF hidden chunks to force, one run each (0: the "
                         "planned one, the default)")
    ap.add_argument("--source", nargs="*", default=[os.path.join(REPO, KERNEL)])
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
    packs = {w: fs.pack_oneway_denoiser(model, 123, 40, weight_dtype=wd)
             for w, wd in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    runs = [(torch.bfloat16, "bf16")] if "bfloat16" in args.compute else []
    if "float32" in args.compute:
        runs += [(torch.float32, w) for w in args.weights]
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
        for compute, weights in runs:
            for (tag, lib, mod), cluster, fc in (
                    (t, c, f) for t in libs for c in args.cluster
                    for f in args.ff_chunk):
                if fc and (mod is not fs or compute != torch.float32):
                    continue
                mod._LIB = lib
                plan = mod.smem_plan
                if fc:
                    mod.smem_plan = forced_chunk(mod, fc)

                def run():
                    return mod._fused_ddim_cuda(packs[weights], x, mem, tm, cf,
                                                None, None, LAYERS, 8, s, compute,
                                                cluster=cluster)

                try:
                    run()
                    torch.cuda.synchronize()
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    run()
                    e1.record()
                    torch.cuda.synchronize()
                finally:
                    mod.smem_plan = plan
                f32 = compute == torch.float32
                print(f"source {tag:10s} {'float32' if f32 else 'bfloat16'} "
                      f"on {weights} weights, n_mem {n_mem:3d} batch {n:2d} "
                      f"{describe(mod, f32)}: "
                      f"{e0.elapsed_time(e1) / s * 1e3:8.1f} us/step [{smi}]",
                      flush=True)
    for mod in (fs, *_TREES):
        mod._LIB = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
