#!/usr/bin/env python3
"""Two builds of the fused DDIM kernel against each other, on one NVIDIA
GPU: are their outputs equal bit for bit, and how long does each take.

    python3 tools/fused_ddim_compare.py OLD.cu [NEW.cu] [--reps 3]

Both sources are built with the package's nvcc flags (both builds started
together) and run through the package's wrapper on the same inputs: the
flagship beat-ours weights (seeded), T 40, 1000 steps, batches 1 and 64,
DDIM with the identity blend and DDPM with the x0 blend, each at the
planned cluster size and at every forced one.  A source whose C interface
takes fewer dimensions than the wrapper passes (one written before a
dimension was appended, such as ``clip_base``) is handed only its own
count; the wrapper's extra dimensions must then be at their defaults.
It prints whether every output is bit-equal (where not, the largest
distance max|new - old| / max|old|), then the device ms (CUDA events) of
each source at the planned cluster size, timed in turns (old, new, new,
old), and the card's name and power limit.  NEW defaults to the
package's ``csrc/fused_ddim.cu``.

    python3 tools/fused_ddim_compare.py OLD.cu [NEW.cu] [--compute bfloat16
        float32] [--weights bf16 f32] [--sass]

``--compute`` picks the instantiations (bfloat16, the default, on the
bf16 pack; float32 on each pack of ``--weights``: bf16, the Generator's
default pack, and f32, ``fused_dtype=float32``).  ``--sass`` also
builds each source's first build part (the bf16 instantiation and the C
interface) as an object and prints whether ``cuobjdump -sass`` reads the
same in both; a difference goes to ``build/compare_sass.diff``.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gesture_diffusion_torch.diffusion import make_diffusion  # noqa: E402
from gesture_diffusion_torch.generation import Generator  # noqa: E402
from gesture_diffusion_torch.models import build_all  # noqa: E402
from gesture_diffusion_torch.ops import fused_sampler as fs  # noqa: E402
from gesture_diffusion_torch.ops import kernel_build  # noqa: E402
from gesture_diffusion_torch.utils import JsonConfig  # noqa: E402

D_POSE, WINDOW, SEED_LEN = 123, 40, 10


class _Interface:
    """A built library as the wrapper calls it, handed only as many
    dimensions as its source declares (``#define N_DIMS``)."""

    def __init__(self, lib, n_dims: int):
        self._lib, self._n_dims = lib, n_dims

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def fused_ddim_launch(self, ptrs, n_ptrs, dims, n_dims, stream):
        if any(dims[i] for i in range(self._n_dims, n_dims)):
            raise ValueError("a dimension this source does not take is set")
        return self._lib.fused_ddim_launch(ptrs, n_ptrs, dims, self._n_dims, stream)


def build(sources, sass: bool = False):
    """The libraries of ``sources`` and, with ``sass``, the SASS text of
    each source's build part 0; every nvcc started together."""
    out_dir = os.path.join(REPO, "build", "torch_kernels")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = kernel_build._nvcc()
    jobs, objs = [], []
    for i, src in enumerate(sources):
        out = os.path.join(out_dir, f"compare-{i}.so")
        jobs.append((src, out, subprocess.Popen(
            [nvcc, *kernel_build.NVCC_FLAGS[:-2], "-o", out, src])))
        if sass:
            obj = os.path.join(out_dir, f"compare-{i}.part0.o")
            flags = [f for f in kernel_build.NVCC_FLAGS[:-2] if f != "-shared"]
            objs.append((obj, subprocess.Popen(
                [nvcc, *flags, "-c", "-DKERNEL_BUILD_PART=0", "-o", obj, src])))
    if any(proc.wait() != 0 for _, _, proc in jobs) or any(
            proc.wait() != 0 for _, proc in objs):
        raise RuntimeError("nvcc failed")
    libs = []
    for src, out, _ in jobs:
        with open(src) as f:
            n_dims = int(re.search(r"#define N_DIMS (\d+)", f.read()).group(1))
        libs.append(_Interface(fs.bind_library(ctypes.CDLL(out)), n_dims))
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    texts = [subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                            text=True, check=True).stdout for obj, _ in objs]
    return libs, texts


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# (compute dtype, pack weight dtype) of each --compute and --weights
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "bf16": torch.bfloat16, "f32": torch.float32}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new", nargs="?", default=os.path.join(
        REPO, "gesture_diffusion_torch", "csrc", "fused_ddim.cu"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--compute", nargs="*", default=["bfloat16"],
                    choices=("bfloat16", "float32"))
    ap.add_argument("--weights", nargs="*", default=["bf16"],
                    choices=("bf16", "f32"),
                    help="packs the float32 instantiation runs on")
    ap.add_argument("--sass", action="store_true",
                    help="compare the bf16 instantiation's SASS too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = JsonConfig(os.path.join(REPO, "configs", "beat-ours.json"))
    model = build_all(cfg, D_POSE, device=dev,
                      generator=torch.Generator().manual_seed(0)).model
    sched, tmap = make_diffusion("linear", 1000)
    runs = [("bfloat16", "bf16")] if "bfloat16" in args.compute else []
    if "float32" in args.compute:
        runs += [("float32", w) for w in args.weights]
    # a Generator per pack, its compute dtype set by each run (the default
    # policy computes batch 1 in float32, which a source before that
    # instantiation does not have)
    gens = {w: Generator(model, sched, tmap, fused_dtype=DTYPES[w], device=dev)
            for w in dict.fromkeys(w for _, w in runs)}
    (old, new), texts = build([args.old, args.new], args.sass)
    g = torch.Generator(device=dev).manual_seed(1)
    cases = {}
    for n in (1, 64):
        wav = 0.3 * torch.randn(n, 32000, generator=g, device=dev)
        noise = torch.randn(n, WINDOW, D_POSE, generator=g, device=dev)
        ip = torch.zeros(n, WINDOW, D_POSE, device=dev)
        ip[:, :SEED_LEN] = 0.5 * torch.randn(n, SEED_LEN, D_POSE, generator=g,
                                             device=dev)
        im = torch.zeros(n, WINDOW, 1, device=dev)
        im[:, :SEED_LEN] = 1.0
        for compute, w in runs:
            at = dict(compute_dtype=DTYPES[compute])
            tag = f"{compute} on {w}"
            with torch.no_grad():
                cases[f"{tag}, DDIM batch {n}"] = {**gens[w].fused_args(
                    wav, D_POSE, WINDOW, noise), **at}
                cases[f"{tag}, DDPM x0-blend batch {n}"] = {**gens[w].fused_args(
                    wav, D_POSE, WINDOW, noise, ip, im, None, sample_alg="ddpm",
                    seed=torch.tensor([987654321], device=dev)), **at}
    equal = {}
    for label, kw in cases.items():
        for cluster in (None,) + fs.CLUSTER_SIZES:
            outs = []
            for lib in (old, new):
                fs._LIB = lib
                with torch.no_grad():
                    outs.append(fs._fused_ddim_cuda(**kw, cluster=cluster))
            torch.cuda.synchronize()
            equal[label, cluster or "planned"] = (
                torch.equal(*outs),
                float((outs[1] - outs[0]).abs().max() / outs[0].abs().max()))
    for (label, c), (same, dist) in equal.items():
        print(f"[compare] {label}, C {c}: bit-equal {same}"
              + ("" if same else f", distance {dist:.3e}"))
    times = {}
    for label, kw in cases.items():
        for tag, lib in (("old", old), ("new", new), ("new", new), ("old", old)):
            fs._LIB = lib
            with torch.no_grad():
                ms = cuda_ms(lambda: fs._fused_ddim_cuda(**kw), args.reps)
            times.setdefault((label, tag), []).append(ms)
    for label in cases:
        o, w = times[label, "old"], times[label, "new"]
        print(f"[compare] {label}, 1000 steps, planned C: old "
              f"{' / '.join(f'{x:.3f}' for x in o)} ms, new "
              f"{' / '.join(f'{x:.3f}' for x in w)} ms (turns old, new, new, "
              f"old); new/old {sum(w) / sum(o):.4f} [{smi}]")
    same = all(e for e, _ in equal.values())
    print(f"[compare] all bit-equal: {same}")
    if args.sass:
        sass_same = texts[0] == texts[1]
        print(f"[compare] bf16 instantiation's SASS the same: {sass_same} "
              f"({len(texts[0].splitlines())} / {len(texts[1].splitlines())} "
              "lines)")
        if not sass_same:
            with open(os.path.join(REPO, "build", "compare_sass.diff"),
                      "w") as f:
                f.writelines(difflib.unified_diff(
                    texts[0].splitlines(True), texts[1].splitlines(True),
                    "old", "new"))
        same = same and sass_same
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
