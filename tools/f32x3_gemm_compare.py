#!/usr/bin/env python3
"""The split-TF32 GEMM (``csrc/f32x3_gemm.cu``) at the float32 MMDiT's
shapes on one NVIDIA GPU: its error and its time beside cuBLAS's float32
``F.linear`` and the plain version.

    python3 tools/f32x3_gemm_compare.py [--reps 20] [--shapes M,K,N ...]

For each (M, K, N) (default: every shape of the tedexp-mmdit cell at
batch 16, 34 frames and 103 context rows) it draws x ~ N(0, 1), a
Glorot-uniform float32 weight (full mantissas) and a small bias, and
prints:
- the error max|y - ref| / max|ref| of the kernel, of ``F.linear`` in
  float32 (TF32 off) and of one TF32 product (TF32 on), against float64;
- the kernel's tile width (``ops/f32_linear.py::tile_n``) and device ms
  (CUDA events over ``--reps`` launches after a warm-up);
- its bound: the three TF32 products' operations (3 x 2 M N K) at
  495e12 FLOP/s or the bytes the product needs (x, the float32 weight,
  the bias and y once each; the kernel reads the weight's two planes,
  twice the weight's bytes) at 3.35e12 B/s, whichever is larger, and
  which one it is;
- ``F.linear``'s float32 ms (cuBLAS, the yardstick) and the plain
  version's ms (``f32x3_linear_plain`` on the card).
Then the host's microseconds a call (``host_us``), the card's name and
power limit, and the kernel's registers and spills from ``ptxas -v``.
It needs the card: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gesture_diffusion_torch.ops import f32_linear as fl  # noqa: E402
from gesture_diffusion_torch.ops import kernel_build  # noqa: E402

TF32_PEAK, HBM = 495e12, 3.35e12
#: (M, K, N) of the tedexp-mmdit cell: the context stream (16 x 103 rows),
#: the sample stream (16 x 34), the modulation and final linears (16)
SHAPES = [(1648, 1536, 1536), (1648, 1536, 6144), (1648, 6144, 1536),
          (544, 1536, 1536), (544, 1536, 6144), (544, 6144, 1536),
          (16, 1536, 9216), (16, 1536, 3072)]


def draw(m, k, n, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=g)
    lim = (6.0 / (k + n)) ** 0.5
    w = (torch.rand(n, k, device="cuda", generator=g) * 2 - 1) * lim
    b = 0.1 * torch.randn(n, device="cuda", generator=g)
    return x, w, b


def rel(y, ref) -> float:
    return float((y.double() - ref).abs().max() / ref.abs().max())


def errors(x, w, b):
    """Relative errors against float64 of the kernel, cuBLAS float32 and
    one TF32 product."""
    ref = x.double() @ w.double().T + b.double()
    got = fl.f32x3_gemm(x, fl.pack_weight(w), b)
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = F.linear(x, w, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = F.linear(x, w, b)
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = fl.f32x3_linear_plain(x, w, b)
    return rel(got, ref), rel(f32, ref), rel(tf32, ref), rel(got, plain.double())


def time_ms(fn, reps) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(m, k, n):
    ops = 3 * 2.0 * m * n * k / TF32_PEAK
    nbytes = 4.0 * (m * k + n * k + m * n + n) / HBM
    return (1e3 * ops, "operations") if ops >= nbytes else (1e3 * nbytes, "bytes")


def host_us(calls=2000):
    """Host microseconds a call of the module's route (``F32x3Linear`` under
    no_grad), of the kernel's wrapper alone and of ``F.linear``, at a size
    where the host sets the pace."""
    x = torch.randn(16, 64, device="cuda")
    lin = fl.F32x3Linear(64, 64).cuda()
    pack = lin.pack()
    out = {}
    with torch.no_grad():
        for name, fn in (("F32x3Linear", lambda: lin(x)),
                         ("f32x3_gemm", lambda: fl.f32x3_gemm(x, pack, lin.bias)),
                         ("F.linear", lambda: F.linear(x, lin.weight, lin.bias))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            out[name] = round(1e6 * (time.perf_counter() - t0) / calls, 2)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="M,K,N triples (default: the tedexp-mmdit cell's)")
    ap.add_argument("--tiles", nargs="*", type=int, default=None,
                    help="tile widths to time besides the chosen one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("f32x3_gemm_compare needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = SHAPES if not args.shapes else [
        tuple(int(v) for v in s.split(",")) for s in args.shapes]
    print("| M, K, N | kernel err | f32 err | tf32 err | vs plain | BN | kernel ms "
          "| bound ms | F.linear ms | plain ms | TFLOP/s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for m, k, n in shapes:
        x, w, b = draw(m, k, n)
        pack = fl.pack_weight(w)
        e_k, e_f, e_t, e_p = errors(x, w, b)
        bn = fl.tile_n(m, n, fl._sms(x.get_device()))
        t_k = time_ms(lambda: fl.f32x3_gemm(x, pack, b), args.reps)
        t_f = time_ms(lambda: F.linear(x, w, b), args.reps)
        t_p = time_ms(lambda: fl.f32x3_linear_plain(x, w, b), max(args.reps // 4, 2))
        bms, what = bound_ms(m, k, n)
        print(f"| {m}, {k}, {n} | {e_k:.3e} | {e_f:.3e} | {e_t:.3e} | {e_p:.3e} | {bn} "
              f"| {t_k:.4f} | {bms:.4f} ({what}) | {t_f:.4f} | {t_p:.4f} "
              f"| {2.0 * m * n * k / t_k / 1e9:.1f} |", flush=True)
        for other in args.tiles or ():
            if other != bn:
                t_o = time_ms(lambda: fl.f32x3_gemm(x, pack, b, bn=other), args.reps)
                print(f"|   BN {other} | {rel(fl.f32x3_gemm(x, pack, b, bn=other), x.double() @ w.double().T + b.double()):.3e} "
                      f"| | | | {other} | {t_o:.4f} | | | | |", flush=True)
    print(f"host us a call (16 x 64 x 64, 2000 calls): {host_us()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip() or torch.cuda.get_device_name(0)}")
    info = kernel_build.BUILD_INFO.get("f32x3_gemm")
    if info:
        print(f"build: {info[1]:.1f} s")
        for line in info[2].splitlines():
            if re.search(r"registers|spill|Compiling entry|wgmma|serializ", line):
                print("ptxas:", line.strip())


if __name__ == "__main__":
    main()
