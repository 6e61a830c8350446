"""Share of the traced window's device-busy time spent in matrix-product kernels, those whose name matches ``GEMM`` (cuBLAS's and CUTLASS's gemm, gemv and split-K reduction kernels); the rest is the modulation, norms, GELU, gates, concatenations and attention.  To stderr: the kernel names the pattern took and the largest it left, with their device seconds."""

import re
import sys
from collections import defaultdict

from benchmark.common import timeline
from benchmark.common.readers import busy_s

GEMM = re.compile(r"gemm|gemv|splitKreduce", re.IGNORECASE)


def read(rec):
    lo, hi = rec["window"]
    kernels = [d for d in rec["device"]
               if "kernel" in d[3] and d[2] > lo and d[1] < hi]
    busy = busy_s(rec)
    if not kernels or not busy:
        return None
    took, left = defaultdict(float), defaultdict(float)
    for name, a, b, _ in kernels:
        (took if GEMM.search(name) else left)[name[:120]] += min(b, hi) - max(a, lo)

    def top(d, k):
        return "; ".join(f"{n} {s!r}" for n, s in
                         sorted(d.items(), key=lambda kv: -kv[1])[:k])

    print(f"gemm_busy_pct: pattern {GEMM.pattern!r} took {len(took)} names: "
          f"{top(took, 20)}", file=sys.stderr)
    print(f"gemm_busy_pct: largest left: {top(left, 10)}", file=sys.stderr)
    gemm = timeline.busy([(a, b) for name, a, b, k in kernels
                          if GEMM.search(name)], lo, hi)
    return 100.0 * gemm / busy
