"""Device-idle ms a request inside the program's ``generate/sample`` span (the live window's call, from its arguments to the kernel's launch); each phase's host ms a request goes to stderr."""

import sys

from benchmark.common import spans

PHASES = ("generate/inputs", "generate/memory", "generate/prepare",
          "fused/launch")


def read(rec):
    sample = spans.intervals(rec, "generate/sample")
    n = len(rec["requests"])
    if not sample or not n:
        return None
    own = spans.self_s(rec, "generate/sample", PHASES)
    parts = ", ".join(f"{p} {1e3 * spans.self_s(rec, p, ()) / n!r} "
                      f"({len(spans.intervals(rec, p))} spans)" for p in PHASES)
    print(f"generate/sample, host ms a request over {n} requests "
          f"({len(sample)} spans): its own {1e3 * own / n!r}, {parts}",
          file=sys.stderr)
    return 1e3 * spans.idle_s(rec, sample) / n
