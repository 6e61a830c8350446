"""Host ms of one scan-sampler step: the mean length of the program's ``sampler/step`` spans (the denoiser's call and the update); their count beside the traffic's windows x steps goes to stderr."""

import sys

from benchmark.common import spans


def read(rec):
    steps = spans.intervals(rec, "sampler/step")
    if not steps:
        return None
    w = rec["work"]
    print(f"sampler/step: {len(steps)} spans; the traffic's windows x steps "
          f"{w.get('windows')} x {w.get('steps')}", file=sys.stderr)
    return 1e3 * sum(b - a for a, b in steps) / len(steps)
