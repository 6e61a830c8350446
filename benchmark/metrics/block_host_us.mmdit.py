"""Host us of one MMDiT block: the mean length of the program's ``mmdit/block`` spans (both streams' modulation, the joint attention, both gated MLPs); to stderr their count beside the traffic's windows x steps, and the host us a block of each inner span."""

import sys

from benchmark.common import spans

PARTS = ("mmdit/modulation", "mmdit/joint_attention", "mmdit/feed_forward")


def read(rec):
    blocks = spans.intervals(rec, "mmdit/block")
    if not blocks:
        return None
    n = len(blocks)
    w = rec["work"]
    steps = (w.get("windows") or 0) * (w.get("steps") or 0)
    per_step = f"{n / steps!r} a step" if steps else "no steps counted"
    parts = ", ".join(f"{p} {1e6 * spans.self_s(rec, p, ()) / n!r} "
                      f"({len(spans.intervals(rec, p))} spans)" for p in PARTS)
    own = spans.self_s(rec, "mmdit/block", PARTS)
    print(f"mmdit/block: {n} spans over the traffic's windows x steps "
          f"{w.get('windows')} x {w.get('steps')} ({per_step}); host us a "
          f"block: {parts}, the block's own {1e6 * own / n!r}", file=sys.stderr)
    return 1e6 * sum(b - a for a, b in blocks) / n
