"""The fused sampler's least time for one window batch of a sequence over its device time."""

from benchmark.common.readers import fused_roofline_pct


def read(rec):
    return fused_roofline_pct(rec)
