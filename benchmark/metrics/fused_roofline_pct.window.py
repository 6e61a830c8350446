"""The fused sampler's least time for one live window (operations at the bf16 peak or bytes at HBM bandwidth, the larger) over its device time."""

from benchmark.common.readers import fused_roofline_pct


def read(rec):
    return fused_roofline_pct(rec)
