"""Device ms a window in every operation but the fused sampler's: the speech encoder, the memory rows, the step-token table, the blend tensors."""

from benchmark.common.readers import other_ms_per_window


def read(rec):
    return other_ms_per_window(rec)
