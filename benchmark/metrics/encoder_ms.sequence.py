"""Device ms a window of a sequence in every operation but the fused sampler's: the speech encoder, memory rows, token table, blend tensors and the poses' copies."""

from benchmark.common.readers import other_ms_per_window


def read(rec):
    return other_ms_per_window(rec)
