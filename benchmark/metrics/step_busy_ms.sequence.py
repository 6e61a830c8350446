"""Device-busy ms (the union of device intervals) over the eager denoiser steps in the traced window."""

from benchmark.common.readers import busy_ms_per_step


def read(rec):
    return busy_ms_per_step(rec)
