"""Kernels launched in the traced window over the eager denoiser steps in it."""

from benchmark.common.readers import kernels_per_step


def read(rec):
    return kernels_per_step(rec)
