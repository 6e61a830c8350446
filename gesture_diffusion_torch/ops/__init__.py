"""Tensor ops: ``audio`` (mel front-end) and ``fused_sampler`` (the fused
DDIM kernel and its plain version).  Import the submodules directly: the
models import ``audio``, and ``fused_sampler`` imports the models."""
