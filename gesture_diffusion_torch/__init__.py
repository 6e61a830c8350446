"""PyTorch + CUDA port of the speech-driven gesture DDPM for NVIDIA Hopper.

Sibling of ``gesture_diffusion_tpu`` (the JAX reference, which this package
never imports).  Layout mirrors the reference package:

  * ``diffusion/``  schedules, respacing, the scan DDIM sampler;
  * ``ops/``        mel front-end and the fused DDIM sampler (CUDA kernel
                    in ``csrc/fused_ddim.cu`` plus its plain-torch version);
  * ``models/``     HA2G speech encoder, oneway cross-attention decoder,
                    the denoiser, ``build_model``;
  * ``generation/`` the serving ``Generator``;
  * ``interop/``    weights carried across from the JAX package.

Public functions take (N, T, C) tensors, as the JAX package does.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
