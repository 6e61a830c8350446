"""PyTorch + CUDA port of the speech-driven gesture DDPM for NVIDIA Hopper.

Sibling of ``gesture_diffusion_tpu`` (the JAX reference, which this package
never imports).  Layout mirrors the reference package:

  * ``diffusion/``  schedules, respacing, q/p functions, the scan DDIM and
                    DDPM samplers, the bpd sweep;
  * ``ops/``        mel front-end and the fused DDIM/DDPM sampler (CUDA
                    kernel in ``csrc/fused_ddim.cu`` plus its plain-torch
                    version);
  * ``models/``     HA2G speech encoder, oneway cross-attention decoder,
                    the denoiser (s2g_v2, default, inpaint), ``build_model``;
  * ``generation/`` the serving ``Generator`` and ``GestureStream``;
  * ``interop/``    weights carried across from the JAX package.

Public functions take (N, T, C) tensors, as the JAX package does.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
