"""PyTorch + CUDA port of the speech-driven gesture DDPM for NVIDIA Hopper.

Sibling of ``gesture_diffusion_tpu`` (the JAX reference, which this package
never imports).  Layout mirrors the reference package:

  * ``diffusion/``  schedules, respacing, q/p functions, the scan DDIM and
                    DDPM samplers, the bpd sweep;
  * ``ops/``        mel front-end, the fused DDIM/DDPM sampler (CUDA
                    kernel in ``csrc/fused_ddim.cu`` plus its plain-torch
                    version), rotation math, the feature scaler and the
                    skeleton graphs of the GCN decoder;
  * ``data/``       BVH parsing and writing, the skeleton's forward
                    kinematics, the pose converter, the windowed dataset;
  * ``models/``     HA2G speech encoder; the four decoders of the JAX
                    factory (oneway and joint-stream cross-attention,
                    cross-attention GCN, UNet); the denoiser (s2g_v2,
                    default, inpaint), ``build_model``;
  * ``generation/`` the serving ``Generator`` (the fused kernel for the
                    oneway decoder, the scan sampler for the others) and
                    ``GestureStream``, the beat metrics, the FGD evaluator;
  * ``training/``   losses, AdamW, schedules, checkpoints, the ``Trainer``
                    (one process, or one rank of a data-parallel group);
  * ``parallel/``   process groups (NCCL on the card, gloo on the CPU) and
                    the data-axis device mesh of training and serving;
  * ``interop/``    weights carried across from the JAX package;
  * ``cli.py``      the phase CLI (prep, data, train, eval, eval-time, gen).

Public functions take (N, T, C) tensors, as the JAX package does.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
