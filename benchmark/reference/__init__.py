"""Plain PyTorch float32 reference of the served model, for the benchmark's
``correct``.

It follows the published description of the system (the reference
repository's ``models/`` and ``gaussian_diffusion.py``) in straightforward
torch operations: no kernels, no packed weights, no caches, no batching
tricks.  It imports nothing of the program under test.  Parameter names
are the reference checkpoint's, the names the program's ``state_dict``
uses too, so one state dict made by the benchmark loads into both.

  * ``audio``      — pre-emphasis, mel spectrogram, instance norm;
  * ``model``      — the HA2G speech encoder, the step encoder, the
                     decoders' building blocks, and the denoiser that joins
                     them;
  * ``decoders``   — one module a decoder type (oneway and joint-stream
                     cross-attention), found by the configuration's name;
  * ``model_types`` — one module a model type (s2g_v2, default), found
                     the same way;
  * ``diffusion``  — the linear schedule with ``ddimN`` respacing, the DDIM
                     loop with the x0 blend and its seed ramp, and the
                     window chaining of a long sequence.

Matrix products run in float32 with TF32 off (``float32_exact``).  A
model's ``operand`` hook rounds the operands of the decoder's products;
the identity by default, the benchmark's controls set a lower precision
there.
"""
