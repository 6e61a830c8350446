"""Operations and bytes that a cell's work needs, from its shapes alone.

``fused_flops`` counts the products of one call of the fused DDIM
sampler (the whole reverse process of the oneway decoder), 2 operations a
multiply-add.  Only memory rows 0 and 1 (the step token and its
neighbour through the depthwise conv) change from step to step, so the
memory's keys and values are counted once a call, and two rows a step.
``fused_bytes`` counts each input of that call once and its output once,
the weights as the bfloat16 the configuration serves them in.  Everything
else (the speech encoder, the eager decoder step) is counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
the meta device: shapes only, nothing computed.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def fused_flops(n, t, nm, d, dp, f, layers, steps) -> float:
    """Operations of the fused sampler's products for ``n`` clips of ``t``
    frames, ``nm`` memory rows (the token row included), width ``d``,
    ``dp`` pose channels, FF width ``f``, over ``steps`` steps."""
    per_layer = (2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d     # self
                 + 2 * t * d * d + 2 * 2 * d * 2 * d
                 + 2 * 2 * t * nm * d + 2 * t * d * d                     # cross
                 + 2 * 2 * t * d * f)                                     # FF
    per_step = 2 * t * dp * d + layers * per_layer + 2 * t * d * dp
    once = layers * 2 * nm * d * 2 * d
    return float(n) * (steps * per_step + once)


def decoder_weight_count(ref) -> int:
    """Parameters the fused sampler reads: the decoder and the step
    encoder of the reference (the same shapes as the program's)."""
    return sum(p.numel() for mod in (ref.pose_decoder,
                                     ref.diffusion_step_encoder)
               for p in mod.parameters())


def fused_bytes(ref, n, t, nm, d, dp, steps) -> float:
    """Bytes one fused call must move: the weights once as bfloat16, x_T
    and the output, the two blend tensors of the seeded window, the
    memory rows, the step coefficients (4 float32 a step) and the
    timestep map (int64)."""
    acts = 4 * n * t * dp * 4
    return float(decoder_weight_count(ref) * 2 + acts
                 + 4 * n * nm * d + steps * (16 + 8))


def counted(fn, *args) -> float:
    """Operations of ``fn(*args)`` by FlopCounterMode (meta tensors in)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def encoder_flops(ref, n: int, wav_len: int) -> float:
    """The speech encoder over ``n`` windows of ``wav_len`` samples (the
    front-end's FFT has no count and is left out)."""
    return counted(ref.encode, torch.zeros(n, wav_len, device="meta"))


def memory_rows(ref, wav_len: int) -> int:
    """Speech memory rows of one window, the token row not counted."""
    return ref.encode(torch.zeros(1, wav_len, device="meta")).shape[1]


def denoise_flops(ref, n: int, t: int, dp: int, m: int, d: int) -> float:
    """One eager denoiser step of ``n`` clips against ``m`` memory rows."""
    return counted(ref.denoise, torch.zeros(n, t, dp, device="meta"),
                   torch.zeros(n, dtype=torch.int64, device="meta"),
                   torch.zeros(n, m, d, device="meta"))
