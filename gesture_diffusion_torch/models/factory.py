"""Config-driven construction of the model and its diffusion schedules.

Port of ``gesture_diffusion_tpu/models/factory.py`` over the flat config
schema of ``configs/beat-ours.json`` and ``configs/tedexp-ours.json``, for
all four decoders of the JAX factory and the port's ``mmdit``
(``Decoder`` ``{type, heads, n_layers}``, d_model / heads channels a
head).  ``build_model`` places the model on the card unless the caller
passes ``device="cpu"``.  The optimizer and its learning-rate
schedule are built in ``training`` (``make_optimizer``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..diffusion import Schedule, make_diffusion
from ..utils.device import resolve_device
from .denoiser import DECODER_TYPES, DenoiserConfig, GestureDenoiser

SUPPORTED_DECODERS = DECODER_TYPES


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter and BN statistic from ``generator`` (on the
    CPU, so a seed gives the same weights on any device): Glorot-uniform
    weights (the zero-initialised UNet outputs too), small random biases,
    LayerNorm/GroupNorm/BN affine near identity, BN running statistics off
    (0, 1)."""
    def draw(shape):
        return torch.rand(shape, generator=generator) * 2.0 - 1.0

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            w = mod.weight
            if isinstance(mod, nn.Conv1d) and mod.groups > 1:
                fan_in = fan_out = w.shape[2]
            else:
                rf = w[0, 0].numel() if w.ndim > 2 else 1
                fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
            w.copy_(draw(w.shape) * math.sqrt(6.0 / (fan_in + fan_out)))
            if mod.bias is not None:
                mod.bias.copy_(0.02 * draw(mod.bias.shape))
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
            mod.weight.copy_(1.0 + 0.1 * draw(mod.weight.shape))
            mod.bias.copy_(0.1 * draw(mod.bias.shape))
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.copy_(0.1 * draw(mod.running_mean.shape))
                mod.running_var.copy_(1.0 + 0.2 * draw(mod.running_var.shape))
    return model


def build_model(d_pose: int, model_params, device=None,
                generator: Optional[torch.Generator] = None,
                encoder_dtype: Optional[str] = None,
                dtype: Optional[str] = None) -> GestureDenoiser:
    """Eval-mode ``GestureDenoiser`` on ``device`` (the card by default).
    With ``generator`` the weights are drawn from it (``init_random_``).
    ``dtype`` ("bfloat16" or None) is ``Train.dtype``, the whole model's
    compute dtype; ``encoder_dtype`` is ``Train.encoder_dtype``, the
    trunk's, which overrides it there."""
    dev = resolve_device(device)
    decoder_params = model_params.get("Decoder")
    if decoder_params.type not in SUPPORTED_DECODERS:
        raise ValueError(f"Unsupported decoder type {decoder_params.type}")
    encoder_params = model_params.get("Encoder")
    if encoder_params is not None and encoder_params.get("type", "ha2g") != "ha2g":
        raise ValueError(f"Unsupported encoder type {encoder_params.type}")
    gen = model_params.get("Generate")
    extras = {}
    if decoder_params.type == "cross_attention_gcn":
        extras = dict(graph_layout=decoder_params.get("graph_layout", "beat"),
                      graph_strategy=decoder_params.get("graph_strategy", "spatial"))
    elif decoder_params.type == "unet_attention":
        # the reference schema: num_res_blocks, channel_mult,
        # attention_resolutions, window_len, num_heads
        extras = dict(
            channel_mult=tuple(decoder_params.get("channel_mult", (1, 2, 4))),
            attention_resolutions=tuple(
                decoder_params.get("attention_resolutions", (1, 2, 4))),
            window_len=decoder_params.get("window_len", 40))
    model = GestureDenoiser(DenoiserConfig(
        d_pose=d_pose,
        d_model=model_params.d_model,
        heads=decoder_params.get("heads", decoder_params.get("num_heads", 8)),
        n_layers=decoder_params.get("n_layers",
                                    decoder_params.get("num_res_blocks", 4)),
        dropout=model_params.get("dropout_prob", 0.0),
        model_type=model_params.get("type", "s2g_v2"),
        decoder_type=decoder_params.type,
        pose_seed_len=(gen.get("pose_seed_len", 10) if gen is not None else 10),
        encoder_dtype=encoder_dtype,
        dtype=dtype,
        **extras,
    ))
    if generator is not None:
        init_random_(model, generator)
    return model.to(dev).eval()


class ModelBundle(NamedTuple):
    model: GestureDenoiser
    schedule: Schedule           # training schedule (full steps)
    timestep_map: torch.Tensor
    eval_schedule: Schedule      # respaced for sampling/eval
    eval_timestep_map: torch.Tensor


def build_all(config, d_pose: int, device=None,
              generator: Optional[torch.Generator] = None,
              encoder_dtype: Optional[str] = None,
              dtype: Optional[str] = None) -> ModelBundle:
    """The model and its diffusion schedules (training and respaced)."""
    model_params = config.Model
    model = build_model(d_pose, model_params, device=device,
                        generator=generator, encoder_dtype=encoder_dtype,
                        dtype=dtype)
    dp = model_params.get("Diffusion")
    if dp.get("type", "gaussian") != "gaussian":
        raise ValueError(f"Unsupported diffusion type {dp.type}")
    mvt = dp.get("model_var_type", "fixed_small")
    if mvt != "fixed_small":
        raise ValueError(f"Unsupported model_var_type {mvt!r}: only "
                         "'fixed_small' is implemented")
    sched, tmap = make_diffusion(dp.noise_schedule, dp.diffusion_steps,
                                 dp.get("timestep_respacing"), is_training=True)
    eval_sched, eval_tmap = make_diffusion(
        dp.noise_schedule, dp.diffusion_steps, dp.get("timestep_respacing"),
        is_training=False)
    return ModelBundle(model, sched, tmap, eval_sched, eval_tmap)
