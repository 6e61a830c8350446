"""Weights from the JAX package into the port's ``state_dict``.

``state_dict_from_jax(variables, cfg)`` is the exact inverse of the JAX
package's ``interop/torch_import.py::import_torch_state_dict`` for the
oneway decoder and all three model types (the inpaint type's conditioning
MLP is flax ``inpaint_proj/layers_{0,2,4}`` and ``proj.{0,2,4}`` here).  Input: the JAX
``{"params", "batch_stats"}`` tree as numpy arrays (anything
``np.asarray`` accepts).  Output: tensors under the reference checkpoint's
names, which are the port modules' own names.

Layout conversions:
  * Dense ``kernel`` (I, O)            -> Linear ``weight`` (O, I)
  * Conv HWIO (kh, kw, I, O)           -> Conv2d OIHW (O, I, kh, kw)
  * depthwise conv taps (3, d_k)       -> grouped Conv1d (d_k, 1, 3)
  * BatchNorm scale/bias + mean/var    -> weight/bias + running_mean/var
  * LayerNorm scale/bias               -> weight/bias
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

# SE-ResNet trunk: [3, 4, 6, 3] blocks
_RESNET_LAYERS = (3, 4, 6, 3)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _layernorm(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _dconv(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T[:, None, :])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _mha(sd: dict, prefix: str, p: Mapping) -> None:
    for name in ("query", "key", "value"):
        _linear(sd, f"{prefix}.{name}.0.linear", p[name])
        _dconv(sd, f"{prefix}.{name}.1.conv", p[f"{name}_dconv"])
    _linear(sd, f"{prefix}.output", p["output"])


def _resnet(sd: dict, base: str, p: Mapping, s: Mapping) -> None:
    _conv(sd, f"{base}.conv1", p["stem_conv"])
    _bn(sd, f"{base}.bn1", p["stem_bn"], s["stem_bn"])
    for k, blocks in enumerate(_RESNET_LAYERS, start=1):
        for b in range(blocks):
            name, prefix = f"layer{k}_block{b}", f"{base}.layer{k}.{b}"
            bp, bs = p[name], s[name]
            _conv(sd, f"{prefix}.conv1", bp["conv1"])
            _bn(sd, f"{prefix}.bn1", bp["bn1"], bs["bn1"])
            _conv(sd, f"{prefix}.conv2", bp["conv2"])
            _bn(sd, f"{prefix}.bn2", bp["bn2"], bs["bn2"])
            _linear(sd, f"{prefix}.se.fc.0", bp["se"]["Dense_0"])
            _linear(sd, f"{prefix}.se.fc.2", bp["se"]["Dense_1"])
            if "proj_conv" in bp:
                _conv(sd, f"{prefix}.downsample.0", bp["proj_conv"])
                _bn(sd, f"{prefix}.downsample.1", bp["proj_bn"], bs["proj_bn"])
    for tag in ("low", "mid", "high"):
        hp, hs = p[f"head_{tag}"], s[f"head_{tag}"]
        _conv(sd, f"{base}.conv_{tag}", hp["conv"])
        _bn(sd, f"{base}.bn_{tag}", hp["bn"], hs["bn"])
        _linear(sd, f"{base}.fc_{tag}", hp["fc"])


def _oneway_decoder(sd: dict, base: str, p: Mapping, n_layers: int) -> None:
    _linear(sd, f"{base}.emb_x", p["emb_x"])
    _linear(sd, f"{base}.emb_mem", p["emb_mem"])
    for i in range(n_layers):
        lp, lj = f"{base}.layers.{i}", p[f"layer{i}"]
        _layernorm(sd, f"{lp}.norm_self_attn", lj["norm_self_attn"])
        _mha(sd, f"{lp}.self_attn", lj["self_attn"])
        _layernorm(sd, f"{lp}.norm_cross_attn", lj["norm_cross_attn"])
        _mha(sd, f"{lp}.cross_attn", lj["cross_attn"])
        _layernorm(sd, f"{lp}.norm_ff", lj["norm_ff"])
        _linear(sd, f"{lp}.feed_forward.layer1", lj["ff"]["layer1"])
        _linear(sd, f"{lp}.feed_forward.layer2", lj["ff"]["layer2"])
    _layernorm(sd, f"{base}.out_layers.0", p["out_norm"])
    _linear(sd, f"{base}.out_layers.1", p["out_proj"])


def state_dict_from_jax(variables: Mapping, cfg) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``{"params", "batch_stats"}`` -> port ``state_dict``.  ``cfg`` is
    either package's ``DenoiserConfig`` (only its fields are read)."""
    if cfg.decoder_type != "oneway_cross_attention":
        raise NotImplementedError(
            f"decoder {cfg.decoder_type!r} is not ported yet")
    if cfg.model_type not in ("s2g_v2", "default", "inpaint"):
        raise ValueError(f"Unsupported model_type {cfg.model_type!r}")
    params, stats = variables["params"], variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    enc = params["speech_encoder"]
    _resnet(sd, "speech_encoder.wav_encoder.feat_extractor", enc["resnet"],
            stats["speech_encoder"]["resnet"])
    _linear(sd, "speech_encoder.wav_proj_layer", enc["wav_proj"])
    _linear(sd, "diffusion_step_encoder.proj.0",
            params["step_encoder"]["proj1"])
    _linear(sd, "diffusion_step_encoder.proj.2",
            params["step_encoder"]["proj2"])
    _oneway_decoder(sd, "pose_decoder", params["decoder"], cfg.n_layers)
    if cfg.model_type == "s2g_v2":
        _linear(sd, "blend_layer", params["blend_layer"])
    if cfg.model_type == "inpaint":
        for i in (0, 2, 4):
            _linear(sd, f"proj.{i}", params["inpaint_proj"][f"layers_{i}"])
    return sd
