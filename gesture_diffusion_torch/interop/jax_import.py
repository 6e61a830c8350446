"""Weights from the JAX package into the port's ``state_dict``.

``state_dict_from_jax(variables, cfg)`` is the exact inverse of the JAX
package's ``interop/torch_import.py::import_torch_state_dict`` for all
four decoders (oneway, cross-attention, GCN, UNet) and all three model
types (the inpaint type's conditioning MLP is flax
``inpaint_proj/layers_{0,2,4}`` and ``proj.{0,2,4}`` here).  Its siblings
invert the importers of the model zoo's other stacks:
``glide_unet_state_dict_from_jax`` (``import_glide_unet_state_dict``; the
GLIDE UNet and, given their ``params["unet"]``, its three wrappers),
``primer_state_dict_from_jax`` (``import_primer_stack``) and
``se_bottleneck_state_dict_from_jax`` (``_se_bottleneck``).
``jax_checkpoint_state_dict`` takes a JAX CLI checkpoint as
``flax_msgpack.load`` reads it (``best_params`` with the state's
BatchNorm statistics) and ``jax_params_state_dict`` a params tree alone
(a fine-tuning start).  Input: the
JAX ``{"params", "batch_stats"}`` tree as numpy arrays (anything
``np.asarray`` accepts).  Output: tensors under the reference checkpoint's
names, which are the port modules' own names.

Layout conversions:
  * Dense ``kernel`` (I, O)            -> Linear ``weight`` (O, I)
  * Conv HWIO (kh, kw, I, O)           -> Conv2d OIHW (O, I, kh, kw)
  * 1-D conv (k, I, O)                 -> Conv1d (O, I, k)
  * Dense (I, O) of a 1x1 conv         -> Conv1d (O, I, 1) / Conv2d (O, I, 1, 1)
    (channel order kept: the UNet's head-major QKV and the graph conv's
    partition-major outputs carry over as they are)
  * depthwise conv taps (3, d_k)       -> grouped Conv1d (d_k, 1, 3)
  * BatchNorm scale/bias + mean/var    -> weight/bias + running_mean/var
  * LayerNorm / GroupNorm scale/bias   -> weight/bias
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


def _conv_nd(sd: dict, prefix: str, p: Mapping) -> None:
    """flax channel-last kernel (*k, I, O) -> torch (O, I, *k)."""
    w = np.moveaxis(np.asarray(p["kernel"]), (-1, -2), (0, 1))
    sd[f"{prefix}.weight"] = _t(w)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv1_from_dense(sd: dict, prefix: str, p: Mapping, ndim: int = 1) -> None:
    """Dense (I, O) -> a 1x1 conv's (O, I, 1[, 1])."""
    w = np.asarray(p["kernel"]).T
    sd[f"{prefix}.weight"] = _t(w.reshape(w.shape + (1,) * ndim))
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


def _cross_layer(sd: dict, lp: str, lj: Mapping, with_ff_mem: bool) -> None:
    _layernorm(sd, f"{lp}.norm_self_attn", lj["norm_self_attn"])
    _mha(sd, f"{lp}.self_attn", lj["self_attn"])
    _layernorm(sd, f"{lp}.norm_self_attn_mem", lj["norm_self_attn_mem"])
    _mha(sd, f"{lp}.self_attn_mem", lj["self_attn_mem"])
    _layernorm(sd, f"{lp}.norm_cross_attn", lj["norm_cross_attn"])
    _mha(sd, f"{lp}.cross_attn", lj["cross_attn"])
    _layernorm(sd, f"{lp}.norm_ff", lj["norm_ff"])
    _linear(sd, f"{lp}.feed_forward.layer1", lj["ff"]["layer1"])
    _linear(sd, f"{lp}.feed_forward.layer2", lj["ff"]["layer2"])
    if with_ff_mem:
        _layernorm(sd, f"{lp}.norm_ff_mem", lj["norm_ff_mem"])
        _linear(sd, f"{lp}.feed_forward_mem.layer1", lj["ff_mem"]["layer1"])
        _linear(sd, f"{lp}.feed_forward_mem.layer2", lj["ff_mem"]["layer2"])


def _cross_decoder(sd: dict, base: str, p: Mapping, n_layers: int) -> None:
    _linear(sd, f"{base}.emb_x", p["emb_x"])
    _linear(sd, f"{base}.emb_mem", p["emb_mem"])
    for i in range(n_layers):
        _cross_layer(sd, f"{base}.layers.{i}", p[f"layer{i}"], i < n_layers - 1)
    _layernorm(sd, f"{base}.out_layers.0", p["out_norm"])
    _linear(sd, f"{base}.out_layers.1", p["out_proj"])


def _gcn_decoder(sd: dict, base: str, p: Mapping, n_layers: int) -> None:
    _linear(sd, f"{base}.emb_x", p["emb_x"])
    _linear(sd, f"{base}.emb_mem", p["emb_mem"])
    for i in range(n_layers):
        lp, lj = f"{base}.layers.{i}", p[f"layer{i}"]
        _layernorm(sd, f"{lp}.norm_gcn", lj["norm_gcn"])
        _conv1_from_dense(sd, f"{lp}.gcn.conv", lj["gcn"]["proj"], ndim=2)
        _cross_layer(sd, lp, lj["attn"], i < n_layers - 1)
    _linear(sd, f"{base}.out_layers", p["out_proj"])


def _unet_res_block(sd: dict, prefix: str, p: Mapping) -> None:
    _layernorm(sd, f"{prefix}.in_layers.0", p["norm_in"])
    _conv_nd(sd, f"{prefix}.in_layers.2", p["conv_in"])
    _linear(sd, f"{prefix}.emb_layers.1", p["emb_proj"])
    _layernorm(sd, f"{prefix}.out_layers.0", p["norm_out"])
    _conv_nd(sd, f"{prefix}.out_layers.3", p["conv_out"])
    if "skip_proj" in p:
        _conv_nd(sd, f"{prefix}.skip_connection", p["skip_proj"])


def _unet_attn_block(sd: dict, prefix: str, p: Mapping) -> None:
    _layernorm(sd, f"{prefix}.norm", p["norm"])
    _conv1_from_dense(sd, f"{prefix}.qkv", p["qkv"])
    _conv1_from_dense(sd, f"{prefix}.proj_out", p["proj_out"])
    if "encoder_kv" in p:
        _conv1_from_dense(sd, f"{prefix}.encoder_kv", p["encoder_kv"])


def _unet_decoder(sd: dict, base: str, p: Mapping, cfg) -> None:
    """Walks the block-construction loop of the JAX importer's
    ``_unet_decoder`` (GLIDE's), so torch block indices line up with the
    flax layer names."""
    channel_mult = tuple(cfg.channel_mult)
    attn_res = set(cfg.attention_resolutions)
    nrb = cfg.n_layers
    _linear(sd, f"{base}.time_embed.0", p["time_embed_0"])
    _linear(sd, f"{base}.time_embed.2", p["time_embed_2"])
    u = p["unet"]
    _conv_nd(sd, f"{base}.input_blocks.0.0", u["conv_in"])
    ds, ti = 1, 1
    for level in range(len(channel_mult)):
        for i in range(nrb):
            _unet_res_block(sd, f"{base}.input_blocks.{ti}.0", u[f"down_{level}_{i}"])
            if ds in attn_res:
                _unet_attn_block(sd, f"{base}.input_blocks.{ti}.1",
                                 u[f"down_attn_{level}_{i}"])
            ti += 1
        if level != len(channel_mult) - 1:
            _conv_nd(sd, f"{base}.input_blocks.{ti}.0.op", u[f"downsample_{level}"])
            ti += 1
            ds *= 2
    _unet_res_block(sd, f"{base}.middle_block.0", u["middle_res1"])
    _unet_attn_block(sd, f"{base}.middle_block.1", u["middle_attn"])
    _unet_res_block(sd, f"{base}.middle_block.2", u["middle_res2"])
    for oi in range(len(channel_mult) * (nrb + 1)):
        level = len(channel_mult) - 1 - oi // (nrb + 1)
        i = oi % (nrb + 1)
        _unet_res_block(sd, f"{base}.output_blocks.{oi}.0", u[f"up_{level}_{i}"])
        li = 1
        if ds in attn_res:
            _unet_attn_block(sd, f"{base}.output_blocks.{oi}.{li}",
                             u[f"up_attn_{level}_{i}"])
            li += 1
        if level and i == nrb:
            _conv_nd(sd, f"{base}.output_blocks.{oi}.{li}.conv",
                     u[f"upsample_{level}"])
            ds //= 2
    _layernorm(sd, f"{base}.out.0", u["norm_out"])
    _conv_nd(sd, f"{base}.out.2", u["conv_out"])


# GlideUNet's ResBlock is UNetAttn's under other flax names
_GLIDE_RES_NAMES = {"in_norm": "norm_in", "in_conv": "conv_in",
                    "emb_proj": "emb_proj", "out_norm": "norm_out",
                    "out_conv": "conv_out", "skip": "skip_proj"}


def _glide_res(sd: dict, prefix: str, p: Mapping) -> None:
    _unet_res_block(sd, prefix, {_GLIDE_RES_NAMES[k]: v for k, v in p.items()})


_DECODERS = {
    "oneway_cross_attention":
        lambda sd, p, cfg: _oneway_decoder(sd, "pose_decoder", p, cfg.n_layers),
    "cross_attention":
        lambda sd, p, cfg: _cross_decoder(sd, "pose_decoder", p, cfg.n_layers),
    "cross_attention_gcn":
        lambda sd, p, cfg: _gcn_decoder(sd, "pose_decoder", p, cfg.n_layers),
    "unet_attention":
        lambda sd, p, cfg: _unet_decoder(sd, "pose_decoder", p, cfg),
}


def state_dict_from_jax(variables: Mapping, cfg) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``{"params", "batch_stats"}`` -> port ``state_dict``.  ``cfg`` is
    either package's ``DenoiserConfig`` (only its fields are read)."""
    if cfg.decoder_type not in _DECODERS:
        raise ValueError(f"Unsupported decoder type {cfg.decoder_type!r}")
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
    _DECODERS[cfg.decoder_type](sd, params["decoder"], cfg)
    if cfg.model_type == "s2g_v2":
        _linear(sd, "blend_layer", params["blend_layer"])
    if cfg.model_type == "inpaint":
        for i in (0, 2, 4):
            _linear(sd, f"proj.{i}", params["inpaint_proj"][f"layers_{i}"])
    return sd


def jax_checkpoint_state_dict(tree: Mapping, cfg) -> "OrderedDict[str, torch.Tensor]":
    """A JAX CLI checkpoint (``{"state": TrainState, "best_params"}``, as
    ``interop.flax_msgpack.load`` reads it) -> the port's state dict to
    serve: ``best_params`` with the last state's BatchNorm statistics, the
    pairing of the JAX CLI's eval."""
    return state_dict_from_jax({"params": tree["best_params"],
                                "batch_stats": tree["state"]["batch_stats"]}, cfg)


class _NoStats(dict):
    """The batch statistics of a tree that has none: every one reads 0."""

    def __getitem__(self, key):
        return 0.0 if key in ("mean", "var") else self


def jax_params_state_dict(params: Mapping, cfg) -> "OrderedDict[str, torch.Tensor]":
    """A flax ``params`` tree -> the port's parameters under their names;
    the BatchNorm statistics, which ``params`` does not hold, are left
    out (a fine-tuning start keeps its own, as the JAX trainer's
    ``load_start_params`` does)."""
    sd = state_dict_from_jax({"params": params, "batch_stats": _NoStats()}, cfg)
    return OrderedDict((k, v) for k, v in sd.items() if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))


def motion_ae_state_dict_from_jax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's FGD ``MotionAE`` variables (``{"params": ...}``)
    -> the port's ``generation/fgd.py::MotionAE`` state dict: flax
    ``Conv_i`` / ``LayerNorm_i`` / ``Dense_i`` are ``convs.{i}`` /
    ``norms.{i}`` / ``fcs.{i}``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    kinds = {"Conv": ("convs", _conv_nd), "LayerNorm": ("norms", _layernorm),
             "Dense": ("fcs", _linear)}
    for part in ("encoder", "decoder"):
        for name, p in variables["params"][part].items():
            kind, i = name.rsplit("_", 1)
            attr, convert = kinds[kind]
            convert(sd, f"{part}.{attr}.{i}", p)
    return sd


def glide_unet_state_dict_from_jax(
        params: Mapping, num_res_blocks: int, attention_resolutions,
        channel_mult=(1, 2, 4, 8), conv_resample: bool = True,
        resblock_updown: bool = False,
        num_classes: "int | None" = None) -> "OrderedDict[str, torch.Tensor]":
    """The JAX ``GlideUNet``'s params (a wrapper's ``params["unet"]``) ->
    the port's ``models/glide_unet.py`` state dict; walks the block loop of
    the JAX importer, so torch block indices line up with the flax names."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    attn_res = set(attention_resolutions)
    _linear(sd, "time_embed.0", params["time_embed_0"])
    _linear(sd, "time_embed.2", params["time_embed_2"])
    if num_classes is not None:
        sd["label_emb.weight"] = _t(params["label_emb"]["embedding"])
    _conv_nd(sd, "input_blocks.0.0", params["input_0_conv"])
    ds, ti = 1, 1
    for level in range(len(channel_mult)):
        for _ in range(num_res_blocks):
            _glide_res(sd, f"input_blocks.{ti}.0", params[f"input_{ti}_res"])
            if ds in attn_res:
                _unet_attn_block(sd, f"input_blocks.{ti}.1",
                                 params[f"input_{ti}_attn"])
            ti += 1
        if level != len(channel_mult) - 1:
            if resblock_updown:
                _glide_res(sd, f"input_blocks.{ti}.0", params[f"input_{ti}_down"])
            elif conv_resample:
                _conv_nd(sd, f"input_blocks.{ti}.0.op", params[f"input_{ti}_down"])
            ti += 1
            ds *= 2
    _glide_res(sd, "middle_block.0", params["middle_res1"])
    _unet_attn_block(sd, "middle_block.1", params["middle_attn"])
    _glide_res(sd, "middle_block.2", params["middle_res2"])
    for oi in range(len(channel_mult) * (num_res_blocks + 1)):
        level = len(channel_mult) - 1 - oi // (num_res_blocks + 1)
        i = oi % (num_res_blocks + 1)
        _glide_res(sd, f"output_blocks.{oi}.0", params[f"output_{oi}_res"])
        li = 1
        if ds in attn_res:
            _unet_attn_block(sd, f"output_blocks.{oi}.{li}",
                             params[f"output_{oi}_attn"])
            li += 1
        if level and i == num_res_blocks:
            if resblock_updown:
                _glide_res(sd, f"output_blocks.{oi}.{li}", params[f"output_{oi}_up"])
            elif conv_resample:
                _conv_nd(sd, f"output_blocks.{oi}.{li}.conv",
                         params[f"output_{oi}_up"])
            ds //= 2
    _layernorm(sd, "out.0", params["out_norm"])
    _conv_nd(sd, "out.2", params["out_conv"])
    return sd


def primer_state_dict_from_jax(params: Mapping, n_layers: int,
                               with_src: bool) -> "OrderedDict[str, torch.Tensor]":
    """The JAX ``PrimerEZEncoder`` (``with_src=False``) or
    ``PrimerEZDecoder`` params -> the port's ``models/primer.py`` state
    dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _linear(sd, "pe.linear", params["pe"]["linear"])
    for i in range(n_layers):
        lp, lj = f"layers.{i}", params[f"layer{i}"]
        _layernorm(sd, f"{lp}.norm_self_attn", lj["norm_self_attn"])
        _mha(sd, f"{lp}.self_attn", lj["self_attn"])
        if with_src:
            _layernorm(sd, f"{lp}.norm_src_attn", lj["norm_src_attn"])
            _mha(sd, f"{lp}.src_attn", lj["src_attn"])
        _layernorm(sd, f"{lp}.norm_ff", lj["norm_ff"])
        _linear(sd, f"{lp}.feed_forward.layer1", lj["ff"]["layer1"])
        _linear(sd, f"{lp}.feed_forward.layer2", lj["ff"]["layer2"])
    _layernorm(sd, "out_layers.0", params["out_norm"])
    _linear(sd, "out_layers.1", params["out_proj"])
    return sd


def se_bottleneck_state_dict_from_jax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """The JAX ``SEBottleneck``'s ``{"params", "batch_stats"}`` -> the
    port's ``models/speech_encoder.py::SEBottleneck`` state dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k in (1, 2, 3):
        _conv(sd, f"conv{k}", p[f"conv{k}"])
        _bn(sd, f"bn{k}", p[f"bn{k}"], s[f"bn{k}"])
    _linear(sd, "se.fc.0", p["se"]["Dense_0"])
    _linear(sd, "se.fc.2", p["se"]["Dense_1"])
    if "proj_conv" in p:
        _conv(sd, "downsample.0", p["proj_conv"])
        _bn(sd, "downsample.1", p["proj_bn"], s["proj_bn"])
    return sd
