"""The port's model-zoo stacks against the JAX package's, on the CPU.

``models/glide_unet.py`` (the GLIDE UNet, dims 1 and 2, class
conditioning, ``resblock_updown`` with encoder keys and values,
``num_head_channels``, ``num_heads_upsample``, no conv resample, and the
three wrappers), ``models/primer.py`` (encoder and decoder, with masks) and
``models/speech_encoder.py::SEBottleneck`` (with and without the
projection, train mode with its BatchNorm statistics, and eval mode), at
small sizes in float32.  Weights go both ways: the port's ``state_dict``
into JAX through the JAX package's own importers
(``import_glide_unet_state_dict``, ``import_primer_stack``,
``_se_bottleneck``), and flax params into the port through
``interop.{glide_unet,primer,se_bottleneck}_state_dict_from_jax`` with a
strict load.  Every weight is moved off its init (the zero-initialised
output convs included), so that each carries into the output.  Outputs
are held within 1e-5 of max|ref|.  The cases mirror
``tests/test_glide_unet.py`` and ``tests/test_primer_stacks.py``, with the
JAX modules in place of the reference checkout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_torch.interop import (glide_unet_state_dict_from_jax,
                                             primer_state_dict_from_jax,
                                             se_bottleneck_state_dict_from_jax)
from gesture_diffusion_torch.models import glide_unet as pglide
from gesture_diffusion_torch.models import primer as pprimer
from gesture_diffusion_torch.models.speech_encoder import SEBottleneck
from gesture_diffusion_tpu.interop import import_glide_unet_state_dict
from gesture_diffusion_tpu.interop.torch_import import (_se_bottleneck,
                                                        import_primer_stack)
from gesture_diffusion_tpu.models import glide_unet as jglide
from gesture_diffusion_tpu.models import primer as jprimer
from gesture_diffusion_tpu.models.speech_encoder import SEBottleneck as JaxSEBottleneck

from torch_port_common import rel_err

torch.set_num_threads(1)

BAR = 1e-5                         # of max |ref|


def _perturb_port(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter moved by N(0, 0.05), BatchNorm statistics drawn."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    return model


def _perturb_jax(tree, seed: int):
    """Every leaf moved by N(0, 0.05) (variances kept positive)."""
    rng = np.random.default_rng(seed)

    def move(path, v):
        v = np.asarray(v)
        step = rng.normal(0, 0.05, v.shape).astype(v.dtype)
        return np.abs(v + step) if path[-1].key == "var" else v + step
    return jax.tree_util.tree_map_with_path(move, tree)


def _cl(x):
    """channel-first -> channel-last (the JAX modules' layout)."""
    return jnp.asarray(np.moveaxis(np.asarray(x), 1, -1))


def _cf(x):
    return np.moveaxis(np.asarray(x), -1, 1)


# -- GLIDE UNet ---------------------------------------------------------------------

def test_timestep_embedding_matches_jax():
    t = np.array([0, 3, 500, 999], np.int32)
    for dim in (32, 33):
        got = pglide.timestep_embedding(torch.from_numpy(t), dim)
        ref = jglide.timestep_embedding(jnp.asarray(t), dim)
        assert tuple(got.shape) == ref.shape and rel_err(got, ref) < BAR


# name -> (wrapper, UNet keywords, input shape, extra inputs' shapes)
GLIDE_CASES = {
    "2d_class_conditional": (None, dict(
        in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
        attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
        num_classes=5, use_scale_shift_norm=True), (2, 3, 8, 8), {}),
    "2d_updown_encoder_kv_head_channels": (None, dict(
        in_channels=2, model_channels=32, out_channels=2, num_res_blocks=1,
        attention_resolutions=(1, 2), channel_mult=(1, 2),
        num_head_channels=16, resblock_updown=True, encoder_channels=12),
        (1, 2, 8, 8), {"encoder_out": (1, 12, 7)}),
    "1d_additive_heads_upsample": (None, dict(
        in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
        attention_resolutions=(1,), channel_mult=(1, 2), num_heads=4,
        num_heads_upsample=2, dims=1), (2, 4, 16), {}),
    "1d_no_conv_resample": (None, dict(
        in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
        attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
        conv_resample=False, use_scale_shift_norm=True, dims=1), (2, 4, 16), {}),
    "superres": ("SuperResGlideUNet", dict(
        in_channels=2, model_channels=32, out_channels=2, num_res_blocks=1,
        attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2),
        (1, 2, 8, 8), {"low_res": (1, 2, 4, 4)}),
    "inpaint": ("InpaintGlideUNet", dict(
        in_channels=2, model_channels=32, out_channels=2, num_res_blocks=1,
        attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2),
        (1, 2, 8, 8), {"inpaint_image": (1, 2, 8, 8), "inpaint_mask": (1, 1, 8, 8)}),
    "superres_inpaint_1d": ("SuperResInpaintGlideUNet", dict(
        in_channels=2, model_channels=32, out_channels=2, num_res_blocks=1,
        attention_resolutions=(1,), channel_mult=(1, 2), num_heads=2,
        use_scale_shift_norm=True, dims=1),
        (2, 2, 16), {"inpaint_image": (2, 2, 16), "inpaint_mask": (2, 1, 16),
                     "low_res": (2, 2, 8)}),
}
_CONFIG_FACTOR = {None: (1, 0), "SuperResGlideUNet": (2, 0),
                  "InpaintGlideUNet": (2, 1), "SuperResInpaintGlideUNet": (3, 1)}


def _glide_inputs(name):
    wrapper, kw, shape, extra = GLIDE_CASES[name]
    rng = np.random.default_rng(sorted(GLIDE_CASES).index(name))
    inputs = {"x": rng.normal(size=shape).astype(np.float32),
              "timesteps": rng.integers(0, 1000, shape[0]).astype(np.int32)}
    for k, s in extra.items():
        inputs[k] = (rng.uniform(size=s) > 0.5).astype(np.float32) if k == \
            "inpaint_mask" else rng.normal(size=s).astype(np.float32)
    if kw.get("num_classes"):
        inputs["y"] = rng.integers(0, kw["num_classes"], shape[0]).astype(np.int32)
    return inputs


def _glide_port(name, inputs, state_dict=None, seed=0):
    wrapper, kw, _, _ = GLIDE_CASES[name]
    cls = getattr(pglide, wrapper or "GlideUNet")
    torch.manual_seed(seed)
    model = cls(**kw).eval()
    if state_dict is None:
        _perturb_port(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    args = {k: torch.from_numpy(v) for k, v in inputs.items()}
    args = {k: (v.long() if k in ("timesteps", "y") else v) for k, v in args.items()}
    with torch.no_grad():
        out = model(args.pop("x"), args.pop("timesteps"), **args)
    return model, out


def _glide_jax(name, inputs, params=None, seed=0):
    """(params of the bare UNet, output in channel-first layout)."""
    wrapper, kw, _, _ = GLIDE_CASES[name]
    k, extra = _CONFIG_FACTOR[wrapper]
    unet = jglide.GlideUNet(**dict(kw, in_channels=kw["in_channels"] * k + extra))
    net = unet if wrapper is None else getattr(jglide, wrapper)(unet)
    args = {key: (jnp.asarray(v) if key in ("timesteps", "y") else _cl(v))
            for key, v in inputs.items()}
    x, t = args.pop("x"), args.pop("timesteps")
    # jitted: op by op, flax compiles each op on its own (up to 12 s a case)
    if wrapper == "SuperResGlideUNet":
        call = jax.jit(lambda v: net.apply(v, x, t, args["low_res"]))
    else:
        call = jax.jit(lambda v: net.apply(v, x, t, **args))
    if params is None:
        init = jax.jit(unet.init if wrapper is None else net.init)
        if wrapper == "SuperResGlideUNet":
            variables = init(jax.random.key(seed), x, t, args["low_res"])
        else:
            variables = init(jax.random.key(seed), x, t, **args)
        variables = _perturb_jax(jax.tree.map(np.asarray, variables), seed)
        params = variables["params"] if wrapper is None else variables["params"]["unet"]
    variables = {"params": params if wrapper is None else {"unet": params}}
    return params, _cf(call(variables))


def _structure(name):
    _, kw, _, _ = GLIDE_CASES[name]
    return dict(num_res_blocks=kw["num_res_blocks"],
                attention_resolutions=kw["attention_resolutions"],
                channel_mult=kw["channel_mult"],
                conv_resample=kw.get("conv_resample", True),
                resblock_updown=kw.get("resblock_updown", False),
                num_classes=kw.get("num_classes"))


@pytest.mark.parametrize("name", sorted(GLIDE_CASES))
def test_glide_port_weights_into_jax(name):
    inputs = _glide_inputs(name)
    model, out = _glide_port(name, inputs)
    params = import_glide_unet_state_dict(model.state_dict(), **_structure(name))
    _, ref = _glide_jax(name, inputs, params=params)
    assert tuple(out.shape) == ref.shape and rel_err(out, ref) < BAR, name


@pytest.mark.parametrize("name", sorted(GLIDE_CASES))
def test_glide_jax_weights_into_port(name):
    inputs = _glide_inputs(name)
    params, ref = _glide_jax(name, inputs, seed=1)
    sd = glide_unet_state_dict_from_jax(params, **_structure(name))
    _, out = _glide_port(name, inputs, state_dict=sd)
    assert tuple(out.shape) == ref.shape and rel_err(out, ref) < BAR, name


def test_glide_attention_block_with_encoder_matches_jax():
    """One block on its own, 2-D, with the encoder's keys and values."""
    rng = np.random.default_rng(5)
    h = rng.normal(size=(2, 32, 4, 6)).astype(np.float32)
    enc = rng.normal(size=(2, 12, 7)).astype(np.float32)
    blk = _perturb_port(pglide.GlideAttentionBlock(
        32, num_head_channels=8, encoder_channels=12), 5).eval()
    assert blk.heads == 4
    with torch.no_grad():
        out = blk(torch.from_numpy(h), torch.from_numpy(enc))
    from gesture_diffusion_tpu.interop.torch_import import _glide_attn

    params = _glide_attn({f"b.{k}": v for k, v in blk.state_dict().items()}, "b")
    ref = jglide.GlideAttentionBlock(num_head_channels=8, encoder_channels=12).apply(
        {"params": params}, _cl(h), _cl(enc))
    assert rel_err(out, _cf(ref)) < BAR
    with pytest.raises(ValueError, match="divisible"):
        pglide.GlideAttentionBlock(32, num_head_channels=12)


def test_glide_refuses_bad_inputs():
    model = pglide.GlideUNet(3, 32, 3, 1, (2,), channel_mult=(1, 2), num_classes=4)
    x, t = torch.zeros(1, 3, 8, 8), torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="class-conditional"):
        model(x, t)
    with pytest.raises(ValueError, match="rank-4"):
        model(x[..., 0], t, y=t)
    with pytest.raises(ValueError, match="dims"):
        pglide.GlideUNet(3, 32, 3, 1, (2,), dims=3)


# -- Primer-EZ ----------------------------------------------------------------------

D_X, D_MODEL, HEADS, LAYERS, T, T_MEM, N = 9, 32, 4, 2, 6, 5, 2


def _primer_inputs(with_src):
    rng = np.random.default_rng(3 + with_src)
    inputs = {"x": rng.normal(size=(N, T, D_X)).astype(np.float32)}
    if with_src:
        inputs["memory"] = rng.normal(size=(N, T_MEM, D_MODEL)).astype(np.float32)
        # a causal self-attention mask and a source mask hiding the last
        # memory row of the second clip
        inputs["mask"] = np.tril(np.ones((T, T), bool))[None, :, :, None]
        src = np.ones((N, 1, T_MEM, 1), bool)
        src[1, :, -1] = False
        inputs["src_mask"] = src
    else:
        pad = np.ones((N, 1, T, 1), bool)
        pad[0, :, -2:] = False                    # two padded keys in clip 0
        inputs["mask"] = pad
    return inputs


def _primer_cls(m, with_src):
    return m.PrimerEZDecoder if with_src else m.PrimerEZEncoder


@pytest.mark.parametrize("with_src", [False, True], ids=["encoder", "decoder"])
@pytest.mark.parametrize("direction", ["port_into_jax", "jax_into_port"])
def test_primer_matches_jax(with_src, direction):
    inputs = _primer_inputs(with_src)
    d_out = None if with_src else 5
    net = _primer_cls(jprimer, with_src)(d_x=D_X, d_model=D_MODEL, heads=HEADS,
                                         n_layers=LAYERS, d_out=d_out)
    args = {k: jnp.asarray(v) for k, v in inputs.items()}
    torch.manual_seed(0)
    model = _primer_cls(pprimer, with_src)(D_X, D_MODEL, HEADS, LAYERS,
                                           d_out=d_out).eval()
    if direction == "port_into_jax":
        _perturb_port(model, 0)
        params = import_primer_stack(model.state_dict(), LAYERS, with_src)
    else:
        params = _perturb_jax(jax.tree.map(np.asarray, jax.jit(net.init)(
            jax.random.key(2), **args)), 2)["params"]
        model.load_state_dict(primer_state_dict_from_jax(params, LAYERS, with_src),
                              strict=True)
    ref = net.apply({"params": params}, **args)
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    assert tuple(out.shape) == ref.shape and rel_err(out, ref) < BAR


def test_primer_decoder_needs_memory():
    layer = pprimer.PrimerLayer(D_MODEL, HEADS, with_src=True)
    with pytest.raises(ValueError, match="memory"):
        layer(torch.zeros(1, T, D_MODEL))


# -- SEBottleneck ---------------------------------------------------------------------

# name -> (inplanes, planes, stride, projection)
SE_CASES = {"projection": (16, 8, 2, True), "identity": (32, 8, 1, False)}


def _stats_of(model):
    """The port's running statistics as the JAX tree's names."""
    sd = model.state_dict()
    names = {"bn1": "bn1", "bn2": "bn2", "bn3": "bn3", "proj_bn": "downsample.1"}
    return {j: {"mean": sd[f"{t}.running_mean"].numpy(),
                "var": sd[f"{t}.running_var"].numpy()}
            for j, t in names.items() if f"{t}.running_mean" in sd}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(SE_CASES))
@pytest.mark.parametrize("direction", ["port_into_jax", "jax_into_port"])
def test_se_bottleneck_matches_jax(case, train, direction):
    inplanes, planes, stride, proj = SE_CASES[case]
    x = np.random.default_rng(9).normal(size=(2, inplanes, 12, 16)).astype(np.float32)
    net = JaxSEBottleneck(planes=planes, stride=stride, use_projection=proj)
    torch.manual_seed(0)
    model = SEBottleneck(inplanes, planes, stride)
    assert (model.downsample is not None) == proj
    if direction == "port_into_jax":
        _perturb_port(model, 4)
        sd = {f"b.{k}": v for k, v in model.state_dict().items()}
        params, stats = _se_bottleneck(sd, "b", has_proj=proj)
        variables = {"params": params, "batch_stats": stats}
    else:
        variables = _perturb_jax(jax.tree.map(np.asarray, jax.jit(
            lambda key, v: net.init(key, v, train=False))(jax.random.key(4), _cl(x))), 4)
        model.load_state_dict(se_bottleneck_state_dict_from_jax(variables),
                              strict=True)
    model.train(train)
    if train:
        ref, updates = net.apply(variables, _cl(x), train=True,
                                 mutable=["batch_stats"])
    else:
        ref = net.apply(variables, _cl(x), train=False)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert tuple(out.shape) == _cf(ref).shape and rel_err(out, _cf(ref)) < BAR
    if train:
        want = jax.tree.map(np.asarray, updates["batch_stats"])
        got = _stats_of(model)
        assert sorted(got) == sorted(want)
        for bn in want:
            for k in ("mean", "var"):
                assert rel_err(got[bn][k], want[bn][k]) < BAR, (bn, k)
