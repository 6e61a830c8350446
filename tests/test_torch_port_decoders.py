"""Port vs JAX: the decoders the JAX factory builds beside the oneway one
(``cross_attention``, ``cross_attention_gcn``, ``unet_attention``), for
each model type, and the pieces they rest on (``ops/graph.py``, the
weight importer, the UNet's zero-initialised output, the factory).

Weights are built by the JAX package, moved off their init values as
``tests/torch_port_common.py`` does (the UNet's zero-initialised kernels
redrawn), and carried into the port with ``state_dict_from_jax``.  Small
widths: cross_attention d_pose 12, d_model 32, 4 heads, 2 layers;
cross_attention_gcn d_pose 150, d_model 75, 3 heads, 2 layers (the 75
vertices of the ``beat`` layout, sized as ``tests/test_alt_decoders.py``
sizes it); unet_attention d_pose 12, d_model 32, 4 heads, one ResBlock per
level, ``channel_mult`` (1, 2), window 10 (padded to 12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.diffusion import linear_betas
from gesture_diffusion_tpu.diffusion import make_schedule as jax_make_schedule
from gesture_diffusion_tpu.interop import import_torch_state_dict
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_tpu.models import build_model as jax_build_model
from gesture_diffusion_tpu.ops import graph as jax_graph
from gesture_diffusion_tpu.training.train_state import assemble_losses as jax_assemble
from gesture_diffusion_tpu.training.trainer import _inpaint_kwargs as jax_inpaint_kwargs
from gesture_diffusion_tpu.utils import JsonConfig as JaxJsonConfig
from gesture_diffusion_torch.diffusion import make_schedule
from gesture_diffusion_torch.interop import state_dict_from_jax
from gesture_diffusion_torch.models import (DenoiserConfig, GestureDenoiser,
                                            build_model)
from gesture_diffusion_torch.models.unet_decoder import UNetAttn, _pad_lengths
from gesture_diffusion_torch.ops import graph
from gesture_diffusion_torch.training import make_adamw, make_train_step
from gesture_diffusion_torch.utils import JsonConfig
from torch_port_common import jax_variables, port_model, rel_err, seeded_wav

torch.set_num_threads(1)

N, TW, STEPS, WAV, SEED_LEN = 2, 10, 50, 8000, 4
BETAS = np.asarray(linear_betas(STEPS))
DECODERS = {
    "cross_attention": dict(d_pose=12, d_model=32, heads=4, n_layers=2),
    "cross_attention_gcn": dict(d_pose=150, d_model=75, heads=3, n_layers=2,
                                graph_layout="beat", graph_strategy="spatial"),
    "unet_attention": dict(d_pose=12, d_model=32, heads=4, n_layers=1,
                           channel_mult=(1, 2), attention_resolutions=(1, 2),
                           window_len=TW),
}
MODEL_TYPES = ("default", "s2g_v2", "inpaint")
# float32 both sides, sums in other orders: 1e-5 of max|ref| (found:
# below 1.2e-6)
TOL = 1e-5
# one train step in float64 on one mel: the loss terms to 1e-5 of their
# value, every gradient outside the SE-ResNet trunk to 3e-6 of the largest
# such gradient (the attention scores stay float32 in both packages)
LOSS_TOL, GRAD_TOL = 1e-5, 3e-6
LOSS_PARAMS = {"speed_loss": 0.1, "speed_l1_loss": 0.2,
               "speed_constraint_loss": 0.05}
TRUNK = "speech_encoder.wav_encoder.feat_extractor."


@pytest.fixture(scope="module",
                params=[(d, m) for d in DECODERS for m in MODEL_TYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """(decoder, model type, JAX config, numpy variables, inputs)."""
    decoder, model_type = request.param
    kw = DECODERS[decoder]
    seed = 11 + list(DECODERS).index(decoder) * 3 + MODEL_TYPES.index(model_type)
    wav = seeded_wav(seed, n=N, length=WAV)
    cfg, variables = jax_variables(model_type, wav=wav, seed=seed, t=TW,
                                   decoder_type=decoder,
                                   pose_seed_len=SEED_LEN, **kw)
    rng = np.random.default_rng(seed + 50)
    d_pose = kw["d_pose"]
    inputs = {"wav": wav,
              "x": rng.normal(size=(N, TW, d_pose)).astype(np.float32),
              "pose": 0.5 * rng.normal(size=(N, TW, d_pose)).astype(np.float32),
              "t": np.array([3, 41], np.int64),
              "noise": rng.normal(size=(N, TW, d_pose))}
    return decoder, model_type, cfg, variables, inputs


def _inpaint(model_type, pose):
    if model_type != "inpaint":
        return {}
    mask = np.zeros(pose.shape[:2] + (1,), pose.dtype)
    mask[:, :SEED_LEN] = 1.0
    return {"inpaint_pose": pose, "inpaint_mask": mask}


def _jax_step(cfg, variables, inputs):
    """The JAX train step's losses and gradients in float64 on the same
    batch, t and noise."""
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        model = JaxDenoiser(cfg)
        poses = jnp.asarray(inputs["pose"], jnp.float64)
        wav = jnp.asarray(inputs["wav"])
        extra = jax_inpaint_kwargs(model, poses)

        @jax.jit
        def run(params, stats):
            def loss_fn(params):
                def model_fn(x_t, tt):
                    out, _ = model.apply(
                        {"params": params, "batch_stats": stats}, x_t, tt, wav,
                        train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.key(0)}, **extra)
                    return out

                losses = jax_assemble(jax_make_schedule(BETAS), model_fn, poses,
                                      jnp.asarray(inputs["t"], jnp.int32),
                                      jnp.asarray(inputs["noise"]), LOSS_PARAMS)
                return losses["loss"], losses

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        (_, losses), grads = run(f64["params"], f64["batch_stats"])
        return jax.tree.map(np.asarray, (losses, grads))


def _share_mel(monkeypatch):
    """The port's encoder reads the JAX front-end's mel (the two differ by
    float32 FFT rounding, which the train-mode trunk amplifies; see
    tests/test_torch_port_training.py)."""
    from gesture_diffusion_torch.models import speech_encoder
    from gesture_diffusion_tpu.ops.audio import speech_frontend as jax_frontend

    monkeypatch.setattr(speech_encoder, "speech_frontend", lambda wav: torch.from_numpy(
        np.asarray(jax_frontend(jnp.asarray(wav.numpy())))))


def test_decoder_matches_jax(case, monkeypatch):
    """Per decoder x model type: ``denoise`` (through the whole forward) in
    float32 within 1e-5 of max|ref|, then one train step in float64: the
    loss terms within 1e-5, every gradient outside the SE-ResNet trunk
    within 3e-6 of max|g|."""
    decoder, model_type, cfg, variables, inputs = case
    model = port_model(cfg, variables)
    extra = _inpaint(model_type, inputs["pose"])
    ref = JaxDenoiser(cfg).apply(
        variables, jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"], jnp.int32),
        jnp.asarray(inputs["wav"]), train=False,
        **{k: jnp.asarray(v) for k, v in extra.items()})
    with torch.no_grad():
        ours = model(torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"]),
                     torch.from_numpy(inputs["wav"]),
                     **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert ours.shape == ref.shape
    assert rel_err(ours.numpy(), np.asarray(ref)) < TOL

    losses, grads = _jax_step(cfg, variables, inputs)
    _share_mel(monkeypatch)
    model = model.double()
    step = make_train_step(model, make_schedule(BETAS),
                           make_adamw(model.parameters(), 0.0, 0.0),
                           lambda s: 0.0, LOSS_PARAMS)
    metrics = step({"pose": torch.from_numpy(inputs["pose"]).double(),
                    "wav": torch.from_numpy(inputs["wav"])}, 0,
                   t=torch.from_numpy(inputs["t"]),
                   noise=torch.from_numpy(inputs["noise"]))
    for k, v in losses.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=LOSS_TOL), k
    ref_grads = state_dict_from_jax({"params": grads,
                                     "batch_stats": variables["batch_stats"]}, cfg)
    outside = {k: p.grad for k, p in model.named_parameters()
               if not k.startswith(TRUNK)}
    assert all(g is not None for g in outside.values())
    top = max(float(ref_grads[k].abs().max()) for k in outside)
    worst = max((float((g - ref_grads[k].double()).abs().max()) / top, k)
                for k, g in outside.items())
    print(f"{decoder} {model_type}: denoise {rel_err(ours.numpy(), np.asarray(ref)):.2e}, "
          f"worst gradient {worst[0]:.2e} of max|g| ({worst[1]})")
    assert worst[0] < GRAD_TOL, worst


def test_state_dict_round_trips_through_jax_importer(case):
    """``state_dict_from_jax`` is the exact inverse of the JAX package's
    ``import_torch_state_dict``: every tensor comes back bit for bit, and
    the port's module loads the dict strictly."""
    _, _, cfg, variables, _ = case
    sd = state_dict_from_jax(variables, cfg)
    back = import_torch_state_dict(sd, cfg)
    flat = jax.tree_util.tree_flatten_with_path
    ours, theirs = flat(back)[0], flat(variables)[0]
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    assert set(sd) == set(port_model(cfg, variables).state_dict())


@pytest.mark.parametrize("layout", sorted(graph.LAYOUTS))
@pytest.mark.parametrize("strategy", ["uniform", "distance", "spatial"])
def test_graph_equals_jax(layout, strategy):
    for max_hop in (1, 2):
        np.testing.assert_array_equal(
            graph.build_graph(layout, strategy, max_hop=max_hop),
            jax_graph.build_graph(layout, strategy, max_hop=max_hop))


def test_graph_rejects_unknown():
    with pytest.raises(ValueError, match="layout"):
        graph.build_graph("nope")
    with pytest.raises(ValueError, match="strategy"):
        graph.build_graph("beat", "nope")


def test_unet_zero_init_output_is_zero():
    """GLIDE's zero-initialised output conv: an untrained UNet gives 0, as
    JAX test_alt_decoders.py holds for the JAX module."""
    unet = UNetAttn(d_x=12, d_memory=32, d_model=32, heads=4, n_layers=1,
                    d_out=12, channel_mult=(1, 2), attention_resolutions=(1,),
                    window_len=10)
    with torch.no_grad():
        out = unet(torch.ones(1, 10, 12), torch.ones(1, 6, 32))
    assert out.shape == (1, 10, 12)
    assert float(out.abs().max()) == 0.0
    assert _pad_lengths(40, 2) == (0, 0) and _pad_lengths(10, 1) == (1, 1)
    with pytest.raises(NotImplementedError):
        _pad_lengths(11, 1)


@pytest.mark.parametrize("decoder", [
    {"type": "cross_attention", "heads": 4, "n_layers": 2},
    {"type": "cross_attention_gcn", "heads": 4, "n_layers": 1,
     "graph_layout": "lara", "graph_strategy": "distance"},
    {"type": "unet_attention", "num_heads": 4, "num_res_blocks": 2,
     "channel_mult": [1, 2], "attention_resolutions": [2], "window_len": 10},
], ids=lambda d: d["type"])
def test_factory_reads_config_as_jax(decoder):
    """``build_model`` reads a decoder's extras and the num_heads /
    num_res_blocks aliases as the JAX factory does: equal config fields,
    and the JAX importer's names are exactly the port module's."""
    d_pose, d_model = (57, 76) if decoder["type"] == "cross_attention_gcn" else (12, 32)
    block = {"type": "default", "d_model": d_model, "dropout_prob": 0.0,
             "Decoder": decoder, "Generate": {"pose_seed_len": 4}}
    ours = build_model(d_pose, JsonConfig(block), device="cpu").cfg
    ref = jax_build_model(d_pose, JaxJsonConfig(block)).cfg
    for field in ("d_pose", "d_model", "heads", "n_layers", "model_type",
                  "decoder_type", "pose_seed_len", "graph_layout",
                  "graph_strategy", "window_len"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert tuple(ours.channel_mult) == tuple(ref.channel_mult)
    assert tuple(ours.attention_resolutions) == tuple(ref.attention_resolutions)


def test_dropout_and_autograd_reach_every_decoder():
    """At p > 0 every decoder's Dropout modules fire in train mode and are
    the identity in eval mode, and a backward pass gives every decoder
    parameter a gradient."""
    p = 0.3
    g = torch.Generator().manual_seed(0)
    wav = torch.from_numpy(seeded_wav(2, n=N, length=WAV))
    for decoder, kw in DECODERS.items():
        if decoder == "cross_attention_gcn":
            # two channels a vertex: over one, the graph conv's LayerNorm
            # gives 0 and its weight no gradient
            kw = {**kw, "d_model": 150, "heads": 5}
        cfg = DenoiserConfig(model_type="default", decoder_type=decoder,
                             dropout=p, **kw)
        model = GestureDenoiser(cfg)
        for mod in model.modules():       # the UNet's zero outputs too
            if isinstance(mod, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d)):
                torch.nn.init.normal_(mod.weight, 0, 0.1, generator=g)
        x = torch.randn(N, TW, kw["d_pose"], generator=g)
        t = torch.tensor([2, 30])
        sites = [m for m in model.pose_decoder.modules()
                 if isinstance(m, torch.nn.Dropout)]
        assert sites and all(m.p == p for m in sites), decoder
        with torch.no_grad():
            a, b = model.eval()(x, t, wav), model(x, t, wav)
        assert torch.equal(a, b), decoder
        fired = []
        handles = [m.register_forward_hook(
            lambda mod, inp, out: fired.append(bool((out == 0).any())))
            for m in sites]
        out = model.train()(x, t, wav)
        for h in handles:
            h.remove()
        assert fired and any(fired), decoder
        out.square().mean().backward()
        missing = [k for k, q in model.pose_decoder.named_parameters()
                   if q.grad is None or not q.grad.abs().sum()]
        assert not missing, (decoder, missing)
