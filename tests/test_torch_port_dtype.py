"""The whole-model compute dtype (``Train.dtype``, JAX
``DenoiserConfig.dtype``) of the port against the JAX package, on the CPU.

bf16 rounds, so the port's bf16 model is not held to JAX's bf16 model
bit for bit: both are held to the float64 model on the same weights (the
port's float64 step, which is JAX's: ``tests/test_torch_port_training.py``),
and the port's distance from it must be at most RATIO times JAX's own
bf16 distance, the method of ``tests/test_torch_port_bf16_grads.py``.
A single draw's bf16 distance is heavy-tailed (on one set of weights the
decoder's gradient error of either package reads 2.5e-2 to 9.9e-2 by the
draw of t and noise, the other package's staying near 3e-2), so each side
is read as its mean over DRAWS draws of t and noise (the forward and the
sample as their worst).  Cases: the oneway
decoder with the three model types, and the cross-attention, GCN and UNet
decoders with ``s2g_v2``, at the decoder tests' small widths (1 layer).
Each case holds the train-mode forward (the step's model output,
max|d|/max|ref|), the step's loss terms (to RATIO squared: a loss
term's bf16 error is mostly the bias that the output's error variance
adds to a mean square, so twice the output's error gives four times the
loss's; with a floor of one bf16 rounding, 2^-8, for a term that JAX
happens to land on), and its
gradients by group (``test_torch_port_bf16_grads``'s: the trunk's body,
its heads and the rest, each as one vector, |d|/|ref| to RATIO times
JAX's, and |g|/|ref| within NORM_BAND for the heads and the rest).  That
test's cap on the trunk body (0.8, below the 1.0 of a lost gradient) and
its band cannot hold here: with the decoder's backward in bf16 too, JAX's
own trunk-body error reads 0.53 to 1.57 and its norm up to 1.4 times
float64's, so the body is held to JAX's error alone.  A ddim50 scan
sample (oneway and cross-attention, eval mode) likewise.  The port reads the JAX front-end's
mel, as the bf16 gradient test does: the trunk turns a 1e-4 mel
difference into percents.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.diffusion import ddim_sample_loop as jax_ddim
from gesture_diffusion_tpu.diffusion import make_diffusion as jax_make_diffusion
from gesture_diffusion_tpu.diffusion import make_schedule as jax_make_schedule
from gesture_diffusion_tpu.interop.torch_import import import_torch_state_dict
from gesture_diffusion_tpu.models import DenoiserConfig as JaxConfig
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_tpu.ops.audio import speech_frontend as jax_frontend
from gesture_diffusion_tpu.training.train_state import assemble_losses as jax_assemble
from gesture_diffusion_tpu.training.trainer import _inpaint_kwargs as jax_inpaint_kwargs
from gesture_diffusion_torch.diffusion import ddim_sample_loop, make_diffusion, make_schedule
from gesture_diffusion_torch.generation import Generator
from gesture_diffusion_torch.interop import state_dict_from_jax
from gesture_diffusion_torch.models import (DenoiserConfig, GestureDenoiser, init_random_,
                                            speech_encoder)
from gesture_diffusion_torch.training import make_adamw, make_train_step
from test_torch_port_bf16_grads import NORM_BAND, _groups, _l2, _norm_ratio
from test_torch_port_training import BETAS, LOSS_PARAMS, STEPS
from torch_port_common import D_POSE, port_model, rel_err, seeded_wav

torch.set_num_threads(1)

RATIO = 2.0
FLOOR = 2.0 ** -8
DRAWS = 3
N = 2
CASES = {
    "oneway-s2g_v2": ("oneway_cross_attention", "s2g_v2", {}),
    "oneway-default": ("oneway_cross_attention", "default", {}),
    "oneway-inpaint": ("oneway_cross_attention", "inpaint", {}),
    "cross-s2g_v2": ("cross_attention", "s2g_v2", {}),
    "gcn-s2g_v2": ("cross_attention_gcn", "s2g_v2",
                   dict(d_pose=150, d_model=75, heads=3)),
    "unet-s2g_v2": ("unet_attention", "s2g_v2",
                    dict(channel_mult=(1, 2), attention_resolutions=(1, 2),
                         window_len=10)),
}
SAMPLED = ("oneway-s2g_v2", "cross-s2g_v2")


def _inputs(name):
    """(JAX config, variables, batch): the weights are drawn in the port
    (``init_random_``, every kernel and bias off its init value) and
    carried to the JAX package with its torch importer, so no JAX init
    runs."""
    decoder, model_type, kw = CASES[name]
    kw = {"d_pose": D_POSE, "d_model": 32, "heads": 4, "n_layers": 1,
          "decoder_type": decoder, "model_type": model_type, "pose_seed_len": 4, **kw}
    t = 10 if decoder == "unet_attention" else 8
    wav = seeded_wav(3, n=N)
    model = init_random_(GestureDenoiser(DenoiserConfig(**kw)),
                         torch.Generator().manual_seed(4))
    cfg = JaxConfig(**kw)
    variables = jax.tree.map(np.asarray, import_torch_state_dict(model.state_dict(), cfg))
    rng = np.random.default_rng(5)
    batch = {"pose": (0.5 * rng.normal(size=(N, t, cfg.d_pose))).astype(np.float32),
             "wav": wav}
    return cfg, variables, batch


def _port(cfg, variables, dtype):
    """The port's model on the JAX weights: bf16 compute, or float64."""
    model = port_model(cfg, variables)
    if dtype == torch.float64:
        return model.double()
    ours = GestureDenoiser(dataclasses.replace(model.cfg, dtype="bfloat16"))
    ours.load_state_dict(model.state_dict())
    return ours.eval()


def _jax_bf16_step(cfg, variables, batch):
    """JAX's bf16 train step as ``run(t, noise) -> (losses, grads,
    batch_stats, model output)``, jitted once."""
    model = JaxDenoiser(dataclasses.replace(cfg, dtype="bfloat16"))
    sched = jax_make_schedule(BETAS)
    poses, wav = jnp.asarray(batch["pose"]), jnp.asarray(batch["wav"])
    extra = jax_inpaint_kwargs(model, poses)

    @jax.jit
    def run(t, noise):
        def loss_fn(params):
            mutated = {}

            def model_fn(x_t, tt):
                out, mut = model.apply(
                    {"params": params, "batch_stats": variables["batch_stats"]},
                    x_t, tt, wav, train=True, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.key(0)}, **extra)
                mutated.update(stats=mut["batch_stats"], out=out)
                return out

            losses = jax_assemble(sched, model_fn, poses, t, noise, LOSS_PARAMS)
            return losses["loss"], (losses, mutated["stats"], mutated["out"])

        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
        return aux[0], grads, aux[1], aux[2].astype(jnp.float32)

    return run


def _port_step(model, batch, t, noise, dtype):
    """(losses, gradients, BN statistics, model output) of the port's step."""
    outs = []
    hook = model.register_forward_hook(lambda m, a, out: outs.append(out.detach()))
    step = make_train_step(model, make_schedule(BETAS),
                           make_adamw(model.parameters(), 0.0, 0.0),
                           lambda s: 0.0, LOSS_PARAMS)
    metrics = step({"pose": torch.from_numpy(batch["pose"]).to(dtype),
                    "wav": torch.from_numpy(batch["wav"])}, 0,
                   t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise).to(dtype))
    hook.remove()
    sd = model.state_dict()
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.double() for k, p in model.named_parameters()},
            {k: v.double() for k, v in sd.items()
             if k.endswith(("running_mean", "running_var"))},
            outs[0].double())


@pytest.fixture(scope="module", params=list(CASES))
def steps(request):
    """Each draw's JAX bf16, port bf16 and port float64 steps."""
    cfg, variables, batch = _inputs(request.param)
    mel = np.asarray(jax.jit(jax_frontend)(jnp.asarray(batch["wav"])))
    jax_run = _jax_bf16_step(cfg, variables, batch)
    rng = np.random.default_rng(8)
    draws = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(speech_encoder, "speech_frontend",
                   lambda wav: torch.from_numpy(mel).to(wav.device))
        for _ in range(DRAWS):
            t = rng.integers(0, STEPS, N)
            noise = rng.normal(size=batch["pose"].shape)
            losses, grads, stats, out = jax.tree.map(np.asarray, jax_run(
                jnp.asarray(t, jnp.int32), jnp.asarray(noise, jnp.float32)))
            jax16 = state_dict_from_jax({"params": grads, "batch_stats": stats}, cfg)
            draws.append({
                "jax16": ({k: float(v) for k, v in losses.items()},
                          {k: v.double() for k, v in jax16.items()}, None,
                          torch.from_numpy(out).double()),
                "port16": _port_step(_port(cfg, variables, None), batch, t,
                                     noise.astype(np.float32), torch.float32),
                "port64": _port_step(_port(cfg, variables, torch.float64), batch, t,
                                     noise, torch.float64)})
    return request.param, draws


def test_forward_and_losses_no_worse_than_jax(steps):
    """The step's model output (bf16, train mode) and its loss terms."""
    name, draws = steps
    out = {side: max(rel_err(d[side][3], d["port64"][3]) for d in draws)
           for side in ("jax16", "port16")}
    print(f"{name}: forward against float64, worst of {DRAWS} draws: "
          f"JAX bf16 {out['jax16']:.3e}, port bf16 {out['port16']:.3e}")
    assert out["port16"] <= RATIO * out["jax16"]
    for k in draws[0]["port64"][0]:
        if k == "grad_norm":
            continue
        err = {side: np.mean([abs(d[side][0][k] - d["port64"][0][k])
                              / abs(d["port64"][0][k]) for d in draws])
               for side in ("jax16", "port16")}
        print(f"{name}: {k} against float64: JAX bf16 {err['jax16']:.3e}, "
              f"port bf16 {err['port16']:.3e}")
        assert err["port16"] <= max(RATIO ** 2 * err["jax16"], FLOOR), k


def test_gradients_no_worse_than_jax(steps):
    name, draws = steps
    names = list(draws[0]["port64"][1])
    failures = []
    for group, sel in _groups(names).items():
        err = {side: np.mean([_l2(d[side][1], d["port64"][1], sel) for d in draws])
               for side in ("jax16", "port16")}
        bar = RATIO * err["jax16"]
        norms = [_norm_ratio(d["port16"][1], d["port64"][1], sel) for d in draws]
        print(f"{name}: gradients ({group}, {len(sel)} tensors) against float64, "
              f"mean of {DRAWS} draws: |d|/|ref| JAX bf16 {err['jax16']:.3e}, "
              f"port bf16 {err['port16']:.3e} (bar {bar:.3e}); port |g|/|ref| "
              + ", ".join(f"{v:.3f}" for v in norms))
        if not err["port16"] <= bar:
            failures.append(f"{group}: {err['port16']:.3e} > {bar:.3e}")
        if group != "trunk body" and not all(
                NORM_BAND[0] <= v <= NORM_BAND[1] for v in norms):
            failures.append(f"{group}: |g|/|ref| {norms} outside {NORM_BAND}")
    assert not failures, failures


@pytest.mark.parametrize("name", SAMPLED)
def test_ddim50_scan_sample_no_worse_than_jax(name):
    """The Generator's scan path on a bf16 model (the memory encoded once,
    each step in bf16, the update in float32) against JAX's
    ``ddim_sample_loop`` over its bf16 model, both against the port's
    float64 sample, worst of DRAWS noise draws."""
    cfg, variables, batch = _inputs(name)
    wav = batch["wav"]
    jsched, jtmap = jax_make_diffusion("linear", 1000, "ddim50", is_training=False)
    jmodel = JaxDenoiser(dataclasses.replace(cfg, dtype="bfloat16"))

    @jax.jit
    def jax_sample(noise):
        mem = jmodel.apply(variables, jnp.asarray(wav), method=JaxDenoiser.encode_memory)
        fn = lambda x, t: jmodel.apply(variables, x, t, mem, method=JaxDenoiser.denoise)
        return jax_ddim(jsched, fn, noise, jax.random.key(0), timestep_map=jtmap)

    mel = np.asarray(jax.jit(jax_frontend)(jnp.asarray(wav)))
    sched, tmap = make_diffusion("linear", 1000, "ddim50")
    gen = Generator(_port(cfg, variables, None), sched, tmap, use_fused=False,
                    device="cpu")
    model64 = _port(cfg, variables, torch.float64)
    rng = np.random.default_rng(9)
    err = {"jax16": 0.0, "port16": 0.0}
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(speech_encoder, "speech_frontend", lambda w: torch.from_numpy(mel))
        mem64 = model64.encode_memory(torch.from_numpy(wav))
        for _ in range(DRAWS):
            noise = rng.normal(size=batch["pose"].shape)
            ref = ddim_sample_loop(sched.to(torch.float64),
                                   lambda x, t: model64.denoise(x, t, mem64),
                                   torch.from_numpy(noise), timestep_map=tmap)
            ours = gen.generate_sample(
                torch.from_numpy(wav), cfg.d_pose, noise.shape[1],
                noise=torch.from_numpy(noise.astype(np.float32)))
            assert ours.dtype == torch.float32
            theirs = np.asarray(jax_sample(jnp.asarray(noise, jnp.float32)))
            err["jax16"] = max(err["jax16"], rel_err(theirs, ref))
            err["port16"] = max(err["port16"], rel_err(ours, ref))
    assert gen.last_sample_path == "scan"
    print(f"{name}: ddim50 against float64, worst of {DRAWS} draws: JAX bf16 "
          f"{err['jax16']:.3e}, port bf16 {err['port16']:.3e}")
    assert err["port16"] <= RATIO * err["jax16"]


def test_dtype_threads_through_every_module():
    """Every Linear, conv and LayerNorm of each decoder and type computes
    in bf16, the parameters stay float32, and the trunk takes
    ``encoder_dtype or dtype``."""
    from gesture_diffusion_torch.models import compute_dtype

    for decoder, model_type, kw in CASES.values():
        cfg = DenoiserConfig(decoder_type=decoder, model_type=model_type,
                             **{"d_pose": 12, "d_model": 32, "heads": 4, **kw},
                             dtype="bfloat16")
        model = GestureDenoiser(cfg)
        layers = [m for m in model.modules() if isinstance(
            m, (compute_dtype.Linear, compute_dtype.Conv1d, compute_dtype.LayerNorm))]
        assert layers and {m.compute_dtype for m in layers} == {torch.bfloat16}
        # the depthwise convs cast in SpatialDepthWiseConv itself
        outside = [n for n, m in model.named_modules()
                   if type(m) in (torch.nn.Linear, torch.nn.Conv1d, torch.nn.LayerNorm)
                   and not n.startswith("speech_encoder") and not n.endswith(".1.conv")]
        assert outside == [], outside
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        assert model.speech_encoder.encoder_dtype == torch.bfloat16
    both = GestureDenoiser(DenoiserConfig(d_pose=12, d_model=32, heads=4,
                                          dtype="bfloat16", encoder_dtype="float16"))
    assert both.speech_encoder.encoder_dtype == torch.float16
