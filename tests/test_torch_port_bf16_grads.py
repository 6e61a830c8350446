"""The bf16 encoder's train step (the flagship config's
``Train.encoder_dtype``), gradient by gradient.

At the width of ``tests/test_torch_port_training.py`` (d_pose 12,
d_model 32, 4 heads, 1 layer, batch 4, 8000-sample wav, 10-frame windows,
50 steps), on one set of weights, with t and noise drawn as the JAX step
draws them: the port's bf16-encoder step is held against its own float64
step, and the JAX package's bf16-encoder step against its own float64
step.  Held, in three groups of gradients (the SE-ResNet trunk's body:
conv1, bn1 and its four stages; the trunk's three heads; the rest of the
model), each taken as one vector:
  * every BatchNorm running statistic to twice the JAX package's error
    (worst tensor, max|d|/max|ref|);
  * the error |d|/|ref| to twice the JAX package's, and never above
    L2_CAP, below the 1.0 that a lost gradient reads;
  * the norm |g|/|ref| to NORM_BAND, which a halved or doubled gradient
    leaves.
In bf16 the trunk's body amplifies rounding about a hundredfold (its
float32 error against float64 is ~5e-6, its bf16 error ~0.5), so twice
JAX's error alone would put the body's bar above 1.0: the cap and the
norm band are what make a lost or scaled trunk gradient fail, and
``test_planted_gradient_faults_fail`` plants such faults and requires
the check to catch each.  The worst single tensor is printed, not held:
it compares two draws of noise.  The port reads the JAX front-end's mel,
so both of its runs see one input (the trunk turns a 1e-4 mel difference
into percents even in float32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.ops.audio import speech_frontend as jax_frontend
from gesture_diffusion_torch.diffusion import make_schedule
from gesture_diffusion_torch.interop import state_dict_from_jax
from gesture_diffusion_torch.models import speech_encoder
from gesture_diffusion_torch.training import make_adamw, make_train_step
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser
from gesture_diffusion_torch.models.factory import init_random_
from gesture_diffusion_tpu.interop.torch_import import import_torch_state_dict
from gesture_diffusion_tpu.models import DenoiserConfig as JaxConfig
from test_torch_port_training import (BETAS, DMS, HS, LOSS_PARAMS, N, TRUNK, TW,
                                      WAV, _bn_stats, _f64, _jax_draws,
                                      _jax_grads, _port)
from torch_port_common import D_POSE, seeded_wav

torch.set_num_threads(1)

RATIO = 2.0
L2_CAP = 0.8
NORM_BAND = (0.8, 1.25)
HEADS = tuple(f"{TRUNK}{kind}_{tag}." for kind in ("conv", "bn", "fc")
              for tag in ("low", "mid", "high"))


def _worst(grads, ref, names):
    """The worst max|g - ref| over the tensors ``names``, each relative to
    its own max|ref| but never to less than 1e-2 of the largest max|ref|
    (the key projections' dconv biases have a gradient of 0 in exact
    arithmetic, so both sides give noise)."""
    top = max(float(ref[k].double().abs().max()) for k in names)
    return max(float((grads[k].double() - ref[k].double()).abs().max())
               / max(float(ref[k].double().abs().max()), 1e-2 * top)
               for k in names)


def _l2(grads, ref, names):
    """|g - ref| / |ref| over the tensors ``names`` taken as one vector."""
    num = sum(float(((grads[k].double() - ref[k].double()) ** 2).sum()) for k in names)
    den = sum(float((ref[k].double() ** 2).sum()) for k in names)
    return (num / den) ** 0.5


def _inputs(seed=5):
    """(JAX config, numpy variables, batch) of the training tests' width.
    The weights are drawn in the port (``init_random_``: biases, affine
    scales and BN statistics off their init values) and carried to the JAX
    package with its torch importer, so no JAX init is compiled."""
    wav = seeded_wav(seed + 6, n=N, length=WAV)
    cfg = JaxConfig(d_pose=D_POSE, d_model=DMS, heads=HS, n_layers=1,
                    encoder_dtype="bfloat16")
    model = init_random_(GestureDenoiser(DenoiserConfig(
        d_pose=D_POSE, d_model=DMS, heads=HS, n_layers=1)),
        torch.Generator().manual_seed(seed))
    variables = import_torch_state_dict(model.state_dict(), cfg)
    poses = 0.5 * np.random.default_rng(seed + 7).normal(
        size=(N, TW, D_POSE)).astype(np.float32)
    return cfg, variables, {"pose": poses, "wav": wav}


def _port_step(cfg, variables, batch, t, noise, dtype):
    model, tensors = _port(cfg, variables, batch, dtype)
    step = make_train_step(model, make_schedule(BETAS),
                           make_adamw(model.parameters(), 0.0, 0.0),
                           lambda s: 0.0, LOSS_PARAMS)
    step(tensors, 0, t=torch.from_numpy(np.array(t)).long(),
         noise=torch.from_numpy(np.array(noise)).to(dtype))
    grads = {k: p.grad for k, p in model.named_parameters()}
    return grads, _bn_stats(model.state_dict())


def _groups(names):
    """name lists of the trunk's body, its heads and the rest."""
    trunk = [k for k in names if k.startswith(TRUNK)]
    heads = [k for k in trunk if k.startswith(HEADS)]
    return {"trunk body": [k for k in trunk if k not in heads],
            "trunk heads": heads,
            "rest": [k for k in names if not k.startswith(TRUNK)]}


def _norm_ratio(grads, ref, names):
    """|g| / |ref| over the tensors ``names`` taken as one vector."""
    num = sum(float((grads[k].double() ** 2).sum()) for k in names)
    den = sum(float((ref[k].double() ** 2).sum()) for k in names)
    return (num / den) ** 0.5


def _gradient_failures(port16, port64, jax16, jax64, groups):
    """The held gradient checks that fail, as strings; each group's
    readings are printed."""
    failures = []
    for group, sel in groups.items():
        found = {"jax": _l2(jax16, jax64, sel), "port": _l2(port16, port64, sel),
                 "port vs jax f64": _l2(port16, jax64, sel)}
        bar = min(RATIO * found["jax"], L2_CAP)
        norms = {"jax": _norm_ratio(jax16, jax64, sel),
                 "port": _norm_ratio(port16, port64, sel)}
        worst = {"jax": _worst(jax16, jax64, sel), "port": _worst(port16, port64, sel)}
        print(f"gradients ({group}, {len(sel)} tensors) against float64: "
              "|d|/|ref| " + ", ".join(f"{k} {v:.2e}" for k, v in found.items())
              + f" (bar {bar:.2e}); |g|/|ref| "
              + ", ".join(f"{k} {v:.3f}" for k, v in norms.items())
              + "; worst tensor max|d|/max|ref| (not held) "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
        for side in ("port", "port vs jax f64"):
            if not found[side] <= bar:
                failures.append(f"{group}: {side} |d|/|ref| {found[side]:.3e} > {bar:.3e}")
        if not NORM_BAND[0] <= norms["port"] <= NORM_BAND[1]:
            failures.append(f"{group}: |g|/|ref| {norms['port']:.3f} outside {NORM_BAND}")
    return failures


@pytest.fixture(scope="module")
def bf16_case():
    """The four runs' gradients and BN statistics, computed once."""
    cfg16, variables, batch = _inputs()
    cfg32 = dataclasses.replace(cfg16, encoder_dtype=None)
    t, noise = _jax_draws(jax.random.key(7), 0, batch["pose"].shape)

    _, g16, s16 = _jax_grads(cfg16, variables, batch, t, noise, LOSS_PARAMS)
    with jax.enable_x64(True):
        batch64 = {"pose": batch["pose"].astype(np.float64), "wav": batch["wav"]}
        _, g64, s64 = _jax_grads(cfg32, _f64(variables), batch64, t,
                                 noise.astype(np.float64), LOSS_PARAMS)
    jax16 = state_dict_from_jax({"params": g16, "batch_stats": s16}, cfg16)
    jax64 = state_dict_from_jax({"params": g64, "batch_stats": s64}, cfg32)
    names = [k for k, _ in _port(cfg32, variables, batch)[0].named_parameters()]

    frontend = jax.jit(jax_frontend)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(speech_encoder, "speech_frontend", lambda wav: torch.from_numpy(
            np.array(frontend(jnp.asarray(wav.numpy())))))
        port16, stats16 = _port_step(cfg16, variables, batch, t, noise, torch.float32)
        port64, stats64 = _port_step(cfg32, variables, batch, t, noise, torch.float64)
    return {"names": names, "jax16": jax16, "jax64": jax64, "port16": port16,
            "port64": port64, "stats16": stats16, "stats64": stats64}


def test_encoder_bf16_grads_and_bn_stats_no_worse_than_jax(bf16_case):
    c = bf16_case
    assert len(c["names"]) > 150
    assert next(iter(c["port64"].values())).dtype == torch.float64
    stats64 = c["stats64"]
    stats = {
        "jax": _worst(c["jax16"], c["jax64"], list(stats64)),
        "port": _worst(c["stats16"], stats64, list(stats64)),
        "port vs jax f64": _worst(c["stats16"], c["jax64"], list(stats64)),
    }
    assert len(stats64) == 2 * 39
    print("BN statistics, worst max|d|/max|ref| against float64: "
          + ", ".join(f"{k} {v:.2e}" for k, v in stats.items()))
    assert stats["port"] <= RATIO * stats["jax"], stats
    assert stats["port vs jax f64"] <= RATIO * stats["jax"], stats
    groups = _groups(c["names"])
    assert [len(v) for v in groups.values()] == [173, 18, len(c["names"]) - 191]
    # the premise of the bars: JAX's own bf16 step meets them
    for sel in groups.values():
        assert _l2(c["jax16"], c["jax64"], sel) < L2_CAP
        assert NORM_BAND[0] <= _norm_ratio(c["jax16"], c["jax64"], sel) <= NORM_BAND[1]
    failures = _gradient_failures(c["port16"], c["port64"], c["jax16"], c["jax64"],
                                  groups)
    assert not failures, failures


def _scaled(grads, prefix, factor, exclude=()):
    return {k: g * factor if k.startswith(prefix) and not k.startswith(exclude) else g
            for k, g in grads.items()}


PLANTED = {
    "trunk detached": lambda g: _scaled(g, TRUNK, 0.0),
    "trunk body detached": lambda g: _scaled(g, TRUNK, 0.0, exclude=HEADS),
    "trunk halved": lambda g: _scaled(g, TRUNK, 0.5),
    "trunk doubled": lambda g: _scaled(g, TRUNK, 2.0),
    "rest halved": lambda g: {k: v if k.startswith(TRUNK) else 0.5 * v
                              for k, v in g.items()},
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_gradient_faults_fail(bf16_case, fault):
    """A lost or scaled gradient in the port's bf16 step fails the check."""
    c = bf16_case
    planted = PLANTED[fault](c["port16"])
    assert _gradient_failures(planted, c["port64"], c["jax16"], c["jax64"],
                              _groups(c["names"]))
