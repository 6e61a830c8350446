"""Port vs JAX: schedules, respacing and the scan DDIM sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.diffusion import ddim_sample_loop as jax_ddim
from gesture_diffusion_tpu.diffusion import make_diffusion as jax_make
from gesture_diffusion_torch.diffusion import ddim_sample_loop, make_diffusion
from gesture_diffusion_torch.diffusion.gaussian import (predict_eps_from_xstart,
                                                        predict_xstart_from_eps)
from torch_port_common import rel_err

torch.set_num_threads(1)


@pytest.mark.parametrize("schedule", ["linear", "squaredcos_cap_v2"])
@pytest.mark.parametrize("respacing", [None, "ddim10", "fast27", "10,10,3,2,2"])
def test_schedule_and_timestep_map_match(schedule, respacing):
    # both sides compute the tables in float64 on the host and store them
    # as float32: the fields must be bit-identical
    sj, tj = jax_make(schedule, 100, respacing)
    sp, tp = make_diffusion(schedule, 100, respacing)
    assert sp._fields == sj._fields
    for name in sj._fields:
        a, b = np.asarray(getattr(sj, name)), getattr(sp, name).numpy()
        assert b.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))


def test_training_uses_full_schedule():
    sched, tmap = make_diffusion("linear", 100, "ddim10", is_training=True)
    assert sched.num_timesteps == 100
    np.testing.assert_array_equal(tmap.numpy(), np.arange(100))


def test_eps_xstart_round_trip():
    sched, _ = make_diffusion("linear", 100)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 5, 4)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(3, 5, 4)).astype(np.float32))
    t = torch.tensor([0, 50, 99])
    x0 = predict_xstart_from_eps(sched, x, t, eps)
    back = predict_eps_from_xstart(sched, x, t, x0)
    # float32 round trip through sqrt(1/acp) ~ 1e2 at t=99: relative 1e-4
    assert rel_err(back.numpy(), eps.numpy()) < 1e-4


def _model_fns(w):
    """The same simple eps model on both sides (isolates the sampler)."""
    def jfn(x, t):
        return jnp.tanh(x * w + t[:, None, None].astype(jnp.float32) / 1000.0)

    def tfn(x, t):
        return torch.tanh(x * torch.from_numpy(w) + t[:, None, None].float() / 1000.0)

    return jfn, tfn


@pytest.mark.parametrize("eta,blend", [(0.0, False), (0.0, True), (0.5, False)])
def test_scan_ddim_matches_jax(eta, blend):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(1, 1, 6)).astype(np.float32)
    noise = rng.normal(size=(2, 5, 6)).astype(np.float32)
    a = rng.normal(size=(2, 5, 6)).astype(np.float32)
    sj, tj = jax_make("linear", 100, "ddim10")
    sp, tp = make_diffusion("linear", 100, "ddim10")
    jfn, tfn = _model_fns(w)
    jblend = tblend = None
    if blend:
        def jblend(x0):
            return 0.5 * jnp.asarray(a) + 0.5 * x0

        def tblend(x0):
            return 0.5 * torch.from_numpy(a) + 0.5 * x0

    key = jax.random.key(7)
    ref = np.asarray(jax_ddim(sj, jfn, jnp.asarray(noise), key,
                              denoise_fn=jblend, timestep_map=tj, eta=eta))
    # the JAX loop draws z from key splits in step order S-1 .. 0; inject
    # the same draws into the port
    zs, k = {}, key
    for i in range(sj.num_timesteps - 1, -1, -1):
        k, sub = jax.random.split(k)
        zs[i] = torch.from_numpy(np.array(jax.random.normal(sub, noise.shape)))
    ours = ddim_sample_loop(sp, tfn, torch.from_numpy(noise),
                            denoise_fn=tblend, timestep_map=tp, eta=eta,
                            step_noise=zs.__getitem__).numpy()
    # float32 on both sides; reassociation through 10 steps: 1e-5 relative
    assert rel_err(ours, ref) < 1e-5
