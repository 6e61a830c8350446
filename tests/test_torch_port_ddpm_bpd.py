"""Port vs JAX: the forward and posterior functions, the likelihood
helpers, the scan DDPM sampler and the bpd sweep, on a simple eps model
shared by both sides (which isolates the diffusion code), float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu import diffusion as jd
from gesture_diffusion_tpu.diffusion import gaussian as jg
from gesture_diffusion_tpu.diffusion import losses as jl
from gesture_diffusion_tpu.diffusion import sampling as jsamp
from gesture_diffusion_torch import diffusion as td
from torch_port_common import rel_err

torch.set_num_threads(1)

SHAPE = (3, 5, 6)
# float32 on both sides, elementwise formulas: a few ulps
ELEM_TOL = 2e-6


def _arr(seed, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _model_fns(w):
    def jfn(x, t):
        return jnp.tanh(x * w + t[:, None, None].astype(jnp.float32) / 100.0)

    def tfn(x, t):
        return torch.tanh(x * torch.from_numpy(w) + t[:, None, None].float() / 100.0)

    return jfn, tfn


@pytest.fixture(scope="module")
def scheds():
    sj, tj = jd.make_diffusion("linear", 100, "ddim10")
    sp, tp = td.make_diffusion("linear", 100, "ddim10")
    return sj, tj, sp, tp


def test_q_functions_match(scheds):
    sj, _, sp, _ = scheds
    x0, noise, xt = _arr(1), _arr(2), _arr(3)
    t = np.array([0, 4, 9])
    jt, tt = jnp.asarray(t.astype(np.int32)), torch.from_numpy(t)
    ref = jg.q_sample(sj, jnp.asarray(x0), jt, jnp.asarray(noise))
    ours = td.q_sample(sp, torch.from_numpy(x0), tt, torch.from_numpy(noise))
    assert rel_err(ours.numpy(), ref) < ELEM_TOL
    for a, b in zip(td.q_mean_variance(sp, torch.from_numpy(x0), tt),
                    jg.q_mean_variance(sj, jnp.asarray(x0), jt)):
        assert a.shape == b.shape and rel_err(a.numpy(), b) < ELEM_TOL
    for a, b in zip(
            td.q_posterior_mean_variance(sp, torch.from_numpy(x0),
                                         torch.from_numpy(xt), tt),
            jg.q_posterior_mean_variance(sj, jnp.asarray(x0), jnp.asarray(xt), jt)):
        assert a.shape == b.shape and rel_err(a.numpy(), b) < ELEM_TOL


def test_q_sample_passes_x_start_through_at_t_minus_one(scheds):
    sp = scheds[2]
    x0, noise = torch.from_numpy(_arr(4)), torch.from_numpy(_arr(5))
    out = td.q_sample(sp, x0, torch.tensor([-1, 3, -1]), noise)
    np.testing.assert_array_equal(out[0].numpy(), x0[0].numpy())
    np.testing.assert_array_equal(out[2].numpy(), x0[2].numpy())
    assert not np.allclose(out[1].numpy(), x0[1].numpy())


@pytest.mark.parametrize("blend", [False, True])
def test_p_mean_variance_matches(scheds, blend):
    sj, _, sp, _ = scheds
    w, x, a = _arr(6, (1, 1, 6)), _arr(7), _arr(8)
    jfn, tfn = _model_fns(w)
    t = np.array([0, 5, 9])
    jblend = tblend = None
    if blend:
        def jblend(x0):
            return 0.25 * jnp.asarray(a) + 0.75 * x0

        def tblend(x0):
            return 0.25 * torch.from_numpy(a) + 0.75 * x0

    ref = jg.p_mean_variance(sj, jfn, jnp.asarray(x),
                             jnp.asarray(t.astype(np.int32)), denoise_fn=jblend)
    ours = td.p_mean_variance(sp, tfn, torch.from_numpy(x), torch.from_numpy(t),
                              denoise_fn=tblend)
    assert set(ours) == set(ref)
    for k in ref:
        # sqrt(1/acp - 1) ~ 1e2 at the last step amplifies float32 tanh
        # differences in x0: 1e-5 relative
        assert rel_err(ours[k].numpy(), ref[k]) < 1e-5, k
    same = np.allclose(ours["raw_x_start"].numpy(), ours["pred_x_start"].numpy())
    assert same != blend


def test_likelihood_helpers_match():
    m1, lv1, m2, lv2 = _arr(9), 0.3 * _arr(10), _arr(11), 0.3 * _arr(12)
    ref = jl.normal_kl(*(jnp.asarray(v) for v in (m1, lv1, m2, lv2)))
    ours = td.normal_kl(*(torch.from_numpy(v) for v in (m1, lv1, m2, lv2)))
    assert rel_err(ours.numpy(), ref) < ELEM_TOL
    # scalars as the second mean / log-variance, as prior_bpd passes them
    ref0 = jl.normal_kl(jnp.asarray(m1), jnp.asarray(lv1), 0.0, 0.0)
    ours0 = td.normal_kl(torch.from_numpy(m1), torch.from_numpy(lv1), 0.0, 0.0)
    assert rel_err(ours0.numpy(), ref0) < ELEM_TOL
    ref = jl.continuous_gaussian_log_likelihood(
        jnp.asarray(m1), means=jnp.asarray(m2), log_scales=jnp.asarray(lv1))
    ours = td.continuous_gaussian_log_likelihood(
        torch.from_numpy(m1), means=torch.from_numpy(m2),
        log_scales=torch.from_numpy(lv1))
    assert rel_err(ours.numpy(), ref) < ELEM_TOL


def _jax_step_noise(key, num_steps, shape):
    """The JAX scan samplers' z per step: ``key, sub = split(key)`` and
    ``normal(sub)`` in step order S-1 .. 0 (step 0's draw is discarded)."""
    zs = {}
    for i in range(num_steps - 1, -1, -1):
        key, sub = jax.random.split(key)
        zs[i] = torch.from_numpy(np.array(jax.random.normal(sub, shape)))
    return zs


@pytest.mark.parametrize("blend", [False, True])
def test_scan_ddpm_matches_jax(scheds, blend):
    sj, tj, sp, tp = scheds
    w, noise, a = _arr(13, (1, 1, 6)), _arr(14), _arr(15)
    jfn, tfn = _model_fns(w)
    jblend = tblend = None
    if blend:
        def jblend(x0):
            return 0.5 * jnp.asarray(a) + 0.5 * x0

        def tblend(x0):
            return 0.5 * torch.from_numpy(a) + 0.5 * x0

    key = jax.random.key(16)
    ref = np.asarray(jd.ddpm_sample_loop(sj, jfn, jnp.asarray(noise), key,
                                         denoise_fn=jblend, timestep_map=tj))
    zs = _jax_step_noise(key, sj.num_timesteps, noise.shape)
    ours = td.ddpm_sample_loop(sp, tfn, torch.from_numpy(noise),
                               denoise_fn=tblend, timestep_map=tp,
                               step_noise=zs.__getitem__).numpy()
    # float32 on both sides; reassociation through 10 steps: 1e-5 relative
    assert rel_err(ours, ref) < 1e-5
    # step 0 adds no noise: a different z there changes nothing
    zs[0] = zs[0] + 100.0
    again = td.ddpm_sample_loop(sp, tfn, torch.from_numpy(noise),
                                denoise_fn=tblend, timestep_map=tp,
                                step_noise=zs.__getitem__).numpy()
    np.testing.assert_array_equal(again, ours)


def test_scan_ddpm_draws_from_generator(scheds):
    _, _, sp, tp = scheds
    _, tfn = _model_fns(_arr(17, (1, 1, 6)))
    noise = torch.from_numpy(_arr(18))
    runs = [td.ddpm_sample_loop(sp, tfn, noise, timestep_map=tp,
                                generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    np.testing.assert_array_equal(runs[0].numpy(), runs[1].numpy())
    assert not np.allclose(runs[0].numpy(), runs[2].numpy())


def _jax_bpd_noise(key, num_steps, shape):
    """The JAX sweep's noise at timestep t: normal(fold_in(rng, t))."""
    return np.stack([np.array(jax.random.normal(jax.random.fold_in(key, t), shape))
                     for t in range(num_steps)])


def test_prior_bpd_matches(scheds):
    sj, _, sp, _ = scheds
    x0 = _arr(19)
    assert rel_err(td.prior_bpd(sp, torch.from_numpy(x0)).numpy(),
                   jsamp.prior_bpd(sj, jnp.asarray(x0))) < 1e-5


@pytest.mark.parametrize("t_block", [1, 5])
def test_bpd_loop_matches_jax(scheds, t_block):
    sj, tj, sp, tp = scheds
    w, x0 = _arr(20, (1, 1, 6)), _arr(21)
    jfn, tfn = _model_fns(w)
    key = jax.random.key(22)
    ref = jd.bpd_loop(sj, jfn, jnp.asarray(x0), key, timestep_map=tj,
                      t_block=t_block)
    noise = torch.from_numpy(_jax_bpd_noise(key, sj.num_timesteps, x0.shape))
    ours = td.bpd_loop(sp, tfn, torch.from_numpy(x0), timestep_map=tp,
                       t_block=t_block, noise=noise)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        # float32 means over 30 elements per row, terms up to ~1e3 bits at
        # the noisiest step: 2e-5 relative
        assert rel_err(ours[k].numpy(), ref[k]) < 2e-5, k


def test_bpd_loop_is_block_invariant_and_ordered(scheds):
    _, _, sp, tp = scheds
    _, tfn = _model_fns(_arr(23, (1, 1, 6)))
    x0 = torch.from_numpy(_arr(24))
    runs = {k: td.bpd_loop(sp, tfn, x0, timestep_map=tp, t_block=k,
                           generator=torch.Generator().manual_seed(3))
            for k in (1, 2, 10)}
    for k in (2, 10):
        for name in ("vb", "mse", "x_start_mse", "total_bpd"):
            # the same noise per timestep whatever the blocking; only the
            # batch a row is computed in differs: float32 ulps
            np.testing.assert_allclose(runs[k][name].numpy(),
                                       runs[1][name].numpy(), rtol=1e-5)
    # columns run from t = T-1 down to 0: the last one is the decoder NLL
    other = td.bpd_loop(sp, tfn, x0, timestep_map=tp,
                        generator=torch.Generator().manual_seed(4))
    assert not np.allclose(other["vb"].numpy(), runs[1]["vb"].numpy())
    with pytest.raises(ValueError, match="must divide"):
        td.bpd_loop(sp, tfn, x0, timestep_map=tp, t_block=3)
    with pytest.raises(ValueError, match="noise shape"):
        td.bpd_loop(sp, tfn, x0, timestep_map=tp, noise=torch.zeros(9, *SHAPE))
