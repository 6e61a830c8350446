"""The slice as a whole: the port's Generator (fused path, plain version
on the CPU) against the JAX Generator (fused Pallas kernel in interpret
mode, float32), on the same weights and the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.diffusion import make_diffusion as jax_make
from gesture_diffusion_tpu.generation import Generator as JaxGenerator
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_torch.diffusion import make_diffusion
from gesture_diffusion_torch.generation import Generator, window_plan
from torch_port_common import D_POSE, T, jax_variables, port_model, rel_err

torch.set_num_threads(1)

# float32 both sides through 10 DDIM steps; the JAX kernel and the port's
# plain version sum in different orders: 2e-5 of the output's magnitude
TOL = 2e-5
SR, FPS, SEED_LEN = 16000, 8, 2      # 1 s windows of T=8 frames, stride 6


@pytest.fixture(scope="module")
def gens():
    wav = np.random.default_rng(40).normal(0, 0.3, (2, 16000)).astype(np.float32)
    cfg, variables = jax_variables("s2g_v2", n_layers=1, wav=wav, seed=41)
    sj, tj = jax_make("linear", 100, "ddim10")
    sp, tp = make_diffusion("linear", 100, "ddim10")
    jgen = JaxGenerator(JaxDenoiser(cfg), variables, sj, tj, use_fused=True,
                        fused_dtype=jnp.float32)
    tgen = Generator(port_model(cfg, variables), sp, tp, use_fused=True,
                     fused_dtype=torch.float32, device="cpu")
    return jgen, tgen, wav


@pytest.mark.parametrize("mode", ["identity", "ramp"])
def test_generate_sample_matches(gens, mode):
    jgen, tgen, wav = gens
    rng = np.random.default_rng(42)
    noise = rng.normal(size=(2, T, D_POSE)).astype(np.float32)
    kw = {}
    if mode == "ramp":
        seeds = rng.normal(size=(2, T, D_POSE)).astype(np.float32)
        mask = np.zeros((2, T, 1), np.float32)
        mask[:, :SEED_LEN] = 1.0
        kw = dict(inpaint_poses=seeds, inpaint_masks=mask, trans_factor=0.575,
                  pose_seed_len=SEED_LEN)
    ref = jgen.generate_sample(
        jnp.asarray(wav), D_POSE, T, jax.random.key(0),
        noise=jnp.asarray(noise),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    assert jgen.last_sample_path == "fused"
    ours = tgen.generate_sample(wav, D_POSE, T, noise=noise, **kw)
    assert tgen.last_sample_path == "fused"
    assert rel_err(ours.numpy(), np.asarray(ref)) < TOL


def _jax_window_noise(key, num_div, shape):
    """The JAX Generator's per-window noise: generate_sequence splits the
    key per window, and the fused path splits that subkey once more and
    draws the noise from the second half (generator.py prep_memory_rng)."""
    out = []
    for _ in range(num_div):
        key, sub = jax.random.split(key)
        _, sub2 = jax.random.split(sub)
        out.append(np.array(jax.random.normal(sub2, shape)))
    return out


@pytest.mark.parametrize("init,smooth", [(False, True), (True, False),
                                         (True, True)])
def test_generate_sequence_matches(gens, init, smooth):
    jgen, tgen, _ = gens
    wav_long = np.random.default_rng(43).normal(0, 0.3, (2, 2 * SR)).astype(np.float32)
    _, num_div = window_plan(wav_long.shape[1], SR, FPS, T, SEED_LEN)
    assert num_div == 3
    init_poses = (np.random.default_rng(44).normal(size=(2, SEED_LEN, D_POSE))
                  .astype(np.float32) if init else None)
    key = jax.random.key(45)
    kw = dict(smooth_trans=smooth, trans_factor=0.575)
    ref = jgen.generate_sequence(
        jnp.asarray(wav_long), SR, D_POSE, FPS, T, SEED_LEN, key,
        init_poses=None if init_poses is None else jnp.asarray(init_poses), **kw)
    noises = _jax_window_noise(key, num_div, (2, T, D_POSE))
    ours = tgen.generate_sequence(wav_long, SR, D_POSE, FPS, T, SEED_LEN,
                                  init_poses=init_poses,
                                  noise_fn=lambda b0, d: noises[d], **kw)
    assert ours.shape == ref.shape == (2, 16, D_POSE)
    assert rel_err(ours, ref) < TOL


def test_scan_path_matches_fused(gens):
    """use_fused=False (the module stepped by ddim_sample_loop) gives the
    same poses as the fused plain version in float32."""
    _, tgen, wav = gens
    noise = np.random.default_rng(46).normal(size=(2, T, D_POSE)).astype(np.float32)
    scan = Generator(tgen.model, tgen.sched, tgen.timestep_map,
                     use_fused=False, device="cpu")
    a = scan.generate_sample(wav, D_POSE, T, noise=noise)
    assert scan.last_sample_path == "scan"
    b = tgen.generate_sample(wav, D_POSE, T, noise=noise)
    assert rel_err(a.numpy(), b.numpy()) < TOL


def test_update_variables_drops_pack(gens):
    _, tgen, wav = gens
    noise = np.random.default_rng(47).normal(size=(2, T, D_POSE)).astype(np.float32)
    old = {k: v.clone() for k, v in tgen.model.state_dict().items()}
    try:
        a = tgen.generate_sample(wav, D_POSE, T, noise=noise)
        assert tgen._packed is not None
        new = {k: (v + 0.05 if v.is_floating_point() else v) for k, v in old.items()}
        tgen.update_variables(new)
        assert tgen._packed is None
        b = tgen.generate_sample(wav, D_POSE, T, noise=noise)
        assert not np.allclose(a.numpy(), b.numpy())
    finally:
        tgen.update_variables(old)


def test_generator_contract(gens):
    _, tgen, wav = gens
    with pytest.raises(NotImplementedError, match="DDPM"):
        tgen.generate_sample(wav, D_POSE, T, sample_alg="ddpm")
    with pytest.raises(TypeError, match="float"):
        tgen.generate_sample((wav * 32767).astype(np.int16), D_POSE, T)
    with pytest.raises(TypeError, match="float"):
        tgen.generate_sample([[1, 2, 3]], D_POSE, T)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tgen.generate_sample(wav, D_POSE, T, generator=g1)
    b = tgen.generate_sample(wav, D_POSE, T, generator=g2)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    mean_ms, std_ms, steps_per_s = tgen.eval_infer_time(
        wav, D_POSE, T, repetitions=1, warmup=1)
    assert mean_ms > 0 and steps_per_s > 0
