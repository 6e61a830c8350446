"""The slice as a whole: the port's Generator (fused path, plain version
on the CPU) against the JAX Generator (fused Pallas kernel in interpret
mode, float32), on the same weights and the same noise, for all three
model types, DDIM and DDPM, and eval_bpd."""

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
from torch_port_common import (D_POSE, T, inpaint_tensors, jax_variables,
                               port_model, rel_err)

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
    with pytest.raises(ValueError, match="unknown sample_alg"):
        tgen.generate_sample(wav, D_POSE, T, sample_alg="plms")
    with pytest.raises(ValueError, match="scan sampler only"):
        tgen.generate_sample(wav, D_POSE, T, sample_alg="ddpm",
                             z_fn=lambda i: np.zeros((2, T, D_POSE), np.float32))
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


# -- the other model types, DDPM and bpd ---------------------------------------

@pytest.fixture(scope="module", params=["default", "inpaint"])
def typed_gens(request):
    """(JAX fused, port fused, port scan, JAX scan, wav, model type)."""
    wav = np.random.default_rng(60).normal(0, 0.3, (2, 16000)).astype(np.float32)
    cfg, variables = jax_variables(request.param, n_layers=1, wav=wav, seed=61)
    sj, tj = jax_make("linear", 100, "ddim10")
    sp, tp = make_diffusion("linear", 100, "ddim10")
    jm, tm = JaxDenoiser(cfg), port_model(cfg, variables)
    jgen = JaxGenerator(jm, variables, sj, tj, use_fused=True,
                        fused_dtype=jnp.float32)
    jscan = JaxGenerator(jm, variables, sj, tj, use_fused=False)
    tgen = Generator(tm, sp, tp, use_fused=True, fused_dtype=torch.float32,
                     device="cpu")
    tscan = Generator(tm, sp, tp, use_fused=False, device="cpu")
    return jgen, tgen, tscan, jscan, wav, request.param


def _seed_kw(seed):
    ip, im = inpaint_tensors(seed, seed_len=SEED_LEN)
    return dict(inpaint_poses=ip, inpaint_masks=im, trans_factor=0.575,
                pose_seed_len=SEED_LEN)


def _jnp_kw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def test_generate_sample_matches_for_type(typed_gens):
    """default and inpaint: a time-concatenated memory whose length is off
    the TPU's 8-row alignment (the JAX side pads and masks), and for
    inpaint the conditioning MLP hoisted into x_add."""
    jgen, tgen, tscan, _, wav, _ = typed_gens
    noise = np.random.default_rng(62).normal(size=(2, T, D_POSE)).astype(np.float32)
    kw = _seed_kw(63)
    ref = jgen.generate_sample(jnp.asarray(wav), D_POSE, T, jax.random.key(0),
                               noise=jnp.asarray(noise), **_jnp_kw(kw))
    assert jgen.last_sample_path == "fused"
    ours = tgen.generate_sample(wav, D_POSE, T, noise=noise, **kw)
    assert tgen.last_sample_path == "fused"
    assert rel_err(ours.numpy(), np.asarray(ref)) < TOL
    # the port's scan path (inpaint tensors on every step) agrees too
    scan = tscan.generate_sample(wav, D_POSE, T, noise=noise, **kw)
    assert tscan.last_sample_path == "scan"
    assert rel_err(scan.numpy(), np.asarray(ref)) < TOL


def test_scan_ddpm_matches_jax_with_injected_noise(typed_gens):
    _, _, tscan, jscan, wav, _ = typed_gens
    noise = np.random.default_rng(64).normal(size=(2, T, D_POSE)).astype(np.float32)
    kw = _seed_kw(65)
    key = jax.random.key(66)
    ref = jscan.generate_sample(jnp.asarray(wav), D_POSE, T, key,
                                noise=jnp.asarray(noise), sample_alg="ddpm",
                                **_jnp_kw(kw))
    assert jscan.last_sample_path == "scan"
    zs, k = {}, key             # the key reaches ddpm_sample_loop unsplit
    for i in range(9, -1, -1):
        k, sub = jax.random.split(k)
        zs[i] = np.array(jax.random.normal(sub, noise.shape))
    ours = tscan.generate_sample(wav, D_POSE, T, noise=noise, sample_alg="ddpm",
                                 z_fn=zs.__getitem__, **kw)
    assert tscan.last_sample_path == "scan"
    # float32 both sides through 10 ancestral steps: 2e-5 relative
    assert rel_err(ours.numpy(), np.asarray(ref)) < TOL


def test_fused_ddpm_is_seeded_and_in_family(typed_gens):
    """DDPM through the fused path: a function of the generator's seed,
    different across seeds, finite, and in family with the scan DDPM
    sampler (other noise streams, so moments and not values; the bars of
    the JAX package's own fused DDPM test)."""
    _, tgen, tscan, _, wav, _ = typed_gens
    noise = np.random.default_rng(67).normal(size=(2, T, D_POSE)).astype(np.float32)
    kw = dict(noise=noise, sample_alg="ddpm", **_seed_kw(68))

    def run(gen, seed):
        return gen.generate_sample(wav, D_POSE, T,
                                   generator=torch.Generator().manual_seed(seed),
                                   **kw).numpy()

    a, b, c = run(tgen, 1), run(tgen, 1), run(tgen, 2)
    assert tgen.last_sample_path == "fused"
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c) and np.isfinite(a).all()
    d = run(tscan, 3)
    assert abs(a.mean() - d.mean()) < 0.25 * max(1.0, abs(d.mean()))
    assert 0.5 < a.std() / d.std() < 2.0


def test_inpaint_model_needs_inpaint_tensors(typed_gens):
    _, tgen, tscan, _, wav, model_type = typed_gens
    if model_type != "inpaint":
        out = tgen.generate_sample(wav, D_POSE, T,
                                   generator=torch.Generator().manual_seed(0))
        assert out.shape == (2, T, D_POSE)
        return
    for gen in (tgen, tscan):
        with pytest.raises(ValueError, match="inpaint tensors"):
            gen.generate_sample(wav, D_POSE, T,
                                generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="pose_seed_len"):
        tgen.eval_bpd(np.zeros((2, T, D_POSE), np.float32), wav)


def _jax_bpd_noise(key, shape):
    return np.stack([np.array(jax.random.normal(jax.random.fold_in(key, t), shape))
                     for t in range(10)])


@pytest.mark.parametrize("t_block", [1, 5, 4])
def test_eval_bpd_matches(typed_gens, t_block):
    """eval_bpd against JAX's with its per-timestep noise injected; a
    t_block that does not divide the 10 steps (4) is clamped to 2 on both
    sides."""
    jgen, tgen, _, _, wav, _ = typed_gens
    poses = np.random.default_rng(69).normal(size=(2, T, D_POSE)).astype(np.float32)
    key = jax.random.key(70)
    ref = jgen.eval_bpd(jnp.asarray(poses), jnp.asarray(wav), key,
                        pose_seed_len=SEED_LEN, t_block=t_block)
    ours = tgen.eval_bpd(poses, wav, pose_seed_len=SEED_LEN, t_block=t_block,
                         noise=_jax_bpd_noise(key, poses.shape))
    assert set(ours) == set(ref)
    for k in ref:
        assert tuple(ours[k].shape) == tuple(ref[k].shape), k
        # float32 both sides; the model runs on other batch shapes per
        # block: 5e-5 relative
        assert rel_err(ours[k].numpy(), ref[k]) < 5e-5, k


def test_eval_bpd_is_block_invariant(gens):
    _, tgen, wav = gens
    poses = np.random.default_rng(71).normal(size=(2, T, D_POSE)).astype(np.float32)
    runs = [tgen.eval_bpd(poses, wav, generator=torch.Generator().manual_seed(5),
                          t_block=k) for k in (1, 5, 10)]
    for r in runs[1:]:
        np.testing.assert_allclose(r["vb"].numpy(), runs[0]["vb"].numpy(),
                                   rtol=2e-5)
    other = tgen.eval_bpd(poses, wav, generator=torch.Generator().manual_seed(6))
    assert not np.allclose(other["vb"].numpy(), runs[0]["vb"].numpy())
    assert runs[0]["vb"].shape == (2, 10) and runs[0]["total_bpd"].shape == (2,)


# -- a model with no fused kernel: the cross-attention decoder ----------------

CROSS_SEED = 4          # tedexp's pose_seed_len


@pytest.fixture(scope="module")
def cross_gens():
    """(JAX Generator, port Generator, wav) on a cross_attention model, both
    built with use_fused=True: each serves through its scan sampler, as the
    JAX Generator's _fused_enabled chooses by the model."""
    wav = np.random.default_rng(80).normal(0, 0.3, (2, 16000)).astype(np.float32)
    cfg, variables = jax_variables("default", n_layers=2, wav=wav, seed=81,
                                   d_model=32, heads=4,
                                   decoder_type="cross_attention",
                                   pose_seed_len=CROSS_SEED)
    sj, tj = jax_make("linear", 100, "ddim10")
    sp, tp = make_diffusion("linear", 100, "ddim10")
    jgen = JaxGenerator(JaxDenoiser(cfg), variables, sj, tj, use_fused=True)
    tgen = Generator(port_model(cfg, variables), sp, tp, use_fused=True,
                     device="cpu")
    return jgen, tgen, wav


def test_cross_attention_serves_through_scan(cross_gens):
    """use_fused=True on a model the kernel does not fuse does not raise:
    generate_sample takes the scan sampler (and says so), DDIM matches the
    JAX Generator's scan path; the fused-only entry points refuse."""
    jgen, tgen, wav = cross_gens
    assert tgen.use_fused and not tgen.fused
    noise = np.random.default_rng(82).normal(size=(2, T, D_POSE)).astype(np.float32)
    ref = jgen.generate_sample(jnp.asarray(wav), D_POSE, T, jax.random.key(0),
                               noise=jnp.asarray(noise))
    assert jgen.last_sample_path == "scan"
    ours = tgen.generate_sample(wav, D_POSE, T, noise=noise)
    assert tgen.last_sample_path == "scan"
    assert rel_err(ours.numpy(), np.asarray(ref)) < TOL
    with pytest.raises(ValueError, match="no fused kernel"):
        tgen.fused_args(torch.from_numpy(wav), D_POSE, T, torch.from_numpy(noise))
    mean_ms, _, steps_per_s = tgen.eval_infer_time(wav, D_POSE, T, repetitions=1,
                                                   warmup=1)
    assert mean_ms > 0 and steps_per_s > 0 and tgen.last_sample_path == "scan"


def test_cross_attention_ddpm_matches_jax_with_injected_noise(cross_gens):
    jgen, tgen, wav = cross_gens
    noise = np.random.default_rng(83).normal(size=(2, T, D_POSE)).astype(np.float32)
    kw = _seed_kw(84)
    kw["pose_seed_len"] = SEED_LEN
    key = jax.random.key(85)
    ref = jgen.generate_sample(jnp.asarray(wav), D_POSE, T, key,
                               noise=jnp.asarray(noise), sample_alg="ddpm",
                               **_jnp_kw(kw))
    assert jgen.last_sample_path == "scan"
    zs, k = {}, key             # the key reaches ddpm_sample_loop unsplit
    for i in range(9, -1, -1):
        k, sub = jax.random.split(k)
        zs[i] = np.array(jax.random.normal(sub, noise.shape))
    # z_fn goes with the scan sampler: allowed on this use_fused=True
    # Generator, whose model takes the scan
    ours = tgen.generate_sample(wav, D_POSE, T, noise=noise, sample_alg="ddpm",
                                z_fn=zs.__getitem__, **kw)
    assert tgen.last_sample_path == "scan"
    assert rel_err(ours.numpy(), np.asarray(ref)) < TOL


def test_cross_attention_sequence_matches_jax(cross_gens):
    """generate_sequence with the smooth transition and a 4-frame seed, as
    tedexp sets them (stride 4: 3 windows over 2 s)."""
    jgen, tgen, _ = cross_gens
    wav_long = np.random.default_rng(86).normal(0, 0.3, (2, 2 * SR)).astype(np.float32)
    _, num_div = window_plan(wav_long.shape[1], SR, FPS, T, CROSS_SEED)
    assert num_div == 3
    init = np.random.default_rng(87).normal(size=(2, CROSS_SEED, D_POSE)).astype(np.float32)
    key = jax.random.key(88)
    kw = dict(smooth_trans=True, trans_factor=0.575)
    ref = jgen.generate_sequence(jnp.asarray(wav_long), SR, D_POSE, FPS, T,
                                 CROSS_SEED, key, init_poses=jnp.asarray(init), **kw)
    assert jgen.last_sample_path == "scan"
    # the scan path draws a window's noise as the fused prep does: the
    # window's subkey split once more
    noises = _jax_window_noise(key, num_div, (2, T, D_POSE))
    ours = tgen.generate_sequence(wav_long, SR, D_POSE, FPS, T, CROSS_SEED,
                                  init_poses=init, noise_fn=lambda b0, d: noises[d],
                                  **kw)
    assert tgen.last_sample_path == "scan"
    assert ours.shape == ref.shape == (2, 16, D_POSE)
    assert rel_err(ours, ref) < TOL


def test_cross_attention_eval_bpd_matches(cross_gens):
    jgen, tgen, wav = cross_gens
    poses = np.random.default_rng(89).normal(size=(2, T, D_POSE)).astype(np.float32)
    key = jax.random.key(90)
    ref = jgen.eval_bpd(jnp.asarray(poses), jnp.asarray(wav), key, t_block=4)
    ours = tgen.eval_bpd(poses, wav, t_block=4,
                         noise=_jax_bpd_noise(key, poses.shape))
    assert set(ours) == set(ref)
    for k in ref:
        assert rel_err(ours[k].numpy(), ref[k]) < 5e-5, k


def test_oneway_with_use_fused_never_takes_the_scan(gens):
    """A oneway model with use_fused=True runs the fused path (its plain
    version on the CPU) on every serving entry point; only use_fused=False
    gives the scan."""
    _, tgen, wav = gens
    assert tgen.fused
    for alg in ("ddim", "ddpm"):
        tgen.generate_sample(wav, D_POSE, T, sample_alg=alg,
                             generator=torch.Generator().manual_seed(1))
        assert tgen.last_sample_path == "fused"
    wav_long = np.random.default_rng(91).normal(0, 0.3, (2, 2 * SR)).astype(np.float32)
    tgen.generate_sequence(wav_long, SR, D_POSE, FPS, T, SEED_LEN,
                           generator=torch.Generator().manual_seed(2))
    assert tgen.last_sample_path == "fused"
    stream = tgen.stream(SR, D_POSE, FPS, T, SEED_LEN,
                         generator=torch.Generator().manual_seed(3))
    stream.push(wav_long)
    stream.flush()
    assert tgen.last_sample_path == "fused"
    scan = Generator(tgen.model, tgen.sched, tgen.timestep_map, use_fused=False,
                     device="cpu")
    assert not scan.fused
    scan.generate_sample(wav, D_POSE, T, generator=torch.Generator().manual_seed(1))
    assert scan.last_sample_path == "scan"


def test_cross_attention_stream_equals_sequence(cross_gens):
    """GestureStream on the scan sampler: pushed in 0.25 s chunks, the
    output equals generate_sequence on the same noise."""
    _, tgen, _ = cross_gens
    wav_long = np.random.default_rng(92).normal(0, 0.3, (2, 2 * SR)).astype(np.float32)
    init = np.random.default_rng(93).normal(size=(2, CROSS_SEED, D_POSE)).astype(np.float32)
    noises = [np.random.default_rng(94 + d).normal(size=(2, T, D_POSE)).astype(np.float32)
              for d in range(3)]
    kw = dict(init_poses=init, trans_factor=0.575,
              noise_fn=lambda b0, d: noises[d])
    offline = tgen.generate_sequence(wav_long, SR, D_POSE, FPS, T, CROSS_SEED, **kw)
    stream = tgen.stream(SR, D_POSE, FPS, T, CROSS_SEED, max_in_flight=1, **kw)
    chunks = []
    for i in range(0, wav_long.shape[1], SR // 4):
        chunks.extend(stream.push(wav_long[:, i:i + SR // 4]))
    chunks.extend(stream.flush())
    assert tgen.last_sample_path == "scan"
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), offline)
