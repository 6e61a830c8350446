"""Port vs JAX: the training path's pieces and one train step.

Both sides run in float32 on the CPU (tests/conftest.py pins JAX matmuls to
"highest"), at a small width: d_pose 12, d_model 32, 4 heads, 1 layer,
8000-sample wav, 10-frame windows, 50 diffusion steps.  Weights come from
the JAX package, moved off their init values, and are carried over with
``state_dict_from_jax``; t and noise are drawn on the JAX side, as its
train step draws them, and handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gesture_diffusion_tpu.diffusion import make_schedule as jax_make_schedule
from gesture_diffusion_tpu.diffusion import linear_betas
from gesture_diffusion_tpu.diffusion.gaussian import training_losses as jax_training_losses
from gesture_diffusion_tpu.diffusion.resample import (
    LossSecondMomentResampler as JaxLossSampler, UniformSampler as JaxUniform)
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_tpu.models.attention import depthwise_conv3 as jax_dwc3
from gesture_diffusion_tpu.training import TrainState, init_opt_state
from gesture_diffusion_tpu.training import data as jax_data
from gesture_diffusion_tpu.training import lr_schedule as jax_lr
from gesture_diffusion_tpu.training import make_train_step as jax_make_train_step
from gesture_diffusion_tpu.training.train_state import assemble_losses as jax_assemble
from gesture_diffusion_tpu.training.train_state import clip_gradients as jax_clip
from gesture_diffusion_tpu.training.trainer import _inpaint_kwargs as jax_inpaint_kwargs
from gesture_diffusion_tpu.utils import JsonConfig as JaxJsonConfig
from gesture_diffusion_tpu.utils.parsing import parse_steps as jax_parse_steps
from gesture_diffusion_tpu.utils.rng import RngStream as JaxRngStream
from gesture_diffusion_torch.diffusion import make_schedule, training_losses
from gesture_diffusion_torch.diffusion.resample import (
    LossSecondMomentResampler, UniformSampler)
from gesture_diffusion_torch.interop import state_dict_from_jax
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser
from gesture_diffusion_torch.models.attention import depthwise_conv3
from gesture_diffusion_torch.models.speech_encoder import BatchNorm2d
from gesture_diffusion_torch.training import (
    ArrayDataset, assemble_losses, build_lr_schedule, clip_gradients,
    global_norm, host_slice, iter_batches, make_adamw, make_train_step,
    noam_decay_schedule, noam_xf_schedule, steps_per_epoch)
from gesture_diffusion_torch.utils import JsonConfig, RngStream, parse_steps
from torch_port_common import D_POSE, jax_variables, port_model, rel_err, seeded_wav

torch.set_num_threads(1)

STEPS, N, TW, DMS, HS, WAV = 50, 4, 10, 32, 4, 8000
BETAS = np.asarray(linear_betas(STEPS))
# sums in other orders on both sides: losses and BN statistics to 1e-5 of
# the reference value, each gradient tensor to 1e-4 of its own max|g|.  The
# SE-ResNet trunk's train-mode gradients are ill-conditioned on these
# random weights: the JAX package's float32 trunk is off its own float64
# result by up to 9.2e-3 of max|g|, and the two front-ends' mels (1e-4
# apart) move it by percents.  So the trunk and the global norm it enters
# are held in float64 with one mel, the port's float32 trunk against the
# JAX package's own float32 error, and the float32 norm to 1e-3 (found: up
# to 4.5e-4).
TOL, GRAD_TOL, NORM_TOL_F32, NORM_TOL_F64 = 1e-5, 1e-4, 1e-3, 1e-4
LOSS_PARAMS = {"speed_loss": 0.1, "speed_l1_loss": 0.2,
               "speed_constraint_loss": 0.05}


# -- parse_steps, learning-rate schedules, RNG, data, samplers ---------------

@pytest.mark.parametrize("value", ["4k", "200k", "1m", "1.5k", "100kk", 250,
                                   3.0, " 12K "])
def test_parse_steps_matches(value):
    assert parse_steps(value) == jax_parse_steps(value)


def test_parse_steps_rejects_empty():
    with pytest.raises(ValueError, match="Cannot parse"):
        parse_steps("k")


@pytest.mark.parametrize("kind", ["noamxf", "noam", "noam_floor", "const"])
def test_lr_schedules_equal_jax(kind):
    if kind == "noamxf":
        ours, ref = noam_xf_schedule(1.0, 256, 4000), jax_lr.noam_xf_schedule(1.0, 256, 4000)
    elif kind == "noam":
        ours, ref = noam_decay_schedule(1e-3, 4000), jax_lr.noam_decay_schedule(1e-3, 4000)
    elif kind == "noam_floor":
        ours = noam_decay_schedule(1e-3, 4000, minimum=4e-4)
        ref = jax_lr.noam_decay_schedule(1e-3, 4000, minimum=4e-4)
    else:
        ours, ref = build_lr_schedule(None, 0.01), jax_lr.build_lr_schedule(None, 0.01)
    for step in (0, 1, 2, 3999, 4000, 100_000):
        assert ours(step) == float(ref(step)), step


def test_flagship_schedule_from_config():
    """beat-ours: lr 1 under noamxf, warm-up "4k", d_model 256; update k
    reads the schedule at k, which holds torch's +1."""
    block = {"type": "noamxf", "warmup_steps": "4k", "d_model": 256}
    ours = build_lr_schedule(JsonConfig(block), 1.0)
    ref = jax_lr.build_lr_schedule(JaxJsonConfig(block), 1.0)
    for k in range(3):
        assert ours(k) == float(ref(k))
        assert ours(k) == pytest.approx(256 ** -0.5 * (k + 1) * 4000 ** -1.5,
                                        rel=1e-6)
    assert ours(0) == pytest.approx(2.47e-7, rel=1e-3)


@pytest.mark.parametrize("name,step", [("shuffle", 0), ("shuffle", 7),
                                       ("schedule_sampler", None)])
def test_numpy_stream_equals_jax(name, step):
    a = RngStream(3).numpy(name, step).integers(0, 1 << 30, 16)
    b = JaxRngStream(3).numpy(name, step).integers(0, 1 << 30, 16)
    np.testing.assert_array_equal(a, b)


def test_torch_stream_is_per_step():
    rngs = RngStream(0)
    a = torch.randn(5, generator=rngs.torch("train/noise", 3))
    assert torch.equal(a, torch.randn(5, generator=rngs.torch("train/noise", 3)))
    assert not torch.equal(a, torch.randn(5, generator=rngs.torch("train/noise", 4)))
    assert not torch.equal(a, torch.randn(5, generator=rngs.torch("train/t", 3)))


def _synthetic(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"wav": rng.normal(size=(n, 40)).astype(np.float32),
            "pose": rng.normal(size=(n, 3, 2)).astype(np.float32)}


@pytest.mark.parametrize("batch_size,drop_last", [(8, True), (5, True), (5, False)])
def test_epoch_order_equals_jax(batch_size, drop_last):
    data = _synthetic(23)
    for epoch in (0, 1):
        ours = list(iter_batches(ArrayDataset(data), batch_size,
                                 rng=RngStream(9).numpy("shuffle", epoch),
                                 drop_last=drop_last))
        ref = list(jax_data.iter_batches(
            jax_data.ArrayDataset(data), batch_size,
            rng=JaxRngStream(9).numpy("shuffle", epoch), drop_last=drop_last,
            process_index=0, process_count=1))
        assert len(ours) == len(ref) == steps_per_epoch(23, batch_size, drop_last)
        for a, b in zip(ours, ref):
            for k in data:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    unshuffled = list(iter_batches(ArrayDataset(data), 8, shuffle=False))
    np.testing.assert_array_equal(unshuffled[1]["wav"], data["wav"][8:16])


def test_host_slice_and_ragged_dataset():
    idx = np.arange(12)
    for i in range(3):
        np.testing.assert_array_equal(host_slice(idx, i, 3),
                                      jax_data.host_slice(idx, i, 3))
    with pytest.raises(ValueError, match="not divisible"):
        host_slice(idx, 0, 5)
    with pytest.raises(ValueError, match="ragged"):
        ArrayDataset({"wav": np.zeros((3, 4)), "pose": np.zeros((2, 1, 1))})


def test_uniform_sampler_equals_jax():
    t, w = UniformSampler(STEPS).sample_np(np.random.default_rng(1), 32)
    rt, rw = JaxUniform(STEPS).sample_np(np.random.default_rng(1), 32)
    np.testing.assert_array_equal(t, rt)
    np.testing.assert_array_equal(w, rw)


def test_loss_second_moment_sampler_equals_jax():
    ours, ref = LossSecondMomentResampler(STEPS), JaxLossSampler(STEPS)
    feed = np.random.default_rng(4)
    gathered = []

    def gather(x):
        gathered.append(x.shape)
        return [x, x[:3]]               # a second process with 3 pairs

    for i in range(80):
        ts = feed.integers(0, STEPS, 16)
        losses = feed.gamma(2.0, 0.5 + ts / STEPS).astype(np.float32)
        ours.update_with_local_losses(ts, losses, allgather=gather)
        ref.update_with_local_losses(ts, losses, allgather=lambda x: [x, x[:3]])
        if i in (5, 79):          # before and after the warm-up
            np.testing.assert_array_equal(ours.weights(), ref.weights())
            a = ours.sample_np(np.random.default_rng(i), 64)
            b = ref.sample_np(np.random.default_rng(i), 64)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert ours._warmed_up() and gathered[0] == (16, 2)
    # the single-process default gathers nothing else
    single = LossSecondMomentResampler(STEPS)
    single.update_with_local_losses(np.array([3, 3]), np.array([1.0, 2.0]))
    assert single._loss_counts[3] == 2


# -- losses ------------------------------------------------------------------

def _model_fns(seed=0):
    """The same deterministic eps(x_t, t) in both frameworks."""
    a = np.random.default_rng(seed).normal(size=(D_POSE,)).astype(np.float32)

    def jax_fn(x_t, t):
        return jnp.tanh(x_t * a + t[:, None, None].astype(jnp.float32) / STEPS)

    def torch_fn(x_t, t):
        return torch.tanh(x_t * torch.from_numpy(a) + t[:, None, None].float() / STEPS)

    return jax_fn, torch_fn


def _t_noise(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, STEPS, shape[0]).astype(np.int32),
            rng.normal(size=shape).astype(np.float32))


def test_training_losses_match():
    x0 = np.random.default_rng(1).normal(size=(N, TW, D_POSE)).astype(np.float32)
    t, noise = _t_noise(2, x0.shape)
    jax_fn, torch_fn = _model_fns()
    ref = jax_training_losses(jax_make_schedule(BETAS), jax_fn, jnp.asarray(x0),
                              jnp.asarray(t), jnp.asarray(noise))
    ours = training_losses(make_schedule(BETAS), torch_fn, torch.from_numpy(x0),
                           torch.from_numpy(t).long(), torch.from_numpy(noise))
    assert set(ours) == set(ref)
    for k in ref:
        assert rel_err(ours[k], ref[k]) < TOL, k


@pytest.mark.parametrize("loss_params,weighted", [
    (None, False), (None, True), ({"speed_loss": 0.3}, False),
    ({"speed_l1_loss": 0.2}, False), ({"speed_constraint_loss": 0.05}, True),
    (LOSS_PARAMS, True)])
def test_assemble_losses_match(loss_params, weighted):
    x0 = 0.5 * np.random.default_rng(3).normal(size=(N, TW, D_POSE)).astype(np.float32)
    t, noise = _t_noise(4, x0.shape)
    w = np.random.default_rng(5).uniform(0.5, 2.0, N).astype(np.float32)
    jax_fn, torch_fn = _model_fns(1)
    ref = jax_assemble(jax_make_schedule(BETAS), jax_fn, jnp.asarray(x0),
                       jnp.asarray(t), jnp.asarray(noise), loss_params,
                       weights=jnp.asarray(w) if weighted else None,
                       with_per_example=True)
    ours = assemble_losses(make_schedule(BETAS), torch_fn, torch.from_numpy(x0),
                           torch.from_numpy(t).long(), torch.from_numpy(noise),
                           loss_params,
                           weights=torch.from_numpy(w) if weighted else None,
                           with_per_example=True)
    assert set(ours) == set(ref)
    for k in ref:
        assert rel_err(ours[k], ref[k]) < TOL, k
    with pytest.raises(ValueError, match="Unsupported loss"):
        assemble_losses(make_schedule(BETAS), torch_fn, torch.from_numpy(x0),
                        torch.from_numpy(t).long(), torch.from_numpy(noise),
                        {"jerk_loss": 1.0})


@pytest.mark.parametrize("norm_clip,value_clip", [(None, None), (0.5, None),
                                                  (None, 0.05), (0.5, 0.05),
                                                  (1e3, None)])
def test_clip_gradients_match(norm_clip, value_clip):
    rng = np.random.default_rng(6)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    ref = jax_clip([jnp.asarray(g) for g in grads], norm_clip, value_clip)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = global_norm(ours)
    assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=TOL)
    clip_gradients(ours, norm, norm_clip, value_clip)
    for a, b in zip(ours, ref):
        assert rel_err(a, b) < TOL


# -- modules with training behaviour ---------------------------------------

def test_depthwise_conv3_gradcheck():
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=g, dtype=torch.float64, requires_grad=True)
            for s in ((2, 5, 3, 4), (3, 4), (4,))]
    assert torch.autograd.gradcheck(depthwise_conv3, args)


def test_depthwise_conv3_vjp_matches_jax():
    rng = np.random.default_rng(7)
    x, w, b, g = (rng.normal(size=s).astype(np.float32)
                  for s in ((2, 9, 4, 8), (3, 8), (8,), (2, 9, 4, 8)))
    y_ref, vjp = jax.vjp(jax_dwc3, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    refs = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = depthwise_conv3(*args)
    y.backward(torch.from_numpy(g))
    assert rel_err(y.detach(), y_ref) < TOL
    for a, ref in zip(args, refs):
        assert rel_err(a.grad, ref) < TOL


def test_batchnorm_train_mode_matches_flax():
    """Normalised by the biased batch variance, and the running variance
    moved towards it (torch's stock update uses the unbiased one)."""
    import flax.linen as fnn

    rng = np.random.default_rng(8)
    x = rng.normal(1.0, 2.0, (3, 5, 4, 6)).astype(np.float32)   # NCHW
    scale, bias = rng.uniform(0.5, 1.5, 5), rng.normal(size=5)
    mean0, var0 = rng.normal(size=5), rng.uniform(0.5, 2.0, 5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    variables = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), variables)
    y_ref, mut = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                               epsilon=1e-5).apply(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])
    bn = BatchNorm2d(5).train()
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean0), ("running_var", var0)):
            getattr(bn, name).copy_(torch.from_numpy(np.asarray(v, np.float32)))
    y = bn(torch.from_numpy(x))
    assert rel_err(y.detach().permute(0, 2, 3, 1), y_ref) < TOL
    assert rel_err(bn.running_mean, mut["batch_stats"]["mean"]) < TOL
    assert rel_err(bn.running_var, mut["batch_stats"]["var"]) < TOL
    assert int(bn.num_batches_tracked) == 1


def test_dropout_identity_in_eval_and_drops_in_train():
    p = 0.3
    cfg = dict(d_pose=D_POSE, d_model=DMS, heads=HS, n_layers=1, model_type="inpaint")
    plain = GestureDenoiser(DenoiserConfig(**cfg))
    dropped = GestureDenoiser(DenoiserConfig(**cfg, dropout=p))
    dropped.load_state_dict(plain.state_dict())
    sites = [m for m in dropped.modules() if isinstance(m, torch.nn.Dropout)]
    # modules: PE, step encoder, inpaint MLP, speech streams, the layer's
    # residuals, the two attentions' probabilities, the FF hidden layer
    assert len(sites) == 8 and all(m.p == p for m in sites)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(N, TW, D_POSE, generator=g)
    wav = torch.from_numpy(seeded_wav(1, n=N))
    pose = torch.randn(N, TW, D_POSE, generator=g)
    mask = torch.ones(N, TW, 1)
    t = torch.tensor([1, 5, 20, 49])
    args = (x, t, wav, pose, mask)
    with torch.no_grad():
        assert torch.equal(dropped.eval()(*args), plain.eval()(*args))
    seen = []

    def hook(mod, inp, out):
        live = inp[0] != 0
        seen.append(((out == 0) & live).sum().item() / max(1, live.sum().item()))

    handles = [m.register_forward_hook(hook) for m in sites]
    with torch.no_grad():
        dropped.train()(*args)
    for h in handles:
        h.remove()
    # calls: PE on x and memory, 3 speech streams, 3 residuals
    assert len(seen) == 13
    assert abs(np.mean(seen) - p) < 0.05, seen


# -- one train step against the JAX step --------------------------------------

def _step_inputs(model_type, seed=5, **cfg_kw):
    wav = seeded_wav(seed + 6, n=N, length=WAV)
    cfg, variables = jax_variables(model_type, n_layers=1, wav=wav, seed=seed,
                                   d_model=DMS, heads=HS, t=TW, **cfg_kw)
    poses = 0.5 * np.random.default_rng(seed + 7).normal(
        size=(N, TW, D_POSE)).astype(np.float32)
    return cfg, variables, {"pose": poses, "wav": wav}


def _jax_draws(key, step, shape, dtype=jnp.float32):
    """t and noise of the JAX train step at ``step`` (trainer.py:113-120);
    the noise is drawn in the poses' dtype."""
    rng = jax.random.fold_in(key, step)
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_rng, (shape[0],), 0, STEPS)
    return np.asarray(t), np.asarray(jax.random.normal(n_rng, shape, dtype))


def _jax_grads(cfg, variables, batch, t, noise, loss_params):
    model = JaxDenoiser(cfg)
    sched = jax_make_schedule(BETAS)
    poses, wav = jnp.asarray(batch["pose"]), jnp.asarray(batch["wav"])
    extra = jax_inpaint_kwargs(model, poses)

    @jax.jit
    def run(params, stats):
        def loss_fn(params):
            mutated = {}

            def model_fn(x_t, tt):
                out, mut = model.apply(
                    {"params": params, "batch_stats": stats}, x_t, tt, wav,
                    train=True, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.key(0)}, **extra)
                mutated["stats"] = mut["batch_stats"]
                return out

            losses = jax_assemble(sched, model_fn, poses, jnp.asarray(t),
                                  jnp.asarray(noise), loss_params)
            return losses["loss"], (losses, mutated["stats"])

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, (losses, stats)), grads = run(variables["params"], variables["batch_stats"])
    return jax.tree.map(np.asarray, (losses, grads, stats))


def _port(cfg, variables, batch, dtype=torch.float32):
    model = port_model(cfg, variables).to(dtype)
    tensors = {"pose": torch.from_numpy(batch["pose"]).to(dtype),
               "wav": torch.from_numpy(batch["wav"])}
    return model, tensors


def _bn_stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith("running_mean") or k.endswith("running_var")}


TRUNK = "speech_encoder.wav_encoder.feat_extractor."


def _grad_errors(model, ref_grads):
    """name -> (max|d|, the bar): 1e-4 of the tensor's max|g|, but never
    below 1e-6 of the largest max|g| of all.  The floor is for the
    gradients that are 0 in exact arithmetic, the key projections' dconv
    biases: a bias added to every key moves each query's scores by a
    constant, which the softmax removes, so both sides give float noise."""
    top = max(float(np.abs(g.numpy()).max()) for g in ref_grads.values())
    out = {}
    for name, p in model.named_parameters():
        scale = float(np.abs(ref_grads[name].numpy()).max())
        err = float((p.grad.double() - ref_grads[name].double()).abs().max())
        out[name] = (err, GRAD_TOL * max(scale, 1e-2 * top))
    return out


@pytest.fixture(scope="module", params=["s2g_v2", "inpaint"])
def step_case(request):
    cfg, variables, batch = _step_inputs(request.param, pose_seed_len=4)
    key = jax.random.key(7)
    t, noise = _jax_draws(key, 0, batch["pose"].shape)
    return request.param, cfg, variables, batch, key, t, noise


@pytest.fixture(scope="module")
def jax_step_grads(step_case):
    """{32: ..., 64: ...}: the JAX step's losses, gradients and BN
    statistics in float32 and in float64 (``jax.enable_x64``)."""
    _, cfg, variables, batch, _, t, noise = step_case
    out = {32: _jax_grads(cfg, variables, batch, t, noise, LOSS_PARAMS)}
    with jax.enable_x64(True):
        batch64 = {"pose": batch["pose"].astype(np.float64), "wav": batch["wav"]}
        out[64] = _jax_grads(cfg, _f64(variables), batch64, t,
                             noise.astype(np.float64), LOSS_PARAMS)
    return out


@pytest.fixture
def shared_mel(monkeypatch):
    """The port's encoder reads the JAX front-end's mel.  The two
    front-ends differ by up to 1e-4 (float32 FFTs,
    test_torch_port_modules.py::test_speech_frontend_matches), and the
    train-mode gradient of the SE-ResNet trunk amplifies such an input
    difference to percents on these random weights; with one mel the
    comparison sees the training path alone."""
    from gesture_diffusion_torch.models import speech_encoder
    from gesture_diffusion_tpu.ops.audio import speech_frontend as jax_frontend

    monkeypatch.setattr(speech_encoder, "speech_frontend", lambda wav: torch.from_numpy(
        np.asarray(jax_frontend(jnp.asarray(wav.numpy())))))


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def test_train_step_matches_jax_float32(step_case, jax_step_grads):
    """float32: the loss terms, grad_norm, the BN running statistics, and
    every gradient outside the SE-ResNet trunk by name, after one step
    from the same weights, batch, t and noise.  The trunk's float32
    gradients are ill-conditioned here (the JAX package's own are off its
    float64 result by up to 9.2e-3 of max|g|, and each front-end's mel
    moves them by percents); they are held in float64 and against the JAX
    package's float32 error by the next tests."""
    model_type, cfg, variables, batch, _, t, noise = step_case
    losses, grads, stats = jax_step_grads[32]
    model, tensors = _port(cfg, variables, batch)
    step = make_train_step(model, make_schedule(BETAS),
                           make_adamw(model.parameters(), 0.0, 0.0),
                           lambda s: 0.0, LOSS_PARAMS)
    metrics = step(tensors, 0, t=torch.from_numpy(t).long(),
                   noise=torch.from_numpy(noise))
    for k, v in losses.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=TOL), k
    ref_norm = float(optax.global_norm(grads))
    assert float(metrics["grad_norm"]) == pytest.approx(ref_norm, rel=NORM_TOL_F32)
    ref_grads = state_dict_from_jax({"params": grads, "batch_stats": stats}, cfg)
    errors = _grad_errors(model, ref_grads)
    outside = {k: v for k, v in errors.items() if not k.startswith(TRUNK)}
    assert len(outside) > 40
    for name, (err, bar) in outside.items():
        assert err <= bar, (name, err, bar)
    trunk = max(e / b for k, (e, b) in errors.items() if k.startswith(TRUNK))
    print(f"{model_type} float32: the trunk's worst gradient is {trunk * GRAD_TOL:.2e} "
          "of its max|g| from JAX")
    ours = _bn_stats(model.state_dict())
    assert len(ours) == 2 * 39      # stem, 16 blocks x 2, 3 projections, 3 heads
    for k, v in ours.items():
        assert rel_err(v, ref_grads[k]) < TOL, k


def test_train_step_grads_match_jax_float64(step_case, jax_step_grads, shared_mel):
    """float64 on both sides, one mel: every gradient by name at 1e-4 of
    its max|g| (the attention scores stay float32 in both packages)."""
    model_type, cfg, variables, batch, _, t, noise = step_case
    losses, grads, stats = jax_step_grads[64]
    assert jax.tree.leaves(grads)[0].dtype == np.float64
    model, tensors = _port(cfg, variables, batch, torch.float64)
    step = make_train_step(model, make_schedule(BETAS),
                           make_adamw(model.parameters(), 0.0, 0.0),
                           lambda s: 0.0, LOSS_PARAMS)
    metrics = step(tensors, 0, t=torch.from_numpy(t).long(),
                   noise=torch.from_numpy(noise).double())
    for k, v in losses.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=TOL), k
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(optax.global_norm(grads)), rel=NORM_TOL_F64)
    errors = _grad_errors(model, state_dict_from_jax(
        {"params": grads, "batch_stats": stats}, cfg))
    for name, (err, bar) in errors.items():
        assert err <= bar, (name, err, bar)
    print(f"{model_type} float64: worst gradient {max(e / b for e, b in errors.values()) * GRAD_TOL:.2e}"
          " of its max|g|")


def _worst_rel(grads, ref, names):
    """The worst max|g - ref| / max|ref| over the tensors ``names``."""
    return max(float((grads[k].double() - ref[k].double()).abs().max()
                     / ref[k].double().abs().max()) for k in names)


def test_trunk_float32_grads_no_worse_than_jax(step_case, jax_step_grads, shared_mel):
    """The SE-ResNet trunk's float32 gradients, one mel: the port's against
    its own float64 result, and against the JAX package's float64 result,
    are each at most twice the JAX package's own float32 error (its float32
    against its float64).  Found: JAX 3.1e-3 (s2g_v2) and 9.2e-3
    (inpaint) of max|g|; the port 5.6e-3 and 1.5e-3, against its own
    float64 and JAX's alike."""
    model_type, cfg, variables, batch, _, t, noise = step_case
    ref = {bits: state_dict_from_jax({"params": g, "batch_stats": s}, cfg)
           for bits, (_, g, s) in jax_step_grads.items()}
    ours = {}
    for bits, dtype in ((32, torch.float32), (64, torch.float64)):
        model, tensors = _port(cfg, variables, batch, dtype)
        step = make_train_step(model, make_schedule(BETAS),
                               make_adamw(model.parameters(), 0.0, 0.0),
                               lambda s: 0.0, LOSS_PARAMS)
        step(tensors, 0, t=torch.from_numpy(t).long(),
             noise=torch.from_numpy(noise).to(dtype))
        ours[bits] = {k: p.grad for k, p in model.named_parameters()}
    names = [k for k in ours[32] if k.startswith(TRUNK)]
    assert len(names) > 100
    jax_err = _worst_rel(ref[32], ref[64], names)
    port_err = _worst_rel(ours[32], ours[64], names)
    port_vs_jax64 = _worst_rel(ours[32], ref[64], names)
    print(f"{model_type}: the trunk's float32 gradients against float64, worst "
          f"max|d|/max|g|: JAX {jax_err:.2e}, the port {port_err:.2e}, the port "
          f"against JAX's float64 {port_vs_jax64:.2e}")
    assert port_err <= 2 * jax_err and port_vs_jax64 <= 2 * jax_err


def test_train_step_params_after_adamw_match_jax(step_case, shared_mel):
    """The whole step in float64, with weight decay and a norm clip that
    binds, then a value clip.  The JAX step gives the loss terms, the norm
    and the BN statistics.  The parameters are held against the JAX step's
    optimizer tail (``clip_gradients``, then ``optax.adamw``) applied to the
    JAX gradient of the same loss: two JAX computations of the trunk's
    gradient differ by about 3e-4 of max|g| (float32 attention scores in
    both, amplified by the train-mode trunk), enough to flip the signs of
    small elements.  Adam's first update is lr * g / (|g| + 1e-8) for the
    clipped g, about lr * sign(g), which flips where g lies within float
    noise of 0.  So every element is held to 1e-3 * lr except those whose
    clipped |g| is below 1e-5 * max|g| of its tensor, or below twice the
    tensor's largest difference between the two clipped gradients (the
    noise); their number is reported and must stay below 1% (found: 0.3%,
    nearly all in the trunk, whose float noise is the widest)."""
    from jax.flatten_util import ravel_pytree

    model_type, cfg, variables, batch, key, _, _ = step_case
    lr, wd, norm_clip, value_clip = 1e-3, 0.1, 40.0, 1.0
    with jax.enable_x64(True):
        t, noise = _jax_draws(key, 0, batch["pose"].shape, jnp.float64)
        v64 = _f64(variables)
        batch64 = {"pose": batch["pose"].astype(np.float64), "wav": batch["wav"]}
        _, grads, stats = _jax_grads(cfg, v64, batch64, t, noise, LOSS_PARAMS)
        assert float(optax.global_norm(grads)) > 2 * norm_clip   # the clip binds
        opt = optax.adamw(lr, weight_decay=wd)
        params = jax.tree.map(jnp.asarray, v64["params"])
        state = TrainState(params, jax.tree.map(jnp.asarray, v64["batch_stats"]),
                           init_opt_state(opt, params), jnp.asarray(0, jnp.int32))
        jax_step = jax_make_train_step(JaxDenoiser(cfg), jax_make_schedule(BETAS),
                                       opt, LOSS_PARAMS, norm_clip, value_clip)
        # the JAX step draws its own t and noise: those handed to the port
        new_state, ref_metrics = jax_step(
            state, {k: jnp.asarray(v) for k, v in batch64.items()}, key)
        flat_g, unravel = ravel_pytree(grads)
        flat_p, _ = ravel_pytree(v64["params"])
        clipped = jax_clip(flat_g, norm_clip, value_clip)
        updates, _ = opt.update(clipped, opt.init(flat_p), flat_p)
        ref_params, clipped = unravel(flat_p + updates), unravel(clipped)
        ref_params, clipped, stats_after, ref_metrics = jax.tree.map(
            np.asarray, (ref_params, clipped, new_state.batch_stats, ref_metrics))

    model, tensors = _port(cfg, variables, batch, torch.float64)
    step = make_train_step(model, make_schedule(BETAS),
                           make_adamw(model.parameters(), lr, wd), lambda s: lr,
                           LOSS_PARAMS, norm_clip, value_clip)
    metrics = step(tensors, 0, t=torch.from_numpy(t).long(),
                   noise=torch.from_numpy(noise))
    for k, v in ref_metrics.items():
        bar = NORM_TOL_F64 if k == "grad_norm" else TOL
        assert float(metrics[k]) == pytest.approx(float(v), rel=bar), k

    ref = state_dict_from_jax({"params": ref_params, "batch_stats": stats_after}, cfg)
    clipped = state_dict_from_jax({"params": clipped, "batch_stats": stats}, cfg)
    ours = model.state_dict()
    near_zero = total = 0
    for name, p in model.named_parameters():
        g = clipped[name].numpy()
        noise_floor = float(np.abs(p.grad.numpy() - g).max())
        small = np.abs(g) < max(1e-5 * np.abs(g).max(), 2 * noise_floor)
        d = np.abs(ours[name].double().numpy() - ref[name].double().numpy())
        assert (d[~small] <= 1e-3 * lr).all(), (name, float(d[~small].max()))
        near_zero += int(small.sum())
        total += g.size
    print(f"{model_type}: {near_zero} of {total} elements within the noise of 0")
    assert near_zero < 1e-2 * total
    for k, v in _bn_stats(ours).items():
        assert rel_err(v, ref[k]) < TOL, k


def test_dropout_masks_follow_seed_and_step():
    """At p > 0 a step's masks are a function of (seed, step): the same
    step of two fresh copies gives the same loss, another step another;
    the step leaves the global generator as it found it."""
    cfg, variables, batch = _step_inputs("s2g_v2", seed=9, dropout=0.2)
    t, noise = _t_noise(3, batch["pose"].shape)
    losses = []
    for step_no in (4, 4, 5):
        model, tensors = _port(cfg, variables, batch)
        step = make_train_step(model, make_schedule(BETAS),
                               make_adamw(model.parameters(), 0.0, 0.0),
                               lambda s: 0.0, seed=1)
        rng_state = torch.get_rng_state()
        losses.append(float(step(tensors, step_no, t=torch.from_numpy(t).long(),
                                 noise=torch.from_numpy(noise))["loss"]))
        assert torch.equal(torch.get_rng_state(), rng_state)
    assert losses[0] == losses[1] != losses[2]


def test_encoder_bf16_loss_tracks_jax_and_fp32():
    """encoder_dtype="bfloat16": after the same 3 steps, the port's loss is
    within 2% of the JAX bf16 loss and of its own f32 loss (the bound of
    tests/test_training.py::test_encoder_bf16_matches_fp32_loss)."""
    wav = np.random.default_rng(0).normal(0, 0.5, (8, WAV)).astype(np.float32)
    poses = 0.5 * np.random.default_rng(1).normal(size=(8, TW, D_POSE)).astype(np.float32)
    batch = {"pose": poses, "wav": wav}
    key = jax.random.key(7)
    draws = [_jax_draws(key, s, poses.shape) for s in range(3)]
    cfg, variables = jax_variables("s2g_v2", wav=wav[:2], seed=0, d_model=DMS,
                                   heads=HS, t=TW, encoder_dtype="bfloat16")
    opt = optax.adamw(1e-3)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       init_opt_state(opt, params), jnp.asarray(0, jnp.int32))
    jax_step = jax_make_train_step(JaxDenoiser(cfg), jax_make_schedule(BETAS), opt, None)
    for _ in range(3):
        state, m = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    losses = {"jax_bf16": float(m["loss"])}
    for tag, enc in (("bf16", "bfloat16"), ("f32", None)):
        model = GestureDenoiser(DenoiserConfig(d_pose=D_POSE, d_model=DMS, heads=HS,
                                               n_layers=1, encoder_dtype=enc))
        model.load_state_dict(state_dict_from_jax(variables, cfg))
        step = make_train_step(model, make_schedule(BETAS),
                               make_adamw(model.parameters(), 1e-3, 1e-4),
                               lambda s: 1e-3)
        tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
        for s, (t, noise) in enumerate(draws):
            out = step(tensors, s, t=torch.from_numpy(t).long(),
                       noise=torch.from_numpy(noise))
        losses[tag] = float(out["loss"])
    print(losses)
    assert losses["bf16"] == pytest.approx(losses["jax_bf16"], rel=0.02), losses
    assert losses["bf16"] == pytest.approx(losses["f32"], rel=0.02), losses
