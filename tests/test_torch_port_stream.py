"""GestureStream of the port: the push API must give exactly what the
port's own ``generate_sequence`` gives on the same audio and the same
noise, whatever the push chunking or the in-flight depth; one case goes
against the JAX package's stream with its noise injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.diffusion import make_diffusion as jax_make
from gesture_diffusion_tpu.generation import Generator as JaxGenerator
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_torch.diffusion import make_diffusion
from gesture_diffusion_torch.generation import (Generator, GestureStream,
                                                window_plan)
from gesture_diffusion_torch.models import (DenoiserConfig, GestureDenoiser,
                                            init_random_)
from torch_port_common import jax_variables, port_model, rel_err

torch.set_num_threads(1)

D_POSE, T_POSE, SEED_LEN = 12, 10, 4
SR, FPS = 16000, 20          # 10-frame window = 0.5 s = 8000 samples
WAV_WINDOW = SR * T_POSE // FPS


def _generator(t_pose=T_POSE):
    model = GestureDenoiser(DenoiserConfig(d_pose=D_POSE, d_model=32, heads=4,
                                           n_layers=1))
    init_random_(model, torch.Generator().manual_seed(0))
    sched, tmap = make_diffusion("linear", 100, "ddim5")
    return Generator(model, sched, tmap, fused_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def gen():
    return _generator()


def _long_wav(seconds, n=1, seed=0):
    return np.random.default_rng(seed).normal(
        0, 0.3, (n, int(SR * seconds))).astype(np.float32)


def _noise_fn(n, t_pose=T_POSE):
    """Initial noise of window d, the same for both paths."""
    def fn(batch_start, d):
        return np.random.default_rng(1000 + d).normal(
            size=(n, t_pose, D_POSE)).astype(np.float32)
    return fn


def _offline(gen, wav, fps=FPS, t_pose=T_POSE, seed_len=SEED_LEN, **kw):
    return gen.generate_sequence(wav, SR, D_POSE, fps, t_pose, seed_len,
                                 noise_fn=_noise_fn(wav.shape[0], t_pose), **kw)


def _streamed(gen, wav, chunk, max_in_flight=4, fps=FPS, t_pose=T_POSE,
              seed_len=SEED_LEN, **kw):
    stream = gen.stream(SR, D_POSE, fps, t_pose, seed_len,
                        noise_fn=_noise_fn(wav.shape[0], t_pose),
                        max_in_flight=max_in_flight, **kw)
    assert isinstance(stream, GestureStream)
    chunks = []
    for i in range(0, wav.shape[-1], chunk):
        chunks.extend(stream.push(wav[:, i:i + chunk]))
    chunks.extend(stream.flush())
    return np.concatenate(chunks, axis=1)


def test_stream_equals_offline(gen):
    wav = _long_wav(2)
    ref = _offline(gen, wav)
    out = _streamed(gen, wav, chunk=3000)
    assert out.shape == ref.shape == (1, 2 * FPS, D_POSE)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("chunk", [512, 7999, 16000])
def test_chunk_size_invariance(gen, chunk):
    wav = _long_wav(2, seed=1)
    np.testing.assert_array_equal(_streamed(gen, wav, chunk=chunk),
                                  _streamed(gen, wav, chunk=WAV_WINDOW))


def test_in_flight_depth_invariance(gen):
    wav = _long_wav(2, seed=2)
    np.testing.assert_array_equal(
        _streamed(gen, wav, chunk=4000, max_in_flight=8),
        _streamed(gen, wav, chunk=4000, max_in_flight=1))


def test_with_init_poses_and_ramp(gen):
    wav = _long_wav(2, seed=3)
    init = np.random.default_rng(7).normal(
        size=(1, SEED_LEN, D_POSE)).astype(np.float32)
    kw = dict(init_poses=init, trans_factor=0.5)
    np.testing.assert_array_equal(_streamed(gen, wav, chunk=2500, **kw),
                                  _offline(gen, wav, **kw))


def test_no_smooth_trans(gen):
    wav = _long_wav(1, seed=4)
    np.testing.assert_array_equal(
        _streamed(gen, wav, chunk=1000, smooth_trans=False),
        _offline(gen, wav, smooth_trans=False))


def test_batch_of_streams(gen):
    wav = _long_wav(2, n=2, seed=5)
    out = _streamed(gen, wav, chunk=6000)
    assert out.shape == (2, 2 * FPS, D_POSE)
    np.testing.assert_array_equal(out, _offline(gen, wav))


@pytest.mark.parametrize("seconds", [1.9, 2.3, 3.05])
def test_fractional_second_audio(gen, seconds):
    """The offline plan truncates to whole seconds; eager dispatch must
    not launch windows beyond that plan."""
    wav = _long_wav(seconds, seed=11)
    ref = _offline(gen, wav)
    out = _streamed(gen, wav, chunk=2000)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_buffer_stays_bounded(gen):
    """A long-running stream holds O(window) audio, not O(stream)."""
    wav = _long_wav(6, seed=8)
    stream = gen.stream(SR, D_POSE, FPS, T_POSE, SEED_LEN,
                        noise_fn=_noise_fn(1), max_in_flight=2)
    chunks, max_buffered = [], 0
    for i in range(0, wav.shape[-1], 1000):
        chunks.extend(stream.push(wav[:, i:i + 1000]))
        max_buffered = max(max_buffered, sum(c.shape[-1] for c in stream._buf))
    chunks.extend(stream.flush())
    # one window of look-back, up to one second of plan-confirmation lag,
    # and one push chunk of slack
    assert max_buffered <= stream.wav_window_len + SR + 1000
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1),
                                  _offline(gen, wav))


@pytest.mark.parametrize("seconds", [2, 3])
def test_nonmonotone_plan_config(seconds):
    """window_plan is not monotone in the audio length when stride > fps;
    the stream's dispatch rule must still match offline."""
    fps, t_pose, seed_len = 4, 12, 5
    assert window_plan(2 * SR, SR, fps, t_pose, seed_len) == (8, 2)
    assert window_plan(3 * SR, SR, fps, t_pose, seed_len) == (12, 1)   # shrank
    g = _generator(t_pose)
    wav = _long_wav(seconds, seed=20 + seconds)
    kw = dict(fps=fps, t_pose=t_pose, seed_len=seed_len)
    ref = _offline(g, wav, **kw)
    out = _streamed(g, wav, chunk=5000, **kw)
    assert out.shape == ref.shape == (1, seconds * fps, D_POSE)
    np.testing.assert_array_equal(out, ref)


def test_seed_ge_window_rejected(gen):
    with pytest.raises(ValueError, match="stride would be <= 0"):
        gen.stream(SR, D_POSE, FPS, T_POSE, T_POSE)
    with pytest.raises(ValueError, match="stride would be <= 0"):
        window_plan(SR, SR, FPS, T_POSE, T_POSE)


def test_sub_second_audio_empty_output(gen):
    assert window_plan(SR - 1, SR, FPS, T_POSE, SEED_LEN) == (0, 0)
    wav = _long_wav(0.5, seed=9)
    assert _offline(gen, wav).shape == (1, 0, D_POSE)
    stream = gen.stream(SR, D_POSE, FPS, T_POSE, SEED_LEN)
    assert stream.push(wav) + stream.flush() == []
    with pytest.raises(RuntimeError, match="already flushed"):
        stream.push(wav)


def test_degenerate_plan_raises_consistently(gen):
    """Frames owed but no window planned: both paths raise the same error,
    the stream only at flush (more audio could still have come)."""
    fps, t_pose, seed_len = 5, 12, 5        # stride 7; 1 s -> 5 frames
    wav = _long_wav(1, seed=10)
    with pytest.raises(ValueError, match="audio too short"):
        gen.generate_sequence(wav, SR, D_POSE, fps, t_pose, seed_len)
    stream = gen.stream(SR, D_POSE, fps, t_pose, seed_len)
    assert stream.push(wav) == []
    with pytest.raises(ValueError, match="audio too short"):
        stream.flush()


def test_transient_degenerate_plan_recovers():
    fps, t_pose, seed_len = 5, 12, 5
    g = _generator(t_pose)
    wav = _long_wav(3, seed=12)
    kw = dict(fps=fps, t_pose=t_pose, seed_len=seed_len)
    out = _streamed(g, wav, chunk=SR, **kw)           # 1-second pushes
    assert out.shape == (1, 3 * fps, D_POSE)
    np.testing.assert_array_equal(out, _offline(g, wav, **kw))


def test_incremental_emission(gen):
    """Chunks come out during streaming, not all at flush."""
    wav = _long_wav(4, seed=6)
    stream = gen.stream(SR, D_POSE, FPS, T_POSE, SEED_LEN,
                        generator=torch.Generator().manual_seed(0),
                        max_in_flight=1)
    seen_before_flush = 0
    for i in range(0, wav.shape[-1], 2000):
        got = stream.push(wav[:, i:i + 2000])
        assert all(c.shape == (1, T_POSE - SEED_LEN, D_POSE) for c in got)
        seen_before_flush += len(got)
    assert seen_before_flush > 0
    assert len(stream.flush()) >= 1


def test_generator_state_gives_the_same_stream(gen):
    """Without a noise_fn both paths draw window noise from the caller's
    generator in window order, DDPM's kernel seed included."""
    wav = _long_wav(2, n=2, seed=13)
    for alg in ("ddim", "ddpm"):
        ref = gen.generate_sequence(wav, SR, D_POSE, FPS, T_POSE, SEED_LEN,
                                    generator=torch.Generator().manual_seed(3),
                                    sample_alg=alg)
        stream = gen.stream(SR, D_POSE, FPS, T_POSE, SEED_LEN,
                            generator=torch.Generator().manual_seed(3),
                            sample_alg=alg, max_in_flight=2)
        chunks = []
        for i in range(0, wav.shape[-1], 3000):
            chunks.extend(stream.push(wav[:, i:i + 3000]))
        chunks.extend(stream.flush())
        np.testing.assert_array_equal(np.concatenate(chunks, axis=1), ref)


@pytest.mark.parametrize("audio", [
    np.array([[1, 2, 3]], np.int16), [[1, 2, 3]], [1, 2, 3],
    torch.tensor([[1, 2, 3]], dtype=torch.int32)])
def test_integer_pcm_refused(gen, audio):
    """Integer PCM is 32768x the trained scale; it is refused after the
    conversion to an array, so plain lists are caught too."""
    stream = gen.stream(SR, D_POSE, FPS, T_POSE, SEED_LEN)
    with pytest.raises(TypeError, match="float"):
        stream.push(audio)
    assert stream.push([0.1, 0.2, -0.3]) == []          # float lists pass
    with pytest.raises(ValueError, match="batch size changed"):
        stream.push(np.zeros((2, 10), np.float32))


def test_stream_matches_jax_stream():
    """The port's stream against the JAX package's, with the JAX stream's
    window noise injected: it splits its key per window, and
    generate_sample splits that subkey once more for the noise."""
    sr, fps, t, seed_len = 16000, 8, 8, 2
    wav = np.random.default_rng(50).normal(0, 0.3, (2, 2 * sr)).astype(np.float32)
    cfg, variables = jax_variables("s2g_v2", n_layers=1, wav=wav[:, :sr], seed=51)
    sj, tj = jax_make("linear", 100, "ddim10")
    sp, tp = make_diffusion("linear", 100, "ddim10")
    jgen = JaxGenerator(JaxDenoiser(cfg), variables, sj, tj, use_fused=False)
    tgen = Generator(port_model(cfg, variables), sp, tp,
                     fused_dtype=torch.float32, device="cpu")
    init = np.random.default_rng(52).normal(size=(2, seed_len, D_POSE)).astype(np.float32)
    key = jax.random.key(53)
    jstream = jgen.stream(sr, D_POSE, fps, t, seed_len, key, trans_factor=0.575,
                          init_poses=jnp.asarray(init), max_in_flight=2)
    noises, k = [], key
    for _ in range(window_plan(wav.shape[1], sr, fps, t, seed_len)[1]):
        k, sub = jax.random.split(k)
        _, sub2 = jax.random.split(sub)
        noises.append(np.array(jax.random.normal(sub2, (2, t, D_POSE))))
    tstream = tgen.stream(sr, D_POSE, fps, t, seed_len, trans_factor=0.575,
                          init_poses=init, max_in_flight=2,
                          noise_fn=lambda b0, d: noises[d])
    ref, ours = [], []
    for i in range(0, wav.shape[1], 5000):
        ref.extend(jstream.push(wav[:, i:i + 5000]))
        ours.extend(tstream.push(wav[:, i:i + 5000]))
    ref.extend(jstream.flush())
    ours.extend(tstream.flush())
    assert [c.shape for c in ours] == [np.asarray(c).shape for c in ref]
    # float32 both sides through 10 DDIM steps per window, three windows
    # chained through their seed tails: 5e-5 relative
    assert rel_err(np.concatenate(ours, axis=1),
                   np.concatenate([np.asarray(c) for c in ref], axis=1)) < 5e-5
