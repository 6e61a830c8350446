"""The serving path's spans (``utils/profiling.py::span``): their names,
nesting and counts under ``torch.profiler``, outputs unchanged by the
profiler, and nothing recorded without one.

The Generators are those of ``test_torch_port_generator.py`` (a 1-layer
oneway denoiser at d_model 256, 8 heads, 12 pose channels, windows of 8
frames, ddim10 over 100 steps, 1 s clips at 16 kHz), with weights drawn
by ``init_random_``: the file imports neither JAX nor the JAX package, so
its card case runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_spans.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gesture_diffusion_torch.diffusion import make_diffusion
from gesture_diffusion_torch.generation import Generator, window_plan
from gesture_diffusion_torch.models import (DenoiserConfig, GestureDenoiser,
                                            init_random_)
from gesture_diffusion_torch.training import make_optimizer, make_train_step
from gesture_diffusion_torch.utils import profiling

torch.set_num_threads(1)

D_POSE, T, STEPS = 12, 8, 10
SR, FPS, SEED_LEN = 16000, 8, 2      # 1 s windows of T=8 frames, stride 6
SPANS = ("generate/sample", "generate/inputs", "generate/memory",
         "generate/prepare", "fused/launch", "sampler/step",
         "generate/sequence", "generate/window", "generate/to_host",
         "generate/stitch")


def _model(device="cpu"):
    model = GestureDenoiser(DenoiserConfig(d_pose=D_POSE, n_layers=1))
    init_random_(model, torch.Generator().manual_seed(41))
    return model.to(device).eval()


@pytest.fixture(scope="module")
def gens():
    """(fused Generator on the plain version, scan Generator, clips)."""
    model = _model()
    sched, tmap = make_diffusion("linear", 100, f"ddim{STEPS}")
    fused = Generator(model, sched, tmap, fused_dtype=torch.float32,
                      device="cpu")
    scan = Generator(model, sched, tmap, use_fused=False, device="cpu")
    wav = np.random.default_rng(40).normal(0, 0.3, (2, SR)).astype(np.float32)
    return fused, scan, wav


def _seeded(seed):
    rng = np.random.default_rng(seed)
    poses = rng.normal(size=(2, T, D_POSE)).astype(np.float32)
    mask = np.zeros((2, T, 1), np.float32)
    mask[:, :SEED_LEN] = 1.0
    return dict(noise=rng.normal(size=(2, T, D_POSE)).astype(np.float32),
                inpaint_poses=poses, inpaint_masks=mask, trans_factor=0.575,
                pose_seed_len=SEED_LEN)


def _recorded(fn, cuda=False):
    """(fn's result, its host spans [(name, start, end)] in start order,
    its device operations [(name, start, end)]), ns on the trace's
    clock."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    host, device = [], []
    for ev in prof.profiler.kineto_results.events():
        a = ev.start_ns()
        item = (ev.name(), a, a + ev.duration_ns())
        if "cuda" in str(ev.device_type()).lower():
            device.append(item)
        elif item[0] in SPANS or item[0].startswith("train_step/"):
            host.append(item)
    return out, sorted(host, key=lambda e: e[1]), device


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _counts(spans):
    return {name: len(_named(spans, name)) for name in SPANS
            if _named(spans, name)}


def test_span_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b") is profiling._NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("a") is not profiling._NO_SPAN


def test_nothing_recorded_without_a_profiler(gens, monkeypatch):
    """No range is opened while no profiler records: the serving calls
    never reach ``record_function``."""
    fused, scan, wav = gens

    def refused(name):
        raise AssertionError(f"span {name!r} recorded with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    fused.generate_sample(wav, D_POSE, T, **_seeded(1))
    scan.generate_sample(wav, D_POSE, T, **_seeded(1))
    fused.generate_sequence(np.tile(wav, 2), SR, D_POSE, FPS, T, SEED_LEN,
                            generator=torch.Generator().manual_seed(2))


@pytest.mark.parametrize("path", ["fused", "scan"])
def test_generate_sample_spans(gens, path):
    fused, scan, wav = gens
    gen = fused if path == "fused" else scan
    _, spans, _ = _recorded(
        lambda: gen.generate_sample(wav, D_POSE, T, **_seeded(3)))
    want = {"generate/sample": 1, "generate/inputs": 1, "generate/memory": 1}
    # the plain version on the CPU launches nothing: no fused/launch
    want.update({"generate/prepare": 1} if path == "fused"
                else {"sampler/step": STEPS})
    assert _counts(spans) == want
    outer = _named(spans, "generate/sample")[0]
    phases = [s for s in spans if s is not outer]
    assert all(_inside(s, outer) for s in phases)
    # one after another, in the order the call runs them
    assert [s[0] for s in phases[:3]] == (
        ["generate/inputs", "generate/memory", "generate/prepare"]
        if path == "fused" else
        ["generate/inputs", "generate/memory", "sampler/step"])
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))


@pytest.mark.parametrize("alg", ["ddim", "ddpm"])
def test_sampler_steps_are_the_schedules(gens, alg):
    _, scan, wav = gens
    _, spans, _ = _recorded(lambda: scan.generate_sample(
        wav, D_POSE, T, generator=torch.Generator().manual_seed(4),
        sample_alg=alg))
    steps = _named(spans, "sampler/step")
    assert len(steps) == scan.num_steps == STEPS
    outer = _named(spans, "generate/sample")[0]
    assert all(_inside(s, outer) for s in steps)


@pytest.mark.parametrize("batch_size", [2, 1])
def test_generate_sequence_spans(gens, batch_size):
    fused, _, wav = gens
    wav_long = np.random.default_rng(43).normal(0, 0.3, (2, 2 * SR)).astype(
        np.float32)
    _, num_div = window_plan(wav_long.shape[1], SR, FPS, T, SEED_LEN)
    batches = -(-2 // batch_size)
    _, spans, _ = _recorded(lambda: fused.generate_sequence(
        wav_long, SR, D_POSE, FPS, T, SEED_LEN, batch_size=batch_size,
        generator=torch.Generator().manual_seed(5), trans_factor=0.575))
    windows = num_div * batches
    assert num_div == 3
    assert _counts(spans) == {
        "generate/sequence": 1, "generate/window": windows,
        "generate/sample": windows, "generate/inputs": windows,
        "generate/memory": windows, "generate/prepare": windows,
        "generate/to_host": windows, "generate/stitch": batches}
    seq = _named(spans, "generate/sequence")[0]
    assert all(_inside(s, seq) for s in spans if s is not seq)
    for window in _named(spans, "generate/window"):
        inner = [s for s in spans if s is not window and _inside(s, window)]
        assert [s[0] for s in inner if s[0] in (
            "generate/sample", "generate/to_host")] == [
            "generate/sample", "generate/to_host"]
    # a batch's stitch follows its last window
    for stitch in _named(spans, "generate/stitch"):
        assert any(w[2] <= stitch[1] for w in _named(spans, "generate/window"))


@pytest.mark.parametrize("case", ["fused-ddim", "fused-ddpm", "scan-ddim",
                                  "scan-ddpm", "sequence"])
def test_outputs_bit_equal_under_the_profiler(gens, case):
    fused, scan, wav = gens

    def run():
        g = torch.Generator().manual_seed(6)
        if case == "sequence":
            return torch.from_numpy(fused.generate_sequence(
                np.tile(wav, 2), SR, D_POSE, FPS, T, SEED_LEN, generator=g,
                trans_factor=0.575, batch_size=1))
        path, alg = case.split("-")
        gen = fused if path == "fused" else scan
        kw = _seeded(7)
        kw.pop("noise")
        return gen.generate_sample(wav, D_POSE, T, generator=g,
                                   sample_alg=alg, **kw)

    plain = run()
    traced, spans, _ = _recorded(run)
    assert spans
    assert torch.equal(plain, traced)


def test_train_step_ranges_keep_their_names():
    """``training/step_profile.py`` reads the step's three ranges by name."""
    model = _model()
    sched, _ = make_diffusion("linear", 100, "")
    step = make_train_step(model, sched, *make_optimizer(model))
    rng = np.random.default_rng(8)
    batch = {"pose": torch.from_numpy(rng.normal(size=(2, T, D_POSE))
                                      .astype(np.float32)),
             "wav": torch.from_numpy(rng.normal(0, 0.3, (2, SR))
                                     .astype(np.float32))}
    _, spans, _ = _recorded(lambda: step(batch, 0))
    names = [s[0] for s in spans]
    assert names == ["train_step/forward", "train_step/backward",
                     "train_step/optimizer"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_spans_share_the_device_clock(card):
    """Each window's fused kernel runs after its ``fused/launch`` span
    starts and ends before the window's ``generate/to_host`` span ends:
    the spans and the device's operations are on one clock."""
    sched, tmap = make_diffusion("linear", 100, f"ddim{STEPS}")
    gen = Generator(_model(card), sched, tmap)
    wav = np.random.default_rng(9).normal(0, 0.3, (2, 2 * SR)).astype(np.float32)
    args = (wav, SR, D_POSE, FPS, T, SEED_LEN)
    gen.generate_sequence(*args)                 # the build and the pack
    _, spans, device = _recorded(lambda: gen.generate_sequence(*args),
                                 cuda=True)
    kernels = sorted((d for d in device if "fused_ddim_kernel" in d[0]),
                     key=lambda d: d[1])
    launches = _named(spans, "fused/launch")
    to_host = _named(spans, "generate/to_host")
    _, num_div = window_plan(wav.shape[1], SR, FPS, T, SEED_LEN)
    assert len(kernels) == len(launches) == len(to_host) == num_div
    for kernel, launch, copy in zip(kernels, launches, to_host):
        assert launch[1] < kernel[1] and kernel[2] < copy[2]
