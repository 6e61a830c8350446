"""The frozen reference against the port's plain path, on the CPU at a
tiny width (the test imports the port; the reference does not), and the
weights made from the seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.common import inputs, program, weights
from benchmark.reference import diffusion as rd
from benchmark.reference import model as rm

from .tiny import config

SEED = 2 ** 31 + 11


def pair(name, shifts=True):
    cfg = config(name)
    ref = rm.build(cfg, "cpu")
    sd = weights.make_state_dict(ref, SEED, "cpu", shifts)
    ref.load_state_dict(sd)
    return cfg, ref, program.build_generator(cfg, sd, "cpu")


def rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name", ["beat-ours", "tedexp-ours"])
def test_state_dict_names_and_shapes_are_the_programs(name):
    cfg, ref, gen = pair(name)
    mine = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    theirs = {k: tuple(v.shape) for k, v in gen.model.state_dict().items()}
    assert mine == theirs


def test_full_width_beat_names_match():
    import json

    from .tiny import BENCH

    cfg = json.loads((BENCH / "configs" / "beat-ours.json").read_text())
    ref = rm.build(cfg, "meta")
    from gesture_diffusion_torch.models.factory import build_all
    from gesture_diffusion_torch.utils.json_config import JsonConfig

    model = build_all(JsonConfig(cfg), cfg["d_pose"], device="cpu").model
    assert ({k: tuple(v.shape) for k, v in ref.state_dict().items()}
            == {k: tuple(v.shape) for k, v in model.state_dict().items()})


@pytest.mark.parametrize("name", ["beat-ours", "tedexp-ours"])
def test_encoder_and_step_match(name):
    cfg, ref, gen = pair(name)
    wav = inputs.speech(SEED, 2, 36266, "cpu")
    with torch.no_grad():
        mem = ref.encode(wav)
        assert rel(mem, gen.model.encode_memory(wav)) < 1e-5
        x = torch.randn(2, cfg["Data"]["pose_window_len"], cfg["d_pose"])
        t = torch.tensor([3, 917])
        assert rel(ref.denoise(x, t, mem), gen.model.denoise(x, t, mem)) < 1e-5


def test_window_matches_the_fused_path():
    """Request shapes of the live cell: a seeded window, x0 blend and ramp,
    float32 compute on the bf16 pack (exact on the live cell's weights,
    whose LayerNorm shifts are 0)."""
    cfg, ref, gen = pair("beat-ours", shifts=False)
    n, t, c, k = 2, 40, cfg["d_pose"], 10
    wav = inputs.speech(SEED, n, 32000, "cpu")
    noise, seed = inputs.request_draws(SEED, 0, 1, n, t, c, k, "cpu")
    ip = torch.zeros(n, t, c)
    ip[:, :k] = seed
    mask = torch.zeros(n, t, 1)
    mask[:, :k] = 1.0
    got = gen.generate_sample(wav, c, t, noise=noise[0], inpaint_poses=ip,
                              inpaint_masks=mask, trans_factor=0.575,
                              pose_seed_len=k)
    assert gen.last_sample_path == "fused"
    want = rd.ddim(ref, rd.Schedule(1000, "ddim10"), wav, noise[0], seed,
                   rd.seed_ramp(0.575, k, t))
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("name", ["beat-ours", "tedexp-ours"])
def test_sequence_matches(name):
    """Chained windows, with the crossfade of tedexp's smooth transition;
    tedexp through the scan sampler, with LayerNorm shifts; beat's two
    clips through the fused path's float32 compute on the bf16 pack,
    exact where the shifts are 0."""
    cfg, ref, gen = pair(name, shifts=name != "beat-ours")
    data, g = cfg["Data"], cfg["Model"]["Generate"]
    n, t, c, k = 2, data["pose_window_len"], cfg["d_pose"], g["pose_seed_len"]
    wav = inputs.speech(SEED, n, 4 * 16000, "cpu")
    frames, windows = rd.window_plan(wav.shape[1], 16000, data["pose_fps"], t, k)
    noise, init = inputs.request_draws(SEED, 3, windows, n, t, c, k, "cpu")
    got = gen.generate_sequence(
        wav.numpy(), 16000, c, data["pose_fps"], t, k,
        smooth_trans=bool(g.get("smooth_transition")),
        trans_factor=g["trans_factor"], init_poses=init.numpy(),
        noise_fn=lambda b0, w: noise[w, b0:b0 + 64])
    want = rd.sequence(ref, rd.Schedule(1000, "ddim10"), wav, noise, init, cfg)
    assert got.shape == tuple(want.shape) == (n, frames, c)
    assert rel(got, want) < 1e-5


def test_weights_repeat_and_are_served_exactly_in_bf16():
    ref = rm.build(config("beat-ours"), "meta")
    a = weights.make_state_dict(ref, SEED, "cpu")
    b = weights.make_state_dict(ref, SEED, "cpu")
    c = weights.make_state_dict(ref, SEED + 1, "cpu")
    z = weights.make_state_dict(ref, SEED, "cpu", layernorm_shifts=False)
    key = "pose_decoder.layers.0.self_attn.query.0.linear.weight"
    shift = "pose_decoder.layers.0.norm_ff.bias"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[key], c[key])
    for k, v in a.items():
        if v.is_floating_point():
            assert torch.equal(v, v.to(torch.bfloat16).float()), k
    ln = a["pose_decoder.layers.0.norm_ff.weight"]
    assert set(ln.unique().tolist()) <= {0.5, 1.0, 2.0}
    assert 0.05 < float(a[shift].abs().max()) <= 0.1
    # without shifts only the LayerNorm shifts change, to 0
    assert not z[shift].any()
    shifts = {f"{name}.bias" for name, mod in ref.named_modules()
              if isinstance(mod, torch.nn.LayerNorm)}
    assert shift in shifts
    assert all(torch.equal(a[k], z[k]) for k in a if k not in shifts)


def test_bf16_pack_of_these_weights_is_exact():
    """The program folds each LayerNorm's affine into the next projection
    and casts the pack to bf16; on the live cell's weights (LayerNorm
    shifts 0) that loses nothing."""
    from gesture_diffusion_torch.ops.fused_sampler import pack_oneway_denoiser

    _, _, gen = pair("beat-ours", shifts=False)
    lo = pack_oneway_denoiser(gen.model, 12, 40, weight_dtype=torch.bfloat16)
    hi = pack_oneway_denoiser(gen.model, 12, 40, weight_dtype=torch.float32)
    for f in lo._fields:
        assert torch.equal(getattr(lo, f).float(), getattr(hi, f).float()), f


def test_folded_shifts_are_the_bf16_packs_only_rounding():
    """With LayerNorm shifts the bf16 pack departs from the f32 pack only
    in the biases a shift is folded into, each by bf16's rounding."""
    from gesture_diffusion_torch.ops.fused_sampler import pack_oneway_denoiser

    _, _, gen = pair("beat-ours")
    lo = pack_oneway_denoiser(gen.model, 12, 40, weight_dtype=torch.bfloat16)
    hi = pack_oneway_denoiser(gen.model, 12, 40, weight_dtype=torch.float32)
    moved = set()
    for f in lo._fields:
        a, b = getattr(lo, f).float(), getattr(hi, f).float()
        if not torch.equal(a, b):
            moved.add(f)
            assert float((a - b).abs().max()) <= 2 ** -8 * float(b.abs().max()), f
    assert moved and all("b" in f.split("_")[-1] for f in moved), moved


def test_schedule_respacing():
    s = rd.Schedule(1000, "ddim50")
    assert s.tmap == list(range(0, 1000, 20))
    full = rd.Schedule(1000)
    assert len(full) == 1000 and float(full.c2[0]) == 1.0
    assert np.isclose(float(s.c0[0]), float(full.c0[0]))
    with pytest.raises(ValueError):
        rd.Schedule(1000, "fast27")
