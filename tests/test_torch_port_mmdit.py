"""The port's ``mmdit`` decoder (SD3-Medium's joint-stream transformer,
``gesture_diffusion_torch/models/mmdit.py``) against the benchmark's plain
reference (``benchmark/reference/decoders/mmdit.py``), which stands in for
the JAX package: it has no such decoder.  On the CPU at d_model 64, 4
heads and 3 blocks (two full blocks and the ``context_pre_only`` last
one), model type default, with the benchmark's seeded weights; and the
published configuration built on the meta device."""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark.common import inputs, program, weights
from benchmark.reference import diffusion as rd
from benchmark.reference import model as rm
from benchmark.reference.decoders import mmdit as ref_mmdit
from gesture_diffusion_torch.diffusion import make_diffusion
from gesture_diffusion_torch.diffusion.sampling import ddim_sample_loop
from gesture_diffusion_torch.models import mmdit as port_mmdit
from gesture_diffusion_torch.models.factory import build_model, init_random_
from gesture_diffusion_torch.utils.json_config import JsonConfig

torch.set_num_threads(1)

CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / \
    "tedexp-mmdit.json"
SEED = 2 ** 31 + 19
D, HEADS, BLOCKS, D_POSE = 64, 4, 3, 12
# float32 on both sides; the port attends through scaled_dot_product_attention
# and modulates with addcmul, the reference through einsum and plain
# products, so the sums round apart: found 1.7e-7 to 3.5e-7 of the
# output's magnitude over three blocks, held to 1e-5 as the other
# decoders' denoise is
TOL_DENOISE = 1e-5
# the same through 5 DDIM steps on 2 chained windows with the seed blend:
# each step's rounding is carried into the next (found 3.6e-7); the
# scan-path bar of the other decoders' sequences
TOL_SEQUENCE = 2e-5


def full_config() -> dict:
    return json.loads(CONFIG.read_text())


def tiny_config() -> dict:
    cfg = full_config()
    cfg["Model"]["d_model"] = D
    cfg["Model"]["Decoder"].update(heads=HEADS, n_layers=BLOCKS)
    cfg["Model"]["Diffusion"]["timestep_respacing"] = "ddim5"
    cfg["d_pose"] = D_POSE
    return cfg


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def pair():
    """(config, reference, port Generator, state dict) on one drawn state
    dict."""
    cfg = tiny_config()
    ref = rm.build(cfg, "cpu")
    sd = weights.make_state_dict(ref, SEED, "cpu")
    ref.load_state_dict(sd)
    return cfg, ref, program.build_generator(cfg, sd, "cpu"), sd


@pytest.fixture(scope="module")
def memory(pair):
    _, ref, _, _ = pair
    wav = inputs.speech(SEED, 2, 36266, "cpu")
    with torch.no_grad():
        return ref.encode(wav)


@pytest.mark.parametrize("t", [[0, 999], [500, 20]])
def test_denoise_matches_reference(pair, memory, t):
    _, ref, gen, _ = pair
    x = torch.randn((2, 34, D_POSE), generator=torch.Generator().manual_seed(3))
    t = torch.tensor(t)
    with torch.no_grad():
        want = ref.denoise(x, t, memory)
        got = gen.model.denoise(x, t, memory)
    assert memory.shape[1] == 103      # tedexp's default memory at 34 frames
    assert rel(got, want) < TOL_DENOISE


def test_generate_sequence_matches_reference(pair):
    cfg, ref, gen, _ = pair
    data, g = cfg["Data"], cfg["Model"]["Generate"]
    sr, fps, t, k = (data["wav_sr"], data["pose_fps"], data["pose_window_len"],
                     g["pose_seed_len"])
    wav = inputs.speech(SEED, 2, 4 * sr, "cpu")
    frames, windows = rd.window_plan(wav.shape[1], sr, fps, t, k)
    assert windows == 2
    noise, init = inputs.request_draws(SEED, 0, windows, 2, t, D_POSE, k, "cpu")
    got = gen.generate_sequence(
        wav.numpy(), sr, D_POSE, fps, t, k, smooth_trans=True,
        trans_factor=g["trans_factor"], init_poses=init.numpy(), batch_size=2,
        noise_fn=lambda b0, w: noise[w, b0:b0 + 2])
    assert gen.last_sample_path == "scan"
    want = rd.sequence(ref, rd.Schedule(1000, "ddim5"), wav, noise, init, cfg)
    assert got.shape == (2, frames, D_POSE)
    assert rel(got, want) < TOL_SEQUENCE


def _chunks(kind, impl, j, x, silu_c, v):
    """The module's outputs with its linear's weight zeroed and bias chunk
    ``j`` set to ``v``: (modulated x, then the chunks it hands on)."""
    mod = getattr(impl, kind)(D) if impl is port_mmdit else \
        getattr(impl, kind)(D, rm.Operand())
    with torch.no_grad():
        mod.linear.weight.zero_()
        mod.linear.bias.zero_()
        mod.linear.bias[j * D:(j + 1) * D] = v
        out = mod(x, silu_c)
    if kind == "AdaLayerNormContinuous":
        return out, ()
    if impl is port_mmdit:
        return out[0], out[1]
    return out[0], out[1:]


@pytest.mark.parametrize("impl", [ref_mmdit, port_mmdit],
                         ids=["reference", "port"])
@pytest.mark.parametrize("kind,j,role", [
    ("AdaLayerNormZero", 0, "shift"), ("AdaLayerNormZero", 1, "scale"),
    ("AdaLayerNormZero", 2, "gate_msa"), ("AdaLayerNormZero", 3, "shift_mlp"),
    ("AdaLayerNormZero", 4, "scale_mlp"), ("AdaLayerNormZero", 5, "gate_mlp"),
    ("AdaLayerNormContinuous", 0, "scale"),
    ("AdaLayerNormContinuous", 1, "shift")])
def test_modulation_chunk_order(impl, kind, j, role):
    """SD3's order: (shift, scale, gate) for the attention, then for the
    MLP, in AdaLayerNormZero; scale before shift in
    AdaLayerNormContinuous."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 7, D), generator=g) * 3.0 + 1.0
    silu_c = F.silu(torch.randn((2, D), generator=g))
    z = F.layer_norm(x, (D,), eps=1e-6)
    v = torch.linspace(0.5, 1.5, D)
    out, handed = _chunks(kind, impl, j, x, silu_c, v)
    want = {"shift": z + v, "scale": z * (1.0 + v)}.get(role, z)
    # the same float32 operations on both sides, but for addcmul's fused
    # multiply-add in the port: an ulp of values near 4
    torch.testing.assert_close(out, want, rtol=0, atol=2e-6)
    names = ("gate_msa", "shift_mlp", "scale_mlp", "gate_mlp")
    for name, chunk in zip(names, handed):
        expect = v if name == role else torch.zeros(D)
        assert torch.equal(chunk, expect.expand(2, D)), name


@pytest.mark.parametrize("row", [None, 0, 51, 102])
def test_the_step_and_each_context_row_move_the_output(pair, memory, row):
    """The step (the decoder's row 0, the conditioning vector) and each
    speech-memory row (the context stream) reach the poses, in the port
    and the reference alike."""
    _, ref, gen, _ = pair
    x = torch.randn((2, 34, D_POSE), generator=torch.Generator().manual_seed(6))
    t = torch.tensor([300, 301])
    t2, moved = t, memory.clone()
    if row is None:
        t2 = t + 1
    else:
        moved[:, row] += 0.5
    with torch.no_grad():
        for model in (ref, gen.model):
            d = (model.denoise(x, t2, moved) - model.denoise(x, t, memory)).abs()
            assert float(d.amax(dim=(1, 2)).min()) > 1e-4


def test_last_block_is_context_pre_only(pair):
    _, _, gen, sd = pair
    last = f"pose_decoder.transformer_blocks.{BLOCKS - 1}."
    for i in range(BLOCKS):
        pre = f"pose_decoder.transformer_blocks.{i}."
        names = {k[len(pre):] for k in sd if k.startswith(pre)}
        context_out = {n for n in names
                       if n.startswith(("attn.to_add_out", "ff_context"))}
        assert bool(context_out) == (pre != last), (i, sorted(context_out))
        assert "attn.add_q_proj.weight" in names
        want_rows = (2 if pre == last else 6) * D
        assert sd[pre + "norm1_context.linear.weight"].shape == (want_rows, D)
    assert gen.model.pose_decoder.transformer_blocks[-1].ff_context is None


def test_every_drawn_tensor_is_drawn(pair):
    """The benchmark draws Linear, Conv, affine LayerNorm and BatchNorm
    tensors and fills anything else with zeros: every floating tensor of
    the configuration's state dict must be one it draws."""
    _, ref, _, sd = pair
    drawn = {name for name, _, _, _ in weights._entries(ref)}
    floating = {k for k, v in sd.items() if v.is_floating_point()}
    assert floating <= drawn
    zero = [k for k in floating if not bool(sd[k].abs().max() > 0)]
    assert not zero


def test_init_random_and_spans(pair, memory):
    """``init_random_`` redraws the port's model (no norm without an
    affine in its way), and a profiled scan sample carries the block
    spans, each inside a ``sampler/step`` span."""
    cfg, _, _, _ = pair
    model = build_model(D_POSE, JsonConfig(cfg).Model, device="cpu")
    init_random_(model, torch.Generator().manual_seed(8))
    w = model.pose_decoder.transformer_blocks[0].attn.to_q.weight.detach()
    assert 0.0 < float(w.abs().max()) <= (6.0 / (2 * D)) ** 0.5
    steps = 3
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sched, tmap = make_diffusion("linear", 1000, f"ddim{steps}")
        ddim_sample_loop(sched, lambda x, t: model.denoise(x, t, memory),
                         torch.randn(2, 34, D_POSE), timestep_map=tmap)
    spans = {}
    for ev in prof.events():
        spans.setdefault(ev.name, []).append(
            (ev.time_range.start, ev.time_range.end))
    step_spans = spans["sampler/step"]
    assert len(step_spans) == steps
    for name in ("mmdit/block", "mmdit/modulation", "mmdit/joint_attention",
                 "mmdit/feed_forward"):
        assert len(spans.get(name, [])) == steps * BLOCKS, name
        assert all(any(a <= s and e <= b for a, b in step_spans)
                   for s, e in spans[name]), name


def test_published_configuration_on_meta():
    """tedexp-mmdit at SD3-Medium's widths builds on the meta device, no
    weight allocated, in the port and the reference, with the same state
    dict names and shapes."""
    cfg = full_config()
    with torch.device("meta"):
        port = build_model(cfg["d_pose"], JsonConfig(cfg).Model, device="meta")
    ref = rm.build(cfg, "meta")
    assert all(p.is_meta for p in port.parameters())
    dec = port.pose_decoder
    blocks = dec.transformer_blocks
    assert len(blocks) == 24
    assert dec.pos_embed.proj.out_features == 1536
    assert blocks[0].attn.heads == 24
    assert blocks[0].attn.to_q.out_features // blocks[0].attn.heads == 64
    assert blocks[0].ff.net[0].proj.out_features == 6144
    assert blocks[-1].context_pre_only and not blocks[-2].context_pre_only
    count = sum(p.numel() for p in port.parameters())
    assert abs(count / 2.03e9 - 1.0) < 0.01, count
    assert ({k: tuple(v.shape) for k, v in port.state_dict().items()}
            == {k: tuple(v.shape) for k, v in ref.state_dict().items()})
