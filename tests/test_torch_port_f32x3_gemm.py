"""The split-TF32 float32 product (``gesture_diffusion_torch/ops/f32_linear.py``)
on the CPU: its TF32 rounding against an independent reference, the
accuracy of its plain version against float64 (with a bar that one TF32
product and three bf16 pieces fail), the exact bias, the tile widths, the
packs' life, and which of the MMDiT's Linears take it.  The kernel itself
is held against this plain version on the card
(``tests/test_torch_port_f32x3_cuda.py``)."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gesture_diffusion_torch.models import mmdit
from gesture_diffusion_torch.models.compute_dtype import Linear
from gesture_diffusion_torch.ops import f32_linear as fl

torch.set_num_threads(1)

# float32 products (cuBLAS's SIMT route, or numpy's) read 4e-7 to 5e-7 of
# max|ref| at these shapes against float64; three TF32 products read the
# same; one TF32 product 2.5e-4 to 3.6e-4, three bf16 pieces 4e-6 to 5e-6
BAR = 1.5e-6
TF32_MAX = (2.0 - 2.0 ** -10) * 2.0 ** 127


def tf32_reference(v: float) -> float:
    """v (a float32 value) rounded to TF32 by arithmetic on Python floats:
    the quantum is 2^(e - 11) for |v| = m 2^e, 0.5 <= m < 1, with e held at
    -125 and below (float32's subnormals keep their 2^-149 step, so TF32's
    is 2^-136); ties to even; past the largest TF32 value, inf."""
    if v == 0.0 or math.isinf(v) or math.isnan(v):
        return v
    e = math.frexp(v)[1]
    q = 2.0 ** (max(e, -125) - 11)
    r = round(v / q) * q                 # round() ties to even
    return math.copysign(math.inf, v) if abs(r) > TF32_MAX else r


def f32(v) -> float:
    return float(np.float32(v))


EDGES = {
    "one": 1.0,
    "tie_down_to_even": 1.0 + 2.0 ** -11,
    "tie_up_to_even": 1.0 + 3 * 2.0 ** -11,
    "above_tie": 1.0 + 2.0 ** -11 + 2.0 ** -23,
    "below_tie": 1.0 + 2.0 ** -11 - 2.0 ** -23,
    "carry_into_exponent": 2.0 - 2.0 ** -23,
    "carry_at_255": f32(255.99),
    "negative_tie": -(1.0 + 3 * 2.0 ** -11),
    "negative_carry": -(4.0 - 2.0 ** -21),
    "largest_finite_to_inf": f32(np.finfo(np.float32).max),
    "largest_tf32": TF32_MAX,
    "smallest_subnormal": 2.0 ** -149,
    "subnormal_tie_to_zero": 2.0 ** -137,
    "subnormal_tie_up": 3 * 2.0 ** -137,
    "largest_subnormal_carries_to_normal": 2.0 ** -126 - 2.0 ** -149,
    "smallest_normal": 2.0 ** -126,
    "zero": 0.0,
    "negative_zero": -0.0,
    "inf": math.inf,
    "negative_inf": -math.inf,
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_tf32_round_edges(name):
    v = EDGES[name]
    got = float(fl.tf32_round(torch.tensor([v], dtype=torch.float32))[0])
    want = tf32_reference(f32(v))
    assert got == want and math.copysign(1, got) == math.copysign(1, want), \
        (name, got, want)


def test_tf32_round_keeps_nan_bits():
    # quiet, signalling, negative quiet (0xFFC00000), all ones (0xFFFFFFFF)
    bits = torch.tensor([0x7FC00000, 0x7F800001, -0x400000, -1, 0x7FFFFFFF],
                        dtype=torch.int32)
    got = fl.tf32_round(bits.view(torch.float32)).view(torch.int32)
    assert torch.equal(got, bits)


def test_tf32_round_matches_reference_over_the_range():
    g = np.random.default_rng(0)
    raw = g.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    x = raw.view(np.float32)
    x = x[np.isfinite(x)]
    got = fl.tf32_round(torch.from_numpy(x.copy())).numpy()
    want = np.array([tf32_reference(float(v)) for v in x], dtype=np.float64)
    assert np.array_equal(got.astype(np.float64), want)


def test_hi_plus_lo_reproduces_x():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(100000, generator=g) * torch.exp2(
        torch.randint(-100, 100, (100000,), generator=g).float())
    # normal values whose remainder is normal too (below 2^-100 lo can fall
    # under float32's subnormal step, and hi + lo keeps fewer bits)
    x = x[x.abs() > 2.0 ** -100]
    hi, lo = fl.split_tf32(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # both pieces are TF32 values
    assert torch.equal(fl.tf32_round(hi), hi) and torch.equal(fl.tf32_round(lo), lo)


def _draw(m, k, n, seed):
    """x ~ N(0, 1) and a Glorot-uniform weight with full float32 mantissas."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g)
    w = (torch.rand(n, k, generator=g) * 2 - 1) * (6.0 / (k + n)) ** 0.5
    return x, w


def _rel(y, ref) -> float:
    return float((y.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("m,k,n", [(64, 1536, 96), (16, 6144, 64)])
def test_plain_matches_float64_and_the_bar_has_teeth(m, k, n):
    x, w = _draw(m, k, n, seed=m + n)
    ref = x.double() @ w.double().T
    assert _rel(fl.f32x3_linear_plain(x, w), ref) < BAR
    one_tf32 = fl.tf32_round(x) @ fl.tf32_round(w).T
    assert _rel(one_tf32, ref) > BAR

    def bf16_pieces(a):
        a0 = a.bfloat16().float()
        return a0, (a - a0).bfloat16().float()
    x0, x1 = bf16_pieces(x)
    w0, w1 = bf16_pieces(w)
    three_bf16 = x0 @ w0.T + x0 @ w1.T + x1 @ w0.T
    assert _rel(three_bf16, ref) > BAR


def test_zero_weights_give_the_bias_exactly():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 5, 48, generator=g) * 7.0
    lin = fl.F32x3Linear(48, 40)
    with torch.no_grad():
        lin.weight.zero_()
        lin.bias.copy_(torch.randn(40, generator=g) * 3.0)
        y = lin(x)
    assert torch.equal(y, lin.bias.expand(3, 5, 40))
    assert torch.equal(fl.f32x3_linear_plain(x, torch.zeros(40, 48), lin.bias),
                       y)


def test_module_grads_are_the_float32_linear_grads():
    x, w = _draw(6, 32, 24, seed=3)
    lin = fl.F32x3Linear(32, 24)
    ref = torch.nn.Linear(32, 24)
    ref.load_state_dict(lin.state_dict())
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    g = torch.randn(6, 24, generator=torch.Generator().manual_seed(4))
    (lin(xa) * g).sum().backward()
    (ref(xb) * g).sum().backward()
    for a, b in [(xa.grad, xb.grad), (lin.weight.grad, ref.weight.grad),
                 (lin.bias.grad, ref.bias.grad)]:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_module_refuses_other_dtypes():
    lin = fl.F32x3Linear(8, 8)
    with pytest.raises(TypeError, match="float32"):
        lin(torch.zeros(2, 8, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):
        fl.tf32_round(torch.zeros(2, dtype=torch.bfloat16))


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w = _draw(4, 16, 8, seed=5)
    with pytest.raises(ValueError, match="not the card"):
        fl.f32x3_gemm(x, fl.pack_weight(w))


def test_pack_is_hi_over_lo_and_rebuilt_when_the_weight_changes():
    lin = fl.F32x3Linear(16, 8)
    pack = lin.pack()
    hi, lo = fl.split_tf32(lin.weight.detach())
    assert torch.equal(pack, torch.cat([hi, lo]))
    assert lin.pack() is pack
    with torch.no_grad():
        lin.weight.mul_(0.5)
    assert lin.pack() is not pack
    assert torch.equal(lin.pack()[:8], fl.tf32_round(lin.weight.detach()))


# (M, N) of the tedexp-mmdit cell (batch 16: the context stream's 1648
# rows, the sample stream's 544, the modulation's 16) and the widths the
# card timed fastest there on an H100 SXM's 132 SMs
# (tools/f32x3_gemm_compare.py, PERF.md)
FASTEST = {(1648, 1536): 160, (1648, 6144): 160, (544, 1536): 64,
           (544, 6144): 128, (16, 9216): 128, (16, 3072): 64,
           (544, 4608): 192, (1648, 4608): 160}


@pytest.mark.parametrize("m,n", sorted(FASTEST))
def test_tile_width_rule_picks_the_timed_fastest(m, n):
    assert fl.tile_n(m, n, 132) == FASTEST[(m, n)]


def _tiny(dtype=None, blocks=3):
    return mmdit.MMDiT(d_x=12, d_memory=64, d_model=64, heads=4,
                       n_layers=blocks, d_out=12, dtype=dtype)


def _op_names(blocks):
    """The Linears the split-TF32 op must take: every block Linear (the
    last block has no to_add_out and no context MLP),
    ``context_embedder`` and ``norm_out.linear``."""
    names = ["context_embedder", "norm_out.linear"]
    for i in range(blocks):
        b = f"transformer_blocks.{i}."
        last = i == blocks - 1
        names += [b + "norm1.linear", b + "norm1_context.linear",
                  b + "attn.to_out.0", b + "ff.net.0.proj", b + "ff.net.2"]
        names += [b + "attn." + p for p in ("to_q", "to_k", "to_v", "add_q_proj",
                                            "add_k_proj", "add_v_proj")]
        if not last:
            names += [b + "attn.to_add_out", b + "ff_context.net.0.proj",
                      b + "ff_context.net.2"]
    return names


def test_mmdit_sends_exactly_its_block_linears_through_the_op(monkeypatch):
    blocks = 3
    model = _tiny(blocks=blocks).eval()
    calls = []
    plain = fl.f32x3_linear_plain

    def counted(x, weight, bias=None):
        calls.append(weight)
        return plain(x, weight, bias)
    monkeypatch.setattr(fl, "f32x3_linear_plain", counted)
    op = {n for n, m in model.named_modules() if isinstance(m, fl.F32x3Linear)}
    want = _op_names(blocks)
    assert op == set(want) and len(want) == 14 * (blocks - 1) + 11 + 2
    for name in ("pos_embed.proj", "proj_out"):
        m = model.get_submodule(name)
        assert type(m) is Linear, name
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        model(torch.randn(2, 9, 12, generator=g), torch.randn(2, 7, 64, generator=g))
    assert len(calls) == len(want)
    weights = {id(model.get_submodule(n).weight) for n in want}
    assert {id(w) for w in calls} == weights


def test_bf16_mmdit_keeps_the_compute_dtype_linear():
    model = _tiny(torch.bfloat16, blocks=2)
    assert not any(isinstance(m, fl.F32x3Linear) for m in model.modules())
    assert isinstance(model.transformer_blocks[0].attn.to_q, Linear)


def test_group_is_its_linears_side_by_side():
    g = torch.Generator().manual_seed(9)
    lins = [fl.F32x3Linear(32, n) for n in (24, 8, 40)]
    group = fl.F32x3Group(*lins)
    x = torch.randn(2, 5, 32, generator=g)
    with torch.no_grad():
        assert torch.equal(group(x), torch.cat([lin(x) for lin in lins], dim=-1))
    pack, bias = group.packs.of(group.linears)
    hi = torch.cat([lin.pack()[:lin.out_features] for lin in lins])
    lo = torch.cat([lin.pack()[lin.out_features:] for lin in lins])
    assert torch.equal(pack, torch.cat([hi, lo]))
    assert torch.equal(bias, torch.cat([lin.bias.detach() for lin in lins]))
    assert group.packs.of(group.linears)[0] is pack
    with torch.no_grad():
        lins[1].bias.add_(1.0)
    assert group.packs.of(group.linears)[0] is not pack
    with pytest.raises(ValueError, match="in_features"):
        fl.F32x3Group(fl.F32x3Linear(32, 8), fl.F32x3Linear(16, 8))


def test_update_variables_drops_the_packs():
    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.generation import Generator
    from gesture_diffusion_torch.models import (DenoiserConfig, GestureDenoiser,
                                                init_random_)

    model = GestureDenoiser(DenoiserConfig(
        d_pose=12, d_model=64, heads=4, n_layers=2, decoder_type="mmdit"))
    init_random_(model, torch.Generator().manual_seed(7))
    sched, tmap = make_diffusion("linear", 1000, "ddim5")
    gen = Generator(model, sched, tmap, device="cpu")
    ops = [m for m in gen.model.modules() if isinstance(m, fl.F32x3Linear)]
    assert len(ops) == 14 + 11 + 2
    groups = [g for b in gen.model.pose_decoder.transformer_blocks
              for g in (b.attn.qkv, b.attn.add_qkv)]
    for m in ops:
        m.pack()
    for g in groups:
        g.packs.of(g.linears)
    sd = {k: v.clone() for k, v in gen.model.state_dict().items()}
    gen.update_variables(sd)
    assert all(m.packs.pack is None for m in ops + groups)


def test_plain_on_the_mmdit_shapes_rounds_like_float32():
    """A block's float32 Linear on the plain route against F.linear: the
    split's error is float32's, at the context stream's K and N."""
    x, w = _draw(8, 1536, 256, seed=8)
    ref = x.double() @ w.double().T
    assert _rel(fl.f32x3_linear_plain(x, w), ref) < 3 * max(
        _rel(F.linear(x, w), ref), 2.0 ** -24)
