"""The split-TF32 GEMM (``gesture_diffusion_torch/csrc/f32x3_gemm.cu``) on the
card: against float64 and cuBLAS's float32 at the float32 MMDiT's shapes,
against its plain version, on ragged rows, through the MMDiT and the
Generator, and its refusals.

Imports neither JAX nor the JAX package, so it runs where only PyTorch and
the CUDA toolkit are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_f32x3_cuda.py -q

Without a card every test skips.
"""

import pytest
import torch
import torch.nn.functional as F

from gesture_diffusion_torch.diffusion import make_diffusion
from gesture_diffusion_torch.diffusion.sampling import ddim_sample_loop
from gesture_diffusion_torch.generation import Generator
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser, init_random_
from gesture_diffusion_torch.ops import f32_linear as fl

# float32's own accuracy at these shapes: cuBLAS's float32 reads 1.8e-7 to
# 4.2e-6 of max|ref| against float64, the kernel 3.8e-7 to 8.6e-7 (PERF.md)
BAR = 1.5e-6
# (M, K, N) of the tedexp-mmdit cell at batch 16: the context stream's
# 1648 rows (q/k/v/out, the MLP), the sample stream's 544, the modulation
# linears' 16 and the final ones (16, 1536, 3072)
SHAPES = [(1648, 1536, 1536), (1648, 1536, 6144), (1648, 6144, 1536),
          (544, 1536, 1536), (544, 1536, 6144), (544, 6144, 1536),
          (16, 1536, 9216), (16, 1536, 3072)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _draw(m, k, n, seed=0):
    """x ~ N(0, 1), a Glorot-uniform weight with full float32 mantissas and
    a small bias."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=g)
    w = (torch.rand(n, k, device="cuda", generator=g) * 2 - 1) * (6.0 / (k + n)) ** 0.5
    b = 0.1 * torch.randn(n, device="cuda", generator=g)
    return x, w, b


def _rel(y, ref) -> float:
    return float((y.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_matches_float64_as_float32_does(card, m, k, n):
    x, w, b = _draw(m, k, n)
    ref = x.double() @ w.double().T + b.double()
    got = _rel(fl.f32x3_gemm(x, fl.pack_weight(w), b), ref)
    cublas = _rel(F.linear(x, w, b), ref)
    assert got < BAR and got < 3 * cublas, (got, cublas)
    # the plain version on the card sums its three products in float32 on
    # cuBLAS, whose own distance from float64 is cuBLAS's (up to 4.2e-6):
    # the two differ by both roundings
    plain = fl.f32x3_linear_plain(x, w, b)
    own = _rel(plain, ref)
    assert _rel(fl.f32x3_gemm(x, fl.pack_weight(w), b), plain.double()) < BAR + own


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 544, 1648])
@pytest.mark.parametrize("bn", fl.TILE_N)
def test_ragged_rows_at_every_tile_width(card, m, bn):
    x, w, b = _draw(m, 1536, 1536 + bn + 8, seed=m)   # a ragged last column tile too
    ref = x.double() @ w.double().T + b.double()
    y = fl.f32x3_gemm(x, fl.pack_weight(w), b, bn=bn)
    assert _rel(y, ref) < BAR
    assert torch.equal(fl.f32x3_gemm(x, fl.pack_weight(w), None, bn=bn) + b, y)


@pytest.mark.cuda
def test_zero_weights_give_the_bias_exactly(card):
    x, _, b = _draw(544, 1536, 1536, seed=1)
    y = fl.f32x3_gemm(x * 100.0, fl.pack_weight(torch.zeros(1536, 1536, device="cuda")), b)
    assert torch.equal(y, b.expand(544, 1536))


def _mmdit(blocks=3):
    model = GestureDenoiser(DenoiserConfig(
        d_pose=12, d_model=64, heads=4, n_layers=blocks, decoder_type="mmdit"))
    init_random_(model, torch.Generator().manual_seed(3))
    return model.eval()


@pytest.mark.cuda
def test_launches_are_the_mmdit_linears_times_steps(card):
    blocks, steps = 3, 2
    model = _mmdit(blocks).cuda()
    ops = [m for m in model.modules() if isinstance(m, fl.F32x3Linear)]
    assert len(ops) == 14 * (blocks - 1) + 11 + 2
    g = torch.Generator(device="cuda").manual_seed(4)
    memory = torch.randn(2, 1 + 103, 64, device="cuda", generator=g)
    x_T = torch.randn(2, 34, 12, device="cuda", generator=g)
    sched, tmap = make_diffusion("linear", 1000, f"ddim{steps}")
    fl.launches = 0
    with torch.no_grad():
        got = ddim_sample_loop(sched.to("cuda"), lambda x, t: model.denoise(x, t, memory),
                               x_T, timestep_map=tmap.cuda())
    # every Linear launches once a step, but a stream's q, k and v together
    assert fl.launches == (len(ops) - 4 * blocks) * steps
    cpu = model.cpu()
    with torch.no_grad():
        want = ddim_sample_loop(sched, lambda x, t: cpu.denoise(x, t, memory.cpu()),
                                x_T.cpu(), timestep_map=tmap)
    assert _rel(got.cpu(), want.double()) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 544, 1648])
def test_group_is_bit_equal_to_its_linears(card, m):
    """q, k and v in one launch (4608 columns, another tile width) give what
    three launches give, bit for bit."""
    lins = [fl.F32x3Linear(1536, 1536).cuda() for _ in range(3)]
    x = torch.randn(m, 1536, device="cuda", generator=torch.Generator(device="cuda").manual_seed(m))
    with torch.no_grad():
        assert torch.equal(fl.F32x3Group(*lins)(x), torch.cat([lin(x) for lin in lins], -1))


@pytest.mark.cuda
def test_update_variables_drops_the_packs_on_the_card(card):
    model = _mmdit(2)
    sched, tmap = make_diffusion("linear", 1000, "ddim2")
    gen = Generator(model, sched, tmap, device="cuda")
    ops = [m for m in gen.model.modules() if isinstance(m, fl.F32x3Linear)]
    g = torch.Generator(device="cuda").manual_seed(5)
    with torch.no_grad():
        gen.model.denoise(torch.randn(2, 34, 12, device="cuda", generator=g),
                          torch.tensor([3, 4], device="cuda"),
                          torch.randn(2, 104, 64, device="cuda", generator=g))
    groups = [g for b in gen.model.pose_decoder.transformer_blocks
              for g in (b.attn.qkv, b.attn.add_qkv)]
    grouped = {id(lin) for g in groups for lin in g.linears}
    assert all(m.packs.pack is not None and m.packs.pack.is_cuda for m in ops
               if id(m) not in grouped)
    assert all(g.packs.pack is not None and g.packs.pack.is_cuda for g in groups)
    gen.update_variables({k: v.clone() for k, v in gen.model.state_dict().items()})
    assert all(m.packs.pack is None for m in ops + groups)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take(card):
    x, w, b = _draw(32, 64, 48)
    pack = fl.pack_weight(w)
    with pytest.raises(ValueError, match="not the card"):
        fl.f32x3_gemm(x.cpu(), pack, b)
    with pytest.raises(ValueError, match="not the card"):
        fl.f32x3_gemm(x, pack, b.cpu())
    with pytest.raises(TypeError, match="float32"):
        fl.f32x3_gemm(x.double(), pack, b)
    with pytest.raises(TypeError, match="float32"):
        fl.f32x3_gemm(x, pack.bfloat16(), b)
    with pytest.raises(ValueError, match="not contiguous"):
        fl.f32x3_gemm(x.T, fl.pack_weight(torch.zeros(48, 32, device="cuda")), b)
    with pytest.raises(ValueError, match=r"\(\.\.\., K\) and \(2N, K\)"):
        fl.f32x3_gemm(x[:, :60].contiguous(), pack, b)
    with pytest.raises(ValueError, match=r"\(\.\.\., K\) and \(2N, K\)"):
        fl.f32x3_gemm(x, pack[None], b)
    with pytest.raises(ValueError, match="bias"):
        fl.f32x3_gemm(x, pack, b[:47])
    with pytest.raises(ValueError, match="multiple of 4"):
        fl.f32x3_gemm(x[:, :62].contiguous(), pack[:, :62].contiguous(), b)
    with pytest.raises(RuntimeError, match="launch failed"):
        fl.f32x3_gemm(x, pack, b, bn=96)        # a width the library lacks


@pytest.mark.cuda
def test_leading_axes_are_rows(card):
    x, w, b = _draw(32, 64, 48, seed=6)
    pack = fl.pack_weight(w)
    assert torch.equal(fl.f32x3_gemm(x.view(2, 16, 64), pack, b),
                       fl.f32x3_gemm(x, pack, b).view(2, 16, 48))


@pytest.mark.cuda
def test_launches_on_every_card(card):
    """The kernel's shared-memory attribute is set per card: a launch on a
    second card after the first matches its float64 product there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second NVIDIA GPU")
    for dev in (0, 1, 0):
        with torch.cuda.device(dev):
            x, w, b = _draw(544, 1536, 1536, seed=dev)
        assert x.get_device() == dev
        for bn in fl.TILE_N:
            y = fl.f32x3_gemm(x, fl.pack_weight(w), b, bn=bn)
            assert _rel(y, x.double() @ w.double().T + b.double()) < BAR
