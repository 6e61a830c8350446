"""The port's CUDA kernel on the card, held against its plain version.

Imports neither JAX nor the JAX package, so it runs where only PyTorch and
the CUDA toolkit are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX).  Without a card every
test skips.
"""

import pytest
import torch

from gesture_diffusion_torch.diffusion import make_diffusion
from gesture_diffusion_torch.generation import Generator
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser, init_random_
from gesture_diffusion_torch.ops import fused_sampler as fs

torch.set_num_threads(1)

D_POSE, T, N_LAYERS = 12, 8, 2
# bf16 operands on both sides, f32 sums in another order: rounding flips
# cascade to the bf16 level (PERF.md, tools/fused_ddim_precision.py)
BAR = 5e-3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = GestureDenoiser(DenoiserConfig(d_pose=D_POSE, n_layers=N_LAYERS))
    init_random_(model, torch.Generator().manual_seed(0))
    return model.cuda().eval()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _inputs(n, t, n_mem, blend, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.zeros(n, t, 128, device="cuda")
    x[..., :D_POSE] = torch.randn(n, t, D_POSE, generator=g, device="cuda")
    mem = torch.randn(n, n_mem, 256, generator=g, device="cuda")
    a = b = None
    if blend:
        a = torch.zeros_like(x)
        a[:, :3, :D_POSE] = 0.5 * torch.randn(n, 3, D_POSE, generator=g, device="cuda")
        b = torch.ones_like(x)
        b[:, :3, :D_POSE] = 0.575
    return x, mem, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,n_mem,blend", [
    (1, T, 16, False), (3, T, 16, True), (5, 40, 32, True), (2, 34, 47, False)])
def test_kernel_matches_plain(card, n, t, n_mem, blend):
    p = fs.pack_oneway_denoiser(card, D_POSE, t)
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    x, mem, a, b = _inputs(n, t, n_mem, blend, seed=n + t)
    args = (p, x, mem, tmap.cuda(), fs.ddim_coefficients(sched).cuda(), a, b,
            N_LAYERS, 8, sched.num_timesteps)
    before = fs.launches
    k = fs.fused_ddim_sample(*args)
    torch.cuda.synchronize()
    assert fs.launches == before + 1
    ref = fs.fused_ddim_sample_plain(*args)
    assert torch.isfinite(k).all()
    assert _rel(k, ref) < BAR


@pytest.mark.cuda
def test_generator_runs_fused_on_card(card):
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    gen = Generator(card, sched, tmap)
    wav = torch.randn(2, 16000, generator=torch.Generator().manual_seed(1)) * 0.3
    before = fs.launches
    out = gen.generate_sample(wav, D_POSE, T,
                              generator=torch.Generator(device="cuda").manual_seed(2))
    assert gen.last_sample_path == "fused" and fs.launches == before + 1
    assert out.shape == (2, T, D_POSE) and out.is_cuda


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(card):
    p = fs.pack_oneway_denoiser(card, D_POSE, T)
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    x, mem, _, _ = _inputs(1, T, 92, False, seed=3)   # 92 memory rows
    with pytest.raises(ValueError, match="at most"):
        fs.fused_ddim_sample(p, x, mem, tmap.cuda(),
                             fs.ddim_coefficients(sched).cuda(), None, None,
                             N_LAYERS, 8, sched.num_timesteps)
    f32 = fs.pack_oneway_denoiser(card, D_POSE, T, weight_dtype=torch.float32)
    with pytest.raises(ValueError):
        fs.fused_ddim_sample(f32, x, mem[:, :16], tmap.cuda(),
                             fs.ddim_coefficients(sched).cuda(), None, None,
                             N_LAYERS, 8, sched.num_timesteps,
                             compute_dtype=torch.float32)
