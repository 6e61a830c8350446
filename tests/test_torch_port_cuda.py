"""The port's CUDA kernel on the card, held against its plain version.

Imports neither JAX nor the JAX package, so it runs where only PyTorch and
the CUDA toolkit are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX).  Without a card every
test skips.
"""

import numpy as np
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
# the float32 instantiation (split TF32, f32 sums) against the plain
# version in float32 with TF32 off: found near 1e-6 at ddim50 (PERF.md)
F32_BAR = 1e-4


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


def _inputs(n, t, n_mem, blend, seed, x_add=False):
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
    if not x_add:
        return x, mem, a, b
    xa = torch.zeros_like(x)
    xa[..., :D_POSE] = 0.3 * torch.randn(n, t, D_POSE, generator=g, device="cuda")
    return x, mem, a, b, xa


# (compute dtype, pack weight dtype, bar): the bf16 instantiation and the
# float32 one on either pack
COMPUTE = {"bf16": (torch.bfloat16, torch.bfloat16, BAR),
           "f32": (torch.float32, torch.bfloat16, F32_BAR),
           "f32w": (torch.float32, torch.float32, F32_BAR)}


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,n_mem,blend", [
    (1, T, 16, False), (3, T, 16, True), (5, 40, 32, True), (2, 34, 47, False),
    (2, 40, 92, False), (2, 10, 13, True), (1, 64, 128, True), (1, 49, 2, False)])
@pytest.mark.parametrize("compute", sorted(COMPUTE))
def test_kernel_matches_plain(card, compute, n, t, n_mem, blend):
    """Windows of 8 to 64 frames and memories of 2 to 128 rows, in each
    instantiation; the float32 one also at every forced cluster size (its
    attention operands in shared memory or in the global scratch, as the
    plan for that size and window places them)."""
    compute_dtype, weights, bar = COMPUTE[compute]
    p = fs.pack_oneway_denoiser(card, D_POSE, t, weight_dtype=weights)
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    x, mem, a, b = _inputs(n, t, n_mem, blend, seed=n + t)
    args = (p, x, mem, tmap.cuda(), fs.ddim_coefficients(sched).cuda(), a, b,
            N_LAYERS, 8, sched.num_timesteps, compute_dtype)
    key = (compute_dtype, weights)
    before = fs.launches, fs.launches_by_dtype.get(key, 0)
    k = fs.fused_ddim_sample(*args)
    torch.cuda.synchronize()
    assert (fs.launches, fs.launches_by_dtype[key]) == (before[0] + 1, before[1] + 1)
    ref = fs.fused_ddim_sample_plain(*args)
    assert torch.isfinite(k).all()
    assert _rel(k, ref) < bar
    _at_every_cluster(args, {}, ref, bar)


def _at_every_cluster(args, kw, ref, bar):
    """The float32 instantiation at every forced cluster size within bar
    of the plain version's ``ref``."""
    if args[10] != torch.float32:
        return
    for c in fs.CLUSTER_SIZES:
        kc = fs._fused_ddim_cuda(*args, **kw, cluster=c)
        torch.cuda.synchronize()
        assert fs.last_cluster == c
        assert torch.isfinite(kc).all() and _rel(kc, ref) < bar, (
            c, fs.last_plan, _rel(kc, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,n_mem,blend,x_add,stochastic", [
    (2, T, 16, True, True, False),        # x_add with the blend
    (3, T, 16, False, False, True),       # DDPM, identity update
    (2, T, 16, True, False, True),        # DDPM, blend update
    (2, 40, 92, True, True, True),        # all of them at a 92-row memory
    (1, 64, 128, False, True, True)])     # the longest window and memory
@pytest.mark.parametrize("compute", sorted(COMPUTE))
def test_new_variants_match_plain(card, compute, n, t, n_mem, blend, x_add,
                                  stochastic):
    compute_dtype, weights, bar = COMPUTE[compute]
    p = fs.pack_oneway_denoiser(card, D_POSE, t, weight_dtype=weights)
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    x, mem, a, b, xa = _inputs(n, t, n_mem, blend, seed=n + t, x_add=True)
    coefs = (fs.ddpm_coefficients(sched) if stochastic
             else fs.ddim_coefficients(sched)).cuda()
    args = (p, x, mem, tmap.cuda(), coefs, a, b, N_LAYERS, 8,
            sched.num_timesteps, compute_dtype)
    kw = dict(stochastic=stochastic, seed=torch.tensor([77], device="cuda"),
              x_add=xa if x_add else None)
    key = (compute_dtype, weights)
    before = fs.launches, fs.launches_by_dtype.get(key, 0)
    k = fs.fused_ddim_sample(*args, **kw)
    torch.cuda.synchronize()
    assert (fs.launches, fs.launches_by_dtype[key]) == (before[0] + 1, before[1] + 1)
    ref = fs.fused_ddim_sample_plain(*args, **kw)
    assert torch.isfinite(k).all()
    assert _rel(k, ref) < bar
    _at_every_cluster(args, kw, ref, bar)
    if stochastic:
        other = fs.fused_ddim_sample(*args, **{**kw, "seed": 78})
        assert _rel(other, ref) > BAR            # the seed is felt


# the four variants of the TPU kernel at the flagship window (3 row tiles):
# (memory rows, x0 blend, DDPM, x_add)
VARIANTS = {"ddim": (32, True, False, False), "long": (92, False, False, False),
            "stochastic": (32, False, True, False), "x_add": (92, True, True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("n", [1, 3])
def test_cluster_kernel_matches_plain(card, cluster, variant, n):
    """Every variant at every cluster size, forced, against the plain
    version."""
    n_mem, blend, stochastic, x_add = VARIANTS[variant]
    p = fs.pack_oneway_denoiser(card, D_POSE, 40)
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    x, mem, a, b, xa = _inputs(n, 40, n_mem, blend, seed=7 * n + cluster,
                               x_add=True)
    coefs = (fs.ddpm_coefficients(sched) if stochastic
             else fs.ddim_coefficients(sched)).cuda()
    args = dict(packed=p, x_T=x, mem_rows=mem, tmap=tmap.cuda(), coefs=coefs,
                blend_a=a, blend_b=b, n_layers=N_LAYERS, heads=8,
                num_steps=sched.num_timesteps, compute_dtype=torch.bfloat16,
                stochastic=stochastic, seed=torch.tensor([91], device="cuda"),
                x_add=xa if x_add else None)
    before = fs.launches
    k = fs._fused_ddim_cuda(**args, cluster=cluster)
    torch.cuda.synchronize()
    assert fs.launches == before + 1 and fs.last_cluster == cluster
    ref = fs.fused_ddim_sample_plain(**args)
    assert torch.isfinite(k).all()
    assert _rel(k, ref) < BAR


@pytest.mark.cuda
@pytest.mark.parametrize("compute,weights", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
def test_cluster_noise_is_bit_equal_across_sizes(card, compute, weights):
    """One step with coefficients (0, 0, 0, 0, 1) returns z: the same bits
    whatever the cluster size and the instantiation, and fused_noise's on
    the card."""
    p = fs.pack_oneway_denoiser(card, D_POSE, 40, weight_dtype=weights)
    x, mem, _, _ = _inputs(3, 40, 16, False, seed=6)
    seed = (7 << 32) | 99
    zs = {c: fs._fused_ddim_cuda(
        p, x, mem, torch.tensor([0], device="cuda"),
        torch.tensor([[0.0, 0.0, 0.0, 0.0, 1.0]], device="cuda"), None, None,
        N_LAYERS, 8, 1, compute, True, seed, cluster=c) for c in (1, 2, 4, 8)}
    ref = fs.fused_noise(seed, 0, 3, 40, 128, device="cuda")
    for c, z in zs.items():
        assert torch.equal(z, zs[1]), c
        assert torch.equal(z, ref), c


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True])
def test_cluster_plan_matches_the_library(card, f32):
    """The Python plan is the library's, for each instantiation at the
    shared memory of its plan for each cluster size; so are the plan's
    bytes and the float32 attention placement."""
    lib = fs._library()

    def nbytes(c):
        return fs.smem_plan(40, 256, 128, 1024, f32, c)[0]

    for n in (1, 3, 16, 17, 33, 34, 64, 66, 67, 128, 200):
        want = lib.fused_ddim_cluster_size(n, 8, 40, 256, 128, 1024, int(f32))
        assert fs.cluster_plan(n, 8, lambda c: fs.max_clusters(
            lib, c, nbytes(c), "cuda:0", f32)) == want, n
    assert fs.cluster_plan(1, 8, lambda c: fs.max_clusters(
        lib, c, nbytes(c), "cuda:0", f32)) == 8
    for t in (8, 40, 64):
        for c in fs.CLUSTER_SIZES:
            b, fc, half = fs.smem_plan(t, 256, 128, 1024, f32, c)
            assert lib.fused_ddim_smem_bytes(t, 256, 128, fc, int(half),
                                             int(f32), c) == b
            assert lib.fused_ddim_attention_shared(t, 256, 128, fc, int(half),
                                                   c) == fs.attention_shared(
                t, 256, 128, fc, half, c)


@pytest.mark.cuda
def test_kernel_noise_is_the_plain_noise(card):
    """One step with coefficients (0, 0, 0, 0, 1) returns z itself."""
    p = fs.pack_oneway_denoiser(card, D_POSE, 40)
    x, mem, _, _ = _inputs(3, 40, 16, False, seed=5)
    coefs = torch.tensor([[0.0, 0.0, 0.0, 0.0, 1.0]], device="cuda")
    seed = (9 << 32) | 4242
    z = fs.fused_ddim_sample(p, x, mem, torch.tensor([0], device="cuda"), coefs,
                             None, None, N_LAYERS, 8, 1, stochastic=True,
                             seed=seed)
    ref = fs.fused_noise(seed, 0, 3, 40, 128, device="cuda")
    # the card's logf/cosf against torch.log/torch.cos: last bits only
    assert float((z - ref).abs().max()) < 1e-5
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("base", [0, 2, 5])
def test_clip_base_draws_the_batch_noise(card, base):
    """A launch over clips [base, base + 2) with ``clip_base`` draws the z
    of those clips of a 7-clip batch, bit for bit at every cluster size,
    and its DDPM sample is its plain version's with the same clip_base."""
    p = fs.pack_oneway_denoiser(card, D_POSE, 40)
    x, mem, _, _ = _inputs(2, 40, 16, False, seed=8)
    seed = (3 << 32) | 17
    one = torch.tensor([[0.0, 0.0, 0.0, 0.0, 1.0]], device="cuda")
    whole = fs._fused_ddim_cuda(
        p, torch.zeros(7, 40, 128, device="cuda"), torch.zeros(7, 16, 256, device="cuda"),
        torch.tensor([0], device="cuda"), one, None, None, N_LAYERS, 8, 1,
        torch.bfloat16, True, seed, cluster=1)
    for c in (1, 2, 4, 8):
        z = fs._fused_ddim_cuda(p, x, mem, torch.tensor([0], device="cuda"), one,
                                None, None, N_LAYERS, 8, 1, torch.bfloat16, True,
                                seed, None, base, cluster=c)
        assert torch.equal(z, whole[base:base + 2]), c
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    args = (p, x, mem, tmap.cuda(), fs.ddpm_coefficients(sched).cuda(), None,
            None, N_LAYERS, 8, sched.num_timesteps)
    kw = dict(stochastic=True, seed=seed, clip_base=base)
    k = fs.fused_ddim_sample(*args, **kw)
    assert _rel(k, fs.fused_ddim_sample_plain(*args, **kw)) < BAR
    if base:
        assert not torch.equal(k, fs.fused_ddim_sample(*args, stochastic=True,
                                                       seed=seed))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_generator_over_two_shards_on_one_card(card, dtype):
    """A mesh whose two devices are the one card: two launches of 2 clips
    give the unsharded DDPM batch of 4 bit for bit (both plan clusters of
    8) at a fixed fused_dtype; a batch of 3 runs unsharded in one launch.
    With no fused_dtype the policy reads the shard's batch: float32 for 2
    clips a shard, bfloat16 for the whole batch of 4."""
    from gesture_diffusion_torch.parallel import make_mesh

    sched, tmap = make_diffusion("linear", 100, "ddim10")
    mesh = make_mesh(devices=["cuda:0"] * 2)
    sharded = Generator(card, sched, tmap, fused_dtype=dtype, mesh=mesh)
    whole = Generator(card, sched, tmap, fused_dtype=dtype)
    wav = torch.randn(4, 16000, generator=torch.Generator().manual_seed(7)) * 0.3
    noise = torch.zeros(4, T, D_POSE, device="cuda")
    assert Generator(card, sched, tmap, mesh=mesh).fused_args(
        wav.cuda(), D_POSE, T, noise)["compute_dtype"] == torch.float32
    assert Generator(card, sched, tmap).fused_args(
        wav.cuda(), D_POSE, T, noise)["compute_dtype"] == torch.bfloat16
    outs = []
    for gen in (sharded, whole):
        before = fs.launches
        outs.append(gen.generate_sample(
            wav, D_POSE, T, sample_alg="ddpm",
            generator=torch.Generator(device="cuda").manual_seed(8)))
        outs.append(fs.launches - before)
    assert outs[1] == 2 and outs[3] == 1 and torch.equal(outs[0], outs[2])
    before = fs.launches
    three = sharded.generate_sample(wav[:3], D_POSE, T)
    assert fs.launches == before + 1 and three.shape == (3, T, D_POSE)


@pytest.mark.cuda
def test_inpaint_generator_runs_ddpm_fused_on_card(card):
    model = GestureDenoiser(DenoiserConfig(d_pose=D_POSE, n_layers=N_LAYERS,
                                           model_type="inpaint"))
    init_random_(model, torch.Generator().manual_seed(0))
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    gen = Generator(model, sched, tmap)
    wav = torch.randn(2, 16000, generator=torch.Generator().manual_seed(1)) * 0.3
    ip = torch.randn(2, T, D_POSE, generator=torch.Generator().manual_seed(2))
    im = torch.zeros(2, T, 1)
    im[:, :3] = 1.0
    outs = []
    for seed in (3, 3, 4):
        before = fs.launches
        outs.append(gen.generate_sample(
            wav, D_POSE, T, sample_alg="ddpm", inpaint_poses=ip, inpaint_masks=im,
            trans_factor=0.575, pose_seed_len=3,
            generator=torch.Generator(device="cuda").manual_seed(seed)))
        assert gen.last_sample_path == "fused" and fs.launches == before + 1
    assert outs[0].shape == (2, T, D_POSE) and outs[0].is_cuda
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1]) and not torch.allclose(outs[0], outs[2])
    with pytest.raises(ValueError, match="inpaint tensors"):
        gen.generate_sample(wav, D_POSE, T)


@pytest.mark.cuda
def test_stream_on_card_equals_offline(card):
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    gen = Generator(card, sched, tmap)
    wav = (torch.randn(2, 48000, generator=torch.Generator().manual_seed(6)) * 0.3).numpy()
    noises = [torch.randn(2, T, D_POSE, generator=torch.Generator().manual_seed(10 + d))
              for d in range(8)]
    kw = dict(noise_fn=lambda b0, d: noises[d], trans_factor=0.575)
    ref = gen.generate_sequence(wav, 16000, D_POSE, 8, T, 2, **kw)
    stream = gen.stream(16000, D_POSE, 8, T, 2, max_in_flight=2, **kw)
    chunks = []
    for i in range(0, wav.shape[1], 7000):
        chunks.extend(stream.push(wav[:, i:i + 7000]))
    chunks.extend(stream.flush())
    assert np.array_equal(np.concatenate(chunks, axis=1), ref)


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
    """129 memory rows are refused; float32 compute on f32 weights launches
    the float32 instantiation (held against its plain version); bf16
    compute on f32 weights, which the JAX package never builds, is
    refused."""
    p = fs.pack_oneway_denoiser(card, D_POSE, T)
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    x, mem, _, _ = _inputs(1, T, 129, False, seed=3)   # 129 memory rows
    with pytest.raises(ValueError, match="at most"):
        fs.fused_ddim_sample(p, x, mem, tmap.cuda(),
                             fs.ddim_coefficients(sched).cuda(), None, None,
                             N_LAYERS, 8, sched.num_timesteps)
    f32 = fs.pack_oneway_denoiser(card, D_POSE, T, weight_dtype=torch.float32)
    args = (f32, x, mem[:, :16].contiguous(), tmap.cuda(),
            fs.ddim_coefficients(sched).cuda(), None, None, N_LAYERS, 8,
            sched.num_timesteps)
    before = fs.launches
    k = fs.fused_ddim_sample(*args, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fs.launches == before + 1
    ref = fs.fused_ddim_sample_plain(*args, compute_dtype=torch.float32)
    assert torch.isfinite(k).all() and _rel(k, ref) < F32_BAR
    with pytest.raises(ValueError, match="packed.w_embx"):
        fs.fused_ddim_sample(*args, compute_dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("n", [1, 3, 64])
@pytest.mark.parametrize("weights", [torch.bfloat16, torch.float32])
def test_f32_kernel_matches_plain(card, weights, n, variant, cluster):
    """The float32 instantiation on a bf16 pack (the JAX default at one or
    two clips a device) and on an f32 pack (fused_dtype=float32): every
    variant at batches 1, 3 and 64, at the planned and at every forced
    cluster size (the float32 plan takes all four: the attention operands
    in the global scratch at C = 1, in shared memory above), against the
    plain version in float32."""
    n_mem, blend, stochastic, x_add = VARIANTS[variant]
    p = fs.pack_oneway_denoiser(card, D_POSE, 40, weight_dtype=weights)
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    x, mem, a, b, xa = _inputs(n, 40, n_mem, blend, seed=11 * n + (cluster or 0),
                               x_add=True)
    coefs = (fs.ddpm_coefficients(sched) if stochastic
             else fs.ddim_coefficients(sched)).cuda()
    args = dict(packed=p, x_T=x, mem_rows=mem, tmap=tmap.cuda(), coefs=coefs,
                blend_a=a, blend_b=b, n_layers=N_LAYERS, heads=8,
                num_steps=sched.num_timesteps, compute_dtype=torch.float32,
                stochastic=stochastic, seed=torch.tensor([93], device="cuda"),
                x_add=xa if x_add else None)
    before = dict(fs.launches_by_dtype)
    k = (fs.fused_ddim_sample(**args) if cluster is None
         else fs._fused_ddim_cuda(**args, cluster=cluster))
    torch.cuda.synchronize()
    key = (torch.float32, weights)
    assert fs.launches_by_dtype[key] == before.get(key, 0) + 1
    assert cluster is None or fs.last_cluster == cluster
    assert fs.last_plan["attention"] == (
        "the global scratch" if fs.last_cluster == 1 else "shared memory")
    ref = fs.fused_ddim_sample_plain(**args)
    assert torch.isfinite(k).all()
    assert _rel(k, ref) < F32_BAR
    if weights == torch.bfloat16:
        # the bf16 instantiation on the same pack is off by bf16 rounding
        bf = fs.fused_ddim_sample(**{**args, "compute_dtype": torch.bfloat16})
        assert _rel(bf, ref) > 10 * _rel(k, ref)


# Every block of the float32 instantiation normalises all of h's rows
# itself: (window, memory rows, batch, x0 blend, DDPM, x_add, emb_x bias
# shift).  Windows 34 (pad rows in the last row tile), 40 and 64 (four
# whole tiles); the shift gives the residual stream a row mean far above
# its spread, which a one-pass variance E[x^2] - E[x]^2 loses to
# cancellation: with one the kernel read 1.4e-3 to 2.1e-3 here at shift
# 300, but 9.5e-6 to 1.7e-5 at 30, under F32_BAR; the kernel's two passes
# read 9.4e-6 to 1.3e-5 at 300.
LN_CASES = {"ddim-t40-m32": (40, 32, 1, True, False, False, 0.0),
           "ddpm-t34-m92": (34, 92, 1, True, True, False, 0.0),
           "ddpm-xadd-t64-m92": (64, 92, 3, True, True, True, 0.0),
           "ddim-xadd-t34-m32": (34, 32, 2, False, False, True, 0.0),
           "ddim-mean300-t40-m32": (40, 32, 1, True, False, False, 300.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LN_CASES))
@pytest.mark.parametrize("weights", [torch.bfloat16, torch.float32])
def test_f32_local_layer_norm_matches_plain(card, weights, case):
    """The float32 instantiation at ddim50 on either pack, at every forced
    cluster size (the attention operands in the global scratch at C = 1,
    in shared memory above), within F32_BAR of the plain version; and the
    noise of one DDPM step, z, bit-equal across the sizes."""
    t, n_mem, n, blend, stochastic, x_add, shift = LN_CASES[case]
    p = fs.pack_oneway_denoiser(card, D_POSE, t, weight_dtype=weights)
    if shift:
        p = p._replace(b_embx=p.b_embx + shift)
    sched, tmap = make_diffusion("linear", 1000, "ddim50")
    x, mem, a, b, xa = _inputs(n, t, n_mem, blend, seed=13 * t + n_mem,
                               x_add=True)
    coefs = (fs.ddpm_coefficients(sched) if stochastic
             else fs.ddim_coefficients(sched)).cuda()
    args = dict(packed=p, x_T=x, mem_rows=mem, tmap=tmap.cuda(), coefs=coefs,
                blend_a=a, blend_b=b, n_layers=N_LAYERS, heads=8,
                num_steps=sched.num_timesteps, compute_dtype=torch.float32,
                stochastic=stochastic, seed=torch.tensor([95], device="cuda"),
                x_add=xa if x_add else None)
    ref = fs.fused_ddim_sample_plain(**args)
    assert torch.isfinite(ref).all()
    for c in fs.CLUSTER_SIZES:
        k = fs._fused_ddim_cuda(**args, cluster=c)
        torch.cuda.synchronize()
        assert fs.last_cluster == c
        assert torch.isfinite(k).all() and _rel(k, ref) < F32_BAR, (
            c, fs.last_plan, _rel(k, ref))
    if stochastic:
        one = dict(args, tmap=torch.tensor([0], device="cuda"), num_steps=1,
                   coefs=torch.tensor([[0.0, 0.0, 0.0, 0.0, 1.0]], device="cuda"),
                   blend_a=None, blend_b=None)
        zs = [fs._fused_ddim_cuda(**one, cluster=c) for c in fs.CLUSTER_SIZES]
        assert all(torch.equal(z, zs[0]) for z in zs)
        ref_z = fs.fused_noise(95, 0, n, t, 128, device="cuda")
        assert float((zs[0] - ref_z).abs().max()) < 1e-5


def _train_case(model_type, dtype):
    """A small model, its batch, t and noise, all drawn on the CPU."""
    from gesture_diffusion_torch.training import make_adamw

    g = torch.Generator().manual_seed(3)
    cfg = DenoiserConfig(d_pose=D_POSE, d_model=64, heads=4, n_layers=1,
                         model_type=model_type, pose_seed_len=3)
    model = init_random_(GestureDenoiser(cfg), torch.Generator().manual_seed(1))
    batch = {"wav": 0.3 * torch.randn(4, 8000, generator=g),
             "pose": 0.5 * torch.randn(4, T, D_POSE, generator=g, dtype=dtype)}
    t = torch.randint(0, 100, (4,), generator=g)
    noise = torch.randn(4, T, D_POSE, generator=g, dtype=dtype)
    return model.to(dtype), batch, t, noise, make_adamw


TRUNK = "speech_encoder.wav_encoder.feat_extractor."


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["s2g_v2", "inpaint"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_train_step_on_card_matches_cpu(card, monkeypatch, model_type, dtype):
    """One train step on the card against the same step on the CPU (TF32
    off, set by the fixture), both reading the CPU's mel (the front-end's
    float32 FFTs differ between cuFFT and the CPU, and the trunk's
    train-mode gradient amplifies an input difference).  The loss, the norm
    and the BN statistics to 1e-4; every gradient to 1e-3 of its tensor's
    max|g| (floored at 1e-2 of the largest: the key projections' dconv
    biases have a gradient of 0 in exact arithmetic), in float32 outside
    the SE-ResNet trunk only: its float32 train-mode gradients are
    ill-conditioned on random weights."""
    import copy

    from gesture_diffusion_torch.models import speech_encoder
    from gesture_diffusion_torch.training import make_train_step

    model, batch, t, noise, make_adamw = _train_case(model_type, dtype)
    mel = speech_encoder.speech_frontend(batch["wav"])
    monkeypatch.setattr(speech_encoder, "speech_frontend",
                        lambda wav: mel.to(wav.device))
    sched, _ = make_diffusion("linear", 100, "")
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        step = make_train_step(m, sched.to(dev), make_adamw(m.parameters(), 1e-3, 0.1),
                               lambda s: 1e-3, grad_norm_clip_value=1.0)
        metrics = step({k: v.to(dev) for k, v in batch.items()}, 0, t=t.to(dev),
                       noise=noise.to(dev))
        out[dev] = (metrics, {k: p.grad.cpu() for k, p in m.named_parameters()},
                    {k: v.cpu() for k, v in m.state_dict().items()})
    (mc, gc, sc), (mg, gg, sg) = out["cpu"], out["cuda"]
    for k in ("loss", "denoise", "grad_norm"):
        assert float(mg[k]) == pytest.approx(float(mc[k]), rel=1e-4), k
    for k, v in sc.items():
        if "running_" in k:
            assert _rel(sg[k], v) < 1e-4, k
    top = max(float(v.abs().max()) for v in gc.values())
    worst = {k: float((gg[k] - v).abs().max()) / max(float(v.abs().max()), 1e-2 * top)
             for k, v in gc.items()}
    held = {k: r for k, r in worst.items()
            if dtype == torch.float64 or not k.startswith(TRUNK)}
    print(model_type, dtype, "worst held", max(held.items(), key=lambda kv: kv[1]),
          "worst of all", max(worst.values()))
    for k, r in held.items():
        assert r < 1e-3, (k, r)


@pytest.mark.cuda
def test_train_step_dropout_on_card_follows_seed_and_step(card):
    """At p > 0 the card's dropout masks are a function of (seed, step),
    and the step leaves the global CUDA generator as it found it."""
    import copy

    from gesture_diffusion_torch.training import make_train_step

    model, batch, t, noise, make_adamw = _train_case("s2g_v2", torch.float32)
    dropped = GestureDenoiser(DenoiserConfig(**{**model.cfg.__dict__, "dropout": 0.2}))
    dropped.load_state_dict(model.state_dict())
    sched, _ = make_diffusion("linear", 100, "")
    batch = {k: v.cuda() for k, v in batch.items()}
    state = torch.cuda.get_rng_state()
    losses = []
    for step_no in (4, 4, 5):
        m = copy.deepcopy(dropped).cuda()
        step = make_train_step(m, sched.to("cuda"), make_adamw(m.parameters(), 0.0, 0.0),
                               lambda s: 0.0, seed=1)
        losses.append(float(step(batch, step_no, t=t.cuda(), noise=noise.cuda())["loss"]))
    assert losses[0] == losses[1] != losses[2]
    assert torch.equal(torch.cuda.get_rng_state(), state)


_TP_RANK = r"""
import sys
rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from gesture_diffusion_torch.diffusion import make_diffusion
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser, speech_encoder
from gesture_diffusion_torch.parallel import (apply_tensor_parallel, gather_full,
                                              init_distributed, make_mesh)
from gesture_diffusion_torch.training import make_adamw, make_train_step
dev = torch.device("cuda", 0)
init_distributed(f"localhost:{port}", 2, rank, backend="gloo", device=dev)
inp = torch.load(f"{work}/inputs.pt", weights_only=True)
speech_encoder.speech_frontend = lambda w: inp["mel"].to(w.device)
model = GestureDenoiser(DenoiserConfig(**inp["cfg"])).to(dev)
model.load_state_dict(inp["state"])
apply_tensor_parallel(model, make_mesh(1, 2, [dev, dev]))
sched, _ = make_diffusion("linear", 100, "")
step = make_train_step(model, sched.to(dev), make_adamw(model.parameters(), 0.0, 0.0),
                       lambda s: 0.0)
m = step({k: v.to(dev) for k, v in inp["batch"].items()}, 0, t=inp["t"].to(dev),
         noise=inp["noise"].to(dev))
grads = gather_full(model, {k: p.grad for k, p in model.named_parameters()})
if rank == 0:
    torch.save({"loss": float(m["loss"]),
                "grads": {k: v.cpu() for k, v in grads.items()}}, f"{work}/out.pt")
print("DONE", rank, flush=True)
"""


@pytest.mark.cuda
def test_tensor_parallel_step_on_card(card, tmp_path, monkeypatch):
    """One step of two model ranks over gloo sharing the card against the
    one-process step on the card (TF32 off, one mel): the loss to 1e-5,
    every gradient outside the SE-ResNet trunk to 1e-5 of max|g|."""
    import os
    import socket
    import subprocess
    import sys

    from gesture_diffusion_torch.models import speech_encoder
    from gesture_diffusion_torch.training import make_train_step

    model, batch, t, noise, make_adamw = _train_case("s2g_v2", torch.float32)
    mel = speech_encoder.speech_frontend(batch["wav"])
    torch.save({"cfg": model.cfg.__dict__, "state": model.state_dict(), "batch": batch,
                "t": t, "noise": noise, "mel": mel}, tmp_path / "inputs.pt")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _TP_RANK, str(r), str(port),
                               str(tmp_path), repo], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0 and "DONE" in out, err[-3000:]
    tp = torch.load(tmp_path / "out.pt", weights_only=True)
    monkeypatch.setattr(speech_encoder, "speech_frontend", lambda w: mel.to(w.device))
    ref = model.cuda()
    sched, _ = make_diffusion("linear", 100, "")
    step = make_train_step(ref, sched.to("cuda"), make_adamw(ref.parameters(), 0.0, 0.0),
                           lambda s: 0.0)
    m = step({k: v.cuda() for k, v in batch.items()}, 0, t=t.cuda(), noise=noise.cuda())
    assert tp["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    grads = {k: p.grad.cpu() for k, p in ref.named_parameters()}
    top = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        if not k.startswith(TRUNK):
            assert float((tp["grads"][k] - g).abs().max()) <= 1e-5 * top, k


@pytest.mark.cuda
def test_bf16_model_on_card_matches_cpu(card):
    """``dtype="bfloat16"`` (``Train.dtype``): the card's forward against
    float64 no worse than twice the CPU's bf16 forward, and the fused
    kernel serving the model's float32 weights against its plain version."""
    import copy

    model, batch, t, _, _ = _train_case("s2g_v2", torch.float32)
    bf16 = GestureDenoiser(DenoiserConfig(**{**model.cfg.__dict__, "dtype": "bfloat16"}))
    bf16.load_state_dict(model.state_dict())
    x = batch["pose"]
    with torch.no_grad():
        ref = copy.deepcopy(model).double().eval()(x.double(), t, batch["wav"])
        cpu = copy.deepcopy(bf16).eval()(x, t, batch["wav"])
        gpu = copy.deepcopy(bf16).cuda().eval()(x.cuda(), t.cuda(), batch["wav"].cuda())
    assert gpu.dtype == torch.bfloat16
    assert _rel(gpu.cpu().double(), ref) <= 2 * _rel(cpu.double(), ref)
    sched, tmap = make_diffusion("linear", 1000, "ddim50")
    gen = Generator(bf16.cuda(), sched, tmap, device="cuda")
    wav = batch["wav"][:2].cuda()
    noise = torch.randn(2, T, D_POSE, device="cuda")
    with torch.no_grad():
        args = gen.fused_args(wav, D_POSE, T, noise)
        k = fs.fused_ddim_sample(**args)
        p = fs.fused_ddim_sample_plain(**args)
    assert _rel(k[..., :D_POSE], p[..., :D_POSE]) < BAR
