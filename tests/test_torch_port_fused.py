"""Port vs JAX: the fused sampler's packing and its plain version against
the JAX Pallas kernel (interpret mode, float32) for the DDIM variants,
``x_add`` and long or unaligned memories and windows; the stochastic
variant against the JAX scan DDPM sampler with its noise injected (the
JAX kernel's own noise has no CPU lowering); the port's Philox noise; and
the wrapper's contract.  The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_port_cuda.py and chip_smoke.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gesture_diffusion_tpu.ops.fused_sampler as jfs
from gesture_diffusion_tpu.diffusion import ddpm_sample_loop as jax_ddpm
from gesture_diffusion_tpu.diffusion import make_diffusion as jax_make
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_torch.diffusion import make_diffusion
from gesture_diffusion_torch.ops import fused_sampler as fs
from torch_port_common import DM, D_POSE, T, jax_variables, port_model, rel_err

torch.set_num_threads(1)

N_LAYERS = 2
DP = 128


@pytest.fixture(scope="module")
def packs():
    cfg, variables = jax_variables("s2g_v2", n_layers=N_LAYERS, seed=11)
    model = port_model(cfg, variables)
    jp = jfs.pack_oneway_denoiser(variables["params"], D_POSE, T,
                                  weight_dtype=jnp.float32)
    tp = fs.pack_oneway_denoiser(model, D_POSE, T, weight_dtype=torch.float32)
    return model, jp, tp, cfg, variables


def test_pack_matches_jax_field_by_field(packs):
    _, jp, tp = packs[:3]
    assert tp._fields == jp._fields
    for name in jp._fields:
        a, b = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        assert a.shape == b.shape and b.dtype == np.float32, name
        # LN folding is one float32 matmul on each side: 1e-6
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)


def test_bf16_pack_dtypes(packs):
    model = packs[0]
    p = fs.pack_oneway_denoiser(model, D_POSE, T)
    for name, w in p._asdict().items():
        want = torch.float32 if name in ("pe_x", "pe_m0", "b_out") else torch.bfloat16
        assert w.dtype == want and w.is_contiguous(), name


def test_ddim_coefficients_match():
    sj, _ = jax_make("linear", 100, "ddim10")
    sp, _ = make_diffusion("linear", 100, "ddim10")
    np.testing.assert_array_equal(fs.ddim_coefficients(sp).numpy(),
                                  jfs.ddim_coefficients(sj))


def test_ddpm_coefficients_match():
    sj, _ = jax_make("linear", 100, "ddim10")
    sp, _ = make_diffusion("linear", 100, "ddim10")
    ours = fs.ddpm_coefficients(sp).numpy()
    np.testing.assert_array_equal(ours, jfs.ddpm_coefficients(sj))
    assert ours.shape == (10, 5) and ours[0, 4] == 0.0 and (ours[1:, 4] > 0).all()


def _inputs(n, seed, blend, t=T, n_mem=16):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, t, DP), np.float32)
    x[..., :D_POSE] = rng.normal(size=(n, t, D_POSE))
    mem = rng.normal(size=(n, n_mem, DM)).astype(np.float32)
    mem[:, 0] = 0.0
    a = b = None
    if blend is not None:
        seeds = rng.normal(size=(n, t, D_POSE)).astype(np.float32)
        mask = np.zeros((n, t, 1), np.float32)
        mask[:, :3] = 1.0
        # as Generator builds them: ramp tf (or 0 = hard seed copy)
        tf = np.float32(0.0) if blend == "hard" else np.linspace(
            0.5, 1.0, t, dtype=np.float32)[None, :, None]
        a = np.zeros((n, t, DP), np.float32)
        b = np.ones((n, t, DP), np.float32)
        a[..., :D_POSE] = (1.0 - tf) * mask * seeds
        b[..., :D_POSE] = tf * mask + (1.0 - mask)
    return x, mem, a, b


@pytest.mark.parametrize("n,blend", [(1, None), (3, "ramp"), (8, "hard"),
                                     (3, None)])
def test_plain_matches_jax_kernel(packs, n, blend):
    _, jp, tp = packs[:3]
    sj, tj = jax_make("linear", 100, "ddim10")
    sp, tmap = make_diffusion("linear", 100, "ddim10")
    x, mem, a, b = _inputs(n, 20 + n, blend)
    S = sj.num_timesteps
    ref = np.asarray(jfs.fused_ddim_sample(
        jp, jnp.asarray(x), jnp.asarray(mem),
        jnp.asarray(np.asarray(tj)[:, None].astype(np.int32)),
        jnp.asarray(jfs.ddim_coefficients(sj)),
        None if a is None else jnp.asarray(a),
        None if b is None else jnp.asarray(b),
        n_layers=N_LAYERS, heads=8, num_steps=S,
        compute_dtype=jnp.float32, interpret=True))
    ours = fs.fused_ddim_sample(
        tp, torch.from_numpy(x), torch.from_numpy(mem), tmap,
        fs.ddim_coefficients(sp),
        None if a is None else torch.from_numpy(a),
        None if b is None else torch.from_numpy(b),
        n_layers=N_LAYERS, heads=8, num_steps=S,
        compute_dtype=torch.float32).numpy()
    # float32 both sides, 10 DDIM steps of reassociated sums: 2e-5
    assert rel_err(ours, ref) < 2e-5
    if blend == "hard":
        # mask 1, tf 0: the seed frames are copied exactly
        np.testing.assert_allclose(ours[:, :3, :D_POSE], a[:, :3, :D_POSE],
                                   atol=1e-4)


def _call(tp, n=1, **kw):
    _, tmap = make_diffusion("linear", 100, "ddim10")
    args = dict(n_layers=N_LAYERS, heads=8, num_steps=10)
    args.update(kw)
    x = torch.zeros(n, T, DP)
    mem = torch.zeros(n, 16, DM)
    coefs = torch.zeros(10, 4)
    return fs.fused_ddim_sample(tp, x, mem, tmap, coefs, None, None, **args)


def test_wrapper_refuses_unported_flags(packs):
    """Both flags are ported; what the wrapper still refuses is a call
    whose tables or tensors do not fit them."""
    tp = packs[2]
    with pytest.raises(ValueError, match="5-column"):
        _call(tp, stochastic=True)                    # 4-column coefs
    with pytest.raises(ValueError, match="x_add shape"):
        _call(tp, x_add=torch.zeros(1, T + 1, DP))
    with pytest.raises(ValueError, match="num_steps"):
        _call(tp, num_steps=11)
    ok = _call(tp, x_add=torch.zeros(1, T, DP))
    assert ok.shape == (1, T, DP)


def test_plain_version_counts_no_launch(packs):
    before = fs.launches
    _call(packs[2], num_steps=10)
    assert fs.launches == before


def test_kernel_plan_limits(packs):
    tp = fs.pack_oneway_denoiser(packs[0], D_POSE, 64)
    # the flagship window fits with the whole FF hidden in one chunk and
    # full-strip staging; the memory length does not enter the plan
    nbytes, fc, half = fs.smem_plan(40, 256, 128, 1024)
    assert nbytes <= fs.SMEM_LIMIT and fc == 1024 and not half
    for n_mem in (32, 92, 128):
        ok = fs._kernel_plan(tp, torch.zeros(1, 40, DP),
                             torch.zeros(1, n_mem, DM), 8)
        assert ok == (fc, half)
    # the longest window fits with half-strip staging
    nbytes, fc, half = fs.smem_plan(64, 256, 128, 1024)
    assert nbytes <= fs.SMEM_LIMIT and half and 1024 % fc == 0
    # each block of a cluster holds the whole layout: the plan of one block
    # per clip stands, byte for byte (214.5 KB at the flagship)
    assert fs.smem_plan(40, 256, 128, 1024) == (214528, 1024, False)
    assert fs._kernel_plan(tp, torch.zeros(1, 64, DP),
                           torch.zeros(1, 128, DM), 8) == (fc, half)
    with pytest.raises(ValueError, match="at most"):
        fs._kernel_plan(tp, torch.zeros(1, 40, DP), torch.zeros(1, 129, DM), 8)
    with pytest.raises(ValueError, match="at most"):
        fs._kernel_plan(tp, torch.zeros(1, 65, DP), torch.zeros(1, 32, DM), 8)
    # heads are whole 16-wide tensor-core tiles: 256 / 32 = 8 is refused
    with pytest.raises(ValueError, match="multiple of 16"):
        fs._kernel_plan(tp, torch.zeros(1, 40, DP), torch.zeros(1, 32, DM), 32)
    # one clip's K/V scratch: L x [K | V] x D x n_mem rounded up to 16
    assert fs.scratch_elems(92, 256, 4) == 4 * 2 * 256 * 96
    assert fs.scratch_elems(13, 256, 2) == 2 * 2 * 256 * 16


# -- the stochastic variant's noise ------------------------------------------

def _np_philox(ctr, key):
    """Philox4x32-10 in numpy uint64 arithmetic, written from the Random123
    description independently of the package's tensor version."""
    c = [np.uint64(v) for v in ctr]
    k = [np.uint64(v) for v in key]
    m32 = np.uint64(0xFFFFFFFF)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [((p1 >> np.uint64(32)) ^ c[1] ^ k[0]) & m32, p1 & m32,
             ((p0 >> np.uint64(32)) ^ c[3] ^ k[1]) & m32, p0 & m32]
        k = [(k[0] + np.uint64(0x9E3779B9)) & m32,
             (k[1] + np.uint64(0xBB67AE85)) & m32]
    return [int(v) for v in c]


def test_philox_known_answers():
    # Random123's known-answer vectors for philox4x32-10
    assert _np_philox((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert _np_philox((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert [int(w) for w in fs.philox4x32_10(0, 0, 0, 0, 0, 0)] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    rng = np.random.default_rng(60)
    for _ in range(20):
        ctr = [int(v) for v in rng.integers(0, 2 ** 32, 4)]
        key = [int(v) for v in rng.integers(0, 2 ** 32, 2)]
        assert [int(w) for w in fs.philox4x32_10(*ctr, *key)] == _np_philox(ctr, key)


def test_fused_noise_layout_matches_its_definition():
    """z[clip, r, n] of step s = Box-Muller of words (0, 1) or (2, 3) of
    Philox(counter ((r // 2) * Dp + n, s, clip, 0), key = seed words)."""
    seed, step, dp = (7 << 32) | 12345, 3, 128
    z = fs.fused_noise(seed, step, 2, 5, dp).numpy()
    for clip, r, n in [(0, 0, 0), (1, 4, 127), (1, 3, 17), (0, 2, 64)]:
        w = _np_philox(((r // 2) * dp + n, step, clip, 0), (12345, 7))
        a, b = w[2 * (r % 2)], w[2 * (r % 2) + 1]
        u1 = np.float32(a >> 9) * np.float32(2.0 ** -23)
        u2 = np.float32(b >> 9) * np.float32(2.0 ** -23)
        want = (np.sqrt(np.float32(-2.0) * np.log(np.maximum(u1, np.float32(1e-12))))
                * np.cos(np.float32(2.0 * np.pi) * u2))
        # numpy's and torch's float32 log/cos differ in the last bits: 1e-5
        np.testing.assert_allclose(z[clip, r, n], want, rtol=1e-5, atol=1e-6)


def test_fused_noise_moments_and_keys():
    z = fs.fused_noise(99, 0, 8, 100, 128).numpy().ravel()      # 102400 draws
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02
    assert abs(((z - z.mean()) ** 3).mean() / z.std() ** 3) < 0.05
    assert np.isfinite(z).all()
    base = fs.fused_noise(5, 2, 3, 8, 128)
    np.testing.assert_array_equal(base.numpy(), fs.fused_noise(5, 2, 3, 8, 128).numpy())
    np.testing.assert_array_equal(                  # a tensor seed is the same seed
        base.numpy(), fs.fused_noise(torch.tensor([5]), 2, 3, 8, 128).numpy())
    assert not np.allclose(base.numpy(), fs.fused_noise(6, 2, 3, 8, 128).numpy())
    assert not np.allclose(base.numpy(), fs.fused_noise(5, 3, 3, 8, 128).numpy())
    assert not np.allclose(base[0].numpy(), base[1].numpy())     # clips differ
    # the high word of the seed counts too
    assert not np.allclose(base.numpy(),
                           fs.fused_noise(5 + (1 << 32), 2, 3, 8, 128).numpy())


# -- the stochastic variant against the JAX scan DDPM sampler ------------------

@pytest.mark.parametrize("n,blend", [(1, None), (3, None), (1, "ramp"),
                                     (3, "ramp")])
def test_plain_stochastic_matches_jax_scan_ddpm(packs, n, blend):
    """The JAX kernel's stochastic branch cannot run on the CPU; its stated
    equal is the scan sampler, so the plain version runs with the scan
    sampler's own z (key splits in step order) injected."""
    model, _, tp, cfg, variables = packs
    sj, tj = jax_make("linear", 100, "ddim10")
    sp, tmap = make_diffusion("linear", 100, "ddim10")
    S = sj.num_timesteps
    rng = np.random.default_rng(70 + n)
    noise = rng.normal(size=(n, T, D_POSE)).astype(np.float32)
    speech = rng.normal(size=(n, 15, DM)).astype(np.float32)
    seeds = rng.normal(size=(n, T, D_POSE)).astype(np.float32)
    mask = np.zeros((n, T, 1), np.float32)
    mask[:, :3] = 1.0
    tf = np.linspace(0.5, 1.0, T, dtype=np.float32)[None, :, None]

    def jmodel(x, t):
        return JaxDenoiser(cfg).apply(variables, x, t, jnp.asarray(speech),
                                      method=JaxDenoiser.denoise)

    denoise_fn = None
    if blend:
        def denoise_fn(x0):
            return (1.0 - tf) * mask * seeds + tf * mask * x0 + (1.0 - mask) * x0

    key = jax.random.key(71)
    ref = np.asarray(jax_ddpm(sj, jmodel, jnp.asarray(noise), key,
                              denoise_fn=denoise_fn, timestep_map=tj))
    z = np.zeros((S, n, T, DP), np.float32)
    for i in range(S - 1, -1, -1):
        key, sub = jax.random.split(key)
        z[i, :, :, :D_POSE] = np.array(jax.random.normal(sub, noise.shape))

    with torch.no_grad():
        emm = model.pose_decoder.emb_mem
        pe = torch.from_numpy(fs.sinusoidal_position_encoding(5000, DM))
        rows = torch.from_numpy(speech) @ emm.weight.t() + emm.bias + pe[1:16]
    mem = torch.cat([torch.zeros(n, 1, DM), rows], dim=1)
    x = torch.zeros(n, T, DP)
    x[..., :D_POSE] = torch.from_numpy(noise)
    a = b = None
    if blend:
        a, b = torch.zeros(n, T, DP), torch.ones(n, T, DP)
        a[..., :D_POSE] = torch.from_numpy((1.0 - tf) * mask * seeds)
        b[..., :D_POSE] = torch.from_numpy(tf * mask + (1.0 - mask))
    ours = fs.fused_ddim_sample_plain(
        tp, x, mem, tmap, fs.ddpm_coefficients(sp), a, b, n_layers=N_LAYERS,
        heads=8, num_steps=S, compute_dtype=torch.float32, stochastic=True,
        z=torch.from_numpy(z))[..., :D_POSE].numpy()
    # float32 both sides, 10 ancestral steps; the module and the packed
    # weights (LN folded) sum in different orders: 5e-5 relative
    assert rel_err(ours, ref) < 5e-5
    # and with its own noise it is a function of the seed
    kw = dict(n_layers=N_LAYERS, heads=8, num_steps=S,
              compute_dtype=torch.float32, stochastic=True)
    args = (tp, x, mem, tmap, fs.ddpm_coefficients(sp), a, b)
    s1 = fs.fused_ddim_sample(*args, seed=1, **kw).numpy()
    np.testing.assert_array_equal(s1, fs.fused_ddim_sample(*args, seed=1, **kw).numpy())
    assert not np.allclose(s1, fs.fused_ddim_sample(*args, seed=2, **kw).numpy())


# -- x_add and long / unaligned shapes against the JAX kernel -----------------

def _jax_kernel(variables, x, mem, a, b, x_add=None):
    """The JAX Pallas kernel in interpret mode, float32, rows zero-padded
    to multiples of 8 with the real counts named, as its Generator calls
    it; returns the real rows."""
    n, t, _ = x.shape
    n_mem = mem.shape[1]
    tp_, mp_ = t + (-t) % 8, n_mem + (-n_mem) % 8
    sj, tj = jax_make("linear", 100, "ddim10")
    jp = jfs.pack_oneway_denoiser(variables["params"], D_POSE, tp_,
                                  weight_dtype=jnp.float32)

    def pad(v, rows, fill=0.0):
        if v is None:
            return None
        out = np.full((n, rows) + v.shape[2:], fill, np.float32)
        out[:, :v.shape[1]] = v
        return jnp.asarray(out)

    out = jfs.fused_ddim_sample(
        jp, pad(x, tp_), pad(mem, mp_),
        jnp.asarray(np.asarray(tj)[:, None].astype(np.int32)),
        jnp.asarray(jfs.ddim_coefficients(sj)), pad(a, tp_), pad(b, tp_, 1.0),
        n_layers=N_LAYERS, heads=8, num_steps=sj.num_timesteps,
        compute_dtype=jnp.float32, interpret=True, x_add=pad(x_add, tp_),
        t_real=t if tp_ != t else None,
        n_mem_real=n_mem if mp_ != n_mem else None)
    return np.asarray(out)[:, :t]


def _plain(model, x, mem, a, b, x_add=None):
    sp, tmap = make_diffusion("linear", 100, "ddim10")
    tp = fs.pack_oneway_denoiser(model, D_POSE, x.shape[1],
                                 weight_dtype=torch.float32)
    opt = [None if v is None else torch.from_numpy(v) for v in (a, b)]
    return fs.fused_ddim_sample(
        tp, torch.from_numpy(x), torch.from_numpy(mem), tmap,
        fs.ddim_coefficients(sp), *opt, n_layers=N_LAYERS, heads=8,
        num_steps=sp.num_timesteps, compute_dtype=torch.float32,
        x_add=None if x_add is None else torch.from_numpy(x_add)).numpy()


@pytest.mark.parametrize("n,blend", [(2, "ramp"), (3, None)])
def test_plain_x_add_matches_jax_kernel(n, blend):
    """x_add from a non-zero inpaint conditioning MLP, through both."""
    cfg, variables = jax_variables("inpaint", n_layers=N_LAYERS, seed=80)
    model = port_model(cfg, variables)
    x, mem, a, b = _inputs(n, 81 + n, blend)
    poses = np.random.default_rng(82).normal(size=(n, T, D_POSE)).astype(np.float32)
    mask = np.zeros((n, T, 1), np.float32)
    mask[:, :3] = 1.0
    with torch.no_grad():
        proj = model.inpaint_projection(torch.from_numpy(poses),
                                        torch.from_numpy(mask)).numpy()
    ref_proj = np.asarray(JaxDenoiser(cfg).apply(
        variables, jnp.asarray(poses), jnp.asarray(mask),
        method=JaxDenoiser.inpaint_projection))
    assert np.abs(ref_proj).max() > 0.05          # the MLP is off its zero init
    assert rel_err(proj, ref_proj) < 1e-5
    x_add = np.zeros((n, T, DP), np.float32)
    x_add[..., :D_POSE] = proj
    ours = _plain(model, x, mem, a, b, x_add)
    ref = _jax_kernel(variables, x, mem, a, b, x_add)
    # float32 both sides, 10 DDIM steps of reassociated sums: 2e-5
    assert rel_err(ours, ref) < 2e-5
    assert rel_err(_plain(model, x, mem, a, b), ref) > 1e-3     # x_add matters


@pytest.mark.parametrize("t,n_mem,blend", [(40, 92, None), (10, 13, "ramp"),
                                           (40, 13, "ramp"), (10, 92, None)])
def test_plain_long_and_unaligned_matches_jax_kernel(packs, t, n_mem, blend):
    """Memories of 92 rows (the default and inpaint types at 2 s windows)
    and row counts off the TPU's 8-row alignment: the JAX kernel pads and
    masks, the port takes the rows as they come."""
    model, variables = packs[0], packs[4]
    x, mem, a, b = _inputs(2, 90 + t + n_mem, blend, t=t, n_mem=n_mem)
    ours = _plain(model, x, mem, a, b)
    ref = _jax_kernel(variables, x, mem, a, b)
    # float32 both sides, 10 DDIM steps of reassociated sums: 2e-5
    assert rel_err(ours, ref) < 2e-5


class _StubLibrary:
    """Records what the CUDA wrapper hands the C launcher."""

    def __init__(self):
        self.calls = []
        self.blocks = []

    def fused_ddim_launch(self, ptrs, n_ptrs, dims, n_dims, stream):
        self.calls.append((list(ptrs)[:n_ptrs], list(dims)[:n_dims]))
        self.blocks.append(dims[0] * dims[12])    # n clusters of C blocks
        return 0

    def fused_ddim_max_clusters(self, c, smem, f32):
        assert 0 < smem <= fs.SMEM_LIMIT and f32 in (0, 1)
        return H100_CLUSTERS[c]


# clusters of C blocks of 214.5 KB of shared memory each that an H100 SXM
# runs at once, as cudaOccupancyMaxActiveClusters gave them on one: the
# GPCs hold fewer clusters of 8 than 132 / 8
H100_CLUSTERS = {8: 15, 4: 30, 2: 66, 1: 132}


@pytest.mark.parametrize("n,want", [(1, 8), (3, 8), (16, 4), (17, 4), (33, 2),
                                    (34, 2), (64, 2), (66, 2), (67, 1),
                                    (128, 1)])
def test_cluster_plan(n, want):
    """The largest cluster whose n clusters run in one wave."""
    assert fs.cluster_plan(n, 8, H100_CLUSTERS.__getitem__) == want
    # C must divide the heads: 4 heads never take clusters of 8, 2 heads
    # never 4, and 1 head runs one block per clip
    assert fs.cluster_plan(n, 4, H100_CLUSTERS.__getitem__) == (
        4 if n <= 30 else 2 if n <= 66 else 1)
    assert fs.cluster_plan(n, 2, H100_CLUSTERS.__getitem__) == (
        2 if n <= 66 else 1)
    assert fs.cluster_plan(n, 1, H100_CLUSTERS.__getitem__) == 1
    # a card that runs no cluster of 8 at once (a smaller part)
    small = {8: 0, 4: 8, 2: 16, 1: 33}
    assert fs.cluster_plan(n, 8, small.__getitem__) == (
        4 if n <= 8 else 2 if n <= 16 else 1)


def test_cuda_wrapper_marshalling(packs, monkeypatch):
    """The wrapper's checks, pointer list and dims, with the library
    stubbed (the launch itself needs the card)."""
    p = fs.pack_oneway_denoiser(packs[0], D_POSE, T)
    _, tmap = make_diffusion("linear", 100, "ddim10")
    x, mem, a, b = (torch.from_numpy(v) for v in _inputs(3, 50, "ramp"))
    stub = _StubLibrary()
    monkeypatch.setattr(fs, "_library", lambda: stub)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    before = fs.launches
    out = fs._fused_ddim_cuda(p, x, mem, tmap, torch.zeros(10, 4), a, b,
                              N_LAYERS, 8, 10, torch.bfloat16)
    assert fs.launches == before + 1 and out.shape == x.shape
    (ptrs, dims), = stub.calls
    assert len(ptrs) == fs.N_PTRS == 35
    assert ptrs[0] == x.data_ptr() and ptrs[1] == out.data_ptr()
    assert ptrs[5] == a.data_ptr() and ptrs[6] == b.data_ptr()
    assert ptrs[7] is None and ptrs[8] is not None and ptrs[9] is not None
    # 3 clips fit in one wave of clusters of 8: 24 blocks
    assert dims == [3, T, 16, DM, DP, 4 * DM, N_LAYERS, 8, 10, 4 * DM, 0, 0, 8, 0,
                    0, 0]
    assert stub.blocks[-1] == 24 and fs.last_cluster == 8
    # the kernel-side transposed weights are made once per pack
    kt = fs.kernel_weights(p)
    assert ptrs[10] == kt["w_embx"].data_ptr() and ptrs[33] == kt["w_out"].data_ptr()
    assert kt["self_wqkv"].shape == (N_LAYERS, 3 * DM, DM)
    assert fs.kernel_weights(p) is kt

    # stochastic, x_add, a 92-row memory, a seed kept as a tensor and the
    # clips of a shard that starts at clip 96
    x_add = 0.1 * x
    mem92 = torch.from_numpy(_inputs(3, 51, None, n_mem=92)[1])
    out = fs._fused_ddim_cuda(p, x, mem92, tmap, torch.zeros(10, 5), a, b,
                              N_LAYERS, 8, 10, torch.bfloat16, True,
                              torch.tensor([1234567890123]), x_add, 96)
    ptrs, dims = stub.calls[-1]
    assert ptrs[7] == x_add.data_ptr() and ptrs[10] == kt["w_embx"].data_ptr()
    assert dims == [3, T, 92, DM, DP, 4 * DM, N_LAYERS, 8, 10, 4 * DM, 0, 1, 8, 96,
                    0, 0]
    # the forced cluster size reaches the launch, n * C blocks of arguments
    for c in fs.CLUSTER_SIZES:
        fs._fused_ddim_cuda(p, x, mem92, tmap, torch.zeros(10, 5), a, b,
                            N_LAYERS, 8, 10, torch.bfloat16, True, 7, x_add,
                            cluster=c)
        assert stub.calls[-1][1][12] == c and stub.blocks[-1] == 3 * c
        assert stub.calls[-1][0][0] == x.data_ptr() and fs.last_cluster == c
    # float32 compute on this bf16 pack launches the float32 instantiation
    # (its dims and operands: test_torch_port_f32_kernel.py)
    fs._fused_ddim_cuda(p, x, mem, tmap, torch.zeros(10, 4), a, b,
                        N_LAYERS, 8, 10, torch.float32)
    assert stub.calls[-1][1][14:] == [1, 0]
    for bad in (3, 16, 0):
        with pytest.raises(ValueError, match="cluster must be one of"):
            fs._fused_ddim_cuda(p, x, mem, tmap, torch.zeros(10, 4), a, b,
                                N_LAYERS, 8, 10, torch.bfloat16, cluster=bad)
    # a cluster must own whole heads: 4 heads take no cluster of 8
    with pytest.raises(ValueError, match="divide"):
        fs._fused_ddim_cuda(p, x, mem, tmap, torch.zeros(10, 4), a, b,
                            N_LAYERS, 4, 10, torch.bfloat16, cluster=8)
    # the longest window asks for half-strip staging
    p64 = fs.pack_oneway_denoiser(packs[0], D_POSE, 64)
    x64, m128, _, _ = (None if v is None else torch.from_numpy(v)
                       for v in _inputs(1, 52, None, t=64, n_mem=128))
    fs._fused_ddim_cuda(p64, x64, m128, tmap, torch.zeros(10, 4), None, None,
                        N_LAYERS, 8, 10, torch.bfloat16)
    assert stub.calls[-1][1][:3] == [1, 64, 128] and stub.calls[-1][1][10] == 1
    assert stub.calls[-1][1][12] == 8
    # a refused launch raises; nothing retries with another cluster size
    stub.fused_ddim_launch = lambda *a: 801
    n_calls = len(stub.calls)
    with pytest.raises(RuntimeError, match=r"clusters of 8 blocks\): CUDA error 801"):
        fs._fused_ddim_cuda(p, x, mem, tmap, torch.zeros(10, 4), a, b,
                            N_LAYERS, 8, 10, torch.bfloat16)
    assert len(stub.calls) == n_calls

    # other compute dtypes than bfloat16 and float32 are refused
    with pytest.raises(ValueError, match="bfloat16 or float32 operands"):
        fs._fused_ddim_cuda(p, x, mem, tmap, torch.zeros(10, 4), a, b,
                            N_LAYERS, 8, 10, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        fs._fused_ddim_cuda(p, x.transpose(1, 2).contiguous().transpose(1, 2),
                            mem, tmap, torch.zeros(10, 4), a, b, N_LAYERS, 8,
                            10, torch.bfloat16)
    with pytest.raises(ValueError, match="x_add must be a contiguous float32"):
        fs._fused_ddim_cuda(p, x, mem, tmap, torch.zeros(10, 4), a, b,
                            N_LAYERS, 8, 10, torch.bfloat16, False, 0,
                            x_add.double())
    # bf16 compute on f32 weights: a combination the JAX package never builds
    f32 = fs.pack_oneway_denoiser(packs[0], D_POSE, T, weight_dtype=torch.float32)
    with pytest.raises(ValueError, match="packed.w_embx"):
        fs._fused_ddim_cuda(f32, x, mem, tmap, torch.zeros(10, 4), a, b,
                            N_LAYERS, 8, 10, torch.bfloat16)


def test_kernel_weights_live_and_die_with_the_pack(packs):
    import gc

    p = fs.pack_oneway_denoiser(packs[0], D_POSE, T)
    gc.collect()                # earlier tests' packs may wait in cycles
    n0 = len(fs._KERNEL_SIDE)
    kt = fs.kernel_weights(p)
    assert len(fs._KERNEL_SIDE) == n0 + 1
    np.testing.assert_array_equal(kt["ff_w2"].float().numpy(),
                                  p.ff_w2.transpose(-1, -2).float().numpy())
    assert kt["ff_w2"].is_contiguous()
    del p, kt
    gc.collect()
    assert len(fs._KERNEL_SIDE) == n0
