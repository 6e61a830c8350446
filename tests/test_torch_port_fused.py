"""Port vs JAX: the fused sampler's packing and its plain version against
the JAX Pallas kernel (interpret mode, float32), plus the wrapper's
contract.  The CUDA kernel itself is held against the plain version on
the card by tests/test_torch_port_cuda.py and chip_smoke.py."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gesture_diffusion_tpu.ops.fused_sampler as jfs
from gesture_diffusion_tpu.diffusion import make_diffusion as jax_make
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
    return model, jp, tp


def test_pack_matches_jax_field_by_field(packs):
    _, jp, tp = packs
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


def _inputs(n, seed, blend):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, T, DP), np.float32)
    x[..., :D_POSE] = rng.normal(size=(n, T, D_POSE))
    mem = rng.normal(size=(n, 16, DM)).astype(np.float32)
    mem[:, 0] = 0.0
    a = b = None
    if blend is not None:
        seeds = rng.normal(size=(n, T, D_POSE)).astype(np.float32)
        mask = np.zeros((n, T, 1), np.float32)
        mask[:, :3] = 1.0
        # as Generator builds them: ramp tf (or 0 = hard seed copy)
        tf = np.float32(0.0) if blend == "hard" else np.linspace(
            0.5, 1.0, T, dtype=np.float32)[None, :, None]
        a = np.zeros((n, T, DP), np.float32)
        b = np.ones((n, T, DP), np.float32)
        a[..., :D_POSE] = (1.0 - tf) * mask * seeds
        b[..., :D_POSE] = tf * mask + (1.0 - mask)
    return x, mem, a, b


@pytest.mark.parametrize("n,blend", [(1, None), (3, "ramp"), (8, "hard"),
                                     (3, None)])
def test_plain_matches_jax_kernel(packs, n, blend):
    _, jp, tp = packs
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
    tp = packs[2]
    with pytest.raises(NotImplementedError, match="stochastic"):
        _call(tp, stochastic=True)
    with pytest.raises(NotImplementedError, match="x_add"):
        _call(tp, x_add=torch.zeros(1, T, DP))
    with pytest.raises(ValueError, match="num_steps"):
        _call(tp, num_steps=11)


def test_plain_version_counts_no_launch(packs):
    before = fs.launches
    _call(packs[2], num_steps=10)
    assert fs.launches == before


def test_kernel_plan_limits(packs):
    tp = fs.pack_oneway_denoiser(packs[0], D_POSE, 64)
    # the flagship window/memory fits the shared-memory budget
    nbytes, fc = fs.smem_plan(40, 32, 256, 128, 1024)
    assert nbytes <= fs.SMEM_LIMIT and 1024 % fc == 0
    ok = fs._kernel_plan(tp, torch.zeros(1, 40, DP), torch.zeros(1, 32, DM), 8)
    assert ok == fc
    with pytest.raises(ValueError, match="at most"):
        fs._kernel_plan(tp, torch.zeros(1, 40, DP), torch.zeros(1, 92, DM), 8)


class _StubLibrary:
    """Records what the CUDA wrapper hands the C launcher."""

    def __init__(self):
        self.calls = []

    def fused_ddim_launch(self, ptrs, n_ptrs, dims, n_dims, stream):
        self.calls.append((list(ptrs)[:n_ptrs], list(dims)[:n_dims]))
        return 0


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
    assert len(ptrs) == 32 and ptrs[0] == x.data_ptr() and ptrs[1] == out.data_ptr()
    assert ptrs[5] == a.data_ptr() and ptrs[6] == b.data_ptr()
    assert dims == [3, T, 16, DM, DP, 4 * DM, N_LAYERS, 8, 10, 4 * DM]
    with pytest.raises(ValueError, match="bfloat16 operands"):
        fs._fused_ddim_cuda(p, x, mem, tmap, torch.zeros(10, 4), a, b,
                            N_LAYERS, 8, 10, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fs._fused_ddim_cuda(p, x.transpose(1, 2).contiguous().transpose(1, 2),
                            mem, tmap, torch.zeros(10, 4), a, b, N_LAYERS, 8,
                            10, torch.bfloat16)
    f32 = fs.pack_oneway_denoiser(packs[0], D_POSE, T, weight_dtype=torch.float32)
    with pytest.raises(ValueError, match="packed.w_embx"):
        fs._fused_ddim_cuda(f32, x, mem, tmap, torch.zeros(10, 4), a, b,
                            N_LAYERS, 8, 10, torch.bfloat16)
