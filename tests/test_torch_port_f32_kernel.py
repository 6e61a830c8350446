"""Port vs JAX: the fused sampler's float32-compute variant and the
Generator's compute-dtype policy.

The JAX kernel computes in float32 on a bfloat16 pack whenever a device
holds one or two clips (the JAX Generator's default).  Here the port's
plain version, the CPU path of ``fused_ddim_sample``, runs that variant
against the JAX Pallas kernel in interpret mode on the same bf16 pack
(identity and x0 blends, ``x_add``, long and unaligned memories and
windows), and the stochastic variant against the JAX scan DDPM sampler
with its noise injected (the JAX kernel's noise has no CPU lowering) on
weights whose bf16 pack is exact.  The port's ``Generator()`` with no
``fused_dtype`` is held against JAX's at batches 1 and 2, and its choice
of compute dtype per launch is read from ``fused_args``; the CUDA
wrapper's marshalling of the float32 instantiation runs with the library
stubbed.  The kernel itself is held against the plain version on the card
by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gesture_diffusion_tpu.ops.fused_sampler as jfs
from gesture_diffusion_tpu.diffusion import ddpm_sample_loop as jax_ddpm
from gesture_diffusion_tpu.diffusion import make_diffusion as jax_make
from gesture_diffusion_tpu.generation import Generator as JaxGenerator
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_torch.diffusion import make_diffusion
from gesture_diffusion_torch.generation import Generator
from gesture_diffusion_torch.ops import fused_sampler as fs
from gesture_diffusion_torch.parallel import make_mesh
from torch_port_common import DM, D_POSE, T, jax_variables, port_model, rel_err

torch.set_num_threads(1)

N_LAYERS = 2
DP = 128
# float32 compute on both sides, 10 DDIM steps of reassociated sums: 2e-5
TOL = 2e-5


def _torch_pack(jp) -> fs.PackedDenoiser:
    """The JAX pack's values as a port pack of the same dtypes: both sides
    read the same bf16 weights, so the comparison is of the sampler alone
    (each package folds LayerNorm in float32 with its own summation order,
    and a last-bit difference can round a bf16 weight the other way)."""
    out = []
    for a in jp:
        a = np.asarray(a)
        t = torch.from_numpy(np.asarray(a, np.float32))
        out.append(t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t)
    return fs.PackedDenoiser(*out)


@pytest.fixture(scope="module")
def bf16_packs():
    cfg, variables = jax_variables("s2g_v2", n_layers=N_LAYERS, seed=11)
    model = port_model(cfg, variables)
    jp = jfs.pack_oneway_denoiser(variables["params"], D_POSE, T,
                                  weight_dtype=jnp.bfloat16)
    return model, jp, _torch_pack(jp), variables


def test_bf16_pack_is_the_port_pack(bf16_packs):
    """The port packs the JAX pack's bf16 weights to within a bf16 ulp
    (the folded biases may round apart), with the same dtypes."""
    model, jp, tp, _ = bf16_packs
    ours = fs.pack_oneway_denoiser(model, D_POSE, T)
    for name in jp._fields:
        a, b = getattr(tp, name), getattr(ours, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   rtol=2 ** -7, atol=1e-6, err_msg=name)


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
        tf = np.float32(0.0) if blend == "hard" else np.linspace(
            0.5, 1.0, t, dtype=np.float32)[None, :, None]
        a = np.zeros((n, t, DP), np.float32)
        b = np.ones((n, t, DP), np.float32)
        a[..., :D_POSE] = (1.0 - tf) * mask * seeds
        b[..., :D_POSE] = tf * mask + (1.0 - mask)
    return x, mem, a, b


def _jax_f32_kernel(jp_of, x, mem, a, b, x_add=None):
    """JAX's kernel, float32 compute on a bf16 pack, in interpret mode, rows
    zero-padded to multiples of 8 with the real counts named (as its
    Generator calls it); returns the real rows.  ``jp_of(t)`` gives the
    bf16 pack at window ``t``."""
    n, t, _ = x.shape
    n_mem = mem.shape[1]
    tp_, mp_ = t + (-t) % 8, n_mem + (-n_mem) % 8
    sj, tj = jax_make("linear", 100, "ddim10")

    def pad(v, rows, fill=0.0):
        if v is None:
            return None
        out = np.full((n, rows) + v.shape[2:], fill, np.float32)
        out[:, :v.shape[1]] = v
        return jnp.asarray(out)

    out = jfs.fused_ddim_sample(
        jp_of(tp_), pad(x, tp_), pad(mem, mp_),
        jnp.asarray(np.asarray(tj)[:, None].astype(np.int32)),
        jnp.asarray(jfs.ddim_coefficients(sj)), pad(a, tp_), pad(b, tp_, 1.0),
        n_layers=N_LAYERS, heads=8, num_steps=sj.num_timesteps,
        compute_dtype=jnp.float32, interpret=True, x_add=pad(x_add, tp_),
        t_real=t if tp_ != t else None,
        n_mem_real=n_mem if mp_ != n_mem else None)
    return np.asarray(out)[:, :t]


def _port_f32(tp, x, mem, a, b, x_add=None):
    sp, tmap = make_diffusion("linear", 100, "ddim10")
    opt = [None if v is None else torch.from_numpy(v) for v in (a, b)]
    return fs.fused_ddim_sample(
        tp, torch.from_numpy(x), torch.from_numpy(mem), tmap,
        fs.ddim_coefficients(sp), *opt, n_layers=N_LAYERS, heads=8,
        num_steps=sp.num_timesteps, compute_dtype=torch.float32,
        x_add=None if x_add is None else torch.from_numpy(x_add)).numpy()


def _pack_at(variables, t):
    return jfs.pack_oneway_denoiser(variables["params"], D_POSE, t,
                                    weight_dtype=jnp.bfloat16)


@pytest.mark.parametrize("n,blend", [(1, None), (2, "ramp"), (3, "hard")])
def test_f32_compute_on_bf16_pack_matches_jax_kernel(bf16_packs, n, blend):
    _, _, _, variables = bf16_packs
    x, mem, a, b = _inputs(n, 120 + n, blend)
    ref = _jax_f32_kernel(lambda t: _pack_at(variables, t), x, mem, a, b)
    ours = _port_f32(_torch_pack(_pack_at(variables, T)), x, mem, a, b)
    assert rel_err(ours, ref) < TOL
    # the bf16-compute variant is off by bf16 rounding: f32 compute counts
    bf = fs.fused_ddim_sample_plain(
        _torch_pack(_pack_at(variables, T)), torch.from_numpy(x),
        torch.from_numpy(mem), make_diffusion("linear", 100, "ddim10")[1],
        fs.ddim_coefficients(make_diffusion("linear", 100, "ddim10")[0]),
        *[None if v is None else torch.from_numpy(v) for v in (a, b)],
        N_LAYERS, 8, 10, compute_dtype=torch.bfloat16).numpy()
    assert rel_err(bf, ref) > 10 * TOL
    if blend == "hard":
        np.testing.assert_allclose(ours[:, :3, :D_POSE], a[:, :3, :D_POSE],
                                   atol=1e-4)


@pytest.mark.parametrize("t,n_mem,blend", [(40, 92, None), (10, 13, "ramp"),
                                           (40, 13, "ramp")])
def test_f32_compute_long_and_unaligned_match_jax_kernel(bf16_packs, t, n_mem,
                                                          blend):
    """Memories of 92 rows and row counts off the TPU's 8-row alignment."""
    _, _, _, variables = bf16_packs
    x, mem, a, b = _inputs(2, 130 + t + n_mem, blend, t=t, n_mem=n_mem)
    ref = _jax_f32_kernel(lambda tt: _pack_at(variables, tt), x, mem, a, b)
    ours = _port_f32(_torch_pack(_pack_at(variables, t)), x, mem, a, b)
    assert rel_err(ours, ref) < TOL


@pytest.mark.parametrize("n,blend", [(2, "ramp"), (3, None)])
def test_f32_compute_x_add_matches_jax_kernel(n, blend):
    """The inpaint type's x_add, from a non-zero conditioning MLP."""
    cfg, variables = jax_variables("inpaint", n_layers=N_LAYERS, seed=140)
    model = port_model(cfg, variables)
    x, mem, a, b = _inputs(n, 141 + n, blend)
    poses = np.random.default_rng(142).normal(size=(n, T, D_POSE)).astype(np.float32)
    mask = np.zeros((n, T, 1), np.float32)
    mask[:, :3] = 1.0
    with torch.no_grad():
        proj = model.inpaint_projection(torch.from_numpy(poses),
                                        torch.from_numpy(mask)).numpy()
    x_add = np.zeros((n, T, DP), np.float32)
    x_add[..., :D_POSE] = proj
    ref = _jax_f32_kernel(lambda t: _pack_at(variables, t), x, mem, a, b, x_add)
    ours = _port_f32(_torch_pack(_pack_at(variables, T)), x, mem, a, b, x_add)
    assert rel_err(ours, ref) < TOL
    assert rel_err(_port_f32(_torch_pack(_pack_at(variables, T)), x, mem, a, b),
                   ref) > 1e-3                                  # x_add matters


def _bf16_exact(variables):
    """The variables with every parameter rounded to a bf16 value and the
    decoder's LayerNorm affine at (1, 0): their bf16 pack then holds the
    module's weights exactly (LN folding multiplies by 1 and adds 0), so
    float32 compute on it is the module's float32 function."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif "decoder" in path and path[-1].startswith(("norm_", "out_norm")):
                out[k] = np.ones_like(v) if k == "scale" else np.zeros_like(v)
            else:
                out[k] = np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                                    .astype(jnp.float32))
        return out
    return {**variables, "params": walk(variables["params"], ())}


@pytest.mark.parametrize("n,blend", [(1, None), (2, "ramp")])
def test_f32_compute_stochastic_matches_jax_scan_ddpm(n, blend):
    """The stochastic variant: float32 compute on a bf16 pack whose values
    are the module's, against the JAX scan sampler (the JAX kernel's stated
    equal; its noise has no CPU lowering) with the scan's own z injected."""
    cfg, variables = jax_variables("s2g_v2", n_layers=N_LAYERS, seed=150)
    variables = _bf16_exact(variables)
    model = port_model(cfg, variables)
    tp = fs.pack_oneway_denoiser(model, D_POSE, T)
    f32 = fs.pack_oneway_denoiser(model, D_POSE, T, weight_dtype=torch.float32)
    for name in tp._fields:                  # the bf16 pack is exact
        assert torch.equal(getattr(tp, name).float(), getattr(f32, name).float()), name
    sj, tj = jax_make("linear", 100, "ddim10")
    sp, tmap = make_diffusion("linear", 100, "ddim10")
    S = sj.num_timesteps
    rng = np.random.default_rng(151 + n)
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

    key = jax.random.key(152)
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
    assert rel_err(ours, ref) < TOL


# -- the Generator's compute-dtype policy ----------------------------------

@pytest.fixture(scope="module")
def default_gens():
    wav = np.random.default_rng(160).normal(0, 0.3, (2, 16000)).astype(np.float32)
    cfg, variables = jax_variables("s2g_v2", n_layers=1, wav=wav, seed=161)
    sj, tj = jax_make("linear", 100, "ddim10")
    sp, tp = make_diffusion("linear", 100, "ddim10")
    jgen = JaxGenerator(JaxDenoiser(cfg), variables, sj, tj, use_fused=True)
    tgen = Generator(port_model(cfg, variables), sp, tp, device="cpu")
    return jgen, tgen, wav


@pytest.mark.parametrize("n,blend", [(1, False), (2, False), (2, True)])
def test_default_generator_matches_jax_default(default_gens, n, blend):
    """No fused_dtype on either side: bf16 weights, float32 compute at one
    or two clips."""
    jgen, tgen, wav = default_gens
    rng = np.random.default_rng(162 + n)
    noise = rng.normal(size=(n, T, D_POSE)).astype(np.float32)
    kw = {}
    if blend:
        mask = np.zeros((n, T, 1), np.float32)
        mask[:, :2] = 1.0
        kw = dict(inpaint_poses=rng.normal(size=(n, T, D_POSE)).astype(np.float32),
                  inpaint_masks=mask, trans_factor=0.575, pose_seed_len=2)
    ref = jgen.generate_sample(
        jnp.asarray(wav[:n]), D_POSE, T, jax.random.key(0), noise=jnp.asarray(noise),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    assert jgen.last_sample_path == "fused"
    assert tgen.fused_dtype is None
    args = tgen.fused_args(torch.from_numpy(wav[:n]), D_POSE, T,
                           torch.from_numpy(noise))
    assert args["compute_dtype"] == torch.float32
    assert args["packed"].w_embx.dtype == torch.bfloat16
    ours = tgen.generate_sample(wav[:n], D_POSE, T, noise=noise, **kw)
    assert tgen.last_sample_path == "fused"
    assert rel_err(ours.numpy(), np.asarray(ref)) < TOL


def _compute_dtype(gen, n, **kw):
    wav = torch.zeros(n, 16000)
    return gen.fused_args(wav, D_POSE, T, torch.zeros(n, T, D_POSE),
                          **kw)["compute_dtype"]


@pytest.mark.parametrize("n,want", [(1, torch.float32), (2, torch.float32),
                                    (3, torch.float32), (4, torch.bfloat16),
                                    (6, torch.float32), (8, torch.bfloat16),
                                    (12, torch.bfloat16)])
def test_policy_follows_the_batch(default_gens, n, want):
    """float32 where gcd(n_local, 8) <= 2, bfloat16 above; an explicit
    fused_dtype sets both the pack and the compute dtype at every batch."""
    _, tgen, _ = default_gens
    assert _compute_dtype(tgen, n) == want
    for dt in (torch.float32, torch.bfloat16):
        fixed = Generator(tgen.model, tgen.sched, tgen.timestep_map,
                          fused_dtype=dt, device="cpu")
        assert _compute_dtype(fixed, n) == dt
        assert fixed.fused_args(torch.zeros(n, 16000), D_POSE, T,
                                torch.zeros(n, T, D_POSE))["packed"].w_embx.dtype == dt


@pytest.mark.parametrize("n,want", [(2, torch.float32), (4, torch.float32),
                                    (3, torch.float32), (8, torch.bfloat16),
                                    (16, torch.bfloat16), (12, torch.float32)])
def test_policy_follows_n_local_under_a_mesh(default_gens, n, want):
    """Under a two-shard mesh the batch a device holds decides: 4 clips are
    2 a shard (float32), 8 are 4 (bfloat16), 12 are 6 (float32); a batch
    that does not divide (3) runs unsharded.  A mesh passed to the call
    decides for that call."""
    _, tgen, _ = default_gens
    mesh = make_mesh(devices=["cpu", "cpu"])
    sharded = Generator(tgen.model, tgen.sched, tgen.timestep_map, mesh=mesh)
    assert _compute_dtype(sharded, n) == want
    assert _compute_dtype(tgen, n, mesh=mesh) == want


def test_sharded_default_sample_computes_per_shard(default_gens):
    """Batch 4 over two shards computes in float32 (2 clips a shard) and
    equals the unsharded float32 batch; the unsharded default batch of 4
    computes in bfloat16."""
    _, tgen, _ = default_gens
    wav = np.random.default_rng(170).normal(0, 0.3, (4, 16000)).astype(np.float32)
    noise = np.random.default_rng(171).normal(size=(4, T, D_POSE)).astype(np.float32)
    sharded = Generator(tgen.model, tgen.sched, tgen.timestep_map,
                        mesh=make_mesh(devices=["cpu", "cpu"]))
    f32 = Generator(tgen.model, tgen.sched, tgen.timestep_map,
                    fused_dtype=torch.float32, device="cpu")
    a = sharded.generate_sample(wav, D_POSE, T, noise=noise)
    b = tgen.generate_sample(wav, D_POSE, T, noise=noise)
    c = f32.generate_sample(wav, D_POSE, T, noise=noise)
    # the f32 pack's weights are not the bf16 pack's: bf16 rounding apart
    assert 1e-4 < rel_err(a.numpy(), c.numpy()) < 5e-2
    ref = Generator(tgen.model, tgen.sched, tgen.timestep_map, device="cpu")
    args = ref.fused_args(torch.from_numpy(wav), D_POSE, T, torch.from_numpy(noise))
    assert args["compute_dtype"] == torch.bfloat16
    args["compute_dtype"] = torch.float32
    whole_f32 = fs.fused_ddim_sample(**args)[..., :D_POSE]
    assert rel_err(a.numpy(), whole_f32.numpy()) < 1e-6
    assert rel_err(b.numpy(), whole_f32.numpy()) > 10 * TOL


# -- the CUDA wrapper's float32 marshalling, library stubbed --------------------

class _StubLibrary:
    def __init__(self):
        self.calls = []
        self.smem = []

    def fused_ddim_launch(self, ptrs, n_ptrs, dims, n_dims, stream):
        self.calls.append((list(ptrs)[:n_ptrs], list(dims)[:n_dims]))
        return 0

    def fused_ddim_max_clusters(self, c, smem, f32):
        self.smem.append((smem, f32))
        return {8: 15, 4: 30, 2: 66, 1: 132}[c]


def test_cuda_wrapper_marshalling_f32(bf16_packs, monkeypatch):
    """Float32 compute on a bf16 and on an f32 pack: the dims' last two
    entries, the tensors the kernel reads (a bf16 pack's as they are, the
    same ones the bf16 instantiation reads; an f32 pack's product weights
    as three interleaved bf16 planes, its other tensors in f32; the memory
    rows, the token table and the scratch in f32), the float32 plan, which
    fits a Hopper block at the flagship, and the scratch's attention area,
    there only where the attention operands live in the global scratch
    (clusters of one block at the flagship)."""
    model = bf16_packs[0]
    _, tmap = make_diffusion("linear", 100, "ddim10")
    x, mem, a, b = (torch.from_numpy(v) for v in _inputs(3, 180, "ramp", t=40,
                                                         n_mem=92))
    stub = _StubLibrary()
    monkeypatch.setattr(fs, "_library", lambda: stub)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    seen = {}
    real_zeros = torch.zeros

    def zeros(*shape, **kw):            # the wrapper's last: the scratch
        seen["scratch"] = real_zeros(*shape, **kw)
        return seen["scratch"]

    nbytes, fc, half = fs.smem_plan(40, DM, DP, 4 * DM, f32=True, cluster=8)
    assert nbytes <= fs.SMEM_LIMIT and (fc, half) == (512, False)
    assert nbytes == fs.smem_bytes(40, DM, DP, 512, False, True, 8) == 232448
    assert fs.attention_shared(40, DM, DP, 512, False, 8)
    for wd, wpack in ((torch.bfloat16, 0), (torch.float32, 1)):
        p = fs.pack_oneway_denoiser(model, D_POSE, 40, weight_dtype=wd)
        for cluster, shared in ((None, True), (1, False)):
            before = dict(fs.launches_by_dtype)
            seen.clear()
            monkeypatch.setattr(torch, "zeros", zeros)
            out = fs._fused_ddim_cuda(p, x, mem, tmap, torch.zeros(10, 4), a, b,
                                      N_LAYERS, 8, 10, torch.float32,
                                      cluster=cluster)
            monkeypatch.setattr(torch, "zeros", real_zeros)
            assert out.shape == x.shape
            assert fs.launches_by_dtype.get((torch.float32, wd), 0) == \
                before.get((torch.float32, wd), 0) + 1
            ptrs, dims = stub.calls[-1]
            assert len(dims) == fs.N_DIMS == 16
            assert dims == [3, 40, 92, DM, DP, 4 * DM, N_LAYERS, 8, 10, fc, 0, 0,
                            cluster or 8, 0, 1, wpack]
            assert fs.last_plan == dict(
                cluster=cluster or 8, ff_chunk=512, half=False,
                attention="shared memory" if shared else "the global scratch")
            # memory K/V of 92 rows in 96, then with the global placement 48
            # rows of [q | k | v]
            kv = seen["scratch"]
            assert kv.dtype == torch.float32 and kv.shape == (
                3, N_LAYERS * 2 * DM * 96 + (0 if shared else 48 * 3 * DM))
            assert kv.shape[1] == fs.scratch_elems(92, DM, N_LAYERS,
                                                   0 if shared else 40)
        # the planned C asked the card (once: the answer is cached) about
        # clusters of 8 at their plan
        assert stub.smem[0] == (nbytes, 1)
        kt = fs.kernel_weights(p, torch.float32)
        assert ptrs[10:] == [kt[k].data_ptr() for k in fs._KERNEL_READS]
        assert all(kt[k].is_contiguous() for k in kt)
        assert kt["pe_x"].dtype == kt["b_out"].dtype == torch.float32
        assert all(kt[k].dtype == wd for k in fs._KERNEL_READS
                   if k not in fs._TRANSPOSED + ("pe_x", "b_out"))
        assert all(kt[k].dtype == torch.bfloat16 for k in fs._TRANSPOSED)
        if wd == torch.bfloat16:
            # the bf16 instantiation's tensors, not a float32 copy
            assert fs.kernel_weights(p) is kt
            assert kt["self_wqkv"].shape == (N_LAYERS, 3 * DM, DM)
            np.testing.assert_array_equal(
                kt["ff_w1"].float().numpy(),
                p.ff_w1.float().transpose(-1, -2).numpy())
        else:
            assert kt["self_wqkv"].shape == (N_LAYERS, 3 * DM, 3 * DM)
            planes = kt["ff_w1"].reshape(N_LAYERS, 4 * DM, DM // 16, 3, 16)
            np.testing.assert_array_equal(
                planes.double().sum(dim=3).reshape(N_LAYERS, 4 * DM, DM).numpy(),
                p.ff_w1.transpose(-1, -2).double().numpy())
        assert fs.kernel_weights(p, torch.float32) is kt
    # the longest window fits the float32 plan too, with a smaller FF chunk
    for c in fs.CLUSTER_SIZES:
        nbytes, fc, half = fs.smem_plan(64, DM, DP, 4 * DM, f32=True, cluster=c)
        assert nbytes <= fs.SMEM_LIMIT and (4 * DM) % fc == 0 and fc >= fs.STRIP
    # bf16 compute on an f32 pack and half precision are refused
    p32 = fs.pack_oneway_denoiser(model, D_POSE, 40, weight_dtype=torch.float32)
    with pytest.raises(ValueError, match="for compute_dtype torch.bfloat16"):
        fs._fused_ddim_cuda(p32, x, mem, tmap, torch.zeros(10, 4), a, b,
                            N_LAYERS, 8, 10, torch.bfloat16)
    p16 = fs.PackedDenoiser(*(t.half() if t.dtype == torch.bfloat16 else t
                              for t in fs.pack_oneway_denoiser(model, D_POSE, 40)))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fs._fused_ddim_cuda(p16, x, mem, tmap, torch.zeros(10, 4), a, b,
                            N_LAYERS, 8, 10, torch.float32)
