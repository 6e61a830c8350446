"""The float32 instantiation's arithmetic and plan, on the CPU.

The kernel computes its float32 products as three bf16 pieces of the
activation against the exact bf16 weight (an f32 pack's weights split the
same way, once): ``split3_bf16`` is that split, and here the pieces are
shown to sum back to their value over bf16's whole exponent range and the
sum of the piecewise products to match the float64 product at the
flagship's shapes.  The shared-memory plan, whose attention placement
depends on the cluster size, is held against its C++ source: the plan's
code in ``csrc/fused_ddim.cu`` compiles as plain C++ and runs here with
g++.  ``kernel_weights`` hands a bf16 pack over as it is and an f32 pack
as three interleaved bf16 planes.  The kernel itself is held against the
plain version on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.
"""

import pathlib
import re
import subprocess

import numpy as np
import pytest
import torch

from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser, init_random_
from gesture_diffusion_torch.ops import fused_sampler as fs

torch.set_num_threads(1)

CU = pathlib.Path(fs.__file__).resolve().parent.parent / "csrc" / "fused_ddim.cu"
WINDOWS = (8, 16, 40, 48, 64)


def _sum(pieces) -> np.ndarray:
    return sum(p.double().numpy() for p in pieces)


def test_split3_bf16_sums_back_on_normals():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 257)).astype(np.float32))
    pieces = fs.split3_bf16(x)
    assert all(p.dtype == torch.bfloat16 and p.shape == x.shape for p in pieces)
    back = _sum(pieces)
    ref = x.double().numpy()
    assert np.all(np.abs(back - ref) <= 2.0 ** -24 * np.abs(ref))
    np.testing.assert_array_equal(back, ref)
    # each piece is what the one before it leaves, rounded
    assert torch.equal(pieces[0], x.to(torch.bfloat16))
    assert np.all(np.abs(pieces[1].double().numpy())
                  <= 2.0 ** -8 * np.abs(ref) + 1e-300)


@pytest.mark.parametrize("exp", list(range(-100, 101, 20)))
def test_split3_bf16_sums_back_over_magnitudes(exp):
    """From 2^-100 to 2^100, signs mixed: the three pieces carry all 24
    bits."""
    rng = np.random.default_rng(exp + 1000)
    mant = rng.uniform(1.0, 2.0, 4096) * rng.choice([-1.0, 1.0], 4096)
    x = torch.from_numpy((mant * 2.0 ** exp).astype(np.float32))
    back = _sum(fs.split3_bf16(x))
    ref = x.double().numpy()
    assert np.all(np.abs(back - ref) <= 2.0 ** -24 * np.abs(ref))


def _piecewise(a: torch.Tensor, w_pieces) -> torch.Tensor:
    """The kernel's sum: each bf16 piece product exact, float32
    accumulation, small terms first (a3 w1 + a2 w2 + a1 w3, a2 w1 + a1 w2,
    a1 w1; with one weight piece a3 w, a2 w, a1 w)."""
    a1, a2, a3 = (p.float() for p in fs.split3_bf16(a))
    w = [p.float() for p in w_pieces]
    if len(w) == 1:
        terms = [a3 @ w[0], a2 @ w[0], a1 @ w[0]]
    else:
        terms = [a3 @ w[0], a2 @ w[1], a1 @ w[2], a2 @ w[0], a1 @ w[1],
                 a1 @ w[0]]
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


@pytest.mark.parametrize("k,n", [(256, 768), (256, 1024), (1024, 256),
                                 (128, 256)])
def test_split3_products_match_float64(k, n):
    """At the flagship's product shapes (40 rows; QKV, FF1, FF2, emb_x):
    on a bf16 pack the three pieces against the exact weight, and on an f32
    pack the six terms, are float32-accurate against float64; the bf16
    product of the instantiation that rounds the activation is not."""
    rng = np.random.default_rng(k + n)
    a = torch.from_numpy(rng.normal(size=(40, k)).astype(np.float32))
    w32 = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32))
    wb = w32.to(torch.bfloat16)
    ref = a.double() @ wb.double()
    scale = float(ref.abs().max())
    got = _piecewise(a, [wb])
    assert float((got.double() - ref).abs().max()) / scale < 2e-6
    rounded = a.to(torch.bfloat16).float() @ wb.float()
    assert float((rounded.double() - ref).abs().max()) / scale > 1e-3
    ref32 = a.double() @ w32.double()
    pieces = fs.split3_bf16(w32)
    np.testing.assert_array_equal(_sum(pieces), w32.double().numpy())
    got32 = _piecewise(a, pieces)
    assert float((got32.double() - ref32).abs().max()) / float(
        ref32.abs().max()) < 2e-6


# -- the shared-memory plan: Python against the C++ source --------------------

@pytest.fixture(scope="module")
def cpp_plan(tmp_path_factory):
    """The plan's code of csrc/fused_ddim.cu (its #defines, and from struct
    Layout to the end of plan_layout) compiled as plain C++ with a main
    that prints, for each window, cluster size and instantiation, the plan
    and the placement."""
    src = CU.read_text()
    defines = "\n".join(re.findall(r"^#define [A-Z_0-9]+ [^\n]*$", src, re.M))
    start = src.index("// Shared-memory plan (bytes)")
    end = src.index("// (end of the plan")
    body = src[start:end]
    main = r"""
#include <cstdio>
int main() {
  const int ts[] = {8, 16, 40, 48, 64};
  for (int t : ts)
    for (int c = 1; c <= 8; c *= 2)
      for (int ob = 2; ob <= 4; ob += 2) {
        int fc, half;
        const Layout L = plan_layout(t, 256, 128, 1024, ob, c, fc, half);
        const Layout M = make_layout(t, 256, 128, 256, 0, ob, c);
        std::printf("%d %d %d %d %d %d %d %d %d\n", t, c, ob, L.total, fc,
                    half, L.satt, M.total, M.satt);
      }
  return 0;
}
"""
    d = tmp_path_factory.mktemp("plan")
    (d / "plan.cpp").write_text("#define __host__\n#define __device__\n"
                                + defines + "\n" + body + main)
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(d / "plan"),
                    str(d / "plan.cpp")], check=True)
    out = subprocess.run([str(d / "plan")], check=True, capture_output=True,
                         text=True).stdout
    return {tuple(int(v) for v in line.split()[:3]):
            tuple(int(v) for v in line.split()[3:]) for line in out.splitlines()}


def test_cpp_plan_is_the_python_plan(cpp_plan):
    assert len(cpp_plan) == len(WINDOWS) * 4 * 2
    for (t, c, ob), (total, fc, half, satt, m_total, m_satt) in cpp_plan.items():
        f32 = ob == 4
        assert fs.smem_plan(t, 256, 128, 1024, f32, c) == (total, fc, bool(half))
        assert fs.smem_bytes(t, 256, 128, 256, False, f32, c) == m_total
        if f32:
            assert fs.attention_shared(t, 256, 128, fc, bool(half), c) == bool(satt)
            assert fs.attention_shared(t, 256, 128, 256, False, c) == bool(m_satt)
        else:
            assert not satt and not m_satt


@pytest.mark.parametrize("t", WINDOWS)
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_plan_fits_every_cluster(t, c):
    """Every window and cluster size fits a Hopper block in both
    instantiations; the bf16 plan does not depend on the cluster size."""
    for f32 in (False, True):
        nbytes, fc, half = fs.smem_plan(t, 256, 128, 1024, f32, c)
        assert nbytes <= fs.SMEM_LIMIT and 1024 % fc == 0 and fc >= fs.STRIP
        assert nbytes == fs.smem_bytes(t, 256, 128, fc, half, f32, c)
    assert fs.smem_plan(t, 256, 128, 1024, False, c) == fs.smem_plan(
        t, 256, 128, 1024, False)


def test_flagship_attention_placement():
    """At the flagship (T 40, d_model 256, FF 1024) the float32 plan takes
    FF chunk 512 with full strips at every C, in 232,448 bytes (its staging
    holds the window's 40 rows, not three whole row tiles); the block's own
    heads' q/k/v and cross queries share the FF chunk's area: in shared
    memory at C = 2, 4 and 8, in the global scratch at C = 1 (all eight
    heads' q/k/v would take 148,992 bytes)."""
    for c in fs.CLUSTER_SIZES:
        assert fs.smem_plan(40, 256, 128, 1024, True, c) == (232448, 512, False)
        assert fs.attention_shared(40, 256, 128, 512, False, c) == (c > 1)
    # with whole row tiles staged, chunk 512 would not fit full strips
    assert fs.smem_bytes(40, 256, 128, 512, False, True, 8) == fs.SMEM_LIMIT
    assert fs.smem_bytes(48, 256, 128, 512, False, True, 8) > fs.SMEM_LIMIT


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_cluster_barriers_a_step(c):
    """Every block of the float32 instantiation normalises all of h's rows
    itself, so no LayerNorm waits on a cluster barrier: 42 a step at the
    flagship (4 layers, FF chunk 512) against the bf16 instantiation's 47
    (FF chunk 1024, every LayerNorm's rows exchanged), and 55 had the
    float32 plan's two chunks exchanged them; on one block, none."""
    fc32 = fs.smem_plan(40, 256, 128, 1024, True, c)[1]
    fc16 = fs.smem_plan(40, 256, 128, 1024, False, c)[1]
    assert (fc32, fc16) == (512, 1024)
    many = c > 1
    assert fs.cluster_barriers(4, 1024, fc32, c, True) == 42 * many
    assert fs.cluster_barriers(4, 1024, fc16, c, False) == 47 * many
    assert fs.cluster_barriers(4, 1024, fc32, c, False) == 55 * many
    # FF chunk 256: two more hidden chunks a layer, four more barriers
    assert fs.cluster_barriers(4, 1024, 256, c, True) == (42 + 16) * many


@pytest.fixture(scope="module")
def model():
    m = GestureDenoiser(DenoiserConfig(d_pose=12, n_layers=2))
    return init_random_(m, torch.Generator().manual_seed(5)).eval()


def test_kernel_weights_of_a_bf16_pack_are_the_pack(model):
    """Both instantiations read a bf16 pack's tensors as the pack holds
    them (the product weights transposed), through one entry: no float32
    copy is made."""
    p = fs.pack_oneway_denoiser(model, 12, 40)
    kt = fs.kernel_weights(p, torch.float32)
    assert fs.kernel_weights(p) is kt
    for name in fs._KERNEL_READS:
        w = getattr(p, name)
        assert kt[name].dtype == w.dtype and kt[name].is_contiguous(), name
        if name in fs._TRANSPOSED:
            assert torch.equal(kt[name], w.transpose(-1, -2)), name
        else:
            assert kt[name] is w, name
    assert all(kt[name].dtype == torch.bfloat16 for name in fs._TRANSPOSED)


def _planes(w: torch.Tensor) -> list:
    """The three planes of an interleaved (..., N, 3 K) weight."""
    *lead, k3 = w.shape
    t = w.reshape(*lead, k3 // 48, 3, 16)
    return [t[..., i, :].reshape(*lead, k3 // 3) for i in range(3)]


def test_kernel_weights_of_an_f32_pack_are_three_planes(model):
    """An f32 pack's product weights go over as three bf16 planes,
    interleaved per 16 k, that sum to the transposed weights exactly; its
    other tensors stay float32."""
    p = fs.pack_oneway_denoiser(model, 12, 40, weight_dtype=torch.float32)
    kt = fs.kernel_weights(p, torch.float32)
    for name in fs._KERNEL_READS:
        w = getattr(p, name)
        if name in fs._TRANSPOSED:
            wt = w.transpose(-1, -2)
            assert kt[name].dtype == torch.bfloat16 and kt[name].is_contiguous()
            assert kt[name].shape == (*wt.shape[:-1], 3 * wt.shape[-1]), name
            planes = _planes(kt[name])
            np.testing.assert_array_equal(_sum(planes), wt.double().numpy())
            assert all(torch.equal(a, b) for a, b in zip(planes, fs.split3_bf16(wt)))
        else:
            assert kt[name] is w and w.dtype == torch.float32, name
    with pytest.raises(ValueError, match="bf16 pack only"):
        fs.kernel_weights(p, torch.bfloat16)
