"""Fused diffusion sampler: the whole reverse process of the oneway
denoiser in ONE CUDA kernel launch (``csrc/fused_ddim.cu``), plus its plain
version.

Replaces the TPU kernel ``gesture_diffusion_tpu/ops/fused_sampler.py``
``fused_ddim_sample`` / ``_make_kernel`` (one ``pallas_call``) in every
variant: DDIM (eta=0) and ancestral DDPM (``stochastic``), each with the
identity blend or the x0 blend, the inpaint model type's ``x_add``, and
windows and memories of any length up to 64 and 128 rows.

Per step (mirrors ``models/denoiser.py`` + ``models/decoders.py``):
  token = emb_mem(step_mlp(temb[tmap[s]])) + pe[0]       (memory row 0)
  mem   = [token ; precomputed emb_mem(speech)+pe[1:]]
  h     = emb_x(x + x_add) + pe[:T]
  L x { LN -> merged QKV -> 3-tap dconv -> attention -> out-proj;
        LN -> cross q + dconv, memory KV + dconv -> cross-attention;
        LN -> squared-ReLU FF }
  eps   = out_head(LN(h))
  DDIM, identity blend:  x = (c2*c0) x + (c3 - c2*c1) eps
  DDIM, x0 blend:        x0 = a + b*(c0 x - c1 eps);  eps = (c0 x - x0)/c1;
                         x = c2 x0 + c3 eps
  DDPM, identity blend:  x = (c2*c0 + c3) x - (c2*c1) eps + sigma z
  DDPM, x0 blend:        x0 = a + b*(c0 x - c1 eps);
                         x = c2 x0 + c3 x + sigma z
(DDPM: c2, c3 are the posterior mean coefficients, ``ddpm_coefficients``.)

Compute-dtype policy (both the kernel and ``fused_ddim_sample_plain``):
the operands of every product (projections, Q.K^T, P.V) are rounded to
``compute_dtype`` and accumulated in float32; everything else stays
float32 — the residual stream h, LayerNorm, softmax, biases, the dconv,
the state x, eps and the noise z.  Both take ``compute_dtype`` bfloat16
with a bfloat16 pack, and float32 with a bfloat16 pack (the JAX
Generator's default at one or two clips a device) or a float32 one
(``fused_dtype=float32``); bfloat16 compute on a float32 pack is refused,
as the JAX package never builds it.  The kernel is one template with an
instantiation for each compute dtype: bf16 operands on the tensor cores,
or, for float32, every projection as three bf16 pieces of the float32
activation against the exact bf16 weight (``split3_bf16``: the pieces sum
to the activation exactly, and each piece times a bf16 weight is exact in
the float32 accumulator), three bf16 MMAs a 16-deep step on a bf16 pack;
an f32 pack's weights are split the same way once, into three bf16
planes, and a product takes the six terms down to the float32 level.
Attention's products (activations on both sides) run as split TF32.  The
token table, the memory rows and P are float32 too
(``csrc/fused_ddim.cu``).

Noise of the stochastic sampler, defined once for the kernel and the plain
version (``fused_noise``): z for element (clip, row r, lane n) of step s
is Box-Muller (cosine branch) of two words of Philox4x32-10 with
key = (seed low word, seed high word) and counter
((r // 2) * Dp_pad + n, s, clip_base + clip, 0); words 0, 1 serve the
even row of the pair and words 2, 3 the odd one.  ``clip_base`` is 0
unless the batch is a shard of a larger one.  u = top 23 bits / 2**23,
z = sqrt(-2 log(max(u1, 1e-12))) cos(2 pi u2).  Pad lanes draw noise like
any other lane; the caller slices them off.

The timestep token depends on the step, not the clip, so the wrapper
precomputes an (S, D) token table with plain torch ops before the launch
(``step_tokens``); the speech memory rows are precomputed by the caller.

Memory design of the kernel: only memory rows 0 and 1 change from step to
step (the token, and its neighbour through the dconv), so the kernel
computes every layer's memory K and V once, before the step loop, into a
per-clip scratch that the wrapper allocates (``scratch_elems``), and
recomputes rows 0 and 1 per step.  The memory takes no shared memory,
whatever its length; cross-attention loads its K and V fragments from the
scratch, which stays in L2.  Both attentions run on the tensor cores, 16
queries per pass, with the softmax in float32 between the two products.

What bounds the kernel on an H100: no SM holds the ~8.7 MB of bf16 weights
(both instantiations read a bf16 pack's transposed bf16 weights; an f32
pack's three bf16 planes take 25.6 MB; 227 KB of shared memory), so every
step re-reads every weight from L2, and the matmul k-loops run on the few
rows of one clip as chains of dependent k-steps; each k-step's weights
load while the previous one's products run.  One clip runs on a
thread-block cluster of C blocks
(``cluster_plan``: the largest of 8, 4, 2 that divides the heads and lets
all n clusters run in one wave, else 1), each with a full replica of the
clip's shared-memory layout; the cluster spreads every product's column
strips and K over its 8C warps and each block's epilogues write into every
replica.  Later work (weights through a TMA ring, wgmma, clips sharing a
block) attacks the weight stream itself.  The float32 instantiation's
operand rows take 4 bytes, so a block holds only its own heads' q/k/v
and cross queries, in the area of the FF hidden chunk, where that fits
(``smem_plan`` per cluster size: at the flagship C = 2, 4, 8), and the
global scratch holds them otherwise (C = 1).  ``bound_ms`` in
``chip_smoke.py`` gives the least time for the work.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.attention import sinusoidal_position_encoding
from ..models.decoders import LN_EPS
from ..models.denoiser import timestep_freqs
from ..utils.profiling import span

# kernel limits (csrc/fused_ddim.cu): one cluster of blocks of NWARPS
# warps per clip, epilogue strips of 32 columns, at most 4 row tiles of 16
# window rows, 4 key chunks of 32 memory rows, heads of up to 4 tiles of
# 16 dims
NWARPS = 8
STRIP = 32
MAX_T = 64
MAX_MEM = 128
MAX_DK = 64
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block can use
CLUSTER_SIZES = (8, 4, 2, 1)  # blocks per clip; 8 is the portable limit

#: launches of the CUDA kernel (never of the plain version); callers that
#: want a per-run count set it to 0 first
launches = 0
#: the same launches by (compute dtype, pack weight dtype): the bf16
#: instantiation is (bfloat16, bfloat16), the float32 one either
#: (float32, bfloat16) or (float32, float32)
launches_by_dtype: dict = {}
#: the cluster size of the last launch
last_cluster = None
#: the plan of the last launch: cluster, ff_chunk, half (half-strip
#: staging), attention ("shared memory" or "the global scratch": where the
#: float32 instantiation's attention operands live; bf16: every block's
#: replica)
last_plan = None


class PackedDenoiser(NamedTuple):
    """Stacked, padded weights for the fused sampler (L = n_layers).
    Dense weights are (in, out).  LayerNorm affine terms are folded into
    the projections that consume them (ln1 -> self qkv, ln2 -> cross q,
    ln3 -> ff1, out_norm -> out head)."""

    w_embx: torch.Tensor      # (Dp_pad, D)
    b_embx: torch.Tensor      # (1, D)
    pe_x: torch.Tensor        # (T, D) f32
    w_sp1: torch.Tensor       # (D, D)
    b_sp1: torch.Tensor
    w_sp2: torch.Tensor
    b_sp2: torch.Tensor
    w_emm: torch.Tensor       # (D, D)  emb_mem
    b_emm: torch.Tensor
    pe_m0: torch.Tensor       # (1, D) f32
    self_wqkv: torch.Tensor   # (L, D, 3D)
    self_bqkv: torch.Tensor   # (L, 1, 3D)
    self_dconv: torch.Tensor  # (L, 3, 3D)  taps tiled across heads
    self_dbias: torch.Tensor  # (L, 1, 3D)
    self_wo: torch.Tensor     # (L, D, D)
    self_bo: torch.Tensor     # (L, 1, D)
    cross_wq: torch.Tensor    # (L, D, D)
    cross_bq: torch.Tensor    # (L, 1, D)
    cross_wkv: torch.Tensor   # (L, D, 2D)  memory side, no LN fold
    cross_bkv: torch.Tensor   # (L, 1, 2D)
    cross_dq: torch.Tensor    # (L, 3, D)
    cross_dqb: torch.Tensor   # (L, 1, D)
    cross_dkv: torch.Tensor   # (L, 3, 2D)
    cross_dkvb: torch.Tensor  # (L, 1, 2D)
    cross_wo: torch.Tensor    # (L, D, D)
    cross_bo: torch.Tensor    # (L, 1, D)
    ff_w1: torch.Tensor       # (L, D, F)
    ff_b1: torch.Tensor       # (L, 1, F)
    ff_w2: torch.Tensor       # (L, F, D)
    ff_b2: torch.Tensor       # (L, 1, D)
    w_out: torch.Tensor       # (D, Dp_pad)
    b_out: torch.Tensor       # (1, Dp_pad) f32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _fold_ln(w: torch.Tensor, b: torch.Tensor, ln_scale: torch.Tensor,
             ln_bias: torch.Tensor):
    """(zW + b) with z = n*s + t  ->  n(W*s[:,None]) + (tW + b)."""
    w32 = w.float()
    return w32 * ln_scale.float()[:, None], b.float() + ln_bias.float() @ w32


@torch.no_grad()
def pack_oneway_denoiser(model, d_pose: int, t_window: int,
                         weight_dtype=torch.bfloat16) -> PackedDenoiser:
    """Flatten a ``GestureDenoiser`` (oneway decoder) into the sampler's
    stacks, on the model's device.  d_pose is zero-padded to a multiple of
    128 on the input embedding and the output head (the extra eps columns
    are discarded by the caller)."""
    dec = model.pose_decoder
    step = model.diffusion_step_encoder.proj
    d_model = dec.emb_x.out_features
    dp_pad = _round_up(d_pose, 128)
    wd = weight_dtype
    dev = dec.emb_x.weight.device

    def kern(lin):                       # Linear -> (in, out) kernel
        return lin.weight.detach().t().float()

    def bias(lin):
        return lin.bias.detach().float()[None, :]

    def pad_rows(w, rows):
        return F.pad(w, (0, 0, 0, rows - w.shape[0]))

    def pad_cols(w, cols):
        return F.pad(w, (0, cols - w.shape[1]))

    pe = torch.from_numpy(sinusoidal_position_encoding(5000, d_model)).to(dev)

    def tiled_dconv(mhas):
        taps, biases = [], []
        for seq in mhas:
            conv = seq[1].conv
            n_heads = d_model // conv.weight.shape[0]
            taps.append(conv.weight[:, 0, :].t().float().repeat(1, n_heads))
            biases.append(conv.bias.float().repeat(n_heads)[None, :])
        return torch.cat(taps, dim=1), torch.cat(biases, dim=1)

    fields = {k: [] for k in PackedDenoiser._fields[10:30]}   # L-stacks
    for layer in dec.layers:
        a, ln = layer.self_attn, layer.norm_self_attn
        w3 = torch.cat([kern(a.query[0].linear), kern(a.key[0].linear),
                        kern(a.value[0].linear)], dim=1)
        b3 = torch.cat([bias(a.query[0].linear), bias(a.key[0].linear),
                        bias(a.value[0].linear)], dim=1)
        w3, b3 = _fold_ln(w3, b3, ln.weight, ln.bias)
        taps, tb = tiled_dconv((a.query, a.key, a.value))
        for k, v in (("self_wqkv", w3), ("self_bqkv", b3), ("self_dconv", taps),
                     ("self_dbias", tb), ("self_wo", kern(a.output)),
                     ("self_bo", bias(a.output))):
            fields[k].append(v)

        a, ln = layer.cross_attn, layer.norm_cross_attn
        wq, bq = _fold_ln(kern(a.query[0].linear), bias(a.query[0].linear),
                          ln.weight, ln.bias)
        tq, tqb = tiled_dconv((a.query,))
        tkv, tkvb = tiled_dconv((a.key, a.value))
        for k, v in (("cross_wq", wq), ("cross_bq", bq),
                     ("cross_wkv", torch.cat([kern(a.key[0].linear),
                                              kern(a.value[0].linear)], dim=1)),
                     ("cross_bkv", torch.cat([bias(a.key[0].linear),
                                              bias(a.value[0].linear)], dim=1)),
                     ("cross_dq", tq), ("cross_dqb", tqb),
                     ("cross_dkv", tkv), ("cross_dkvb", tkvb),
                     ("cross_wo", kern(a.output)), ("cross_bo", bias(a.output))):
            fields[k].append(v)

        ff, ln = layer.feed_forward, layer.norm_ff
        w1, b1 = _fold_ln(kern(ff.layer1), bias(ff.layer1), ln.weight, ln.bias)
        for k, v in (("ff_w1", w1), ("ff_b1", b1), ("ff_w2", kern(ff.layer2)),
                     ("ff_b2", bias(ff.layer2))):
            fields[k].append(v)

    out_norm, out_proj = dec.out_layers[0], dec.out_layers[1]
    w_out, b_out = _fold_ln(pad_cols(kern(out_proj), dp_pad),
                            pad_cols(bias(out_proj), dp_pad),
                            out_norm.weight, out_norm.bias)

    def cast(x):
        return x.to(wd).contiguous()

    return PackedDenoiser(
        w_embx=cast(pad_rows(kern(dec.emb_x), dp_pad)),
        b_embx=cast(bias(dec.emb_x)),
        pe_x=pe[:t_window].contiguous(),
        w_sp1=cast(kern(step[0])), b_sp1=cast(bias(step[0])),
        w_sp2=cast(kern(step[2])), b_sp2=cast(bias(step[2])),
        w_emm=cast(kern(dec.emb_mem)), b_emm=cast(bias(dec.emb_mem)),
        pe_m0=pe[:1].contiguous(),
        **{k: cast(torch.stack(v)) for k, v in fields.items()},
        w_out=cast(w_out),
        b_out=b_out.float().contiguous(),
    )


def ddim_coefficients(sched) -> torch.Tensor:
    """(S, 4) float32: [sqrt_recip_acp, sqrt_recipm1_acp, sqrt(acp_prev),
    sqrt(1-acp_prev)] per step of the RESPACED schedule (respacing is baked
    into its tables; the timestep map only feeds the token table)."""
    acp_prev = sched.alphas_cumprod_prev.cpu().numpy()
    c = np.stack([
        sched.sqrt_recip_alphas_cumprod.cpu().numpy(),
        sched.sqrt_recipm1_alphas_cumprod.cpu().numpy(),
        np.sqrt(acp_prev),
        np.sqrt(1.0 - acp_prev),
    ], axis=1).astype(np.float32)
    return torch.from_numpy(c)


def ddpm_coefficients(sched) -> torch.Tensor:
    """(S, 5) float32 for ancestral sampling: [sqrt_recip_acp,
    sqrt_recipm1_acp, posterior_mean_coef1, posterior_mean_coef2, noise std
    exp(0.5 * posterior_log_variance_clipped)]; the std is zero at step 0
    (no noise at t == 0).  ``fused_ddim_sample(stochastic=True)`` needs
    this 5-column layout."""
    sigma = np.exp(0.5 * sched.posterior_log_variance_clipped.cpu().numpy())
    sigma[0] = 0.0
    c = np.stack([
        sched.sqrt_recip_alphas_cumprod.cpu().numpy(),
        sched.sqrt_recipm1_alphas_cumprod.cpu().numpy(),
        sched.posterior_mean_coef1.cpu().numpy(),
        sched.posterior_mean_coef2.cpu().numpy(),
        sigma,
    ], axis=1).astype(np.float32)
    return torch.from_numpy(c)


_M32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of a * b for a constant a < 2**32 and int64
    words b in [0, 2**32), through 16-bit halves so that nothing leaves
    int64."""
    p0, p1 = a * (b & 0xFFFF), a * (b >> 16)
    return (p1 + (p0 >> 16)) >> 16, (((p1 & 0xFFFF) << 16) + p0) & _M32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., Random123) with integer tensor ops:
    counter words c0..c3 and key words k0, k1 (int64 tensors or ints in
    [0, 2**32), broadcast together) -> four int64 tensors of 32-bit words."""
    c0, c1, c2, c3, k0, k1 = (torch.as_tensor(v, dtype=torch.int64)
                              for v in (c0, c1, c2, c3, k0, k1))
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def _box_muller(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One N(0, 1) draw per pair of 32-bit words (the cosine branch)."""
    u1 = (a >> 9).float() * 2.0 ** -23
    u2 = (b >> 9).float() * 2.0 ** -23
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
    return r * torch.cos((2.0 * math.pi) * u2)


def fused_noise(seed, step: int, n: int, t: int, dp: int,
                device=None, clip_base: int = 0) -> torch.Tensor:
    """(N, T, Dp_pad) float32 noise of the stochastic sampler at ``step``,
    as the kernel draws it (module docstring), for the clips
    [clip_base, clip_base + N): a shard of a larger batch draws the
    whole batch's z for its clips.  ``seed`` is an int or a one-element
    int64 tensor; only its low 64 bits count."""
    seed = torch.as_tensor(seed, dtype=torch.int64).reshape(())
    device = seed.device if device is None else device
    seed = seed.to(device)
    pairs = (t + 1) // 2
    c0 = torch.arange(pairs * dp, dtype=torch.int64, device=device
                      ).view(1, pairs, dp)
    clip = torch.arange(clip_base, clip_base + n, dtype=torch.int64,
                        device=device).view(n, 1, 1)
    w = philox4x32_10(c0, step, clip, 0, seed & _M32, (seed >> 32) & _M32)
    z = torch.stack([_box_muller(w[0], w[1]), _box_muller(w[2], w[3])], dim=2)
    return z.reshape(n, 2 * pairs, dp)[:, :t]


def _r(x: torch.Tensor, cd) -> torch.Tensor:
    """Round a product operand to the compute dtype (kept as float32)."""
    return x if cd == torch.float32 else x.to(cd).float()


def _mm(a: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    return _r(a, cd) @ w.float()


def step_tokens(packed: PackedDenoiser, tmap: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """(S, D) float32 timestep tokens emb_mem(step_mlp(temb(tmap[s]))) +
    pe[0], one per step (shared by every clip)."""
    p, cd = packed, compute_dtype
    d_model = p.w_emm.shape[0]
    args = tmap.to(p.w_emm.device).float()[:, None] * timestep_freqs(
        d_model, device=p.w_emm.device)[None]
    e = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    t1 = _mm(e, p.w_sp1, cd) + p.b_sp1.float()
    t1 = t1 * torch.sigmoid(t1)
    t2 = _mm(t1, p.w_sp2, cd) + p.b_sp2.float()
    return _mm(t2, p.w_emm, cd) + p.b_emm.float() + p.pe_m0


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Normalize only (the affine is folded into the next projection)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS)


def _dconv(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor):
    taps = taps.float()
    prev = F.pad(x[:, :-1], (0, 0, 1, 0))
    nxt = F.pad(x[:, 1:], (0, 0, 0, 1))
    return prev * taps[0] + x * taps[1] + nxt * taps[2] + bias.float()


def _attention(q, k, v, heads: int, cd) -> torch.Tensor:
    n, tq, d = q.shape
    dk = d // heads

    def split(t):
        return _r(t, cd).view(n, t.shape[1], heads, dk).transpose(1, 2)

    s = (split(q) @ split(k).transpose(-1, -2)) * (1.0 / math.sqrt(dk))
    o = _r(torch.softmax(s, dim=-1), cd) @ split(v)
    return o.transpose(1, 2).reshape(n, tq, d)


@torch.no_grad()
def fused_ddim_sample_plain(packed: PackedDenoiser, x_T, mem_rows, tmap, coefs,
                            blend_a, blend_b, n_layers: int, heads: int,
                            num_steps: int, compute_dtype=torch.bfloat16,
                            stochastic: bool = False, seed=0, x_add=None,
                            clip_base: int = 0, z=None):
    """The fused sampler's function in plain torch ops on the packed
    weights, with the kernel's arguments and compute-dtype policy.  The
    CPU path of ``fused_ddim_sample`` and the card's yardstick for the
    kernel; not the serving path when a card is present.

    With ``stochastic`` it draws the kernel's noise (``fused_noise``) from
    the same ``seed``; ``z`` of shape (S, N, T, Dp_pad), when given,
    replaces the drawn noise (``z[s]`` at step s): the hook that lets a
    test hold it against another sampler's draws."""
    _check_args(packed, x_T, mem_rows, tmap, coefs, blend_a, blend_b,
                n_layers, heads, num_steps, stochastic, x_add)
    p, cd = packed, compute_dtype
    d_model = p.w_emm.shape[0]
    n, t, dp = x_T.shape
    if z is not None and tuple(z.shape) != (num_steps, n, t, dp):
        raise ValueError(f"z shape {tuple(z.shape)} must be "
                         f"{(num_steps, n, t, dp)}")
    tok = step_tokens(p, tmap, cd)
    # host copy of the coefficients; scalar products in float32, as the kernel's
    c = coefs.detach().cpu().numpy().astype(np.float32)
    pe_x = p.pe_x[:t].float()
    mem = mem_rows.float().clone()
    x = x_T.float()
    for i in range(num_steps):
        s = num_steps - 1 - i
        mem[:, 0] = tok[s]
        xin = x if x_add is None else x + x_add
        h = _mm(xin, p.w_embx, cd) + p.b_embx.float() + pe_x
        for l in range(n_layers):
            qkv = _dconv(_mm(_ln(h), p.self_wqkv[l], cd) + p.self_bqkv[l].float(),
                         p.self_dconv[l], p.self_dbias[l])
            q, k, v = qkv.split(d_model, dim=-1)
            h = h + (_mm(_attention(q, k, v, heads, cd), p.self_wo[l], cd)
                     + p.self_bo[l].float())
            q = _dconv(_mm(_ln(h), p.cross_wq[l], cd) + p.cross_bq[l].float(),
                       p.cross_dq[l], p.cross_dqb[l])
            kv = _dconv(_mm(mem, p.cross_wkv[l], cd) + p.cross_bkv[l].float(),
                        p.cross_dkv[l], p.cross_dkvb[l])
            k, v = kv.split(d_model, dim=-1)
            h = h + (_mm(_attention(q, k, v, heads, cd), p.cross_wo[l], cd)
                     + p.cross_bo[l].float())
            f = torch.relu(_mm(_ln(h), p.ff_w1[l], cd) + p.ff_b1[l].float())
            h = h + (_mm(f * f, p.ff_w2[l], cd) + p.ff_b2[l].float())
        eps = _mm(_ln(h), p.w_out, cd) + p.b_out
        c0, c1, c2, c3 = c[s, :4]
        if stochastic:
            zs = z[s] if z is not None else fused_noise(
                seed, s, n, t, dp, x.device, clip_base)
            if blend_a is None:
                x = (float(c2 * c0 + c3) * x - float(c2 * c1) * eps
                     + float(c[s, 4]) * zs)
            else:
                x0 = blend_a + blend_b * (float(c0) * x - float(c1) * eps)
                x = float(c2) * x0 + float(c3) * x + float(c[s, 4]) * zs
        elif blend_a is None:
            x = float(c2 * c0) * x + float(c3 - c2 * c1) * eps
        else:
            x0 = blend_a + blend_b * (float(c0) * x - float(c1) * eps)
            eps = (float(c0) * x - x0) / float(c1)
            x = float(c2) * x0 + float(c3) * eps
    return x


def _check_args(packed, x_T, mem_rows, tmap, coefs, blend_a, blend_b,
                n_layers, heads, num_steps, stochastic=False,
                x_add=None) -> None:
    n, t, dp = x_T.shape
    d_model = packed.w_emm.shape[0]
    if dp != packed.w_embx.shape[0]:
        raise ValueError(f"x_T has {dp} pose lanes, the pack {packed.w_embx.shape[0]}")
    if mem_rows.ndim != 3 or mem_rows.shape[0] != n or mem_rows.shape[2] != d_model:
        raise ValueError(f"mem_rows {tuple(mem_rows.shape)} must be "
                         f"(N={n}, n_mem, D={d_model})")
    if mem_rows.shape[1] < 2:
        raise ValueError("mem_rows needs the token row plus a speech row")
    if t > packed.pe_x.shape[0]:
        raise ValueError(f"window {t} exceeds the packed window {packed.pe_x.shape[0]}")
    if n_layers != packed.self_wqkv.shape[0] or d_model % heads:
        raise ValueError("n_layers/heads do not match the packed weights")
    if tmap.shape[0] != num_steps or coefs.shape[0] != num_steps:
        raise ValueError(f"tmap ({tmap.shape[0]} rows) and coefs ({coefs.shape[0]}) "
                         f"must both have num_steps ({num_steps}) rows")
    if (blend_a is None) != (blend_b is None):
        raise ValueError("blend_a and blend_b must both be given or both None")
    if blend_a is not None and (blend_a.shape != x_T.shape or blend_b.shape != x_T.shape):
        raise ValueError("blend tensors must match x_T's shape")
    if coefs.ndim != 2 or coefs.shape[1] < (5 if stochastic else 4):
        raise ValueError(
            "stochastic=True needs the 5-column ddpm_coefficients() layout, "
            "DDIM the 4-column ddim_coefficients() one "
            f"(got {tuple(coefs.shape)})")
    if x_add is not None and x_add.shape != x_T.shape:
        raise ValueError(f"x_add shape {tuple(x_add.shape)} must match x_T "
                         f"{tuple(x_T.shape)}")


def _align128(b: int) -> int:
    return (b + 127) // 128 * 128


def _layout(t: int, d_model: int, dp_pad: int, ff_chunk: int, half: bool,
            f32: bool, cluster: int):
    """(bytes, attention operands in shared memory) of one block; mirrors
    ``make_layout`` in ``csrc/fused_ddim.cu``."""
    mtx = -(-t // 16)
    ob = 4 if f32 else 2
    lda, ldm = max(d_model, dp_pad) + 8, d_model + 8
    srows = max(_round_up(t, 8), 16) if f32 else 16 * mtx   # rows staged
    stage_warp = max(srows * (STRIP // 2 if half else STRIP), 16 * MAX_DK)
    stage = _align128(NWARPS * stage_warp * 4)
    off = _align128(t * d_model * 4) + _align128(16 * mtx * lda * ob)
    shared = False
    if f32:
        rest = max(16 * ldm * 4, 16 * mtx * (ff_chunk + 8) * 4)
        hc = d_model // cluster
        own = max(rest, 16 * mtx * (3 * hc + 8) * 4,
                  _align128(t * (hc + 8) * 4) + 16 * ldm * 4)
        shared = off + _align128(own) + stage <= SMEM_LIMIT
        big = own if shared else rest
    else:
        cq = _align128(t * (d_model + 8) * 2)
        big = max(16 * mtx * (3 * d_model + 8) * 2, cq + 16 * ldm * 2,
                  16 * mtx * (ff_chunk + 8) * 2, 16 * mtx * ldm * 2)
    return off + _align128(big) + stage, shared


def smem_bytes(t: int, d_model: int, dp_pad: int, ff_chunk: int,
               half: bool = False, f32: bool = False, cluster: int = 1) -> int:
    """Dynamic shared memory of one block; mirrors ``make_layout`` in
    ``csrc/fused_ddim.cu``.  The memory length does not enter: the memory
    K and V live in the global scratch.  ``half``: a warp stages its
    32-column strip as two 16-column halves.  ``f32``: the float32
    instantiation, whose operand rows take 4 bytes and whose blocks of a
    cluster of ``cluster`` hold their own heads' attention operands where
    that fits (``attention_shared``)."""
    return _layout(t, d_model, dp_pad, ff_chunk, half, f32, cluster)[0]


def attention_shared(t: int, d_model: int, dp_pad: int, ff_chunk: int,
                     half: bool, cluster: int) -> bool:
    """Whether the float32 instantiation's attention operands live in
    shared memory (each block of the cluster its own heads' q/k/v and cross
    queries) or in the global scratch; mirrors ``make_layout``."""
    return _layout(t, d_model, dp_pad, ff_chunk, half, True, cluster)[1]


def smem_plan(t: int, d_model: int, dp_pad: int, ffn: int, f32: bool = False,
              cluster: int = 1):
    """(bytes, FF chunk, half) for clusters of ``cluster`` blocks: with
    full-strip staging first, then with half strips, halve the FF hidden
    chunk until a block fits.  Mirrors ``plan_layout`` in
    ``csrc/fused_ddim.cu``."""
    for half in (False, True):
        fc = ffn
        while (smem_bytes(t, d_model, dp_pad, fc, half, f32, cluster) > SMEM_LIMIT
               and fc % (2 * STRIP) == 0):
            fc //= 2
        if smem_bytes(t, d_model, dp_pad, fc, half, f32, cluster) <= SMEM_LIMIT:
            break
    return smem_bytes(t, d_model, dp_pad, fc, half, f32, cluster), fc, half


def cluster_barriers(n_layers: int, ffn: int, ff_chunk: int, cluster: int,
                     ln_local: bool) -> int:
    """Cluster barriers of one denoiser step on clusters of ``cluster``
    blocks (none on one block, whose barriers are the block's own): after
    emb_x and after the update; in each layer after the QKV product, each
    attention, each out-projection, the cross queries, and FF1 and FF2 of
    each hidden chunk; and, unless every block normalises all of h's rows
    itself (``ln_local``: the float32 instantiation), after each of the
    3 L + 1 LayerNorms, whose rows cross blocks.  Mirrors the step loop of
    ``csrc/fused_ddim.cu``."""
    if cluster == 1:
        return 0
    n = 2 + n_layers * (6 + 2 * (ffn // ff_chunk))
    return n if ln_local else n + 3 * n_layers + 1


def cluster_plan(n: int, heads: int, max_clusters) -> int:
    """Blocks per clip for n clips: the largest C of 8, 4, 2 that divides
    ``heads`` (a block owns whole heads) and for which all n clusters run at
    once, ``max_clusters(C) >= n`` (the card's figure at the shared memory
    of the plan for C, ``cudaOccupancyMaxActiveClusters``); else 1.
    Mirrors ``fused_ddim_cluster_size`` in ``csrc/fused_ddim.cu``."""
    for c in CLUSTER_SIZES[:-1]:
        if heads % c == 0 and max_clusters(c) >= n:
            return c
    return 1


def scratch_elems(n_mem: int, d_model: int, n_layers: int, t: int = 0) -> int:
    """Operand elements of one clip's scratch: the memory K/V, per layer one
    row of [K | V] per memory row, n_mem rounded up to whole 16-row tiles;
    with the window ``t`` (the float32 instantiation where its attention
    operands live in the scratch, ``attention_shared`` false), then the
    attention operands, one row of [q | k | v] per window row, rounded the
    same way."""
    return (n_layers * 2 * d_model * _round_up(n_mem, 16)
            + _round_up(t, 16) * 3 * d_model)


def _kernel_plan(packed: PackedDenoiser, x_T, mem_rows, heads: int,
                 f32: bool = False, cluster: int = 1):
    """Raise on what the kernel does not take; return (FF chunk, half) for
    clusters of ``cluster`` blocks."""
    n, t, dp = x_T.shape
    n_mem, d_model = mem_rows.shape[1], packed.w_emm.shape[0]
    ffn, dk = packed.ff_w1.shape[2], d_model // heads
    if not (1 <= t <= MAX_T and 2 <= n_mem <= MAX_MEM):
        raise ValueError(f"kernel takes windows of at most {MAX_T} rows and "
                         f"memories of at most {MAX_MEM} (got T={t}, "
                         f"n_mem={n_mem})")
    if dk > MAX_DK or dk % 16:
        raise ValueError(f"kernel takes a head width that is a multiple of 16 "
                         f"up to {MAX_DK} (got {dk})")
    if d_model % STRIP or dp % STRIP or ffn % STRIP:
        raise ValueError(f"kernel needs d_model, padded d_pose and the FF width "
                         f"to be multiples of {STRIP}")
    nbytes, fc, half = smem_plan(t, d_model, dp, ffn, f32, cluster)
    if nbytes > SMEM_LIMIT or fc % STRIP or ffn % fc:
        raise ValueError(f"kernel's shared-memory plan needs {nbytes} bytes "
                         f"> {SMEM_LIMIT} (T={t}, D={d_model})")
    return fc, half


_LIB = None
N_PTRS, N_DIMS = 35, 16


def _library():
    global _LIB
    if _LIB is None:
        from .kernel_build import load_library

        _LIB = bind_library(load_library("fused_ddim"))
    return _LIB


def bind_library(lib):
    """Set the ctypes signatures of a built ``csrc/fused_ddim.cu``."""
    lib.fused_ddim_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    lib.fused_ddim_launch.restype = ctypes.c_int
    lib.fused_ddim_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.fused_ddim_smem_bytes.restype = ctypes.c_int
    lib.fused_ddim_scratch_elems.argtypes = [ctypes.c_int] * 4
    lib.fused_ddim_scratch_elems.restype = ctypes.c_longlong
    lib.fused_ddim_max_clusters.argtypes = [ctypes.c_int] * 3
    lib.fused_ddim_max_clusters.restype = ctypes.c_int
    lib.fused_ddim_cluster_size.argtypes = [ctypes.c_int] * 7
    lib.fused_ddim_cluster_size.restype = ctypes.c_int
    if hasattr(lib, "fused_ddim_attention_shared"):   # older sources lack it
        lib.fused_ddim_attention_shared.argtypes = [ctypes.c_int] * 6
        lib.fused_ddim_attention_shared.restype = ctypes.c_int
    return lib


_MAX_CLUSTERS: dict = {}


def _current(dev: torch.device):
    """``dev`` as the current CUDA device for the block (nothing for the
    CPU tensors of the wrapper's tests)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def max_clusters(lib, c: int, smem: int, device, f32: bool = False) -> int:
    """Clusters of c blocks with ``smem`` bytes each that the card runs at
    once, for the bf16 or (``f32``) the float32 instantiation, asked of the
    built library once per (library, device, c, smem, instantiation);
    raises on a CUDA error."""
    key = (id(lib), str(device), c, smem, f32)
    if key not in _MAX_CLUSTERS:
        with _current(torch.device(device)):
            m = lib.fused_ddim_max_clusters(c, smem, int(f32))
        if m < 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed for "
                               f"clusters of {c}: CUDA error {-m}")
        _MAX_CLUSTERS[key] = m
    return _MAX_CLUSTERS[key]


#: product weights the kernel reads transposed, (N, K) row-major, so that a
#: B fragment is 32-bit loads along k
_TRANSPOSED = ("w_embx", "self_wqkv", "self_wo", "cross_wq", "cross_wkv",
               "cross_wo", "ff_w1", "ff_w2", "w_out")
#: the pack's tensors the kernel reads, in its pointer order (the step
#: MLP, emb_mem and pe_m0 enter through the token table)
_KERNEL_READS = ("w_embx", "b_embx", "pe_x", "self_wqkv", "self_bqkv",
                 "self_dconv", "self_dbias", "self_wo", "self_bo", "cross_wq",
                 "cross_bq", "cross_wkv", "cross_bkv", "cross_dq", "cross_dqb",
                 "cross_dkv", "cross_dkvb", "cross_wo", "cross_bo", "ff_w1",
                 "ff_b1", "ff_w2", "ff_b2", "w_out", "b_out")
_KERNEL_SIDE: dict = {}


def split3_bf16(x: torch.Tensor):
    """Three bfloat16 pieces of float32 ``x``: x1 = bf16(x), x2 = bf16(x -
    x1), x3 = bf16(x - x1 - x2), each rounded to nearest even; every
    difference is exact in float32, so x1 + x2 + x3 == x for finite x
    within bfloat16's exponent range.  The split the float32 instantiation
    makes of its activations in registers, and of an f32 pack's weights
    once (``kernel_weights``)."""
    x = x.float()
    x1 = x.to(torch.bfloat16)
    r = x - x1.float()
    x2 = r.to(torch.bfloat16)
    return x1, x2, (r - x2.float()).to(torch.bfloat16)


def _interleave(planes) -> torch.Tensor:
    """(..., N, K) planes -> (..., N, K/16, P, 16) as (..., N, P K): a
    16-deep k-step of a row holds the P planes side by side."""
    *lead, k = planes[0].shape
    tiles = [w.reshape(*lead, k // 16, 16) for w in planes]
    return torch.stack(tiles, dim=-2).reshape(*lead, len(planes) * k).contiguous()


def kernel_weights(packed: PackedDenoiser, compute_dtype=torch.bfloat16) -> dict:
    """The pack's tensors as the kernel reads them, made once per pack and
    kept for as long as the pack lives: the product weights transposed,
    (N, K) row-major (~9 MB at the flagship in bf16), everything else as
    the pack holds it.  Both instantiations read a bf16 pack's tensors, the
    same ones (no float32 copy).  The float32 instantiation reads an f32
    pack's product weights as their three bf16 pieces (``split3_bf16``),
    interleaved per 16 k (``_interleave``: 25.6 MB at the flagship).  The
    entry is keyed on the pack's ``w_embx`` tensor and dropped when that
    tensor is freed, so a caller that drops its cached pack
    (``Generator.update_variables``) drops these too."""
    planes = packed.w_embx.dtype == torch.float32
    if planes and compute_dtype != torch.float32:
        raise ValueError("the bf16 instantiation reads a bf16 pack only")
    key = id(packed.w_embx)
    hit = _KERNEL_SIDE.get(key)
    if hit is None:
        hit = {}
        for name in _KERNEL_READS:
            w = getattr(packed, name)
            if name in _TRANSPOSED:
                w = w.transpose(-1, -2)
                w = _interleave(split3_bf16(w)) if planes else w.contiguous()
            hit[name] = w
        _KERNEL_SIDE[key] = hit
        weakref.finalize(packed.w_embx, _KERNEL_SIDE.pop, key, None)
    return hit


def _fused_ddim_cuda(packed, x_T, mem_rows, tmap, coefs, blend_a, blend_b,
                     n_layers, heads, num_steps, compute_dtype,
                     stochastic=False, seed=0, x_add=None, clip_base=0, *,
                     cluster=None):
    """Launch the kernel.  ``cluster`` forces the blocks per clip (tests
    and ``chip_smoke.py``); by default ``cluster_plan`` picks it.  The
    whole call is the ``fused/launch`` span."""
    global launches, last_cluster, last_plan
    with span("fused/launch"):
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("the CUDA kernel computes with bfloat16 or float32 "
                             f"operands (got compute_dtype={compute_dtype})")
        f32 = compute_dtype == torch.float32
        dev = x_T.device
        # float32 compute takes a bf16 or an f32 pack, bfloat16 compute a bf16
        # one only (the JAX package never builds bf16 compute on f32 weights)
        wd = packed.w_embx.dtype if f32 else torch.bfloat16
        for name, w in packed._asdict().items():
            want = torch.float32 if name in ("pe_x", "pe_m0", "b_out") else wd
            if w.device != dev or w.dtype != want or not w.is_contiguous():
                raise ValueError(f"packed.{name} must be a contiguous {want} "
                                 f"tensor on {dev} for compute_dtype "
                                 f"{compute_dtype} (got {w.dtype} on {w.device})")
        if wd not in (torch.bfloat16, torch.float32):
            raise ValueError(f"the pack's weights must be bfloat16 or float32, "
                             f"not {wd}")
        for name, a in (("x_T", x_T), ("mem_rows", mem_rows), ("blend_a", blend_a),
                        ("blend_b", blend_b), ("x_add", x_add)):
            if a is not None and (a.device != dev or a.dtype != torch.float32
                                  or not a.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous float32 tensor "
                                 f"on {dev}")
        # the plan fits at every cluster size or at none (the float32 layout
        # holds its attention operands in shared memory only where that fits)
        _kernel_plan(packed, x_T, mem_rows, heads, f32)
        n, t, dp = x_T.shape
        d_model = packed.w_emm.shape[0]
        lib = _library()
        ffn = packed.ff_w1.shape[2]
        if cluster is None:
            cluster = cluster_plan(n, heads, lambda c: max_clusters(
                lib, c, smem_plan(t, d_model, dp, ffn, f32, c)[0], dev, f32))
        elif cluster not in CLUSTER_SIZES or heads % cluster:
            raise ValueError(f"cluster must be one of {CLUSTER_SIZES} and divide "
                             f"heads ({heads}); got {cluster}")
        fc, half = _kernel_plan(packed, x_T, mem_rows, heads, f32, cluster)
        shared = f32 and attention_shared(t, d_model, dp, fc, half, cluster)
        # the memory rows and the token table are operands: in the compute dtype
        mem = mem_rows.to(compute_dtype)
        tok = (step_tokens(packed, tmap, compute_dtype).to(compute_dtype)
               .contiguous())
        # five columns for either sampler; DDIM leaves the last one unread
        coef5 = torch.zeros((num_steps, 5), dtype=torch.float32, device=dev)
        ncol = min(coefs.shape[1], 5)
        coef5[:, :ncol] = coefs[:, :ncol].to(dev, torch.float32)
        # a seed drawn on the card stays there: the kernel reads it from memory
        seed_t = torch.as_tensor(seed, dtype=torch.int64).reshape(1).to(dev)
        out = torch.empty_like(x_T)
        # zeroed: attention loads the pad rows of the last 16-row tile
        kv = torch.zeros((n, scratch_elems(mem.shape[1], d_model, n_layers,
                                           t if f32 and not shared else 0)),
                         dtype=compute_dtype, device=dev)
        kt = kernel_weights(packed, compute_dtype)
        tensors = [x_T, out, mem, tok, coef5, blend_a, blend_b, x_add, kv, seed_t,
                   *(kt[name] for name in _KERNEL_READS)]
        ptrs = (ctypes.c_void_p * N_PTRS)(
            *[None if a is None else a.data_ptr() for a in tensors])
        # the last two: float32 operands, and an f32 pack (its product weights
        # as three bf16 planes, its other tensors in float32)
        dims = (ctypes.c_int * N_DIMS)(n, t, mem.shape[1], d_model, dp,
                                       packed.ff_w1.shape[2], n_layers, heads,
                                       num_steps, fc, int(half),
                                       int(bool(stochastic)), cluster,
                                       int(clip_base), int(f32),
                                       int(wd == torch.float32))
        # the launch is asynchronous: the temporaries above (mem, tok, coef5,
        # seed_t, the scratch) may be freed on return because the caching
        # allocator only reuses their blocks for work queued after the kernel
        # on this same stream
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the launch goes to the tensors' device, whichever is current
        with _current(dev):
            rc = lib.fused_ddim_launch(ptrs, N_PTRS, dims, N_DIMS,
                                       ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"fused_ddim kernel launch failed (clusters of "
                               f"{cluster} blocks): CUDA error {rc}")
        launches += 1
        key = (compute_dtype, wd)
        launches_by_dtype[key] = launches_by_dtype.get(key, 0) + 1
        last_cluster = cluster
        last_plan = dict(cluster=cluster, ff_chunk=fc, half=half,
                         attention="shared memory" if shared else (
                             "the global scratch" if f32 else "every replica"))
        return out


def fused_ddim_sample(
    packed: PackedDenoiser,
    x_T: torch.Tensor,          # (N, T, Dp_pad) f32 initial noise, pose lanes padded
    mem_rows: torch.Tensor,     # (N, n_mem, D) f32; row 0 = token slot,
                                # rows 1.. = emb_mem(speech) + pe[1:]
    tmap: torch.Tensor,         # (S,) respaced -> original timestep
    coefs: torch.Tensor,        # (S, 4) ddim_coefficients, or (S, 5)
                                # ddpm_coefficients with stochastic
    blend_a: Optional[torch.Tensor],   # (N, T, Dp_pad) f32, or None with
    blend_b: Optional[torch.Tensor],   # blend_b: identity blend
    n_layers: int,
    heads: int,
    num_steps: int,
    compute_dtype=torch.bfloat16,
    stochastic: bool = False,
    seed=0,                     # int or one-element int64 tensor
    x_add: Optional[torch.Tensor] = None,   # (N, T, Dp_pad) f32
    clip_base: int = 0,         # the first clip's index in the noise stream
) -> torch.Tensor:
    """(N, T, Dp_pad) float32 x_0.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise.

    ``stochastic`` runs ancestral DDPM with the noise of ``fused_noise``
    drawn from ``seed``; ``x_add`` is a loop-invariant term added to the
    state before the input projection on every step (the inpaint model
    type's conditioning).  ``clip_base`` numbers the clips from
    ``clip_base`` in the noise stream: a shard holding clips [c0, c0 + N)
    of a batch passes c0 and draws that batch's noise for them."""
    if clip_base < 0:
        raise ValueError(f"clip_base must be >= 0, got {clip_base}")
    _check_args(packed, x_T, mem_rows, tmap, coefs, blend_a, blend_b,
                n_layers, heads, num_steps, stochastic, x_add)
    args = (packed, x_T, mem_rows, tmap, coefs, blend_a, blend_b, n_layers,
            heads, num_steps, compute_dtype, stochastic, seed, x_add,
            clip_base)
    if x_T.device.type == "cpu":
        return fused_ddim_sample_plain(*args)
    if x_T.device.type != "cuda":
        raise ValueError(f"fused_ddim_sample runs on cuda or cpu, not {x_T.device}")
    return _fused_ddim_cuda(*args)
