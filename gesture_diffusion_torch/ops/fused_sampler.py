"""Fused DDIM sampler: the whole reverse process of the oneway denoiser in
ONE CUDA kernel launch (``csrc/fused_ddim.cu``), plus its plain version.

Replaces the TPU kernel ``gesture_diffusion_tpu/ops/fused_sampler.py``
``fused_ddim_sample`` / ``_make_kernel`` (one ``pallas_call``), for its
identity-blend and x0-blend DDIM (eta=0) variants.

Per step (mirrors ``models/denoiser.py`` + ``models/decoders.py``):
  token = emb_mem(step_mlp(temb[tmap[s]])) + pe[0]       (memory row 0)
  mem   = [token ; precomputed emb_mem(speech)+pe[1:]]
  h     = emb_x(x) + pe[:T]
  L x { LN -> merged QKV -> 3-tap dconv -> attention -> out-proj;
        LN -> cross q + dconv, memory KV + dconv -> cross-attention;
        LN -> squared-ReLU FF }
  eps   = out_head(LN(h))
  identity blend:  x = (c2*c0) x + (c3 - c2*c1) eps
  x0 blend:        x0 = a + b*(c0 x - c1 eps);  eps = (c0 x - x0)/c1;
                   x = c2 x0 + c3 eps

Compute-dtype policy (both the kernel and ``fused_ddim_sample_plain``):
the operands of every product (projections, Q.K^T, P.V) are rounded to
``compute_dtype`` and accumulated in float32; everything else stays
float32 — the residual stream h, LayerNorm, softmax, biases, the dconv,
and the state x / eps.  The kernel takes bfloat16 only (Hopper tensor
cores); the plain version also takes float32, which the CPU tests use
against the JAX kernel in float32.

The timestep token depends on the step, not the clip, so the wrapper
precomputes an (S, D) token table with plain torch ops before the launch
(``step_tokens``); the speech memory rows are precomputed by the caller.

What bounds the kernel on an H100, and what the design does about it:
the TPU kept the ~8.7 MB of bf16 weights resident in its 16 MB VMEM for
all steps.  No SM holds that (227 KB of shared memory), so each thread
block (one per clip) re-reads every weight from L2 on every step, and
stays bound by L2 bandwidth: batch 1 uses 1 of 132 SMs, batch 64 streams
~64 x 8.7 MB per step out of L2.  The design keeps everything a clip
produces (h, the operands, q/k/v, FF hidden) in shared memory so that
the weight stream is the only traffic; later work (weights sharded over
SMs, clips sharing a block, wgmma/TMA) attacks the stream itself.
``bound_ms`` in ``chip_smoke.py`` gives the least time for the work.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.attention import sinusoidal_position_encoding
from ..models.decoders import LN_EPS
from ..models.denoiser import timestep_freqs

# kernel limits (csrc/fused_ddim.cu): one block of NWARPS warps per clip,
# epilogue strips of 32 columns, at most 4 row tiles of 16 per side
NWARPS = 8
STRIP = 32
MAX_ROWS = 64
MAX_DK = 64
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block can use

#: launches of the CUDA kernel (never of the plain version); callers that
#: want a per-run count set it to 0 first
launches = 0


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
                            num_steps: int, compute_dtype=torch.bfloat16):
    """The fused sampler's function in plain torch ops on the packed
    weights, with the kernel's arguments and compute-dtype policy.  The
    CPU path of ``fused_ddim_sample`` and the card's yardstick for the
    kernel; not the serving path when a card is present."""
    _check_args(packed, x_T, mem_rows, tmap, coefs, blend_a, blend_b,
                n_layers, heads, num_steps)
    p, cd = packed, compute_dtype
    d_model = p.w_emm.shape[0]
    tok = step_tokens(p, tmap, cd)
    # host copy of the coefficients; scalar products in float32, as the kernel's
    c = coefs[:, :4].detach().cpu().numpy().astype(np.float32)
    pe_x = p.pe_x[: x_T.shape[1]].float()
    mem = mem_rows.float().clone()
    x = x_T.float()
    for i in range(num_steps):
        s = num_steps - 1 - i
        mem[:, 0] = tok[s]
        h = _mm(x, p.w_embx, cd) + p.b_embx.float() + pe_x
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
        c0, c1, c2, c3 = c[s]
        if blend_a is None:
            x = float(c2 * c0) * x + float(c3 - c2 * c1) * eps
        else:
            x0 = blend_a + blend_b * (float(c0) * x - float(c1) * eps)
            eps = (float(c0) * x - x0) / float(c1)
            x = float(c2) * x0 + float(c3) * eps
    return x


def _check_args(packed, x_T, mem_rows, tmap, coefs, blend_a, blend_b,
                n_layers, heads, num_steps) -> None:
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


def _align128(b: int) -> int:
    return (b + 127) // 128 * 128


def smem_bytes(t: int, n_mem: int, d_model: int, dp_pad: int, ff_chunk: int) -> int:
    """Dynamic shared memory of one block; mirrors ``make_layout`` in
    ``csrc/fused_ddim.cu``."""
    mtx, mtm = -(-t // 16), -(-n_mem // 16)
    lda, ldm = max(d_model, dp_pad) + 8, d_model + 8
    big = max(t * (3 * d_model + 2) * 2,
              _align128(t * (d_model + 2) * 2) + n_mem * (2 * d_model + 2) * 2,
              16 * mtx * (ff_chunk + 8) * 2)
    return (_align128(t * dp_pad * 4) + _align128(t * d_model * 4)
            + _align128(16 * mtx * lda * 2) + _align128(16 * mtm * ldm * 2)
            + _align128(big) + _align128(NWARPS * 16 * max(mtx, mtm) * STRIP * 4))


def smem_plan(t: int, n_mem: int, d_model: int, dp_pad: int, ffn: int):
    """(bytes, FF chunk): halve the FF hidden chunk until a block fits."""
    fc = ffn
    while (smem_bytes(t, n_mem, d_model, dp_pad, fc) > SMEM_LIMIT
           and fc % (2 * STRIP) == 0):
        fc //= 2
    return smem_bytes(t, n_mem, d_model, dp_pad, fc), fc


def _kernel_plan(packed: PackedDenoiser, x_T, mem_rows, heads: int) -> int:
    """Raise on what the kernel does not take; return its FF chunk."""
    n, t, dp = x_T.shape
    n_mem, d_model = mem_rows.shape[1], packed.w_emm.shape[0]
    ffn, dk = packed.ff_w1.shape[2], d_model // heads
    if not (1 <= t <= MAX_ROWS and 2 <= n_mem <= MAX_ROWS):
        raise ValueError(f"kernel takes windows and memories of at most "
                         f"{MAX_ROWS} rows (got T={t}, n_mem={n_mem})")
    if dk > MAX_DK or dk % 2:
        raise ValueError(f"kernel takes an even head width <= {MAX_DK} (got {dk})")
    if d_model % STRIP or dp % STRIP or ffn % STRIP:
        raise ValueError(f"kernel needs d_model, padded d_pose and the FF width "
                         f"to be multiples of {STRIP}")
    nbytes, fc = smem_plan(t, n_mem, d_model, dp, ffn)
    if nbytes > SMEM_LIMIT or fc % STRIP or ffn % fc:
        raise ValueError(f"kernel's shared-memory plan needs {nbytes} bytes "
                         f"> {SMEM_LIMIT} (T={t}, n_mem={n_mem}, D={d_model})")
    return fc


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from .kernel_build import load_library

        lib = load_library("fused_ddim")
        lib.fused_ddim_launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
        lib.fused_ddim_launch.restype = ctypes.c_int
        lib.fused_ddim_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.fused_ddim_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _transposed(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(-1, -2).contiguous()


def _fused_ddim_cuda(packed, x_T, mem_rows, tmap, coefs, blend_a, blend_b,
                     n_layers, heads, num_steps, compute_dtype):
    global launches
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes with bfloat16 operands only "
                         f"(got compute_dtype={compute_dtype})")
    dev = x_T.device
    for name, w in packed._asdict().items():
        want = torch.float32 if name in ("pe_x", "pe_m0", "b_out") else torch.bfloat16
        if w.device != dev or w.dtype != want or not w.is_contiguous():
            raise ValueError(f"packed.{name} must be a contiguous {want} tensor "
                             f"on {dev} (got {w.dtype} on {w.device})")
    for name, a in (("x_T", x_T), ("mem_rows", mem_rows), ("blend_a", blend_a),
                    ("blend_b", blend_b)):
        if a is not None and (a.device != dev or a.dtype != torch.float32
                              or not a.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")
    fc = _kernel_plan(packed, x_T, mem_rows, heads)
    n, t, dp = x_T.shape
    mem = mem_rows.to(torch.bfloat16)
    tok = step_tokens(packed, tmap, compute_dtype).to(torch.bfloat16).contiguous()
    coef4 = coefs[:, :4].to(dev, torch.float32).contiguous()
    out = torch.empty_like(x_T)
    p = packed
    # the kernel reads product weights transposed, (N, K) row-major, so its
    # B fragments are 32-bit loads along k; ~9 MB copied per call
    kt = _transposed
    tensors = [x_T, out, mem, tok, coef4, blend_a, blend_b,
               kt(p.w_embx), p.b_embx, p.pe_x,
               kt(p.self_wqkv), p.self_bqkv, p.self_dconv, p.self_dbias,
               kt(p.self_wo), p.self_bo,
               kt(p.cross_wq), p.cross_bq, kt(p.cross_wkv), p.cross_bkv,
               p.cross_dq, p.cross_dqb, p.cross_dkv, p.cross_dkvb,
               kt(p.cross_wo), p.cross_bo,
               kt(p.ff_w1), p.ff_b1, kt(p.ff_w2), p.ff_b2, kt(p.w_out), p.b_out]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if a is None else a.data_ptr() for a in tensors])
    dims = (ctypes.c_int * 10)(n, t, mem.shape[1], p.w_emm.shape[0], dp,
                               p.ff_w1.shape[2], n_layers, heads, num_steps, fc)
    # the launch is asynchronous: the temporaries above (mem, tok, coef4,
    # the transposed weights) may be freed on return because the caching
    # allocator only reuses their blocks for work queued after the kernel
    # on this same stream
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().fused_ddim_launch(ptrs, len(tensors), dims, len(dims),
                                      ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_ddim kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def fused_ddim_sample(
    packed: PackedDenoiser,
    x_T: torch.Tensor,          # (N, T, Dp_pad) f32 initial noise, pose lanes padded
    mem_rows: torch.Tensor,     # (N, n_mem, D) f32; row 0 = token slot,
                                # rows 1.. = emb_mem(speech) + pe[1:]
    tmap: torch.Tensor,         # (S,) respaced -> original timestep
    coefs: torch.Tensor,        # (S, 4) f32 ddim_coefficients
    blend_a: Optional[torch.Tensor],   # (N, T, Dp_pad) f32, or None with
    blend_b: Optional[torch.Tensor],   # blend_b: identity blend
    n_layers: int,
    heads: int,
    num_steps: int,
    compute_dtype=torch.bfloat16,
    stochastic: bool = False,
    x_add: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(N, T, Dp_pad) float32 x_0.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if stochastic:
        raise NotImplementedError(
            "stochastic DDPM in the fused sampler is not ported yet "
            "(ROADMAP.md, queue 2: stochastic DDPM with a Philox generator)")
    if x_add is not None:
        raise NotImplementedError(
            "the inpaint x_add branch is not ported yet "
            "(ROADMAP.md, queue 2: inpaint x_add)")
    _check_args(packed, x_T, mem_rows, tmap, coefs, blend_a, blend_b,
                n_layers, heads, num_steps)
    if x_T.device.type == "cpu":
        return fused_ddim_sample_plain(packed, x_T, mem_rows, tmap, coefs,
                                       blend_a, blend_b, n_layers, heads,
                                       num_steps, compute_dtype)
    if x_T.device.type != "cuda":
        raise ValueError(f"fused_ddim_sample runs on cuda or cpu, not {x_T.device}")
    return _fused_ddim_cuda(packed, x_T, mem_rows, tmap, coefs, blend_a,
                            blend_b, n_layers, heads, num_steps, compute_dtype)
