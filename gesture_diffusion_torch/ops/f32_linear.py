"""Float32-accurate linear layers on Hopper's tensor cores: ``y = x w^T + b``
as three TF32 products with float32 sums (``csrc/f32x3_gemm.cu``).

TF32 keeps 10 mantissa bits.  Each operand is split as ``a = hi + lo``,
``hi = tf32(a)`` and ``lo = tf32(a - hi)``, both rounded to nearest, ties
to even (``tf32_round``); then ``y = lo_x hi_w^T + hi_x lo_w^T + hi_x
hi_w^T + b`` with float32 sums, which keeps float32's accuracy where one
TF32 product keeps about three decimal digits.  The weight's planes are
made once, into a (2N, K) pack (``pack_weight``: hi rows above lo rows);
x is split inside the kernel as it is read.

``F32x3Linear`` is an ``nn.Linear`` (same parameters and state dict) whose
forward takes this route: a CPU tensor goes to ``f32x3_linear_plain``, the
same arithmetic in torch; a CUDA float32 tensor launches the kernel on a
pack cached beside the module, or raises.  Nothing falls back.
``F32x3Group`` runs several of them on one input as one launch.  A pack
is rebuilt when a weight or bias changes and dropped by ``drop_packs``
(``Generator.update_variables`` calls it).  The gradient is the float32
one of ``x w^T + b`` (the rounding is piecewise constant; its straight-
through gradient is the identity), computed by plain products.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn as nn

#: launches of the CUDA kernel (never of the plain version); callers that
#: want a per-run count set it to 0 first
launches = 0
#: tile widths the kernel is built for (columns a block)
TILE_N = (64, 128, 160, 192)
TILE_M = 128
TILE_COST = 220           # a block's fixed cost a k-tile, in columns (tile_n)

_LIB = None


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties to even,
    on the bits; inf and NaN unchanged, a carry past the largest finite
    value gives inf.  The kernel's ``tf32_rne``."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, not {x.dtype}")
    u = x.contiguous().view(torch.int32)
    r = (u + 0xFFF + ((u >> 13) & 1)) & -0x2000
    special = (u & 0x7F800000) == 0x7F800000
    return torch.where(special, u, r).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); x - hi is exact."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """The (2N, K) float32 pack of an (N, K) weight: hi rows above lo rows,
    on the weight's device."""
    hi, lo = split_tf32(weight.detach().float())
    return torch.cat([hi, lo]).contiguous()


def f32x3_linear_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias=None) -> torch.Tensor:
    """The kernel's arithmetic in torch: lo_x hi_w + hi_x lo_w + hi_x hi_w,
    float32 sums, then the bias; x (..., K) float32, weight (N, K)."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(weight)
    y = xl @ wh.T + xh @ wl.T + xh @ wh.T
    return y if bias is None else y + bias


@functools.lru_cache(maxsize=None)
def tile_n(m: int, n: int, sms: int) -> int:
    """The kernel's tile width for an (m, ., n) product on a card of
    ``sms`` streaming multiprocessors: the least waves of blocks over the
    SMs times a block's time, which goes as the width plus a fixed cost of
    about 220 columns' worth a k-tile (the chain of dependent wgmmas, the
    split, the promotion; fitted to the H100 SXM's times at 1648 rows,
    tools/f32x3_gemm_compare.py)."""
    def cost(bn):
        tiles = -(-m // TILE_M) * -(-n // bn)
        return -(-tiles // sms) * (bn + TILE_COST), -bn
    return min(TILE_N, key=cost)


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _library():
    global _LIB
    if _LIB is None:
        from .kernel_build import load_library

        lib = load_library("f32x3_gemm")
        lib.f32x3_gemm_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.f32x3_gemm_launch.restype = ctypes.c_int
        lib.f32x3_gemm_error.argtypes = [ctypes.c_int]
        lib.f32x3_gemm_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def f32x3_gemm(x: torch.Tensor, pack: torch.Tensor, bias=None, *,
               bn=None) -> torch.Tensor:
    """The kernel, the one launcher: x (..., K) against a (2N, K)
    ``pack_weight`` pack, plus ``bias`` (N,), into a new (..., N) tensor,
    all float32, contiguous and on one card; ``bn`` forces a tile width
    (else ``tile_n``).  Raises on a tensor the kernel does not take and on
    a launch error."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"f32x3_gemm: x is on {x.device}, not the card")
    for name, t in (("x", x), ("pack", pack), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"f32x3_gemm: {name} is on {t.device}, not the "
                             f"card x is on ({x.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"f32x3_gemm: {name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"f32x3_gemm: {name} is not contiguous")
    k = x.shape[-1] if x.dim() else -1
    if pack.dim() != 2 or pack.shape[0] % 2 or pack.shape[1] != k:
        raise ValueError(f"f32x3_gemm: x {tuple(x.shape)} and pack "
                         f"{tuple(pack.shape)} are not (..., K) and (2N, K)")
    n = pack.shape[0] // 2
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"f32x3_gemm: bias {tuple(bias.shape)} is not ({n},)")
    if k % 4 or n % 2:
        raise ValueError(f"f32x3_gemm: K {k} must be a multiple of 4 (16-byte "
                         f"rows for TMA) and N {n} even")
    y = x.new_empty((*x.shape[:-1], n))
    m = y.numel() // n
    if m == 0:
        return y
    lib = _library()
    dev = x.get_device()
    args = (x.data_ptr(), pack.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), m, n, k,
            tile_n(m, n, _sms(dev)) if bn is None else bn,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev == torch.cuda.current_device():
        err = lib.f32x3_gemm_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.f32x3_gemm_launch(*args)
    if err:
        raise RuntimeError(f"f32x3_gemm launch failed ({err}): "
                           f"{lib.f32x3_gemm_error(err).decode()}")
    launches += 1
    return y


class _F32x3(torch.autograd.Function):
    """The product with the float32 gradient of ``x w^T + b``."""

    @staticmethod
    def forward(ctx, x, weight, bias, pack):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        if pack is None:
            return f32x3_linear_plain(x, weight, bias)
        return f32x3_gemm(x.contiguous(), pack, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        gx = g @ weight
        gw = g.reshape(-1, g.shape[-1]).T @ x.reshape(-1, x.shape[-1])
        gb = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb, None


class _Packs:
    """The stacked pack (every hi plane above every lo plane) and the joined
    bias of some ``F32x3Linear``s of one input, remade when a weight or a
    bias changed; ``drop`` frees them."""

    def __init__(self):
        self.drop()

    def drop(self) -> None:
        self.pack = self.bias = self._key = None

    def of(self, linears):
        key = tuple((p.data_ptr(), p._version) for lin in linears
                    for p in (lin.weight, lin.bias) if p is not None)
        if self._key != key:
            self.drop()
            planes = [split_tf32(lin.weight.detach()) for lin in linears]
            self.pack = torch.cat([hi for hi, _ in planes] + [lo for _, lo in planes])
            if linears[0].bias is not None:
                self.bias = torch.cat([lin.bias.detach() for lin in linears])
            self._key = key
        return self.pack, self.bias


def _on_card(x: torch.Tensor, packs: _Packs, linears) -> torch.Tensor:
    """The launch over ``linears`` for a CUDA float32 x, no gradient wanted."""
    pack, bias = packs.of(linears)
    return f32x3_gemm(x if x.is_contiguous() else x.contiguous(), pack, bias)


def _wants_grad(x: torch.Tensor, linears) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(
        lin.weight.requires_grad for lin in linears))


class F32x3Linear(nn.Linear):
    """``nn.Linear`` in float32 through the split-TF32 product."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias)
        self.packs = _Packs()

    def pack(self) -> torch.Tensor:
        """The weight's (2N, K) pack, made when the weight changed."""
        return self.packs.of((self,))[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if x.dtype != torch.float32 or w.dtype != torch.float32:
            raise TypeError(f"F32x3Linear computes in float32: input "
                            f"{x.dtype}, weight {w.dtype}")
        if not x.is_cuda:
            return _F32x3.apply(x, w, self.bias, None)
        if _wants_grad(x, (self,)):
            return _F32x3.apply(x, w, self.bias, self.pack())
        return _on_card(x, self.packs, (self,))


class F32x3Group:
    """``F32x3Linear``s of one input as one launch on the card: their
    weights' planes stacked into one pack and their biases side by side,
    the outputs side by side along the last axis.  An output element is
    computed as its own Linear computes it: the same k-steps in the same
    order.  On the CPU, and where a gradient is wanted, each Linear runs on
    its own and the outputs are joined.  Not an ``nn.Module``: it holds its
    Linears, whose owner registers them."""

    def __init__(self, *linears: F32x3Linear):
        if len({lin.in_features for lin in linears}) != 1 or \
                len({lin.bias is None for lin in linears}) != 1:
            raise ValueError("F32x3Group: the Linears must share in_features "
                             "and all have a bias or none")
        self.linears = linears
        self.packs = _Packs()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda or _wants_grad(x, self.linears):
            return torch.cat([lin(x) for lin in self.linears], dim=-1)
        if x.dtype != torch.float32:
            raise TypeError(f"F32x3Group computes in float32, not {x.dtype}")
        return _on_card(x, self.packs, self.linears)


def drop_packs(module: nn.Module) -> None:
    """Free the packs of every ``F32x3Linear`` and ``F32x3Group`` in
    ``module``."""
    for m in module.modules():
        for v in vars(m).values():
            if isinstance(v, F32x3Group):
                v = v.packs
            if isinstance(v, _Packs):
                v.drop()
