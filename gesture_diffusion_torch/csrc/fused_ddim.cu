// Fused diffusion sampler for Hopper (sm_90a): the whole reverse process of
// the oneway cross-attention denoiser in one launch.
//
// Replaces the TPU kernel gesture_diffusion_tpu/ops/fused_sampler.py,
// fused_ddim_sample / _make_kernel (its pallas_call), in every variant:
//   * DDIM (eta=0) with the identity blend or the x0 blend;
//   * ancestral DDPM (stochastic), with either blend, its noise drawn in
//     the update epilogue from Philox4x32-10 and Box-Muller;
//   * x_add, the inpaint model type's loop-invariant conditioning, added to
//     the state where it is rounded to the operand of emb_x;
//   * windows and memories of any length up to 64 and 128 rows;
//   * compute_dtype bfloat16 (bf16 weights) or float32 (bf16 or f32
//     weights): the kernel is a template on the operand type T and the
//     pack's weight type W, instantiated for bf16 on bf16, float on bf16
//     and float on f32, sharing the Philox, cluster, DSMEM and update
//     code.
// It computes that kernel's function, not its block structure: the TPU's
// clip packing and 8-row padding are not needed here.  Rows outside
// [0, T) and [0, n_mem) give zero to the dconv and nothing to a softmax.
//
// Design: one clip per thread-block cluster of C blocks (C = 1, 2, 4 or 8,
// chosen by the host: the largest that divides the heads and lets all
// clusters of the batch run in one wave), 8 warps per block, a loop over
// the S steps inside the cluster.  What a clip produces within a step lives
// in shared memory, and every block of the cluster holds the same layout: a
// full replica of the residual stream h (f32) and of the bf16 operand rows
// of every product, q/k/v of self-attention, the cross queries, and the FF
// hidden in chunks.  Products run on the tensor cores through nvcuda::wmma
// (bf16 operands, f32 accumulation); the A operand (activations) comes from
// the block's own shared memory and the B operand (weights) straight from
// global memory, one k-step ahead.  The wrapper hands the weights over
// transposed, (N, K) row-major, so a B fragment is loaded as 32-bit pairs
// along k.
//
// Work division (matmul): a product is cut into units of one 32-column
// strip, all row tiles and one of kp parts of K, spread over the cluster's
// 8C warps; kp is chosen per product so that the longest chain of k-steps
// any warp runs is short (kplan: at C = 8 and the flagship, 34 k-steps per
// layer instead of 256).  The kp parts of a strip run in neighbouring warps
// of one block and stage their partial sums side by side; after a block
// barrier each of them runs the strip's epilogue on its share of the rows,
// reading the sum of the parts in a fixed order: bias, the 3-tap depthwise
// conv over time, squared ReLU, the residual add, or the sampler's update.
// Each output element is computed by exactly one warp, which writes it into
// every block's replica through distributed shared memory (or, for q/k/v
// and the cross queries, into the block that owns the element's head).  A
// cluster barrier separates a phase from the next one that reads what
// another block wrote.  Every replica of h is bitwise the same, so no
// block needs another's LayerNorm: in the bf16 instantiation a row is
// normalised by one warp of the cluster, from its own block's replica,
// and copied like an output; in the float one every block normalises
// all rows from its own replica into its own operand rows (row_norm),
// so that no normalised row is copied or waited for: a block barrier,
// not a cluster one, follows.  Attention runs on the
// tensor cores too, block r taking heads [r H/C, (r+1) H/C) and one warp
// per (head, 16-query pass): S = Q K^T into the warp's staging area, an
// f32 softmax over each row there, P rounded to bf16 in place, then
// O = P V.
//
// The float32 instantiation (T = float).  Hopper's tensor cores have no
// full-f32 product, so a projection runs as three bf16 pieces of the f32
// activation against the exact bf16 weight: a = a1 + a2 + a3 with
// a1 = bf16(a), a2 = bf16(a - a1), a3 = bf16(a - a1 - a2); each difference
// is exact in f32, so the pieces carry all 24 bits of a, and each piece
// times a bf16 weight is exact in the f32 accumulator.  A 16-deep k-step
// takes three bf16 MMAs, summed small first (a3 w, a2 w, a1 w).  On an f32
// pack the wrapper splits every weight once, the same way, into three bf16
// planes (w = w1 + w2 + w3, exact), and a k-step takes six MMAs:
// a3 w1 + a2 w2 + a1 w3, then a2 w1 + a1 w2, then a1 w1; the dropped terms
// are below 2^-26 of |a||w|.  Two bf16 planes would carry only 16 bits of
// an f32 weight.
// Route: mma.sync.m16n8k16 (bf16, f32 accumulation) through inline PTX.
// The PTX ISA documents which fragment elements a lane holds (wmma's
// layout is opaque, and one type's fragment cannot become another's), so a
// lane loads its A elements from the f32 rows in shared memory and splits
// them in registers, and loads its B elements from the (N, K) weights in
// global memory as 64-bit runs of four neighbouring k of one row: inside a
// 16-deep step both sides use the same order of k (lane t's k 4t..4t+3 are
// the MMA's k 2t, 2t+1, 2t+8, 2t+9).  The next k-step's B fragments load
// while this k-step's MMAs run, as in the bf16 instantiation.  Chosen over
// epilogues that write the activations as three bf16 planes (6 bytes an
// element against 4: the A rows alone would take 76 KB at T 40, and the
// block would not fit) and over split TF32 (on a bf16 pack four TF32 MMAs
// a 16-deep step, each as slow as a bf16 m16n8k16 of twice its depth,
// against three bf16 ones here; on an f32 pack both take the time of six,
// and TF32 hi/lo planes take 8 bytes an element against the bf16 planes'
// 6).  The float instantiation reads a bf16 pack's transposed weights, the
// very tensors the bf16 one reads (9.0 MB at the flagship); an f32 pack's
// three planes are interleaved per 16 k ((N, K/16, 3, 16): one plane's 16
// k of a row are one 32-byte sector), 25.6 MB.
// Attention's products have activations on both sides; they stay split
// TF32 on the tensor cores (wmma m16n16k8, a = hi + lo with hi = tf32(a)
// and lo = tf32(a - hi) on both sides, lo hi + hi lo + hi hi summed small
// first, about 2^-22 of |a||b|).  Operand rows of 4 bytes do not fit the
// bf16 layout, whose every block holds all heads' q/k/v (149 KB at the
// flagship).  Here a block holds its own heads' columns only (block r owns
// heads [r H/C, (r+1) H/C)): its q/k/v, then its cross queries beside the
// 16-row memory tile, in the area the FF hidden chunk uses, wherever that
// layout fits (make_layout; at the flagship C = 2, 4 and 8).  The epilogue
// that computes a q/k/v column stores it straight into its owner's shared
// memory.  Where it does not fit (C = 1 at the flagship), the attention
// operands live in a per-clip area of the global scratch (it stays in L2),
// written once by the warp that computes them and read by every block of
// the cluster after a cluster barrier.  A warp's f32 staging holds the
// window's rows only (8-row halves of a row tile, at least one tile), not
// whole row tiles, which leaves room for an FF hidden chunk of 512 with
// full strips at the flagship: two chunks a layer, where bf16 takes all
// 1024 at once (ops/fused_sampler.py::smem_plan).  The softmax
// probabilities P stay f32 into P V; the memory rows, the token table, the
// hoisted memory K/V and the 16-row memory tile are f32.
//
// Memory design (the memory K and V are hoisted out of the step loop): only
// memory rows 0 and 1 change from step to step: row 0 is the timestep
// token, and row 1 sees it through the dconv.  So before the step loop the
// block computes every layer's dconv'd memory K and V once, into a per-clip
// scratch in global memory that the wrapper allocates (L x n_mem x 2D
// bf16; it stays in L2), and per step it recomputes rows 0 and 1 only, from
// a 16-row operand tile [token; row 1; row 2].  Cross-attention loads its K
// and V fragments straight from that scratch (row-major, K beside V).  The
// memory rows therefore take no shared memory, whatever n_mem is, and a
// 16-query pass holds the scores of all (up to 128) keys at once (no running
// softmax).  The hoisted values are the ones the in-loop product gave: same
// operands, same f32 dconv, same rounding to bf16.  Blocks of a cluster
// write the scratch and the state x for each other, so a cluster barrier
// orders those global writes before the reads; the wrapper hands the
// scratch over zeroed, so its pad rows are finite.  The state x lives in
// the output buffer (global, f32), read and written once per step.  Where a
// window is too long for full-strip staging (T > 48 at d_model 256), a warp
// stages its strip in two 16-column halves.
//
// Bound on an H100: the ~8.7 MB of bf16 weights (flagship; 25.6 MB of bf16
// planes from an f32 pack) fit in no SM, so every step re-reads all of
// them from L2; the kernel is bound by latency:
// the chains of dependent k-steps of the matmuls on few rows, then the
// softmax and staging of the attention passes.  The cluster spreads one
// clip's weight stream and its chains over C SMs; K-splitting keeps each
// weight fragment loaded once per step and clip, as with one block.
// Weights through an asynchronous ring in shared memory (TMA, wgmma) and
// several clips per block are later work.
//
// Numerics (shared with fused_ddim_sample_plain): product operands are
// rounded to the compute dtype (bf16, or not at all in the float32
// instantiation, whose products keep float32 accuracy as above), everything else
// is f32: h, LayerNorm (normalise only, two passes, eps 1e-6; its affine
// is folded into the next projection at pack time), softmax, biases, dconv, the
// state x, eps and the noise z.  Accumulation is f32 in both.
//
// Noise (stochastic): z for element (clip, row r, lane n) of step s is
// Box-Muller of two words of Philox4x32-10 with key = the 64-bit seed (low
// word, high word) and counter = ((r / 2) * Dp + n, s, clip, 0): words 0, 1
// serve the even row of the pair, words 2, 3 the odd one.  u = top 23 bits
// / 2^23, z = sqrt(-2 log(max(u1, 1e-12))) cos(2 pi u2).  clip is the
// cluster's index plus clip_base, so the noise does not depend on C, and a
// launch over clips [c0, c0 + n) of a larger batch (one shard of a batch
// split over devices) draws with clip_base = c0 what the whole batch's
// launch draws for them.
//
// The seed is read from device memory, so a caller that drew it on the
// card hands it over without a host round trip.
//
// C interface (ctypes): fused_ddim_launch(ptrs, 35, dims, 16, stream)
// returns the launch's error (cudaLaunchKernelEx with the cluster
// dimension; a refused launch is returned, never retried another way);
// fused_ddim_cluster_size gives the host's choice of C.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

#define NWARPS 8
#define NTHREADS (NWARPS * 32)
#define NT 2                 // 16-column tiles per warp strip
#define STRIP (16 * NT)      // columns per warp strip
#define MAXMT 4              // row tiles of 16: windows of at most 64 rows
#define MAXKC 4              // key chunks of 32: at most 128 memory rows
#define MAXDK 64             // head width: a multiple of 16 up to this
#define SMR 4                // softmax rows in flight per warp
#define SMEM_LIMIT 232448
#define LN_EPS 1e-6f
#define MAXC 8               // blocks per cluster: the portable limit
#define N_PTRS 35
#define N_DIMS 16

// The kernel's arguments; T is the operand type (bf16 or float): the
// memory rows, the token table and the scratch.  The product weights are
// bf16 in every instantiation (an f32 pack's as NP = 3 interleaved planes,
// header); the biases, dconv taps and other small tensors are the pack's
// weight type W.
template <class T, class W>
struct Params {
  const float* x_T;  float* out;
  const T* mem;   const T* tok;  const float* coefs;
  const float* blend_a;  const float* blend_b;  const float* x_add;
  T* kv;  const unsigned long long* seed;
  const bf16* w_embx;  const W* b_embx;  const float* pe_x;
  const bf16* self_wqkv;  const W* self_bqkv;  const W* self_dconv;
  const W* self_dbias; const bf16* self_wo;    const W* self_bo;
  const bf16* cross_wq;   const W* cross_bq;   const bf16* cross_wkv;
  const W* cross_bkv;  const W* cross_dq;   const W* cross_dqb;
  const W* cross_dkv;  const W* cross_dkvb; const bf16* cross_wo;
  const W* cross_bo;
  const bf16* ff_w1;  const W* ff_b1;  const bf16* ff_w2;  const W* ff_b2;
  const bf16* w_out;  const float* b_out;
  int n, t, nm, d, dp, f, layers, heads, steps, fc, half, stochastic, cluster;
  int clip_base;
};

// Shared-memory plan (bytes); mirrored by ops/fused_sampler.py::smem_bytes.
struct Layout {
  int h, za, big, ma, stage, total;    // byte offsets
  int lda, ldm, ldqkv, ldcq, ldf;      // row strides (elements)
  int mtx, sw, stage_warp;             // row tiles, staged columns, floats
  int srows;                           // rows a staging area holds
  int mch;                             // row tiles of a memory chunk
  int satt;                            // float: attention operands in shared memory
};

__host__ __device__ inline int align128(int b) { return (b + 127) & ~127; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// ob: bytes of an operand element, 2 (bf16) or 4 (float); c: blocks per
// cluster (the float layout holds a block's own heads, D / c columns)
__host__ __device__ inline Layout make_layout(int t, int d, int dp, int fc,
                                              int half, int ob, int c) {
  Layout L;
  L.mtx = (t + 15) / 16;
  L.sw = half ? STRIP / 2 : STRIP;
  L.lda = imax(d, dp) + 8;   // +8 keeps wmma row loads off one bank
  L.ldm = d + 8;
  L.ldqkv = 3 * d + 8;
  L.ldcq = d + 8;
  L.ldf = fc + 8;
  L.satt = 0;
  int off = 0;
  L.h = off;   off += align128(t * d * 4);
  L.za = off;  off += align128(16 * L.mtx * L.lda * ob);
  // per warp: its strip's f32 staging, or a 16-query attention pass; the
  // float layout stages only the window's rows, in 8-row halves of a row
  // tile (at least one tile: a memory chunk), which lets the FF chunk grow
  L.srows = ob == 2 ? 16 * L.mtx : imax((t + 7) & ~7, 16);
  L.stage_warp = imax(L.srows * L.sw, 16 * MAXDK);
  const int stage_bytes = align128(NWARPS * L.stage_warp * 4);
  int big;
  if (ob == 2) {
    // one area for: self q/k/v; cross q plus the 16-row memory tile; an FF
    // hidden chunk; a chunk of memory rows before the step loop
    // (whole row tiles: attention loads 16-row fragments)
    const int cq_bytes = align128(t * L.ldcq * 2);
    big = imax(imax(16 * L.mtx * L.ldqkv * 2, cq_bytes + 16 * L.ldm * 2),
               imax(16 * L.mtx * L.ldf * 2, 16 * L.mtx * L.ldm * 2));
    L.big = off;
    L.ma = off + cq_bytes;
  } else {
    // one area for: the 16-row memory tile, an FF hidden chunk, or a chunk
    // of as many memory row tiles as fit before the step loop; and, where
    // the block still fits, the block's own heads' q/k/v, then its cross
    // queries with the memory tile behind them (else the attention
    // operands live in the global scratch)
    const int hc = d / c, ldqkv = 3 * hc + 8, ldcq = hc + 8;
    const int cq_bytes = align128(t * ldcq * 4);
    const int rest = imax(16 * L.ldm * 4, 16 * L.mtx * L.ldf * 4);
    const int own = imax(rest, imax(16 * L.mtx * ldqkv * 4,
                                    cq_bytes + 16 * L.ldm * 4));
    L.satt = off + align128(own) + stage_bytes <= SMEM_LIMIT;
    big = L.satt ? own : rest;
    L.big = off;
    L.ma = off + (L.satt ? cq_bytes : 0);
    if (L.satt) {
      L.ldqkv = ldqkv;
      L.ldcq = ldcq;
    }
  }
  L.mch = imin(imin(L.mtx, big / (16 * L.ldm * ob)), L.srows / 16);
  off += align128(big);
  L.stage = off;
  off += stage_bytes;
  L.total = off;
  return L;
}

// The plan for clusters of c blocks (ops/fused_sampler.py::smem_plan):
// with full-strip staging first, then with half strips, halve the FF
// hidden chunk from ffn until a block fits; fc and half are set.
__host__ inline Layout plan_layout(int t, int d, int dp, int ffn, int ob,
                                   int c, int& fc, int& half) {
  Layout L;
  for (half = 0; half < 2; ++half) {
    fc = ffn;
    L = make_layout(t, d, dp, fc, half, ob, c);
    while (L.total > SMEM_LIMIT && fc % (2 * STRIP) == 0) {
      fc /= 2;
      L = make_layout(t, d, dp, fc, half, ob, c);
    }
    if (L.total <= SMEM_LIMIT) return L;
  }
  half = 1;
  return L;
}
// (end of the plan: the code from struct Layout to here also compiles as
// plain C++, which tests/test_torch_port_f32_split.py holds against the
// Python mirror)

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float f32(float v) { return v; }

// an f32 value as an operand of type T
template <class T> __device__ __forceinline__ T to_op(float v);
template <> __device__ __forceinline__ bf16 to_op<bf16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ float to_op<float>(float v) { return v; }

// The wmma fragments of each operand type: bf16 is m16n16k16 (the bf16
// instantiation's products and attention); float runs as TF32 m16n16k8
// (the float instantiation's attention).
template <class T> struct Frag;
template <> struct Frag<bf16> {
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> A;
  template <class LB>
  using B = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB>;
};
template <> struct Frag<float> {
  typedef wmma::fragment<wmma::accumulator, 16, 16, 8, float> Acc;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                         wmma::row_major> A;
  template <class LB>
  using B = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                           LB>;
};

// f32 values of a fragment -> their TF32 high parts, and the TF32 low parts
// (what the high parts leave) into lo
template <class F>
__device__ __forceinline__ void split_tf32(F& hi, F& lo) {
#pragma unroll
  for (int i = 0; i < hi.num_elements; ++i) {
    const float v = hi.x[i], h = wmma::__float_to_tf32(v);
    hi.x[i] = h;
    lo.x[i] = wmma::__float_to_tf32(v - h);
  }
}

// acc += A[16, kk] B[kk, 16]: A row-major (row stride lda), B of layout LB
// with row stride ldb, bstep elements from one k to the next.  bf16: one
// m16n16k16 MMA a k-step; float: the three split-TF32 MMAs (header).
template <class LB>
__device__ __forceinline__ void mma_tile(Frag<bf16>::Acc& acc, const bf16* a,
                                         int lda, const bf16* b, int ldb,
                                         int bstep, int kk) {
  for (int e = 0; e < kk; e += 16) {
    Frag<bf16>::A fa;
    Frag<bf16>::B<LB> fb;
    wmma::load_matrix_sync(fa, a + e, lda);
    wmma::load_matrix_sync(fb, b + (size_t)e * bstep, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

template <class LB>
__device__ __forceinline__ void mma_tile(Frag<float>::Acc& acc, const float* a,
                                         int lda, const float* b, int ldb,
                                         int bstep, int kk) {
  for (int e = 0; e < kk; e += 8) {
    Frag<float>::A ah, al;
    Frag<float>::B<LB> bh, bl;
    wmma::load_matrix_sync(ah, a + e, lda);
    wmma::load_matrix_sync(bh, b + (size_t)e * bstep, ldb);
    split_tf32(ah, al);
    split_tf32(bh, bl);
    wmma::mma_sync(acc, al, bh, acc);
    wmma::mma_sync(acc, ah, bl, acc);
    wmma::mma_sync(acc, ah, bh, acc);
  }
}

// d += a b on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
// accumulation.  a: four registers of bf16 pairs, (row g, k 2t..2t+1),
// (row g+8, k 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..); b: two, (k
// 2t..2t+1, column g), (k 2t+8.., column g); d: (row g, columns 2t, 2t+1),
// (row g+8, columns 2t, 2t+1); g = lane / 4, t = lane % 4 (PTX ISA).  Not
// volatile: the compiler may interleave independent MMAs and loads.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// two f32 values -> their three bf16 pieces as bf16 pairs (x in the low
// half): p1 = bf16(v), p2 = bf16(v - p1), p3 = bf16(v - p1 - p2), every
// difference exact in f32 (header)
__device__ __forceinline__ void split3(float x, float y, uint32_t& p1,
                                       uint32_t& p2, uint32_t& p3) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  float2 f = __bfloat1622float2(h);
  x -= f.x;
  y -= f.y;
  p1 = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(x, y);
  f = __bfloat1622float2(h);
  p2 = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(x - f.x, y - f.y);
  p3 = *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Philox4x32-10 (Salmon et al., Random123): four words from a counter and
// a key, no state.
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t w[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;  c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;  c3 = lo0;
    k0 += 0x9E3779B9u;   k1 += 0xBB67AE85u;
  }
  w[0] = c0;  w[1] = c1;  w[2] = c2;  w[3] = c3;
}

// one N(0, 1) draw from two words: Box-Muller, the cosine branch
__device__ __forceinline__ float box_muller(uint32_t a, uint32_t b) {
  const float u1 = __uint_as_float((a >> 9) | 0x3F800000u) - 1.0f;
  const float u2 = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
  const float r = sqrtf(-2.0f * logf(fmaxf(u1, 1e-12f)));
  return r * cosf(6.283185307179586f * u2);
}

// Cluster helpers.  csync: a barrier for what other blocks of the cluster
// wrote (shared or global memory: barrier.cluster's arrive has release and
// its wait acquire semantics); a block barrier when the cluster is one
// block.  share: after the lanes of a warp wrote rows [lo, hi) x columns
// [n0, n0 + cols) of `buf` (row stride ld) into their own block's replica,
// the warp copies them into the replicas of blocks [k0, k1), 16 bytes per
// lane and store (ld, n0 and cols are multiples of 8 bf16 or 4 floats, and
// every area is 128-byte aligned).
__device__ __forceinline__ void csync(int C) {
// Timing-breakdown hook (tools/fused_ddim_breakdown.py), off in real
// builds: SKIP_CSYNC keeps only the block barrier in the step loop, to
// price the cluster barriers (the first and last ones stay).
#ifdef FUSED_DDIM_SKIP_CSYNC
  C = 1;
#endif
  if (C > 1) cg::this_cluster().sync(); else __syncthreads();
}

template <class T>
__device__ __forceinline__ void share(T* buf, int ld, int n0, int cols, int lo,
                                      int hi, int k0, int k1) {
// Timing-breakdown hook: LOCAL_PUT writes the block's own replica only,
// to price the writes into the other blocks.
#ifdef FUSED_DDIM_LOCAL_PUT
  return;
#endif
  __syncwarp();
  cg::cluster_group cl = cg::this_cluster();
  const int self = (int)cl.block_rank(), lane = threadIdx.x & 31;
  const int per = 16 / (int)sizeof(T), vr = cols / per, nv = (hi - lo) * vr;
  for (int i = lane; i < nv; i += 32) {
    const int off = (lo + i / vr) * ld + n0 + (i % vr) * per;
    const int4 v = *reinterpret_cast<const int4*>(buf + off);
    for (int k = k0; k < k1; ++k)
      if (k != self)
        *reinterpret_cast<int4*>(cl.map_shared_rank(buf + off, k)) = v;
  }
}

// Rows [lo, hi) of `rows` that part q of kp sums and runs the epilogue on:
// an even count each, so that the update's noise pairs stay whole.
__device__ __forceinline__ void part_rows(int rows, int q, int kp, int& lo,
                                          int& hi) {
  const int rc = ((rows + kp - 1) / kp + 1) & ~1;
  lo = imin(q * rc, rows);
  hi = imin(lo + rc, rows);
}

// K parts of a product of `strips` 32-column strips and ks k-steps on W
// warps: the kp in 1, 2, 4, 8 (dividing ks) that makes the longest chain of
// k-steps of a warp, rounds * ks / kp, shortest, with a small charge for
// the reduction; ties go to the smaller kp.
__device__ __forceinline__ int kplan(int strips, int ks, int W) {
  int best = 1, cost = ((strips + W - 1) / W) * ks;
  for (int kp = 2; kp <= NWARPS && ks % kp == 0; kp *= 2) {
    const int c = ((strips * kp + W - 1) / W) * (ks / kp) + kp / 4;
    if (c < cost) {
      cost = c;
      best = kp;
    }
  }
  return best;
}

// The cluster as a product sees it: the block's staging areas (ws floats
// per warp, srows rows), the staging width sw, C blocks, this block's rank.
struct Ctx {
  float* stage0; int ws, sw, C, rank, srows;
};

// Timing-breakdown hooks (tools/fused_ddim_breakdown.py), off in real
// builds: SKIP_MMA drops the k-loops (the work division stays); FIXED_A /
// FIXED_B keep that operand's fragments at k-step 0, taking its loads' cost
// out of the loop.
#ifdef FUSED_DDIM_FIXED_A
#define KA(k) ((k) * 0)
#else
#define KA(k) (k)
#endif
#ifdef FUSED_DDIM_FIXED_B
#define KB(k) ((k) * 0)
#else
#define KB(k) (k)
#endif

// The float instantiation's k-loop of one unit (matmul): acc[m][j] += the
// A rows of row tile m (f32, shared, row stride lda, from a0) times the
// weights of the unit's 8-column tile j, over kl of K (header: three bf16
// pieces of A against the NP bf16 planes of W, mma.sync m16n8k16).  wt:
// the unit's first weight row, rows ldk * NP elements apart, a 16-deep
// k-step's NP planes side by side (16 elements each); lane (g, t) loads
// row g of each tile, k 4t..4t+3 of each plane, one k-step ahead.
template <int NP>
__device__ __forceinline__ void kloop_split(float (&acc)[MAXMT][4][4],
                                            const float* a0, int lda, int mt,
                                            const bf16* __restrict__ wt,
                                            int ldk, int kl) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bf16* wr = wt + (size_t)g * ldk * NP + 4 * t4;
  const size_t tile = (size_t)8 * ldk * NP;     // to the next 8-column tile
  uint2 b[4][NP], bn[4][NP];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int pl = 0; pl < NP; ++pl)
      b[j][pl] = *reinterpret_cast<const uint2*>(wr + j * tile + 16 * pl);
#pragma unroll 2
  for (int k0 = 0; k0 < kl; k0 += 16) {
    const int kn = k0 + 16 < kl ? k0 + 16 : k0;   // next k-step's weights
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int pl = 0; pl < NP; ++pl)
        bn[j][pl] = *reinterpret_cast<const uint2*>(
            wr + j * tile + (size_t)KB(kn) * NP + 16 * pl);
#pragma unroll
    for (int m = 0; m < MAXMT; ++m) {
      if (m < mt) {
        const float* ar = a0 + (size_t)(16 * m + g) * lda + KA(k0) + 4 * t4;
        const float4 lo = *reinterpret_cast<const float4*>(ar);
        const float4 hi = *reinterpret_cast<const float4*>(ar + 8 * lda);
        uint32_t a1[4], a2[4], a3[4];       // the three pieces
        split3(lo.x, lo.y, a1[0], a2[0], a3[0]);
        split3(hi.x, hi.y, a1[1], a2[1], a3[1]);
        split3(lo.z, lo.w, a1[2], a2[2], a3[2]);
        split3(hi.z, hi.w, a1[3], a2[3], a3[3]);
        // each term over the four tiles before the next term: an
        // accumulator's MMAs are dependent, the tiles' are not
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], a3, b[j][0]);
        if constexpr (NP == 3) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], a2, b[j][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], a1, b[j][2]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], a2, b[j][0]);
        if constexpr (NP == 3) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], a1, b[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], a1, b[j][0]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) b[j][pl] = bn[j][pl];
  }
}

// C[rows, N] = A[rows, K] (T, shared, row stride lda) x W[K, N], with W
// given transposed: Wt[N, K] (bf16, global, row stride ldk; NP planes,
// header).  Unit u = s * kp + q (strip s, K part q) goes to warp u mod 8C
// of the cluster, which accumulates all mt row tiles of the strip over its
// part of K and stores them to its staging area (f32, mt*16 rows, at most
// x.srows, of sw columns: the whole strip when sw == STRIP, else one
// 16-column half after the other).  With kp > 1 the strip's warps, after
// a block barrier, each sum a share of the rows of all parts in a fixed
// order into the first part's area, and after another run epi(stage, sw,
// first column, lane, q, kp) on that area for their share of the rows.
// N % STRIP == 0, K % 16 == 0.  bf16 operands: wmma m16n16k16; float:
// kloop_split.
template <class T, int NP, class Epi>
__device__ __forceinline__ void matmul(const Ctx& x, const T* A, int lda,
                                       int mt, const bf16* __restrict__ Wt,
                                       int ldk, int K, int N, const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = NWARPS * x.C, gw = x.rank * NWARPS + warp;
  const int strips = N / STRIP, kp = kplan(strips, K / 16, W);
  const int units = strips * kp, kd = K / kp;
  const int srows = imin(16 * mt, x.srows);    // rows staged
  int kl = kd;
#ifdef FUSED_DDIM_SKIP_MMA
  kl = 0;
#endif
  float* stage = x.stage0 + warp * x.ws;
  for (int base = 0; base < units; base += W) {
    const int u = base + gw;
    const bool on = u < units;
    const int s = u / kp, q = u % kp, n0 = s * STRIP;
    typename Frag<bf16>::Acc acc[MAXMT][NT];   // bf16
    float racc[MAXMT][4][4];                   // float: 8-column tiles
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int m = 0; m < MAXMT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[m][j], 0.0f);
    } else {
#pragma unroll
      for (int m = 0; m < MAXMT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) racc[m][j][e] = 0.0f;
    }
    if (on) {
      const bf16* wt = Wt + ((size_t)n0 * ldk + q * kd) * NP;
      const T* a0 = A + q * kd;
      if constexpr (sizeof(T) == 2) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[NT], bn[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          wmma::load_matrix_sync(b[j], wt + (size_t)16 * j * ldk, ldk);
#pragma unroll 2
        for (int k0 = 0; k0 < kl; k0 += 16) {
          const int kn = k0 + 16 < kl ? k0 + 16 : k0;   // next k-step's weights
#pragma unroll
          for (int j = 0; j < NT; ++j)
            wmma::load_matrix_sync(bn[j], wt + (size_t)16 * j * ldk + KB(kn), ldk);
#pragma unroll
          for (int m = 0; m < MAXMT; ++m) {
            if (m < mt) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
              wmma::load_matrix_sync(a, a0 + (size_t)16 * m * lda + KA(k0), lda);
#pragma unroll
              for (int j = 0; j < NT; ++j)
                wmma::mma_sync(acc[m][j], a, b[j], acc[m][j]);
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) b[j] = bn[j];
        }
      } else {
        kloop_split<NP>(racc, a0, lda, mt, wt, ldk, kl);
      }
    }
    float* st0 = stage - q * x.ws;    // the strip's first part
    const int halves = x.sw == STRIP ? 1 : NT;
    for (int hf = 0; hf < halves; ++hf) {
      if (on) {
#pragma unroll
        for (int m = 0; m < MAXMT; ++m) {
          if (m < mt) {
            if constexpr (sizeof(T) == 2) {
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                if (halves == 1)
                  wmma::store_matrix_sync(stage + 16 * m * STRIP + 16 * j,
                                          acc[m][j], STRIP, wmma::mem_row_major);
                else if (j == hf)
                  wmma::store_matrix_sync(stage + 16 * m * 16, acc[m][j], 16,
                                          wmma::mem_row_major);
              }
            } else {
              const int g = lane >> 2, c2 = 2 * (lane & 3);
              const bool lower = 16 * m + 8 < srows;   // rows 8..15 of the tile
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (halves == 1 || (j >> 1) == hf) {
                  float* d = stage + (16 * m + g) * x.sw
                             + (halves == 1 ? 8 * j : 8 * (j & 1)) + c2;
                  *reinterpret_cast<float2*>(d) =
                      make_float2(racc[m][j][0], racc[m][j][1]);
                  if (lower)
                    *reinterpret_cast<float2*>(d + 8 * x.sw) =
                        make_float2(racc[m][j][2], racc[m][j][3]);
                }
              }
            }
          }
        }
      }
      if (kp > 1) {
        __syncthreads();
        if (on && lane < x.sw) {
          int lo, hi;
          part_rows(srows, q, kp, lo, hi);
          for (int r = lo; r < hi; ++r) {
            float v = st0[r * x.sw + lane];
            for (int i = 1; i < kp; ++i) v += st0[i * x.ws + r * x.sw + lane];
            st0[r * x.sw + lane] = v;
          }
        }
        __syncthreads();
      } else {
        __syncwarp();
      }
      if (on) epi(st0, x.sw, n0 + 16 * hf, lane, q, kp);
      if (kp > 1) __syncthreads(); else __syncwarp();
    }
  }
}

// Epilogues: lane c < sw owns column n0 + c of the staged columns and walks
// its share of the rows (part_rows); st has row stride sw.

// h = acc + b_embx + pe_x, into every replica
template <class W>
struct EpiEmbX {
  float* h; const W* b; const float* pe; int rows, d, C;
  __device__ __forceinline__ void operator()(const float* st, int sw, int n0,
                                            int c, int q, int kp) const {
    int lo, hi;
    part_rows(rows, q, kp, lo, hi);
    if (c < sw) {
      const int n = n0 + c;
      const float bias = f32(b[n]);
      for (int r = lo; r < hi; ++r)
        h[r * d + n] = (st[r * sw + c] + bias) + pe[r * d + n];
    }
    if (C > 1) share(h, d, n0, sw, lo, hi, 0, C);
  }
};

// y = dconv3(acc + b) over the rows, stored as operands (attention's) in
// the block's own replica and in the block that owns column n's head:
// columns n mod hmod of [0, hmod) go to blocks in C equal slices.  With
// C = 1 nothing is copied: the float instantiation passes 1 for its
// global attention operands, which every block reads.
template <class T, class W>
struct EpiDconv {
  T* out; int ldo; const W* b; const W* taps; const W* tb;
  int ntap, rows, hmod, C;
  __device__ __forceinline__ void operator()(const float* st, int sw, int n0,
                                            int c, int q, int kp) const {
    int lo, hi;
    part_rows(rows, q, kp, lo, hi);
    if (lo >= hi) return;                  // the same for every lane
    if (c < sw) {
      const int n = n0 + c;
      const float bias = f32(b[n]), w0 = f32(taps[n]), w1 = f32(taps[ntap + n]),
                  w2 = f32(taps[2 * ntap + n]), db = f32(tb[n]);
      float prev = lo > 0 ? st[(lo - 1) * sw + c] + bias : 0.0f;
      float cur = st[lo * sw + c] + bias;
      for (int r = lo; r < hi; ++r) {
        const float nxt = (r + 1 < rows) ? st[(r + 1) * sw + c] + bias : 0.0f;
        out[r * ldo + n] = to_op<T>(((prev * w0 + cur * w1) + nxt * w2) + db);
        prev = cur;
        cur = nxt;
      }
    }
    // each 16 columns belong to one head, hence to one block
    for (int g = 0; C > 1 && g < sw; g += 16) {
      const int k = ((n0 + g) % hmod) / (hmod / C);
      share(out, ldo, n0 + g, 16, lo, hi, k, k + 1);
    }
  }
};

// The float instantiation's q/k/v (or cross queries) in shared memory:
// the same dconv3(acc + b), each column stored straight into the shared
// memory of the block that owns its head, which holds its heads' columns
// only: column n of [q | k | v] (hmod = d columns each) goes to block
// (n mod hmod) / (hmod / C), at column (n / hmod) (hmod / C) + n mod
// (hmod / C) of its rows (row stride ldo).
template <class W>
struct EpiDconvOwn {
  float* out; int ldo; const W* b; const W* taps; const W* tb;
  int ntap, rows, hmod, C;
  __device__ __forceinline__ void operator()(const float* st, int sw, int n0,
                                            int c, int q, int kp) const {
    int lo, hi;
    part_rows(rows, q, kp, lo, hi);
    if (lo >= hi || c >= sw) return;
    const int n = n0 + c, hc = hmod / C, col = n % hmod;
    float* o = out + (n / hmod) * hc + col % hc;
#ifndef FUSED_DDIM_LOCAL_PUT   // the timing-breakdown hook of share()
    if (C > 1) o = cg::this_cluster().map_shared_rank(o, col / hc);
#endif
    const float bias = f32(b[n]), w0 = f32(taps[n]), w1 = f32(taps[ntap + n]),
                w2 = f32(taps[2 * ntap + n]), db = f32(tb[n]);
    float prev = lo > 0 ? st[(lo - 1) * sw + c] + bias : 0.0f;
    float cur = st[lo * sw + c] + bias;
    for (int r = lo; r < hi; ++r) {
      const float nxt = (r + 1 < rows) ? st[(r + 1) * sw + c] + bias : 0.0f;
      o[r * ldo] = ((prev * w0 + cur * w1) + nxt * w2) + db;
      prev = cur;
      cur = nxt;
    }
  }
};

// Memory K and V: the same dconv3(acc + b) over `rows` staged memory rows
// that start at memory row r0, written for local rows [o_lo, o_hi) into
// the clip's global scratch kv, row-major with row stride 2d: columns
// [0, d) are K, [d, 2d) are V.  Row -1 and row `rows` count as absent (zero
// taps), so a caller that stages a chunk from the middle of the memory
// leaves the chunk's edge rows to the neighbouring chunk.
template <class T, class W>
struct EpiMemKV {
  T* kv; int d; const W* b; const W* taps; const W* tb;
  int r0, rows, o_lo, o_hi;
  __device__ __forceinline__ void operator()(const float* st, int sw, int n0,
                                            int c, int q, int kp) const {
    if (c >= sw) return;
    const int n = n0 + c, ntap = 2 * d;
    const float bias = f32(b[n]), w0 = f32(taps[n]), w1 = f32(taps[ntap + n]),
                w2 = f32(taps[2 * ntap + n]), db = f32(tb[n]);
    int lo, hi;
    part_rows(rows, q, kp, lo, hi);
    for (int r = imax(lo, o_lo); r < imin(hi, o_hi); ++r) {
      const float prev = r > 0 ? st[(r - 1) * sw + c] + bias : 0.0f;
      const float cur = st[r * sw + c] + bias;
      const float nxt = (r + 1 < rows) ? st[(r + 1) * sw + c] + bias : 0.0f;
      kv[(size_t)(r0 + r) * ntap + n] =
          to_op<T>(((prev * w0 + cur * w1) + nxt * w2) + db);
    }
  }
};

// h += acc + b (b may be null), into every replica
template <class W>
struct EpiResid {
  float* h; const W* b; int rows, d, C;
  __device__ __forceinline__ void operator()(const float* st, int sw, int n0,
                                            int c, int q, int kp) const {
    int lo, hi;
    part_rows(rows, q, kp, lo, hi);
    if (c < sw) {
      const int n = n0 + c;
      const float bias = b ? f32(b[n]) : 0.0f;
      for (int r = lo; r < hi; ++r) h[r * d + n] += st[r * sw + c] + bias;
    }
    if (C > 1) share(h, d, n0, sw, lo, hi, 0, C);
  }
};

// f = relu(acc + b)^2 as an operand (of FF2), into every replica; n is the
// column in the chunk
template <class T, class W>
struct EpiRelu2 {
  T* f; int ldf; const W* b; int rows, C;
  __device__ __forceinline__ void operator()(const float* st, int sw, int n0,
                                            int c, int q, int kp) const {
    int lo, hi;
    part_rows(rows, q, kp, lo, hi);
    if (c < sw) {
      const int n = n0 + c;
      const float bias = f32(b[n]);
      for (int r = lo; r < hi; ++r) {
        const float v = fmaxf(st[r * sw + c] + bias, 0.0f);
        f[r * ldf + n] = to_op<T>(v * v);
      }
    }
    if (C > 1) share(f, ldf, n0, sw, lo, hi, 0, C);
  }
};

// eps = acc + b_out, then the sampler's update of the state x in place.
// The step's five coefficients: DDIM reads [c0, c1, sqrt(acp_prev),
// sqrt(1 - acp_prev)]; DDPM reads [c0, c1, posterior mean coef 1 and 2,
// sigma].
struct EpiUpdate {
  float* xs; const float* b; const float* ba; const float* bb;
  float c0, c1, c2, c3, sigma; int rows, dp, stochastic;
  uint32_t k0, k1, step, clip;

  __device__ __forceinline__ void one(int i, float eps, float z) const {
    const float x = xs[i];
    if (stochastic) {
      if (ba == nullptr) {
        // identity blend folded out: c2*x0 + c3*x with x0 = c0 x - c1 eps
        xs[i] = ((__fmul_rn(c2, c0) + c3) * x - __fmul_rn(c2, c1) * eps)
                + sigma * z;
      } else {
        const float x0 = ba[i] + bb[i] * (c0 * x - c1 * eps);
        xs[i] = (c2 * x0 + c3 * x) + sigma * z;
      }
    } else if (ba == nullptr) {
      // identity blend folded out: c2*x0 + c3*eps with x0 = c0 x - c1 eps
      xs[i] = __fmul_rn(c2, c0) * x + (c3 - __fmul_rn(c2, c1)) * eps;
    } else {
      float x0 = c0 * x - c1 * eps;
      x0 = ba[i] + bb[i] * x0;
      const float e2 = (c0 * x - x0) / c1;   // eps re-derived from blended x0
      xs[i] = c2 * x0 + c3 * e2;
    }
  }

  __device__ __forceinline__ void operator()(const float* st, int sw, int n0,
                                            int c, int q, int kp) const {
    if (c >= sw) return;
    const int n = n0 + c;
    const float bias = b[n];
    int lo, hi;
    part_rows(rows, q, kp, lo, hi);
    for (int r = lo; r < hi; r += 2) {
      float z0 = 0.0f, z1 = 0.0f;
      if (stochastic) {
        uint32_t w[4];
        philox4x32_10((uint32_t)((r >> 1) * dp + n), step, clip, 0u, k0, k1, w);
        z0 = box_muller(w[0], w[1]);
        z1 = box_muller(w[2], w[3]);
      }
      one(r * dp + n, st[r * sw + c] + bias, z0);
      if (r + 1 < rows) one((r + 1) * dp + n, st[(r + 1) * sw + c] + bias, z1);
    }
  }
};

// z = normalize(h) (f32 statistics) -> operand rows; warp per row over the
// cluster's 8C warps, each row copied into every block's replica (every
// replica of h is the same, so any block may normalise any row)
template <class T>
__device__ void layer_norm(const float* h, int rows, int d, T* z, int ldz,
                           int C, int rank) {
#ifdef FUSED_DDIM_SKIP_LN
  return;  // timing-breakdown hook, off in real builds
#endif
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = rank * NWARPS + warp; r < rows; r += NWARPS * C) {
    const float* x = h + r * d;
    float s = 0.0f;
    for (int k = lane; k < d; k += 32) s += x[k];
    const float mu = warp_sum(s) / d;
    float v = 0.0f;
    for (int k = lane; k < d; k += 32) {
      const float e = x[k] - mu;
      v += e * e;
    }
    const float rs = rsqrtf(warp_sum(v) / d + LN_EPS);
    for (int k = lane; k < d; k += 32)
      z[r * ldz + k] = to_op<T>((x[k] - mu) * rs);
    if (C > 1) share(z, ldz, 0, d, r, r + 1, 0, C);
  }
}

// The float instantiation's LayerNorm: z = normalize(h) for every row, in
// every block, from the block's own replica (every replica is the same)
// into its own operand rows; rows >= `rows` of z are left as they are.
// The mean and rstd are f32 sums over the row, in two passes (eps
// LN_EPS).  g lanes a row, the most up to 32 that keep all rows in flight
// at once; a lane sums its float4s in order (odd rows of a quarter-warp
// start one run of g float4s further, so that its two rows fall on
// different banks), then a butterfly over the g lanes: a fixed order,
// with no atomics.  Not inlined: inlined, its temporaries on top of what
// the step loop keeps live pass the 255 registers a thread has, and
// ptxas spills values that the products then reload; as a call it takes
// registers of its own.
static __device__ __noinline__ void row_norm(const float* h, int rows, int d,
                                             float* z, int ldz) {
  int g = 32;
  while (g > 4 && rows * g > NTHREADS) g >>= 1;
  const int tid = threadIdx.x, lg = tid & (g - 1), n4 = d / 4;
  for (int r0 = 0; r0 < rows; r0 += NTHREADS / g) {
    const int r = r0 + tid / g;
    const float4* x = reinterpret_cast<const float4*>(h + (size_t)imin(r, rows - 1) * d);
    const int sh = g < 8 ? (r % (8 / g)) * g : 0;
    float mu = 0.0f, rs = 1.0f;
#ifndef FUSED_DDIM_SKIP_LN   // timing-breakdown hook: the statistics skipped
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = lg; i < n4; i += g) {
      const float4 v = x[i + sh < n4 ? i + sh : i + sh - n4];
      s.x += v.x;  s.y += v.y;  s.z += v.z;  s.w += v.w;
    }
    float t = (s.x + s.y) + (s.z + s.w);
    for (int o = g >> 1; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    mu = t / d;
    s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = lg; i < n4; i += g) {
      const float4 v = x[i + sh < n4 ? i + sh : i + sh - n4];
      const float ex = v.x - mu, ey = v.y - mu, ez = v.z - mu, ew = v.w - mu;
      s.x += ex * ex;  s.y += ey * ey;  s.z += ez * ez;  s.w += ew * ew;
    }
    t = (s.x + s.y) + (s.z + s.w);
    for (int o = g >> 1; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    rs = rsqrtf(t / d + LN_EPS);
#endif
    if (r >= rows) continue;     // after the shuffles, which every lane joins
    for (int i = lg; i < n4; i += g) {
      const int j = i + sh < n4 ? i + sh : i + sh - n4;
      const float4 v = x[j];
      reinterpret_cast<float4*>(z + r * ldz)[j] = make_float4(
          (v.x - mu) * rs, (v.y - mu) * rs, (v.z - mu) * rs, (v.w - mu) * rs);
    }
  }
}

// h's LayerNorm into the operand rows z for the products that read it
// (bf16: each row normalised once in the cluster and copied into every
// replica; float: every row in every block), then the barrier before such
// a product: a cluster barrier where rows crossed blocks, else a block one
template <bool F32, class T>
__device__ __forceinline__ void ln_rows(const float* h, int rows, int d, T* z,
                                        int ldz, int C, int rank) {
  if constexpr (F32) row_norm(h, rows, d, reinterpret_cast<float*>(z), ldz);
  else layer_norm(h, rows, d, z, ldz, C, rank);
}

template <bool F32>
__device__ __forceinline__ void ln_sync(int C) {
  if constexpr (F32) __syncthreads();
  else csync(C);
}

// o[i, head] = softmax(q_i . K^T * scale) V on the tensor cores, for the
// heads of this block of the cluster (heads / C of them, from rank *
// heads / C on), one warp per (head, 16-query pass); o goes to every
// block's replica.  q, k and v are row-major operands (shared or global
// memory; k and v one row per key), dk a multiple of 16.  A pass stores
// S = Q K^T (f32) to the warp's staging area sbuf as 16 rows of nkp
// columns (nk rounded up to whole tiles), runs the softmax of each row in
// f32 with lane j owning columns j, j+32, ..., writes P as operands over
// the scores (bf16 P: the rows of P written in one go end before the next
// unread row of S begins; f32 P: in place), multiplies P V, and stages
// the 16 x dk output behind P for its conversion to operands.  Key
// columns >= nk get P = 0; their K and V rows, and the query rows >= nq
// of the last tile, only have to be readable and finite.  A pass needs
// max(16 nkp, pf + 16 dk) floats, pf the floats of P (8 nkp for bf16,
// 16 nkp for f32); where that is more than one warp's staging area, every
// `span`-th warp works, over the areas of the warps it displaces.  OWNQ
// (OWNKV): q (k and v) hold this block's heads only, the first at column
// 0; else every head, head i at column i dk.
template <class T, bool OWNQ = false, bool OWNKV = false>
__device__ void attention(const T* q, int ldq, const T* k, int ldk,
                          const T* v, int ldv, int nq, int nk, int heads,
                          int dk, float scale, T* o, int ldo, float* sbuf,
                          int stage_warp, int C, int rank) {
#ifdef FUSED_DDIM_SKIP_ATTN
  return;  // timing-breakdown hook, off in real builds
#endif
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nkp = (nk + 15) & ~15;
  const int pf = 16 * nkp * (int)sizeof(T) / 4;   // floats of P
  int span = 1;
  while (span * stage_warp < imax(16 * nkp, pf + 16 * dk)) span *= 2;
  if (warp % span) return;
  T* pb = reinterpret_cast<T*>(sbuf);
  float* obuf = sbuf + pf;                // behind the 16 x nkp of P
  const int hl = heads / C, passes = (nq + 15) / 16;
  for (int u = warp / span; u < hl * passes; u += NWARPS / span) {
    const int hd = (rank * hl + u / passes) * dk, i0 = (u % passes) * 16;
    const int hq = OWNQ ? (u / passes) * dk : hd;
    const int hkv = OWNKV ? (u / passes) * dk : hd;
    {
      for (int j0 = 0; j0 < nkp; j0 += 16) {
        typename Frag<T>::Acc sc;
        wmma::fill_fragment(sc, 0.0f);
        mma_tile<wmma::col_major>(sc, q + (size_t)i0 * ldq + hq, ldq,
                                  k + (size_t)j0 * ldk + hkv, ldk, 1, dk);
        wmma::store_matrix_sync(sbuf + j0, sc, nkp, wmma::mem_row_major);
      }
      __syncwarp();
      // four rows at a time, so that their shuffle chains overlap
      const int rows = imin(16, nq - i0);
      for (int r0 = 0; r0 < rows; r0 += SMR) {
        float s[SMR][MAXKC], mx[SMR], sum[SMR];
#pragma unroll
        for (int g = 0; g < SMR; ++g) {
          mx[g] = -INFINITY;
#pragma unroll
          for (int cc = 0; cc < MAXKC; ++cc) {
            if (32 * cc >= nkp) break;        // warp-uniform
            const int j = lane + 32 * cc;
            s[g][cc] = j < nk ? sbuf[(r0 + g) * nkp + j] * scale : -INFINITY;
            mx[g] = fmaxf(mx[g], s[g][cc]);
          }
        }
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
#pragma unroll
          for (int g = 0; g < SMR; ++g)
            mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], sh));
#pragma unroll
        for (int g = 0; g < SMR; ++g) {
          sum[g] = 0.0f;
#pragma unroll
          for (int cc = 0; cc < MAXKC; ++cc) {
            if (32 * cc >= nkp) break;
            s[g][cc] = lane + 32 * cc < nk ? expf(s[g][cc] - mx[g]) : 0.0f;
            sum[g] += s[g][cc];
          }
        }
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
#pragma unroll
          for (int g = 0; g < SMR; ++g)
            sum[g] += __shfl_xor_sync(0xffffffffu, sum[g], sh);
        __syncwarp();   // every lane has read these rows of S
#pragma unroll
        for (int g = 0; g < SMR; ++g) {
          const float inv = 1.0f / sum[g];
#pragma unroll
          for (int cc = 0; cc < MAXKC; ++cc)
            if (lane + 32 * cc < nkp)
              pb[(r0 + g) * nkp + lane + 32 * cc] = to_op<T>(s[g][cc] * inv);
        }
      }
      __syncwarp();
      // O = P V, one 16-column tile of the head at a time, staged behind P
      for (int e = 0; e < dk; e += 16) {
        typename Frag<T>::Acc oc;
        wmma::fill_fragment(oc, 0.0f);
        mma_tile<wmma::row_major>(oc, pb, nkp, v + hkv + e, ldv, ldv, nkp);
        wmma::store_matrix_sync(obuf + e, oc, dk, wmma::mem_row_major);
      }
      __syncwarp();
      for (int r = 0; r < rows; ++r)
        for (int c = lane; c < dk; c += 32)
          o[(i0 + r) * ldo + hd + c] = to_op<T>(obuf[r * dk + c]);
      if (C > 1) share(o, ldo, hd, dk, i0, i0 + rows, 0, C);
      __syncwarp();     // sbuf is rewritten by the next pass
    }
  }
}

template <class T, class W>
__global__ void __launch_bounds__(NTHREADS, 1) fused_ddim_kernel(Params<T, W> p) {
  constexpr bool F32 = sizeof(T) == 4;
  // planes of each product weight: 3 for an f32 pack (header), else 1
  constexpr int NP = F32 && sizeof(W) == 4 ? 3 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(p.t, p.d, p.dp, p.fc, p.half, (int)sizeof(T),
                               p.cluster);
  const int T_ = p.t, NM = p.nm, D = p.d, DP = p.dp, F = p.f, FC = p.fc;
  const int NMP = (NM + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5;
  // a one-dimensional cluster of C blocks per clip: rank = position in it
  const int C = p.cluster, rank = blockIdx.x % C, clip = blockIdx.x / C;
  // GA: the attention operands live in the global scratch (float, where
  // the block's own heads do not fit in shared memory; header)
  const bool GA = F32 && !L.satt;

  float* h = reinterpret_cast<float*>(smem + L.h);
  T* za = reinterpret_cast<T*>(smem + L.za);
  T* big = reinterpret_cast<T*>(smem + L.big);
  T* ma = reinterpret_cast<T*>(smem + L.ma);
  float* stage0 = reinterpret_cast<float*>(smem + L.stage);
  float* stage = stage0 + warp * L.stage_warp;
  const Ctx cx{stage0, L.stage_warp, L.sw, C, rank, L.srows};

  // the state x lives in the clip's slice of the output
  float* xs = p.out + (size_t)clip * T_ * DP;
  const float* xg = p.x_T + (size_t)clip * T_ * DP;
  const float* xa = p.x_add ? p.x_add + (size_t)clip * T_ * DP : nullptr;
  const float* ba = p.blend_a ? p.blend_a + (size_t)clip * T_ * DP : nullptr;
  const float* bb = p.blend_b ? p.blend_b + (size_t)clip * T_ * DP : nullptr;
  const T* mg = p.mem + (size_t)clip * NM * D;
  // scratch of this clip: per layer NMP rows of [K | V]; with GA, then
  // 16 * mtx rows of [q | k | v] (the cross queries reuse q's columns)
  const size_t kv_layer = (size_t)2 * D * NMP;
  const size_t att_elems = GA ? (size_t)16 * L.mtx * 3 * D : 0;
  T* kvs = p.kv + (size_t)clip * (p.layers * kv_layer + att_elems);
  T* att = kvs + p.layers * kv_layer;
  T* qkv = GA ? att : big;                     // self q/k/v
  const int ldqkv = GA ? 3 * D : L.ldqkv, cqkv = GA ? 1 : C;
  T* cq = GA ? att : big;                      // the cross queries
  const int ldcq = GA ? 3 * D : L.ldcq;
  // float in shared memory: q, k and v hold the block's heads only
  const bool own = F32 && !GA;
  const int hcol = own ? D / C : D;            // columns of each of q, k, v
  const int dk = D / p.heads;
  const float scale = 1.0f / sqrtf((float)dk);
  const size_t dd = (size_t)D * D;
  const unsigned long long seed = p.stochastic ? *p.seed : 0ull;

  // zero the operand areas so that pad rows of every row tile hold 0; the
  // cluster barrier also keeps other blocks' writes out until this is done
  for (int i = tid; i < (L.total - L.za) / 4; i += NTHREADS)
    reinterpret_cast<uint32_t*>(smem + L.za)[i] = 0u;
  for (int i = rank * NTHREADS + tid; i < T_ * DP; i += C * NTHREADS)
    xs[i] = xg[i];
  if (C > 1) cg::this_cluster().sync(); else __syncthreads();

  // memory K and V of every layer, once: chunks of 16*mch memory rows that
  // overlap by two, so that each row's dconv sees its real neighbours; each
  // block stages every chunk, the cluster shares the products
  {
    const int ch = 16 * L.mch;
    for (int s0 = 0;; s0 += ch - 2) {
      const int rows = imin(ch, NM - s0);
      const bool last = s0 + rows >= NM;
      for (int i = tid; i < ch * D; i += NTHREADS) {
        const int r = i / D, c = i % D;
        big[r * L.ldm + c] = r < rows ? mg[(size_t)(s0 + r) * D + c]
                                      : to_op<T>(0.0f);
      }
      __syncthreads();
      for (int l = 0; l < p.layers; ++l)
        matmul<T, NP>(cx, big, L.ldm, (rows + 15) / 16,
                      p.cross_wkv + NP * l * 2 * dd, D, D, 2 * D,
                      EpiMemKV<T, W>{kvs + l * kv_layer, D, p.cross_bkv + l * 2 * D,
                                     p.cross_dkv + l * 6 * D, p.cross_dkvb + l * 2 * D,
                                     s0, rows, s0 == 0 ? 0 : 1, last ? rows : rows - 1});
      __syncthreads();
      if (last) break;
    }
  }
  csync(C);

  for (int it = 0; it < p.steps; ++it) {
    const int s = p.steps - 1 - it;
    for (int i = tid; i < T_ * DP; i += NTHREADS)
      za[(i / DP) * L.lda + i % DP] = to_op<T>(xa ? xs[i] + xa[i] : xs[i]);
    __syncthreads();
    matmul<T, NP>(cx, za, L.lda, L.mtx, p.w_embx, DP, DP, D,
                  EpiEmbX<W>{h, p.b_embx, p.pe_x, T_, D, C});
    csync(C);

    for (int l = 0; l < p.layers; ++l) {
      // self-attention: merged QKV + dconv -> attention -> out-proj
      ln_rows<F32>(h, T_, D, za, L.lda, C, rank);
      ln_sync<F32>(C);
      {
        const bf16* w = p.self_wqkv + NP * l * 3 * dd;
        const W *b = p.self_bqkv + l * 3 * D, *tp = p.self_dconv + l * 9 * D,
                *tb = p.self_dbias + l * 3 * D;
        if (own)
          matmul<T, NP>(cx, za, L.lda, L.mtx, w, D, D, 3 * D,
                        EpiDconvOwn<W>{reinterpret_cast<float*>(qkv), ldqkv, b,
                                       tp, tb, 3 * D, T_, D, C});
        else
          matmul<T, NP>(cx, za, L.lda, L.mtx, w, D, D, 3 * D,
                        EpiDconv<T, W>{qkv, ldqkv, b, tp, tb, 3 * D, T_, D, cqkv});
      }
      csync(C);
      if (own)
        attention<T, true, true>(qkv, ldqkv, qkv + hcol, ldqkv, qkv + 2 * hcol,
                                 ldqkv, T_, T_, p.heads, dk, scale, za, L.lda,
                                 stage, L.stage_warp, C, rank);
      else
        attention(qkv, ldqkv, qkv + D, ldqkv, qkv + 2 * D, ldqkv, T_, T_,
                  p.heads, dk, scale, za, L.lda, stage, L.stage_warp, C, rank);
      csync(C);
      matmul<T, NP>(cx, za, L.lda, L.mtx, p.self_wo + NP * l * dd, D, D, D,
                    EpiResid<W>{h, p.self_bo + l * D, T_, D, C});
      csync(C);

      // cross-attention: q from h; memory rows 0 and 1 of K and V from the
      // tile [token; memory row 1; memory row 2], the rest is in the scratch
      ln_rows<F32>(h, T_, D, za, L.lda, C, rank);
      const int mrows = imin(NM, 3);
      // float: the tile shares its area with the FF chunk, so its other
      // rows are cleared (they enter the product, whose rows 2.. are dropped)
      const int mfill = F32 ? 16 : mrows;
      for (int i = tid; i < mfill * D; i += NTHREADS) {
        const int r = i / D, c = i % D;
        ma[r * L.ldm + c] = r == 0      ? p.tok[(size_t)s * D + c]
                            : r < mrows ? mg[r * D + c]
                                        : to_op<T>(0.0f);
      }
      // float: a block barrier (the tile and the normalised rows are the
      // block's own; the cross queries other blocks now write into this
      // one lie beside the tile, or in the global scratch)
      ln_sync<F32>(C);
      T* kv = kvs + l * kv_layer;
      {
        const bf16* w = p.cross_wq + NP * l * dd;
        const W *b = p.cross_bq + l * D, *tp = p.cross_dq + l * 3 * D,
                *tb = p.cross_dqb + l * D;
        if (own)
          matmul<T, NP>(cx, za, L.lda, L.mtx, w, D, D, D,
                        EpiDconvOwn<W>{reinterpret_cast<float*>(cq), ldcq, b,
                                       tp, tb, D, T_, D, C});
        else
          matmul<T, NP>(cx, za, L.lda, L.mtx, w, D, D, D,
                        EpiDconv<T, W>{cq, ldcq, b, tp, tb, D, T_, D, cqkv});
      }
      matmul<T, NP>(cx, ma, L.ldm, 1, p.cross_wkv + NP * l * 2 * dd, D, D, 2 * D,
                    EpiMemKV<T, W>{kv, D, p.cross_bkv + l * 2 * D,
                                   p.cross_dkv + l * 6 * D,
                                   p.cross_dkvb + l * 2 * D, 0, mrows, 0, 2});
      csync(C);
      if (own)
        attention<T, true, false>(cq, ldcq, kv, 2 * D, kv + D, 2 * D, T_, NM,
                                  p.heads, dk, scale, za, L.lda, stage,
                                  L.stage_warp, C, rank);
      else
        attention(cq, ldcq, kv, 2 * D, kv + D, 2 * D, T_, NM, p.heads, dk,
                  scale, za, L.lda, stage, L.stage_warp, C, rank);
      csync(C);
      matmul<T, NP>(cx, za, L.lda, L.mtx, p.cross_wo + NP * l * dd, D, D, D,
                    EpiResid<W>{h, p.cross_bo + l * D, T_, D, C});
      csync(C);

      // squared-ReLU FF in hidden chunks of FC
      ln_rows<F32>(h, T_, D, za, L.lda, C, rank);
      ln_sync<F32>(C);
      for (int c0 = 0; c0 < F; c0 += FC) {
        matmul<T, NP>(cx, za, L.lda, L.mtx,
                      p.ff_w1 + NP * ((size_t)l * F + c0) * D, D, D, FC,
                      EpiRelu2<T, W>{big, L.ldf, p.ff_b1 + (size_t)l * F + c0, T_, C});
        csync(C);
        matmul<T, NP>(cx, big, L.ldf, L.mtx,
                      p.ff_w2 + NP * ((size_t)l * D * F + c0), F, FC, D,
                      EpiResid<W>{h, c0 == 0 ? p.ff_b2 + l * D : nullptr, T_, D, C});
        csync(C);
      }
    }

    ln_rows<F32>(h, T_, D, za, L.lda, C, rank);
    ln_sync<F32>(C);
    const float* cf = p.coefs + (size_t)s * 5;
    matmul<T, NP>(cx, za, L.lda, L.mtx, p.w_out, D, D, DP,
                  EpiUpdate{xs, p.b_out, ba, bb, cf[0], cf[1], cf[2], cf[3], cf[4],
                            T_, DP, p.stochastic, (uint32_t)seed,
                            (uint32_t)(seed >> 32), (uint32_t)s,
                            (uint32_t)(p.clip_base + clip)});
    csync(C);
  }
  // no block leaves while another may still write into its shared memory
  if (C > 1) cg::this_cluster().sync();
}

// Build parts (ops/kernel_build.py): with KERNEL_BUILD_PART set to 0, 1 or
// 2 this file emits one instantiation (bf16 on bf16, float on bf16, float
// on f32) with its launch and occupancy functions, part 0 also the C
// interface; ops/kernel_build.py compiles the KERNEL_BUILD_PARTS parts at
// once and links them into one library.  Unset, the file emits the whole
// library.
#define KERNEL_BUILD_PARTS 3
#ifndef KERNEL_BUILD_PART
#define KERNEL_BUILD_PART -1
#endif
#define PART(k) (KERNEL_BUILD_PART < 0 || KERNEL_BUILD_PART == (k))

// each instantiation's launch (launch) and occupancy (max_clusters)
extern "C" {
int fused_ddim_launch_bb(void** ptrs, const int* dims, cudaStream_t stream);
int fused_ddim_launch_fb(void** ptrs, const int* dims, cudaStream_t stream);
int fused_ddim_launch_ff(void** ptrs, const int* dims, cudaStream_t stream);
int fused_ddim_occupancy_bb(int c, int smem);
int fused_ddim_occupancy_fb(int c, int smem);
}

#if PART(0)
// f32: 1 for the float instantiation, 0 for bf16; c: blocks per cluster
extern "C" int fused_ddim_smem_bytes(int t, int d, int dp, int fc, int half,
                                     int f32, int c) {
  return make_layout(t, d, dp, fc, half, f32 ? 4 : 2, c).total;
}

// 1 where the float instantiation's attention operands live in shared
// memory (the block's own heads), 0 where they live in the global scratch
extern "C" int fused_ddim_attention_shared(int t, int d, int dp, int fc,
                                           int half, int c) {
  return make_layout(t, d, dp, fc, half, 4, c).satt;
}

// operand elements of one clip's scratch: the memory K/V, and where the
// float instantiation's attention operands live there (t > 0: the window)
// those
extern "C" long long fused_ddim_scratch_elems(int nm, int d, int layers,
                                              int t) {
  return (long long)layers * 2 * d * ((nm + 15) & ~15) +
         (long long)((t + 15) & ~15) * 3 * d;
}
#endif

static cudaLaunchConfig_t launch_config(int blocks, int c, int smem,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class T, class W>
static int max_clusters(int c, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_ddim_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(c, c, smem, 0, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (void*)fused_ddim_kernel<T, W>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

#if PART(0)
// Clusters of c blocks, each with smem bytes of shared memory, that the
// card runs at once (cudaOccupancyMaxActiveClusters) for the bf16 or (f32)
// the float instantiation (on a bf16 pack; one block an SM either way);
// minus a CUDA error.
extern "C" int fused_ddim_max_clusters(int c, int smem, int f32) {
  if (c < 1 || c > MAXC || smem > SMEM_LIMIT) return -(int)cudaErrorInvalidValue;
  return f32 ? fused_ddim_occupancy_fb(c, smem) : fused_ddim_occupancy_bb(c, smem);
}

// The cluster size for n clips of window t (d_model d, padded pose width
// dp, FF width ffn): the largest of 8, 4, 2 that divides heads and runs
// all n clusters at once with the plan for that size (plan_layout), else
// 1 (ops/fused_sampler.py::cluster_plan is the same rule); minus a CUDA
// error.
extern "C" int fused_ddim_cluster_size(int n, int heads, int t, int d, int dp,
                                       int ffn, int f32) {
  for (int c = MAXC; c > 1; c /= 2) {
    if (heads % c) continue;
    int fc, half;
    const Layout L = plan_layout(t, d, dp, ffn, f32 ? 4 : 2, c, fc, half);
    const int m = fused_ddim_max_clusters(c, L.total, f32);
    if (m < 0) return m;
    if (m >= n) return c;
  }
  return 1;
}
#endif

template <class T, class W>
static int launch(void** ptrs, const int* dims, cudaStream_t stream) {
  Params<T, W> p;
  p.x_T = (const float*)ptrs[0];       p.out = (float*)ptrs[1];
  p.mem = (const T*)ptrs[2];           p.tok = (const T*)ptrs[3];
  p.coefs = (const float*)ptrs[4];
  p.blend_a = (const float*)ptrs[5];   p.blend_b = (const float*)ptrs[6];
  p.x_add = (const float*)ptrs[7];     p.kv = (T*)ptrs[8];
  p.seed = (const unsigned long long*)ptrs[9];
  p.w_embx = (const bf16*)ptrs[10];
  p.b_embx = (const W*)ptrs[11];
  p.pe_x = (const float*)ptrs[12];
  p.self_wqkv = (const bf16*)ptrs[13];
  p.self_bqkv = (const W*)ptrs[14];
  p.self_dconv = (const W*)ptrs[15];
  p.self_dbias = (const W*)ptrs[16];
  p.self_wo = (const bf16*)ptrs[17];
  p.self_bo = (const W*)ptrs[18];
  p.cross_wq = (const bf16*)ptrs[19];
  p.cross_bq = (const W*)ptrs[20];
  p.cross_wkv = (const bf16*)ptrs[21];
  p.cross_bkv = (const W*)ptrs[22];
  p.cross_dq = (const W*)ptrs[23];
  p.cross_dqb = (const W*)ptrs[24];
  p.cross_dkv = (const W*)ptrs[25];
  p.cross_dkvb = (const W*)ptrs[26];
  p.cross_wo = (const bf16*)ptrs[27];
  p.cross_bo = (const W*)ptrs[28];
  p.ff_w1 = (const bf16*)ptrs[29];
  p.ff_b1 = (const W*)ptrs[30];
  p.ff_w2 = (const bf16*)ptrs[31];
  p.ff_b2 = (const W*)ptrs[32];
  p.w_out = (const bf16*)ptrs[33];
  p.b_out = (const float*)ptrs[34];
  p.n = dims[0];  p.t = dims[1];  p.nm = dims[2];  p.d = dims[3];
  p.dp = dims[4]; p.f = dims[5];  p.layers = dims[6];  p.heads = dims[7];
  p.steps = dims[8];  p.fc = dims[9];  p.half = dims[10];
  p.stochastic = dims[11];  p.cluster = dims[12];  p.clip_base = dims[13];

  const int dk = p.heads > 0 ? p.d / p.heads : 0;
  const int c = p.cluster;
  if (p.n < 1 || p.t < 1 || p.t > 16 * MAXMT || p.nm < 2 ||
      p.nm > 32 * MAXKC || p.heads < 1 || p.d % p.heads || dk % 16 ||
      dk > MAXDK || p.d % STRIP || p.dp % STRIP || p.fc % STRIP ||
      p.fc < STRIP || p.f % p.fc || p.steps < 1 || p.layers < 1 ||
      p.kv == nullptr || (p.stochastic && p.seed == nullptr) ||
      c < 1 || c > MAXC || (c & (c - 1)) || p.heads % c ||
      (long long)p.n * c > 0x7fffffffLL || p.clip_base < 0 ||
      (long long)p.clip_base + p.n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(p.t, p.d, p.dp, p.fc, p.half, (int)sizeof(T), c);
  if (L.total > SMEM_LIMIT || L.mch < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_ddim_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p.n * c, c, L.total, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, fused_ddim_kernel<T, W>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#if PART(0)
extern "C" int fused_ddim_launch_bb(void** ptrs, const int* dims,
                                    cudaStream_t stream) {
  return launch<bf16, bf16>(ptrs, dims, stream);
}
extern "C" int fused_ddim_occupancy_bb(int c, int smem) {
  return max_clusters<bf16, bf16>(c, smem);
}
#endif
#if PART(1)
extern "C" int fused_ddim_launch_fb(void** ptrs, const int* dims,
                                    cudaStream_t stream) {
  return launch<float, bf16>(ptrs, dims, stream);
}
extern "C" int fused_ddim_occupancy_fb(int c, int smem) {
  return max_clusters<float, bf16>(c, smem);
}
#endif
#if PART(2)
extern "C" int fused_ddim_launch_ff(void** ptrs, const int* dims,
                                    cudaStream_t stream) {
  return launch<float, float>(ptrs, dims, stream);
}
#endif

// dims[14]: 1 for float operands (compute_dtype float32), 0 for bf16;
// dims[15]: 1 for an f32 pack (float operands only: its product weights
// handed over as three interleaved bf16 planes, its other tensors as f32),
// 0 for a bf16 pack (every tensor as the pack holds it)
#if PART(0)
extern "C" int fused_ddim_launch(void** ptrs, int n_ptrs, const int* dims,
                                 int n_dims, void* stream) {
  if (n_ptrs != N_PTRS || n_dims != N_DIMS || (dims[14] != 0 && dims[14] != 1) ||
      (dims[15] != 0 && dims[15] != 1) || (!dims[14] && dims[15]))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!dims[14]) return fused_ddim_launch_bb(ptrs, dims, st);
  return dims[15] ? fused_ddim_launch_ff(ptrs, dims, st)
                  : fused_ddim_launch_fb(ptrs, dims, st);
}
#endif
