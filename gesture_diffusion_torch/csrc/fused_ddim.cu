// Fused DDIM sampler for Hopper (sm_90a): the whole reverse process of the
// oneway cross-attention denoiser in one launch.
//
// Replaces the TPU kernel gesture_diffusion_tpu/ops/fused_sampler.py,
// fused_ddim_sample / _make_kernel (its pallas_call), for the DDIM (eta=0)
// identity-blend and x0-blend variants.  It computes that kernel's
// function, not its block structure: the TPU's clip packing and 8-row
// padding are not needed here, windows and memories are taken at their
// real lengths: up to 64 rows each, as far as the shared-memory plan fits
// (d_model 256: T <= 45 at n_mem 32, n_mem <= 48 at T 40).
//
// Design: one thread block of 8 warps per clip, a loop over the S steps
// inside the block.  Everything the clip produces lives in shared memory:
// the state x (f32), the residual stream h (f32), the bf16 operand rows of
// every product, q/k/v, and the FF hidden in chunks.  Products run on the
// tensor cores through nvcuda::wmma (bf16 operands, f32 accumulation); the
// A operand (activations) comes from shared memory and the B operand
// (weights) straight from global memory, one k-step ahead.  The wrapper
// hands the weights over transposed, (N, K) row-major, so a B fragment is
// loaded as 32-bit pairs along k (col_major) rather than as scattered 16-bit
// loads over 16 rows.  Each warp owns whole 32-column
// strips of an output, so it sees every row of its strip and can run the
// strip's epilogue itself: bias, the 3-tap depthwise conv over time,
// squared ReLU, the residual add, or the DDIM update.  Attention is plain
// f32 FMA, one warp per head, keys spread over lanes, four queries at a
// time so that every key and value load feeds four independent chains.
//
// Bound on an H100: the ~8.7 MB of bf16 weights (flagship) fit in no SM, so
// every block re-reads all of them from L2 on every step; the kernel is
// bound by that weight stream (batch 1: one SM's L2 bandwidth; batch 64:
// 64 blocks sharing L2).  Keeping all activations on chip makes the weight
// stream the only global traffic.  Spreading one clip's weights over many
// SMs, or several clips over one block, is later work.
//
// Numerics (shared with fused_ddim_sample_plain): product operands are
// rounded to bf16, everything else is f32: h, LayerNorm (normalise only,
// eps 1e-6; its affine is folded into the next projection at pack time),
// softmax, biases, dconv, the state x and eps.
//
// C interface (ctypes): fused_ddim_launch(ptrs, 32, dims, 10, stream)
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define NWARPS 8
#define NTHREADS (NWARPS * 32)
#define NT 2                 // 16-column tiles per warp strip
#define STRIP (16 * NT)      // columns per warp strip
#define MAXMT 4              // row tiles of 16: at most 64 rows per side
#define MAXKC 2              // key chunks of 32: at most 64 keys
#define SMEM_LIMIT 232448
#define LN_EPS 1e-6f

struct Params {
  const float* x_T;  float* out;
  const bf16* mem;   const bf16* tok;  const float* coefs;
  const float* blend_a;  const float* blend_b;
  const bf16* w_embx;  const bf16* b_embx;  const float* pe_x;
  const bf16* self_wqkv;  const bf16* self_bqkv;  const bf16* self_dconv;
  const bf16* self_dbias; const bf16* self_wo;    const bf16* self_bo;
  const bf16* cross_wq;   const bf16* cross_bq;   const bf16* cross_wkv;
  const bf16* cross_bkv;  const bf16* cross_dq;   const bf16* cross_dqb;
  const bf16* cross_dkv;  const bf16* cross_dkvb; const bf16* cross_wo;
  const bf16* cross_bo;
  const bf16* ff_w1;  const bf16* ff_b1;  const bf16* ff_w2;  const bf16* ff_b2;
  const bf16* w_out;  const float* b_out;
  int n, t, nm, d, dp, f, layers, heads, steps, fc;
};

// Shared-memory plan (bytes); mirrored by ops/fused_sampler.py::smem_bytes.
struct Layout {
  int xs, h, za, ma, big, ckv, stage, total;   // byte offsets
  int lda, ldm, ldqkv, ldcq, ldckv, ldf;       // row strides (elements)
  int mtx, mtm;                                // row tiles per side
};

__host__ __device__ inline int align128(int b) { return (b + 127) & ~127; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Layout make_layout(int t, int nm, int d, int dp,
                                              int fc) {
  Layout L;
  L.mtx = (t + 15) / 16;
  L.mtm = (nm + 15) / 16;
  L.lda = imax(d, dp) + 8;   // +8 keeps wmma row loads off one bank
  L.ldm = d + 8;
  L.ldqkv = 3 * d + 2;       // odd word stride: per-lane key rows hit
  L.ldcq = d + 2;            // distinct banks in the score loop
  L.ldckv = 2 * d + 2;
  L.ldf = fc + 8;
  int off = 0;
  L.xs = off;  off += align128(t * dp * 4);
  L.h = off;   off += align128(t * d * 4);
  L.za = off;  off += align128(16 * L.mtx * L.lda * 2);
  L.ma = off;  off += align128(16 * L.mtm * L.ldm * 2);
  int cq_bytes = align128(t * L.ldcq * 2);
  int big = imax(imax(t * L.ldqkv * 2, cq_bytes + nm * L.ldckv * 2),
                 16 * L.mtx * L.ldf * 2);
  L.big = off;
  L.ckv = off + cq_bytes;
  off += align128(big);
  L.stage = off;
  off += align128(NWARPS * 16 * imax(L.mtx, L.mtm) * STRIP * 4);
  L.total = off;
  return L;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

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

// C[rows, N] = A[rows, K] (bf16, shared, row stride lda) x W[K, N], with W
// given transposed: Wt[N, K] (bf16, global, row stride ldk).  Warp w
// computes column strips w, w+8, ... over all mt row tiles, stores each
// strip to its staging area (f32, mt*16 x STRIP) and runs
// epi(stage, n0, lane) on it.  N % STRIP == 0, K % 16 == 0.
template <class Epi>
__device__ __forceinline__ void matmul(const bf16* A, int lda, int mt,
                                       const bf16* __restrict__ Wt, int ldk,
                                       int K, int N, float* stage,
                                       const Epi& epi) {
// Timing-breakdown hooks (tools/fused_ddim_breakdown.py), off in real
// builds: SKIP_MMA drops the k-loops; FIXED_A / FIXED_B keep that operand's
// fragments at k-step 0, taking its loads' cost out of the loop.
#ifdef FUSED_DDIM_SKIP_MMA
  K = 0;
#endif
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n0 = warp * STRIP; n0 < N; n0 += NWARPS * STRIP) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXMT][NT];
#pragma unroll
    for (int m = 0; m < MAXMT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[m][j], 0.0f);
    const bf16* wt = Wt + (size_t)n0 * ldk;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[NT], bn[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wmma::load_matrix_sync(b[j], wt + (size_t)16 * j * ldk, ldk);
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int kn = k0 + 16 < K ? k0 + 16 : k0;   // next k-step's weights
#pragma unroll
      for (int j = 0; j < NT; ++j)
        wmma::load_matrix_sync(bn[j], wt + (size_t)16 * j * ldk + KB(kn), ldk);
#pragma unroll
      for (int m = 0; m < MAXMT; ++m) {
        if (m < mt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + (size_t)16 * m * lda + KA(k0), lda);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            wmma::mma_sync(acc[m][j], a, b[j], acc[m][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = bn[j];
    }
#pragma unroll
    for (int m = 0; m < MAXMT; ++m) {
      if (m < mt) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          wmma::store_matrix_sync(stage + 16 * m * STRIP + 16 * j, acc[m][j],
                                  STRIP, wmma::mem_row_major);
      }
    }
    __syncwarp();
    epi(stage, n0, lane);
    __syncwarp();
  }
}

// Epilogues: lane c owns column n0 + c of the strip and walks its rows.

// h = acc + b_embx + pe_x
struct EpiEmbX {
  float* h; const bf16* b; const float* pe; int rows, d;
  __device__ void operator()(const float* st, int n0, int c) const {
    const int n = n0 + c;
    const float bias = bf(b[n]);
    for (int r = 0; r < rows; ++r)
      h[r * d + n] = (st[r * STRIP + c] + bias) + pe[r * d + n];
  }
};

// y = dconv3(acc + b) over the rows, stored bf16 (attention operands)
struct EpiDconv {
  bf16* out; int ldo; const bf16* b; const bf16* taps; const bf16* tb;
  int ntap, rows;
  __device__ void operator()(const float* st, int n0, int c) const {
    const int n = n0 + c;
    const float bias = bf(b[n]), w0 = bf(taps[n]), w1 = bf(taps[ntap + n]),
                w2 = bf(taps[2 * ntap + n]), db = bf(tb[n]);
    float prev = 0.0f, cur = st[c] + bias;
    for (int r = 0; r < rows; ++r) {
      const float nxt = (r + 1 < rows) ? st[(r + 1) * STRIP + c] + bias : 0.0f;
      out[r * ldo + n] = __float2bfloat16(((prev * w0 + cur * w1) + nxt * w2) + db);
      prev = cur;
      cur = nxt;
    }
  }
};

// h += acc + b   (b may be null)
struct EpiResid {
  float* h; const bf16* b; int rows, d;
  __device__ void operator()(const float* st, int n0, int c) const {
    const int n = n0 + c;
    const float bias = b ? bf(b[n]) : 0.0f;
    for (int r = 0; r < rows; ++r) h[r * d + n] += st[r * STRIP + c] + bias;
  }
};

// f = relu(acc + b)^2 as bf16 (the FF2 operand); n is the column in the chunk
struct EpiRelu2 {
  bf16* f; int ldf; const bf16* b; int rows;
  __device__ void operator()(const float* st, int n0, int c) const {
    const int n = n0 + c;
    const float bias = bf(b[n]);
    for (int r = 0; r < rows; ++r) {
      const float v = fmaxf(st[r * STRIP + c] + bias, 0.0f);
      f[r * ldf + n] = __float2bfloat16(v * v);
    }
  }
};

// eps = acc + b_out, then the DDIM update of the state x in place
struct EpiUpdate {
  float* xs; const float* b; const float* ba; const float* bb;
  float c0, c1, c2, c3; int rows, dp;
  __device__ void operator()(const float* st, int n0, int c) const {
    const int n = n0 + c;
    const float bias = b[n];
    for (int r = 0; r < rows; ++r) {
      const int i = r * dp + n;
      const float eps = st[r * STRIP + c] + bias, x = xs[i];
      if (ba == nullptr) {
        // identity blend folded out: c2*x0 + c3*eps with x0 = c0 x - c1 eps
        xs[i] = __fmul_rn(c2, c0) * x + (c3 - __fmul_rn(c2, c1)) * eps;
      } else {
        float x0 = c0 * x - c1 * eps;
        x0 = ba[i] + bb[i] * x0;
        const float e2 = (c0 * x - x0) / c1;   // eps re-derived from blended x0
        xs[i] = c2 * x0 + c3 * e2;
      }
    }
  }
};

// z = normalize(h) (f32 statistics) -> bf16 operand rows; warp per row
__device__ void layer_norm(const float* h, int rows, int d, bf16* z, int ldz) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += NWARPS) {
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
      z[r * ldz + k] = __float2bfloat16((x[k] - mu) * rs);
  }
}

// o[i, head] = softmax(q_i . K^T * scale) V, one warp per head, QG queries
// per pass.  Lane j owns keys j and j+32; bf16 operands, f32 scores,
// softmax and sums, P rounded to bf16 and parked in this warp's pbuf
// (QG x 64 floats) for the P.V pass, where lane d owns output dims d, d+32.
#define QG 4
__device__ void attention(const bf16* q, int ldq, const bf16* k,
                          const bf16* v, int ldkv, int nq, int nk, int heads,
                          int dk, float scale, bf16* o, int ldo, float* pbuf) {
#ifdef FUSED_DDIM_SKIP_ATTN
  return;  // timing-breakdown hook, off in real builds
#endif
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool wide = dk > 32;
  for (int hh = warp; hh < heads; hh += NWARPS) {
    const int hd = hh * dk;
    for (int i0 = 0; i0 < nq; i0 += QG) {
      const __nv_bfloat162* qr[QG];
#pragma unroll
      for (int g = 0; g < QG; ++g)
        qr[g] = reinterpret_cast<const __nv_bfloat162*>(
            q + min(i0 + g, nq - 1) * ldq + hd);
      float s[QG][MAXKC];
#pragma unroll
      for (int cc = 0; cc < MAXKC; ++cc) {
        const int j = lane + 32 * cc;
        const bool live = j < nk;
#pragma unroll
        for (int g = 0; g < QG; ++g) s[g][cc] = -INFINITY;
        if (32 * cc >= nk) continue;          // warp-uniform
        const __nv_bfloat162* kj = reinterpret_cast<const __nv_bfloat162*>(
            k + (live ? j : 0) * ldkv + hd);
        float acc[QG];
#pragma unroll
        for (int g = 0; g < QG; ++g) acc[g] = 0.0f;
#pragma unroll 4
        for (int e = 0; e < dk / 2; ++e) {
          const float2 kf = __bfloat1622float2(kj[e]);
#pragma unroll
          for (int g = 0; g < QG; ++g) {
            const float2 qf = __bfloat1622float2(qr[g][e]);
            acc[g] = fmaf(qf.x, kf.x, acc[g]);
            acc[g] = fmaf(qf.y, kf.y, acc[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < QG; ++g) s[g][cc] = live ? acc[g] * scale : -INFINITY;
      }
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        float mx = s[g][0];
#pragma unroll
        for (int cc = 1; cc < MAXKC; ++cc) mx = fmaxf(mx, s[g][cc]);
        mx = warp_max(mx);
        float sum = 0.0f;
#pragma unroll
        for (int cc = 0; cc < MAXKC; ++cc) {
          s[g][cc] = (lane + 32 * cc < nk) ? expf(s[g][cc] - mx) : 0.0f;
          sum += s[g][cc];
        }
        const float inv = 1.0f / warp_sum(sum);
#pragma unroll
        for (int cc = 0; cc < MAXKC; ++cc)
          pbuf[g * 32 * MAXKC + lane + 32 * cc] =
              bf(__float2bfloat16(s[g][cc] * inv));
      }
      __syncwarp();
      float o0[QG], o1[QG];
#pragma unroll
      for (int g = 0; g < QG; ++g) o0[g] = o1[g] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < nk; ++j) {
        const bf16* vj = v + j * ldkv + hd;
        const float v0 = bf(vj[lane]);
        const float v1 = wide && lane + 32 < dk ? bf(vj[lane + 32]) : 0.0f;
#pragma unroll
        for (int g = 0; g < QG; ++g) {
          const float pj = pbuf[g * 32 * MAXKC + j];
          o0[g] = fmaf(pj, v0, o0[g]);
          if (wide) o1[g] = fmaf(pj, v1, o1[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        if (i0 + g < nq) {
          if (lane < dk) o[(i0 + g) * ldo + hd + lane] = __float2bfloat16(o0[g]);
          if (lane + 32 < dk)
            o[(i0 + g) * ldo + hd + lane + 32] = __float2bfloat16(o1[g]);
        }
      }
      __syncwarp();   // pbuf is rewritten by the next pass
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) fused_ddim_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(p.t, p.nm, p.d, p.dp, p.fc);
  const int T = p.t, NM = p.nm, D = p.d, DP = p.dp, F = p.f, FC = p.fc;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int clip = blockIdx.x;

  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* h = reinterpret_cast<float*>(smem + L.h);
  bf16* za = reinterpret_cast<bf16*>(smem + L.za);
  bf16* ma = reinterpret_cast<bf16*>(smem + L.ma);
  bf16* big = reinterpret_cast<bf16*>(smem + L.big);
  bf16* ckv = reinterpret_cast<bf16*>(smem + L.ckv);
  float* stage = reinterpret_cast<float*>(smem + L.stage) +
                 warp * 16 * imax(L.mtx, L.mtm) * STRIP;

  // zero the operand areas so that pad rows of every row tile hold 0
  for (int i = tid; i < (L.stage - L.za) / 4; i += NTHREADS)
    reinterpret_cast<uint32_t*>(smem + L.za)[i] = 0u;
  __syncthreads();
  const float* xg = p.x_T + (size_t)clip * T * DP;
  for (int i = tid; i < T * DP; i += NTHREADS) xs[i] = xg[i];
  const bf16* mg = p.mem + (size_t)clip * NM * D;
  for (int i = D + tid; i < NM * D; i += NTHREADS)
    ma[(i / D) * L.ldm + i % D] = mg[i];
  const float* ba = p.blend_a ? p.blend_a + (size_t)clip * T * DP : nullptr;
  const float* bb = p.blend_b ? p.blend_b + (size_t)clip * T * DP : nullptr;
  const int dk = D / p.heads;
  const float scale = 1.0f / sqrtf((float)dk);

  for (int it = 0; it < p.steps; ++it) {
    const int s = p.steps - 1 - it;
    for (int c = tid; c < D; c += NTHREADS) ma[c] = p.tok[(size_t)s * D + c];
    for (int i = tid; i < T * DP; i += NTHREADS)
      za[(i / DP) * L.lda + i % DP] = __float2bfloat16(xs[i]);
    __syncthreads();
    matmul(za, L.lda, L.mtx, p.w_embx, DP, DP, D, stage,
           EpiEmbX{h, p.b_embx, p.pe_x, T, D});
    __syncthreads();

    for (int l = 0; l < p.layers; ++l) {
      const size_t dd = (size_t)D * D;
      // self-attention: merged QKV + dconv -> attention -> out-proj
      layer_norm(h, T, D, za, L.lda);
      __syncthreads();
      matmul(za, L.lda, L.mtx, p.self_wqkv + l * 3 * dd, D, D, 3 * D, stage,
             EpiDconv{big, L.ldqkv, p.self_bqkv + l * 3 * D,
                      p.self_dconv + l * 9 * D, p.self_dbias + l * 3 * D,
                      3 * D, T});
      __syncthreads();
      attention(big, L.ldqkv, big + D, big + 2 * D, L.ldqkv, T, T, p.heads, dk,
                scale, za, L.lda, stage);
      __syncthreads();
      matmul(za, L.lda, L.mtx, p.self_wo + l * dd, D, D, D, stage,
             EpiResid{h, p.self_bo + l * D, T, D});
      __syncthreads();

      // cross-attention: q from h, merged KV from the memory rows
      layer_norm(h, T, D, za, L.lda);
      __syncthreads();
      matmul(za, L.lda, L.mtx, p.cross_wq + l * dd, D, D, D, stage,
             EpiDconv{big, L.ldcq, p.cross_bq + l * D, p.cross_dq + l * 3 * D,
                      p.cross_dqb + l * D, D, T});
      matmul(ma, L.ldm, L.mtm, p.cross_wkv + l * 2 * dd, D, D, 2 * D, stage,
             EpiDconv{ckv, L.ldckv, p.cross_bkv + l * 2 * D,
                      p.cross_dkv + l * 6 * D, p.cross_dkvb + l * 2 * D, 2 * D,
                      NM});
      __syncthreads();
      attention(big, L.ldcq, ckv, ckv + D, L.ldckv, T, NM, p.heads, dk, scale,
                za, L.lda, stage);
      __syncthreads();
      matmul(za, L.lda, L.mtx, p.cross_wo + l * dd, D, D, D, stage,
             EpiResid{h, p.cross_bo + l * D, T, D});
      __syncthreads();

      // squared-ReLU FF in hidden chunks of FC
      layer_norm(h, T, D, za, L.lda);
      __syncthreads();
      for (int c0 = 0; c0 < F; c0 += FC) {
        matmul(za, L.lda, L.mtx, p.ff_w1 + ((size_t)l * F + c0) * D, D, D, FC,
               stage, EpiRelu2{big, L.ldf, p.ff_b1 + (size_t)l * F + c0, T});
        __syncthreads();
        matmul(big, L.ldf, L.mtx, p.ff_w2 + (size_t)l * D * F + c0, F, FC, D,
               stage, EpiResid{h, c0 == 0 ? p.ff_b2 + l * D : nullptr, T, D});
        __syncthreads();
      }
    }

    layer_norm(h, T, D, za, L.lda);
    __syncthreads();
    const float* cf = p.coefs + (size_t)s * 4;
    matmul(za, L.lda, L.mtx, p.w_out, D, D, DP, stage,
           EpiUpdate{xs, p.b_out, ba, bb, cf[0], cf[1], cf[2], cf[3], T, DP});
    __syncthreads();
  }

  float* og = p.out + (size_t)clip * T * DP;
  for (int i = tid; i < T * DP; i += NTHREADS) og[i] = xs[i];
}

extern "C" int fused_ddim_smem_bytes(int t, int nm, int d, int dp, int fc) {
  return make_layout(t, nm, d, dp, fc).total;
}

extern "C" int fused_ddim_launch(void** ptrs, int n_ptrs, const int* dims,
                                 int n_dims, void* stream) {
  if (n_ptrs != 32 || n_dims != 10) return (int)cudaErrorInvalidValue;
  Params p;
  p.x_T = (const float*)ptrs[0];       p.out = (float*)ptrs[1];
  p.mem = (const bf16*)ptrs[2];        p.tok = (const bf16*)ptrs[3];
  p.coefs = (const float*)ptrs[4];
  p.blend_a = (const float*)ptrs[5];   p.blend_b = (const float*)ptrs[6];
  p.w_embx = (const bf16*)ptrs[7];     p.b_embx = (const bf16*)ptrs[8];
  p.pe_x = (const float*)ptrs[9];
  p.self_wqkv = (const bf16*)ptrs[10]; p.self_bqkv = (const bf16*)ptrs[11];
  p.self_dconv = (const bf16*)ptrs[12]; p.self_dbias = (const bf16*)ptrs[13];
  p.self_wo = (const bf16*)ptrs[14];   p.self_bo = (const bf16*)ptrs[15];
  p.cross_wq = (const bf16*)ptrs[16];  p.cross_bq = (const bf16*)ptrs[17];
  p.cross_wkv = (const bf16*)ptrs[18]; p.cross_bkv = (const bf16*)ptrs[19];
  p.cross_dq = (const bf16*)ptrs[20];  p.cross_dqb = (const bf16*)ptrs[21];
  p.cross_dkv = (const bf16*)ptrs[22]; p.cross_dkvb = (const bf16*)ptrs[23];
  p.cross_wo = (const bf16*)ptrs[24];  p.cross_bo = (const bf16*)ptrs[25];
  p.ff_w1 = (const bf16*)ptrs[26];     p.ff_b1 = (const bf16*)ptrs[27];
  p.ff_w2 = (const bf16*)ptrs[28];     p.ff_b2 = (const bf16*)ptrs[29];
  p.w_out = (const bf16*)ptrs[30];     p.b_out = (const float*)ptrs[31];
  p.n = dims[0];  p.t = dims[1];  p.nm = dims[2];  p.d = dims[3];
  p.dp = dims[4]; p.f = dims[5];  p.layers = dims[6];  p.heads = dims[7];
  p.steps = dims[8];  p.fc = dims[9];

  const int dk = p.heads > 0 ? p.d / p.heads : 0;
  if (p.n < 1 || p.t < 1 || p.t > 16 * MAXMT || p.nm < 2 ||
      p.nm > 16 * MAXMT || p.nm > 32 * MAXKC || p.t > 32 * MAXKC ||
      p.heads < 1 || p.d % p.heads || dk % 2 || dk > 64 || p.d % STRIP ||
      p.dp % STRIP || p.fc % STRIP || p.fc < STRIP || p.f % p.fc ||
      p.steps < 1 || p.layers < 1)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(p.t, p.nm, p.d, p.dp, p.fc);
  if (L.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_ddim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  fused_ddim_kernel<<<p.n, NTHREADS, L.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
