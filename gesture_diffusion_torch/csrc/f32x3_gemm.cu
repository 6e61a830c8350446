// Float32-accurate matrix product on Hopper's tensor cores (sm_90a):
// y = x w^T + b for a float32 activation x (M, K) and an nn.Linear weight
// w (N, K), as three TF32 products with float32 sums.
//
// It replaces no TPU kernel: the JAX package leaves these products to XLA.
// It is added because the float32 products of the MMDiT decoder
// (models/mmdit.py) ran on cuBLAS's SIMT cores and took 92% of the device
// time of a float32 MMDiT step; the tensor cores run TF32 at 495 TFLOP/s
// dense, against 67 TFLOP/s of SIMT float32.
//
// Numerics.  A TF32 value keeps 10 mantissa bits.  Each operand is split
// as a = hi + lo, hi = tf32(a) and lo = tf32(a - hi), both rounded to
// nearest, ties to even, on the bits (tf32_rne): a - hi is exact in
// float32, and hi + lo carries about 22 bits of a.  The product takes
// lo_x hi_w + hi_x lo_w + hi_x hi_w at every k-step, in that order;
// lo_x lo_w (below 2^-22 of |x||w|) is dropped.  Each TF32 product of two
// such values is exact.  All three products run at every k-step for every
// weight, whatever its values.  The weight's two planes are made once by
// the wrapper (ops/f32_linear.py::pack_weight) into one (2N, K) float32
// tensor, hi rows above lo rows; x is split in registers as it is read.
// The tensor core's own accumulation loses bits (on an H100, summing a
// K of 1536-6144 in its accumulator read 1.0e-5 to 4.7e-5 of max|y|
// against float64, cuBLAS's float32 1.5e-6 to 4.2e-6), so each k-tile's
// 12 products start from zero in a second accumulator that is then added
// to the float32 sum in registers (1.8e-7 to 8.6e-7): the tensor core
// sums over 32 of K only.  An output element's arithmetic depends on
// neither its tile nor BN.
//
// Design: a block computes a tile of 128 rows x BN columns (BN 64, 128,
// 160 or 192, chosen by the host by shape: ops/f32_linear.py::tile_n).  One
// thread of a producer warpgroup keeps a ring of STAGES k-tiles of 32 in
// flight through TMA (x's 128 x 32 tile and both planes' BN x 32 tiles,
// 128-byte swizzled; rows past M or N and columns past K read as zeros);
// the producer's registers go to the two consumer warpgroups
// (setmaxnreg: 24 and 240), which take 64 rows each and hold two BN-wide
// accumulators.  A consumer reads its x fragment from shared memory into
// registers, splits it, and issues 12 wgmma m64nBNk8 a k-tile with A from
// registers and B (the weight planes) from shared memory, waits for them,
// and adds them to its sum.  The bias is added in float32 in the
// epilogue, which writes y straight from the registers.
//
// Bound on an H100 SXM: at the streams' shapes (544 and 1648 rows) the
// three products' operations, 3 x 2 M N K at 495e12 (one third of TF32's
// rate is float32 work at 165 TFLOP/s); at 16 rows (the modulation
// linears) the bytes the product needs, the float32 weight's 4 N K once,
// at 3.35e12.  What holds it from that: a block's k-tile is a chain of 12
// dependent wgmmas on one accumulator, then the wait and the promotion, a
// fixed cost of about 220 columns' worth a k-tile (tile_n), so wide tiles
// run best; tiles do not fill the 132 SMs evenly at 1648 and 544 rows; at
// 16 rows it reads both planes, 8 N K bytes, twice the bound's, and at N
// 3072 its 48 blocks of 64 columns leave most SMs idle, where cuBLAS's
// float32 GEMV is faster (tools/f32x3_gemm_compare.py).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // rows a block: two consumer warpgroups of 64
constexpr int BK = 32;           // k a stage: one 128-byte swizzled row of floats
constexpr int THREADS = 384;     // two consumer warpgroups and the producer's
constexpr int SMEM_LIMIT = 232448;
constexpr int ERR_ENCODE = 1000; // cuTensorMapEncodeTiled refused a map
constexpr int ERR_ENTRY = 1001;  // the driver gave no cuTensorMapEncodeTiled

template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 4;           // one plane
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES_FIT = (SMEM_LIMIT - 1024 - 256) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 6 ? STAGES_FIT : 6;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 16 * STAGES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// float32 -> TF32 (10 mantissa bits), round to nearest, ties to even;
// inf and NaN unchanged; a carry past the largest finite gives inf
__device__ __forceinline__ uint32_t tf32_rne(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;
  return (u + 0xfffu + ((u >> 13) & 1u)) & 0xffffe000u;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(k), "r"(row) : "memory");
}

// wgmma operand descriptor of a K-major, 128-byte-swizzled tile whose
// 8-row groups lie 1024 bytes apart (the base 1024-aligned)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3ffffu) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving register reads or writes of v across an
// asynchronous wgmma's issue or wait
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v) :: "memory");
}

// d (m64 x n) += a (m64 x k8, TF32 in registers) b (n x k8, TF32 in shared
// memory); scale_d 0 gives d = a b
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<192>(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<160>(float (&d)[80], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// one k-tile of 32 into d, from zero: at each k-step lo_x hi_w, hi_x lo_w,
// hi_x hi_w
template <int BN>
__device__ __forceinline__ void ktile_products(float (&d)[BN / 2], const uint32_t (&hi)[4][4],
                                               const uint32_t (&lo)[4][4], uint64_t dh,
                                               uint64_t dl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32<BN>(d, lo[kk], dh + 2 * kk, kk == 0 ? 0 : 1);
    wgmma_tf32<BN>(d, hi[kk], dl + 2 * kk, 1);
    wgmma_tf32<BN>(d, hi[kk], dh + 2 * kk, 1);
  }
}

// x's fragment of one k-tile for this thread, split: rows r0 and r0 + 8,
// k 8 kk + t and 8 kk + t + 4 (wgmma's A layout), read from the
// 128-byte-swizzled tile
__device__ __forceinline__ void split_fragment(const uint8_t* a_tile, int r0, int t,
                                               uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 8 * (j & 1);
      const int chunk = (2 * kk + (j >> 1)) ^ (r & 7);
      const float v = *reinterpret_cast<const float*>(a_tile + r * 128 + chunk * 16 + t * 4);
      hi[kk][j] = tf32_rne(v);
      lo[kk][j] = tf32_rne(v - __uint_as_float(hi[kk][j]));
    }
  }
}

// a consumer warpgroup's k-tile: wait for the stage, split x, issue the
// products into part from zero (asynchronous: committed, not waited for)
template <int BN>
__device__ __forceinline__ void issue_ktile(const uint8_t* smem, uint64_t* full, int kt,
                                            int r0, int t, float (&part)[BN / 2],
                                            uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
  using T = Tile<BN>;
  const int s = kt % T::STAGES;
  mbar_wait(&full[s], (kt / T::STAGES) & 1);
  const uint8_t* a_tile = smem + s * T::STAGE_BYTES;
  split_fragment(a_tile, r0, t, hi, lo);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(part[i]);
  wgmma_fence();
  ktile_products<BN>(part, hi, lo, desc_sw128(a_tile + T::A_BYTES),
                     desc_sw128(a_tile + T::A_BYTES + T::B_BYTES));
  wgmma_commit();
}

// k-tile kt's products are done: add them to the float32 sum and free the
// stage
template <int BN>
__device__ __forceinline__ void retire_ktile(uint64_t* empty, int kt, int lane,
                                             float (&acc)[BN / 2], float (&part)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    fence_operand(part[i]);
    acc[i] += part[i];
  }
  if (lane == 0) mbar_arrive(&empty[kt % Tile<BN>::STAGES]);
}

// a consumer warpgroup: rows m0 + 64 wg + [0, 64) of the block's tile;
// each k-tile is issued, waited for and added to the float32 sum in turn.
// (Two accumulators in turn, k-tile kt + 1 issued before kt is waited
// for, were tried at BN 64: ptxas serialises the wgmmas, C7514, and the
// time did not move.)
template <int BN>
__device__ __forceinline__ void consume(const uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, const float* __restrict__ bias,
                                        float* __restrict__ y, int M, int N, int k_tiles,
                                        int m0, int n0, int warp, int lane) {
  using T = Tile<BN>;
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + g;     // and r0 + 8
  if (m0 + 64 * wg >= M) {                           // a shape test, not a value one
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(&full[kt % T::STAGES], (kt / T::STAGES) & 1);
      if (lane == 0) mbar_arrive(&empty[kt % T::STAGES]);
    }
    return;
  }
  float acc[BN / 2], part[BN / 2];
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    issue_ktile<BN>(smem, full, kt, r0, t, part, hi, lo);
    wgmma_wait_all();
    retire_ktile<BN>(empty, kt, lane, acc, part);
  }

  // d[4 j + e]: row r0 + 8 (e >> 1), column 8 j + 2 t + (e & 1)
  const int row_a = m0 + r0, row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= N) continue;
    float b0 = 0.0f, b1 = 0.0f;
    if (bias != nullptr) {
      b0 = bias[col];
      b1 = bias[col + 1];
    }
    if (row_a < M)
      *reinterpret_cast<float2*>(y + (size_t)row_a * N + col) =
          make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    if (row_b < M)
      *reinterpret_cast<float2*>(y + (size_t)row_b * N + col) =
          make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
f32x3_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const float* __restrict__ bias, float* __restrict__ y,
                  int M, int N, int K) {
  using T = Tile<BN>;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * T::STAGE_BYTES);
  uint64_t* empty = full + S;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // the producer warpgroup: one thread issues the loads; the others
    // only hand their registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&map_x)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&map_w)) : "memory");
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % S;
        mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        uint8_t* a = smem + s * T::STAGE_BYTES;
        mbar_expect_tx(&full[s], T::STAGE_BYTES);
        tma_load(a, &map_x, &full[s], kt * BK, m0);
        tma_load(a + T::A_BYTES, &map_w, &full[s], kt * BK, n0);
        tma_load(a + T::A_BYTES + T::B_BYTES, &map_w, &full[s], kt * BK, N + n0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<BN>(smem, full, empty, bias, y, M, N, k_tiles, m0, n0, warp, lane);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, K) row-major float32 matrix, read in boxes of box_rows x 32
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int K, int rows,
            int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const float* bias, float* y,
           int M, int N, int K, cudaStream_t stream) {
  // the shared-memory attribute is the current device's: set once a card
  constexpr int CARDS = 64;
  static bool ready[CARDS] = {};
  auto kernel = f32x3_gemm_kernel<BN>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= CARDS || !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<BN>::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < CARDS) ready[dev] = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, THREADS, Tile<BN>::SMEM, stream>>>(mx, mw, bias, y, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (M, N) = x (M, K) w^T + bias, w given as its (2N, K) pack [hi; lo];
// bias may be null.  Launches on `stream` and does not synchronise.
// Returns 0, a CUDA error code, ERR_ENCODE or ERR_ENTRY; an unsupported
// bn, or K not a multiple of 4 or N odd, give cudaErrorInvalidValue.
int f32x3_gemm_launch(const void* x, const void* pack, const void* bias, void* y,
                      int M, int N, int K, int bn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || N % 2 != 0)
    return cudaErrorInvalidValue;
  if (bn != 64 && bn != 128 && bn != 160 && bn != 192) return cudaErrorInvalidValue;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_ENTRY;
  CUtensorMap mx, mw;
  if (!encode(fn, &mx, x, K, M, BM) || !encode(fn, &mw, pack, K, 2 * N, bn))
    return ERR_ENCODE;
  const float* b = static_cast<const float*>(bias);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return launch<64>(mx, mw, b, out, M, N, K, s);
  if (bn == 128) return launch<128>(mx, mw, b, out, M, N, K, s);
  if (bn == 160) return launch<160>(mx, mw, b, out, M, N, K, s);
  return launch<192>(mx, mw, b, out, M, N, K, s);
}

const char* f32x3_gemm_error(int code) {
  if (code == ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  if (code == ERR_ENTRY) return "the driver has no cuTensorMapEncodeTiled";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
