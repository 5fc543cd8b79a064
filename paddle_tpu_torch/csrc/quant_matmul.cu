// Kernel #7: fused dequant-matmul for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant_matmul.py:dequant_matmul
// (its pallas_call at :121, bodies _wo_kernel and _dyn_kernel).  x [M, K] is
// float32, bfloat16 or float16; qw [K, N] int8; scale [N] float32 dequant
// multipliers (w ~= qw * scale); the result is the float32 [M, N]:
//
// * weight_only: (x_f32 @ qw_f32) * scale[n].  int8 values are exact in
//   float32, TF32, bfloat16 and float16, so the dequant is the widening
//   itself; the per-column scale is applied to the accumulator in the
//   epilogue (_wo_kernel's acc * s).
// * dynamic: each row of x gets its own int8 grid, sx = max(max|x|, 1e-12) /
//   rng (or the static envelope max(xscale, 1e-12) / rng of a trained QAT
//   activation scale; rng = 2^(bits-1) - 1), qx = clip(rint(x / sx), -rng,
//   rng); then an int8 x int8 -> int32 product, and the epilogue (float(acc)
//   * sx) * scale[n], in that order, as _dyn_kernel.  Division is IEEE (no
//   fast-math flags), rintf rounds half to even and the abs-max propagates
//   NaN, as jnp.round / torch.round / amax do, so qx, sx and the int32
//   accumulator equal the plain version bit for bit.
//
// What bounds it on the H100.  Decode (M = 8) reads the int8 weight once and
// does 2 M flops per weight byte: device memory binds (the logits projection
// moves 16.4 MB, ~5 us at 3.35 TB/s).  Prefill (M = 4096) is operations:
// float32 x takes two TF32 passes on the tensor cores (x = x_hi + x_lo; w
// has no lo part), 2 x 2 M K N / 495 TFLOP/s; dynamic one int8 pass.
//
// Design.  qw stays [K, N] int8 as the program stores it; no dequantized or
// transposed copy is written to device memory.
//  - Tensor cores through mma.sync (wgmma.cuh): float32 x as x_hi w + x_lo w
//    (m16n8k8 TF32), bfloat16 / float16 x as one m16n8k16 pass with w
//    converted exactly, dynamic as m16n8k32 s8 (IMMA; integer sums are
//    exact in any order).  TF32 and s8 wgmma take B K-major only, and qw is
//    N-major.
//  - B fragments straight from the int8 tile in shared memory: a warp's
//    column tile j, column g is the strip's column NJ g + j, so a thread's
//    bytes of one row are one 4- or 8-byte load; bytes become floats by the
//    2^23 bias (two operations) and s8 fragments (4 k a register) by byte
//    permutes.  The tile's 16-byte chunks rotate by row, so that the rows
//    of every fragment pattern fall in distinct banks.
//  - Decode (M <= 32, the gemv kernel): a block takes 128 columns and 8,
//    16 or 32 rows, the product transposed (out^T = w^T x^T: the weight
//    fills the mma's 16-row side, x's rows its 8-wide one); a ring of up to
//    8 stages of 16-byte cp.async keeps the block's weight slice in flight
//    at once.  8 warps: 4 column groups x 2 halves of each stage's rows,
//    the halves' sums added in order at the end.  Where the column strips
//    leave SMs idle, K is split over a thread block cluster of up to 8
//    blocks and the partial sums meet in distributed shared memory, added
//    in rank order (the same bits every run): no scratch, no second pass.
//    Dynamic mode computes its rows' int8 grid inside the same kernel:
//    each rank takes the abs-max of its x slice, the ranks exchange them
//    through distributed shared memory (a max is exact in any order), and
//    each quantizes its slice; strip 0's blocks write qx / sx when asked.
//    One launch a call in both modes.
//  - Prefill (the gemm kernel): 128 x 128 tiles, 8 warps of 32 x 64, x and
//    w tiles by 16-byte cp.async in a 3-4 stage ring.  Dynamic mode takes
//    qx / sx from a one-warp-a-row grid pass before it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "dtype.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using ptt::to_f;

constexpr int kBN = 128;          // columns a block (a weight row's 128 bytes)
constexpr int kWBK = 64;          // weight rows a stage of the decode kernel
constexpr int kDecodeM = 32;      // rows the decode kernel takes
constexpr int kDecodeThreads = 256;  // 4 column groups x 2 halves of K
constexpr int kDecodeStages = 8;  // at most 64 KB of weight in flight a block
constexpr int kDecodeX = 65536;   // bytes of a decode block's float32 x slice
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kDecodeWave = 2 * 132;  // decode blocks worth aiming for
constexpr int kGemmThreads = 256;
constexpr int kRowThreads = 256;

enum Mode { kWeightOnly = 0, kDynamic = 1 };

// NaN-propagating max, as jnp.max / torch.amax: a NaN row gives a NaN grid
// and NaN outputs (which the serving engine then quarantines)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// ---------------------------------------------------------------------------
// copies: 16 bytes of a row into shared memory
// ---------------------------------------------------------------------------

// bytes [col, col + 16) of a row of `valid` bytes (past it: zeros) to
// shared address dst.  vec 16: one 16-byte cp.async (row and col 16-byte
// aligned); 4: four 4-byte ones (valid % 4 == 0); 1: through registers.
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* row,
                                       int col, int valid, int vec) {
  if (vec == 16) {
    const bool in = col < valid;
    cp_async16(smem_u32(dst), in ? row + col : row, in ? 16 : 0);
  } else if (vec == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = col + 4 * i < valid;
      cp_async_small<4>(smem_u32(dst + 4 * i), in ? row + col + 4 * i : row,
                        in ? 4 : 0);
    }
  } else {
    uint32_t w[4] = {};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (col + i < valid) w[i / 4] |= (uint32_t)row[col + i] << (8 * (i % 4));
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the widest copy a row layout allows: rows of `row_bytes` from `base`
__host__ int vec_of(const void* base, long row_bytes) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  if (p % 16 == 0 && row_bytes % 16 == 0) return 16;
  if (p % 4 == 0 && row_bytes % 4 == 0) return 4;
  return 1;
}

// ---------------------------------------------------------------------------
// the int8 weight tile in shared memory: rows of 128 bytes (the block's
// columns); 16-byte chunk c of row r sits at chunk (c + 2 rot(r)) % 8, so
// that the rows a fragment reads together (r + t, r + 2t + i, r + 4t + i
// over t = 0..3) land 8 words apart: distinct banks
// ---------------------------------------------------------------------------

__device__ __forceinline__ int wrot(int r) { return (r ^ (r >> 2)) & 3; }
__device__ __forceinline__ int wchunk(int r, int c) {
  return r * 8 + ((c + 2 * wrot(r)) & 7);
}

// NJ bytes of weight row r (NJ / 4 words from word w0): byte j is the
// thread's column j
template <int NJ>
__device__ __forceinline__ void wrow(const uint8_t* tile, int r, int w0,
                                     uint32_t (&out)[NJ / 4]) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(tile) + r * 32 +
                      ((w0 + 8 * wrot(r)) & 31);
  if constexpr (NJ == 4) {
    out[0] = p[0];
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
}

// signed byte i of w as an exact float: its biased byte under the exponent
// of 2^23, minus 2^23 + 128
__device__ __forceinline__ float byte_f(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | i)) -
         8388736.f;
}

// a 16-bit pair (lo, hi) of exact int8 values in x's type
template <typename T>
__device__ __forceinline__ uint32_t half2_of(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>)
    return (uint32_t)__half_as_ushort(__float2half_rn(lo)) |
           ((uint32_t)__half_as_ushort(__float2half_rn(hi)) << 16);
  else  // bfloat16: the high half of the float, exact at 7 bits
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// a float32 x (its bits) as hi + lo TF32 parts: hi truncated (one AND), lo
// = x - hi exact in float32, of which the tensor core reads the top 19
// bits: |x - hi - lo| <= 2^-21 |x|.  The weight needs no lo part.
__device__ __forceinline__ void split_x(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// B fragments of one k step (rows k.. of the tile) for NJ column tiles:
//   TF32 (float32 x): {W(k + t), W(k + t + 4)} as floats (no lo part)
//   16-bit x:        {W(k + 2t, k + 2t + 1), W(k + 2t + 8, k + 2t + 9)}
//   s8 (dynamic):    {W(k + 4t .. + 3), W(k + 16 + 4t .. + 3)} packed
template <int MODE, typename T, int NJ>
__device__ __forceinline__ void load_bw(const uint8_t* tile, int k, int w0,
                                        uint32_t (&b)[NJ][2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  w0 += (NJ / 4) * g;  // the thread's NJ columns
  if constexpr (MODE == kDynamic) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t r[4][NJ / 4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wrow<NJ>(tile, k + 16 * h + 4 * t + i, w0, r[i]);
#pragma unroll
      for (int q = 0; q < NJ / 4; ++q) {
        // 4 rows x 4 columns of bytes -> 4 columns of 4 k
        const uint32_t t0 = __byte_perm(r[0][q], r[1][q], 0x5140);
        const uint32_t t1 = __byte_perm(r[2][q], r[3][q], 0x5140);
        const uint32_t t2 = __byte_perm(r[0][q], r[1][q], 0x7362);
        const uint32_t t3 = __byte_perm(r[2][q], r[3][q], 0x7362);
        b[4 * q + 0][h] = __byte_perm(t0, t1, 0x5410);
        b[4 * q + 1][h] = __byte_perm(t0, t1, 0x7632);
        b[4 * q + 2][h] = __byte_perm(t2, t3, 0x5410);
        b[4 * q + 3][h] = __byte_perm(t2, t3, 0x7632);
      }
    }
  } else if constexpr (sizeof(T) == 4) {
    uint32_t r0[NJ / 4], r1[NJ / 4];
    wrow<NJ>(tile, k + t, w0, r0);
    wrow<NJ>(tile, k + t + 4, w0, r1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      b[j][0] = __float_as_uint(byte_f(r0[j / 4], j % 4));
      b[j][1] = __float_as_uint(byte_f(r1[j / 4], j % 4));
    }
  } else {
    uint32_t r[4][NJ / 4];
    wrow<NJ>(tile, k + 2 * t, w0, r[0]);
    wrow<NJ>(tile, k + 2 * t + 1, w0, r[1]);
    wrow<NJ>(tile, k + 2 * t + 8, w0, r[2]);
    wrow<NJ>(tile, k + 2 * t + 9, w0, r[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      b[j][0] = half2_of<T>(byte_f(r[0][j / 4], j % 4), byte_f(r[1][j / 4], j % 4));
      b[j][1] = half2_of<T>(byte_f(r[2][j / 4], j % 4), byte_f(r[3][j / 4], j % 4));
    }
  }
}

// the accumulator of a mode: float32, or int32 for the int8 product
template <int MODE>
using Acc = std::conditional_t<MODE == kDynamic, int, float>;

// one k step: acc[i][j] += A_i B_j.  A's fragments are words of x's rows:
// word (16 i + g (+ 8), kw + t (+ 4)) for every type (kw: the step's first
// word); float32 x is split into hi / lo TF32 and takes two passes, small
// terms first.
template <int MODE, typename T, int MT, int NJ, class FA>
__device__ __forceinline__ void kstep(Acc<MODE> (&acc)[MT][NJ][4], FA word,
                                      int kw, const uint8_t* wtile, int k,
                                      int w0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  uint32_t a[MT][4], b[NJ][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    a[i][0] = word(16 * i + g, kw + t);
    a[i][1] = word(16 * i + g + 8, kw + t);
    a[i][2] = word(16 * i + g, kw + t + 4);
    a[i][3] = word(16 * i + g + 8, kw + t + 4);
  }
  load_bw<MODE, T, NJ>(wtile, k, w0, b);
  if constexpr (MODE == kDynamic) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_s8(acc[i][j], a[i], b[j]);
  } else if constexpr (sizeof(T) == 4) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_x(a[i][e], ah[i][e], al[i][e]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], al[i], b[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], ah[i], b[j]);
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if constexpr (std::is_same_v<T, __half>)
          mma_f16(acc[i][j], a[i], b[j]);
        else
          mma_bf16(acc[i][j], a[i], b[j]);
      }
  }
}

// one k step of the decode kernel, which takes the product transposed,
// out^T = w^T x^T: the weight is the A operand (16 columns an m tile, no
// row wasted) and x's rows the B operand (8 a tile, MB of them), so M = 8
// fills the mma exactly.  The warp's 32 columns are 2 m tiles; the
// thread's four (tile i, row g + 8 h) are byte 2 i + h of its word of each
// weight row, columns 4 g .. 4 g + 3 of the strip.  B's fragments are
// words (8 j + g, kw + t (+ 4)) of x for every type; float32 x is split
// into hi / lo TF32 and takes two passes, small terms first.
template <int MODE, typename T, int MB, class FX>
__device__ __forceinline__ void kstep_t(Acc<MODE> (&acc)[2][MB][4], FX word,
                                        int kw, const uint8_t* wtile, int k,
                                        int w0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  w0 += g;
  uint32_t a[2][4], b[MB][2];
#pragma unroll
  for (int j = 0; j < MB; ++j) {
    b[j][0] = word(8 * j + g, kw + t);
    b[j][1] = word(8 * j + g, kw + t + 4);
  }
  if constexpr (MODE == kDynamic) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t r[4][1];
#pragma unroll
      for (int i = 0; i < 4; ++i) wrow<4>(wtile, k + 16 * h + 4 * t + i, w0, r[i]);
      // 4 rows x 4 columns of bytes -> 4 columns of 4 k
      const uint32_t t0 = __byte_perm(r[0][0], r[1][0], 0x5140);
      const uint32_t t1 = __byte_perm(r[2][0], r[3][0], 0x5140);
      const uint32_t t2 = __byte_perm(r[0][0], r[1][0], 0x7362);
      const uint32_t t3 = __byte_perm(r[2][0], r[3][0], 0x7362);
      a[0][2 * h] = __byte_perm(t0, t1, 0x5410);
      a[0][2 * h + 1] = __byte_perm(t0, t1, 0x7632);
      a[1][2 * h] = __byte_perm(t2, t3, 0x5410);
      a[1][2 * h + 1] = __byte_perm(t2, t3, 0x7632);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j) mma_s8(acc[i][j], a[i], b[j]);
  } else if constexpr (sizeof(T) == 4) {
    uint32_t r0[1], r1[1];
    wrow<4>(wtile, k + t, w0, r0);
    wrow<4>(wtile, k + t + 4, w0, r1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i][0] = __float_as_uint(byte_f(r0[0], 2 * i));
      a[i][1] = __float_as_uint(byte_f(r0[0], 2 * i + 1));
      a[i][2] = __float_as_uint(byte_f(r1[0], 2 * i));
      a[i][3] = __float_as_uint(byte_f(r1[0], 2 * i + 1));
    }
    uint32_t bh[MB][2], bl[MB][2];
#pragma unroll
    for (int j = 0; j < MB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) split_x(b[j][e], bh[j][e], bl[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j) mma_tf32(acc[i][j], a[i], bl[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j) mma_tf32(acc[i][j], a[i], bh[j]);
  } else {
    uint32_t r[4][1];
    wrow<4>(wtile, k + 2 * t, w0, r[0]);
    wrow<4>(wtile, k + 2 * t + 1, w0, r[1]);
    wrow<4>(wtile, k + 2 * t + 8, w0, r[2]);
    wrow<4>(wtile, k + 2 * t + 9, w0, r[3]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[i][h] = half2_of<T>(byte_f(r[0][0], 2 * i + h), byte_f(r[1][0], 2 * i + h));
        a[i][2 + h] =
            half2_of<T>(byte_f(r[2][0], 2 * i + h), byte_f(r[3][0], 2 * i + h));
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        if constexpr (std::is_same_v<T, __half>)
          mma_f16(acc[i][j], a[i], b[j]);
        else
          mma_bf16(acc[i][j], a[i], b[j]);
      }
  }
}

// the epilogue of one output: weight_only acc * scale[n]; dynamic
// (float(acc) * sx[m]) * scale[n], in _dyn_kernel's order
template <int MODE>
__device__ __forceinline__ float finish(Acc<MODE> a, float sxm, float sn) {
  if constexpr (MODE == kDynamic)
    return __fmul_rn(__fmul_rn((float)a, sxm), sn);
  else
    return a * sn;
}

// outputs [n, n + 4) of row m from four accumulators: one 16-byte store
// where N and the pointers allow
template <int MODE>
__device__ __forceinline__ void store_row(const Acc<MODE> (&v)[4], int m, int n,
                                          int N, float sxm,
                                          const float* __restrict__ scale,
                                          float* __restrict__ out,
                                          int32_t* __restrict__ acc_out) {
  const size_t o = (size_t)m * N + n;
  const bool vec = N % 4 == 0 && n + 4 <= N &&
                   ((reinterpret_cast<uintptr_t>(scale) |
                     reinterpret_cast<uintptr_t>(out) |
                     reinterpret_cast<uintptr_t>(acc_out)) & 15) == 0;
  if (vec) {
    const float4 s4 = *reinterpret_cast<const float4*>(scale + n);
    *reinterpret_cast<float4*>(out + o) = make_float4(
        finish<MODE>(v[0], sxm, s4.x), finish<MODE>(v[1], sxm, s4.y),
        finish<MODE>(v[2], sxm, s4.z), finish<MODE>(v[3], sxm, s4.w));
    if (acc_out != nullptr)
      *reinterpret_cast<int4*>(acc_out + o) =
          make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (n + c >= N) continue;
    out[o + c] = finish<MODE>(v[c], sxm, scale[n + c]);
    if (acc_out != nullptr) acc_out[o + c] = (int32_t)v[c];
  }
}

// four accumulators to 16-byte aligned shared memory
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(int* p, int a, int b, int c, int d) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}

// k elements a step of mma takes, and a 4-byte word holds, per mode / type
template <int MODE, typename T>
constexpr int kKStep = MODE == kDynamic ? 32 : (sizeof(T) == 4 ? 8 : 16);
template <int MODE, typename T>
constexpr int kPerWord = MODE == kDynamic ? 4 : 4 / (int)sizeof(T);

// ---------------------------------------------------------------------------
// decode: M <= 32 rows, K split over a cluster
// ---------------------------------------------------------------------------

struct Plan {
  bool gemv;
  int splits, kchunk;
};

int round_up(long a, int b) { return (int)((a + b - 1) / b * b); }

// the decode kernel's K split: doubled while the column strips leave the
// card short of blocks and each rank keeps a stage of 64 rows, then while
// a rank's float32 x slice would pass kDecodeX; past 8 ranks (or M > 32)
// the prefill kernel takes the shape
Plan plan_of(int M, int N, int K) {
  if (M > kDecodeM) return {false, 1, K};
  const long strips = (N + kBN - 1) / kBN;
  const int bm = M <= 8 ? 8 : M <= 16 ? 16 : 32;  // x rows a block
  auto chunk = [&](int s) { return std::max(kWBK, round_up((K + s - 1) / s, kWBK)); };
  int s = 1;
  while (s < kMaxCluster && strips * s * 2 <= kDecodeWave &&
         (K + 2 * s - 1) / (2 * s) >= kWBK)
    s *= 2;
  while (s < kMaxCluster && (long)chunk(s) * bm * 4 > kDecodeX) s *= 2;
  if ((long)chunk(s) * bm * 4 > kDecodeX) return {false, 1, K};
  return {true, s, chunk(s)};
}

// shared memory of a decode block: the weight ring, x's slice as it is
// (row stride: the slice plus 16 bytes), dynamic mode's int8 slice, and
// the rows' abs-max and scales
template <int MODE, typename T>
struct DecodeSmem {
  // weight stages in the ring: the slice's, up to kDecodeStages
  __host__ __device__ static int ring(int kchunk) {
    return min(kDecodeStages, kchunk / kWBK);
  }
  __host__ __device__ static int xld(int kchunk) {
    return kchunk * (int)sizeof(T) + 16;
  }
  __host__ __device__ static int qld(int kchunk) { return kchunk + 16; }
  // the ring, x's slice, its int8 grid and the rows' abs-max and scales;
  // at least the epilogue's [bm][128] partial sums (over the ring)
  static size_t bytes(int kchunk, int bm) {
    return std::max((size_t)ring(kchunk) * kWBK * kBN + (size_t)bm * xld(kchunk) +
                        (MODE == kDynamic ? (size_t)bm * qld(kchunk) : 0) +
                        2 * kDecodeM * sizeof(float),
                    (size_t)bm * kBN * 4);
  }
};

// cp.async.wait_group with a count known only at run time
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    default: cp_wait<7>(); break;
  }
}

template <int MODE, typename T, int MB>
__global__ void __launch_bounds__(kDecodeThreads)
gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
            const float* __restrict__ scale, const float* __restrict__ xscale,
            int8_t* __restrict__ qx, float* __restrict__ sx,
            float* __restrict__ out, int32_t* __restrict__ acc_out, int M,
            int N, int K, int Kp, int kchunk, float rng, int xvec, int wvec,
            int cluster) {
  constexpr int BM = 8 * MB;
  extern __shared__ __align__(128) uint8_t smem[];
  using Sm = DecodeSmem<MODE, T>;
  const int S = Sm::ring(kchunk);  // ring slots
  uint8_t* ring = smem;
  uint8_t* xs = ring + S * kWBK * kBN;
  uint8_t* qs = xs + BM * Sm::xld(kchunk);
  float* sAmax = reinterpret_cast<float*>(
      qs + (MODE == kDynamic ? BM * Sm::qld(kchunk) : 0));  // [32]
  float* sSx = sAmax + kDecodeM;                             // [32]

  const int rank = blockIdx.x % cluster, strip = blockIdx.x / cluster;
  const int n0 = strip * kBN;
  const int ks = min(rank * kchunk, K), ke = min(ks + kchunk, K);
  const int nst = (ke - ks + kWBK - 1) / kWBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int xld = Sm::xld(kchunk);

  // x's slice, rows past M and columns past ke zero (group 0)
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  const int xrow = K * (int)sizeof(T), xvalid = (ke - ks) * (int)sizeof(T);
  for (int c = tid; c < BM * (xld / 16); c += kDecodeThreads) {
    const int r = c / (xld / 16), col = (c % (xld / 16)) * 16;
    copy16(xs + r * xld + col, xb + (size_t)min(r, M - 1) * xrow + ks * sizeof(T),
           col, r < M ? xvalid : 0, xvec);
  }
  cp_commit();
  // weight stages (one group each, empty past the slice): the whole
  // slice in flight at once, up to 8 stages
  auto load_stage = [&](int st) {
    if (st < nst) {
      uint8_t* tile = ring + (st % S) * kWBK * kBN;
      for (int c = tid; c < kWBK * 8; c += kDecodeThreads) {
        const int r = c >> 3, gk = ks + st * kWBK + r;
        copy16(tile + wchunk(r, c & 7) * 16,
               reinterpret_cast<const uint8_t*>(qw) + (size_t)max(min(gk, K - 1), 0) * N,
               n0 + (c & 7) * 16, gk < ke ? N : 0, wvec);
      }
    }
    cp_commit();
  };
  for (int st = 0; st < S - 1; ++st) load_stage(st);

  cg::cluster_group cl = cg::this_cluster();
  if constexpr (MODE == kDynamic) {
    // the rows' int8 grid: this rank's abs-max of its slice, then the
    // cluster's through distributed shared memory (exact in any order)
    cp_wait_upto(S - 1);  // x's slice
    __syncthreads();
    for (int m = warp; m < M; m += kDecodeThreads / 32) {
      float amax = 0.f;
      const T* xr = reinterpret_cast<const T*>(xs + m * xld);
      for (int k = lane; k < ke - ks; k += 32)
        amax = nan_max(fabsf(to_f(xr[k])), amax);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = nan_max(__shfl_xor_sync(0xffffffffu, amax, off), amax);
      if (lane == 0) sAmax[m] = amax;
    }
    if (cluster > 1 && xscale == nullptr)
      cl.sync();
    else
      __syncthreads();
    if (tid < M) {
      float amax = xscale != nullptr ? xscale[0] : sAmax[tid];
      if (xscale == nullptr)
        for (int r = 0; r < cluster; ++r)
          if (r != rank) amax = nan_max(cl.map_shared_rank(sAmax, r)[tid], amax);
      const float s = nan_max(amax, 1e-12f) / rng;  // IEEE division
      sSx[tid] = s;
      if (sx != nullptr && strip == 0 && rank == 0) sx[tid] = s;
    }
    __syncthreads();
    const int qld = Sm::qld(kchunk);
    // the slice on the grid (zero past ke); strip 0 writes qx when asked
    const int kq = ke == K ? Kp : ke;
    for (int m = 0; m < M; ++m) {
      const T* xr = reinterpret_cast<const T*>(xs + m * xld);
      const float sm = sSx[m];
      for (int kk = tid; kk < kchunk; kk += kDecodeThreads) {
        const int k = ks + kk;
        float q = 0.f;
        if (k < ke) q = fminf(fmaxf(rintf(to_f(xr[kk]) / sm), -rng), rng);
        qs[m * qld + kk] = (int8_t)q;
        if (qx != nullptr && strip == 0 && ks < ke && k < kq)
          qx[(size_t)m * Kp + k] = (int8_t)q;
      }
    }
    // rows past M: zero
    for (int i = tid; i < (BM - M) * qld / 16; i += kDecodeThreads)
      reinterpret_cast<uint4*>(qs + M * qld)[i] = make_uint4(0, 0, 0, 0);
  }

  // the product over this rank's weight rows: warp w takes the 32 columns
  // 32 (w % 4) .. and the half w / 4 of each stage's rows
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int wc = warp & 3, kh = warp >> 2;
  Acc<MODE> acc[2][MB][4] = {};
  constexpr int PW = kPerWord<MODE, T>, KS = kKStep<MODE, T>;
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(MODE == kDynamic ? qs : xs);
  const int ald = (MODE == kDynamic ? Sm::qld(kchunk) : xld) / 4;
  auto word = [&](int r, int c) { return aw[r * ald + c]; };
  for (int st = 0; st < nst; ++st) {
    load_stage(st + S - 1);
    cp_wait_upto(S - 1);
    __syncthreads();
    const uint8_t* tile = ring + (st % S) * kWBK * kBN;
#pragma unroll
    for (int kk = 0; kk < kWBK / 2; kk += KS) {
      const int k = kh * kWBK / 2 + kk;  // the warp's half of the stage
      kstep_t<MODE, T, MB>(acc, word, (st * kWBK + k) / PW, tile, k, 8 * wc);
    }
    __syncthreads();
  }

  // the two halves' sums, in a fixed order: warps 4-7 hand theirs to 0-3
  // through shared memory (the ring is free)
  Acc<MODE>* xch = reinterpret_cast<Acc<MODE>*>(ring);  // [8 MB][128]
  const int ht = tid & (kDecodeThreads / 2 - 1);
  if (kh == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[((i * MB + j) * 4 + e) * 128 + ht] = acc[i][j][e];
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += xch[((i * MB + j) * 4 + e) * 128 + ht];
  }
  __syncthreads();

  // outputs (warps 0-3): the thread holds rows 8 j + 2 t + e, columns
  // 4 g .. 4 g + 3 of the warp's strip: tile i's rows g and g + 8
  // (accumulator elements e and 2 + e)
  const int c0 = n0 + 32 * wc + 4 * g;
  auto four = [&](int j, int e, Acc<MODE> (&v)[4]) {
    v[0] = acc[0][j][e];
    v[1] = acc[0][j][2 + e];
    v[2] = acc[1][j][e];
    v[3] = acc[1][j][2 + e];
  };
  if (cluster == 1) {
    if (kh == 1) return;
#pragma unroll
    for (int j = 0; j < MB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * t + e;
        if (m >= M) continue;
        Acc<MODE> v[4];
        four(j, e, v);
        store_row<MODE>(v, m, c0, N, MODE == kDynamic ? sSx[m] : 1.f, scale,
                        out, acc_out);
      }
    return;
  }
  // the ranks' partial sums through distributed shared memory, in rank
  // order
  Acc<MODE>* part = reinterpret_cast<Acc<MODE>*>(ring);  // [BM][128]
  if (kh == 0) {
#pragma unroll
    for (int j = 0; j < MB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        Acc<MODE> v[4];
        four(j, e, v);
        store4(part + (8 * j + 2 * t + e) * kBN + 32 * wc + 4 * g, v[0], v[1],
               v[2], v[3]);
      }
  }
  cl.sync();
  for (int e = rank * kDecodeThreads + tid; e < M * kBN;
       e += cluster * kDecodeThreads) {
    const int m = e / kBN, n = n0 + e % kBN;
    if (n >= N) continue;
    Acc<MODE> a = 0;
    for (int r = 0; r < cluster; ++r) a += cl.map_shared_rank(part, r)[e];
    out[(size_t)m * N + n] = finish<MODE>(a, MODE == kDynamic ? sSx[m] : 1.f, scale[n]);
    if (acc_out != nullptr) acc_out[(size_t)m * N + n] = (int32_t)a;
  }
  cl.sync();  // no rank leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// prefill: 128 x 128 tiles
// ---------------------------------------------------------------------------

// the A operand's element (x's type, or int8 in dynamic mode) and the ring
template <int MODE, typename T>
struct Gemm {
  using A = std::conditional_t<MODE == kDynamic, int8_t, T>;
  static constexpr int BM = 128;
  static constexpr int BK = 128 / (int)sizeof(A);    // k a stage: 128-byte rows
  static constexpr int WROWS = BK;                   // weight rows a stage
  static constexpr int STAGE = BM * 128 + WROWS * kBN;
  static constexpr int STAGES = MODE == kDynamic ? 3 : 4;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE;
};

template <int MODE, typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_kernel(const void* __restrict__ xa, const int8_t* __restrict__ qw,
            const float* __restrict__ scale, const float* __restrict__ sx,
            float* __restrict__ out, int32_t* __restrict__ acc_out, int M,
            int N, int K, int arow, int xvec, int wvec) {
  using G = Gemm<MODE, T>;
  constexpr int MT = 2, NJ = 8, S = G::STAGES;
  constexpr int PW = kPerWord<MODE, T>, KS = kKStep<MODE, T>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: rows 32 wm, columns 64 wn
  const int nkt = (K + G::BK - 1) / G::BK;
  const uint8_t* xb = static_cast<const uint8_t*>(xa);

  auto load_stage = [&](int kt) {
    if (kt < nkt) {
      uint8_t* xt = smem + (kt % S) * G::STAGE;
      uint8_t* wt = xt + G::BM * 128;
      for (int c = tid; c < G::BM * 8; c += kGemmThreads) {
        const int r = c >> 3, j = c & 7, gm = m0 + r;
        copy16(xt + swz(r, j), xb + (size_t)min(gm, M - 1) * arow,
               kt * 128 + j * 16, gm < M ? arow : 0, xvec);
      }
      for (int c = tid; c < G::WROWS * 8; c += kGemmThreads) {
        const int r = c >> 3, gk = kt * G::WROWS + r;
        copy16(wt + wchunk(r, c & 7) * 16,
               reinterpret_cast<const uint8_t*>(qw) + (size_t)min(gk, K - 1) * N,
               n0 + (c & 7) * 16, gk < K ? N : 0, wvec);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int kt = 0; kt < S - 1; ++kt) load_stage(kt);

  Acc<MODE> acc[MT][NJ][4] = {};
  for (int kt = 0; kt < nkt; ++kt) {
    load_stage(kt + S - 1);
    cp_wait<S - 1>();
    __syncthreads();
    const uint8_t* xt = smem + (kt % S) * G::STAGE;
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(xt);
    // x's tile: 128-byte rows, 16-byte chunks XOR the row's low 3 bits
    auto word = [&](int r, int wc) {
      const int row = 32 * wm + r;
      return xw[row * 32 + ((((wc >> 2) ^ (row & 7)) << 2) | (wc & 3))];
    };
#pragma unroll
    for (int s = 0; s < 4; ++s)
      kstep<MODE, T, MT, NJ>(acc, word, s * KS / PW, xt + G::BM * 128, s * KS,
                             16 * wn);
    __syncthreads();
  }

  // the tile through shared memory (the ring is free: the loop's last
  // barrier passed and no copy is pending), then out a row a warp at a
  // time, 512 contiguous bytes.  The thread holds rows 32 wm + 16 i + g
  // (+ 8), columns 16 t .. 16 t + 15 of the warp's 64 (tile j's column
  // 2 t + e % 2 is column 8 (2 t + e % 2) + j).
  constexpr int LD = kBN + 4;
  Acc<MODE>* st = reinterpret_cast<Acc<MODE>*>(smem);
  const int g = (tid & 31) >> 2, t = tid & 3, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Acc<MODE>* row = st + (32 * wm + 16 * i + g + 8 * h) * LD + 64 * wn + 16 * t;
#pragma unroll
      for (int c = 0; c < 16; c += 4)
        store4(row + c, acc[i][c % 8][2 * h + c / 8],
               acc[i][(c + 1) % 8][2 * h + c / 8],
               acc[i][(c + 2) % 8][2 * h + c / 8],
               acc[i][(c + 3) % 8][2 * h + c / 8]);
    }
  __syncthreads();
  for (int r = warp; r < G::BM; r += kGemmThreads / 32) {
    const int m = m0 + r;
    if (m >= M) break;
    Acc<MODE> v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = st[r * LD + 4 * lane + c];
    store_row<MODE>(v, m, n0 + 4 * lane, N, MODE == kDynamic ? sx[m] : 1.f,
                    scale, out, acc_out);
  }
}

// the dynamic prefill's row grid: one warp per row; qx rows are padded with
// zeros to Kp (a multiple of 4)
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
quantize_rows_kernel(const T* __restrict__ x, const float* __restrict__ xscale,
                     int8_t* __restrict__ qx, float* __restrict__ sx, int M,
                     int K, int Kp, float rng) {
  const int row = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  const T* xr = x + (size_t)row * K;
  float amax;
  if (xscale != nullptr) {
    amax = xscale[0];
  } else {
    amax = 0.f;
    for (int k = lane; k < K; k += 32) amax = nan_max(fabsf(to_f(xr[k])), amax);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = nan_max(__shfl_xor_sync(0xffffffffu, amax, off), amax);
  }
  const float s = nan_max(amax, 1e-12f) / rng;  // IEEE division
  int8_t* qr = qx + (size_t)row * Kp;
  for (int k = lane; k < Kp; k += 32) {
    float q = 0.f;
    if (k < K) q = fminf(fmaxf(rintf(to_f(xr[k]) / s), -rng), rng);
    qr[k] = (int8_t)q;
  }
  if (lane == 0) sx[row] = s;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int MODE, typename T, int MB>
int launch_gemv(const T* x, const int8_t* qw, const float* scale,
                const float* xscale, int8_t* qx, float* sx, float* out,
                int32_t* acc, int M, int N, int K, int Kp, float rng,
                const Plan& p, cudaStream_t st) {
  auto kern = gemv_kernel<MODE, T, MB>;
  const size_t smem = DecodeSmem<MODE, T>::bytes(p.kchunk, 8 * MB);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + kBN - 1) / kBN * p.splits));
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  const int xvec = vec_of(x, (long)K * sizeof(T));
  const int wvec = vec_of(qw, N);
  err = cudaLaunchKernelEx(&cfg, kern, x, qw, scale, xscale, qx, sx, out, acc,
                           M, N, K, Kp, p.kchunk, rng, xvec, wvec, p.splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the decode kernel for x's rows: 8, 16 or 32 a block
template <int MODE, typename T>
int launch_gemv_rows(const T* x, const int8_t* qw, const float* scale,
                     const float* xscale, int8_t* qx, float* sx, float* out,
                     int32_t* acc, int M, int N, int K, int Kp, float rng,
                     const Plan& p, cudaStream_t st) {
  if (M <= 8)
    return launch_gemv<MODE, T, 1>(x, qw, scale, xscale, qx, sx, out, acc, M,
                                   N, K, Kp, rng, p, st);
  if (M <= 16)
    return launch_gemv<MODE, T, 2>(x, qw, scale, xscale, qx, sx, out, acc, M,
                                   N, K, Kp, rng, p, st);
  return launch_gemv<MODE, T, 4>(x, qw, scale, xscale, qx, sx, out, acc, M, N,
                                 K, Kp, rng, p, st);
}

template <int MODE, typename T>
int launch_gemm(const void* xa, long arow, const int8_t* qw, const float* scale,
                const float* sx, float* out, int32_t* acc, int M, int N, int K,
                cudaStream_t st) {
  using G = Gemm<MODE, T>;
  auto kern = gemm_kernel<MODE, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBN - 1) / kBN, (M + G::BM - 1) / G::BM);
  kern<<<grid, kGemmThreads, G::SMEM, st>>>(xa, qw, scale, sx, out, acc, M, N,
                                             K, (int)arow, vec_of(xa, arow),
                                             vec_of(qw, N));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wo(const void* xv, const int8_t* qw, const float* scale, float* out,
              int M, int N, int K, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const Plan p = plan_of(M, N, K);
  if (!p.gemv)
    return launch_gemm<kWeightOnly, T>(x, (long)K * sizeof(T), qw, scale,
                                       nullptr, out, nullptr, M, N, K, st);
  return launch_gemv_rows<kWeightOnly, T>(x, qw, scale, nullptr, nullptr,
                                          nullptr, out, nullptr, M, N, K, 0,
                                          0.f, p, st);
}

template <typename T>
int launch_dyn(const void* xv, const float* xscale, int8_t* qx, float* sx,
               const int8_t* qw, const float* scale, float* out, int32_t* acc,
               int M, int N, int K, int Kp, float rng, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const Plan p = plan_of(M, N, K);
  if (p.gemv)
    return launch_gemv_rows<kDynamic, T>(x, qw, scale, xscale, qx, sx, out,
                                         acc, M, N, K, Kp, rng, p, st);
  const int rows = kRowThreads / 32;
  quantize_rows_kernel<T><<<(M + rows - 1) / rows, kRowThreads, 0, st>>>(
      x, xscale, qx, sx, M, K, Kp, rng);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_gemm<kDynamic, T>(qx, Kp, qw, scale, sx, out, acc, M, N, K, st);
}

}  // namespace

// The kernel a launch of this shape takes: 0 for the prefill kernel (whose
// dynamic mode quantizes x's rows into the caller's qx/sx first), else the
// decode kernel's cluster, the blocks it splits K over (1: no split).  The
// kernel needs no scratch for it.
extern "C" int ptt_dequant_matmul_splits(int M, int N, int K, int dynamic) {
  (void)dynamic;
  const Plan p = plan_of(M, N, K);
  return p.gemv ? p.splits : 0;
}

// weight_only: x [M, K] (dtype 0 float32, 1 bfloat16, 2 float16), qw [K, N]
// int8, scale [N] float32, out [M, N] float32, all contiguous; part is not
// used (null).  Returns the CUDA error of the launch (0 = launched).
extern "C" int ptt_dequant_matmul_wo(const void* x, const void* qw,
                                     const void* scale, void* out, void* part,
                                     int M, int N, int K, int dtype,
                                     int device, void* stream) {
  (void)part;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int8_t* w = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32) return launch_wo<float>(x, w, s, o, M, N, K, st);
  if (dtype == ptt::kBFloat16)
    return launch_wo<__nv_bfloat16>(x, w, s, o, M, N, K, st);
  if (dtype == ptt::kFloat16) return launch_wo<__half>(x, w, s, o, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic: as weight_only, plus xscale (null, or one float32: the static
// activation envelope), the row grid's outputs qx [M, Kp] int8 (Kp = K
// rounded up to 4, padded with zeros) and sx [M] float32 (either may be
// null at decode, M <= 32, where the grid stays inside the kernel), and acc
// (null, or [M, N] int32: the accumulator, for checks).  rng = 2^(bits-1) -
// 1.
extern "C" int ptt_dequant_matmul_dyn(const void* x, const void* qw,
                                      const void* scale, const void* xscale,
                                      void* qx, void* sx, void* out, void* acc,
                                      void* part, int M, int N, int K, int Kp,
                                      float rng, int dtype, int device,
                                      void* stream) {
  (void)part;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Kp % 4 != 0 || Kp < K) return (int)cudaErrorInvalidValue;
  if (!plan_of(M, N, K).gemv && (qx == nullptr || sx == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(xscale);
  int8_t* q = static_cast<int8_t*>(qx);
  float* g = static_cast<float*>(sx);
  const int8_t* w = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  int32_t* a = static_cast<int32_t*>(acc);
  if (dtype == ptt::kFloat32)
    return launch_dyn<float>(x, xs, q, g, w, s, o, a, M, N, K, Kp, rng, st);
  if (dtype == ptt::kBFloat16)
    return launch_dyn<__nv_bfloat16>(x, xs, q, g, w, s, o, a, M, N, K, Kp, rng,
                                     st);
  if (dtype == ptt::kFloat16)
    return launch_dyn<__half>(x, xs, q, g, w, s, o, a, M, N, K, Kp, rng, st);
  return (int)cudaErrorInvalidValue;
}
