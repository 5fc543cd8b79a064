// Kernel #7: fused dequant-matmul for Hopper (sm_90a), in plain CUDA C++.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant_matmul.py:dequant_matmul
// (its pallas_call at :121, bodies _wo_kernel and _dyn_kernel).  x [M, K] is
// float32, bfloat16 or float16; qw [K, N] int8; scale [N] float32 dequant
// multipliers (w ~= qw * scale); the result is the float32 [M, N]:
//
// * weight_only: (x_f32 @ qw_f32) * scale[n].  int8 values are exact in
//   float32, so the dequant is the widening itself; the per-column scale is
//   applied to the accumulator in the epilogue (_wo_kernel's acc * s).
// * dynamic: each row of x gets its own int8 grid, sx = max(max|x|, 1e-12) /
//   127 (or the static envelope max(xscale, 1e-12) / 127 of a trained QAT
//   activation scale), qx = clip(rint(x / sx), -127, 127); then an int8 x
//   int8 -> int32 product, and the epilogue (float(acc) * sx) * scale[n], in
//   that order, as _dyn_kernel.  Division is IEEE (no fast-math flags) and
//   rintf rounds half to even, as jnp.round and torch.round do, so qx, sx and
//   the int32 accumulator equal the plain version bit for bit.
//
// What bounds it on the H100.  Decode (M = 8) reads the int8 weight once and
// does 2 M flops per weight byte: device memory binds (the logits projection
// moves 16.4 MB, ~5 us at 3.35 TB/s, against 65.5 MB for the float32 master).
// Prefill (M = 4096) is compute-bound: float32 FMA on the SIMT cores for
// weight_only, __dp4a (4 int8 products a lane) for dynamic.
//
// Design.  The TPU kernel keeps a whole K x 128 weight stripe resident in
// VMEM so the dynamic row grid needs no cross-block reduction.  Here the row
// grid is its own pass (one warp per row, writing qx and sx), and the product
// is a classic shared-memory tiled SIMT GEMM over K steps: the grid runs over
// (N blocks, M blocks), so at decode the parallelism comes from N (500
// column blocks at N = 32000), not from M.  The weight tile is read four
// int8 values per 32-bit load and widened in registers on its way into
// shared memory (weight_only) or transposed with byte permutes into 4-deep
// k-packed words for __dp4a (dynamic); no dequantized copy of the weight is
// ever written to device memory.  Each thread keeps a TM x TN block of
// accumulators in registers; rows and columns are interleaved across threads
// so a warp's shared-memory reads and global stores are contiguous.  Where
// the (N, M) grid has too few blocks to keep ~8 blocks an SM in flight (the
// decode projections: 8 blocks at N = 512), K is split over grid.z: each
// block writes its partial sums to a [splits, M, N] scratch and a second
// pass adds them in a fixed order and applies the epilogue (int32 partials
// add exactly; float32 ones in the same order every run).  No tensor cores
// yet (mma.sync / wgmma s8 is for a later PR).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dtype.cuh"

namespace {

using ptt::to_f;

constexpr int kThreads = 256;
// blocks in flight worth aiming for: 8 blocks of 256 threads on 132 SMs
constexpr long kTargetBlocks = 1024;

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int TX = BN / TN;  // threads along N
  static constexpr int TY = BM / TM;  // threads along M
  static_assert(TX * TY == kThreads, "a tile is covered by 256 threads");
  static_assert(BK % 4 == 0 && BN % 4 == 0, "4-byte weight loads");
};

// decode (M <= 8), small batches (M <= 32), and everything larger
using Small = Tile<8, 64, 64, 1, 2>;
using Medium = Tile<32, 64, 32, 4, 2>;
using LargeF = Tile<128, 128, 8, 8, 8>;
using LargeI = Tile<128, 128, 32, 8, 8>;

// four int8 weights of row k, columns n..n+3, as the bytes of one word
// (zero past N); `vec` says N % 4 == 0 and qw is 4-byte aligned
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ qw,
                                          int k, int n, int N, bool vec) {
  const int8_t* src = qw + (size_t)k * N + n;
  if (vec) return *reinterpret_cast<const uint32_t*>(src);
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) w |= (uint32_t)(uint8_t)src[j] << (8 * j);
  return w;
}

__device__ __forceinline__ float byte_f(uint32_t w, int j) {
  return (float)(int8_t)(w >> (8 * j));
}

template <typename T, class C>
__global__ void __launch_bounds__(kThreads)
wo_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
          const float* __restrict__ scale, float* __restrict__ out,
          float* __restrict__ part, int M, int N, int K, int kchunk,
          bool vec) {
  __shared__ float xs[C::BK][C::BM + 1];
  __shared__ float ws[C::BK][C::BN];
  const int tid = threadIdx.x, tx = tid % C::TX, ty = tid / C::TX;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += C::BK) {
    // x tile, read along k (x is row-major), stored k-major
    for (int e = tid; e < C::BM * C::BK; e += kThreads) {
      const int r = e / C::BK, c = e % C::BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < kend) ? to_f(x[(size_t)m * K + k]) : 0.f;
    }
    // weight tile: 4 int8 a load, widened to float in registers
    for (int e = tid; e < C::BK * C::BN / 4; e += kThreads) {
      const int r = e / (C::BN / 4), c = (e % (C::BN / 4)) * 4;
      const int k = k0 + r, n = n0 + c;
      const uint32_t w = (k < kend && n < N) ? load4(qw, k, n, N, vec) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[r][c + j] = byte_f(w, j);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C::BK; ++kk) {
      float a[C::TM], b[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) a[i] = xs[kk][ty + i * C::TY];
#pragma unroll
      for (int j = 0; j < C::TN; ++j) b[j] = ws[kk][tx + j * C::TX];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // epilogue: the per-output-channel dequant scale, or this split's
  // partial sums
  float* dst = part != nullptr ? part + (size_t)blockIdx.z * M * N : out;
#pragma unroll
  for (int j = 0; j < C::TN; ++j) {
    const int n = n0 + tx + j * C::TX;
    if (n >= N) continue;
    const float s = part != nullptr ? 1.f : scale[n];  // x 1 is exact
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int m = m0 + ty + i * C::TY;
      if (m < M) dst[(size_t)m * N + n] = acc[i][j] * s;
    }
  }
}

// the second pass of a K split: partial sums added in split order, then
// the epilogue of the mode
__global__ void __launch_bounds__(kThreads)
reduce_wo_kernel(const float* __restrict__ part, int splits,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int M, int N) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float a = 0.f;
  for (int z = 0; z < splits; ++z) a += part[z * mn + i];
  out[i] = a * scale[i % N];
}

__global__ void __launch_bounds__(kThreads)
reduce_dyn_kernel(const int* __restrict__ part, int splits,
                  const float* __restrict__ sx, const float* __restrict__ scale,
                  float* __restrict__ out, int32_t* __restrict__ acc_out, int M,
                  int N) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  int a = 0;
  for (int z = 0; z < splits; ++z) a += part[z * mn + i];
  out[i] = __fmul_rn(__fmul_rn((float)a, sx[i / N]), scale[i % N]);
  if (acc_out != nullptr) acc_out[i] = a;
}

// NaN-propagating max, as jnp.max / torch.amax: a NaN row gives a NaN grid
// and NaN outputs (which the serving engine then quarantines)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// the dynamic mode's row grid: one warp per row; qx rows are padded with
// zeros to Kp (a multiple of 4), so the product loads whole aligned words
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, const float* __restrict__ xscale,
                     int8_t* __restrict__ qx, float* __restrict__ sx, int M,
                     int K, int Kp, float rng) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
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

template <class C>
__global__ void __launch_bounds__(kThreads)
int8_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
            const float* __restrict__ sx, const float* __restrict__ scale,
            float* __restrict__ out, int32_t* __restrict__ acc_out,
            int* __restrict__ part, int M, int N, int K, int Kp, int kchunk,
            bool vec) {
  constexpr int BK4 = C::BK / 4;
  __shared__ int xs[BK4][C::BM + 1];
  __shared__ int ws[BK4][C::BN];
  const int tid = threadIdx.x, tx = tid % C::TX, ty = tid / C::TX;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  // kchunk is a multiple of BK (so of 4); the last split runs to Kp, whose
  // words past K hold the zero padding of the row pass
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  const int kend4 = kend == K ? Kp : kend;
  int acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += C::BK) {
    // qx tile: 4 consecutive k of a row in one aligned word
    for (int e = tid; e < C::BM * BK4; e += kThreads) {
      const int r = e / BK4, c = e % BK4;
      const int m = m0 + r, k = k0 + 4 * c;
      xs[c][r] = (m < M && k < kend4)
                     ? *reinterpret_cast<const int*>(qx + (size_t)m * Kp + k)
                     : 0;
    }
    // weight tile: a 4 (k) x 4 (n) block of bytes per thread, transposed so
    // each word holds 4 consecutive k of one column
    for (int e = tid; e < BK4 * (C::BN / 4); e += kThreads) {
      const int r4 = e / (C::BN / 4), c = (e % (C::BN / 4)) * 4;
      const int k = k0 + 4 * r4, n = n0 + c;
      uint32_t row[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        row[i] = (k + i < kend && n < N) ? load4(qw, k + i, n, N, vec) : 0u;
      const uint32_t t0 = __byte_perm(row[0], row[1], 0x5140);
      const uint32_t t1 = __byte_perm(row[2], row[3], 0x5140);
      const uint32_t t2 = __byte_perm(row[0], row[1], 0x7362);
      const uint32_t t3 = __byte_perm(row[2], row[3], 0x7362);
      ws[r4][c + 0] = (int)__byte_perm(t0, t1, 0x5410);
      ws[r4][c + 1] = (int)__byte_perm(t0, t1, 0x7632);
      ws[r4][c + 2] = (int)__byte_perm(t2, t3, 0x5410);
      ws[r4][c + 3] = (int)__byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK4; ++kk) {
      int a[C::TM], b[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) a[i] = xs[kk][ty + i * C::TY];
#pragma unroll
      for (int j = 0; j < C::TN; ++j) b[j] = ws[kk][tx + j * C::TX];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // epilogue: (float(acc) * sx) * scale, in _dyn_kernel's order, or this
  // split's partial sums
#pragma unroll
  for (int j = 0; j < C::TN; ++j) {
    const int n = n0 + tx + j * C::TX;
    if (n >= N) continue;
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int m = m0 + ty + i * C::TY;
      if (m >= M) continue;
      const size_t o = (size_t)m * N + n;
      if (part != nullptr) {
        part[(size_t)blockIdx.z * M * N + o] = acc[i][j];
        continue;
      }
      out[o] = __fmul_rn(__fmul_rn((float)acc[i][j], sx[m]), scale[n]);
      if (acc_out != nullptr) acc_out[o] = acc[i][j];
    }
  }
}

// the K split of a launch: as many splits (each a whole number of BK
// steps) as it takes to reach kTargetBlocks blocks, at most one a step
struct Split {
  int splits, kchunk;
};

template <class C>
Split split_of(int M, int N, int K) {
  const long blocks = (long)((N + C::BN - 1) / C::BN) * ((M + C::BM - 1) / C::BM);
  const int steps = std::max(1, (K + C::BK - 1) / C::BK);
  const int want = (int)std::min(
      (long)steps, std::max(1L, (kTargetBlocks + blocks - 1) / blocks));
  const int per = (steps + want - 1) / want;
  return {(steps + per - 1) / per, per * C::BK};
}

template <class C>
dim3 grid_of(int M, int N, int splits) {
  return dim3((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, splits);
}

Split split_wo(int M, int N, int K) {
  if (M <= Small::BM) return split_of<Small>(M, N, K);
  if (M <= Medium::BM) return split_of<Medium>(M, N, K);
  return split_of<LargeF>(M, N, K);
}

Split split_dyn(int M, int N, int K) {
  if (M <= Small::BM) return split_of<Small>(M, N, K);
  if (M <= Medium::BM) return split_of<Medium>(M, N, K);
  return split_of<LargeI>(M, N, K);
}

int blocks_1d(size_t n) { return (int)((n + kThreads - 1) / kThreads); }

template <typename T>
int launch_wo(const void* x, const int8_t* qw, const float* scale, float* out,
              float* part, int M, int N, int K, bool vec, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const Split sp = split_wo(M, N, K);
  float* p = sp.splits > 1 ? part : nullptr;
  if (sp.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  if (M <= Small::BM)
    wo_kernel<T, Small><<<grid_of<Small>(M, N, sp.splits), kThreads, 0, st>>>(
        xt, qw, scale, out, p, M, N, K, sp.kchunk, vec);
  else if (M <= Medium::BM)
    wo_kernel<T, Medium><<<grid_of<Medium>(M, N, sp.splits), kThreads, 0, st>>>(
        xt, qw, scale, out, p, M, N, K, sp.kchunk, vec);
  else
    wo_kernel<T, LargeF><<<grid_of<LargeF>(M, N, sp.splits), kThreads, 0, st>>>(
        xt, qw, scale, out, p, M, N, K, sp.kchunk, vec);
  if (p != nullptr)
    reduce_wo_kernel<<<blocks_1d((size_t)M * N), kThreads, 0, st>>>(
        p, sp.splits, scale, out, M, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* x, const float* xscale, int8_t* qx, float* sx,
                int M, int K, int Kp, float rng, cudaStream_t st) {
  const int rows_per_block = kThreads / 32;
  quantize_rows_kernel<T><<<(M + rows_per_block - 1) / rows_per_block,
                            kThreads, 0, st>>>(static_cast<const T*>(x),
                                               xscale, qx, sx, M, K, Kp, rng);
  return (int)cudaGetLastError();
}

bool aligned4(const void* p, int N) {
  return N % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 4 == 0;
}

}  // namespace

// The number of K splits a launch of this shape uses (1: none); the caller
// passes a [splits, M, N] scratch, float32 for weight_only (dynamic = 0) and
// int32 for dynamic, when it is above 1.
extern "C" int ptt_dequant_matmul_splits(int M, int N, int K, int dynamic) {
  return (dynamic ? split_dyn(M, N, K) : split_wo(M, N, K)).splits;
}

// weight_only: x [M, K] (dtype 0 float32, 1 bfloat16, 2 float16), qw [K, N]
// int8, scale [N] float32, out [M, N] float32, all contiguous; part the K
// split's scratch (null without a split).  Returns the CUDA error of the
// launch (0 = launched).
extern "C" int ptt_dequant_matmul_wo(const void* x, const void* qw,
                                     const void* scale, void* out, void* part,
                                     int M, int N, int K, int dtype,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int8_t* w = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const bool vec = aligned4(qw, N);
  if (dtype == ptt::kFloat32)
    return launch_wo<float>(x, w, s, o, p, M, N, K, vec, st);
  if (dtype == ptt::kBFloat16)
    return launch_wo<__nv_bfloat16>(x, w, s, o, p, M, N, K, vec, st);
  if (dtype == ptt::kFloat16)
    return launch_wo<__half>(x, w, s, o, p, M, N, K, vec, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic: as weight_only (part int32), plus xscale (null, or one float32:
// the static activation envelope), the row grid's outputs qx [M, Kp] int8
// (Kp = K rounded up to 4, padded with zeros) and sx [M] float32, and acc
// (null, or [M, N] int32: the accumulator, for checks).  rng = 2^(bits-1) -
// 1.
extern "C" int ptt_dequant_matmul_dyn(const void* x, const void* qw,
                                      const void* scale, const void* xscale,
                                      void* qx, void* sx, void* out, void* acc,
                                      void* part, int M, int N, int K, int Kp,
                                      float rng, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Kp % 4 != 0 || Kp < K) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(xscale);
  int8_t* q = static_cast<int8_t*>(qx);
  float* g = static_cast<float*>(sx);
  int rc;
  if (dtype == ptt::kFloat32)
    rc = launch_rows<float>(x, xs, q, g, M, K, Kp, rng, st);
  else if (dtype == ptt::kBFloat16)
    rc = launch_rows<__nv_bfloat16>(x, xs, q, g, M, K, Kp, rng, st);
  else if (dtype == ptt::kFloat16)
    rc = launch_rows<__half>(x, xs, q, g, M, K, Kp, rng, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  const int8_t* w = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  int32_t* a = static_cast<int32_t*>(acc);
  const Split sp = split_dyn(M, N, K);
  if (sp.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  int* p = sp.splits > 1 ? static_cast<int*>(part) : nullptr;
  const bool vec = aligned4(qw, N);
  if (M <= Small::BM)
    int8_kernel<Small><<<grid_of<Small>(M, N, sp.splits), kThreads, 0, st>>>(
        q, w, g, s, o, a, p, M, N, K, Kp, sp.kchunk, vec);
  else if (M <= Medium::BM)
    int8_kernel<Medium><<<grid_of<Medium>(M, N, sp.splits), kThreads, 0, st>>>(
        q, w, g, s, o, a, p, M, N, K, Kp, sp.kchunk, vec);
  else
    int8_kernel<LargeI><<<grid_of<LargeI>(M, N, sp.splits), kThreads, 0, st>>>(
        q, w, g, s, o, a, p, M, N, K, Kp, sp.kchunk, vec);
  if (p != nullptr)
    reduce_dyn_kernel<<<blocks_1d((size_t)M * N), kThreads, 0, st>>>(
        p, sp.splits, g, s, o, a, M, N);
  return (int)cudaGetLastError();
}
