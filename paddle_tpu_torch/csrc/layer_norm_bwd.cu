// Kernel #4: layer-norm backward for Hopper (sm_90a), in plain CUDA C++.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/layer_norm.py:_bwd (its
// pallas_call body _bwd_kernel).  Same function over rows of x [N, D], from
// the forward's float32 row mean and rstd = 1/sqrt(var + eps) and the
// cotangent dy:
//   xhat = (x - mean) rstd,  gg = dy gamma,
//   dx = (gg - mean(gg) - xhat mean(gg xhat)) rstd,
//   dgamma = sum over rows of dy xhat,  dbeta = sum over rows of dy.
// Inputs are float32 or bfloat16; every sum is float32; dx, dgamma and dbeta
// take the input type.
//
// What bounds it on the H100: device memory.  It reads x and dy once and
// writes dx once (12 bytes an element in float32) for about 13 flops an
// element, far below the ~20 flops a byte at which the float32 units bind.
//
// Design: the TPU kernel walks the row blocks in order and carries dgamma and
// dbeta across grid steps in its output block; Hopper's blocks run in no
// order, so the column sums take two passes, with no float atomics, so that
// two runs give the same bits.
//  - Rows: about the card's resident blocks (the wrapper's grid), 8 warps
//    each; warp w of block b takes rows b*8 + w, then every 8 * blocks-th.
//    A lane holds 16-byte vectors of the row (4 float32 or 8 bfloat16
//    columns each, so D = 512 is 4 or 2 vectors a lane; plain loads when D
//    is not a multiple of the vector) and issues the next row's x, dy, mean
//    and rstd before the current row's two shuffle reductions, so a warp
//    always has a row's loads in flight.  Each lane keeps its columns'
//    running sums of dy xhat and dy; the block adds its warps' sums in a
//    fixed order and writes one [D] row of each into a [2, blocks, D]
//    scratch (~1 MB at 16384 x 512 with 264 blocks).
//  - Columns: blocks of 8 columns x 32 row slices over the card (128 blocks
//    at D = 512); each slice sums its partial rows in order, then the
//    slices are added in order.

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "wgmma.cuh"

namespace {

using ptt::from_f;
using ptt::to_f;
using ptt::warp_sum;

constexpr int kWarps = 8;
constexpr int kColThreads = 256;
constexpr int kColWidth = 8;  // columns a block of the column pass
constexpr int kSlices = kColThreads / kColWidth;

// EPV elements of a row as one load: a 16-byte vector, or (EPV = 1) one T
template <typename T, int EPV>
struct Raw {
  using type = uint4;
};
template <typename T>
struct Raw<T, 1> {
  using type = T;
};

template <typename T, int EPV>
__device__ __forceinline__ void to_floats(const typename Raw<T, EPV>::type& r,
                                          float (&f)[EPV]) {
  if constexpr (EPV == 1)
    f[0] = to_f(r);
  else
    unpack(r, f);
}

template <typename T, int EPV>
__device__ __forceinline__ typename Raw<T, EPV>::type from_floats(
    const float (&f)[EPV]) {
  if constexpr (EPV == 1)
    return from_f<T>(f[0]);
  else
    return pack(f);
}

template <typename T, int NV, int EPV>
__global__ void __launch_bounds__(32 * kWarps)
layer_norm_bwd_rows(const T* __restrict__ x, const T* __restrict__ gamma,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ part, int N, int D) {
  using R = typename Raw<T, EPV>::type;
  extern __shared__ float smem[];  // [2][kWarps][D] partial sums, gamma [D]
  float* sg = smem + 2 * kWarps * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  const float inv_d = 1.f / D;
  for (int c = threadIdx.x; c < D; c += 32 * kWarps) sg[c] = to_f(gamma[c]);
  __syncthreads();

  float dg[NV][EPV], db[NV][EPV];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < EPV; ++e) dg[j][e] = db[j][e] = 0.f;

  R cx[NV], cd[NV], nx[NV], nd[NV];
  float cmu = 0.f, crs = 0.f, nmu = 0.f, nrs = 0.f;
  auto load_row = [&](int r, R (&bx)[NV], R (&bd)[NV], float& mu, float& rs) {
    const T* xr = x + (size_t)r * D;
    const T* dyr = dy + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (lane + 32 * j) * EPV;
      if (c < D) {
        bx[j] = *reinterpret_cast<const R*>(xr + c);
        bd[j] = *reinterpret_cast<const R*>(dyr + c);
      }
    }
    mu = mean[r];
    rs = rstd[r];
  };

  int row = blockIdx.x * kWarps + warp;
  if (row < N) load_row(row, cx, cd, cmu, crs);
  for (; row < N; row += stride) {
    if (row + stride < N) load_row(row + stride, nx, nd, nmu, nrs);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (lane + 32 * j) * EPV;
      if (c >= D) continue;
      float xf[EPV], df[EPV];
      to_floats<T, EPV>(cx[j], xf);
      to_floats<T, EPV>(cd[j], df);
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        const float xh = (xf[e] - cmu) * crs;
        dg[j][e] = fmaf(df[e], xh, dg[j][e]);
        db[j][e] += df[e];
        const float gg = df[e] * sg[c + e];
        s1 += gg;
        s2 = fmaf(gg, xh, s2);
      }
    }
    const float m1 = warp_sum(s1) * inv_d;
    const float m2 = warp_sum(s2) * inv_d;
    T* dxr = dx + (size_t)row * D;
    // xhat and dy again from the row's registers (fewer live values)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (lane + 32 * j) * EPV;
      if (c >= D) continue;
      float xf[EPV], df[EPV], out[EPV];
      to_floats<T, EPV>(cx[j], xf);
      to_floats<T, EPV>(cd[j], df);
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        out[e] = (df[e] * sg[c + e] - m1 - (xf[e] - cmu) * crs * m2) * crs;
      *reinterpret_cast<R*>(dxr + c) = from_floats<T, EPV>(out);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      cx[j] = nx[j];
      cd[j] = nd[j];
    }
    cmu = nmu;
    crs = nrs;
  }

#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const int c = (lane + 32 * j) * EPV + e;
      if (c < D) {
        smem[warp * D + c] = dg[j][e];
        smem[(kWarps + warp) * D + c] = db[j][e];
      }
    }
  __syncthreads();
  float* pg = part + (size_t)blockIdx.x * D;
  float* pb = part + ((size_t)gridDim.x + blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += 32 * kWarps) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += smem[w * D + c];
      b += smem[(kWarps + w) * D + c];
    }
    pg[c] = a;
    pb[c] = b;
  }
}

// dgamma (grid.y 0) or dbeta (1), 8 columns a block: 32 slices sum rows
// slice, slice + 32, ... of the partials in order, then the slices are
// added in order
template <typename T>
__global__ void __launch_bounds__(kColThreads)
layer_norm_bwd_columns(const float* __restrict__ part, T* __restrict__ dgamma,
                       T* __restrict__ dbeta, int blocks, int D) {
  __shared__ float red[kSlices][kColWidth + 1];
  const int cl = threadIdx.x % kColWidth, sl = threadIdx.x / kColWidth;
  const int c = blockIdx.x * kColWidth + cl;
  const float* p = part + (size_t)blockIdx.y * blocks * D;
  float a = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int i = sl; i < blocks; i += kSlices) a += p[(size_t)i * D + c];
  }
  red[sl][cl] = a;
  __syncthreads();
  if (sl == 0 && c < D) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kSlices; ++q) s += red[q][cl];
    (blockIdx.y ? dbeta : dgamma)[c] = from_f<T>(s);
  }
}

template <typename T>
using RowsKernel = void (*)(const T*, const T*, const float*, const float*,
                            const T*, T*, float*, int, int);

// the row kernel for width D: 16-byte vectors when `vec`, else one element
// a load; NV loads a lane, the least power of two that covers D
template <typename T>
RowsKernel<T> rows_kernel(int D, bool vec) {
  constexpr int EPV = 16 / sizeof(T);
  if (vec) {
    const int nv = (int)cdiv(D, 32 * EPV);
    if (nv <= 1) return layer_norm_bwd_rows<T, 1, EPV>;
    if (nv <= 2) return layer_norm_bwd_rows<T, 2, EPV>;
    if (nv <= 4) return layer_norm_bwd_rows<T, 4, EPV>;
    // float32 rows of up to 1024 take 8 vectors a lane, bfloat16 4
    if constexpr (EPV == 4)
      if (nv <= 8) return layer_norm_bwd_rows<T, 8, EPV>;
    return nullptr;
  }
  const int nv = (int)cdiv(D, 32);
  if (nv <= 1) return layer_norm_bwd_rows<T, 1, 1>;
  if (nv <= 2) return layer_norm_bwd_rows<T, 2, 1>;
  if (nv <= 4) return layer_norm_bwd_rows<T, 4, 1>;
  if (nv <= 8) return layer_norm_bwd_rows<T, 8, 1>;
  if (nv <= 16) return layer_norm_bwd_rows<T, 16, 1>;
  if (nv <= 32) return layer_norm_bwd_rows<T, 32, 1>;
  return nullptr;
}

size_t rows_smem(int D) { return sizeof(float) * (2 * kWarps + 1) * D; }

// the row kernel's resident blocks on the card, or -(CUDA error)
template <typename T>
int resident(int D, bool vec) {
  RowsKernel<T> kern = rows_kernel<T>(D, vec);
  if (!kern) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_smem(D));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, 32 * kWarps, rows_smem(D));
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

template <typename T>
int launch(const void* xv, const void* gv, const float* mean, const float* rstd,
           const void* dyv, void* dxv, void* dgv, void* dbv, float* part, int N,
           int D, int blocks, bool vec, cudaStream_t stream) {
  RowsKernel<T> kern = rows_kernel<T>(D, vec);
  if (!kern) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_smem(D));
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, 32 * kWarps, rows_smem(D), stream>>>(
      static_cast<const T*>(xv), static_cast<const T*>(gv), mean, rstd,
      static_cast<const T*>(dyv), static_cast<T*>(dxv), part, N, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  layer_norm_bwd_columns<T><<<dim3((unsigned)cdiv(D, kColWidth), 2), kColThreads,
                               0, stream>>>(part, static_cast<T*>(dgv),
                                            static_cast<T*>(dbv), blocks, D);
  return (int)cudaGetLastError();
}

}  // namespace

// How many blocks of the row pass the card holds at once for width D (the
// wrapper's grid is at most this); vec: 16-byte vectors (D a multiple of
// 16 / element bytes, 16-byte aligned rows).  Returns -(CUDA error) on error.
extern "C" int ptt_layer_norm_bwd_resident(int D, int vec, int dtype,
                                           int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  if (dtype == ptt::kFloat32) return resident<float>(D, vec != 0);
  if (dtype == ptt::kBFloat16) return resident<__nv_bfloat16>(D, vec != 0);
  return -(int)cudaErrorInvalidValue;
}

// x/dy [N, D] contiguous, gamma [D] of x's dtype (D <= 1024); mean/rstd [N]
// float32; dx like x, dgamma/dbeta like gamma; part a float32 scratch of
// 2 * blocks * D.  Launches the row pass on `blocks` blocks, then the
// column pass.  Returns the CUDA error of the launches (0 = launched).
extern "C" int ptt_layer_norm_bwd(const void* x, const void* gamma,
                                  const void* mean, const void* rstd,
                                  const void* dy, void* dx, void* dgamma,
                                  void* dbeta, void* part, int N, int D,
                                  int blocks, int vec, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch<float>(x, gamma, mu, rs, dy, dx, dgamma, dbeta, pt, N, D,
                         blocks, vec != 0, st);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, mu, rs, dy, dx, dgamma, dbeta, pt, N,
                                 D, blocks, vec != 0, st);
  return (int)cudaErrorInvalidValue;
}
