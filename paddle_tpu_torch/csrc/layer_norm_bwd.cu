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
// writes dx once (12 bytes an element in float32) for about 12 flops an
// element, far below the ~20 flops a byte at which the float32 units bind.
//
// Design: the TPU kernel walks the row blocks in order and carries dgamma and
// dbeta across grid steps in its output block; Hopper's blocks run in no
// order, so the column sums take two passes, with no float atomics, so that
// two runs give the same bits.
//  - Pass 1: one block of 8 warps per 64 rows; a warp takes one row at a
//    time, each lane holding NPL = ceil(D / 32) (a power of two) columns of x,
//    dy and gamma in registers, so the row is read from device memory once.
//    dx needs two row sums (warp shuffles).  Each lane also keeps its
//    columns' running sums of dy xhat and dy; the block adds its 8 warps'
//    sums in a fixed order through shared memory and writes one [D] row of
//    each into a [2, blocks, D] float32 scratch.
//  - Pass 2: one thread per column adds the blocks' rows in order.
// The scratch is 2 * N/64 * D floats (1 MB at 16384 x 512), written and read
// once.

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using ptt::from_f;
using ptt::to_f;
using ptt::warp_sum;

constexpr int kWarps = 8;

template <typename T, int NPL>
__global__ void __launch_bounds__(32 * kWarps)
layer_norm_bwd_rows(const T* __restrict__ x, const T* __restrict__ gamma,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ part, int N, int D,
                    int rows_per_block) {
  extern __shared__ float smem[];  // [2][kWarps][D]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(row0 + rows_per_block, N);
  const float inv_d = 1.f / D;

  float g[NPL], dg[NPL], db[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    g[j] = c < D ? to_f(gamma[c]) : 0.f;
    dg[j] = db[j] = 0.f;
  }

  for (int row = row0 + warp; row < row1; row += kWarps) {
    const T* xr = x + (size_t)row * D;
    const T* dyr = dy + (size_t)row * D;
    const float mu = mean[row], rs = rstd[row];
    float xh[NPL], gy[NPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int c = lane + 32 * j;
      const float xv = c < D ? to_f(xr[c]) : 0.f;
      const float dv = c < D ? to_f(dyr[c]) : 0.f;
      xh[j] = c < D ? (xv - mu) * rs : 0.f;
      gy[j] = dv;
      dg[j] = fmaf(dv, xh[j], dg[j]);
      db[j] += dv;
      const float gg = dv * g[j];
      s1 += gg;
      s2 = fmaf(gg, xh[j], s2);
    }
    const float m1 = warp_sum(s1) * inv_d;
    const float m2 = warp_sum(s2) * inv_d;
    T* dxr = dx + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int c = lane + 32 * j;
      if (c < D) dxr[c] = from_f<T>((gy[j] * g[j] - m1 - xh[j] * m2) * rs);
    }
  }

#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    if (c < D) {
      smem[warp * D + c] = dg[j];
      smem[(kWarps + warp) * D + c] = db[j];
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

template <typename T>
__global__ void layer_norm_bwd_columns(const float* __restrict__ part,
                                       T* __restrict__ dgamma,
                                       T* __restrict__ dbeta, int blocks,
                                       int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  float a = 0.f, b = 0.f;
  for (int i = 0; i < blocks; ++i) {
    a += part[(size_t)i * D + c];
    b += part[((size_t)blocks + i) * D + c];
  }
  dgamma[c] = from_f<T>(a);
  dbeta[c] = from_f<T>(b);
}

template <typename T, int NPL>
int launch_rows(const T* x, const T* gamma, const float* mean, const float* rstd,
                const T* dy, T* dx, float* part, int N, int D, int rpb,
                int blocks, cudaStream_t stream) {
  auto kern = layer_norm_bwd_rows<T, NPL>;
  const size_t smem = sizeof(float) * 2 * kWarps * D;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, 32 * kWarps, smem, stream>>>(x, gamma, mean, rstd, dy, dx, part,
                                              N, D, rpb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xv, const void* gv, const float* mean, const float* rstd,
           const void* dyv, void* dxv, void* dgv, void* dbv, float* part, int N,
           int D, int rpb, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* gamma = static_cast<const T*>(gv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  const int blocks = (N + rpb - 1) / rpb;
  int err;
  if (D <= 32)
    err = launch_rows<T, 1>(x, gamma, mean, rstd, dy, dx, part, N, D, rpb, blocks, stream);
  else if (D <= 64)
    err = launch_rows<T, 2>(x, gamma, mean, rstd, dy, dx, part, N, D, rpb, blocks, stream);
  else if (D <= 128)
    err = launch_rows<T, 4>(x, gamma, mean, rstd, dy, dx, part, N, D, rpb, blocks, stream);
  else if (D <= 256)
    err = launch_rows<T, 8>(x, gamma, mean, rstd, dy, dx, part, N, D, rpb, blocks, stream);
  else if (D <= 512)
    err = launch_rows<T, 16>(x, gamma, mean, rstd, dy, dx, part, N, D, rpb, blocks, stream);
  else if (D <= 1024)
    err = launch_rows<T, 32>(x, gamma, mean, rstd, dy, dx, part, N, D, rpb, blocks, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  layer_norm_bwd_columns<T><<<(D + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(dgv), static_cast<T*>(dbv), blocks, D);
  return (int)cudaGetLastError();
}

}  // namespace

// x/dy [N, D] contiguous, gamma [D] of x's dtype (D <= 1024); mean/rstd [N]
// float32; dx like x, dgamma/dbeta like gamma; part a float32 scratch of
// 2 * ceil(N / rows_per_block) * D.  Returns the CUDA error of the launches
// (0 = launched).
extern "C" int ptt_layer_norm_bwd(const void* x, const void* gamma,
                                  const void* mean, const void* rstd,
                                  const void* dy, void* dx, void* dgamma,
                                  void* dbeta, void* part, int N, int D,
                                  int rows_per_block, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch<float>(x, gamma, mu, rs, dy, dx, dgamma, dbeta, pt, N, D,
                         rows_per_block, st);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, mu, rs, dy, dx, dgamma, dbeta, pt, N,
                                 D, rows_per_block, st);
  return (int)cudaErrorInvalidValue;
}
