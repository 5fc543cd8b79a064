// Kernel A: layer-norm forward for Hopper (sm_90a), in plain CUDA C++.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/layer_norm.py:_fwd_kernel
// (its pallas_call is in _fwd).  Same function over rows of x [N, D]:
// mean, variance = mean((x - mean)^2), y = (x - mean) / sqrt(var + eps)
// * gamma + beta.  Inputs are float32 or bfloat16; the statistics are
// float32 whatever the input type and are returned as float32; y takes the
// input type.
//
// What bounds it on the H100: device memory.  It reads x once and writes y
// once (plus 8 bytes of statistics a row) and does about 8 flops an element,
// far below the ~20 flops a byte at which the float32 units would bind.
//
// Design: one warp per row, four rows per 128-thread block.  Lanes stride the
// row, so each load and store of the warp covers consecutive addresses.  The
// TPU kernel keeps a block of rows in VMEM for its three passes (mean,
// variance, normalize); here the row is read three times from global memory,
// the second and third times from L1/L2 (a 512-float row is 2 KB), so device
// memory sees it once.  No shared memory, no tensor cores.

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using ptt::from_f;
using ptt::to_f;
using ptt::warp_sum;

constexpr int kRowsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ var, int N,
                      int D, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // whole warps leave together
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / D;
  float sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = to_f(xr[c]) - mu;
    sq = fmaf(d, d, sq);
  }
  const float vr = warp_sum(sq) / D;
  const float rstd = 1.f / sqrtf(vr + eps);
  T* yr = y + (size_t)row * D;
  for (int c = lane; c < D; c += 32)
    yr[c] = from_f<T>((to_f(xr[c]) - mu) * rstd * to_f(gamma[c]) + to_f(beta[c]));
  if (lane == 0) {
    mean[row] = mu;
    var[row] = vr;
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           float* mean, float* var, int N, int D, float eps,
           cudaStream_t stream) {
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_fwd_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y), mean, var, N, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, D] contiguous, gamma/beta [D] of x's dtype; y like x; mean/var [N]
// float32.  Returns the CUDA error of the launch (0 = launched).
extern "C" int ptt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* var, int N, int D, float eps, int dtype,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  float* mu = static_cast<float*>(mean);
  float* vr = static_cast<float*>(var);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch<float>(x, gamma, beta, y, mu, vr, N, D, eps, st);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, beta, y, mu, vr, N, D, eps, st);
  return (int)cudaErrorInvalidValue;
}
