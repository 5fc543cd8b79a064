// Kernels #5 and #6: fused softmax + cross-entropy, forward and backward, for
// Hopper (sm_90a), in plain CUDA C++.
//
// Replace the TPU kernels paddle_tpu/ops/pallas/softmax_xent.py:_fwd_kernel
// and _bwd_kernel (their pallas_calls are in _fwd and _bwd).  Same functions
// over rows of logits x [N, C] with hard labels [N] (int64), uniform label
// smoothing eps fused in:
//   forward:  loss = (1 - eps) (logZ - x[label]) + eps (logZ - mean(x)),
//             softmax = exp(x - logZ);
//   backward: dlogits = (softmax - target) dloss + softmax (dsm - sum(dsm softmax)),
//             target = (1 - eps) onehot(label) + eps / C.
// As in the TPU kernels' iota compare, the label is matched against the
// column index: a label outside [0, C) picks 0 and has no onehot term, and
// nothing is read out of bounds.  dsm (the cotangent of the softmax output)
// may be a null pointer, meaning zero: the backward then reads only the
// softmax.  Inputs are float32 or bfloat16; every sum is float32.
//
// What bounds them on the H100: device memory.  At the Transformer's
// 16384 x 32000 float32 the forward reads 2.1 GB and writes 2.1 GB, the
// backward (no dsm) the same, each at a few flops an element.
//
// Design: one block of 256 threads per row; the TPU kernel stages a block of
// rows in VMEM, here a row of 32000 floats (128 KB) is streamed.  Forward:
// one pass keeps a per-thread running max and sum of exp (rescaled when the
// max grows, so an element costs one exp), and the sum of x; the block
// combines them through shared memory in a fixed order; a second pass
// re-reads the row (mostly from L2, which holds the rows in flight) and writes
// the softmax.  Backward without dsm: one pass, softmax in, dlogits out; with
// dsm, a first pass sums dsm softmax.  Known weakness: the forward's second
// read of the row, and scalar (not 16-byte) loads.

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

using ptt::from_f;
using ptt::to_f;
using ptt::warp_sum;

constexpr int NT = 256;
constexpr int NW = NT / 32;

// (m, s) running max and sum of exp(x - m): merge b into a
__device__ __forceinline__ void merge(float& m, float& s, float mb, float sb) {
  if (sb == 0.f) return;
  if (s == 0.f) {
    m = mb;
    s = sb;
    return;
  }
  const float mn = fmaxf(m, mb);
  s = s * expf(m - mn) + sb * expf(mb - mn);
  m = mn;
}

// sum over the block, in a fixed order; every thread gets the result
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) t += red[w];
  return t;
}

template <typename T>
__global__ void __launch_bounds__(NT)
softmax_xent_fwd_kernel(const T* __restrict__ logits,
                        const long long* __restrict__ label, T* __restrict__ loss,
                        T* __restrict__ softmax, int C, float eps) {
  __shared__ float red_m[NW], red_s[NW], red[NW];
  const int row = blockIdx.x;
  const T* xr = logits + (size_t)row * C;
  float m = 0.f, s = 0.f, sx = 0.f;
#pragma unroll 4
  for (int c = threadIdx.x; c < C; c += NT) {
    const float v = to_f(xr[c]);
    sx += v;
    if (s == 0.f) {
      m = v;
      s = 1.f;
    } else if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mb = __shfl_xor_sync(0xffffffffu, m, off);
    const float sb = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, mb, sb);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) merge(m, s, red_m[w], red_s[w]);
  sx = block_sum(sx, red);

  if (threadIdx.x == 0) {
    const float log_z = m + logf(s);
    const long long lbl = label[row];
    const float picked = (lbl >= 0 && lbl < C) ? to_f(xr[lbl]) : 0.f;
    float l = log_z - picked;
    if (eps != 0.f) l = (1.f - eps) * l + eps * (log_z - sx / C);
    loss[row] = from_f<T>(l);
  }
  const float inv_s = 1.f / s;
  T* sr = softmax + (size_t)row * C;
#pragma unroll 4
  for (int c = threadIdx.x; c < C; c += NT)
    sr[c] = from_f<T>(expf(to_f(xr[c]) - m) * inv_s);
}

template <typename T>
__global__ void __launch_bounds__(NT)
softmax_xent_bwd_kernel(const T* __restrict__ softmax,
                        const long long* __restrict__ label,
                        const T* __restrict__ dloss, const T* __restrict__ dsm,
                        T* __restrict__ dlogits, int C, float eps) {
  __shared__ float red[NW];
  const int row = blockIdx.x;
  const size_t off = (size_t)row * C;
  const T* sr = softmax + off;
  const float g = to_f(dloss[row]);
  const long long lbl = label[row];
  const float base = eps / C;
  float inner = 0.f;
  if (dsm != nullptr) {
    float t = 0.f;
#pragma unroll 4
    for (int c = threadIdx.x; c < C; c += NT) t = fmaf(to_f(dsm[off + c]), to_f(sr[c]), t);
    inner = block_sum(t, red);
  }
  T* out = dlogits + off;
#pragma unroll 4
  for (int c = threadIdx.x; c < C; c += NT) {
    const float p = to_f(sr[c]);
    const float target = c == lbl ? base + (1.f - eps) : base;
    float d = (p - target) * g;
    if (dsm != nullptr) d += p * (to_f(dsm[off + c]) - inner);
    out[c] = from_f<T>(d);
  }
}

template <typename T>
int launch_fwd(const void* logits, const long long* label, void* loss,
               void* softmax, int N, int C, float eps, cudaStream_t stream) {
  softmax_xent_fwd_kernel<T><<<N, NT, 0, stream>>>(
      static_cast<const T*>(logits), label, static_cast<T*>(loss),
      static_cast<T*>(softmax), C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* softmax, const long long* label, const void* dloss,
               const void* dsm, void* dlogits, int N, int C, float eps,
               cudaStream_t stream) {
  softmax_xent_bwd_kernel<T><<<N, NT, 0, stream>>>(
      static_cast<const T*>(softmax), label, static_cast<const T*>(dloss),
      static_cast<const T*>(dsm), static_cast<T*>(dlogits), C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// logits [N, C] contiguous (float32 or bfloat16), label [N] int64; loss [N, 1]
// and softmax [N, C] of logits' dtype.  Returns the CUDA error of the launch.
extern "C" int ptt_softmax_xent_fwd(const void* logits, const void* label,
                                    void* loss, void* softmax, int N, int C,
                                    float eps, int dtype, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long* lb = static_cast<const long long*>(label);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_fwd<float>(logits, lb, loss, softmax, N, C, eps, st);
  if (dtype == ptt::kBFloat16)
    return launch_fwd<__nv_bfloat16>(logits, lb, loss, softmax, N, C, eps, st);
  return (int)cudaErrorInvalidValue;
}

// softmax [N, C] contiguous, label [N] int64, dloss [N, 1], dsm [N, C] or null
// (zero); dlogits like softmax.  Returns the CUDA error of the launch.
extern "C" int ptt_softmax_xent_bwd(const void* softmax, const void* label,
                                    const void* dloss, const void* dsm,
                                    void* dlogits, int N, int C, float eps,
                                    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long* lb = static_cast<const long long*>(label);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_bwd<float>(softmax, lb, dloss, dsm, dlogits, N, C, eps, st);
  if (dtype == ptt::kBFloat16)
    return launch_bwd<__nv_bfloat16>(softmax, lb, dloss, dsm, dlogits, N, C, eps,
                                     st);
  return (int)cudaErrorInvalidValue;
}
