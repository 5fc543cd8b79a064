// Kernel #3: layer-norm forward for Hopper (sm_90a), in plain CUDA C++.
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
// Design: one warp a row, the warps of a grid no larger than the card
// holds at once walking the rows (warp w takes rows w, w + warps, ...).
// At D = 512 (the Transformer's and the serving decoder's width; a template
// parameter) the row comes into registers at once with 16-byte loads, 16
// values a lane (4 float4, or 2 x 8 bf16), lane l holding the 16-byte
// chunks l, l + 32, ... so that each load of the warp covers 512
// consecutive bytes; the next row's loads are issued before this row is
// normalized; the mean and then the two-pass variance mean((x -
// mean)^2) come from registers (the TPU kernel's formula), and y leaves
// with 16-byte stores.  gamma and beta are loaded once a warp, into
// registers, and serve every row the warp takes.  Any other D, and rows or
// vectors not on 16-byte addresses, take the generic loop: lanes stride the
// row, which is read three times (the second and third from L1).  When N
// is below a wave of the SMs, a block takes fewer warps, so that more SMs
// take part.  Each row's sums are a warp's, in a fixed order: the same bits
// every launch, whatever warp takes the row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

using ptt::from_f;
using ptt::to_f;
using ptt::warp_sum;

constexpr int kMaxWarps = 8;  // warps of a block
constexpr int kVecD = 512;    // the row width of the register path

// 16 bytes at a 16-byte aligned p as floats, and back
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// D: the row width of the register path, 0 for the generic loop
template <typename T, int D>
__global__ void __launch_bounds__(32 * kMaxWarps)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ var, int N,
                      int Dn, float eps) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int first = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if constexpr (D == 0) {
    for (int row = first; row < N; row += warps) {
      const T* xr = x + (size_t)row * Dn;
      float s = 0.f;
      for (int c = lane; c < Dn; c += 32) s += to_f(xr[c]);
      const float mu = warp_sum(s) / Dn;
      float sq = 0.f;
      for (int c = lane; c < Dn; c += 32) {
        const float d = to_f(xr[c]) - mu;
        sq = fmaf(d, d, sq);
      }
      const float vr = warp_sum(sq) / Dn;
      const float rstd = 1.f / sqrtf(vr + eps);
      T* yr = y + (size_t)row * Dn;
      for (int c = lane; c < Dn; c += 32)
        yr[c] = from_f<T>((to_f(xr[c]) - mu) * rstd * to_f(gamma[c]) +
                          to_f(beta[c]));
      if (lane == 0) {
        mean[row] = mu;
        var[row] = vr;
      }
    }
  } else {
    constexpr int VE = 16 / sizeof(T);    // values a 16-byte chunk
    constexpr int NV = D / (32 * VE);     // chunks a lane
    static_assert(D % (32 * VE) == 0, "D must fill whole 16-byte chunks");
    float g[NV][VE], b[NV][VE];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      load16(gamma + (k * 32 + lane) * VE, g[k]);
      load16(beta + (k * 32 + lane) * VE, b[k]);
    }
    // the row in registers; the next row's loads go out before this row's
    // arithmetic and stores, so that a warp keeps a row in flight
    float v[NV][VE];
    int row = first;
    if (row < N) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
        load16(x + (size_t)row * D + (k * 32 + lane) * VE, v[k]);
    }
    for (; row < N; row += warps) {
      const int next = row + warps;
      float nx[NV][VE];
      if (next < N) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
          load16(x + (size_t)next * D + (k * 32 + lane) * VE, nx[k]);
      }
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < VE; ++i) s += v[k][i];
      const float mu = warp_sum(s) / D;
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < VE; ++i) {
          const float d = v[k][i] - mu;
          sq = fmaf(d, d, sq);
        }
      const float vr = warp_sum(sq) / D;
      const float rstd = 1.f / sqrtf(vr + eps);
      T* yr = y + (size_t)row * D;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        float o[VE];
#pragma unroll
        for (int i = 0; i < VE; ++i) o[i] = (v[k][i] - mu) * rstd * g[k][i] + b[k][i];
        store16(yr + (k * 32 + lane) * VE, o);
      }
      if (lane == 0) {
        mean[row] = mu;
        var[row] = vr;
      }
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < VE; ++i) v[k][i] = nx[k][i];
    }
  }
}

// The launch plan of N rows of D values: [register-path D (0: the generic
// loop), warps a block, blocks, SMs, blocks an SM holds].  A block takes
// ceil(N / SMs) warps, at most kMaxWarps; the grid is one wave of the
// blocks the card holds at once, fewer when the rows do not fill them.
template <typename T>
int plan(int N, int D, bool aligned, int device, int* out) {
  static int sms[16], resident[16][2][kMaxWarps + 1];
  if (device < 0 || device >= 16) return (int)cudaErrorInvalidDevice;
  const bool vec = D == kVecD && aligned;
  const void* kern = vec ? (const void*)layer_norm_fwd_kernel<T, kVecD>
                         : (const void*)layer_norm_fwd_kernel<T, 0>;
  cudaError_t err;
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
  }
  const int wpb = min(kMaxWarps, max(1, (N + sms[device] - 1) / sms[device]));
  int& per_sm = resident[device][vec][wpb];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * wpb,
                                                        0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  out[0] = vec ? kVecD : 0;
  out[1] = wpb;
  out[2] = max(1, min((N + wpb - 1) / wpb, per_sm * sms[device]));
  out[3] = sms[device];
  out[4] = per_sm;
  return 0;
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) & 15) == 0;
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           float* mean, float* var, int N, int D, float eps, int device,
           cudaStream_t stream) {
  int p[5];
  const int err = plan<T>(N, D, aligned16(x, gamma, beta, y), device, p);
  if (err) return err;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gamma);
  const T* bt = static_cast<const T*>(beta);
  T* yt = static_cast<T*>(y);
  if (p[0] == kVecD)
    layer_norm_fwd_kernel<T, kVecD><<<p[2], 32 * p[1], 0, stream>>>(
        xt, gt, bt, yt, mean, var, N, D, eps);
  else
    layer_norm_fwd_kernel<T, 0><<<p[2], 32 * p[1], 0, stream>>>(
        xt, gt, bt, yt, mean, var, N, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan of N rows of D values of `dtype` whose x, gamma, beta and y
// all start on 16 bytes (`aligned`): out [5] = register-path D (0: generic),
// warps a block, blocks, SMs, blocks an SM holds: what a launch takes, for
// tests.  Returns a CUDA error (0 = planned).
extern "C" int ptt_layer_norm_fwd_plan(int N, int D, int dtype, int aligned,
                                       int device, int* out) {
  if (dtype == ptt::kFloat32) return plan<float>(N, D, aligned, device, out);
  if (dtype == ptt::kBFloat16)
    return plan<__nv_bfloat16>(N, D, aligned, device, out);
  return (int)cudaErrorInvalidValue;
}

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
    return launch<float>(x, gamma, beta, y, mu, vr, N, D, eps, device, st);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, beta, y, mu, vr, N, D, eps, device,
                                 st);
  return (int)cudaErrorInvalidValue;
}
