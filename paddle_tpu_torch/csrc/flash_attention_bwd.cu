// Kernel #2: flash-attention backward for Hopper (sm_90a), in plain CUDA C++.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py:_dq_kernel
// and _dkv_kernel (their pallas_calls are in _flash_bwd).  Same function: from
// Q, K, V, dO, the forward's row LSE and delta = rowsum(dO * O) (one reduction
// done by the wrapper before the launch, as the JAX package does it outside
// Pallas), with the forward's masks — a per-batch key length klen (clamped to
// Tk), causal top-aligned when Tq == Tk and suffix-aligned (query i at key
// position klen - Tq + i) when Tq < Tk — and the forward's murmur3 dropout hash
// bit for bit:
//   P  = exp(scale Q K^T - LSE) on valid (query, key) pairs, else 0
//   G  = dO V^T, zeroed where dropout dropped the weight
//   dS = P (G - delta)
//   dQ = scale dS K,   dK = dS^T (scale Q),   dV = P_drop^T dO.
// A fully masked row has LSE = +1e30, so its P is 0 and its gradients are 0,
// never NaN.  Inputs are float32 or bfloat16; every sum is float32.  bf16
// rounding follows the JAX kernels: scale * Q, P_drop and dS are rounded to
// bf16 before the products that take them.
//
// What bounds it on the H100: at the training shapes (Tq = Tk = 64, D = 64)
// each (b, h) reads Q, K, V, dO once and writes dQ, dK, dV once, and does
// 4 products of 64 x 64 x 64: ~4 x 64 flops per element moved, so in float32
// SIMT (67 TFLOP/s, ~20 flops a byte at 3.35 TB/s) it is bound by operations;
// in bf16 on these SIMT cores too, since it does not use the tensor cores.
//
// Design: two kernels, as on the TPU, because dQ sums over keys while dK and
// dV sum over queries, and blocks have no order to carry a sum between them.
//  - dQ: one block of 256 threads per (b*h, tile of 64 queries), looping over
//    64-key tiles up to the last key any of its queries may see (klen and the
//    causal limit; tiles past it are never loaded).  Each thread owns a 4 x 4
//    patch of the 64 x 64 score tile for S and G, and 4 rows x 16 columns of
//    dQ; dS goes through shared memory for the dS K product.
//  - dK/dV: one block per (b*h, tile of 64 keys), looping over the query
//    tiles that can see any of its keys (none when the tile starts at or past
//    klen: it writes zeros).  Each thread owns a 4 x 4 patch of the transposed
//    tile (4 keys x 4 queries) and 4 rows x 16 columns of dK and dV; P_drop
//    and dS go through shared memory for the two transposed products.
// Tiles are staged into shared memory through registers, 8 loads of each
// operand in flight per thread, as in kernel #1.  Known weaknesses: SIMT
// float32 (no wgmma), no cp.async/TMA double buffering, and for Tq = 64 one
// query tile per block, so nothing overlaps a tile's loads with the previous
// tile's arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

using ptt::from_f;
using ptt::round_to;
using ptt::to_f;

constexpr int BT = 64;   // queries or keys per tile
constexpr int D = 64;    // head dim (the only one the port builds)
constexpr int DP = D + 1;
constexpr int TP = BT + 1;
constexpr int NT = 256;  // threads per block: 16 x 16, a 4 x 4 patch each
constexpr int LD = 8;    // loads of each operand in flight per thread
constexpr int NC = D / 16;
constexpr float kNegInf = -1e30f;
constexpr float kPosBig = 1e30f;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// _keep_mask for one (bh, query, key) position: true = keep
__device__ __forceinline__ bool keep(uint32_t seed, uint32_t bh, int gq, int gk,
                                     uint32_t thresh) {
  uint32_t h = ((uint32_t)gq * 0x85EBCA6Bu) ^ ((uint32_t)gk * 0xC2B2AE35u);
  h ^= seed + bh * 0x9E3779B1u;
  return (mix32(h) >> 8) >= thresh;
}

__device__ __forceinline__ bool valid_pair(int gq, int gk, int kl, int Tq, int Tk,
                                           int causal) {
  bool ok = gk < kl;
  if (causal) ok = ok && (Tq == Tk ? gq >= gk : gq + kl - Tq >= gk);
  return ok;
}

// Copy rows [r0, r0 + BT) of a [rows, D] matrix into a padded [BT][DP] tile,
// times `mul` and rounded to T (mul = 1: a plain copy); rows past `rows` are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int rows, float mul) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j0 = 0; j0 < BT * D / NT; j0 += LD) {
    float r[LD];
#pragma unroll
    for (int j = 0; j < LD; ++j) {
      const int i = tid + (j0 + j) * NT;
      const int g = r0 + i / D;
      r[j] = g < rows ? to_f(src[(size_t)g * D + (i % D)]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < LD; ++j) {
      const int i = tid + (j0 + j) * NT;
      dst[(i / D) * DP + (i % D)] = mul == 1.f ? r[j] : round_to<T>(r[j] * mul);
    }
  }
}

// acc[i][j] += sum_d A[ra + i][d] * B[tx + 16 j][d] over padded tiles
__device__ __forceinline__ void patch_product(float (&acc)[4][4], const float* A,
                                              const float* B, int ra, int tx) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ra + i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[i][c] += sum_t W[ra + i][t] * M[t][tx + 16 c]: a [BT][TP] weight tile
// times a padded [BT][DP] operand tile
__device__ __forceinline__ void rows_times_tile(float (&out)[4][NC], const float* W,
                                                const float* M, int ra, int tx) {
#pragma unroll 4
  for (int t = 0; t < BT; ++t) {
    float w[4], m[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(ra + i) * TP + t];
#pragma unroll
    for (int c = 0; c < NC; ++c) m[c] = M[t * DP + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) out[i][c] = fmaf(w[i], m[c], out[i][c]);
  }
}

constexpr size_t kDqSmem = sizeof(float) * (4 * BT * DP + BT * TP + 2 * BT);
constexpr size_t kDkvSmem = sizeof(float) * (4 * BT * DP + 2 * BT * TP + 2 * BT);

template <typename T>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ klen,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int H,
                int Tq, int Tk, float scale, int causal, uint32_t seed,
                uint32_t thresh, int dropout) {
  extern __shared__ float smem[];
  float* sQ = smem;            // [BT][DP]  scale * Q
  float* sdO = sQ + BT * DP;   // [BT][DP]
  float* sK = sdO + BT * DP;   // [BT][DP]
  float* sV = sK + BT * DP;    // [BT][DP]
  float* sS = sV + BT * DP;    // [BT][TP]  dS of this tile
  float* sL = sS + BT * TP;    // [BT]      LSE
  float* sD = sL + BT;         // [BT]      delta

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BT;
  const int kl = klen[bh / H];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = (tid >> 4) * 4;
  const size_t qoff = (size_t)bh * Tq * D;
  const float qscale = round_to<T>(scale);

  load_tile<T>(sQ, q + qoff, q0, Tq, qscale);
  load_tile<T>(sdO, dout + qoff, q0, Tq, 1.f);
  if (tid < BT) {
    const int gq = q0 + tid;
    sL[tid] = gq < Tq ? lse[(size_t)bh * Tq + gq] : kPosBig;
    sD[tid] = gq < Tq ? delta[(size_t)bh * Tq + gq] : 0.f;
  }

  int kend = kl;
  if (causal) {
    const int last_q = min(q0 + BT, Tq) - 1;
    kend = min(kend, (Tq == Tk ? last_q : last_q + kl - Tq) + 1);
  }
  const int nkt = kend > 0 ? (kend + BT - 1) / BT : 0;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T>(sK, kb, k0, Tk, 1.f);
    load_tile<T>(sV, vb, k0, Tk, 1.f);
    __syncthreads();

    float s[4][4] = {}, g[4][4] = {};
    patch_product(s, sQ, sK, r0, tx);
    patch_product(g, sdO, sV, r0, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gq = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = k0 + tx + 16 * j;
        float ds = 0.f;
        if (valid_pair(gq, gk, kl, Tq, Tk, causal)) {
          const float p = expf(s[i][j] - sL[r0 + i]);
          float gg = g[i][j];
          if (dropout && !keep(seed, (uint32_t)bh, gq, gk, thresh)) gg = 0.f;
          ds = p * (gg - sD[r0 + i]);
        }
        sS[(r0 + i) * TP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    rows_times_tile(acc, sS, sK, r0, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + r0 + i;
    if (gq >= Tq) continue;
    T* row = dq + qoff + (size_t)gq * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ klen,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Tq, int Tk, float scale,
                 int causal, uint32_t seed, uint32_t thresh, int dropout) {
  extern __shared__ float smem[];
  float* sK = smem;            // [BT][DP]
  float* sV = sK + BT * DP;    // [BT][DP]
  float* sQ = sV + BT * DP;    // [BT][DP]  scale * Q
  float* sdO = sQ + BT * DP;   // [BT][DP]
  float* sP = sdO + BT * DP;   // [BT][TP]  P_drop^T: [key][query]
  float* sS = sP + BT * TP;    // [BT][TP]  dS^T
  float* sL = sS + BT * TP;    // [BT]
  float* sD = sL + BT;         // [BT]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const int kl = klen[bh / H];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = (tid >> 4) * 4;  // this thread's first key row in the tile
  const size_t koff = (size_t)bh * Tk * D;
  const size_t qoff = (size_t)bh * Tq * D;
  const float qscale = round_to<T>(scale);

  float ak[4][NC], av[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) ak[i][c] = av[i][c] = 0.f;

  // the first query that may see key k0: all of them without causal;
  // query k0 top-aligned; query k0 - klen + Tq suffix-aligned
  int qbeg = 0;
  if (causal) qbeg = Tq == Tk ? k0 : max(0, k0 - kl + Tq);
  const int nqt = k0 < kl ? (Tq + BT - 1) / BT : 0;

  if (nqt > 0) {
    load_tile<T>(sK, k + koff, k0, Tk, 1.f);
    load_tile<T>(sV, v + koff, k0, Tk, 1.f);
  }
  for (int qt = qbeg / BT; qt < nqt; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();
    load_tile<T>(sQ, q + qoff, q0, Tq, qscale);
    load_tile<T>(sdO, dout + qoff, q0, Tq, 1.f);
    if (tid < BT) {
      const int gq = q0 + tid;
      sL[tid] = gq < Tq ? lse[(size_t)bh * Tq + gq] : kPosBig;
      sD[tid] = gq < Tq ? delta[(size_t)bh * Tq + gq] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, g[4][4] = {};
    patch_product(s, sK, sQ, r0, tx);   // [key][query]
    patch_product(g, sV, sdO, r0, tx);  // G^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jq = tx + 16 * j;
        const int gq = q0 + jq;
        float pd = 0.f, ds = 0.f;
        if (gq < Tq && valid_pair(gq, gk, kl, Tq, Tk, causal)) {
          const float p = expf(s[i][j] - sL[jq]);
          float gg = g[i][j];
          pd = p;
          if (dropout && !keep(seed, (uint32_t)bh, gq, gk, thresh)) {
            pd = 0.f;
            gg = 0.f;
          }
          ds = p * (gg - sD[jq]);
        }
        sP[(r0 + i) * TP + jq] = round_to<T>(pd);
        sS[(r0 + i) * TP + jq] = round_to<T>(ds);
      }
    }
    __syncthreads();
    rows_times_tile(av, sP, sdO, r0, tx);
    rows_times_tile(ak, sS, sQ, r0, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + r0 + i;
    if (gk >= Tk) continue;
    T* rk = dk + koff + (size_t)gk * D;
    T* rv = dv + koff + (size_t)gk * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      rk[tx + 16 * c] = from_f<T>(ak[i][c]);
      rv[tx + 16 * c] = from_f<T>(av[i][c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* klen,
           const void* dout, const float* lse, const float* delta, void* dq,
           void* dk, void* dv, int B, int H, int Tq, int Tk, float scale,
           int causal, uint32_t seed, uint32_t thresh, int dropout,
           cudaStream_t stream) {
  auto kq = flash_dq_kernel<T>;
  auto kkv = flash_dkv_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kq<<<dim3(B * H, (Tq + BT - 1) / BT), NT, kDqSmem, stream>>>(
      qt, kt, vt, klen, dot, lse, delta, static_cast<T*>(dq), H, Tq, Tk, scale,
      causal, seed, thresh, dropout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(B * H, (Tk + BT - 1) / BT), NT, kDkvSmem, stream>>>(
      qt, kt, vt, klen, dot, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tq, Tk, scale, causal, seed, thresh, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

// q/dout [B,H,Tq,64], k/v [B,H,Tk,64] contiguous, all of one dtype; klen [B]
// int32 clamped to Tk; lse/delta [B,H,Tq] float32; dq like q, dk/dv like k.
// Launches the dQ kernel, then the dK/dV kernel.  Returns the CUDA error of
// the launches (0 = launched).
extern "C" int ptt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* klen, const void* dout,
                                       const void* lse, const void* delta, void* dq,
                                       void* dk, void* dv, int B, int H, int Tq,
                                       int Tk, int Dh, float scale, int causal,
                                       unsigned int seed, unsigned int thresh,
                                       int dropout, int dtype, int device,
                                       void* stream) {
  if (Dh != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* kl = static_cast<const int*>(klen);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch<float>(q, k, v, kl, dout, ls, dl, dq, dk, dv, B, H, Tq, Tk,
                         scale, causal, seed, thresh, dropout, st);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, kl, dout, ls, dl, dq, dk, dv, B, H, Tq,
                                 Tk, scale, causal, seed, thresh, dropout, st);
  return (int)cudaErrorInvalidValue;
}
