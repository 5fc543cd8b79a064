// Kernel B: flash-attention forward for Hopper (sm_90a), in plain CUDA C++.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (its pallas_call is in _flash_fwd).  Same function: O and the row LSE of
// softmax(scale * Q K^T) V under a per-batch key length klen (clamped to Tk by
// the wrapper) and an optional causal mask — top-aligned when Tq == Tk, suffix
// (query i at key position klen - Tq + i) when Tq < Tk — plus the murmur3
// counter-hash dropout of _keep_mask, bit for bit, without upscaling.  A fully
// masked row gives zeros and an LSE of +1e30.  Inputs are float32 or bfloat16;
// every sum is float32.  bf16 rounding follows the JAX package's reference:
// scale * Q is rounded to bf16, and so are the probabilities fed to P V.
//
// What bounds it on the H100: at the serving shapes (D = 64) the work per byte
// is small — a decode step (Tq = 1) reads K and V once and does 4 * Tk * D
// flops per (b, h), so it is bound by device memory; a causal prefill does
// about 2 * Tq * D flops per K/V element read, and its bound is the float32
// rate of the SIMT cores, which this kernel uses instead of tensor cores.
//
// Design: one block of 256 threads per (b*h, tile of 64 queries).  The TPU
// kernel holds a whole K/V row of one (b, h) in VMEM and walks it with a
// fori_loop; here a loop inside the block streams 64-key tiles of K and V
// through shared memory (a block has at most 227 KB), with the online softmax
// (running max m, sum l, accumulator O) in registers: each thread owns a 4x4
// patch of the 64x64 score tile and 4 rows x D/16 columns of O.  Each thread
// starts 8 K and 8 V loads before it stores any of them to shared memory,
// so a tile costs a few device-memory latencies, not one per element.  Key
// tiles past klen, and past the causal limit of the query tile, are never
// loaded.
// Warps whose 8 query rows all lie past Tq skip the arithmetic, so a decode
// tile (Tq = 1) computes with one warp and loads with all eight.  Known
// weakness: a decode step has only B*H blocks (64 on the serving shape, for
// 132 SMs); a split-K design, cp.async/TMA double buffering and wgmma belong
// to later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

using ptt::from_f;
using ptt::round_to;
using ptt::to_f;

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 x 16, 4 rows x 4 keys each
constexpr int LD = 8;    // K and V loads each thread keeps in flight
constexpr float kNegInf = -1e30f;
constexpr float kPosBig = 1e30f;

// murmur3 finalizer, as _mix32
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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ klen,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Tq,
                 int Tk, float scale, int causal, uint32_t seed,
                 uint32_t thresh, int dropout) {
  constexpr int DP = D + 1;   // padded row: conflict-free column reads
  constexpr int PP = BK + 1;
  constexpr int NC = D / 16;  // output columns per thread
  static_assert(BK * D % (NT * LD) == 0, "tile load does not split evenly");
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][DP]  scale * Q
  float* sK = sQ + BQ * DP;    // [BK][DP]
  float* sV = sK + BK * DP;    // [BK][D]
  float* sP = sV + BK * D;     // [BQ][PP]  probabilities of this tile

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int kl = klen[bh / H];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = (tid >> 4) * 4;  // this thread's first query row in the tile
  // warp w holds tile rows 8w .. 8w+7; skip its arithmetic if all are past Tq
  const bool warp_active = q0 + (tid >> 5) * 8 < Tq;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const float qscale = round_to<T>(scale);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i - r * D;
    const int gq = q0 + r;
    sQ[r * DP + c] =
        gq < Tq ? round_to<T>(to_f(qb[(size_t)gq * D + c]) * qscale) : 0.f;
  }

  // keys at or past kend are masked for every query of this tile
  int kend = kl;
  if (causal) {
    const int last_q = min(q0 + BQ, Tq) - 1;
    kend = min(kend, (Tq == Tk ? last_q : last_q + kl - Tq) + 1);
  }
  const int nkt = kend > 0 ? (kend + BK - 1) / BK : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    // Stage the tile through registers, LD chunks of loads in flight
    // before the first store: a load-then-store loop waits out one
    // device-memory latency per element it copies.
#pragma unroll
    for (int j0 = 0; j0 < BK * D / NT; j0 += LD) {
      float kr[LD], vr[LD];
#pragma unroll
      for (int j = 0; j < LD; ++j) {
        const int i = tid + (j0 + j) * NT;
        const int gk = k0 + i / D;
        const size_t off = (size_t)gk * D + (i % D);
        kr[j] = gk < Tk ? to_f(kb[off]) : 0.f;
        vr[j] = gk < Tk ? to_f(vb[off]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < LD; ++j) {
        const int i = tid + (j0 + j) * NT;
        const int r = i / D, c = i % D;
        sK[r * DP + c] = kr[j];
        sV[r * D + c] = vr[j];
      }
    }
    __syncthreads();

    if (warp_active) {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sQ[(r0 + i) * DP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gq = q0 + r0 + i;
        bool valid[4];
        float rowmax = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gk = k0 + tx + 16 * j;
          bool ok = gk < kl;
          if (causal) ok = ok && (Tq == Tk ? gq >= gk : gq + kl - Tq >= gk);
          valid[j] = ok;
          if (!ok) s[i][j] = kNegInf;
          rowmax = fmaxf(rowmax, s[i][j]);
        }
        // the 16 threads of a row are one half-warp
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, off));
        const float m_new = fmaxf(m[i], rowmax);
        float p[4], psum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = valid[j] ? expf(s[i][j] - m_new) : 0.f;
          psum += p[j];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + psum;  // the normalizer counts dropped keys too
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gk = k0 + tx + 16 * j;
          if (dropout && !keep(seed, (uint32_t)bh, gq, gk, thresh)) p[j] = 0.f;
          sP[(r0 + i) * PP + tx + 16 * j] = round_to<T>(p[j]);
        }
      }
    }
    __syncthreads();

    if (warp_active) {
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float pa[4], vv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = sP[(r0 + i) * PP + c];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) vv[cc] = sV[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) acc[i][cc] = fmaf(pa[i], vv[cc], acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + r0 + i;
    if (gq >= Tq) continue;
    const bool valid_row = l[i] > 0.f;
    const float den = valid_row ? l[i] : 1.f;
    T* orow = o + ((size_t)bh * Tq + gq) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) orow[tx + 16 * cc] = from_f<T>(acc[i][cc] / den);
    if (tx == 0)
      lse[(size_t)bh * Tq + gq] =
          valid_row ? m[i] + logf(fmaxf(l[i], 1e-37f)) : kPosBig;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* klen, void* o,
           float* lse, int B, int H, int Tq, int Tk, float scale, int causal,
           uint32_t seed, uint32_t thresh, int dropout, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), klen, static_cast<T*>(o), lse, H, Tq, Tk,
      scale, causal, seed, thresh, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,Tq,D=64], k/v [B,H,Tk,D] contiguous, all of one dtype; klen [B] int32,
// already clamped to Tk; o like q; lse [B,H,Tq] float32.  Returns the CUDA
// error of the launch (0 = launched).
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* klen, void* o, void* lse, int B,
                                       int H, int Tq, int Tk, int D, float scale,
                                       int causal, unsigned int seed,
                                       unsigned int thresh, int dropout, int dtype,
                                       int device, void* stream) {
  // head dim 64 only: the Transformer-base decoder's d_model 512 / 8 heads
  if (D != 64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* kl = static_cast<const int*>(klen);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch<float, 64>(q, k, v, kl, o, ls, B, H, Tq, Tk, scale, causal,
                             seed, thresh, dropout, st);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16, 64>(q, k, v, kl, o, ls, B, H, Tq, Tk, scale,
                                     causal, seed, thresh, dropout, st);
  return (int)cudaErrorInvalidValue;
}
