// Kernel #2: flash-attention backward for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py:_dq_kernel
// and _dkv_kernel (their pallas_calls are in _flash_bwd).  Same function: from
// Q, K, V, dO, the forward's O and row LSE, with the forward's masks — a
// per-batch key length klen (clamped to Tk here), causal top-aligned when
// Tq == Tk and suffix-aligned (query i at key position klen - Tq + i) when
// Tq < Tk — and the forward's murmur3 dropout hash bit for bit:
//   P  = exp(scale Q K^T - LSE) on valid (query, key) pairs, else 0
//   G  = dO V^T, zeroed where dropout dropped the weight
//   dS = P (G - delta),  delta = rowsum(dO * O)
//   dQ = scale dS K,   dK = dS^T (scale Q),   dV = P_drop^T dO.
// A fully masked row has LSE = +1e30, so its P is 0 and its gradients are 0,
// never NaN.  Inputs are float32 or bfloat16; every sum is float32.  bf16
// rounding follows the JAX kernels: scale * Q, P_drop and dS are rounded to
// bf16 before the products that take them.
//
// What bounds it on the H100: at the training shapes (Tq = Tk = 64, D = 64)
// each (b, h) reads Q, K, V, dO, O once and writes dQ, dK, dV once (32 KB in
// float32) for five 64 x 64 x 64 products (2.6 MFLOP): ~80 flops a byte, so
// the bytes bound it only if the products run on the tensor cores.
//
// Design:
//  - One pass.  A block of 8 warps takes one (b*h, tile of 64 keys) and
//    loops over the 64-query tiles that can see its keys, as _dkv_kernel
//    does.  Per query tile it computes S and G once and from them P and dS,
//    then dV, dK and this key tile's part of dQ: five products, not the
//    seven of a dQ kernel beside a dK/dV kernel.  When one key tile covers
//    Tk (every training launch) that part is dQ and is written directly;
//    otherwise the parts go to a float32 scratch [B*H, key tiles, Tq, 64]
//    and dq_sum adds them in key-tile order (no atomics: the same bits
//    every run).
//  - delta and the klen clamp are computed here, from dO (in shared memory)
//    and O (read once), so the wrapper launches nothing else.
//  - Tensor cores through mma.sync: float32 as three TF32 passes of a hi/lo
//    split of each operand (hi = tf32(v), lo = tf32(v - hi); lo*hi + hi*lo +
//    hi*hi, lo*lo dropped), bfloat16 as one m16n8k16 pass.  Fragments are
//    read from float32 tiles in shared memory, so each product takes its
//    operands transposed or not by its index order alone: dV = P^T dO,
//    dK = dS^T Q and dQ = dS K need no transposed copies, which wgmma's
//    K-major TF32 operands would (Q^T, K^T, dO^T and hi/lo of every tile
//    do not fit beside each other in 227 KB).
//  - Two warp teams: warps 0-3 compute S, then dV; warps 4-7 G, then dK;
//    each warp a 32 x 32 quadrant (8 independent accumulator tiles, 24
//    mma a k step, each fragment split once for 2-4 products).  S and G
//    meet in shared memory, where all 8 warps turn them into P_drop and dS;
//    dQ is cut in 16 x 32 pieces, one a warp, interleaved with dV / dK.
//    The three passes go pass by pass over a step's tiles, so that no two
//    consecutive mma add into one accumulator.
//  - The tiles are XOR-swizzled rows of 64 floats, so that both fragment
//    patterns (8 rows x 4 columns and 4 rows x 8 columns) hit 32 banks.
//  - Loads: 16-byte cp.async for float32 (bfloat16 through registers, where
//    Q is scaled and rounded).  Six 16 KB tiles fit two blocks an SM, so
//    one block's loads overlap the other's products.
//  - The masks, the dropout hash, the swizzle, the mma products and the
//    tile loads are attention.cuh's, shared with the forward (#1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"
#include "dtype.cuh"

namespace {

using ptt::from_f;
using ptt::round_to;
using ptt::to_f;

constexpr int kThreads = 256;  // 8 warps
constexpr float kPosBig = 1e30f;
// Q, dO, K, V, P_drop, dS tiles and the rows' LSE and delta
constexpr size_t kSmem = sizeof(float) * (6 * kTile + 2 * kBT);

// a warp's accumulators into a swizzled tile at (row r0, column c0)
template <int MT, int NJ>
__device__ __forceinline__ void stage(const float (&acc)[MT][NJ][4], float* dst,
                                      int r0, int c0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dst + sidx(r0 + 16 * i + g + 8 * h,
                                              c0 + 8 * j + 2 * t)) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

// 16 consecutive values of a row, as float32
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p, float (&f)[16]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 u = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = u.x;
      f[4 * i + 1] = u.y;
      f[4 * i + 2] = u.z;
      f[4 * i + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float h[8];
      unpack(reinterpret_cast<const uint4*>(p)[i], h);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[8 * i + e] = h[e];
    }
  }
}

// P_drop and dS of the tile, from S (staged in sP) and G (in sS), in
// place, rounded to T: a thread takes 16 of a row's columns
template <typename T>
__device__ __forceinline__ void p_ds(float* sP, float* sS, const float* sL,
                                     const float* sDl, int q0, int k0, int kl,
                                     int Tq, int Tk, int causal, uint32_t seed,
                                     uint32_t bh, uint32_t thresh, int dropout) {
  const int r = threadIdx.x >> 2, gq = q0 + r;
  const float lse = sL[r], delta = sDl[r];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = (threadIdx.x & 3) * 4 + 16 * i;
    float4* ps = reinterpret_cast<float4*>(sP + sidx(r, c));
    float4* pg = reinterpret_cast<float4*>(sS + sidx(r, c));
    const float4 s4 = *ps, g4 = *pg;
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, gv[4] = {g4.x, g4.y, g4.z, g4.w};
    float pd[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gk = k0 + c + e;
      pd[e] = ds[e] = 0.f;
      if (gq < Tq && valid_pair(gq, gk, kl, Tq, Tk, causal)) {
        const float p = expf(sv[e] - lse);
        float gg = gv[e];
        pd[e] = p;
        if (dropout && !keep(seed, bh, gq, gk, thresh)) {
          pd[e] = 0.f;
          gg = 0.f;
        }
        ds[e] = p * (gg - delta);
      }
    }
    *ps = make_float4(round_to<T>(pd[0]), round_to<T>(pd[1]), round_to<T>(pd[2]),
                      round_to<T>(pd[3]));
    *pg = make_float4(round_to<T>(ds[0]), round_to<T>(ds[1]), round_to<T>(ds[2]),
                      round_to<T>(ds[3]));
  }
}

// rows [q0, q0 + 64) of this key tile's dQ part: zero
template <typename T>
__device__ __forceinline__ void zero_dq(T* dq, float* dqp, size_t off, int q0,
                                        int Tq) {
  for (int i = threadIdx.x; i < kBT * kD / 2; i += kThreads) {
    const int r = q0 + i / (kD / 2), c = (i % (kD / 2)) * 2;
    if (r >= Tq) continue;
    if (dqp)
      *reinterpret_cast<float2*>(dqp + off + (size_t)r * kD + c) =
          make_float2(0.f, 0.f);
    else
      store2<T>(dq + off + (size_t)r * kD + c, 0.f, 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const int* __restrict__ klen,
                 const float* __restrict__ lse, T* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dqp,
                 int H, int Tq, int Tk, float scale, int causal,
                 const uint32_t* __restrict__ seed_ptr, uint32_t thresh,
                 int dropout, HashRows rows) {
  extern __shared__ float4 smem4[];
  // the forward's dropout seed, read from device memory as #1 reads it
  const uint32_t seed = dropout ? *seed_ptr : 0u;
  float* sQ = reinterpret_cast<float*>(smem4);  // Q (bf16: scale * Q)
  float* sdO = sQ + kTile;
  float* sK = sdO + kTile;
  float* sV = sK + kTile;
  float* sP = sV + kTile;   // P_drop [query][key]
  float* sS = sP + kTile;   // dS [query][key]
  float* sL = sS + kTile;   // [64] LSE
  float* sDl = sL + kBT;    // [64] delta

  const int bh = blockIdx.x;
  const int nkt = gridDim.y;
  const int k0 = blockIdx.y * kBT;
  const int kl = klen ? min(klen[bh / H], Tk) : Tk;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const size_t qoff = (size_t)bh * Tq * kD, koff = (size_t)bh * Tk * kD;
  // this key tile's dQ part: dq itself when it is the only key tile, else
  // its slice of the scratch
  float* part = nkt > 1 ? dqp : nullptr;
  const size_t poff = nkt > 1 ? ((size_t)bh * nkt + blockIdx.y) * Tq * kD : qoff;
  // float32 scales Q as a fragment is read; bfloat16 holds scale * Q rounded
  const float qmul = sizeof(T) == 4 ? scale : 1.f;
  const float qround = sizeof(T) == 4 ? 1.f : round_to<T>(scale);

  // the query tiles that see any of these keys: all of them without
  // causal; from query k0 top-aligned, k0 - klen + Tq suffix-aligned
  const int nqt = (Tq + kBT - 1) / kBT;
  int qt0 = nqt;
  if (k0 < kl) qt0 = causal ? (Tq == Tk ? k0 : max(0, k0 - kl + Tq)) / kBT : 0;
  for (int qt = 0; qt < qt0; ++qt) zero_dq<T>(dq, part, poff, qt * kBT, Tq);

  // team 0 (warps 0-3) computes S and dV, team 1 G and dK, each warp a 32 x
  // 32 quadrant; dQ is cut in 16 x 32 pieces, one a warp
  const int team = warp >> 2, mr = (warp & 1) * 32, nc = ((warp >> 1) & 1) * 32;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;
  float* sA = team ? sdO : sQ;          // S = (scale Q) K^T, G = dO V^T
  float* sB = team ? sV : sK;
  const float amul = team ? 1.f : qmul;
  float* sX = team ? sS : sP;           // dV = P_drop^T dO, dK = dS^T (scale Q)
  float* sY = team ? sQ : sdO;
  const float ymul = team ? qmul : 1.f;
  float acc[2][4][4] = {};              // dV or dK of the quadrant
  if (qt0 < nqt) {
    load_tile<T, kThreads>(sK, k + koff, k0, Tk, 1.f);
    load_tile<T, kThreads>(sV, v + koff, k0, Tk, 1.f);
  }
  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * kBT;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, kThreads>(sQ, q + qoff, q0, Tq, qround);
    load_tile<T, kThreads>(sdO, dout + qoff, q0, Tq, 1.f);
    cp_commit();
    // delta = rowsum(dO * O): four threads a row, 16 columns each
    const int dr = tid >> 2, dc = (tid & 3) * 16, gq = q0 + dr;
    float of[16] = {};
    if (gq < Tq) load16<T>(o + qoff + (size_t)gq * kD + dc, of);
    cp_wait<0>();
    __syncthreads();
    float dsum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(sdO + sidx(dr, dc + i));
      dsum += d4.x * of[i] + d4.y * of[i + 1] + d4.z * of[i + 2] + d4.w * of[i + 3];
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
    if ((tid & 3) == 0) {
      sDl[dr] = gq < Tq ? dsum : 0.f;
      sL[dr] = gq < Tq ? lse[(size_t)bh * Tq + gq] : kPosBig;
    }

    // S (team 0) or G (team 1) of the quadrant: queries mr.., keys nc..,
    // staged into sP or sS
    {
      float sg[2][4][4] = {};
      auto aSG = [&](int m, int c) { return sA[sidx(mr + m, c)] * amul; };
      auto bSG = [&](int c, int n) { return sB[sidx(nc + n, c)]; };
#pragma unroll
      for (int c = 0; c < kD; c += kStep<T>) mma_step<T>(sg, aSG, bSG, c);
      stage(sg, sX, mr, nc);
    }
    __syncthreads();
    p_ds<T>(sP, sS, sL, sDl, q0, k0, kl, Tq, Tk, causal, seed,
            hash_row(rows, bh, H), thresh, dropout);
    __syncthreads();

    // dV (team 0) or dK (team 1) of the quadrant, keys mr.., d nc..; and
    // this key tile's dS K for queries wr.., d wc..
    float aq[1][4][4] = {};
    auto aXY = [&](int m, int c) { return sX[sidx(c, mr + m)]; };
    auto bXY = [&](int c, int n) { return sY[sidx(c, nc + n)] * ymul; };
    auto aQ = [&](int m, int c) { return sS[sidx(wr + m, c)]; };
    auto bQ = [&](int c, int n) { return sK[sidx(c, wc + n)]; };
#pragma unroll
    for (int c = 0; c < kBT; c += kStep<T>) {
      mma_step<T>(acc, aXY, bXY, c);
      mma_step<T>(aq, aQ, bQ, c);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + wr + g + 8 * h;
      if (r >= Tq) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t at = poff + (size_t)r * kD + wc + 8 * j + 2 * t;
        if (part)
          *reinterpret_cast<float2*>(part + at) =
              make_float2(aq[0][j][2 * h], aq[0][j][2 * h + 1]);
        else
          store2<T>(dq + at, aq[0][j][2 * h] * scale, aq[0][j][2 * h + 1] * scale);
      }
    }
  }

  T* out = team ? dk : dv;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = k0 + mr + 16 * i + g + 8 * h;
      if (r >= Tk) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store2<T>(out + koff + (size_t)r * kD + nc + 8 * j + 2 * t,
                  acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

// dQ = scale * the sum of the key tiles' parts, in key-tile order; one
// thread per 2 values
template <typename T>
__global__ void dq_sum(const float* __restrict__ dqp, T* __restrict__ dq,
                       int nkt, int Tq, float scale, int64_t pairs) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int64_t row = i / (kD / 2), bh = row / Tq, r = row % Tq;
  const int c = (int)(i % (kD / 2)) * 2;
  float a = 0.f, b = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const float2 p = *reinterpret_cast<const float2*>(
        dqp + ((bh * nkt + kt) * Tq + r) * kD + c);
    a += p.x;
    b += p.y;
  }
  store2<T>(dq + row * kD + c, a * scale, b * scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const int* klen, const void* dout, const float* lse, void* dq,
           void* dk, void* dv, float* dqp, int B, int H, int Tq, int Tk,
           float scale, int causal, const uint32_t* seed, uint32_t thresh,
           int dropout, HashRows rows, cudaStream_t stream) {
  auto kern = flash_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int nkt = (Tk + kBT - 1) / kBT;
  if (nkt > 1 && !dqp) return (int)cudaErrorInvalidValue;
  kern<<<dim3(B * H, nkt), kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), klen, lse, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), dqp, H, Tq, Tk, scale, causal,
      seed, thresh, dropout, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || nkt == 1) return (int)err;
  const int64_t pairs = (int64_t)B * H * Tq * (kD / 2);
  dq_sum<T><<<(unsigned)cdiv(pairs, 256), 256, 0, stream>>>(
      dqp, static_cast<T*>(dq), nkt, Tq, scale, pairs);
  return (int)cudaGetLastError();
}

}  // namespace

// q/o/dout [B,H,Tq,64], k/v [B,H,Tk,64] contiguous and 16-byte aligned, all of
// one dtype; klen [B] int32 (null: Tk; clamped to Tk here); lse [B,H,Tq]
// float32; dq like q, dk/dv like k; dq_part a float32 scratch of
// [B*H, ceil(Tk / 64), Tq, 64] when Tk > 64, else null; seed the forward's
// uint32 in device memory, read when dropout is on (null otherwise); (b0, h0,
// hg) the dropout hash's rows, as the forward took them.  Launches the
// backward kernel, then (Tk > 64) the fixed-order dQ sum.  Returns the CUDA
// error of the launches (0 = launched).
extern "C" int ptt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* klen,
                                       const void* dout, const void* lse,
                                       void* dq, void* dk, void* dv,
                                       void* dq_part, int B, int H, int Tq,
                                       int Tk, int Dh, float scale, int causal,
                                       const void* seed, unsigned int thresh,
                                       int dropout, int b0, int h0, int hg,
                                       int dtype, int device, void* stream) {
  if (Dh != kD) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dropout && !seed) return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(klen);
  const float* ls = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(dq_part);
  const uint32_t* sd = static_cast<const uint32_t*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HashRows rows = {b0, h0, hg};
  if (dtype == ptt::kFloat32)
    return launch<float>(q, k, v, o, kl, dout, ls, dq, dk, dv, dp, B, H, Tq, Tk,
                         scale, causal, sd, thresh, dropout, rows, st);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, kl, dout, ls, dq, dk, dv, dp, B, H,
                                 Tq, Tk, scale, causal, sd, thresh, dropout,
                                 rows, st);
  return (int)cudaErrorInvalidValue;
}
