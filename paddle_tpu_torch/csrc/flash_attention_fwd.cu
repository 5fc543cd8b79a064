// Kernel #1: flash-attention forward for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (its pallas_call is in _flash_fwd).  Same function: O and the row LSE of
// softmax(scale * Q K^T) V under a per-batch key length klen (clamped to Tk
// here; null = Tk) and an optional causal mask — top-aligned when Tq == Tk,
// suffix (query i at key position klen - Tq + i) when Tq < Tk — plus the
// murmur3 counter-hash dropout of _keep_mask, bit for bit, without
// upscaling.  A fully masked row gives zeros and an LSE of +1e30.  Inputs
// are float32 or bfloat16; every sum is float32.  Rounding follows the JAX
// package's _dot: scale * Q is rounded to the input type, and so are the
// probabilities fed to P V (after dropout); the normaliser l counts dropped
// keys too.
//
// What bounds it on the H100: at D = 64 a (b, h) reads Q, K, V and writes O
// once (the training shape [256,8,64,64]: 134 MB in float32, 0.03-0.04 ms)
// for 4 Tq Tk D flops, so on the tensor cores the bytes bind; a decode step
// (Tq = 1) reads each (b, h)'s K and V up to klen once and does 4 klen D
// flops: bytes again.
//
// Design:
//  - Tensor cores through mma.sync (attention.cuh): S = (scale Q) K^T and
//    P V, float32 as three TF32 passes of a hi/lo split (hi truncated, lo
//    the exact rest: two operations a value), bfloat16 as one
//    m16n8k16 pass.  A block of 4 warps takes 64 queries, a warp 16 rows
//    against each 64-key tile.  P stays in registers: for float32 the
//    accumulator holds keys (2t, 2t + 1) of a row where P V's A fragment
//    wants columns (t, t + 4), so V's rows are stored permuted (load_tile
//    PERM) and no value moves; bfloat16's k16 fragment matches as it is.
//    The masks and the dropout hash take each accumulator element's own
//    (query, key).
//  - Loads: 16-byte cp.async into XOR-swizzled float32 tiles, K/V double
//    buffered over key tiles, so the next tile lands while this one
//    computes (bfloat16 through registers, where Q is scaled and rounded).
//    With one key tile (the training shape) the overlap comes from
//    residency instead: 48 KB and at most 128 registers a block, four
//    blocks an SM.  Keys past the slice's end are never read.
//  - Decode: when the (b*h, query tile) blocks would leave most SMs idle,
//    each (b, h)'s keys up to its last visible key are split over a thread
//    block cluster of up to 8 blocks (whole 64-key tiles a rank, one
//    launch).  Each rank keeps its partial (m, l, O); the partials meet in
//    distributed shared memory and are combined in rank order (the same
//    bits every run): M = max m_r, L = sum l_r e^(m_r - M), O likewise.
//    An empty slice is (-1e30, 0, 0) and adds nothing; a row with no key
//    anywhere gives zeros and +1e30.  No scratch and no second pass.
//  - Decode (Tq = 1) runs its own kernel (flash_decode_kernel): one query
//    row would leave 15 of 16 mma rows empty and one warp of four working,
//    so all 128 threads take the row on the float32 units, from the same
//    tiles and with the same slices and combine.
//  - Query tiles run longest first (causal rows see the most keys last).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"
#include "dtype.cuh"

namespace cg = cooperative_groups;

namespace {

using ptt::from_f;
using ptt::round_to;

constexpr int kThreads = 128;    // 4 warps, 16 query rows each
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kWave = 4 * 132;   // blocks the card holds at once
constexpr float kNegInf = -1e30f;
constexpr float kPosBig = 1e30f;

// ranks a (b*h, query tile) spreads its keys over: doubled while the grid
// stays within a wave of resident blocks and a rank keeps a key tile
int cluster_size(int blocks, int Tk) {
  int c = 1;
  while (c < kMaxCluster && (long)blocks * c * 2 <= kWave && c * 2 * kBT <= Tk)
    c *= 2;
  return c;
}

// keys [ks, ke) of cluster rank `rank`: its share of [0, kend) in whole
// 64-key tiles (empty past kend)
__device__ __forceinline__ void key_slice(int kend, int cluster, int rank,
                                          int& ks, int& ke) {
  const int n = kend > 0 ? kend : 0;
  const int chunk = ((n + cluster - 1) / cluster + kBT - 1) / kBT * kBT;
  ks = min(rank * chunk, n);
  ke = min(ks + chunk, n);
}

// the decode kernel's scratch floats before its stages (2 KB)
constexpr int kScratch = 512;

// Q (or the decode kernel's scratch), then `stages` (K, V) tile pairs
size_t smem_bytes(int stages, bool decode) {
  return sizeof(float) * ((decode ? kScratch : kTile) + 2 * stages * kTile);
}

// the cluster's partials of the tile's first `rows` query rows — each
// rank's m [64], l [64] and unnormalised O (a swizzled [64][64] tile) in
// its shared memory — combined in rank order into O and the LSE; rank r
// takes every cluster-th run of the threads' elements
template <typename T>
__device__ __forceinline__ void combine(const float* sO, const float* sM,
                                        const float* sL, int rows, int rank,
                                        int cluster, T* __restrict__ o,
                                        float* __restrict__ lse) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  for (int e = rank * kThreads + threadIdx.x; e < rows * kD;
       e += cluster * kThreads) {
    const int r = e / kD, c = e % kD;
    float mr[kMaxCluster], M = kNegInf;
#pragma unroll
    for (int x = 0; x < kMaxCluster; ++x)
      if (x < cluster) {
        mr[x] = cl.map_shared_rank(sM, x)[r];
        M = fmaxf(M, mr[x]);
      }
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int x = 0; x < kMaxCluster; ++x)
      if (x < cluster) {
        const float w = expf(mr[x] - M);
        L += cl.map_shared_rank(sL, x)[r] * w;
        O += cl.map_shared_rank(sO, x)[sidx(r, c)] * w;
      }
    const bool valid_row = L > 0.f;
    o[(size_t)r * kD + c] = from_f<T>(O / (valid_row ? L : 1.f));
    if (c == 0) lse[r] = valid_row ? M + logf(fmaxf(L, 1e-37f)) : kPosBig;
  }
  cl.sync();  // no rank leaves while another reads its shared memory
}

// a block's work: its (b, h) and cluster rank, the first query of its
// tile, the clamped key length, and its rank's keys [ks, ke) in nkt
// 64-key tiles
struct Slice {
  int rank, bh, q0, kl, ks, ke, nkt;
};

__device__ __forceinline__ Slice slice_of(const int* __restrict__ klen, int H,
                                          int Tq, int Tk, int causal,
                                          int cluster) {
  Slice w;
  w.rank = blockIdx.x % cluster;
  w.bh = blockIdx.x / cluster;
  w.q0 = (gridDim.y - 1 - blockIdx.y) * kBT;  // the longest rows first
  w.kl = klen ? min(klen[w.bh / H], Tk) : Tk;
  // keys at or past kend are masked for every query of this tile
  int kend = w.kl;
  if (causal) {
    const int last_q = min(w.q0 + kBT, Tq) - 1;
    kend = min(kend, (Tq == Tk ? last_q : last_q + w.kl - Tq) + 1);
  }
  key_slice(kend, cluster, w.rank, w.ks, w.ke);
  w.nkt = (w.ke - w.ks + kBT - 1) / kBT;
  return w;
}

// the slice's K and V tile i into stage i % 2 (two tiles a stage from
// `stages`; V's rows permuted for float32, see load_tile), one cp.async
// group
template <typename T>
__device__ __forceinline__ void load_kv_tiles(float* stages,
                                              const T* __restrict__ k,
                                              const T* __restrict__ v,
                                              const Slice& w, int i) {
  float* sK = stages + 2 * kTile * (i & 1);
  load_tile<T, kThreads>(sK, k, w.ks + i * kBT, w.ke, 1.f);
  load_tile<T, kThreads, true>(sK + kTile, v, w.ks + i * kBT, w.ke, 1.f);
  cp_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ klen,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Tq,
                 int Tk, float scale, int causal,
                 const uint32_t* __restrict__ seed_ptr, uint32_t thresh,
                 int dropout, HashRows rows, int cluster) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // Q (bf16: scale * Q)
  // the dropout seed is device data: a replayed CUDA graph reads this run's
  const uint32_t seed = dropout ? *seed_ptr : 0u;
  const Slice w = slice_of(klen, H, Tq, Tk, causal, cluster);
  const int rank = w.rank, bh = w.bh, q0 = w.q0, kl = w.kl, ks = w.ks,
            ke = w.ke, nkt = w.nkt;
  const uint32_t hrow = hash_row(rows, bh, H);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const size_t qoff = (size_t)bh * Tq * kD, koff = (size_t)bh * Tk * kD;
  // float32 scales Q as a fragment is read; bfloat16 holds scale * Q rounded
  const float qmul = sizeof(T) == 4 ? scale : 1.f;
  const float qround = sizeof(T) == 4 ? 1.f : round_to<T>(scale);
  // a warp computes if any of its 16 rows is a query
  const bool active = q0 + 16 * warp < Tq;
  auto load_kv = [&](int i) {
    load_kv_tiles<T>(sQ + kTile, k + koff, v + koff, w, i);
  };
  if (nkt > 0) {
    load_tile<T, kThreads>(sQ, q + qoff, q0, Tq, qround);
    load_kv(0);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float oacc[1][8][4] = {};  // O of the warp's 16 rows x 64 columns
  for (int i = 0; i < nkt; ++i) {
    if (i + 1 < nkt) {
      load_kv(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* sK = sQ + kTile * (1 + 2 * (i & 1));
      const float* sV = sK + kTile;
      const int k0 = ks + i * kBT;
      // S of the warp's rows against the tile's 64 keys
      float s[1][8][4] = {};
      auto aQ = [&](int r, int c) { return sQ[sidx(16 * warp + r, c)] * qmul; };
      auto bK = [&](int c, int n) { return sK[sidx(n, c)]; };
#pragma unroll
      for (int c = 0; c < kD; c += kStep<T>) mma_step<T, true>(s, aQ, bK, c);

      // masks, online softmax and dropout: the thread holds rows g and
      // g + 8, columns 8 j + 2 t + {0, 1}; a row's four threads are
      // neighbouring lanes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gq = q0 + 16 * warp + g + 8 * h;
        bool ok[8][2];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int gk = k0 + 8 * j + 2 * t + e;
            ok[j][e] = gk < ke && valid_pair(gq, gk, kl, Tq, Tk, causal);
            if (!ok[j][e]) s[0][j][2 * h + e] = kNegInf;
            mx = fmaxf(mx, s[0][j][2 * h + e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float corr = expf(m[h] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = ok[j][e] ? expf(s[0][j][2 * h + e] - m_new) : 0.f;
            psum += p;  // the normaliser counts dropped keys too
            if (dropout && ok[j][e] &&
                !keep(seed, hrow, gq, k0 + 8 * j + 2 * t + e, thresh))
              p = 0.f;
            s[0][j][2 * h + e] = p;
          }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l[h] = l[h] * corr + psum;
        m[h] = m_new;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          oacc[0][j][2 * h] *= corr;
          oacc[0][j][2 * h + 1] *= corr;
        }
      }

      // O += P V, P from registers (rounded to T as the fragment is made)
      auto bV = [&](int c, int n) { return sV[sidx(c, n)]; };
      uint32_t bh_[8][2], bl_[8][2];
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          uint32_t ah[1][4], al[1][4];
          split<true>(s[0][kk][0], ah[0][0], al[0][0]);
          split<true>(s[0][kk][2], ah[0][1], al[0][1]);
          split<true>(s[0][kk][1], ah[0][2], al[0][2]);
          split<true>(s[0][kk][3], ah[0][3], al[0][3]);
          load_b<T, true>(bh_, bl_, bV, 8 * kk);
          mma_frags<T>(oacc, ah, al, bh_, bl_);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a[1][4] = {{pack2(s[0][2 * kk][0], s[0][2 * kk][1]),
                                     pack2(s[0][2 * kk][2], s[0][2 * kk][3]),
                                     pack2(s[0][2 * kk + 1][0], s[0][2 * kk + 1][1]),
                                     pack2(s[0][2 * kk + 1][2], s[0][2 * kk + 1][3])}};
          load_b<T, true>(bh_, bl_, bV, 16 * kk);
          mma_frags<T>(oacc, a, a, bh_, bl_);
        }
      }
    }
    __syncthreads();  // the stage's readers are done before it is refilled
  }

  if (cluster == 1) {
    if (!active) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gq = q0 + 16 * warp + g + 8 * h;
      if (gq >= Tq) continue;
      const bool valid_row = l[h] > 0.f;
      const float den = valid_row ? l[h] : 1.f;
      T* orow = o + qoff + (size_t)gq * kD;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2<T>(orow + 8 * j + 2 * t, oacc[0][j][2 * h] / den,
                  oacc[0][j][2 * h + 1] / den);
      if (t == 0)
        lse[(size_t)bh * Tq + gq] =
            valid_row ? m[h] + logf(fmaxf(l[h], 1e-37f)) : kPosBig;
    }
    return;
  }

  // the cluster's partials: each rank's (m, l, unnormalised O) of the
  // tile's rows in its shared memory, combined in rank order
  float* sO = sQ;              // [64][64], swizzled
  float* sM = sQ + kTile;      // [64]
  float* sL = sM + kBT;        // [64]
  __syncthreads();             // Q is no longer read
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(sO + sidx(r, 8 * j + 2 * t)) =
            make_float2(oacc[0][j][2 * h], oacc[0][j][2 * h + 1]);
      if (t == 0) {
        sM[r] = m[h];
        sL[r] = l[h];
      }
    }
  }
  combine<T>(sO, sM, sL, min(kBT, Tq - q0), rank, cluster,
             o + qoff + (size_t)q0 * kD, lse + (size_t)bh * Tq + q0);
}

// decode (Tq = 1): one query row, which one warp of mma tiles would compute
// alone, 16 rows at a time; here all 128 threads take it on the float32
// units.  S: a pair of threads a key (32 columns each); P V: a thread a
// column and half the tile's keys.  Sums in float32, operands rounded as
// the tile kernel rounds them.  Shared memory: kScratch floats, then the
// K / V stages.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ klen,
                    T* __restrict__ o, float* __restrict__ lse, int H, int Tk,
                    float scale, int causal,
                    const uint32_t* __restrict__ seed_ptr, uint32_t thresh,
                    int dropout, HashRows rows, int cluster) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [64] scale * q
  const uint32_t seed = dropout ? *seed_ptr : 0u;
  float* sP = sq + kD;         // [64] this tile's P (rounded to T)
  float* sRed = sP + kBT;      // [4] the warps' maxima, [4] their sums
  float* sOh = sq + 4 * kD;    // [2][64] the two key halves' O
  float* stages = sq + kScratch;
  const Slice w = slice_of(klen, H, 1, Tk, causal, cluster);
  const int rank = w.rank, bh = w.bh, kl = w.kl, ks = w.ks, ke = w.ke,
            nkt = w.nkt;
  const uint32_t hrow = hash_row(rows, bh, H);
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t qoff = (size_t)bh * kD, koff = (size_t)bh * Tk * kD;
  const float qround = sizeof(T) == 4 ? 1.f : round_to<T>(scale);
  auto load_kv = [&](int i) {
    load_kv_tiles<T>(stages, k + koff, v + koff, w, i);
  };
  if (nkt > 0) load_kv(0);
  if (tid < kD) {
    const float x = ptt::to_f(q[qoff + tid]);
    sq[tid] = sizeof(T) == 4 ? x * scale : round_to<T>(x * qround);
  }
  const int j = tid >> 1, half = tid & 1;   // S: key j, columns 32 half..
  const int d = tid & (kD - 1), kh = tid >> 6;  // P V: column d, keys 32 kh..
  float m1 = kNegInf, l1 = 0.f, o1 = 0.f;
  for (int i = 0; i < nkt; ++i) {
    if (i + 1 < nkt) {
      load_kv(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sK = stages + 2 * kTile * (i & 1);
    const float* sV = sK + kTile;
    const int gk = ks + i * kBT + j;
    float sj = 0.f;
#pragma unroll
    for (int c = 32 * half; c < 32 * half + 32; c += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(sK + sidx(j, c));
      const float4 q4 = *reinterpret_cast<const float4*>(sq + c);
      sj = fmaf(q4.x, k4.x, sj);
      sj = fmaf(q4.y, k4.y, sj);
      sj = fmaf(q4.z, k4.z, sj);
      sj = fmaf(q4.w, k4.w, sj);
    }
    sj += __shfl_xor_sync(0xffffffffu, sj, 1);
    const bool ok = gk < ke && valid_pair(0, gk, kl, 1, Tk, causal);
    float mx = ok ? sj : kNegInf;
#pragma unroll
    for (int off = 2; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if ((tid & 31) == 0) sRed[warp] = mx;
    __syncthreads();
    mx = fmaxf(fmaxf(sRed[0], sRed[1]), fmaxf(sRed[2], sRed[3]));
    const float m_new = fmaxf(m1, mx);
    const float corr = expf(m1 - m_new);
    float p = ok ? expf(sj - m_new) : 0.f;
    float ps = half ? 0.f : p;  // each key once
#pragma unroll
    for (int off = 2; off < 32; off <<= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    if (dropout && ok && !keep(seed, hrow, 0, gk, thresh)) p = 0.f;
    if (half == 0) sP[j] = round_to<T>(p);
    if ((tid & 31) == 0) sRed[4 + warp] = ps;
    __syncthreads();
    // the normaliser counts dropped keys too; the warps' sums in order
    l1 = l1 * corr + (((sRed[4] + sRed[5]) + sRed[6]) + sRed[7]);
    m1 = m_new;
    float pv = 0.f;
#pragma unroll
    for (int r = 32 * kh; r < 32 * kh + 32; ++r) {
      // V's rows are stored permuted for float32 (load_tile PERM)
      const int pr = sizeof(T) == 4
                         ? (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1) : r;
      pv = fmaf(sP[r], sV[sidx(pr, d)], pv);
    }
    o1 = o1 * corr + pv;
    __syncthreads();  // the stage and sP are refilled next
  }
  sOh[tid] = o1;
  __syncthreads();
  const float O = sOh[d] + sOh[kD + d];
  if (cluster == 1) {
    if (tid < kD) {
      const bool valid_row = l1 > 0.f;
      o[qoff + tid] = from_f<T>(O / (valid_row ? l1 : 1.f));
      if (tid == 0)
        lse[bh] = valid_row ? m1 + logf(fmaxf(l1, 1e-37f)) : kPosBig;
    }
    return;
  }
  float* sO = stages;  // the first stage: no longer read
  if (tid < kD) sO[sidx(0, tid)] = O;
  if (tid == 0) {
    sO[kTile] = m1;
    sO[kTile + kBT] = l1;
  }
  combine<T>(sO, sO + kTile, sO + kTile + kBT, 1, rank, cluster, o + qoff,
             lse + bh);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* klen, void* o,
           float* lse, int B, int H, int Tq, int Tk, float scale, int causal,
           const uint32_t* seed, uint32_t thresh, int dropout, HashRows rows,
           cudaStream_t stream) {
  const int nqt = (Tq + kBT - 1) / kBT;
  const int cluster = cluster_size(B * H * nqt, Tk);
  // two stages when a rank's slice can hold more than one key tile
  const int chunk = ((Tk + cluster - 1) / cluster + kBT - 1) / kBT * kBT;
  const bool decode = Tq == 1;
  const size_t smem = smem_bytes(chunk > kBT ? 2 : 1, decode);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * cluster, nqt);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaError_t err;
  if (decode) {
    auto kern = flash_decode_kernel<T>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(2, true));
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, kern, qt, kt, vt, klen, ot, lse, H, Tk,
                               scale, causal, seed, thresh, dropout, rows,
                               cluster);
  } else {
    auto kern = flash_fwd_kernel<T>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(2, false));
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, kern, qt, kt, vt, klen, ot, lse, H, Tq,
                               Tk, scale, causal, seed, thresh, dropout, rows,
                               cluster);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The cluster size a launch of this shape spreads each (b, h)'s keys over
// (1: no split).
extern "C" int ptt_flash_attention_fwd_cluster(int B, int H, int Tq, int Tk) {
  return cluster_size(B * H * ((Tq + kBT - 1) / kBT), Tk);
}

// q [B,H,Tq,D=64], k/v [B,H,Tk,D] contiguous and 16-byte aligned, all of one
// dtype; klen [B] int32 (null: Tk; clamped to Tk here); o like q; lse
// [B,H,Tq] float32; seed one uint32 in device memory, read when dropout is
// on (null otherwise); (b0, h0, hg) the dropout hash's rows (HashRows: a
// shard's batch offset, head offset and global head count; 0, 0, H for a
// whole tensor).  Returns the CUDA error of the launch (0 = launched).
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* klen, void* o, void* lse, int B,
                                       int H, int Tq, int Tk, int D, float scale,
                                       int causal, const void* seed,
                                       unsigned int thresh, int dropout, int b0,
                                       int h0, int hg, int dtype, int device,
                                       void* stream) {
  // head dim 64 only: the Transformer-base decoder's d_model 512 / 8 heads
  if (D != kD) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dropout && !seed) return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(klen);
  float* ls = static_cast<float*>(lse);
  const uint32_t* sd = static_cast<const uint32_t*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HashRows rows = {b0, h0, hg};
  if (dtype == ptt::kFloat32)
    return launch<float>(q, k, v, kl, o, ls, B, H, Tq, Tk, scale, causal, sd,
                         thresh, dropout, rows, st);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, kl, o, ls, B, H, Tq, Tk, scale,
                                 causal, sd, thresh, dropout, rows, st);
  return (int)cudaErrorInvalidValue;
}
