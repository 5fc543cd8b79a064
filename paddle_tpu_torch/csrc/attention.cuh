// What the flash-attention kernels share (flash_attention_fwd.cu, #1, and
// flash_attention_bwd.cu, #2): the JAX package's masks and dropout hash, the
// XOR-swizzled 64 x 64 float32 tiles, the TF32 / bfloat16 mma.sync products
// read from them, and the tile loads.
//
// Products: float32 as three TF32 passes of a hi/lo split of each operand
// (hi = tf32(v), lo = tf32(v - hi); lo*hi + hi*lo + hi*hi, lo*lo dropped),
// bfloat16 as one m16n8k16 pass (the mma.sync wrappers are wgmma.cuh's).
// Fragments are read from float32 tiles in shared memory, so a product
// takes an operand transposed or not by its index order alone.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBT = 64;  // queries or keys per tile
constexpr int kD = 64;   // head dim (the only one the port builds)
constexpr int kTile = kBT * kD;

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

// the klen and causal masks of one (query, key) pair: causal is top-aligned
// when Tq == Tk, suffix-aligned (query i at key klen - Tq + i) otherwise
__device__ __forceinline__ bool valid_pair(int gq, int gk, int kl, int Tq, int Tk,
                                           int causal) {
  bool ok = gk < kl;
  if (causal) ok = ok && (Tq == Tk ? gq >= gk : gq + kl - Tq >= gk);
  return ok;
}

// float index of (row r, column c) in a swizzled 64 x 64 tile: columns XOR
// bits 2-4 of the row, so 8 rows x 4 columns and 4 rows x 8 columns both
// fall in 32 banks; 4-column groups stay whole (16-byte stores)
__device__ __forceinline__ int sidx(int r, int c) {
  return r * kD + (c ^ (((r & 3) << 3) | (r & 4)));
}

// x as hi + lo TF32 parts.  FAST (#1) truncates hi (one AND) and leaves lo
// = x - hi, exact in float32, for the tensor core, which reads only a
// .tf32 operand's top 19 bits: |x - hi - lo| <= 2^-21 |x|, against ~2^-22
// for the rounded split (#2) and its five operations
template <bool FAST = false>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (FAST) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  }
}

// the contraction a step of mma takes: k8 in TF32, k16 in bf16
template <typename T>
constexpr int kStep = sizeof(T) == 4 ? 8 : 16;

// B fragments of one k step for NJ column tiles: B(k', 8 j + n) for k' in
// [k, k + kStep); float32 as hi and lo TF32, bfloat16 as pairs along k (lo
// unused)
template <typename T, bool FAST = false, int NJ, class FB>
__device__ __forceinline__ void load_b(uint32_t (&bh)[NJ][2],
                                       uint32_t (&bl)[NJ][2], FB B, int k) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if constexpr (sizeof(T) == 4) {
      split<FAST>(B(k + t, 8 * j + g), bh[j][0], bl[j][0]);
      split<FAST>(B(k + t + 4, 8 * j + g), bh[j][1], bl[j][1]);
    } else {
      const int k0 = k + 2 * t, k1 = k0 + 8, n = 8 * j + g;
      bh[j][0] = pack2(B(k0, n), B(k0 + 1, n));
      bh[j][1] = pack2(B(k1, n), B(k1 + 1, n));
    }
  }
}

// acc[i][j] += A_i B_j over one k step, from fragments: float32 the three
// passes pass by pass over the tiles, so that no two consecutive products
// add into one accumulator; bfloat16 one pass
template <typename T, int MT, int NJ>
__device__ __forceinline__ void mma_frags(float (&acc)[MT][NJ][4],
                                          const uint32_t (&ah)[MT][4],
                                          const uint32_t (&al)[MT][4],
                                          const uint32_t (&bh)[NJ][2],
                                          const uint32_t (&bl)[NJ][2]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], ah[i], bh[j]);
  }
}

// one k step of a product: acc[i][j] += sum over k' in [k, k + kStep) of
// A(16 i + m, k') B(k', 8 j + n), the warp's (16 MT) x (8 NJ) block, A(m, k)
// and B(k, n) reading shared memory.  The accumulator layout is mma's:
// acc[i][j][e] is row 16 i + g + 8 (e / 2), column 8 j + 2 t + e % 2 (g =
// lane / 4, t = lane % 4).
template <typename T, bool FAST = false, int MT, int NJ, class FA, class FB>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NJ][4], FA A, FB B,
                                         int k) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  if constexpr (sizeof(T) == 4) {
    uint32_t ah[MT][4], al[MT][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      split<FAST>(A(16 * i + g, k + t), ah[i][0], al[i][0]);
      split<FAST>(A(16 * i + g + 8, k + t), ah[i][1], al[i][1]);
      split<FAST>(A(16 * i + g, k + t + 4), ah[i][2], al[i][2]);
      split<FAST>(A(16 * i + g + 8, k + t + 4), ah[i][3], al[i][3]);
    }
    load_b<T, FAST>(bh, bl, B, k);
    mma_frags<T>(acc, ah, al, bh, bl);
  } else {
    // each column tile's B fragment made just before its products: fewer
    // live registers than load_b's NJ at once
    const int k0 = k + 2 * t, k1 = k0 + 8;
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = 16 * i + g;
      a[i][0] = pack2(A(m, k0), A(m, k0 + 1));
      a[i][1] = pack2(A(m + 8, k0), A(m + 8, k0 + 1));
      a[i][2] = pack2(A(m, k1), A(m, k1 + 1));
      a[i][3] = pack2(A(m + 8, k1), A(m + 8, k1 + 1));
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = 8 * j + g;
      const uint32_t b[2] = {pack2(B(k0, n), B(k0 + 1, n)),
                             pack2(B(k1, n), B(k1 + 1, n))};
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b);
    }
  }
}

// rows [r0, r0 + 64) of a [rows, 64] matrix into a swizzled tile by NTHR
// threads; rows past `rows` are 0.  float32 by 16-byte cp.async (the caller
// commits and waits); bfloat16 through registers, times `mul` and rounded
// (mul = 1: as it is).  PERM stores row r of each 8-row group at 4 (r % 2) +
// r / 2 (float32 only): the rows (2t, 2t + 1) that a product's accumulator
// fragment holds as columns arrive where a B fragment reads rows (t, t + 4).
template <typename T, int NTHR, bool PERM = false>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int rows, float mul) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = threadIdx.x; i < kTile / 4; i += NTHR) {
      const int r = i >> 4, c = (i & 15) * 4, gr = r0 + r;
      const bool in = gr < rows;
      const int pr = PERM ? (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1) : r;
      cp_async16(smem_u32(dst + sidx(pr, c)), src + (size_t)(in ? gr : 0) * kD + c,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = threadIdx.x; i < kTile / 8; i += NTHR) {
      const int r = i >> 3, c = (i & 7) * 8, gr = r0 + r;
      float f[8] = {};
      if (gr < rows) {
        unpack(*reinterpret_cast<const uint4*>(src + (size_t)gr * kD + c), f);
        if (mul != 1.f)
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = ptt::round_to<T>(f[e] * mul);
      }
      *reinterpret_cast<float4*>(dst + sidx(r, c)) =
          make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(dst + sidx(r, c + 4)) =
          make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// two adjacent outputs of a row
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}

}  // namespace
