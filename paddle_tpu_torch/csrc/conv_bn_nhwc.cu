// Kernels #10 and #11: the fused BN-apply -> 1x1 conv -> batch-stats layer
// of ResNet's bottleneck in NHWC, forward and backward, on Hopper's tensor
// cores (sm_90a), in CUDA C++.  The PTX wrappers, swizzle, packing,
// accumulator staging and sum_rows are wgmma.cuh's, shared with conv_bn.cu
// (#8/#9).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/conv_bn.py:
//   #10 _fwd_call_nhwc  (pallas_call body _fwd_kernel_nhwc)   x [M, C]
//   #11 _bwd_call_nhwc  (_bwd_kernel_nhwc)
// The function, per position m and output channel o, with the producer's
// batch mean/rstd and the BN's gamma/beta over the input channels c:
//   xn[m, c] = act(((x - mean) * rstd) * gamma + beta)   (apply_bn)
//            = act(x[m, c])                                (raw input)
//   z[m, o]  = sum_c xn[m, c] W[o, c],  W read [O, C] through its strides
//   sum[o]   = sum_m (z - shift[o]),  sumsq[o] = sum_m (z - shift[o])^2
// with xn rounded to x's type before the product, every sum in float32,
// and z written in x's type.  The backward folds the stats' cotangents
// into dz (dz + dsum + 2 (z - shift) dsumsq, rounded to x's type, skipped
// without them), recomputes xn and returns dx (x's type), dW [O, C],
// dgamma and dbeta (float32).
//
// What bounds it on the H100: operations.  ResNet-50's fused layers are
// 2 M C O = 13.15 GFLOP at batch 128 against 0.02-0.05 ms of bytes.  The
// float32 units (67 TFLOP/s) leave the tensor cores' TF32 (495 TFLOP/s) as
// the only faster route, and TF32 keeps 10 of float32's 23 mantissa bits.
// So a float32 product is three TF32 products of a split of each operand,
// hi = tf32(v) (cvt.rna), lo = tf32(v - hi), summed small terms first:
//   acc += A_lo B_hi + A_hi B_lo + A_hi B_hi
// which leaves ~3 * 2^-22 of each product (the dropped lo lo term and the
// roundings), at a third of the TF32 rate: 3 * operations / 495 TFLOP/s.
// bfloat16 operands take one pass at the bf16 rate.
//
// Design.  Three GEMMs; the tile's rows are positions or output channels
// and its columns channels, so an accumulator row is a run of neighbouring
// channels of one position:
//   forward  z[M, O]   = xn[M, C] W[O, C]^T    grid (O tiles, M tiles)
//   dx       dxn[M, C] = dz'[M, O] W[O, C]     grid (C tiles, M tiles)
//   dW       dW[O, C]  = dz'^T xn over a chunk of the positions
//                                              grid (C tiles, O tiles, chunks)
//  - 128 x 128 tiles, 512 threads in four warpgroups of 64 x 64 each, the
//    contraction in k tiles of 128 bytes (32 float32 or 64 bfloat16), one
//    block an SM (the staging below fills the shared memory; sixteen warps
//    hide the transform's latencies).
//  - Raw k tiles of x, z, dz and W arrive by 16-byte cp.async, zero-filled
//    past the edge, into a ring of three stages (two in the float32
//    backward, which stages three operands), laid out as in device memory
//    (k-contiguous or row-contiguous), two or one tiles ahead of their use.
//  - A transform step reads a raw tile from shared memory, applies the
//    prologue (BN-apply + ReLU, rounded to x's type) or the stats fold,
//    zeroes rows and k past the edge (relu(norm(0)) is not 0), splits
//    float32 into hi/lo TF32, and writes the K-major, 128-byte-swizzled
//    tiles the wgmma descriptors point at.  TF32 wgmma takes only K-major
//    operands, so the transposes that W (forward), dz' and xn (dW) need are
//    made in this step, never by a pass over device memory.
//  - wgmma.mma_async m64n64 (three k8 TF32 passes, or one k16 bf16) reads
//    both operands from shared memory into float32 registers; the transform
//    of tile t + 1 runs while the wgmmas of tile t are in flight (the
//    swizzled tiles are double-buffered).
//  - Epilogues stage the accumulator in shared memory and walk it along the
//    channel axis: z and dx leave as 16-byte stores, x is read the same way
//    for the BN backward.  Per-tile column sums (the stats; dgamma/dbeta)
//    go to a [2, M tiles, width] scratch and the dW chunks to [chunks, O,
//    C], each added by a fixed-order second pass (sum_rows): no atomics, two
//    launches give the same bits.
//  - Any shape: ragged M, C and O, and a row stride that is not a multiple
//    of 16 bytes (then the raw tiles are filled by plain loads).

#include "wgmma.cuh"

namespace {

using ptt::from_f;
using ptt::round_to;
using ptt::to_f;

constexpr int RED_ROWS = 32;  // most rows a column-sum pass takes

template <typename T>
struct Tile : Elem<T> {
  using Elem<T>::BK;
  static constexpr int OP_BYTES = 2 * Elem<T>::OP_BYTES;  // A and B
  static constexpr int PRM_BYTES = 4 * BK * (int)sizeof(float);
  __host__ __device__ static constexpr int stage_bytes(int nraw) {
    return nraw * TILE_BYTES + PRM_BYTES;
  }
  // swizzled tiles (double-buffered), a raw ring of ns stages, and 1 KB to
  // align
  __host__ __device__ static constexpr int smem_bytes(int nraw, int ns) {
    return 1024 + 2 * OP_BYTES + ns * stage_bytes(nraw);
  }
  // three raw stages where they fit in a block's 227 KB (all but the
  // float32 backward), else two
  __host__ __device__ static constexpr int stages(int nraw) {
    return smem_bytes(nraw, 3) <= SMEM_MAX ? 3 : 2;
  }
};
// the epilogue's staged accumulator and column sums fit in what the
// smallest configuration allocates
static_assert((BM * LDS + 2 * RED_ROWS * BN) * 4 + 1024 <=
                  Tile<__nv_bfloat16>::smem_bytes(2, 2),
              "epilogue staging exceeds the shared memory");

enum Kind { kPlain = 0, kXn = 1, kDz = 2 };

// One operand of a product: element (row, k) at p[row * srow + k * sk] of
// x's type.  Rows from `rows` on, and k past the contraction's end (the
// main loop's), are zero.  kc: the raw
// tile keeps k contiguous ([row][k]); else rows contiguous ([k][row]).
// vec: 16-byte copies (p, and z, 16-byte aligned, the contiguous stride 1
// and the other a multiple of 16 bytes).  kXn: v = mean, rstd, gamma,
// beta, on = apply_bn; kDz: v = dsum, dsumsq, shift and on = the fold
// (z read, addressed as p).  Per-channel vectors are indexed by k when kc,
// by row otherwise.
struct Src {
  const void* p;
  const void* z;
  int64_t srow, sk;
  int64_t rows;
  int kc, vec, on, relu;
  const float* v[4];
};

// one k tile of the product on swizzled buffer `op`: A (hi, lo) then B (hi,
// lo); warpgroup g takes A's rows 64 (g % 2) .. + 63 and B's 64 (g / 2) ..
template <typename T>
__device__ __forceinline__ void mma(const uint8_t* op, float (&d)[32]) {
  const uint32_t base = smem_u32(op);
  mma_tiles<T>(base, base + Elem<T>::OP_BYTES, d);
}

// ---------------------------------------------------------------------------
// staging: raw tiles, the transform, the main loop
// ---------------------------------------------------------------------------

// the raw k tile [k0, k0 + BK) of rows [row0, row0 + 128) of `src`
// (addressed as s), 16-byte chunk q at byte q * 16 in either layout
template <typename T>
__device__ __forceinline__ void load_raw(const Src& s, const void* src,
                                         uint8_t* raw, int64_t row0,
                                         int64_t k0, int64_t ke) {
  constexpr int EPC = Tile<T>::EPC;
  const T* p = static_cast<const T*>(src);
  const uint32_t dst = smem_u32(raw);
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int q = threadIdx.x + i * NT;
    int64_t row, k;
    if (s.kc) {
      row = row0 + (q >> 3);
      k = k0 + (q & 7) * EPC;
    } else {
      row = row0 + (q % (BM / EPC)) * EPC;
      k = k0 + q / (BM / EPC);
    }
    if (s.vec) {
      const int64_t left = s.kc ? ke - k : s.rows - row;
      const bool in = s.kc ? row < s.rows : k < ke;
      const int n = (in && left > 0) ? (int)(left < EPC ? left : EPC) : 0;
      cp_async16(dst + q * 16, n ? p + row * s.srow + k * s.sk : p,
                 n * (int)sizeof(T));
    } else {
      float v[EPC];
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const int64_t r = s.kc ? row : row + e, kk = s.kc ? k + e : k;
        v[e] = (r < s.rows && kk < ke) ? to_f(p[r * s.srow + kk * s.sk]) : 0.f;
      }
      *reinterpret_cast<uint4*>(raw + q * 16) = pack(v);
    }
  }
}

// the k tile's per-channel vectors (k-indexed operands), [vector][BK], by
// 4-byte cp.async (zero past the end)
template <typename T, int KIND>
__device__ __forceinline__ void load_prm(const Src& s, float* prm,
                                         int64_t k0, int64_t ke) {
  constexpr int BK = Tile<T>::BK;
  if (threadIdx.x >= BK) return;
  const int64_t k = k0 + threadIdx.x;
  const uint32_t dst = smem_u32(prm + threadIdx.x);
#pragma unroll
  for (int i = 0; i < (KIND == kXn ? 4 : 3); ++i)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     dst + i * BK * 4),
                 "l"(k < ke ? s.v[i] + k : s.v[i]), "r"(k < ke ? 4 : 0)
                 : "memory");
}

// the row's per-channel vectors (row-indexed operands)
template <int KIND>
__device__ __forceinline__ void row_prm(const Src& s, int64_t row,
                                        float (&rp)[4]) {
  if constexpr (KIND != kPlain) {
    if (!s.kc && s.on && row < s.rows)
#pragma unroll
      for (int i = 0; i < (KIND == kXn ? 4 : 3); ++i) rp[i] = s.v[i][row];
  }
}

// chunk j (EPC consecutive k) of tile row r, as float
template <typename T>
__device__ __forceinline__ void read_chunk(int kc, const uint8_t* raw, int r,
                                           int j, float (&v)[Tile<T>::EPC]) {
  constexpr int EPC = Tile<T>::EPC;
  if (kc) {
    unpack(*reinterpret_cast<const uint4*>(raw + r * ROW_BYTES + j * 16), v);
  } else {
    const T* t = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int e = 0; e < EPC; ++e) v[e] = to_f(t[(j * EPC + e) * BM + r]);
  }
}

// raw tile -> the swizzled K-major operand tile(s), with the operand's
// prologue or fold and the edge zeroed
template <typename T, int KIND>
__device__ __forceinline__ void transform(const Src& s, const uint8_t* raw,
                                          const uint8_t* rawz,
                                          const float* prm,
                                          const float (&rp)[4], uint8_t* hi,
                                          uint8_t* lo, int64_t row0,
                                          int64_t k0, int64_t ke) {
  constexpr int EPC = Tile<T>::EPC, BK = Tile<T>::BK;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    int r, j;
    if (s.kc) {  // 8 threads a row: 16-byte reads and writes
      r = (threadIdx.x >> 3) + (NT / 8) * i;
      j = threadIdx.x & 7;
    } else {  // a thread a row: reads along the contiguous rows
      r = threadIdx.x & (BM - 1);
      j = (threadIdx.x >> 7) + (NT / BM) * i;
    }
    float v[EPC], zv[EPC], pm[4][EPC];
    read_chunk<T>(s.kc, raw, r, j, v);
    if (KIND == kDz && s.on) read_chunk<T>(s.kc, rawz, r, j, zv);
    if constexpr (KIND != kPlain) {  // the chunk's channel vectors
#pragma unroll
      for (int p = 0; p < (KIND == kXn ? 4 : 3); ++p)
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 f =
              s.kc ? *reinterpret_cast<const float4*>(prm + p * BK + j * EPC + e)
                   : make_float4(rp[p], rp[p], rp[p], rp[p]);
          pm[p][e] = f.x;
          pm[p][e + 1] = f.y;
          pm[p][e + 2] = f.z;
          pm[p][e + 3] = f.w;
        }
    }
    // elements of the chunk inside the edge: all, or the first nk
    const int64_t kleft = ke - (k0 + j * EPC);
    const int nk = row0 + r >= s.rows ? 0 : kleft >= EPC ? EPC
                                           : kleft > 0 ? (int)kleft : 0;
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      float out = v[e];
      if constexpr (KIND == kXn)
        out = round_to<T>(bn_act(out, pm[0][e], pm[1][e], pm[2][e], pm[3][e],
                                 s.on, s.relu));
      else if constexpr (KIND == kDz)
        if (s.on)
          out = round_to<T>(fold(out, zv[e], pm[0][e], pm[1][e], pm[2][e]));
      v[e] = e < nk ? out : 0.f;
    }
    write_chunk<T>(v, hi, lo, r, j);
  }
}

// acc (this thread's part of the 128 x 128 tile) = sum over k in [kb, ke)
// of A(a0 + row, k) B(b0 + col, k).  Shared memory from sm: the swizzled
// operands [2][A hi, A lo, B hi, B lo] (bf16: [2][A, B]), then the raw ring
// [NS][A, B, A's z][vectors].  Tile t: raw stage t % NS, swizzled buffer
// t % 2.  Every step commits one cp.async group (empty past the end), so
// waiting for all but the newest NS - 1 groups waits for the tile to
// transform next.
template <typename T, int KA, int KB, int NS>
__device__ __forceinline__ void mainloop(const Src& a, const Src& b,
                                         int64_t a0, int64_t b0, int64_t kb,
                                         int64_t ke, int nraw, uint8_t* sm,
                                         float (&acc)[32]) {
  constexpr int BK = Tile<T>::BK, OPB = Tile<T>::OP_BYTES;
  constexpr int B_OFF = (Tile<T>::SPLIT ? 2 : 1) * TILE_BYTES;
  const int sb = Tile<T>::stage_bytes(nraw);
  uint8_t* raw = sm + 2 * OPB;
  const bool az = KA == kDz && a.on;
  const bool ak = KA != kPlain && a.kc && a.on;
  float ra[4] = {0.f, 1.f, 1.f, 0.f}, rb[4] = {0.f, 1.f, 1.f, 0.f};
  row_prm<KA>(a, a0 + (threadIdx.x & (BM - 1)), ra);
  row_prm<KB>(b, b0 + (threadIdx.x & (BM - 1)), rb);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int nt = ke > kb ? (int)((ke - kb + BK - 1) / BK) : 0;
  if (nt == 0) return;

  auto issue = [&](int t) {
    if (t < nt) {
      uint8_t* st = raw + (t % NS) * sb;
      const int64_t k0 = kb + (int64_t)t * BK;
      load_raw<T>(a, a.p, st, a0, k0, ke);
      load_raw<T>(b, b.p, st + TILE_BYTES, b0, k0, ke);
      if (az) load_raw<T>(a, a.z, st + 2 * TILE_BYTES, a0, k0, ke);
      if (ak)
        load_prm<T, KA>(a, reinterpret_cast<float*>(st + nraw * TILE_BYTES),
                        k0, ke);
    }
    cp_commit();
  };
  auto xform = [&](int t) {
    const uint8_t* st = raw + (t % NS) * sb;
    uint8_t* op = sm + (t & 1) * OPB;
    const int64_t k0 = kb + (int64_t)t * BK;
    const float* prm = reinterpret_cast<const float*>(st + nraw * TILE_BYTES);
    transform<T, KA>(a, st, st + 2 * TILE_BYTES, prm, ra, op, op + TILE_BYTES,
                     a0, k0, ke);
    transform<T, KB>(b, st + TILE_BYTES, nullptr, nullptr, rb, op + B_OFF,
                     op + B_OFF + TILE_BYTES, b0, k0, ke);
  };

#pragma unroll
  for (int t = 0; t < NS; ++t) issue(t);
  cp_wait<NS - 1>();
  __syncthreads();
  xform(0);
  fence_async_smem();
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    fence_acc(acc);
    wg_fence();
    mma<T>(sm + (t & 1) * OPB, acc);
    wg_commit();
    issue(t + NS);  // into the stage tile t left
    if (t + 1 < nt) {  // stage tile t + 1 while the wgmmas run
      cp_wait<NS - 1>();
      __syncthreads();
      xform(t + 1);
    }
    wg_wait_all();
    fence_acc(acc);
    fence_async_smem();
    __syncthreads();
  }
}

// per-column sums of two quantities (EPC columns a thread, rows r0 + q
// RPP) into part[tile, col] and part[tiles + tile, col], added over the
// rows in a fixed order
template <int EPC, int RPP>
__device__ __forceinline__ void column_sums(float* red, const float (&s0)[EPC],
                                            const float (&s1)[EPC], int cc,
                                            int r0, int64_t col0,
                                            int64_t width, int tile,
                                            int tiles, float* part) {
  static_assert(RPP <= RED_ROWS, "column_sums: too many rows");
#pragma unroll
  for (int e = 0; e < EPC; ++e) {
    red[r0 * BN + cc * EPC + e] = s0[e];
    red[(RPP + r0) * BN + cc * EPC + e] = s1[e];
  }
  __syncthreads();
  const int64_t col = col0 + threadIdx.x;
  if (threadIdx.x < BN && col < width) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int q = 0; q < RPP; ++q) {
      a += red[q * BN + threadIdx.x];
      b += red[(RPP + q) * BN + threadIdx.x];
    }
    part[(int64_t)tile * width + col] = a;
    part[((int64_t)tiles + tile) * width + col] = b;
  }
}

// EPC values of one row from `p` (16 bytes when `full`, else those < n)
template <typename T, int EPC>
__device__ __forceinline__ void load_row(const T* p, bool full, int n,
                                         float (&v)[EPC]) {
  if (full) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  } else {
#pragma unroll
    for (int e = 0; e < EPC; ++e) v[e] = e < n ? to_f(p[e]) : 0.f;
  }
}

template <typename T, int EPC>
__device__ __forceinline__ void store_row(T* p, bool full, int n,
                                          const float (&v)[EPC]) {
  if (full) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  } else {
#pragma unroll
    for (int e = 0; e < EPC; ++e)
      if (e < n) p[e] = from_f<T>(v[e]);
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// forward: a = x [M, C] (the prologue), b = W as [O, C]; grid (O tiles, M
// tiles: the O tiles of a row of x run together and share it in L2).  z [M, O]; with_stats: part [2, M tiles, O].  vec: 16-byte z rows.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
fwd_kernel(Src a, Src b, const float* __restrict__ shift, T* __restrict__ z,
           float* __restrict__ part, int64_t M, int C, int O, int with_stats,
           int vec) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int o0 = blockIdx.x * BN;
  float acc[32];
  mainloop<T, kXn, kPlain, Tile<T>::stages(2)>(a, b, m0, o0, 0, C, 2, sm, acc);
  float* S = stage_acc(acc, sm);

  constexpr int EPC = Tile<T>::EPC, CPR = BN / EPC, RPP = NT / CPR;
  const int cc = threadIdx.x % CPR, r0 = threadIdx.x / CPR;
  const int oc = o0 + cc * EPC, n = O - oc;  // this thread's columns
  const bool full = vec && n >= EPC;
  float sh[EPC], s[EPC], ss[EPC];
#pragma unroll
  for (int e = 0; e < EPC; ++e) {
    sh[e] = (with_stats && e < n) ? shift[oc + e] : 0.f;
    s[e] = ss[e] = 0.f;
  }
  for (int r = r0; r < BM; r += RPP) {
    const int64_t m = m0 + r;
    if (m >= M || n <= 0) break;
    float v[EPC];
    load_staged<EPC>(S + r * LDS + cc * EPC, v);
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      if (e < n) {
        const float d = v[e] - sh[e];
        s[e] += d;
        ss[e] = fmaf(d, d, ss[e]);
      }
    }
    store_row<T, EPC>(z + m * O + oc, full, n, v);
  }
  if (with_stats)
    column_sums<EPC, RPP>(S + BM * LDS, s, ss, cc, r0, o0, O, blockIdx.y,
                          gridDim.y, part);
}

// backward (a): dx; a = dz' [M, O] (the fold), b = W as [C, O]; grid (C
// tiles, M tiles).  dx [M, C]; apply_bn: part [2, M tiles, C] (dgamma,
// dbeta).  vec: 16-byte x and dx rows.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
dx_kernel(Src a, Src b, const T* __restrict__ x, Bn bn, T* __restrict__ dx,
          float* __restrict__ part, int64_t M, int C, int O, int vec) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  float acc[32];
  mainloop<T, kDz, kPlain, Tile<T>::stages(3)>(a, b, m0, c0, 0, O, 3, sm,
                                               acc);
  float* S = stage_acc(acc, sm);

  constexpr int EPC = Tile<T>::EPC, CPR = BN / EPC, RPP = NT / CPR;
  const int cc = threadIdx.x % CPR, r0 = threadIdx.x / CPR;
  const int cb = c0 + cc * EPC, n = C - cb;
  const bool full = vec && n >= EPC;
  float mu[EPC], rs[EPC], g[EPC], be[EPC], sg[EPC], sb[EPC];
#pragma unroll
  for (int e = 0; e < EPC; ++e) {
    const bool on = bn.apply && e < n;
    mu[e] = on ? bn.mean[cb + e] : 0.f;
    rs[e] = on ? bn.rstd[cb + e] : 1.f;
    g[e] = on ? bn.gamma[cb + e] : 1.f;
    be[e] = on ? bn.beta[cb + e] : 0.f;
    sg[e] = sb[e] = 0.f;
  }
  for (int r = r0; r < BM; r += RPP) {
    const int64_t m = m0 + r;
    if (m >= M || n <= 0) break;
    float xv[EPC], dv[EPC], out[EPC];
    load_row<T, EPC>(x + m * C + cb, full, n, xv);
    load_staged<EPC>(S + r * LDS + cc * EPC, dv);
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const float d = dv[e];
      if (bn.apply) {
        const float pre = (xv[e] - mu[e]) * rs[e];
        const float ylin = pre * g[e] + be[e];
        const float dyl = (bn.relu && !(ylin > 0.f)) ? 0.f : d;
        if (e < n) {
          sg[e] = fmaf(dyl, pre, sg[e]);
          sb[e] += dyl;
        }
        out[e] = dyl * (g[e] * rs[e]);
      } else {
        out[e] = (bn.relu && !(xv[e] > 0.f)) ? 0.f : d;
      }
    }
    store_row<T, EPC>(dx + m * C + cb, full, n, out);
  }
  if (bn.apply)
    column_sums<EPC, RPP>(S + BM * LDS, sg, sb, cc, r0, c0, C, blockIdx.y,
                          gridDim.y, part);
}

// backward (b): dW over the positions [z chunk, (z + 1) chunk); a = dz'^T
// (rows o, k m; the fold), b = xn^T (rows c, k m; the prologue); grid (C
// tiles, O tiles, chunks).  Chunk z writes out[z] (float32 [O, C]).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
dw_kernel(const Src a, const Src b, float* __restrict__ out, int O, int C,
          int64_t chunk, int64_t M) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int c0 = blockIdx.x * BN;
  const int o0 = blockIdx.y * BM;
  const int64_t kb = (int64_t)blockIdx.z * chunk;
  const int64_t ke = kb + chunk < M ? kb + chunk : M;
  float acc[32];
  mainloop<T, kDz, kXn, Tile<T>::stages(3)>(a, b, o0, c0, kb, ke, 3, sm, acc);
  float* S = stage_acc(acc, sm);

  // float32 out: 32 threads a row of 128 columns, 4 each
  const int cc = threadIdx.x & 31, r0 = threadIdx.x >> 5;
  const int cb = c0 + cc * 4, n = C - cb;
  const bool full = (C & 3) == 0 && n >= 4;
  float* oz = out + (int64_t)blockIdx.z * O * C;
  for (int r = r0; r < BM; r += NT / 32) {
    const int o = o0 + r;
    if (o >= O || n <= 0) break;
    float v[4];
    load_staged<4>(S + r * LDS + cc * 4, v);
    store_row<float, 4>(oz + (int64_t)o * C + cb, full, n, v);
  }
}

// an activation [rows, width] of x's type as the operand (row, k): kc
// reads it as (row = position, k = channel), else as (row = channel, k =
// position)
template <typename T>
Src act_src(const void* p, const void* z, int64_t positions, int64_t width,
            bool kc, bool z_read) {
  Src s{};
  s.p = p;
  s.z = z;
  s.kc = kc;
  s.srow = kc ? width : 1;
  s.sk = kc ? 1 : width;
  s.rows = kc ? positions : width;
  s.vec = aligned16(p) && (!z_read || aligned16(z)) &&
          (width * (int64_t)sizeof(T)) % 16 == 0;
  return s;
}

// W as the operand (row, k) at w[row * srow + k * sk]: whichever axis is
// contiguous stays contiguous in the raw tile
template <typename T>
Src w_src(const void* w, int64_t srow, int64_t sk, int64_t rows) {
  Src s{};
  s.p = w;
  s.srow = srow;
  s.sk = sk;
  s.rows = rows;
  s.kc = sk == 1 || srow != 1;
  const bool unit = s.kc ? sk == 1 : srow == 1;
  s.vec = aligned16(w) && unit &&
          ((s.kc ? srow : sk) * (int64_t)sizeof(T)) % 16 == 0;
  return s;
}

template <typename T, typename... P, typename... A>
cudaError_t launch(void (*kern)(P...), dim3 grid, int nraw, cudaStream_t st,
                   A... args) {
  const int bytes = Tile<T>::smem_bytes(nraw, Tile<T>::stages(nraw));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, bytes, st>>>(args...);
  return cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const void* w, int64_t swo, int64_t swc, Bn bn,
        const float* shift, void* z, float* part, float* stats, int64_t N,
        int C, int O, int with_stats, cudaStream_t st) {
  Src a = act_src<T>(x, nullptr, N, C, true, false);
  a.on = bn.apply;
  a.relu = bn.relu;
  a.v[0] = bn.mean;
  a.v[1] = bn.rstd;
  a.v[2] = bn.gamma;
  a.v[3] = bn.beta;
  const Src b = w_src<T>(w, swo, swc, O);
  const dim3 grid((unsigned)cdiv(O, BN), (unsigned)cdiv(N, BM));
  const int vec = aligned16(z) && (O * (int64_t)sizeof(T)) % 16 == 0;
  cudaError_t err = launch<T>(fwd_kernel<T>, grid, 2, st, a, b, shift,
                              static_cast<T*>(z), part, N, C, O, with_stats,
                              vec);
  if (err != cudaSuccess || !with_stats) return (int)err;
  sum_rows<<<dim3((unsigned)cdiv(O, 32), 2), RT, 0, st>>>(part, grid.y, O, stats);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* w, int64_t swo, int64_t swc, const void* z,
        const void* dz, const float* const fold_v[3], int fold_on, Bn bn,
        void* dx, float* dw, float* dw_part, float* g_part, float* dgb,
        int64_t N, int C, int O, int splits, int64_t chunk, cudaStream_t st) {
  // dx = dz' W: a = dz' (position, output channel), b = W (c, o)
  Src dzm = act_src<T>(dz, z, N, O, true, fold_on);
  dzm.on = fold_on;
  for (int i = 0; i < 3; ++i) dzm.v[i] = fold_v[i];
  const Src wt = w_src<T>(w, swc, swo, C);
  const dim3 gx((unsigned)cdiv(C, BN), (unsigned)cdiv(N, BM));
  const int vec = aligned16(x) && aligned16(dx) &&
                  (C * (int64_t)sizeof(T)) % 16 == 0;
  cudaError_t err = launch<T>(dx_kernel<T>, gx, 3, st, dzm, wt,
                              static_cast<const T*>(x), bn, static_cast<T*>(dx),
                              g_part, N, C, O, vec);
  if (err != cudaSuccess) return (int)err;
  if (bn.apply) {
    sum_rows<<<dim3((unsigned)cdiv(C, 32), 2), RT, 0, st>>>(g_part, gx.y, C, dgb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // dW = dz'^T xn: a = dz' (o, position), b = xn (c, position)
  Src dzt = act_src<T>(dz, z, N, O, false, fold_on);
  dzt.on = fold_on;
  for (int i = 0; i < 3; ++i) dzt.v[i] = fold_v[i];
  Src xt = act_src<T>(x, nullptr, N, C, false, false);
  xt.on = bn.apply;
  xt.relu = bn.relu;
  xt.v[0] = bn.mean;
  xt.v[1] = bn.rstd;
  xt.v[2] = bn.gamma;
  xt.v[3] = bn.beta;
  const dim3 gw((unsigned)cdiv(C, BN), (unsigned)cdiv(O, BM), (unsigned)splits);
  err = launch<T>(dw_kernel<T>, gw, 3, st, dzt, xt, splits > 1 ? dw_part : dw,
                  O, C, chunk, N);
  if (err != cudaSuccess || splits == 1) return (int)err;
  sum_rows<<<dim3((unsigned)cdiv((int64_t)O * C, 32), 1), RT, 0, st>>>(
      dw_part, splits, (int64_t)O * C, dw);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward.  x [N, C] contiguous; w [O, C] of x's dtype with element strides
// (swo, swc).  mean/rstd/gamma/beta float32 [C] (read only with apply_bn),
// shift float32 [O] (read only with with_stats).  z [N, O]; part a float32
// scratch of 2 * ceil(N / 128) * O; stats float32 [2, O] (sum, sumsq),
// written only with with_stats.  Returns the CUDA error of the launches (0
// = launched).
extern "C" int ptt_conv_bn_nhwc_fwd(const void* x, const void* w,
                                    long long swo, long long swc,
                                    const void* mean, const void* rstd,
                                    const void* gamma, const void* beta,
                                    const void* shift, void* z, void* part,
                                    void* stats, long long N, int C, int O,
                                    int apply_bn, int relu, int with_stats,
                                    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || C <= 0 || O <= 0 || cdiv(N, BM) > 65535) return (int)cudaErrorInvalidValue;
  const Bn bn{static_cast<const float*>(mean), static_cast<const float*>(rstd),
              static_cast<const float*>(gamma), static_cast<const float*>(beta),
              apply_bn, relu};
  const float* sh = static_cast<const float*>(shift);
  float* pt = static_cast<float*>(part);
  float* sv = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return fwd<float>(x, w, swo, swc, bn, sh, z, pt, sv, N, C, O, with_stats, st);
  if (dtype == ptt::kBFloat16)
    return fwd<__nv_bfloat16>(x, w, swo, swc, bn, sh, z, pt, sv, N, C, O, with_stats, st);
  return (int)cudaErrorInvalidValue;
}

// Backward.  x, w and the BN vectors as in ptt_conv_bn_nhwc_fwd; z and dz
// [N, O] (z read only with with_stats); dsum/dsumsq/shift float32 [O]
// (read only with with_stats).  dx like x; dw float32 [O, C]; dw_part a
// float32 scratch of splits * O * C (unused when splits is 1); g_part a
// float32 scratch of 2 * ceil(N / 128) * C and dgb float32 [2, C] (dgamma,
// dbeta), both only with apply_bn.  Chunk z of the dW contraction covers
// positions [z * chunk, (z + 1) * chunk); chunk is a multiple of the k tile
// (32 float32, 64 bfloat16) and splits * chunk >= N.
extern "C" int ptt_conv_bn_nhwc_bwd(const void* x, const void* w,
                                    long long swo, long long swc,
                                    const void* z, const void* dz,
                                    const void* dsum, const void* dsumsq,
                                    const void* mean, const void* rstd,
                                    const void* gamma, const void* beta,
                                    const void* shift, void* dx, void* dw,
                                    void* dw_part, void* g_part, void* dgb,
                                    long long N, int C, int O, int apply_bn,
                                    int relu, int with_stats, int splits,
                                    long long chunk, int dtype, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bk = dtype == ptt::kFloat32 ? Tile<float>::BK : Tile<__nv_bfloat16>::BK;
  if (N <= 0 || C <= 0 || O <= 0 || cdiv(N, BM) > 65535 || splits < 1 ||
      splits > 65535 || chunk <= 0 || chunk % bk || (long long)splits * chunk < N)
    return (int)cudaErrorInvalidValue;
  const Bn bn{static_cast<const float*>(mean), static_cast<const float*>(rstd),
              static_cast<const float*>(gamma), static_cast<const float*>(beta),
              apply_bn, relu};
  const float* fv[3] = {static_cast<const float*>(dsum),
                        static_cast<const float*>(dsumsq),
                        static_cast<const float*>(shift)};
  float* dwv = static_cast<float*>(dw);
  float* dwp = static_cast<float*>(dw_part);
  float* gp = static_cast<float*>(g_part);
  float* gb = static_cast<float*>(dgb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return bwd<float>(x, w, swo, swc, z, dz, fv, with_stats, bn, dx, dwv, dwp, gp, gb, N, C, O, splits, chunk, st);
  if (dtype == ptt::kBFloat16)
    return bwd<__nv_bfloat16>(x, w, swo, swc, z, dz, fv, with_stats, bn, dx, dwv, dwp, gp, gb, N, C, O, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
}
