// Kernels #8 and #9: the fused BN-apply -> 1x1 conv -> batch-stats layer of
// ResNet's bottleneck in NCHW, forward and backward, on Hopper's tensor
// cores (sm_90a), in CUDA C++.  The NHWC kernels #10/#11 are
// conv_bn_nhwc.cu; both include wgmma.cuh.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/conv_bn.py:
//   #8  _fwd_call       (pallas_call body _fwd_kernel)        x [B, C, HW]
//   #9  _bwd_call       (_bwd_kernel)
// The function, per position j = b*HW + p and output channel o, with the
// producer's batch mean/rstd and the BN's gamma/beta over input channels c:
//   xn[c, j] = act(((x[c, j] - mean) * rstd) * gamma + beta)   (apply_bn)
//            = act(x[c, j])                                     (raw input)
//   z[o, j]  = sum_c W[o, c] * xn[c, j],  W read [O, C] through its strides
//   sum[o]   = sum_j (z - shift[o]),  sumsq[o] = sum_j (z - shift[o])^2
// with xn rounded to x's type before the product, every sum in float32,
// and z written in x's type.  The backward folds the stats' cotangents
// into dz (dz + dsum + 2 (z - shift) dsumsq, rounded to x's type, skipped
// without them), recomputes xn and returns dx (x's type), dW [O, C],
// dgamma and dbeta (float32).
//
// What bounds it on the H100: operations.  ResNet-50's fused layers are
// 2 B HW C O = 13.15 GFLOP at batch 128 against 0.02-0.05 ms of bytes, so
// the products go to the tensor cores: float32 as three TF32 passes
// (wgmma.cuh), 3 x operations / 495 TFLOP/s; bfloat16 as one.
//
// Design.  Three GEMMs, each a 128 x 128 tile a block (four warpgroups of
// 64 x 64, wgmma m64n64 from 128-byte-swizzled K-major shared tiles):
//   forward  z_b[O, HW]   = W[O, C] xn_b[C, HW]       grid (O tiles, position tiles)
//   dx       dxn_b[C, HW] = W^T[C, O] dz'_b[O, HW]    grid (C tiles, position tiles)
//   dW       dW[O, C]     = sum_j dz'[O, j] xn[C, j]  grid (C tiles, O tiles, chunks)
//  - TF32 wgmma takes only K-major operands.  W is split into hi/lo TF32
//    (bfloat16: copied) and, for dx, transposed, by a pre-pass over W
//    alone (split_w, a few microseconds) into tiles already in the wgmma
//    layout; the blocks copy them with 16-byte cp.async straight into the
//    shared ring and never transform them.
//  - The per-block transform is left to the operand that carries the
//    prologue or the fold (xn, dz').  Its raw tiles arrive by cp.async in
//    device layout, positions contiguous: [k][position] for the forward's
//    and dx's B, [channel][position] for both dW operands (already K-major:
//    the transform only applies the prologue or fold and splits hi/lo).
//  - Positions run across images: position j sits at b C HW + p.  A copy
//    takes v positions of one channel, v the widest of 16, 8 or 4 bytes
//    whose element count divides HW (then no copy straddles an image): 16
//    bytes at stages 1-3 in float32, 4 bytes at stage 4 (HW 49); bfloat16
//    at an odd HW takes plain loads.  Rows and k past the edge are zeroed
//    after the prologue (relu(norm(0)) is not 0).
//  - dW's chunks over positions are whole images; per-tile stats, dgamma/
//    dbeta and dW chunk partials go to scratch and are added by the
//    fixed-order second pass (sum_rows): no atomics, two launches give the
//    same bits.
//  - A ring of raw stages (three, or two where three do not fit 227 KB)
//    keeps the copies two (one) tiles ahead; the transform of tile t + 1
//    runs while the wgmmas of tile t are in flight (the swizzled tiles are
//    double-buffered).
//  - Epilogues stage the accumulator in shared memory; rows are channels,
//    columns positions, so z and dx leave along the positions in the same
//    image-aligned pieces as the copies (16 bytes where HW allows), and x
//    is read the same way for the BN backward.  The rows' channel vectors
//    wait in shared memory and x is loaded for all rows at once: with one
//    block an SM nothing else hides a load inside the row loop.

#include "wgmma.cuh"

namespace {

using ptt::from_f;
using ptt::round_to;
using ptt::to_f;

// the operands
enum Kind {
  kPre = 0,    // W's tiles from split_w, copied as they are
  kXnPos = 1,  // xn: rows positions, k channels (raw [k][row]), prologue by k
  kDzPos = 2,  // dz': rows positions, k output channels, fold by k
  kXnCh = 3,   // xn: rows channels, k positions (raw [row][k]), prologue by row
  kDzCh = 4,   // dz': rows output channels, k positions, fold by row
};
__host__ __device__ constexpr bool pos_rows(int k) { return k == kXnPos || k == kDzPos; }
__host__ __device__ constexpr bool is_dz(int k) { return k == kDzPos || k == kDzCh; }
__host__ __device__ constexpr int nvec(int k) { return is_dz(k) ? 3 : 4; }

// An activation [B, ch, hw] of x's type as an operand.  v: positions a
// copy (v elements of x's type, 4-16 bytes, v divides hw), 0 for plain
// loads.  on: the prologue (apply_bn) or the fold; vec: mean, rstd, gamma,
// beta, or dsum, dsumsq, shift (z then read beside dz).
struct Act {
  const void* p;
  const void* z;
  int64_t img;  // ch * hw
  int hw, ch, v, on, relu;
  const float* vec[4];
};

// shared memory of a kernel: the swizzled tiles (double-buffered; W's come
// from the ring), then a ring of NS stages [A raw | B raw | B's k vectors],
// each 1 KB-aligned (W's tiles are swizzle atoms)
template <typename T, int KA, int KB>
struct Smem {
  static constexpr int OPB = Elem<T>::OP_BYTES;
  static constexpr int A_RAW =
      KA == kPre ? OPB : (is_dz(KA) ? 2 : 1) * TILE_BYTES;
  static constexpr int B_RAW = (is_dz(KB) ? 2 : 1) * TILE_BYTES;
  static constexpr int PRM = pos_rows(KB) ? 4 * Elem<T>::BK * 4 : 0;
  static constexpr int STAGE = (A_RAW + B_RAW + PRM + 1023) / 1024 * 1024;
  static constexpr int SWZ = (KA == kPre ? 1 : 2) * OPB;
  static constexpr int BASE = 1024 + 2 * SWZ;  // 1 KB to align
  static constexpr int NS = BASE + 3 * STAGE <= SMEM_MAX ? 3 : 2;
  static constexpr int BYTES = BASE + NS * STAGE;
  static_assert(BYTES <= SMEM_MAX, "the stages exceed the shared memory");
  // the epilogue: the staged accumulator and four channel vectors
  static_assert(BM * LDS * 4 + 4 * BM * 4 + 1024 <= BYTES,
                "epilogue staging too large");
};

// image and place of position j
struct BP {
  int b, p;
};
__device__ __forceinline__ BP locate(int64_t j, int hw) {
  const int64_t b = j / hw;
  return {(int)b, (int)(j - b * hw)};
}
__device__ __forceinline__ void step(BP& q, int n, int hw) {
  q.p += n;
  while (q.p >= hw) {
    q.p -= hw;
    ++q.b;
  }
}

// EPC positions from j (at q) of the channel whose offset in an image is
// chan, into the 16 bytes at raw: copies of V positions (none straddles an
// image); positions from `end` on, and a channel that is out, are zero
template <typename T, int V>
__device__ __forceinline__ void copy_run_v(const T* base, int64_t img, int hw,
                                           uint8_t* raw, int64_t j, BP q,
                                           int64_t chan, bool chok,
                                           int64_t end) {
  constexpr int EPC = Elem<T>::EPC, NB = V * (int)sizeof(T);
  const uint32_t dst = smem_u32(raw);
#pragma unroll
  for (int s = 0; s < EPC / V; ++s) {
    const bool ok = chok && j + s * V < end;
    const T* src = ok ? base + q.b * img + chan + q.p : base;
    if constexpr (NB == 16)
      cp_async16(dst, src, ok ? 16 : 0);
    else
      cp_async_small<NB>(dst + s * NB, src, ok ? NB : 0);
    step(q, V, hw);
  }
}

template <typename T>
__device__ __forceinline__ void copy_run(const Act& s, const void* src,
                                         uint8_t* raw, int64_t j, BP q,
                                         int64_t chan, bool chok,
                                         int64_t end) {
  constexpr int EPC = Elem<T>::EPC;
  const T* base = static_cast<const T*>(src);
  if (s.v == EPC) {
    copy_run_v<T, EPC>(base, s.img, s.hw, raw, j, q, chan, chok, end);
  } else if (s.v == EPC / 2) {
    copy_run_v<T, EPC / 2>(base, s.img, s.hw, raw, j, q, chan, chok, end);
  } else if (s.v == EPC / 4) {  // 4 bytes
    copy_run_v<T, EPC / 4>(base, s.img, s.hw, raw, j, q, chan, chok, end);
  } else {
    float f[EPC];
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      f[e] = (chok && j + e < end) ? to_f(base[q.b * s.img + chan + q.p]) : 0.f;
      step(q, 1, s.hw);
    }
    *reinterpret_cast<uint4*>(raw) = pack(f);
  }
}

// the k tile's per-channel vectors (k-indexed operands), [vector][BK], by
// 4-byte cp.async (zero past the end)
template <typename T, int KIND>
__device__ __forceinline__ void load_prm(const Act& s, float* prm, int64_t k0,
                                         int64_t ke) {
  constexpr int BK = Elem<T>::BK;
  if (threadIdx.x >= BK) return;
  const int64_t k = k0 + threadIdx.x;
  const uint32_t dst = smem_u32(prm + threadIdx.x);
#pragma unroll
  for (int i = 0; i < nvec(KIND); ++i)
    cp_async_small<4>(dst + i * BK * 4, k < ke ? s.vec[i] + k : s.vec[i],
                      k < ke ? 4 : 0);
}

// apply the operand's prologue or fold to EPC values, zero those from nk on
template <typename T, int KIND, int EPC>
__device__ __forceinline__ void apply(const Act& s, float (&v)[EPC],
                                      const float (&zv)[EPC],
                                      const float (&pm)[4][EPC], int nk) {
#pragma unroll
  for (int e = 0; e < EPC; ++e) {
    float out = v[e];
    if constexpr (is_dz(KIND)) {
      if (s.on) out = round_to<T>(fold(out, zv[e], pm[0][e], pm[1][e], pm[2][e]));
    } else {
      out = round_to<T>(bn_act(out, pm[0][e], pm[1][e], pm[2][e], pm[3][e],
                               s.on, s.relu));
    }
    v[e] = e < nk ? out : 0.f;
  }
}

// elements of a chunk of k from kc on inside [.., ke): all, or the first nk
__device__ __forceinline__ int inside(int64_t kc, int64_t ke, int epc) {
  const int64_t left = ke - kc;
  return left >= epc ? epc : left > 0 ? (int)left : 0;
}

// raw [k][row] (rows positions) -> the swizzled K-major tile(s); a thread a
// row, reading along the contiguous positions; vectors by k from prm
template <typename T, int KIND>
__device__ __forceinline__ void transform_pos(const Act& s, const uint8_t* raw,
                                              const uint8_t* rawz,
                                              const float* prm, uint8_t* hi,
                                              uint8_t* lo, int64_t row0,
                                              int64_t rows, int64_t k0,
                                              int64_t ke) {
  constexpr int EPC = Elem<T>::EPC, BK = Elem<T>::BK;
  const T* t = reinterpret_cast<const T*>(raw);
  const T* tz = reinterpret_cast<const T*>(rawz);
  const int r = threadIdx.x & (BM - 1);
  const bool rok = row0 + r < rows;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int j = (threadIdx.x >> 7) + (NT / BM) * i;
    float v[EPC], zv[EPC], pm[4][EPC];
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      v[e] = to_f(t[(j * EPC + e) * BM + r]);
      zv[e] = (is_dz(KIND) && s.on) ? to_f(tz[(j * EPC + e) * BM + r]) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < nvec(KIND); ++p)
#pragma unroll
      for (int e = 0; e < EPC; e += 4) {
        const float4 f =
            s.on ? *reinterpret_cast<const float4*>(prm + p * BK + j * EPC + e)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        pm[p][e] = f.x;
        pm[p][e + 1] = f.y;
        pm[p][e + 2] = f.z;
        pm[p][e + 3] = f.w;
      }
    apply<T, KIND, EPC>(s, v, zv, pm, rok ? inside(k0 + j * EPC, ke, EPC) : 0);
    write_chunk<T>(v, hi, lo, r, j);
  }
}

// raw [row][k] (rows channels, k positions) -> the swizzled tile(s): 8
// threads a row, 16-byte reads and writes; vectors by row from rp
template <typename T, int KIND>
__device__ __forceinline__ void transform_ch(const Act& s, const uint8_t* raw,
                                             const uint8_t* rawz,
                                             const float (&rp)[CHUNKS][4],
                                             uint8_t* hi, uint8_t* lo,
                                             int64_t row0, int64_t k0,
                                             int64_t ke) {
  constexpr int EPC = Elem<T>::EPC;
  const int j = threadIdx.x & 7;
  const int nkc = inside(k0 + j * EPC, ke, EPC);
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int r = (threadIdx.x >> 3) + (NT / 8) * i;
    float v[EPC], zv[EPC], pm[4][EPC];
    unpack(*reinterpret_cast<const uint4*>(raw + r * ROW_BYTES + j * 16), v);
    if (is_dz(KIND) && s.on)
      unpack(*reinterpret_cast<const uint4*>(rawz + r * ROW_BYTES + j * 16), zv);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < EPC; ++e) pm[p][e] = rp[i][p];
    apply<T, KIND, EPC>(s, v, zv, pm, row0 + r < s.ch ? nkc : 0);
    write_chunk<T>(v, hi, lo, r, j);
  }
}

// acc (this thread's part of the 128 x 128 tile) = sum over k in [kb, ke)
// of A(a0 + row, k) B(b0 + col, k).  A is W's tiles (kPre: row tile a0 /
// BM of pre, nkt k tiles a row tile) or dz' by channel (kDzCh); B is xn or
// dz' by position (rows [b0, b0 + 128) of nb) or xn by channel.  Tile t:
// raw stage t % NS, swizzled buffer t % 2.  Every step commits one
// cp.async group (empty past the end).
template <typename T, int KA, int KB>
__device__ __forceinline__ void mainloop(const Act& a, const uint8_t* pre,
                                         int nkt, int64_t a0, const Act& b,
                                         int64_t b0, int64_t nb, int64_t kb,
                                         int64_t ke, uint8_t* sm,
                                         float (&acc)[32]) {
  using L = Smem<T, KA, KB>;
  constexpr int BK = Elem<T>::BK, EPC = Elem<T>::EPC, NS = L::NS;
  constexpr int RC = BM / EPC;  // chunks of positions a k row (pos_rows)
  uint8_t* raw = sm + 2 * L::SWZ;
  const int tid = threadIdx.x;

  // by-position B: this thread's EPC positions, fixed
  const int64_t jb = b0 + (tid % RC) * EPC;
  const BP qb = pos_rows(KB) ? locate(jb, b.hw) : BP{0, 0};
  // by-channel operands: the positions of this thread's k chunk, walked
  int64_t jw = kb + (tid & 7) * EPC;
  BP qw = pos_rows(KB) ? BP{0, 0} : locate(jw, b.hw);
  // by-channel operands: the vectors of this thread's rows
  float ra[CHUNKS][4], rb[CHUNKS][4];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int r = (tid >> 3) + (NT / 8) * i;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      ra[i][p] = rb[i][p] = 0.f;
      if (KA == kDzCh && a.on && p < 3 && a0 + r < a.ch) ra[i][p] = a.vec[p][a0 + r];
      if (KB == kXnCh && b.on && b0 + r < b.ch) rb[i][p] = b.vec[p][b0 + r];
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int nt = ke > kb ? (int)((ke - kb + BK - 1) / BK) : 0;
  if (nt == 0) return;

  auto issue = [&](int t) {
    if (t < nt) {
      uint8_t* st = raw + (t % NS) * L::STAGE;
      uint8_t* sb = st + L::A_RAW;
      const int64_t k0 = kb + (int64_t)t * BK;
      if constexpr (KA == kPre) {
        const uint8_t* src =
            pre + ((a0 / BM) * nkt + (k0 / BK)) * (int64_t)L::OPB;
        const uint32_t dst = smem_u32(st);
#pragma unroll
        for (int i = 0; i < L::OPB / 16 / NT; ++i)
          cp_async16(dst + (tid + i * NT) * 16, src + (tid + i * NT) * 16, 16);
      } else {  // kDzCh: rows o, positions jw..
#pragma unroll
        for (int i = 0; i < CHUNKS; ++i) {
          const int q = tid + i * NT;
          const int64_t o = a0 + (q >> 3);
          copy_run<T>(a, a.p, st + q * 16, jw, qw, o * a.hw, o < a.ch, ke);
          if (a.on)
            copy_run<T>(a, a.z, st + TILE_BYTES + q * 16, jw, qw, o * a.hw,
                        o < a.ch, ke);
        }
      }
      if constexpr (pos_rows(KB)) {
#pragma unroll
        for (int i = 0; i < CHUNKS; ++i) {
          const int q = tid + i * NT;
          const int64_t ch = k0 + q / RC;
          copy_run<T>(b, b.p, sb + q * 16, jb, qb, ch * b.hw, ch < ke, nb);
          if (is_dz(KB) && b.on)
            copy_run<T>(b, b.z, sb + TILE_BYTES + q * 16, jb, qb, ch * b.hw,
                        ch < ke, nb);
        }
        if (b.on)
          load_prm<T, KB>(b, reinterpret_cast<float*>(sb + L::B_RAW), k0, ke);
      } else {  // kXnCh: rows c, positions jw..
#pragma unroll
        for (int i = 0; i < CHUNKS; ++i) {
          const int q = tid + i * NT;
          const int64_t c = b0 + (q >> 3);
          copy_run<T>(b, b.p, sb + q * 16, jw, qw, c * b.hw, c < b.ch, ke);
        }
      }
      if constexpr (!pos_rows(KB)) {
        jw += BK;
        step(qw, BK, b.hw);
      }
    }
    cp_commit();
  };
  auto xform = [&](int t) {
    uint8_t* st = raw + (t % NS) * L::STAGE;
    uint8_t* sb = st + L::A_RAW;
    uint8_t* op = sm + (t & 1) * L::SWZ;
    const int64_t k0 = kb + (int64_t)t * BK;
    uint8_t* bsw = op;
    if constexpr (KA != kPre) {
      transform_ch<T, KA>(a, st, st + TILE_BYTES, ra, op, op + TILE_BYTES,
                          a0, k0, ke);
      bsw = op + L::OPB;
    }
    if constexpr (pos_rows(KB))
      transform_pos<T, KB>(b, sb, sb + TILE_BYTES,
                           reinterpret_cast<const float*>(sb + L::B_RAW), bsw,
                           bsw + TILE_BYTES, b0, nb, k0, ke);
    else
      transform_ch<T, KB>(b, sb, nullptr, rb, bsw, bsw + TILE_BYTES, b0, k0,
                          ke);
  };

#pragma unroll
  for (int t = 0; t < NS; ++t) issue(t);
  cp_wait<NS - 1>();
  __syncthreads();
  xform(0);
  fence_async_smem();
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const uint32_t op = smem_u32(sm + (t & 1) * L::SWZ);
    const uint32_t aop =
        KA == kPre ? smem_u32(raw + (t % NS) * L::STAGE) : op;
    fence_acc(acc);
    wg_fence();
    mma_tiles<T>(aop, KA == kPre ? op : op + L::OPB, acc);
    wg_commit();
    if (t + 1 < nt) {  // stage tile t + 1 while the wgmmas run
      cp_wait<NS - 2>();
      __syncthreads();
      xform(t + 1);
    }
    wg_wait_all();
    fence_acc(acc);
    fence_async_smem();
    __syncthreads();
    issue(t + NS);  // into the stage tile t left
  }
}

// sum over the n lanes (a power of two, <= 32) that share a row
template <int N>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// W [rows, kdim] at w[r * srow + k * sk] -> tiles [row tile][k tile] in the
// wgmma layout: float32 as hi then lo TF32 (two swizzled 16 KB tiles),
// bfloat16 as it is; zero past the edges.  A thread a 16-byte chunk.
template <typename T>
__global__ void __launch_bounds__(RT)
split_w(const T* __restrict__ w, int64_t srow, int64_t sk, int rows,
        int kdim, int nkt, int64_t chunks, uint8_t* __restrict__ out) {
  constexpr int EPC = Elem<T>::EPC, BK = Elem<T>::BK;
  const int64_t q = (int64_t)blockIdx.x * RT + threadIdx.x;
  if (q >= chunks) return;
  const int64_t tile = q / (BM * 8);
  const int rem = (int)(q - tile * (BM * 8)), r = rem >> 3, j = rem & 7;
  const int64_t row = (tile / nkt) * BM + r;
  const int64_t k = (tile % nkt) * BK + j * EPC;
  float v[EPC];
#pragma unroll
  for (int e = 0; e < EPC; ++e)
    v[e] = (row < rows && k + e < kdim) ? to_f(w[row * srow + (k + e) * sk])
                                        : 0.f;
  uint8_t* hi = out + tile * Elem<T>::OP_BYTES;
  write_chunk<T>(v, hi, hi + TILE_BYTES, r, j);
}

// this thread's EPC positions of an epilogue row, from j (at q), in
// pieces of v positions (16, 8 or 4 bytes; v divides hw, so no piece
// straddles an image), or one by one at the end of the positions or where
// v is 0
template <typename T, int EPC>
__device__ __forceinline__ void load_pos(const T* p, int64_t img, int hw,
                                         int64_t chan, int64_t j, BP q,
                                         int64_t n, int v, float (&f)[EPC]) {
  constexpr int S = (int)sizeof(T);
  if (v > 0 && j + EPC <= n) {
    uint32_t w[4];
    if (v == EPC) {
      const uint4 u =
          *reinterpret_cast<const uint4*>(p + q.b * img + chan + q.p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if (v * S == 8) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint2 u =
            *reinterpret_cast<const uint2*>(p + q.b * img + chan + q.p);
        w[2 * s] = u.x, w[2 * s + 1] = u.y;
        step(q, v, hw);
      }
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        w[s] = *reinterpret_cast<const uint32_t*>(p + q.b * img + chan + q.p);
        step(q, v, hw);
      }
    }
    unpack(make_uint4(w[0], w[1], w[2], w[3]), f);
    return;
  }
#pragma unroll
  for (int e = 0; e < EPC; ++e) {
    f[e] = j + e < n ? to_f(p[q.b * img + chan + q.p]) : 0.f;
    step(q, 1, hw);
  }
}
template <typename T, int EPC>
__device__ __forceinline__ void store_pos(T* p, int64_t img, int hw,
                                          int64_t chan, int64_t j, BP q,
                                          int64_t n, int v,
                                          const float (&f)[EPC]) {
  constexpr int S = (int)sizeof(T);
  if (v > 0 && j + EPC <= n) {
    const uint4 u = pack(f);
    if (v == EPC) {
      *reinterpret_cast<uint4*>(p + q.b * img + chan + q.p) = u;
    } else if (v * S == 8) {
      *reinterpret_cast<uint2*>(p + q.b * img + chan + q.p) = make_uint2(u.x, u.y);
      step(q, v, hw);
      *reinterpret_cast<uint2*>(p + q.b * img + chan + q.p) = make_uint2(u.z, u.w);
    } else {
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        *reinterpret_cast<uint32_t*>(p + q.b * img + chan + q.p) = w[s];
        step(q, v, hw);
      }
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < EPC; ++e) {
    if (j + e < n) p[q.b * img + chan + q.p] = from_f<T>(f[e]);
    step(q, 1, hw);
  }
}

// The epilogues of the forward and dx: the staged accumulator S's rows are
// channels, its columns positions; CPR threads a row, EPC positions each,
// ROWS rows a thread (r0 + RPP i).  The rows' channel vectors are put in
// shared memory beside S before it is staged (one barrier publishes
// both), so no row waits on a load of its own.
template <typename T>
struct Epi {
  static constexpr int EPC = Elem<T>::EPC, CPR = BN / EPC, RPP = NT / CPR,
                       ROWS = BM / RPP;
  static constexpr int VEC_OFF = BM * LDS * 4;  // bytes: the vectors after S
};

// forward: A = W (rows o), B = xn (rows positions); grid (O tiles,
// position tiles: the O tiles of a position tile run together and share
// its x in L2).  with_stats: part [2, position tiles, O].  vec: positions
// a piece of z (v of run_v), 0 for one by one.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
fwd_kernel(Act xa, const uint8_t* __restrict__ wsw, int nkt,
           const float* __restrict__ shift, T* __restrict__ z,
           float* __restrict__ part, int64_t N, int C, int O, int with_stats,
           int vec) {
  using E = Epi<T>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int o0 = blockIdx.x * BM;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  float acc[32];
  mainloop<T, kPre, kXnPos>(xa, wsw, nkt, o0, xa, n0, N, 0, C, sm, acc);
  float* V = reinterpret_cast<float*>(sm + E::VEC_OFF);
  if (threadIdx.x < BM)
    V[threadIdx.x] =
        with_stats && o0 + (int)threadIdx.x < O ? shift[o0 + threadIdx.x] : 0.f;
  const float* S = stage_acc(acc, sm);

  constexpr int EPC = E::EPC, CPR = E::CPR;
  const int cc = threadIdx.x % CPR, r0 = threadIdx.x / CPR;
  const int hw = xa.hw;
  const int64_t j = n0 + cc * EPC, img = (int64_t)O * hw;
  const BP q = locate(j < N ? j : 0, hw);
#pragma unroll
  for (int i = 0; i < E::ROWS; ++i) {
    const int r = r0 + E::RPP * i, o = o0 + r;
    const bool ook = o < O;
    float v[EPC];
    load_staged<EPC>(S + r * LDS + cc * EPC, v);
    if (ook && j < N)
      store_pos<T, EPC>(z, img, hw, (int64_t)o * hw, j, q, N, vec, v);
    if (with_stats) {
      const float sh = V[r];
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        if (j + e < N) {
          const float d = v[e] - sh;
          s += d;
          ss = fmaf(d, d, ss);
        }
      }
      s = lanes_sum<CPR>(s);
      ss = lanes_sum<CPR>(ss);
      if (cc == 0 && ook) {
        part[(int64_t)blockIdx.y * O + o] = s;
        part[((int64_t)gridDim.y + blockIdx.y) * O + o] = ss;
      }
    }
  }
}

// backward (a): dx; A = W^T (rows c), B = dz' (rows positions, the fold);
// grid (C tiles, position tiles).  apply_bn: part [2, position tiles, C]
// (dgamma, dbeta).  vec: positions a piece of x and dx.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
dx_kernel(Act dza, const uint8_t* __restrict__ wsw, int nkt,
          const T* __restrict__ x, Bn bn, T* __restrict__ dx,
          float* __restrict__ part, int64_t N, int C, int O, int vec) {
  using E = Epi<T>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int c0 = blockIdx.x * BM;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  float acc[32];
  mainloop<T, kPre, kDzPos>(dza, wsw, nkt, c0, dza, n0, N, 0, O, sm, acc);
  float* V = reinterpret_cast<float*>(sm + E::VEC_OFF);  // mean, rstd, gamma, beta
  if (threadIdx.x < BM) {
    const int c = c0 + threadIdx.x;
    const bool on = bn.apply && c < C;
    V[threadIdx.x] = on ? bn.mean[c] : 0.f;
    V[BM + threadIdx.x] = on ? bn.rstd[c] : 1.f;
    V[2 * BM + threadIdx.x] = on ? bn.gamma[c] : 1.f;
    V[3 * BM + threadIdx.x] = on ? bn.beta[c] : 0.f;
  }
  const float* S = stage_acc(acc, sm);

  constexpr int EPC = E::EPC, CPR = E::CPR;
  const int cc = threadIdx.x % CPR, r0 = threadIdx.x / CPR;
  const int hw = dza.hw;
  const int64_t j = n0 + cc * EPC, img = (int64_t)C * hw;
  const BP q = locate(j < N ? j : 0, hw);
  // x of every row first: their loads are in flight together
  float xv[E::ROWS][EPC];
#pragma unroll
  for (int i = 0; i < E::ROWS; ++i) {
    const int c = c0 + r0 + E::RPP * i;
    if (c < C && j < N)
      load_pos<T, EPC>(x, img, hw, (int64_t)c * hw, j, q, N, vec, xv[i]);
    else
#pragma unroll
      for (int e = 0; e < EPC; ++e) xv[i][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < E::ROWS; ++i) {
    const int r = r0 + E::RPP * i, c = c0 + r;
    const bool in = c < C && j < N;
    const float mu = V[r], rs = V[BM + r], g = V[2 * BM + r],
                be = V[3 * BM + r];
    float dv[EPC], out[EPC];
    load_staged<EPC>(S + r * LDS + cc * EPC, dv);
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const float xe = xv[i][e];
      if (bn.apply) {
        const float pre = (xe - mu) * rs;
        const float ylin = pre * g + be;
        const float dyl = (bn.relu && !(ylin > 0.f)) ? 0.f : dv[e];
        if (in && j + e < N) {
          sg = fmaf(dyl, pre, sg);
          sb += dyl;
        }
        out[e] = dyl * (g * rs);
      } else {
        out[e] = (bn.relu && !(xe > 0.f)) ? 0.f : dv[e];
      }
    }
    if (in) store_pos<T, EPC>(dx, img, hw, (int64_t)c * hw, j, q, N, vec, out);
    if (bn.apply) {
      sg = lanes_sum<CPR>(sg);
      sb = lanes_sum<CPR>(sb);
      if (cc == 0 && c < C) {
        part[(int64_t)blockIdx.y * C + c] = sg;
        part[((int64_t)gridDim.y + blockIdx.y) * C + c] = sb;
      }
    }
  }
}

// backward (b): dW over the positions [z chunk, (z + 1) chunk), whole
// images; A = dz' (rows o, the fold), B = xn (rows c, the prologue), both
// K-major in NCHW; grid (C tiles, O tiles, chunks).  Chunk z writes out[z]
// (float32 [O, C]).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
dw_kernel(Act dza, Act xa, float* __restrict__ out, int O, int C,
          int64_t chunk, int64_t N) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int c0 = blockIdx.x * BN;
  const int o0 = blockIdx.y * BM;
  const int64_t kb = (int64_t)blockIdx.z * chunk;
  const int64_t ke = kb + chunk < N ? kb + chunk : N;
  float acc[32];
  mainloop<T, kDzCh, kXnCh>(dza, nullptr, 0, o0, xa, c0, C, kb, ke, sm, acc);
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
    if (full) {
      *reinterpret_cast<float4*>(oz + (int64_t)o * C + cb) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n) oz[(int64_t)o * C + cb + e] = v[e];
    }
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// positions a copy of an activation [B, ch, hw] (and of z beside it)
template <typename T>
int run_v(int hw, const void* p, const void* z) {
  constexpr int EPC = Elem<T>::EPC, S = (int)sizeof(T);
  for (int v = EPC; v * S >= 4; v /= 2)
    if (hw % v == 0 && aligned(p, v * S) && (!z || aligned(z, v * S)))
      return v;
  return 0;
}

template <typename T>
Act act(const void* p, const void* z, int hw, int ch, int on, int relu,
        const float* v0, const float* v1, const float* v2, const float* v3) {
  Act s{};
  s.p = p;
  s.z = z;
  s.hw = hw;
  s.ch = ch;
  s.img = (int64_t)ch * hw;
  s.v = run_v<T>(hw, p, on ? z : nullptr);
  s.on = on;
  s.relu = relu;
  s.vec[0] = v0;
  s.vec[1] = v1;
  s.vec[2] = v2;
  s.vec[3] = v3;
  return s;
}

// W as [rows, kdim] (strides srow, sk) into its wgmma tiles at wsw
template <typename T>
cudaError_t split(const void* w, int64_t srow, int64_t sk, int rows, int kdim,
                  void* wsw, cudaStream_t st) {
  const int nkt = (int)cdiv(kdim, Elem<T>::BK);
  const int64_t chunks = cdiv(rows, BM) * nkt * (BM * 8);
  split_w<T><<<(unsigned)cdiv(chunks, RT), RT, 0, st>>>(
      static_cast<const T*>(w), srow, sk, rows, kdim, nkt, chunks,
      static_cast<uint8_t*>(wsw));
  return cudaGetLastError();
}

template <typename T, int KA, int KB, typename... P, typename... A>
cudaError_t launch(void (*kern)(P...), dim3 grid, cudaStream_t st,
                   A... args) {
  const int bytes = Smem<T, KA, KB>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, bytes, st>>>(args...);
  return cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const void* w, int64_t swo, int64_t swc, Bn bn,
        const float* shift, void* z, float* part, float* stats, void* wsw,
        int64_t N, int hw, int C, int O, int with_stats, cudaStream_t st) {
  cudaError_t err = split<T>(w, swo, swc, O, C, wsw, st);
  if (err != cudaSuccess) return (int)err;
  const Act xa = act<T>(x, nullptr, hw, C, bn.apply, bn.relu, bn.mean,
                        bn.rstd, bn.gamma, bn.beta);
  const dim3 grid((unsigned)cdiv(O, BM), (unsigned)cdiv(N, BN));
  const int vec = run_v<T>(hw, z, nullptr);
  err = launch<T, kPre, kXnPos>(
      fwd_kernel<T>, grid, st, xa, static_cast<const uint8_t*>(wsw),
      (int)cdiv(C, Elem<T>::BK), shift, static_cast<T*>(z), part, N, C, O,
      with_stats, vec);
  if (err != cudaSuccess || !with_stats) return (int)err;
  sum_rows<<<dim3((unsigned)cdiv(O, 32), 2), RT, 0, st>>>(part, grid.y, O, stats);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* w, int64_t swo, int64_t swc, const void* z,
        const void* dz, const float* const fv[3], int fold_on, Bn bn,
        void* dx, float* dw, float* dw_part, float* g_part, float* dgb,
        void* wsw, int64_t N, int hw, int C, int O, int splits,
        int64_t chunk, cudaStream_t st) {
  // dx = W^T dz': W^T as [C, O]
  cudaError_t err = split<T>(w, swc, swo, C, O, wsw, st);
  if (err != cudaSuccess) return (int)err;
  const Act dza = act<T>(dz, z, hw, O, fold_on, 0, fv[0], fv[1], fv[2],
                         nullptr);
  const dim3 gx((unsigned)cdiv(C, BM), (unsigned)cdiv(N, BN));
  const int vec = run_v<T>(hw, x, dx);
  err = launch<T, kPre, kDzPos>(
      dx_kernel<T>, gx, st, dza, static_cast<const uint8_t*>(wsw),
      (int)cdiv(O, Elem<T>::BK), static_cast<const T*>(x), bn,
      static_cast<T*>(dx), g_part, N, C, O, vec);
  if (err != cudaSuccess) return (int)err;
  if (bn.apply) {
    sum_rows<<<dim3((unsigned)cdiv(C, 32), 2), RT, 0, st>>>(g_part, gx.y, C, dgb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // dW = sum_j dz'[o, j] xn[c, j]
  const Act xa = act<T>(x, nullptr, hw, C, bn.apply, bn.relu, bn.mean,
                        bn.rstd, bn.gamma, bn.beta);
  const dim3 gw((unsigned)cdiv(C, BN), (unsigned)cdiv(O, BM), (unsigned)splits);
  err = launch<T, kDzCh, kXnCh>(dw_kernel<T>, gw, st, dza, xa,
                                splits > 1 ? dw_part : dw, O, C, chunk, N);
  if (err != cudaSuccess || splits == 1) return (int)err;
  sum_rows<<<dim3((unsigned)cdiv((int64_t)O * C, 32), 1), RT, 0, st>>>(
      dw_part, splits, (int64_t)O * C, dw);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward.  x [B, C, HW] contiguous, N = B*HW, hw = HW.  w [O, C] of x's
// dtype with element strides (swo, swc).  mean/rstd/gamma/beta float32 [C]
// (read only with apply_bn), shift float32 [O] (read only with
// with_stats).  z like x with O channels; part a float32 scratch of 2 *
// ceil(N / 128) * O; stats float32 [2, O] (sum, sumsq), written only with
// with_stats; wsw a scratch of ceil(O / 128) * ceil(C / k tile) * 32 KB
// (float32; 16 KB bfloat16), the k tile 32 float32 or 64 bfloat16.
// Returns the CUDA error of the launches (0 = launched).
extern "C" int ptt_conv_bn_fwd(const void* x, const void* w, long long swo,
                               long long swc, const void* mean,
                               const void* rstd, const void* gamma,
                               const void* beta, const void* shift, void* z,
                               void* part, void* stats, void* wsw, long long N,
                               int hw, int C, int O, int apply_bn, int relu,
                               int with_stats, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || C <= 0 || O <= 0 || hw <= 0 || N % hw ||
      cdiv(N, BN) > 65535)
    return (int)cudaErrorInvalidValue;
  const Bn bn{static_cast<const float*>(mean), static_cast<const float*>(rstd),
              static_cast<const float*>(gamma), static_cast<const float*>(beta),
              apply_bn, relu};
  const float* sh = static_cast<const float*>(shift);
  float* pt = static_cast<float*>(part);
  float* sv = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return fwd<float>(x, w, swo, swc, bn, sh, z, pt, sv, wsw, N, hw, C, O, with_stats, st);
  if (dtype == ptt::kBFloat16)
    return fwd<__nv_bfloat16>(x, w, swo, swc, bn, sh, z, pt, sv, wsw, N, hw, C, O, with_stats, st);
  return (int)cudaErrorInvalidValue;
}

// Backward.  x, w and the BN vectors as in ptt_conv_bn_fwd; z and dz like
// the forward's z (z read only with with_stats); dsum/dsumsq/shift float32
// [O] (read only with with_stats).  dx like x; dw float32 [O, C]; dw_part
// a float32 scratch of splits * O * C (unused when splits is 1); g_part a
// float32 scratch of 2 * ceil(N / 128) * C and dgb float32 [2, C] (dgamma,
// dbeta), both only with apply_bn; wsw a scratch of ceil(C / 128) *
// ceil(O / k tile) * 32 KB (16 KB bfloat16).  Chunk z of the dW
// contraction covers positions [z * chunk, (z + 1) * chunk): whole images
// (chunk a multiple of hw), splits * chunk >= N.
extern "C" int ptt_conv_bn_bwd(const void* x, const void* w, long long swo,
                               long long swc, const void* z, const void* dz,
                               const void* dsum, const void* dsumsq,
                               const void* mean, const void* rstd,
                               const void* gamma, const void* beta,
                               const void* shift, void* dx, void* dw,
                               void* dw_part, void* g_part, void* dgb,
                               void* wsw, long long N, int hw, int C, int O,
                               int apply_bn, int relu, int with_stats,
                               int splits, long long chunk, int dtype,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || C <= 0 || O <= 0 || hw <= 0 || N % hw ||
      cdiv(N, BN) > 65535 || splits < 1 || splits > 65535 || chunk <= 0 ||
      chunk % hw || (long long)splits * chunk < N)
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
    return bwd<float>(x, w, swo, swc, z, dz, fv, with_stats, bn, dx, dwv, dwp, gp, gb, wsw, N, hw, C, O, splits, chunk, st);
  if (dtype == ptt::kBFloat16)
    return bwd<__nv_bfloat16>(x, w, swo, swc, z, dz, fv, with_stats, bn, dx, dwv, dwp, gp, gb, wsw, N, hw, C, O, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
}
