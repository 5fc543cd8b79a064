// Kernels #8 and #9: the fused BN-apply -> 1x1 conv -> batch-stats layer of
// ResNet's bottleneck, forward and backward, NCHW, for Hopper (sm_90a), in
// plain CUDA C++.  The NHWC kernels #10/#11 are conv_bn_nhwc.cu (tensor
// cores); the templates below keep their layout parameter, instantiated
// for NCHW only.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/conv_bn.py:
//   #8  _fwd_call       (pallas_call body _fwd_kernel)        NCHW x [B, C, HW]
//   #9  _bwd_call       (_bwd_kernel)                          NCHW
// The function, per position j (NCHW: j = b*HW + p; NHWC: j = m) and
// output channel o, with the producer's batch mean/rstd and the BN's
// gamma/beta over input channels c:
//   xn[c, j] = act(((x[c, j] - mean) * rstd) * gamma + beta)   (apply_bn)
//            = act(x[c, j])                                     (raw input)
//   z[o, j]  = sum_c W[o, c] * xn[c, j],  W read [O, C] in both layouts
//   sum[o]   = sum_j (z - shift[o]),  sumsq[o] = sum_j (z - shift[o])^2
// with xn rounded to x's type before the product, every sum in float32,
// and z written in x's type.  The backward folds the stats' cotangents
// into dz (dz + dsum + 2 (z - shift) dsumsq, skipped without them),
// recomputes the prologue and returns dx (x's type), dW [O, C], dgamma and
// dbeta (float32).
//
// What bounds it on the H100: in float32, operations.  Every fused layer
// of ResNet-50 but one is 2*B*HW*C*O = 13.15 GFLOP at batch 128, 0.196 ms
// at the 67 TFLOP/s of the float32 units, against 0.02-0.05 ms for its
// bytes.  In bfloat16 the same products would be bound by bytes on the
// tensor cores; these kernels use the float32 units for both types.
//
// Design.  The TPU kernel walks a (batch, HW-block) grid in order, keeps W
// resident, and carries the stats (and, backward, dW) across grid steps.
// Hopper's blocks run in parallel in no order, so:
//  - One templated SIMT GEMM core: 128 x 128 tiles, k steps of 8, 256
//    threads each holding an 8 x 8 sub-tile in registers, double-buffered
//    shared tiles filled through registers.  The contraction's operands
//    are loaded by small loader structs that pick the thread layout under
//    which their global reads are coalesced (k-contiguous or
//    row-contiguous) and apply the prologue while staging into shared
//    memory.  NCHW's columns run over (b, p) together, so stage 4's
//    HW = 49 does not fragment the tile per image as the TPU's did.
//  - The prologue zeroes the columns (positions) and channels past the
//    edge as it stages x: relu(norm(0)) is not 0, so the padding would
//    otherwise leak into z and the stats.
//  - Forward epilogue: z in x's type, and each tile's per-row partial
//    sum(z - shift), sum((z - shift)^2) from the float32 accumulator into
//    a [2, tiles, O] scratch; a second pass adds the partials in a fixed
//    order.  No float atomics: a step is repeatable bit for bit.
//  - Backward, two GEMMs: (a) dx[c, j] = sum_o W[o, c] dz'[o, j] with the
//    fold in dz's staging and the BN backward (relu mask, dgamma/dbeta
//    partials per tile, dx = dylin * gamma * rstd) in the epilogue; (b)
//    dW[o, c] = sum_j dz'[o, j] xn[c, j], contracting over the positions
//    (401,408 in stage 1), split into chunks over grid.z with the partial
//    dW tiles added by the same fixed-order second pass.
// Simple and right first: no tensor cores, no TMA, no cp.async.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

using ptt::from_f;
using ptt::round_to;
using ptt::to_f;

constexpr int BM = 128;  // tile rows: output channels (forward, dW) or input channels (dx)
constexpr int BN = 128;  // tile columns: positions (forward, dx) or input channels (dW)
constexpr int BK = 8;    // contraction step
constexpr int LD = BM + 4;  // shared row stride: conflict-free k-contiguous stores
constexpr int NT = 256;  // threads a block: 16 x 16, each an 8 x 8 sub-tile;
                         // two blocks an SM (at most 128 registers a thread)

// The staging layout of one operand's 8 x 128 tile.  KC: the operand is
// contiguous along k, so 8 neighbouring threads read 8 neighbouring k of one
// row; otherwise 32 neighbouring threads read 32 neighbouring rows of one k.
template <bool KC>
__device__ __forceinline__ int map_k(int t) {
  return KC ? (t & 7) : (t >> 5);
}
template <bool KC>
__device__ __forceinline__ int map_i(int t, int r) {
  return (KC ? (t >> 3) : (t & 31)) + 32 * r;
}
template <bool KC>
__device__ __forceinline__ void stage(float* buf, const float v[4]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < 4; ++r) buf[map_k<KC>(t) * LD + map_i<KC>(t, r)] = v[r];
}

// Row (or column) of accumulator entry q of the thread at (ty, tx): two
// 4-wide strips 64 apart, so the 16 threads of a row read distinct float4s.
__device__ __forceinline__ int sub(int q, int t4) {
  return (q < 4 ? 0 : 64) + t4 * 4 + (q & 3);
}

// Position j -> offset of its channel 0 in an activation of `ch` channels;
// a channel is cstride() further.  NCHW: b*ch*HW + p; NHWC: j*ch.
template <bool NHWC>
struct Pos {
  int hw;
  __device__ __forceinline__ int64_t off(int64_t j, int ch) const {
    if (NHWC) return j * ch;
    const int64_t b = j / hw;
    return b * ch * (int64_t)hw + (j - b * hw);
  }
  __device__ __forceinline__ int64_t cstride() const { return NHWC ? 1 : hw; }
};

// The positions j, j + BK, j + 2 BK, ... one thread reads along a
// contraction over positions, walked without a division per step.
template <bool NHWC>
struct PosWalk {
  int64_t j, b;
  int p, hw;
  __device__ __forceinline__ void start(int64_t j0, int hw_) {
    j = j0;
    hw = hw_;
    if (!NHWC) {
      b = j0 / hw;
      p = (int)(j0 - b * hw);
    }
  }
  __device__ __forceinline__ int64_t off(int ch) const {
    return NHWC ? j * ch : b * ch * (int64_t)hw + p;
  }
  __device__ __forceinline__ void advance() {
    j += BK;
    if (!NHWC) {
      p += BK;
      while (p >= hw) {
        p -= hw;
        ++b;
      }
    }
  }
};

// act(norm(v)) as the TPU kernel computes it: ((v - mean) * rstd) * gamma + beta
__device__ __forceinline__ float bn_act(float v, float mu, float rs, float g,
                                        float b, bool apply, bool relu) {
  if (apply) v = (v - mu) * rs * g + b;
  return relu ? fmaxf(v, 0.f) : v;
}

// dz with the stats' cotangents folded in: d sum / dz = 1, d sumsq / dz =
// 2 (z - shift), the shift being the one the forward accumulated with
__device__ __forceinline__ float fold(float dz, float z, float ds, float dss,
                                      float sh) {
  return dz + ds + 2.f * (z - sh) * dss;
}

struct Bn {
  const float *mean, *rstd, *gamma, *beta;
  int apply, relu;
};

struct Fold {
  const float *dsum, *dsumsq, *shift;
  int on;
};

// ---------------------------------------------------------------------------
// the GEMM core: acc (this thread's 8 x 8) = sum over k in [k0, k1) of
// A(row, k) B(k, col) for the block's 128 x 128 tile
// ---------------------------------------------------------------------------

template <class LA, class LB>
__device__ __forceinline__ void gemm(LA& la, LB& lb, int64_t k0, int64_t k1,
                                     float acc[8][8]) {
  __shared__ __align__(16) float As[2][BK * LD];
  __shared__ __align__(16) float Bs[2][BK * LD];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (k0 >= k1) return;
  float va[4], vb[4];
  la.fetch(k0, va);
  lb.fetch(k0, vb);
  stage<LA::KC>(As[0], va);
  stage<LB::KC>(Bs[0], vb);
  __syncthreads();
  int cur = 0;
  for (int64_t k = k0; k < k1; k += BK) {
    const bool more = k + BK < k1;
    if (more) {
      la.fetch(k + BK, va);
      lb.fetch(k + BK, vb);
    }
    const float* a = As[cur];
    const float* b = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[8], rb[8];
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * LD + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * LD + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + kk * LD + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + kk * LD + 64 + tx * 4);
      ra[0] = a0.x; ra[1] = a0.y; ra[2] = a0.z; ra[3] = a0.w;
      ra[4] = a1.x; ra[5] = a1.y; ra[6] = a1.z; ra[7] = a1.w;
      rb[0] = b0.x; rb[1] = b0.y; rb[2] = b0.z; rb[3] = b0.w;
      rb[4] = b1.x; rb[5] = b1.y; rb[6] = b1.z; rb[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    if (more) {
      stage<LA::KC>(As[cur ^ 1], va);
      stage<LB::KC>(Bs[cur ^ 1], vb);
    }
    __syncthreads();
    cur ^= 1;
  }
}

// sum over the 16 threads of a half warp (the threads sharing tile rows)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// operand loaders
// ---------------------------------------------------------------------------

// A(o, c) = W[o, c]: rows o, contraction over c
template <typename T>
struct WByOut {
  static constexpr bool KC = true;
  const T* w;
  int64_t swo, swc;
  int O, C;
  int o[4];
  __device__ void init(int i0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[r] = i0 + map_i<KC>(threadIdx.x, r);
  }
  __device__ __forceinline__ void fetch(int64_t k0, float v[4]) {
    const int64_t c = k0 + map_k<KC>(threadIdx.x);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = (o[r] < O && c < C) ? to_f(w[o[r] * swo + c * swc]) : 0.f;
  }
};

// A(c, o) = W[o, c]: rows c, contraction over o (dx)
template <typename T>
struct WByIn {
  static constexpr bool KC = false;
  const T* w;
  int64_t swo, swc;
  int O, C;
  int c[4];
  __device__ void init(int i0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] = i0 + map_i<KC>(threadIdx.x, r);
  }
  __device__ __forceinline__ void fetch(int64_t k0, float v[4]) {
    const int64_t o = k0 + map_k<KC>(threadIdx.x);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = (c[r] < C && o < O) ? to_f(w[o * swo + c[r] * swc]) : 0.f;
  }
};

// B(c, j) = xn[c, j]: columns are positions, contraction over channels c
template <typename T, bool NHWC>
struct XnByPos {
  static constexpr bool KC = NHWC;
  const T* x;
  Pos<NHWC> pos;
  int C;
  int64_t N;
  Bn bn;
  int64_t off[4];
  bool ok[4];
  __device__ void init(int64_t j0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t j = j0 + map_i<KC>(threadIdx.x, r);
      ok[r] = j < N;
      off[r] = ok[r] ? pos.off(j, C) : 0;
    }
  }
  __device__ __forceinline__ void fetch(int64_t k0, float v[4]) {
    const int64_t c = k0 + map_k<KC>(threadIdx.x);
    const bool cok = c < C;
    float mu = 0.f, rs = 1.f, g = 1.f, b = 0.f;
    if (bn.apply && cok) {
      mu = bn.mean[c];
      rs = bn.rstd[c];
      g = bn.gamma[c];
      b = bn.beta[c];
    }
    const int64_t cs = c * pos.cstride();
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = (ok[r] && cok)
                 ? round_to<T>(bn_act(to_f(x[off[r] + cs]), mu, rs, g, b,
                                      bn.apply, bn.relu))
                 : 0.f;
  }
};

// B(o, j) = dz'[o, j]: columns are positions, contraction over o (dx)
template <typename T, bool NHWC>
struct DzByPos {
  static constexpr bool KC = NHWC;
  const T *dz, *z;
  Pos<NHWC> pos;
  int O;
  int64_t N;
  Fold fd;
  int64_t off[4];
  bool ok[4];
  __device__ void init(int64_t j0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t j = j0 + map_i<KC>(threadIdx.x, r);
      ok[r] = j < N;
      off[r] = ok[r] ? pos.off(j, O) : 0;
    }
  }
  __device__ __forceinline__ void fetch(int64_t k0, float v[4]) {
    const int64_t o = k0 + map_k<KC>(threadIdx.x);
    const bool ook = o < O;
    float ds = 0.f, dss = 0.f, sh = 0.f;
    if (fd.on && ook) {
      ds = fd.dsum[o];
      dss = fd.dsumsq[o];
      sh = fd.shift[o];
    }
    const int64_t os = o * pos.cstride();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float d = 0.f;
      if (ok[r] && ook) {
        d = to_f(dz[off[r] + os]);
        if (fd.on) d = fold(d, to_f(z[off[r] + os]), ds, dss, sh);
        d = round_to<T>(d);
      }
      v[r] = d;
    }
  }
};

// A(o, j) = dz'[o, j]: rows o, contraction over positions (dW)
template <typename T, bool NHWC>
struct DzByOut {
  static constexpr bool KC = !NHWC;
  const T *dz, *z;
  int O;
  int64_t N;
  Fold fd;
  int o[4];
  float ds[4], dss[4], sh[4];
  PosWalk<NHWC> walk;
  __device__ void init(int i0, int64_t kb, int hw) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      o[r] = i0 + map_i<KC>(threadIdx.x, r);
      const bool on = fd.on && o[r] < O;
      ds[r] = on ? fd.dsum[o[r]] : 0.f;
      dss[r] = on ? fd.dsumsq[o[r]] : 0.f;
      sh[r] = on ? fd.shift[o[r]] : 0.f;
    }
    walk.start(kb + map_k<KC>(threadIdx.x), hw);
  }
  __device__ __forceinline__ void fetch(int64_t, float v[4]) {
    const bool jok = walk.j < N;
    const int64_t base = jok ? walk.off(O) : 0;
    const int64_t os = NHWC ? 1 : walk.hw;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float d = 0.f;
      if (jok && o[r] < O) {
        const int64_t i = base + o[r] * os;
        d = to_f(dz[i]);
        if (fd.on) d = fold(d, to_f(z[i]), ds[r], dss[r], sh[r]);
        d = round_to<T>(d);
      }
      v[r] = d;
    }
    walk.advance();
  }
};

// B(j, c) = xn[c, j]: columns are input channels, contraction over
// positions (dW)
template <typename T, bool NHWC>
struct XnByIn {
  static constexpr bool KC = !NHWC;
  const T* x;
  int C;
  int64_t N;
  Bn bn;
  int c[4];
  float mu[4], rs[4], g[4], b[4];
  PosWalk<NHWC> walk;
  __device__ void init(int i0, int64_t kb, int hw) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      c[r] = i0 + map_i<KC>(threadIdx.x, r);
      const bool on = bn.apply && c[r] < C;
      mu[r] = on ? bn.mean[c[r]] : 0.f;
      rs[r] = on ? bn.rstd[c[r]] : 1.f;
      g[r] = on ? bn.gamma[c[r]] : 1.f;
      b[r] = on ? bn.beta[c[r]] : 0.f;
    }
    walk.start(kb + map_k<KC>(threadIdx.x), hw);
  }
  __device__ __forceinline__ void fetch(int64_t, float v[4]) {
    const bool jok = walk.j < N;
    const int64_t base = jok ? walk.off(C) : 0;
    const int64_t cs = NHWC ? 1 : walk.hw;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = (jok && c[r] < C)
                 ? round_to<T>(bn_act(to_f(x[base + c[r] * cs]), mu[r], rs[r],
                                      g[r], b[r], bn.apply, bn.relu))
                 : 0.f;
    walk.advance();
  }
};

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// forward: grid (position tiles, output-channel tiles)
template <typename T, bool NHWC>
__global__ void __launch_bounds__(NT, 2)
conv_bn_fwd(const T* __restrict__ x, const T* __restrict__ w, int64_t swo,
            int64_t swc, Bn bn, const float* __restrict__ shift,
            T* __restrict__ z, float* __restrict__ part, int64_t N, int hw,
            int C, int O, int with_stats) {
  const int64_t j0 = (int64_t)blockIdx.x * BN;
  const int i0 = blockIdx.y * BM;
  const Pos<NHWC> pos{hw};
  WByOut<T> la{w, swo, swc, O, C};
  la.init(i0);
  XnByPos<T, NHWC> lb{x, pos, C, N, bn};
  lb.init(j0);
  float acc[8][8];
  gemm(la, lb, 0, C, acc);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int64_t zoff[8];
  bool jok[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int64_t j = j0 + sub(q, tx);
    jok[q] = j < N;
    zoff[q] = jok[q] ? pos.off(j, O) : 0;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int o = i0 + sub(r, ty);
    const bool ook = o < O;
    const float sh = (with_stats && ook) ? shift[o] : 0.f;
    const int64_t os = (int64_t)o * pos.cstride();
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (ook && jok[q]) {
        z[zoff[q] + os] = from_f<T>(acc[r][q]);
        const float d = acc[r][q] - sh;
        s += d;
        ss = fmaf(d, d, ss);
      }
    }
    if (with_stats) {
      s = row_sum(s);
      ss = row_sum(ss);
      if (tx == 0 && ook) {
        part[(int64_t)blockIdx.x * O + o] = s;
        part[((int64_t)gridDim.x + blockIdx.x) * O + o] = ss;
      }
    }
  }
}

// backward (a): dx; grid (position tiles, input-channel tiles)
template <typename T, bool NHWC>
__global__ void __launch_bounds__(NT, 2)
conv_bn_bwd_dx(const T* __restrict__ x, const T* __restrict__ w, int64_t swo,
               int64_t swc, const T* __restrict__ z, const T* __restrict__ dz,
               Fold fd, Bn bn, T* __restrict__ dx, float* __restrict__ part,
               int64_t N, int hw, int C, int O) {
  const int64_t j0 = (int64_t)blockIdx.x * BN;
  const int i0 = blockIdx.y * BM;
  const Pos<NHWC> pos{hw};
  WByIn<T> la{w, swo, swc, O, C};
  la.init(i0);
  DzByPos<T, NHWC> lb{dz, z, pos, O, N, fd};
  lb.init(j0);
  float acc[8][8];
  gemm(la, lb, 0, O, acc);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int64_t xoff[8];
  bool jok[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int64_t j = j0 + sub(q, tx);
    jok[q] = j < N;
    xoff[q] = jok[q] ? pos.off(j, C) : 0;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int c = i0 + sub(r, ty);
    const bool cok = c < C;
    float mu = 0.f, rs = 1.f, g = 1.f, b = 0.f;
    if (bn.apply && cok) {
      mu = bn.mean[c];
      rs = bn.rstd[c];
      g = bn.gamma[c];
      b = bn.beta[c];
    }
    const float grs = g * rs;
    const int64_t cs = (int64_t)c * pos.cstride();
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (cok && jok[q]) {
        const int64_t i = xoff[q] + cs;
        const float xv = to_f(x[i]);
        const float d = acc[r][q];
        float dxv;
        if (bn.apply) {
          const float pre = (xv - mu) * rs;
          const float ylin = pre * g + b;
          const float dyl = (bn.relu && !(ylin > 0.f)) ? 0.f : d;
          sg = fmaf(dyl, pre, sg);
          sb += dyl;
          dxv = dyl * grs;
        } else {
          dxv = (bn.relu && !(xv > 0.f)) ? 0.f : d;
        }
        dx[i] = from_f<T>(dxv);
      }
    }
    if (bn.apply) {
      sg = row_sum(sg);
      sb = row_sum(sb);
      if (tx == 0 && cok) {
        part[(int64_t)blockIdx.x * C + c] = sg;
        part[((int64_t)gridDim.x + blockIdx.x) * C + c] = sb;
      }
    }
  }
}

// backward (b): dW, the positions split into chunks over grid.z; grid
// (input-channel tiles, output-channel tiles, chunks).  Chunk z writes
// out[z] (float32 [O, C]).
template <typename T, bool NHWC>
__global__ void __launch_bounds__(NT, 2)
conv_bn_bwd_dw(const T* __restrict__ x, const T* __restrict__ z,
               const T* __restrict__ dz, Fold fd, Bn bn, float* __restrict__ out,
               int64_t N, int hw, int C, int O, int64_t chunk) {
  const int c0 = blockIdx.x * BN;
  const int i0 = blockIdx.y * BM;
  const int64_t kb = (int64_t)blockIdx.z * chunk;
  const int64_t ke = kb + chunk < N ? kb + chunk : N;
  DzByOut<T, NHWC> la{dz, z, O, N, fd};
  la.init(i0, kb, hw);
  XnByIn<T, NHWC> lb{x, C, N, bn};
  lb.init(c0, kb, hw);
  float acc[8][8];
  gemm(la, lb, kb, ke, acc);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* o_out = out + (int64_t)blockIdx.z * O * C;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int o = i0 + sub(r, ty);
    if (o >= O) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = c0 + sub(q, tx);
      if (c < C) o_out[(int64_t)o * C + c] = acc[r][q];
    }
  }
}

// out[s, w] = sum over i of part[s, i, w], i in order 0..rows-1 split over
// the 8 warps of a block and added warp by warp: the same bits every run.
// grid (ceil(width / 32), sets)
__global__ void __launch_bounds__(NT)
sum_rows(const float* __restrict__ part, int64_t rows, int64_t width,
         float* __restrict__ out) {
  __shared__ float red[NT / 32][33];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int64_t wcol = (int64_t)blockIdx.x * 32 + lane;
  const float* p = part + (int64_t)blockIdx.y * rows * width;
  float a = 0.f;
  if (wcol < width)
    for (int64_t i = wi; i < rows; i += NT / 32) a += p[i * width + wcol];
  red[wi][lane] = a;
  __syncthreads();
  if (wi == 0 && wcol < width) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NT / 32; ++q) s += red[q][lane];
    out[(int64_t)blockIdx.y * width + wcol] = s;
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T, bool NHWC>
int fwd(const void* x, const void* w, int64_t swo, int64_t swc, Bn bn,
        const float* shift, void* z, float* part, float* stats, int64_t N,
        int hw, int C, int O, int with_stats, cudaStream_t st) {
  const dim3 grid((unsigned)cdiv(N, BN), (unsigned)cdiv(O, BM));
  conv_bn_fwd<T, NHWC><<<grid, NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), swo, swc, bn, shift,
      static_cast<T*>(z), part, N, hw, C, O, with_stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !with_stats) return (int)err;
  sum_rows<<<dim3((unsigned)cdiv(O, 32), 2), NT, 0, st>>>(part, grid.x, O, stats);
  return (int)cudaGetLastError();
}

template <typename T, bool NHWC>
int bwd(const void* x, const void* w, int64_t swo, int64_t swc, const void* z,
        const void* dz, Fold fd, Bn bn, void* dx, float* dw, float* dw_part,
        float* g_part, float* dgb, int64_t N, int hw, int C, int O,
        int splits, int64_t chunk, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* zt = static_cast<const T*>(z);
  const T* dzt = static_cast<const T*>(dz);
  const dim3 gx((unsigned)cdiv(N, BN), (unsigned)cdiv(C, BM));
  conv_bn_bwd_dx<T, NHWC><<<gx, NT, 0, st>>>(
      xt, static_cast<const T*>(w), swo, swc, zt, dzt, fd, bn,
      static_cast<T*>(dx), g_part, N, hw, C, O);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (bn.apply) {
    sum_rows<<<dim3((unsigned)cdiv(C, 32), 2), NT, 0, st>>>(g_part, gx.x, C, dgb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const dim3 gw((unsigned)cdiv(C, BN), (unsigned)cdiv(O, BM), (unsigned)splits);
  conv_bn_bwd_dw<T, NHWC><<<gw, NT, 0, st>>>(xt, zt, dzt, fd, bn,
                                            splits > 1 ? dw_part : dw, N, hw,
                                            C, O, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return (int)err;
  sum_rows<<<dim3((unsigned)cdiv((int64_t)O * C, 32), 1), NT, 0, st>>>(
      dw_part, splits, (int64_t)O * C, dw);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward.  x [B, C, HW] contiguous, N = B*HW, hw = HW.  w [O, C] of x's
// dtype with element strides (swo, swc).  mean/rstd/gamma/beta float32 [C] (read only with
// apply_bn), shift float32 [O] (read only with with_stats).  z like x with
// O channels; part a float32 scratch of 2 * ceil(N / 128) * O; stats float32
// [2, O] (sum, sumsq), written only with with_stats.  Returns the CUDA error
// of the launches (0 = launched).
extern "C" int ptt_conv_bn_fwd(const void* x, const void* w, long long swo,
                               long long swc, const void* mean,
                               const void* rstd, const void* gamma,
                               const void* beta, const void* shift, void* z,
                               void* part, void* stats, long long N, int hw,
                               int C, int O, int apply_bn, int relu,
                               int with_stats, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || C <= 0 || O <= 0 || hw <= 0) return (int)cudaErrorInvalidValue;
  const Bn bn{static_cast<const float*>(mean), static_cast<const float*>(rstd),
              static_cast<const float*>(gamma), static_cast<const float*>(beta),
              apply_bn, relu};
  const float* sh = static_cast<const float*>(shift);
  float* pt = static_cast<float*>(part);
  float* sv = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return fwd<float, false>(x, w, swo, swc, bn, sh, z, pt, sv, N, hw, C, O, with_stats, st);
  if (dtype == ptt::kBFloat16)
    return fwd<__nv_bfloat16, false>(x, w, swo, swc, bn, sh, z, pt, sv, N, hw, C, O, with_stats, st);
  return (int)cudaErrorInvalidValue;
}

// Backward.  x, w and the BN vectors as in ptt_conv_bn_fwd; z
// and dz like the forward's z (z read only with with_stats); dsum/dsumsq/
// shift float32 [O] (read only with with_stats).  dx like x; dw float32
// [O, C]; dw_part a float32 scratch of splits * O * C (unused when splits is
// 1); g_part a float32 scratch of 2 * ceil(N / 128) * C and dgb float32
// [2, C] (dgamma, dbeta), both only with apply_bn.  Chunk z of the dW
// contraction covers positions [z * chunk, (z + 1) * chunk); chunk is a
// multiple of 8 and splits * chunk >= N.
extern "C" int ptt_conv_bn_bwd(const void* x, const void* w, long long swo,
                               long long swc, const void* z, const void* dz,
                               const void* dsum, const void* dsumsq,
                               const void* mean, const void* rstd,
                               const void* gamma, const void* beta,
                               const void* shift, void* dx, void* dw,
                               void* dw_part, void* g_part, void* dgb,
                               long long N, int hw, int C, int O,
                               int apply_bn, int relu, int with_stats,
                               int splits, long long chunk, int dtype,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || C <= 0 || O <= 0 || hw <= 0 || splits < 1 ||
      splits > 65535 || chunk <= 0 || chunk % BK || (long long)splits * chunk < N)
    return (int)cudaErrorInvalidValue;
  const Bn bn{static_cast<const float*>(mean), static_cast<const float*>(rstd),
              static_cast<const float*>(gamma), static_cast<const float*>(beta),
              apply_bn, relu};
  const Fold fd{static_cast<const float*>(dsum), static_cast<const float*>(dsumsq),
                static_cast<const float*>(shift), with_stats};
  float* dwv = static_cast<float*>(dw);
  float* dwp = static_cast<float*>(dw_part);
  float* gp = static_cast<float*>(g_part);
  float* gb = static_cast<float*>(dgb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return bwd<float, false>(x, w, swo, swc, z, dz, fd, bn, dx, dwv, dwp, gp, gb, N, hw, C, O, splits, chunk, st);
  if (dtype == ptt::kBFloat16)
    return bwd<__nv_bfloat16, false>(x, w, swo, swc, z, dz, fd, bn, dx, dwv, dwp, gp, gb, N, hw, C, O, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
}
