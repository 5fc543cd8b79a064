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
// Forward design: each row is read from device memory once and written
// once, as the TPU kernel does with its VMEM block.  A row is cut into
// 16-byte chunks on 16-byte addresses (the first and last chunk of a row
// whose start is not 16-byte aligned are partial: a scalar head and tail)
// and spread over a thread block cluster of `cluster` blocks of 256
// threads; each thread keeps up to 32 values in registers (8 float4 chunks,
// or 4 chunks of 8 bf16), and an SM holds four blocks.  A block takes its slice's max, then exp(x - m)
// in place and its sum, the sum of x, and the label's logit where its slice
// holds it; the cluster's partials meet in distributed shared memory and
// are combined in rank order (the same bits every launch), and each block
// writes its slice, exp(x - m) exp(m - M) / S, with 16-byte stores.  One
// exp an element, no branch on the data.  Where every row starts on 16 bytes
// and is whole chunks (C * itemsize a multiple of 16, as at the
// Transformer's and machine translation's vocabularies), the kernel is
// compiled without the head, tail and column checks.  For few rows a row
// takes more blocks, so that more SMs take part: the wrapper plans the
// cluster and the chunks a thread (``softmax_xent._fwd_plan``), and the
// launch refuses a plan whose registers do not hold the row.  A row too wide
// for 8 blocks of registers (more than 64K values) takes the streaming path: one
// block a row, a pass that keeps a running max and sum (a rescale per
// chunk, not per element) and a second pass that reads the row again and
// writes the softmax, both with 16-byte accesses.  Backward without dsm:
// one pass, softmax in, dlogits out; with dsm, a first pass sums dsm
// softmax.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"

namespace cg = cooperative_groups;

namespace {

using ptt::from_f;
using ptt::to_f;
using ptt::warp_sum;

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kValues = 32;      // row values a thread keeps in registers
// blocks an SM holds (at most 64 registers a thread, not the 80 the
// compiler takes unbounded): a block waits on its loads, then computes, then
// stores, and the more blocks an SM holds the more of them keep loads in
// flight while another computes
constexpr int kBlocksPerSM = 4;

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

// barrier.cluster in two halves: arrive once this block has read the other
// blocks' shared memory, wait before it exits
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes at a 16-byte aligned p as floats, loaded and stored with the
// streaming hint (each logit is read once; the softmax is read again only by
// the backward, after the whole step's forward)
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&b);
  }
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}

// A row's chunks: chunk q holds the row's columns [q VE - h, (q + 1) VE - h)
// within [0, C), where h is how many elements the row starts after a
// 16-byte boundary; it is whole (one 16-byte access) unless it is the
// row's misaligned head or tail.  A: every row of the launch starts on 16
// bytes and is whole chunks, and the softmax is aligned as the logits (no
// head, no tail, no column checks).
template <typename T, bool A = false>
struct Row {
  static constexpr int VE = 16 / sizeof(T);
  const T* x;
  int C, h, Q;
  __device__ __forceinline__ Row(const T* xr, int C_) : x(xr), C(C_) {
    h = A ? 0 : (int)(((uintptr_t)xr & 15) / sizeof(T));
    Q = (C + h + VE - 1) / VE;
  }
  __device__ __forceinline__ int col(int q) const { return q * VE - h; }
  __device__ __forceinline__ bool whole(int q) const {
    return A || (col(q) >= 0 && col(q) + VE <= C);
  }
  // the chunk's values; columns outside the row read as -inf
  __device__ __forceinline__ void load(int q, float (&v)[VE]) const {
    const int c0 = col(q);
    if (whole(q)) {
      load16(x + c0, v);
    } else {
#pragma unroll
      for (int i = 0; i < VE; ++i)
        v[i] = (c0 + i >= 0 && c0 + i < C) ? to_f(x[c0 + i]) : -INFINITY;
    }
  }
  // the sum of the chunk's values inside the row, in column order
  __device__ __forceinline__ float sum(int q, const float (&v)[VE]) const {
    const int c0 = col(q);
    float t = 0.f;
    if (whole(q)) {
#pragma unroll
      for (int i = 0; i < VE; ++i) t += v[i];
    } else {
#pragma unroll
      for (int i = 0; i < VE; ++i)
        if (c0 + i >= 0 && c0 + i < C) t += v[i];
    }
    return t;
  }
  // write the chunk's values inside the row to out (a row laid out like
  // x's); 16 bytes at once where out is aligned as x is
  __device__ __forceinline__ void store(int q, const float (&o)[VE], T* out,
                                        bool vec) const {
    const int c0 = col(q);
    if (A || (vec && whole(q))) {
      store16(out + c0, o);
    } else {
#pragma unroll
      for (int i = 0; i < VE; ++i)
        if (c0 + i >= 0 && c0 + i < C) out[c0 + i] = from_f<T>(o[i]);
    }
  }
};

template <typename T>
__device__ __forceinline__ void write_loss(T* loss, int row, float M, float S,
                                           float SX, float picked, int C,
                                           float eps) {
  const float log_z = M + logf(S);
  float l = log_z - picked;
  if (eps != 0.f) l = (1.f - eps) * l + eps * (log_z - SX / C);
  loss[row] = from_f<T>(l);
}

// the streaming path: one block a row, two passes over it
template <typename T>
__device__ __forceinline__ void fwd_stream(const T* __restrict__ logits,
                                           const long long* __restrict__ label,
                                           T* __restrict__ loss,
                                           T* __restrict__ softmax, int C,
                                           float eps, bool vec) {
  constexpr int VE = Row<T>::VE;
  __shared__ float red_m[NW], red_s[NW], red[NW];
  const int row = blockIdx.x;
  const Row<T> r(logits + (size_t)row * C, C);
  float m = -INFINITY, s = 0.f, sx = 0.f;
#pragma unroll 2
  for (int q = threadIdx.x; q < r.Q; q += NT) {
    float v[VE];
    r.load(q, v);
    sx += r.sum(q, v);
    float cm = -INFINITY;
#pragma unroll
    for (int i = 0; i < VE; ++i) cm = fmaxf(cm, v[i]);
    if (cm > m) {
      s *= expf(m - cm);
      m = cm;
    }
#pragma unroll
    for (int i = 0; i < VE; ++i) s += expf(v[i] - m);
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
    const long long lbl = label[row];
    const float picked = (lbl >= 0 && lbl < C) ? to_f(r.x[lbl]) : 0.f;
    write_loss(loss, row, m, s, sx, picked, C, eps);
  }
  const float inv_s = 1.f / s;
  T* out = softmax + (size_t)row * C;
#pragma unroll 2
  for (int q = threadIdx.x; q < r.Q; q += NT) {
    float v[VE];
    r.load(q, v);
#pragma unroll
    for (int i = 0; i < VE; ++i) v[i] = expf(v[i] - m) * inv_s;
    r.store(q, v, out, vec);
  }
}

// Kernel #5.  NCH: 16-byte chunks a thread keeps (0: the streaming path);
// blocks [row cluster, (row + 1) cluster) form a row's cluster, rank
// blockIdx.x % cluster taking the rank-th share of the row's chunks.  vec:
// the softmax is aligned as the logits are (16-byte stores).  A: as Row's.
template <typename T, int NCH, bool A>
__global__ void __launch_bounds__(NT, kBlocksPerSM)
softmax_xent_fwd_kernel(const T* __restrict__ logits,
                        const long long* __restrict__ label, T* __restrict__ loss,
                        T* __restrict__ softmax, int C, float eps, int cluster,
                        int vec) {
  if constexpr (NCH == 0) {
    fwd_stream<T>(logits, label, loss, softmax, C, eps, vec != 0);
  } else {
    constexpr int VE = Row<T>::VE;
    __shared__ float red_m[NW], red[3][NW];
    __shared__ float part[4];  // this rank's max, sum of exp, sum of x, label logit
    const int row = blockIdx.x / cluster, rank = blockIdx.x % cluster;
    const Row<T, A> r(logits + (size_t)row * C, C);
    const int per = (r.Q + cluster - 1) / cluster;
    const int q0 = min(rank * per, r.Q), q1 = min(q0 + per, r.Q);
    const long long lbl = label[row];

    float v[NCH][VE];
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int q = q0 + j * NT + (int)threadIdx.x;
      if (q < q1) {
        r.load(q, v[j]);
      } else {
#pragma unroll
        for (int i = 0; i < VE; ++i) v[j][i] = -INFINITY;
      }
    }
    // the label's chunk and place in it (-1: outside the row, picks 0)
    const bool in_row = lbl >= 0 && lbl < C;
    const int ql = in_row ? (int)((lbl + r.h) / VE) : -1;
    const int il = in_row ? (int)((lbl + r.h) % VE) : 0;
    float m = -INFINITY, sx = 0.f, picked = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int q = q0 + j * NT + (int)threadIdx.x;
      if (q < q1) {
        sx += r.sum(q, v[j]);
        if (q == ql) {
#pragma unroll
          for (int i = 0; i < VE; ++i)
            if (i == il) picked = v[j][i];
        }
      }
#pragma unroll
      for (int i = 0; i < VE; ++i) m = fmaxf(m, v[j][i]);
    }
    // the block's max (exact in any order)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) red_m[warp] = m;
    __syncthreads();
    m = red_m[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, red_m[w]);
    const float mref = m == -INFINITY ? 0.f : m;  // an empty slice
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        v[j][i] = expf(v[j][i] - mref);
        s += v[j][i];
      }
    // the block's sums, warps in order
    s = warp_sum(s);
    sx = warp_sum(sx);
    picked = warp_sum(picked);
    if (lane == 0) {
      red[0][warp] = s;
      red[1][warp] = sx;
      red[2][warp] = picked;
    }
    __syncthreads();
    s = sx = picked = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      s += red[0][w];
      sx += red[1][w];
      picked += red[2][w];
    }
    float M = m, S = s, SX = sx, P = picked;
    if (cluster > 1) {
      if (threadIdx.x == 0) {
        part[0] = m;
        part[1] = s;
        part[2] = sx;
        part[3] = picked;
      }
      cg::cluster_group cl = cg::this_cluster();
      float* const own = part;
      cl.sync();
      M = -INFINITY;
#pragma unroll
      for (int x = 0; x < kMaxCluster; ++x)
        if (x < cluster) M = fmaxf(M, cl.map_shared_rank(own, x)[0]);
      S = SX = P = 0.f;
#pragma unroll
      for (int x = 0; x < kMaxCluster; ++x)
        if (x < cluster) {
          const float* px = cl.map_shared_rank(own, x);
          S += px[1] * expf(px[0] - M);
          SX += px[2];
          P += px[3];
        }
      cluster_arrive();
    }
    if (rank == 0 && threadIdx.x == 0)
      write_loss(loss, row, M, S, SX, P, C, eps);
    const float scale = expf(m - M) / S;
    T* out = softmax + (size_t)row * C;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int q = q0 + j * NT + (int)threadIdx.x;
      if (q < q1) {
        float o[VE];
#pragma unroll
        for (int i = 0; i < VE; ++i) o[i] = v[j][i] * scale;
        r.store(q, o, out, vec != 0);
      }
    }
    if (cluster > 1) cluster_wait();  // the others have read `part`
  }
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

// plan: `cluster` blocks a row and `chunks` 16-byte chunks a thread, or
// (0, 0) for the streaming path; refused unless the cluster's registers
// hold a row's chunks (a misaligned start adds one)
template <typename T>
int launch_fwd(const void* logits, const long long* label, void* loss,
               void* softmax, int N, int C, float eps, int plan_cluster,
               int chunks, cudaStream_t stream) {
  constexpr int VE = Row<T>::VE;
  const long qmax = ((long)C + 2 * VE - 2) / VE;
  if (chunks == 0 ? plan_cluster != 0
                  : plan_cluster < 1 || plan_cluster > kMaxCluster ||
                        chunks * VE > kValues ||
                        (long)NT * chunks * plan_cluster < qmax)
    return (int)cudaErrorInvalidValue;
  const int cluster = chunks == 0 ? 1 : plan_cluster;
  const int vec = (((uintptr_t)softmax - (uintptr_t)logits) & 15) == 0;
  const bool aligned = vec && ((uintptr_t)logits & 15) == 0 &&
                       (C * sizeof(T)) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)N * cluster);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const T* x = static_cast<const T*>(logits);
  T* ls = static_cast<T*>(loss);
  T* sm = static_cast<T*>(softmax);
  auto go = [&](auto kern) {
    return cudaLaunchKernelEx(&cfg, kern, x, label, ls, sm, C, eps, cluster,
                              vec);
  };
  auto go2 = [&](auto whole, auto part) { return go(aligned ? whole : part); };
  cudaError_t err;
  switch (chunks) {
    case 0: err = go(softmax_xent_fwd_kernel<T, 0, false>); break;
    case 1:
      err = go2(softmax_xent_fwd_kernel<T, 1, true>,
                softmax_xent_fwd_kernel<T, 1, false>);
      break;
    case 2:
      err = go2(softmax_xent_fwd_kernel<T, 2, true>,
                softmax_xent_fwd_kernel<T, 2, false>);
      break;
    case 4:
      err = go2(softmax_xent_fwd_kernel<T, 4, true>,
                softmax_xent_fwd_kernel<T, 4, false>);
      break;
    case 8:
      if constexpr (kValues / VE >= 8)
        err = go2(softmax_xent_fwd_kernel<T, 8, true>,
                  softmax_xent_fwd_kernel<T, 8, false>);
      else
        err = cudaErrorInvalidValue;
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
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
// and softmax [N, C] of logits' dtype; the plan as launch_fwd's.  Returns the
// CUDA error of the launch.
extern "C" int ptt_softmax_xent_fwd(const void* logits, const void* label,
                                    void* loss, void* softmax, int N, int C,
                                    float eps, int dtype, int cluster,
                                    int chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long* lb = static_cast<const long long*>(label);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_fwd<float>(logits, lb, loss, softmax, N, C, eps, cluster,
                             chunks, st);
  if (dtype == ptt::kBFloat16)
    return launch_fwd<__nv_bfloat16>(logits, lb, loss, softmax, N, C, eps,
                                     cluster, chunks, st);
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
