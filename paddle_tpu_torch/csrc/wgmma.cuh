// What the tensor-core conv+BN kernels share (conv_bn.cu, NCHW #8/#9, and
// conv_bn_nhwc.cu, NHWC #10/#11): cp.async, TF32 rounding, the 128-byte
// swizzle and its wgmma descriptor, the wgmma wrappers, 16-byte packing,
// the BN prologue and stats fold, the accumulator's staging, and the
// fixed-order second pass (sum_rows).  The flash-attention kernels (#1,
// #2, through attention.cuh) take its cp.async, TF32 rounding, packing and
// mma.sync wrappers; quant_matmul.cu (#7) the same; layer_norm_bwd.cu (#4)
// its packing.
//
// Tiles: 128 x 128, 512 threads in four warpgroups of 64 x 64 each; a k
// tile is one 128-byte swizzle span a row (32 float32 or 64 bfloat16).
// float32 products are three TF32 passes of a hi/lo split of each operand,
// hi = tf32(v) (cvt.rna), lo = tf32(v - hi), summed small terms first:
//   acc += A_lo B_hi + A_hi B_lo + A_hi B_hi
// bfloat16 takes one pass.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

constexpr int BM = 128;                       // tile rows
constexpr int BN = 128;                       // tile columns (operand B's rows)
constexpr int NT = 512;                       // threads: four warpgroups, each a
                                              // 64 x 64 quarter of the tile
constexpr int RT = 256;                       // threads of the second pass
constexpr int ROW_BYTES = 128;                // a k tile's row: one swizzle span
constexpr int TILE_BYTES = BM * ROW_BYTES;    // one operand tile, 16 KB
constexpr int CHUNKS = TILE_BYTES / 16 / NT;  // 16-byte chunks a thread moves a tile
constexpr int LDS = BN + 8;                   // staged accumulator row (floats):
                                              // conflict-free float2 stores
constexpr int SMEM_MAX = 232448;              // dynamic shared memory a block

// the k tile and the element chunks of an operand type
template <typename T>
struct Elem {
  static constexpr int EPC = 16 / (int)sizeof(T);        // elements a chunk
  static constexpr int BK = ROW_BYTES / (int)sizeof(T);  // k tile
  static constexpr bool SPLIT = sizeof(T) == 4;          // hi/lo TF32 tiles
  static constexpr int OP_BYTES = (SPLIT ? 2 : 1) * TILE_BYTES;  // one operand
};

struct Bn {
  const float *mean, *rstd, *gamma, *beta;
  int apply, relu;
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

// ---------------------------------------------------------------------------
// PTX: cp.async, TF32 rounding, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// 16 bytes to shared memory, of which the first `bytes` from src, the rest 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// N = 4 or 8 bytes, all from src or (bytes 0) all zero
template <int N>
__device__ __forceinline__ void cp_async_small(uint32_t dst, const void* src,
                                               int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(N), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// round to TF32 (10 mantissa bits), to nearest, ties away from zero, as
// cvt.rna.tf32.f32 does for finite values: half a TF32 ulp added to the
// magnitude's bits, the low 13 cleared (two integer instructions)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// descriptor of a K-major tile with the 128-byte swizzle: rows of 128
// bytes in 8-row atoms of 1024 bytes (stride byte offset), the atom
// 1024-aligned; a k step inside the atom moves the start address
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of 16-byte chunk j of row r in such a tile
__host__ __device__ __forceinline__ int swz(int r, int j) {
  return r * ROW_BYTES + ((j ^ (r & 7)) << 4);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads across the waits
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PTT_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define PTT_ACC8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PTT_ACC32 PTT_ACC8(0), PTT_ACC8(8), PTT_ACC8(16), PTT_ACC8(24)

// d[64 x 64] += A[64 x 8] B[64 x 8]^T, TF32 operands in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PTT_REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : PTT_ACC32
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[64 x 16]^T, bfloat16 operands, both K-major
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PTT_ACC32
      : "l"(a), "l"(b), "r"(1));
}

// one k tile of the product: A's tile at shared address a (float32: hi,
// then lo TILE_BYTES on), B's at b; warpgroup g takes A's rows 64 (g % 2)
// .. + 63 and B's 64 (g / 2) ..
template <typename T>
__device__ __forceinline__ void mma_tiles(uint32_t a, uint32_t b,
                                          float (&d)[32]) {
  const int g = threadIdx.x >> 7;
  a += (g & 1) * (64 * ROW_BYTES);
  b += (g >> 1) * (64 * ROW_BYTES);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t o = s * 32;  // 32 bytes: k8 of TF32, k16 of bf16
    if constexpr (Elem<T>::SPLIT) {
      wgmma_tf32(d, desc(a + TILE_BYTES + o), desc(b + o));
      wgmma_tf32(d, desc(a + o), desc(b + TILE_BYTES + o));
      wgmma_tf32(d, desc(a + o), desc(b + o));
    } else {
      wgmma_bf16(d, desc(a + o), desc(b + o));
    }
  }
}

// ---------------------------------------------------------------------------
// mma.sync: the warp-level products of flash_attention_fwd.cu / _bwd.cu
// (TF32, bfloat16) and quant_matmul.cu (TF32, bfloat16, float16, int8)
// ---------------------------------------------------------------------------

// mma.sync without volatile: the compiler may interleave independent
// products (the three passes of another column tile, another product)
// between two that add into one accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8 x int8 into int32, exact in any order: A 16 x 32 (4 k a register),
// B 32 x 8
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// 16 bytes <-> EPC floats: 4 float32, or 8 bfloat16 (a bfloat16 is the
// high half of its float32; packing rounds to nearest even)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void unpack(uint4 q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(uint4 q, float (&v)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// write chunk j of row r into the swizzled tile(s): float32 as hi and lo
// TF32, bfloat16 as it is
template <typename T>
__device__ __forceinline__ void write_chunk(const float (&v)[Elem<T>::EPC],
                                            uint8_t* hi, uint8_t* lo, int r,
                                            int j) {
  const int off = swz(r, j);
  if constexpr (Elem<T>::SPLIT) {
    uint4 h, l;
    h.x = tf32(v[0]);
    h.y = tf32(v[1]);
    h.z = tf32(v[2]);
    h.w = tf32(v[3]);
    l.x = tf32(v[0] - __uint_as_float(h.x));
    l.y = tf32(v[1] - __uint_as_float(h.y));
    l.z = tf32(v[2] - __uint_as_float(h.z));
    l.w = tf32(v[3] - __uint_as_float(h.w));
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  } else {
    *reinterpret_cast<uint4*>(hi + off) = pack(v);
  }
}

// the accumulator into shared memory, S[row][col] float32 (row stride LDS),
// from the wgmma layout: warp w of warpgroup g holds rows 64 (g % 2) + 16 w
// + lane / 4 (+ 8), columns 64 (g / 2) + 8 i + 2 (lane % 4) (+ 1)
__device__ __forceinline__ float* stage_acc(const float (&acc)[32],
                                            uint8_t* sm) {
  float* S = reinterpret_cast<float*>(sm);
  const int l = threadIdx.x & 31, g = threadIdx.x >> 7;
  const int row = (g & 1) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (l >> 2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = (g >> 1) * 64 + 8 * i + 2 * (l & 3);
    *reinterpret_cast<float2*>(S + row * LDS + col) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(S + (row + 8) * LDS + col) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  return S;
}

// EPC float32 of a staged row
template <int EPC>
__device__ __forceinline__ void load_staged(const float* p, float (&v)[EPC]) {
#pragma unroll
  for (int e = 0; e < EPC; e += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + e);
    v[e] = f.x;
    v[e + 1] = f.y;
    v[e + 2] = f.z;
    v[e + 3] = f.w;
  }
}

// out[s, w] = sum over i of part[s, i, w], i in order 0..rows-1 split over
// the 8 warps of a block and added warp by warp: the same bits every run.
// grid (ceil(width / 32), sets)
__global__ void __launch_bounds__(RT)
sum_rows(const float* __restrict__ part, int64_t rows, int64_t width,
         float* __restrict__ out) {
  __shared__ float red[RT / 32][33];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int64_t wcol = (int64_t)blockIdx.x * 32 + lane;
  const float* p = part + (int64_t)blockIdx.y * rows * width;
  float a = 0.f;
  if (wcol < width)
    for (int64_t i = wi; i < rows; i += RT / 32) a += p[i * width + wcol];
  red[wi][lane] = a;
  __syncthreads();
  if (wi == 0 && wcol < width) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < RT / 32; ++q) s += red[q][lane];
    out[(int64_t)blockIdx.y * width + wcol] = s;
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
