// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cuh): the masking constant, 16-bit conversions, cp.async,
// ldmatrix and the m16n8k16 tensor-core product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as the plain cast
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 16-bit matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  .trans hands each thread a column pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two f32 values as one register of two 16-bit values (lo = lower index).
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two 16-bit values of one register as f32 (x = lower index).
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t w);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t w) {
  return __half22float2(*reinterpret_cast<__half2*>(&w));
}

// c += a.b on the tensor cores: m16n8k16, row-major A, column-major B, f32 C.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, __nv_bfloat16*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, __half*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Columns i * N .. i * N + N - 1 of an accumulator array, as an array of
// their own (the operand of one product of width N).
template <int N, int M>
__device__ __forceinline__ float (&cols(float (&a)[M], int i))[N] {
  static_assert(M % N == 0, "whole chunks only");
  return *reinterpret_cast<float(*)[N]>(a + i * N);
}

// The element mask of every flash kernel, the forward's: key kp is visible
// to query qp when it exists, is not in the future (causal) and lies inside
// the window (0 <= qp - kp < window).
__device__ __forceinline__ bool visible(int qp, int kp, int Lk, int causal, int window) {
  return kp < Lk && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// Whether a tiled body exists for dtype (0 f32, 1 bf16, 2 fp16) at padded
// width Dp and takes head_dim D: f32 at Dp 16..128, 16-bit at Dp 16..256
// with D a multiple of 8 (ops/flash_attention.py:_body is the caller's
// rule).
inline bool tiled(int dtype, int D, int Dp) {
  if (D < 1 || D > Dp || (dtype != 0 && D % 8)) return false;
  if (Dp == 16 || Dp == 32 || Dp == 64 || Dp == 128) return dtype >= 0 && dtype <= 2;
  return Dp == 256 && (dtype == 1 || dtype == 2);
}

// Grids.  A forward block covers (batch and head, q tile) and a dk/dv block
// (batch and kv head, key tile): the tile on grid.x and the head on grid.y
// (the forward's last q tile, the heaviest, first), as long as the head
// count fits grid.y's 65535; past it, tile_grid folds both into grid.x,
// tile fastest, in the same order.  (A dq block has the head on grid.x
// and its q tile on grid.y: no count of heads meets a limit there.)
inline dim3 tile_grid(int tiles, int heads, int z = 1) {
  return heads <= 65535 ? dim3(tiles, heads, z) : dim3((unsigned)tiles * heads, 1, z);
}

// The block's (head, tile) on tile_grid's grid: the 2-D grid's own index
// where there is one (a grid.y of 1 folds to the same block).
__device__ __forceinline__ void grid_tile(int tiles, int& head, int& tile) {
  if (gridDim.y > 1) {
    head = blockIdx.y;
    tile = blockIdx.x;
  } else {
    head = blockIdx.x / tiles;
    tile = blockIdx.x % tiles;
  }
}

// A forward block's (batch and head, first q row), the last q tile first.
__device__ __forceinline__ void fwd_block(int L, int bq, int& bh, int& q_lo) {
  const int nqt = (L + bq - 1) / bq;
  int t;
  grid_tile(nqt, bh, t);
  q_lo = (nqt - 1 - t) * bq;
}

// A dk/dv block's (batch and kv head, first key).
__device__ __forceinline__ void dkv_block(int Lk, int bk, int& bhk, int& k_lo) {
  int t;
  grid_tile((Lk + bk - 1) / bk, bhk, t);
  k_lo = t * bk;
}

// Stores the first D of a row's Dp values, 8 columns a call of
// store(j) for group j: at D == Dp every group, unpredicated, as a body
// built for that width alone stores them.
template <int DP, typename F>
__device__ __forceinline__ void store_groups(int D, F&& store) {
  if (D == DP) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) store(j);
  } else {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D) store(j);
  }
}

}  // namespace flash
