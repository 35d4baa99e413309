// RMSNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel k8s_tpu/ops/fused_norm.py:_rms_kernel
// (launched by _rms).  Same function, row by row:
//   1. the mean of squares in f32 (the sum over D, divided by D);
//   2. r = 1 / sqrt(var + eps), each step correctly rounded (no rsqrtf);
//   3. the normalized row x * r rounded to the type of x;
//   4. multiplied by the scale in f32;
//   5. written in promote_types(x, scale): the type of x where the scale
//      has the same type, else f32.
//
// What bounds it on this card: ~3 operations per element against 2-4 bytes
// in and 2-4 bytes out, so HBM bandwidth wherever there are many rows; at
// the 1-16 rows of a decode step nothing comes near the byte bound, and the
// cost is the launch and one dependent round trip load -> reduce -> store.
// Every body reads each element of x once from HBM, keeps the row in
// registers between the reduction and the store, and never writes the
// variance.  x and the output pass through L2 with evict-first hints
// (ld/st.global.cs, L2::evict_first on the bulk copies): each of their
// bytes is touched once, while the scale, read by every row, stays.  A
// thread moves VEC elements an access, 16 bytes of the wider of x and the
// scale, so the output (f32 wherever the types differ) is stored 16 bytes
// a thread and each warp store covers 512 contiguous bytes; 16-byte x
// vectors with 32-byte output chunks a thread measured 1.4x slower at the
// f32-output shapes.  Three bodies; ops/fused_norm.py:_rms_plan picks one
// per call, and the entry refuses any launch shape the plan does not make:
//   - rms_norm_row (few rows): one block a row, D / (NV VEC) threads, each
//     loading its NV accesses of x and of the scale together before the
//     reduction; warp shuffles, one shared-memory pass across the warps;
//   - rms_norm_stream (many rows, each on a 16-byte boundary): persistent,
//     at most 1024 threads an SM, so every block is resident; blocks walk
//     the rows at a stride of the grid.  A block loads its columns of the
//     scale once, into registers, and streams its rows through a ring of
//     row buffers in shared memory, each filled by one bulk async copy
//     (cp.async.bulk, completion counted on an mbarrier), so the next rows
//     are in flight while one is reduced and stored.  One __syncthreads a
//     row: the cross-warp sum, which also frees the row's buffer for the
//     copy of the row `stages` rows on;
//   - rms_norm_scalar (D, a row stride or a pointer that does not split into
//     accesses aligned to their size): one block a row, each thread HOLD
//     (1, 2, 4 or 8, the fewest that fit the row in 1024 threads) elements
//     a block-width apart, held in registers between the reduction and the
//     store; a row wider than 8192 is read twice, the second time from L2.
//     At a few short rows the time is the chain load -> reduce -> store,
//     which grows with the elements a thread handles, so the plan gives a
//     row as many threads as it can.
// The row sums are taken in a fixed order, so a row's output does not
// depend on the grid.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// What ops/fused_norm.py:_launch_args packs for one launch (ctypes passes
// one pointer instead of fifteen arguments).
struct RmsArgs {
  int x_dtype, s_dtype;  // 0 f32, 1 bf16, 2 f16
  int body, N, D, grid, threads;
  int nv;      // vector bodies: accesses a thread makes; scalar: HOLD
  int stages;  // stream body: row buffers in the ring
  float eps;
  long long stride_x;  // elements from one row of x to the next
};

namespace {

constexpr int MAX_STAGES = 4;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// promote_types(T, S) for the three float types
template <typename T, typename S>
using Out = typename std::conditional<std::is_same<T, S>::value, T, float>::type;

// Elements a thread moves per access: 16 bytes of the wider of x and the
// scale, so that the output (f32 wherever the two types differ) is stored
// 16 bytes a thread and a warp's store covers 512 contiguous bytes.
template <typename T, typename S>
__host__ __device__ constexpr int vec_of() {
  return 16 / (sizeof(T) > sizeof(S) ? sizeof(T) : sizeof(S));
}

// Threads a block of the vector bodies may have: up to 16 elements a
// thread fit in 64 registers (1024 threads), more need 256.
template <typename T, typename S, int NV>
__host__ __device__ constexpr int max_threads() {
  return NV * vec_of<T, S>() <= 16 ? 1024 : 256;
}

// BYTES (8 or a multiple of 16) between aligned addresses, in 8- or
// 16-byte words.  LOAD_CS: the source is x in global memory, read once
// (ld.global.cs, evict first from L2); STORE_CS: the destination is the
// output, written once (st.global.cs).  Otherwise plain accesses (the
// scale, read by every row, and shared memory).
template <int BYTES, bool LOAD_CS, bool STORE_CS>
__device__ __forceinline__ void copy_words(void* dst, const void* src) {
  static_assert(BYTES % 16 == 0 || BYTES == 8, "8 bytes or a multiple of 16");
  using W = typename std::conditional<BYTES % 16 == 0, uint4, uint2>::type;
#pragma unroll
  for (int i = 0; i < BYTES / (int)sizeof(W); ++i) {
    const W* s = reinterpret_cast<const W*>(src) + i;
    W* d = reinterpret_cast<W*>(dst) + i;
    W w;
    if constexpr (LOAD_CS)
      w = __ldcs(s);
    else
      w = *s;
    if constexpr (STORE_CS)
      __stcs(d, w);
    else
      *d = w;
  }
}

// N contiguous elements at p, as f32; CS: p is x in global memory
template <int N, bool CS, typename E>
__device__ __forceinline__ void load_vec(const E* p, float (&f)[N]) {
  alignas(16) E buf[N];
  copy_words<N * (int)sizeof(E), CS, false>(buf, p);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = to_f32(buf[i]);
}

// N contiguous output elements at p
template <int N, typename E>
__device__ __forceinline__ void store_vec(E* p, const float (&f)[N]) {
  alignas(16) E buf[N];
#pragma unroll
  for (int i = 0; i < N; ++i) buf[i] = from_f32<E>(f[i]);
  copy_words<N * (int)sizeof(E), false, true>(p, buf);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v, the same on every thread: a warp butterfly, the
// warps' sums through `red`, then a second butterfly over them in every
// warp (the same order everywhere, so the same value).  blockDim.x is a
// multiple of 32.  One __syncthreads (none for a single warp); `red` may
// be written again only after the next one.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (blockDim.x == 32) return v;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

// r = 1 / sqrt(sum / D + eps), each step correctly rounded.
__device__ __forceinline__ float inv_rms(float sum, int D, float eps) {
  return __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(sum, (float)D), eps)));
}

// One output element: x * r rounded to T, times the scale in f32.
template <typename T>
__device__ __forceinline__ float normed(float x, float r, float s) {
  return __fmul_rn(to_f32(from_f32<T>(__fmul_rn(x, r))), s);
}

// -- row body ------------------------------------------------------------------

template <typename T, typename S, int NV>
__global__ void __launch_bounds__(max_threads<T, S, NV>())
    rms_norm_row(const T* __restrict__ x, const S* __restrict__ scale, Out<T, S>* __restrict__ out,
                 int D, long long stride_x, float eps) {
  constexpr int VEC = vec_of<T, S>();
  __shared__ float red[32];
  const int nvec = D / VEC;
  const T* xr = x + (long long)blockIdx.x * stride_x;
  Out<T, S>* orow = out + (long long)blockIdx.x * D;
  float xv[NV][VEC], sv[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = threadIdx.x + v * blockDim.x;
    if (c < nvec) {
      load_vec<VEC, true>(xr + c * VEC, xv[v]);
      load_vec<VEC, false>(scale + c * VEC, sv[v]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if ((int)(threadIdx.x + v * blockDim.x) < nvec) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(xv[v][i], xv[v][i], ss);
    }
  }
  const float r = inv_rms(block_sum(ss, red), D, eps);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = threadIdx.x + v * blockDim.x;
    if (c < nvec) {
      float y[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) y[i] = normed<T>(xv[v][i], r, sv[v][i]);
      store_vec<VEC>(orow + c * VEC, y);
    }
  }
}

// -- persistent streaming body ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of x from
// global memory into shared memory by one bulk async copy, counted on
// `bar`; the lines read are evicted first from L2.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

template <typename T, typename S, int NV>
__global__ void __launch_bounds__(max_threads<T, S, NV>())
    rms_norm_stream(const T* __restrict__ x, const S* __restrict__ scale, Out<T, S>* __restrict__ out,
                    int N, int D, long long stride_x, float eps, int stages) {
  constexpr int VEC = vec_of<T, S>();
  extern __shared__ __align__(128) unsigned char ring[];  // stages rows of D elements of T
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ float red[2][32];
  const int nvec = D / VEC;
  const uint32_t row_bytes = (uint32_t)D * sizeof(T);

  float sv[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = threadIdx.x + v * blockDim.x;
    if (c < nvec) load_vec<VEC, false>(scale + c * VEC, sv[v]);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < stages; ++s) {
      const long long row = blockIdx.x + (long long)s * gridDim.x;
      if (row < N) bulk_load(ring + s * row_bytes, x + row * stride_x, row_bytes, &full[s]);
    }

  int it = 0;
  for (long long row = blockIdx.x; row < N; row += gridDim.x, ++it) {
    const int st = it % stages;
    mbar_wait(&full[st], (it / stages) & 1);
    const T* xs = reinterpret_cast<const T*>(ring + st * row_bytes);
    float xv[NV][VEC];
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = threadIdx.x + v * blockDim.x;
      if (c < nvec) {
        load_vec<VEC, false>(xs + c * VEC, xv[v]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) ss = fmaf(xv[v][i], xv[v][i], ss);
      }
    }
    const float sum = block_sum(ss, red[it & 1]);
    // every thread has its part of this row in registers: refill the buffer
    if (threadIdx.x == 0) {
      const long long next = row + (long long)stages * gridDim.x;
      if (next < N) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_load(ring + st * row_bytes, x + next * stride_x, row_bytes, &full[st]);
      }
    }
    const float r = inv_rms(sum, D, eps);
    Out<T, S>* orow = out + row * D;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = threadIdx.x + v * blockDim.x;
      if (c < nvec) {
        float y[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) y[i] = normed<T>(xv[v][i], r, sv[v][i]);
        store_vec<VEC>(orow + c * VEC, y);
      }
    }
  }
}

// -- scalar body ---------------------------------------------------------------

template <typename T, typename S>
__device__ __forceinline__ void scalar_store(Out<T, S>* p, float v) {
  __stcs(p, from_f32<Out<T, S>>(v));
}

template <typename T, typename S, int HOLD>
__global__ void __launch_bounds__(1024)
    rms_norm_scalar(const T* __restrict__ x, const S* __restrict__ scale, Out<T, S>* __restrict__ out,
                    int D, long long stride_x, float eps) {
  __shared__ float red[32];
  const T* xr = x + (long long)blockIdx.x * stride_x;
  Out<T, S>* orow = out + (long long)blockIdx.x * D;
  const int step = blockDim.x * HOLD;
  float ss = 0.f;
  if (step >= D) {  // the row fits the block's hold: one pass, in registers
    float xv[HOLD], sv[HOLD];
#pragma unroll
    for (int k = 0; k < HOLD; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      xv[k] = c < D ? to_f32(__ldcs(xr + c)) : 0.f;
      sv[k] = c < D ? to_f32(scale[c]) : 0.f;
      ss = fmaf(xv[k], xv[k], ss);
    }
    const float r = inv_rms(block_sum(ss, red), D, eps);
#pragma unroll
    for (int k = 0; k < HOLD; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < D) scalar_store<T, S>(orow + c, normed<T>(xv[k], r, sv[k]));
    }
    return;
  }
  // a wider row: sum in one pass, normalize in a second (x again from L2),
  // HOLD loads in flight a thread in each
  for (int c0 = threadIdx.x; c0 < D; c0 += step) {
    float v[HOLD];
#pragma unroll
    for (int k = 0; k < HOLD; ++k) {
      const int c = c0 + k * blockDim.x;
      v[k] = c < D ? to_f32(xr[c]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < HOLD; ++k) ss = fmaf(v[k], v[k], ss);
  }
  const float r = inv_rms(block_sum(ss, red), D, eps);
  for (int c0 = threadIdx.x; c0 < D; c0 += step) {
    float v[HOLD], w[HOLD];
#pragma unroll
    for (int k = 0; k < HOLD; ++k) {
      const int c = c0 + k * blockDim.x;
      v[k] = c < D ? to_f32(xr[c]) : 0.f;
      w[k] = c < D ? to_f32(scale[c]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < HOLD; ++k) {
      const int c = c0 + k * blockDim.x;
      if (c < D) scalar_store<T, S>(orow + c, normed<T>(v[k], r, w[k]));
    }
  }
}

// -- launch ----------------------------------------------------------------------

enum Body { ROW = 0, STREAM = 1, SCALAR = 2 };

// Opt a kernel in to more than 48 KB of shared memory.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem + 1024 <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename S, int NV>
int launch_nv(const RmsArgs& a, const T* x, const S* s, Out<T, S>* o, cudaStream_t st) {
  if (a.threads > max_threads<T, S, NV>()) return (int)cudaErrorInvalidValue;
  if (a.body == ROW) {
    if (a.grid != a.N) return (int)cudaErrorInvalidValue;
    rms_norm_row<T, S, NV><<<a.grid, a.threads, 0, st>>>(x, s, o, a.D, a.stride_x, a.eps);
  } else if (a.body == STREAM) {
    if (a.stages < 2 || a.stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)a.stages * a.D * sizeof(T);
    if (const int err = allow_smem(rms_norm_stream<T, S, NV>, smem)) return err;
    rms_norm_stream<T, S, NV><<<a.grid, a.threads, smem, st>>>(x, s, o, a.N, a.D, a.stride_x, a.eps,
                                                               a.stages);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch(const RmsArgs& a, const void* xp, const void* sp, void* op, cudaStream_t st) {
  const T* x = static_cast<const T*>(xp);
  const S* s = static_cast<const S*>(sp);
  Out<T, S>* o = static_cast<Out<T, S>*>(op);
  if (a.grid < 1 || a.threads < 32 || a.threads > 1024 || a.threads % 32) return (int)cudaErrorInvalidValue;
  if (a.body == SCALAR) {
    if (a.grid != a.N) return (int)cudaErrorInvalidValue;
    switch (a.nv) {
      case 1: rms_norm_scalar<T, S, 1><<<a.grid, a.threads, 0, st>>>(x, s, o, a.D, a.stride_x, a.eps); break;
      case 2: rms_norm_scalar<T, S, 2><<<a.grid, a.threads, 0, st>>>(x, s, o, a.D, a.stride_x, a.eps); break;
      case 4: rms_norm_scalar<T, S, 4><<<a.grid, a.threads, 0, st>>>(x, s, o, a.D, a.stride_x, a.eps); break;
      case 8: rms_norm_scalar<T, S, 8><<<a.grid, a.threads, 0, st>>>(x, s, o, a.D, a.stride_x, a.eps); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  switch (a.nv) {
    case 1: return launch_nv<T, S, 1>(a, x, s, o, st);
    case 2: return launch_nv<T, S, 2>(a, x, s, o, st);
    case 4: return launch_nv<T, S, 4>(a, x, s, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_scale(const RmsArgs& a, const void* x, const void* s, void* o, cudaStream_t st) {
  switch (a.s_dtype) {
    case 0: return launch<T, float>(a, x, s, o, st);
    case 1: return launch<T, __nv_bfloat16>(a, x, s, o, st);
    case 2: return launch<T, __half>(a, x, s, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Normalize the N rows of x (D elements each, row i at x + i * stride_x)
// into the contiguous [N, D] out, as `args` says (ops/fused_norm.py:
// _rms_plan's body, grid, threads, nv and stages; any other shape is
// refused).  Returns the launch's
// cudaError_t (0 when the kernel was queued).
extern "C" int k8s_rms_norm(const void* x, const void* scale, void* out, const RmsArgs* args,
                            void* stream) {
  const RmsArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.N < 1 || a.D < 1) return (int)cudaErrorInvalidValue;
  switch (a.x_dtype) {
    case 0: return by_scale<float>(a, x, scale, out, st);
    case 1: return by_scale<__nv_bfloat16>(a, x, scale, out, st);
    case 2: return by_scale<__half>(a, x, scale, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
