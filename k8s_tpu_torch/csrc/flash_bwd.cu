// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of k8s_tpu/ops/flash_attention.py's
// backward (launched by _flash_bwd):
//   - K3 _dq_kernel:  dq = sum_k ds.k;
//   - K4 _dkv_kernel: dv = sum_q p^T.do, dk = sum_q ds^T.q;
// with p = exp(s - lse) recomputed from the forward's saved lse (s the
// scaled, masked score), dp = do.v^T, ds = p * (dp - delta) * scale and
// delta = rowsum(do * o).  The reference computes delta in XLA before its
// kernels; here the dq kernel computes it in f32 for its own q rows, uses
// it, and writes it to a contiguous [B, H, L] buffer that the dk/dv kernel,
// launched after it on the same stream, reads.  Masked entries give p = 0,
// so a fully masked row contributes nothing; the element mask is the
// forward's (flash::visible).
//
// What bounds it on this card: the backward does 2.5x the forward's
// products over the same visible (q, k) pairs (dq: q.k^T, do.v^T, ds.k, 6 D
// flops a pair; dk/dv: q.k^T, do.v^T, p^T.do, ds^T.q, 8 D), far above the
// H100's ~295 ops/byte line at the training shapes, so the tensor cores'
// arithmetic is the bound.  The TPU kernels carry dq_acc / dk_acc / dv_acc
// in VMEM scratch across an in-order inner grid axis; on the card one block
// owns its output tile and loops instead, accumulating in f32 registers and
// writing once, through (batch, head, row) strides so the [B, L, H, D]
// model layout needs no copies:
//   - dq (K3, k8s_tpu/ops/flash_attention.py:233 _dq_kernel), bf16 / fp16
//     at D 64 and 128: flash_bwd_dq_wgmma.  One block per (batch, head,
//     128-row q tile), built like the forward's wgmma body: a producer
//     warpgroup (setmaxnreg down to 24 registers) whose first thread loads
//     the q and do tiles once and streams K and V tiles by TMA into a
//     two-stage mbarrier ring, over the key tiles the forward visits for
//     those rows (causal: up to the last q row; window: from
//     q_lo - window + 1); two consumer warpgroups of 64 q rows each compute
//     their rows' delta from do and o while the first tiles land, then per
//     key tile run s = Q.K^T and dp = dO.V^T as wgmma from shared memory,
//     p = 2^(s scale log2(e) - lse log2(e)) on the special-function unit
//     and ds in registers (the element mask only on edge tiles, p computed
//     while dp's product still runs), and dq += ds.K as wgmma with ds
//     rounded to the input type straight into the register A operand and K
//     read with the transpose bit.  In bf16 (f32's exponent range) the
//     scale is left out of ds and applied to dq once at the end; fp16 keeps
//     it in ds for range.  dq is an f32 m64nD accumulator written once,
//     with no atomics, so it is deterministic.  Blocks launch heaviest q
//     tile first across every (batch, head) (ops/flash_attention.py:
//     _dq_plan), so the causal tail is made of short blocks;
//   - dq, bf16 / fp16 at D 16 and 32 (the tiny test shapes only): one block
//     per 64-row q tile, four warps of 16 rows on mma.sync m16n8k16 with
//     cp.async double buffering and ldmatrix;
//   - dk/dv (K4), bf16 / fp16 at D 64 and 128: flash_bwd_dkv_wgmma.  One
//     block per 128-key tile: a producer warpgroup (setmaxnreg down to 24
//     registers) whose first warp loads K and V once and streams q and do
//     tiles by TMA (4-D tensor maps over the caller's strides, 128-byte
//     swizzle, zero fill past L) with their lse and delta into a two-stage
//     mbarrier ring, for each query head of the GQA group and each 64-row
//     q tile that can see the keys (causal: from k_lo; window: up to
//     k_lo + 127 + window); two consumer warpgroups of 64 keys each run
//     s^T = K.q^T and dp^T = V.do^T as wgmma from shared memory, recompute
//     p = exp2(s^T scale log2(e) - lse log2(e)) and ds in registers (the
//     element mask only on edge tiles), and accumulate dv += p^T.do and
//     dk += ds^T.q as wgmma with p and ds rounded to the input type straight
//     into the register A operand and do, q read with the transpose bit.
//     The group sum stays inside the block, with no atomics, so dk/dv are
//     deterministic.  Where B * Hkv * ceil(Lk / 128) blocks would leave SMs
//     idle, the caller (ops/flash_attention.py:_dkv_plan) splits each
//     block's (head, q tile) list into nsplit fixed chunks: each writes an
//     f32 partial, and the caller sums them in a fixed order;
//   - dk/dv, bf16 / fp16 at D 16 and 32 (the tiny test shapes only): one
//     block per 64-key tile, four warps of 16 keys on mma.sync, as dq;
//   - f32 (exact f32 arithmetic, as the tiny test model needs): f32 FMAs on
//     the CUDA cores over tiles held in shared memory.
// p and ds are rounded to the input type before their products, as the
// forward rounds p.

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;            // dq: q rows per block (fma: also per q tile)
constexpr int BK = 64;            // k rows per block (dk/dv) or per tile (dq)
constexpr int NT = 256;           // fma bodies: 16 x 16 threads
constexpr int MMA_THREADS = 128;  // mma bodies: 4 warps x 16 rows

// The tensors a launch addresses through strides.
enum { T_Q, T_K, T_V, T_DO, T_OUT0, T_OUT1, T_O };

// (batch, head, row) element strides of q, k, v, do, the outputs (dq; or
// dk, dv) and o (dq only), in T_* order; the last dim is contiguous.
struct Strides {
  int64_t s[21];
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* o;       // dq only
  const float* lse;    // [B, H, L] contiguous
  float* delta;        // [B, H, L] contiguous: written by dq, read by dk/dv
  void* out0;          // dq, or dk
  void* out1;          // dv
  int B, H, Hkv, L, Lk;
  Strides st;
  float scale;
  int causal, window;
  int nsplit;  // dk/dv wgmma body: chunks of each block's (head, q tile) list
};

// Offset of (batch b, head h, row r) of tensor t (T_*).
__device__ __forceinline__ int64_t off(const Strides& st, int t, int b, int h, int r) {
  return b * st.s[3 * t] + h * st.s[3 * t + 1] + (int64_t)r * st.s[3 * t + 2];
}

// The lse of row qp with a fully masked row's NEG_INF taken as 0 (the
// reference's safe_lse); 0 past L.
__device__ __forceinline__ float row_lse(const BwdArgs& a, int bh, int qp) {
  if (qp >= a.L) return 0.f;
  const float l = a.lse[(int64_t)bh * a.L + qp];
  return l <= NEG_INF / 2 ? 0.f : l;
}

// lse (row_lse) and delta; 0 past L.
__device__ __forceinline__ void row_stats(const BwdArgs& a, int bh, int qp, float& lse,
                                          float& delta) {
  lse = row_lse(a, bh, qp);
  delta = qp < a.L ? a.delta[(int64_t)bh * a.L + qp] : 0.f;
}

template <typename T>
__device__ __forceinline__ float dot2(uint32_t x, uint32_t y, float acc) {
  const float2 a = unpack2<T>(x), b = unpack2<T>(y);
  return fmaf(a.y, b.y, fmaf(a.x, b.x, acc));
}

// This lane's share of the f32 dot product of two rows of D values: lane
// `part` (0..3) of a quad takes every fourth 16-byte chunk (every fourth
// word below D 32, every fourth value in f32), so the quad's four shares
// sum to the row's.  16-bit rows are 16-byte aligned (the wrapper checks).
template <typename T, int D>
__device__ __forceinline__ float quad_dot(const T* x, const T* y, int part) {
  float acc = 0.f;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc = fmaf(x[part + 4 * i], y[part + 4 * i], acc);
  } else if constexpr (D % 32 == 0) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* yv = reinterpret_cast<const uint4*>(y);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const uint4 a = xv[part + 4 * i], b = yv[part + 4 * i];
      acc = dot2<T>(a.x, b.x, acc);
      acc = dot2<T>(a.y, b.y, acc);
      acc = dot2<T>(a.z, b.z, acc);
      acc = dot2<T>(a.w, b.w, acc);
    }
  } else {
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
    const uint32_t* yw = reinterpret_cast<const uint32_t*>(y);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) acc = dot2<T>(xw[part + 4 * i], yw[part + 4 * i], acc);
  }
  return acc;
}

// delta = rowsum(do * o) of row qp (0 past L), summed over the calling
// quad (every lane of the warp calls it): lane % 4 takes its quad_dot share.
// Lane 0 of the quad stores it when `store`.
template <typename T, int D>
__device__ __forceinline__ float row_delta(const BwdArgs& a, int b, int h, int qp, int part,
                                           bool store) {
  float d = 0.f;
  if (qp < a.L)
    d = quad_dot<T, D>(static_cast<const T*>(a.dout) + off(a.st, T_DO, b, h, qp),
                       static_cast<const T*>(a.o) + off(a.st, T_O, b, h, qp), part);
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  if (store && part == 0 && qp < a.L) a.delta[(int64_t)(b * a.H + h) * a.L + qp] = d;
  return d;
}

// ---------------------------------------------------------------------------
// f32 bodies
// ---------------------------------------------------------------------------

// dq: q, do, k, v tiles (rows padded by one word), the ds tile and the q
// tile's delta.
template <int D>
struct DqFma {
  static constexpr int QS = D + 1;
  static constexpr int PS = BK + 1;
  static constexpr size_t bytes =
      (size_t)4 * 64 * QS * 4 + (size_t)BQ * PS * 4 + (size_t)BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_fma(const BwdArgs a) {
  constexpr int QS = DqFma<D>::QS, PS = DqFma<D>::PS, DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + BQ * QS;
  float* ks = dos + BQ * QS;
  float* vs = ks + BK * QS;
  float* dss = vs + BK * QS;
  float* dl_s = dss + BQ * PS;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, qp = q_lo + r;
    const bool in = qp < a.L;
    qs[r * QS + d] = in ? q[off(a.st, T_Q, b, h, qp) + d] : 0.f;
    dos[r * QS + d] = in ? dout[off(a.st, T_DO, b, h, qp) + d] : 0.f;
  }
  // delta: a quad of threads a row
  const float dl = row_delta<float, D>(a, b, h, q_lo + (tid >> 2), tid & 3, true);
  if ((tid & 3) == 0) dl_s[tid >> 2] = dl;
  __syncthreads();
  float lse_r[4], dl_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = row_lse(a, bh, q_lo + ty + 16 * i);
    dl_r[i] = dl_s[ty + 16 * i];
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  const int kv_lo = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(a.Lk, q_lo + BQ) : a.Lk;
  for (int t0 = kv_lo; t0 < kv_hi; t0 += BK) {
    __syncthreads();  // the previous tile's k and ds reads are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D, kp = t0 + r;
      const bool in = kp < a.Lk;
      ks[r * QS + d] = in ? k[off(a.st, T_K, b, hk, kp) + d] : 0.f;
      vs[r * QS + d] = in ? v[off(a.st, T_V, b, hk, kp) + d] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * QS + d];
        ov[i] = dos[(ty + 16 * i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * QS + d];
        vv[j] = vs[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_lo + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t0 + tx + 16 * j;
        const float p = visible(qp, kp, a.Lk, a.causal, a.window)
                            ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        dss[(ty + 16 * i) * PS + tx + 16 * j] = p * (dp[i][j] - dl_r[i]) * a.scale;
      }
    }
    __syncthreads();  // ds tile complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        const float kv = ks[kk * QS + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(dsv[i], kv, acc[i][jd]);
      }
    }
  }

  float* dq = static_cast<float*>(a.out0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_lo + ty + 16 * i;
    if (qp >= a.L) continue;
    float* row = dq + off(a.st, T_OUT0, b, h, qp);
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) row[tx + 16 * jd] = acc[i][jd];
  }
}

// dk/dv: the block's k and v tiles, one q and do tile at a time, the p^T and
// ds^T tiles, and the q tile's lse and delta.
template <int D>
struct DkvFma {
  static constexpr int QS = D + 1;
  static constexpr int PS = BQ + 1;
  static constexpr size_t bytes =
      (size_t)4 * 64 * QS * 4 + (size_t)2 * BK * PS * 4 + (size_t)2 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_fma(const BwdArgs a) {
  constexpr int QS = DkvFma<D>::QS, PS = DkvFma<D>::PS, DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + BK * QS;
  float* qs = vs + BK * QS;
  float* dos = qs + BQ * QS;
  float* pts = dos + BQ * QS;
  float* dsts = pts + BK * PS;
  float* lse_s = dsts + BK * PS;
  float* dl_s = lse_s + BQ;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k_lo = blockIdx.x * BK;
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv, G = a.H / a.Hkv;

  for (int i = tid; i < BK * D; i += NT) {
    const int r = i / D, d = i % D, kp = k_lo + r;
    const bool in = kp < a.Lk;
    ks[r * QS + d] = in ? k[off(a.st, 1, b, hk, kp) + d] : 0.f;
    vs[r * QS + d] = in ? v[off(a.st, 2, b, hk, kp) + d] : 0.f;
  }
  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) dk[i][jd] = dv[i][jd] = 0.f;

  // the queries that can see a key of this tile
  const int q_begin = a.causal ? k_lo : 0;
  const int q_end = a.window > 0 ? min(a.L, k_lo + BK - 1 + a.window) : a.L;
  for (int h = hk * G; h < (hk + 1) * G; ++h) {
    const int bh = b * a.H + h;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous q tile's reads are done
      for (int i = tid; i < BQ * D; i += NT) {
        const int r = i / D, d = i % D, qp = q0 + r;
        const bool in = qp < a.L;
        qs[r * QS + d] = in ? q[off(a.st, 0, b, h, qp) + d] : 0.f;
        dos[r * QS + d] = in ? dout[off(a.st, 3, b, h, qp) + d] : 0.f;
      }
      if (tid < BQ) row_stats(a, bh, q0 + tid, lse_s[tid], dl_s[tid]);
      __syncthreads();

      // s^T and dp^T: rows are keys ty + 16 i, columns queries tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ks[(ty + 16 * i) * QS + d];
          vv[i] = vs[(ty + 16 * i) * QS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(tx + 16 * j) * QS + d];
          ov[j] = dos[(tx + 16 * j) * QS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k_lo + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j, qp = q0 + qi;
          const float p = qp < a.L && visible(qp, kp, a.Lk, a.causal, a.window)
                              ? expf(s[i][j] * a.scale - lse_s[qi]) : 0.f;
          pts[(ty + 16 * i) * PS + qi] = p;
          dsts[(ty + 16 * i) * PS + qi] = p * (dp[i][j] - dl_s[qi]) * a.scale;
        }
      }
      __syncthreads();  // p^T and ds^T tiles complete

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pts[(ty + 16 * i) * PS + qq];
          dsv[i] = dsts[(ty + 16 * i) * PS + qq];
        }
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) {
          const float ov = dos[qq * QS + tx + 16 * jd];
          const float qv = qs[qq * QS + tx + 16 * jd];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][jd] = fmaf(pv[i], ov, dv[i][jd]);
            dk[i][jd] = fmaf(dsv[i], qv, dk[i][jd]);
          }
        }
      }
    }
  }

  float* dkp = static_cast<float*>(a.out0);
  float* dvp = static_cast<float*>(a.out1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k_lo + ty + 16 * i;
    if (kp >= a.Lk) continue;
    float* rk = dkp + off(a.st, 4, b, hk, kp);
    float* rv = dvp + off(a.st, 5, b, hk, kp);
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      rk[tx + 16 * jd] = dk[i][jd];
      rv[tx + 16 * jd] = dv[i][jd];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 bodies (tensor cores)
// ---------------------------------------------------------------------------
//
// Fragment layouts (PTX m16n8k16): an accumulator element e of n-tile nt
// sits at row g + 8 * (e >> 1), column nt * 8 + c2 + (e & 1), with
// g = lane / 4 and c2 = 2 * (lane % 4).  The accumulators of n-tiles 2j and
// 2j + 1 are, packed to 16 bits, the A fragment of k-step j of the next
// product.  Row-major A tiles come from shared memory by ldmatrix (lane l
// addresses row l % 16, column 8 * (l / 16)); a B operand whose rows are the
// product's n index (k^T, v^T, q^T, do^T) by plain ldmatrix, one whose rows
// are the k index (k, q, do) by ldmatrix.trans.

// dq at head_dim 16 and 32 (the wgmma body takes 64 and 128): the block's
// q and do tiles, then two stages of k and v tiles; rows padded by 16 bytes
// so the 8 row addresses of each ldmatrix hit different banks.
template <typename T, int D>
struct DqMma {
  static_assert(D <= 32, "head_dim 64 and 128 take flash_bwd_dq_wgmma");
  static constexpr int KS = D + 8;
  static constexpr size_t bytes = (size_t)(2 * BQ + 2 * 2 * BK) * KS * sizeof(T);
};

template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_mma(const BwdArgs a) {
  constexpr int KS = DqMma<T, D>::KS;
  constexpr int NKT = BK / 8;     // 8-column n-tiles of the score tile
  constexpr int NDT = D / 8;      // 8-column n-tiles of dq
  constexpr int KSTEPS = D / 16;  // 16-deep k-steps over head_dim
  constexpr int CPR = D / 8;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + BQ * KS;
  T* tiles = dos + BQ * KS;  // [stage][k, v][BK][KS]
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int lr = lane & 7, lm = lane >> 3;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int w_lo = q_lo + warp * 16;  // this warp's 16 q rows
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);
  const int rows[2] = {w_lo + g, w_lo + g + 8};

  const int kv_lo = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(a.Lk, q_lo + BQ) : a.Lk;

  for (int i = tid; i < BQ * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, qp = q_lo + r;
    const bool in = qp < a.L;
    const int row = in ? qp : 0;
    cp_async16(qs + r * KS + c, q + off(a.st, 0, b, h, row) + c, in);
    cp_async16(dos + r * KS + c, dout + off(a.st, 3, b, h, row) + c, in);
  }
  // start the copies of the k/v tile beginning at key t0 into stage st (the
  // first group also carries the q and do tiles)
  auto load_tile = [&](int st, int t0) {
    T* ks = tiles + st * 2 * BK * KS;
    T* vs = ks + BK * KS;
    for (int i = tid; i < BK * CPR; i += MMA_THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, kp = t0 + r;
      const bool in = kp < a.Lk;
      const int row = in ? kp : 0;
      cp_async16(ks + r * KS + c, k + off(a.st, 1, b, hk, row) + c, in);
      cp_async16(vs + r * KS + c, v + off(a.st, 2, b, hk, row) + c, in);
    }
    cp_async_commit();
  };
  load_tile(0, kv_lo);

  // lse and delta of this thread's two rows (delta from do and o, summed
  // over the quad that shares the rows)
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = row_lse(a, bh, rows[i]);
    dl_r[i] = row_delta<T, D>(a, b, h, rows[i], lane & 3, true);
  }
  float acc[NDT][4];
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  int stage = 0;
  for (int t0 = kv_lo; t0 < kv_hi; t0 += BK, stage ^= 1) {
    if (t0 + BK < kv_hi) {
      load_tile(stage ^ 1, t0 + BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's tile has landed for every thread
    const T* ks = tiles + stage * 2 * BK * KS;
    const T* vs = ks + BK * KS;
    // a tile wholly masked for this warp's rows changes nothing (the
    // forward's skip rule; warp-uniform)
    const bool skip = (a.causal && w_lo + 15 < t0) ||
                      (a.window > 0 && w_lo - (t0 + BK - 1) >= a.window);
    if (!skip) {
      float s[NKT][4], dp[NKT][4];
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      // s = q.k^T and dp = do.v^T: k and v rows are the n index
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[4], da[4];
        ldsm_x4(qa, qs + (warp * 16 + (lane & 15)) * KS + kk * 16 + (lane >> 4) * 8);
        ldsm_x4(da, dos + (warp * 16 + (lane & 15)) * KS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NKT; nt += 2) {
          uint32_t f[4];
          const int at = ((nt + (lm >> 1)) * 8 + lr) * KS + kk * 16 + (lm & 1) * 8;
          ldsm_x4(f, ks + at);
          mma16816(s[nt], qa, f[0], f[1], (T*)nullptr);
          mma16816(s[nt + 1], qa, f[2], f[3], (T*)nullptr);
          ldsm_x4(f, vs + at);
          mma16816(dp[nt], da, f[0], f[1], (T*)nullptr);
          mma16816(dp[nt + 1], da, f[2], f[3], (T*)nullptr);
        }
      }
      // ds = p * (dp - delta) * scale, in place of s
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kp = t0 + nt * 8 + c2 + (e & 1);
          const float p = visible(rows[i], kp, a.Lk, a.causal, a.window)
                              ? expf(s[nt][e] * a.scale - lse_r[i]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - dl_r[i]) * a.scale;
        }
      // dq += ds.k: k rows are the k index (ldmatrix.trans)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint32_t fa[4] = {
            pack2<T>(s[2 * j][0], s[2 * j][1]), pack2<T>(s[2 * j][2], s[2 * j][3]),
            pack2<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
            pack2<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int dn = 0; dn < NDT; dn += 2) {
          uint32_t f[4];
          ldsm_x4_t(f, ks + (j * 16 + (lm & 1) * 8 + lr) * KS + (dn + (lm >> 1)) * 8);
          mma16816(acc[dn], fa, f[0], f[1], (T*)nullptr);
          mma16816(acc[dn + 1], fa, f[2], f[3], (T*)nullptr);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its reuse
  }
  cp_async_wait<0>();

  T* dq = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = rows[i];
    if (qp >= a.L) continue;
    T* row = dq + off(a.st, T_OUT0, b, h, qp);
#pragma unroll
    for (int dn = 0; dn < NDT; ++dn) {
      row[dn * 8 + c2] = from_f<T>(acc[dn][2 * i]);
      row[dn * 8 + c2 + 1] = from_f<T>(acc[dn][2 * i + 1]);
    }
  }
}

// dk/dv at head_dim 16 and 32 (the wgmma body takes 64 and 128): the
// block's k and v tiles, then two stages of (q, do) tiles of QT rows and
// their lse and delta.
template <typename T, int D>
struct DkvMma {
  static_assert(D <= 32, "head_dim 64 and 128 take flash_bwd_dkv_wgmma");
  static constexpr int KS = D + 8;
  static constexpr int QT = 64;
  static constexpr size_t bytes =
      (size_t)(2 * BK + 2 * 2 * QT) * KS * sizeof(T) + (size_t)2 * 2 * QT * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkv_mma(const BwdArgs a) {
  constexpr int KS = DkvMma<T, D>::KS;
  constexpr int QT = DkvMma<T, D>::QT;
  constexpr int NQT = QT / 8;     // 8-column n-tiles of the s^T tile
  constexpr int NDT = D / 8;      // 8-column n-tiles of dk / dv
  constexpr int KSTEPS = D / 16;  // 16-deep k-steps over head_dim
  constexpr int CPR = D / 8;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BK * KS;
  T* stg = vs + BK * KS;                                  // [stage][q, do][QT][KS]
  float* rowv = reinterpret_cast<float*>(stg + 2 * 2 * QT * KS);  // [stage][lse, delta][QT]
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int lr = lane & 7, lm = lane >> 3;
  const int k_lo = blockIdx.x * BK;
  const int kw_lo = k_lo + warp * 16;  // this warp's 16 keys
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv, G = a.H / a.Hkv;
  const int keys[2] = {kw_lo + g, kw_lo + g + 8};

  for (int i = tid; i < BK * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, kp = k_lo + r;
    const bool in = kp < a.Lk;
    const int row = in ? kp : 0;
    cp_async16(ks + r * KS + c, k + off(a.st, 1, b, hk, row) + c, in);
    cp_async16(vs + r * KS + c, v + off(a.st, 2, b, hk, row) + c, in);
  }
  cp_async_commit();

  // the queries that can see a key of this tile, for each head of the group
  const int q_begin = a.causal ? k_lo : 0;
  const int q_end = a.window > 0 ? min(a.L, k_lo + BK - 1 + a.window) : a.L;
  const int nqt = q_end > q_begin ? (q_end - q_begin + QT - 1) / QT : 0;
  const int total = G * nqt;

  // start the copies of q tile `it` (head hk * G + it / nqt) into stage st;
  // lse and delta go through registers
  auto load_tile = [&](int st, int it) {
    const int h = hk * G + it / nqt, q0 = q_begin + (it % nqt) * QT;
    T* qs = stg + st * 2 * QT * KS;
    T* dos = qs + QT * KS;
    for (int i = tid; i < QT * CPR; i += MMA_THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, qp = q0 + r;
      const bool in = qp < a.L;
      const int row = in ? qp : 0;
      cp_async16(qs + r * KS + c, q + off(a.st, 0, b, h, row) + c, in);
      cp_async16(dos + r * KS + c, dout + off(a.st, 3, b, h, row) + c, in);
    }
    cp_async_commit();
    float* rv = rowv + st * 2 * QT;
    for (int i = tid; i < QT; i += MMA_THREADS)
      row_stats(a, b * a.H + h, q0 + i, rv[i], rv[QT + i]);
  };
  if (total > 0) load_tile(0, 0);

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  int stage = 0;
  for (int it = 0; it < total; ++it, stage ^= 1) {
    if (it + 1 < total) {
      load_tile(stage ^ 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and the k/v tiles) landed for every thread
    const T* qs = stg + stage * 2 * QT * KS;
    const T* dos = qs + QT * KS;
    const float* lse_s = rowv + stage * 2 * QT;
    const float* dl_s = lse_s + QT;
    const int q0 = q_begin + (it % nqt) * QT;
    // a q tile wholly masked for this warp's keys changes nothing
    const bool skip = (a.causal && q0 + QT - 1 < kw_lo) ||
                      (a.window > 0 && q0 - (kw_lo + 15) >= a.window);
    if (!skip) {
      float s[NQT][4], dp[NQT][4];
#pragma unroll
      for (int nt = 0; nt < NQT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      // s^T = k.q^T and dp^T = v.do^T: q and do rows are the n index
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, ks + (warp * 16 + (lane & 15)) * KS + kk * 16 + (lane >> 4) * 8);
        ldsm_x4(va, vs + (warp * 16 + (lane & 15)) * KS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NQT; nt += 2) {
          uint32_t f[4];
          const int at = ((nt + (lm >> 1)) * 8 + lr) * KS + kk * 16 + (lm & 1) * 8;
          ldsm_x4(f, qs + at);
          mma16816(s[nt], ka, f[0], f[1], (T*)nullptr);
          mma16816(s[nt + 1], ka, f[2], f[3], (T*)nullptr);
          ldsm_x4(f, dos + at);
          mma16816(dp[nt], va, f[0], f[1], (T*)nullptr);
          mma16816(dp[nt + 1], va, f[2], f[3], (T*)nullptr);
        }
      }
      // p^T in place of s, ds^T in place of dp
#pragma unroll
      for (int nt = 0; nt < NQT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + c2 + (e & 1), qp = q0 + qi;
          const float p = qp < a.L && visible(qp, keys[e >> 1], a.Lk, a.causal, a.window)
                              ? expf(s[nt][e] * a.scale - lse_s[qi]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dl_s[qi]) * a.scale;
        }
      // dv += p^T.do and dk += ds^T.q: do and q rows are the k index
#pragma unroll
      for (int j = 0; j < QT / 16; ++j) {
        const uint32_t pa[4] = {
            pack2<T>(s[2 * j][0], s[2 * j][1]), pack2<T>(s[2 * j][2], s[2 * j][3]),
            pack2<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
            pack2<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
        const uint32_t sa[4] = {
            pack2<T>(dp[2 * j][0], dp[2 * j][1]), pack2<T>(dp[2 * j][2], dp[2 * j][3]),
            pack2<T>(dp[2 * j + 1][0], dp[2 * j + 1][1]),
            pack2<T>(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
        for (int dn = 0; dn < NDT; dn += 2) {
          uint32_t f[4];
          const int at = (j * 16 + (lm & 1) * 8 + lr) * KS + (dn + (lm >> 1)) * 8;
          ldsm_x4_t(f, dos + at);
          mma16816(dv[dn], pa, f[0], f[1], (T*)nullptr);
          mma16816(dv[dn + 1], pa, f[2], f[3], (T*)nullptr);
          ldsm_x4_t(f, qs + at);
          mma16816(dk[dn], sa, f[0], f[1], (T*)nullptr);
          mma16816(dk[dn + 1], sa, f[2], f[3], (T*)nullptr);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its reuse
  }
  cp_async_wait<0>();

  T* dkp = static_cast<T*>(a.out0);
  T* dvp = static_cast<T*>(a.out1);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = keys[i];
    if (kp >= a.Lk) continue;
    T* rk = dkp + off(a.st, 4, b, hk, kp);
    T* rv = dvp + off(a.st, 5, b, hk, kp);
#pragma unroll
    for (int dn = 0; dn < NDT; ++dn) {
      rk[dn * 8 + c2] = from_f<T>(dk[dn][2 * i]);
      rk[dn * 8 + c2 + 1] = from_f<T>(dk[dn][2 * i + 1]);
      rv[dn * 8 + c2] = from_f<T>(dv[dn][2 * i]);
      rv[dn * 8 + c2 + 1] = from_f<T>(dv[dn][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv wgmma body (bf16 / fp16, head_dim 64 and 128)
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BK = 128;       // keys per block: two consumer warpgroups of 64
constexpr int BQ = 64;        // q rows per streamed tile
constexpr int STAGES = 2;     // (q, do, lse, delta) ring depth
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;
}  // namespace wg

// K and V [half][BK][64] for the whole block, then per stage q and do
// [half][BQ][64] and the tile's lse * log2(e) and delta, then the mbarriers.
template <int D>
struct DkvSmem {
  static constexpr int KV_BYTES = wg::BK * D * 2;
  static constexpr int Q_BYTES = wg::BQ * D * 2;
  static constexpr int STAGE_ELEMS = 2 * wg::BQ * D;
  static constexpr size_t bytes =
      1024 + 2 * KV_BYTES + wg::STAGES * (2 * Q_BYTES + 2 * wg::BQ * 4) + 64;
};

// One block per (128-key tile, batch and kv head, split).  The block walks
// its share of the GQA group's (query head, visible 64-row q tile) list,
// head-major: all of it (nsplit = 1, outputs dk/dv in T), or chunk
// blockIdx.z of nsplit equal chunks (outputs an f32 partial at head index
// hk * nsplit + chunk of a [B, Hkv * nsplit, Lk, D] scratch, summed by the
// caller in a fixed order).
template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(wg::THREADS, 1) flash_bwd_dkv_wgmma(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const BwdArgs a) {
  constexpr int BQ = wg::BQ, BK = wg::BK, STAGES = wg::STAGES;
  constexpr float LOG2E = wg::LOG2E;
  using S = DkvSmem<D>;
  constexpr int HALVES = D / 64;
  constexpr int NO = D / 2;  // dk / dv accumulators a thread (m64nD)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_base1024(smem_raw);
  T* ks = reinterpret_cast<T*>(base);  // [half][BK][64]
  T* vs = ks + BK * D;
  T* stg = vs + BK * D;  // [stage][q, do][half][BQ][64]
  float* rowv = reinterpret_cast<float*>(stg + STAGES * S::STAGE_ELEMS);  // [stage][lse, delta][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rowv + STAGES * 2 * BQ);
  uint64_t* full = kv_full + 1;     // [stage]: every producer lane arrives
  uint64_t* empty = full + STAGES;  // [stage]: one arrival per consumer warp

  const int tid = threadIdx.x, wgi = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  const int k_lo = blockIdx.x * BK;
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv, G = a.H / a.Hkv;
  // the queries that can see a key of this tile, for each head of the group
  const int q_begin = a.causal ? k_lo : 0;
  const int q_end = a.window > 0 ? min(a.L, k_lo + BK - 1 + a.window) : a.L;
  const int nqt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int total = G * nqt;
  const int it_lo = (int)((int64_t)blockIdx.z * total / a.nsplit);
  const int n_items = (int)((int64_t)(blockIdx.z + 1) * total / a.nsplit) - it_lo;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi == 0) {
    setmaxnreg_dec<24>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_tx(kv_full, 2 * S::KV_BYTES);
        for (int hf = 0; hf < HALVES; ++hf) {
          tma_load4(ks + hf * BK * 64, &tk, kv_full, hf * 64, hk, k_lo, b);
          tma_load4(vs + hf * BK * 64, &tv, kv_full, hf * 64, hk, k_lo, b);
        }
      }
      for (int i = 0; i < n_items; ++i) {
        const int st = i % STAGES, use = i / STAGES;
        if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
        const int it = it_lo + i, h = hk * G + it / nqt, q0 = q_begin + (it % nqt) * BQ;
        // lse (a fully masked row's NEG_INF taken as 0) and delta, 0 past L
        float* rv = rowv + st * 2 * BQ;
        const int64_t rb = (int64_t)(b * a.H + h) * a.L;
        for (int r = lane; r < BQ; r += 32) {
          const int qp = q0 + r;
          float ls = 0.f, dl = 0.f;
          if (qp < a.L) {
            const float x = a.lse[rb + qp];
            ls = x <= NEG_INF / 2 ? 0.f : x * LOG2E;
            dl = a.delta[rb + qp];
          }
          rv[r] = ls;
          rv[BQ + r] = dl;
        }
        if (lane == 0) {
          T* qd = stg + st * S::STAGE_ELEMS;
          mbar_arrive_tx(full + st, 2 * S::Q_BYTES);
          for (int hf = 0; hf < HALVES; ++hf) {
            tma_load4(qd + hf * BQ * 64, &tq, full + st, hf * 64, h, q0, b);
            tma_load4(qd + BQ * D + hf * BQ * 64, &tdo, full + st, hf * 64, h, q0, b);
          }
        } else {
          mbar_arrive(full + st);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int c = wgi - 1;  // consumer: keys kw_lo .. kw_lo + 63
    const int kw_lo = k_lo + 64 * c;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const int keys[2] = {kw_lo + warp * 16 + g, kw_lo + warp * 16 + g + 8};
    const float sl2 = a.scale * LOG2E;
    float dk[NO], dv[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) dk[e] = dv[e] = 0.f;
    mbar_wait(kv_full, 0);

    for (int i = 0; i < n_items; ++i) {
      const int st = i % STAGES, ph = (i / STAGES) & 1;
      const int it = it_lo + i, q0 = q_begin + (it % nqt) * BQ;
      // a q tile wholly masked for these 64 keys (warpgroup-uniform)
      const bool skip = (a.causal && q0 + BQ - 1 < kw_lo) ||
                        (a.window > 0 && q0 - (kw_lo + 63) >= a.window);
      mbar_wait(full + st, ph);
      if (!skip) {
        const T* qt = stg + st * S::STAGE_ELEMS;
        const T* dot = qt + BQ * D;
        const float* rv = rowv + st * 2 * BQ;
        // s^T = K.q^T and dp^T = V.do^T: accumulator e is key
        // keys[(e >> 1) & 1], query q0 + 8 (e / 4) + c2 + (e & 1)
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int ao = (kk / 4) * BK * 64 + c * 64 * 64 + (kk % 4) * 16;
          const int bo = (kk / 4) * BQ * 64 + (kk % 4) * 16;
          wgmma_ss(s, desc_sw128(ks + ao, 16, 1024), desc_sw128(qt + bo, 16, 1024), kk > 0,
                   (T*)nullptr);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int ao = (kk / 4) * BK * 64 + c * 64 * 64 + (kk % 4) * 16;
          const int bo = (kk / 4) * BQ * 64 + (kk % 4) * 16;
          wgmma_ss(dp, desc_sw128(vs + ao, 16, 1024), desc_sw128(dot + bo, 16, 1024), kk > 0,
                   (T*)nullptr);
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(s);
        reg_fence(dp);

        // p^T in place of s, ds^T = p (dp - delta) scale in place of dp;
        // the element mask only on tiles at the diagonal, the window edge
        // or the ends of q and k
        const bool edge = q0 + BQ > a.L || kw_lo + 63 >= a.Lk ||
                          (a.causal && kw_lo + 63 > q0) ||
                          (a.window > 0 && q0 + BQ - 1 - kw_lo >= a.window);
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int qi = (e / 4) * 8 + c2 + (e & 1);
          float p = exp2f(fmaf(s[e], sl2, -rv[qi]));
          if (edge && !(q0 + qi < a.L &&
                        visible(q0 + qi, keys[(e >> 1) & 1], a.Lk, a.causal, a.window)))
            p = 0.f;
          s[e] = p;
          dp[e] = p * (dp[e] - rv[BQ + qi]) * a.scale;
        }
        uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j) {
          acc_to_a<T>(s, j, pa[j]);
          acc_to_a<T>(dp, j, sa[j]);
        }
        // dv += p^T.do and dk += ds^T.q: do and q [q rows][D] are MN-major
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j) {
          wgmma_rs(dv, pa[j], desc_sw128(dot + j * 16 * 64, BQ * 128, 1024), (T*)nullptr);
          wgmma_rs(dk, sa[j], desc_sw128(qt + j * 16 * 64, BQ * 128, 1024), (T*)nullptr);
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(dk);
        reg_fence(dv);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }

    OutT* dkp = static_cast<OutT*>(a.out0);
    OutT* dvp = static_cast<OutT*>(a.out1);
    const int oh = a.nsplit > 1 ? hk * a.nsplit + blockIdx.z : hk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = keys[r];
      if (kp >= a.Lk) continue;
      OutT* rk = dkp + off(a.st, 4, b, oh, kp);
      OutT* rv = dvp + off(a.st, 5, b, oh, kp);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int e = 4 * j + 2 * r;
        if constexpr (std::is_same<OutT, float>::value) {
          *reinterpret_cast<float2*>(rk + 8 * j + c2) = make_float2(dk[e], dk[e + 1]);
          *reinterpret_cast<float2*>(rv + 8 * j + c2) = make_float2(dv[e], dv[e + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(rk + 8 * j + c2) = pack2<T>(dk[e], dk[e + 1]);
          *reinterpret_cast<uint32_t*>(rv + 8 * j + c2) = pack2<T>(dv[e], dv[e + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dq wgmma body (bf16 / fp16, head_dim 64 and 128)
// ---------------------------------------------------------------------------

namespace wq {
constexpr int BQ = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int BK = 128;  // keys per streamed tile
}  // namespace wq

// q and do [half][BQ][64] for the whole block, then per stage K and V
// [half][BK][64], then the mbarriers.
template <int D>
struct DqSmem {
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = wq::BQ * D * 2;
  static constexpr int KV_BYTES = wq::BK * D * 2;
  static constexpr size_t bytes = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 128;
};

// One block per (batch and head, 128-row q tile), heaviest q tiles first.
template <typename T, int D>
__global__ void __launch_bounds__(wg::THREADS, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const BwdArgs a) {
  using S = DqSmem<D>;
  constexpr int BQ = wq::BQ, BK = wq::BK, STAGES = S::STAGES;
  constexpr float LOG2E = wg::LOG2E;
  constexpr int HALVES = D / 64;
  constexpr int NS = BK / 2;  // score accumulators a thread (m64nBK)
  constexpr int NO = D / 2;   // dq accumulators a thread (m64nD)
  // bf16 has f32's exponent range, so ds / scale rounds to it with the same
  // relative error as ds: scale dq once at the end instead of every ds
  constexpr bool DEFER_SCALE = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_base1024(smem_raw);
  T* qs = reinterpret_cast<T*>(base);  // [half][BQ][64]
  T* dos = qs + BQ * D;                // [half][BQ][64]
  T* ks = dos + BQ * D;                // [stage][half][BK][64]
  T* vs = ks + STAGES * BK * D;        // [stage][half][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * BK * D);
  uint64_t* k_full = q_full + 1;       // [stage]
  uint64_t* v_full = k_full + STAGES;  // [stage]
  uint64_t* empty = v_full + STAGES;   // [stage]: one arrival per consumer warp

  const int tid = threadIdx.x, wgi = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);
  // the key tiles the forward visits for these rows
  const int kv_lo = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(a.Lk, q_lo + BQ) : a.Lk;
  const int n_tiles = (kv_hi - kv_lo + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: one thread issues every load
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_tx(q_full, 2 * S::Q_BYTES);
      for (int hf = 0; hf < HALVES; ++hf) {
        tma_load4(qs + hf * BQ * 64, &tq, q_full, hf * 64, h, q_lo, b);
        tma_load4(dos + hf * BQ * 64, &tdo, q_full, hf * 64, h, q_lo, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES, use = i / STAGES;
        if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
        const int t0 = kv_lo + i * BK;
        T* kd = ks + st * BK * D;
        T* vd = vs + st * BK * D;
        mbar_arrive_tx(k_full + st, S::KV_BYTES);
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load4(kd + hf * BK * 64, &tk, k_full + st, hf * 64, hk, t0, b);
        mbar_arrive_tx(v_full + st, S::KV_BYTES);
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load4(vd + hf * BK * 64, &tv, v_full + st, hf * 64, hk, t0, b);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int c = wgi - 1;  // consumer: q rows r0 .. r0 + 63
    const int r0 = q_lo + 64 * c;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
    const float sl2 = a.scale * LOG2E;
    // lse * log2(e) and delta of this thread's rows, while the tiles land
    float ls[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] = row_lse(a, bh, rows[r]) * LOG2E;
      dl[r] = row_delta<T, D>(a, b, h, rows[r], lane & 3, true);
    }
    float dq[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) dq[e] = 0.f;
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES, ph = (i / STAGES) & 1;
      const int t0 = kv_lo + i * BK;
      const T* kt = ks + st * BK * D;
      const T* vt = vs + st * BK * D;
      // wholly masked for these 64 rows: nothing to do (warpgroup-uniform)
      const bool skip =
          (a.causal && t0 > r0 + 63) || (a.window > 0 && r0 - (t0 + BK - 1) >= a.window);
      mbar_wait(k_full + st, ph);
      if (!skip) {
        // s = Q.K^T and dp = dO.V^T: accumulator e is row rows[(e >> 1) & 1],
        // key t0 + 8 (e / 4) + c2 + (e & 1)
        float s[NS], dp[NS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int ao = (kk / 4) * BQ * 64 + c * 64 * 64 + (kk % 4) * 16;
          const int bo = (kk / 4) * BK * 64 + (kk % 4) * 16;
          wgmma_ss(s, desc_sw128(qs + ao, 16, 1024), desc_sw128(kt + bo, 16, 1024), kk > 0,
                   (T*)nullptr);
        }
        wgmma_commit();
        mbar_wait(v_full + st, ph);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int ao = (kk / 4) * BQ * 64 + c * 64 * 64 + (kk % 4) * 16;
          const int bo = (kk / 4) * BK * 64 + (kk % 4) * 16;
          wgmma_ss(dp, desc_sw128(dos + ao, 16, 1024), desc_sw128(vt + bo, 16, 1024), kk > 0,
                   (T*)nullptr);
        }
        wgmma_commit();
        // s is done (dp may still run): p in place of s while dp finishes;
        // the element mask only where the tile straddles the diagonal, the
        // window edge or the end of the keys (rows past L have q = do = 0
        // and lse = delta = 0, so their ds is 0)
        wgmma_wait<1>();
        reg_fence(s);
        const bool edge = t0 + BK > a.Lk || (a.causal && t0 + BK - 1 > r0) ||
                          (a.window > 0 && r0 + 63 - t0 >= a.window);
#pragma unroll
        for (int e = 0; e < NS; ++e) {
          const int r = (e >> 1) & 1;
          float p = exp2_ftz(fmaf(s[e], sl2, -ls[r]));
          if (edge && !visible(rows[r], t0 + (e / 4) * 8 + c2 + (e & 1), a.Lk, a.causal,
                               a.window))
            p = 0.f;
          s[e] = p;
        }
        wgmma_wait0();
        reg_fence(dp);
        // ds = p (dp - delta) scale (bf16: without the scale), rounded to T
        // as the A operand
        uint32_t da[BK / 16][4];
#pragma unroll
        for (int e = 0; e < NS; ++e) {
          const float d = dp[e] - dl[(e >> 1) & 1];
          s[e] *= DEFER_SCALE ? d : d * a.scale;
        }
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) acc_to_a<T>(s, j, da[j]);

        // dq += ds.K: K [keys][D] is the MN-major B operand
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
          wgmma_rs(dq, da[j], desc_sw128(kt + j * 16 * 64, BK * 128, 1024), (T*)nullptr);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(dq);
      } else {
        mbar_wait(v_full + st, ph);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    if constexpr (DEFER_SCALE) {
#pragma unroll
      for (int e = 0; e < NO; ++e) dq[e] *= a.scale;
    }

    T* dqp = static_cast<T*>(a.out0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = rows[r];
      if (qp >= a.L) continue;
      T* row = dqp + off(a.st, T_OUT0, b, h, qp);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + c2) =
            pack2<T>(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int run(Kernel kern, dim3 grid, int threads, size_t smem, const BwdArgs& a,
        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// A wgmma body: tensor maps over q and do (boxes of q_rows rows) and k and v
// (boxes of k_rows), then the launch.
template <typename T, int D, typename Kernel>
int run_tma(Kernel kern, dim3 grid, size_t smem, int q_rows, int k_rows, const BwdArgs& a,
            cudaStream_t s) {
  constexpr int dtype = std::is_same<T, __nv_bfloat16>::value ? 1 : 2;
  const int64_t* st = a.st.s;
  CUtensorMap mq, mk, mv, mdo;
  int e = make_map(&mq, a.q, dtype, D, a.H, a.L, a.B, st[0], st[1], st[2], q_rows);
  if (!e) e = make_map(&mk, a.k, dtype, D, a.Hkv, a.Lk, a.B, st[3], st[4], st[5], k_rows);
  if (!e) e = make_map(&mv, a.v, dtype, D, a.Hkv, a.Lk, a.B, st[6], st[7], st[8], k_rows);
  if (!e) e = make_map(&mdo, a.dout, dtype, D, a.H, a.L, a.B, st[9], st[10], st[11], q_rows);
  if (e) return e;
  cudaError_t r = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (r != cudaSuccess) return (int)r;
  kern<<<grid, wg::THREADS, smem, s>>>(mq, mk, mv, mdo, a);
  return (int)cudaGetLastError();
}

// which: 0 = dq, 1 = dk/dv.  The body for a type and head_dim is a static
// choice; only the dk/dv wgmma body takes nsplit > 1.
template <typename T, int D>
int launch(int which, const BwdArgs& a, cudaStream_t s) {
  const dim3 dq_grid(a.B * a.H, (a.L + BQ - 1) / BQ);
  const dim3 dkv_grid((a.Lk + BK - 1) / BK, a.B * a.Hkv);
  constexpr bool wgmma = !std::is_same<T, float>::value && D >= 64;
  if (a.nsplit < 1 || (a.nsplit > 1 && (which == 0 || !wgmma)))
    return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    if (which == 0) return run(flash_bwd_dq_fma<D>, dq_grid, NT, DqFma<D>::bytes, a, s);
    return run(flash_bwd_dkv_fma<D>, dkv_grid, NT, DkvFma<D>::bytes, a, s);
  } else if constexpr (wgmma) {
    if (which == 0)
      return run_tma<T, D>(flash_bwd_dq_wgmma<T, D>,
                           dim3(a.B * a.H, (a.L + wq::BQ - 1) / wq::BQ), DqSmem<D>::bytes,
                           wq::BQ, wq::BK, a, s);
    const dim3 grid((a.Lk + wg::BK - 1) / wg::BK, a.B * a.Hkv, a.nsplit);
    const size_t smem = DkvSmem<D>::bytes;
    return a.nsplit > 1 ? run_tma<T, D>(flash_bwd_dkv_wgmma<T, float, D>, grid, smem, wg::BQ,
                                        wg::BK, a, s)
                        : run_tma<T, D>(flash_bwd_dkv_wgmma<T, T, D>, grid, smem, wg::BQ,
                                        wg::BK, a, s);
  } else {
    if (which == 0)
      return run(flash_bwd_dq_mma<T, D>, dq_grid, MMA_THREADS, DqMma<T, D>::bytes, a, s);
    return run(flash_bwd_dkv_mma<T, D>, dkv_grid, MMA_THREADS, DkvMma<T, D>::bytes, a, s);
  }
}

template <typename T>
int dispatch_d(int which, int D, const BwdArgs& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(which, a, s);
    case 32: return launch<T, 32>(which, a, s);
    case 64: return launch<T, 64>(which, a, s);
    case 128: return launch<T, 128>(which, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int which, int dtype, int D, const BwdArgs& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(which, D, a, s);
    case 1: return dispatch_d<__nv_bfloat16>(which, D, a, s);
    case 2: return dispatch_d<__half>(which, D, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, void* delta, void* out0, void* out1, int B,
                  int H, int Hkv, int L, int Lk, const int64_t* strides, int n_strides,
                  float scale, int causal, int window, int nsplit) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.out0 = out0;
  a.out1 = out1;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.L = L;
  a.Lk = Lk;
  for (int i = 0; i < n_strides; ++i) a.st.s[i] = strides[i];
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.nsplit = nsplit;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q, do, o [B, H, L, D];
// k, v [B, Hkv, Lk, D]; lse, delta contiguous [B, H, L] float32.  strides:
// (batch, head, row) element strides of q, k, v, do, then the outputs, then
// o (dq only), each with a contiguous last dim.  window <= 0 means none.
// Each returns the cudaError_t of its launch (0 = launched), or for the
// wgmma bodies flash::NO_ENCODER / flash::MAP_ERROR + CUresult when a
// tensor map cannot be made.

// dq [B, H, L, D] in the input type, and delta = rowsum(do * o) into
// `delta`; 18 strides (q, k, v, do, dq, o).
extern "C" int k8s_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* o, const void* lse,
                                void* delta, void* dq, int dtype, int B, int H, int Hkv,
                                int L, int Lk, int D, const int64_t* strides, float scale,
                                int causal, int window, void* stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, delta, dq, nullptr, B, H, Hkv, L, Lk, strides,
                        15, scale, causal, window, 1);
  a.o = o;
  for (int i = 0; i < 3; ++i) a.st.s[3 * T_O + i] = strides[15 + i];
  return dispatch(0, dtype, D, a, stream);
}

// dk, dv [B, Hkv, Lk, D] in the input type, each summed over its GQA group,
// from the delta the dq launch wrote; 18 strides (q, k, v, do, dk, dv).
// With nsplit > 1 (wgmma body only) dk and dv are instead f32 [B, Hkv *
// nsplit, Lk, D] partials, chunk z of kv head hk at head index
// hk * nsplit + z, for the caller to sum over z.
extern "C" int k8s_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int dtype, int B, int H, int Hkv,
                                 int L, int Lk, int D, const int64_t* strides,
                                 float scale, int causal, int window, int nsplit,
                                 void* stream) {
  const BwdArgs a = make_args(q, k, v, dout, lse, const_cast<void*>(delta), dk, dv, B, H,
                              Hkv, L, Lk, strides, 18, scale, causal, window, nsplit);
  return dispatch(1, dtype, D, a, stream);
}

// The dynamic shared memory of the body k8s_flash_bwd_dq (which = 0) or
// k8s_flash_bwd_dkv (which = 1) launches for dtype and D (a report for the
// smoke test), or -1.
extern "C" int k8s_flash_bwd_smem(int which, int dtype, int D) {
  if ((D != 16 && D != 32 && D != 64 && D != 128) || dtype < 0 || dtype > 2) return -1;
  if (dtype == 0) {
    switch (D) {
      case 16: return (int)(which ? DkvFma<16>::bytes : DqFma<16>::bytes);
      case 32: return (int)(which ? DkvFma<32>::bytes : DqFma<32>::bytes);
      case 64: return (int)(which ? DkvFma<64>::bytes : DqFma<64>::bytes);
      default: return (int)(which ? DkvFma<128>::bytes : DqFma<128>::bytes);
    }
  }
  switch (D) {
    case 16: return (int)(which ? DkvMma<__half, 16>::bytes : DqMma<__half, 16>::bytes);
    case 32: return (int)(which ? DkvMma<__half, 32>::bytes : DqMma<__half, 32>::bytes);
    case 64: return (int)(which ? DkvSmem<64>::bytes : DqSmem<64>::bytes);
    default: return (int)(which ? DkvSmem<128>::bytes : DqSmem<128>::bytes);
  }
}
