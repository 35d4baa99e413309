// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of k8s_tpu/ops/flash_attention.py's
// backward (launched by _flash_bwd):
//   - K3 _dq_kernel:  dq = sum_k ds.k;
//   - K4 _dkv_kernel: dv = sum_q p^T.do, dk = sum_q ds^T.q;
// with p = exp(s - lse) recomputed from the forward's saved lse (s the
// scaled, masked score), dp = do.v^T, ds = p * (dp - delta) * scale and
// delta = rowsum(do * o) (an f32 reduction the caller computes, as the
// reference does in XLA).  Masked entries give p = 0, so a fully masked row
// contributes nothing; the element mask is the forward's (flash::visible).
//
// What bounds it on this card: the backward does 2.5x the forward's
// products over the same visible (q, k) pairs (dq: q.k^T, do.v^T, ds.k;
// dk/dv: q.k^T, do.v^T, p^T.do, ds^T.q), far above the H100's ~295 ops/byte
// line at the training shapes, so the tensor cores' arithmetic is the bound.
// The TPU kernels carry dq_acc / dk_acc / dv_acc in VMEM scratch across an
// in-order inner grid axis; on the card one block owns its output tile and
// loops instead:
//   - dq: one block per (batch, head, 64-row q tile), looping over the k
//     tiles the forward visits (causal: none wholly in the future; window:
//     from max(0, q_lo - window + 1));
//   - dk/dv: one block per (batch, KV head, 64-row k tile), looping over the
//     H / Hkv query heads of its GQA group times the q tiles that can see its
//     keys (causal: from k_lo; window: up to k_lo + 63 + window), so the
//     group sum happens in registers, with no atomics, and dk/dv come out
//     deterministic and already [B, Hkv, Lk, D];
//   - the accumulators stay in f32 registers and are written once;
//   - q/k/v/do and the outputs are read and written through (batch, head,
//     row) strides, so the [B, L, H, D] model layout needs no copies;
//   - ragged L and Lk: tail rows are zero-filled on load, masked in the
//     scores, and never written.
// Two bodies per kernel, chosen by the input type:
//   - bf16 / fp16: four warps of 16 rows each on mma.sync m16n8k16 with f32
//     accumulation; tiles come in through cp.async (k/v double-buffered for
//     dq, q/do/lse/delta double-buffered for dk/dv) and reach the tensor
//     cores through ldmatrix; p and ds are rounded to the input type before
//     their products, as the forward rounds p.  At head_dim 128 the dk/dv
//     kernel streams 32-row q tiles so that two f32 [16, 128] accumulators
//     per warp still fit in registers;
//   - f32 (exact f32 arithmetic, as the tiny test model needs): f32 FMAs on
//     the CUDA cores over tiles held in shared memory.
// Not yet done: TMA, wgmma and warp specialisation, which is the way to the
// bound.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;            // dq: q rows per block (fma: also per q tile)
constexpr int BK = 64;            // k rows per block (dk/dv) or per tile (dq)
constexpr int NT = 256;           // fma bodies: 16 x 16 threads
constexpr int MMA_THREADS = 128;  // mma bodies: 4 warps x 16 rows

// (batch, head, row) element strides of q, k, v, do and then the outputs
// (dq; or dk, dv); the last dim is contiguous.
struct Strides {
  int64_t s[18];
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, L] contiguous
  const float* delta;  // [B, H, L] contiguous
  void* out0;          // dq, or dk
  void* out1;          // dv
  int B, H, Hkv, L, Lk;
  Strides st;
  float scale;
  int causal, window;
};

// Offset of (batch b, head h, row r) of tensor t (0 q, 1 k, 2 v, 3 do, 4 out0,
// 5 out1).
__device__ __forceinline__ int64_t off(const Strides& st, int t, int b, int h, int r) {
  return b * st.s[3 * t] + h * st.s[3 * t + 1] + (int64_t)r * st.s[3 * t + 2];
}

// lse with a fully masked row's NEG_INF taken as 0 (the reference's
// safe_lse), and delta; 0 past L.
__device__ __forceinline__ void row_stats(const BwdArgs& a, int bh, int qp, float& lse,
                                          float& delta) {
  if (qp < a.L) {
    const float l = a.lse[(int64_t)bh * a.L + qp];
    lse = l <= NEG_INF / 2 ? 0.f : l;
    delta = a.delta[(int64_t)bh * a.L + qp];
  } else {
    lse = 0.f;
    delta = 0.f;
  }
}

// ---------------------------------------------------------------------------
// f32 bodies
// ---------------------------------------------------------------------------

// dq: q, do, k, v tiles (rows padded by one word) and the ds tile.
template <int D>
struct DqFma {
  static constexpr int QS = D + 1;
  static constexpr int PS = BK + 1;
  static constexpr size_t bytes = (size_t)4 * 64 * QS * 4 + (size_t)BQ * PS * 4;
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
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, qp = q_lo + r;
    const bool in = qp < a.L;
    qs[r * QS + d] = in ? q[off(a.st, 0, b, h, qp) + d] : 0.f;
    dos[r * QS + d] = in ? dout[off(a.st, 3, b, h, qp) + d] : 0.f;
  }
  float lse_r[4], dl_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_stats(a, bh, q_lo + ty + 16 * i, lse_r[i], dl_r[i]);
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
      ks[r * QS + d] = in ? k[off(a.st, 1, b, hk, kp) + d] : 0.f;
      vs[r * QS + d] = in ? v[off(a.st, 2, b, hk, kp) + d] : 0.f;
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
    float* row = dq + off(a.st, 4, b, h, qp);
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

// dq: the block's q and do tiles, then two stages of k and v tiles; rows
// padded by 16 bytes so the 8 row addresses of each ldmatrix hit different
// banks.
template <typename T, int D>
struct DqMma {
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
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int w_lo = q_lo + warp * 16;  // this warp's 16 q rows
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);
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

  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) row_stats(a, bh, rows[i], lse_r[i], dl_r[i]);
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
    T* row = dq + off(a.st, 4, b, h, qp);
#pragma unroll
    for (int dn = 0; dn < NDT; ++dn) {
      row[dn * 8 + c2] = from_f<T>(acc[dn][2 * i]);
      row[dn * 8 + c2 + 1] = from_f<T>(acc[dn][2 * i + 1]);
    }
  }
}

// dk/dv: the block's k and v tiles, then two stages of (q, do) tiles of QT
// rows and their lse and delta.  QT is 32 at head_dim 128, where the two
// [16, 128] f32 accumulators of a warp already take 128 registers a thread.
template <typename T, int D>
struct DkvMma {
  static constexpr int KS = D + 8;
  static constexpr int QT = D >= 128 ? 32 : 64;
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

// which: 0 = dq, 1 = dk/dv
template <typename T, int D>
int launch(int which, const BwdArgs& a, cudaStream_t s) {
  const dim3 dq_grid((a.L + BQ - 1) / BQ, a.B * a.H);
  const dim3 dkv_grid((a.Lk + BK - 1) / BK, a.B * a.Hkv);
  if constexpr (std::is_same<T, float>::value) {
    if (which == 0) return run(flash_bwd_dq_fma<D>, dq_grid, NT, DqFma<D>::bytes, a, s);
    return run(flash_bwd_dkv_fma<D>, dkv_grid, NT, DkvFma<D>::bytes, a, s);
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
                  const void* lse, const void* delta, void* out0, void* out1, int B,
                  int H, int Hkv, int L, int Lk, const int64_t* strides, int n_strides,
                  float scale, int causal, int window) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
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
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q, do [B, H, L, D];
// k, v [B, Hkv, Lk, D]; lse, delta contiguous [B, H, L] float32.  strides:
// (batch, head, row) element strides of q, k, v, do and then the outputs,
// whose last dim is contiguous like the inputs'.  window <= 0 means none.
// Each returns the cudaError_t of its launch (0 = launched).

// dq [B, H, L, D] in the input type; 15 strides (q, k, v, do, dq).
extern "C" int k8s_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int dtype, int B, int H, int Hkv, int L,
                                int Lk, int D, const int64_t* strides, float scale,
                                int causal, int window, void* stream) {
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, dq, nullptr, B, H, Hkv, L, Lk,
                              strides, 15, scale, causal, window);
  return dispatch(0, dtype, D, a, stream);
}

// dk, dv [B, Hkv, Lk, D] in the input type, each summed over its GQA group;
// 18 strides (q, k, v, do, dk, dv).
extern "C" int k8s_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int dtype, int B, int H, int Hkv,
                                 int L, int Lk, int D, const int64_t* strides,
                                 float scale, int causal, int window, void* stream) {
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, L, Lk,
                              strides, 18, scale, causal, window);
  return dispatch(1, dtype, D, a, stream);
}
