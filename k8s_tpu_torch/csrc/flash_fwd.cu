// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel k8s_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd).  Same function: blockwise attention with an
// online softmax, running max / sum / accumulator in f32, masked scores set
// to NEG_INF = -1e30 (not -inf), a fully masked row giving o = 0 and
// lse = NEG_INF; causal, sliding-window and bidirectional; returns o in the
// input dtype and lse in f32.
//
// What bounds it on this card: at the serving shapes (D = 128, L in the
// hundreds to thousands) attention does ~L/2 operations per byte it must
// move, far above the H100's ~295 ops/byte line, so the bound is the
// tensor cores' arithmetic, not HBM.  The TPU kernel's sequential k grid
// with VMEM scratch becomes a loop inside one thread block:
//   - one block per (batch, head, 64-row q tile), heaviest causal tiles
//     scheduled first;
//   - k/v stream through shared memory 64 rows at a time; only tiles that
//     hold a visible key are visited (causal: none wholly in the future;
//     window: from max(0, q_lo - window + 1), the visibility rule of
//     _window_visible);
//   - m, l and the output accumulator stay in f32 registers;
//   - GQA reads kv head h / (H / Hkv) directly, no repeated K/V;
//   - q/k/v/o are read and written through (batch, head, row) strides, so
//     both the [B, L, H, D] and [B, H, L, D] layouts need no copies;
//   - ragged L and Lk are masked inside the tile (no divisor block sizes).
// Two bodies, chosen by the input type:
//   - bf16 / fp16 (the served path): flash_fwd_mma, four warps of 16 q rows
//     each; q.k^T and p.v run on the tensor cores as mma.sync m16n8k16 with
//     f32 accumulation; the q fragments stay in registers, k/v tiles come
//     in through a two-stage cp.async pipeline and reach the tensor cores
//     through ldmatrix (.trans for v), and the score tile's accumulator
//     layout is reused directly as the A operand of p.v (p rounded to the
//     input type, as flash kernels on GPUs do);
//   - f32 (exact f32 arithmetic, as the tiny test model needs):
//     flash_fwd_fma, f32 FMAs on the CUDA cores over a q tile held in
//     shared memory.
// Not yet done: TMA, wgmma and warp specialisation, which is the way to
// the bound.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // k rows per streamed tile
constexpr int NT = 256;  // fma body: 16 x 16 threads, each 4 rows x 4 cols of S
constexpr int MMA_THREADS = 128;  // mma body: 4 warps x 16 q rows

// fma body (f32 inputs): q, k, v and p tiles in shared memory; q/k rows
// padded by one word so the 16 threads reading one column from 16 different
// rows hit 16 different banks.
template <typename T, int D>
struct Tiles {
  static constexpr int QS = D + 1;
  static constexpr int PS = BK + 1;
  static constexpr size_t bytes =
      (size_t)(BQ * QS + BK * QS + BK * D) * sizeof(T) + (size_t)BQ * PS * sizeof(float);
};

// mma body: two stages of k and v tiles in shared memory (the next tile
// streams in with cp.async while the current one is used), rows padded by 16
// bytes so the 8 row addresses of each ldmatrix hit different banks.
template <typename T, int D>
struct MmaTiles {
  static constexpr int KS = D + 8;
  static constexpr size_t bytes = (size_t)2 * 2 * BK * KS * sizeof(T);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_fma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int L, int Lk,
    int64_t q_sb, int64_t q_sh, int64_t q_sl, int64_t k_sb, int64_t k_sh,
    int64_t k_sl, int64_t v_sb, int64_t v_sh, int64_t v_sl, int64_t o_sb,
    int64_t o_sh, int64_t o_sl, float scale, int causal, int window) {
  constexpr int QS = Tiles<T, D>::QS;
  constexpr int PS = Tiles<T, D>::PS;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * QS;
  T* vs = ks + BK * QS;
  float* ps = reinterpret_cast<float*>(vs + BK * D);

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: cols tx + 16 j
  const int ty = tid >> 4;  // row group: rows ty + 16 i
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, qp = q_lo + r;
    qs[r * QS + d] = qp < L ? qb[(int64_t)qp * q_sl + d] : from_f<T>(0.f);
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_hi = causal ? min(Lk, q_lo + BQ) : Lk;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += BK) {
    __syncthreads();  // the previous tile's k/v/p reads are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D, kp = t0 + r;
      const bool in = kp < Lk;
      ks[r * QS + d] = in ? kb[(int64_t)kp * k_sl + d] : from_f<T>(0.f);
      vs[r * D + d] = in ? vb[(int64_t)kp * v_sl + d] : from_f<T>(0.f);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_lo + ty + 16 * i;
      bool keep[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t0 + tx + 16 * j;
        keep[j] = visible(qp, kp, Lk, causal, window);
        s[i][j] = keep[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 64 scores live on the 16 lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float safe_m = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = m[i] <= NEG_INF / 2 ? 0.f : expf(m[i] - safe_m);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - safe_m) : 0.f;
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();  // p tile complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        const float vv = vs[kk * D + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_lo + ty + 16 * i;
    if (qp >= L) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* ob = o + b * o_sb + h * o_sh + (int64_t)qp * o_sl;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) ob[tx + 16 * jd] = from_f<T>(acc[i][jd] / den);
    if (tx == 0)
      lse[(int64_t)bh * L + qp] = m[i] <= NEG_INF / 2 ? NEG_INF : m[i] + logf(den);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int L, int Lk,
    int64_t q_sb, int64_t q_sh, int64_t q_sl, int64_t k_sb, int64_t k_sh,
    int64_t k_sl, int64_t v_sb, int64_t v_sh, int64_t v_sl, int64_t o_sb,
    int64_t o_sh, int64_t o_sl, float scale, int causal, int window) {
  constexpr int KS = MmaTiles<T, D>::KS;
  constexpr int NKT = BK / 8;     // 8-column n-tiles of the score tile
  constexpr int NDT = D / 8;      // 8-column n-tiles of the output
  constexpr int KSTEPS = D / 16;  // 16-deep k-steps of q.k^T
  constexpr int CPR = D / 8;      // 16-byte chunks per k/v row
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [stage][k, v][BK][KS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;        // fragment row (and row + 8)
  const int c2 = (lane & 3) * 2;  // fragment column pair
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int w_lo = q_lo + warp * 16;  // this warp's 16 q rows
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int rows[2] = {w_lo + g, w_lo + g + 8};

  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_hi = causal ? min(Lk, q_lo + BQ) : Lk;

  // start the copies of the k/v tile beginning at key t0 into stage st
  auto load_tile = [&](int st, int t0) {
    T* ks = tiles + st * 2 * BK * KS;
    T* vs = ks + BK * KS;
    for (int i = tid; i < BK * CPR; i += MMA_THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, kp = t0 + r;
      const bool in = kp < Lk;
      const int64_t row = in ? kp : 0;
      cp_async16(ks + r * KS + c, kb + row * k_sl + c, in);
      cp_async16(vs + r * KS + c, vb + row * v_sl + c, in);
    }
    cp_async_commit();
  };
  if (kv_lo < kv_hi) load_tile(0, kv_lo);

  // A fragments of q (rows g / g+8, columns c2 / c2+8 of each k-step),
  // held in registers for the whole k loop
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rows[j & 1];
      qa[kk][j] = r < L ? *reinterpret_cast<const uint32_t*>(
                              qb + (int64_t)r * q_sl + kk * 16 + (j >> 1) * 8 + c2)
                        : 0u;
    }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NDT][4];
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  // ldmatrix row addresses: lane l reads row l % 8 of matrix l / 8
  const int lr = lane & 7, lm = lane >> 3;
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
    // a tile wholly masked for this warp's rows changes nothing: skip its
    // arithmetic (warp-uniform, so the shuffles below stay converged)
    const bool skip = (causal && w_lo + 15 < t0) ||
                      (window > 0 && w_lo - (t0 + BK - 1) >= window);
    if (!skip) {
      float s[NKT][4];
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      // K as the B operand: matrices (keys nt.., d lo), (keys nt.., d hi),
      // (keys nt+1.., d lo), (keys nt+1.., d hi)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int nt = 0; nt < NKT; nt += 2) {
          uint32_t kf[4];
          ldsm_x4(kf, ks + ((nt + (lm >> 1)) * 8 + lr) * KS + kk * 16 + (lm & 1) * 8);
          mma16816(s[nt], qa[kk], kf[0], kf[1], (T*)nullptr);
          mma16816(s[nt + 1], qa[kk], kf[2], kf[3], (T*)nullptr);
        }

      // accumulator element e of n-tile nt: row rows[e >> 1], key
      // t0 + nt * 8 + c2 + (e & 1); a row's 64 keys live on one quad
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = rows[e >> 1], kp = t0 + nt * 8 + c2 + (e & 1);
          const bool keep = visible(qp, kp, Lk, causal, window);
          s[nt][e] = keep ? s[nt][e] * scale : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float safe[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        safe[i] = m_new <= NEG_INF / 2 ? 0.f : m_new;
        alpha[i] = m[i] <= NEG_INF / 2 ? 0.f : expf(m[i] - safe[i]);
        m[i] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              s[nt][e] <= NEG_INF / 2 ? 0.f : expf(s[nt][e] - safe[e >> 1]);
          s[nt][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int dn = 0; dn < NDT; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];

      // p.v: the score accumulators of n-tiles 2j, 2j+1 are the A fragment
      // of k-step j; V (keys x d in shared memory) is the B operand through
      // ldmatrix.trans: matrices (keys lo, d dn), (keys hi, d dn),
      // (keys lo, d dn+1), (keys hi, d dn+1)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint32_t pa[4] = {
            pack2<T>(s[2 * j][0], s[2 * j][1]), pack2<T>(s[2 * j][2], s[2 * j][3]),
            pack2<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
            pack2<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int dn = 0; dn < NDT; dn += 2) {
          uint32_t vf[4];
          ldsm_x4_t(vf, vs + (j * 16 + (lm & 1) * 8 + lr) * KS + (dn + (lm >> 1)) * 8);
          mma16816(acc[dn], pa, vf[0], vf[1], (T*)nullptr);
          mma16816(acc[dn + 1], pa, vf[2], vf[3], (T*)nullptr);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its reuse
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = rows[i];
    if (qp >= L) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* ob = o + b * o_sb + h * o_sh + (int64_t)qp * o_sl;
#pragma unroll
    for (int dn = 0; dn < NDT; ++dn) {
      ob[dn * 8 + c2] = from_f<T>(acc[dn][2 * i] / den);
      ob[dn * 8 + c2 + 1] = from_f<T>(acc[dn][2 * i + 1] / den);
    }
    if ((lane & 3) == 0)
      lse[(int64_t)bh * L + qp] = m[i] <= NEG_INF / 2 ? NEG_INF : m[i] + logf(den);
  }
}

template <typename T, typename Kernel>
int run(Kernel kern, int threads, size_t smem, const void* q, const void* k,
        const void* v, void* o, void* lse, int B, int H, int Hkv, int L, int Lk,
        const int64_t* st, float scale, int causal, int window, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + BQ - 1) / BQ, B * H);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, Hkv, L, Lk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
           int H, int Hkv, int L, int Lk, const int64_t* st, float scale,
           int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return run<T>(flash_fwd_fma<T, D>, NT, Tiles<T, D>::bytes, q, k, v, o, lse, B,
                  H, Hkv, L, Lk, st, scale, causal, window, stream);
  else
    return run<T>(flash_fwd_mma<T, D>, MMA_THREADS, MmaTiles<T, D>::bytes, q, k, v,
                  o, lse, B, H, Hkv, L, Lk, st, scale, causal, window, stream);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int H, int Hkv, int L, int Lk, const int64_t* st, float scale,
               int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Hkv, L, Lk, st, scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Hkv, L, Lk, st, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Hkv, L, Lk, st, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Hkv, L, Lk, st, scale, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  strides: 12 element strides,
// (batch, head, row) for q, k, v, o in that order; the last dim is contiguous.
// lse is a contiguous [B, H, L] float32 buffer.  window <= 0 means none.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int k8s_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int dtype, int B, int H, int Hkv, int L,
                             int Lk, int D, const int64_t* strides, float scale,
                             int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, lse, B, H, Hkv, L, Lk, strides, scale, causal, window, s);
    case 1: return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Hkv, L, Lk, strides, scale, causal, window, s);
    case 2: return dispatch_d<__half>(D, q, k, v, o, lse, B, H, Hkv, L, Lk, strides, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
