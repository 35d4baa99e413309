// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel k8s_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd).  Same function: blockwise attention with an
// online softmax, running max / sum / accumulator in f32, masked scores set
// to NEG_INF = -1e30 (not -inf), a fully masked row giving o = 0 and
// lse = NEG_INF; causal, sliding-window and bidirectional; returns o in the
// input dtype and lse in f32.
//
// What bounds it on this card: at the serving and training shapes (D 64 or
// 128, L in the hundreds to thousands) attention does ~L/2 operations per
// byte it must move, far above the H100's ~295 ops/byte line, so the bound
// is the tensor cores' arithmetic, and only wgmma reaches their full rate.
// The TPU kernel's sequential k grid with VMEM scratch becomes a loop inside
// one thread block; what every body shares:
//   - heaviest causal q tiles are scheduled first;
//   - only k tiles that hold a visible key are visited (causal: none wholly
//     in the future; window: from max(0, q_lo - window + 1), the visibility
//     rule of _window_visible);
//   - m, l and the output accumulator stay in f32 registers;
//   - GQA reads kv head h / (H / Hkv) directly, no repeated K/V;
//   - q/k/v/o are read and written through (batch, head, row) strides, so
//     both the [B, L, H, D] and [B, H, L, D] layouts need no copies;
//   - ragged L and Lk need no divisor block sizes.
// Four bodies; the caller's plan (ops/flash_attention.py:_fwd_plan) names
// one and the padded head_dim Dp it runs at.  A tiled body built for Dp
// takes any real head_dim D <= Dp: columns D..Dp read as zeros (TMA's
// out-of-bounds fill for wgmma, masked loads elsewhere), so q.k^T, the
// softmax and p.v are exact, and o is written for its first D columns only:
//   - bf16 / fp16, D a multiple of 8 in 33..256, rows a tensor map can
//     describe: flash_fwd_wgmma at Dp 64, 96, 128 or 256.  One block per
//     (batch, head, 128-row q tile): a producer warpgroup whose first
//     thread issues every TMA load (Q once, then K and V tiles into a
//     ring of stages, completion on mbarriers; 4-D tensor maps over the
//     caller's strides, whose out-of-bounds zero fill replaces tail masking
//     on loads) and gives up its registers (setmaxnreg) to two consumer
//     warpgroups of 64 q rows each.  A consumer runs S = Q.K^T as wgmma
//     from shared memory (swizzled boxes of Dp's columns), the online
//     softmax in registers with
//     exp2 and scale * log2(e) folded together, the element mask only on
//     tiles that straddle the diagonal, the window edge or the end of the
//     keys, then O += P.V as wgmma with P rounded to the input type
//     straight from the score accumulators into the register A operand
//     and V read [keys, D] with the transpose bit.  The two consumers share
//     the tensor cores, so one's softmax overlaps the other's products; a
//     consumer hands each stage back to the producer through an mbarrier,
//     never __syncthreads.  By width:
//       Dp 64, 128: 128-key tiles in two stages, 64-column boxes with the
//         128-byte swizzle, O one m64nDp product a k-step;
//       Dp 96 (D 72..96: Phi-3-mini's 96, Phi-2's 80): its own width, not
//         D 128's, since a quarter of that body's tensor-core work and Q/K/V
//         shared-memory traffic was zero columns.  S in 6 k-steps, O one
//         m64n96k16 product a k-step (48 f32 a thread).  96 columns are
//         three 32-column boxes with the 64-byte swizzle: the only swizzle
//         whose atom divides 96, so one descriptor spans V's 96 columns
//         (a 64 + 32 split would need two swizzles and two products).  Q
//         takes 24 KiB and a 128-key K/V stage 48, so the ring holds three
//         (1.6% faster than two on the card);
//       Dp 256: 64-key tiles in two stages (Q 64 KiB, the ring 128 KiB),
//         O 128 f32 registers a thread, run as two m64n128 products a
//         k-step, p by ex2.approx.ftz.  80-key tiles, O rescaled only
//         where a row's max moved, and the next tile's S product issued
//         before this tile's softmax were each tried and none was faster
//         (PERF.md, Findings): the overlap keeps S, P and O live at once,
//         past the 168 registers a thread of this block is compiled for,
//         and spilled;
//   - bf16 / fp16, D a multiple of 8 up to 32 (the tiny test shapes):
//     flash_fwd_mma at Dp 16 or 32, four warps of 16 q rows on mma.sync
//     m16n8k16 with a cp.async double buffer and ldmatrix (a wgmma tile is
//     64 deep in k tiles of 16, wider than these heads need);
//   - f32 up to D 128 with a contiguous head_dim (exact f32 arithmetic, as
//     the tiny test model needs): flash_fwd_fma at Dp 16, 32, 64 or 128,
//     f32 FMAs on the CUDA cores over a q tile held in shared memory;
//   - every other head_dim (16-bit D not a multiple of 8 or past 256, f32
//     past 128): flash_fwd_generic, entered through k8s_flash_fwd_generic.
//     Plain loads through any row strides of 32-column chunks into
//     shared memory as f32, scores and the online softmax for 32 q rows x
//     32 keys a tile on 256 threads, and o accumulated in f32 rows of a
//     scratch buffer the caller allocates (one block owns its rows, so it
//     needs no atomics and no bound on D).  Slow and right.
// The caller copies an operand whose layout its body cannot read (a
// strided head_dim; for the 16-bit tiled bodies also misaligned or stride-0
// rows) to a contiguous one.  Every body runs one block per (batch and
// head, q tile), the heaviest q tile of each head first, on a 2-D grid
// while B*H fits grid.y's 65535 and folded into grid.x past it
// (flash_common.cuh:tile_grid).

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // k rows per streamed tile
constexpr int NT = 256;  // fma body: 16 x 16 threads, each 4 rows x 4 cols of S
constexpr int MMA_THREADS = 128;  // mma body: 4 warps x 16 q rows

// fma body (f32 inputs): q, k, v and p tiles in shared memory; q/k rows
// padded by one word so the 16 threads reading one column from 16 different
// rows hit 16 different banks.
template <typename T, int DP>
struct Tiles {
  static constexpr int QS = DP + 1;
  static constexpr int PS = BK + 1;
  static constexpr size_t bytes =
      (size_t)(BQ * QS + BK * QS + BK * DP) * sizeof(T) + (size_t)BQ * PS * sizeof(float);
};

// mma body (Dp 16 and 32; the wgmma body takes 64 to 256): two stages of k
// and v tiles in shared memory (the next tile streams in with cp.async while
// the current one is used), rows padded by 16 bytes so the 8 row addresses
// of each ldmatrix hit different banks.
template <typename T, int DP>
struct MmaTiles {
  static_assert(DP <= 32, "Dp 64 to 256 take flash_fwd_wgmma");
  static constexpr int KS = DP + 8;
  static constexpr size_t bytes = (size_t)2 * 2 * BK * KS * sizeof(T);
};

template <typename T, int DP>
__global__ void __launch_bounds__(NT) flash_fwd_fma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int L, int Lk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_sl, int64_t k_sb, int64_t k_sh,
    int64_t k_sl, int64_t v_sb, int64_t v_sh, int64_t v_sl, int64_t o_sb,
    int64_t o_sh, int64_t o_sl, float scale, int causal, int window) {
  constexpr int QS = Tiles<T, DP>::QS;
  constexpr int PS = Tiles<T, DP>::PS;
  constexpr int DJ = DP / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * QS;
  T* vs = ks + BK * QS;
  float* ps = reinterpret_cast<float*>(vs + BK * DP);

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: cols tx + 16 j
  const int ty = tid >> 4;  // row group: rows ty + 16 i
  int bh, q_lo;
  fwd_block(L, BQ, bh, q_lo);
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  // columns D..DP of every tile are zeros
  for (int i = tid; i < BQ * DP; i += NT) {
    const int r = i / DP, d = i % DP, qp = q_lo + r;
    qs[r * QS + d] = qp < L && d < D ? qb[(int64_t)qp * q_sl + d] : from_f<T>(0.f);
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
    for (int i = tid; i < BK * DP; i += NT) {
      const int r = i / DP, d = i % DP, kp = t0 + r;
      const bool in = kp < Lk && d < D;
      ks[r * QS + d] = in ? kb[(int64_t)kp * k_sl + d] : from_f<T>(0.f);
      vs[r * DP + d] = in ? vb[(int64_t)kp * v_sl + d] : from_f<T>(0.f);
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
        const float vv = vs[kk * DP + tx + 16 * jd];
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
    for (int jd = 0; jd < DJ; ++jd)
      if (tx + 16 * jd < D) ob[tx + 16 * jd] = from_f<T>(acc[i][jd] / den);
    if (tx == 0)
      lse[(int64_t)bh * L + qp] = m[i] <= NEG_INF / 2 ? NEG_INF : m[i] + logf(den);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int L, int Lk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_sl, int64_t k_sb, int64_t k_sh,
    int64_t k_sl, int64_t v_sb, int64_t v_sh, int64_t v_sl, int64_t o_sb,
    int64_t o_sh, int64_t o_sl, float scale, int causal, int window) {
  constexpr int KS = MmaTiles<T, DP>::KS;
  constexpr int NKT = BK / 8;      // 8-column n-tiles of the score tile
  constexpr int NDT = DP / 8;      // 8-column n-tiles of the output
  constexpr int KSTEPS = DP / 16;  // 16-deep k-steps of q.k^T
  constexpr int CPR = DP / 8;      // 16-byte chunks per k/v row
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [stage][k, v][BK][KS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;        // fragment row (and row + 8)
  const int c2 = (lane & 3) * 2;  // fragment column pair
  int bh, q_lo;
  fwd_block(L, BQ, bh, q_lo);
  const int w_lo = q_lo + warp * 16;  // this warp's 16 q rows
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int rows[2] = {w_lo + g, w_lo + g + 8};

  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_hi = causal ? min(Lk, q_lo + BQ) : Lk;

  // start the copies of the k/v tile beginning at key t0 into stage st
  // (D is a multiple of 8: a 16-byte chunk lies wholly below D or past it,
  // and one past it is zero-filled)
  auto load_tile = [&](int st, int t0) {
    T* ks = tiles + st * 2 * BK * KS;
    T* vs = ks + BK * KS;
    for (int i = tid; i < BK * CPR; i += MMA_THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, kp = t0 + r;
      const bool in = kp < Lk && c < D;
      const int64_t row = in ? kp : 0;
      const int col = in ? c : 0;
      cp_async16(ks + r * KS + c, kb + row * k_sl + col, in);
      cp_async16(vs + r * KS + c, vb + row * v_sl + col, in);
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
      const int r = rows[j & 1], col = kk * 16 + (j >> 1) * 8;
      qa[kk][j] = r < L && col < D ? *reinterpret_cast<const uint32_t*>(
                                         qb + (int64_t)r * q_sl + col + c2)
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
      if (dn * 8 >= D) continue;
      ob[dn * 8 + c2] = from_f<T>(acc[dn][2 * i] / den);
      ob[dn * 8 + c2 + 1] = from_f<T>(acc[dn][2 * i + 1] / den);
    }
    if ((lane & 3) == 0)
      lse[(int64_t)bh * L + qp] = m[i] <= NEG_INF / 2 ? NEG_INF : m[i] + logf(den);
  }
}

// wgmma body: tiles, warpgroups and shared memory.  Each box is
// [rows][BOX]: 64 columns (128 bytes a row, 128-byte swizzle), so Dp = 128
// keeps two boxes ("halves") and Dp = 256 four; at Dp 96, 32 columns with
// the 64-byte swizzle, three boxes (flash_sm90.cuh).
namespace wg {
constexpr int BQ = 128;       // q rows per block: two consumer warpgroups of 64
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
}  // namespace wg

template <int DP>
struct FwdSmem {
  static constexpr int BK = DP == 256 ? 64 : 128;  // keys per streamed tile
  // K/V ring depth: three at Dp 96 (Q 24 KiB, 48 KiB a stage), else two
  static constexpr int STAGES = DP == 96 ? 3 : 2;
  static constexpr int BOX = DP == 96 ? 32 : 64;  // columns a TMA box
  static constexpr int BOXES = DP / BOX;
  static constexpr int Q_BYTES = wg::BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;
  // q_full, then k_full, v_full and empty a stage
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES) > 64 ? 8 * (1 + 3 * STAGES) : 64;
  // 1024 bytes of alignment slack, Q, the K and V rings, the mbarriers
  static constexpr size_t bytes = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

template <typename T, int DP>
__global__ void __launch_bounds__(wg::THREADS, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, T* __restrict__ o, float* __restrict__ lse, int H,
    int Hkv, int L, int Lk, int D, int64_t o_sb, int64_t o_sh, int64_t o_sl, float scale,
    int causal, int window) {
  using S = FwdSmem<DP>;
  constexpr int BQ = wg::BQ, BK = S::BK, STAGES = S::STAGES;
  constexpr int BOX = S::BOX, BOXES = S::BOXES;
  constexpr int KPB = BOX / 16;  // 16-deep k-steps a box row holds
  constexpr int NS = BK / 2;     // score accumulators a thread (m64nBK)
  constexpr int NO = DP / 2;     // output accumulators a thread (m64nDp)
  constexpr int NC = DP > 128 ? 128 : DP;  // columns of one p.v product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_base1024(smem_raw);
  T* qs = reinterpret_cast<T*>(base);               // [box][BQ][BOX]
  T* ks = reinterpret_cast<T*>(base + S::Q_BYTES);  // [stage][box][BK][BOX]
  T* vs = ks + STAGES * BK * DP;                    // [stage][box][BK][BOX]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + S::Q_BYTES + 2 * STAGES * S::KV_BYTES);
  uint64_t* k_full = q_full + 1;       // [stage]
  uint64_t* v_full = k_full + STAGES;  // [stage]
  uint64_t* empty = v_full + STAGES;   // [stage]: one arrival per consumer warp

  const int tid = threadIdx.x, wgi = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  int bh, q_lo;
  fwd_block(L, BQ, bh, q_lo);
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_hi = causal ? min(Lk, q_lo + BQ) : Lk;
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
    // producer: one thread issues every load; the warpgroup keeps 24
    // registers a thread and hands the rest to the consumers.  A box past
    // D (padded width) still counts its full bytes: TMA writes its zeros.
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_tx(q_full, S::Q_BYTES);
      for (int hf = 0; hf < BOXES; ++hf)
        tma_load4(qs + hf * BQ * BOX, &tq, q_full, hf * BOX, h, q_lo, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES, use = i / STAGES;
        if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
        const int t0 = kv_lo + i * BK;
        T* kd = ks + st * BK * DP;
        T* vd = vs + st * BK * DP;
        mbar_arrive_tx(k_full + st, S::KV_BYTES);
        for (int hf = 0; hf < BOXES; ++hf)
          tma_load4(kd + hf * BK * BOX, &tk, k_full + st, hf * BOX, hk, t0, b);
        mbar_arrive_tx(v_full + st, S::KV_BYTES);
        for (int hf = 0; hf < BOXES; ++hf)
          tma_load4(vd + hf * BK * BOX, &tv, v_full + st, hf * BOX, hk, t0, b);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int c = wgi - 1;         // consumer: q rows r0 .. r0 + 63
    const int r0 = q_lo + 64 * c;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
    const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
    // m: the running row max of score * scale * log2(e); l: this thread's
    // share of the row sum (its quad holds the rest)
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) acc[e] = 0.f;
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES, ph = (i / STAGES) & 1;
      const int t0 = kv_lo + i * BK;
      const T* kt = ks + st * BK * DP;
      const T* vt = vs + st * BK * DP;
      // wholly masked for these 64 rows: nothing to do (warpgroup-uniform)
      const bool skip = (causal && t0 > r0 + 63) || (window > 0 && r0 - (t0 + BK - 1) >= window);
      mbar_wait(k_full + st, ph);
      if (!skip) {
        // S = Q.K^T: accumulator e is row rows[(e >> 1) & 1], key
        // t0 + 8 (e / 4) + c2 + (e & 1); every k-step runs (a runtime bound
        // would serialise the wgmma pipeline), past D over TMA's zeros
        float s[NS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint64_t da = desc_box<BOX>(
              qs + (kk / KPB) * BQ * BOX + c * 64 * BOX + (kk % KPB) * 16, 16);
          const uint64_t db = desc_box<BOX>(kt + (kk / KPB) * BK * BOX + (kk % KPB) * 16, 16);
          wgmma_ss(s, da, db, kk > 0, (T*)nullptr);
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(s);

        // the element mask, only where the tile straddles the diagonal,
        // the window edge or the end of the keys
        const bool edge = t0 + BK > Lk || (causal && t0 + BK - 1 > r0) ||
                          (window > 0 && r0 + 63 - t0 >= window);
        if (edge) {
#pragma unroll
          for (int e = 0; e < NS; ++e) {
            const int kp = t0 + (e / 4) * 8 + c2 + (e & 1);
            if (!visible(rows[(e >> 1) & 1], kp, Lk, causal, window)) s[e] = NEG_INF;
          }
        }
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int e = 0; e < NS; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
        float safe[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] <= NEG_INF / 2 ? NEG_INF : mx[r] * sl2);
          safe[r] = m_new <= NEG_INF / 2 ? 0.f : m_new;
          alpha[r] = m[r] <= NEG_INF / 2 ? 0.f : exp2f(m[r] - safe[r]);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
        // p in place of s (a masked score gives exp2(-1.4e30) = 0); at Dp
        // 256 on ex2.approx.ftz (flash_sm90.cuh:exp2_ftz), which read 2%
        // faster there (PERF.md, Findings)
#pragma unroll
        for (int e = 0; e < NS; ++e) {
          const int r = (e >> 1) & 1;
          const float x = fmaf(s[e], sl2, -safe[r]);
          s[e] = DP == 256 ? exp2_ftz(x) : exp2f(x);
          l[r] += s[e];
        }
#pragma unroll
        for (int e = 0; e < NO; ++e) acc[e] *= alpha[(e >> 1) & 1];
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) acc_to_a<T>(s, j, pa[j]);

        // O += P.V: V [keys][Dp] is the MN-major B operand, NC columns a
        // product (one m64n96 at Dp 96, two m64n128 at Dp 256)
        mbar_wait(v_full + st, ph);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          if constexpr (DP == NC) {
            wgmma_rs(acc, pa[j], desc_box<BOX>(vt + j * 16 * BOX, BK * BOX * 2), (T*)nullptr);
          } else {
#pragma unroll
            for (int n = 0; n < DP / NC; ++n)
              wgmma_rs(cols<NC / 2>(acc, n), pa[j],
                       desc_box<BOX>(vt + n * (NC / BOX) * BK * BOX + j * 16 * BOX,
                                     BK * BOX * 2),
                       (T*)nullptr);
          }
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(acc);
      } else {
        mbar_wait(v_full + st, ph);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qp = rows[r];
      if (qp >= L) continue;
      const float den = fmaxf(l[r], 1e-30f);
      T* ob = o + b * o_sb + h * o_sh + (int64_t)qp * o_sl;
      store_groups<DP>(D, [&](int j) {
        *reinterpret_cast<uint32_t*>(ob + 8 * j + c2) =
            pack2<T>(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
      });
      if ((lane & 3) == 0)
        lse[(int64_t)bh * L + qp] =
            m[r] <= NEG_INF / 2 ? NEG_INF : m[r] * 0.6931471805599453f + logf(den);
    }
  }
}

// -- generic body -------------------------------------------------------------

namespace gen {
constexpr int BQ = 32;        // q rows a block
constexpr int BK = 32;        // keys a tile
constexpr int DC = 32;        // head_dim columns a chunk
constexpr int THREADS = 256;  // 8 threads a row: row tid / 8, columns tid % 8 + 8 j
}  // namespace gen

// (batch, head, row) element strides of q, k, v, o; the head_dim is
// contiguous (the caller copies an operand whose is not).
struct GenStrides {
  int64_t s[12];
};

// Any type and head_dim; rows of any stride, 0 and misaligned ones
// included.  o accumulates in f32 rows of `acc`
// (contiguous [B * H * L, D]) that this block alone reads and writes; each
// element stays with one thread, so the tiles need no atomics and D no
// bound.
template <typename T>
__global__ void __launch_bounds__(gen::THREADS) flash_fwd_generic(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, float* __restrict__ acc, int H, int Hkv,
    int L, int Lk, int D, const GenStrides st, float scale, int causal, int window) {
  constexpr int BQ = gen::BQ, BK = gen::BK, DC = gen::DC, THREADS = gen::THREADS;
  __shared__ float qs[BQ][DC + 1], ks[BK][DC + 1], ps[BQ][BK + 1];
  const int tid = threadIdx.x, r = tid >> 3, cx = tid & 7;
  int bh, q_lo;
  fwd_block(L, BQ, bh, q_lo);
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int qp = q_lo + r;
  const T* qb = q + b * st.s[0] + h * st.s[1];
  const T* kb = k + b * st.s[3] + hk * st.s[4];
  const T* vb = v + b * st.s[6] + hk * st.s[7];
  float* arow = acc + ((int64_t)bh * L + min(qp, L - 1)) * D;

  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_hi = causal ? min(Lk, q_lo + BQ) : Lk;
  float m = NEG_INF, l = 0.f;
  bool first = true;
  for (int t0 = kv_lo; t0 < kv_hi; t0 += BK, first = false) {
    // s for row r, keys cx + 8 j, over D in chunks
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // the previous chunk's reads are done
      for (int i = tid; i < BQ * DC; i += THREADS) {
        const int rr = i / DC, d = i % DC, p = q_lo + rr, kp = t0 + rr;
        qs[rr][d] = p < L && d0 + d < D ? to_f(qb[p * st.s[2] + d0 + d]) : 0.f;
        ks[rr][d] = kp < Lk && d0 + d < D ? to_f(kb[kp * st.s[5] + d0 + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < DC; ++d) {
        const float qv = qs[r][d];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = fmaf(qv, ks[cx + 8 * j][d], s[j]);
      }
    }
    // the online softmax: a row's 32 scores live on 8 neighbouring lanes
    float mx = NEG_INF;
    bool keep[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      keep[j] = visible(qp, t0 + cx + 8 * j, Lk, causal, window);
      s[j] = keep[j] ? s[j] * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
    const float alpha = m <= NEG_INF / 2 ? 0.f : expf(m - safe);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = keep[j] ? expf(s[j] - safe) : 0.f;
      ps[r][cx + 8 * j] = p;
      rs += p;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
    l = l * alpha + rs;
    m = m_new;
    // o = o * alpha + p.v, over D in chunks (v chunks in ks)
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // p complete; the previous chunk's reads are done
      for (int i = tid; i < BK * DC; i += THREADS) {
        const int rr = i / DC, d = i % DC, kp = t0 + rr;
        ks[rr][d] = kp < Lk && d0 + d < D ? to_f(vb[kp * st.s[8] + d0 + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        const int d = cx + 8 * j;
        if (d0 + d >= D) continue;
        float a = first || qp >= L ? 0.f : arow[d0 + d] * alpha;
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) a = fmaf(ps[r][kk], ks[kk][d], a);
        if (qp < L) arow[d0 + d] = a;
      }
    }
  }
  if (qp >= L) return;
  const float den = fmaxf(l, 1e-30f);
  T* ob = o + b * st.s[9] + h * st.s[10] + (int64_t)qp * st.s[11];
  for (int d = cx; d < D; d += 8) ob[d] = from_f<T>(arow[d] / den);
  if (cx == 0) lse[(int64_t)bh * L + qp] = m <= NEG_INF / 2 ? NEG_INF : m + logf(den);
}

template <typename T, typename Kernel>
int run(Kernel kern, int threads, size_t smem, const void* q, const void* k,
        const void* v, void* o, void* lse, int B, int H, int Hkv, int L, int Lk, int D,
        const int64_t* st, float scale, int causal, int window, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid = tile_grid((L + BQ - 1) / BQ, B * H);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, Hkv, L, Lk, D, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int run_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
              int Hkv, int L, int Lk, int D, const int64_t* st, float scale, int causal,
              int window, cudaStream_t stream) {
  constexpr int dtype = std::is_same<T, __nv_bfloat16>::value ? 1 : 2;
  using S = FwdSmem<DP>;
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, q, dtype, D, H, L, B, st[0], st[1], st[2], wg::BQ, S::BOX);
  if (!e) e = make_map(&mk, k, dtype, D, Hkv, Lk, B, st[3], st[4], st[5], S::BK, S::BOX);
  if (!e) e = make_map(&mv, v, dtype, D, Hkv, Lk, B, st[6], st[7], st[8], S::BK, S::BOX);
  if (e) return e;
  auto kern = flash_fwd_wgmma<T, DP>;
  const size_t smem = S::bytes;
  cudaError_t r = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (r != cudaSuccess) return (int)r;
  const dim3 grid = tile_grid((L + wg::BQ - 1) / wg::BQ, B * H);
  kern<<<grid, wg::THREADS, smem, stream>>>(mq, mk, mv, static_cast<T*>(o),
                                            static_cast<float*>(lse), H, Hkv, L, Lk, D, st[9],
                                            st[10], st[11], scale, causal, window);
  return (int)cudaGetLastError();
}

// The tiled body for a type and padded width Dp (a static choice; the
// caller's plan picked Dp for the real D).
template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
           int H, int Hkv, int L, int Lk, int D, const int64_t* st, float scale,
           int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return run<T>(flash_fwd_fma<T, DP>, NT, Tiles<T, DP>::bytes, q, k, v, o, lse, B,
                  H, Hkv, L, Lk, D, st, scale, causal, window, stream);
  else if constexpr (DP >= 64)
    return run_wgmma<T, DP>(q, k, v, o, lse, B, H, Hkv, L, Lk, D, st, scale, causal,
                            window, stream);
  else
    return run<T>(flash_fwd_mma<T, DP>, MMA_THREADS, MmaTiles<T, DP>::bytes, q, k, v,
                  o, lse, B, H, Hkv, L, Lk, D, st, scale, causal, window, stream);
}

template <typename T>
int dispatch_d(int Dp, const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int H, int Hkv, int L, int Lk, int D, const int64_t* st, float scale,
               int causal, int window, cudaStream_t stream) {
  switch (Dp) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Hkv, L, Lk, D, st, scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Hkv, L, Lk, D, st, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Hkv, L, Lk, D, st, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Hkv, L, Lk, D, st, scale, causal, window, stream);
    case 96:
      if constexpr (!std::is_same<T, float>::value)
        return launch<T, 96>(q, k, v, o, lse, B, H, Hkv, L, Lk, D, st, scale, causal, window, stream);
      return (int)cudaErrorInvalidValue;
    default:
      if constexpr (!std::is_same<T, float>::value)
        return launch<T, 256>(q, k, v, o, lse, B, H, Hkv, L, Lk, D, st, scale, causal, window, stream);
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int run_generic(const void* q, const void* k, const void* v, void* o, void* lse, void* acc,
                int B, int H, int Hkv, int L, int Lk, int D, const int64_t* strides,
                float scale, int causal, int window, cudaStream_t stream) {
  GenStrides st;
  for (int i = 0; i < 12; ++i) st.s[i] = strides[i];
  const dim3 grid = tile_grid((L + gen::BQ - 1) / gen::BQ, B * H);
  flash_fwd_generic<T><<<grid, gen::THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<float*>(acc), H, Hkv, L, Lk,
      D, st, scale, causal, window);
  return (int)cudaGetLastError();
}

// Whether the forward has a tiled body for (dtype, D, Dp): the shared
// widths (flash_common.cuh:tiled), and the 16-bit Dp-96 body of this file.
bool fwd_tiled(int dtype, int D, int Dp) {
  if (Dp == 96) return (dtype == 1 || dtype == 2) && D >= 1 && D <= 96 && D % 8 == 0;
  return tiled(dtype, D, Dp);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  D: the real head_dim;
// Dp: the padded width of the tiled body to run (the caller's plan,
// ops/flash_attention.py:_fwd_plan).  strides: 12 element strides,
// (batch, head, row) for q, k, v, o in that order; the last dim is
// contiguous.  lse is a contiguous [B, H, L] float32 buffer.  window <= 0
// means none.  Returns the cudaError_t of the launch (0 = launched;
// cudaErrorInvalidValue for a (dtype, D, Dp) no body takes), or for the
// wgmma body flash::NO_ENCODER / flash::MAP_ERROR + CUresult when a tensor
// map cannot be made.
extern "C" int k8s_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int dtype, int B, int H, int Hkv, int L,
                             int Lk, int D, const int64_t* strides, float scale,
                             int causal, int window, int Dp, void* stream) {
  if (!fwd_tiled(dtype, D, Dp)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(Dp, q, k, v, o, lse, B, H, Hkv, L, Lk, D, strides, scale, causal, window, s);
    case 1: return dispatch_d<__nv_bfloat16>(Dp, q, k, v, o, lse, B, H, Hkv, L, Lk, D, strides, scale, causal, window, s);
    default: return dispatch_d<__half>(Dp, q, k, v, o, lse, B, H, Hkv, L, Lk, D, strides, scale, causal, window, s);
  }
}

// The generic body: any dtype and head_dim, the same strides as above
// (rows of any stride, 0 and misaligned ones included).  acc: an f32 scratch of
// B * H * L * D elements (every one written before it is read).
extern "C" int k8s_flash_fwd_generic(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int dtype, int B, int H, int Hkv, int L,
                                     int Lk, int D, const int64_t* strides, float scale,
                                     int causal, int window, void* acc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run_generic<float>(q, k, v, o, lse, acc, B, H, Hkv, L, Lk, D, strides, scale, causal, window, s);
    case 1: return run_generic<__nv_bfloat16>(q, k, v, o, lse, acc, B, H, Hkv, L, Lk, D, strides, scale, causal, window, s);
    case 2: return run_generic<__half>(q, k, v, o, lse, acc, B, H, Hkv, L, Lk, D, strides, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of the tiled body k8s_flash_fwd launches for
// dtype and Dp (a report for the smoke test), or -1 where there is none.
// The generic body uses static shared memory only (0).
extern "C" int k8s_flash_fwd_smem(int dtype, int Dp) {
  if (dtype < 0 || dtype > 2 || !fwd_tiled(dtype, 8, Dp)) return -1;
  if (dtype == 0) {
    switch (Dp) {
      case 16: return (int)Tiles<float, 16>::bytes;
      case 32: return (int)Tiles<float, 32>::bytes;
      case 64: return (int)Tiles<float, 64>::bytes;
      default: return (int)Tiles<float, 128>::bytes;
    }
  }
  switch (Dp) {
    case 16: return (int)MmaTiles<__half, 16>::bytes;
    case 32: return (int)MmaTiles<__half, 32>::bytes;
    case 64: return (int)FwdSmem<64>::bytes;
    case 96: return (int)FwdSmem<96>::bytes;
    case 128: return (int)FwdSmem<128>::bytes;
    default: return (int)FwdSmem<256>::bytes;
  }
}
