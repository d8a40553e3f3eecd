// FlashAttention-2 forward and backward on [B, S, H, D] tensors.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (the
// forward, reached through `_fwd`), `_dq_kernel` and `_dkv_kernel` (the
// backward, reached through `_bwd`), and the ring-step kernels
// `_fwd_pos_kernel` (reached through `flash_fwd_pos`), `_dq_pos_kernel`
// and `_dkv_pos_kernel` (through `flash_bwd_pos`): flash_fwd_pos,
// flash_dq_pos and flash_dkv_pos here.
//
// Per head (b, h), with s = (q . k) * scale and the causal mask on global
// row/column indices (row >= col):
//   forward   O = softmax(s) V, lse = m + log(l), online over K blocks;
//   dq kernel dQ = sum_k dS K,   dS = P * (dP - delta) * scale,
//             P = exp(s - lse), dP = dO V^T, delta = rowsum(dO * O);
//   dkv       dV = sum_q P^T dO, dK = sum_q dS^T Q.
// delta comes from the caller (a PyTorch f32 rowsum, as the TPU version
// computes it outside Pallas).
//
// What bounds it on an H100: at the training shapes (S = 1024-2048, D =
// 64-128) the operations, 4*S^2*D per head forward (half of it causal)
// and 2.5 times that backward, on the bf16 tensor cores; the bytes (q, k,
// v, o, dO once each) are a few percent of that time. The design:
//   * one CTA of 4 warps per (b*h, 64-row block) — Q rows in the forward
//     and the dq kernel, K rows in the dkv kernel; each warp owns 16 rows,
//     one m16n8k16 tile high. The loop over the other side's blocks runs
//     inside the CTA (the TPU kernel's sequential grid axis), causal
//     blocks only up to (forward, dq) or from (dkv) the diagonal, and the
//     forward's grid starts with the longest causal rows;
//   * bf16 products on the tensor cores (mma.sync m16n8k16, f32
//     accumulation); f32 inputs run the same tiles as CUDA-core FMAs in
//     the m16n8 accumulator layout, so one softmax/mask code serves both;
//   * S, the online-softmax state (m, l) and every accumulator stay in
//     f32 registers; P (forward) and dS (backward) are cast to the input
//     type before their second product, as the TPU kernel casts them, and
//     pass through a per-warp shared-memory tile;
//   * tiles are staged through shared memory with 16-byte loads, read
//     through the caller's strides (b, s, h; unit stride along D), so the
//     fused-QKV views of the model are never copied; rows >= S and
//     columns >= D load as zeros, so a ragged S needs no padding and any
//     D <= 256 runs in the next tile width of 32, 64, 128 or 256;
//   * no atomics: every output element has exactly one owning CTA and is
//     summed in a fixed order, so a backward is bitwise reproducible;
//   * masked entries are selected to 0 after the exp, never multiplied,
//     so a padded row's garbage statistics cannot leak into dK / dV.
// These bodies load synchronously and multiply with mma.sync. For bf16
// at head-dim tiles 64 and 128 (32 < D <= 128, D % 8 == 0, every stride a
// multiple of 8 elements, 16-byte aligned bases) the forward, dQ and
// dK/dV kernels have Hopper bodies (TMA-fed wgmma, P and dS in
// registers): `flash_fwd_sm90`, `flash_dq_sm90` and `flash_dkv_sm90`
// (attention_sm90.cuh's bodies, see their notes). The caller asks for
// them as kinds 3, 4 and 5, and an entry asked for a kind its inputs do
// not admit returns cudaErrorInvalidValue. f32 inputs and head-dim tiles
// 32 and 256 keep the mma.sync bodies (kinds 0-2).
//
// The ring-step (_pos) kernels run with the causal test `row >= col`
// replaced by int32 global positions, q_pos[row] >= k_pos[col]. Where the
// Hopper bodies admit the operands and the shards are of one length (Sq
// == Sk, the ring's own case) they run those bodies under the PosMask
// policy (`flash_fwd_pos_sm90`, `flash_dq_pos_sm90`, `flash_dkv_pos_sm90`,
// kinds 3-5 of `ptt_flash_attention_pos`; see attention_sm90.cuh's note;
// without the mask, the whole-sequence Hopper kernels with causal off).
// Otherwise they run the mma.sync bodies (kinds 0-2), with q and k of
// their own lengths (Sq, Sk). A zigzag shard's positions are not monotone
// in the shard, so the index shortcuts above (K blocks bounded by the
// diagonal) do not apply: every block is visited, and a whole K (or, in
// dkv, Q) block is skipped only when the positions say that no pair in it
// is kept — max(q_pos of the CTA's rows) < min(k_pos of the block) —
// decided by one __syncthreads_or. A row that the mask hides throughout
// (a visiting shard wholly in its future) keeps m = -1e30 and l = 0 and
// is written as O = 0, lse = m + log(1e-30), the TPU kernel's l_safe, so
// the ring's merge gives it weight 0 (the Hopper forward writes the
// same).
#include <limits.h>
#include <math.h>

#include <algorithm>
#include <initializer_list>

#include "attention_sm90.cuh"

namespace {

using namespace ptt;
using namespace ptt::attn;
using namespace ptt::sm90;
using namespace ptt::attn90;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B*H, S] (backward input)
  const float* delta;   // [B*H, S]
  void* out0;           // forward: O; dq kernel: dQ; dkv kernel: dK
  void* out1;           // dkv kernel: dV
  float* lse_out;       // forward: [B*H, Sq]
  const int* qpos;      // _pos kernels: [Sq], [Sk] int32 global positions
  const int* kpos;
  int Sq, Sk, H, D;     // q / dO rows Sq; k / v rows Sk (equal unless _pos)
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, d_b, d_s, d_h;
  float scale;
  int causal;
  int vec;              // 16-byte loads allowed (alignment and strides)
};

// --- forward -----------------------------------------------------------------

// max (or min) of one int over the CTA's threads
template <bool MAX>
__device__ __forceinline__ int cta_reduce(int v) {
  __shared__ int red[kWarps];
  v = MAX ? __reduce_max_sync(0xffffffffu, v)
          : __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = MAX ? max(r, red[w]) : min(r, red[w]);
  return r;
}

// The largest position of the CTA's q rows [q0, q0 + kBlock); INT_MIN if
// it has none.
__device__ __forceinline__ int cta_qpos_max(const Params& p, int q0) {
  const int r = q0 + static_cast<int>(threadIdx.x);
  return cta_reduce<true>(threadIdx.x < kBlock && r < p.Sq ? p.qpos[r]
                                                           : INT_MIN);
}

// Barrier of a K-block step of the forward and dQ kernels: whether any key
// of [k0, k0 + BK) has a position at or below qmax (all threads agree).
template <int BK>
__device__ __forceinline__ bool kblock_needed(const Params& p, int k0,
                                              int qmax) {
  int lo = INT_MAX;
  for (int i = threadIdx.x; i < BK; i += kThreads)
    if (k0 + i < p.Sk) lo = min(lo, p.kpos[k0 + i]);
  return __syncthreads_or(lo <= qmax) != 0;
}

// the positions of key columns c0 and c0 + 1 (0 past Sk: masked anyway)
__device__ __forceinline__ void kpos_pair(const Params& p, int c0,
                                          int (&kp)[2]) {
  kp[0] = c0 < p.Sk ? p.kpos[c0] : 0;
  kp[1] = c0 + 1 < p.Sk ? p.kpos[c0 + 1] : 0;
}

template <typename T, int DP, bool POS>
__device__ __forceinline__ void fwd_body(const Params& p) {
  using C = FwdCfg<T, DP>;
  constexpr int BK = C::BK, LD = C::LD, LDP = C::LDP;
  constexpr int NO = DP / 8, NS = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBlock * LD;
  T* Vs = Ks + BK * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* Ps = Vs + BK * LD + warp * kRows * LDP;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const T* q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + h * p.k_h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + h * p.v_h;

  load_tile<T, kBlock, DP, LD>(Qs, q, p.q_s, q0, p.Sq, p.D, p.vec);
  const int r_lo = q0 + warp * kRows + g, r_hi = r_lo + 8;
  const bool pos_mask = POS && p.causal;
  int qp_lo = 0, qp_hi = 0, qmax = 0;
  if (pos_mask) {
    qp_lo = r_lo < p.Sq ? p.qpos[r_lo] : 0;
    qp_hi = r_hi < p.Sq ? p.qpos[r_hi] : 0;
    qmax = cta_qpos_max(p, q0);
  }
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float acc[NO][4];
  zero(acc);
  const int n_kv = (p.Sk + BK - 1) / BK;
  const int hi = !POS && p.causal ? min((q0 + kBlock + BK - 1) / BK, n_kv)
                                  : n_kv;
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * BK;
    // the barrier: the last step's K/V are read
    if (pos_mask) {
      if (!kblock_needed<BK>(p, k0, qmax)) continue;
    } else {
      __syncthreads();
    }
    load_tile<T, BK, DP, LD>(Ks, k, p.k_s, k0, p.Sk, p.D, p.vec);
    load_tile<T, BK, DP, LD>(Vs, v, p.v_s, k0, p.Sk, p.D, p.vec);
    __syncthreads();
    float s[NS][4];
    zero(s);
    warp_mma<NS, DP, true>(s, Qs + warp * kRows * LD, LD, Ks, LD);
    unsigned ok = 0;
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      int kp[2] = {0, 0};
      if (pos_mask) kpos_pair(p, k0 + n * 8 + 2 * t, kp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r_lo : r_hi;
        const bool seen = POS ? (e < 2 ? qp_lo : qp_hi) >= kp[e & 1]
                              : row >= col;
        const bool keep = col < p.Sk && (!p.causal || seen);
        ok |= static_cast<unsigned>(keep) << (n * 4 + e);
        s[n][e] = keep ? s[n][e] * p.scale : kNegInf;
        if (e < 2) mx_lo = fmaxf(mx_lo, s[n][e]);
        else mx_hi = fmaxf(mx_hi, s[n][e]);
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float c_lo = __expf(m_lo - mn_lo), c_hi = __expf(m_hi - mn_hi);
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = (ok >> (n * 4 + e)) & 1u
                             ? __expf(s[n][e] - (e < 2 ? mn_lo : mn_hi))
                             : 0.f;
        if (e < 2) rs_lo += pv;
        else rs_hi += pv;
        Ps[(g + (e < 2 ? 0 : 8)) * LDP + n * 8 + 2 * t + (e & 1)] =
            from_f<T>(pv);
      }
    // l per lane (its share of the row), summed over the quad at the end
    l_lo = l_lo * c_lo + rs_lo;
    l_hi = l_hi * c_hi + rs_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= c_lo;
      acc[n][1] *= c_lo;
      acc[n][2] *= c_hi;
      acc[n][3] *= c_hi;
    }
    __syncwarp();
    warp_mma<NO, BK, false>(acc, Ps, LDP, Vs, LD);
    __syncwarp();
  }
  l_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  l_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  store_rows<T, NO>(static_cast<T*>(p.out0), acc, b, h, r_lo, 0, p.Sq, p.H,
                    p.D, l_lo, l_hi);
  if (t == 0) {
    float* lse = p.lse_out + static_cast<size_t>(bh) * p.Sq;
    if (r_lo < p.Sq) lse[r_lo] = m_lo + logf(l_lo);
    if (r_hi < p.Sq) lse[r_hi] = m_hi + logf(l_hi);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  fwd_body<T, DP, false>(p);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_pos(const Params p) {
  fwd_body<T, DP, true>(p);
}

// --- forward on Hopper: the shared body of attention_sm90.cuh, no dropout ---
template <int DP>
__global__ void __launch_bounds__(HopCfg<DP>::THREADS, HopCfg<DP>::CTAS)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const FwdArgs a,
                   const Units units) {
  fwd_sm90_body<DP>(tq, tk, tv, a, units, NoDropout());
}

// the ring step's forward on the same body, under the PosMask policy
template <int DP>
__global__ void __launch_bounds__(HopCfg<DP>::THREADS, HopCfg<DP>::CTAS)
    flash_fwd_pos_sm90(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const FwdArgs a, const Units units, const PosMask pm) {
  fwd_sm90_body<DP>(tq, tk, tv, a, units, NoDropout(), pm);
}

// --- backward: dQ -------------------------------------------------------------

template <typename T, int DP, bool POS>
__device__ __forceinline__ void dq_body(const Params& p) {
  using C = DqCfg<T, DP>;
  constexpr int BK = C::BK, LD = C::LD, LDP = C::LDP;
  constexpr int NO = DP / 8, NS = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kBlock * LD;
  T* Ks = dOs + kBlock * LD;
  T* Vs = Ks + BK * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* dSs = Vs + BK * LD + warp * kRows * LDP;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const T* q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + h * p.k_h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + h * p.v_h;
  const T* dout = static_cast<const T*>(p.dout) + b * p.d_b + h * p.d_h;

  load_tile<T, kBlock, DP, LD>(Qs, q, p.q_s, q0, p.Sq, p.D, p.vec);
  load_tile<T, kBlock, DP, LD>(dOs, dout, p.d_s, q0, p.Sq, p.D, p.vec);
  const int r_lo = q0 + warp * kRows + g, r_hi = r_lo + 8;
  const float* lse = p.lse + static_cast<size_t>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.Sq;
  const float lse_lo = r_lo < p.Sq ? lse[r_lo] : 0.f;
  const float lse_hi = r_hi < p.Sq ? lse[r_hi] : 0.f;
  const float dl_lo = r_lo < p.Sq ? delta[r_lo] : 0.f;
  const float dl_hi = r_hi < p.Sq ? delta[r_hi] : 0.f;
  const bool pos_mask = POS && p.causal;
  int qp_lo = 0, qp_hi = 0, qmax = 0;
  if (pos_mask) {
    qp_lo = r_lo < p.Sq ? p.qpos[r_lo] : 0;
    qp_hi = r_hi < p.Sq ? p.qpos[r_hi] : 0;
    qmax = cta_qpos_max(p, q0);
  }
  float acc[NO][4];
  zero(acc);
  const int n_kv = (p.Sk + BK - 1) / BK;
  const int hi = !POS && p.causal ? min((q0 + kBlock + BK - 1) / BK, n_kv)
                                  : n_kv;
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * BK;
    if (pos_mask) {
      if (!kblock_needed<BK>(p, k0, qmax)) continue;
    } else {
      __syncthreads();
    }
    load_tile<T, BK, DP, LD>(Ks, k, p.k_s, k0, p.Sk, p.D, p.vec);
    load_tile<T, BK, DP, LD>(Vs, v, p.v_s, k0, p.Sk, p.D, p.vec);
    __syncthreads();
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    warp_mma<NS, DP, true>(s, Qs + warp * kRows * LD, LD, Ks, LD);
    warp_mma<NS, DP, true>(dp, dOs + warp * kRows * LD, LD, Vs, LD);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      int kp[2] = {0, 0};
      if (pos_mask) kpos_pair(p, k0 + n * 8 + 2 * t, kp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r_lo : r_hi;
        const bool seen = POS ? (e < 2 ? qp_lo : qp_hi) >= kp[e & 1]
                              : row >= col;
        const bool keep = col < p.Sk && (!p.causal || seen);
        const float pv =
            keep ? __expf(s[n][e] * p.scale - (e < 2 ? lse_lo : lse_hi))
                 : 0.f;
        const float ds = pv * (dp[n][e] - (e < 2 ? dl_lo : dl_hi)) * p.scale;
        dSs[(g + (e < 2 ? 0 : 8)) * LDP + n * 8 + 2 * t + (e & 1)] =
            from_f<T>(ds);
      }
    }
    __syncwarp();
    warp_mma<NO, BK, false>(acc, dSs, LDP, Ks, LD);
    __syncwarp();
  }
  store_rows<T, NO>(static_cast<T*>(p.out0), acc, b, h, r_lo, 0, p.Sq, p.H,
                    p.D, 1.f, 1.f);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_dq(const Params p) {
  dq_body<T, DP, false>(p);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_dq_pos(const Params p) {
  dq_body<T, DP, true>(p);
}

// --- backward: dK, dV ----------------------------------------------------------

template <typename T, int DP, bool POS>
__device__ __forceinline__ void dkv_body(const Params& p) {
  using C = DkvCfg<T, DP>;
  constexpr int BQ = C::BQ, LD = C::LD, LDT = C::LDT;
  constexpr int NC = C::DO / 8, NQ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kBlock * LD;
  T* Qs = Vs + kBlock * LD;
  T* dOs = Qs + BQ * LD;
  T* Ts = dOs + BQ * LD;                   // per warp: P^T, then dS^T
  float* lse_s = reinterpret_cast<float*>(Ts + kWarps * kRows * LDT);
  float* dl_s = lse_s + BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  Ts += warp * kRows * LDT;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kBlock;      // this CTA's K rows
  const int c0 = blockIdx.z * C::DO;       // and its output columns
  const T* q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + h * p.k_h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + h * p.v_h;
  const T* dout = static_cast<const T*>(p.dout) + b * p.d_b + h * p.d_h;
  const float* lse = p.lse + static_cast<size_t>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.Sq;

  load_tile<T, kBlock, DP, LD>(Ks, k, p.k_s, k0, p.Sk, p.D, p.vec);
  load_tile<T, kBlock, DP, LD>(Vs, v, p.v_s, k0, p.Sk, p.D, p.vec);
  const int kr_lo = k0 + warp * kRows + g, kr_hi = kr_lo + 8;
  const bool pos_mask = POS && p.causal;
  int kp_lo = 0, kp_hi = 0, kmin = 0;
  if (pos_mask) {
    kp_lo = kr_lo < p.Sk ? p.kpos[kr_lo] : 0;
    kp_hi = kr_hi < p.Sk ? p.kpos[kr_hi] : 0;
    const int r = k0 + static_cast<int>(threadIdx.x);
    kmin = cta_reduce<false>(threadIdx.x < kBlock && r < p.Sk ? p.kpos[r]
                                                              : INT_MAX);
  }
  float dk[NC][4], dv[NC][4];
  zero(dk);
  zero(dv);
  const int n_q = (p.Sq + BQ - 1) / BQ;
  for (int i = !POS && p.causal ? k0 / BQ : 0; i < n_q; ++i) {
    const int qi0 = i * BQ;
    if (pos_mask) {
      // skip a Q block none of whose rows sits at or after a key here
      int hi_q = INT_MIN;
      for (int r = threadIdx.x; r < BQ; r += kThreads)
        if (qi0 + r < p.Sq) hi_q = max(hi_q, p.qpos[qi0 + r]);
      if (!__syncthreads_or(hi_q >= kmin)) continue;
    } else {
      __syncthreads();
    }
    load_tile<T, BQ, DP, LD>(Qs, q, p.q_s, qi0, p.Sq, p.D, p.vec);
    load_tile<T, BQ, DP, LD>(dOs, dout, p.d_s, qi0, p.Sq, p.D, p.vec);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = qi0 + r < p.Sq;
      lse_s[r] = in ? lse[qi0 + r] : 0.f;
      dl_s[r] = in ? delta[qi0 + r] : 0.f;
    }
    __syncthreads();
    // S^T[key][q] = K[key] . Q[q]; P^T = exp(S^T - lse[q]), masked to 0
    float pt[NQ][4];
    zero(pt);
    warp_mma<NQ, DP, true>(pt, Ks + warp * kRows * LD, LD, Qs, LD);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      int qp[2] = {0, 0};
      if (pos_mask) {
        const int qc0 = qi0 + n * 8 + 2 * t;
        qp[0] = qc0 < p.Sq ? p.qpos[qc0] : 0;
        qp[1] = qc0 + 1 < p.Sq ? p.qpos[qc0 + 1] : 0;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1), qc = qi0 + ql;
        const int kr = e < 2 ? kr_lo : kr_hi;
        const bool seen = POS ? qp[e & 1] >= (e < 2 ? kp_lo : kp_hi)
                              : qc >= kr;
        const bool keep = qc < p.Sq && kr < p.Sk && (!p.causal || seen);
        pt[n][e] = keep ? __expf(pt[n][e] * p.scale - lse_s[ql]) : 0.f;
        Ts[(g + (e < 2 ? 0 : 8)) * LDT + ql] = from_f<T>(pt[n][e]);
      }
    }
    __syncwarp();
    warp_mma<NC, BQ, false>(dv, Ts, LDT, dOs + c0, LD);
    // dP^T[key][q] = V[key] . dO[q]; dS^T = P^T * (dP^T - delta[q]) * scale
    float dpt[NQ][4];
    zero(dpt);
    warp_mma<NQ, DP, true>(dpt, Vs + warp * kRows * LD, LD, dOs, LD);
    __syncwarp();                          // P^T is read: overwrite it
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1);
        const float ds = pt[n][e] * (dpt[n][e] - dl_s[ql]) * p.scale;
        Ts[(g + (e < 2 ? 0 : 8)) * LDT + ql] = from_f<T>(ds);
      }
    __syncwarp();
    warp_mma<NC, BQ, false>(dk, Ts, LDT, Qs + c0, LD);
  }
  store_rows<T, NC>(static_cast<T*>(p.out0), dk, b, h, kr_lo, c0, p.Sk, p.H,
                    p.D, 1.f, 1.f);
  store_rows<T, NC>(static_cast<T*>(p.out1), dv, b, h, kr_lo, c0, p.Sk, p.H,
                    p.D, 1.f, 1.f);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_dkv(const Params p) {
  dkv_body<T, DP, false>(p);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_dkv_pos(const Params p) {
  dkv_body<T, DP, true>(p);
}

// --- backward on Hopper: attention_sm90.cuh's bodies, no dropout ----------
// dQ and dK/dV for bf16 at head-dim tiles 64 and 128 (kinds 4 and 5): the
// bodies and their note are in attention_sm90.cuh (shared with the
// short-attention backward, which adds the dropout and its own row term);
// here they run with NoDropout, the caller's delta and this file's Params.
template <int DP>
__global__ void __launch_bounds__(BwdCfg<DP, false>::THREADS, 1)
    flash_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p,
                  const Units units) {
  dq_sm90_body<DP, false>(tq, tdo, tk, tv, p, units, NoDropout{});
}

template <int DP>
__global__ void __launch_bounds__(BwdCfg<DP, true>::THREADS, 1)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo, const Params p,
                   const Units units) {
  dkv_sm90_body<DP>(tk, tv, tq, tdo, p, units, NoDropout{});
}

// the ring step's dQ and dK/dV on the same bodies, under PosMask
template <int DP>
__global__ void __launch_bounds__(BwdCfg<DP, false>::THREADS, 1)
    flash_dq_pos_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Params p,
                      const Units units, const PosMask pm) {
  dq_sm90_body<DP, false>(tq, tdo, tk, tv, p, units, NoDropout{}, pm);
}

template <int DP>
__global__ void __launch_bounds__(BwdCfg<DP, true>::THREADS, 1)
    flash_dkv_pos_sm90(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const Params p, const Units units, const PosMask pm) {
  dkv_sm90_body<DP>(tk, tv, tq, tdo, p, units, NoDropout{}, pm);
}

// --- launch --------------------------------------------------------------------
enum Kind {
  kFwd = 0, kDq = 1, kDkv = 2,            // the mma.sync bodies
  kFwdSm90 = 3, kDqSm90 = 4, kDkvSm90 = 5  // the Hopper bodies
};

using Kernel = void (*)(const Params);

template <typename T, int DP, bool POS>
int launch(int kind, int BH, const Params& p, cudaStream_t s) {
  const int nq = (p.Sq + kBlock - 1) / kBlock;
  const int nk = (p.Sk + kBlock - 1) / kBlock;
  Kernel fwd = flash_fwd<T, DP>, dq = flash_dq<T, DP>,
         dkv = flash_dkv<T, DP>;
  if (POS) {
    fwd = flash_fwd_pos<T, DP>;
    dq = flash_dq_pos<T, DP>;
    dkv = flash_dkv_pos<T, DP>;
  }
  switch (kind) {
    case kFwd:
      return launch_with_smem(fwd, dim3(BH, nq), FwdCfg<T, DP>::smem, p, s);
    case kDq:
      return launch_with_smem(dq, dim3(BH, nq), DqCfg<T, DP>::smem, p, s);
    case kDkv:
      return launch_with_smem(dkv, dim3(BH, nk, DP / DkvCfg<T, DP>::DO),
                              DkvCfg<T, DP>::smem, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool POS>
int dispatch_d(int kind, int BH, const Params& p, cudaStream_t s) {
  if (p.D <= 32) return launch<T, 32, POS>(kind, BH, p, s);
  if (p.D <= 64) return launch<T, 64, POS>(kind, BH, p, s);
  if (p.D <= 128) return launch<T, 128, POS>(kind, BH, p, s);
  return launch<T, 256, POS>(kind, BH, p, s);
}

// The Hopper bodies: the forward (kind 3), dQ (4) and dK/dV (5) on q, k,
// v (and dout) as 4-D tensor maps over the caller's strides; tiles of 128
// rows, blocks of 64 (the forward's as HopCfg says); pos: the ring step's
// kernels (PosMask, causal), of one length Sq == Sk
int launch_sm90(int kind, const Params& p, int B, bool pos, cudaStream_t s) {
  const void* bases[4] = {p.q, p.k, p.v, p.dout};
  const long long st[4][3] = {{p.q_b, p.q_s, p.q_h},
                              {p.k_b, p.k_s, p.k_h},
                              {p.v_b, p.v_s, p.v_h},
                              {p.d_b, p.d_s, p.d_h}};
  if (kind == kFwdSm90) {
    const FwdArgs a{p.out0, p.lse_out, p.Sq, p.H, p.D, p.scale, p.causal};
    const void* const qkv[3] = {p.q, p.k, p.v};
    const long long qkv_st[3][3] = {{st[0][0], st[0][1], st[0][2]},
                                    {st[1][0], st[1][1], st[1][2]},
                                    {st[2][0], st[2][1], st[2][2]}};
    if (pos)
      return launch_fwd_sm90<flash_fwd_pos_sm90<64>, flash_fwd_pos_sm90<128>,
                             true>(qkv, qkv_st, B, a, s,
                                   PosMask{p.qpos, p.kpos});
    return launch_fwd_sm90<flash_fwd_sm90<64>, flash_fwd_sm90<128>>(
        qkv, qkv_st, B, a, s);
  }
  const PosMask pm{p.qpos, p.kpos};
  if (kind == kDkvSm90)
    return pos ? launch_bwd_sm90<flash_dkv_pos_sm90<64>,
                                 flash_dkv_pos_sm90<128>, true, false, true>(
                     bases, st, B, p, s, pm)
               : launch_bwd_sm90<flash_dkv_sm90<64>, flash_dkv_sm90<128>,
                                 true, false>(bases, st, B, p, s);
  return pos ? launch_bwd_sm90<flash_dq_pos_sm90<64>, flash_dq_pos_sm90<128>,
                               false, false, true>(bases, st, B, p, s, pm)
             : launch_bwd_sm90<flash_dq_sm90<64>, flash_dq_sm90<128>, false,
                               false>(bases, st, B, p, s);
}

int run(int kind, Params& p, int BH, int dtype, bool pos, void* stream) {
  if (p.D < 1 || p.D > 256 || p.Sq < 1 || p.Sk < 1 || BH < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ch = dtype == kF32 ? 4 : 8;    // elements per 16-byte load
  bool vec = aligned16(p.q) && aligned16(p.k) && aligned16(p.v) &&
             aligned16(p.dout);
  for (long long st : {p.q_b, p.q_s, p.q_h, p.k_b, p.k_s, p.k_h, p.v_b,
                       p.v_s, p.v_h, p.d_b, p.d_s, p.d_h})
    vec = vec && st % ch == 0;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind >= kFwdSm90) {
    // what the Hopper bodies admit (a ring step: shards of one length);
    // asked for anything else, the entry refuses rather than run another
    // body. A ring step without the mask is the whole-sequence kernel's
    // work with causal off.
    if (kind > kDkvSm90 || dtype != kBF16 || !vec || p.D <= 32 ||
        p.D > 128 || p.D % 8 != 0 || !(p.scale > 0.f) ||
        (pos && p.Sq != p.Sk))
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_sm90(kind, p, BH / p.H, pos && p.causal, s);
    return err != 0 ? err : static_cast<int>(cudaGetLastError());
  }
  int err;
  switch (dtype) {
    case kF32:
      err = pos ? dispatch_d<float, true>(kind, BH, p, s)
                : dispatch_d<float, false>(kind, BH, p, s);
      break;
    case kBF16:
      err = pos ? dispatch_d<__nv_bfloat16, true>(kind, BH, p, s)
                : dispatch_d<__nv_bfloat16, false>(kind, BH, p, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 forward (q, k, v -> out0 = O, lse_out), 1 dQ (q, k, v, dout,
// lse, delta -> out0), 2 dK, dV (-> out0, out1); 3, 4, 5 the same on the
// Hopper bodies (bf16, 32 < D <= 128, TMA-describable strides). dims = {B, S, H, D, then
// the (b, s, h) element strides of q, k, v and dout} (dout's are 0 for a
// forward): q, k, v, dout are [B, S, H, D] with a unit stride along D;
// outputs are contiguous [B, S, H, D]; lse / delta are [B*H, S] f32. The
// sizes travel packed, as one pointer, because a call's host time is part
// of its cost.
extern "C" int ptt_flash_attention(int kind, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* out0, void* out1, void* lse_out,
                                   const long long* dims, int dtype,
                                   float scale, int causal, void* stream) {
  const long long* st = dims + 4;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), out0, out1,
           static_cast<float*>(lse_out), nullptr, nullptr,
           static_cast<int>(dims[1]), static_cast<int>(dims[1]),
           static_cast<int>(dims[2]), static_cast<int>(dims[3]), st[0], st[1],
           st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
           st[11], scale, causal, 0};
  return run(kind, p, static_cast<int>(dims[0] * dims[2]), dtype, false,
             stream);
}

// The ring-step kernels: the kinds of ptt_flash_attention (0-2 the
// mma.sync bodies, 3-5 the Hopper bodies, which take Sq == Sk only), with
// q / dout of Sq = dims[1] rows and k / v of Sk rows (dK, dV [B, Sk, H,
// D]; lse, delta [B*H, Sq]) and the causal mask qpos[i] >= kpos[j] on
// int32 positions ([Sq], [Sk]); dims packed as for ptt_flash_attention.
extern "C" int ptt_flash_attention_pos(
    int kind, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* out0, void* out1,
    void* lse_out, const void* qpos, const void* kpos, const long long* dims,
    int Sk, int dtype, float scale, int causal, void* stream) {
  const long long* st = dims + 4;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), out0, out1,
           static_cast<float*>(lse_out), static_cast<const int*>(qpos),
           static_cast<const int*>(kpos), static_cast<int>(dims[1]), Sk,
           static_cast<int>(dims[2]), static_cast<int>(dims[3]), st[0], st[1],
           st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
           st[11], scale, causal, 0};
  return run(kind, p, static_cast<int>(dims[0] * dims[2]), dtype, true,
             stream);
}
