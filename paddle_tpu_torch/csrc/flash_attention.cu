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
// registers): `flash_fwd_sm90` (attention_sm90.cuh's body, see its note),
// `flash_dq_sm90` and `flash_dkv_sm90` (see theirs). The caller asks for
// them as kinds 3, 4 and 5, and an entry asked for a kind its inputs do
// not admit returns cudaErrorInvalidValue. f32 inputs, head-dim tiles 32
// and 256 and the ring steps keep the mma.sync bodies (kinds 0-2).
//
// The ring-step (_pos) kernels run the same bodies with the causal test
// `row >= col` replaced by int32 global positions, q_pos[row] >=
// k_pos[col], and q and k of their own lengths (Sq, Sk). A zigzag shard's
// positions are not monotone in the shard, so the index shortcuts above
// (K blocks bounded by the diagonal) do not apply: every block is
// visited, and a whole K (or, in dkv, Q) block is skipped only when the
// positions say that no pair in it is kept — max(q_pos of the CTA's rows)
// < min(k_pos of the block) — decided by one __syncthreads_or. A row that
// the mask hides throughout (a visiting shard wholly in its future) keeps
// m = -1e30 and l = 0 and is written as O = 0, lse = m + log(1e-30), the
// TPU kernel's l_safe, so the ring's merge gives it weight 0.
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

// --- backward on Hopper: TMA-fed wgmma, dS and P^T in registers ---------------
// Two kernels, as the mma.sync bodies: each output has one owning CTA and
// is summed in a fixed order (no atomics), so the backward stays bitwise
// reproducible. A persistent CTA per multiprocessor walks `Units` of
// 128-row tiles; two consumer warpgroups own 64 rows each, and a producer
// warp keeps the tile's two resident operands (double-buffered) and a ring
// of blocks of the two streamed ones, loaded by TMA through the caller's
// strides (rows past S and columns past D load as zeros; D = 80 runs in
// the 128-column tiles).
//   dQ     a tile of 128 query rows: Q and dO resident, K and V streamed
//          in blocks of 64 keys. Per block S = Q K^T and dP = dO V^T (ss,
//          both K-major), P = 2^(s sl2 - lse log2 e) masked to 0 after the
//          exp, dS = P (dP - delta) scale packed to bf16 A fragments, and
//          dQ += dS K (rs, K MN-major through the transpose bit, as V in
//          the forward). dS never touches shared memory. Causal: blocks
//          up to the diagonal.
//   dK/dV  a tile of keys: K and V resident, Q and dO streamed in blocks
//          of 64 query rows with their lse (times log2 e) and delta, which
//          the producer warp's lanes copy beside them. Per block S^T =
//          K Q^T (ss), P^T in registers, dV += P^T dO (rs, dO MN-major),
//          dP^T = V dO^T (ss), dS^T = P^T (dP^T - delta) scale, dK +=
//          dS^T Q (rs, Q MN-major). Causal: blocks from the diagonal.
//          D = 64: a tile of 128 keys, each warpgroup all four products
//          of its 64 keys (dK, dV, P^T, dP^T: 128 f32 registers).
//          D = 128: dK and dV alone take 128 registers a thread, and
//          ptxas caps these 288-thread kernels at 168 (whatever setmaxnreg
//          asks); holding P^T and dP^T beside them spilled 736 bytes. So
//          the two warpgroups share a tile of 64 keys: warpgroup 0 forms
//          S^T, P^T and dV, and hands P^T in f32 to warpgroup 1 through a
//          double-buffered shared-memory tile (each thread's entries
//          stored where the same thread of warpgroup 1 reads them, on
//          mbarriers); warpgroup 1 forms dP^T, dS^T and dK. The same four
//          products, none recomputed, 112 and 144 live f32 registers.
// Each product closes (wgmma_wait<0>) before the registers of the next
// are defined (ptxas serializes wgmma otherwise: C7513), and the two
// warpgroups take turns on the tensor cores. The causal units pair a long
// tile with a short one (`Units`). 288 threads, one CTA an SM.
template <int DP, bool DKV>
struct BwdCfg {
  static constexpr int NSUB = DP / 64;          // 64-column sub-tiles
  static constexpr int NWG = 2;                 // consumer warpgroups
  // dK/dV at D = 128: both warpgroups on one 64-key tile (see above)
  static constexpr bool SPLIT = DKV && DP == 128;
  static constexpr int ROWS = SPLIT ? 64 : 64 * NWG;  // resident rows a tile
  static constexpr int BN = 64;                 // streamed rows a block
  static constexpr int STAGES = DP == 64 ? 4 : SPLIT ? 3 : 2;
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int kRSub = ROWS * 128;      // one [ROWS][64] sub-tile
  static constexpr int kR = NSUB * kRSub;       // one resident operand
  static constexpr int kSub = BN * 128;         // one [BN][64] sub-tile
  static constexpr int kB = NSUB * kSub;        // one streamed operand
  static constexpr int kPT = SPLIT ? 64 * 64 * 4 : 0;  // one f32 P^T tile
  static constexpr size_t smem = 1024 + 4 * kR + 2 * STAGES * kB + 2 * kPT +
                                 2 * STAGES * BN * sizeof(float) +
                                 (8 + 2 * STAGES) * sizeof(uint64_t);
};

// shared memory of a backward CTA: [2 buffers][2] resident tiles, [STAGES]
// [2] streamed blocks, [2] P^T tiles (SPLIT), [STAGES][2][BN] f32 rows
// (dK/dV: lse log2 e, delta), then the barriers; thread 0 initialises them
// (s_full takes `s_arrivals` arrivals a phase, the P^T hand-over one from
// each of a warpgroup's four warps)
template <int DP, bool DKV>
struct BwdSmem {
  using C = BwdCfg<DP, DKV>;
  uint8_t *R, *S;
  float *PT, *F;
  uint64_t *r_full, *r_empty, *s_full, *s_empty, *pt_full, *pt_empty;
  __device__ BwdSmem(uint8_t* raw, int s_arrivals) {
    R = align1024(raw);
    S = R + 4 * C::kR;
    PT = reinterpret_cast<float*>(S + 2 * C::STAGES * C::kB);
    F = PT + 2 * C::kPT / 4;
    r_full = reinterpret_cast<uint64_t*>(F + 2 * C::STAGES * C::BN);
    r_empty = r_full + 2;
    pt_full = r_full + 4;
    pt_empty = r_full + 6;
    s_full = r_full + 8;
    s_empty = s_full + C::STAGES;
    if (threadIdx.x == 0) {
      for (int i = 0; i < 2; ++i) {
        mbar_init(&r_full[i], 1);
        mbar_init(&r_empty[i], C::NWG);
        mbar_init(&pt_full[i], 4);
        mbar_init(&pt_empty[i], 4);
      }
      for (int s = 0; s < C::STAGES; ++s) {
        mbar_init(&s_full[s], s_arrivals);
        mbar_init(&s_empty[s], C::NWG);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }
  __device__ uint8_t* res(int buf, int x) const { return R + (2 * buf + x) * C::kR; }
  __device__ uint8_t* blk(int s, int y) const { return S + (2 * s + y) * C::kB; }
};

// the streamed blocks [lo, hi) of the tile whose first resident row is r0:
// dQ (DKV false) key blocks up to the diagonal when causal, dK/dV query
// blocks from it
template <int BN, bool DKV>
__device__ __forceinline__ void bwd_range(const Params& p, int r0, int rows,
                                          int& lo, int& hi) {
  const int n = (p.Sq + BN - 1) / BN;
  if (DKV) {
    lo = p.causal ? r0 / BN : 0;
    hi = n;
  } else {
    lo = 0;
    hi = p.causal ? min((r0 + rows + BN - 1) / BN, n) : n;
  }
}

template <int DP, bool DKV>
__device__ __forceinline__ void bwd_producer(const BwdSmem<DP, DKV>& sm,
                                             const CUtensorMap& r0m,
                                             const CUtensorMap& r1m,
                                             const CUtensorMap& b0m,
                                             const CUtensorMap& b1m,
                                             const Params& p,
                                             const Units& units) {
  using C = BwdCfg<DP, DKV>;
  constexpr int NS = C::STAGES, BN = C::BN;
  const int lane = threadIdx.x & 31;
  if (!DKV && lane != 0) return;        // dQ: one thread issues the loads
  int jj = 0, tt = 0;                   // blocks and tiles loaded so far
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int bh, tiles[2];
    const int nt = units.tiles(u, bh, tiles);
    const int b = bh / p.H, h = bh % p.H;
    for (int i = 0; i < nt; ++i, ++tt) {
      const int r0 = tiles[i] * C::ROWS;
      int lo, hi;
      bwd_range<BN, DKV>(p, r0, C::ROWS, lo, hi);
      const int rb = tt & 1;
      if (lane == 0) {
        mbar_wait(&sm.r_empty[rb], ((tt >> 1) & 1) ^ 1);
        mbar_expect_tx(&sm.r_full[rb], 2 * C::kR);
        for (int sub = 0; sub < C::NSUB; ++sub) {
          tma_load_4d(sm.res(rb, 0) + sub * C::kRSub, &r0m, &sm.r_full[rb],
                      sub * 64, h, r0, b);
          tma_load_4d(sm.res(rb, 1) + sub * C::kRSub, &r1m, &sm.r_full[rb],
                      sub * 64, h, r0, b);
        }
      }
      for (int j = lo; j < hi; ++j, ++jj) {
        const int s = jj % NS;
        mbar_wait(&sm.s_empty[s], ((jj / NS) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&sm.s_full[s], 2 * C::kB);
          for (int sub = 0; sub < C::NSUB; ++sub) {
            tma_load_4d(sm.blk(s, 0) + sub * C::kSub, &b0m, &sm.s_full[s],
                        sub * 64, h, j * BN, b);
            tma_load_4d(sm.blk(s, 1) + sub * C::kSub, &b1m, &sm.s_full[s],
                        sub * 64, h, j * BN, b);
          }
        }
        if constexpr (DKV) {
          // the block's lse (log2 domain) and delta, 0 past S; the
          // stage's second arrival once every lane's stores are done
          const float* lse = p.lse + static_cast<size_t>(bh) * p.Sq;
          const float* delta = p.delta + static_cast<size_t>(bh) * p.Sq;
          float* f = sm.F + 2 * s * BN;
          for (int r = lane; r < BN; r += 32) {
            const int q = j * BN + r;
            const bool in = q < p.Sq;
            f[r] = in ? lse[q] * 1.4426950408889634f : 0.f;
            f[BN + r] = in ? delta[q] : 0.f;
          }
          __threadfence_block();
          __syncwarp();
          if (lane == 0) mbar_arrive(&sm.s_full[s]);
        }
      }
    }
  }
}

// an accumulator tile's two rows (row_lo and row_lo + 8, below S) into a
// contiguous [B, S, H, D] bf16 output
template <int NSUB>
__device__ __forceinline__ void store_tile_rows(void* outp,
                                                const float (&acc)[NSUB][32],
                                                const Params& p, int b,
                                                int h, int row_lo) {
  const int t = threadIdx.x & 3;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(outp);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row_lo + 8 * hh;
    if (r >= p.Sq) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * p.Sq + r) * p.H + h) * p.D;
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = sub * 64 + 8 * i + 2 * t;   // D % 8 == 0: pairs
        if (col < p.D)
          *reinterpret_cast<uint32_t*>(orow + col) = pack2<__nv_bfloat16>(
              acc[sub][4 * i + 2 * hh], acc[sub][4 * i + 2 * hh + 1]);
      }
  }
}

// A[64 rows of warpgroup wg][DP] (+)= ... : the K-major descriptors of k16
// slice ks of a [rows][64]-sub-tiled operand whose sub-tiles are `sub`
// bytes apart, starting at row `row0`
__device__ __forceinline__ uint64_t kdesc(const uint8_t* base, int sub,
                                          int row0, int ks) {
  return make_desc(base + (ks >> 2) * sub + row0 * 128 + (ks & 3) * 32, 16,
                   1024, kSW128);
}

// d[64 x 64] = A B^T over DP columns, both operands K-major
template <int DP>
__device__ __forceinline__ void wg_ss(float (&d)[32], const uint8_t* a,
                                      int a_sub, int a_row0,
                                      const uint8_t* bm, int b_sub) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wgmma_ss_bf16<64, 0, 0>(d, kdesc(a, a_sub, a_row0, ks),
                            kdesc(bm, b_sub, 0, ks), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(d);
}

// acc[64 x DP] += A[64 x 64] (bf16 fragments) . B[64 rows x DP], B from a
// [64][64]-sub-tiled block read MN-major
template <int NSUB>
__device__ __forceinline__ void wg_rs(float (&acc)[NSUB][32],
                                      uint32_t (&pa)[4][4],
                                      const uint8_t* bm, int b_sub) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) reg_fence(pa[kk]);
#pragma unroll
  for (int sub = 0; sub < NSUB; ++sub) reg_fence(acc[sub]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub)
      wgmma_rs_bf16_n64<1>(
          acc[sub], pa[kk],
          make_desc(bm + sub * b_sub + kk * 2048, 1024, 1024, kSW128), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int sub = 0; sub < NSUB; ++sub) reg_fence(acc[sub]);
}

// dQ's dS of one block: P = 2^(s sl2 - lse2) (0 where masked: MASK, the
// block crosses the causal diagonal or the end of the keys), dS = P (dP -
// delta) scale, packed to the A fragments of dS K
template <bool MASK>
__device__ __forceinline__ void dq_ds(const float (&sc)[32],
                                      const float (&dp)[32],
                                      uint32_t (&pa)[4][4], const Params& p,
                                      int k0, int row_lo,
                                      const float (&lse2)[2],
                                      const float (&dl)[2], float sl2) {
  const int t = threadIdx.x & 3;
  float ds[32];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * i + 2 * t + (e & 1);
      const int row = row_lo + (e < 2 ? 0 : 8);
      const bool keep = !MASK || (col < p.Sk && (!p.causal || row >= col));
      const float pv =
          keep ? fast_exp2(fmaf(sc[4 * i + e], sl2, -lse2[e >> 1])) : 0.f;
      ds[4 * i + e] = pv * (dp[4 * i + e] - dl[e >> 1]) * p.scale;
    }
  pack_p<64>(ds, pa);
}

template <int DP>
__global__ void __launch_bounds__(BwdCfg<DP, false>::THREADS, 1)
    flash_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p,
                  const Units units) {
  using C = BwdCfg<DP, false>;
  constexpr int NS = C::STAGES, BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  const BwdSmem<DP, false> sm(smem_raw, 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4 * C::NWG) {
    bwd_producer<DP, false>(sm, tq, tdo, tk, tv, p, units);
    return;
  }
  const int wg = warp >> 2, g = lane >> 2;
  const bool leader = (threadIdx.x & 127) == 0;
  const float sl2 = p.scale * 1.4426950408889634f;
  int jj = 0, tt = 0;
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int bh, tiles[2];
    const int nt = units.tiles(u, bh, tiles);
    const int b = bh / p.H, h = bh % p.H;
    for (int it = 0; it < nt; ++it, ++tt) {
      const int q0 = tiles[it] * C::ROWS;
      int lo, hi;
      bwd_range<BN, false>(p, q0, C::ROWS, lo, hi);
      // key blocks wholly past this warpgroup's last row (causal), or all
      // of them when its rows lie past S: taken in turn, released unread
      const int hi_wg =
          q0 + wg * 64 >= p.Sq
              ? 0
              : p.causal ? min((q0 + wg * 64 + 64 + BN - 1) / BN, hi) : hi;
      const int row_lo = q0 + wg * 64 + (warp & 3) * 16 + g;
      float lse2[2], dl[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_lo + 8 * hh;
        const size_t at = static_cast<size_t>(bh) * p.Sq + r;
        lse2[hh] = r < p.Sq ? p.lse[at] * 1.4426950408889634f : 0.f;
        dl[hh] = r < p.Sq ? p.delta[at] : 0.f;
      }
      const uint8_t* Qb = sm.res(tt & 1, 0);
      const uint8_t* dOb = sm.res(tt & 1, 1);
      float dq[C::NSUB][32];
#pragma unroll
      for (int sub = 0; sub < C::NSUB; ++sub)
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[sub][i] = 0.f;
      mbar_wait(&sm.r_full[tt & 1], (tt >> 1) & 1);
      __syncwarp();
      for (int j = lo; j < hi; ++j, ++jj) {
        const int s = jj % NS;
        mbar_wait(&sm.s_full[s], (jj / NS) & 1);
        __syncwarp();                   // converged for the .aligned wgmma
        if (j >= hi_wg) {
          // every warp is past its wait before the leader releases the
          // stage (no wgmma orders them here)
          bar_sync(1 + wg, 128);
          if (leader) mbar_arrive(&sm.s_empty[s]);
          continue;
        }
        const uint8_t* Kb = sm.blk(s, 0);
        const uint8_t* Vb = sm.blk(s, 1);
        float sc[32], dp[32];
        wg_ss<DP>(sc, Qb, C::kRSub, wg * 64, Kb, C::kSub);
        wg_ss<DP>(dp, dOb, C::kRSub, wg * 64, Vb, C::kSub);
        const int k0 = j * BN;
        uint32_t pa[4][4];
        if (k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > q0 + wg * 64))
          dq_ds<true>(sc, dp, pa, p, k0, row_lo, lse2, dl, sl2);
        else
          dq_ds<false>(sc, dp, pa, p, k0, row_lo, lse2, dl, sl2);
        wg_rs<C::NSUB>(dq, pa, Kb, C::kSub);
        if (leader) mbar_arrive(&sm.s_empty[s]);   // K and V are read
      }
      if (leader) mbar_arrive(&sm.r_empty[tt & 1]);  // Q and dO are read
      store_tile_rows<C::NSUB>(p.out0, dq, p, b, h, row_lo);
    }
  }
}

// dK/dV's P^T of one block in place: rows are keys (krow_lo, + 8), columns
// query rows qi0 + ..., masked (MASK) past S and above the diagonal
template <bool MASK>
__device__ __forceinline__ void dkv_p(float (&st)[32], const Params& p,
                                      int qi0, int krow_lo,
                                      const float* lse2, float sl2) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ql = 8 * i + 2 * t + (e & 1), qc = qi0 + ql;
      const int kr = krow_lo + (e < 2 ? 0 : 8);
      const bool keep =
          !MASK || (qc < p.Sq && kr < p.Sk && (!p.causal || qc >= kr));
      st[4 * i + e] =
          keep ? fast_exp2(fmaf(st[4 * i + e], sl2, -lse2[ql])) : 0.f;
    }
}

// dS^T = P^T (dP^T - delta) scale over one block, in place of dP^T
__device__ __forceinline__ void dkv_ds(float (&dpt)[32], const float (&pt)[32],
                                       const float* dl, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * n + e] =
          pt[4 * n + e] * (dpt[4 * n + e] - dl[8 * n + 2 * t + (e & 1)]) *
          scale;
}

template <int DP>
__global__ void __launch_bounds__(BwdCfg<DP, true>::THREADS, 1)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo, const Params p,
                   const Units units) {
  using C = BwdCfg<DP, true>;
  constexpr int NS = C::STAGES, BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  const BwdSmem<DP, true> sm(smem_raw, 2);  // TMA bytes + the lanes' rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4 * C::NWG) {
    bwd_producer<DP, true>(sm, tk, tv, tq, tdo, p, units);
    return;
  }
  const int wg = warp >> 2, g = lane >> 2;
  const bool leader = (threadIdx.x & 127) == 0;
  const float sl2 = p.scale * 1.4426950408889634f;
  // SPLIT: warpgroup 0 forms dV, 1 dK, of the same 64 keys; else each
  // warpgroup both, of its own 64 keys
  const int wrow = C::SPLIT ? 0 : wg * 64;  // its rows in the resident tile
  int jj = 0, tt = 0, pc = 0;             // blocks, tiles, P^T hand-overs
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int bh, tiles[2];
    const int nt = units.tiles(u, bh, tiles);
    const int b = bh / p.H, h = bh % p.H;
    for (int it = 0; it < nt; ++it, ++tt) {
      const int k0 = tiles[it] * C::ROWS;
      int lo, hi;
      bwd_range<BN, true>(p, k0, C::ROWS, lo, hi);
      const int kw = k0 + wrow;          // this warpgroup's first key
      const int krow_lo = kw + (warp & 3) * 16 + g;
      const uint8_t* Kb = sm.res(tt & 1, 0);
      const uint8_t* Vb = sm.res(tt & 1, 1);
      float acc[2][C::NSUB][32];         // dK, dV (SPLIT: this one's)
      constexpr int NACC = C::SPLIT ? 1 : 2;
#pragma unroll
      for (int a = 0; a < NACC; ++a)
#pragma unroll
        for (int sub = 0; sub < C::NSUB; ++sub)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[a][sub][i] = 0.f;
      mbar_wait(&sm.r_full[tt & 1], (tt >> 1) & 1);
      __syncwarp();
      for (int i = lo; i < hi; ++i, ++jj) {
        const int s = jj % NS;
        mbar_wait(&sm.s_full[s], (jj / NS) & 1);
        __syncwarp();
        const int qi0 = i * BN;
        // no key of this warpgroup (a ragged last tile), or every query
        // row of the block before its first key (causal): released unread
        if (kw >= p.Sk || (p.causal && qi0 + BN - 1 < kw)) {
          bar_sync(1 + wg, 128);
          if (leader) mbar_arrive(&sm.s_empty[s]);
          continue;
        }
        const uint8_t* Qb = sm.blk(s, 0);
        const uint8_t* dOb = sm.blk(s, 1);
        const float* lse2 = sm.F + 2 * s * BN;
        const float* dl = lse2 + BN;
        const bool mask = qi0 + BN > p.Sq || kw + 64 > p.Sk ||
                          (p.causal && qi0 < kw + 63);
        uint32_t pa[4][4];
        float st[32];
        if (!C::SPLIT || wg == 0) {
          wg_ss<DP>(st, Kb, C::kRSub, wrow, Qb, C::kSub);
          if (mask)
            dkv_p<true>(st, p, qi0, krow_lo, lse2, sl2);
          else
            dkv_p<false>(st, p, qi0, krow_lo, lse2, sl2);
          if constexpr (C::SPLIT) {
            // P^T to warpgroup 1: entry k of thread x at [k][x]
            const int pb = pc & 1;
            mbar_wait(&sm.pt_empty[pb], ((pc >> 1) & 1) ^ 1);
            float4* dst = reinterpret_cast<float4*>(sm.PT + pb * 64 * 64) +
                          (threadIdx.x & 127);
#pragma unroll
            for (int k = 0; k < 8; ++k)
              dst[k * 128] = make_float4(st[4 * k], st[4 * k + 1],
                                         st[4 * k + 2], st[4 * k + 3]);
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.pt_full[pb]);
          }
          pack_p<64>(st, pa);
          wg_rs<C::NSUB>(acc[NACC - 1], pa, dOb, C::kSub);   // dV
        }
        if (!C::SPLIT || wg == 1) {
          float dpt[32];
          wg_ss<DP>(dpt, Vb, C::kRSub, wrow, dOb, C::kSub);
          if constexpr (C::SPLIT) {
            const int pb = pc & 1;
            mbar_wait(&sm.pt_full[pb], (pc >> 1) & 1);
            const float4* src =
                reinterpret_cast<const float4*>(sm.PT + pb * 64 * 64) +
                (threadIdx.x & 127);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const float4 v4 = src[k * 128];
              st[4 * k] = v4.x;
              st[4 * k + 1] = v4.y;
              st[4 * k + 2] = v4.z;
              st[4 * k + 3] = v4.w;
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.pt_empty[pb]);
          }
          dkv_ds(dpt, st, dl, p.scale);
          pack_p<64>(dpt, pa);
          wg_rs<C::NSUB>(acc[0], pa, Qb, C::kSub);           // dK
        }
        ++pc;
        if (leader) mbar_arrive(&sm.s_empty[s]);   // Q, dO and rows read
      }
      if (leader) mbar_arrive(&sm.r_empty[tt & 1]);  // K and V are read
      if (!C::SPLIT || wg == 1)
        store_tile_rows<C::NSUB>(p.out0, acc[0], p, b, h, krow_lo);
      if (!C::SPLIT || wg == 0)
        store_tile_rows<C::NSUB>(p.out1, acc[NACC - 1], p, b, h, krow_lo);
    }
  }
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
// rows, blocks of 64 (the forward's as HopCfg says)
int launch_sm90(int kind, const Params& p, int B, cudaStream_t s) {
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
    return launch_fwd_sm90<flash_fwd_sm90<64>, flash_fwd_sm90<128>>(
        qkv, qkv_st, B, a, s);
  }
  // resident operands first (dQ: q, dout; dK/dV: k, v), then the streamed
  const bool dkv = kind == kDkvSm90;
  const int order[4] = {dkv ? 1 : 0, dkv ? 2 : 3, dkv ? 0 : 1, dkv ? 3 : 2};
  const int rows = !dkv                ? BwdCfg<64, false>::ROWS
                   : p.D <= 64 ? BwdCfg<64, true>::ROWS
                               : BwdCfg<128, true>::ROWS;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const int o = order[i];
    if (!attn_tmap(&maps[i], bases[o], B, p.Sq, p.H, p.D, st[o][0],
                   st[o][1], st[o][2], i < 2 ? rows : BwdCfg<64, true>::BN))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Units units((p.Sq + rows - 1) / rows, B * p.H, p.causal != 0);
  const dim3 grid(std::min(units.count, sm_count()));
  auto go = [&](auto kernel, auto dp) {
    constexpr int DP = decltype(dp)::value;
    constexpr auto K = decltype(kernel)::value;
    using C = std::conditional_t<K == flash_dkv_sm90<DP>,
                                 BwdCfg<DP, true>, BwdCfg<DP, false>>;
    if (const int e = smem_opt_in<K>(C::smem)) return e;
    K<<<grid, C::THREADS, C::smem, s>>>(maps[0], maps[1], maps[2], maps[3],
                                         p, units);
    return 0;
  };
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  if (p.D <= 64)
    return dkv ? go(std::integral_constant<decltype(&flash_dkv_sm90<64>),
                                           flash_dkv_sm90<64>>(), I64())
               : go(std::integral_constant<decltype(&flash_dq_sm90<64>),
                                           flash_dq_sm90<64>>(), I64());
  return dkv ? go(std::integral_constant<decltype(&flash_dkv_sm90<128>),
                                         flash_dkv_sm90<128>>(), I128())
             : go(std::integral_constant<decltype(&flash_dq_sm90<128>),
                                         flash_dq_sm90<128>>(), I128());
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
    // what the Hopper bodies admit; asked for anything else, the entry
    // refuses rather than run another body
    if (kind > kDkvSm90 || dtype != kBF16 || pos || !vec || p.D <= 32 ||
        p.D > 128 || p.D % 8 != 0 || !(p.scale > 0.f))
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_sm90(kind, p, BH / p.H, s);
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

// The ring-step kernels: kinds 0-2 of ptt_flash_attention, sizes and
// strides as arguments, with q / dout of Sq rows, k / v of Sk rows (dK, dV
// [B, Sk, H, D]; lse, delta [B*H, Sq]) and the causal mask qpos[i] >=
// kpos[j] on int32 positions ([Sq], [Sk]).
extern "C" int ptt_flash_attention_pos(
    int kind, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* out0, void* out1,
    void* lse_out, const void* qpos, const void* kpos, int B, int Sq, int Sk,
    int H, int D, long long q_b, long long q_s, long long q_h, long long k_b,
    long long k_s, long long k_h, long long v_b, long long v_s,
    long long v_h, long long d_b, long long d_s, long long d_h, int dtype,
    float scale, int causal, void* stream) {
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), out0, out1,
           static_cast<float*>(lse_out), static_cast<const int*>(qpos),
           static_cast<const int*>(kpos), Sq, Sk, H, D, q_b, q_s, q_h, k_b,
           k_s, k_h, v_b, v_s, v_h, d_b, d_s, d_h, scale, causal, 0};
  return run(kind, p, B * H, dtype, true, stream);
}
