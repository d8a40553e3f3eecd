// Short-sequence attention with attention-probability dropout drawn inside
// the kernels, forward and backward, on [B, S, H, D] tensors.
//
// Replaces paddle_tpu/ops/pallas/short_attention.py `_fwd_kernel` (the
// forward, reached through `_fwd_call`) and `_bwd_kernel` (the backward,
// reached through `_bwd_rule`).
//
// Per head (b, h), with s = (q . k) * scale, the causal mask row >= col,
// P = softmax(s) and the dropout factor Z = keep ? 1 / (1 - p) : 0:
//   forward   O = (P o Z) V, lse = m + log(l), online over K blocks: Z
//             multiplies the unnormalised exp(s - m) that meets V, before
//             its cast to the input type; the row sum l stays unmasked;
//   dq kernel a first pass over K blocks forms the row term
//             D_i = sum_j P Z dP (= dO_i . O_i, so O need not be kept),
//             stores it, and a second forms dQ = sum_k dS K,
//             dS = P o (dP o Z - D) * scale, dP = dO V^T;
//   dkv       dV = sum_q (P o Z)^T dO, dK = sum_q dS^T Q, from lse and D.
// The keep bits are Philox4x32-10 of (seed, b, h, i, j) (the layout is
// ops/_dropout_rng.py's): key (seed lo, seed hi), counter (j & ~8, i & ~8,
// h, b), word 2 * bit3(i) + bit3(j). One call covers the 2x2 group
// {i, i + 8} x {j, j + 8}, which one thread holds of a score tile in both
// the forward/dQ layout (rows i, columns j) and the dK/dV kernel's
// transposed one, so no drawn word is wasted. The forward and both
// backward kernels replay the same bits; nothing but lse is saved.
//
// The TPU kernel runs one grid step per batch element and holds every
// head's whole [S, S] score matrix in VMEM; at S = 512 one f32 [S, S] tile
// is 1 MB, past a CTA's shared memory. So this is FlashAttention-2 with
// dropout, on the tile machinery of flash_attention.cu
// (attention_tiles.cuh): 4-warp CTAs of 64 rows, mma.sync m16n8k16 bf16
// products with f32 accumulation, f32 inputs as CUDA-core FMAs in the same
// layout, tiles read through the caller's strides (no transposes), rows
// >= S and columns >= D loaded as zeros (any S, D <= 256 padded to the
// next tile width), no atomics (the backward is bitwise reproducible).
//
// What bounds it on an H100: at BERT-base's training shape (S = 128,
// D = 64) the bytes — q, k, v, O read or written once are 4 x 25 MB, while
// the products, 4 * S^2 * D per head, take a fifth of that time at the
// tensor-core peak; the in-kernel Philox adds ~100 integer operations per
// four probabilities. The mma.sync bodies load synchronously. For bf16 at
// 32 < D <= 128 the forward and the backward have Hopper bodies, the
// flash bodies of attention_sm90.cuh with this file's dropout policy:
// `sa_fwd_sm90`, `sa_dq_sm90` and `sa_dkv_sm90` (below): TMA-fed wgmma
// with P and dS in registers. The forward draws a block's Philox bits
// just before its S product is issued, while the other warpgroups'
// products run (attention_sm90.cuh's note says why not during its own);
// the backward's dQ kernel draws while its own S and dP products run, its
// dK/dV kernel just before S^T is issued (drawn in flight, it ran slower
// beside dK's and dV's accumulators). The integer work bounds the forward
// (~0.6 G integer instructions a draw at BERT-base's shape); the backward
// draws twice (dQ's first sweep, whose words its second sweep reuses, and
// dK/dV).
#include <math.h>

#include "attention_sm90.cuh"

namespace {

using namespace ptt;
using namespace ptt::attn;
using namespace ptt::attn90;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const long long* seed;  // [1] on the device (read only when dropout)
  float* lse;             // [B*H, S]: forward output, backward input
  float* delta;           // [B*H, S]: dq kernel output, dkv kernel input
  void* out0;             // forward: O; dq kernel: dQ; dkv kernel: dK
  void* out1;             // dkv kernel: dV
  int S, H, D;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, d_b, d_s, d_h;
  float scale;            // softmax scale
  float keep_scale;       // 1 / (1 - p)
  unsigned thresh;        // keep where bits >= thresh
  int dropout;            // p > 0
  int causal;
  int vec;                // 16-byte loads allowed (alignment and strides)
};

// --- the dropout stream ------------------------------------------------------
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0,
                                        uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

struct Stream {
  uint32_t k0, k1, b, h;
};

__device__ __forceinline__ Stream stream_of(const Params& p, int b, int h) {
  const unsigned long long sd =
      p.dropout ? static_cast<unsigned long long>(*p.seed) : 0ull;
  return Stream{static_cast<uint32_t>(sd), static_cast<uint32_t>(sd >> 32),
                static_cast<uint32_t>(b), static_cast<uint32_t>(h)};
}

// Keep bits of a score tile in the accumulator layout, bit 4n + e for
// element [n][e]; word 2u + v of a call holds element (i + 8u, j + 8v).
// `thresh` is taken by reference: in sa_dq it then stays an operand of
// the kernel's parameter space, where a value copy cost 36 registers
// (164 against 128 at bf16, D = 64, and 6 % of the backward's time).
// Rows are queries (forward, dQ): rows i_lo, i_lo + 8 by e < 2, columns
// j0 + 8n + 2t + (e & 1). i_lo and j0 have bit 3 clear.
template <int NT>
__device__ __forceinline__ unsigned keep_rows_q(const unsigned& thresh,
                                                const Stream& st, int i_lo,
                                                int j0) {
  const int t = threadIdx.x & 3;
  unsigned bits = 0;
#pragma unroll
  for (int n = 0; n < NT; n += 2)
#pragma unroll
    for (int ec = 0; ec < 2; ++ec) {
      const uint4 w = philox(j0 + n * 8 + 2 * t + ec, i_lo, st.h, st.b,
                             st.k0, st.k1);
      bits |= static_cast<unsigned>(w.x >= thresh) << (n * 4 + ec);
      bits |= static_cast<unsigned>(w.y >= thresh) << ((n + 1) * 4 + ec);
      bits |= static_cast<unsigned>(w.z >= thresh) << (n * 4 + 2 + ec);
      bits |= static_cast<unsigned>(w.w >= thresh)
              << ((n + 1) * 4 + 2 + ec);
    }
  return bits;
}

// The transposed tile (dK/dV): rows are keys j_lo, j_lo + 8 by e < 2,
// columns queries i0 + 8n + 2t + (e & 1).
template <int NT>
__device__ __forceinline__ unsigned keep_rows_k(const unsigned& thresh,
                                                const Stream& st, int j_lo,
                                                int i0) {
  const int t = threadIdx.x & 3;
  unsigned bits = 0;
#pragma unroll
  for (int n = 0; n < NT; n += 2)
#pragma unroll
    for (int ec = 0; ec < 2; ++ec) {
      const uint4 w = philox(j_lo, i0 + n * 8 + 2 * t + ec, st.h, st.b,
                             st.k0, st.k1);
      bits |= static_cast<unsigned>(w.x >= thresh) << (n * 4 + ec);
      bits |= static_cast<unsigned>(w.y >= thresh) << (n * 4 + 2 + ec);
      bits |= static_cast<unsigned>(w.z >= thresh) << ((n + 1) * 4 + ec);
      bits |= static_cast<unsigned>(w.w >= thresh)
              << ((n + 1) * 4 + 2 + ec);
    }
  return bits;
}

// --- forward -----------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) sa_fwd(const Params p) {
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
  const Stream st = stream_of(p, b, h);

  load_tile<T, kBlock, DP, LD>(Qs, q, p.q_s, q0, p.S, p.D, p.vec);
  const int r_lo = q0 + warp * kRows + g, r_hi = r_lo + 8;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float acc[NO][4];
  zero(acc);
  const int n_kv = (p.S + BK - 1) / BK;
  const int hi = p.causal ? min((q0 + kBlock + BK - 1) / BK, n_kv) : n_kv;
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();                       // the last step's K/V are read
    load_tile<T, BK, DP, LD>(Ks, k, p.k_s, k0, p.S, p.D, p.vec);
    load_tile<T, BK, DP, LD>(Vs, v, p.v_s, k0, p.S, p.D, p.vec);
    __syncthreads();
    float s[NS][4];
    zero(s);
    warp_mma<NS, DP, true>(s, Qs + warp * kRows * LD, LD, Ks, LD);
    const unsigned keep =
        p.dropout ? keep_rows_q<NS>(p.thresh, st, q0 + warp * kRows + g, k0)
                  : ~0u;
    unsigned ok = 0;
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r_lo : r_hi;
        const bool in = col < p.S && (!p.causal || row >= col);
        ok |= static_cast<unsigned>(in) << (n * 4 + e);
        s[n][e] = in ? s[n][e] * p.scale : kNegInf;
        if (e < 2) mx_lo = fmaxf(mx_lo, s[n][e]);
        else mx_hi = fmaxf(mx_hi, s[n][e]);
      }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float c_lo = __expf(m_lo - mn_lo), c_hi = __expf(m_hi - mn_hi);
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bit = n * 4 + e;
        const float pv = (ok >> bit) & 1u
                             ? __expf(s[n][e] - (e < 2 ? mn_lo : mn_hi))
                             : 0.f;
        // l sums every probability; only kept ones, times 1 / (1 - p),
        // meet V (scaled before the cast to T, as the TPU kernel casts
        // probs * mask)
        if (e < 2) rs_lo += pv;
        else rs_hi += pv;
        Ps[(g + (e < 2 ? 0 : 8)) * LDP + n * 8 + 2 * t + (e & 1)] =
            from_f<T>((keep >> bit) & 1u ? pv * p.keep_scale : 0.f);
      }
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
  store_rows<T, NO>(static_cast<T*>(p.out0), acc, b, h, r_lo, 0, p.S, p.H,
                    p.D, l_lo, l_hi);
  if (t == 0) {
    float* lse = p.lse + static_cast<size_t>(bh) * p.S;
    if (r_lo < p.S) lse[r_lo] = m_lo + logf(l_lo);
    if (r_hi < p.S) lse[r_hi] = m_hi + logf(l_hi);
  }
}

// --- forward on Hopper: attention_sm90.cuh's body with the dropout drawn --
// The bf16 forward at head-dim tiles 64 and 128 (32 < D <= 128, D % 8 ==
// 0, TMA-describable strides; kind 3) runs the flash forward's Hopper
// body with this policy: keep_rows_q on the m64nBK accumulator, whose warp
// slices have the m16n8 layout it assumes (rows 16 (warp in warpgroup) +
// g and + 8), drawn just before the block's S wgmma is issued, while the
// other warpgroups' products run (see attention_sm90.cuh's note on the
// dropout policy). At BERT's S = 128 a head is
// one 128-row tile over two 64-key blocks, so its K and V are read once.
struct PhiloxDropout {
  static constexpr bool kOn = true;
  const long long* seed;  // [1] on the device
  float ks;               // 1 / (1 - p)
  unsigned thresh;
  int drop;               // p > 0
  uint32_t k0, k1;        // the key, from the seed (init)
  __device__ void init() {
    const unsigned long long sd =
        drop ? static_cast<unsigned long long>(*seed) : 0ull;
    k0 = static_cast<uint32_t>(sd);
    k1 = static_cast<uint32_t>(sd >> 32);
  }
  __device__ bool on() const { return drop != 0; }
  template <int BK>
  __device__ void draw(uint32_t (&bits)[BK / 64], int b, int h, int row_lo,
                       int c0) const {
    const Stream st{k0, k1, static_cast<uint32_t>(b),
                    static_cast<uint32_t>(h)};
#pragma unroll
    for (int w = 0; w < BK / 64; ++w)
      bits[w] = keep_rows_q<8>(thresh, st, row_lo, c0 + 64 * w);
  }
  // the dK/dV body's S^T accumulator: keep_rows_k's layout, the same
  // Philox words as `draw`, so the same bit for each (b, h, i, j)
  template <int BN>
  __device__ void draw_t(uint32_t (&bits)[BN / 64], int b, int h,
                         int krow_lo, int q0) const {
    const Stream st{k0, k1, static_cast<uint32_t>(b),
                    static_cast<uint32_t>(h)};
#pragma unroll
    for (int w = 0; w < BN / 64; ++w)
      bits[w] = keep_rows_k<8>(thresh, st, krow_lo, q0 + 64 * w);
  }
  __device__ float keep_scale() const { return ks; }
};

template <int DP>
__global__ void __launch_bounds__(HopCfg<DP>::THREADS, HopCfg<DP>::CTAS)
    sa_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const FwdArgs a,
                const Units units, const PhiloxDropout drop) {
  fwd_sm90_body<DP>(tq, tk, tv, a, units, drop);
}

// --- backward on Hopper: attention_sm90.cuh's bodies with the dropout -----
// The bf16 backward at head-dim tiles 64 and 128 (32 < D <= 128, D % 8 ==
// 0, S <= 512, TMA-describable strides; kinds 4 and 5) runs the flash
// backward's Hopper bodies with this policy. dQ (ROW): a first sweep over
// the key blocks forms the row term D_i = sum_j P Z dP in f32 (the keep
// words, drawn while S and dP are in flight, wait in shared memory),
// stores it in `delta`, and a second forms dS = P (dP Z - D) scale and
// dQ. dK/dV: the keep bits drawn transposed (`draw_t`) for S^T's
// accumulator just before S^T is issued; dV takes P o Z cast to bf16, dK
// dS^T.
// At BERT's S = 128 a head is one 128-row tile over two 64-key blocks.
template <int DP>
__global__ void __launch_bounds__(BwdCfg<DP, false, true>::THREADS, 1)
    sa_dq_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const BwdArgs a,
               const Units units, const PhiloxDropout drop) {
  dq_sm90_body<DP, true>(tq, tdo, tk, tv, a, units, drop);
}

template <int DP>
__global__ void __launch_bounds__(BwdCfg<DP, true>::THREADS, 1)
    sa_dkv_sm90(const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo, const BwdArgs a,
                const Units units, const PhiloxDropout drop) {
  dkv_sm90_body<DP>(tk, tv, tq, tdo, a, units, drop);
}

// --- backward: D, then dQ ------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) sa_dq(const Params p) {
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
  const Stream st = stream_of(p, b, h);

  load_tile<T, kBlock, DP, LD>(Qs, q, p.q_s, q0, p.S, p.D, p.vec);
  load_tile<T, kBlock, DP, LD>(dOs, dout, p.d_s, q0, p.S, p.D, p.vec);
  const int r_lo = q0 + warp * kRows + g, r_hi = r_lo + 8;
  const float* lse = p.lse + static_cast<size_t>(bh) * p.S;
  const float lse_lo = r_lo < p.S ? lse[r_lo] : 0.f;
  const float lse_hi = r_hi < p.S ? lse[r_hi] : 0.f;
  const int n_kv = (p.S + BK - 1) / BK;
  const int hi = p.causal ? min((q0 + kBlock + BK - 1) / BK, n_kv) : n_kv;
  float dl_lo = 0.f, dl_hi = 0.f;
  float acc[NO][4];
  zero(acc);
  // pass 0 forms D_i = sum_j P Z dP; pass 1 dS and dQ
  for (int pass = 0; pass < 2; ++pass) {
    for (int j = 0; j < hi; ++j) {
      const int k0 = j * BK;
      __syncthreads();
      load_tile<T, BK, DP, LD>(Ks, k, p.k_s, k0, p.S, p.D, p.vec);
      load_tile<T, BK, DP, LD>(Vs, v, p.v_s, k0, p.S, p.D, p.vec);
      __syncthreads();
      float s[NS][4], dp[NS][4];
      zero(s);
      zero(dp);
      warp_mma<NS, DP, true>(s, Qs + warp * kRows * LD, LD, Ks, LD);
      warp_mma<NS, DP, true>(dp, dOs + warp * kRows * LD, LD, Vs, LD);
      const unsigned keep =
          p.dropout ? keep_rows_q<NS>(p.thresh, st, q0 + warp * kRows + g, k0)
                    : ~0u;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? r_lo : r_hi;
          const bool in = col < p.S && (!p.causal || row >= col);
          const float pv =
              in ? __expf(s[n][e] * p.scale - (e < 2 ? lse_lo : lse_hi))
                 : 0.f;
          const float z = (keep >> (n * 4 + e)) & 1u ? p.keep_scale : 0.f;
          if (pass == 0) {
            if (e < 2) dl_lo += pv * z * dp[n][e];
            else dl_hi += pv * z * dp[n][e];
          } else {
            const float ds =
                pv * (dp[n][e] * z - (e < 2 ? dl_lo : dl_hi)) * p.scale;
            dSs[(g + (e < 2 ? 0 : 8)) * LDP + n * 8 + 2 * t + (e & 1)] =
                from_f<T>(ds);
          }
        }
      if (pass == 1) {
        __syncwarp();
        warp_mma<NO, BK, false>(acc, dSs, LDP, Ks, LD);
        __syncwarp();
      }
    }
    if (pass == 0) {
      dl_lo = quad_sum(dl_lo);
      dl_hi = quad_sum(dl_hi);
      if (t == 0) {
        float* delta = p.delta + static_cast<size_t>(bh) * p.S;
        if (r_lo < p.S) delta[r_lo] = dl_lo;
        if (r_hi < p.S) delta[r_hi] = dl_hi;
      }
    }
  }
  store_rows<T, NO>(static_cast<T*>(p.out0), acc, b, h, r_lo, 0, p.S, p.H,
                    p.D, 1.f, 1.f);
}

// --- backward: dK, dV ----------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) sa_dkv(const Params p) {
  using C = DkvCfg<T, DP>;
  constexpr int BQ = C::BQ, LD = C::LD, LDT = C::LDT;
  constexpr int NC = C::DO / 8, NQ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kBlock * LD;
  T* Qs = Vs + kBlock * LD;
  T* dOs = Qs + BQ * LD;
  T* Ts = dOs + BQ * LD;                   // per warp: (P o Z)^T, then dS^T
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
  const float* lse = p.lse + static_cast<size_t>(bh) * p.S;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.S;
  const Stream st = stream_of(p, b, h);

  load_tile<T, kBlock, DP, LD>(Ks, k, p.k_s, k0, p.S, p.D, p.vec);
  load_tile<T, kBlock, DP, LD>(Vs, v, p.v_s, k0, p.S, p.D, p.vec);
  const int kr_lo = k0 + warp * kRows + g, kr_hi = kr_lo + 8;
  float dk[NC][4], dv[NC][4];
  zero(dk);
  zero(dv);
  const int n_q = (p.S + BQ - 1) / BQ;
  for (int i = p.causal ? k0 / BQ : 0; i < n_q; ++i) {
    const int qi0 = i * BQ;
    __syncthreads();
    load_tile<T, BQ, DP, LD>(Qs, q, p.q_s, qi0, p.S, p.D, p.vec);
    load_tile<T, BQ, DP, LD>(dOs, dout, p.d_s, qi0, p.S, p.D, p.vec);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = qi0 + r < p.S;
      lse_s[r] = in ? lse[qi0 + r] : 0.f;
      dl_s[r] = in ? delta[qi0 + r] : 0.f;
    }
    __syncthreads();
    // S^T[key][q] = K[key] . Q[q]; P^T = exp(S^T - lse[q]), masked to 0
    float pt[NQ][4];
    zero(pt);
    warp_mma<NQ, DP, true>(pt, Ks + warp * kRows * LD, LD, Qs, LD);
    const unsigned keep =
        p.dropout ? keep_rows_k<NQ>(p.thresh, st, kr_lo, qi0) : ~0u;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1), qc = qi0 + ql;
        const int kr = e < 2 ? kr_lo : kr_hi;
        const bool in = qc < p.S && kr < p.S && (!p.causal || qc >= kr);
        pt[n][e] = in ? __expf(pt[n][e] * p.scale - lse_s[ql]) : 0.f;
        const float z = (keep >> (n * 4 + e)) & 1u ? p.keep_scale : 0.f;
        Ts[(g + (e < 2 ? 0 : 8)) * LDT + ql] = from_f<T>(pt[n][e] * z);
      }
    __syncwarp();
    warp_mma<NC, BQ, false>(dv, Ts, LDT, dOs + c0, LD);
    // dP^T[key][q] = V[key] . dO[q]; dS^T = P^T (dP^T Z - D[q]) * scale
    float dpt[NQ][4];
    zero(dpt);
    warp_mma<NQ, DP, true>(dpt, Vs + warp * kRows * LD, LD, dOs, LD);
    __syncwarp();                          // (P o Z)^T is read: overwrite it
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1);
        const float z = (keep >> (n * 4 + e)) & 1u ? p.keep_scale : 0.f;
        const float ds = pt[n][e] * (dpt[n][e] * z - dl_s[ql]) * p.scale;
        Ts[(g + (e < 2 ? 0 : 8)) * LDT + ql] = from_f<T>(ds);
      }
    __syncwarp();
    warp_mma<NC, BQ, false>(dk, Ts, LDT, Qs + c0, LD);
  }
  store_rows<T, NC>(static_cast<T*>(p.out0), dk, b, h, kr_lo, c0, p.S, p.H,
                    p.D, 1.f, 1.f);
  store_rows<T, NC>(static_cast<T*>(p.out1), dv, b, h, kr_lo, c0, p.S, p.H,
                    p.D, 1.f, 1.f);
}

// --- launch --------------------------------------------------------------------
enum Kind {
  kFwd = 0, kDq = 1, kDkv = 2,              // the mma.sync bodies
  kFwdSm90 = 3, kDqSm90 = 4, kDkvSm90 = 5,  // the Hopper bodies
  kBwd = 6, kBwdSm90 = 7                    // dQ then dK/dV, one call
};

template <typename T, int DP>
int launch(int kind, int BH, const Params& p, cudaStream_t s) {
  const int nblk = (p.S + kBlock - 1) / kBlock;
  switch (kind) {
    case kFwd:
      return launch_with_smem(sa_fwd<T, DP>, dim3(BH, nblk),
                              FwdCfg<T, DP>::smem, p, s);
    case kDq:
      return launch_with_smem(sa_dq<T, DP>, dim3(BH, nblk),
                              DqCfg<T, DP>::smem, p, s);
    case kDkv:
      return launch_with_smem(sa_dkv<T, DP>,
                              dim3(BH, nblk, DP / DkvCfg<T, DP>::DO),
                              DkvCfg<T, DP>::smem, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_d(int kind, int BH, const Params& p, cudaStream_t s) {
  if (p.D <= 32) return launch<T, 32>(kind, BH, p, s);
  if (p.D <= 64) return launch<T, 64>(kind, BH, p, s);
  if (p.D <= 128) return launch<T, 128>(kind, BH, p, s);
  return launch<T, 256>(kind, BH, p, s);
}

int launch_fwd_hopper(const Params& p, int B, cudaStream_t s) {
  const void* const bases[3] = {p.q, p.k, p.v};
  const long long st[3][3] = {{p.q_b, p.q_s, p.q_h},
                              {p.k_b, p.k_s, p.k_h},
                              {p.v_b, p.v_s, p.v_h}};
  const FwdArgs a{p.out0, p.lse, p.S, p.H, p.D, p.scale, p.causal};
  const PhiloxDropout drop{p.seed, p.keep_scale, p.thresh, p.dropout, 0u,
                           0u};
  return launch_fwd_sm90<sa_fwd_sm90<64>, sa_fwd_sm90<128>>(bases, st, B, a,
                                                            s, drop);
}

int launch_bwd_hopper(int kind, const Params& p, int B, cudaStream_t s) {
  const void* const bases[4] = {p.q, p.k, p.v, p.dout};
  const long long st[4][3] = {{p.q_b, p.q_s, p.q_h},
                              {p.k_b, p.k_s, p.k_h},
                              {p.v_b, p.v_s, p.v_h},
                              {p.d_b, p.d_s, p.d_h}};
  const BwdArgs a{p.lse, p.delta, p.out0, p.out1, p.S, p.S, p.H, p.D,
                  p.scale, p.causal};
  const PhiloxDropout drop{p.seed, p.keep_scale, p.thresh, p.dropout, 0u,
                           0u};
  if (kind == kDkvSm90)
    return launch_bwd_sm90<sa_dkv_sm90<64>, sa_dkv_sm90<128>, true, false>(
        bases, st, B, a, s, drop);
  return launch_bwd_sm90<sa_dq_sm90<64>, sa_dq_sm90<128>, false, true>(
      bases, st, B, a, s, drop);
}

// One launch of `kind` (0-5: the entry's kinds 0 and 3, and the two
// launches of its backward kinds 6 and 7) on checked sizes.
int run(int kind, const Params& p, int B, int dtype, cudaStream_t s) {
  int err;
  if (kind >= kFwdSm90) {
    // what the Hopper bodies admit; asked for anything else, the entry
    // refuses rather than run another body (the backward's row-term sweep
    // keeps a keep word a block: S <= 512)
    if (kind > kDkvSm90 || dtype != kBF16 || !p.vec || p.D <= 32 ||
        p.D > 128 || p.D % 8 != 0 || !(p.scale > 0.f) ||
        (kind != kFwdSm90 && p.S > 64 * BwdCfg<64, false, true>::kMaxBlocks))
      return static_cast<int>(cudaErrorInvalidValue);
    err = kind == kFwdSm90 ? launch_fwd_hopper(p, B, s)
                           : launch_bwd_hopper(kind, p, B, s);
  } else {
    switch (dtype) {
      case kF32: err = dispatch_d<float>(kind, B * p.H, p, s); break;
      case kBF16: err = dispatch_d<__nv_bfloat16>(kind, B * p.H, p, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 forward (q, k, v -> out0 = O, lse), 3 the same on the Hopper
// body, 6 the backward (q, k, v, dout, lse -> delta, then out0 = [3, B, S,
// H, D]: dQ, dK, dV): the row term and dQ (`run`'s kind 1), then dK and dV
// from delta (kind 2), 7 the same on the Hopper bodies (kinds 4 and 5).
// The Hopper kinds take bf16, 32 < D <= 128, TMA-describable strides, and
// S <= 512 for 7; the entry refuses anything else, kinds 1, 2, 4 and 5
// included. dims = {B, S, H, D, then the (b, s, h) element strides of q,
// k, v and dout} (dout's are 0 for a forward): q, k, v, dout are
// [B, S, H, D] with a unit stride along D;
// outputs are contiguous [B, S, H, D]; lse / delta are [B*H, S] f32; seed
// is one int64 on the device, read only when dropout is set. The sizes
// travel packed, as one pointer, because a call's host time is part of
// its cost.
extern "C" int ptt_short_attention(
    int kind, const void* q, const void* k, const void* v, const void* dout,
    const void* seed, void* lse, void* delta, void* out0, void* out1,
    const long long* dims, int dtype, float scale, float keep_scale,
    unsigned thresh, int dropout, int causal, void* stream) {
  const int B = static_cast<int>(dims[0]), S = static_cast<int>(dims[1]);
  const int H = static_cast<int>(dims[2]), D = static_cast<int>(dims[3]);
  const long long* st = dims + 4;
  if (D < 1 || D > 256 || S < 1 || B * H < 1 || (dropout && !seed) ||
      (kind != kFwd && kind != kFwdSm90 && kind != kBwd && kind != kBwdSm90))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,     k,     v,     dout,  static_cast<const long long*>(seed),
           static_cast<float*>(lse), static_cast<float*>(delta), out0,
           out1,  S,     H,     D,     st[0], st[1], st[2], st[3], st[4],
           st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
           keep_scale, thresh, dropout, causal, 0};
  const int ch = dtype == kF32 ? 4 : 8;    // elements per 16-byte load
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  for (int i = 0; i < 12; ++i) vec = vec && st[i] % ch == 0;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < kBwd) return run(kind, p, B, dtype, s);
  // dQ (which stores the row term), then dK/dV (which reads it)
  const size_t n = static_cast<size_t>(B) * S * H * D *
                   (dtype == kF32 ? 4 : 2);
  uint8_t* grads = static_cast<uint8_t*>(out0);
  const int dq = kind == kBwd ? kDq : kDqSm90;
  if (const int err = run(dq, p, B, dtype, s)) return err;
  p.out0 = grads + n;
  p.out1 = grads + 2 * n;
  return run(dq + 1, p, B, dtype, s);
}
