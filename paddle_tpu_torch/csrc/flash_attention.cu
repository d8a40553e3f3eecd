// FlashAttention-2 forward and backward on [B, S, H, D] tensors.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (the
// forward, reached through `_fwd`), `_dq_kernel` and `_dkv_kernel` (the
// backward, reached through `_bwd`).
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
// Simple first: loads are synchronous (no cp.async/TMA pipeline) and the
// products are mma.sync, not wgmma.
#include <math.h>

#include <initializer_list>

#include "attention_tiles.cuh"

namespace {

using namespace ptt;
using namespace ptt::attn;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B*H, S] (backward input)
  const float* delta;   // [B*H, S]
  void* out0;           // forward: O; dq kernel: dQ; dkv kernel: dK
  void* out1;           // dkv kernel: dV
  float* lse_out;       // forward: [B*H, S]
  int S, H, D;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, d_b, d_s, d_h;
  float scale;
  int causal;
  int vec;              // 16-byte loads allowed (alignment and strides)
};

// --- forward -----------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
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
    unsigned ok = 0;
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r_lo : r_hi;
        const bool keep = col < p.S && (!p.causal || row >= col);
        ok |= static_cast<unsigned>(keep) << (n * 4 + e);
        s[n][e] = keep ? s[n][e] * p.scale : kNegInf;
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
  store_rows<T, NO>(static_cast<T*>(p.out0), acc, b, h, r_lo, 0, p.S, p.H,
                    p.D, l_lo, l_hi);
  if (t == 0) {
    float* lse = p.lse_out + static_cast<size_t>(bh) * p.S;
    if (r_lo < p.S) lse[r_lo] = m_lo + logf(l_lo);
    if (r_hi < p.S) lse[r_hi] = m_hi + logf(l_hi);
  }
}

// --- backward: dQ -------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_dq(const Params p) {
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

  load_tile<T, kBlock, DP, LD>(Qs, q, p.q_s, q0, p.S, p.D, p.vec);
  load_tile<T, kBlock, DP, LD>(dOs, dout, p.d_s, q0, p.S, p.D, p.vec);
  const int r_lo = q0 + warp * kRows + g, r_hi = r_lo + 8;
  const float* lse = p.lse + static_cast<size_t>(bh) * p.S;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.S;
  const float lse_lo = r_lo < p.S ? lse[r_lo] : 0.f;
  const float lse_hi = r_hi < p.S ? lse[r_hi] : 0.f;
  const float dl_lo = r_lo < p.S ? delta[r_lo] : 0.f;
  const float dl_hi = r_hi < p.S ? delta[r_hi] : 0.f;
  float acc[NO][4];
  zero(acc);
  const int n_kv = (p.S + BK - 1) / BK;
  const int hi = p.causal ? min((q0 + kBlock + BK - 1) / BK, n_kv) : n_kv;
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
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r_lo : r_hi;
        const bool keep = col < p.S && (!p.causal || row >= col);
        const float pv =
            keep ? __expf(s[n][e] * p.scale - (e < 2 ? lse_lo : lse_hi))
                 : 0.f;
        const float ds = pv * (dp[n][e] - (e < 2 ? dl_lo : dl_hi)) * p.scale;
        dSs[(g + (e < 2 ? 0 : 8)) * LDP + n * 8 + 2 * t + (e & 1)] =
            from_f<T>(ds);
      }
    __syncwarp();
    warp_mma<NO, BK, false>(acc, dSs, LDP, Ks, LD);
    __syncwarp();
  }
  store_rows<T, NO>(static_cast<T*>(p.out0), acc, b, h, r_lo, 0, p.S, p.H,
                    p.D, 1.f, 1.f);
}

// --- backward: dK, dV ----------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_dkv(const Params p) {
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
  const float* lse = p.lse + static_cast<size_t>(bh) * p.S;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.S;

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
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1), qc = qi0 + ql;
        const int kr = e < 2 ? kr_lo : kr_hi;
        const bool keep = qc < p.S && kr < p.S && (!p.causal || qc >= kr);
        pt[n][e] = keep ? __expf(pt[n][e] * p.scale - lse_s[ql]) : 0.f;
        Ts[(g + (e < 2 ? 0 : 8)) * LDT + ql] = from_f<T>(pt[n][e]);
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
  store_rows<T, NC>(static_cast<T*>(p.out0), dk, b, h, kr_lo, c0, p.S, p.H,
                    p.D, 1.f, 1.f);
  store_rows<T, NC>(static_cast<T*>(p.out1), dv, b, h, kr_lo, c0, p.S, p.H,
                    p.D, 1.f, 1.f);
}

// --- launch --------------------------------------------------------------------
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int DP>
int launch(int kind, int BH, const Params& p, cudaStream_t s) {
  const int nblk = (p.S + kBlock - 1) / kBlock;
  switch (kind) {
    case kFwd:
      return launch_with_smem(flash_fwd<T, DP>, dim3(BH, nblk),
                              FwdCfg<T, DP>::smem, p, s);
    case kDq:
      return launch_with_smem(flash_dq<T, DP>, dim3(BH, nblk),
                              DqCfg<T, DP>::smem, p, s);
    case kDkv:
      return launch_with_smem(flash_dkv<T, DP>,
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

}  // namespace

// kind: 0 forward (q, k, v -> out0 = O, lse_out), 1 dQ (q, k, v, dout,
// lse, delta -> out0), 2 dK, dV (-> out0, out1). q, k, v, dout are
// [B, S, H, D] with element strides (b, s, h) and a unit stride along D;
// outputs are contiguous [B, S, H, D]; lse / delta are [B*H, S] f32.
extern "C" int ptt_flash_attention(
    int kind, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* out0, void* out1,
    void* lse_out, int B, int S, int H, int D, long long q_b, long long q_s,
    long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long d_b,
    long long d_s, long long d_h, int dtype, float scale, int causal,
    void* stream) {
  if (D < 1 || D > 256 || S < 1 || B * H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,   k,   v,   dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), out0, out1,
           static_cast<float*>(lse_out), S, H, D, q_b, q_s, q_h, k_b, k_s,
           k_h, v_b, v_s, v_h, d_b, d_s, d_h, scale, causal, 0};
  const int ch = dtype == kF32 ? 4 : 8;    // elements per 16-byte load
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  for (long long st : {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, d_b, d_s,
                       d_h})
    vec = vec && st % ch == 0;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case kF32: err = dispatch_d<float>(kind, B * H, p, s); break;
    case kBF16: err = dispatch_d<__nv_bfloat16>(kind, B * H, p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
