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
// These bodies load synchronously and multiply with mma.sync. The bf16
// forward at head-dim tiles 64 and 128 (32 < D <= 128, D % 8 == 0, every
// q/k/v stride a multiple of 8 elements, 16-byte aligned bases) has a
// Hopper body of its own, `flash_fwd_sm90` (see its note): the caller asks
// for it as kind 3, and an entry asked for a kind its inputs do not admit
// returns cudaErrorInvalidValue. f32 inputs, head-dim tiles 32 and 256 and
// the ring-step forward keep `fwd_body` (kind 0).
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

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace ptt;
using namespace ptt::attn;
using namespace ptt::sm90;

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

// --- forward on Hopper: TMA-fed wgmma, P in registers (bf16, D tiles 64/128) ---
// A persistent CTA per multiprocessor walks a static list of query tiles.
// Consumer warpgroups own 64 query rows each; a producer keeps Q (double-
// buffered, so the next tile's Q lands while this one finishes) and a ring
// of K and V blocks loaded by TMA through 4-D tensor maps over the
// caller's [B, S, H, D] strides (rows past S and columns past D load as
// zeros), K and V on barriers of their own so S = QK^T starts before V
// lands. A warpgroup computes S by wgmma from shared memory (A = its 64 Q
// rows, B = the K block, K-major, 128-byte swizzle), runs the online
// softmax on the accumulator layout in f32 registers (log2 domain, masked
// entries selected to 0 after the exp), casts P to bf16 in registers and
// feeds it to the P.V wgmma as its register A operand, with V from shared
// memory MN-major (the descriptor's transpose bit). P never touches
// shared memory. A head's tiles run side by side, so its K and V come
// from device memory once.
// Two consumer warpgroups (128 query rows a tile). D = 64: blocks of 64
// keys and a producer warp, about 90 registers a thread, two CTAs an SM
// (four warpgroups hide each other's loads and softmax); D = 128: blocks
// of 128 keys and a producer warpgroup (one thread issues the loads) that
// hands its registers to the consumers (232 each: S, P and O take 160),
// one CTA an SM. Persistent CTAs (their number a multiple of the SMs); Q
// is double-buffered so the next tile's Q lands while this one finishes.
template <int DP>
struct HopCfg {
  static constexpr int NSUB = DP / 64;          // 64-column sub-tiles
  static constexpr int NWG = 2;                 // consumer warpgroups
  static constexpr int ROWS = 64 * NWG;         // query rows a tile
  static constexpr int BK = DP == 64 ? 64 : 128;  // keys per block
  static constexpr int STAGES = DP == 64 ? 4 : 2; // K/V ring depth
  static constexpr int CTAS = DP == 64 ? 2 : 1;   // per multiprocessor
  static constexpr int THREADS = DP == 64 ? 128 * NWG + 32 : 128 * NWG + 128;
  static constexpr int kQSub = ROWS * 128;      // one [ROWS][64] Q sub-tile
  static constexpr int kQ = NSUB * kQSub;       // one Q buffer
  static constexpr int kSub = BK * 128;         // one [BK][64] sub-tile
  static constexpr int kKV = NSUB * kSub;       // one K or V block
  static constexpr size_t smem = 1024 + 2 * kQ + 2 * STAGES * kKV +
                                 (4 + 4 * STAGES) * sizeof(uint64_t);
};

// The work of the persistent grid: units of one or two query tiles of one
// head, handed out statically (unit u to CTA u % grid). Causal rows see
// more keys the later they sit, so a unit pairs tile n - 1 - i with tile i:
// every unit then holds about the same number of key blocks, and a head's
// units run side by side (its K and V stay in L2). Without the mask a
// unit is one tile, the longest first.
struct Units {
  int n_qt, per_head, count;
  bool causal;
  __host__ __device__ Units(int nqt, int heads, bool c)
      : n_qt(nqt), per_head(c ? (nqt + 1) / 2 : nqt),
        count(heads * (c ? (nqt + 1) / 2 : nqt)), causal(c) {}
  // unit u -> its head and its tiles (returns 1 or 2)
  __device__ int tiles(int u, int& bh, int (&qt)[2]) const {
    bh = u / per_head;
    const int i = u % per_head;
    qt[0] = n_qt - 1 - i;
    qt[1] = i;
    return causal && qt[1] != qt[0] ? 2 : 1;
  }
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (raw scores of one block of BK keys) -> P in place, with the
// online-softmax update of the rows' max m (log2 domain) and per-lane sum
// l, and the factor c that rescales O: p = 2^(s * sl2 - m), one FFMA and
// one ex2 an entry (sl2 = scale * log2(e) > 0, so the max is taken on the
// raw scores). MASK: the block crosses the causal diagonal or the end of
// the keys; a masked entry is selected to 0 after the exp.
template <int BK, bool MASK>
__device__ __forceinline__ void hop_softmax(float (&s)[BK / 2],
                                            float (&m)[2], float (&l)[2],
                                            float (&c)[2], const Params& p,
                                            int k0, int row_lo, float sl2) {
  constexpr int NC = BK / 8;            // n8 chunks
  const int t = threadIdx.x & 3;
  float mx[2] = {kNegInf, kNegInf};
  uint64_t keep = ~0ull;
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int col = k0 + 8 * i + 2 * t + (e & 1);
        const int row = row_lo + (e < 2 ? 0 : 8);
        if (!(col < p.Sk && (!p.causal || row >= col))) {
          keep &= ~(1ull << (4 * i + e));
          s[4 * i + e] = kNegInf;
        }
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
    }
  float mn[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mn[h] = fmaxf(m[h], quad_max(mx[h]) * sl2);
    c[h] = fast_exp2(m[h] - mn[h]);
    m[h] = mn[h];
  }
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = (!MASK || ((keep >> (4 * i + e)) & 1))
                           ? fast_exp2(fmaf(s[4 * i + e], sl2, -mn[e >> 1]))
                           : 0.f;
      rs[e >> 1] += pv;
      s[4 * i + e] = pv;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * c[h] + rs[h];
}

// P (f32, in the S accumulator layout) -> the bf16 A fragments of P.V:
// 16 keys a k16 slice, n8 chunks 2kk (a[0], a[1]) and 2kk + 1 (a[2], a[3])
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack2<__nv_bfloat16>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int DP>
__global__ void __launch_bounds__(HopCfg<DP>::THREADS, HopCfg<DP>::CTAS)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p,
                   const Units units) {
  using C = HopCfg<DP>;
  constexpr int NS = C::STAGES, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);    // [2] buffers
  uint8_t* Ks = Qs + 2 * C::kQ;
  uint8_t* Vs = Ks + NS * C::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + NS * C::kKV);  // [2]
  uint64_t* q_empty = q_full + 2;       // [2]
  uint64_t* k_full = q_full + 4;        // [NS] each
  uint64_t* v_full = k_full + NS;
  uint64_t* k_empty = v_full + NS;
  uint64_t* v_empty = k_empty + NS;
  const int n_kv = (p.Sk + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], C::NWG);   // one arrival per warpgroup
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], C::NWG);
      mbar_init(&v_empty[s], C::NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * C::NWG) {             // producer
    if constexpr (C::CTAS == 1) regs_dealloc<40>();
    if (warp == 4 * C::NWG && lane == 0) {
      int jj = 0, tt = 0;               // blocks and tiles loaded so far
      for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
        int bh, qts[2];
        const int nt = units.tiles(u, bh, qts);
        const int b = bh / p.H, h = bh % p.H;
        for (int i = 0; i < nt; ++i, ++tt) {
          const int q0 = qts[i] * C::ROWS;
          const int hi = p.causal
                             ? min((q0 + C::ROWS + BK - 1) / BK, n_kv)
                             : n_kv;
          const int qb = tt & 1;
          mbar_wait(&q_empty[qb], ((tt >> 1) & 1) ^ 1);
          mbar_expect_tx(&q_full[qb], C::kQ);
          for (int sub = 0; sub < C::NSUB; ++sub)
            tma_load_4d(Qs + qb * C::kQ + sub * C::kQSub, &tq, &q_full[qb],
                        sub * 64, h, q0, b);
          for (int j = 0; j < hi; ++j, ++jj) {
            const int s = jj % NS;
            const uint32_t free_ph = ((jj / NS) & 1) ^ 1;
            mbar_wait(&k_empty[s], free_ph);
            mbar_expect_tx(&k_full[s], C::kKV);
            for (int sub = 0; sub < C::NSUB; ++sub)
              tma_load_4d(Ks + s * C::kKV + sub * C::kSub, &tk, &k_full[s],
                          sub * 64, h, j * BK, b);
            mbar_wait(&v_empty[s], free_ph);
            mbar_expect_tx(&v_full[s], C::kKV);
            for (int sub = 0; sub < C::NSUB; ++sub)
              tma_load_4d(Vs + s * C::kKV + sub * C::kSub, &tv, &v_full[s],
                          sub * 64, h, j * BK, b);
          }
        }
      }
    }
    return;
  }

  if constexpr (C::CTAS == 1) regs_alloc<232>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  const float sl2 = p.scale * 1.4426950408889634f;   // scale * log2(e)
  int jj = 0, tt = 0;
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int bh, qts[2];
    const int nt = units.tiles(u, bh, qts);
    const int b = bh / p.H, h = bh % p.H;
    for (int it = 0; it < nt; ++it, ++tt) {
      const int q0 = qts[it] * C::ROWS;
      const int hi =
          p.causal ? min((q0 + C::ROWS + BK - 1) / BK, n_kv) : n_kv;
      // causal: a block wholly past this warpgroup's last row holds no key
      // it sees (at BK = 64 the last block of warpgroup 0): taken in its
      // turn (waited for, so each release lands in its own phase) and
      // released unread
      // and a warpgroup whose rows all lie past S (a ragged last tile)
      // computes nothing
      const int hi_wg =
          q0 + wg * 64 >= p.Sq
              ? 0
              : p.causal ? min((q0 + wg * 64 + 64 + BK - 1) / BK, hi) : hi;
      const int row_lo = q0 + wg * 64 + (warp & 3) * 16 + g;
      const uint8_t* Qb = Qs + (tt & 1) * C::kQ;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      float o[C::NSUB][32];
#pragma unroll
      for (int sub = 0; sub < C::NSUB; ++sub)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[sub][i] = 0.f;
      mbar_wait(&q_full[tt & 1], (tt >> 1) & 1);
      __syncwarp();
      for (int j = 0; j < hi; ++j, ++jj) {
        const int s = jj % NS;
        const uint32_t ph = (jj / NS) & 1;
        mbar_wait(&k_full[s], ph);
        __syncwarp();                   // converged for the .aligned wgmma
        if (j >= hi_wg) {
          mbar_wait(&v_full[s], ph);
          // every warp of the warpgroup is past both waits before the
          // leader releases the stage (no wgmma orders them here): a
          // lagging warp would otherwise find the stage refilled and wait
          // on the parity of a phase two ahead
          bar_sync(1 + wg, 128);
          if (leader) {
            mbar_arrive(&k_empty[s]);
            mbar_arrive(&v_empty[s]);
          }
          continue;
        }
        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks)
          wgmma_ss_bf16<BK, 0, 0>(
              sc,
              make_desc(Qb + (ks >> 2) * C::kQSub + wg * 64 * 128 +
                            (ks & 3) * 32,
                        16, 1024, kSW128),
              make_desc(Ks + s * C::kKV + (ks >> 2) * C::kSub +
                            (ks & 3) * 32,
                        16, 1024, kSW128),
              ks > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        if (leader) mbar_arrive(&k_empty[s]);   // K is read
        const int k0 = j * BK;
        uint32_t pa[BK / 16][4];
        float c[2];
        if (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0 + wg * 64))
          hop_softmax<BK, true>(sc, m, l, c, p, k0, row_lo, sl2);
        else
          hop_softmax<BK, false>(sc, m, l, c, p, k0, row_lo, sl2);
        pack_p<BK>(sc, pa);
#pragma unroll
        for (int sub = 0; sub < C::NSUB; ++sub)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[sub][i] *= c[(i >> 1) & 1];
        mbar_wait(&v_full[s], ph);
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) reg_fence(pa[kk]);
#pragma unroll
        for (int sub = 0; sub < C::NSUB; ++sub) reg_fence(o[sub]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int sub = 0; sub < C::NSUB; ++sub)
            // V rows 16kk.. of sub-tile sub: 8-key groups 1024 bytes apart
            // (one 64-column atom: the other offset is unused)
            wgmma_rs_bf16_n64<1>(
                o[sub], pa[kk],
                make_desc(Vs + s * C::kKV + sub * C::kSub + kk * 2048, 1024,
                          1024, kSW128),
                1);
        wgmma_commit();
        // closed before the next S batch: no wgmma is in flight while its
        // accumulators are defined (ptxas serializes the batches otherwise;
        // issuing the next S before this P.V, as FA-3 does, measured
        // slower on the H100: C7518 serialization and spills at D = 64)
        wgmma_wait<0>();
#pragma unroll
        for (int sub = 0; sub < C::NSUB; ++sub) reg_fence(o[sub]);
        if (leader) mbar_arrive(&v_empty[s]);   // V is read
      }
      if (leader) mbar_arrive(&q_empty[tt & 1]);  // Q is read

      float lq[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) lq[hh] = fmaxf(quad_sum(l[hh]), 1e-30f);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_lo + 8 * hh;
        if (r >= p.Sq) continue;
        __nv_bfloat16* orow =
            out + ((static_cast<size_t>(b) * p.Sq + r) * p.H + h) * p.D;
#pragma unroll
        for (int sub = 0; sub < C::NSUB; ++sub)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int col = sub * 64 + 8 * i + 2 * t;   // D % 8 == 0: pairs
            if (col < p.D)
              *reinterpret_cast<uint32_t*>(orow + col) =
                  pack2<__nv_bfloat16>(o[sub][4 * i + 2 * hh] / lq[hh],
                                       o[sub][4 * i + 2 * hh + 1] / lq[hh]);
          }
        if (t == 0)
          p.lse_out[static_cast<size_t>(bh) * p.Sq + r] =
              m[hh] * 0.6931471805599453f + logf(lq[hh]);
      }
    }
  }
}

// q, k, v as 4-D tensor maps (D, H, S, B) over the caller's strides, boxes
// of [128 rows][64 columns] with the 128-byte swizzle
int launch_fwd_sm90(const Params& p, int B, cudaStream_t s) {
  CUtensorMap maps[3];
  const void* bases[3] = {p.q, p.k, p.v};
  const long long strides[3][3] = {{p.q_h, p.q_s, p.q_b},
                                   {p.k_h, p.k_s, p.k_b},
                                   {p.v_h, p.v_s, p.v_b}};
  const uint64_t dims[4] = {static_cast<uint64_t>(p.D),
                            static_cast<uint64_t>(p.H),
                            static_cast<uint64_t>(p.Sq),
                            static_cast<uint64_t>(B)};
  // Q boxes of a CTA's rows, K and V of one block of keys
  const bool d64 = p.D <= 64;
  const uint32_t rows = d64 ? HopCfg<64>::ROWS : HopCfg<128>::ROWS;
  const uint32_t bk = d64 ? HopCfg<64>::BK : HopCfg<128>::BK;
  for (int i = 0; i < 3; ++i) {
    const uint32_t box[4] = {64, 1, i == 0 ? rows : bk, 1};
    const uint64_t st[3] = {static_cast<uint64_t>(strides[i][0]) * 2,
                            static_cast<uint64_t>(strides[i][1]) * 2,
                            static_cast<uint64_t>(strides[i][2]) * 2};
    if (!make_tmap<4>(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bases[i],
                      dims, st, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Units units((p.Sq + rows - 1) / rows, B * p.H, p.causal != 0);
  const int ctas = d64 ? HopCfg<64>::CTAS : HopCfg<128>::CTAS;
  const dim3 grid(std::min(units.count, ctas * sm_count()));
  auto run = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    constexpr size_t smem = HopCfg<DP>::smem;
    if (const int e = smem_opt_in<flash_fwd_sm90<DP>>(smem)) return e;
    flash_fwd_sm90<DP><<<grid, HopCfg<DP>::THREADS, smem, s>>>(
        maps[0], maps[1], maps[2], p, units);
    return 0;
  };
  return d64 ? run(std::integral_constant<int, 64>())
             : run(std::integral_constant<int, 128>());
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

// --- launch --------------------------------------------------------------------
enum Kind { kFwd = 0, kDq = 1, kDkv = 2, kFwdSm90 = 3 };

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
  if (kind == kFwdSm90) {
    if (dtype != kBF16 || pos || !vec || p.D <= 32 || p.D > 128 ||
        p.D % 8 != 0 || !(p.scale > 0.f))
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_fwd_sm90(p, BH / p.H, s);
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
// lse, delta -> out0), 2 dK, dV (-> out0, out1), 3 the forward on the
// Hopper body (bf16, 32 < D <= 128; as kind 0). dims = {B, S, H, D, then
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
