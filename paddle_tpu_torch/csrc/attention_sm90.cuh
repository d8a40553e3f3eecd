// The Hopper (sm_90a) attention forward shared by flash_attention.cu
// (`flash_fwd_sm90`, no dropout) and short_attention.cu (`sa_fwd_sm90`,
// attention-probability dropout drawn inside), with the pieces the
// backward bodies of flash_attention.cu reuse: the persistent grid's work
// list (`Units`), ex2, and the P -> bf16 A-fragment packing.
//
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
// one CTA an SM.
//
// The dropout policy (template parameter DROP) draws a block's keep bits
// on the integer pipe just before its S product is issued: they depend
// only on (b, h, row, column), and the other warpgroups' products run
// meanwhile. (Drawing them while this warpgroup's own S wgmma was in
// flight kept its 32 accumulators live across the draw: at D = 64, two
// CTAs an SM and 96 registers a thread, ptxas spilled 148 bytes instead
// of 52, and it ran slower on an H100; PERF.md has the A/B.) It leaves
// the row sum l alone (l sums every probability) and, when on, sets a
// dropped probability to 0 and scales a kept one by 1 / (1 - p) before
// the bf16 pack, in the P that meets V only. lse stays natural-log and
// unmasked.
// A policy provides:
//   kOn                     whether it can drop at all (compile time);
//   init()                  per-kernel set-up (reads the seed);
//   on()                    whether this launch drops;
//   draw<BK>(bits, b, h, row_lo, k0)
//                           keep bits of this thread's entries of the
//                           block: word w, bit 4n + e for the entry
//                           s[32w + 4n + e] (row row_lo + 8 (e >= 2),
//                           column k0 + 64w + 8n + 2t + (e & 1));
//   keep_scale()            1 / (1 - p).
#pragma once

#include <algorithm>
#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace ptt {
namespace attn90 {

using namespace ptt::sm90;
using ptt::attn::kNegInf;
using ptt::attn::quad_max;
using ptt::attn::quad_sum;

// what the forward body reads besides its tensor maps: O, lse [B*H, S]
// f32, S (queries and keys), heads, head dim, softmax scale, causal
struct FwdArgs {
  void* out;
  float* lse;
  int S, H, D;
  float scale;
  int causal;
};

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

// The work of a persistent grid: units of one or two 128-row tiles of one
// head, handed out statically (unit u to CTA u % grid). Under the causal
// mask a tile's work grows (forward, dQ: query tiles) or shrinks (dK/dV:
// key tiles) with its index, so a unit pairs tile n - 1 - i with tile i:
// every unit then holds about the same number of blocks, and a head's
// units run side by side (its streamed operands stay in L2). Without the
// mask a unit is one tile, the longest-running first.
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
                                            float (&c)[2], const FwdArgs& a,
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
        if (!(col < a.S && (!a.causal || row >= col))) {
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

// P (f32, in the m64nBK accumulator layout) -> the bf16 A fragments of a
// product that reduces over those BK columns: 16 columns a k16 slice, n8
// chunks 2kk (a[0], a[1]) and 2kk + 1 (a[2], a[3])
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack2<__nv_bfloat16>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// no dropout (the flash forward)
struct NoDropout {
  static constexpr bool kOn = false;
  __device__ void init() {}
  __device__ bool on() const { return false; }
  template <int BK>
  __device__ void draw(uint32_t (&)[BK / 64], int, int, int, int) const {}
  __device__ float keep_scale() const { return 1.f; }
};

template <int DP, class DROP>
__device__ __forceinline__ void fwd_sm90_body(const CUtensorMap& tq,
                                              const CUtensorMap& tk,
                                              const CUtensorMap& tv,
                                              const FwdArgs& a,
                                              const Units& units, DROP drop) {
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
  const int n_kv = (a.S + BK - 1) / BK;
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
        const int b = bh / a.H, h = bh % a.H;
        for (int i = 0; i < nt; ++i, ++tt) {
          const int q0 = qts[i] * C::ROWS;
          const int hi = a.causal
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
  drop.init();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)
  int jj = 0, tt = 0;
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int bh, qts[2];
    const int nt = units.tiles(u, bh, qts);
    const int b = bh / a.H, h = bh % a.H;
    for (int it = 0; it < nt; ++it, ++tt) {
      const int q0 = qts[it] * C::ROWS;
      const int hi =
          a.causal ? min((q0 + C::ROWS + BK - 1) / BK, n_kv) : n_kv;
      // causal: a block wholly past this warpgroup's last row holds no key
      // it sees (at BK = 64 the last block of warpgroup 0): taken in its
      // turn (waited for, so each release lands in its own phase) and
      // released unread
      // and a warpgroup whose rows all lie past S (a ragged last tile)
      // computes nothing
      const int hi_wg =
          q0 + wg * 64 >= a.S
              ? 0
              : a.causal ? min((q0 + wg * 64 + 64 + BK - 1) / BK, hi) : hi;
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
        // the keep bits of the block (see the note above)
        [[maybe_unused]] uint32_t keep[BK / 64];
        if constexpr (DROP::kOn)
          if (drop.on()) drop.template draw<BK>(keep, b, h, row_lo, j * BK);
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
        // formed here, not before the S batch: one more register live
        // across it cost the D = 128 body (at its 168-register cap) 5 %
        const int k0 = j * BK;
        uint32_t pa[BK / 16][4];
        float c[2];
        if (k0 + BK > a.S || (a.causal && k0 + BK - 1 > q0 + wg * 64))
          hop_softmax<BK, true>(sc, m, l, c, a, k0, row_lo, sl2);
        else
          hop_softmax<BK, false>(sc, m, l, c, a, k0, row_lo, sl2);
        if constexpr (DROP::kOn) {
          // l keeps every probability; only kept ones, times 1 / (1 - p),
          // meet V (scaled before the cast, as the TPU kernel casts
          // probs * mask)
          if (drop.on()) {
            const float ks = drop.keep_scale();
#pragma unroll
            for (int i = 0; i < BK / 2; ++i)
              sc[i] = (keep[i >> 5] >> (i & 31)) & 1u ? sc[i] * ks : 0.f;
          }
        }
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
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_lo + 8 * hh;
        if (r >= a.S) continue;
        __nv_bfloat16* orow =
            out + ((static_cast<size_t>(b) * a.S + r) * a.H + h) * a.D;
#pragma unroll
        for (int sub = 0; sub < C::NSUB; ++sub)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int col = sub * 64 + 8 * i + 2 * t;   // D % 8 == 0: pairs
            if (col < a.D)
              *reinterpret_cast<uint32_t*>(orow + col) =
                  pack2<__nv_bfloat16>(o[sub][4 * i + 2 * hh] / lq[hh],
                                       o[sub][4 * i + 2 * hh + 1] / lq[hh]);
          }
        if (t == 0)
          a.lse[static_cast<size_t>(bh) * a.S + r] =
              m[hh] * 0.6931471805599453f + logf(lq[hh]);
      }
    }
  }
}

// --- host --------------------------------------------------------------------------
// A 4-D bf16 tensor map (D, H, S, B) over a [B, S, H, D] tensor's element
// strides (b, s, h; unit stride along D), boxes of [rows][64 columns] with
// the 128-byte swizzle.
inline bool attn_tmap(CUtensorMap* map, const void* base, int B, int S,
                      int H, int D, long long sb, long long ss, long long sh,
                      uint32_t rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t st[3] = {static_cast<uint64_t>(sh) * 2,
                          static_cast<uint64_t>(ss) * 2,
                          static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {64, 1, rows, 1};
  return make_tmap<4>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, st,
                      box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launches the forward kernel K64 (D <= 64) or K128 (64 < D <= 128) on
// q, k, v ([B, S, H, D] bf16, element strides {b, s, h} each) with the
// kernel's trailing arguments `extra` (its dropout policy).
template <auto K64, auto K128, class... EXTRA>
int launch_fwd_sm90(const void* const (&bases)[3],
                    const long long (&strides)[3][3], int B,
                    const FwdArgs& a, cudaStream_t s, const EXTRA&... extra) {
  CUtensorMap maps[3];
  const bool d64 = a.D <= 64;
  // Q boxes of a tile's rows, K and V of one block of keys
  const uint32_t rows = d64 ? HopCfg<64>::ROWS : HopCfg<128>::ROWS;
  const uint32_t bk = d64 ? HopCfg<64>::BK : HopCfg<128>::BK;
  for (int i = 0; i < 3; ++i)
    if (!attn_tmap(&maps[i], bases[i], B, a.S, a.H, a.D, strides[i][0],
                   strides[i][1], strides[i][2], i == 0 ? rows : bk))
      return static_cast<int>(cudaErrorInvalidValue);
  const Units units((a.S + rows - 1) / rows, B * a.H, a.causal != 0);
  const int ctas = d64 ? HopCfg<64>::CTAS : HopCfg<128>::CTAS;
  const dim3 grid(std::min(units.count, ctas * sm_count()));
  auto run = [&](auto kernel, auto dp) {
    constexpr int DP = decltype(dp)::value;
    constexpr auto K = decltype(kernel)::value;
    constexpr size_t smem = HopCfg<DP>::smem;
    if (const int e = smem_opt_in<K>(smem)) return e;
    K<<<grid, HopCfg<DP>::THREADS, smem, s>>>(maps[0], maps[1], maps[2], a,
                                              units, extra...);
    return 0;
  };
  return d64 ? run(std::integral_constant<decltype(K64), K64>(),
                   std::integral_constant<int, 64>())
             : run(std::integral_constant<decltype(K128), K128>(),
                   std::integral_constant<int, 128>());
}

}  // namespace attn90
}  // namespace ptt
