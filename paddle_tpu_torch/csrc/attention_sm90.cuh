// The Hopper (sm_90a) attention bodies shared by flash_attention.cu (no
// dropout: `flash_fwd_sm90`, `flash_dq_sm90`, `flash_dkv_sm90`) and
// short_attention.cu (attention-probability dropout drawn inside:
// `sa_fwd_sm90`, `sa_dq_sm90`, `sa_dkv_sm90`): the forward below, the
// backward's dQ and dK/dV bodies after it (see their note), and what they
// share: the persistent grid's work list (`Units`), ex2, and the P -> bf16
// A-fragment packing.
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
//   draw_t<BN>(bits, b, h, krow_lo, q0)
//                           the same bits in the transposed accumulator
//                           of the dK/dV body (S^T: rows are keys, columns
//                           queries): bit 4n + e of word w for the entry
//                           of key krow_lo + 8 (e >= 2) and query q0 + 64w
//                           + 8n + 2t + (e & 1); the bit of a (b, h, query,
//                           key) is the one draw gives it;
//   keep_scale()            1 / (1 - p).
//
// The mask policy (template parameter MP, after DROP) says what the causal
// mask compares. IndexMask: the rows' and columns' indices, row >= col
// (the whole-sequence bodies). PosMask: one ring step of context
// parallelism (`flash_fwd_pos_sm90`, `flash_dq_pos_sm90`,
// `flash_dkv_pos_sm90`), int32 global positions, q_pos[row] >= k_pos[col],
// always causal (a ring step without the mask runs the IndexMask body
// with causal off), queries and keys of one length. A zigzag shard's
// positions are two runs, and a 128-row tile may straddle both, so no
// index shortcut holds: the producer warp classifies each (tile, block)
// pair from position bounds and streams only the blocks some row of the
// tile sees (max q_pos >= min k_pos), having counted them first, and
// decides per (consumer warpgroup, block) from the bounds of the
// warpgroup's 64 rows and the block's: skip (max q_pos < min k_pos:
// waited for and released unread, as the causal skip), whole (min q_pos
// >= max k_pos: the MASK = false path, no compare) or mask per entry
// with the positions from shared memory (past S: INT_MIN for a query,
// INT_MAX for a key, which no compare passes). It publishes, beside the
// tile's resident operand, the tile's record (that count, every row's
// position) on the resident barrier, and beside each stage the block's
// (its index, the two modes, every position) on the stage's full
// barrier, which then takes one more arrival, after the lanes' stores.
// Consumers read the decisions there and compute none. The pairing of
// `Units` still balances a zigzag shard:
// the own shard's work grows with the tile index as the causal mask's
// does (a diagonal tile pairs with a full one), and the visiting shard's
// tiles see all keys or none by run (a tile that sees nothing pairs with
// one that sees everything). A forward row that sees no key keeps l = 0
// and is written O = 0, lse = -1e30 + log(1e-30) (the TPU kernel's l_safe;
// its m would otherwise be the log2-domain max of masked scores).
// BlockTable: the block-sparse forward (`bs_fwd_sm90`, block_sparse_sm90.cu) on
// contiguous [BH, S, D] tensors, mapped as [B = BH, S, H = 1, D]. Query tile qt
// (128 rows) attends the 128-key blocks its row of the table lists (idx[qt, 0
// .. cnt[qt]), an index outside [0, S / 128) skipped). The work is not a static
// list: the producer warp takes units (head, query tile) from a counter in
// device memory, in the order of a pre-pass (the tiles longest-listed first,
// all heads of a tile together), so the tiles that list every block start first
// and the short ones fill the tail, whichever CTA is free. It reads the tile's
// row of the table while Q's TMA is in flight, publishes the tile's record (the
// stages it will stream, its head and tile) beside the resident Q, as PosMask
// does, and then streams only the listed blocks (two 64-key stages a block at D
// = 64, one at D = 128). With no unit left it publishes a record of -1 stages,
// and the consumers leave. Every key of a listed block is live, so the
// consumers take the MASK = false path and compare nothing; they read the tile
// from the record and decide nothing (a block's index is of no use to them, so
// the stages carry no record). No lse is written: the backward is the plain
// version's. A tile with no listed block streams nothing and writes O = 0 (l =
// 0).
#pragma once

#include <climits>

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

// the mask policies (see the note above)
struct IndexMask {
  static constexpr bool kOn = false;
};
struct PosMask {
  static constexpr bool kOn = true;
  const int* qpos;   // [S] int32 global positions of the queries
  const int* kpos;   // [S] of the keys
};
struct BlockTable {
  static constexpr bool kOn = false;  // no compare: every listed key is live
  const int* idx;    // [nq, max_nb] int32: the key blocks of a query tile
  const int* cnt;    // [nq] how many of a row's entries are listed
  const int* order;  // [nq] the query tiles, longest-listed first
  int* next;         // the units taken so far (the pre-pass zeroes it)
  int max_nb, heads, units;  // units = heads * nq
};
template <class MP>
constexpr bool kTable = std::is_same<MP, BlockTable>::value;

// a tile's record under BlockTable: the stages streamed for it (-1: no
// unit is left), its head and its query tile
struct TableRec {
  int n, bh, qt, pad;
};

// a record the producer publishes under PosMask: a tile's (N = its
// resident rows; n the blocks streamed for it) or a block's (N = its rows;
// n its index, mode[w] what consumer warpgroup w does with it), with the
// rows' positions
template <int N>
struct PosRec {
  int n;
  int mode[2];
  int pos[N];
};

// what a consumer warpgroup does with a block: skip it (no query of its
// rows sees a key of the pair: waited for and released unread), take it
// whole (every query sees every key: the MASK = false path) or mask it
// per entry
enum PosMode { kSkip = 0, kWhole = 1, kMask = 2 };

// the mode of a (query group, key group) pair from their [min, max]
// positions (an empty group: lo = INT_MAX, hi = INT_MIN); ragged: one of
// them runs past S, so it is masked at least
__device__ __forceinline__ int pos_mode(int qlo, int qhi, int klo, int khi,
                                        bool ragged) {
  return qhi < klo ? kSkip : !ragged && qlo >= khi ? kWhole : kMask;
}

// N (64 or 128) positions [start, start + N) of one warp, N / 32 a lane
// (entry lane + 32 i; at or past S `past` stands in), and, once bounds()
// has run, the [min, max] of each 64-entry group's valid ones (an empty
// group: lo = INT_MAX, hi = INT_MIN). load() only issues the loads, so
// that the producer can wait on a barrier while they are in flight.
template <int N>
struct LanePos {
  static constexpr int G = N / 64;
  int v[N / 32];
  int lo[G], hi[G];
  __device__ __forceinline__ void load(const int* pos, int start, int S,
                                       int past) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < N / 32; ++i) {
      const int x = start + lane + 32 * i;
      v[i] = x < S ? pos[x] : past;
    }
  }
  __device__ __forceinline__ void bounds(int start, int S) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      lo[g] = INT_MAX;
      hi[g] = INT_MIN;
    }
#pragma unroll
    for (int i = 0; i < N / 32; ++i)
      if (start + lane + 32 * i < S) {
        lo[i / 2] = min(lo[i / 2], v[i]);
        hi[i / 2] = max(hi[i / 2], v[i]);
      }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      lo[g] = __reduce_min_sync(0xffffffffu, lo[g]);
      hi[g] = __reduce_max_sync(0xffffffffu, hi[g]);
    }
  }
  __device__ __forceinline__ int min_all() const {
    return G == 1 ? lo[0] : min(lo[0], lo[G - 1]);
  }
  __device__ __forceinline__ int max_all() const {
    return G == 1 ? hi[0] : max(hi[0], hi[G - 1]);
  }
  // the positions into `r`, n into r.n (lane 0) and, for a block, the
  // consumer warpgroups' modes
  __device__ __forceinline__ void publish(PosRec<N>& r, int n, int mode0 = 0,
                                          int mode1 = 0) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < N / 32; ++i) r.pos[lane + 32 * i] = v[i];
    if (lane == 0) {
      r.n = n;
      r.mode[0] = mode0;
      r.mode[1] = mode1;
    }
  }
};

// Which of the 32 blocks j0 .. j0 + 31 of N positions each (S in all)
// meet a tile: as keys (KEYS), the blocks holding a position at most
// `bound` (the tile's largest query position); as queries, at least
// `bound` (the tile's smallest key position). Bit l for block j0 + l, the
// same in every lane. One warp reads the positions coalesced, 16 loads in
// flight a lane; the producer counts a tile's blocks and streams them by
// the same masks, so the two agree.
template <int N, bool KEYS>
__device__ __forceinline__ uint32_t meet_mask(const int* pos, int S, int j0,
                                              int bound) {
  const int start = j0 * N, end = min(S, start + 32 * N);
  uint32_t m = 0;
#pragma unroll 16
  for (int x = start + (threadIdx.x & 31); x < end; x += 32) {
    const int v = pos[x];
    if (KEYS ? v <= bound : v >= bound) m |= 1u << ((x - start) / N);
  }
  return __reduce_or_sync(0xffffffffu, m);
}

// the lanes' stores of a record before lane 0's arrival on its barrier
__device__ __forceinline__ void publish_arrive(uint64_t* bar) {
  __threadfence_block();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

template <int DP, bool POS = false, bool TABLE = false>
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
  // PosMask: the [2] tiles' and [STAGES] blocks' records, after the
  // barriers; BlockTable: the [2] tiles' records
  static constexpr int kPos =
      POS     ? 2 * sizeof(PosRec<ROWS>) + STAGES * sizeof(PosRec<BK>)
      : TABLE ? 2 * sizeof(TableRec)
              : 0;
  static constexpr size_t smem = 1024 + 2 * kQ + 2 * STAGES * kKV +
                                 (4 + 4 * STAGES) * sizeof(uint64_t) + kPos;
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
// the keys; a masked entry is selected to 0 after the exp. Under PosMask
// (POS) the compare is qrow[0 or 8] >= kcol[column in the block]: the
// positions of the thread's rows and of the block's keys in shared memory.
template <int BK, bool MASK, bool POS = false>
__device__ __forceinline__ void hop_softmax(float (&s)[BK / 2],
                                            float (&m)[2], float (&l)[2],
                                            float (&c)[2], const FwdArgs& a,
                                            int k0, int row_lo, float sl2,
                                            const int* qrow = nullptr,
                                            const int* kcol = nullptr) {
  constexpr int NC = BK / 8;            // n8 chunks
  const int t = threadIdx.x & 3;
  float mx[2] = {kNegInf, kNegInf};
  uint64_t keep = ~0ull;
  [[maybe_unused]] int qv[2];
  if constexpr (POS && MASK) {
    qv[0] = qrow[0];
    qv[1] = qrow[8];
  }
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (POS && MASK) {
        if (!(qv[e >> 1] >= kcol[8 * i + 2 * t + (e & 1)])) {
          keep &= ~(1ull << (4 * i + e));
          s[4 * i + e] = kNegInf;
        }
      } else if (MASK) {
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

// no dropout (the flash attention bodies)
struct NoDropout {
  static constexpr bool kOn = false;
  __device__ void init() {}
  __device__ bool on() const { return false; }
  template <int BK>
  __device__ void draw(uint32_t (&)[BK / 64], int, int, int, int) const {}
  template <int BN>
  __device__ void draw_t(uint32_t (&)[BN / 64], int, int, int, int) const {}
  __device__ float keep_scale() const { return 1.f; }
};

template <int DP, class DROP, class MP = IndexMask>
__device__ __forceinline__ void fwd_sm90_body(const CUtensorMap& tq,
                                              const CUtensorMap& tk,
                                              const CUtensorMap& tv,
                                              const FwdArgs& a,
                                              const Units& units, DROP drop,
                                              MP mp = {}) {
  constexpr bool TABLE = kTable<MP>;
  using C = HopCfg<DP, MP::kOn, TABLE>;
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
  // PosMask: the [2] tiles' records (beside the Q buffers), then the [NS]
  // blocks' (beside the stages)
  [[maybe_unused]] PosRec<C::ROWS>* tile_recs =
      reinterpret_cast<PosRec<C::ROWS>*>(v_empty + NS);
  [[maybe_unused]] PosRec<BK>* blk_recs =
      reinterpret_cast<PosRec<BK>*>(tile_recs + 2);
  // BlockTable: the [2] tiles' records, beside the Q buffers
  [[maybe_unused]] TableRec* table_recs =
      reinterpret_cast<TableRec*>(v_empty + NS);
  const int n_kv = (a.S + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    // PosMask: Q's and K's full barriers take the record's arrival too
    // (BlockTable: Q's)
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], MP::kOn || TABLE ? 2 : 1);
      mbar_init(&q_empty[i], C::NWG);   // one arrival per warpgroup
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(&k_full[s], MP::kOn ? 2 : 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], C::NWG);
      mbar_init(&v_empty[s], C::NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * C::NWG) {             // producer
    if constexpr (C::CTAS == 1) regs_dealloc<40>();
    if constexpr (TABLE) {
      // the whole warp: lane 0 takes the units and issues the loads, the
      // lanes read the table's row (see the note above)
      if (warp == 4 * C::NWG) {
        constexpr int SPB = 128 / BK;   // stages a listed block streams
        const int nkb = a.S / 128;      // key blocks
        int jj = 0;
        for (int tt = 0;; ++tt) {
          const int qb = tt & 1;
          mbar_wait(&q_empty[qb], ((tt >> 1) & 1) ^ 1);
          int u = 0;
          if (lane == 0) u = atomicAdd(mp.next, 1);
          u = __shfl_sync(0xffffffffu, u, 0);
          if (u >= mp.units) {          // none left: the consumers leave
            if (lane == 0) {
              table_recs[qb].n = -1;
              mbar_arrive(&q_full[qb]);   // in place of Q's bytes
            }
            publish_arrive(&q_full[qb]);
            break;
          }
          const int qt = mp.order[u / mp.heads], bh = u % mp.heads;
          if (lane == 0) {
            mbar_expect_tx(&q_full[qb], C::kQ);
            for (int sub = 0; sub < C::NSUB; ++sub)
              tma_load_4d(Qs + qb * C::kQ + sub * C::kQSub, &tq,
                          &q_full[qb], sub * 64, 0, qt * C::ROWS, bh);
          }
          // the row's entries in range, counted while Q is in flight
          const int cnt = min(max(mp.cnt[qt], 0), mp.max_nb);
          const int* row = mp.idx + static_cast<size_t>(qt) * mp.max_nb;
          int n = 0;
          for (int c0 = 0; c0 < cnt; c0 += 32) {
            const int blk = c0 + lane < cnt ? row[c0 + lane] : -1;
            n += __popc(__ballot_sync(0xffffffffu, blk >= 0 && blk < nkb));
          }
          if (lane == 0) {
            table_recs[qb].n = n * SPB;
            table_recs[qb].bh = bh;
            table_recs[qb].qt = qt;
          }
          publish_arrive(&q_full[qb]);
          for (int c0 = 0; c0 < cnt; c0 += 32) {
            const int blk = c0 + lane < cnt ? row[c0 + lane] : -1;
            for (uint32_t mk = __ballot_sync(0xffffffffu,
                                             blk >= 0 && blk < nkb);
                 mk; mk &= mk - 1) {
              const int j = __shfl_sync(0xffffffffu, blk, __ffs(mk) - 1);
              for (int hb = 0; hb < SPB; ++hb, ++jj) {
                const int s = jj % NS;
                const uint32_t free_ph = ((jj / NS) & 1) ^ 1;
                const int k0 = j * 128 + hb * BK;
                mbar_wait(&k_empty[s], free_ph);
                if (lane == 0) {
                  mbar_expect_tx(&k_full[s], C::kKV);
                  for (int sub = 0; sub < C::NSUB; ++sub)
                    tma_load_4d(Ks + s * C::kKV + sub * C::kSub, &tk,
                                &k_full[s], sub * 64, 0, k0, bh);
                }
                mbar_wait(&v_empty[s], free_ph);
                if (lane == 0) {
                  mbar_expect_tx(&v_full[s], C::kKV);
                  for (int sub = 0; sub < C::NSUB; ++sub)
                    tma_load_4d(Vs + s * C::kKV + sub * C::kSub, &tv,
                                &v_full[s], sub * 64, 0, k0, bh);
                }
              }
            }
          }
        }
      }
    } else if constexpr (MP::kOn) {
      // the whole warp: lane 0 issues the loads, the lanes classify and
      // publish (see the note above)
      if (warp == 4 * C::NWG) {
        int jj = 0, tt = 0;
        for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
          int bh, qts[2];
          const int nt = units.tiles(u, bh, qts);
          const int b = bh / a.H, h = bh % a.H;
          for (int i = 0; i < nt; ++i, ++tt) {
            const int q0 = qts[i] * C::ROWS;
            const int qb = tt & 1;
            mbar_wait(&q_empty[qb], ((tt >> 1) & 1) ^ 1);
            if (lane == 0) {
              mbar_expect_tx(&q_full[qb], C::kQ);
              for (int sub = 0; sub < C::NSUB; ++sub)
                tma_load_4d(Qs + qb * C::kQ + sub * C::kQSub, &tq,
                            &q_full[qb], sub * 64, h, q0, b);
            }
            LanePos<C::ROWS> qp;
            qp.load(mp.qpos, q0, a.S, INT_MIN);
            qp.bounds(q0, a.S);
            const int q_hi = qp.max_all();
            int n = 0;                  // blocks some row of the tile sees
            for (int j0 = 0; j0 < n_kv; j0 += 32)
              n += __popc(meet_mask<BK, true>(mp.kpos, a.S, j0, q_hi));
            qp.publish(tile_recs[qb], n);
            publish_arrive(&q_full[qb]);
            const int qlo[2] = {qp.lo[0], qp.lo[1]};
            const int qhi[2] = {qp.hi[0], qp.hi[1]};
            for (int j0 = 0; j0 < n_kv; j0 += 32)
              for (uint32_t mk = meet_mask<BK, true>(mp.kpos, a.S, j0, q_hi);
                   mk; mk &= mk - 1, ++jj) {
                const int j = j0 + __ffs(mk) - 1;
                LanePos<BK> kp;
                kp.load(mp.kpos, j * BK, a.S, INT_MAX);
                const int s = jj % NS;
                const uint32_t free_ph = ((jj / NS) & 1) ^ 1;
                mbar_wait(&k_empty[s], free_ph);
                if (lane == 0) {
                  mbar_expect_tx(&k_full[s], C::kKV);
                  for (int sub = 0; sub < C::NSUB; ++sub)
                    tma_load_4d(Ks + s * C::kKV + sub * C::kSub, &tk,
                                &k_full[s], sub * 64, h, j * BK, b);
                }
                mbar_wait(&v_empty[s], free_ph);
                if (lane == 0) {
                  mbar_expect_tx(&v_full[s], C::kKV);
                  for (int sub = 0; sub < C::NSUB; ++sub)
                    tma_load_4d(Vs + s * C::kKV + sub * C::kSub, &tv,
                                &v_full[s], sub * 64, h, j * BK, b);
                }
                // the record after V's release: its last reader, the
                // softmax, is done with the stage's previous block
                kp.bounds(j * BK, a.S);
                const int klo = kp.min_all(), khi = kp.max_all();
                const bool ragged = (j + 1) * BK > a.S;
                kp.publish(blk_recs[s], j,
                           pos_mode(qlo[0], qhi[0], klo, khi, ragged),
                           pos_mode(qlo[1], qhi[1], klo, khi, ragged));
                publish_arrive(&k_full[s]);
              }
          }
        }
      }
    } else if (warp == 4 * C::NWG && lane == 0) {
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
  // BlockTable: until the producer's record says no tile is left
  for (int u = blockIdx.x; TABLE || u < units.count; u += gridDim.x) {
    int bh, qts[2];
    const int nt = units.tiles(u, bh, qts);
    int b = bh / a.H, h = bh % a.H;
    for (int it = 0; it < nt; ++it, ++tt) {
      int q0 = qts[it] * C::ROWS;
      [[maybe_unused]] int n_tab = 0;
      if constexpr (TABLE) {
        // the tile from its record
        mbar_wait(&q_full[tt & 1], (tt >> 1) & 1);
        const TableRec& rec = table_recs[tt & 1];
        n_tab = rec.n;
        if (n_tab < 0) return;
        b = rec.bh;
        h = 0;
        q0 = rec.qt * C::ROWS;
      }
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
      if constexpr (!TABLE) mbar_wait(&q_full[tt & 1], (tt >> 1) & 1);
      __syncwarp();
      // PosMask: the blocks streamed for the tile, from its record
      // (BlockTable: the stages)
      int nblk = hi;
      [[maybe_unused]] const PosRec<C::ROWS>* tr = tile_recs + (tt & 1);
      if constexpr (MP::kOn) nblk = tr->n;
      if constexpr (TABLE) nblk = n_tab;
      for (int x = 0; x < nblk; ++x, ++jj) {
        const int s = jj % NS;
        const uint32_t ph = (jj / NS) & 1;
        mbar_wait(&k_full[s], ph);
        __syncwarp();                   // converged for the .aligned wgmma
        // the block and whether this warpgroup skips it (PosMask: no row
        // of it sees a key of the block)
        int j = x;
        bool skip = !TABLE && x >= hi_wg;
        // (the mode is read again where it is used: a register held across
        // the S batch costs the D = 128 body, at its register cap)
        [[maybe_unused]] const PosRec<BK>* br = blk_recs + s;
        if constexpr (MP::kOn) {
          j = br->n;
          skip = br->mode[wg] == kSkip;
        }
        if (skip) {
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
        if constexpr (TABLE) {
          hop_softmax<BK, false>(sc, m, l, c, a, k0, row_lo, sl2);
        } else if constexpr (MP::kOn) {
          if (br->mode[wg] == kMask)
            hop_softmax<BK, true, true>(sc, m, l, c, a, k0, row_lo, sl2,
                                        tr->pos + (row_lo - q0), br->pos);
          else
            hop_softmax<BK, false>(sc, m, l, c, a, k0, row_lo, sl2);
        } else if (k0 + BK > a.S ||
                   (a.causal && k0 + BK - 1 > q0 + wg * 64)) {
          hop_softmax<BK, true>(sc, m, l, c, a, k0, row_lo, sl2);
        } else {
          hop_softmax<BK, false>(sc, m, l, c, a, k0, row_lo, sl2);
        }
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
        if (!TABLE && t == 0) {
          float lse = m[hh] * 0.6931471805599453f + logf(lq[hh]);
          // PosMask: a row that saw no key (l = 0; l >= 1 otherwise)
          if constexpr (MP::kOn)
            if (lq[hh] == 1e-30f) lse = kNegInf + logf(1e-30f);
          a.lse[static_cast<size_t>(bh) * a.S + r] = lse;
        }
      }
    }
  }
}

// --- backward: TMA-fed wgmma, dS and P^T in registers -----------------------
// Two kernels: each output has one owning CTA and is summed in a fixed
// order (no atomics), so the backward stays bitwise reproducible. A
// persistent CTA per multiprocessor walks `Units` of 128-row tiles; two
// consumer warpgroups own 64 rows each, and a producer warp keeps the
// tile's two resident operands (double-buffered) and a ring of blocks of
// the two streamed ones, loaded by TMA through the caller's strides (rows
// past S and columns past D load as zeros; D = 80 runs in the 128-column
// tiles).
//   dQ     a tile of 128 query rows: Q and dO resident, K and V streamed
//          in blocks of 64 keys. Per block S = Q K^T and dP = dO V^T (ss,
//          both K-major), P = 2^(s sl2 - lse log2 e) masked to 0 after the
//          exp, dS = P (dP Z - delta) scale packed to bf16 A fragments, and
//          dQ += dS K (rs, K MN-major through the transpose bit, as V in
//          the forward). dS never touches shared memory. Causal: blocks
//          up to the diagonal. ROW (the short-attention backward, which
//          keeps no O): the row term delta_i = sum_j P Z dP is formed
//          first, in f32 from P, Z and dP as the reference forms it, by a
//          sweep of its own over the key blocks (S and dP only; the
//          producer streams the blocks twice, the second time from L2),
//          stored for the dK/dV kernel, then the sweep above runs on it.
//          The keep words of the first sweep wait in shared memory for the
//          second (one a thread a block: S <= 512, 8 blocks).
//   dK/dV  a tile of keys: K and V resident, Q and dO streamed in blocks
//          of 64 query rows with their lse (times log2 e) and delta, which
//          the producer warp's lanes copy beside them. Per block S^T =
//          K Q^T (ss), P^T in registers, dV += (P^T Z) dO (rs, dO
//          MN-major), dP^T = V dO^T (ss), dS^T = P^T (dP^T Z - delta)
//          scale, dK += dS^T Q (rs, Q MN-major). Causal: blocks from the
//          diagonal.
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
//          With dropout warpgroup 0 draws the keep bits and hands each
//          over as the sign of its P^T entry (P >= 0; a dropped one goes
//          negated), so warpgroup 1 draws nothing.
// Z is the dropout factor (keep ? 1 / (1 - p) : 0) of the policy DROP
// (attention_sm90.cuh's contract above; the dK/dV body asks for the
// transposed draw, draw_t); NoDropout has none, and its bodies are the
// flash backward's (Z = 1 compiled out). Each product closes
// (wgmma_wait<0>) before the registers of the next are defined (ptxas
// serializes wgmma otherwise: C7513), and the two warpgroups take turns
// on the tensor cores. The causal units pair a long tile with a short one
// (`Units`). 288 threads, one CTA an SM.

// what the backward bodies read besides their tensor maps (their argument
// type A has these members; the flash backward passes its own Params,
// the kernel argument it always had): lse and delta [B*H, S] f32 (delta
// written by a ROW dQ body, read otherwise), the outputs (dQ; dK, dV) as
// contiguous [B, S, H, D] bf16, S as the query count Sq and the key count
// Sk (equal here), heads, head dim, softmax scale, causal
struct BwdArgs {
  const float* lse;
  float* delta;
  void* out0;
  void* out1;
  int Sq, Sk, H, D;
  float scale;
  int causal;
};

template <int DP, bool DKV, bool ROW = false, bool POS = false>
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
  // ROW: the first sweep's keep words, [blocks][consumer thread]
  static constexpr int kMaxBlocks = 8;          // S <= 512
  static constexpr int kKB = ROW ? kMaxBlocks * 128 * NWG * 4 : 0;
  // PosMask: the [2] tiles' and [STAGES] blocks' records, after the
  // barriers
  static constexpr int kPos =
      POS ? 2 * sizeof(PosRec<ROWS>) + STAGES * sizeof(PosRec<BN>) : 0;
  static constexpr size_t smem = 1024 + 4 * kR + 2 * STAGES * kB + 2 * kPT +
                                 2 * STAGES * BN * sizeof(float) + kKB +
                                 (8 + 2 * STAGES) * sizeof(uint64_t) + kPos;
};

// shared memory of a backward CTA: [2 buffers][2] resident tiles, [STAGES]
// [2] streamed blocks, [2] P^T tiles (SPLIT), [STAGES][2][BN] f32 rows
// (dK/dV: lse log2 e, delta), the keep words (ROW), the barriers, then
// the records (POS); thread 0 initialises the barriers (s_full takes
// `s_arrivals` arrivals a phase, r_full one more under POS: the record's,
// the P^T hand-over one from each of a warpgroup's four warps)
template <int DP, bool DKV, bool ROW = false, bool POS = false>
struct BwdSmem {
  using C = BwdCfg<DP, DKV, ROW, POS>;
  uint8_t *R, *S;
  float *PT, *F;
  uint64_t *r_full, *r_empty, *s_full, *s_empty, *pt_full, *pt_empty;
  __device__ BwdSmem(uint8_t* raw, int s_arrivals) {
    R = align1024(raw);
    S = R + 4 * C::kR;
    PT = reinterpret_cast<float*>(S + 2 * C::STAGES * C::kB);
    F = PT + 2 * C::kPT / 4;
    r_full = reinterpret_cast<uint64_t*>(
        reinterpret_cast<uint8_t*>(F + 2 * C::STAGES * C::BN) + C::kKB);
    r_empty = r_full + 2;
    pt_full = r_full + 4;
    pt_empty = r_full + 6;
    s_full = r_full + 8;
    s_empty = s_full + C::STAGES;
    if (threadIdx.x == 0) {
      for (int i = 0; i < 2; ++i) {
        mbar_init(&r_full[i], POS ? 2 : 1);
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
  // ROW: keep word of block j (from the tile's first) of consumer thread x
  __device__ uint32_t& kb(int j, int x) const {
    return reinterpret_cast<uint32_t*>(F + 2 * C::STAGES * C::BN)
        [j * 128 * C::NWG + x];
  }
  // POS: the record of resident buffer `buf`, of stage `s`
  __device__ PosRec<C::ROWS>* tile_rec(int buf) const {
    return reinterpret_cast<PosRec<C::ROWS>*>(s_empty + C::STAGES) + buf;
  }
  __device__ PosRec<C::BN>* blk_rec(int s) const {
    return reinterpret_cast<PosRec<C::BN>*>(tile_rec(2)) + s;
  }
};

// the streamed blocks [lo, hi) of the tile whose first resident row is r0:
// dQ (DKV false) key blocks up to the diagonal when causal, dK/dV query
// blocks from it
template <int BN, bool DKV, class A>
__device__ __forceinline__ void bwd_range(const A& a, int r0, int rows,
                                          int& lo, int& hi) {
  const int n = (a.Sq + BN - 1) / BN;
  if (DKV) {
    lo = a.causal ? r0 / BN : 0;
    hi = n;
  } else {
    lo = 0;
    hi = a.causal ? min((r0 + rows + BN - 1) / BN, n) : n;
  }
}

// dK/dV: query block j's lse (log2 domain) and delta rows, 0 past S, into
// f ([2][BN]), by the producer warp's lanes
template <int BN, class A>
__device__ __forceinline__ void bwd_rows(float* f, const A& a, int bh,
                                         int j) {
  const int lane = threadIdx.x & 31;
  const float* lse = a.lse + static_cast<size_t>(bh) * a.Sq;
  const float* delta = a.delta + static_cast<size_t>(bh) * a.Sq;
  for (int r = lane; r < BN; r += 32) {
    const int q = j * BN + r;
    const bool in = q < a.Sq;
    f[r] = in ? lse[q] * 1.4426950408889634f : 0.f;
    f[BN + r] = in ? delta[q] : 0.f;
  }
}

// the producer warp: each tile's resident pair, then its streamed blocks
// (twice for a ROW dQ body: one sweep for the row term, one for dQ)
template <int DP, bool DKV, bool ROW, class A>
__device__ __forceinline__ void bwd_producer(
    const BwdSmem<DP, DKV, ROW>& sm, const CUtensorMap& r0m,
    const CUtensorMap& r1m, const CUtensorMap& b0m, const CUtensorMap& b1m,
    const A& a, const Units& units) {
  using C = BwdCfg<DP, DKV, ROW>;
  constexpr int NS = C::STAGES, BN = C::BN;
  const int lane = threadIdx.x & 31;
  if (!DKV && lane != 0) return;        // dQ: one thread issues the loads
  int jj = 0, tt = 0;                   // blocks and tiles loaded so far
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int bh, tiles[2];
    const int nt = units.tiles(u, bh, tiles);
    const int b = bh / a.H, h = bh % a.H;
    for (int i = 0; i < nt; ++i, ++tt) {
      const int r0 = tiles[i] * C::ROWS;
      int lo, hi;
      bwd_range<BN, DKV>(a, r0, C::ROWS, lo, hi);
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
      auto stream = [&] {
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
            // the stage's second arrival once every lane's stores are done
            bwd_rows<BN>(sm.F + 2 * s * BN, a, bh, j);
            __threadfence_block();
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.s_full[s]);
          }
        }
      };
      stream();
      if constexpr (ROW) stream();
    }
  }
}

// the producer warp under PosMask, every lane (see the note at the top):
// each tile's resident pair and its record, then the blocks it meets,
// each with its record (and, dK/dV, its lse and delta rows). dQ: queries
// resident, key blocks streamed, a pair meets where the tile's largest
// query position reaches the block's smallest key position; dK/dV the
// other way round.
template <int DP, bool DKV, class A>
__device__ __forceinline__ void bwd_pos_producer(
    const BwdSmem<DP, DKV, false, true>& sm, const CUtensorMap& r0m,
    const CUtensorMap& r1m, const CUtensorMap& b0m, const CUtensorMap& b1m,
    const A& a, const Units& units, const PosMask& mp) {
  using C = BwdCfg<DP, DKV, false, true>;
  constexpr int NS = C::STAGES, BN = C::BN;
  const int lane = threadIdx.x & 31;
  // positions of the resident and the streamed rows, each with the
  // sentinel past S that no compare passes
  const int* rpos = DKV ? mp.kpos : mp.qpos;
  const int* spos = DKV ? mp.qpos : mp.kpos;
  const int r_past = DKV ? INT_MAX : INT_MIN;
  const int s_past = DKV ? INT_MIN : INT_MAX;
  const int n_blk = (a.Sq + BN - 1) / BN;
  int jj = 0, tt = 0;                   // blocks and tiles loaded so far
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int bh, tiles[2];
    const int nt = units.tiles(u, bh, tiles);
    const int b = bh / a.H, h = bh % a.H;
    for (int i = 0; i < nt; ++i, ++tt) {
      const int r0 = tiles[i] * C::ROWS;
      const int rb = tt & 1;
      mbar_wait(&sm.r_empty[rb], ((tt >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&sm.r_full[rb], 2 * C::kR);
        for (int sub = 0; sub < C::NSUB; ++sub) {
          tma_load_4d(sm.res(rb, 0) + sub * C::kRSub, &r0m, &sm.r_full[rb],
                      sub * 64, h, r0, b);
          tma_load_4d(sm.res(rb, 1) + sub * C::kRSub, &r1m, &sm.r_full[rb],
                      sub * 64, h, r0, b);
        }
      }
      // the bounds of the tile's 64-row groups (SPLIT: one group, both
      // consumer warpgroups'), and the bound a streamed block is held to:
      // the tile's largest query position (dQ) or its smallest key
      // position (dK/dV)
      int glo[2], ghi[2], bound;
      {
        LanePos<C::ROWS> rp;
        rp.load(rpos, r0, a.Sq, r_past);
        rp.bounds(r0, a.Sq);
        for (int w = 0; w < 2; ++w) {
          glo[w] = rp.lo[C::SPLIT ? 0 : w];
          ghi[w] = rp.hi[C::SPLIT ? 0 : w];
        }
        bound = DKV ? rp.min_all() : rp.max_all();
        int n = 0;
        for (int j0 = 0; j0 < n_blk; j0 += 32)
          n += __popc(meet_mask<BN, !DKV>(spos, a.Sq, j0, bound));
        rp.publish(*sm.tile_rec(rb), n);
      }
      publish_arrive(&sm.r_full[rb]);
      for (int j0 = 0; j0 < n_blk; j0 += 32)
        for (uint32_t mk = meet_mask<BN, !DKV>(spos, a.Sq, j0, bound); mk;
             mk &= mk - 1, ++jj) {
          const int j = j0 + __ffs(mk) - 1;
          LanePos<BN> sp;
          sp.load(spos, j * BN, a.Sq, s_past);
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
          if constexpr (DKV) bwd_rows<BN>(sm.F + 2 * s * BN, a, bh, j);
          sp.bounds(j * BN, a.Sq);
          // each consumer warpgroup's mode: its 64 resident rows against
          // the block (dK/dV: its keys, ragged where they run past S)
          int mode[2];
          for (int w = 0; w < 2; ++w) {
            const bool ragged =
                (j + 1) * BN > a.Sq ||
                (DKV && r0 + (C::SPLIT ? 0 : 64 * w) + 64 > a.Sk);
            mode[w] = DKV ? pos_mode(sp.min_all(), sp.max_all(), glo[w],
                                     ghi[w], ragged)
                          : pos_mode(glo[w], ghi[w], sp.min_all(),
                                     sp.max_all(), ragged);
          }
          sp.publish(*sm.blk_rec(s), j, mode[0], mode[1]);
          publish_arrive(&sm.s_full[s]);
        }
    }
  }
}

// an accumulator tile's two rows (row_lo and row_lo + 8, below S) into a
// contiguous [B, S, H, D] bf16 output
template <int NSUB, class A>
__device__ __forceinline__ void store_tile_rows(void* outp,
                                                const float (&acc)[NSUB][32],
                                                const A& a, int b,
                                                int h, int row_lo) {
  const int t = threadIdx.x & 3;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(outp);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row_lo + 8 * hh;
    if (r >= a.Sq) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * a.Sq + r) * a.H + h) * a.D;
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = sub * 64 + 8 * i + 2 * t;   // D % 8 == 0: pairs
        if (col < a.D)
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

// d[64 x 64] = A B^T over DP columns, both operands K-major: issued and
// committed (wg_ss_issue), or also waited for (wg_ss)
template <int DP>
__device__ __forceinline__ void wg_ss_issue(float (&d)[32], const uint8_t* a,
                                            int a_sub, int a_row0,
                                            const uint8_t* bm, int b_sub) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wgmma_ss_bf16<64, 0, 0>(d, kdesc(a, a_sub, a_row0, ks),
                            kdesc(bm, b_sub, 0, ks), ks > 0);
  wgmma_commit();
}

template <int DP>
__device__ __forceinline__ void wg_ss(float (&d)[32], const uint8_t* a,
                                      int a_sub, int a_row0,
                                      const uint8_t* bm, int b_sub) {
  wg_ss_issue<DP>(d, a, a_sub, a_row0, bm, b_sub);
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

// the dropout factor of entry i of an accumulator whose keep word is `keep`
__device__ __forceinline__ float keep_z(uint32_t keep, int i, float ks) {
  return (keep >> i) & 1u ? ks : 0.f;
}

// P o Z (f32, the m64n64 accumulator layout) -> bf16 A fragments, as
// `pack_p` (Z scaled in before the cast, as the forward does)
__device__ __forceinline__ void pack_pz(const float (&s)[32], uint32_t keep,
                                        float ks, uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r;
      pa[kk][r] = pack2<__nv_bfloat16>(s[i] * keep_z(keep, i, ks),
                                       s[i + 1] * keep_z(keep, i + 1, ks));
    }
}

// P of one dQ block: 2^(s sl2 - lse2), 0 where masked (MASK: the block
// crosses the causal diagonal or the end of the keys)
template <bool MASK, class A>
__device__ __forceinline__ float dq_prob(const float (&sc)[32], int i, int e,
                                         const A& a, int k0,
                                         int row_lo, const float (&lse2)[2],
                                         float sl2) {
  const int t = threadIdx.x & 3;
  const int col = k0 + 8 * i + 2 * t + (e & 1);
  const int row = row_lo + (e < 2 ? 0 : 8);
  const bool keep = !MASK || (col < a.Sk && (!a.causal || row >= col));
  return keep ? fast_exp2(fmaf(sc[4 * i + e], sl2, -lse2[e >> 1])) : 0.f;
}

// dQ's dS of one block: dS = P (dP Z - delta) scale (Z compiled out: ZON
// false), packed to the A fragments of dS K. POS: the compare is on the
// positions of the thread's rows (qrow[0 or 8]) and of the block's keys
// (kcol), in shared memory.
template <bool MASK, bool ZON, bool POS = false, class A>
__device__ __forceinline__ void dq_ds(const float (&sc)[32],
                                      const float (&dp)[32],
                                      uint32_t (&pa)[4][4], const A& a,
                                      int k0, int row_lo,
                                      const float (&lse2)[2],
                                      const float (&dl)[2], float sl2,
                                      uint32_t keep, float ks,
                                      const int* qrow = nullptr,
                                      const int* kcol = nullptr) {
  const int t = threadIdx.x & 3;
  float ds[32];
  [[maybe_unused]] int qv[2];
  if constexpr (POS && MASK) {
    qv[0] = qrow[0];
    qv[1] = qrow[8];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * i + 2 * t + (e & 1);
      const int row = row_lo + (e < 2 ? 0 : 8);
      bool in;
      if constexpr (POS && MASK)
        in = qv[e >> 1] >= kcol[8 * i + 2 * t + (e & 1)];
      else
        in = !MASK || (col < a.Sk && (!a.causal || row >= col));
      const float pv =
          in ? fast_exp2(fmaf(sc[4 * i + e], sl2, -lse2[e >> 1])) : 0.f;
      if constexpr (ZON)
        ds[4 * i + e] =
            pv * (dp[4 * i + e] * keep_z(keep, 4 * i + e, ks) - dl[e >> 1]) *
            a.scale;
      else
        ds[4 * i + e] = pv * (dp[4 * i + e] - dl[e >> 1]) * a.scale;
    }
  pack_p<64>(ds, pa);
}

// the row term's share of one block: dl += P Z dP (this thread's entries)
template <bool MASK, class A>
__device__ __forceinline__ void dq_row(const float (&sc)[32],
                                       const float (&dp)[32],
                                       const A& a, int k0, int row_lo,
                                       const float (&lse2)[2], float (&dl)[2],
                                       float sl2, uint32_t keep, float ks) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = dq_prob<MASK>(sc, i, e, a, k0, row_lo, lse2, sl2);
      dl[e >> 1] += pv * keep_z(keep, 4 * i + e, ks) * dp[4 * i + e];
    }
}

template <int DP, bool ROW, class A, class DROP, class MP = IndexMask>
__device__ __forceinline__ void dq_sm90_body(const CUtensorMap& tq,
                                             const CUtensorMap& tdo,
                                             const CUtensorMap& tk,
                                             const CUtensorMap& tv,
                                             const A& a,
                                             const Units& units, DROP drop,
                                             MP mp = {}) {
  constexpr bool POS = MP::kOn;
  using C = BwdCfg<DP, false, ROW, POS>;
  constexpr int NS = C::STAGES, BN = C::BN;
  constexpr bool ZON = DROP::kOn;       // Z is applied (the short backward)
  static_assert(ROW || !ZON, "a dropout dQ body forms its row term");
  static_assert(!(POS && ROW), "a ring step takes the caller's delta");
  extern __shared__ uint8_t smem_raw[];
  // POS: a stage also takes the lanes' arrival after the block's record
  const BwdSmem<DP, false, ROW, POS> sm(smem_raw, POS ? 2 : 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4 * C::NWG) {
    if constexpr (POS)
      bwd_pos_producer<DP, false>(sm, tq, tdo, tk, tv, a, units, mp);
    else
      bwd_producer<DP, false, ROW>(sm, tq, tdo, tk, tv, a, units);
    return;
  }
  if constexpr (ZON) drop.init();
  const int wg = warp >> 2, g = lane >> 2;
  const bool leader = (threadIdx.x & 127) == 0;
  const float sl2 = a.scale * 1.4426950408889634f;
  [[maybe_unused]] const float ks = drop.keep_scale();
  int jj = 0, tt = 0;
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int bh, tiles[2];
    const int nt = units.tiles(u, bh, tiles);
    const int b = bh / a.H, h = bh % a.H;
    for (int it = 0; it < nt; ++it, ++tt) {
      const int q0 = tiles[it] * C::ROWS;
      int lo, hi;
      bwd_range<BN, false>(a, q0, C::ROWS, lo, hi);
      // key blocks wholly past this warpgroup's last row (causal), or all
      // of them when its rows lie past S: taken in turn, released unread
      const int hi_wg =
          q0 + wg * 64 >= a.Sq
              ? 0
              : a.causal ? min((q0 + wg * 64 + 64 + BN - 1) / BN, hi) : hi;
      const int row_lo = q0 + wg * 64 + (warp & 3) * 16 + g;
      float lse2[2], dl[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_lo + 8 * hh;
        const size_t at = static_cast<size_t>(bh) * a.Sq + r;
        lse2[hh] = r < a.Sq ? a.lse[at] * 1.4426950408889634f : 0.f;
        dl[hh] = !ROW && r < a.Sq ? a.delta[at] : 0.f;
      }
      const uint8_t* Qb = sm.res(tt & 1, 0);
      const uint8_t* dOb = sm.res(tt & 1, 1);
      mbar_wait(&sm.r_full[tt & 1], (tt >> 1) & 1);
      __syncwarp();
      if constexpr (ROW) {
        // the first sweep: delta_i = sum_j P Z dP
        for (int j = lo; j < hi; ++j, ++jj) {
          const int s = jj % NS;
          mbar_wait(&sm.s_full[s], (jj / NS) & 1);
          __syncwarp();
          if (j >= hi_wg) {
            bar_sync(1 + wg, 128);
            if (leader) mbar_arrive(&sm.s_empty[s]);
            continue;
          }
          const int k0 = j * BN;
          // S and dP in flight while the keep bits are drawn (kept for
          // the second sweep): no accumulator is touched meanwhile, and
          // the draw's registers fit beside the two (64 of them)
          float sc[32], dp[32];
          wg_ss_issue<DP>(sc, Qb, C::kRSub, wg * 64, sm.blk(s, 0), C::kSub);
          wg_ss_issue<DP>(dp, dOb, C::kRSub, wg * 64, sm.blk(s, 1), C::kSub);
          uint32_t keep = ~0u;
          if constexpr (ZON)
            if (drop.on()) {
              uint32_t kw[1];
              drop.template draw<BN>(kw, b, h, row_lo, k0);
              keep = kw[0];
            }
          sm.kb(j - lo, threadIdx.x) = keep;
          wgmma_wait<0>();
          reg_fence(sc);
          reg_fence(dp);
          if (leader) mbar_arrive(&sm.s_empty[s]);   // K and V are read
          if (k0 + BN > a.Sk || (a.causal && k0 + BN - 1 > q0 + wg * 64))
            dq_row<true>(sc, dp, a, k0, row_lo, lse2, dl, sl2, keep, ks);
          else
            dq_row<false>(sc, dp, a, k0, row_lo, lse2, dl, sl2, keep, ks);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          dl[hh] = quad_sum(dl[hh]);
          const int r = row_lo + 8 * hh;
          if ((lane & 3) == 0 && r < a.Sq)
            a.delta[static_cast<size_t>(bh) * a.Sq + r] = dl[hh];
        }
      }
      float dq[C::NSUB][32];
#pragma unroll
      for (int sub = 0; sub < C::NSUB; ++sub)
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[sub][i] = 0.f;
      // POS: the blocks streamed for the tile, from its record
      [[maybe_unused]] const PosRec<C::ROWS>* tr = sm.tile_rec(tt & 1);
      if constexpr (POS) {
        lo = 0;
        hi = tr->n;
      }
      for (int x = lo; x < hi; ++x, ++jj) {
        const int s = jj % NS;
        mbar_wait(&sm.s_full[s], (jj / NS) & 1);
        __syncwarp();                   // converged for the .aligned wgmma
        // the block, and whether this warpgroup skips it (POS: no row of
        // it sees a key of the block)
        int j = x;
        bool skip = x >= hi_wg;
        // (the mode is read again where it is used, as in the forward)
        [[maybe_unused]] const PosRec<BN>* br = sm.blk_rec(s);
        if constexpr (POS) {
          j = br->n;
          skip = br->mode[wg] == kSkip;
        }
        if (skip) {
          // every warp is past its wait before the leader releases the
          // stage (no wgmma orders them here)
          bar_sync(1 + wg, 128);
          if (leader) mbar_arrive(&sm.s_empty[s]);
          continue;
        }
        [[maybe_unused]] uint32_t keep = ~0u;
        if constexpr (ZON) keep = sm.kb(j - lo, threadIdx.x);
        const uint8_t* Kb = sm.blk(s, 0);
        const uint8_t* Vb = sm.blk(s, 1);
        float sc[32], dp[32];
        if constexpr (ROW) {
          // the two products in flight together (one wait)
          wg_ss_issue<DP>(sc, Qb, C::kRSub, wg * 64, Kb, C::kSub);
          wg_ss_issue<DP>(dp, dOb, C::kRSub, wg * 64, Vb, C::kSub);
          wgmma_wait<0>();
          reg_fence(sc);
          reg_fence(dp);
        } else {
          wg_ss<DP>(sc, Qb, C::kRSub, wg * 64, Kb, C::kSub);
          wg_ss<DP>(dp, dOb, C::kRSub, wg * 64, Vb, C::kSub);
        }
        const int k0 = j * BN;
        uint32_t pa[4][4];
        if constexpr (POS) {
          if (br->mode[wg] == kMask)
            dq_ds<true, ZON, true>(sc, dp, pa, a, k0, row_lo, lse2, dl, sl2,
                                   keep, ks, tr->pos + (row_lo - q0),
                                   br->pos);
          else
            dq_ds<false, ZON>(sc, dp, pa, a, k0, row_lo, lse2, dl, sl2, keep,
                              ks);
        } else if (k0 + BN > a.Sk ||
                   (a.causal && k0 + BN - 1 > q0 + wg * 64)) {
          dq_ds<true, ZON>(sc, dp, pa, a, k0, row_lo, lse2, dl, sl2, keep,
                           ks);
        } else {
          dq_ds<false, ZON>(sc, dp, pa, a, k0, row_lo, lse2, dl, sl2, keep,
                            ks);
        }
        wg_rs<C::NSUB>(dq, pa, Kb, C::kSub);
        if (leader) mbar_arrive(&sm.s_empty[s]);   // K and V are read
      }
      if (leader) mbar_arrive(&sm.r_empty[tt & 1]);  // Q and dO are read
      store_tile_rows<C::NSUB>(a.out0, dq, a, b, h, row_lo);
    }
  }
}

// dK/dV's P^T of one block in place: rows are keys (krow_lo, + 8), columns
// query rows qi0 + ..., masked (MASK) past S and above the diagonal; POS:
// by the positions of the block's queries (qcol) and of the thread's keys
// (krow[0 or 8]), in shared memory
template <bool MASK, bool POS = false, class A>
__device__ __forceinline__ void dkv_p(float (&st)[32], const A& a,
                                      int qi0, int krow_lo,
                                      const float* lse2, float sl2,
                                      const int* qcol = nullptr,
                                      const int* krow = nullptr) {
  const int t = threadIdx.x & 3;
  [[maybe_unused]] int kv[2];
  if constexpr (POS && MASK) {
    kv[0] = krow[0];
    kv[1] = krow[8];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ql = 8 * i + 2 * t + (e & 1), qc = qi0 + ql;
      const int kr = krow_lo + (e < 2 ? 0 : 8);
      bool keep;
      if constexpr (POS && MASK)
        keep = qcol[ql] >= kv[e >> 1];
      else
        keep = !MASK || (qc < a.Sq && kr < a.Sk && (!a.causal || qc >= kr));
      st[4 * i + e] =
          keep ? fast_exp2(fmaf(st[4 * i + e], sl2, -lse2[ql])) : 0.f;
    }
}

// dS^T = P^T (dP^T Z - delta) scale over one block, in place of dP^T (Z
// compiled out: ZON false)
template <bool ZON>
__device__ __forceinline__ void dkv_ds(float (&dpt)[32], const float (&pt)[32],
                                       const float* dl, float scale,
                                       uint32_t keep, float ks) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      if constexpr (ZON)
        dpt[i] = pt[i] * (dpt[i] * keep_z(keep, i, ks) -
                          dl[8 * n + 2 * t + (e & 1)]) * scale;
      else
        dpt[i] = pt[i] * (dpt[i] - dl[8 * n + 2 * t + (e & 1)]) * scale;
    }
}

template <int DP, class A, class DROP, class MP = IndexMask>
__device__ __forceinline__ void dkv_sm90_body(const CUtensorMap& tk,
                                              const CUtensorMap& tv,
                                              const CUtensorMap& tq,
                                              const CUtensorMap& tdo,
                                              const A& a,
                                              const Units& units, DROP drop,
                                              MP mp = {}) {
  constexpr bool POS = MP::kOn;
  using C = BwdCfg<DP, true, false, POS>;
  constexpr int NS = C::STAGES, BN = C::BN;
  constexpr bool ZON = DROP::kOn;
  extern __shared__ uint8_t smem_raw[];
  // TMA bytes + the lanes' rows (and, POS, the block's record)
  const BwdSmem<DP, true, false, POS> sm(smem_raw, 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4 * C::NWG) {
    if constexpr (POS)
      bwd_pos_producer<DP, true>(sm, tk, tv, tq, tdo, a, units, mp);
    else
      bwd_producer<DP, true, false>(sm, tk, tv, tq, tdo, a, units);
    return;
  }
  if constexpr (ZON) drop.init();
  const int wg = warp >> 2, g = lane >> 2;
  const bool leader = (threadIdx.x & 127) == 0;
  const float sl2 = a.scale * 1.4426950408889634f;
  [[maybe_unused]] const float ks = drop.keep_scale();
  // SPLIT: warpgroup 0 forms dV, 1 dK, of the same 64 keys; else each
  // warpgroup both, of its own 64 keys
  const int wrow = C::SPLIT ? 0 : wg * 64;  // its rows in the resident tile
  int jj = 0, tt = 0, pc = 0;             // blocks, tiles, P^T hand-overs
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int bh, tiles[2];
    const int nt = units.tiles(u, bh, tiles);
    const int b = bh / a.H, h = bh % a.H;
    for (int it = 0; it < nt; ++it, ++tt) {
      const int k0 = tiles[it] * C::ROWS;
      int lo, hi;
      bwd_range<BN, true>(a, k0, C::ROWS, lo, hi);
      const int kw = k0 + wrow;          // this warpgroup's first key
      const int krow_lo = kw + (warp & 3) * 16 + g;
      const uint8_t* Kb = sm.res(tt & 1, 0);
      const uint8_t* Vb = sm.res(tt & 1, 1);
      float acc[2][C::NSUB][32];         // dK, dV (SPLIT: this one's)
      constexpr int NACC = C::SPLIT ? 1 : 2;
#pragma unroll
      for (int x = 0; x < NACC; ++x)
#pragma unroll
        for (int sub = 0; sub < C::NSUB; ++sub)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[x][sub][i] = 0.f;
      mbar_wait(&sm.r_full[tt & 1], (tt >> 1) & 1);
      __syncwarp();
      // POS: the blocks streamed for the tile, from its record
      [[maybe_unused]] const PosRec<C::ROWS>* tr = sm.tile_rec(tt & 1);
      if constexpr (POS) {
        lo = 0;
        hi = tr->n;
      }
      for (int x = lo; x < hi; ++x, ++jj) {
        const int s = jj % NS;
        mbar_wait(&sm.s_full[s], (jj / NS) & 1);
        __syncwarp();
        int i = x;
        [[maybe_unused]] const PosRec<BN>* br = sm.blk_rec(s);
        [[maybe_unused]] int mode = kMask;
        if constexpr (POS) {
          i = br->n;
          mode = br->mode[wg];
        }
        const int qi0 = i * BN;
        // no key of this warpgroup (a ragged last tile), or every query
        // row of the block before its first key (causal; POS: no query of
        // the block sees a key of the warpgroup): released unread
        bool skip = kw >= a.Sk || (a.causal && qi0 + BN - 1 < kw);
        if constexpr (POS) skip = mode == kSkip;
        if (skip) {
          bar_sync(1 + wg, 128);
          if (leader) mbar_arrive(&sm.s_empty[s]);
          continue;
        }
        const uint8_t* Qb = sm.blk(s, 0);
        const uint8_t* dOb = sm.blk(s, 1);
        const float* lse2 = sm.F + 2 * s * BN;
        const float* dl = lse2 + BN;
        bool mask = qi0 + BN > a.Sq || kw + 64 > a.Sk ||
                    (a.causal && qi0 < kw + 63);
        if constexpr (POS) mask = mode == kMask;
        uint32_t pa[4][4];
        float st[32];
        [[maybe_unused]] uint32_t keep = ~0u;
        if (!C::SPLIT || wg == 0) {
          // the keep bits of S^T's entries (the transposed draw), before
          // the product is issued: drawn while it was in flight, the
          // kernel ran slower at BERT's shape (D = 64, at the 168-register
          // cap beside dK's and dV's 64 accumulators)
          if constexpr (ZON)
            if (drop.on()) {
              uint32_t kw2[1];
              drop.template draw_t<BN>(kw2, b, h, krow_lo, qi0);
              keep = kw2[0];
            }
          wg_ss<DP>(st, Kb, C::kRSub, wrow, Qb, C::kSub);
          if (mask) {
            if constexpr (POS)
              dkv_p<true, true>(st, a, qi0, krow_lo, lse2, sl2, br->pos,
                                tr->pos + (krow_lo - k0));
            else
              dkv_p<true>(st, a, qi0, krow_lo, lse2, sl2);
          } else {
            dkv_p<false>(st, a, qi0, krow_lo, lse2, sl2);
          }
          if constexpr (C::SPLIT) {
            // P^T to warpgroup 1: entry k of thread x at [k][x]; a
            // dropped entry negated (its keep bit as the sign)
            const int pb = pc & 1;
            mbar_wait(&sm.pt_empty[pb], ((pc >> 1) & 1) ^ 1);
            float4* dst = reinterpret_cast<float4*>(sm.PT + pb * 64 * 64) +
                          (threadIdx.x & 127);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              if constexpr (ZON) {
                float v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  v[e] = (keep >> (4 * k + e)) & 1u ? st[4 * k + e]
                                                    : -st[4 * k + e];
                dst[k * 128] = make_float4(v[0], v[1], v[2], v[3]);
              } else {
                dst[k * 128] = make_float4(st[4 * k], st[4 * k + 1],
                                           st[4 * k + 2], st[4 * k + 3]);
              }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.pt_full[pb]);
          }
          if constexpr (ZON)
            pack_pz(st, keep, ks, pa);
          else
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
            if constexpr (ZON) {
              keep = 0u;
#pragma unroll
              for (int x = 0; x < 32; ++x) {
                keep |= (~__float_as_uint(st[x]) >> 31) << x;
                st[x] = fabsf(st[x]);
              }
            }
          }
          dkv_ds<ZON>(dpt, st, dl, a.scale, keep, ks);
          pack_p<64>(dpt, pa);
          wg_rs<C::NSUB>(acc[0], pa, Qb, C::kSub);           // dK
        }
        ++pc;
        if (leader) mbar_arrive(&sm.s_empty[s]);   // Q, dO and rows read
      }
      if (leader) mbar_arrive(&sm.r_empty[tt & 1]);  // K and V are read
      if (!C::SPLIT || wg == 1)
        store_tile_rows<C::NSUB>(a.out0, acc[0], a, b, h, krow_lo);
      if (!C::SPLIT || wg == 0)
        store_tile_rows<C::NSUB>(a.out1, acc[NACC - 1], a, b, h, krow_lo);
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
// kernel's trailing arguments `extra` (its dropout policy, or its
// positions: POS, whose kernels run PosMask; or its table: TABLE, whose
// kernels run BlockTable). The tensor maps take S rows for q, k and v
// alike: a ring step's shards are of one length.
template <auto K64, auto K128, bool POS = false, bool TABLE = false,
          class... EXTRA>
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
    constexpr size_t smem = HopCfg<DP, POS, TABLE>::smem;
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

// Launches a backward kernel, dQ (DKV false; ROW: the body that forms the
// row term) or dK/dV: K64 (D <= 64) or K128 (64 < D <= 128) on q, k, v and
// dout ([B, S, H, D] bf16, element strides {b, s, h} each, in that order)
// with the kernel's trailing arguments `extra` (its dropout policy, or its
// positions: POS). The tensor maps take Sq rows for all four: Sq == Sk.
template <auto K64, auto K128, bool DKV, bool ROW, bool POS = false, class A,
          class... EXTRA>
int launch_bwd_sm90(const void* const (&bases)[4],
                    const long long (&strides)[4][3], int B, const A& a,
                    cudaStream_t s, const EXTRA&... extra) {
  // resident operands first (dQ: q, dout; dK/dV: k, v), then the streamed
  const int order[4] = {DKV ? 1 : 0, DKV ? 2 : 3, DKV ? 0 : 1, DKV ? 3 : 2};
  const bool d64 = a.D <= 64;
  const int rows = !DKV ? BwdCfg<64, false>::ROWS
                   : d64 ? BwdCfg<64, true>::ROWS
                         : BwdCfg<128, true>::ROWS;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const int o = order[i];
    if (!attn_tmap(&maps[i], bases[o], B, a.Sq, a.H, a.D, strides[o][0],
                   strides[o][1], strides[o][2],
                   i < 2 ? rows : BwdCfg<64, true>::BN))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Units units((a.Sq + rows - 1) / rows, B * a.H, a.causal != 0);
  const dim3 grid(std::min(units.count, sm_count()));
  auto go = [&](auto kernel, auto dp) {
    constexpr int DP = decltype(dp)::value;
    constexpr auto K = decltype(kernel)::value;
    using C = BwdCfg<DP, DKV, ROW, POS>;
    if (const int e = smem_opt_in<K>(C::smem)) return e;
    K<<<grid, C::THREADS, C::smem, s>>>(maps[0], maps[1], maps[2], maps[3],
                                         a, units, extra...);
    return 0;
  };
  return d64 ? go(std::integral_constant<decltype(K64), K64>(),
                  std::integral_constant<int, 64>())
             : go(std::integral_constant<decltype(K128), K128>(),
                  std::integral_constant<int, 128>());
}

}  // namespace attn90
}  // namespace ptt
