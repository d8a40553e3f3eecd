// Paged flash-decoding: single-query attention of every sequence over its
// own KV blocks, read in place through the block table.
//
// Replaces paddle_tpu/ops/pallas/decode_attn.py `_paged_kernel` (reached
// through `paged_decode_attention`) and `_kernel` (reached through
// `decode_attention`): a contiguous cache [B, Hkv, T, D] is the pool with
// one block of T rows a sequence, passed with no table (sequence b reads
// block b).
//
// For sequence b and query head h (KV head hk = h / (H / Hkv)):
//   s_t = (q . k_t) * ks_t * scale          for t = 0 .. pos[b]
//   out = sum_t softmax(s)_t * vs_t * v_t
// where k_t / v_t live in pool block tables[b, t / BS] (b with no table),
// row t % BS, and ks / vs are the per-row f32 dequant scales of an int8
// pool (absent for a float pool: 1). Softmax is online in f32: (m, l, acc) carried across
// the sequence's tokens, exactly as the TPU kernel carries them across its
// sequential grid.
//
// What bounds it on an H100: the KV bytes the sequence owns, read once
// ((pos + 1) rows of K and V per KV head), at 3.35 TB/s; the arithmetic is
// about one FMA per byte (two with GQA's heads sharing a row), far below
// the tensor cores' break-even of ~295 operations a byte, so the work runs
// on the CUDA cores: a tensor-core tile would be 1/16 full (one query row)
// and save nothing, since the bytes bound it.
//
// Two bodies, chosen by the caller's route (ops/decode_attn.py
// `paged_route`), each refused by the entry where its inputs do not fit:
//   * `paged_decode_ring` (route 1), the Hopper design. One CTA of four
//     warps per (sequence, KV head, token split) computes the query heads
//     of that KV head, four a CTA where G = H / Hkv is a multiple of four
//     and one a CTA otherwise: so each K/V row is read from device memory
//     once at G = 1 or 4, G / 4 times at G = 8, 12, ..., and G times at
//     any other G (2, 3, 6, ...; the port's named models are all MHA,
//     G = 1, but `num_kv_heads` may set any G). The split's table
//     entries are staged in shared memory once per CTA. Each warp streams
//     its own chunks of 8 tokens (chunk c of the split to warp c % 4)
//     through a ring of 3 stages in shared memory, filled by 16-byte
//     cp.async (the int8 row scales by 4-byte ones), so two chunks are in
//     flight while one is reduced (4 stages measured slower: fewer CTAs
//     an SM). A row is read by LPR
//     lanes, 16 bytes each (8 of an int8 row: 8 values a lane, so a
//     query head takes 8 registers of q and 8 of acc): scores are dot
//     products of the lane's columns with the query heads held in
//     registers, summed over the row's lanes by a reduce-scatter, so a
//     lane ends with one row's score; the online softmax (m, l, acc; log2
//     domain) runs per warp with no CTA barrier per chunk, the chunk's
//     probabilities passing to the lanes that multiply them into V
//     through shared memory; an int8 row is dequantised in registers with
//     its f32 scale. At the end the warps merge in a fixed order, then the
//     splits as before. Rows of 64, 128, 256 or 512 bytes (bf16 D = 32 to
//     256, int8 D = 64 to 256, f32 D = 16 to 128), 16-byte aligned rows.
//   * `paged_decode` (route 0), the first body: for any D <= 512 and any
//     strides. One block per (head, sequence, token split), chunks of 64
//     tokens with three CTA barriers each, scalar loads, and each GQA
//     query head re-reads its KV head's rows.
// Both: splitting each sequence's tokens over up to 16 blocks
// (flash-decoding) keeps the card full at small batch; a second small
// kernel merges the splits' (m, l, acc) in a fixed order. The split
// length depends only on the table width, never on the batch, and every
// merge runs in a fixed order, so a sequence's result is the same bits in
// any batch. Early stop at pos[b]: table entries past the last used block
// (they point at reserved block 0) are never read, and no token past
// pos[b] is loaded; a ring CTA whose split holds none of the sequence's
// tokens exits at once, and the merge reads only the splits before
// pos[b] / split length. The pool is addressed by element strides (n, h, t)
// with a unit stride along D, so the engine passes a permuted view of its
// [N, BS, Hkv, D] pool without copying it. A contiguous cache has no
// table (sequence b reads block b) and may pass one position for every
// sequence (`pos_all`, pos null) instead of a [B] tensor.
// NaN guard: block 0 of a live sequence holds position 0 <= pos, so the
// running max is finite after the first chunk; the first chunk's rescale
// factor is taken as 0 instead of exp(-inf - -inf).
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace ptt;
using ptt::sm90::smem_u32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;               // tokens per iteration
constexpr int kPerWarp = kChunk / kWarps;  // scores per warp per chunk
constexpr int kMaxDPerThread = 4;        // D <= 512
constexpr int kMaxSplits = 16;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_decode(
    const TQ* __restrict__ q, const TKV* __restrict__ kq,
    const float* __restrict__ ks, const TKV* __restrict__ vq,
    const float* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ pos, int pos_all, TQ* __restrict__ out, int H,
    int Hkv, int D, int BS, int NB, long long kv_sn, long long kv_sh,
    long long kv_st, long long sc_sn, long long sc_sh, long long sc_st,
    float scale, int part, float* __restrict__ partial) {
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int hk = h / (H / Hkv);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_s = reinterpret_cast<long long*>(smem_raw);  // KV row offs
  long long* sco_s = row_s + kChunk;                          // scale offs
  float* q_s = reinterpret_cast<float*>(sco_s + kChunk);      // [D]
  float* s_s = q_s + D;                                       // scores
  float* pl_s = s_s + kChunk;                                 // exp(s - m)
  float* pv_s = pl_s + kChunk;                                // ... * vs

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TQ* qp = q + (static_cast<size_t>(b) * H + h) * D;
  for (int d = tid; d < D; d += kThreads) q_s[d] = to_f(qp[d]);
  const int ntok = min((pos != nullptr ? pos[b] : pos_all) + 1, NB * BS);
  const int t_begin = split * part, t_end = min(ntok, t_begin + part);
  const int* tab = tables + static_cast<size_t>(b) * NB;
  const TKV* kbase = kq + hk * kv_sh;
  const TKV* vbase = vq + hk * kv_sh;

  float m_run = -INFINITY, l_run = 0.f;
  float acc[kMaxDPerThread];
#pragma unroll
  for (int i = 0; i < kMaxDPerThread; ++i) acc[i] = 0.f;

  for (int c0 = t_begin; c0 < t_end; c0 += kChunk) {
    const int cnt = min(kChunk, t_end - c0);
    if (tid < cnt) {
      const int gt = c0 + tid;
      const long long blk = tables != nullptr ? tab[gt / BS] : b;
      const int t = gt % BS;
      row_s[tid] = blk * kv_sn + t * kv_st;
      sco_s[tid] = blk * sc_sn + hk * sc_sh + t * sc_st;
    }
    __syncthreads();  // row offsets (and q_s on the first chunk)

    float dot[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) dot[i] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float qd = q_s[d];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const int t = warp + i * kWarps;
        if (t < cnt) dot[i] = fmaf(qd, to_f(kbase[row_s[t] + d]), dot[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const float s = warp_sum(dot[i]);
      const int t = warp + i * kWarps;
      if (lane == 0 && t < cnt)
        s_s[t] = s * (ks != nullptr ? ks[sco_s[t]] : 1.f) * scale;
    }
    __syncthreads();

    float cmax = -INFINITY;
    for (int t = 0; t < cnt; ++t) cmax = fmaxf(cmax, s_s[t]);
    const float m_new = fmaxf(m_run, cmax);
    const float alpha = (m_run == -INFINITY) ? 0.f : expf(m_run - m_new);
    if (tid < cnt) {
      const float e = expf(s_s[tid] - m_new);
      pl_s[tid] = e;
      pv_s[tid] = vs != nullptr ? e * vs[sco_s[tid]] : e;
    }
    __syncthreads();

    float lsum = 0.f;
    for (int t = 0; t < cnt; ++t) lsum += pl_s[t];
    l_run = l_run * alpha + lsum;
#pragma unroll
    for (int i = 0; i < kMaxDPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d < D) {
        float a = acc[i] * alpha;
        for (int t = 0; t < cnt; ++t)
          a = fmaf(pv_s[t], to_f(vbase[row_s[t] + d]), a);
        acc[i] = a;
      }
    }
    m_run = m_new;
    __syncthreads();  // before the next chunk overwrites the shared arrays
  }

  if (gridDim.z == 1) {  // one split: normalise and write the output
    TQ* op = out + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kMaxDPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d < D) op[d] = from_f<TQ>(acc[i] / l_run);
    }
    return;
  }
  // partial [B, H, splits, D + 2]: acc, then m and l (an empty split
  // leaves m = -inf, l = 0, acc = 0: weight 0 in the merge)
  float* pp = partial +
              ((static_cast<size_t>(b) * H + h) * gridDim.z + split) * (D + 2);
#pragma unroll
  for (int i = 0; i < kMaxDPerThread; ++i) {
    const int d = tid + i * kThreads;
    if (d < D) pp[d] = acc[i];
  }
  if (tid == 0) {
    pp[D] = m_run;
    pp[D + 1] = l_run;
  }
}

// merge the splits of one (head, sequence): rescale each to the global
// max, in split order. Only the splits that hold tokens of the sequence
// (those before pos / part) are read: a split past them has weight 0, and
// the ring body writes nothing for it.
template <typename TQ>
__global__ void __launch_bounds__(kThreads) merge_splits(
    const float* __restrict__ partial, TQ* __restrict__ out, int H, int D,
    int splits, const int* __restrict__ pos, int pos_all, int span,
    int part) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int ntok = min((pos != nullptr ? pos[b] : pos_all) + 1, span);
  const int used = min(splits, (ntok + part - 1) / part);
  const float* pp =
      partial + (static_cast<size_t>(b) * H + h) * splits * (D + 2);
  float m = -INFINITY;
  for (int s = 0; s < used; ++s) m = fmaxf(m, pp[s * (D + 2) + D]);
  float l = 0.f;
  for (int s = 0; s < used; ++s) {
    const float ms = pp[s * (D + 2) + D];
    if (ms != -INFINITY) l += expf(ms - m) * pp[s * (D + 2) + D + 1];
  }
  TQ* op = out + (static_cast<size_t>(b) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < used; ++s) {
      const float ms = pp[s * (D + 2) + D];
      if (ms != -INFINITY) a += expf(ms - m) * pp[s * (D + 2) + d];
    }
    op[d] = from_f<TQ>(a / l);
  }
}

struct Args {
  const void *q, *kq, *ks, *vq, *vs, *tables, *pos;
  int pos_all;     // every sequence's position when pos is null
  void* out;
  int B, H, Hkv, D, BS, NB;
  long long kv_sn, kv_sh, kv_st, sc_sn, sc_sh, sc_st;
  float scale;
  float* partial;  // [B, H, splits, D + 2] f32 scratch (splits > 1)
  int q_dtype;
};

// split length: a multiple of kSplitRound tokens (so of the first body's
// chunk), chosen from the table width alone (never the batch) so that at
// most kMaxSplits blocks share a row. A shorter split leaves a ring CTA
// little work beyond its start-up (at the decode engine's 64-block tables
// the splits were 64 tokens, 2 chunks a warp).
constexpr int kSplitRound = 256;
inline int split_part(int NB, int BS) {
  const int span = NB * BS;
  const int per = (span + kMaxSplits - 1) / kMaxSplits;
  return ((per + kSplitRound - 1) / kSplitRound) * kSplitRound;
}

// --- the ring body -----------------------------------------------------------
namespace ring {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;         // tokens a warp takes at a time (a chunk)
constexpr int kStages = 3;       // chunks of a warp in its ring
constexpr int kMaxHeads = 4;     // query heads a CTA computes
constexpr int kMaxSmem = 232448; // a CTA's shared memory on an H100

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the bytes a lane reads of a row at once: 16, but 8 of an int8 row (8
// values a lane either way, so q and acc take 8 registers a head)
template <typename TKV>
constexpr int kReadBytes = sizeof(TKV) == 1 ? 8 : 16;

// a lane's bytes of a row -> floats
template <typename TKV>
__device__ __forceinline__ void unpack(const uint8_t* p,
                                       float (&f)[kReadBytes<TKV> /
                                                  sizeof(TKV)]) {
  if constexpr (std::is_same_v<TKV, float>) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else if constexpr (std::is_same_v<TKV, int8_t>) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = static_cast<float>(static_cast<int8_t>(
          ((i < 4 ? w.x : w.y) >> (8 * (i & 3))) & 0xffu));
  } else {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 v;
      if constexpr (std::is_same_v<TKV, __half>)
        v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      else
        v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
}

__device__ __forceinline__ float q_elem(const void* q, int qdt, size_t i) {
  switch (qdt) {
    case kBF16: return to_f(static_cast<const __nv_bfloat16*>(q)[i]);
    case kF16: return to_f(static_cast<const __half*>(q)[i]);
    default: return static_cast<const float*>(q)[i];
  }
}

__device__ __forceinline__ void store_out(void* out, int qdt, size_t i,
                                          float v) {
  switch (qdt) {
    case kBF16:
      static_cast<__nv_bfloat16*>(out)[i] = from_f<__nv_bfloat16>(v);
      break;
    case kF16: static_cast<__half*>(out)[i] = from_f<__half>(v); break;
    default: static_cast<float*>(out)[i] = v;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The shared memory of a CTA: the warps' rings ([kWarps][kStages][K, V]
// [kRows][row bytes]), their scales ([kWarps][kStages][K, V][kRows] f32),
// the warps' probabilities ([kWarps][kRows][kMaxHeads] f32), then the
// split's table entries; the rings are reused for the warps' merge
// ([kWarps][HG][D + 2] f32) once every warp is done.
__host__ __device__ inline size_t ring_bytes(int row_bytes) {
  return static_cast<size_t>(kWarps) * kStages * 2 * kRows * (row_bytes + 4);
}
__host__ __device__ inline size_t smem_bytes(int row_bytes, int tab_n, int hg,
                                             int D) {
  const size_t ring = ring_bytes(row_bytes);
  const size_t merge = static_cast<size_t>(kWarps) * hg * (D + 2) * 4;
  return (ring > merge ? ring : merge) + kWarps * kRows * kMaxHeads * 4 +
         static_cast<size_t>(tab_n) * 4;
}

// LPR lanes read a row (8 values each), so a warp step reads 32 / LPR rows
// and a chunk of kRows rows takes STEPS steps. A lane's scores of its
// STEPS rows are summed over the row's lanes by a reduce-scatter (each
// stage halves the values a lane holds, then plain butterflies): lane l
// ends with the score of row ((l % LPR) / 4) (32 / LPR) + l / LPR, which
// the four lanes l & ~3 .. l | 3 share. Its probability goes to shared
// memory, where every lane reads those of the rows it multiplies into V.
template <typename TKV, int LPR, int HG>
__global__ void __launch_bounds__(kThreads) paged_decode_ring(const Args a,
                                                              int part) {
  constexpr int RW = kReadBytes<TKV>;
  constexpr int EPL = RW / sizeof(TKV);   // values a lane reads of a row
  constexpr int D = LPR * EPL;
  constexpr int RB = LPR * RW;            // row bytes
  constexpr int RPW = 32 / LPR;           // rows a warp step reads
  constexpr int STEPS = kRows / RPW;
  constexpr int PIECES = RB / 16;         // 16-byte copies a row
  static_assert(STEPS >= 1 && kRows % RPW == 0 && LPR / STEPS == 4 &&
                    kRows * PIECES % 32 == 0,
                "rows of >= 64 bytes, chunks of 8 rows");
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.H / a.Hkv, ngrp = G / HG;
  const int hk = blockIdx.x / ngrp, h0 = hk * G + (blockIdx.x % ngrp) * HG;
  const int b = blockIdx.y, split = blockIdx.z;
  const int ntok = min(
      (a.pos != nullptr ? static_cast<const int*>(a.pos)[b] : a.pos_all) + 1,
      a.NB * a.BS);
  const int t0 = split * part, t1 = min(ntok, t0 + part);
  if (t1 <= t0) return;            // no token here: the merge skips the split
  uint8_t* rings = smem;
  float* scales = reinterpret_cast<float*>(
      smem + static_cast<size_t>(kWarps) * kStages * 2 * kRows * RB);
  const size_t body = smem_bytes(RB, 0, HG, D) - kWarps * kRows * kMaxHeads * 4;
  float* probs = reinterpret_cast<float*>(smem + body) +
                 warp * kRows * kMaxHeads;
  int* tab_s = reinterpret_cast<int*>(smem + smem_bytes(RB, 0, HG, D));
  const int* tables = static_cast<const int*>(a.tables);
  const int blk0 = t0 / a.BS;
  if (tables != nullptr) {
    const int n = (t1 - 1) / a.BS - blk0 + 1;
    for (int i = threadIdx.x; i < n; i += kThreads)
      tab_s[i] = tables[static_cast<size_t>(b) * a.NB + blk0 + i];
  }
  __syncthreads();

  // this lane's columns of the G query heads, times scale * log2(e)
  const int d0 = (lane % LPR) * EPL;
  const float qs = a.scale * 1.4426950408889634f;
  float qr[HG][EPL];
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[g][e] = q_elem(a.q, a.q_dtype,
                        (static_cast<size_t>(b) * a.H + h0 + g) * D + d0 + e) *
                 qs;

  const float* ks = static_cast<const float*>(a.ks);
  const float* vs = static_cast<const float*>(a.vs);
  const uint8_t* kbase = static_cast<const uint8_t*>(a.kq);
  const uint8_t* vbase = static_cast<const uint8_t*>(a.vq);
  const int nchunks = t1 > t0 ? (t1 - t0 + kRows - 1) / kRows : 0;
  const int mine = nchunks > warp ? (nchunks - warp + kWarps - 1) / kWarps : 0;
  auto stage_k = [&](int i) {
    return rings + static_cast<size_t>(warp * kStages + i % kStages) * 2 *
                       kRows * RB;
  };
  auto stage_s = [&](int i) {
    return scales + (warp * kStages + i % kStages) * 2 * kRows;
  };
  // the copies of this warp's i-th chunk into its stage (an empty group
  // past the last chunk)
  auto issue = [&](int i) {
    if (i < mine) {
      const int c0 = t0 + (warp + i * kWarps) * kRows;
      const int cnt = min(kRows, t1 - c0);
      long long kvo = 0, sco = 0;
      if (lane < cnt) {
        const int t = c0 + lane, bi = t / a.BS, r = t - bi * a.BS;
        const long long blk =
            tables == nullptr ? b : tab_s[bi - blk0];
        kvo = (blk * a.kv_sn + hk * a.kv_sh + r * a.kv_st) *
              static_cast<long long>(sizeof(TKV));
        sco = blk * a.sc_sn + hk * a.sc_sh + r * a.sc_st;
      }
      uint8_t* kd = stage_k(i);
#pragma unroll
      for (int x = 0; x < kRows * PIECES / 32; ++x) {
        const int id = lane + 32 * x, r = id / PIECES, piece = id % PIECES;
        const long long o = __shfl_sync(kAll, kvo, r) + piece * 16;
        if (r < cnt) {
          cp_async16(kd + r * RB + piece * 16, kbase + o);
          cp_async16(kd + (kRows + r) * RB + piece * 16, vbase + o);
        }
      }
      if (ks != nullptr) {
        const int r = lane & (kRows - 1);
        const long long o = __shfl_sync(kAll, sco, r);
        if (lane < 2 * kRows && r < cnt)
          cp_async4(stage_s(i) + (lane / kRows) * kRows + r,
                    (lane < kRows ? ks : vs) + o);
      }
    }
    cp_async_commit();
  };

  // the row whose score this lane ends with (see above)
  const int my_row = ((lane % LPR) >> 2) * RPW + lane / LPR;
  float m[HG], l[HG], acc[HG][EPL];
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();                  // every lane's copies of chunk i landed
    const uint8_t* kd = stage_k(i);
    const float* sd = stage_s(i);
    const int cnt = min(kRows, t1 - (t0 + (warp + i * kWarps) * kRows));
    // partial dot products of this lane's columns, a row a step
    float v[HG][STEPS];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      float kf[EPL];
      unpack<TKV>(kd + (st * RPW + lane / LPR) * RB + d0 * sizeof(TKV), kf);
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kf[e], dot);
        v[g][st] = dot;
      }
    }
    // reduce-scatter over the row's lanes, then plain butterflies
#pragma unroll
    for (int g = 0; g < HG; ++g) {
#pragma unroll
      for (int n = STEPS, o = LPR / 2; n > 1; n >>= 1, o >>= 1) {
        const bool hi = (lane & o) != 0;
#pragma unroll
        for (int x = 0; x < n / 2; ++x) {
          const float send = hi ? v[g][x] : v[g][x + n / 2];
          const float keep = hi ? v[g][x + n / 2] : v[g][x];
          v[g][x] = keep + __shfl_xor_sync(kAll, send, o);
        }
      }
#pragma unroll
      for (int o = 2; o > 0; o >>= 1)
        v[g][0] += __shfl_xor_sync(kAll, v[g][0], o);
    }
    const bool live = my_row < cnt;
    float pr[kMaxHeads];
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      const float sc = live ? v[g][0] * (ks != nullptr ? sd[my_row] : 1.f)
                            : -INFINITY;
      float cm = sc;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        cm = fmaxf(cm, __shfl_xor_sync(kAll, cm, o));
      const float mn = fmaxf(m[g], cm);
      const float alpha = m[g] == -INFINITY ? 0.f : ex2(m[g] - mn);
      m[g] = mn;
      pr[g] = ex2(sc - mn);
      l[g] = l[g] * alpha + pr[g];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
    if ((lane & 3) == 0) {
      const float vsc = live && vs != nullptr ? sd[kRows + my_row] : 1.f;
#pragma unroll
      for (int g = 0; g < HG; ++g) probs[my_row * kMaxHeads + g] = pr[g] * vsc;
    }
    __syncwarp();
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int r = st * RPW + lane / LPR;
      if (r < cnt) {
        float vf[EPL];
        unpack<TKV>(kd + (kRows + r) * RB + d0 * sizeof(TKV), vf);
        const float4 p4 =
            *reinterpret_cast<const float4*>(probs + r * kMaxHeads);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int g = 0; g < HG; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[g][e] = fmaf(pv[g], vf[e], acc[g][e]);
      }
    }
    __syncwarp();                  // the stage and the probabilities are read
  }
  cp_async_wait<0>();
  // the warp's sums: l over its rows (lanes l & ~3 share a row), acc over
  // its row groups
#pragma unroll
  for (int g = 0; g < HG; ++g) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) l[g] += __shfl_xor_sync(kAll, l[g], o);
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] += __shfl_xor_sync(kAll, acc[g][e], o);
  }
  __syncthreads();                 // every warp is done with the rings
  float* red = reinterpret_cast<float*>(smem);   // [kWarps][HG][D + 2]
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    float* rw = red + (warp * HG + g) * (D + 2);
    if (lane < LPR)
#pragma unroll
      for (int e = 0; e < EPL; ++e) rw[d0 + e] = acc[g][e];
    if (lane == 0) {
      rw[D] = m[g];
      rw[D + 1] = l[g];
    }
  }
  __syncthreads();
  // the warps in a fixed order: rescale each to the CTA's max (an empty
  // warp has m = -inf and weighs 0)
  const int splits = gridDim.z;
  for (int x = threadIdx.x; x < HG * D; x += kThreads) {
    const int g = x / D, d = x % D;
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mt = fmaxf(mt, red[(w * HG + g) * (D + 2) + D]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* rw = red + (w * HG + g) * (D + 2);
      if (rw[D] != -INFINITY) {
        const float f = ex2(rw[D] - mt);
        lt += f * rw[D + 1];
        at += f * rw[d];
      }
    }
    const size_t bh = static_cast<size_t>(b) * a.H + h0 + g;
    if (splits == 1) {
      store_out(a.out, a.q_dtype, bh * D + d, at / lt);
    } else {
      // partial [B, H, splits, D + 2]: acc, then m (natural log, as
      // merge_splits reads it) and l
      float* pp = a.partial + (bh * splits + split) * (D + 2);
      pp[d] = at;
      if (d == 0) {
        pp[D] = mt * 0.6931471805599453f;
        pp[D + 1] = lt;
      }
    }
  }
}

template <typename TKV, int LPR, int HG>
int launch(const Args& a, int part, int splits, cudaStream_t s) {
  constexpr int RB = LPR * kReadBytes<TKV>;
  constexpr int D = RB / static_cast<int>(sizeof(TKV));
  const int tab_n = a.tables != nullptr ? part / a.BS + 2 : 0;
  const size_t smem = smem_bytes(RB, tab_n, HG, D);
  constexpr auto K = paged_decode_ring<TKV, LPR, HG>;
  if (smem > 48 * 1024)
    if (const int e = smem_opt_in<K>(kMaxSmem)) return e;
  const dim3 grid(a.Hkv * (a.H / a.Hkv) / HG, a.B, splits);
  K<<<grid, kThreads, smem, s>>>(a, part);
  return 0;
}

template <typename TKV, int LPR>
int launch_hg(const Args& a, int part, int splits, cudaStream_t s) {
  return (a.H / a.Hkv) % kMaxHeads == 0
             ? launch<TKV, LPR, kMaxHeads>(a, part, splits, s)
             : launch<TKV, LPR, 1>(a, part, splits, s);
}

// the row's lanes: 4 (rows of 64 bytes or more), 8, 16 or 32
template <typename TKV>
int launch_lpr(const Args& a, int part, int splits, cudaStream_t s) {
  switch (a.D * static_cast<int>(sizeof(TKV)) / kReadBytes<TKV>) {
    case 4:
      if constexpr (4 * kReadBytes<TKV> >= 64)
        return launch_hg<TKV, 4>(a, part, splits, s);
      break;
    case 8: return launch_hg<TKV, 8>(a, part, splits, s);
    case 16: return launch_hg<TKV, 16>(a, part, splits, s);
    case 32: return launch_hg<TKV, 32>(a, part, splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// what the ring body admits: rows of 64-512 bytes that are 4, 8, 16 or 32
// lanes' reads (int8 rows 64-256 bytes), 16-byte aligned rows, a query
// dtype it writes
bool admits(const Args& a, int kv_dtype) {
  const int elt = kv_dtype == kF32 ? 4 : kv_dtype == kI8 ? 1 : 2;
  const int rb = a.D * elt, lanes = rb / (elt == 1 ? 8 : 16);
  if (rb % 64 != 0 || (lanes != 4 && lanes != 8 && lanes != 16 &&
                       lanes != 32) || rb < 64)
    return false;
  auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  return al(a.kq) && al(a.vq) && (a.kv_sn * elt) % 16 == 0 &&
         (a.kv_sh * elt) % 16 == 0 && (a.kv_st * elt) % 16 == 0 &&
         a.q_dtype >= kF32 && a.q_dtype <= kF16;
}

int dispatch(const Args& a, int kv_dtype, int part, int splits,
             cudaStream_t s) {
  switch (kv_dtype) {
    case kF32: return launch_lpr<float>(a, part, splits, s);
    case kBF16: return launch_lpr<__nv_bfloat16>(a, part, splits, s);
    case kF16: return launch_lpr<__half>(a, part, splits, s);
    case kI8: return launch_lpr<int8_t>(a, part, splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ring

template <typename TQ, typename TKV>
void launch(const Args& a, int part, int splits, cudaStream_t s) {
  const size_t smem = 2 * kChunk * sizeof(long long) +
                      (a.D + 3 * kChunk) * sizeof(float);
  dim3 grid(a.H, a.B, splits);
  paged_decode<TQ, TKV><<<grid, kThreads, smem, s>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kq),
      static_cast<const float*>(a.ks), static_cast<const TKV*>(a.vq),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.pos), a.pos_all, static_cast<TQ*>(a.out),
      a.H, a.Hkv, a.D, a.BS, a.NB, a.kv_sn, a.kv_sh, a.kv_st, a.sc_sn,
      a.sc_sh, a.sc_st, a.scale, part, a.partial);
}

template <typename TQ>
int dispatch_kv(const Args& a, int kv_dtype, int part, int splits,
                cudaStream_t s) {
  switch (kv_dtype) {
    case kF32: launch<TQ, float>(a, part, splits, s); break;
    case kBF16: launch<TQ, __nv_bfloat16>(a, part, splits, s); break;
    case kF16: launch<TQ, __half>(a, part, splits, s); break;
    case kI8: launch<TQ, int8_t>(a, part, splits, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename TQ>
void merge(const Args& a, int splits, int part, cudaStream_t s) {
  merge_splits<TQ><<<dim3(a.H, a.B), kThreads, 0, s>>>(
      a.partial, static_cast<TQ*>(a.out), a.H, a.D, splits,
      static_cast<const int*>(a.pos), a.pos_all, a.NB * a.BS, part);
}

}  // namespace

// route: 0 the first body (`paged_decode`), 1 the ring body
// (`paged_decode_ring`); an asked-for body that its inputs do not fit is
// refused (cudaErrorInvalidValue). pos: [B] int32, or null with
// pos_all every sequence's position; tables null: sequence b reads block b.
// dims = {B, H, Hkv, D, BS, NB, the pool's element strides (n, h, t), the
// scales' (n, h, t), q dtype, kv dtype, route, pos_all}: the sizes travel
// packed, as one pointer, because a call's host time is part of its cost.
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* tables, const void* pos, void* out,
    void* partial, const long long* dims, float scale, void* stream) {
  const int B = static_cast<int>(dims[0]), H = static_cast<int>(dims[1]);
  const int Hkv = static_cast<int>(dims[2]), D = static_cast<int>(dims[3]);
  const int BS = static_cast<int>(dims[4]), NB = static_cast<int>(dims[5]);
  const int q_dtype = static_cast<int>(dims[12]);
  const int kv_dtype = static_cast<int>(dims[13]);
  const int route = static_cast<int>(dims[14]);
  if (D > kThreads * kMaxDPerThread || Hkv <= 0 || H % Hkv != 0 ||
      route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int part = split_part(NB, BS);
  const int splits = (NB * BS + part - 1) / part;
  if (partial == nullptr && splits > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,        kq,       ks,       vq,
               vs,       tables,   pos,      static_cast<int>(dims[15]),
               out,      B,        H,        Hkv,
               D,        BS,       NB,       dims[6],
               dims[7],  dims[8],  dims[9],  dims[10],
               dims[11], scale,    static_cast<float*>(partial),
               q_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (route != 0) {
    if (!ring::admits(a, kv_dtype))
      return static_cast<int>(cudaErrorInvalidValue);
    err = ring::dispatch(a, kv_dtype, part, splits, s);
  } else {
    switch (q_dtype) {
      case kF32: err = dispatch_kv<float>(a, kv_dtype, part, splits, s); break;
      case kBF16:
        err = dispatch_kv<__nv_bfloat16>(a, kv_dtype, part, splits, s);
        break;
      case kF16: err = dispatch_kv<__half>(a, kv_dtype, part, splits, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (err != 0) return err;
  if (splits > 1) {
    switch (q_dtype) {
      case kF32: merge<float>(a, splits, part, s); break;
      case kBF16: merge<__nv_bfloat16>(a, splits, part, s); break;
      case kF16: merge<__half>(a, splits, part, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// entries the caller's scratch must hold: B * H * splits * (D + 2) floats
extern "C" int ptt_paged_decode_splits(int NB, int BS) {
  const int part = split_part(NB, BS);
  return (NB * BS + part - 1) / part;
}
