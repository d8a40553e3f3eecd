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
// ((pos + 1) rows of K and V per KV head), at 3.35 TB/s; the arithmetic
// is ~1 FMA per byte. The design follows:
//   * one block per (head, sequence, token split), no sequential grid:
//     the block loads its own pos[b] and table row and loops over its
//     split's tokens in chunks of 64. Splitting each sequence's tokens
//     over up to 16 blocks (flash-decoding) keeps the card full at small
//     batch; a second small kernel merges the splits' (m, l, acc) in a
//     fixed order. The split length depends only on the table width, never
//     on the batch, so a sequence's result is the same in any batch;
//   * early stop at pos[b]: table entries past the last used block (they
//     point at reserved block 0) are never read, and no token past pos[b]
//     is loaded, so no mask is needed inside a chunk;
//   * the pool is addressed by element strides (n, h, t) with a unit
//     stride along D, so the engine passes a permuted view of its
//     [N, BS, Hkv, D] pool without copying it;
//   * per chunk each warp computes 16 scores at once (16 independent row
//     loads in flight per lane), then every thread owns one or more D
//     columns of the PV accumulation.
// Simple first: no vectorised or TMA loads, and the GQA query heads of one
// KV head each re-read its rows (from L2).
// NaN guard: block 0 of a live sequence holds position 0 <= pos, so the
// running max is finite after the first chunk; the first chunk's rescale
// factor is taken as 0 instead of exp(-inf - -inf).
#include <math.h>

#include "common.cuh"

namespace {

using namespace ptt;

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
    const int* __restrict__ pos, TQ* __restrict__ out, int H, int Hkv, int D,
    int BS, int NB, long long kv_sn, long long kv_sh, long long kv_st,
    long long sc_sn, long long sc_sh, long long sc_st, float scale,
    int part, float* __restrict__ partial) {
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
  const int ntok = min(pos[b] + 1, NB * BS);
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
// max, in split order
template <typename TQ>
__global__ void __launch_bounds__(kThreads) merge_splits(
    const float* __restrict__ partial, TQ* __restrict__ out, int H, int D,
    int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* pp =
      partial + (static_cast<size_t>(b) * H + h) * splits * (D + 2);
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pp[s * (D + 2) + D]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ms = pp[s * (D + 2) + D];
    if (ms != -INFINITY) l += expf(ms - m) * pp[s * (D + 2) + D + 1];
  }
  TQ* op = out + (static_cast<size_t>(b) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ms = pp[s * (D + 2) + D];
      if (ms != -INFINITY) a += expf(ms - m) * pp[s * (D + 2) + d];
    }
    op[d] = from_f<TQ>(a / l);
  }
}

struct Args {
  const void *q, *kq, *ks, *vq, *vs, *tables, *pos;
  void* out;
  int B, H, Hkv, D, BS, NB;
  long long kv_sn, kv_sh, kv_st, sc_sn, sc_sh, sc_st;
  float scale;
  float* partial;  // [B, H, splits, D + 2] f32 scratch (splits > 1)
};

// split length: a multiple of the chunk, chosen from the table width
// alone (never the batch) so that at most kMaxSplits blocks share a row
inline int split_part(int NB, int BS) {
  const int span = NB * BS;
  const int per = (span + kMaxSplits - 1) / kMaxSplits;
  return ((per + kChunk - 1) / kChunk) * kChunk;
}

template <typename TQ, typename TKV>
void launch(const Args& a, cudaStream_t s) {
  const size_t smem = 2 * kChunk * sizeof(long long) +
                      (a.D + 3 * kChunk) * sizeof(float);
  const int part = split_part(a.NB, a.BS);
  const int splits = (a.NB * a.BS + part - 1) / part;
  dim3 grid(a.H, a.B, splits);
  paged_decode<TQ, TKV><<<grid, kThreads, smem, s>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kq),
      static_cast<const float*>(a.ks), static_cast<const TKV*>(a.vq),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.pos), static_cast<TQ*>(a.out), a.H, a.Hkv,
      a.D, a.BS, a.NB, a.kv_sn, a.kv_sh, a.kv_st, a.sc_sn, a.sc_sh, a.sc_st,
      a.scale, part, a.partial);
  if (splits > 1)
    merge_splits<TQ><<<dim3(a.H, a.B), kThreads, 0, s>>>(
        a.partial, static_cast<TQ*>(a.out), a.H, a.D, splits);
}

template <typename TQ>
int dispatch_kv(const Args& a, int kv_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case kF32: launch<TQ, float>(a, s); break;
    case kBF16: launch<TQ, __nv_bfloat16>(a, s); break;
    case kF16: launch<TQ, __half>(a, s); break;
    case kI8: launch<TQ, int8_t>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" int ptt_paged_decode_attention(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* tables, const void* pos, void* out, int B,
    int H, int Hkv, int D, int BS, int NB, long long kv_sn, long long kv_sh,
    long long kv_st, long long sc_sn, long long sc_sh, long long sc_st,
    int q_dtype, int kv_dtype, float scale, void* partial, void* stream) {
  if (D > kThreads * kMaxDPerThread || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (partial == nullptr && split_part(NB, BS) < NB * BS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     kq,    ks,    vq,    vs,    tables, pos,   out,
               B,     H,     Hkv,   D,     BS,    NB,     kv_sn, kv_sh,
               kv_st, sc_sn, sc_sh, sc_st, scale,
               static_cast<float*>(partial)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (q_dtype) {
    case kF32: err = dispatch_kv<float>(a, kv_dtype, s); break;
    case kBF16: err = dispatch_kv<__nv_bfloat16>(a, kv_dtype, s); break;
    case kF16: err = dispatch_kv<__half>(a, kv_dtype, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// entries the caller's scratch must hold: B * H * splits * (D + 2) floats
extern "C" int ptt_paged_decode_splits(int NB, int BS) {
  const int part = split_part(NB, BS);
  return (NB * BS + part - 1) / part;
}
