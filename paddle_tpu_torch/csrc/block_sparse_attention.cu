// Block-sparse flash attention forward on [BH, S, D] tensors.
//
// Replaces paddle_tpu/ops/pallas/block_sparse_attention.py `_bs_fwd_kernel`
// (reached through `_bs_pallas`). Query block qi (128 rows) attends the
// key blocks block_idx[qi, 0 .. block_cnt[qi]) (128 rows each):
//   O = softmax(q . k^T * scale) V over the listed blocks' keys only,
// an online softmax (m, l, acc in f32) across the blocks, p cast to the
// input type before the PV product, O = acc / max(l, 1e-30). A query
// block with block_cnt = 0 writes O = 0.
//
// What bounds it on an H100: the operations, 4 * BH * (listed tiles) *
// 128^2 * D on the bf16 tensor cores; the bytes (q, k, v, o once each)
// are a fraction of that time at D = 64. The design:
//   * grid (BH, nq), one CTA of 8 warps per (b*h, query block): each warp
//     owns 16 of the 128 rows (one m16n8k16 tile high), so each K/V tile
//     in shared memory serves all 128 rows. The TPU kernel kept the whole
//     of K and V of one (b, h) in VMEM; here the listed blocks stream
//     through shared memory, 64 key rows a step (32 at D = 256);
//   * load imbalance: a global query block lists every key block, a
//     window row a handful. The CTAs take their query blocks in order of
//     decreasing count (each CTA ranks the counts itself), so the longest
//     rows start first and the short ones fill the tail. On an H100 at
//     BigBird's tables this takes a quarter off grid order's time at
//     D = 64 and two fifths at D = 128 (PERF.md, port_ab.py);
//   * the products, the softmax, the f32 path and the output stores are
//     flash_fwd's (csrc/flash_attention.cu, attention_tiles.cuh) without
//     the causal mask: every key of a listed block is live.
// This body (`bs_fwd`, route 0) loads synchronously, multiplies with
// mma.sync and prefetches no K/V; it takes f32, and bf16 at head-dim tiles
// 32 and 256. bf16 at 32 < D <= 128 (D % 8 == 0, 16-byte aligned bases)
// runs route 1, `bs_fwd_sm90` in block_sparse_sm90.cu: the flash
// forward's Hopper body under the BlockTable policy (see its note). An
// entry asked for route 1 on inputs it does not admit returns
// cudaErrorInvalidValue.
// A listed block index outside [0, S / 128) is skipped (the tables of
// csr_to_block_tables never hold one).
#include "attention_tiles.cuh"

namespace ptt {
// route 1 (block_sparse_sm90.cu): q, k, v, out contiguous [BH, S, D] bf16,
// scratch int32 [S / 128 + 1]
int block_sparse_sm90(const void* q, const void* k, const void* v,
                      const int* idx, const int* cnt, void* out,
                      int* scratch, int BH, int S, int D, int max_nb,
                      float scale, cudaStream_t s);
}  // namespace ptt

namespace {

using namespace ptt;
using namespace ptt::attn;

constexpr int kBsWarps = 8;
constexpr int kBsThreads = kBsWarps * 32;
constexpr int kBsRows = kBsWarps * kRows;  // 128: a query (and key) block

struct BsParams {
  const void* q;
  const void* k;
  const void* v;
  const int* idx;  // [nq, max_nb]
  const int* cnt;  // [nq]
  void* out;
  int BH, S, D, nq, max_nb;
  float scale;
  int vec;         // 16-byte loads allowed (alignment and D)
};

template <typename T, int DP>
struct BsCfg {
  static constexpr int BK = DP == 256 ? 32 : 64;  // key rows per step
  static constexpr int LD = DP + Pad<T>::v;
  static constexpr int LDP = BK + Pad<T>::v;
  static constexpr size_t smem =
      sizeof(T) * (static_cast<size_t>(kBsRows + 2 * BK) * LD +
                   kBsWarps * kRows * LDP);
};

// This CTA's query block: the blockIdx.y-th in order of decreasing count,
// ties by index (the ranks are a permutation of 0 .. nq - 1).
__device__ __forceinline__ int heavy_first(const int* __restrict__ cnt,
                                           int nq) {
  __shared__ int qi_s;
  for (int j = threadIdx.x; j < nq; j += kBsThreads) {
    const int cj = cnt[j];
    int rank = 0;
    for (int i = 0; i < nq; ++i) {
      const int ci = cnt[i];
      rank += ci > cj || (ci == cj && i < j);
    }
    if (rank == static_cast<int>(blockIdx.y)) qi_s = j;
  }
  __syncthreads();
  return qi_s;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kBsThreads) bs_fwd(const BsParams p) {
  using C = BsCfg<T, DP>;
  constexpr int BK = C::BK, LD = C::LD, LDP = C::LDP;
  constexpr int NO = DP / 8, NS = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBsRows * LD;
  T* Vs = Ks + BK * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* Ps = Vs + BK * LD + warp * kRows * LDP;
  const int qi = heavy_first(p.cnt, p.nq);
  const int q0 = qi * kBsRows;
  const size_t base = static_cast<size_t>(blockIdx.x) * p.S * p.D;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;

  load_tile<T, kBsRows, DP, LD, kBsThreads>(Qs, q, p.D, q0, p.S, p.D, p.vec);
  const int r_lo = q0 + warp * kRows + g;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float acc[NO][4];
  zero(acc);
  const int n = p.cnt[qi], nk = p.S / kBsRows;
  const int* row = p.idx + static_cast<size_t>(qi) * p.max_nb;
  for (int j = 0; j < n; ++j) {
    const int blk = row[j];
    if (blk < 0 || blk >= nk) continue;  // the same for every thread
    for (int k0 = blk * kBsRows; k0 < (blk + 1) * kBsRows; k0 += BK) {
      __syncthreads();  // the last step's K/V are read
      load_tile<T, BK, DP, LD, kBsThreads>(Ks, k, p.D, k0, p.S, p.D, p.vec);
      load_tile<T, BK, DP, LD, kBsThreads>(Vs, v, p.D, k0, p.S, p.D, p.vec);
      __syncthreads();
      float s[NS][4];
      zero(s);
      warp_mma<NS, DP, true>(s, Qs + warp * kRows * LD, LD, Ks, LD);
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int nn = 0; nn < NS; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nn][e] *= p.scale;
          if (e < 2) mx_lo = fmaxf(mx_lo, s[nn][e]);
          else mx_hi = fmaxf(mx_hi, s[nn][e]);
        }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float c_lo = __expf(m_lo - mn_lo), c_hi = __expf(m_hi - mn_hi);
      float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
      for (int nn = 0; nn < NS; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = __expf(s[nn][e] - (e < 2 ? mn_lo : mn_hi));
          if (e < 2) rs_lo += pv;
          else rs_hi += pv;
          Ps[(g + (e < 2 ? 0 : 8)) * LDP + nn * 8 + 2 * t + (e & 1)] =
              from_f<T>(pv);
        }
      // l per lane (its share of the row), summed over the quad at the end
      l_lo = l_lo * c_lo + rs_lo;
      l_hi = l_hi * c_hi + rs_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int nn = 0; nn < NO; ++nn) {
        acc[nn][0] *= c_lo;
        acc[nn][1] *= c_lo;
        acc[nn][2] *= c_hi;
        acc[nn][3] *= c_hi;
      }
      __syncwarp();
      warp_mma<NO, BK, false>(acc, Ps, LDP, Vs, LD);
      __syncwarp();
    }
  }
  l_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  l_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  store_rows<T, NO>(static_cast<T*>(p.out) + base, acc, 0, 0, r_lo, 0, p.S,
                    1, p.D, l_lo, l_hi);
}

template <typename T, int DP>
int launch(const BsParams& p, cudaStream_t s) {
  constexpr size_t smem = BsCfg<T, DP>::smem;
  if (smem > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t e = cudaFuncSetAttribute(
        bs_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bs_fwd<T, DP><<<dim3(p.BH, p.nq), kBsThreads, smem, s>>>(p);
  return 0;
}

template <typename T>
int dispatch_d(const BsParams& p, cudaStream_t s) {
  if (p.D <= 32) return launch<T, 32>(p, s);
  if (p.D <= 64) return launch<T, 64>(p, s);
  if (p.D <= 128) return launch<T, 128>(p, s);
  return launch<T, 256>(p, s);
}

}  // namespace

// q, k, v, out: contiguous [BH, S, D] of one dtype (0 f32, 1 bf16), S a
// multiple of 128, D <= 256; idx [S / 128, max_nb], cnt [S / 128] int32.
// route 0: bs_fwd (mma.sync); 1: bs_fwd_sm90 (bf16, 32 < D <= 128, D % 8
// == 0, 16-byte aligned q, k, v, out, scale > 0), which takes scratch,
// int32 [S / 128 + 1].
extern "C" int ptt_block_sparse_attention(const void* q, const void* k,
                                          const void* v, const void* idx,
                                          const void* cnt, void* out,
                                          void* scratch, int BH, int S, int D,
                                          int max_nb, int dtype, int route,
                                          float scale, void* stream) {
  if (BH < 1 || S < kBsRows || S % kBsRows || D < 1 || D > 256 ||
      max_nb < 1 || S / kBsRows > 65535 || route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != kBF16 || D <= 32 || D > 128 || D % 8 || !(scale > 0.f) ||
        !scratch || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
        !aligned16(out))
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = ptt::block_sparse_sm90(
        q, k, v, static_cast<const int*>(idx), static_cast<const int*>(cnt),
        out, static_cast<int*>(scratch), BH, S, D, max_nb, scale, s);
    return err != 0 ? err : static_cast<int>(cudaGetLastError());
  }
  BsParams p{q,  k,  v,  static_cast<const int*>(idx),
             static_cast<const int*>(cnt), out, BH, S, D, S / kBsRows,
             max_nb, scale, 0};
  int err;
  switch (dtype) {
    case kF32:
      p.vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
      err = dispatch_d<float>(p, s);
      break;
    case kBF16:
      p.vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
      err = dispatch_d<__nv_bfloat16>(p, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
