// Block-sparse flash attention forward on the Hopper bodies: route 1 of
// ptt_block_sparse_attention (block_sparse_attention.cu), bf16 q, k, v
// [BH, S, D] at 32 < D <= 128.
//
// Replaces, with route 0, paddle_tpu/ops/pallas/block_sparse_attention.py
// `_bs_fwd_kernel` (reached through `_bs_pallas`): query block qi (128
// rows) attends the key blocks block_idx[qi, 0 .. block_cnt[qi]), an
// online softmax in f32, p cast to bf16 before PV, O = acc / max(l,
// 1e-30), a query block that lists nothing O = 0, an index outside
// [0, S / 128) skipped.
//
// What bounds it on an H100: the operations, 4 BH (listed tiles) 128^2 D
// on the bf16 tensor cores. The design: the flash forward's Hopper body
// (csrc/attention_sm90.cuh: persistent CTAs, TMA-fed wgmma, P in
// registers, two CTAs an SM at D = 64) under the BlockTable policy, which
// streams only the listed blocks (see its note there). Its work list is
// not a static grid order: a pre-pass (`bs_order`) ranks the query tiles
// by their counts on the device (no host sync) and zeroes a counter from
// which each CTA's producer takes the next unit (head, tile), longest
// rows first across all heads, whichever CTA is free. A tile's output
// depends only on its own rows and listed blocks, never on the CTA that
// runs it or when.
#include "attention_sm90.cuh"

namespace {

using namespace ptt;
using namespace ptt::sm90;
using namespace ptt::attn90;

template <int DP>
__global__ void __launch_bounds__(HopCfg<DP>::THREADS, HopCfg<DP>::CTAS)
    bs_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const FwdArgs a,
                const Units units, const BlockTable bt) {
  fwd_sm90_body<DP>(tq, tk, tv, a, units, NoDropout(), bt);
}

// The work list of bs_fwd_sm90: order[r] = the query tile of rank r, the
// tiles by decreasing count (ties by index: the ranks are a permutation of
// 0 .. nq - 1), and the counter of units taken set to 0. One CTA.
__global__ void __launch_bounds__(1024)
    bs_order(const int* __restrict__ cnt, int nq, int* __restrict__ order,
             int* __restrict__ next) {
  for (int j = threadIdx.x; j < nq; j += blockDim.x) {
    const int cj = cnt[j];
    int rank = 0;
    for (int i = 0; i < nq; ++i) {
      const int ci = cnt[i];
      rank += ci > cj || (ci == cj && i < j);
    }
    order[rank] = j;
  }
  if (threadIdx.x == 0) *next = 0;
}

}  // namespace

namespace ptt {

// q, k, v, out contiguous [BH, S, D] bf16 as [B = BH, S, H = 1, D];
// scratch: int32 [nq + 1] (the order, then the counter)
int block_sparse_sm90(const void* q, const void* k, const void* v,
                      const int* idx, const int* cnt, void* out,
                      int* scratch, int BH, int S, int D, int max_nb,
                      float scale, cudaStream_t s) {
  const int nq = S / 128;
  bs_order<<<1, 1024, 0, s>>>(cnt, nq, scratch, scratch + nq);
  const void* const qkv[3] = {q, k, v};
  const long long st[3] = {static_cast<long long>(S) * D, D, D};
  const long long strides[3][3] = {
      {st[0], st[1], st[2]}, {st[0], st[1], st[2]}, {st[0], st[1], st[2]}};
  const FwdArgs a{out, nullptr, S, 1, D, scale, 0};
  const BlockTable bt{idx, cnt, scratch, scratch + nq, max_nb, BH, BH * nq};
  return launch_fwd_sm90<bs_fwd_sm90<64>, bs_fwd_sm90<128>, false, true>(
      qkv, strides, BH, a, s, bt);
}

}  // namespace ptt
