// Batched gather LoRA product (BGMV): every sequence of a batch applies its
// own low-rank adapter in one call,
//   delta[b, s, :] = (x[b, s, :] @ A[ids[b]]) @ B[ids[b]],
// with f32 accumulation and an f32 [batch, s, d_out] result.
//
// Replaces paddle_tpu/ops/pallas/bgmv.py `_kernel` (reached through
// `lora_delta`, pallas_call at :107).
//
// Layouts: x [batch, s, d_in] f32 or bf16, rows read through the strides
// (sxb, sxs) with the last dim contiguous; A [slots, d_in, r] and
// B [slots, r, d_out] f32 contiguous slot stacks (slot 0 all zeros, B
// pre-scaled by alpha/r); ids [batch] int32; h [batch, s, r] f32 scratch;
// out [batch, s, d_out] f32.
//
// What bounds it on an H100: bytes. At decode (s = 1) each distinct slot
// of the batch reads d_in*r + r*d_out f32 values for 2*b*r*(d_in + d_out)
// operations, about half an operation per byte. Two bodies (the wrapper's
// route, ops/bgmv.py `bgmv_route`):
//
// The decode step (s = 1): one launch, bgmv_cluster. A thread block
// cluster of KC CTAs (8, or 16 as a non-portable size) takes a sequence,
// so a batch of 8 runs 8 KC CTAs where one CTA a sequence left 124 of the
// 132 SMs idle, each streaming a 256 KB block alone. KC and the cuts of
// d_in and d_out are a pure function of (d_in, r, d_out), chosen by the
// wrapper (`bgmv_cluster_plan`):
//   * shrink: CTA k streams its d_in / KC rows of the slot's A with 16-byte
//     loads, eight steps in flight a thread, and adds its threads'
//     partials of h [r] in shared memory by a tree of fixed shape;
//   * exchange: after a cluster barrier every CTA gathers the KC
//     partials through distributed shared memory (one remote read a
//     thread) and adds them in rank order 0..KC-1, so every CTA holds the
//     same bits of h;
//   * expand: CTA k forms its d_out / KC columns of h @ B[slot], four
//     columns a thread (16-byte loads where d_out % 4 == 0), each summed
//     over r in order.
// h never leaves the cluster. The cluster barrier's second half, before a
// CTA exits, keeps every CTA's partials alive until the others have read
// them.
//
// Other shapes (s > 1: a prefill chunk with an id per sequence) keep the
// two launches of Punica's shrink-then-expand, kept simple:
//   * shrink: one CTA per (b, tile of s rows) forms h = x @ A[ids[b]]. The
//     slot's A block is read as one flat array of d_in*r floats, 16 bytes
//     a thread when r % 4 == 0, consecutive threads on consecutive
//     addresses, several steps' loads in flight per thread. A thread's r
//     offset is the same at every step, so it keeps one accumulator per
//     (row, r) it owns; the partial sums of the thread groups that share
//     an r are then added in shared memory by a pairwise tree of fixed
//     shape.
//   * expand: one CTA per (b, tile of s rows, 256 columns of d_out) forms
//     h @ B[ids[b]], one column a thread, summed over r in order.
// Only the slots the batch references leave device memory. There are no
// atomics, and the cluster body's split of h's sum across CTAs is added in
// a fixed order: each output row is reduced in an order fixed by the shape
// (d_in, r, d_out) alone, so its bits do not depend on its batchmates or on
// the batch size (the decode engine's row-stability contract). Slot 0
// rows are computed like any other (zeros in, zeros out). An id outside
// [0, slots) gives a NaN row, never a stray read.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int kShrinkThreads = 512;
constexpr int kExpandThreads = 256;  // one output column each

template <int VW>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float o[1]) {
    o[0] = *p;
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float o[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

// h[b, s0 + i, :] = x[b, s0 + i, :] @ A[slot] for i < ROWS.
// The flat A block holds q = r / VW vectors per d; `active` threads (a
// multiple of q) take vectors t, t + active, ...: thread t keeps r0 =
// (t % q) * VW and visits d = t / q, t / q + G, ... with G = active / q.
template <typename T, int VW, int ROWS>
__global__ void __launch_bounds__(kShrinkThreads)
    bgmv_shrink(const T* __restrict__ x, long long sxb, long long sxs,
                const float* __restrict__ A, const int* __restrict__ ids,
                float* __restrict__ h, int s, int d_in, int r, int slots) {
  __shared__ float part[kShrinkThreads * 4];  // [G][r] of one row
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, s - s0);
  const int slot = ids[b];
  float* hrow = h + (static_cast<size_t>(b) * s + s0) * r;
  if (slot < 0 || slot >= slots) {  // CTA-uniform: no barrier is skipped
    for (int i = threadIdx.x; i < nrows * r; i += blockDim.x)
      hrow[i] = nanf("");
    return;
  }
  const int q = r / VW;
  const int active = (kShrinkThreads / q) * q;
  const int G = active / q;
  const int t = threadIdx.x;
  const int g = t / q, r0 = (t % q) * VW;
  const float* a = A + static_cast<size_t>(slot) * d_in * r;
  const T* xb = x + static_cast<size_t>(b) * sxb + static_cast<size_t>(s0) * sxs;

  float acc[ROWS][VW];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[i][v] = 0.f;

  if (t < active) {
    // U steps' loads are issued before their FMAs, so 512 threads keep
    // U x 16 bytes each in flight. The sum still runs over d in ascending
    // order per thread.
    constexpr int U = 4;
    for (int d0 = g; d0 < d_in; d0 += U * G) {
      float av[U][VW];
      float xv[U][ROWS];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = d0 + u * G;
        if (d < d_in) {
          Vec<VW>::load(a + static_cast<size_t>(d) * r + r0, av[u]);
#pragma unroll
          for (int i = 0; i < ROWS; ++i)  // a ragged row tile re-reads
            xv[u][i] = to_f(               // its last row; not stored
                xb[static_cast<size_t>(min(i, nrows - 1)) * sxs + d]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (d0 + u * G < d_in) {
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
#pragma unroll
            for (int v = 0; v < VW; ++v)
              acc[i][v] = fmaf(xv[u][i], av[u][v], acc[i][v]);
        }
      }
    }
  }
  // per row: the G groups' partials -> shared memory -> a pairwise tree
  // whose shape depends on G alone (fixed order, no atomics)
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (i >= nrows) break;  // CTA-uniform
    if (t < active) {
#pragma unroll
      for (int v = 0; v < VW; ++v) part[g * r + r0 + v] = acc[i][v];
    }
    __syncthreads();
    for (int n = G; n > 1;) {
      const int half = (n + 1) / 2;
      for (int k = t; k < (n - half) * r; k += blockDim.x)
        part[k] += part[k + half * r];
      __syncthreads();
      n = half;
    }
    for (int c = t; c < r; c += blockDim.x)
      hrow[static_cast<size_t>(i) * r + c] = part[c];
    __syncthreads();
  }
}

// out[b, s0 + i, o] = h[b, s0 + i, :] @ B[slot][:, o] for i < ROWS.
template <int ROWS>
__global__ void __launch_bounds__(kExpandThreads)
    bgmv_expand(const float* __restrict__ h, const float* __restrict__ B,
                const int* __restrict__ ids, float* __restrict__ out, int s,
                int r, int d_out, int slots) {
  __shared__ float hs[ROWS * 128];  // r <= 128
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, s - s0);
  const int o = blockIdx.x * kExpandThreads + threadIdx.x;
  const int slot = ids[b];
  const float* hrow = h + (static_cast<size_t>(b) * s + s0) * r;
  for (int i = threadIdx.x; i < nrows * r; i += blockDim.x) hs[i] = hrow[i];
  __syncthreads();
  if (o >= d_out) return;
  float* orow = out + (static_cast<size_t>(b) * s + s0) * d_out + o;
  if (slot < 0 || slot >= slots) {
    for (int i = 0; i < nrows; ++i) orow[static_cast<size_t>(i) * d_out] = nanf("");
    return;
  }
  const float* bcol = B + static_cast<size_t>(slot) * r * d_out + o;
  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;
#pragma unroll 8
  for (int k = 0; k < r; ++k) {
    const float bv = bcol[static_cast<size_t>(k) * d_out];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      acc[i] = fmaf(hs[min(i, nrows - 1) * r + k], bv, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    if (i < nrows) orow[static_cast<size_t>(i) * d_out] = acc[i];
}

// --- the decode step: one cluster of KC CTAs a sequence ---------------------
constexpr int kClusterThreads = 256;
constexpr int kMaxClusterRank = 128;   // h [r] of the cluster body
constexpr int kMaxCluster = 16;

// the two halves of a cluster barrier: arrive (release: this thread's
// shared-memory accesses, remote ones included, are done) and wait
// (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// out[b, 0, :] = (x[b, 0, :] @ A[slot]) @ B[slot] for the cluster of
// sequence b (grid: KC x batch, clusters of KC along x). CTA k owns rows
// [k rows_per, (k + 1) rows_per) of d_in and columns [k cols_per, (k + 1)
// cols_per) of d_out (cols_per a multiple of 4). VW: A's vector width (4
// where r % 4 == 0); VO: B's (4 where d_out % 4 == 0).
template <typename T, int VW, int VO>
__global__ void __launch_bounds__(kClusterThreads)
    bgmv_cluster(const T* __restrict__ x, long long sxb,
                 const float* __restrict__ A, const float* __restrict__ B,
                 const int* __restrict__ ids, float* __restrict__ out,
                 int d_in, int r, int d_out, int slots, int rows_per,
                 int cols_per) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ __align__(16) float part[kClusterThreads * 4];  // [G][r]
  __shared__ float gat[kMaxCluster * kMaxClusterRank];       // [KC][r]
  __shared__ float hs[kMaxClusterRank];
  const int kc = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int slot = ids[b];
  const int o0 = k * cols_per;
  const int o1 = min(d_out, o0 + cols_per);
  float* orow = out + static_cast<size_t>(b) * d_out;
  if (slot < 0 || slot >= slots) {  // cluster-uniform: no barrier skipped
    for (int o = o0 + t; o < o1; o += kClusterThreads) orow[o] = nanf("");
    return;
  }

  // shrink: the thread's r offset r0 is fixed, its rows d0 + g, + G, ...
  // summed in ascending order
  const int q = r / VW;
  const int active = (kClusterThreads / q) * q;
  const int G = active / q;
  const int g = t / q, r0 = (t % q) * VW;
  const int d0 = k * rows_per, d1 = min(d_in, d0 + rows_per);
  const float* a = A + static_cast<size_t>(slot) * d_in * r;
  const T* xb = x + static_cast<size_t>(b) * sxb;
  float acc[VW];
#pragma unroll
  for (int v = 0; v < VW; ++v) acc[v] = 0.f;
  if (t < active) {
    constexpr int U = 8;
    for (int dd = d0 + g; dd < d1; dd += U * G) {
      float av[U][VW];
      float xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = dd + u * G;
        if (d < d1) {
          Vec<VW>::load(a + static_cast<size_t>(d) * r + r0, av[u]);
          xv[u] = to_f(xb[d]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (dd + u * G < d1) {
#pragma unroll
          for (int v = 0; v < VW; ++v) acc[v] = fmaf(xv[u], av[u][v], acc[v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < VW; ++v) part[g * r + r0 + v] = acc[v];
  }
  __syncthreads();
  // the G groups' partials: a pairwise tree whose shape depends on G alone
  for (int n = G; n > 1;) {
    const int half = (n + 1) / 2;
    for (int i = t; i < (n - half) * r; i += kClusterThreads)
      part[i] += part[i + half * r];
    __syncthreads();
    n = half;
  }

  // exchange: every CTA gathers the KC partials part[0, r) of the cluster
  // (one remote read a thread), then adds them in rank order
  cluster.sync();
  for (int i = t; i < kc * r; i += kClusterThreads)
    gat[i] = cluster.map_shared_rank(part, i / r)[i % r];
  cluster_arrive();                  // this CTA's remote reads are done
  __syncthreads();
  for (int j = t; j < r; j += kClusterThreads) {
    float h = 0.f;
    for (int c = 0; c < kc; ++c) h += gat[c * r + j];
    hs[j] = h;
  }
  __syncthreads();

  // expand: VO columns a thread, each summed over r in order
  const float* bm = B + static_cast<size_t>(slot) * r * d_out;
  for (int o = o0 + VO * t; o < o1; o += VO * kClusterThreads) {
    float s[VO];
#pragma unroll
    for (int v = 0; v < VO; ++v) s[v] = 0.f;
#pragma unroll 8
    for (int j = 0; j < r; ++j) {
      float bv[VO];
      Vec<VO>::load(bm + static_cast<size_t>(j) * d_out + o, bv);
#pragma unroll
      for (int v = 0; v < VO; ++v) s[v] = fmaf(hs[j], bv[v], s[v]);
    }
    if constexpr (VO == 4) {
      *reinterpret_cast<float4*>(orow + o) = make_float4(s[0], s[1], s[2],
                                                         s[3]);
    } else {
      orow[o] = s[0];
    }
  }
  // no CTA leaves while another may still read its partials
  cluster_wait();
}

template <typename T, int VW, int VO>
int launch_cluster(const void* x, long long sxb, const float* A,
                   const float* B, const int* ids, float* out, int batch,
                   int d_in, int r, int d_out, int slots, int kc,
                   int rows_per, int cols_per, cudaStream_t st) {
  auto kern = bgmv_cluster<T, VW, VO>;
  if (kc > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kc, batch);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(x), sxb, A, B, ids, out, d_in, r,
      d_out, slots, rows_per, cols_per));
}

template <typename T>
int cluster(const void* x, long long sxb, const float* A, const float* B,
            const int* ids, float* out, int batch, int d_in, int r,
            int d_out, int slots, int kc, int rows_per, int cols_per,
            cudaStream_t st) {
  const bool va = r % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool vo = d_out % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
#define PTT_BGMV_CLUSTER(VW, VO)                                            \
  return launch_cluster<T, VW, VO>(x, sxb, A, B, ids, out, batch, d_in, r, \
                                   d_out, slots, kc, rows_per, cols_per, st)
  if (va && vo) PTT_BGMV_CLUSTER(4, 4);
  if (va) PTT_BGMV_CLUSTER(4, 1);
  if (vo) PTT_BGMV_CLUSTER(1, 4);
  PTT_BGMV_CLUSTER(1, 1);
#undef PTT_BGMV_CLUSTER
}

template <typename T, int VW, int ROWS>
void launch_shrink(const void* x, long long sxb, long long sxs, const float* A,
                   const int* ids, float* h, int batch, int s, int d_in,
                   int r, int slots, cudaStream_t st) {
  dim3 grid((s + ROWS - 1) / ROWS, batch);
  bgmv_shrink<T, VW, ROWS><<<grid, kShrinkThreads, 0, st>>>(
      static_cast<const T*>(x), sxb, sxs, A, ids, h, s, d_in, r, slots);
}

template <typename T>
void shrink(const void* x, long long sxb, long long sxs, const float* A,
            const int* ids, float* h, int batch, int s, int d_in, int r,
            int slots, cudaStream_t st) {
  // 16-byte vectors need r % 4 == 0 (then every A row and slot block
  // starts 16-byte aligned in the contiguous stack)
  const bool vec = r % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  if (vec)
    launch_shrink<T, 4, 4>(x, sxb, sxs, A, ids, h, batch, s, d_in, r, slots, st);
  else
    launch_shrink<T, 1, 4>(x, sxb, sxs, A, ids, h, batch, s, d_in, r, slots, st);
}

}  // namespace

// routes (ops/bgmv.py ROUTE_*): 0 the two launches, 1 the cluster body
// (s == 1; kc, rows_per and cols_per its plan, `bgmv_cluster_plan`)
extern "C" int ptt_bgmv(const void* x, long long sxb, long long sxs,
                        const void* A, const void* B, const void* ids,
                        void* h, void* out, int batch, int s, int d_in, int r,
                        int d_out, int slots, int x_dtype, int route, int kc,
                        int rows_per, int cols_per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > 128 || (x_dtype != kF32 && x_dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  const float* bb = static_cast<const float*>(B);
  const int* id = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  if (route == 1) {
    if (s != 1 || (kc != 8 && kc != 16) || rows_per < 1 || cols_per < 4 ||
        cols_per % 4 || static_cast<long long>(rows_per) * kc < d_in ||
        static_cast<long long>(cols_per) * kc < d_out)
      return static_cast<int>(cudaErrorInvalidValue);
    const int err =
        x_dtype == kF32
            ? cluster<float>(x, sxb, a, bb, id, o, batch, d_in, r, d_out,
                             slots, kc, rows_per, cols_per, st)
            : cluster<__nv_bfloat16>(x, sxb, a, bb, id, o, batch, d_in, r,
                                     d_out, slots, kc, rows_per, cols_per,
                                     st);
    if (err != 0) return err;
    return static_cast<int>(cudaGetLastError());
  }
  if (route != 0 || h == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  float* hh = static_cast<float*>(h);
  if (x_dtype == kF32)
    shrink<float>(x, sxb, sxs, a, id, hh, batch, s, d_in, r, slots, st);
  else
    shrink<__nv_bfloat16>(x, sxb, sxs, a, id, hh, batch, s, d_in, r, slots,
                          st);
  dim3 grid((d_out + kExpandThreads - 1) / kExpandThreads, (s + 7) / 8,
            batch);
  bgmv_expand<8><<<grid, kExpandThreads, 0, st>>>(hh, bb, id, o, s, r, d_out,
                                                   slots);
  return static_cast<int>(cudaGetLastError());
}
