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
// operations, about half an operation per byte. The design (Punica's
// shrink-then-expand, kept simple):
//   * shrink: one CTA per (b, tile of s rows) forms h = x @ A[ids[b]]. The
//     slot's A block is read as one flat array of d_in*r floats, 16 bytes
//     a thread when r % 4 == 0, consecutive threads on consecutive
//     addresses, several steps' loads in flight per thread (at decode the
//     shrink has only b CTAs). A thread's r offset is the same at every
//     step, so it keeps one accumulator per (row, r) it owns; the partial
//     sums of the thread groups that share an r are then added in shared
//     memory by a pairwise tree of fixed shape.
//   * expand: one CTA per (b, tile of s rows, 256 columns of d_out) forms
//     h @ B[ids[b]], one column a thread, summed over r in order.
// Only the slots the batch references leave device memory. There are no
// atomics and no split of a sum across CTAs: each output row is reduced in
// an order fixed by (d_in, r) alone, so its bits do not depend on its
// batchmates or on the batch size (the decode engine's row-stability
// contract). Slot 0 rows are computed like any other (zeros in, zeros
// out). An id outside [0, slots) gives a NaN row, never a stray read.
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
    // U x 16 bytes each in flight: with only b CTAs at decode, each SM
    // streams its slot's A block alone. The sum still runs over d in
    // ascending order per thread.
    constexpr int U = ROWS == 1 ? 8 : 4;
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
  if (s == 1) {
    if (vec)
      launch_shrink<T, 4, 1>(x, sxb, sxs, A, ids, h, batch, s, d_in, r, slots, st);
    else
      launch_shrink<T, 1, 1>(x, sxb, sxs, A, ids, h, batch, s, d_in, r, slots, st);
  } else {
    if (vec)
      launch_shrink<T, 4, 4>(x, sxb, sxs, A, ids, h, batch, s, d_in, r, slots, st);
    else
      launch_shrink<T, 1, 4>(x, sxb, sxs, A, ids, h, batch, s, d_in, r, slots, st);
  }
}

}  // namespace

extern "C" int ptt_bgmv(const void* x, long long sxb, long long sxs,
                        const void* A, const void* B, const void* ids,
                        void* h, void* out, int batch, int s, int d_in, int r,
                        int d_out, int slots, int x_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > 128) return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  const int* id = static_cast<const int*>(ids);
  float* hh = static_cast<float*>(h);
  switch (x_dtype) {
    case kF32:
      shrink<float>(x, sxb, sxs, a, id, hh, batch, s, d_in, r, slots, st);
      break;
    case kBF16:
      shrink<__nv_bfloat16>(x, sxb, sxs, a, id, hh, batch, s, d_in, r, slots,
                            st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bb = static_cast<const float*>(B);
  float* o = static_cast<float*>(out);
  if (s == 1) {
    dim3 grid((d_out + kExpandThreads - 1) / kExpandThreads, 1, batch);
    bgmv_expand<1><<<grid, kExpandThreads, 0, st>>>(hh, bb, id, o, s, r,
                                                     d_out, slots);
  } else {
    dim3 grid((d_out + kExpandThreads - 1) / kExpandThreads, (s + 7) / 8,
              batch);
    bgmv_expand<8><<<grid, kExpandThreads, 0, st>>>(hh, bb, id, o, s, r,
                                                     d_out, slots);
  }
  return static_cast<int>(cudaGetLastError());
}
