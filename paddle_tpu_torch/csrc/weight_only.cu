// Weight-only int8 / int4 matrix product:
//   out[m, n] = (x[m, k] . dequant(qw)[n, k]^T) * scale[n]
// with f32 accumulation and the scale applied once per output.
//
// Replaces paddle_tpu/ops/pallas/weight_only.py `_kernel` and
// `_kernel_int4` (reached through `weight_only_matmul`).
//
// Layouts: x [m, k] f32/bf16/f16 row-major; qw [n, k] int8, or for int4
// [n, k/2] bytes in the halves-packed two's-complement layout (the low
// nibble of byte j holds w[:, j], the high nibble w[:, k/2 + j], both
// sign-extended by arithmetic shifts); scale [n] f32; out [m, n] in x's
// dtype.
//
// What bounds it on an H100: at decode (m <= 16) the weight bytes, n*k
// for int8 and n*k/2 for int4, read once at 3.35 TB/s; at prefill (m in
// the hundreds) the 2*m*n*k operations. The design follows:
//   * m <= 16 (every decode bucket): a GEMV. Each warp owns two output
//     columns and streams their weight rows with 16-byte loads, the
//     dequantize happens in registers, and all m rows are served from the
//     one read of the weights. x is small and stays in L1/L2. Each output
//     row is summed in a fixed order (lane-strided 16-element chunks, then
//     a butterfly across the warp) that does not depend on m, so a row's
//     result is the same whatever batch it sits in (row-stable). The grid
//     covers m in row-blocks of up to 8, so the GEMV is right at any m.
//   * m > 16 (prefill chunks) with bf16/f16 x and k % 64 == 0: a 64x128
//     output tile per block on the tensor cores (WMMA 16x16x16, f32
//     accumulators). Each k step stages a 64x32 x tile and a 128x32
//     weight tile through shared memory with 16-byte loads, the weights
//     dequantized to x's type on the way in (int8 and int4 values are
//     exact in bf16/f16), and the scale is applied in the epilogue. No
//     pipelining yet: wgmma with TMA-fed multi-stage tiles is later work.
//   * any other m > 16 (f32 x, unaligned x, or k not a multiple of 64,
//     none of which the llama2_7b path produces): the GEMV, row-blocks of 8.
// Ragged m, n and k are masked in every path.
//
// The file also holds `row_gemv`, the float-weight GEMV of the decode
// buckets (see its note below).
#include <mma.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int kGemvMaxM = 16;  // m at or below: the GEMV path
constexpr int kGemvWarps = 8;
constexpr int kGemvCols = 2;   // output columns per warp

// --- 16 consecutive values as float ---------------------------------------
template <typename T, bool VEC>
__device__ __forceinline__ void load16(const T* __restrict__ p, float o[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = to_f(p[i]);
}
template <>
__device__ __forceinline__ void load16<float, true>(
    const float* __restrict__ p, float o[16]) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = v[i];
    o[4 * i] = f.x; o[4 * i + 1] = f.y; o[4 * i + 2] = f.z;
    o[4 * i + 3] = f.w;
  }
}
template <typename H>
__device__ __forceinline__ void load16_half(const H* __restrict__ p,
                                            float o[16]) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = v[i];
    const H* h = reinterpret_cast<const H*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[8 * i + j] = to_f(h[j]);
  }
}
template <>
__device__ __forceinline__ void load16<__nv_bfloat16, true>(
    const __nv_bfloat16* __restrict__ p, float o[16]) {
  load16_half(p, o);
}
template <>
__device__ __forceinline__ void load16<__half, true>(
    const __half* __restrict__ p, float o[16]) {
  load16_half(p, o);
}

// 16 weight bytes; for int4 each byte yields a low (w[j]) and a high
// (w[k/2 + j]) value
template <bool VEC>
__device__ __forceinline__ void load_w16(const int8_t* __restrict__ p,
                                         int8_t o[16]) {
  if (VEC) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = b[i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = p[i];
  }
}

__device__ __forceinline__ float lo4(int p) {
  return static_cast<float>(((p & 15) ^ 8) - 8);
}
__device__ __forceinline__ float hi4(int p) {
  return static_cast<float>(p >> 4);
}

// --- GEMV: m <= 16 -----------------------------------------------------------
template <typename T, bool INT4, bool VEC, int MT>
__global__ void __launch_bounds__(kGemvWarps * 32)
    wo_gemv(const T* __restrict__ x, const int8_t* __restrict__ qw,
            const float* __restrict__ scale, T* __restrict__ out, int m,
            int n, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * kGemvWarps + warp) * kGemvCols;
  const int row0 = blockIdx.y * MT;
  if (col0 >= n) return;
  const int kw = INT4 ? k / 2 : k;  // bytes per weight row
  const int8_t* wrow[kGemvCols];
#pragma unroll
  for (int c = 0; c < kGemvCols; ++c)  // a ragged column reads a valid row
    wrow[c] = qw + static_cast<size_t>(min(col0 + c, n - 1)) * kw;
  const T* xrow[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r)
    xrow[r] = x + static_cast<size_t>(min(row0 + r, m - 1)) * k;

  float acc[MT][kGemvCols];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) acc[r][c] = 0.f;

  const int nchunk = kw / 16;
  for (int ch = lane; ch < nchunk; ch += 32) {
    const int j0 = ch * 16;
    float wl[kGemvCols][16];
    float wh[INT4 ? kGemvCols : 1][16];
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) {
      int8_t b[16];
      load_w16<VEC>(wrow[c] + j0, b);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (INT4) {
          wl[c][i] = lo4(b[i]);
          wh[INT4 ? c : 0][i] = hi4(b[i]);
        } else {
          wl[c][i] = static_cast<float>(b[i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      float xv[16];
      load16<T, VEC>(xrow[r] + j0, xv);
#pragma unroll
      for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          acc[r][c] = fmaf(xv[i], wl[c][i], acc[r][c]);
      if (INT4) {
        load16<T, VEC>(xrow[r] + kw + j0, xv);
#pragma unroll
        for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
          for (int i = 0; i < 16; ++i)
            acc[r][c] = fmaf(xv[i], wh[INT4 ? c : 0][i], acc[r][c]);
      }
    }
  }
  // ragged k: the bytes past the last full chunk, one per lane
  for (int j = nchunk * 16 + lane; j < kw; j += 32) {
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) {
      const int p = wrow[c][j];
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        if (INT4) {
          acc[r][c] = fmaf(to_f(xrow[r][j]), lo4(p), acc[r][c]);
          acc[r][c] = fmaf(to_f(xrow[r][kw + j]), hi4(p), acc[r][c]);
        } else {
          acc[r][c] = fmaf(to_f(xrow[r][j]), static_cast<float>(p),
                           acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) {
      const float v = warp_sum(acc[r][c]);
      const int row = row0 + r, col = col0 + c;
      if (lane == 0 && row < m && col < n)
        out[static_cast<size_t>(row) * n + col] = from_f<T>(v * scale[col]);
    }
}

// --- tensor cores: m > 16, bf16/f16 x, k % 64 == 0 ---------------------------
constexpr int kWM = 64, kWN = 128, kWK = 32, kWThreads = 256, kWPad = 8;
constexpr int kWLd = kWK + kWPad;    // smem row stride of the A/B tiles
constexpr int kCLd = kWN + 4;        // smem row stride of the f32 C tile

template <typename T, bool INT4>
__global__ void __launch_bounds__(kWThreads)
    wo_wmma(const T* __restrict__ x, const int8_t* __restrict__ qw,
            const float* __restrict__ scale, T* __restrict__ out, int m,
            int n, int k) {
  using namespace nvcuda;
  constexpr int kAB = (kWM + kWN) * kWLd * sizeof(T);
  constexpr int kC = kWM * kCLd * sizeof(float);
  __shared__ __align__(128) unsigned char smem[kAB > kC ? kAB : kC];
  T(*As)[kWLd] = reinterpret_cast<T(*)[kWLd]>(smem);
  T(*Bs)[kWLd] = reinterpret_cast<T(*)[kWLd]>(smem + kWM * kWLd * sizeof(T));
  float(*Cs)[kCLd] = reinterpret_cast<float(*)[kCLd]>(smem);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;   // warp tile: 32 x 32
  const int bm = blockIdx.y * kWM, bn = blockIdx.x * kWN;
  const int kw = INT4 ? k / 2 : k;          // bytes per weight row

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  // per-thread load slots: A 64 rows x 4 slots of 8 values; B 128 rows x
  // 2 slots of 16 weight bytes
  const int a_row = tid / 4, a_col = (tid % 4) * 8;
  const int b_row = tid / 2, b_col = (tid % 2) * 16;
  const bool a_ok = bm + a_row < m, b_ok = bn + b_row < n;
  const T* a_src = x + static_cast<size_t>(min(bm + a_row, m - 1)) * k;
  const int8_t* b_src = qw + static_cast<size_t>(min(bn + b_row, n - 1)) * kw;

  for (int k0 = 0; k0 < k; k0 += kWK) {
    uint4 av = make_uint4(0, 0, 0, 0);
    if (a_ok) av = *reinterpret_cast<const uint4*>(a_src + k0 + a_col);
    *reinterpret_cast<uint4*>(&As[a_row][a_col]) = av;
    // an int4 tile lies wholly in one half of k (k/2 % 32 == 0)
    const bool high = INT4 && k0 >= kw;
    const int byte0 = (high ? k0 - kw : k0) + b_col;
    uint4 wv = make_uint4(0, 0, 0, 0);
    if (b_ok) wv = *reinterpret_cast<const uint4*>(b_src + byte0);
    const int8_t* wb = reinterpret_cast<const int8_t*>(&wv);
    T deq[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      deq[i] = from_f<T>(INT4 ? (high ? hi4(wb[i]) : lo4(wb[i]))
                              : static_cast<float>(wb[i]));
    *reinterpret_cast<uint4*>(&Bs[b_row][b_col]) =
        *reinterpret_cast<const uint4*>(deq);
    *reinterpret_cast<uint4*>(&Bs[b_row][b_col + 8]) =
        *reinterpret_cast<const uint4*>(deq + 8);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], kWLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[wn * 32 + j * 16][kk], kWLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }
  // epilogue through shared memory (the A/B tiles are dead by now)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16],
                              c[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < kWM * kWN; idx += kWThreads) {
    const int r = idx / kWN, cc = idx % kWN;
    const int gr = bm + r, gc = bn + cc;
    if (gr < m && gc < n)
      out[static_cast<size_t>(gr) * n + gc] = from_f<T>(Cs[r][cc] * scale[gc]);
  }
}

template <typename T, bool INT4, bool VEC, int MT>
void launch_gemv(const void* x, const void* qw, const void* scale, void* out,
                 int m, int n, int k, cudaStream_t s) {
  const int cols_per_block = kGemvWarps * kGemvCols;
  dim3 grid((n + cols_per_block - 1) / cols_per_block, (m + MT - 1) / MT);
  wo_gemv<T, INT4, VEC, MT><<<grid, kGemvWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<T*>(out), m, n, k);
}

template <typename T, bool INT4, bool VEC>
void dispatch_mt(const void* x, const void* qw, const void* scale, void* out,
                 int m, int n, int k, cudaStream_t s) {
  if (m == 1)
    launch_gemv<T, INT4, VEC, 1>(x, qw, scale, out, m, n, k, s);
  else if (m == 2)
    launch_gemv<T, INT4, VEC, 2>(x, qw, scale, out, m, n, k, s);
  else if (m <= 4)
    launch_gemv<T, INT4, VEC, 4>(x, qw, scale, out, m, n, k, s);
  else
    launch_gemv<T, INT4, VEC, 8>(x, qw, scale, out, m, n, k, s);
}

template <typename T, bool INT4>
void dispatch_path(const void* x, const void* qw, const void* scale,
                   void* out, int m, int n, int k, cudaStream_t s) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(qw) % 16 == 0);
  if constexpr (!std::is_same<T, float>::value) {  // no f32 tensor path
    if (m > kGemvMaxM && aligned && k % 64 == 0) {
      dim3 grid((n + kWN - 1) / kWN, (m + kWM - 1) / kWM);
      wo_wmma<T, INT4><<<grid, kWThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(qw),
          static_cast<const float*>(scale), static_cast<T*>(out), m, n, k);
      return;
    }
  }
  // 16-byte loads need 16-byte aligned rows and chunk starts: k % 32
  // covers int8 rows (k), int4 rows (k/2) and the x rows of every dtype
  const bool vec = (k % 32 == 0) && aligned;
  if (vec)
    dispatch_mt<T, INT4, true>(x, qw, scale, out, m, n, k, s);
  else
    dispatch_mt<T, INT4, false>(x, qw, scale, out, m, n, k, s);
}

template <typename T>
void dispatch_int4(const void* x, const void* qw, const void* scale,
                   void* out, int m, int n, int k, int int4, cudaStream_t s) {
  if (int4)
    dispatch_path<T, true>(x, qw, scale, out, m, n, k, s);
  else
    dispatch_path<T, false>(x, qw, scale, out, m, n, k, s);
}

// --- the row-stable float GEMV of the decode buckets --------------------------
// out[m, n] = x[m, k] . w[n, k]^T (+ bias[n]) for float weights in
// nn.Linear's [out, in] layout, x, w and bias of one dtype (f32, bf16 or
// f16): the float Linears of a paged decode step (m <= 16). It is not the
// port of a TPU kernel. It keeps the JAX engine's promise that a
// sequence's decode rows are bit-identical whatever batch they sit in,
// which cuBLAS does not make (it may choose its reduction by m). The
// pattern is wo_gemv's: a warp owns two output columns and streams their
// weight rows with 16-byte loads, each lane sums its 16-element chunks in
// order and a butterfly sums the lanes, so a row's sum has one order
// whatever m is; the bias is added to the f32 sum before the one rounding.
// Bound: the weight bytes, n * k * sizeof(T), at 3.35 TB/s.
template <typename T, bool VEC, int MT>
__global__ void __launch_bounds__(kGemvWarps * 32)
    row_gemv(const T* __restrict__ x, const T* __restrict__ w,
             const T* __restrict__ bias, T* __restrict__ out, int m, int n,
             int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * kGemvWarps + warp) * kGemvCols;
  const int row0 = blockIdx.y * MT;
  if (col0 >= n) return;
  const T* wrow[kGemvCols];
#pragma unroll
  for (int c = 0; c < kGemvCols; ++c)  // a ragged column reads a valid row
    wrow[c] = w + static_cast<size_t>(min(col0 + c, n - 1)) * k;
  const T* xrow[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r)
    xrow[r] = x + static_cast<size_t>(min(row0 + r, m - 1)) * k;

  float acc[MT][kGemvCols];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) acc[r][c] = 0.f;

  const int nchunk = k / 16;
  for (int ch = lane; ch < nchunk; ch += 32) {
    const int j0 = ch * 16;
    float wv[kGemvCols][16];
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) load16<T, VEC>(wrow[c] + j0, wv[c]);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      float xv[16];
      load16<T, VEC>(xrow[r] + j0, xv);
#pragma unroll
      for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          acc[r][c] = fmaf(xv[i], wv[c][i], acc[r][c]);
    }
  }
  // ragged k: the elements past the last full chunk, one per lane
  for (int j = nchunk * 16 + lane; j < k; j += 32) {
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) {
      const float wj = to_f(wrow[c][j]);
#pragma unroll
      for (int r = 0; r < MT; ++r)
        acc[r][c] = fmaf(to_f(xrow[r][j]), wj, acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) {
      const float v = warp_sum(acc[r][c]);
      const int row = row0 + r, col = col0 + c;
      if (lane == 0 && row < m && col < n)
        out[static_cast<size_t>(row) * n + col] =
            from_f<T>(bias != nullptr ? v + to_f(bias[col]) : v);
    }
}

template <typename T, bool VEC, int MT>
void launch_row_gemv(const void* x, const void* w, const void* bias,
                     void* out, int m, int n, int k, cudaStream_t s) {
  constexpr int cols_per_block = kGemvWarps * kGemvCols;
  dim3 grid((n + cols_per_block - 1) / cols_per_block, (m + MT - 1) / MT);
  row_gemv<T, VEC, MT><<<grid, kGemvWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), m, n, k);
}

template <typename T, bool VEC>
void row_gemv_mt(const void* x, const void* w, const void* bias, void* out,
                 int m, int n, int k, cudaStream_t s) {
  if (m == 1)
    launch_row_gemv<T, VEC, 1>(x, w, bias, out, m, n, k, s);
  else if (m == 2)
    launch_row_gemv<T, VEC, 2>(x, w, bias, out, m, n, k, s);
  else if (m <= 4)
    launch_row_gemv<T, VEC, 4>(x, w, bias, out, m, n, k, s);
  else
    launch_row_gemv<T, VEC, 8>(x, w, bias, out, m, n, k, s);
}

template <typename T>
void row_gemv_dispatch(const void* x, const void* w, const void* bias,
                       void* out, int m, int n, int k, cudaStream_t s) {
  // 16-byte loads: 16-byte aligned bases and rows (k % 16 covers every
  // dtype's row bytes and chunk starts)
  const bool vec = k % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    row_gemv_mt<T, true>(x, w, bias, out, m, n, k, s);
  else
    row_gemv_mt<T, false>(x, w, bias, out, m, n, k, s);
}

}  // namespace

// x [m, k], w [n, k], bias [n] (or null), out [m, n]: contiguous, one
// dtype (x_dtype: 0 f32, 1 bf16, 2 f16).
extern "C" int ptt_row_gemv(const void* x, const void* w, const void* bias,
                            void* out, int m, int n, int k, int x_dtype,
                            void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      row_gemv_dispatch<float>(x, w, bias, out, m, n, k, s);
      break;
    case kBF16:
      row_gemv_dispatch<__nv_bfloat16>(x, w, bias, out, m, n, k, s);
      break;
    case kF16:
      row_gemv_dispatch<__half>(x, w, bias, out, m, n, k, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_weight_only_matmul(const void* x, const void* qw,
                                      const void* scale, void* out, int m,
                                      int n, int k, int x_dtype, int int4,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      dispatch_int4<float>(x, qw, scale, out, m, n, k, int4, s);
      break;
    case kBF16:
      dispatch_int4<__nv_bfloat16>(x, qw, scale, out, m, n, k, int4, s);
      break;
    case kF16:
      dispatch_int4<__half>(x, qw, scale, out, m, n, k, int4, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_cuda_error_string(int err, char* buf, int len) {
  const char* msg = cudaGetErrorString(static_cast<cudaError_t>(err));
  strncpy(buf, msg, len - 1);
  buf[len - 1] = '\0';
  return 0;
}
