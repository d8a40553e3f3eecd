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
// the hundreds) the 2*m*n*k operations on the bf16 tensor cores. The
// caller names the route (ops/weight_only.py `weight_only_route`); asked
// for a route its inputs do not admit, the entry returns
// cudaErrorInvalidValue:
//   * route 2, prefill (m > 16, bf16/f16 x, x and qw 16-byte aligned,
//     k % 64 == 0): `wo_wgmma`, a mixed-input GEMM with the roles swapped,
//     out^T[n-tile, m] = dequant(W)[n-tile, k] . x^T, so that the weight is
//     wgmma's A operand from registers. A CTA owns 128 weight rows and 64
//     or 128 rows of x (the width with the fewest waves of CTAs), one CTA
//     an SM. A producer warpgroup keeps a ring of 8 stages of TMA loads in
//     flight (a 128 x 64-byte weight tile, int4 128 x 32, and the x tile
//     [rows][64 k]) and hands its registers to the consumers; each of two
//     consumer warpgroups reads its 64 weight rows' bytes from shared
//     memory straight into the A-fragment layout, converts them to x's
//     type in registers (int8 and int4 values are exact in bf16/f16) and
//     issues wgmma m64nNk16 over the CTA's x rows.
//     The fragments are built with no wgmma of the warpgroup in flight
//     (ptxas serializes the batch otherwise), so the two warpgroups take
//     turns on the tensor cores. The epilogue scales each row, rounds
//     once to x's type and transposes through shared memory into 16-byte
//     stores of out.
//   * route 1, decode (m <= 16, the same dtype, alignment and k rules):
//     `wo_mma_gemv`, row-stable. A warp owns 16 output columns and streams
//     their weight rows with 16-byte loads (a 64-byte block of each row a
//     step, the next two in flight), converts them in registers into the
//     mma.sync m16n8k16 A fragment and multiplies by x on the tensor cores:
//     lane t's 16 weight bytes are four k16 slices' fragments, so the k
//     order inside a slice is permuted alike for A and B, and x's fragment
//     is a plain run of its row. The CTA stages x's m rows in shared memory
//     once for all its warps (cp.async, in one slice of k wherever it fits,
//     a quarter of the slice at a time, so the first blocks start while
//     the rest lands; a row past m reads as zeros); the warps of a CTA split
//     the columns (and, for narrow n, k) by n alone. A row's sum runs over
//     the 64-byte blocks in one fixed order, then over the k-split warps
//     in order, whatever m is, so a row's result is the same bits in any
//     decode batch.
//   * route 0, `wo_gemv` (f32 x, unaligned x, k % 64 != 0, at any m; none
//     of them on the llama2_7b path): each warp owns two output columns and
//     streams their weight rows with 16-byte loads, the dequantize happens
//     in registers, and f32 FMAs serve up to 8 rows of x per read of the
//     weights; each row is summed in a fixed order whatever m is.
// Ragged m, n and k are masked in every path.
//
// The file also holds the float-weight GEMV of the decode buckets,
// `row_mma_gemv` and `row_gemv` (see their note below).
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace ptt;
using namespace ptt::sm90;

enum Route { kRouteGemv = 0, kRouteDecode = 1, kRoutePrefill = 2 };

constexpr int kGemvMaxM = 16;  // m at or below: the decode routes
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

// --- route 0: the CUDA-core GEMV ----------------------------------------------
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
void launch_route_gemv(const void* x, const void* qw, const void* scale,
                       void* out, int m, int n, int k, cudaStream_t s) {
  // 16-byte loads need 16-byte aligned rows and chunk starts: k % 32
  // covers int8 rows (k), int4 rows (k/2) and the x rows of every dtype
  const bool vec = (k % 32 == 0) &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  if (vec)
    dispatch_mt<T, INT4, true>(x, qw, scale, out, m, n, k, s);
  else
    dispatch_mt<T, INT4, false>(x, qw, scale, out, m, n, k, s);
}

// --- weight bytes to x's type, in registers -----------------------------------
// Two signed int8 values, bytes s0 and s1 of w, as one packed pair of T
// (the first in the low half), exact. bf16: a byte b is placed in a half
// of the word; 0x4300 | (b & 0x7F) encodes 128 + (b & 127), 0x4300 |
// (b & 0x80) encodes 128 + 128 * sign(b), and their difference is b. f16:
// the byte flipped to unsigned u is the mantissa of 1024 + u, less 1152.
template <typename T>
__device__ __forceinline__ uint32_t i8pair(uint32_t w, uint32_t s0,
                                           uint32_t s1) {
  if constexpr (std::is_same<T, __half>::value) {
    const uint32_t u = w ^ 0x80808080u;
    uint32_t h = __byte_perm(u, 0x64646464u, s0 | 0x40u | (s1 << 8) | 0x4000u);
    const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&h),
                              __half2half2(__ushort_as_half(0x6480)));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const uint32_t x = __byte_perm(w, 0u, s0 | 0x40u | (s1 << 8) | 0x4000u);
    uint32_t lo = (x & 0x007F007Fu) | 0x43004300u;
    uint32_t hi = (x & 0x00800080u) | 0x43004300u;
    const __nv_bfloat162 r =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                *reinterpret_cast<const __nv_bfloat162*>(&hi));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
}

// The nibbles of bytes s0 and s1 of w as two packed pairs of T: lo = the
// low nibbles (w[:, j]), hi = the high nibbles (w[:, k/2 + j]). A nibble n
// becomes the mantissa of 128 + (n ^ 8) (bf16; f16: 1024 + (n ^ 8)), less
// 136 (1032): exact.
template <typename T>
__device__ __forceinline__ void i4pairs(uint32_t w, uint32_t s0, uint32_t s1,
                                        uint32_t& lo, uint32_t& hi) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  constexpr uint32_t kMagic = F16 ? 0x64086408u : 0x43084308u;
  const uint32_t x = __byte_perm(w, 0u, s0 | 0x40u | (s1 << 8) | 0x4000u);
  uint32_t l = (x & 0x000F000Fu) ^ kMagic;
  uint32_t h = ((x >> 4) & 0x000F000Fu) ^ kMagic;
  if constexpr (F16) {
    const __half2 off = __half2half2(__ushort_as_half(0x6408));
    const __half2 a = __hsub2(*reinterpret_cast<const __half2*>(&l), off);
    const __half2 b = __hsub2(*reinterpret_cast<const __half2*>(&h), off);
    lo = *reinterpret_cast<const uint32_t*>(&a);
    hi = *reinterpret_cast<const uint32_t*>(&b);
  } else {
    const __nv_bfloat162 off =
        __bfloat162bfloat162(__ushort_as_bfloat16(0x4308));
    const __nv_bfloat162 a =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), off);
    const __nv_bfloat162 b =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), off);
    lo = *reinterpret_cast<const uint32_t*>(&a);
    hi = *reinterpret_cast<const uint32_t*>(&b);
  }
}

// --- route 2, prefill: wgmma with the weight as the register A operand --------
constexpr int kWoRows = 128;        // weight rows (output columns) per CTA
constexpr int kWoEpLd = 64 + 8;     // epilogue tile row stride (elements)

// N: the CTA's x rows (64 or 128), wgmma's N. Two consumer warpgroups
// each own 64 weight rows and multiply them by all N rows of x; a producer
// warpgroup (one thread issues the loads) hands its registers to them.
// One CTA an SM. Measured slower on the H100 at int8 m = 256: four
// warpgroups of N = 64 over the same tile, two CTAs an SM (ptxas caps a
// thread at 96 registers and spills), a producer warp without the
// register hand-over, and a persistent grid.
template <int N>
struct WoCfg {
  static constexpr int THREADS = 3 * 128;
  static constexpr int kX = N * 128;                // x tile: N x 64 x 2 B
  static constexpr int kW = kWoRows * 64;           // the weight tile slot
  static constexpr int kStage = kX + kW;
  static constexpr int STAGES = 8;
  static constexpr int kEp = 2 * N * kWoEpLd * 2;   // epilogue, on the ring
  static_assert(kEp <= STAGES * kStage, "epilogue tile exceeds the ring");
  static constexpr size_t smem =
      1024 + STAGES * kStage + 2 * STAGES * sizeof(uint64_t);
};

// The A fragments of one stage's four k16 slices for weight rows r0 and
// r0 + 8 of the tile, read from the TMA-swizzled weight tile and converted
// to T. int8: a 64-byte row, slice ks is its 16-byte chunk ks (SW64).
// int4: a 32-byte row; slices 0 and 1 are the low nibbles of chunks 0 and
// 1 (x's k tile at 32 kt), slices 2 and 3 their high nibbles (k/2 + 32 kt).
template <typename T, bool INT4>
__device__ __forceinline__ void wo_frags(const uint8_t* wt, int r0, int t,
                                         uint32_t (&af)[4][4]) {
  const uint32_t s0 = 2 * (t & 1), s1 = s0 + 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if constexpr (INT4) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint4 q = *reinterpret_cast<const uint4*>(
            wt + r * 32 + ((c ^ ((r >> 2) & 1)) * 16));
        const uint32_t wlo = (t & 2) ? q.y : q.x;   // bytes 2t, 2t + 1
        const uint32_t whi = (t & 2) ? q.w : q.z;   // bytes 8 + 2t, 9 + 2t
        i4pairs<T>(wlo, s0, s1, af[c][h], af[2 + c][h]);
        i4pairs<T>(whi, s0, s1, af[c][2 + h], af[2 + c][2 + h]);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint4 q = *reinterpret_cast<const uint4*>(
            wt + r * 64 + ((ks ^ ((r >> 1) & 3)) * 16));
        af[ks][h] = i8pair<T>((t & 2) ? q.y : q.x, s0, s1);
        af[ks][2 + h] = i8pair<T>((t & 2) ? q.w : q.z, s0, s1);
      }
    }
  }
}

// One k tile of a consumer warpgroup: wait for the stage, build the A
// fragments of its 64 weight rows, issue four wgmma over the N x rows,
// wait for them and release the stage. The fragments are built while no
// wgmma of the warpgroup is in flight (ptxas serializes the batch
// otherwise); the other warpgroup's batch keeps the tensor cores busy
// meanwhile.
template <typename T, bool INT4, int N>
__device__ __forceinline__ void wo_step(uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int kt, int r0,
                                        int t, float (&acc)[N / 2]) {
  using C = WoCfg<N>;
  const int s = kt % C::STAGES;
  mbar_wait(&full[s], (kt / C::STAGES) & 1);
  __syncwarp();                     // converged for the .aligned wgmma
  const uint8_t* st = smem + s * C::kStage;
  uint32_t af[4][4];
  wo_frags<T, INT4>(st + C::kX, r0, t, af);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) reg_fence(af[ks]);
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    // int8: one SW128 box of x; int4: two SW64 boxes (low, high half)
    const uint64_t db =
        INT4 ? make_desc(st + (ks >> 1) * (C::kX / 2) + (ks & 1) * 32, 16,
                         512, kSW64)
             : make_desc(st + ks * 32, 16, 1024, kSW128);
    wgmma_rs<T, N, 0>(acc, af[ks], db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  // the wgmma wait orders every warp of the warpgroup before the release
  if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[s]);
}

template <typename T, bool INT4, int N>
__global__ void __launch_bounds__(WoCfg<N>::THREADS, 1)
    wo_wgmma(const __grid_constant__ CUtensorMap tm_x,
             const __grid_constant__ CUtensorMap tm_w,
             const float* __restrict__ scale, T* __restrict__ out, int m,
             int n, int k) {
  using C = WoCfg<N>;
  constexpr int NS = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NS * C::kStage);
  uint64_t* empty = full + NS;
  const int m0 = blockIdx.x * N, n0 = blockIdx.y * kWoRows;
  const int nk = k / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);        // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {                    // producer warpgroup
    regs_dealloc<40>();
    if (warp == 8 && lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % NS;
        mbar_wait(&empty[s], ((kt / NS) & 1) ^ 1);
        uint8_t* st = smem + s * C::kStage;
        mbar_expect_tx(&full[s], C::kX + C::kW / (INT4 ? 2 : 1));
        if (INT4) {
          tma_load_2d(st + C::kX, &tm_w, &full[s], kt * 32, n0);
          tma_load_2d(st, &tm_x, &full[s], kt * 32, m0);
          tma_load_2d(st + C::kX / 2, &tm_x, &full[s], k / 2 + kt * 32, m0);
        } else {
          tma_load_2d(st + C::kX, &tm_w, &full[s], kt * 64, n0);
          tma_load_2d(st, &tm_x, &full[s], kt * 64, m0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns weight rows [64 w, 64 w + 64)
  regs_alloc<232>();
  const int w = warp >> 2, g = lane >> 2, t = lane & 3;
  const int wr = w * 64;
  const int r0 = wr + (warp & 3) * 16 + g;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt)
    wo_step<T, INT4, N>(smem, full, empty, kt, r0, t, acc);
  // every stage is consumed by both warpgroups before the ring becomes
  // the epilogue tile
  bar_sync(1, 256);

  // epilogue: scale, round once, transpose through shared memory
  const float sc_lo = n0 + r0 < n ? scale[n0 + r0] : 0.f;
  const float sc_hi = n0 + r0 + 8 < n ? scale[n0 + r0 + 8] : 0.f;
  const int rl = r0 - wr;             // the row within the warpgroup's 64
  T* et = reinterpret_cast<T*>(smem) + w * N * kWoEpLd;  // [x][w row]
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = 8 * i + 2 * t;
    et[c * kWoEpLd + rl] = from_f<T>(acc[4 * i] * sc_lo);
    et[(c + 1) * kWoEpLd + rl] = from_f<T>(acc[4 * i + 1] * sc_lo);
    et[c * kWoEpLd + rl + 8] = from_f<T>(acc[4 * i + 2] * sc_hi);
    et[(c + 1) * kWoEpLd + rl + 8] = from_f<T>(acc[4 * i + 3] * sc_hi);
  }
  bar_sync(2 + w, 128);
  const bool vec = n % 8 == 0;        // 16-byte aligned rows of out
  const int nw = n0 + wr;
  for (int i = threadIdx.x & 127; i < N * 8; i += 128) {
    const int row = i >> 3, gm = m0 + row, gn = nw + (i & 7) * 8;
    if (gm >= m || gn >= n) continue;
    const T* src = et + row * kWoEpLd + (i & 7) * 8;
    T* dst = out + static_cast<size_t>(gm) * n + gn;
    if (vec && gn + 8 <= n) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gn + e < n; ++e) dst[e] = src[e];
    }
  }
}

template <typename T, bool INT4, int N>
int launch_wgmma(const void* x, const void* qw, const void* scale, void* out,
                 int m, int n, int k, cudaStream_t s) {
  using C = WoCfg<N>;
  const CUtensorMapDataType xt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t kw = INT4 ? k / 2 : k;
  const uint64_t xd[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
  const uint64_t xs[1] = {static_cast<uint64_t>(k) * 2};
  const uint64_t wd[2] = {kw, static_cast<uint64_t>(n)};
  const uint64_t ws[1] = {kw};
  // int8: x boxes of 64 k (128-byte rows, SW128), weight 64 bytes (SW64);
  // int4: x boxes of 32 k (SW64) at 32 kt and k/2 + 32 kt, weight 32 bytes
  const uint32_t xb[2] = {INT4 ? 32u : 64u, static_cast<uint32_t>(N)};
  const uint32_t wb[2] = {INT4 ? 32u : 64u, static_cast<uint32_t>(kWoRows)};
  CUtensorMap tm_x, tm_w;
  if (!make_tmap<2>(&tm_x, xt, x, xd, xs, xb,
                    INT4 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap<2>(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, qw, wd, ws, wb,
                    INT4 ? CU_TENSOR_MAP_SWIZZLE_32B
                         : CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = smem_opt_in<wo_wgmma<T, INT4, N>>(C::smem)) return e;
  // x tiles fastest: the CTAs of one weight tile run side by side
  dim3 grid((m + N - 1) / N, (n + kWoRows - 1) / kWoRows);
  wo_wgmma<T, INT4, N><<<grid, C::THREADS, C::smem, s>>>(
      tm_x, tm_w, static_cast<const float*>(scale), static_cast<T*>(out), m,
      n, k);
  return 0;
}

template <typename T, bool INT4>
int launch_route_prefill(const void* x, const void* qw, const void* scale,
                         void* out, int m, int n, int k, cudaStream_t s) {
  // 128 x rows a CTA (fewer re-reads of x through L2) unless 64 take
  // fewer waves of CTAs over the card's 132 multiprocessors, each wave
  // weighted by the rows a CTA computes
  const int n_tiles = (n + kWoRows - 1) / kWoRows;
  auto cost = [&](int N) {
    return (n_tiles * ((m + N - 1) / N) + 131) / 132 * N;
  };
  if (m > 64 && cost(128) <= cost(64))
    return launch_wgmma<T, INT4, 128>(x, qw, scale, out, m, n, k, s);
  return launch_wgmma<T, INT4, 64>(x, qw, scale, out, m, n, k, s);
}

// --- route 1, decode: the row-stable tensor-core GEMV ---------------------------
constexpr int kDecThreads = 256;

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         bool f16) {
  if (f16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// One 64-byte block of the warp's 16 weight rows: lane (g, t) holds bytes
// [16t, 16t + 16) of rows g (wa) and g + 8 (wb). Word s of those bytes is
// k16 slice s's A fragment (logical k 2t, 2t + 1 <- bytes 4s, 4s + 1;
// 8 + 2t, 9 + 2t <- 4s + 2, 4s + 3), so x's B fragment of slice s is
// elements 4s..4s + 3 of the lane's 16-element run x[row][16t..]; int4
// adds slices 4..7, the high nibbles, against x's high half.
template <typename T, bool INT4, int NT>
__device__ __forceinline__ void dec_block(const uint4& wa, const uint4& wb,
                                          const T* xlo, const T* xhi, int ld,
                                          const bool (&live)[NT],
                                          float (&c)[NT][4]) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  const uint4 z = make_uint4(0, 0, 0, 0);
  uint4 xl[NT][2], xh[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {    // a row past m is not staged: zeros
    const T* p = xlo + nt * 8 * ld;
    xl[nt][0] = live[nt] ? *reinterpret_cast<const uint4*>(p) : z;
    xl[nt][1] = live[nt] ? *reinterpret_cast<const uint4*>(p + 8) : z;
    if (INT4) {
      const T* q = xhi + nt * 8 * ld;
      xh[nt][0] = live[nt] ? *reinterpret_cast<const uint4*>(q) : z;
      xh[nt][1] = live[nt] ? *reinterpret_cast<const uint4*>(q + 8) : z;
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t qa = word(wa, s), qb = word(wb, s);
    if constexpr (INT4) {
      uint32_t lo[4], hi[4];
      i4pairs<T>(qa, 0, 1, lo[0], hi[0]);
      i4pairs<T>(qb, 0, 1, lo[1], hi[1]);
      i4pairs<T>(qa, 2, 3, lo[2], hi[2]);
      i4pairs<T>(qb, 2, 3, lo[3], hi[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma16816(c[nt], lo, word(xl[nt][s >> 1], (s & 1) * 2),
                 word(xl[nt][s >> 1], (s & 1) * 2 + 1), F16);
        mma16816(c[nt], hi, word(xh[nt][s >> 1], (s & 1) * 2),
                 word(xh[nt][s >> 1], (s & 1) * 2 + 1), F16);
      }
    } else {
      const uint32_t a[4] = {i8pair<T>(qa, 0, 1), i8pair<T>(qb, 0, 1),
                             i8pair<T>(qa, 2, 3), i8pair<T>(qb, 2, 3)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma16816(c[nt], a, word(xl[nt][s >> 1], (s & 1) * 2),
                 word(xl[nt][s >> 1], (s & 1) * 2 + 1), F16);
    }
  }
}

// wait until at most `pending` (0..3) of the thread's cp.async groups are
// in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// The staged x: m rows of XW elements (+ 16 bytes, so that rows fall in
// other banks) in at most 64 KB + 256 bytes, three CTAs a multiprocessor.
// XW, a multiple of 512, is the whole k where it fits: a llama2_7b Linear's
// k at m <= 2 (k = 11008) or m <= 8 (k = 4096); half of k = 4096 at
// m = 16.
constexpr int kDecSmem = 16 * (2048 + 8) * 2;

inline int dec_slice(int m, int k) {
  const int fit = (kDecSmem / (2 * m) - 8) / 512 * 512;
  const int whole = (k + 511) / 512 * 512;
  return fit < whole ? fit : whole;
}

// The CTA's 8 warps: wc = warp % WC owns 16 columns, wk = warp / WC takes
// every WK-th 64-byte block (WC * WK = 8, chosen from n alone). x's m rows
// are staged in shared memory a slice of XW elements at a time (int4:
// XW / 2 from each half); a warp keeps its next two weight blocks in
// flight across the slices.
template <typename T, bool INT4, int NT>
__global__ void __launch_bounds__(kDecThreads, 3)
    wo_mma_gemv(const T* __restrict__ x, const int8_t* __restrict__ qw,
                const float* __restrict__ scale, T* __restrict__ out, int m,
                int n, int k, int wk_split, int XW) {
  const int LD = XW + 8;
  const int JS = INT4 ? XW / 2 : XW;        // weight bytes a slice
  extern __shared__ __align__(16) uint8_t dec_smem[];
  T* xs = reinterpret_cast<T*>(dec_smem);
  __shared__ float red[8][32][NT * 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int WK = wk_split, WC = 8 / wk_split;
  const int wc = warp % WC, wk = warp / WC;
  const int col0 = (blockIdx.x * WC + wc) * 16;
  const int kw = INT4 ? k / 2 : k;
  const int nblk = (kw + 63) / 64;
  const int8_t* w0 = qw + static_cast<size_t>(min(col0 + g, n - 1)) * kw;
  const int8_t* w1 = qw + static_cast<size_t>(min(col0 + g + 8, n - 1)) * kw;
  bool live[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) live[nt] = 8 * nt + g < m;
  float c[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
  // bytes past kw (an int4 row of 32 mod 64 bytes, or no block) are zeros
  auto load = [&](int b, uint4& ra, uint4& rb) {
    const int j = b * 64 + 16 * t;
    if (b < nblk && j < kw) {
      ra = __ldg(reinterpret_cast<const uint4*>(w0 + j));
      rb = __ldg(reinterpret_cast<const uint4*>(w1 + j));
    } else {
      ra = rb = make_uint4(0, 0, 0, 0);
    }
  };
  int b = wk;
  uint4 pa0, pb0, pa1, pb1;                 // blocks b and b + WK
  load(b, pa0, pb0);
  load(b + WK, pa1, pb1);
  for (int j0 = 0; j0 < kw; j0 += JS) {
    __syncthreads();                        // the last slice is read
    // cp.async in four groups, a quarter of the slice's columns each
    // (int4: a quarter of each half), so the first blocks start while the
    // rest of x lands; a column past the data is zeros
    const int per_row = XW / 32;            // 16-byte copies a row, a quarter
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (int i = threadIdx.x; i < m * per_row; i += kDecThreads) {
        const int r = i / per_row, pc = i % per_row;
        const int high = INT4 && pc >= XW / 64;
        const int cc = q * (JS / 4) + 8 * (pc - high * (XW / 64));
        const bool ok = j0 + cc < kw;
        const T* src = ok ? x + static_cast<size_t>(r) * k +
                                high * (k / 2) + j0 + cc
                          : x;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                         "r"(smem_u32(xs + r * LD + high * JS + cc)),
                     "l"(src), "r"(ok ? 16 : 0)
                     : "memory");
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cp_async_wait(3 - q);
      __syncthreads();                      // every thread's copies landed
      const int bend = min((j0 + (q + 1) * (JS / 4)) / 64, nblk);
      for (; b < bend; b += WK) {
        const uint4 ca = pa0, cb = pb0;
        pa0 = pa1;
        pb0 = pb1;
        load(b + 2 * WK, pa1, pb1);
        const T* xl = xs + g * LD + (b * 64 - j0) + 16 * t;
        dec_block<T, INT4, NT>(ca, cb, xl, xl + JS, LD, live, c);
      }
    }
  }
  if (WK > 1) {                             // k-split warps, summed in order
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][lane][nt * 4 + e] = c[nt][e];
    __syncthreads();
    if (wk != 0) return;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = red[wc][lane][nt * 4 + e];
        for (int w = 1; w < WK; ++w) v += red[w * WC + wc][lane][nt * 4 + e];
        c[nt][e] = v;
      }
  }
  // c[nt][e]: column col0 + g (+ 8 for e >= 2), x row 8 nt + 2t + (e & 1)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * nt + 2 * t + (e & 1);
      const int col = col0 + g + (e >= 2 ? 8 : 0);
      if (row < m && col < n)
        out[static_cast<size_t>(row) * n + col] =
            from_f<T>(c[nt][e] * scale[col]);
    }
}

template <typename T, bool INT4>
int launch_route_decode(const void* x, const void* qw, const void* scale,
                        void* out, int m, int n, int k, cudaStream_t s) {
  // 16-column warp groups: the widest CTA (8 groups) that still gives
  // about two CTAs a multiprocessor; the rest of the 8 warps split k
  int wc = 8;
  while (wc > 1 && (n + 16 * wc - 1) / (16 * wc) < 264) wc /= 2;
  dim3 grid((n + 16 * wc - 1) / (16 * wc));
  const int wk = 8 / wc;
  const int xw = dec_slice(m, k);
  auto run = [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    if (const int e = smem_opt_in<wo_mma_gemv<T, INT4, NT>>(kDecSmem))
      return e;
    wo_mma_gemv<T, INT4, NT>
        <<<grid, kDecThreads, static_cast<size_t>(m) * (xw + 8) * 2, s>>>(
            static_cast<const T*>(x), static_cast<const int8_t*>(qw),
            static_cast<const float*>(scale), static_cast<T*>(out), m, n, k,
            wk, xw);
    return 0;
  };
  return m <= 8 ? run(std::integral_constant<int, 1>())
                : run(std::integral_constant<int, 2>());
}

template <typename T>
int dispatch_route(const void* x, const void* qw, const void* scale,
                   void* out, int m, int n, int k, int int4, int route,
                   cudaStream_t s) {
  if (route == kRouteGemv) {
    if (int4)
      launch_route_gemv<T, true>(x, qw, scale, out, m, n, k, s);
    else
      launch_route_gemv<T, false>(x, qw, scale, out, m, n, k, s);
    return 0;
  }
  if constexpr (std::is_same<T, float>::value) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(qw) % 16 == 0;
    if (!aligned || k % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (route == kRouteDecode && m <= kGemvMaxM)
      return int4 ? launch_route_decode<T, true>(x, qw, scale, out, m, n, k, s)
                  : launch_route_decode<T, false>(x, qw, scale, out, m, n, k,
                                                  s);
    if (route == kRoutePrefill && m > kGemvMaxM)
      return int4
                 ? launch_route_prefill<T, true>(x, qw, scale, out, m, n, k, s)
                 : launch_route_prefill<T, false>(x, qw, scale, out, m, n, k,
                                                  s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --- the row-stable float GEMV of the decode buckets --------------------------
// out[m, n] = x[m, k] . w[n, k]^T (+ bias[n]) for float weights in
// nn.Linear's [out, in] layout, x, w and bias of one dtype (f32, bf16 or
// f16): the float Linears of a paged decode step (m <= 16) and its
// vocabulary projection. It replaces no TPU kernel. It exists to keep the
// JAX engine's promise that a sequence's decode rows are bit-identical
// whatever batch they sit in (paddle_tpu/inference/decode/engine.py:84-89),
// which cuBLAS does not make (it may choose its reduction by m). Bound: the
// weight bytes, n * k * sizeof(T), at 3.35 TB/s (180 MB, 0.054 ms, for
// llama2_7b's gate_up in bf16). The caller names the body
// (ops/weight_only.py `row_gemv_route`, from the dtype, k and the weight's
// alignment, never from m); asked for a body its inputs do not admit, the
// entry returns cudaErrorInvalidValue:
//   * route 1, `row_mma_gemv` (bf16 / f16, k % 64 == 0, x and w on 16
//     bytes): the decode route of the weight-only product on float weights.
//     The weights are mma.sync's A operand (16 output columns a warp) and
//     x its B operand (8 rows; two n8 tiles for 9-16 rows). A warp streams
//     its 16 weight rows with 16-byte loads that bypass L1, a 128-byte
//     block (64 k, a whole L2 line) of each row a step with the next two
//     blocks in flight. The CUDA-core body re-read x from memory in every
//     warp of the grid for each 16-element chunk; here x's m rows are read
//     once a multiprocessor into L1, where every warp of it finds them (a
//     variant that staged x in shared memory once a CTA with cp.async
//     measured 10 % slower at m = 8: each CTA waited for its copy before
//     its first block). The warps of a CTA split the columns and, for
//     narrow n (o_proj, down), k, by n alone. 80 registers and 8 KB of
//     shared memory (the k-split sums) a CTA: three CTAs a multiprocessor
//     (`ptt_row_gemv_occupancy` asks
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor; chip_smoke.py records
//     it).
//   * route 0, `row_gemv` (f32, k % 64 != 0 such as the tests' k = 550,
//     unaligned weights): the CUDA-core body. A warp owns two output
//     columns and streams their weight rows with 16-byte loads, each lane
//     sums its 16-element chunks in order and a butterfly sums the lanes.
// Both keep a row's f32 sum in one order whatever m is (blocks or chunks
// in order, then the k-split warps or the lanes in a fixed order) and add
// the bias to that sum before the one rounding to x's dtype.

// 32 k values of the warp's 16 weight rows (a half of a 128-byte block):
// lane (g, t) holds elements [8t, 8t + 8) of rows g (wa) and g + 8 (wb). Words
// 2s and 2s + 1 of those 16 bytes are k16 slice s's A fragment (logical k
// 2t, 2t + 1 <- elements 8t + 4s, +1; 8 + 2t, 9 + 2t <- 8t + 4s + 2, +3),
// so x's B fragment of slice s is words 2s, 2s + 1 of the lane's run
// x[row][8t .. 8t + 8): A and B are permuted alike, and the same way
// whatever m is.
template <typename T, int NT>
__device__ __forceinline__ void row_block(const uint4& wa, const uint4& wb,
                                          const T* const (&xr)[NT], int off,
                                          const bool (&live)[NT],
                                          float (&c)[NT][4]) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  const uint4 z = make_uint4(0, 0, 0, 0);
  uint4 xv[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)   // a row past m is zeros
    xv[nt] = live[nt] ? __ldg(reinterpret_cast<const uint4*>(xr[nt] + off))
                      : z;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t a[4] = {word(wa, 2 * s), word(wb, 2 * s),
                           word(wa, 2 * s + 1), word(wb, 2 * s + 1)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma16816(c[nt], a, word(xv[nt], 2 * s), word(xv[nt], 2 * s + 1), F16);
  }
}

// The CTA's 8 warps: wc = warp % WC owns 16 columns, wk = warp / WC takes
// every WK-th 64-element block (WC * WK = 8, chosen from n alone): lane
// (g, t) loads elements [8t, 8t + 8) and [32 + 8t, 40 + 8t) of rows g and
// g + 8, two row_block halves, so the warp's two loads of a row cover its
// 128 bytes; a warp keeps its next two weight blocks in flight. The
// weights stream past L1 (ld.global.nc.L1::no_allocate); x's m rows are
// read through L1, where all the warps of a multiprocessor find them
// (m * k * 2 bytes: 64 KB at m = 8, k = 4096).

// 16 bytes that are read once: not kept in L1
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kDecThreads, 3)
    row_mma_gemv(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out, int m,
                 int n, int k, int wk_split) {
  __shared__ float red[8][32][NT * 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int WK = wk_split, WC = 8 / wk_split;
  const int wc = warp % WC, wk = warp / WC;
  const int col0 = (blockIdx.x * WC + wc) * 16;
  const int nblk = k / 64;
  const T* w0 = w + static_cast<size_t>(min(col0 + g, n - 1)) * k + 8 * t;
  const T* w1 = w + static_cast<size_t>(min(col0 + g + 8, n - 1)) * k + 8 * t;
  bool live[NT];
  const T* xr[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    live[nt] = 8 * nt + g < m;
    xr[nt] = x + static_cast<size_t>(min(8 * nt + g, m - 1)) * k + 8 * t;
  }
  float c[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
  auto load = [&](int b, uint4 (&r)[4]) {
    if (b < nblk) {
      r[0] = ld_stream(w0 + b * 64);
      r[1] = ld_stream(w1 + b * 64);
      r[2] = ld_stream(w0 + b * 64 + 32);
      r[3] = ld_stream(w1 + b * 64 + 32);
    } else {
      r[0] = r[1] = r[2] = r[3] = make_uint4(0, 0, 0, 0);
    }
  };
  int b = wk;
  uint4 p0[4], p1[4];                       // blocks b and b + WK
  load(b, p0);
  load(b + WK, p1);
  for (; b < nblk; b += WK) {
    uint4 cur[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cur[i] = p0[i];
      p0[i] = p1[i];
    }
    load(b + 2 * WK, p1);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_block<T, NT>(cur[2 * h], cur[2 * h + 1], xr, b * 64 + 32 * h,
                       live, c);
  }
  if (WK > 1) {                             // k-split warps, summed in order
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][lane][nt * 4 + e] = c[nt][e];
    __syncthreads();
    if (wk != 0) return;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = red[wc][lane][nt * 4 + e];
        for (int i = 1; i < WK; ++i) v += red[i * WC + wc][lane][nt * 4 + e];
        c[nt][e] = v;
      }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * nt + 2 * t + (e & 1);
      const int col = col0 + g + (e >= 2 ? 8 : 0);
      if (row < m && col < n)
        out[static_cast<size_t>(row) * n + col] = from_f<T>(
            bias != nullptr ? c[nt][e] + to_f(bias[col]) : c[nt][e]);
    }
}

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

// the grid and k split of a row_mma_gemv launch: 16-column warp groups,
// the widest CTA (8 groups) that still gives about two CTAs a
// multiprocessor, the rest of the 8 warps splitting k
struct RowMmaPlan {
  int ctas, wk;
};

inline RowMmaPlan row_mma_plan(int n) {
  int wc = 8;
  while (wc > 1 && (n + 16 * wc - 1) / (16 * wc) < 264) wc /= 2;
  return {(n + 16 * wc - 1) / (16 * wc), 8 / wc};
}

template <typename T, int NT>
void launch_row_mma_nt(const void* x, const void* w, const void* bias,
                       void* out, int m, int n, int k, cudaStream_t s) {
  const RowMmaPlan p = row_mma_plan(n);
  row_mma_gemv<T, NT><<<p.ctas, kDecThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), m, n, k, p.wk);
}

template <typename T>
void launch_row_mma(const void* x, const void* w, const void* bias, void* out,
                    int m, int n, int k, cudaStream_t s) {
  if (m <= 8)
    launch_row_mma_nt<T, 1>(x, w, bias, out, m, n, k, s);
  else
    launch_row_mma_nt<T, 2>(x, w, bias, out, m, n, k, s);
}

template <typename T, int NT>
int row_mma_occupancy() {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, row_mma_gemv<T, NT>, kDecThreads, 0);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
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

enum RowRoute { kRowCudaCore = 0, kRowMma = 1 };

}  // namespace

// x [m, k], w [n, k], bias [n] (or null), out [m, n]: contiguous, one
// dtype (x_dtype: 0 f32, 1 bf16, 2 f16); route: 0 the CUDA-core body, 1
// the tensor-core body (see the note above).
extern "C" int ptt_row_gemv(const void* x, const void* w, const void* bias,
                            void* out, int m, int n, int k, int x_dtype,
                            int route, void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRowMma) {
    const bool ok = (x_dtype == kBF16 || x_dtype == kF16) && m <= kGemvMaxM &&
                    k % 64 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    if (x_dtype == kBF16)
      launch_row_mma<__nv_bfloat16>(x, w, bias, out, m, n, k, s);
    else
      launch_row_mma<__half>(x, w, bias, out, m, n, k, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kRowCudaCore) return static_cast<int>(cudaErrorInvalidValue);
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

// CTAs of the tensor-core body a multiprocessor holds at once for x of m
// rows (bf16 or f16), or a negative CUDA error
extern "C" int ptt_row_gemv_occupancy(int x_dtype, int m) {
  if (m < 1 || m > kGemvMaxM || (x_dtype != kBF16 && x_dtype != kF16))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == kBF16)
    return m <= 8 ? row_mma_occupancy<__nv_bfloat16, 1>()
                  : row_mma_occupancy<__nv_bfloat16, 2>();
  return m <= 8 ? row_mma_occupancy<__half, 1>()
                : row_mma_occupancy<__half, 2>();
}

// route: 0 the CUDA-core GEMV, 1 the decode tensor-core GEMV (m <= 16),
// 2 the prefill wgmma GEMM (m > 16); see the note at the top.
extern "C" int ptt_weight_only_matmul(const void* x, const void* qw,
                                      const void* scale, void* out, int m,
                                      int n, int k, int x_dtype, int int4,
                                      int route, void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (x_dtype) {
    case kF32:
      err = dispatch_route<float>(x, qw, scale, out, m, n, k, int4, route, s);
      break;
    case kBF16:
      err = dispatch_route<__nv_bfloat16>(x, qw, scale, out, m, n, k, int4,
                                          route, s);
      break;
    case kF16:
      err = dispatch_route<__half>(x, qw, scale, out, m, n, k, int4, route,
                                   s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_cuda_error_string(int err, char* buf, int len) {
  const char* msg = cudaGetErrorString(static_cast<cudaError_t>(err));
  strncpy(buf, msg, len - 1);
  buf[len - 1] = '\0';
  return 0;
}
