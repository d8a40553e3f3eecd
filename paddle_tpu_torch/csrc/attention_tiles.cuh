// Tile machinery shared by the attention kernels (flash_attention.cu,
// short_attention.cu): 4-warp CTAs of 16-row warp tiles, products in the
// mma.sync m16n8 accumulator layout (bf16 on the tensor cores, f32 as
// CUDA-core FMAs in the same layout), shared-memory tiles read through the
// caller's strides, and the launch helper.
#pragma once

#include "common.cuh"

namespace ptt {
namespace attn {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                // rows per warp: one mma tile
constexpr int kBlock = kWarps * kRows;    // rows per CTA
constexpr float kNegInf = -1e30f;         // the TPU kernels' mask value

// shared-memory row padding (elements): keeps the fragment reads of
// neighbouring rows in distinct banks
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };

// --- warp-level products in the m16n8 accumulator layout ---------------------
// acc[n][0..1] hold row g, columns 8n + 2t + {0, 1}; acc[n][2..3] row
// g + 8, the same columns (g = lane / 4, t = lane % 4).
// acc (+)= A[16 x K] . B[K x 8*NT]: A row-major in shared memory (row
// stride lda). B_T: B(k, n) = Bm[n * ldb + k] (a row-major [n][k] tile
// read transposed), else B(k, n) = Bm[k * ldb + n].

// four 8x8 b16 matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 address matrix i); .trans delivers them transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: fragments come in by ldmatrix, four 8x8 matrices per instruction
// (the A tile's four quadrants; two n-tiles' b0/b1), NT even
template <int NT, int K, bool B_T>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* Bm, int ldb) {
  static_assert(NT % 2 == 0, "n-tiles are loaded in pairs");
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
  // A quadrants (rows +0/+8, cols +0/+8) -> a0..a3; B: for a transposed
  // [n][k] tile the matrices are (n +0/+8, k +0/+8), for a [k][n] tile
  // (k +0/+8, n +0/+8) read with .trans -> b0, b1 of n-tile 0, then 1
  const __nv_bfloat16* a_p = A + (r + (mat & 1) * 8) * lda + (mat >> 1) * 8;
  const __nv_bfloat16* b_p =
      B_T ? Bm + (r + (mat >> 1) * 8) * ldb + (mat & 1) * 8
          : Bm + (r + (mat & 1) * 8) * ldb + (mat >> 1) * 8;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_p + k0);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      if (B_T)
        ldsm_x4(b, b_p + n * 8 * ldb + k0);
      else
        ldsm_x4_trans(b, b_p + k0 * ldb + n * 8);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

template <int NT, int K, bool B_T>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* A,
                                         int lda, const float* Bm, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a_lo = A + g * lda;
  const float* a_hi = A + (g + 8) * lda;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = a_lo[k], x1 = a_hi[k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float y0 = B_T ? Bm[c * ldb + k] : Bm[k * ldb + c];
      const float y1 = B_T ? Bm[(c + 1) * ldb + k] : Bm[k * ldb + c + 1];
      acc[n][0] = fmaf(x0, y0, acc[n][0]);
      acc[n][1] = fmaf(x0, y1, acc[n][1]);
      acc[n][2] = fmaf(x1, y0, acc[n][2]);
      acc[n][3] = fmaf(x1, y1, acc[n][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// the four lanes of a quad share a row of the accumulator layout
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [row0, row0 + ROWS) of one (b, h) slice (element stride `rs`
// between sequence rows, unit stride along D) into a shared tile
// [ROWS][LD]; rows >= S and columns >= D are zero. NTH threads share the
// copy.
template <typename T, int ROWS, int DP, int LD, int NTH = kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long rs, int row0, int S,
                                          int D, int vec) {
  constexpr int kCh = 16 / sizeof(T);
  constexpr int kPerRow = DP / kCh;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += NTH) {
    const int r = i / kPerRow, c = (i % kPerRow) * kCh;
    const int gr = row0 + r;
    T* d = dst + r * LD + c;
    if (vec && gr < S && c + kCh <= D) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + gr * rs + c);
    } else {
#pragma unroll
      for (int e = 0; e < kCh; ++e)
        d[e] = (gr < S && c + e < D) ? src[gr * rs + c + e] : from_f<T>(0.f);
    }
  }
}

// one accumulator tile row-pair into a contiguous [B, S, H, D] output,
// each row's values divided by its divisor (div_lo for row r_lo, div_hi
// for r_lo + 8)
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[NT][4],
                                           int b, int h, int r_lo, int c0,
                                           int S, int H, int D, float div_lo,
                                           float div_hi) {
  const int t = (threadIdx.x & 31) & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r >= S) continue;
    const float div = half ? div_hi : div_lo;
    T* row = out + ((static_cast<size_t>(b) * S + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = c0 + n * 8 + 2 * t;
      if (c < D) row[c] = from_f<T>(acc[n][2 * half] / div);
      if (c + 1 < D) row[c + 1] = from_f<T>(acc[n][2 * half + 1] / div);
    }
  }
}

// --- tile shapes of the forward, dQ and dK/dV kernels ------------------------
// forward and dQ: a CTA owns kBlock query rows and steps over BK key rows
// (Q, and for dQ dO, resident; K and V per step; a per-warp [16][BK] tile
// for P or dS); dK/dV: a CTA owns kBlock key rows and DO output columns
// and steps over BQ query rows (K, V resident; Q and dO per step; the
// rows' lse and delta in f32)
template <typename T, int DP>
struct FwdCfg {
  static constexpr int BK = DP == 256 ? 32 : 64;  // K rows per step
  static constexpr int LD = DP + Pad<T>::v;
  static constexpr int LDP = BK + Pad<T>::v;
  static constexpr size_t smem =
      sizeof(T) * (static_cast<size_t>(kBlock + 2 * BK) * LD +
                   kWarps * kRows * LDP);
};

template <typename T, int DP>
struct DqCfg {
  static constexpr int BK = DP == 256 ? 32 : 64;
  static constexpr int LD = DP + Pad<T>::v;
  static constexpr int LDP = BK + Pad<T>::v;
  static constexpr size_t smem =
      sizeof(T) * (static_cast<size_t>(2 * kBlock + 2 * BK) * LD +
                   kWarps * kRows * LDP);
};

template <typename T, int DP>
struct DkvCfg {
  static constexpr int BQ = DP >= 128 ? 32 : 64;  // Q rows per step
  static constexpr int DO = DP > 128 ? 128 : DP;  // output columns per CTA
  static constexpr int LD = DP + Pad<T>::v;
  static constexpr int LDT = BQ + Pad<T>::v;
  static constexpr size_t smem =
      sizeof(T) * (static_cast<size_t>(2 * kBlock + 2 * BQ) * LD +
                   kWarps * kRows * LDT) +
      2 * BQ * sizeof(float);
};

// --- launch --------------------------------------------------------------------
template <typename F, typename P>
int launch_with_smem(F kernel, dim3 grid, size_t smem, const P& p,
                     cudaStream_t s) {
  if (smem > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, s>>>(p);
  return 0;
}

inline bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace attn
}  // namespace ptt
