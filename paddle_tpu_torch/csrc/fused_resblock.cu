// Fused train-mode ResNet bottleneck block (stride 1, identity residual,
// channels 4C -> C -> C -> 4C), forward and backward, on flat NHWC rows
// [M = N*H*W, channels].
//
// Replaces paddle_tpu/ops/pallas/fused_resblock.py `_k1`..`_k4` (the
// forward, through `_call` from `fused_bottleneck_fwd`) and `_b1`..`_b4`
// (the backward, from `fused_bottleneck_bwd`); and `_k41` (from
// `fused_bottleneck2_fwd`, two chained blocks): rb_k41 below. What they
// compute is ops/fused_resblock.py's plain versions: bf16 operands, f32
// accumulation, r1 and r2 stored in bf16, every BN's sums taken from the
// f32 accumulator before the store, r3 never stored (recomputed).
//
// The TPU kernels hold whole images in a block and form the 3x3 conv as
// nine row rolls with iota masks, and carry the BN sums and the weight
// gradients in VMEM across a grid that runs in order. Here:
//   * every product is one tiled GEMM kernel over the flat rows: 4-warp
//     CTAs of 64 rows x 64 columns, mma.sync m16n8k16 bf16 with f32
//     accumulation (the tiles of attention_tiles.cuh), K in steps of 32;
//   * the A operand's prologue forms what the TPU kernel formed in VMEM,
//     16 bytes at a time: x cast to bf16, relu(r * scale + bias), or the BN
//     backward c0 * ((g - m1) - xhat * m2), each rounded to bf16;
//   * the 3x3 conv is an implicit GEMM over K = 9 C: the A element
//     (row m, tap, c) is the neighbour (h + di, w + dj) of row m, read
//     directly and 0 outside the image, so any row tile works and nothing
//     needs to hold whole images; the backward's transposed conv runs the
//     same kernel on flip_transpose_w2(w2);
//   * the epilogue holds the store, the residual add, the relu masks of
//     the backward and the per-tile column sums of each BN;
//   * there are no atomics: each CTA writes its BN sums to a [tiles, 2, N]
//     buffer and each weight gradient's row chunk to a [chunks, K, N]
//     buffer, and a second kernel sums them in a fixed order (the BN
//     reductions also turn the sums into the [5, N] vectors the next
//     product reads). Reruns and the backward are bitwise reproducible.
//
// What bounds it on an H100: at ResNet-50's layer1 and layer2 shapes the
// bytes (the forward reads x and writes y, 4C wide, plus the C-wide r1 and
// r2; the backward reads dy, y, x and writes dx), at layer3 and layer4 the
// products (34 M C^2 operations forward, 68 backward). Simple first:
// synchronous 16-byte loads into shared memory, mma.sync, one tile size.
// The backward also stores dr3 [M, 4C] in bf16 between its two products,
// which the TPU kernel kept in VMEM.
#include "attention_tiles.cuh"

// the argument block of ptt_resblock_gemm (ops/fused_resblock.py _Args);
// named, so the C entry point that takes it keeps external linkage
namespace ptt {
namespace rb {

// one operand of a product, as flat rows of C channels
struct Opnd {
  const void* x;     // rows: T, or bf16 for the kBf16 and kRelu modes
  const void* r;     // kBnBwd: the BN's input rows (bf16)
  const float* bn;   // kRelu, kBnBwd: the BN's forward vectors [5, C]
  const float* bw;   // kBnBwd: the BN's backward vectors [5, C]
  int C;
};

struct Args {
  Opnd a;            // A operand (rows of the output, or of the weight grad)
  Opnd d;            // weight gradients: the operand whose columns are N
  const void* w;     // products: B [K, N] bf16 row-major
  const void* e0;    // epilogue inputs [M, N]
  const void* e1;
  const float* ebn;  // epilogue BN vectors [5, N]
  const float* ebw;
  void* out;         // [M, N]
  float* part;       // per-tile sums [tiles, 2, N] or chunks [splits, K, N]
  int M, H, W, N, splits, rows_per_split;
  const void* w_next;  // kF41: the next block's w1 [N, C] bf16
  void* out_next;      // kF41: the next block's r1 [M, C] bf16
};

}  // namespace rb
}  // namespace ptt

namespace {

using namespace ptt;
using namespace ptt::attn;
using namespace ptt::rb;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;           // rows of a product tile (4 warps x 16)
constexpr int BN = 64;           // columns of a product tile
constexpr int BK = 32;           // K per step
constexpr int NT = BN / 8;       // n-tiles of a warp
constexpr int LDA = BK + 8;      // shared row strides (bf16 elements)
constexpr int LDB = BN + 8;
constexpr int WM = 32;           // rows per step of a weight-gradient tile
constexpr int WK = 64;           // a weight-gradient tile is WK x BN
constexpr int LDW = WK + 8;

// rows of the [5, C] BN vectors: forward, and backward (sum(g),
// sum(g * xhat), c0 = gamma * inv, m1 = sum(g) / n, m2 = sum(g xhat) / n)
enum { kMean = 0, kVar, kInv, kScale, kBias };
enum { kSum0 = 0, kSum1, kC0, kM1, kM2 };

// A operand modes
enum AMode { kCastT = 0, kBf16, kRelu, kBnBwd };
// epilogues of the row products
enum Epi {
  eStoreStats = 0,  // out = bf16(acc); sums of acc, acc^2
  eStats,           // sums of acc, acc^2
  eResid,           // out = relu(acc * scale + bias + bf16(e0)) (T)
  eB1,              // out = dz = e0 [e1 > 0] (T); sums of dz, dz * xhat(acc)
  eDr3,             // out = bf16(c0 * ((e0 - m1) - xhat(acc) * m2))
  eMaskStats,       // out = da = acc [relu(e0 * s + b) > 0] (T); sums of
                    // da, da * xhat(e0)
  eDx               // out = acc + e0 (T)
};

// --- operand loads ----------------------------------------------------------
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]);
template <>
__device__ __forceinline__ void load8<bf16>(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}
template <>
__device__ __forceinline__ void load8<float>(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// relu(r * scale + bias), rounded as the plain version rounds (no fma)
__device__ __forceinline__ float affine_relu(float r, const float* bn, int C,
                                             int c) {
  return fmaxf(__fadd_rn(__fmul_rn(r, bn[kScale * C + c]), bn[kBias * C + c]),
               0.f);
}

__device__ __forceinline__ float xhat(float r, const float* bn, int C, int c) {
  return __fmul_rn(__fsub_rn(r, bn[kMean * C + c]), bn[kInv * C + c]);
}

// c0 * ((g - m1) - xhat * m2)
__device__ __forceinline__ float bn_bwd(float g, float r, const float* bn,
                                        const float* bw, int C, int c) {
  const float t = __fsub_rn(__fsub_rn(g, bw[kM1 * C + c]),
                            __fmul_rn(xhat(r, bn, C, c), bw[kM2 * C + c]));
  return __fmul_rn(bw[kC0 * C + c], t);
}

// eight bf16 operand values of row `row`, channels c .. c + 7 (zeros for
// row < 0); T is the activation dtype (x, dy and the stored gradients)
template <int MODE, typename T>
__device__ __forceinline__ uint4 opnd8(const Opnd& o, long long row, int c) {
  uint4 out = make_uint4(0, 0, 0, 0);
  if (row < 0) return out;
  const long long off = row * o.C + c;
  float v[8];
  if (MODE == kCastT) {
    load8(static_cast<const T*>(o.x) + off, v);
  } else if (MODE == kBf16) {
    load8(static_cast<const bf16*>(o.x) + off, v);
  } else if (MODE == kRelu) {
    load8(static_cast<const bf16*>(o.x) + off, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = affine_relu(v[e], o.bn, o.C, c + e);
  } else {
    float r[8];
    load8(static_cast<const T*>(o.x) + off, v);
    load8(static_cast<const bf16*>(o.r) + off, r);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = bn_bwd(v[e], r[e], o.bn, o.bw, o.C, c + e);
  }
  bf16* h = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16_rn(v[e]);
  return out;
}

// the source row and channel of element (m, k) of an operand: k < C for a
// 1x1 product; for the 3x3 conv k = tap * C + c and the source is the
// neighbour (h + di, w + dj) of row m, or -1 outside the image. -1 too for
// m >= M or k >= K.
template <bool CONV>
__device__ __forceinline__ long long src_row(const Args& p, int C, int m,
                                             int k, int& c) {
  const int K = CONV ? 9 * C : C;
  if (m >= p.M || k >= K) return -1;
  if (!CONV) {
    c = k;
    return m;
  }
  const int tap = k / C;
  c = k - tap * C;
  const int di = tap / 3 - 1, dj = tap % 3 - 1;
  const int hw = m % (p.H * p.W);
  const int h = hw / p.W + di, w = hw % p.W + dj;
  if (h < 0 || h >= p.H || w < 0 || w >= p.W) return -1;
  return static_cast<long long>(m) + di * p.W + dj;
}

template <typename T>
__device__ __forceinline__ void store2(T* out, long long off, float v0,
                                       float v1);
template <>
__device__ __forceinline__ void store2<float>(float* out, long long off,
                                              float v0, float v1) {
  *reinterpret_cast<float2*>(out + off) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* out, long long off,
                                             float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(out + off) =
      __floats2bfloat162_rn(v0, v1);
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p, long long off);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p,
                                               long long off) {
  return *reinterpret_cast<const float2*>(p + off);
}
template <>
__device__ __forceinline__ float2 load2<bf16>(const bf16* p, long long off) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + off));
}

// --- row products: out [M, N] = A [M, K] . B [K, N] with fused edges ------
template <int AM, bool CONV, int EPI, typename T>
__global__ void __launch_bounds__(kThreads) rb_gemm(Args p) {
  __shared__ __align__(16) bf16 As[BM * LDA];
  __shared__ __align__(16) bf16 Bs[BK * LDB];
  __shared__ float red[2][kWarps][BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int C = p.a.C, K = CONV ? 9 * C : C, N = p.N;
  const bf16* w = static_cast<const bf16*>(p.w);

  float acc[NT][4];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK / 8; i += kThreads) {
      const int r = i / (BK / 8), kc = (i % (BK / 8)) * 8;
      int c = 0;
      const long long src = src_row<CONV>(p, C, m0 + r, k0 + kc, c);
      *reinterpret_cast<uint4*>(As + r * LDA + kc) = opnd8<AM, T>(p.a, src, c);
    }
    for (int i = threadIdx.x; i < BK * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), nc = (i % (BN / 8)) * 8;
      const int k = k0 + r, n = n0 + nc;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < K && n < N)
        v = *reinterpret_cast<const uint4*>(w + static_cast<long long>(k) * N +
                                            n);
      *reinterpret_cast<uint4*>(Bs + r * LDB + nc) = v;
    }
    __syncthreads();
    warp_mma<NT, BK, false>(acc, As + warp * kRows * LDA, LDA, Bs, LDB);
    __syncthreads();
  }

  // epilogue: this thread holds rows r_lo, r_lo + 8 and columns
  // n0 + 8 nt + 2 t + {0, 1}
  constexpr bool kStats = EPI == eStoreStats || EPI == eStats ||
                          EPI == eB1 || EPI == eMaskStats;
  float s0[NT][2], s1[NT][2];
  const int r_lo = m0 + warp * kRows + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s0[nt][0] = s0[nt][1] = s1[nt][0] = s1[nt][1] = 0.f;
    const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r_lo + 8 * half;
      if (row >= p.M || col >= N) continue;
      const long long off = static_cast<long long>(row) * N + col;
      float v[2] = {acc[nt][2 * half], acc[nt][2 * half + 1]};
      float a[2] = {0.f, 0.f}, b[2] = {0.f, 0.f};  // the sums' summands
      if (EPI == eStoreStats || EPI == eStats) {
        if (EPI == eStoreStats)
          store2(static_cast<bf16*>(p.out), off, v[0], v[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) { a[j] = v[j]; b[j] = v[j] * v[j]; }
      } else if (EPI == eResid) {
        const float2 x2 = load2(static_cast<const T*>(p.e0), off);
        const float xs[2] = {x2.x, x2.y};
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float xb = __bfloat162float(__float2bfloat16_rn(xs[j]));
          const float z = __fadd_rn(
              __fadd_rn(__fmul_rn(v[j], p.ebn[kScale * N + col + j]),
                        p.ebn[kBias * N + col + j]),
              xb);
          y[j] = fmaxf(z, 0.f);
        }
        store2(static_cast<T*>(p.out), off, y[0], y[1]);
      } else if (EPI == eB1) {
        const float2 dy = load2(static_cast<const T*>(p.e0), off);
        const float2 y = load2(static_cast<const T*>(p.e1), off);
        const float dz[2] = {y.x > 0.f ? dy.x : 0.f, y.y > 0.f ? dy.y : 0.f};
        store2(static_cast<T*>(p.out), off, dz[0], dz[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a[j] = dz[j];
          b[j] = dz[j] * xhat(v[j], p.ebn, N, col + j);
        }
      } else if (EPI == eDr3) {
        const float2 dz = load2(static_cast<const T*>(p.e0), off);
        const float dzs[2] = {dz.x, dz.y};
        float dr[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = col + j;
          const float tt = __fsub_rn(
              __fsub_rn(dzs[j], p.ebw[kM1 * N + c]),
              __fmul_rn(xhat(v[j], p.ebn, N, c), p.ebw[kM2 * N + c]));
          dr[j] = __fmul_rn(p.ebw[kC0 * N + c], tt);
        }
        store2(static_cast<bf16*>(p.out), off, dr[0], dr[1]);
      } else if (EPI == eMaskStats) {
        const float2 r2 = load2(static_cast<const bf16*>(p.e0), off);
        const float rs[2] = {r2.x, r2.y};
        float da[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          da[j] = affine_relu(rs[j], p.ebn, N, col + j) > 0.f ? v[j] : 0.f;
          a[j] = da[j];
          b[j] = da[j] * xhat(rs[j], p.ebn, N, col + j);
        }
        store2(static_cast<T*>(p.out), off, da[0], da[1]);
      } else {  // eDx
        const float2 dz = load2(static_cast<const T*>(p.e0), off);
        store2(static_cast<T*>(p.out), off, v[0] + dz.x, v[1] + dz.y);
      }
      if (kStats) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s0[nt][j] += a[j];
          s1[nt][j] += b[j];
        }
      }
    }
  }
  if (!kStats) return;
  // column sums: the 8 lanes of a column (g), then the 4 warps in order
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0[nt][j] += __shfl_xor_sync(0xffffffffu, s0[nt][j], o);
        s1[nt][j] += __shfl_xor_sync(0xffffffffu, s1[nt][j], o);
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red[0][warp][nt * 8 + 2 * t + j] = s0[nt][j];
        red[1][warp][nt * 8 + 2 * t + j] = s1[nt][j];
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * BN; i += kThreads) {
    const int which = i / BN, col = i % BN;
    if (n0 + col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[which][wi][col];
    p.part[(static_cast<long long>(blockIdx.x) * 2 + which) * N + n0 + col] =
        s;
  }
}

// --- weight gradients: part[z] [K, N] = sum over rows of chunk z of
//     A(m, k) D(m, n) --------------------------------------------------------
// acc (+)= A^T . D with A and D in shared memory as [rows][cols]: the A
// fragment is read transposed (ldmatrix .trans), so this warp's 16 output
// rows are 16 columns of As starting at col0
template <int KK>
__device__ __forceinline__ void warp_mma_tn(float (&acc)[NT][4],
                                            const bf16* As, int col0,
                                            const bf16* Ds) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
  const bf16* a_p = As + ((mat >> 1) * 8 + r) * LDW + col0 + (mat & 1) * 8;
  const bf16* b_p = Ds + (r + (mat & 1) * 8) * LDB + (mat >> 1) * 8;
#pragma unroll
  for (int k0 = 0; k0 < KK; k0 += 16) {
    uint32_t a[4];
    ldsm_x4_trans(a, a_p + k0 * LDW);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, b_p + k0 * LDB + n * 8);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

template <int AM, bool CONV, int DM, typename T>
__global__ void __launch_bounds__(kThreads) rb_wgrad(Args p) {
  __shared__ __align__(16) bf16 As[WM * LDW];
  __shared__ __align__(16) bf16 Ds[WM * LDB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * WK, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int C = p.a.C, K = CONV ? 9 * C : C, N = p.N;
  const int mb = z * p.rows_per_split;
  const int me = min(p.M, mb + p.rows_per_split);

  float acc[NT][4];
  zero(acc);
  for (int m = mb; m < me; m += WM) {
    for (int i = threadIdx.x; i < WM * WK / 8; i += kThreads) {
      const int r = i / (WK / 8), kc = (i % (WK / 8)) * 8;
      int c = 0;
      const long long src =
          m + r < me ? src_row<CONV>(p, C, m + r, k0 + kc, c) : -1;
      *reinterpret_cast<uint4*>(As + r * LDW + kc) = opnd8<AM, T>(p.a, src, c);
    }
    for (int i = threadIdx.x; i < WM * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), nc = (i % (BN / 8)) * 8;
      int c = 0;
      const long long src =
          m + r < me ? src_row<false>(p, N, m + r, n0 + nc, c) : -1;
      *reinterpret_cast<uint4*>(Ds + r * LDB + nc) = opnd8<DM, T>(p.d, src, c);
    }
    __syncthreads();
    warp_mma_tn<WM>(acc, As, warp * kRows, Ds);
    __syncthreads();
  }
  float* out = p.part + static_cast<long long>(z) * K * N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = k0 + warp * kRows + g + 8 * half;
      if (row < K && col < N)
        store2(out, static_cast<long long>(row) * N + col,
               acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// --- fixed-order reductions -------------------------------------------------
// mode kSumMode: out[r] = sum_t part[t][r] (t in order), r < N
__global__ void rb_sum(const float* __restrict__ part, int T, int N,
                       float* __restrict__ out) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= N) return;
  float s = 0.f;
  for (int t = 0; t < T; ++t) s += part[static_cast<long long>(t) * N + r];
  out[r] = s;
}

// modes kBnFwd / kBnBwd: the per-tile sums part [T, 2, N] of a BN summed
// (32 strided partial sums per column, then those in order) and turned
// into its [5, N] vectors
__global__ void rb_bn(int mode, const float* __restrict__ part, int T, int N,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const float* __restrict__ bn, float eps, float n,
                      float* __restrict__ out) {
  __shared__ float sm[2][32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a0 = 0.f, a1 = 0.f;
  if (c < N)
    for (int t = ty; t < T; t += 32) {
      a0 += part[(static_cast<long long>(t) * 2) * N + c];
      a1 += part[(static_cast<long long>(t) * 2 + 1) * N + c];
    }
  sm[0][ty][tx] = a0;
  sm[1][ty][tx] = a1;
  __syncthreads();
  if (ty != 0 || c >= N) return;
  float s0 = 0.f, s1 = 0.f;
  for (int i = 0; i < 32; ++i) {
    s0 += sm[0][i][tx];
    s1 += sm[1][i][tx];
  }
  if (mode == 1) {  // forward: mean, var, inv, scale, bias
    const float mean = __fdiv_rn(s0, n);
    const float var =
        fmaxf(__fsub_rn(__fdiv_rn(s1, n), __fmul_rn(mean, mean)), 0.f);
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    const float scale = __fmul_rn(gamma[c], inv);
    out[kMean * N + c] = mean;
    out[kVar * N + c] = var;
    out[kInv * N + c] = inv;
    out[kScale * N + c] = scale;
    out[kBias * N + c] = __fsub_rn(beta[c], __fmul_rn(mean, scale));
  } else {          // backward: the sums, c0, m1, m2
    out[kSum0 * N + c] = s0;
    out[kSum1 * N + c] = s1;
    out[kC0 * N + c] = __fmul_rn(gamma[c], bn[kInv * N + c]);
    out[kM1 * N + c] = __fdiv_rn(s0, n);
    out[kM2 * N + c] = __fdiv_rn(s1, n);
  }
}

// --- two blocks' boundary: block 1's k4 coupled with block 2's k1 -----------
// A CTA owns BMR rows. Pass 1, over the 4C columns of y in steps of BN:
// r3 = relu(bn2(r2)) . w3 (the tile's f2 rows re-formed per step), y =
// relu(r3 * s3 + b3 + bf16(x)) stored in T (block 2's residual) and, as
// bf16, into shared memory Ys [BMR][4C]. Pass 2, over the C columns of
// block 2's r1: Ys . w1_next, r1 stored in bf16, each column's sums of the
// f32 products (block 2's bn1) per tile into part [tiles, 2, C], as
// eStoreStats does. y never leaves the CTA between the two products; it
// is written once, as the TPU kernel writes it.
// Shared memory: BMR x 4C bf16 for Ys, which at 64 rows is 128 KB at
// layer3 (4C = 1024) and 256 KB at layer4 (4C = 2048), over the 227 KB a
// CTA may hold. So the row tile follows 4C (k41_rows): 64 rows up to
// 4C = 1024, 32 up to 2048, 16 up to 4096. The 4 warps sit as BMR / 16
// row groups x 64 / BMR column groups over a 64-column step.
constexpr int kK41MaxC4 = 4096;

__host__ __device__ constexpr int k41_rows(int C4) {
  return C4 <= 1024 ? 64 : (C4 <= 2048 ? 32 : 16);
}

template <int BMR>
struct K41Cfg {
  static constexpr int WR = BMR / kRows;      // row groups of warps
  static constexpr int WC = kWarps / WR;      // column groups
  static constexpr int NTW = BN / WC / 8;     // n-tiles of a warp
};

template <int BMR>
size_t k41_smem(int C4) {
  return sizeof(bf16) * (static_cast<size_t>(BMR) * (C4 + 8) + BMR * LDA +
                         BK * LDB) +
         sizeof(float) * 2 * kWarps * BN;
}

template <int BMR, typename T>
__global__ void __launch_bounds__(kThreads) rb_k41(Args p) {
  using Cfg = K41Cfg<BMR>;
  constexpr int NTW = Cfg::NTW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = p.a.C, C4 = p.N, LDY = C4 + 8;
  bf16* Ys = reinterpret_cast<bf16*>(smem_raw);
  bf16* As = Ys + BMR * LDY;
  bf16* Bs = As + BMR * LDA;
  float* red = reinterpret_cast<float*>(Bs + BK * LDB);  // [2][WR][BN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % Cfg::WR, wc = warp / Cfg::WR;
  const int m0 = blockIdx.x * BMR;
  const int r_lo = m0 + wr * kRows + g;        // this thread's rows
  const int c_w = wc * NTW * 8;                // its columns in a step
  const bf16* w3 = static_cast<const bf16*>(p.w);
  const bf16* w1n = static_cast<const bf16*>(p.w_next);

  // pass 1: y over the 4C columns
  for (int n0 = 0; n0 < C4; n0 += BN) {
    float acc[NTW][4];
    zero(acc);
    for (int k0 = 0; k0 < C; k0 += BK) {
      for (int i = threadIdx.x; i < BMR * BK / 8; i += kThreads) {
        const int r = i / (BK / 8), kc = (i % (BK / 8)) * 8;
        int c = 0;
        const long long src = src_row<false>(p, C, m0 + r, k0 + kc, c);
        *reinterpret_cast<uint4*>(As + r * LDA + kc) =
            opnd8<kRelu, T>(p.a, src, c);
      }
      for (int i = threadIdx.x; i < BK * BN / 8; i += kThreads) {
        const int r = i / (BN / 8), nc = (i % (BN / 8)) * 8;
        const int k = k0 + r, n = n0 + nc;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k < C && n < C4)
          v = *reinterpret_cast<const uint4*>(
              w3 + static_cast<long long>(k) * C4 + n);
        *reinterpret_cast<uint4*>(Bs + r * LDB + nc) = v;
      }
      __syncthreads();
      warp_mma<NTW, BK, false>(acc, As + wr * kRows * LDA, LDA, Bs + c_w,
                               LDB);
      __syncthreads();
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int col = n0 + c_w + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r_lo + 8 * half;
        if (col >= C4) continue;
        float y[2] = {0.f, 0.f};
        if (row < p.M) {
          const long long off = static_cast<long long>(row) * C4 + col;
          const float2 x2 = load2(static_cast<const T*>(p.e0), off);
          const float xs[2] = {x2.x, x2.y};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float xb = __bfloat162float(__float2bfloat16_rn(xs[j]));
            const float z = __fadd_rn(
                __fadd_rn(__fmul_rn(acc[nt][2 * half + j],
                                    p.ebn[kScale * C4 + col + j]),
                          p.ebn[kBias * C4 + col + j]),
                xb);
            y[j] = fmaxf(z, 0.f);
          }
          store2(static_cast<T*>(p.out), off, y[0], y[1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            Ys + (row - m0) * LDY + col) = __floats2bfloat162_rn(y[0], y[1]);
      }
    }
  }
  __syncthreads();

  // pass 2: block 2's r1 = bf16(y) . w1_next over the C columns, with sums
  for (int n0 = 0; n0 < C; n0 += BN) {
    float acc[NTW][4];
    zero(acc);
    for (int k0 = 0; k0 < C4; k0 += BK) {
      for (int i = threadIdx.x; i < BK * BN / 8; i += kThreads) {
        const int r = i / (BN / 8), nc = (i % (BN / 8)) * 8;
        const int k = k0 + r, n = n0 + nc;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k < C4 && n < C)
          v = *reinterpret_cast<const uint4*>(
              w1n + static_cast<long long>(k) * C + n);
        *reinterpret_cast<uint4*>(Bs + r * LDB + nc) = v;
      }
      __syncthreads();
      warp_mma<NTW, BK, false>(acc, Ys + wr * kRows * LDY + k0, LDY,
                               Bs + c_w, LDB);
      __syncthreads();
    }
    float s0[NTW][2], s1[NTW][2];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      s0[nt][0] = s0[nt][1] = s1[nt][0] = s1[nt][1] = 0.f;
      const int col = n0 + c_w + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r_lo + 8 * half;
        if (row >= p.M || col >= C) continue;
        const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
        store2(static_cast<bf16*>(p.out_next),
               static_cast<long long>(row) * C + col, v0, v1);
        s0[nt][0] += v0;
        s0[nt][1] += v1;
        s1[nt][0] += v0 * v0;
        s1[nt][1] += v1 * v1;
      }
    }
    // column sums: the 8 lanes of a column (g), then the row groups in
    // order
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0[nt][j] += __shfl_xor_sync(0xffffffffu, s0[nt][j], o);
          s1[nt][j] += __shfl_xor_sync(0xffffffffu, s1[nt][j], o);
        }
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c_w + nt * 8 + 2 * t + j;
          red[(0 * Cfg::WR + wr) * BN + c] = s0[nt][j];
          red[(1 * Cfg::WR + wr) * BN + c] = s1[nt][j];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * BN; i += kThreads) {
      const int which = i / BN, c = i % BN;
      if (n0 + c >= C) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < Cfg::WR; ++w)
        sum += red[(which * Cfg::WR + w) * BN + c];
      p.part[(static_cast<long long>(blockIdx.x) * 2 + which) * C + n0 + c] =
          sum;
    }
    __syncthreads();  // red is rewritten by the next column step
  }
}

template <int BMR, typename T>
int k41_launch(const Args& p, cudaStream_t s) {
  const size_t smem = k41_smem<BMR>(p.N);
  const cudaError_t e = cudaFuncSetAttribute(
      rb_k41<BMR, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rb_k41<BMR, T><<<(p.M + BMR - 1) / BMR, kThreads, smem, s>>>(p);
  return 0;
}

template <typename T>
int k41(const Args& p, cudaStream_t s) {
  if (p.N > kK41MaxC4 || !p.w_next || !p.out_next)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (k41_rows(p.N)) {
    case 64: return k41_launch<64, T>(p, s);
    case 32: return k41_launch<32, T>(p, s);
    default: return k41_launch<16, T>(p, s);
  }
}

// --- launch -----------------------------------------------------------------
enum Kind { kF1 = 0, kF2, kF3, kF4, kB1, kB2A, kB2B, kB3, kB4, kW3, kW2, kW1,
            kF41 };

template <int AM, bool CONV, int EPI, typename T>
int row_gemm(const Args& p, cudaStream_t s) {
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  rb_gemm<AM, CONV, EPI, T><<<grid, kThreads, 0, s>>>(p);
  return 0;
}

template <int AM, bool CONV, int DM, typename T>
int wgrad(const Args& p, cudaStream_t s) {
  const int K = CONV ? 9 * p.a.C : p.a.C;
  const dim3 grid((K + WK - 1) / WK, (p.N + BN - 1) / BN, p.splits);
  rb_wgrad<AM, CONV, DM, T><<<grid, kThreads, 0, s>>>(p);
  return 0;
}

template <typename T>
int dispatch(int kind, const Args& p, cudaStream_t s) {
  switch (kind) {
    case kF1: return row_gemm<kCastT, false, eStoreStats, T>(p, s);
    case kF2: return row_gemm<kRelu, true, eStoreStats, T>(p, s);
    case kF3: return row_gemm<kRelu, false, eStats, T>(p, s);
    case kF4: return row_gemm<kRelu, false, eResid, T>(p, s);
    case kB1: return row_gemm<kRelu, false, eB1, T>(p, s);
    case kB2A: return row_gemm<kRelu, false, eDr3, T>(p, s);
    case kB2B: return row_gemm<kBf16, false, eMaskStats, T>(p, s);
    case kB3: return row_gemm<kBnBwd, true, eMaskStats, T>(p, s);
    case kB4: return row_gemm<kBnBwd, false, eDx, T>(p, s);
    case kW3: return wgrad<kRelu, false, kBf16, T>(p, s);
    case kW2: return wgrad<kRelu, true, kBnBwd, T>(p, s);
    case kW1: return wgrad<kCastT, false, kBnBwd, T>(p, s);
    case kF41: return k41<T>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One product of the block (kind: Kind above). Every row tensor is
// contiguous [M, channels] and 16-byte aligned, every channel count a
// multiple of 8; weights are bf16 [K, N] row-major; dtype is the
// activations' (x, y, dy, dz, da2, da1, dx): 0 f32, 1 bf16.
extern "C" int ptt_resblock_gemm(int kind, const ptt::rb::Args* args,
                                 int dtype, void* stream) {
  const ptt::rb::Args& p = *args;
  if (p.M < 1 || p.N < 1 || p.N % 8 || p.a.C < 1 || p.a.C % 8 ||
      (kind >= kW3 && kind <= kW1 &&
       (p.splits < 1 || p.rows_per_split < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case kF32: err = dispatch<float>(kind, p, s); break;
    case kBF16: err = dispatch<bf16>(kind, p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// mode 0: out [N] = sum over t of part [T, N]; 1: a BN's forward vectors
// [5, N] from its sums part [T, 2, N] (gamma, beta, eps, n); 2: its
// backward vectors (gamma and the forward vectors bn).
extern "C" int ptt_resblock_reduce(int mode, const void* part, int T, int N,
                                   const void* gamma, const void* beta,
                                   const void* bn, float eps, float n,
                                   void* out, void* stream) {
  if (T < 1 || N < 1 || mode < 0 || mode > 2 ||
      (mode >= 1 && !gamma) || (mode == 1 && !beta) || (mode == 2 && !bn))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(part);
  float* o = static_cast<float*>(out);
  if (mode == 0) {
    rb_sum<<<(N + 255) / 256, 256, 0, s>>>(pp, T, N, o);
  } else {
    rb_bn<<<(N + 31) / 32, dim3(32, 32), 0, s>>>(
        mode, pp, T, N, static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const float*>(bn), eps,
        n, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows of a kF41 tile for 4C = C4 (the per-tile sums' count is
// ceil(M / rows)); 0 where the coupled kernel does not take C4
extern "C" int ptt_resblock_k41_rows(int C4) {
  return C4 <= kK41MaxC4 ? k41_rows(C4) : 0;
}
