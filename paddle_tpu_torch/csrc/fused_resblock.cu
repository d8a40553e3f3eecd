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
// gradients in VMEM across a grid that runs in order. Here every product
// runs over the flat rows, with the TPU kernel's VMEM work at its edges:
//   * the A operand's prologue forms what the TPU kernel formed in VMEM,
//     16 bytes at a time: x cast to bf16, relu(r * scale + bias), or the BN
//     backward c0 * ((g - m1) - xhat * m2), each rounded to bf16;
//   * the 3x3 conv is an implicit GEMM over K = 9 C: the A element
//     (row m, tap, c) is the neighbour (h + di, w + dj) of row m, 0 outside
//     the image, so any row tile works and nothing holds whole images; the
//     backward's transposed conv runs it on flip_transpose_w2(w2);
//   * the epilogue holds the store, the residual add, the relu masks of
//     the backward and the per-tile column sums of each BN;
//   * there are no atomics: each CTA writes its BN sums to a [tiles, 2, N]
//     buffer and each weight gradient's row chunk to a [chunks, K, N]
//     buffer, and a second kernel sums them in a fixed order (the BN
//     reductions also turn the sums into the [5, N] vectors the next
//     product reads). Reruns are bitwise reproducible.
//
// What bounds it on an H100: at ResNet-50's layer1 and layer2 shapes the
// bytes (the forward reads x and writes y, 4C wide, plus the C-wide r1 and
// r2; the backward reads dy, y, x and writes dx), at layer3 and layer4 the
// products (34 M C^2 operations forward, 68 backward).
//
// Both directions run on Hopper bodies built from TMA, mbarrier rings and
// wgmma with both operands in shared memory. The forward's products:
//   * F1 (r1 = x . w1) and F3 / F4 (relu(bn2(r2)) . w3) on rb_wg, the
//     backward's row-product body below, with the epilogues eStoreStats
//     (r1 in bf16 and its per-tile column sums), eStats (the sums alone: r3
//     is never stored) and eResid (y = relu(bn3(r3) + bf16(x)), the x tile
//     by TMA during the mainloop). For bf16 x, F1's A is a plain TMA copy
//     into the swizzled operand; for f32 x, TMA brings the raw tile and
//     the consumers cast it.
//   * F2 (the 3x3 conv of relu(bn1(r1))) on rb_wg_conv: relu(bn1(r1))
//     formed once a source row per 64-channel chunk into the staged halo,
//     the nine taps copied from it.
//   * F3 and F4 both read relu(bn2(r2)) [M, C] with K = C and N = 4C, so
//     the forward forms it once, in bf16, by rb_form (the rounding the
//     consumers would apply), and both products take it as a plain TMA
//     copy: the mma.sync body formed it again for every 64 columns of N
//     (16 times a row at layer3, 32 at layer4).
// The forward's mma.sync body (rb_gemm) is retired; of it stay only the
// pieces rb_k41 (12c's coupled pair) shares (opnd8, src_row, the step
// constants), and rb_k41 keeps its mma.sync design: 4-warp CTAs, 64
// columns a step, mma.sync m16n8k16 (the tiles of attention_tiles.cuh), K
// in steps of 32 loaded synchronously between two __syncthreads.
//
// The bodies keep both wgmma operands in shared memory (so no A fragment
// is built in registers while a wgmma is in flight, which ptxas would
// serialize: weight_only.cu's C7513). The backward's:
//   * row products B1, B2A, B2B, B4 (rb_wg): persistent CTAs over tiles of
//     128 rows x 128 columns (64 where N = 64), a TMA warp and two consumer
//     warpgroups. The TMA warp keeps a ring of stages in flight: the
//     weight, B (the wrapper passes it [N, K]: K-major, SW128), and A's
//     64-channel slice of the tile's rows, straight into the swizzled
//     operand where A is a plain bf16 copy (B2B's dr3), else raw (r2 for
//     relu(bn2(r2)); da1 and r1 for the BN backward). Each consumer
//     warpgroup forms its 64 rows of A from the raw tiles in shared memory,
//     stores them as bf16 in the SW128 layout, fences them into the async
//     proxy and runs wgmma m64nNk16 with the last stage's batch still in
//     flight. The epilogue's inputs (dy and y, dz, r2) come by TMA too,
//     into shared memory during the tile's mainloop. The global loads of
//     the prologue and epilogue were the mma.sync kernel's latency: here
//     they are TMA's, ahead of the threads that read them.
//   * the transposed 3x3 conv, B3 (rb_wg_conv): a producer warpgroup stages
//     a tile's rows plus a halo of W + 1 rows each side once a 64-channel
//     chunk, dr2's BN-backward prologue formed once a source row, and
//     copies each tap's window (a shift by di W + dj rows, zeros outside
//     the image) into the swizzled stage beside the TMA-fed B; the
//     mma.sync kernel re-read and re-formed every tap from memory.
//   * weight gradients W3, W2, W1 (rb_wg_wgrad): the product sums over
//     rows, so both operands are stored MN-major ([rows][columns], SW128)
//     and wgmma reads them transposed. A CTA takes a chunk of rows
//     (`rows_per_split`, a multiple of 64 and a pure function of the shape)
//     and forms its D operand (dr3, dr2 or dr1) once a stage for two or
//     three A tiles: two 64-wide column tiles of A for W3 and W1; for W2 the
//     three taps of one kernel row di, cut from one forming of
//     relu(bn1(r1)) over the stage's rows and a row each side. The
//     mma.sync kernel formed W2's D tile once for every 64 of the 9 C rows
//     of dW2. TMA brings the raw tiles, the consumer warpgroups form them.
// The backward also stores dr3 [M, 4C] in bf16 between its two products,
// and the forward relu(bn2(r2)) [M, C] between F2 and F3, both of which
// the TPU kernels kept in VMEM.
#include <string.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"

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
  const void* w;     // products: B, bf16: [N, K] row-major (TMA,
                     // K-major); kF41: [K, N] row-major
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

// rb_k41's steps (mma.sync)
constexpr int BN = 64;           // columns of a step
constexpr int BK = 32;           // K per step
constexpr int LDA = BK + 8;      // shared row strides (bf16 elements)
constexpr int LDB = BN + 8;

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
  eResid,           // out = relu(acc * scale + bias + bf16(e0)) (T; the
                    // scale and bias of ebn)
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

// The BN vectors of 8 channels (ch .. ch + 7) that an operand's prologue
// reads, loaded once for all the rows a thread forms: kRelu's scale and
// bias; kBnBwd's mean, inv, c0, m1 and m2. apply() is opnd8's arithmetic.
template <int MODE>
struct Vec8 {
  static constexpr int kN = MODE == kRelu ? 2 : MODE == kBnBwd ? 5 : 1;
  float a[kN][8];

  __device__ __forceinline__ void load(const Opnd& o, int ch) {
    if constexpr (MODE == kRelu || MODE == kBnBwd) {
      if (ch >= o.C) return;            // a channel past C forms zeros
      const float* src[5] = {o.bn + kScale * o.C, o.bn + kBias * o.C};
      if constexpr (MODE == kBnBwd) {
        src[0] = o.bn + kMean * o.C;
        src[1] = o.bn + kInv * o.C;
        src[2] = o.bw + kC0 * o.C;
        src[3] = o.bw + kM1 * o.C;
        src[4] = o.bw + kM2 * o.C;
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(src[j] + ch));
        const float4 hi =
            __ldg(reinterpret_cast<const float4*>(src[j] + ch + 4));
        a[j][0] = lo.x; a[j][1] = lo.y; a[j][2] = lo.z; a[j][3] = lo.w;
        a[j][4] = hi.x; a[j][5] = hi.y; a[j][6] = hi.z; a[j][7] = hi.w;
      }
    }
  }

  // channel ch + e of the value g (and, kBnBwd, the BN input r)
  __device__ __forceinline__ float apply(int e, float g, float r) const {
    if constexpr (MODE == kRelu) {
      return fmaxf(__fadd_rn(__fmul_rn(g, a[0][e]), a[1][e]), 0.f);
    } else if constexpr (MODE == kBnBwd) {
      const float xh = __fmul_rn(__fsub_rn(r, a[0][e]), a[1][e]);
      const float t = __fsub_rn(__fsub_rn(g, a[3][e]), __fmul_rn(xh, a[4][e]));
      return __fmul_rn(a[2][e], t);
    } else {
      return g;
    }
  }
};

// --- operands from raw tiles in shared memory ---------------------------------
// What TMA brings for an operand in mode MODE: kBf16, and kCastT of bf16
// activations, are copied as they are, straight into the swizzled operand
// tile (kDirect); the other modes land as raw [rows][64] tiles (no swizzle)
// of X (x for kCastT and kBnBwd's g: T; kRelu's r: bf16) and, for kBnBwd,
// of r (bf16), and the consumer warpgroups form the bf16 operand from them.
template <int MODE, typename T>
struct RawOf {
  using X = std::conditional_t<MODE == kRelu || MODE == kBf16, bf16, T>;
  static constexpr bool kDirect =
      MODE == kBf16 || (MODE == kCastT && std::is_same<T, bf16>::value);
  static constexpr bool kR = MODE == kBnBwd;
  __host__ __device__ static constexpr int xbytes(int rows) {
    return kDirect ? 0 : rows * 64 * static_cast<int>(sizeof(X));
  }
  __host__ __device__ static constexpr int rbytes(int rows) {
    return kR ? rows * 128 : 0;
  }
};

// Eight bf16 operand values in mode MODE from eight values x (and, kBnBwd,
// the BN inputs r) and their channels' BN vectors: opnd8's arithmetic.
template <int MODE, typename T>
__device__ __forceinline__ uint4 form8(const Vec8<MODE>& vec,
                                       const typename RawOf<MODE, T>::X* x,
                                       const bf16* r) {
  float v[8], rv[8];
  load8(x, v);
  if constexpr (MODE == kBnBwd) load8(r, rv);
  uint4 out;
  bf16* h = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    h[e] = __float2bfloat16_rn(vec.apply(e, v[e], MODE == kBnBwd ? rv[e] : 0.f));
  return out;
}

// row `row`'s channels c .. c + 7 from global memory (zeros for row < 0)
template <int MODE, typename T>
__device__ __forceinline__ uint4 opnd8v(const Opnd& o, const Vec8<MODE>& vec,
                                        long long row, int c) {
  using X = typename RawOf<MODE, T>::X;
  if (row < 0) return make_uint4(0, 0, 0, 0);
  const long long off = row * o.C + c;
  return form8<MODE, T>(vec, static_cast<const X*>(o.x) + off,
                        static_cast<const bf16*>(o.r) + off);
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

// --- the Hopper bodies -------------------------------------------------------
// Shared pieces of rb_wg and rb_wg_wgrad (see the note at the top): tiles of
// rows of 64 bf16 values (128 bytes) in the SW128 layout, written by the
// producer warpgroup and read by wgmma through descriptors.
using namespace ptt::sm90;

constexpr int kWgStages = 4;        // the ring of stages in shared memory
constexpr int kWgK = 64;            // K of a stage: one 128-byte swizzle row
constexpr int kHaloLd = 72;         // staged rows' stride (bf16): 144 bytes
constexpr int kWgSmemMax = 232448;  // the dynamic shared memory a CTA may use

// chunk c (16 bytes) of row r of a 1024-byte-aligned SW128 tile
__device__ __forceinline__ uint8_t* sw128(uint8_t* tile, int r, int c) {
  return tile + r * 128 + ((c ^ (r & 7)) << 4);
}

// Rows of a 64-channel chunk (channel c0) of bf16 operand values in mode
// MODE (opnd8), taken by the 128 producer threads: thread tid takes
// channel group tid % 8 of rows r0 + 16 i (r0 = tid / 8 + ...), i < NR.
// load_rows forms the values of rows below `rows` from global row g0 + r
// (a row outside [lo, hi) or a channel past C is zeros); store_rows writes
// them plain (kHaloLd apart) or swizzled into an SW128 tile. A caller
// issues all of a stage's loads before its stores.
template <int MODE, typename T, int NR>
__device__ __forceinline__ void load_rows(const Opnd& o, const Vec8<MODE>& vec,
                                          long long g0, int r0, int rows,
                                          long long lo, long long hi, int c0,
                                          int tid, uint4 (&v)[NR]) {
  const int ch = c0 + 8 * (tid & 7);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = r0 + 16 * i;
    const long long gr = g0 + r;
    v[i] = opnd8v<MODE, T>(
        o, vec, r < rows && gr >= lo && gr < hi && ch < o.C ? gr : -1, ch);
  }
}

template <bool SWZ, int NR>
__device__ __forceinline__ void store_rows(uint8_t* dst, int r0, int rows,
                                           int tid, const uint4 (&v)[NR]) {
  const int c = tid & 7;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = r0 + 16 * i;
    if (r < rows)
      *reinterpret_cast<uint4*>(SWZ ? sw128(dst, r, c)
                                    : dst + r * (kHaloLd * 2) + 16 * c) =
          v[i];
  }
}

// `rows` rows from global row g0 on, 128 at a time (8 loads a thread in
// flight), the thread's 8 channels' BN vectors loaded once
template <int MODE, typename T, bool SWZ>
__device__ __forceinline__ void form_rows(const Opnd& o, uint8_t* dst,
                                          long long g0, int rows, long long lo,
                                          long long hi, int c0, int tid) {
  Vec8<MODE> vec;
  vec.load(o, c0 + 8 * (tid & 7));
  for (int r0 = tid >> 3; r0 < rows; r0 += 128) {
    uint4 v[8];
    load_rows<MODE, T, 8>(o, vec, g0, r0, rows, lo, hi, c0, tid, v);
    store_rows<SWZ, 8>(dst, r0, rows, tid, v);
  }
}

// Row m's place in its image, h << 16 | w (32-bit arithmetic: M < 2^31,
// W < 2^16), or -1 for a row past `valid` rows of the tile; computed once
// for the rows a thread copies, then read by every tap.
__device__ __forceinline__ int image_pos(const Args& p, int m, bool valid) {
  if (!valid) return -1;
  const int hw = m % (p.H * p.W);
  const int h = hw / p.W;
  return (h << 16) | (hw - h * p.W);
}

// Tap (di, dj) of the rows r = tid / 8 + 16 i (i < NR) of a tile, out of
// rows staged plain: row r is staged row r + shift, zeros where its
// neighbour (h + di, w + dj) lies outside the image or the row is past the
// tile's valid rows (pos[i] < 0). Swizzled into `tile`; 128 threads.
template <int NR>
__device__ __forceinline__ void copy_tap(const Args& p, const uint8_t* staged,
                                         uint8_t* tile, const int (&pos)[NR],
                                         int shift, int di, int dj, int tid) {
  const int c = tid & 7;
  uint4 v[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = (tid >> 3) + 16 * i;
    const int h = (pos[i] >> 16) + di, w = (pos[i] & 0xffff) + dj;
    v[i] = make_uint4(0, 0, 0, 0);
    if (pos[i] >= 0 && h >= 0 && h < p.H && w >= 0 && w < p.W)
      v[i] = *reinterpret_cast<const uint4*>(
          staged + (r + shift) * (kHaloLd * 2) + 16 * c);
  }
#pragma unroll
  for (int i = 0; i < NR; ++i)
    *reinterpret_cast<uint4*>(sw128(tile, (tid >> 3) + 16 * i, c)) = v[i];
}

// The producer's stores of a stage are visible to the consumers' wgmma
// once the 128 producer threads have fenced and met; then one arrival.
__device__ __forceinline__ void publish_stage(uint64_t* full, int tid) {
  fence_proxy_async();
  bar_sync(1, 128);
  if (tid == 0) mbar_arrive(full);
}

// row r's channel group c of raw tiles [rows][64] in shared memory (x, and
// r for kBnBwd); zeros unless ok
template <int MODE, typename T>
__device__ __forceinline__ uint4 opnd8_raw(const Vec8<MODE>& vec,
                                           const uint8_t* rx,
                                           const uint8_t* rr, int r, int c,
                                           bool ok) {
  using X = typename RawOf<MODE, T>::X;
  if (!ok) return make_uint4(0, 0, 0, 0);
  return form8<MODE, T>(vec, reinterpret_cast<const X*>(rx) + r * 64 + 8 * c,
                        reinterpret_cast<const bf16*>(rr) + r * 64 + 8 * c);
}

// --- the row products' epilogue ---------------------------------------------
// d[4 i + e] is row r_lo (+ 8 for e >= 2) of the tile, column
// n0 + 8 i + 2 t + (e & 1), r_lo = 128 mt + 64 wg + 16 w4 + g. The inputs
// of G column groups, and the BN vectors of their columns, are loaded
// before any of their stores (a load may not pass a store to memory that
// could alias it). The per-tile column sums: the 8 lanes of a column (g),
// then the 8 consumer warps in order (`ct`: the consumer thread 0..255;
// `bar`: their named barrier).
// whether an epilogue reads the input tiles e0 (and, eB1, e1)
template <int EPI>
struct EpiIn {
  static constexpr bool value = EPI != eStoreStats && EPI != eStats;
};

template <int EPI>
struct EpiVecs {
  // rows of ebn / ebw an epilogue reads: eB1 xhat; eDr3 xhat and the BN
  // backward's c0, m1, m2; eMaskStats the relu's scale and bias and xhat;
  // eResid the BN's scale and bias (eDx and the statistics epilogues
  // none)
  static constexpr bool kAny =
      EPI != eDx && EPI != eStoreStats && EPI != eStats;
  static constexpr int kN = EPI == eB1 || EPI == eResid ? 2
                            : EPI == eDr3               ? 5
                            : EPI == eMaskStats         ? 4
                                                        : 1;
  __device__ static const float* row(const Args& p, int j) {
    const int N = p.N;
    if constexpr (EPI == eResid) {
      return p.ebn + (j == 0 ? kScale : kBias) * N;
    } else if constexpr (EPI == eMaskStats) {
      const int rows[4] = {kScale, kBias, kMean, kInv};
      return p.ebn + rows[j] * N;
    } else if constexpr (EPI == eDr3) {
      return j < 2 ? p.ebn + (j == 0 ? kMean : kInv) * N
                   : p.ebw + (j == 2 ? kC0 : j == 3 ? kM1 : kM2) * N;
    } else {
      return p.ebn + (j == 0 ? kMean : kInv) * N;
    }
  }
};

// Two elements (columns cc, cc + 1) of row rr of an epilogue input tile
// that TMA wrote as boxes of 128 bytes a row (SW128) over the tile's 128
// rows: box cc / (128 / sizeof(E)), each 16 KB.
template <typename E>
__device__ __forceinline__ float2 tile2(const uint8_t* tile, int rr, int cc) {
  constexpr int kIn = 128 / static_cast<int>(sizeof(E));   // a box's columns
  constexpr int kCh = 16 / static_cast<int>(sizeof(E));    // a chunk's
  const int within = cc % kIn;
  const uint8_t* q = tile + (cc / kIn) * (128 * 128) + rr * 128 +
                     (((within / kCh) ^ (rr & 7)) << 4) +
                     (within % kCh) * static_cast<int>(sizeof(E));
  if constexpr (std::is_same<E, float>::value) {
    return *reinterpret_cast<const float2*>(q);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q));
  }
}

// `epi`: the tile's inputs in shared memory (e0's tile, then e1's), or
// null to read them from global memory
template <int EPI, typename T, int BNT>
__device__ __forceinline__ void row_epilogue(const Args& p,
                                             const float (&d)[BNT / 2],
                                             int mt, int n0, int wg, int w4,
                                             int g, int t, int ct, float* red,
                                             int bar, const uint8_t* epi) {
  constexpr int NI = BNT / 8;                // 8-column groups
  constexpr bool kStats = EPI == eB1 || EPI == eMaskStats ||
                          EPI == eStoreStats || EPI == eStats;
  constexpr bool kIn = EpiIn<EPI>::value;    // e0 (and e1) are read
  constexpr bool kTwo = EPI == eB1;          // dy and y
  constexpr int G = EPI == eDx ? 8 : 4;
  constexpr int NV = EpiVecs<EPI>::kN;
  using E0 = std::conditional_t<EPI == eMaskStats, bf16, T>;
  const int N = p.N;
  const int r_lo = mt * 128 + wg * 64 + w4 * 16 + g;
#pragma unroll
  for (int i0 = 0; i0 < NI; i0 += G) {
    float2 ea[G][2];
    [[maybe_unused]] float2 eb[G][2];
    [[maybe_unused]] float2 vv[NV][G];       // vv[j][i]: columns col, col + 1
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int col = n0 + 8 * (i0 + i) + 2 * t;
      if constexpr (EpiVecs<EPI>::kAny)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          vv[j][i] = col < N ? *reinterpret_cast<const float2*>(
                                   EpiVecs<EPI>::row(p, j) + col)
                             : make_float2(0.f, 0.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r_lo + 8 * half;
        const bool ok = row < p.M && col < N;
        if constexpr (!kIn) {
          ea[i][half] = make_float2(0.f, 0.f);
          continue;
        }
        if (epi != nullptr) {
          const int rr = row - mt * 128, cc = col - n0;
          ea[i][half] = tile2<E0>(epi, rr, cc);
          if constexpr (kTwo)
            eb[i][half] = tile2<T>(epi + 128 * BNT * sizeof(E0), rr, cc);
          continue;
        }
        const long long off = static_cast<long long>(row) * N + col;
        ea[i][half] = ok ? load2(static_cast<const E0*>(p.e0), off)
                         : make_float2(0.f, 0.f);
        if constexpr (kTwo)
          eb[i][half] = ok ? load2(static_cast<const T*>(p.e1), off)
                           : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int ii = i0 + i;
      const int col = n0 + 8 * ii + 2 * t;
      // the BN vectors of columns col + j
      [[maybe_unused]] float vec[NV][2];
      if constexpr (EpiVecs<EPI>::kAny)
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          vec[j][0] = vv[j][i].x;
          vec[j][1] = vv[j][i].y;
        }
      float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r_lo + 8 * half;
        if (row >= p.M || col >= N) continue;
        const long long off = static_cast<long long>(row) * N + col;
        const float v[2] = {d[4 * ii + 2 * half], d[4 * ii + 2 * half + 1]};
        const float2 e = ea[i][half];
        float a[2] = {0.f, 0.f}, b[2] = {0.f, 0.f};  // the sums' summands
        if constexpr (EPI == eB1) {                  // vec: mean, inv
          const float2 y = eb[i][half];
          const float dz[2] = {y.x > 0.f ? e.x : 0.f, y.y > 0.f ? e.y : 0.f};
          store2(static_cast<T*>(p.out), off, dz[0], dz[1]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            a[j] = dz[j];
            b[j] = dz[j] *
                   __fmul_rn(__fsub_rn(v[j], vec[0][j]), vec[1][j]);
          }
        } else if constexpr (EPI == eDr3) {  // vec: mean, inv, c0, m1, m2
          const float dzs[2] = {e.x, e.y};
          float dr[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float xh = __fmul_rn(__fsub_rn(v[j], vec[0][j]), vec[1][j]);
            const float tt = __fsub_rn(__fsub_rn(dzs[j], vec[3][j]),
                                       __fmul_rn(xh, vec[4][j]));
            dr[j] = __fmul_rn(vec[2][j], tt);
          }
          store2(static_cast<bf16*>(p.out), off, dr[0], dr[1]);
        } else if constexpr (EPI == eStoreStats || EPI == eStats) {
          if constexpr (EPI == eStoreStats)
            store2(static_cast<bf16*>(p.out), off, v[0], v[1]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            a[j] = v[j];
            b[j] = v[j] * v[j];
          }
        } else if constexpr (EPI == eResid) {  // vec: scale, bias
          const float xs[2] = {e.x, e.y};
          float y[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float xb = __bfloat162float(__float2bfloat16_rn(xs[j]));
            y[j] = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(v[j], vec[0][j]),
                                             vec[1][j]),
                                   xb),
                         0.f);
          }
          store2(static_cast<T*>(p.out), off, y[0], y[1]);
        } else if constexpr (EPI == eMaskStats) {
          // vec: scale, bias, mean, inv
          const float rs[2] = {e.x, e.y};
          float da[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float f = fmaxf(
                __fadd_rn(__fmul_rn(rs[j], vec[0][j]), vec[1][j]), 0.f);
            da[j] = f > 0.f ? v[j] : 0.f;
            a[j] = da[j];
            b[j] = da[j] *
                   __fmul_rn(__fsub_rn(rs[j], vec[2][j]), vec[3][j]);
          }
          store2(static_cast<T*>(p.out), off, da[0], da[1]);
        } else {  // eDx
          store2(static_cast<T*>(p.out), off, v[0] + e.x, v[1] + e.y);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s0[j] += a[j];
          s1[j] += b[j];
        }
      }
      if constexpr (kStats) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s0[j] += __shfl_xor_sync(0xffffffffu, s0[j], o);
            s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], o);
          }
        if (g == 0)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            red[(0 * 8 + wg * 4 + w4) * BNT + 8 * ii + 2 * t + j] = s0[j];
            red[(1 * 8 + wg * 4 + w4) * BNT + 8 * ii + 2 * t + j] = s1[j];
          }
      }
    }
  }
  if constexpr (kStats) {
    bar_sync(bar, 256);              // every warp's sums are in red
    for (int i = ct; i < 2 * BNT; i += 256) {
      const int which = i / BNT, col = i % BNT;
      if (n0 + col >= N) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[(which * 8 + w) * BNT + col];
      p.part[(static_cast<long long>(mt) * 2 + which) * N + n0 + col] = sum;
    }
    bar_sync(bar, 256);              // red is read before the next tile
  }
}

// --- row products: out [M, N] = A [M, K] . B [K, N] with fused edges ------
// (F1, F3, F4; B1, B2A, B2B, B4.) A CTA walks tiles tile = blockIdx.x,
// + gridDim.x, ... of 128 rows x BNT columns (columns fastest, so the
// CTAs at work share A's rows in L2), K in 64-channel steps. Warp 8
// issues the TMA loads of a ring of NS stages: each stage the B tile
// [BNT][64 k] and A's tile [128][64 k] (swizzled where A is a plain copy,
// else raw). Warpgroups 0 and 1 (rows 0-63, 64-127) each form their 64
// rows of A from the raw tiles (where A is raw), fence them into the
// async proxy, run wgmma m64nBNTk16 with one batch in flight (the forming
// of a stage overlaps the last stage's batch), and run the epilogue on its
// input tiles ([128][BNT] of e0, and of e1 for B1), which the TMA warp
// loads once the last tile's epilogue has read them, so they land during
// the tile's mainloop.
template <int AM, int EPI, typename T, int BNT>
struct RowCfg {
  using RO = RawOf<AM, T>;
  using E0 = std::conditional_t<EPI == eMaskStats, bf16, T>;
  static constexpr int kA = 128 * 128;                  // A tile bytes
  static constexpr int kB = BNT * 128;                  // B tile bytes
  static constexpr int kRX = RO::xbytes(128), kRR = RO::rbytes(128);
  static constexpr int kStage = kA + kB + kRX + kRR;
  // the epilogue's input tiles [128][BNT]: e0, and for eB1 e1 (y); kept
  // in shared memory where they fit beside two stages (bf16 activations),
  // else read from global memory (kE = 0)
  static constexpr int kE0 =
      EpiIn<EPI>::value ? 128 * BNT * static_cast<int>(sizeof(E0)) : 0;
  static constexpr int kRed = 2 * 8 * BNT * static_cast<int>(sizeof(float));
  static constexpr int kEAll =
      kE0 + (EPI == eB1 ? 128 * BNT * static_cast<int>(sizeof(T)) : 0);
  static constexpr int kE =
      kEAll + kRed + 2 * kStage <= 216 * 1024 ? kEAll : 0;
  // the ring: at least two stages (a stage is released once the next
  // one's batch is issued)
  static constexpr int NS = (216 * 1024 - kE - kRed) / kStage < 4
                                ? (216 * 1024 - kE - kRed) / kStage
                                : 4;
  static_assert(NS >= 2, "rb_wg needs two stages");
  static constexpr uint32_t kTx = kB + (RO::kDirect ? kA : kRX + kRR);
  static constexpr size_t smem = 1024 + static_cast<size_t>(NS) * kStage +
                                 kE + kRed + (2 * NS + 2) * sizeof(uint64_t);
};

template <int AM, int EPI, typename T, int BNT>
__global__ void __launch_bounds__(288, 1)
    rb_wg(const __grid_constant__ CUtensorMap tb,
          const __grid_constant__ CUtensorMap tax,
          const __grid_constant__ CUtensorMap tar,
          const __grid_constant__ CUtensorMap te0,
          const __grid_constant__ CUtensorMap te1, const Args p,
          int tiles_n) {
  using Cfg = RowCfg<AM, EPI, T, BNT>;
  using RO = typename Cfg::RO;
  constexpr int NS = Cfg::NS;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* st = align1024(wg_smem);       // [NS][A, B, raw x, raw r]
  uint8_t* epi = st + NS * Cfg::kStage;   // the epilogue's input tiles
  float* red = reinterpret_cast<float*>(epi + Cfg::kE);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 8 * BNT);
  uint64_t* empty = full + NS;
  uint64_t* efull = empty + NS;           // the epilogue tiles' barriers
  uint64_t* eempty = efull + 1;
  const int C = p.a.C;
  const int nk = (C + kWgK - 1) / kWgK;
  const int tiles = (p.M + 127) / 128 * tiles_n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);      // the TMA bytes' arrival
      mbar_init(&empty[s], 2);     // one arrival per consumer warpgroup
    }
    mbar_init(efull, 1);
    mbar_init(eempty, 2);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {                 // TMA
    if (lane == 0) {
      using E0 = typename Cfg::E0;
      constexpr int kIn0 = 128 / static_cast<int>(sizeof(E0));
      constexpr int kIn1 = 128 / static_cast<int>(sizeof(T));
      int it = 0, ti = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
        const int m0 = (tile / tiles_n) * 128, n0 = (tile % tiles_n) * BNT;
        // the tile's stages first, then (once the last tile's epilogue has
        // read them) its epilogue tiles, which land during its mainloop
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % NS;
          mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
          uint8_t* a = st + s * Cfg::kStage;
          mbar_expect_tx(&full[s], Cfg::kTx);
          tma_load_2d(a + Cfg::kA, &tb, &full[s], kc * kWgK, n0);
          if constexpr (RO::kDirect) {
            tma_load_2d(a, &tax, &full[s], kc * kWgK, m0);
          } else {
            tma_load_2d(a + Cfg::kA + Cfg::kB, &tax, &full[s], kc * kWgK,
                        m0);
            if constexpr (RO::kR)
              tma_load_2d(a + Cfg::kA + Cfg::kB + Cfg::kRX, &tar, &full[s],
                          kc * kWgK, m0);
          }
        }
        if constexpr (Cfg::kE > 0) {
          mbar_wait(eempty, (ti & 1) ^ 1);
          mbar_expect_tx(efull, Cfg::kE);
#pragma unroll
          for (int b = 0; b < BNT / kIn0; ++b)
            tma_load_2d(epi + b * 128 * 128, &te0, efull, n0 + b * kIn0, m0);
          if constexpr (EPI == eB1)
#pragma unroll
            for (int b = 0; b < BNT / kIn1; ++b)
              tma_load_2d(epi + Cfg::kE0 + b * 128 * 128, &te1, efull,
                          n0 + b * kIn1, m0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int tw = threadIdx.x & 127;
  const bool leader = tw == 0;
  int it = 0, ti = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
    const int mt = tile / tiles_n, m0 = mt * 128;
    const int n0 = (tile % tiles_n) * BNT;
    float d[BNT / 2];
    int prev = -1;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % NS;
      uint8_t* a = st + s * Cfg::kStage;
      mbar_wait(&full[s], (it / NS) & 1);
      __syncwarp();                // converged for the .aligned wgmma
      if constexpr (!RO::kDirect) {
        // this warpgroup's 64 rows of A, formed from the raw tiles
        const uint8_t* rx = a + Cfg::kA + Cfg::kB;
        const int c = tw & 7, ch = ks * kWgK + 8 * c;
        Vec8<AM> vec;
        vec.load(p.a, ch);
        uint4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wg * 64 + (tw >> 3) + 16 * i;
          v[i] = opnd8_raw<AM, T>(vec, rx, rx + Cfg::kRX, r, c,
                                  m0 + r < p.M && ch < C);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint4*>(
              sw128(a, wg * 64 + (tw >> 3) + 16 * i, c)) = v[i];
        fence_proxy_async();
        bar_sync(1 + wg, 128);
      }
      reg_fence(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgK / 16; ++kk)
        wgmma_ss_bf16<BNT, 0, 0>(
            d, make_desc(a + wg * 64 * 128 + kk * 32, 16, 1024, kSW128),
            make_desc(a + Cfg::kA + kk * 32, 16, 1024, kSW128),
            ks > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();             // the last step's batch is done
      reg_fence(d);
      if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    reg_fence(d);
    if (leader) mbar_arrive(&empty[prev]);
    if constexpr (Cfg::kE > 0) {
      mbar_wait(efull, ti & 1);
      __syncwarp();
    }
    row_epilogue<EPI, T, BNT>(p, d, mt, n0, wg, w4, g, t, threadIdx.x, red,
                              3, Cfg::kE > 0 ? epi : nullptr);
    if constexpr (Cfg::kE > 0) {
      // the warpgroup's four warps have read the epilogue tiles
      bar_sync(1 + wg, 128);
      if (leader) mbar_arrive(eempty);
    }
  }
}

// --- the 3x3 conv (F2) and the transposed 3x3 conv (B3) ---------------------
// As rb_wg, but warpgroup 0 produces: per 64-channel chunk of a tile it
// stages the tile's rows plus W + 1 rows each side once, the A prologue
// (F2's relu(bn1(r1)), B3's dr2) formed once a source row (direct loads,
// 128 rows at a time), and for each of the nine taps copies the shifted
// window into the stage's swizzled A tile beside the TMA-fed B tile;
// warpgroups 1 and 2 multiply.
template <int BNT>
struct ConvCfg {
  static constexpr int kA = 128 * 128;   // bytes of a stage's A tile
  static constexpr int kB = BNT * 128;   // bytes of its B tile
  static size_t smem(int halo_rows) {
    return 1024 + static_cast<size_t>(kWgStages) * (kA + kB) +
           sizeof(float) * 2 * 8 * BNT + 2 * kWgStages * sizeof(uint64_t) +
           static_cast<size_t>(halo_rows) * kHaloLd * 2;
  }
};

template <int AM, int EPI, typename T, int BNT>
__global__ void __launch_bounds__(384, 1)
    rb_wg_conv(const __grid_constant__ CUtensorMap tb, const Args p,
               int tiles_n) {
  using Cfg = ConvCfg<BNT>;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* As = align1024(wg_smem);                  // [stages][128][128 B]
  uint8_t* Bs = As + kWgStages * Cfg::kA;            // [stages][BNT][128 B]
  float* red = reinterpret_cast<float*>(Bs + kWgStages * Cfg::kB);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 8 * BNT);
  uint64_t* empty = full + kWgStages;
  uint8_t* halo = reinterpret_cast<uint8_t*>(empty + kWgStages);
  const int C = p.a.C;
  const int nc = (C + kWgK - 1) / kWgK;      // 64-channel chunks of A
  const int tiles = (p.M + 127) / 128 * tiles_n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 2);      // the B tile's bytes, the A tile's stores
      mbar_init(&empty[s], 2);     // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {                  // producer
    const int tid = threadIdx.x;
    const int lead = p.W + 1;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * 128;
      const int n0 = (tile % tiles_n) * BNT;
      int pos[8];                  // this thread's 8 rows of the tile
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + (tid >> 3) + 16 * i;
        pos[i] = image_pos(p, m, m < p.M);
      }
      for (int cc = 0; cc < nc; ++cc) {
        // the chunk's rows and halo, each source row's prologue once (the
        // last chunk's taps were copied before the last publish_stage)
        form_rows<AM, T, false>(p.a, halo, m0 - lead, 128 + 2 * lead, 0,
                                p.M, cc * kWgK, tid);
        bar_sync(1, 128);
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int s = it % kWgStages;
          mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
          if (tid == 0) {
            mbar_expect_tx(&full[s], Cfg::kB);
            tma_load_2d(Bs + s * Cfg::kB, &tb, &full[s],
                        tap * C + cc * kWgK, n0);
          }
          const int di = tap / 3 - 1, dj = tap % 3 - 1;
          copy_tap<8>(p, halo, As + s * Cfg::kA, pos, lead + di * p.W + dj,
                      di, dj, tid);
          publish_stage(&full[s], tid);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63
  const int wg = (warp >> 2) - 1, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  const int nk = nc * 9;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile / tiles_n;
    const int n0 = (tile % tiles_n) * BNT;
    float d[BNT / 2];
    int prev = -1;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % kWgStages;
      mbar_wait(&full[s], (it / kWgStages) & 1);
      __syncwarp();                // converged for the .aligned wgmma
      reg_fence(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgK / 16; ++kk)
        wgmma_ss_bf16<BNT, 0, 0>(
            d,
            make_desc(As + s * Cfg::kA + wg * 64 * 128 + kk * 32, 16, 1024,
                      kSW128),
            make_desc(Bs + s * Cfg::kB + kk * 32, 16, 1024, kSW128),
            ks > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();             // the last step's batch is done
      reg_fence(d);
      if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    reg_fence(d);
    if (leader) mbar_arrive(&empty[prev]);
    row_epilogue<EPI, T, BNT>(p, d, mt, n0, wg, w4, g, t, threadIdx.x - 128,
                              red, 2, nullptr);
  }
}

// --- weight gradients: part[z] [K, N] = sum over the rows of chunk z of
//     A(m, k) D(m, n) ------------------------------------------------------
// A CTA owns NA output tiles of 64 rows of K x 64 NB columns of N and a
// chunk of rows [mb, me) of the contraction (a multiple of 64 rows), 64 rows
// a stage. Warp 4 NA issues each stage's TMA loads: the NB D tiles and the
// A tiles (swizzled where the operand is a plain copy, else raw). The NA
// consumer warpgroups form the D tiles (shared) and their own A tile from
// the raw tiles: for W3 / W1 (NA = 2) two column tiles of A; for W2 (CONV,
// NA = 3) the taps dj = -1, 0, 1 of one kernel row di, copied out of
// relu(bn1(r1)) formed once over the stage's rows plus one row each side.
// Warpgroup j multiplies A tile j (read transposed) by the D tiles (read
// transposed) into its 64 x 64 NB sums.
template <int AM, bool CONV, int DM, typename T, int NB>
struct WgradCfg {
  static constexpr int NA = CONV ? 3 : 2;
  using RA = RawOf<AM, T>;
  using RD = RawOf<DM, T>;
  static constexpr int kTile = 64 * 128;              // [64 rows][64 bf16]
  static constexpr int kStaged = 66 * 128;            // CONV: raw r1 rows
  static constexpr int kRA = CONV ? 9 * 1024 : NA * RA::xbytes(64);
  static constexpr int kRD1 = RD::xbytes(64) + RD::rbytes(64);
  static constexpr int kStage = (NA + NB) * kTile + kRA + NB * kRD1;
  static constexpr int NS =
      (208 * 1024) / kStage < 4 ? (208 * 1024) / kStage : 4;
  static constexpr uint32_t kTx =
      (CONV ? kStaged : (RA::kDirect ? NA * kTile : kRA)) +
      NB * (RD::kDirect ? kTile : kRD1);
  static constexpr size_t smem = 1024 + static_cast<size_t>(NS) * kStage +
                                 2 * NS * sizeof(uint64_t) +
                                 (CONV ? 66 * kHaloLd * 2 : 0);
  static constexpr int kThreads = 128 * NA + 32;
};

template <int AM, bool CONV, int DM, typename T, int NB>
__global__ void __launch_bounds__(WgradCfg<AM, CONV, DM, T, NB>::kThreads, 1)
    rb_wg_wgrad(const __grid_constant__ CUtensorMap tax,
                const __grid_constant__ CUtensorMap tdx,
                const __grid_constant__ CUtensorMap tdr, const Args p) {
  using Cfg = WgradCfg<AM, CONV, DM, T, NB>;
  using RA = typename Cfg::RA;
  using RD = typename Cfg::RD;
  constexpr int NA = Cfg::NA, NS = Cfg::NS;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* st = align1024(wg_smem);  // [NS][A tiles, D tiles, raw A, raw D]
  uint64_t* full = reinterpret_cast<uint64_t*>(st + NS * Cfg::kStage);
  uint64_t* empty = full + NS;
  uint8_t* staged = reinterpret_cast<uint8_t*>(empty + NS);
  const int C = p.a.C, N = p.N, K = CONV ? 9 * C : C;
  // CONV: x = input-channel tile * 3 + (di + 1); else the NA column tiles
  // of A from 64 NA x on
  const int di = CONV ? static_cast<int>(blockIdx.x % 3) - 1 : 0;
  const int k0 = CONV ? static_cast<int>(blockIdx.x / 3) * 64
                      : static_cast<int>(blockIdx.x) * 64 * NA;
  const int n0 = blockIdx.y * 64 * NB;
  const int mb = blockIdx.z * p.rows_per_split;
  const int me = mb + p.rows_per_split < p.M ? mb + p.rows_per_split : p.M;
  const int chunks = (me - mb + 63) / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NA);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NA) {            // TMA
    if (lane == 0) {
      for (int ch = 0; ch < chunks; ++ch) {
        const int m0 = mb + 64 * ch;
        const int s = ch % NS;
        mbar_wait(&empty[s], ((ch / NS) & 1) ^ 1);
        uint8_t* a = st + s * Cfg::kStage;
        uint8_t* ra = a + (NA + NB) * Cfg::kTile;
        uint8_t* rd = ra + Cfg::kRA;
        mbar_expect_tx(&full[s], Cfg::kTx);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if constexpr (RD::kDirect) {
            tma_load_2d(a + (NA + b) * Cfg::kTile, &tdx, &full[s],
                        n0 + 64 * b, m0);
          } else {
            tma_load_2d(rd + b * Cfg::kRD1, &tdx, &full[s], n0 + 64 * b, m0);
            if constexpr (RD::kR)
              tma_load_2d(rd + b * Cfg::kRD1 + RD::xbytes(64), &tdr,
                          &full[s], n0 + 64 * b, m0);
          }
        }
        if constexpr (CONV) {
          tma_load_2d(ra, &tax, &full[s], k0, m0 + di * p.W - 1);
        } else {
#pragma unroll
          for (int j = 0; j < NA; ++j) {
            if constexpr (RA::kDirect)
              tma_load_2d(a + j * Cfg::kTile, &tax, &full[s], k0 + 64 * j,
                          m0);
            else
              tma_load_2d(ra + j * RA::xbytes(64), &tax, &full[s],
                          k0 + 64 * j, m0);
          }
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int tw = threadIdx.x & 127, ct = threadIdx.x;
  const bool leader = tw == 0;
  // the D tiles' chunks: thread ct forms tile db = ct % NB, chunks
  // ct / NB + j * DSTEP (channel group dc: fixed), so its BN vectors load
  // once; so do those of its A chunks (channel group tw % 8)
  constexpr int DSTEP = 128 * NA / NB;
  const int db = ct % NB, dc = (ct / NB) & 7;
  Vec8<DM> vd;
  vd.load(p.d, n0 + 64 * db + 8 * dc);
  Vec8<AM> va;
  va.load(p.a, CONV ? k0 + 8 * (tw & 7) : k0 + 64 * wg + 8 * (tw & 7));
  float d[NB][32];
  int prev = -1;
  for (int ch = 0; ch < chunks; ++ch) {
    const int m0 = mb + 64 * ch;
    const int s = ch % NS;
    uint8_t* a = st + s * Cfg::kStage;
    const uint8_t* ra = a + (NA + NB) * Cfg::kTile;
    const uint8_t* rd = ra + Cfg::kRA;
    mbar_wait(&full[s], (ch / NS) & 1);
    __syncwarp();                  // converged for the .aligned wgmma
    if constexpr (!RD::kDirect) {
      // the D tiles, shared by the warpgroups
      const uint8_t* x = rd + db * Cfg::kRD1;
      const bool cok = n0 + 64 * db + 8 * dc < N;
      for (int rc = ct / NB; rc < 512; rc += DSTEP) {
        const int r = rc >> 3;
        *reinterpret_cast<uint4*>(sw128(a + (NA + db) * Cfg::kTile, r, dc)) =
            opnd8_raw<DM, T>(vd, x, x + RD::xbytes(64), r, dc,
                             m0 + r < me && cok);
      }
    }
    if constexpr (CONV) {
      // relu(bn1(r1)) over rows m0 + di W - 1 .. m0 + di W + 64, plain
      for (int idx = ct; idx < 66 * 8; idx += 128 * NA) {
        const int r = idx >> 3, c = idx & 7;    // c == tw % 8
        const int gr = m0 + di * p.W - 1 + r;
        *reinterpret_cast<uint4*>(staged + r * (kHaloLd * 2) + 16 * c) =
            opnd8_raw<AM, T>(va, ra, nullptr, r, c,
                             gr >= 0 && gr < p.M && k0 + 8 * c < C);
      }
      int pos[4];                  // this thread's 4 rows of the stage
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + (tw >> 3) + 16 * i;
        pos[i] = image_pos(p, m, m < me);
      }
      bar_sync(1, 128 * NA);
      // this warpgroup's tap dj = wg - 1: row r is staged row r + wg
      copy_tap<4>(p, staged, a + wg * Cfg::kTile, pos, wg, di, wg - 1, tw);
    } else if constexpr (!RA::kDirect) {
      const int c = tw & 7, chn = k0 + 64 * wg + 8 * c;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (tw >> 3) + 16 * i;
        *reinterpret_cast<uint4*>(sw128(a + wg * Cfg::kTile, r, c)) =
            opnd8_raw<AM, T>(va, ra + wg * RA::xbytes(64), nullptr, r, c,
                             m0 + r < me && chn < C);
      }
    }
    fence_proxy_async();
    // every tile of the stage is formed (and, CONV, the staging is read)
    bar_sync(1, 128 * NA);
#pragma unroll
    for (int b = 0; b < NB; ++b) reg_fence(d[b]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        // 16 rows of the contraction a step: two 8-row groups 1024 bytes
        // apart, one 64-wide atom of M (A) and of N (D)
        wgmma_ss_bf16<64, 1, 1>(
            d[b], make_desc(a + wg * Cfg::kTile + kk * 2048, 1024, 1024,
                            kSW128),
            make_desc(a + (NA + b) * Cfg::kTile + kk * 2048, 1024, 1024,
                      kSW128),
            ch > 0 || kk > 0);
    wgmma_commit();
    // a stage is released once the next one's batch is issued; with one
    // stage (f32 operands), at once
    if constexpr (NS > 1) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) reg_fence(d[b]);
    if (NS == 1 && leader) mbar_arrive(&empty[s]);
    if (NS > 1 && prev >= 0 && leader) mbar_arrive(&empty[prev]);
    prev = NS > 1 ? s : -1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NB; ++b) reg_fence(d[b]);
  if (leader && prev >= 0) mbar_arrive(&empty[prev]);
  if (chunks == 0) return;

  // d[b][4 i + e]: output row (of K) kr (+ 8 for e >= 2) of the tile,
  // column n0 + 64 b + 8 i + 2 t + (e & 1)
  float* out = p.part + static_cast<long long>(blockIdx.z) * K * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kr = w4 * 16 + g + 8 * half;     // row of the 64-row tile
    int krow;
    bool ok;
    if constexpr (CONV) {
      krow = ((di + 1) * 3 + wg) * C + k0 + kr;
      ok = k0 + kr < C;
    } else {
      krow = k0 + 64 * wg + kr;
      ok = krow < K;
    }
    if (!ok) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = n0 + 64 * b + 8 * i + 2 * t;
        if (col < N)
          store2(out, static_cast<long long>(krow) * N + col,
                 d[b][4 * i + 2 * half], d[b][4 * i + 2 * half + 1]);
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

// --- relu(bn2(r2)) in bf16, formed once for F3 and F4 ---------------------
// out [M, C] = bf16(relu(r * scale + bias)) of the operand a (kRelu: r the
// bf16 rows a.x, scale and bias of a.bn), 8 channels a thread: exactly what
// rb_wg's consumers would form from raw r2 tiles, once instead of once for
// every 128 columns of N in each of the two products.
__global__ void __launch_bounds__(256)
    rb_form(const Opnd a, int M, bf16* __restrict__ out) {
  const int c8 = a.C / 8;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(M) * c8) return;
  Vec8<kRelu> vec;
  vec.load(a, static_cast<int>(i % c8) * 8);
  *reinterpret_cast<uint4*>(out + i * 8) = form8<kRelu, bf16>(
      vec, static_cast<const bf16*>(a.x) + i * 8, nullptr);
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
            kF41, kFA };

int form_a(const Args& p, cudaStream_t s) {
  if (p.a.x == nullptr || p.a.bn == nullptr || p.out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(p.M) * (p.a.C / 8);
  rb_form<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      p.a, p.M, static_cast<bf16*>(p.out));
  return 0;
}

// a TMA map of rows [M, C] of element type X (bf16 or f32) in boxes of
// `cols` channels x `rows` rows: SW128 for a tile TMA writes as the
// consumers read it (a bf16 operand; an epilogue input, 128 bytes a box
// row), no swizzle for a raw tile
template <typename X>
bool row_map(CUtensorMap* map, const void* base, int C, int M, int rows,
             bool swizzle, int cols = 64) {
  if (base == nullptr) {           // an operand the kernel does not read
    memset(map, 0, sizeof(*map));
    return true;
  }
  const uint64_t dims[2] = {static_cast<uint64_t>(C),
                            static_cast<uint64_t>(M)};
  const uint64_t strides[1] = {static_cast<uint64_t>(C) * sizeof(X)};
  const uint32_t box[2] = {static_cast<uint32_t>(cols),
                           static_cast<uint32_t>(rows)};
  return make_tmap<2>(map,
                      std::is_same<X, float>::value
                          ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      base, dims, strides, box,
                      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the B map of a backward row product: p.w [N, K] in boxes of 64 k x BNT
template <int BNT>
bool b_map(CUtensorMap* tb, const Args& p, int K) {
  const uint64_t dims[2] = {static_cast<uint64_t>(K),
                            static_cast<uint64_t>(p.N)};
  const uint64_t strides[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t box[2] = {static_cast<uint32_t>(kWgK),
                           static_cast<uint32_t>(BNT)};
  return make_tmap<2>(tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.w, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// a persistent grid: one CTA a multiprocessor, or one a tile
inline int persistent_grid(const Args& p, int tiles_n) {
  const long long tiles = (p.M + 127ll) / 128 * tiles_n;
  return static_cast<int>(tiles < sm_count() ? tiles : sm_count());
}

template <int AM, bool CONV, int EPI, typename T, int BNT>
int wg_gemm_bn(const Args& p, cudaStream_t s) {
  CUtensorMap tb;
  const int tiles_n = (p.N + BNT - 1) / BNT;
  if constexpr (CONV) {
    if (!b_map<BNT>(&tb, p, 9 * p.a.C))
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = ConvCfg<BNT>::smem(128 + 2 * (p.W + 1));
    if (smem > kWgSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    if (const int e =
            smem_opt_in<rb_wg_conv<AM, EPI, T, BNT>>(kWgSmemMax))
      return e;
    rb_wg_conv<AM, EPI, T, BNT><<<persistent_grid(p, tiles_n), 384, smem,
                                  s>>>(tb, p, tiles_n);
  } else {
    using Cfg = RowCfg<AM, EPI, T, BNT>;
    using X = typename Cfg::RO::X;
    using E0 = typename Cfg::E0;
    CUtensorMap tax, tar, te0, te1;
    if (!b_map<BNT>(&tb, p, p.a.C) ||
        !row_map<X>(&tax, p.a.x, p.a.C, p.M, 128, Cfg::RO::kDirect) ||
        !row_map<bf16>(&tar, Cfg::RO::kR ? p.a.r : nullptr, p.a.C, p.M, 128,
                       false) ||
        !row_map<E0>(&te0, p.e0, p.N, p.M, 128, true,
                     128 / static_cast<int>(sizeof(E0))) ||
        !row_map<T>(&te1, EPI == eB1 ? p.e1 : nullptr, p.N, p.M, 128, true,
                    128 / static_cast<int>(sizeof(T))))
      return static_cast<int>(cudaErrorInvalidValue);
    if (const int e = smem_opt_in<rb_wg<AM, EPI, T, BNT>>(Cfg::smem))
      return e;
    rb_wg<AM, EPI, T, BNT><<<persistent_grid(p, tiles_n), 288, Cfg::smem,
                             s>>>(tb, tax, tar, te0, te1, p, tiles_n);
  }
  return 0;
}

// tiles of 128 columns, or 64 where N is (layer1's C)
template <int AM, bool CONV, int EPI, typename T>
int wg_gemm(const Args& p, cudaStream_t s) {
  return p.N > 64 ? wg_gemm_bn<AM, CONV, EPI, T, 128>(p, s)
                  : wg_gemm_bn<AM, CONV, EPI, T, 64>(p, s);
}

// the [K, N] partial sums of each of p.splits row chunks (a multiple of 64
// rows each): the grid is the shape's tiles (ops/fused_resblock.py
// `_wgrad_tiles`) x the chunks
template <int AM, bool CONV, int DM, typename T, int NB>
int wg_wgrad_nb(const Args& p, cudaStream_t s) {
  using Cfg = WgradCfg<AM, CONV, DM, T, NB>;
  const int C = p.a.C;
  CUtensorMap tax, tdx, tdr;
  if (!row_map<typename Cfg::RA::X>(&tax, p.a.x, C, p.M, CONV ? 66 : 64,
                                    !CONV && Cfg::RA::kDirect) ||
      !row_map<typename Cfg::RD::X>(&tdx, p.d.x, p.N, p.M, 64,
                                    Cfg::RD::kDirect) ||
      !row_map<bf16>(&tdr, Cfg::RD::kR ? p.d.r : nullptr, p.N, p.M, 64,
                     false))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(CONV ? 3 * ((C + 63) / 64) : (C + 127) / 128,
                  (p.N + 64 * NB - 1) / (64 * NB), p.splits);
  if (const int e =
          smem_opt_in<rb_wg_wgrad<AM, CONV, DM, T, NB>>(Cfg::smem))
    return e;
  rb_wg_wgrad<AM, CONV, DM, T, NB><<<grid, Cfg::kThreads, Cfg::smem, s>>>(
      tax, tdx, tdr, p);
  return 0;
}

// 128 columns of N a CTA where N > 64 (two 64-wide D tiles)
template <int AM, bool CONV, int DM, typename T>
int wg_wgrad(const Args& p, cudaStream_t s) {
  if (p.rows_per_split % 64) return static_cast<int>(cudaErrorInvalidValue);
  if (p.N > 64) return wg_wgrad_nb<AM, CONV, DM, T, 2>(p, s);
  return wg_wgrad_nb<AM, CONV, DM, T, 1>(p, s);
}

template <typename T>
int dispatch(int kind, const Args& p, cudaStream_t s) {
  switch (kind) {
    // F2 and F3 read no activation of dtype T: one instantiation each
    case kF1: return wg_gemm<kCastT, false, eStoreStats, T>(p, s);
    case kF2: return wg_gemm<kRelu, true, eStoreStats, bf16>(p, s);
    case kF3: return wg_gemm<kBf16, false, eStats, bf16>(p, s);
    case kF4: return wg_gemm<kBf16, false, eResid, T>(p, s);
    case kB1: return wg_gemm<kRelu, false, eB1, T>(p, s);
    case kB2A: return wg_gemm<kRelu, false, eDr3, T>(p, s);
    case kB2B: return wg_gemm<kBf16, false, eMaskStats, T>(p, s);
    case kB3: return wg_gemm<kBnBwd, true, eMaskStats, T>(p, s);
    case kB4: return wg_gemm<kBnBwd, false, eDx, T>(p, s);
    case kW3: return wg_wgrad<kRelu, false, kBf16, T>(p, s);
    case kW2: return wg_wgrad<kRelu, true, kBnBwd, T>(p, s);
    case kW1: return wg_wgrad<kCastT, false, kBnBwd, T>(p, s);
    case kF41: return k41<T>(p, s);
    case kFA: return form_a(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One launch of the block (kind: Kind above; kFA forms relu(bn2(r2)) in
// bf16, no product). Every row tensor is contiguous [M, channels] and
// 16-byte aligned, every channel count a multiple of 8; weights are bf16,
// [N, K] row-major (the TMA operand), kF41's [K, N] row-major; dtype is the
// activations' (x, y, dy, dz, da2, da1, dx): 0 f32, 1 bf16.
extern "C" int ptt_resblock_gemm(int kind, const ptt::rb::Args* args,
                                 int dtype, void* stream) {
  const ptt::rb::Args& p = *args;
  if (p.M < 1 || p.N < 1 || p.N % 8 || p.a.C < 1 || p.a.C % 8 ||
      (kind >= kW3 && kind <= kW1 &&
       (p.splits < 1 || p.rows_per_split < 1)) ||
      ((kind == kF2 || kind == kB3 || kind == kW2) &&
       (p.W < 1 || p.W >= 65536)))
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
