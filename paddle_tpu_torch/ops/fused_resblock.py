"""Fused train-mode ResNet bottleneck block, forward and backward
(counterpart of paddle_tpu/ops/pallas/fused_resblock.py: its
`fused_bottleneck_fwd`, `fused_bottleneck_bwd`, `bottleneck_reference`,
`fused_bottleneck`, `fused_bottleneck_auto` and `fused_block_impl`).

The block is the stride-1 identity bottleneck, channels 4C -> C -> C -> 4C,
on flat NHWC rows ``[M = N*H*W, channels]``::

    r1 = x @ w1                         bn1 stats from the f32 accumulator
    r2 = conv3x3(relu(bn1(r1)))         bn2 stats likewise
    r3 = relu(bn2(r2)) @ w3             bn3 stats; r3 is never stored
    y  = relu(bn3(r3) + x)              r3 recomputed

Three kernel wrappers over ``csrc/fused_resblock.cu``; one call is a
family of launches, and each wrapper counts them: ``.launches`` the
kernel launches (at each launch), ``.routes`` the launches of each body
(`ROUTE_NAMES`), ``.calls`` the calls on CUDA inputs:

* `fused_bottleneck_fwd` replaces the TPU kernels `_k1`..`_k4`
  (fused_resblock.py:141-188, through `_call` :321 from
  `fused_bottleneck_fwd` :334): four products on the Hopper bodies (F1,
  F3 and F4 on `rb_wg`, the 3x3 F2 on `rb_wg_conv`), relu(bn2(r2)) formed
  once in bf16 for F3 and F4 (`rb_form`), and three fixed-order
  reductions of the per-tile BN sums, eight launches (`FWD_PRODUCTS`);
* `fused_bottleneck_bwd` replaces `_b1`..`_b4` (:192-287, from
  `fused_bottleneck_bwd` :404): the full BN backward, fourteen launches
  (five row products with fused edges and three weight-gradient products
  on the Hopper bodies `rb_wg`, `rb_wg_conv` and `rb_wg_wgrad`, three BN
  reductions and three sums of the gradients' row chunks);
* `fused_bottleneck2_fwd` replaces the two-block chain of
  `fused_bottleneck2_fwd` (:612) with its coupled `_k41` (:593): block
  1's k4 and block 2's k1 in one kernel (`rb_wg_k41`: TMA and wgmma on
  64-row tiles, y1 handed to block 2's first product as K slices in
  shared memory, C <= 512); the other six products are the kernels
  above, fifteen launches. The reference wires it into no model
  (only `tools/bench_resstage.py` and its test call it): it measures
  whether the coupling pays.

Arithmetic, as the TPU kernels do it: matmul operands in `MATMUL_DTYPE`
(bf16) with f32 accumulation; r1 and r2 stored in bf16; each BN's sums
taken from the f32 accumulator before the store; single-pass
``mean = S/n``, ``var = max(S2/n - mean^2, 0)`` (`_stats`, the
reference's `_stats_to_scale_bias`); x rounded to bf16 once and used so
(the residual add and dW1 too); dz, da2, da1 and dx in dy's dtype;
gradients of the weights and BN vectors in f32.

A CUDA input launches the kernels (x f32 or bf16, every channel count a
multiple of 8, `MATMUL_DTYPE` bf16; anything else raises); a CPU input
computes the plain versions `fused_bottleneck_fwd_ref` /
`fused_bottleneck_bwd_ref`, which repeat the kernels' casts step by step
and also run on CUDA tensors (chip_smoke.py compares them there).
`MATMUL_DTYPE` mirrors the reference's module constant so the CPU tests
can set both to f32; it is not a knob of the model.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._counts import count, count_call

__all__ = ["MATMUL_DTYPE", "fused_bottleneck_fwd", "fused_bottleneck_bwd",
           "fused_bottleneck_fwd_ref", "fused_bottleneck_bwd_ref",
           "fused_bottleneck2_fwd", "fused_bottleneck2_fwd_ref",
           "bottleneck_reference", "fused_bottleneck",
           "fused_bottleneck_auto", "fused_block_impl", "flip_transpose_w2",
           "FWD_PRODUCTS", "ROUTE_NAMES"]

MATMUL_DTYPE = torch.bfloat16
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# rows of the [5, C] f32 BN vectors the forward keeps (and the kernels
# read): mean, biased variance, 1/sqrt(var + eps), scale = gamma * inv,
# bias = beta - mean * scale
_MEAN, _VAR, _INV, _SCALE, _BIAS = range(5)


# ------------------------------------------------------------------ plain

def flip_transpose_w2(w2):
    """The transposed 3x3 conv's kernel: spatial flip and in/out swap.
    conv_transpose(d, w2) == conv3x3(d, flip_transpose_w2(w2))."""
    return w2.flip(0, 1).permute(0, 1, 3, 2)


def _mm(a, b):
    """a @ b with f32 accumulation of MATMUL_DTYPE operands."""
    return a.float() @ b.float()


def _taps(f, N, H, W):
    """The nine shifted views of flat rows f [M, C]: tap (di, dj) holds
    the pixel (h + di, w + dj) of each output row, 0 outside the image
    (the reference's `_shift` with its `_tap_masks`), in the kernel's
    order di, dj = -1, 0, 1."""
    C = f.shape[-1]
    fp = torch.nn.functional.pad(f.reshape(N, H, W, C), (0, 0, 1, 1, 1, 1))
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            yield (di, dj), fp[:, 1 + di:1 + di + H,
                               1 + dj:1 + dj + W].reshape(N * H * W, C)


def _conv3x3(f, w2, N, H, W):
    """conv3x3 of flat rows f [M, Cin] (MATMUL_DTYPE) with w2 [3, 3, Cin,
    Cout]: the sum over the nine taps of shift @ w2[tap], in f32."""
    acc = None
    for (di, dj), g in _taps(f, N, H, W):
        t = _mm(g, w2[di + 1, dj + 1])
        acc = t if acc is None else acc + t
    return acc


def _stats(r, n, gamma, beta, eps):
    """[5, C] f32 BN vectors of the f32 rows r from their sums."""
    s0, s1 = r.sum(0), (r * r).sum(0)
    mean = s0 / n
    var = torch.clamp_min(s1 / n - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    scale = gamma * inv
    bias = beta - mean * scale
    return torch.stack([mean, var, inv, scale, bias])


def _affine_relu(r, bn):
    """relu(bn(r)) in f32 with bn folded into scale and bias."""
    return torch.relu(r.float() * bn[_SCALE] + bn[_BIAS])


def _bn_bwd(st0, st1, gamma, bn, n):
    """(c0, m1, m2) of a BN backward from its sums sum(g), sum(g * xhat):
    dr = c0 * ((g - m1) - xhat * m2)."""
    return gamma * bn[_INV], st0 / n, st1 / n


def _xhat(r, bn):
    return (r.float() - bn[_MEAN]) * bn[_INV]


def _vec(v):
    return v.float()


def _residuals(x, r1, r2, y, w1c, w2c, w3c, bn1, bn2, bn3, g1, g2, g3,
               eps):
    """What the backward needs, in the reference's residual order: x (the
    kernels round it to bf16 where they read it), r1, r2, y, the weights
    in MATMUL_DTYPE, each BN's [5, C] vectors and its gamma, and eps."""
    return (x, r1, r2, y, w1c, w2c, w3c, bn1, bn2, bn3, g1, g2, g3, eps)


def _block_ref(xb, w1c, w2c, w3c, g1, be1, g2, be2, g3, be3, eps, N, H, W):
    """The kernels' k1..k3 of one block on its bf16 input rows xb [M, 4C]:
    (r1, r2 in MATMUL_DTYPE, r3 in f32, bn1, bn2, bn3)."""
    n = float(xb.shape[0])
    md = MATMUL_DTYPE
    acc1 = _mm(xb, w1c)
    bn1 = _stats(acc1, n, g1, be1, eps)
    r1 = acc1.to(md)
    acc2 = _conv3x3(_affine_relu(r1, bn1).to(md), w2c, N, H, W)
    bn2 = _stats(acc2, n, g2, be2, eps)
    r2 = acc2.to(md)
    r3 = _mm(_affine_relu(r2, bn2).to(md), w3c)
    bn3 = _stats(r3, n, g3, be3, eps)
    return r1, r2, r3, bn1, bn2, bn3


def _y_f32(r3, bn3, xb):
    """relu(bn3(r3) + x) in f32, the residual x in bf16 rows."""
    return torch.relu(r3 * bn3[_SCALE] + bn3[_BIAS] + xb.float())


def fused_bottleneck_fwd_ref(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                             eps=1e-5):
    """Plain version of the forward: x [N, H, W, 4C]; w1 [4C, C],
    w2 [3, 3, C, C] (HWIO), w3 [C, 4C]; the BN vectors. Returns (y
    [N, H, W, 4C] in x's dtype, residuals, ((mean, var) of each BN))."""
    N, H, W, C4 = x.shape
    M, md = N * H * W, MATMUL_DTYPE
    w1c, w2c, w3c = (w.to(md) for w in (w1, w2, w3))
    g1, be1, g2, be2, g3, be3 = (_vec(v) for v in (g1, be1, g2, be2, g3,
                                                   be3))
    xb = x.reshape(M, C4).to(md)
    r1, r2, r3, bn1, bn2, bn3 = _block_ref(xb, w1c, w2c, w3c, g1, be1, g2,
                                           be2, g3, be3, eps, N, H, W)
    y = _y_f32(r3, bn3, xb).to(x.dtype)
    res = _residuals(x, r1, r2, y, w1c, w2c, w3c, bn1, bn2, bn3, g1, g2, g3,
                     eps)
    stats = tuple((bn[_MEAN], bn[_VAR]) for bn in (bn1, bn2, bn3))
    return y.reshape(N, H, W, C4), res, stats


def fused_bottleneck_bwd_ref(res, dy4):
    """Plain version of the backward (the reference's B1..B4): returns
    (dx in dy's dtype, dw1, dw2, dw3, dg1, dbe1, dg2, dbe2, dg3, dbe3) in
    f32."""
    x, r1, r2, y, w1c, w2c, w3c, bn1, bn2, bn3, g1, g2, g3, eps = res
    N, H, W, C4 = x.shape
    M, md, cdt = N * H * W, MATMUL_DTYPE, dy4.dtype
    n = float(M)
    dy = dy4.reshape(M, C4)
    xb = x.reshape(M, C4).to(md)
    # B1: dz and bn3's sums, r3 recomputed
    dz = torch.where(y.float() > 0, dy.float(), 0.0)
    dz_c = dz.to(cdt)
    f2 = _affine_relu(r2, bn2)
    f2b = f2.to(md)
    xh3 = (_mm(f2b, w3c) - bn3[_MEAN]) * bn3[_INV]
    dbe3, dg3 = dz.sum(0), (dz * xh3).sum(0)
    c03, m13, m23 = _bn_bwd(dbe3, dg3, g3, bn3, n)
    # B2: dr3, df2 = dr3 @ w3^T masked by f2 > 0, dW3, bn2's sums
    dr3b = (c03 * ((dz_c.float() - m13) - xh3 * m23)).to(md)
    da2 = torch.where(f2 > 0, _mm(dr3b, w3c.t()), 0.0)
    dw3 = _mm(f2b.t(), dr3b)
    xh2 = _xhat(r2, bn2)
    dbe2, dg2 = da2.sum(0), (da2 * xh2).sum(0)
    c02, m12, m22 = _bn_bwd(dbe2, dg2, g2, bn2, n)
    # B3: dr2, the transposed conv, da1, dW2 over the nine masked taps
    dr2b = (c02 * ((da2.to(cdt).float() - m12) - xh2 * m22)).to(md)
    df1 = _conv3x3(dr2b, flip_transpose_w2(w2c), N, H, W)
    f1 = _affine_relu(r1, bn1)
    f1b = f1.to(md)
    da1 = torch.where(f1 > 0, df1, 0.0)
    dw2 = torch.stack([_mm(g.t(), dr2b) for _, g in _taps(f1b, N, H, W)]
                      ).reshape(3, 3, *w2c.shape[2:])
    xh1 = _xhat(r1, bn1)
    dbe1, dg1 = da1.sum(0), (da1 * xh1).sum(0)
    c01, m11, m21 = _bn_bwd(dbe1, dg1, g1, bn1, n)
    # B4: dr1, dx = dr1 @ w1^T + dz, dW1
    dr1b = (c01 * ((da1.to(cdt).float() - m11) - xh1 * m21)).to(md)
    dx = (_mm(dr1b, w1c.t()) + dz_c.float()).to(cdt)
    dw1 = _mm(xb.t(), dr1b)
    return (dx.reshape(N, H, W, C4), dw1, dw2, dw3, dg1, dbe1, dg2, dbe2,
            dg3, dbe3)


def fused_bottleneck2_fwd_ref(x, params1, params2, eps=1e-5):
    """Plain version of two chained stride-1 blocks with the k4 -> k1
    coupling: params_i = (w1, w2, w3, g1, be1, g2, be2, g3, be3) in the
    layout of `fused_bottleneck_fwd`. The reference's roundings: block
    1's y is stored in x's dtype; block 2's first product takes block 1's
    in-register f32 y rounded to MATMUL_DTYPE; block 2's residual reads
    the stored y cast to MATMUL_DTYPE. Returns block 2's y [N, H, W, 4C]
    in x's dtype (only: the reference returns no residuals or
    statistics)."""
    N, H, W, C4 = x.shape
    M, md = N * H * W, MATMUL_DTYPE
    blocks = []
    for prm in (params1, params2):
        _check_shapes(x, *prm[:3])
        blocks.append([w.to(md) for w in prm[:3]]
                      + [_vec(v) for v in prm[3:]])
    xb = x.reshape(M, C4).to(md)
    *_, r3, _, _, bn3 = _block_ref(xb, *blocks[0], eps, N, H, W)
    y1f = _y_f32(r3, bn3, xb)
    y1 = y1f.to(x.dtype)
    *_, r3b, _, _, bn3b = _block_ref(y1f.to(md), *blocks[1], eps, N, H, W)
    y2 = _y_f32(r3b, bn3b, y1.to(md)).to(x.dtype)
    return y2.reshape(N, H, W, C4)


def bottleneck_reference(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                         eps=1e-5):
    """The train-mode bottleneck in f32 throughout, as the module
    composition computes it (the reference's `bottleneck_reference`):
    returns (y in x's dtype, ((mean, var) of each BN))."""
    xf = x.float()

    def bn(r, g, be):
        mu = r.mean(dim=(0, 1, 2))
        var = r.var(dim=(0, 1, 2), unbiased=False)
        return (r - mu) * torch.rsqrt(var + eps) * g.float() + be.float(), \
            mu, var

    a1, mu1, var1 = bn(xf @ w1.float(), g1, be1)
    r2 = torch.nn.functional.conv2d(
        torch.relu(a1).permute(0, 3, 1, 2), w2.float().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    a2, mu2, var2 = bn(r2, g2, be2)
    a3, mu3, var3 = bn(torch.relu(a2) @ w3.float(), g3, be3)
    y = torch.relu(a3 + xf).to(x.dtype)
    return y, ((mu1, var1), (mu2, var2), (mu3, var3))


# ------------------------------------------------------------------ kernels

# launch kinds of ptt_resblock_gemm (csrc/fused_resblock.cu `Kind`; _FA
# forms relu(bn2(r2)) in bf16)
_F1, _F2, _F3, _F4, _B1, _B2A, _B2B, _B3, _B4, _W3, _W2, _W1, _F41, _FA = \
    range(14)
# reduction modes of ptt_resblock_reduce
_SUM, _BN_FWD, _BN_BWD = range(3)
_TILE_ROWS = 128    # rows of a row product's tile (its sums' count)
_K41_ROWS = 64      # rows of the coupled kernel's tile (its sums' count)
_CHUNK = 64         # rows of a weight-gradient stage
_MIN_SPLIT = 256    # the fewest rows a weight-gradient CTA sums
_TARGET_CTAS = 528  # 4 waves of one CTA a multiprocessor on an H100


#: the bodies a family's launches run on (`.routes`' keys)
ROUTE_ROWS, ROUTE_CONV, ROUTE_WGRAD, ROUTE_FORM, ROUTE_REDUCE, ROUTE_K41 = \
    range(6)
ROUTE_NAMES = {ROUTE_ROWS: "rb_wg (TMA + wgmma row product)",
               ROUTE_CONV: "rb_wg_conv (TMA + wgmma, 3x3 from a staged halo)",
               ROUTE_WGRAD: "rb_wg_wgrad (TMA + wgmma weight gradient)",
               ROUTE_FORM: "rb_form (relu(bn2(r2)) in bf16)",
               ROUTE_REDUCE: "rb_bn / rb_sum (fixed-order reductions)",
               ROUTE_K41: "rb_wg_k41 (TMA + wgmma, the coupled pair)"}
_BODY = {_F1: ROUTE_ROWS, _F2: ROUTE_CONV, _F3: ROUTE_ROWS, _F4: ROUTE_ROWS,
         _B1: ROUTE_ROWS, _B2A: ROUTE_ROWS, _B2B: ROUTE_ROWS,
         _B3: ROUTE_CONV, _B4: ROUTE_ROWS, _W3: ROUTE_WGRAD,
         _W2: ROUTE_WGRAD, _W1: ROUTE_WGRAD, _F41: ROUTE_K41,
         _FA: ROUTE_FORM}
#: `fused_bottleneck_fwd`'s launches in order (`_fwd_cuda`)
FWD_PRODUCTS = ("F1", "bn1", "F2", "bn2", "form a2", "F3", "bn3", "F4")


class _Opnd(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("r", ctypes.c_void_p),
                ("bn", ctypes.c_void_p), ("bw", ctypes.c_void_p),
                ("C", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [("a", _Opnd), ("d", _Opnd), ("w", ctypes.c_void_p),
                ("e0", ctypes.c_void_p), ("e1", ctypes.c_void_p),
                ("ebn", ctypes.c_void_p), ("ebw", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("part", ctypes.c_void_p),
                ("M", ctypes.c_int), ("H", ctypes.c_int),
                ("W", ctypes.c_int), ("N", ctypes.c_int),
                ("splits", ctypes.c_int), ("rows_per_split", ctypes.c_int),
                ("w_next", ctypes.c_void_p), ("out_next", ctypes.c_void_p)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _opnd(x=None, r=None, bn=None, bw=None, C=0):
    return _Opnd(_ptr(x), _ptr(r), _ptr(bn), _ptr(bw), C)


def _wgrad_tiles(K, N, conv):
    """CTAs of one row chunk of a weight-gradient product [K, N]
    (`rb_wg_wgrad`'s grid but for the chunks): for the 3x3 one (K = 9 C)
    three kernel rows x the 64-wide input-channel tiles, otherwise the
    128-row tiles of K; x the output tiles, 128 wide where N > 64."""
    cols = -(-N // (128 if N > 64 else 64))
    if conv:
        return 3 * -(-(K // 9) // 64) * cols
    return -(-K // 128) * cols


def _splits(M, tiles):
    """Row chunks of a weight-gradient product: enough CTAs to fill the
    card, chunks of at least `_MIN_SPLIT` rows, a multiple of `_CHUNK` rows
    each. Returns (chunks, rows a chunk): a pure function of the shape, so
    the reduction order is fixed."""
    want = max(1, -(-_TARGET_CTAS // tiles))
    splits = max(1, min(want, M // _MIN_SPLIT))
    rows = -(-M // splits)
    rows = -(-rows // _CHUNK) * _CHUNK
    return -(-M // rows), rows


class _Launcher:
    """One call's launches on x's device and current stream, each counted
    on `wrapper.launches` where it is made."""

    def __init__(self, wrapper, x, M, H, W):
        self.wrapper = wrapper
        self.dev, self.M, self.H, self.W = x.device, M, H, W
        self.dtype = _build.dtype_code(x.dtype)
        self.lib = _build.lib()
        self.ctx, self.stream = _build.launch_on(x.device)

    def gemm(self, kind, what, a, N, w=None, d=None, e0=None, e1=None,
             ebn=None, ebw=None, out=None, part=None, splits=1, rows=0,
             w_next=None, out_next=None):
        args = _Args(a, d or _Opnd(), _ptr(w), _ptr(e0), _ptr(e1), _ptr(ebn),
                     _ptr(ebw), _ptr(out), _ptr(part), self.M, self.H,
                     self.W, N, splits, rows, _ptr(w_next), _ptr(out_next))
        with self.ctx:
            err = self.lib.ptt_resblock_gemm(kind, ctypes.byref(args),
                                             self.dtype, self.stream)
        _build.check(err, what)
        count(self.wrapper, _BODY[kind])

    def reduce(self, mode, what, part, T, N, out, gamma=None, beta=None,
               bn=None, eps=0.0, n=1.0):
        with self.ctx:
            err = self.lib.ptt_resblock_reduce(
                mode, part.data_ptr(), T, N, _ptr(gamma), _ptr(beta),
                _ptr(bn), float(eps), float(n), out.data_ptr(), self.stream)
        _build.check(err, what)
        count(self.wrapper, ROUTE_REDUCE)

    def stats(self, mode, what, part, N, gamma, beta=None, bn=None, eps=0.0):
        """[5, N] f32 BN vectors from the products' per-tile sums."""
        out = torch.empty((5, N), dtype=torch.float32, device=self.dev)
        self.reduce(mode, what, part, part.shape[0], N, out, gamma, beta,
                    bn, eps, float(self.M))
        return out

    def wgrad(self, kind, what, a, d, K, N):
        """A weight gradient [K, N] f32: per-chunk partial products, then
        their sum in chunk order."""
        splits, rows = _splits(self.M, _wgrad_tiles(K, N, kind == _W2))
        part = torch.empty((splits, K, N), dtype=torch.float32,
                           device=self.dev)
        self.gemm(kind, what, a, N, d=d, part=part, splits=splits, rows=rows)
        out = torch.empty((K, N), dtype=torch.float32, device=self.dev)
        self.reduce(_SUM, what + " (sum)", part, splits, K * N, out)
        return out

    def empty(self, rows, cols, dtype):
        return torch.empty((rows, cols), dtype=dtype, device=self.dev)

    def sums(self, N, rows=_TILE_ROWS):
        """Per-tile BN sums [ceil(M / rows), 2, N] of a product whose tiles
        are `rows` rows."""
        return torch.empty((-(-self.M // rows), 2, N), dtype=torch.float32,
                           device=self.dev)


def _cuda_checks(x, *others):
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused bottleneck kernels take f32 or bf16 "
                        f"activations, got {x.dtype}")
    if MATMUL_DTYPE != torch.bfloat16:
        raise TypeError(f"the fused bottleneck kernels multiply in bf16; "
                        f"MATMUL_DTYPE is {MATMUL_DTYPE}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"operands must share x's device {x.device}, "
                             f"got {t.device}")


def _aligned(t):
    """Contiguous, 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_shapes(x, w1, w2, w3):
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, 4C], got {tuple(x.shape)}")
    N, H, W, C4 = x.shape
    C = w1.shape[1]
    want = {"w1": (C4, C), "w2": (3, 3, C, C), "w3": (C, C4)}
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3)):
        if tuple(w.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(w.shape)}")
    return N, H, W, C4, C


def _cuda_operands(prm):
    """A block's weights in MATMUL_DTYPE and BN vectors in f32, aligned."""
    return ([_aligned(w.to(MATMUL_DTYPE)) for w in prm[:3]]
            + [_aligned(_vec(v)) for v in prm[3:]])


def _fwd_weights(w1c, w2c, w3c):
    """The forward products' B operands [N, K] (K-major, as TMA reads
    them) from the block's weights: w1 [4C, C] -> [C, 4C]; the 3x3's
    w2 [3, 3, C, C] -> [C, 9 C], K = tap * C + input channel with the taps
    (di, dj) in `_conv3x3`'s order; w3 [C, 4C] -> [4C, C]."""
    C = w1c.shape[1]
    return (_aligned(w1c.t()), _aligned(w2c.reshape(9 * C, C).t()),
            _aligned(w3c.t()))


def _check_channels(C4, C):
    if C % 8 or C4 % 8:
        raise ValueError(f"the kernels take channel counts that are "
                         f"multiples of 8, got C={C}, 4C={C4}")


def _block_head_cuda(L, what, xop, C4, C, wt, g1, be1, g2, be2, g3, be3,
                     eps, r1=None):
    """k1 (skipped when r1 and its bn1 come in: the coupled kernel made
    them), k2 and k3 of a block on the B operands wt (`_fwd_weights`):
    (r1, r2, a2 = relu(bn2(r2)) in bf16, bn1, bn2, bn3)."""
    M, md = L.M, MATMUL_DTYPE
    w1t, w2t, w3t = wt
    if r1 is None:
        r1 = L.empty(M, C, md)
        part = L.sums(C)
        L.gemm(_F1, f"{what} (k1)", xop, C, w=w1t, out=r1, part=part)
        bn1 = L.stats(_BN_FWD, f"{what} (bn1)", part, C, g1, be1, eps=eps)
    else:
        r1, bn1 = r1
    r2 = L.empty(M, C, md)
    part = L.sums(C)
    L.gemm(_F2, f"{what} (k2)", _opnd(r1, bn=bn1, C=C), C, w=w2t, out=r2,
           part=part)
    bn2 = L.stats(_BN_FWD, f"{what} (bn2)", part, C, g2, be2, eps=eps)
    # k3's and k4's A, formed once
    a2 = L.empty(M, C, md)
    L.gemm(_FA, f"{what} (a2)", _opnd(r2, bn=bn2, C=C), C, out=a2)
    part = L.sums(C4)
    L.gemm(_F3, f"{what} (k3)", _opnd(a2, C=C), C4, w=w3t, part=part)
    bn3 = L.stats(_BN_FWD, f"{what} (bn3)", part, C4, g3, be3, eps=eps)
    return r1, r2, a2, bn1, bn2, bn3


def _fwd_cuda(x, w1, w2, w3, g1, be1, g2, be2, g3, be3, eps):
    N, H, W, C4, C = _check_shapes(x, w1, w2, w3)
    _cuda_checks(x, w1, w2, w3, g1, be1, g2, be2, g3, be3)
    _check_channels(C4, C)
    M = N * H * W
    x = _aligned(x)
    w1c, w2c, w3c, g1, be1, g2, be2, g3, be3 = _cuda_operands(
        (w1, w2, w3, g1, be1, g2, be2, g3, be3))
    L = _Launcher(fused_bottleneck_fwd, x, M, H, W)
    wt = _fwd_weights(w1c, w2c, w3c)
    r1, r2, a2, bn1, bn2, bn3 = _block_head_cuda(
        L, "fused_bottleneck_fwd", _opnd(x, C=C4), C4, C, wt, g1, be1, g2,
        be2, g3, be3, eps)
    y = L.empty(M, C4, x.dtype)
    L.gemm(_F4, "fused_bottleneck_fwd (k4)", _opnd(a2, C=C), C4, w=wt[2],
           e0=x, ebn=bn3, out=y)
    res = _residuals(x, r1, r2, y, w1c, w2c, w3c, bn1, bn2, bn3, g1, g2, g3,
                     eps)
    stats = tuple((bn[_MEAN], bn[_VAR]) for bn in (bn1, bn2, bn3))
    return y.reshape(N, H, W, C4), res, stats


def _bwd_cuda(res, dy4):
    x, r1, r2, y, w1c, w2c, w3c, bn1, bn2, bn3, g1, g2, g3, eps = res
    N, H, W, C4 = x.shape
    C = r1.shape[1]
    if dy4.dtype != x.dtype or tuple(dy4.shape) != tuple(x.shape):
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy4.shape)} {dy4.dtype}")
    _cuda_checks(x, dy4)
    M, md = N * H * W, MATMUL_DTYPE
    dy = _aligned(dy4)
    L = _Launcher(fused_bottleneck_bwd, x, M, H, W)
    f2 = _opnd(r2, bn=bn2, C=C)
    # the row products read their weight B [K, N] as [N, K] (TMA, K-major)
    w3t = _aligned(w3c.t())
    # B1: dz = dy [y > 0], bn3's sums with r3 recomputed
    dz = L.empty(M, C4, x.dtype)
    part = L.sums(C4)
    L.gemm(_B1, "fused_bottleneck_bwd (b1)", f2, C4, w=w3t, e0=dy, e1=y,
           ebn=bn3, out=dz, part=part)
    bw3 = L.stats(_BN_BWD, "fused_bottleneck_bwd (bn3)", part, C4, g3,
                  bn=bn3)
    # B2: dr3 (bf16), then da2 = dr3 @ w3^T masked, bn2's sums, and dW3
    dr3 = L.empty(M, C4, md)
    L.gemm(_B2A, "fused_bottleneck_bwd (b2 dr3)", f2, C4, w=w3t, e0=dz,
           ebn=bn3, ebw=bw3, out=dr3)
    da2 = L.empty(M, C, x.dtype)
    part = L.sums(C)
    L.gemm(_B2B, "fused_bottleneck_bwd (b2)", _opnd(dr3, C=C4), C,
           w=_aligned(w3c),
           e0=r2, ebn=bn2, out=da2, part=part)
    bw2 = L.stats(_BN_BWD, "fused_bottleneck_bwd (bn2)", part, C, g2,
                  bn=bn2)
    dw3 = L.wgrad(_W3, "fused_bottleneck_bwd (dw3)", f2,
                  _opnd(dr3, C=C4), C, C4)
    del dr3
    # B3: dr2, the transposed conv, da1 masked, bn1's sums, and dW2
    dr2 = _opnd(da2, r2, bn2, bw2, C)
    da1 = L.empty(M, C, x.dtype)
    part = L.sums(C)
    L.gemm(_B3, "fused_bottleneck_bwd (b3)", dr2, C,
           w=_aligned(flip_transpose_w2(w2c).reshape(9 * C, C).t()), e0=r1,
           ebn=bn1, out=da1, part=part)
    bw1 = L.stats(_BN_BWD, "fused_bottleneck_bwd (bn1)", part, C, g1,
                  bn=bn1)
    dw2 = L.wgrad(_W2, "fused_bottleneck_bwd (dw2)", _opnd(r1, bn=bn1, C=C),
                  dr2, 9 * C, C).reshape(3, 3, C, C)
    # B4: dr1, dx = dr1 @ w1^T + dz, and dW1
    dr1 = _opnd(da1, r1, bn1, bw1, C)
    dx = L.empty(M, C4, x.dtype)
    L.gemm(_B4, "fused_bottleneck_bwd (b4)", dr1, C4, w=_aligned(w1c),
           e0=dz, out=dx)
    dw1 = L.wgrad(_W1, "fused_bottleneck_bwd (dw1)", _opnd(x, C=C4), dr1,
                  C4, C)
    return (dx.reshape(N, H, W, C4), dw1, dw2, dw3, bw1[1], bw1[0], bw2[1],
            bw2[0], bw3[1], bw3[0])


def _fwd2_cuda(x, params1, params2, eps):
    what = "fused_bottleneck2_fwd"
    N, H, W, C4, C = _check_shapes(x, *params1[:3])
    _check_shapes(x, *params2[:3])
    _cuda_checks(x, *params1, *params2)
    _check_channels(C4, C)
    M, md = N * H * W, MATMUL_DTYPE
    rows = _build.lib().ptt_resblock_k41_rows(C4)
    if rows == 0:
        raise ValueError(f"the coupled kernel takes 4C <= 2048, got {C4}")
    x = _aligned(x)
    p1, p2 = _cuda_operands(params1), _cuda_operands(params2)
    L = _Launcher(fused_bottleneck2_fwd, x, M, H, W)
    wt1, wt2 = _fwd_weights(*p1[:3]), _fwd_weights(*p2[:3])
    _, _, a2, _, _, bn3 = _block_head_cuda(
        L, what + " block 1", _opnd(x, C=C4), C4, C, wt1, *p1[3:], eps)
    # block 1's k4 coupled with block 2's k1 on a2 = relu(bn2(r2)) in bf16:
    # y1, r1 of block 2, its sums (a row per tile of `rows` rows)
    y1, r1b = L.empty(M, C4, x.dtype), L.empty(M, C, md)
    part = L.sums(C, rows)
    L.gemm(_F41, what + " (k4 + k1)", _opnd(a2, C=C), C4, w=wt1[2], e0=x,
           ebn=bn3, out=y1, part=part, w_next=wt2[0], out_next=r1b)
    bn1b = L.stats(_BN_FWD, what + " block 2 (bn1)", part, C, p2[3], p2[4],
                   eps=eps)
    _, _, a2b, _, _, bn3b = _block_head_cuda(
        L, what + " block 2", None, C4, C, wt2, *p2[3:], eps,
        r1=(r1b, bn1b))
    # block 2's k4: its residual y1 is read rounded to bf16, as the
    # reference's y1.astype(MATMUL_DTYPE)
    y2 = L.empty(M, C4, x.dtype)
    L.gemm(_F4, what + " block 2 (k4)", _opnd(a2b, C=C), C4, w=wt2[2],
           e0=y1, ebn=bn3b, out=y2)
    return y2.reshape(N, H, W, C4)


def fused_bottleneck2_fwd(x, params1, params2, eps=1e-5):
    """Two chained stride-1 identity blocks, forward only (the reference's
    stage probe): x [N, H, W, 4C]; params_i = (w1 [4C, C], w2 [3, 3, C, C],
    w3 [C, 4C], g1, be1, g2, be2, g3, be3). Returns block 2's y in x's
    dtype — the kernels for a CUDA x (block 1's k4 and block 2's k1 in the
    coupled kernel), the plain version for a CPU one."""
    if x.device.type == "cpu":
        return fused_bottleneck2_fwd_ref(x, params1, params2, eps)
    out = _fwd2_cuda(x, tuple(params1), tuple(params2), eps)
    count_call(fused_bottleneck2_fwd)
    return out


fused_bottleneck2_fwd.launches = fused_bottleneck2_fwd.calls = 0
fused_bottleneck2_fwd.routes = dict.fromkeys(ROUTE_NAMES, 0)


def fused_bottleneck_fwd(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                         eps=1e-5):
    """x [N, H, W, 4C] NHWC (f32 or bf16); w1 [4C, C], w2 [3, 3, C, C],
    w3 [C, 4C]; per-BN gamma/beta. Returns (y, residuals, ((mean, var) of
    each BN, f32)) — the kernels for a CUDA x, the plain version for a
    CPU one."""
    if x.device.type == "cpu":
        _check_shapes(x, w1, w2, w3)
        return fused_bottleneck_fwd_ref(x, w1, w2, w3, g1, be1, g2, be2, g3,
                                        be3, eps)
    out = _fwd_cuda(x, w1, w2, w3, g1, be1, g2, be2, g3, be3, eps)
    count_call(fused_bottleneck_fwd)
    return out


def fused_bottleneck_bwd(res, dy):
    """The forward's residuals and dy [N, H, W, 4C] -> (dx in dy's dtype,
    dw1, dw2, dw3, dg1, dbe1, dg2, dbe2, dg3, dbe3 in f32)."""
    if dy.device.type == "cpu":
        return fused_bottleneck_bwd_ref(res, dy)
    out = _bwd_cuda(res, dy)
    count_call(fused_bottleneck_bwd)
    return out


fused_bottleneck_fwd.launches = fused_bottleneck_fwd.calls = 0
fused_bottleneck_bwd.launches = fused_bottleneck_bwd.calls = 0
#: launches of each body (`ROUTE_NAMES`' codes)
fused_bottleneck_fwd.routes = dict.fromkeys(ROUTE_NAMES, 0)
fused_bottleneck_bwd.routes = dict.fromkeys(ROUTE_NAMES, 0)


# ------------------------------------------------------------------ autograd

class _FusedBottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, w3, g1, be1, g2, be2, g3, be3, eps):
        y, res, stats = fused_bottleneck_fwd(x, w1, w2, w3, g1, be1, g2,
                                             be2, g3, be3, eps)
        ctx.save_for_backward(*res[:-1])
        ctx.eps = res[-1]
        flat = tuple(t for pair in stats for t in pair)
        ctx.mark_non_differentiable(*flat)
        return (y,) + flat

    @staticmethod
    def backward(ctx, dy, *_stats):
        res = tuple(ctx.saved_tensors) + (ctx.eps,)
        x = res[0]
        grads = fused_bottleneck_bwd(res, dy.to(x.dtype).contiguous())
        return grads + (None,)


def fused_bottleneck(x, w1, w2, w3, g1, be1, g2, be2, g3, be3, eps=1e-5):
    """Differentiable fused bottleneck: returns (y, mu1, var1, mu2, var2,
    mu3, var3); the stats are detached (running-stat updates only)."""
    return _FusedBottleneck.apply(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                                  float(eps))


def fused_bottleneck_auto(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                          eps=1e-5):
    """Casts the parameters to f32 before the autograd boundary (the cast's
    backward returns the gradients in the caller's dtypes), so the op has
    one signature."""
    return fused_bottleneck(x, *(t.float() for t in (w1, w2, w3, g1, be1,
                                                     g2, be2, g3, be3)), eps)


def fused_block_impl(x, cw1, cw2, cw3, g1, be1, g2, be2, g3, be3, *, eps):
    """The model's entry (models/resnet.py): takes the layers' OIHW conv
    weights and views them as the flat kernels' w1 [4C, C], w2 HWIO,
    w3 [C, 4C]."""
    w1 = cw1[:, :, 0, 0].t()
    w2 = cw2.permute(2, 3, 1, 0)
    w3 = cw3[:, :, 0, 0].t()
    return fused_bottleneck_auto(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                                 eps)
