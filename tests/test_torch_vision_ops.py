"""Port parity of the detection ops of `vision.ops` beyond `nms` /
`box_iou` — RoIAlign, RoI and PS-RoI pooling, box coding, prior boxes,
deformable convolution v1 / v2, YOLOv3's box decode and loss, the
proposal ops, matrix NMS and the image readers — against the JAX package
on the same numpy inputs, and by hand where the port gives an op
Paddle's meaning (matrix NMS, per-image FPN counts).

Tolerances (f32; the two sides round in another order): forward values
1e-5 relative to the largest magnitude (RoIAlign 1e-5: XLA may fuse the
sample-grid multiply-adds); gradients normwise 1e-5 (`jax` tape of the
JAX function against autograd); integer outputs, bin edges, kept sets,
orders and counts exactly; prior boxes bit-equal (both made in float64
on the host).
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from paddle_tpu.vision import ops as J

from paddle_tpu_torch.vision import ops as T


def _np(t):
    return np.asarray(t.numpy())


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _normwise(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _var(a):
    return paddle.to_tensor(a, stop_gradient=False)


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_(True)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _rois(rng, r, lo=0, hi=15, span=(2, 9)):
    xy = rng.uniform(lo, hi - span[1], (r, 2))
    wh = rng.uniform(*span, (r, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---------------------------------------------------------------- RoI ops

@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [-1, 3])
def test_roi_align_forward_and_gradients_match_jax(aligned, sampling_ratio):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16, 20).astype(np.float32)
    boxes = _rois(rng, 6, hi=18)
    boxes[0] = [-3.0, -2.0, 6.0, 25.0]          # samples clipped at edges
    bn = np.array([2, 4])
    cot = rng.randn(6, 5, 3, 4).astype(np.float32)
    jx, jb = _var(x), _var(boxes)
    ref = J.roi_align(jx, jb, bn, (3, 4), 0.9, sampling_ratio, aligned)
    (ref * paddle.to_tensor(cot)).sum().backward()
    tx, tb = _leaf(x), _leaf(boxes)
    got = T.roi_align(tx, tb, bn, (3, 4), 0.9, sampling_ratio, aligned)
    (got * torch.from_numpy(cot)).sum().backward()
    assert got.shape == (6, 5, 3, 4)
    assert _rel(got.detach().numpy(), _np(ref)) <= 1e-5
    assert _normwise(tx.grad.numpy(), _np(jx.grad)) <= 1e-5
    assert _normwise(tb.grad.numpy(), _np(jb.grad)) <= 1e-5


def test_roi_align_without_boxes_num_reads_image_0():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 9, 9).astype(np.float32)
    boxes = _rois(rng, 4, hi=9, span=(1, 4))
    ref = _np(J.roi_align(paddle.to_tensor(x), paddle.to_tensor(boxes)))
    got = T.roi_align(torch.from_numpy(x), torch.from_numpy(boxes))
    assert _rel(got.numpy(), ref) <= 1e-5
    layer = T.RoIAlign(7)
    np.testing.assert_array_equal(
        layer(torch.from_numpy(x), torch.from_numpy(boxes), [4, 0]).numpy(),
        got.numpy())


def _edge_boxes():
    """Bin edges on integers and halves (a rounding of the edges moves a
    floor or a ceil), a box wider than the map, one of height below 0.1
    (psroi_pool's float64 0.1) and one that collapses to a single cell."""
    return np.array([[0.0, 0.0, 6.0, 6.0], [1.5, 2.5, 7.5, 11.5],
                     [3.0, 1.0, 4.0, 1.05], [-4.0, -2.0, 30.0, 9.0],
                     [2.0, 3.0, 2.0, 3.0], [0.4, 0.6, 9.7, 8.2]],
                    np.float32)


@pytest.mark.parametrize("output_size,scale", [(3, 1.0), ((2, 4), 0.7)])
def test_roi_pool_matches_jax_on_edges_at_integers(output_size, scale):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 12, 14).astype(np.float32)
    boxes = np.concatenate([_edge_boxes(), _rois(rng, 4, hi=14)])
    bn = np.array([4, 6])
    ref = _np(J.roi_pool(paddle.to_tensor(x), paddle.to_tensor(boxes), bn,
                         output_size, scale))
    got = T.roi_pool(torch.from_numpy(x), torch.from_numpy(boxes), bn,
                     output_size, scale)
    np.testing.assert_array_equal(got.numpy(), ref)
    layer = T.RoIPool(output_size, scale)
    np.testing.assert_array_equal(
        layer(torch.from_numpy(x), torch.from_numpy(boxes), bn).numpy(), ref)


@pytest.mark.parametrize("output_size,scale", [(3, 1.0), ((2, 3), 0.5)])
def test_psroi_pool_matches_jax_on_edges_at_integers(output_size, scale):
    oh, ow = (output_size,) * 2 if isinstance(output_size, int) \
        else output_size
    rng = np.random.RandomState(3)
    x = rng.randn(2, 2 * oh * ow, 12, 14).astype(np.float32)
    boxes = np.concatenate([_edge_boxes(), _rois(rng, 4, hi=14)])
    bn = np.array([5, 5])
    ref = _np(J.psroi_pool(paddle.to_tensor(x), paddle.to_tensor(boxes), bn,
                           output_size, scale))
    got = T.psroi_pool(torch.from_numpy(x), torch.from_numpy(boxes), bn,
                       output_size, scale).numpy()
    assert got.shape == ref.shape == (10, 2, oh, ow)
    np.testing.assert_array_equal(got == 0, ref == 0)   # the empty bins
    assert _rel(got, ref) <= 1e-5
    layer = T.PSRoIPool(output_size, scale)
    assert _rel(layer(torch.from_numpy(x), torch.from_numpy(boxes),
                      bn).numpy(), ref) <= 1e-5


# ----------------------------------------------------------- box geometry

@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encodes_and_decodes_as_jax(normalized):
    rng = np.random.RandomState(4)
    prior, target = _rois(rng, 7, hi=20), _rois(rng, 7, hi=20)
    var = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (7, 1))
    args = [paddle.to_tensor(a) for a in (prior, var, target)]
    enc = _np(J.box_coder(*args, "encode_center_size", normalized))
    got = T.box_coder(torch.from_numpy(prior), torch.from_numpy(var),
                      torch.from_numpy(target), "encode_center_size",
                      normalized).numpy()
    assert _rel(got, enc) <= 1e-5
    dec = _np(J.box_coder(args[0], args[1], paddle.to_tensor(enc),
                          "decode_center_size", normalized))
    got = T.box_coder(torch.from_numpy(prior), torch.from_numpy(var),
                      torch.from_numpy(enc.copy()), "decode_center_size",
                      normalized).numpy()
    assert _rel(got, dec) <= 1e-5
    np.testing.assert_allclose(got, target, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[8.0], max_sizes=[16.0], aspect_ratios=[2.0], flip=True,
         clip=True),
    dict(min_sizes=[8.0, 12.0], max_sizes=[16.0, 20.0],
         aspect_ratios=[2.0, 3.0], min_max_aspect_ratios_order=True,
         steps=(6.0, 7.0), offset=0.25),
    dict(min_sizes=[4.0], aspect_ratios=[1.0, 0.5])])
def test_prior_box_equals_jax(kw):
    inp, img = torch.zeros(1, 3, 4, 5), torch.zeros(1, 3, 32, 40)
    rb, rv = J.prior_box(paddle.to_tensor(inp.numpy()),
                         paddle.to_tensor(img.numpy()), **kw)
    gb, gv = T.prior_box(inp, img, **kw)
    assert gb.device == inp.device
    np.testing.assert_array_equal(gb.numpy(), _np(rb))
    np.testing.assert_array_equal(gv.numpy(), _np(rv))


# ---------------------------------------------------------- deformable conv

@pytest.mark.parametrize("v2,groups,dg,stride,padding,dilation", [
    (True, 1, 1, 1, 1, 1), (False, 2, 2, 2, 0, 1), (True, 1, 2, 1, 2, 2)])
def test_deform_conv2d_forward_and_gradients_match_jax(v2, groups, dg,
                                                       stride, padding,
                                                       dilation):
    rng = np.random.RandomState(5)
    n, c, h, w, co = 2, 4, 9, 8, 6
    ho = (h + 2 * padding - dilation * 2 - 1) // stride + 1
    wo = (w + 2 * padding - dilation * 2 - 1) // stride + 1
    x = rng.randn(n, c, h, w).astype(np.float32)
    wt = (rng.randn(co, c // groups, 3, 3) * 0.3).astype(np.float32)
    off = (rng.randn(n, 2 * dg * 9, ho, wo) * 1.5).astype(np.float32)
    mk = rng.rand(n, dg * 9, ho, wo).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    cot = rng.randn(n, co, ho, wo).astype(np.float32)
    jv = [_var(a) for a in (x, off, wt, b, mk)]
    ref = J.deform_conv2d(jv[0], jv[1], jv[2], jv[3], stride, padding,
                          dilation, dg, groups, jv[4] if v2 else None)
    (ref * paddle.to_tensor(cot)).sum().backward()
    tv = [_leaf(a) for a in (x, off, wt, b, mk)]
    got = T.deform_conv2d(tv[0], tv[1], tv[2], tv[3], stride, padding,
                          dilation, dg, groups, tv[4] if v2 else None)
    (got * torch.from_numpy(cot)).sum().backward()
    assert _rel(got.detach().numpy(), _np(ref)) <= 1e-5
    for j, t in zip(jv[:4] + jv[4:] * v2, tv[:4] + tv[4:] * v2):
        assert _normwise(t.grad.numpy(), _np(j.grad)) <= 1e-5


def test_deform_conv2d_layer_draws_the_jax_layers_weights():
    jl = J.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    tl = T.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2,
                        device="cpu")
    np.testing.assert_array_equal(tl.weight.detach().numpy(),
                                  _np(jl.weight))
    np.testing.assert_array_equal(tl.bias.detach().numpy(), _np(jl.bias))
    rng = np.random.RandomState(6)
    x = rng.randn(1, 4, 5, 5).astype(np.float32)
    off = rng.randn(1, 36, 5, 5).astype(np.float32)
    mk = rng.rand(1, 18, 5, 5).astype(np.float32)
    ref = _np(jl(paddle.to_tensor(x), paddle.to_tensor(off),
                 paddle.to_tensor(mk)))
    got = tl(torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(mk))
    assert _rel(got.detach().numpy(), ref) <= 1e-5
    assert T.DeformConv2D(4, 6, 3, bias_attr=False, device="cpu").bias is None
    gen = torch.Generator().manual_seed(0)
    own = T.DeformConv2D(4, 6, 3, device="cpu", generator=gen)
    assert float(own.weight.detach().abs().max()) <= 1 / 6.0


# ------------------------------------------------------------------- YOLO

_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


@pytest.mark.parametrize("iou_aware,scale_x_y", [(False, 1.0), (True, 1.05),
                                                 (False, 1.2)])
def test_yolo_box_matches_jax(iou_aware, scale_x_y):
    rng = np.random.RandomState(7)
    cn = 3
    x = rng.randn(2, 3 * (5 + cn) + 3 * iou_aware, 5, 6).astype(np.float32)
    ims = np.array([[320, 384], [300, 200]], np.int32)
    rb, rs = J.yolo_box(paddle.to_tensor(x), paddle.to_tensor(ims),
                        _ANCHORS[:6], cn, 0.3, 32, True, scale_x_y=scale_x_y,
                        iou_aware=iou_aware, iou_aware_factor=0.4)
    gb, gs = T.yolo_box(torch.from_numpy(x), torch.from_numpy(ims),
                        _ANCHORS[:6], cn, 0.3, 32, True, scale_x_y=scale_x_y,
                        iou_aware=iou_aware, iou_aware_factor=0.4)
    assert gb.shape == (2, 90, 4) and gs.shape == (2, 90, cn)
    assert _rel(gb.numpy(), _np(rb)) <= 1e-5
    assert _rel(gs.numpy(), _np(rs)) <= 1e-5
    np.testing.assert_array_equal(gb.numpy() == 0, _np(rb) == 0)


def _yolo_gt(rng, n=3, b=6, cn=3):
    """Valid boxes then padding; image 1's boxes 0 and 1 share a cell
    and an anchor (the later one wins), one box of image 0 matches an
    anchor of another head, and image 2 has no box."""
    gt = np.zeros((n, b, 4), np.float32)
    gt[:, :4, :2] = rng.uniform(0.05, 0.95, (n, 4, 2))
    gt[:, :4, 2:] = rng.uniform(0.15, 0.5, (n, 4, 2))
    gt[1, 1] = gt[1, 0] + np.array([0.01, 0.01, 0.02, 0.0], np.float32)
    gt[0, 3, 2:] = [0.02, 0.03]
    gt[2] = 0.0
    labels = rng.randint(0, cn, (n, b))
    return gt, labels


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("gt_score", [False, True])
def test_yolo_loss_and_its_gradient_match_jax(smooth, gt_score):
    rng = np.random.RandomState(8)
    cn = 3
    x = rng.randn(3, 3 * (5 + cn), 6, 6).astype(np.float32)
    gt, labels = _yolo_gt(rng, cn=cn)
    score = rng.uniform(0.5, 1.0, labels.shape).astype(np.float32)
    kw = dict(use_label_smooth=smooth)
    jx = _var(x)
    ref = J.yolo_loss(jx, paddle.to_tensor(gt), paddle.to_tensor(labels),
                      _ANCHORS, [3, 4, 5], cn, 0.5, 32,
                      paddle.to_tensor(score) if gt_score else None, **kw)
    ref.sum().backward()
    tx = _leaf(x)
    got = T.yolo_loss(tx, torch.from_numpy(gt), torch.from_numpy(labels),
                      _ANCHORS, [3, 4, 5], cn, 0.5, 32,
                      torch.from_numpy(score) if gt_score else None, **kw)
    got.sum().backward()
    assert got.shape == (3,)
    assert _rel(got.detach().numpy(), _np(ref)) <= 1e-5
    assert _normwise(tx.grad.numpy(), _np(jx.grad)) <= 1e-5


def test_yolo_loss_ignore_mask_and_targets_match_the_jax_loops():
    """The targets alone: with an ignore threshold low enough that the
    mask has holes, x at zero except a few cells, every target tensor the
    JAX loop builds equals the port's."""
    rng = np.random.RandomState(9)
    cn = 2
    x = (rng.randn(3, 3 * (5 + cn), 5, 5) * 0.3).astype(np.float32)
    gt, labels = _yolo_gt(rng, cn=cn)
    gt[:2, :4, 2:] *= 0.3               # the sizes of anchors 0-2
    gt[1, 0] = [0.5, 0.5, 0.1, 0.1]
    gt[1, 1] = [0.52, 0.51, 0.11, 0.1]
    got = T._yolo_targets(torch.from_numpy(x), torch.from_numpy(gt),
                          torch.from_numpy(labels), torch.ones(labels.shape),
                          _ANCHORS, [0, 1, 2], cn, 0.2, 32, True)
    captured = {}
    real = J.apply

    def spy(name, fn, args, kw=None):
        if name == "yolo_loss":
            captured.update(zip(("tobj", "tscale", "txy", "twh", "tcls",
                                 "ign"), (_np(a) for a in args[1:])))
        return real(name, fn, args, kw)

    J.apply = spy
    try:
        J.yolo_loss(paddle.to_tensor(x), paddle.to_tensor(gt),
                    paddle.to_tensor(labels), _ANCHORS, [0, 1, 2], cn, 0.2,
                    32)
    finally:
        J.apply = real
    for name, t in zip(("tobj", "tscale", "txy", "twh", "tcls", "ign"), got):
        np.testing.assert_allclose(t.numpy(), captured[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    ign = got[5].numpy()
    assert 0 < ign[:2].sum() < ign[:2].size and ign[2].min() == 1.0
    # image 1's two boxes in cell (2, 2) of anchor 1: the later one's
    # offsets stand
    np.testing.assert_allclose(got[2].numpy()[1, 1, :, 2, 2], [0.6, 0.55],
                               rtol=1e-5)
    assert got[0].numpy()[1, 1, 2, 2] == 1.0


def test_yolo_loss_refuses_scale_x_y():
    x = torch.zeros(1, 3 * 7, 2, 2)
    gt = torch.zeros(1, 1, 4)
    with pytest.raises(NotImplementedError, match="scale_x_y"):
        T.yolo_loss(x, gt, torch.zeros(1, 1, dtype=torch.long), _ANCHORS,
                    [0, 1, 2], 2, 0.7, 32, scale_x_y=1.05)


# ------------------------------------------------------------- matrix NMS

def _paddle_matrix_nms(bx, sc, score_thr, post_thr, nms_top_k, keep_top_k,
                       gaussian, sigma, background):
    """Paddle's matrix_nms kernel, one pair at a time (phi matrix_nms
    CPU kernel's loops; the kept bound is the JAX function's >=)."""
    rows, idx, nums = [], [], []
    n, c, m = sc.shape
    for i in range(n):
        dets = []
        for k in range(c):
            if k == background:
                continue
            cand = [j for j in range(m) if sc[i, k, j] > score_thr]
            cand.sort(key=lambda j: -sc[i, k, j])
            if nms_top_k > -1:
                cand = cand[:nms_top_k]

            def iou(p, q):
                a, b = bx[i, p], bx[i, q]
                iw = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
                ih = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
                inter = iw * ih
                ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (
                    b[3] - b[1]) - inter
                return inter / ua

            comp = [max([iou(cand[p], cand[q]) for q in range(p)] or [0.0])
                    for p in range(len(cand))]
            for p, j in enumerate(cand):
                decay = 1.0
                for q in range(p):
                    u = iou(j, cand[q])
                    f = (np.exp((comp[q] ** 2 - u ** 2) * sigma) if gaussian
                         else (1 - u) / (1 - comp[q]))
                    decay = min(decay, f)
                ds = decay * sc[i, k, j]
                if ds >= post_thr:
                    dets.append((ds, k, j))
        dets.sort(key=lambda d: -d[0])
        if keep_top_k > -1:
            dets = dets[:keep_top_k]
        rows += [[k, ds, *bx[i, j]] for ds, k, j in dets]
        idx += [i * m + j for _, _, j in dets]
        nums.append(len(dets))
    return np.array(rows, np.float64).reshape(-1, 6), np.array(idx), nums


def _det_boxes(rng, n, m, span=40.0):
    xy = rng.uniform(0, span, (n, m, 2))
    wh = rng.uniform(4, 16, (n, m, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("tops", [(-1, -1), (12, 20), (-1, 7)])
def test_matrix_nms_is_paddles_pairwise_loop(gaussian, tops):
    rng = np.random.RandomState(10)
    bx = _det_boxes(rng, 2, 30)
    sc = rng.rand(2, 4, 30).astype(np.float32)
    args = (0.2, 0.15, tops[0], tops[1], gaussian, 2.0, 0)
    rows, idx, nums = _paddle_matrix_nms(bx, sc, *args)
    out, index, rn = T.matrix_nms(
        torch.from_numpy(bx), torch.from_numpy(sc), 0.2, 0.15, tops[0],
        tops[1], gaussian, 2.0, 0, return_index=True)
    assert rn.tolist() == nums and rn.dtype == torch.int32
    np.testing.assert_array_equal(index.numpy().ravel(), idx)
    np.testing.assert_allclose(out.numpy(), rows, rtol=1e-5, atol=1e-6)


def test_matrix_nms_three_boxes_decay_by_the_suppressors():
    """A on top, B overlapping A, C overlapping B and not A (two overlaps
    of 0.4: at 0.5 or more both, A and C would have to meet inside B).
    Paddle decays B by 1 - 0.4 and leaves C; the JAX function leaves B
    and decays C by 1 - 0.4."""
    bx = np.array([[[0, 0, 4, 10], [0, 0, 10, 10], [6, 0, 10, 10]]],
                  np.float32)
    iou = T.box_iou(torch.from_numpy(bx[0]), torch.from_numpy(bx[0]),
                    device="cpu").numpy()
    assert iou[0, 1] == np.float32(0.4) and iou[1, 2] == np.float32(0.4)
    assert iou[0, 2] == 0.0
    sc = np.array([[[0.0, 0.0, 0.0], [1.0, 0.9, 0.8]]], np.float32)
    out = T.matrix_nms(torch.from_numpy(bx), torch.from_numpy(sc), 0.05,
                       0.01, -1, -1, return_rois_num=False).numpy()
    got = {(r[2], r[4]): r[1] for r in out}
    np.testing.assert_allclose(got[(0.0, 4.0)], 1.0)
    np.testing.assert_allclose(got[(0.0, 10.0)], 0.9 * 0.6, rtol=1e-6)
    np.testing.assert_allclose(got[(6.0, 10.0)], 0.8, rtol=1e-6)
    ref = _np(J.matrix_nms(paddle.to_tensor(bx), paddle.to_tensor(sc), 0.05,
                           0.01, 100, 100, return_rois_num=False))
    ref = {(r[2], r[4]): r[1] for r in ref}
    np.testing.assert_allclose(ref[(0.0, 10.0)], 0.9, rtol=1e-6)
    np.testing.assert_allclose(ref[(6.0, 10.0)], 0.8 * 0.6, rtol=1e-6)


def test_matrix_nms_minus_one_keeps_every_box():
    """nms_top_k = keep_top_k = -1 keep all (the JAX function's [:-1]
    slices drop the last box of each class and of each image)."""
    rng = np.random.RandomState(11)
    bx = _det_boxes(rng, 1, 12, span=200.0)         # apart: no decay
    sc = rng.uniform(0.5, 1.0, (1, 2, 12)).astype(np.float32)
    out, rn = T.matrix_nms(torch.from_numpy(bx), torch.from_numpy(sc), 0.1,
                           0.1, -1, -1, background_label=-1)
    assert rn.tolist() == [24] and out.shape == (24, 6)
    ref, rref = J.matrix_nms(paddle.to_tensor(bx), paddle.to_tensor(sc), 0.1,
                             0.1, -1, -1, background_label=-1)
    assert _np(rref).tolist() == [21]


def _apart_chains(rng, n, m):
    """Boxes in pairs far from each other: no box overlaps both a higher-
    and a lower-scored box of its class."""
    base = rng.uniform(0, 10, (n, m // 2, 2)) + 60 * np.arange(
        m // 2)[None, :, None]
    wh = rng.uniform(10, 14, (n, m // 2, 2))
    a = np.concatenate([base, base + wh], -1)
    b = a + np.concatenate([rng.uniform(1, 5, (n, m // 2, 2))] * 2, -1)
    return np.concatenate([a, b], 1).astype(np.float32)


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms_equals_jax_where_no_box_is_in_a_chain(gaussian):
    """Where no box overlaps both a higher- and a lower-scored box, the
    two decays agree (the gaussian one at sigma 1, where Paddle's
    multiplication by sigma and the JAX division by it meet)."""
    rng = np.random.RandomState(12)
    bx = _apart_chains(rng, 2, 16)
    sc = rng.rand(2, 3, 16).astype(np.float32)
    kw = dict(use_gaussian=gaussian, gaussian_sigma=1.0, background_label=0,
              return_index=True)
    ref, rix, rn = J.matrix_nms(paddle.to_tensor(bx), paddle.to_tensor(sc),
                                0.1, 0.05, 100, 100, **kw)
    out, ix, n = T.matrix_nms(torch.from_numpy(bx), torch.from_numpy(sc),
                              0.1, 0.05, 100, 100, **kw)
    assert n.tolist() == _np(rn).tolist()
    np.testing.assert_array_equal(ix.numpy(), _np(rix))
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-6)


def test_matrix_nms_with_nothing_above_the_threshold():
    bx = np.zeros((2, 3, 4), np.float32)
    sc = np.full((2, 2, 3), 0.01, np.float32)
    out, ix, rn = T.matrix_nms(torch.from_numpy(bx), torch.from_numpy(sc),
                               0.5, 0.1, -1, -1, return_index=True)
    assert out.shape == (0, 6) and ix.shape == (0, 1)
    assert rn.tolist() == [0, 0]


# ---------------------------------------------------------- proposal ops

def _rpn(rng, n=2, a=3, h=6, w=7, stride=8.0):
    sc = rng.randn(n, a, h, w).astype(np.float32)
    bd = (rng.randn(n, 4 * a, h, w) * 0.5).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h) * stride, np.arange(w) * stride,
                         indexing="ij")
    sizes = np.array([16.0, 32.0, 48.0])[:a]
    anc = np.stack([xs[..., None] - sizes / 2, ys[..., None] - sizes / 2,
                    xs[..., None] + sizes / 2, ys[..., None] + sizes / 2],
                   -1).astype(np.float32)
    var = np.full_like(anc, 1.0)
    var[..., 2:] = 0.5
    ims = np.array([[48.0, 56.0], [40.0, 50.0]], np.float32)[:n]
    return sc, bd, ims, anc, var


@pytest.mark.parametrize("pixel_offset", [False, True])
@pytest.mark.parametrize("min_size,post", [(0.0, 20), (6.0, 300)])
def test_generate_proposals_matches_jax(pixel_offset, min_size, post):
    rng = np.random.RandomState(13)
    inputs = _rpn(rng)
    ref = J.generate_proposals(*(paddle.to_tensor(a) for a in inputs), 100,
                               post, 0.5, min_size, pixel_offset=pixel_offset,
                               return_rois_num=True)
    got = T.generate_proposals(*(torch.from_numpy(a) for a in inputs), 100,
                               post, 0.5, min_size, pixel_offset=pixel_offset,
                               return_rois_num=True)
    assert got[2].tolist() == _np(ref[2]).tolist()
    assert _rel(got[0].numpy(), _np(ref[0])) <= 1e-5
    np.testing.assert_array_equal(got[1].numpy(), _np(ref[1]))
    rois, scores = T.generate_proposals_v2(
        *(torch.from_numpy(a) for a in inputs), 100, post, 0.5, min_size,
        pixel_offset=pixel_offset)
    np.testing.assert_array_equal(rois.numpy(), got[0].numpy())


def test_generate_proposals_refuses_adaptive_nms():
    inputs = _rpn(np.random.RandomState(14))
    with pytest.raises(NotImplementedError, match="eta"):
        T.generate_proposals(*(torch.from_numpy(a) for a in inputs),
                             eta=0.9)


def test_distribute_fpn_proposals_matches_jax_and_counts_per_image():
    rng = np.random.RandomState(15)
    sizes = np.exp(rng.uniform(np.log(8), np.log(600), 40))
    xy = rng.uniform(0, 200, (40, 2))
    rois = np.concatenate([xy, xy + sizes[:, None] * rng.uniform(
        0.5, 2.0, (40, 2))], 1).astype(np.float32)
    rois_num = np.array([13, 0, 27], np.int32)
    for offset in (False, True):
        outs, restore, nums = J.distribute_fpn_proposals(
            paddle.to_tensor(rois), 2, 5, 4, 224, offset,
            rois_num=paddle.to_tensor(rois_num))
        go, gr, gn = T.distribute_fpn_proposals(
            torch.from_numpy(rois), 2, 5, 4, 224, offset,
            rois_num=torch.from_numpy(rois_num))
        assert len(go) == 4
        for a, b in zip(outs, go):
            np.testing.assert_array_equal(b.numpy(), _np(a))
        np.testing.assert_array_equal(gr.numpy(), _np(restore))
        assert gr.dtype == torch.int32
        # Paddle's counts: a level's RoIs per image; their sum is the
        # JAX function's one total
        img = np.repeat(np.arange(3), rois_num)
        back = torch.cat(go)[gr[:, 0].long()].numpy()
        np.testing.assert_array_equal(back, rois)
        lvl = np.concatenate([np.full(len(o), k) for k, o in enumerate(go)])
        lvl = lvl[gr[:, 0].numpy()]
        for k, (per, tot) in enumerate(zip(gn, nums)):
            want = [int(((lvl == k) & (img == i)).sum()) for i in range(3)]
            assert per.tolist() == want and per.dtype == torch.int32
            assert sum(want) == int(_np(tot)[0])
    _, _, none = T.distribute_fpn_proposals(torch.from_numpy(rois), 2, 5, 4,
                                            224)
    assert none is None


# ---------------------------------------------------------------- images

def test_read_file_and_decode_jpeg_match_jax(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(16)
    path = tmp_path / "a.jpg"
    Image.fromarray(rng.randint(0, 255, (12, 10, 3), np.uint8)).save(path)
    raw = T.read_file(str(path), device="cpu")
    assert raw.dtype == torch.uint8 and raw.device.type == "cpu"
    np.testing.assert_array_equal(raw.numpy(), _np(J.read_file(str(path))))
    for mode in ("unchanged", "gray", "rgb"):
        got = T.decode_jpeg(raw, mode, device="cpu")
        ref = _np(J.decode_jpeg(J.read_file(str(path)), mode))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert got.shape[0] == (1 if mode == "gray" else 3)


def test_numpy_inputs_go_to_the_gpu_unless_asked_for_the_cpu():
    rng = np.random.RandomState(17)
    x = rng.randn(1, 2, 6, 6).astype(np.float32)
    boxes = _rois(rng, 2, hi=6, span=(1, 3))
    for out in (T.roi_align(x, boxes, device="cpu"),
                T.box_coder(boxes, np.ones_like(boxes), boxes,
                            device="cpu"),
                T.roi_pool(x, boxes, None, 2, device="cpu")):
        assert out.device.type == "cpu"
    layer = T.DeformConv2D(2, 2, 3, device="cpu")
    assert layer.weight.device.type == "cpu"
    if not torch.cuda.is_available():
        for call in (lambda: T.roi_align(x, boxes),
                     lambda: T.matrix_nms(boxes[None], np.ones((1, 1, 2)),
                                          0.1, 0.1, -1, -1),
                     lambda: T.DeformConv2D(2, 2, 3),
                     lambda: T.read_file(__file__),
                     lambda: T.decode_jpeg(np.zeros(4, np.uint8))):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
