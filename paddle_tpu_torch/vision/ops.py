"""Detection ops (counterpart of paddle_tpu/vision/ops.py): plain PyTorch
on the tensors' device. Numpy inputs are placed on `device` (the GPU by
default, ``"cpu"`` on request); tensors are used where they lie.

`nms` keeps the JAX result exactly: boxes in score-descending order, ties
in input order (a stable sort, as `jnp.argsort` is); a box is dropped when
its IoU with a kept higher-scored box is strictly above `iou_threshold`;
the kept indices are -1-padded to N and `top_k` slices the padded vector.

The keep vector is the fixed point of ``keep[i] = eligible[i] and not
any(j < i: iou[i, j] > t and keep[j])``, which has one solution, reached
in at most N rounds from any start (after round r the first r entries are
final): greedy NMS. Each round is a few whole-matrix device ops, and the
host reads one flag every `_CHECK_EVERY` rounds to stop at the fixed
point: no host synchronisation per box and no data-dependent shape (the
padding is a scatter by the running count), so on the GPU the IoU matrix
and the scan stay on the card. `generate_proposals` runs the same scan
over all its images at once, its size filter as the eligible set.

Where the JAX function loops on the host (`roi_pool`, `psroi_pool`,
`yolo_loss`'s targets and ignore mask, `matrix_nms`, the proposal ops),
the port computes the same values as whole-tensor ops over RoIs, bins,
boxes, classes and images; the host reads only the sizes of its outputs.
`matrix_nms` and `distribute_fpn_proposals(rois_num=)` have Paddle's
meaning where the JAX functions differ (their docstrings say how).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..nn.functional.conv import _ntuple

__all__ = ["box_iou", "nms", "roi_align", "box_coder", "deform_conv2d",
           "yolo_box", "yolo_loss", "prior_box", "roi_pool", "psroi_pool",
           "matrix_nms", "distribute_fpn_proposals", "generate_proposals",
           "generate_proposals_v2", "read_file", "decode_jpeg", "RoIAlign",
           "RoIPool", "PSRoIPool", "DeformConv2D"]

#: rounds of the keep scan between two host reads of its convergence flag
_CHECK_EVERY = 8
#: elements of the largest intermediate a chunked op builds at once
_CHUNK_ELEMS = 1 << 25


def _as_tensor(x, device, dtype=None):
    if torch.is_tensor(x):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))


def _on(x, ref, dtype=None):
    """`x` (tensor, numpy or list) as a tensor on `ref`'s device."""
    if torch.is_tensor(x):
        return x.to(device=ref.device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=ref.device)


def _div(a, b):
    """a / b for a Python number b, correctly rounded on every device (a
    CUDA kernel multiplies by the reciprocal of a host scalar, which lands
    an ulp away: a bin edge of 2 becomes 1.9999999999999998)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _clip0(x):
    """max(x, 0) with `jnp.clip`'s gradient at 0 (half to each side)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _box_area(b, off=0.0):
    if off:
        return (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _iou_matrix(a, b, eps=1e-9, off=0.0):
    """IoU of [..., N, 4] x [..., M, 4] xyxy boxes -> [..., N, M]; `off`
    is added to widths and heights (1 for pixel boxes)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = _clip0(rb - lt + off) if off else _clip0(rb - lt)
    inter = wh[..., 0] * wh[..., 1]
    union = (_box_area(a, off)[..., :, None] + _box_area(b, off)[..., None, :]
             - inter)
    return inter / torch.clamp_min(union, eps)


def box_iou(boxes1, boxes2, *, device=None):
    """Pairwise IoU of [N, 4] x [M, 4] xyxy boxes (differentiable). Numpy
    inputs are placed on `device` (the GPU by default)."""
    return _iou_matrix(_as_tensor(boxes1, device), _as_tensor(boxes2, device))


def _greedy_keep(sup, eligible):
    """Greedy NMS over boxes in score order, batched: `sup` [B, n, n]
    (sup[b, i, j]: j, earlier, may drop i), `eligible` [B, n]. The fixed
    point of the keep scan (module docstring)."""
    n = sup.shape[-1]
    keep = eligible.clone()
    for r in range(n + 1):
        new = eligible & ~(sup & keep[:, None, :]).any(-1)
        if r % _CHECK_EVERY == _CHECK_EVERY - 1 or r == n:
            if torch.equal(new, keep):
                break
        keep = new
    return keep


def _suppressors(boxes_sorted, iou_threshold, eps=1e-9):
    """sup[..., i, j]: box j, earlier in score order, overlaps box i by
    more than the threshold."""
    n = boxes_sorted.shape[-2]
    iou = _iou_matrix(boxes_sorted, boxes_sorted, eps)
    earlier = torch.ones(n, n, dtype=torch.bool,
                         device=boxes_sorted.device).tril_(-1)
    return (iou > iou_threshold) & earlier


@torch.no_grad()
def _nms_impl(boxes, scores, iou_threshold):
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    sup = _suppressors(boxes[order], iou_threshold)
    keep = _greedy_keep(sup[None], torch.ones(1, n, dtype=torch.bool,
                                              device=boxes.device))[0]
    pos = torch.cumsum(keep, 0) - 1
    out = torch.full((n + 1,), -1, dtype=torch.int64, device=boxes.device)
    out.scatter_(0, torch.where(keep, pos, n), order)
    return out[:n]


def nms(boxes, scores=None, iou_threshold=0.3, top_k=None, *, device=None):
    """Indices of kept boxes, score-descending; -1-padded to N (the JAX
    function's static shape): slice with `top_k` or filter ``>= 0``.
    Without `scores` the boxes keep their input order. Runs on the
    tensors' device; numpy inputs are placed on `device` (the GPU by
    default)."""
    boxes = _as_tensor(boxes, device)
    if scores is None:
        scores = torch.arange(boxes.shape[0], 0, -1, dtype=boxes.dtype,
                              device=boxes.device)
    scores = _as_tensor(scores, device).to(boxes.device)
    idx = _nms_impl(boxes, scores, float(iou_threshold))
    if top_k is not None:
        idx = idx[:top_k]
    return idx


# ---------------------------------------------------------------- RoI ops

def _batch_index(boxes_num, r, ref):
    """The image of each of `r` RoIs: `boxes_num` RoIs per image, in
    order (all on image 0 without it)."""
    if boxes_num is None:
        return torch.zeros(r, dtype=torch.long, device=ref.device)
    bn = _on(boxes_num, ref, torch.long).reshape(-1)
    return torch.repeat_interleave(
        torch.arange(bn.numel(), device=ref.device), bn, output_size=r)


def roi_align(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, *, device=None):
    """RoIAlign: x [N, C, H, W], boxes [R, 4] xyxy in input coordinates,
    `boxes_num` RoIs per image (all on image 0 without it) -> [R, C, oh,
    ow]. Each bin averages an sr x sr grid of bilinear samples (sample
    coordinates clipped into the map, as the JAX function does);
    ``sampling_ratio <= 0`` takes the JAX function's fixed 2 x 2 grid
    (Paddle samples adaptively there). One gather over every RoI's
    samples, from the channels-last view of x; differentiable in x and
    boxes."""
    x = _as_tensor(x, device)
    boxes = _on(boxes, x, x.dtype)
    oh, ow = _ntuple(output_size, 2)
    sr = int(sampling_ratio) if sampling_ratio > 0 else 2
    n, c, h, w = x.shape
    r = boxes.shape[0]
    bi = _batch_index(boxes_num, r, x)
    b = boxes * spatial_scale - (0.5 if aligned else 0.0)
    x0, y0, x1, y1 = b.unbind(-1)
    if aligned:
        rw, rh = x1 - x0, y1 - y0
    else:
        one = torch.ones((), dtype=b.dtype, device=b.device)
        rw, rh = torch.maximum(x1 - x0, one), torch.maximum(y1 - y0, one)
    bh, bw = _div(rh, oh), _div(rw, ow)

    def grid(size, step, start):
        i = torch.arange(size, device=x.device, dtype=x.dtype)[:, None]
        s = torch.arange(sr, device=x.device, dtype=x.dtype)[None, :]
        st, b0 = step[:, None, None], start[:, None, None]
        return (i * st + b0 + _div((s + 0.5) * st, sr)).reshape(r, size * sr)

    def corners(v, size):
        v = torch.minimum(_clip0(v), torch.full((), size - 1.0,
                                                dtype=v.dtype,
                                                device=v.device))
        lo = torch.floor(v).long()
        hi = torch.clamp(lo + 1, max=size - 1)
        return lo, hi, v - lo.to(v.dtype)

    ylo, yhi, wy = corners(grid(oh, bh, y0), h)       # [R, oh * sr]
    xlo, xhi, wx = corners(grid(ow, bw, x0), w)       # [R, ow * sr]
    feat = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    row = (bi[:, None] * h)

    def at(yi, xi):
        idx = ((row + yi)[:, :, None] * w + xi[:, None, :])
        return feat[idx]                              # [R, Py, Px, C]

    wy, wx = wy[:, :, None, None], wx[:, None, :, None]
    vals = (at(ylo, xlo) * (1 - wy) * (1 - wx) + at(ylo, xhi) * (1 - wy) * wx
            + at(yhi, xlo) * wy * (1 - wx) + at(yhi, xhi) * wy * wx)
    vals = vals.reshape(r, oh, sr, ow, sr, c).mean((2, 4))
    return vals.permute(0, 3, 1, 2)


def _roi_chunks(r, per_roi):
    step = max(1, _CHUNK_ELEMS // max(per_roi, 1))
    return [(s, min(s + step, r)) for s in range(0, r, step)]


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None,
             *, device=None):
    """Max RoI pooling -> [R, C, oh, ow]: the JAX function's bins (the box
    scaled, floored and ceiled to integers, at least one cell; bin edges
    `np.linspace` of those in float64, each bin [floor(edge_i),
    ceil(edge_i+1)) clipped to the map; an empty bin is 0), all RoIs and
    bins at once (in chunks of RoIs)."""
    x = _as_tensor(x, device)
    boxes = _on(boxes, x, torch.float32)
    oh, ow = _ntuple(output_size, 2)
    n, c, h, w = x.shape
    r = boxes.shape[0]
    bi = _batch_index(boxes_num, r, x)
    s = boxes * spatial_scale
    x0, y0 = torch.floor(s[:, 0]).long(), torch.floor(s[:, 1]).long()
    x1, y1 = torch.ceil(s[:, 2]).long(), torch.ceil(s[:, 3]).long()
    x1, y1 = torch.maximum(x1, x0 + 1), torch.maximum(y1, y0 + 1)

    def edges(lo, hi, bins, size):
        # np.linspace(lo, hi, bins + 1): i * step + lo in float64, the
        # last edge exactly hi
        step = _div((hi - lo).double(), bins)
        e = torch.arange(bins + 1, device=x.device,
                         dtype=torch.float64)[None] * step[:, None] \
            + lo.double()[:, None]
        e[:, -1] = hi.double()
        a = torch.floor(e[:, :-1]).long().clamp(0, size)
        b = torch.ceil(e[:, 1:]).long().clamp(0, size)
        return a, b                                   # [R, bins]

    ya, yb = edges(y0, y1, oh, h)
    xa, xb = edges(x0, x1, ow, w)
    hs = torch.arange(h, device=x.device)
    ws = torch.arange(w, device=x.device)
    my = (hs >= ya[..., None]) & (hs < yb[..., None])     # [R, oh, H]
    mx = (ws >= xa[..., None]) & (ws < xb[..., None])     # [R, ow, W]
    neg = torch.full((), -math.inf, dtype=x.dtype, device=x.device)
    outs = []
    for lo, hi in _roi_chunks(r, c * h * w * max(oh, ow)):
        f = x[bi[lo:hi]]                                  # [r, C, H, W]
        cm = torch.where(mx[lo:hi, None, None], f[:, :, :, None, :],
                         neg).amax(-1)                    # [r, C, H, ow]
        m = torch.where(my[lo:hi, None, :, None, :],
                        cm.transpose(2, 3)[:, :, None], neg).amax(-1)
        outs.append(m)                                    # [r, C, oh, ow]
    out = torch.cat(outs) if outs else x.new_zeros((0, c, oh, ow))
    empty = ((yb <= ya)[:, :, None] | (xb <= xa)[:, None, :])[:, None]
    return torch.where(empty, torch.zeros((), dtype=x.dtype,
                                          device=x.device), out)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None, *, device=None):
    """Position-sensitive RoI pooling -> [R, C / (oh * ow), oh, ow]: bin
    (i, j) averages channels ``(i * ow + j) * co ...`` over [floor(y0 + i
    * rh), ceil(y0 + (i + 1) * rh)) x the same in x, with the JAX
    function's float32 edges (rh = max(y1 - y0, 0.1) / oh; the 0.1 in
    float64), clipped to the map; an empty bin is 0. Bin sums from one
    float64 summed-area table, all RoIs and bins at once."""
    x = _as_tensor(x, device)
    boxes = _on(boxes, x, torch.float32)
    oh, ow = _ntuple(output_size, 2)
    n, c, h, w = x.shape
    co = c // (oh * ow)
    r = boxes.shape[0]
    bi = _batch_index(boxes_num, r, x)
    s = boxes * spatial_scale
    tenth = torch.tensor(0.1, dtype=torch.float32, device=x.device)

    def edges(lo, hi, bins, size):
        ext = hi - lo
        i = torch.arange(bins + 1, device=x.device)
        step32 = _div(ext, bins)
        t32 = i.float()[None] * step32[:, None]
        t64 = (i.double() * (0.1 / bins)).float()[None].expand_as(t32)
        t = torch.where((tenth > ext)[:, None], t64, t32)
        e = lo[:, None] + t
        a = torch.floor(e[:, :-1]).long().clamp(0, size)
        b = torch.ceil(e[:, 1:]).long().clamp(0, size)
        return a, b

    ya, yb = edges(s[:, 1], s[:, 3], oh, h)               # [R, oh]
    xa, xb = edges(s[:, 0], s[:, 2], ow, w)               # [R, ow]
    sat = torch.zeros(n, c, h + 1, w + 1, dtype=torch.float64,
                      device=x.device)
    sat[:, :, 1:, 1:] = x.double().cumsum(2).cumsum(3)
    ch = ((torch.arange(oh, device=x.device)[:, None] * ow
           + torch.arange(ow, device=x.device)[None]) * co)[..., None] \
        + torch.arange(co, device=x.device)                # [oh, ow, co]
    base = (bi[:, None, None, None] * c + ch[None]) * (h + 1)

    def corner(yy, xx):
        idx = (base + yy[:, :, None, None]) * (w + 1) + xx[:, None, :, None]
        return sat.reshape(-1)[idx]                        # [R, oh, ow, co]

    total = (corner(yb, xb) - corner(ya, xb) - corner(yb, xa)
             + corner(ya, xa))
    area = ((yb - ya)[:, :, None] * (xb - xa)[:, None, :])[..., None]
    mean = total / area.clamp_min(1).double()
    empty = ((yb <= ya)[:, :, None] | (xb <= xa)[:, None, :])[..., None]
    mean = torch.where(empty, torch.zeros((), dtype=mean.dtype,
                                          device=x.device), mean)
    return mean.permute(0, 3, 1, 2).to(x.dtype)


# ----------------------------------------------------------- box geometry

def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, *,
              device=None):
    """Center-size box coding of [M, 4] rows against [M, 4] priors (the
    JAX function's row-wise form): ``encode_center_size`` gives
    ((tcx - pcx) / pw, (tcy - pcy) / ph, log(tw / pw), log(th / ph)) /
    var, ``decode_center_size`` inverts it. ``box_normalized=False`` adds
    one to widths and heights (pixel boxes)."""
    prior = _as_tensor(prior_box, device)
    var = _on(prior_box_var, prior, prior.dtype)
    target = _on(target_box, prior, prior.dtype)
    off = 0.0 if box_normalized else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = target[:, 2] - target[:, 0] + off
        th = target[:, 3] - target[:, 1] + off
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], -1)
        return out / var
    t = target * var
    cx = t[:, 0] * pw + pcx
    cy = t[:, 1] * ph + pcy
    w = torch.exp(t[:, 2]) * pw
    h = torch.exp(t[:, 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - off,
                        cy + h / 2 - off], -1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None, *, device=None):
    """SSD prior boxes of one feature map -> (boxes, variances), each [H,
    W, P, 4]. Only the shapes of `input` and `image` are read; the boxes
    are made on the host, as the JAX function makes them, and placed on
    `input`'s device (or `device` for an input that is not a tensor)."""
    feat_h, feat_w = int(input.shape[2]), int(input.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    step_w = steps[0] or img_w / feat_w
    step_h = steps[1] or img_h / feat_h
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    cell = []
    for k, ms in enumerate(min_sizes):
        big = [] if not max_sizes else [(np.sqrt(ms * max_sizes[k]),) * 2]
        shaped = [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in ars
                  if not (min_max_aspect_ratios_order
                          and abs(ar - 1.0) < 1e-6)]
        cell += ([(ms, ms)] + big + shaped if min_max_aspect_ratios_order
                 else shaped + big)
    wh = np.array(cell, np.float64)                       # [P, 2]
    cx = (np.arange(feat_w) + offset) * step_w
    cy = (np.arange(feat_h) + offset) * step_h
    cx = np.broadcast_to(cx[None, :, None], (feat_h, feat_w, len(cell)))
    cy = np.broadcast_to(cy[:, None, None], (feat_h, feat_w, len(cell)))
    b = np.stack([(cx - wh[:, 0] / 2) / img_w, (cy - wh[:, 1] / 2) / img_h,
                  (cx + wh[:, 0] / 2) / img_w, (cy + wh[:, 1] / 2) / img_h],
                 -1)
    if clip:
        b = np.minimum(np.maximum(b, 0.0), 1.0)
    v = np.broadcast_to(np.asarray(variance, np.float64), b.shape)
    dev = input.device if torch.is_tensor(input) else resolve_device(device)
    return (torch.as_tensor(b.astype(np.float32), device=dev),
            torch.as_tensor(np.ascontiguousarray(v, np.float32), device=dev))


# ---------------------------------------------------------- deformable conv

def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None, *, device=None):
    """Deformable convolution, v1 (``mask=None``) and v2 (DCN): each tap
    reads x at its offset position bilinearly (zero outside the map), v2
    scales it by `mask`, and one grouped product with `weight` [Co, C /
    groups, kh, kw] sums the column buffer [N, C * kh * kw, Ho * Wo]. x
    [N, C, H, W]; offset [N, 2 * dg * kh * kw, Ho, Wo] as (dy, dx) pairs
    per tap; mask [N, dg * kh * kw, Ho, Wo]. The four corner reads of all
    taps are four gathers; differentiable in x, offset, mask, weight and
    bias."""
    x = _as_tensor(x, device)
    offset, weight = _on(offset, x, x.dtype), _on(weight, x, x.dtype)
    n, c, h, w = x.shape
    co, cg, kh, kw = weight.shape
    (sh, sw), (ph, pw), (dh, dw) = (_ntuple(v, 2) for v in (stride, padding,
                                                             dilation))
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg, k = int(deformable_groups), kh * kw
    off = offset.reshape(n, dg, k, 2, ho, wo)
    taps = torch.arange(k, device=x.device)
    ky = (taps // kw).to(x.dtype)[:, None, None] * dh
    kx = (taps % kw).to(x.dtype)[:, None, None] * dw
    base_y = (torch.arange(ho, device=x.device) * sh - ph).to(x.dtype)
    base_x = (torch.arange(wo, device=x.device) * sw - pw).to(x.dtype)
    py = base_y[:, None] + ky + off[:, :, :, 0]           # [N, dg, K, Ho, Wo]
    px = base_x[None, :] + kx + off[:, :, :, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    xf = x.reshape(n, dg, c // dg, h * w)

    def gather(yy, xx):
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        lin = yy.long().clamp(0, h - 1) * w + xx.long().clamp(0, w - 1)
        idx = lin.reshape(n, dg, 1, -1).expand(n, dg, c // dg, -1)
        g = torch.gather(xf, 3, idx).reshape(n, dg, c // dg, k, ho, wo)
        return g * inb[:, :, None].to(x.dtype)

    v = (gather(y0, x0) * ((1 - wy) * (1 - wx))[:, :, None]
         + gather(y0, x0 + 1) * ((1 - wy) * wx)[:, :, None]
         + gather(y0 + 1, x0) * (wy * (1 - wx))[:, :, None]
         + gather(y0 + 1, x0 + 1) * (wy * wx)[:, :, None])
    if mask is not None:
        v = v * _on(mask, x, x.dtype).reshape(n, dg, k, ho, wo)[:, :, None]
    g = int(groups)
    col = v.reshape(n, g, (c // g) * k, ho * wo)
    out = torch.matmul(weight.reshape(g, co // g, cg * k)[None], col)
    out = out.reshape(n, co, ho, wo)
    if bias is not None:
        out = out + _on(bias, x, x.dtype).reshape(1, -1, 1, 1)
    return out


# ------------------------------------------------------------------- YOLO

def _anchor_table(anchors, ref):
    return torch.tensor(np.asarray(anchors, np.float32).reshape(-1, 2),
                        device=ref.device)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, *, device=None):
    """Decode a YOLOv3 head [N, an * (5 + C), H, W] (an IoU channel per
    anchor first with `iou_aware`) into boxes [N, an * H * W, 4] (xyxy in
    image pixels, clipped with `clip_bbox`) and scores [N, an * H * W, C];
    boxes whose objectness is not above `conf_thresh` are zeroed."""
    x = _as_tensor(x, device)
    n, _, h, w = x.shape
    anc = _anchor_table(anchors, x)
    an = anc.shape[0]
    if iou_aware:
        ious = x[:, :an].reshape(n, an, 1, h, w)
        x = x[:, an:]
    f = x.reshape(n, an, 5 + class_num, h, w)
    cx = torch.arange(w, device=x.device, dtype=x.dtype)
    cy = torch.arange(h, device=x.device, dtype=x.dtype)[:, None]
    bx = _div(torch.sigmoid(f[:, :, 0]) * scale_x_y - 0.5 * (scale_x_y - 1)
              + cx, w)
    by = _div(torch.sigmoid(f[:, :, 1]) * scale_x_y - 0.5 * (scale_x_y - 1)
              + cy, h)
    bw = _div(torch.exp(f[:, :, 2]) * anc[None, :, 0, None, None],
              w * downsample_ratio)
    bh = _div(torch.exp(f[:, :, 3]) * anc[None, :, 1, None, None],
              h * downsample_ratio)
    conf = torch.sigmoid(f[:, :, 4])
    if iou_aware:
        conf = conf ** (1 - iou_aware_factor) * torch.sigmoid(
            ious[:, :, 0]) ** iou_aware_factor
    probs = torch.sigmoid(f[:, :, 5:]) * conf[:, :, None]
    size = _on(img_size, x, x.dtype)
    img_h, img_w = size[:, 0, None, None, None], size[:, 1, None, None, None]
    x0 = (bx - bw / 2) * img_w
    y0 = (by - bh / 2) * img_h
    x1 = (bx + bw / 2) * img_w
    y1 = (by + bh / 2) * img_h
    if clip_bbox:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)

        def clip(v, hi):
            return torch.minimum(torch.maximum(v, zero), hi - 1)

        x0, y0, x1, y1 = clip(x0, img_w), clip(y0, img_h), clip(x1, img_w), \
            clip(y1, img_h)
    boxes = torch.stack([x0, y0, x1, y1], -1).reshape(n, -1, 4)
    scores = probs.movedim(2, -1).reshape(n, -1, class_num)
    keep = (conf.reshape(n, -1, 1) > conf_thresh).to(x.dtype)
    return boxes * keep, scores * keep


def _bce(logit, target):
    return (_clip0(logit) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


@torch.no_grad()
def _yolo_targets(x, gt, gl, gs, anchors, an_mask, class_num, ignore_thresh,
                  downsample_ratio, use_label_smooth):
    """The JAX function's host loops as tensor ops over images, gt boxes
    and anchors: best anchor of each gt box by (w, h) IoU at the origin
    (the first of equal ones); a box whose best anchor is in `an_mask`
    writes its cell (a later box of an image overwrites an earlier one in
    the same cell, as the loop's later iteration does); the ignore mask
    from every predicted box's best IoU against the image's valid gt boxes
    (in float64, as numpy promotes it there)."""
    n, _, h, w = x.shape
    nm = len(an_mask)
    cells = h * w
    dev, f32 = x.device, torch.float32
    allanc = _anchor_table(anchors, x)
    input_size = downsample_ratio * h
    gw, gh = gt[..., 2], gt[..., 3]
    valid = ~((gw <= 0) | (gh <= 0))                      # [N, B]
    aw, ah = _div(allanc[:, 0], input_size), _div(allanc[:, 1], input_size)
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None],
                                                             ah)
    iou = inter / ((gw * gh)[..., None] + aw * ah - inter)
    best = iou.argmax(-1)                                 # [N, B]
    midx = torch.tensor(an_mask, device=dev)
    hit = best[..., None] == midx
    k = hit.int().argmax(-1)
    assigned = valid & hit.any(-1)
    gi = torch.clamp((gt[..., 0] * w).long(), max=w - 1)
    gj = torch.clamp((gt[..., 1] * h).long(), max=h - 1)
    gi, gj = torch.where(gi < 0, gi + w, gi), torch.where(gj < 0, gj + h, gj)
    nb = gt.shape[1]
    img = torch.arange(n, device=dev)[:, None].expand(n, nb)
    slot = img * nm + k                                   # [N, B]
    cell = slot * cells + gj * w + gi
    later = torch.ones(nb, nb, dtype=torch.bool, device=dev).triu_(1)
    overwritten = ((cell[:, :, None] == cell[:, None, :])
                   & assigned[:, None, :] & later).any(-1)
    win = assigned & ~overwritten
    # losers write to a spare slot that is dropped: no duplicate index
    rows = torch.where(win, slot, n * nm).reshape(-1)
    pos = (gj * w + gi).reshape(-1)
    tobj = torch.zeros(n * nm + 1, cells, dtype=f32, device=dev)
    tscale = torch.zeros_like(tobj)
    txy = torch.zeros(n * nm + 1, 2, cells, dtype=f32, device=dev)
    twh = torch.zeros_like(txy)
    tcls = torch.zeros(n * nm + 1, class_num, cells, dtype=f32, device=dev)
    tobj[rows, pos] = gs.reshape(-1)
    tscale[rows, pos] = (2.0 - gw * gh).reshape(-1)
    txy[rows, 0, pos] = (gt[..., 0] * w - gi).reshape(-1)
    txy[rows, 1, pos] = (gt[..., 1] * h - gj).reshape(-1)
    best_wh = allanc[best]                                # [N, B, 2]
    tiny = torch.full((), 1e-9, dtype=f32, device=dev)
    twh[rows, 0, pos] = torch.log(torch.maximum(
        gw * input_size / best_wh[..., 0], tiny)).reshape(-1)
    twh[rows, 1, pos] = torch.log(torch.maximum(
        gh * input_size / best_wh[..., 1], tiny)).reshape(-1)
    smooth = 1.0 / class_num if use_label_smooth else 0.0
    tcls[rows, :, pos] = smooth
    tcls[rows, gl.reshape(-1).long(), pos] = (1.0 - smooth
                                              if use_label_smooth else 1.0)
    shape = (n, nm, h, w)
    tobj, tscale = tobj[:-1].reshape(shape), tscale[:-1].reshape(shape)
    txy, twh = txy[:-1].reshape(n, nm, 2, h, w), twh[:-1].reshape(
        n, nm, 2, h, w)
    tcls = tcls[:-1].reshape(n, nm, class_num, h, w)
    # ignore mask
    f = x.reshape(n, nm, 5 + class_num, h, w)
    manc = allanc[midx]                                   # [nm, 2]
    cx = torch.arange(w, device=dev, dtype=torch.float64)
    cy = torch.arange(h, device=dev, dtype=torch.float64)[:, None]
    px = _div((1 / (1 + torch.exp(-f[:, :, 0]))).double() + cx, w)
    py = _div((1 / (1 + torch.exp(-f[:, :, 1]))).double() + cy, h)
    pw = _div(torch.exp(torch.clamp(f[:, :, 2], -10, 10))
              * manc[None, :, 0, None, None], input_size)
    ph = _div(torch.exp(torch.clamp(f[:, :, 3], -10, 10))
              * manc[None, :, 1, None, None], input_size)
    bx0, bx1 = px - pw / 2, px + pw / 2
    by0, by1 = py - ph / 2, py + ph / 2
    g = gt[:, None, None, None]                           # [N,1,1,1,B,4]
    gx0, gx1 = g[..., 0] - g[..., 2] / 2, g[..., 0] + g[..., 2] / 2
    gy0, gy1 = g[..., 1] - g[..., 3] / 2, g[..., 1] + g[..., 3] / 2
    e = (..., None)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    iw = torch.maximum(torch.minimum(bx1[e], gx1) - torch.maximum(bx0[e],
                                                                 gx0), zero)
    ih = torch.maximum(torch.minimum(by1[e], gy1) - torch.maximum(by0[e],
                                                                 gy0), zero)
    inter = iw * ih
    u = (pw * ph)[e] + g[..., 2] * g[..., 3] - inter
    gious = inter / torch.clamp_min(u, 1e-10)             # [N,nm,H,W,B]
    gious = torch.where(valid[:, None, None, None], gious, zero)
    best_iou = gious.amax(-1)
    ignored = valid.any(1)[:, None, None, None] & (best_iou > ignore_thresh)
    ign = torch.where(ignored, 0.0, 1.0).to(f32)
    return tobj, tscale, txy, twh, tcls, ign


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0, *,
              device=None):
    """YOLOv3 loss of one head x [N, len(anchor_mask) * (5 + C), H, W]
    against gt boxes [N, B, 4] (cx, cy, w, h in [0, 1]; a box with w <= 0
    or h <= 0 is padding) and labels [N, B] -> the loss of each image
    [N]: BCE of x / y offsets and L1 of log w / h (scaled by 2 - w * h),
    BCE of objectness (predictions overlapping a gt box by more than
    `ignore_thresh` ignored), BCE of the classes (label smoothing with
    `use_label_smooth`). Targets and the ignore mask are built on the
    device (`_yolo_targets`); the loss is differentiable in x.
    `scale_x_y`, which the JAX function accepts and never reads, is not
    ported."""
    if scale_x_y != 1.0:
        raise NotImplementedError("yolo_loss(scale_x_y != 1) is not ported "
                                  "(the JAX function never reads it)")
    x = _as_tensor(x, device)
    gt = _on(gt_box, x, torch.float32)
    gl = _on(gt_label, x, torch.long)
    gs = (_on(gt_score, x, torch.float32) if gt_score is not None
          else torch.ones(gl.shape, dtype=torch.float32, device=x.device))
    an_mask = [int(a) for a in anchor_mask]
    tobj, tscale, txy, twh, tcls, ign = _yolo_targets(
        x.detach(), gt, gl, gs, anchors, an_mask, int(class_num),
        float(ignore_thresh), int(downsample_ratio), use_label_smooth)
    n, _, h, w = x.shape
    f = x.reshape(n, len(an_mask), 5 + int(class_num), h, w)
    lxy = (_bce(f[:, :, 0:2], txy) * tscale[:, :, None]
           * tobj[:, :, None]).sum((1, 2, 3, 4))
    lwh = (torch.abs(f[:, :, 2:4] - twh) * tscale[:, :, None]
           * tobj[:, :, None]).sum((1, 2, 3, 4))
    lobj = (_bce(f[:, :, 4], tobj)
            * torch.where(tobj > 0, 1.0, ign)).sum((1, 2, 3))
    lcls = (_bce(f[:, :, 5:], tcls) * tobj[:, :, None]).sum((1, 2, 3, 4))
    return lxy + lwh + lobj + lcls


# ------------------------------------------------------------- matrix NMS

@torch.no_grad()
def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None, *, device=None):
    """Matrix NMS (SOLOv2) with Paddle's meaning: per image and class
    (not `background_label`), the boxes scored above `score_threshold`,
    best first (the first `nms_top_k`; -1 keeps all), each decayed by
    ``min(1, min over higher-scored i of f(iou_ik, comp_i))`` with comp_i
    box i's largest IoU with any box above it and f linear ``(1 - iou) /
    (1 - comp)`` or gaussian ``exp((comp^2 - iou^2) * gaussian_sigma)``;
    a box is kept when its decayed score is at least `post_threshold` (the
    JAX function's bound). Each image's kept boxes, best first, the first
    `keep_top_k` (-1 keeps all) -> rows [label, score, x0, y0, x1, y1],
    the index ``n * M + box`` of each with `return_index`, the rows per
    image with `return_rois_num`. The JAX function decays box k by its
    own IoUs instead and reads -1 as a slice (ROADMAP Queue 3).
    ``normalized=False`` adds one to widths and heights, as Paddle does.
    All (image, class) pairs at once, in chunks; the host reads the
    longest candidate list and the rows per image."""
    sv = _as_tensor(scores, device, torch.float32)
    bv = _on(bboxes, sv, torch.float32)
    n, c, m = sv.shape
    cls = torch.arange(c, device=sv.device)
    if 0 <= background_label < c:
        cls = torch.cat([cls[:background_label], cls[background_label + 1:]])
    s = sv[:, cls]                                        # [N, C', M]
    cand = s > score_threshold
    neg = torch.full((), -math.inf, device=sv.device)
    val, order = torch.sort(torch.where(cand, s, neg), dim=-1,
                            descending=True, stable=True)
    cnt = cand.sum(-1)
    if nms_top_k > -1:
        cnt = cnt.clamp(max=int(nms_top_k))
    kk = int(cnt.max()) if cnt.numel() else 0             # host read
    off = 0.0 if normalized else 1.0
    ncls = cls.numel()
    if kk:
        order, val = order[..., :kk], val[..., :kk]
        valid = torch.arange(kk, device=sv.device) < cnt[..., None]
        bx = bv[torch.arange(n, device=sv.device)[:, None, None], order]
        grp = n * ncls
        bx, val, valid = bx.reshape(grp, kk, 4), val.reshape(grp, kk), \
            valid.reshape(grp, kk)
        lower = torch.ones(kk, kk, dtype=torch.bool,
                           device=sv.device).tril_(-1)
        inf = torch.full((), math.inf, device=sv.device)
        ds = torch.empty_like(val)
        step = max(1, _CHUNK_ELEMS // (kk * kk))
        for lo in range(0, grp, step):
            hi = min(lo + step, grp)
            ok = valid[lo:hi]
            pair = lower & ok[:, :, None] & ok[:, None, :]
            iou = torch.where(pair, _iou_matrix(bx[lo:hi], bx[lo:hi], 1e-10,
                                                off), 0.0)  # iou[g, i, j<i]
            comp = iou.amax(-1)                           # [g, K]
            if use_gaussian:
                d = torch.exp((comp[:, None, :] ** 2 - iou ** 2)
                              * gaussian_sigma)
            else:
                d = (1 - iou) / (1 - comp[:, None, :])
                d = torch.where(torch.isnan(d), inf, d)
            d = torch.where(pair, d, inf).amin(-1)
            ds[lo:hi] = torch.clamp(d, max=1.0) * val[lo:hi]
        keep = valid & (ds >= post_threshold)
        flat_ds = torch.where(keep, ds, neg).reshape(n, ncls * kk)
        _, rank = torch.sort(flat_ds, dim=-1, descending=True, stable=True)
        num = keep.reshape(n, -1).sum(-1)
        if keep_top_k > -1:
            num = num.clamp(max=int(keep_top_k))
        nums = num.to(torch.int32)
        counts = num.tolist()                             # host read
        sel = torch.cat([rank[i, :k] + i * ncls * kk
                         for i, k in enumerate(counts)])
        box_idx = order.reshape(-1)[sel]
        g = sel // kk
        rows = torch.cat([cls[g % ncls][:, None].float(),
                          ds.reshape(-1)[sel][:, None],
                          bx.reshape(-1, 4)[sel]], 1)
        index = (g // ncls) * m + box_idx
    else:
        nums = torch.zeros(n, dtype=torch.int32, device=sv.device)
        rows = torch.zeros(0, 6, device=sv.device)
        index = torch.zeros(0, dtype=torch.long, device=sv.device)
    res = [rows]
    if return_index:
        res.append(index.reshape(-1, 1))
    if return_rois_num:
        res.append(nums)
    return tuple(res) if len(res) > 1 else rows


# ---------------------------------------------------------- proposal ops

@torch.no_grad()
def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None, *, device=None):
    """Assign RoIs [R, 4] to FPN levels by scale: level ``floor(log2(
    sqrt(w * h) / refer_scale + 1e-8)) + refer_level`` clipped to
    [min_level, max_level] -> (the RoIs of each level in input order, the
    restore index [R, 1] int32 that puts the concatenated levels back in
    input order, the counts). With `rois_num` (RoIs per image) the counts
    are Paddle's: one [N] int32 tensor a level, its RoIs per image (the
    JAX function returns one total a level); without it, None."""
    rois = _as_tensor(fpn_rois, device, torch.float32)
    off = 1.0 if pixel_offset else 0.0
    zero = torch.zeros((), device=rois.device)
    ws = torch.maximum(rois[:, 2] - rois[:, 0] + off, zero)
    hs = torch.maximum(rois[:, 3] - rois[:, 1] + off, zero)
    scale = torch.sqrt(ws * hs)
    lvl = torch.floor(torch.log2(_div(scale, refer_scale) + 1e-8)) \
        + refer_level
    lvl = lvl.clamp(min_level, max_level).long() - min_level
    levels = max_level - min_level + 1
    perm = torch.argsort(lvl, stable=True)
    counts = _counts(lvl, levels).tolist()                    # host read
    outs = list(torch.split(rois[perm], counts))
    restore = torch.empty_like(perm)
    restore[perm] = torch.arange(perm.numel(), device=rois.device)
    restore = restore.to(torch.int32).reshape(-1, 1)
    if rois_num is None:
        return outs, restore, None
    bn = _on(rois_num, rois, torch.long).reshape(-1)
    img = torch.repeat_interleave(torch.arange(bn.numel(),
                                               device=rois.device), bn,
                                  output_size=rois.shape[0])
    per = _counts(lvl * bn.numel() + img, levels * bn.numel())
    nums = list(per.to(torch.int32).reshape(levels, bn.numel()).unbind(0))
    return outs, restore, nums


def _counts(idx, n):
    """`torch.bincount(idx, minlength=n)` for idx < n, without the host
    read of its largest index."""
    return torch.zeros(n, dtype=torch.long, device=idx.device) \
        .index_add_(0, idx, torch.ones_like(idx))


@torch.no_grad()
def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False, name=None,
                       *, device=None):
    """RPN proposals: per image, the `pre_nms_top_n` best anchors (scores
    [N, A, H, W] read in (h, w, a) order; a stable sort, where numpy's is
    not: ties take index order), decoded by `bbox_deltas` [N, 4A, H, W]
    against `anchors` / `variances` [H, W, A, 4] (log-sizes capped at
    log(1000 / 16)), clipped to `img_size` [N, 2] (h, w), those narrower
    or lower than `min_size` dropped, then greedy NMS (a box whose IoU
    with a kept better box is above `nms_thresh` dropped; areas without
    the pixel offset, as the JAX function computes them), the first
    `post_nms_top_n` kept -> rois [sum, 4], scores [sum, 1] (and the rois
    per image [N] int32 with `return_rois_num`). Every image at once on
    the device; the host reads the scan's flags and the kept count.
    Adaptive NMS (``eta < 1``), which the JAX function ignores, is not
    ported."""
    if eta != 1.0:
        raise NotImplementedError("generate_proposals(eta != 1): adaptive "
                                  "NMS is not ported (the JAX function "
                                  "ignores eta)")
    sc = _as_tensor(scores, device, torch.float32)
    dev = sc.device
    bd = _on(bbox_deltas, sc, torch.float32)
    im = _on(img_size, sc, torch.float32)
    an = _on(anchors, sc, torch.float32).reshape(-1, 4)
    var = _on(variances, sc, torch.float32).reshape(-1, 4)
    n, a, h, w = sc.shape
    off = 1.0 if pixel_offset else 0.0
    s = sc.permute(0, 2, 3, 1).reshape(n, -1)
    d = bd.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(n, -1, 4)
    order = torch.argsort(-s, dim=1, stable=True)[:, :pre_nms_top_n]
    s = torch.gather(s, 1, order)
    d = torch.gather(d, 1, order[..., None].expand(-1, -1, 4))
    ac, v = an[order], var[order]
    aw = ac[..., 2] - ac[..., 0] + off
    ah = ac[..., 3] - ac[..., 1] + off
    acx = ac[..., 0] + aw / 2
    acy = ac[..., 1] + ah / 2
    cx = v[..., 0] * d[..., 0] * aw + acx
    cy = v[..., 1] * d[..., 1] * ah + acy
    cap = torch.full((), math.log(1000.0 / 16.0), dtype=torch.float32,
                     device=dev)
    bw = torch.exp(torch.minimum(v[..., 2] * d[..., 2], cap)) * aw
    bh = torch.exp(torch.minimum(v[..., 3] * d[..., 3], cap)) * ah
    zero = torch.zeros((), device=dev)
    hi_w, hi_h = (im[:, 1] - off)[:, None], (im[:, 0] - off)[:, None]

    def clip(t, hi):
        return torch.minimum(torch.maximum(t, zero), hi)

    boxes = torch.stack([clip(cx - bw / 2, hi_w), clip(cy - bh / 2, hi_h),
                         clip(cx + bw / 2 - off, hi_w),
                         clip(cy + bh / 2 - off, hi_h)], -1)
    ws = boxes[..., 2] - boxes[..., 0] + off
    hs = boxes[..., 3] - boxes[..., 1] + off
    eligible = (ws >= min_size) & (hs >= min_size)
    keep = _greedy_keep(_suppressors(boxes, float(nms_thresh), 1e-10),
                        eligible)
    keep &= (torch.cumsum(keep, 1) <= post_nms_top_n)
    img, pos = keep.nonzero(as_tuple=True)                # host read
    rois, rscores = boxes[img, pos], s[img, pos][:, None]
    if return_rois_num:
        return rois, rscores, keep.sum(1).to(torch.int32)
    return rois, rscores


def generate_proposals_v2(*args, **kwargs):
    """`generate_proposals` under its Paddle 2 name."""
    return generate_proposals(*args, **kwargs)


# ---------------------------------------------------------------- images

def read_file(filename, name=None, *, device=None):
    """The bytes of a file as a uint8 tensor [size], read on the host and
    placed on `device` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8).copy()
    return torch.from_numpy(data).to(dev)


def decode_jpeg(x, mode="unchanged", name=None, *, device=None):
    """Decode JPEG bytes (a uint8 tensor) to a [C, H, W] uint8 tensor on
    the host with Pillow (imported here): ``mode`` "gray", "rgb" or
    "unchanged". The result is placed on `device` (the card unless the
    caller asks for the CPU)."""
    import io

    dev = resolve_device(device)
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("decode_jpeg requires Pillow") from e
    raw = (x.detach().cpu().numpy() if torch.is_tensor(x)
           else np.asarray(x)).astype(np.uint8).tobytes()
    img = Image.open(io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.array(arr)).to(dev)        # a writable copy


# ---------------------------------------------------------------- layers

class RoIAlign(torch.nn.Module):
    """`roi_align` with a fixed output size and scale."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size, self.spatial_scale = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool(torch.nn.Module):
    """`roi_pool` with a fixed output size and scale."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size, self.spatial_scale = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool(torch.nn.Module):
    """`psroi_pool` with a fixed output size and scale."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size, self.spatial_scale = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


class DeformConv2D(torch.nn.Module):
    """`deform_conv2d` owning its weight [out, in / groups, kh, kw] and
    bias (``bias_attr=False``: none), both uniform in +-1 / sqrt(in * kh *
    kw): from numpy's RandomState(0) in float64, cast to float32, as the
    JAX layer draws them, or from `generator`. `device`: the GPU by
    default, ``"cpu"`` on request."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None,
                 generator=None):
        super().__init__()
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError("DeformConv2D ports weight_attr None "
                                      "and bias_attr None or False")
        dev = resolve_device(device)
        k = _ntuple(kernel_size, 2)
        std = 1.0 / np.sqrt(in_channels * k[0] * k[1])
        shape = (out_channels, in_channels // groups, *k)
        if generator is None:
            rng = np.random.RandomState(0)
            wt = torch.from_numpy(rng.uniform(-std, std, shape)
                                  .astype("float32"))
            bt = torch.from_numpy(rng.uniform(-std, std, (out_channels,))
                                  .astype("float32"))
        else:
            wt = torch.empty(shape, device=generator.device).uniform_(
                -std, std, generator=generator)
            bt = torch.empty(out_channels, device=generator.device) \
                .uniform_(-std, std, generator=generator)
        self.weight = torch.nn.Parameter(wt.to(dev))
        self.bias = (None if bias_attr is False
                     else torch.nn.Parameter(bt.to(dev)))
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deformable_groups, self.groups = deformable_groups, groups

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self.stride,
                             self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)
