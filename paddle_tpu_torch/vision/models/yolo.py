"""PP-YOLOE-class anchor-free detector (counterpart of
paddle_tpu/vision/models/yolo.py; BASELINE config 3 of the project):
a CSP backbone, lateral 1x1s onto a shared neck width, decoupled
anchor-free heads at strides 8 / 16 / 32, a closed-form FCOS-style
assignment with BCE classification and GIoU regression, and a host
postprocess over `vision.ops.nms`.

The layer names are the JAX model's (``stem.0.weight``,
``stage1.blocks.0.1.1._mean``, ``heads.2.cls_pred.bias`` ...), so
`convert.load_jax_state` carries a JAX state over. ``data_format="NHWC"``
runs channels-last through views, as the port's ResNet does: the heads'
outputs flatten to [B, H*W, C] without a copy and no activation is
transposed. Ground truth arrives padded to `max_boxes` with a validity
mask, as in the reference, so the loss has static shapes.

The loss follows the JAX `_det_loss_impl` operation by operation,
including where the gradients of ties go: `jnp.maximum` / `jnp.minimum` /
`jnp.clip` send half of the gradient to each side of an exact tie, as
`torch.maximum` / `torch.minimum` do, while `torch.clamp` would pass all
of it, so clips are maxima with zero.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import BatchNorm2D, Conv2D, LayerList, Sequential, Silu
from .. import ops as vops
from ._init import init_kwargs

__all__ = ["PPYOLOE", "ppyoloe_s"]


def _level_points(h, w, s):
    """Anchor-point centers of an h x w stride-s level: (px, py) [h*w]."""
    ys = (np.arange(h) + 0.5) * s
    xs = (np.arange(w) + 0.5) * s
    gx, gy = np.meshgrid(xs, ys)
    return gx.reshape(-1).astype(np.float32), \
        gy.reshape(-1).astype(np.float32)


def _dist_to_boxes(d_log, px, py, stride):
    """Log-scale (l, t, r, b) predictions [..., N, 4] -> xyxy boxes.
    `stride`: a number or per-point [..., N]."""
    stride = torch.as_tensor(stride, dtype=torch.float32,
                             device=d_log.device)
    if stride.ndim:
        stride = stride[..., None]
    d = torch.exp(d_log) * stride
    return torch.stack([px - d[..., 0], py - d[..., 1],
                        px + d[..., 2], py + d[..., 3]], -1)


def _conv_bn_act(c_in, c_out, k=3, s=1, data_format="NCHW", init=None):
    init = init or {}
    return Sequential(
        Conv2D(c_in, c_out, k, stride=s, padding=k // 2, bias_attr=False,
               data_format=data_format, **init),
        BatchNorm2D(c_out, data_format=data_format,
                    device=init.get("device")),
        Silu(),
    )


class _CSPBlock(nn.Module):
    """Cross-stage-partial residual stage (CSPResNet-style)."""

    def __init__(self, c_in, c_out, n=1, stride=2, data_format="NCHW",
                 init=None):
        super().__init__()
        df = data_format
        self._cat_axis = 1 if df == "NCHW" else -1
        self.down = _conv_bn_act(c_in, c_out, 3, stride, df, init)
        mid = c_out // 2
        self.split1 = _conv_bn_act(c_out, mid, 1, 1, df, init)
        self.split2 = _conv_bn_act(c_out, mid, 1, 1, df, init)
        self.blocks = Sequential(*[
            Sequential(_conv_bn_act(mid, mid, 3, 1, df, init),
                       _conv_bn_act(mid, mid, 3, 1, df, init))
            for _ in range(n)])
        self.fuse = _conv_bn_act(2 * mid, c_out, 1, 1, df, init)

    def forward(self, x):
        x = self.down(x)
        a = self.split1(x)
        b = self.split2(x)
        for blk in self.blocks:
            b = b + blk(b)
        return self.fuse(torch.cat([a, b], dim=self._cat_axis))


class _Head(nn.Module):
    """Decoupled per-level head: class logits + (l, t, r, b) distances."""

    def __init__(self, ch, num_classes, data_format="NCHW", init=None):
        super().__init__()
        init = init or {}
        self.cls_conv = _conv_bn_act(ch, ch, 3, 1, data_format, init)
        self.reg_conv = _conv_bn_act(ch, ch, 3, 1, data_format, init)
        self.cls_pred = Conv2D(ch, num_classes, 1, data_format=data_format,
                               **init)
        self.reg_pred = Conv2D(ch, 4, 1, data_format=data_format, **init)
        # focal-style prior: rare-positive initialization
        with torch.no_grad():
            self.cls_pred.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(self, x):
        return self.cls_pred(self.cls_conv(x)), self.reg_pred(self.reg_conv(x))


class PPYOLOE(nn.Module):
    """Simplified PP-YOLOE: 3 detection levels (strides 8/16/32).
    `device`: the GPU by default (raises without one), ``"cpu"`` on
    request; the weights come from `generator` (default: one on the
    device seeded with `seed`): Kaiming-uniform convolutions, BN 1 / 0,
    the class bias at the focal prior."""

    def __init__(self, num_classes=80, width=0.5, depth=1, max_boxes=16,
                 data_format="NCHW", *, device=None, seed=0,
                 generator=None):
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got "
                             f"{data_format!r}")
        init = init_kwargs(device, seed, generator)
        self.num_classes = num_classes
        self.max_boxes = max_boxes
        self.data_format = df = data_format
        c = [max(16, int(64 * width)), max(32, int(128 * width)),
             max(64, int(256 * width)), max(64, int(512 * width))]
        self.stem = _conv_bn_act(3, c[0], 3, 2, df, init)           # /2
        self.stage1 = _CSPBlock(c[0], c[1], depth, 2, df, init)     # /4
        self.stage2 = _CSPBlock(c[1], c[2], depth, 2, df, init)     # /8
        self.stage3 = _CSPBlock(c[2], c[3], depth, 2, df, init)     # /16
        self.stage4 = _CSPBlock(c[3], c[3], depth, 2, df, init)     # /32
        nw = c[2]
        self.lat3 = _conv_bn_act(c[2], nw, 1, 1, df, init)
        self.lat4 = _conv_bn_act(c[3], nw, 1, 1, df, init)
        self.lat5 = _conv_bn_act(c[3], nw, 1, 1, df, init)
        self.heads = LayerList([_Head(nw, num_classes, df, init)
                                for _ in range(3)])
        self.strides = (8, 16, 32)
        self._grids = {}

    def backbone(self, x):
        x = self.stem(x)
        x = self.stage1(x)
        p3 = self.stage2(x)
        p4 = self.stage3(p3)
        p5 = self.stage4(p4)
        return self.lat3(p3), self.lat4(p4), self.lat5(p5)

    def forward(self, images):
        """-> per level (cls_logits, reg) in the model's layout ([B, C, H,
        W] or [B, H, W, C])."""
        feats = self.backbone(images)
        return tuple(self.heads[i](f) for i, f in enumerate(feats))

    def _flat(self, t):
        """[B, C, H, W] / [B, H, W, C] -> ([B, H*W, C], h, w); a view in
        NHWC."""
        if self.data_format == "NCHW":
            b, c, h, w = t.shape
            return t.permute(0, 2, 3, 1).reshape(b, h * w, c), h, w
        b, h, w, c = t.shape
        return t.reshape(b, h * w, c), h, w

    def _grid(self, shapes, device):
        """The anchor points [N, 2] and strides [N] of the levels' (h, w),
        built once per shape and device."""
        key = (tuple(shapes), str(device))
        if key not in self._grids:
            pts, strides = [], []
            for (h, w), s in zip(shapes, self.strides):
                px, py = _level_points(h, w, s)
                pts.append(np.stack([px, py], -1))
                strides.append(np.full(h * w, s, np.float32))
            self._grids[key] = (
                torch.from_numpy(np.concatenate(pts)).to(device),
                torch.from_numpy(np.concatenate(strides)).to(device))
        return self._grids[key]

    # -- training -----------------------------------------------------------
    def loss(self, images, gt_boxes, gt_labels, gt_mask):
        """gt_boxes [B, M, 4] xyxy (image coords), gt_labels [B, M] int,
        gt_mask [B, M] 1/0 valid. FCOS-style assignment + BCE cls + GIoU
        reg."""
        outs = self.forward(images)
        flat_cls, flat_reg, shapes = [], [], []
        for cls, reg in outs:
            fc, h, w = self._flat(cls)
            flat_cls.append(fc)
            flat_reg.append(self._flat(reg)[0])
            shapes.append((h, w))
        pts, strides = self._grid(shapes, flat_cls[0].device)
        return _det_loss_impl(torch.cat(flat_cls, 1), torch.cat(flat_reg, 1),
                              gt_boxes, gt_labels, gt_mask, pts, strides,
                              num_classes=self.num_classes)

    # -- inference ----------------------------------------------------------
    @torch.no_grad()
    def postprocess(self, images, score_threshold=0.3, nms_iou=0.6,
                    top_k=100):
        """-> list over batch of (boxes [K, 4], scores [K], labels [K])
        numpy arrays (K <= top_k). Each level's logits and distances come
        to the host in one read; decoding and the score filter run in
        numpy, `nms` on the model's device."""
        outs = self.forward(images)
        boxes_all, scores_all, labels_all = [], [], []
        for (cls, reg), s in zip(outs, self.strides):
            logits, h, w = self._flat(cls)
            both = torch.cat([logits, self._flat(reg)[0]], -1).float().cpu()
            ln, dist = both[..., :-4].numpy(), both[..., -4:]
            px, py = _level_points(h, w, s)
            boxes_all.append(_dist_to_boxes(
                dist, torch.from_numpy(px)[None], torch.from_numpy(py)[None],
                s).numpy())
            prob = 1.0 / (1.0 + np.exp(-ln))
            scores_all.append(prob.max(-1))
            labels_all.append(prob.argmax(-1))
        boxes = np.concatenate(boxes_all, 1)
        scores = np.concatenate(scores_all, 1)
        labels = np.concatenate(labels_all, 1)
        device = self.heads[0].cls_pred.weight.device
        results = []
        for bi in range(boxes.shape[0]):
            keepm = scores[bi] >= score_threshold
            bb, sc, lb = boxes[bi][keepm], scores[bi][keepm], labels[bi][keepm]
            if len(sc) == 0:
                results.append((np.zeros((0, 4), np.float32),
                                np.zeros((0,), np.float32),
                                np.zeros((0,), np.int64)))
                continue
            order = np.argsort(-sc)[:400]  # cap pre-NMS for the O(n^2) mask
            bb, sc, lb = bb[order], sc[order], lb[order]
            keep = vops.nms(torch.from_numpy(bb.astype(np.float32)).to(device),
                            torch.from_numpy(sc.astype(np.float32)).to(device),
                            iou_threshold=nms_iou).cpu().numpy()
            keep = [i for i in keep if i >= 0][:top_k]
            results.append((bb[keep], sc[keep], lb[keep].astype(np.int64)))
        return results


def _clip0(x):
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _det_loss_impl(cls_all, reg_all, gt_boxes, gt_labels, gt_mask, pts,
                   strides_a, *, num_classes):
    """cls_all [B, N, C] logits; reg_all [B, N, 4] log-distances; gt_*
    padded; pts [N, 2], strides_a [N]. Center-inside assignment with
    per-level scale ranges."""
    B, N, C = cls_all.shape
    px, py = pts[:, 0], pts[:, 1]
    # distances of each point to each gt side: [B, N, M]
    l = px[None, :, None] - gt_boxes[:, None, :, 0]
    t = py[None, :, None] - gt_boxes[:, None, :, 1]
    r = gt_boxes[:, None, :, 2] - px[None, :, None]
    bt = gt_boxes[:, None, :, 3] - py[None, :, None]
    dists = torch.stack([l, t, r, bt], -1)
    inside = dists.amin(-1) > 0
    maxd = dists.amax(-1)
    # FCOS-style per-level regression range (stride*4, stride*16]; the
    # finest level keeps lo=0 so small objects always have an owner
    lo = torch.where(strides_a == strides_a.min(),
                     torch.zeros_like(strides_a), strides_a * 4.0)
    hi = strides_a * 16.0
    in_range = (maxd > lo[None, :, None]) & (maxd <= hi[None, :, None])
    valid = gt_mask[:, None, :] != 0
    cand = inside & in_range & valid
    # choose the smallest-area gt among candidates
    area = ((gt_boxes[:, :, 2] - gt_boxes[:, :, 0])
            * (gt_boxes[:, :, 3] - gt_boxes[:, :, 1]))[:, None, :]
    area = torch.where(cand, area, torch.full((), math.inf, dtype=area.dtype,
                                              device=area.device))
    assigned = area.argmin(-1)                          # [B, N]
    is_pos = torch.isfinite(area.amin(-1))              # [B, N]
    tgt_label = torch.gather(gt_labels, 1, assigned)    # [B, N]
    tgt_box = torch.gather(gt_boxes, 1,
                           assigned[..., None].expand(B, N, 4))

    # classification: BCE, one-hot at the assigned class for positives
    onehot = F.one_hot(tgt_label.long(), C).float() * is_pos[..., None]
    cls_f = cls_all.float()
    bce = _clip0(cls_f) - cls_f * onehot + torch.log1p(
        torch.exp(-torch.abs(cls_f)))
    n_pos = torch.clamp_min(is_pos.sum(), 1).float()
    cls_loss = bce.sum() / n_pos / C

    # regression: GIoU on positives; predicted distances are log-scale
    pb = _dist_to_boxes(reg_all.float(), px[None], py[None], strides_a[None])
    giou = _giou(pb, tgt_box)
    reg_loss = torch.where(is_pos, 1.0 - giou,
                           torch.zeros_like(giou)).sum() / n_pos
    return cls_loss + 2.0 * reg_loss


def _giou(a, b):
    ax0, ay0, ax1, ay1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx0, by0, bx1, by1 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    ix0 = torch.maximum(ax0, bx0)
    iy0 = torch.maximum(ay0, by0)
    ix1 = torch.minimum(ax1, bx1)
    iy1 = torch.minimum(ay1, by1)
    inter = _clip0(ix1 - ix0) * _clip0(iy1 - iy0)
    aa = _clip0(ax1 - ax0) * _clip0(ay1 - ay0)
    ab = _clip0(bx1 - bx0) * _clip0(by1 - by0)
    union = aa + ab - inter
    iou = inter / torch.clamp_min(union, 1e-9)
    cx0 = torch.minimum(ax0, bx0)
    cy0 = torch.minimum(ay0, by0)
    cx1 = torch.maximum(ax1, bx1)
    cy1 = torch.maximum(ay1, by1)
    hull = _clip0(cx1 - cx0) * _clip0(cy1 - cy0)
    return iou - (hull - union) / torch.clamp_min(hull, 1e-9)


def ppyoloe_s(num_classes=80, **kw):
    return PPYOLOE(num_classes=num_classes, width=0.5, depth=1, **kw)

