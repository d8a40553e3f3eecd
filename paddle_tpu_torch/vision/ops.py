"""Detection ops (counterpart of paddle_tpu/vision/ops.py's `box_iou` and
`nms`): plain PyTorch on the tensors' device.

`nms` keeps the JAX result exactly: boxes in score-descending order, ties
in input order (a stable sort, as `jnp.argsort` is); a box is dropped when
its IoU with a kept higher-scored box is strictly above `iou_threshold`;
the kept indices are -1-padded to N and `top_k` slices the padded vector.

The keep vector is the fixed point of ``keep[i] = not any(j < i:
iou[i, j] > t and keep[j])``, which has one solution, reached in at most N
rounds from any start (after round r the first r entries are final).
Each round is a few whole-matrix device ops, and the host reads one flag
every `_CHECK_EVERY` rounds to stop at the fixed point: no host
synchronisation per box and no data-dependent shape (the padding is a
scatter by the running count), so on the GPU the IoU matrix and the scan
stay on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

__all__ = ["box_iou", "nms"]

#: rounds of the keep scan between two host reads of its convergence flag
_CHECK_EVERY = 8


def _as_tensor(x, device):
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def _clip0(x):
    """max(x, 0) with `jnp.clip`'s gradient at 0 (half to each side)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _box_area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _iou_matrix(a, b):
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = _clip0(rb - lt)
    inter = wh[..., 0] * wh[..., 1]
    union = _box_area(a)[:, None] + _box_area(b)[None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def box_iou(boxes1, boxes2, *, device=None):
    """Pairwise IoU of [N, 4] x [M, 4] xyxy boxes (differentiable). Numpy
    inputs are placed on `device` (the GPU by default)."""
    return _iou_matrix(_as_tensor(boxes1, device), _as_tensor(boxes2, device))


@torch.no_grad()
def _nms_impl(boxes, scores, iou_threshold):
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou = _iou_matrix(boxes[order], boxes[order])
    earlier = torch.ones(n, n, dtype=torch.bool,
                         device=boxes.device).tril_(-1)
    sup = (iou > iou_threshold) & earlier        # sup[i, j]: j may drop i
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for r in range(n + 1):
        new = ~(sup & keep[None, :]).any(1)
        if r % _CHECK_EVERY == _CHECK_EVERY - 1 or r == n:
            if torch.equal(new, keep):
                break
        keep = new
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
