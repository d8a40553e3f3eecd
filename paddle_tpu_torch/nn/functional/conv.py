"""Convolution (counterpart of paddle_tpu/nn/functional/conv.py's
`conv2d`).

The product is `torch.nn.functional.conv2d` (cuDNN on the GPU), as the
JAX package leaves convolutions to XLA outside any kernel of its own.
Weights are OIHW in both data formats, as on the JAX side, so they load
unchanged. ``data_format="NHWC"`` goes through channels-last views: the
NCHW view ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is
channels_last-contiguous, cuDNN computes in that layout and returns it,
and the inverse permute gives a contiguous NHWC result, so no activation
is copied to change its layout. The weight is taken channels_last (the
`Conv2D` layer keeps it so).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...amp import amp_op

__all__ = ["conv2d"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v) if len(v) == n else (int(v[0]),) * n
    return (int(v),) * n


def _pads(padding, n, size, kernel, stride, dilation):
    """Per spatial dim (before, after), from Paddle's forms: an int, one
    int per dim, 2n ints (before, after per dim), the 4-d nested form, or
    "SAME" / "VALID" (XLA's SAME: the total split low-first)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError(f"bad padding {padding!r}")
        out = []
        for i in range(n):
            eff = (kernel[i] - 1) * dilation[i] + 1
            total = max((math.ceil(size[i] / stride[i]) - 1) * stride[i]
                        + eff - size[i], 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(padding, int):
        return [(padding, padding)] * n
    p = list(padding)
    if len(p) == n and all(isinstance(x, int) for x in p):
        return [(x, x) for x in p]
    if len(p) == 2 * n and all(isinstance(x, int) for x in p):
        return [(p[2 * i], p[2 * i + 1]) for i in range(n)]
    if all(isinstance(x, (list, tuple)) for x in p):
        return [tuple(int(v) for v in x) for x in p[-n:]]
    raise ValueError(f"bad padding {padding!r}")


@amp_op("conv")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution; x NCHW or NHWC, weight [Cout, Cin / groups, kh,
    kw]. Returns the layout of x."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    channel_last = data_format == "NHWC"
    xc = x.permute(0, 3, 1, 2) if channel_last else x
    stride, dilation = _ntuple(stride, 2), _ntuple(dilation, 2)
    pads = _pads(padding, 2, xc.shape[2:], weight.shape[2:], stride,
                 dilation)
    if any(a != b for a, b in pads):
        xc = F.pad(xc, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        pads = [(0, 0)] * 2
    if channel_last:
        weight = weight.contiguous(memory_format=torch.channels_last)
    out = F.conv2d(xc, weight, bias, stride, (pads[0][0], pads[1][0]),
                   dilation, int(groups))
    return out.permute(0, 2, 3, 1) if channel_last else out
