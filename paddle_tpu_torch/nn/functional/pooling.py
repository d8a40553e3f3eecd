"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py's
`max_pool2d`, `avg_pool2d` and `adaptive_avg_pool2d`), NCHW or NHWC
through the same channels-last views as `conv2d`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import _ntuple, _pads

__all__ = ["max_pool2d", "avg_pool2d", "adaptive_avg_pool2d"]


def _nchw(x, data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(out, data_format):
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def max_pool2d(x, kernel_size, stride=None, padding=0, data_format="NCHW"):
    """Max over windows; padded cells are -inf (never the maximum).
    `stride` defaults to `kernel_size`."""
    out = F.max_pool2d(_nchw(x, data_format), kernel_size,
                       kernel_size if stride is None else stride, padding)
    return _back(out, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """Mean over windows. ``exclusive=True`` (the default) divides by the
    window's cells inside the input, ``False`` by the whole window,
    padding included, as Paddle does (the JAX function divides by the
    cells inside whatever `exclusive` says). `padding`: Paddle's int,
    per-dim, (before, after) or nested forms, or "VALID"; ``ceil_mode``
    takes symmetric padding only. `stride` defaults to `kernel_size`.
    `divisor_override`, which the JAX function accepts and ignores, is not
    ported."""
    if divisor_override is not None:
        raise NotImplementedError("avg_pool2d(divisor_override=) is not "
                                  "ported (the JAX function ignores it)")
    if isinstance(padding, str) and padding.upper() == "SAME":
        raise NotImplementedError("avg_pool2d ports numeric padding and "
                                  "'VALID'")
    xc = _nchw(x, data_format)
    k = _ntuple(kernel_size, 2)
    st = k if stride is None else _ntuple(stride, 2)
    pads = _pads(padding, 2, xc.shape[2:], k, st, (1, 1))
    if ceil_mode:
        if any(a != b for a, b in pads):
            raise NotImplementedError("avg_pool2d(ceil_mode=True) ports "
                                      "symmetric padding only")
        out = F.avg_pool2d(xc, k, st, (pads[0][0], pads[1][0]), True,
                           count_include_pad=not exclusive)
        return _back(out, data_format)
    # the window sums over the zero-padded input, then the divisor (the
    # JAX function's order: a sum, then one division)
    pad4 = (pads[1][0], pads[1][1], pads[0][0], pads[0][1])
    total = F.avg_pool2d(F.pad(xc, pad4), k, st, divisor_override=1)
    if not exclusive:
        return _back(total / float(k[0] * k[1]), data_format)
    ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                      device=xc.device)
    count = F.avg_pool2d(F.pad(ones, pad4), k, st, divisor_override=1)
    return _back(total / count, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over the bins [floor(i * in / out), ceil((i + 1) * in / out))
    of each spatial dim."""
    return _back(F.adaptive_avg_pool2d(_nchw(x, data_format), output_size),
                 data_format)
