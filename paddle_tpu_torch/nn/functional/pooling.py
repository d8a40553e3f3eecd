"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py's
`max_pool2d` and `adaptive_avg_pool2d`), NCHW or NHWC through the same
channels-last views as `conv2d`."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["max_pool2d", "adaptive_avg_pool2d"]


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


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over the bins [floor(i * in / out), ceil((i + 1) * in / out))
    of each spatial dim."""
    return _back(F.adaptive_avg_pool2d(_nchw(x, data_format), output_size),
                 data_format)
