"""Pooling layers (counterpart of paddle_tpu/nn/layer/pooling.py's
`MaxPool2D`, `AvgPool2D` and `AdaptiveAvgPool2D`)."""
from __future__ import annotations

from torch import nn

from ..functional.pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.data_format = padding, data_format

    def forward(self, x):
        return max_pool2d(x, self.kernel_size, self.stride, self.padding,
                          self.data_format)


class AvgPool2D(nn.Module):
    """`nn.functional.avg_pool2d` over fixed windows (``exclusive=True``
    by default)."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW"):
        super().__init__()
        if divisor_override is not None:
            raise NotImplementedError("AvgPool2D(divisor_override=) is not "
                                      "ported (the JAX layer ignores it)")
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.exclusive, self.data_format = exclusive, data_format

    def forward(self, x):
        return avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                          self.ceil_mode, self.exclusive,
                          data_format=self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size, self.data_format)
