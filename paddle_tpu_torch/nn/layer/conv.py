"""Convolution layer (counterpart of paddle_tpu/nn/layer/conv.py's
`Conv2D`): weight [out, in / groups, kh, kw] as on the JAX side, Paddle's
default initialisation (Kaiming-uniform with a = sqrt(5): uniform in
+-1/sqrt(fan_in), the bias likewise) drawn from `generator`. With
``data_format="NHWC"`` the weight is kept channels_last, the layout cuDNN
takes with channels-last activations; its shape and values are OIHW."""
from __future__ import annotations

import math

import torch
from torch import nn

from ..functional.conv import _ntuple, conv2d

__all__ = ["Conv2D"]


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCHW", *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if bias_attr not in (None, False):
            raise NotImplementedError("Conv2D ports bias_attr None or False")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _ntuple(kernel_size, 2)
        self._stride = _ntuple(stride, 2)
        self._padding = padding
        self._dilation = _ntuple(dilation, 2)
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.empty(out_channels, in_channels // groups,
                        *self._kernel_size, device=device, dtype=dtype)
        w.uniform_(-bound, bound, generator=generator)
        if data_format == "NHWC":
            w = w.contiguous(memory_format=torch.channels_last)
        self.weight = nn.Parameter(w)
        self.bias = None
        if bias_attr is not False:
            b = torch.empty(out_channels, device=device, dtype=dtype)
            self.bias = nn.Parameter(b.uniform_(-bound, bound,
                                                generator=generator))

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"data_format={self._data_format}")
