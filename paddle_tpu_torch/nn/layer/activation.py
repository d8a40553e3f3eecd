"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py's
`ReLU`, `ReLU6`, `Silu`, `Swish`, `Hardswish`, `Hardsigmoid` and
`GELU`)."""
from __future__ import annotations

from torch import nn

from ..functional.activation import (gelu, hardsigmoid, hardswish, relu,
                                     relu6, silu, swish)

__all__ = ["ReLU", "ReLU6", "Silu", "Swish", "Hardswish", "Hardsigmoid",
           "GELU"]


class ReLU(nn.Module):
    def forward(self, x):
        return relu(x)


class ReLU6(nn.Module):
    def forward(self, x):
        return relu6(x)


class Silu(nn.Module):
    def forward(self, x):
        return silu(x)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


class Hardswish(nn.Module):
    def forward(self, x):
        return hardswish(x)


class Hardsigmoid(nn.Module):
    def forward(self, x):
        return hardsigmoid(x)


class GELU(nn.Module):
    """``approximate=True`` is the tanh form."""

    def __init__(self, approximate=False):
        super().__init__()
        self._approximate = bool(approximate)

    def forward(self, x):
        return gelu(x, self._approximate)
