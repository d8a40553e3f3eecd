"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py's
`ReLU`)."""
from __future__ import annotations

from torch import nn

from ..functional.activation import relu

__all__ = ["ReLU"]


class ReLU(nn.Module):
    def forward(self, x):
        return relu(x)
