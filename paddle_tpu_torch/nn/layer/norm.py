"""Norm layers (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional import norm as _F

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    def __init__(self, hidden, epsilon=1e-5, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(hidden, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return _F.layer_norm(x, self.weight, self.bias, self.epsilon)


class RMSNorm(nn.Module):
    def __init__(self, hidden, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return _F.rms_norm(x, self.weight, self.epsilon)
