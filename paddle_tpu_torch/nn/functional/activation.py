"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["gelu", "relu", "relu6", "silu"]


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form (jax.nn.gelu's)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return F.relu(x)


def relu6(x):
    return F.relu6(x)


def silu(x):
    return F.silu(x)
