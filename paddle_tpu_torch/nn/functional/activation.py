"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["gelu", "relu", "silu"]


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form (jax.nn.gelu's)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return F.relu(x)


def silu(x):
    return F.silu(x)
