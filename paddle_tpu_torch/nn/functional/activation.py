"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu", "relu", "relu6", "silu", "swish", "hardswish",
           "hardsigmoid"]


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form (jax.nn.gelu's)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return F.relu(x)


def relu6(x):
    return F.relu6(x)


def silu(x):
    return F.silu(x)


def swish(x):
    """x * sigmoid(x): the JAX package's `swish` is `silu`."""
    return F.silu(x)


def hardswish(x):
    """x * relu6(x + 3) / 6."""
    return F.hardswish(x)


def hardsigmoid(x):
    """clip(x / 6 + 0.5, 0, 1), in the JAX function's order of operations
    (`F.hardsigmoid` computes relu6(x + 3) / 6, an ulp away)."""
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)
