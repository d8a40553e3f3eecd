"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py):
`dropout`.

The JAX package draws the keep mask from its global key stream; the port
draws it from an explicit `torch.Generator` (the caller's, else torch's
default generator of the tensor's device), so a model that owns one
generator replays its masks from one seed.
"""
from __future__ import annotations

import torch

from ...amp import amp_op

__all__ = ["dropout"]


@amp_op("dropout")
def dropout(x, p=0.5, training=True, generator=None, name=None):
    """Zero each element with probability `p` while training and scale the
    kept ones by 1 / (1 - p) (``upscale_in_train``); the identity
    otherwise. p = 1 gives zeros. The mask is drawn on the generator's
    device (the tensor's when `generator` is None)."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    dev = generator.device if generator is not None else x.device
    keep = torch.rand(x.shape, generator=generator, device=dev) < 1.0 - p
    keep = keep.to(x.device)
    return torch.where(keep, x * (1.0 / (1.0 - p)), torch.zeros_like(x))
