"""Common layers (counterpart of paddle_tpu/nn/layer/common.py):
`Dropout`, which holds the generator its masks are drawn from."""
from __future__ import annotations

from torch import nn

from ..functional.common import dropout

__all__ = ["Dropout"]


class Dropout(nn.Module):
    """`nn.functional.dropout` while training, the identity in eval mode
    (``upscale_in_train``). `generator`: the `torch.Generator` the masks
    come from (torch's default generator of the input's device when
    None)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x):
        return dropout(x, self.p, self.training, self.generator)

    def extra_repr(self):
        return f"p={self.p}"
