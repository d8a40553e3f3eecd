"""Common layers (counterpart of paddle_tpu/nn/layer/common.py): `Linear`,
`Dropout`, which holds the generator its masks are drawn from, `Flatten`
and `ChannelShuffle`."""
from __future__ import annotations

import math

import torch
from torch import nn

from ..functional.common import dropout
from ..functional.extra import channel_shuffle

__all__ = ["Linear", "Dropout", "Flatten", "ChannelShuffle"]


class Linear(nn.Linear):
    """`torch.nn.Linear` (weight ``[out, in]``; the JAX layer's is ``[in,
    out]`` and `convert` transposes it) with Paddle's default
    initialisation: a Xavier-uniform weight, uniform in +-sqrt(6 / (in +
    out)), drawn from `generator`, and a zero bias. ``bias_attr=False``
    builds no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None,
                 generator=None):
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError("Linear ports weight_attr None and "
                                      "bias_attr None or False")
        super().__init__(in_features, out_features,
                         bias=bias_attr is not False, device=device,
                         dtype=dtype)
        bound = math.sqrt(6.0 / (in_features + out_features))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.zero_()


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


class Flatten(nn.Module):
    """Flattens the axes `start_axis` .. `stop_axis` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = int(start_axis), int(stop_axis)

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class ChannelShuffle(nn.Module):
    """`nn.functional.channel_shuffle` with `groups` groups."""

    def __init__(self, groups, data_format="NCHW"):
        super().__init__()
        self.groups, self.data_format = int(groups), data_format

    def forward(self, x):
        return channel_shuffle(x, self.groups, self.data_format)
