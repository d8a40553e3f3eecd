"""SqueezeNet 1.0 / 1.1 (counterpart of
paddle_tpu/vision/models/squeezenet.py). `device`: the GPU by default,
``"cpu"`` on request; weights and dropout from `generator` (or
`seed`)."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, MaxPool2D, ReLU,
                   Sequential)
from ._init import init_kwargs

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(nn.Module):
    def __init__(self, c_in, squeeze, e1, e3, init):
        super().__init__()
        self.squeeze = Sequential(Conv2D(c_in, squeeze, 1, **init), ReLU())
        self.expand1 = Sequential(Conv2D(squeeze, e1, 1, **init), ReLU())
        self.expand3 = Sequential(Conv2D(squeeze, e3, 3, padding=1, **init),
                                  ReLU())

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1(x), self.expand3(x)], dim=1)


class SqueezeNet(nn.Module):
    def __init__(self, version="1.0", num_classes=1000, dropout=0.5, *,
                 device=None, seed=0, generator=None):
        super().__init__()
        init = init_kwargs(device, seed, generator)
        self.num_classes = num_classes

        def fire(*a):
            return _Fire(*a, init)

        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, **init), ReLU(),
                MaxPool2D(3, 2),
                fire(96, 16, 64, 64), fire(128, 16, 64, 64),
                fire(128, 32, 128, 128),
                MaxPool2D(3, 2),
                fire(256, 32, 128, 128), fire(256, 48, 192, 192),
                fire(384, 48, 192, 192), fire(384, 64, 256, 256),
                MaxPool2D(3, 2),
                fire(512, 64, 256, 256),
            )
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, **init), ReLU(),
                MaxPool2D(3, 2),
                fire(64, 16, 64, 64), fire(128, 16, 64, 64),
                MaxPool2D(3, 2),
                fire(128, 32, 128, 128), fire(256, 32, 128, 128),
                MaxPool2D(3, 2),
                fire(256, 48, 192, 192), fire(384, 48, 192, 192),
                fire(384, 64, 256, 256), fire(512, 64, 256, 256),
            )
        self.classifier = Sequential(
            Dropout(dropout, generator=init["generator"]),
            Conv2D(512, num_classes, 1, **init), ReLU(),
            AdaptiveAvgPool2D(1),
        )

    def forward(self, x):
        x = self.classifier(self.features(x))
        return x.flatten(1)


def squeezenet1_0(num_classes=1000, **kw):
    return SqueezeNet("1.0", num_classes=num_classes, **kw)


def squeezenet1_1(num_classes=1000, **kw):
    return SqueezeNet("1.1", num_classes=num_classes, **kw)
