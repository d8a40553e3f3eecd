"""AlexNet (counterpart of paddle_tpu/vision/models/alexnet.py).
`device`: the GPU by default, ``"cpu"`` on request; weights and dropout
from `generator` (or `seed`)."""
from __future__ import annotations

from torch import nn

from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, Linear, MaxPool2D,
                   ReLU, Sequential)
from ._init import init_kwargs

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Module):
    def __init__(self, num_classes=1000, dropout=0.5, *, device=None,
                 seed=0, generator=None):
        super().__init__()
        init = init_kwargs(device, seed, generator)
        g = init["generator"]
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, **init), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2, **init), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1, **init), ReLU(),
            Conv2D(384, 256, 3, padding=1, **init), ReLU(),
            Conv2D(256, 256, 3, padding=1, **init), ReLU(),
            MaxPool2D(3, 2),
        )
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(dropout, generator=g),
                Linear(256 * 36, 4096, **init), ReLU(),
                Dropout(dropout, generator=g),
                Linear(4096, 4096, **init), ReLU(),
                Linear(4096, num_classes, **init),
            )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def alexnet(num_classes=1000, **kw):
    return AlexNet(num_classes=num_classes, **kw)
