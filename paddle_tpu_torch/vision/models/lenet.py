"""LeNet (counterpart of paddle_tpu/vision/models/lenet.py). `device`:
the GPU by default, ``"cpu"`` on request; weights from `generator` (or
`seed`)."""
from __future__ import annotations

from torch import nn

from ...nn import Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ._init import init_kwargs

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes=10, *, device=None, seed=0,
                 generator=None):
        super().__init__()
        init = init_kwargs(device, seed, generator)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **init),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **init),
            ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, **init),
                Linear(120, 84, **init),
                Linear(84, num_classes, **init),
            )

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x
