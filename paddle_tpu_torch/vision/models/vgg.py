"""VGG family (counterpart of paddle_tpu/vision/models/vgg.py). `device`:
the GPU by default, ``"cpu"`` on request; weights and dropout from
`generator` (or `seed`)."""
from __future__ import annotations

from torch import nn

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear,
                   MaxPool2D, ReLU, Sequential)
from ._init import init_kwargs

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm=False, init=None):
    layers = []
    c_in = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
            continue
        layers.append(Conv2D(c_in, v, 3, padding=1, **init))
        if batch_norm:
            layers.append(BatchNorm2D(v, device=init["device"]))
        layers.append(ReLU())
        c_in = v
    return Sequential(*layers)


class VGG(nn.Module):
    """`features`: the convolution stack (`_make_layers`); `init`: the
    {device, generator} of the classifier (default: `init_kwargs`)."""

    def __init__(self, features, num_classes=1000, dropout=0.5, *,
                 init=None):
        super().__init__()
        init = init or init_kwargs()
        g = init["generator"]
        self.features = features
        self.num_classes = num_classes
        self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 49, 4096, **init), ReLU(),
                Dropout(dropout, generator=g),
                Linear(4096, 4096, **init), ReLU(),
                Dropout(dropout, generator=g),
                Linear(4096, num_classes, **init),
            )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, batch_norm, num_classes, device=None, seed=0, generator=None,
         **kw):
    init = init_kwargs(device, seed, generator)
    return VGG(_make_layers(_CFGS[cfg], batch_norm, init),
               num_classes=num_classes, init=init, **kw)


def vgg11(batch_norm=False, num_classes=1000, **kw):
    return _vgg("A", batch_norm, num_classes, **kw)


def vgg13(batch_norm=False, num_classes=1000, **kw):
    return _vgg("B", batch_norm, num_classes, **kw)


def vgg16(batch_norm=False, num_classes=1000, **kw):
    return _vgg("D", batch_norm, num_classes, **kw)


def vgg19(batch_norm=False, num_classes=1000, **kw):
    return _vgg("E", batch_norm, num_classes, **kw)
