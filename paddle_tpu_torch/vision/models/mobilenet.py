"""MobileNetV1 / V2 (counterpart of paddle_tpu/vision/models/mobilenet.py;
depthwise convolutions as grouped `Conv2D`s). `device`: the GPU by
default, ``"cpu"`` on request; weights and dropout from `generator` (or
`seed`)."""
from __future__ import annotations

from torch import nn

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Linear,
                   ReLU, ReLU6, Sequential)
from ._init import init_kwargs

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


def _conv_bn(c_in, c_out, k, stride=1, padding=0, groups=1, act="relu6",
             init=None):
    layers = [Conv2D(c_in, c_out, k, stride=stride, padding=padding,
                     groups=groups, bias_attr=False, **init),
              BatchNorm2D(c_out, device=init["device"])]
    if act == "relu6":
        layers.append(ReLU6())
    elif act == "relu":
        layers.append(ReLU())
    return Sequential(*layers)


class MobileNetV1(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, *, device=None, seed=0,
                 generator=None):
        super().__init__()
        init = init_kwargs(device, seed, generator)
        self.num_classes = num_classes

        def c(ch):
            return max(8, int(ch * scale))

        cfg = [  # (out, stride) of each depthwise-separable block
            (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1),
        ]
        layers = [_conv_bn(3, c(32), 3, stride=2, padding=1, act="relu",
                           init=init)]
        c_in = c(32)
        for out, s in cfg:
            layers.append(_conv_bn(c_in, c_in, 3, stride=s, padding=1,
                                   groups=c_in, act="relu", init=init))
            layers.append(_conv_bn(c_in, c(out), 1, act="relu", init=init))
            c_in = c(out)
        self.features = Sequential(*layers)
        self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(c_in, num_classes, **init)
        self._out_ch = c_in

    def forward(self, x):
        x = self.pool(self.features(x)).flatten(1)
        if self.num_classes > 0:
            x = self.fc(x)
        return x


class _InvertedResidual(nn.Module):
    def __init__(self, c_in, c_out, stride, expand, init):
        super().__init__()
        hidden = int(round(c_in * expand))
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if expand != 1:
            layers.append(_conv_bn(c_in, hidden, 1, init=init))
        layers += [
            _conv_bn(hidden, hidden, 3, stride=stride, padding=1,
                     groups=hidden, init=init),
            Conv2D(hidden, c_out, 1, bias_attr=False, **init),
            BatchNorm2D(c_out, device=init["device"]),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, dropout=0.2, *,
                 device=None, seed=0, generator=None):
        super().__init__()
        init = init_kwargs(device, seed, generator)
        self.num_classes = num_classes

        def c(ch):
            return max(8, int(ch * scale + 4) // 8 * 8)

        cfg = [  # t (expand), c (out), n (repeat), s (stride)
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        c_in = c(32)
        layers = [_conv_bn(3, c_in, 3, stride=2, padding=1, init=init)]
        for t, ch, n, s in cfg:
            for i in range(n):
                layers.append(_InvertedResidual(
                    c_in, c(ch), s if i == 0 else 1, t, init))
                c_in = c(ch)
        last = max(1280, int(1280 * scale))
        layers.append(_conv_bn(c_in, last, 1, init=init))
        self.features = Sequential(*layers)
        self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(dropout, generator=init["generator"]),
                Linear(last, num_classes, **init))

    def forward(self, x):
        x = self.pool(self.features(x)).flatten(1)
        if self.num_classes > 0:
            x = self.classifier(x)
        return x


def mobilenet_v1(scale=1.0, num_classes=1000, **kw):
    return MobileNetV1(scale=scale, num_classes=num_classes, **kw)


def mobilenet_v2(scale=1.0, num_classes=1000, **kw):
    return MobileNetV2(scale=scale, num_classes=num_classes, **kw)
