"""DenseNet 121 / 161 / 169 / 201 / 264 (counterpart of
paddle_tpu/vision/models/densenet.py): dense blocks of BN-ReLU-conv1x1,
BN-ReLU-conv3x3 growth layers, each concatenating its input and its
growth, with BN-ReLU-conv1x1-avgpool transitions. NCHW or NHWC
(`data_format`); `device` the GPU by default, ``"cpu"`` on request;
weights from `generator` (or `seed`)."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                   Linear, MaxPool2D, ReLU, Sequential)
from ._blocks import channel_axis, flatten_nchw, refuse_pretrained
from ._init import init_kwargs

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFGS = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class _DenseLayer(nn.Module):
    def __init__(self, in_ch, growth, bn_size, *, init, data_format="NCHW"):
        super().__init__()
        mid = bn_size * growth
        df, dev = data_format, init["device"]
        self.bn1 = BatchNorm2D(in_ch, data_format=df, device=dev)
        self.conv1 = Conv2D(in_ch, mid, 1, bias_attr=False, data_format=df,
                            **init)
        self.bn2 = BatchNorm2D(mid, data_format=df, device=dev)
        self.conv2 = Conv2D(mid, growth, 3, padding=1, bias_attr=False,
                            data_format=df, **init)
        self.relu = ReLU()
        self._axis = channel_axis(df)

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        return torch.cat([x, out], self._axis)


class _Transition(nn.Module):
    def __init__(self, in_ch, out_ch, *, init, data_format="NCHW"):
        super().__init__()
        self.bn = BatchNorm2D(in_ch, data_format=data_format,
                              device=init["device"])
        self.conv = Conv2D(in_ch, out_ch, 1, bias_attr=False,
                           data_format=data_format, **init)
        self.pool = AvgPool2D(2, 2, data_format=data_format)
        self.relu = ReLU()

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Module):
    """DenseNet-`layers`. The JAX model accepts `dropout` and never applies
    it; the port refuses a nonzero one."""

    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, data_format="NCHW", *, device=None, seed=0,
                 generator=None):
        super().__init__()
        if layers not in _CFGS:
            raise ValueError(f"DenseNet layers must be one of {list(_CFGS)}")
        if dropout:
            raise NotImplementedError("DenseNet(dropout=) is not ported (the "
                                      "JAX model never applies it)")
        init = init_kwargs(device, seed, generator)
        df = self.data_format = data_format
        init_ch, growth, blocks = _CFGS[layers]
        self.stem = Sequential(
            Conv2D(3, init_ch, 7, stride=2, padding=3, bias_attr=False,
                   data_format=df, **init),
            BatchNorm2D(init_ch, data_format=df, device=init["device"]),
            ReLU(), MaxPool2D(3, stride=2, padding=1, data_format=df))
        ch = init_ch
        stages = []
        for i, n in enumerate(blocks):
            for _ in range(n):
                stages.append(_DenseLayer(ch, growth, bn_size, init=init,
                                          data_format=df))
                ch += growth
            if i != len(blocks) - 1:
                stages.append(_Transition(ch, ch // 2, init=init,
                                          data_format=df))
                ch //= 2
        self.features = Sequential(*stages)
        self.bn_final = BatchNorm2D(ch, data_format=df,
                                    device=init["device"])
        self.relu = ReLU()
        self.with_pool = with_pool
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1), data_format=df)
        self.num_classes = num_classes
        if num_classes > 0:
            self.fc = Linear(ch, num_classes, **init)

    def forward(self, x):
        x = self.relu(self.bn_final(self.features(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten_nchw(x, self.data_format))
        return x


def _make(layers):
    def fn(pretrained=False, **kwargs):
        refuse_pretrained(pretrained)
        return DenseNet(layers=layers, **kwargs)
    fn.__name__ = fn.__qualname__ = f"densenet{layers}"
    return fn


densenet121 = _make(121)
densenet161 = _make(161)
densenet169 = _make(169)
densenet201 = _make(201)
densenet264 = _make(264)
