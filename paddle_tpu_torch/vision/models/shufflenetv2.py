"""ShuffleNetV2 and MobileNetV3 (counterpart of
paddle_tpu/vision/models/shufflenetv2.py). NCHW or NHWC (`data_format`:
the stride-1 unit splits and concatenates the channel axis of that
layout, and the shuffle reads it); `device` the GPU by default, ``"cpu"``
on request; weights from `generator` (or `seed`)."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import (AdaptiveAvgPool2D, ChannelShuffle, Conv2D, Hardsigmoid,
                   Hardswish, Linear, MaxPool2D, ReLU, Sequential)
from ._blocks import (channel_axis, conv_bn, flatten_nchw,
                      refuse_pretrained)
from ._init import init_kwargs

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish", "MobileNetV3",
           "MobileNetV3Large", "MobileNetV3Small", "mobilenet_v3_large",
           "mobilenet_v3_small"]


class _ShuffleUnit(nn.Module):
    def __init__(self, cin, cout, stride, act="relu", *, init, data_format):
        super().__init__()
        kw = dict(init=init, data_format=data_format)
        self.stride = stride
        branch = cout // 2
        if stride == 1:
            self.right = Sequential(
                conv_bn(cin // 2, branch, 1, act=act, **kw),
                conv_bn(branch, branch, 3, padding=1, groups=branch,
                        act="none", **kw),
                conv_bn(branch, branch, 1, act=act, **kw))
            self.left = None
        else:
            self.left = Sequential(
                conv_bn(cin, cin, 3, stride=stride, padding=1, groups=cin,
                        act="none", **kw),
                conv_bn(cin, branch, 1, act=act, **kw))
            self.right = Sequential(
                conv_bn(cin, branch, 1, act=act, **kw),
                conv_bn(branch, branch, 3, stride=stride, padding=1,
                        groups=branch, act="none", **kw),
                conv_bn(branch, branch, 1, act=act, **kw))
        self.shuffle = ChannelShuffle(2, data_format)
        self._axis = channel_axis(data_format)

    def forward(self, x):
        if self.stride == 1:
            left, right = x.chunk(2, self._axis)
            out = torch.cat([left, self.right(right)], self._axis)
        else:
            out = torch.cat([self.left(x), self.right(x)], self._axis)
        return self.shuffle(out)


_SHUFFLE_CH = {
    0.25: (24, 24, 48, 96, 512),
    0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}


class ShuffleNetV2(nn.Module):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, data_format="NCHW", *, device=None, seed=0,
                 generator=None):
        super().__init__()
        init = init_kwargs(device, seed, generator)
        df = self.data_format = data_format
        kw = dict(init=init, data_format=df)
        chs = _SHUFFLE_CH[scale]
        self.stem = Sequential(
            conv_bn(3, chs[0], 3, stride=2, padding=1, act=act, **kw),
            MaxPool2D(3, stride=2, padding=1, data_format=df))
        stages, cin = [], chs[0]
        for i, repeats in enumerate((4, 8, 4)):
            cout = chs[i + 1]
            stages.append(_ShuffleUnit(cin, cout, 2, act, **kw))
            stages += [_ShuffleUnit(cout, cout, 1, act, **kw)
                       for _ in range(repeats - 1)]
            cin = cout
        self.stages = Sequential(*stages)
        self.tail = conv_bn(cin, chs[4], 1, act=act, **kw)
        self.with_pool = with_pool
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1), data_format=df)
        self.num_classes = num_classes
        if num_classes > 0:
            self.fc = Linear(chs[4], num_classes, **init)

    def forward(self, x):
        x = self.tail(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten_nchw(x, self.data_format))
        return x


def _shuffle(scale, act="relu", name=None):
    def fn(pretrained=False, **kwargs):
        refuse_pretrained(pretrained)
        return ShuffleNetV2(scale=scale, act=act, **kwargs)
    fn.__name__ = fn.__qualname__ = name
    return fn


shufflenet_v2_x0_25 = _shuffle(0.25, name="shufflenet_v2_x0_25")
shufflenet_v2_x0_33 = _shuffle(0.33, name="shufflenet_v2_x0_33")
shufflenet_v2_x0_5 = _shuffle(0.5, name="shufflenet_v2_x0_5")
shufflenet_v2_x1_0 = _shuffle(1.0, name="shufflenet_v2_x1_0")
shufflenet_v2_x1_5 = _shuffle(1.5, name="shufflenet_v2_x1_5")
shufflenet_v2_x2_0 = _shuffle(2.0, name="shufflenet_v2_x2_0")
shufflenet_v2_swish = _shuffle(1.0, act="swish", name="shufflenet_v2_swish")


class _SEModule(nn.Module):
    """Squeeze-and-excitation: pool, 1x1 down by `reduction`, ReLU, 1x1
    up, hard sigmoid, times the input."""

    def __init__(self, ch, reduction=4, *, init, data_format):
        super().__init__()
        self.pool = AdaptiveAvgPool2D((1, 1), data_format=data_format)
        self.fc1 = Conv2D(ch, ch // reduction, 1, data_format=data_format,
                          **init)
        self.fc2 = Conv2D(ch // reduction, ch, 1, data_format=data_format,
                          **init)
        self.relu = ReLU()
        self.hsig = Hardsigmoid()

    def forward(self, x):
        return x * self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))


class _MBV3Block(nn.Module):
    """Expand 1x1 (when mid != cin), depthwise k x k, SE, project 1x1;
    the residual at stride 1 with equal widths."""

    def __init__(self, cin, mid, cout, k, stride, use_se, act, *, init,
                 data_format):
        super().__init__()
        kw = dict(init=init, data_format=data_format)
        self.use_res = stride == 1 and cin == cout
        layers = [conv_bn(cin, mid, 1, act=act, **kw)] if mid != cin else []
        layers.append(conv_bn(mid, mid, k, stride=stride, padding=k // 2,
                              groups=mid, act=act, **kw))
        self.features = Sequential(*layers)
        self.se = _SEModule(mid, **kw) if use_se else None
        self.project = conv_bn(mid, cout, 1, act="none", **kw)

    def forward(self, x):
        out = self.features(x)
        if self.se is not None:
            out = self.se(out)
        out = self.project(out)
        return x + out if self.use_res else out


_MBV3_LARGE = [
    # k, mid, out, se, act, stride
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_MBV3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class MobileNetV3(nn.Module):
    """MobileNetV3 of a block table (`_MBV3_LARGE` / `_MBV3_SMALL`), its
    widths scaled by `scale` to multiples of 8; the head Linear,
    Hardswish, Linear."""

    def __init__(self, config, last_ch, scale=1.0, num_classes=1000,
                 with_pool=True, data_format="NCHW", *, device=None, seed=0,
                 generator=None):
        super().__init__()
        init = init_kwargs(device, seed, generator)
        df = self.data_format = data_format
        kw = dict(init=init, data_format=df)

        def c(v):
            return max(8, int(v * scale + 4) // 8 * 8)

        self.stem = conv_bn(3, c(16), 3, stride=2, padding=1,
                            act="hardswish", **kw)
        blocks, cin = [], c(16)
        for k, mid, cout, se, act, stride in config:
            blocks.append(_MBV3Block(cin, c(mid), c(cout), k, stride, se, act,
                                     **kw))
            cin = c(cout)
        self.blocks = Sequential(*blocks)
        mid_ch = c(config[-1][1])
        self.tail = conv_bn(cin, mid_ch, 1, act="hardswish", **kw)
        self.with_pool = with_pool
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1), data_format=df)
        self.num_classes = num_classes
        if num_classes > 0:
            self.head = Sequential(Linear(mid_ch, last_ch, **init),
                                   Hardswish(),
                                   Linear(last_ch, num_classes, **init))

    def forward(self, x):
        x = self.tail(self.blocks(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.head(flatten_nchw(x, self.data_format))
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_MBV3_LARGE, 1280, scale, num_classes, with_pool,
                         **kw)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_MBV3_SMALL, 1024, scale, num_classes, with_pool,
                         **kw)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)
