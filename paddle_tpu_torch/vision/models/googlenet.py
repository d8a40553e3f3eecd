"""GoogLeNet and InceptionV3 (counterpart of
paddle_tpu/vision/models/googlenet.py): parallel conv branches
concatenated on the channel axis. NCHW or NHWC (`data_format`); `device`
the GPU by default, ``"cpu"`` on request; weights from `generator` (or
`seed`)."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import (AdaptiveAvgPool2D, AvgPool2D, Linear, MaxPool2D,
                   Sequential)
from ._blocks import (ChannelsFirstFlatten, channel_axis, conv_bn,
                      flatten_nchw, refuse_pretrained)
from ._init import init_kwargs

__all__ = ["GoogLeNet", "googlenet", "InceptionV3", "inception_v3"]


class _Inception(nn.Module):
    """GoogLeNet's block: 1x1, 1x1-3x3, 1x1-5x5 and pool-1x1 branches."""

    def __init__(self, cin, c1, c3r, c3, c5r, c5, pp, *, init, data_format):
        super().__init__()
        kw = dict(init=init, data_format=data_format)
        self.b1 = conv_bn(cin, c1, 1, **kw)
        self.b3 = Sequential(conv_bn(cin, c3r, 1, **kw),
                             conv_bn(c3r, c3, 3, padding=1, **kw))
        self.b5 = Sequential(conv_bn(cin, c5r, 1, **kw),
                             conv_bn(c5r, c5, 5, padding=2, **kw))
        self.pool = MaxPool2D(3, stride=1, padding=1, data_format=data_format)
        self.bp = conv_bn(cin, pp, 1, **kw)
        self._axis = channel_axis(data_format)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b3(x), self.b5(x),
                          self.bp(self.pool(x))], self._axis)


class GoogLeNet(nn.Module):
    """GoogLeNet (Inception v1) with batch norm. In train mode it returns
    (main, aux1, aux2) logits, the auxiliary heads (4 x 4 average pool,
    flatten, fc) on inception 4a's and 4d's outputs; in eval mode the
    main logits."""

    def __init__(self, num_classes=1000, with_pool=True, data_format="NCHW",
                 *, device=None, seed=0, generator=None):
        super().__init__()
        init = init_kwargs(device, seed, generator)
        df = self.data_format = data_format
        kw = dict(init=init, data_format=df)

        def pool():
            return MaxPool2D(3, stride=2, padding=1, data_format=df)

        self.stem = Sequential(
            conv_bn(3, 64, 7, stride=2, padding=3, **kw), pool(),
            conv_bn(64, 64, 1, **kw), conv_bn(64, 192, 3, padding=1, **kw),
            pool())
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32, **kw)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64, **kw)
        self.pool3 = pool()
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64, **kw)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64, **kw)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64, **kw)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64, **kw)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128, **kw)
        self.pool4 = pool()
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128, **kw)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128, **kw)
        self.with_pool = with_pool
        if with_pool:
            self.pool5 = AdaptiveAvgPool2D((1, 1), data_format=df)
        self.num_classes = num_classes
        if num_classes > 0:
            self.fc = Linear(1024, num_classes, **init)

            def aux(ch):
                return Sequential(AdaptiveAvgPool2D((4, 4), data_format=df),
                                  ChannelsFirstFlatten(df),
                                  Linear(ch * 16, num_classes, **init))

            self.aux1 = aux(512)
            self.aux2 = aux(528)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        a1 = x
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = x
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            out = self.fc(flatten_nchw(x, self.data_format))
            if self.training:
                return out, self.aux1(a1), self.aux2(a2)
            return out
        return x


def googlenet(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return GoogLeNet(**kwargs)


class _InceptionA(nn.Module):
    def __init__(self, cin, pool_feats, *, init, data_format):
        super().__init__()
        kw = dict(init=init, data_format=data_format)
        self.b1 = conv_bn(cin, 64, 1, **kw)
        self.b5 = Sequential(conv_bn(cin, 48, 1, **kw),
                             conv_bn(48, 64, 5, padding=2, **kw))
        self.b3 = Sequential(conv_bn(cin, 64, 1, **kw),
                             conv_bn(64, 96, 3, padding=1, **kw),
                             conv_bn(96, 96, 3, padding=1, **kw))
        self.pool = AvgPool2D(3, stride=1, padding=1, data_format=data_format)
        self.bp = conv_bn(cin, pool_feats, 1, **kw)
        self._axis = channel_axis(data_format)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x),
                          self.bp(self.pool(x))], self._axis)


class _ReductionA(nn.Module):
    def __init__(self, cin, *, init, data_format):
        super().__init__()
        kw = dict(init=init, data_format=data_format)
        self.b3 = conv_bn(cin, 384, 3, stride=2, **kw)
        self.b3d = Sequential(conv_bn(cin, 64, 1, **kw),
                              conv_bn(64, 96, 3, padding=1, **kw),
                              conv_bn(96, 96, 3, stride=2, **kw))
        self.pool = MaxPool2D(3, stride=2, data_format=data_format)
        self._axis = channel_axis(data_format)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], self._axis)


class InceptionV3(nn.Module):
    """InceptionV3 as the JAX package builds it: the 299 px stem, three A
    blocks and the A reduction, then the head on its 768 channels. The B
    and C blocks and the second reduction of the published network
    (Szegedy et al. 2016; Paddle's inceptionv3.py) are not there; the
    port mirrors the JAX model (ROADMAP Queue 3)."""

    def __init__(self, num_classes=1000, with_pool=True, data_format="NCHW",
                 *, device=None, seed=0, generator=None):
        super().__init__()
        init = init_kwargs(device, seed, generator)
        df = self.data_format = data_format
        kw = dict(init=init, data_format=df)
        self.stem = Sequential(
            conv_bn(3, 32, 3, stride=2, **kw), conv_bn(32, 32, 3, **kw),
            conv_bn(32, 64, 3, padding=1, **kw),
            MaxPool2D(3, stride=2, data_format=df),
            conv_bn(64, 80, 1, **kw), conv_bn(80, 192, 3, **kw),
            MaxPool2D(3, stride=2, data_format=df))
        self.a1 = _InceptionA(192, 32, **kw)
        self.a2 = _InceptionA(256, 64, **kw)
        self.a3 = _InceptionA(288, 64, **kw)
        self.red = _ReductionA(288, **kw)
        self.with_pool = with_pool
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1), data_format=df)
        self.num_classes = num_classes
        if num_classes > 0:
            self.fc = Linear(768, num_classes, **init)

    def forward(self, x):
        x = self.red(self.a3(self.a2(self.a1(self.stem(x)))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten_nchw(x, self.data_format))
        return x


def inception_v3(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return InceptionV3(**kwargs)
