"""ResNet family (counterpart of paddle_tpu/models/resnet.py; BASELINE
config 1 of the project is ResNet-50 on ImageNet shapes).

The layer names are the JAX model's (``conv1``, ``bn1``, ``layer1.0.
downsample.1._mean`` ...), so `convert.load_jax_state` carries a JAX state
over. ``data_format="NHWC"`` runs the whole network channels-last
through views (`nn.functional.conv2d`): no activation is transposed.

Fused route (``PADDLE_TPU_FUSED_RESBLOCK``, read at each call, as in the
JAX package): a stride-1 identity `BottleneckBlock` whose three BNs use
batch statistics, in NHWC, runs through the fused forward and backward
kernels of `ops.fused_resblock` instead of the per-op route (cuDNN
convolutions, batch norm, relu):

* ``"0"`` (the default): the per-op route;
* ``"1"``: the fused route when the input is a bf16 CUDA tensor;
* ``"force"``: the fused route on any input; on the CPU that is the
  kernels' plain version (the tests use it).

On the GPU the fused route launches the kernels or raises; it never
drops back to the per-op route. Of ResNet-50's 16 bottleneck blocks the
12 that are not the first of their stage take it.
"""
from __future__ import annotations

import math
import os

import torch
from torch import nn

from .. import resolve_device
from ..nn import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, MaxPool2D, ReLU
from ..nn.functional.norm import update_running_stats
from ..ops import fused_resblock

__all__ = ["BottleneckBlock", "BasicBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "train_flops_per_image"]


def _fused_blocks_mode():
    return os.environ.get("PADDLE_TPU_FUSED_RESBLOCK", "0")


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__()
        df = self._data_format = data_format
        kw = dict(bias_attr=False, data_format=df, device=device,
                  generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, **kw)
        self.bn1 = BatchNorm2D(width, data_format=df, device=device)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation, **kw)
        self.bn2 = BatchNorm2D(width, data_format=df, device=device)
        self.conv3 = Conv2D(width, planes * self.expansion, 1, **kw)
        self.bn3 = BatchNorm2D(planes * self.expansion, data_format=df,
                               device=device)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def _can_fuse(self, x=None):
        """The JAX block's rule: every BN in batch-stats training mode, no
        downsample, stride 1, NHWC, groups 1, dilation 1, and the mode; in
        mode "1" the input must be a bf16 CUDA tensor (the kernels
        multiply in bf16; an f32 model keeps its numerics)."""
        for bn in (self.bn1, self.bn2, self.bn3):
            if not bn.training or bn._use_global_stats:
                return False
        if not (self.training and self.downsample is None
                and self.stride == 1 and self._data_format == "NHWC"
                and self.conv2._groups == 1
                and self.conv2._dilation == (1, 1)):
            return False
        mode = _fused_blocks_mode()
        if mode == "0":
            return False
        if mode == "force":
            return True
        if x is not None and x.dtype != torch.bfloat16:
            return False
        device = x.device if x is not None else self.conv1.weight.device
        return device.type == "cuda"

    def _forward_fused(self, x):
        y, mu1, v1, mu2, v2, mu3, v3 = fused_resblock.fused_block_impl(
            x, self.conv1.weight, self.conv2.weight, self.conv3.weight,
            self.bn1.weight, self.bn1.bias, self.bn2.weight, self.bn2.bias,
            self.bn3.weight, self.bn3.bias, eps=float(self.bn1._epsilon))
        n = x.numel() // x.shape[-1]
        for bn, mean, var in ((self.bn1, mu1, v1), (self.bn2, mu2, v2),
                              (self.bn3, mu3, v3)):
            update_running_stats(bn._mean, bn._variance, mean, var,
                                 bn._momentum, n)
        return y

    def forward(self, x):
        if self._can_fuse(x):
            return self._forward_fused(x)
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__()
        df = data_format
        kw = dict(bias_attr=False, data_format=df, device=device,
                  generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            **kw)
        self.bn1 = BatchNorm2D(planes, data_format=df, device=device)
        self.conv2 = Conv2D(planes, planes, 3, padding=1, **kw)
        self.bn2 = BatchNorm2D(planes, data_format=df, device=device)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """`block` (BottleneckBlock or BasicBlock) in four stages of
    `depth_cfg` blocks; `groups` and `width_per_group` shape each
    bottleneck's 3x3 (ResNeXt). `device`: the GPU by default (raises without
    one), ``"cpu"`` on request; weights from `seed` (Paddle's default
    initialisers: Kaiming-uniform convolutions, BN 1 / 0, a Xavier-uniform
    fc with a zero bias)."""

    def __init__(self, block, depth_cfg, num_classes=1000, with_pool=True,
                 data_format="NCHW", *, device=None, seed=0, groups=1,
                 width_per_group=64):
        super().__init__()
        self._groups, self._base_width = groups, width_per_group
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self._init = dict(device=dev, generator=gen)
        df = self.data_format = data_format
        self.inplanes = 64
        self.conv1 = Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                            data_format=df, **self._init)
        self.bn1 = BatchNorm2D(64, data_format=df, device=dev)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1,
                                 data_format=df)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0])
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], stride=2)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], stride=2)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], stride=2)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=df)
        self.num_classes = num_classes
        if num_classes > 0:
            fan_in = 512 * block.expansion
            self.fc = nn.Linear(fan_in, num_classes, device=dev)
            bound = math.sqrt(6.0 / (fan_in + num_classes))
            with torch.no_grad():
                self.fc.weight.uniform_(-bound, bound, generator=gen)
                self.fc.bias.zero_()
        del self._init

    def _make_layer(self, block, planes, blocks, stride=1):
        df = self.data_format
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, data_format=df,
                       **self._init),
                BatchNorm2D(planes * block.expansion, data_format=df,
                            device=self._init["device"]))
        grouped = dict(groups=self._groups, base_width=self._base_width)
        layers = [block(self.inplanes, planes, stride, downsample,
                        data_format=df, **grouped, **self._init)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, data_format=df,
                                **grouped, **self._init))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def resnet18(num_classes=1000, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes=num_classes, **kw)


def resnet34(num_classes=1000, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes=num_classes, **kw)


def resnet50(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes=num_classes,
                  **kw)


def resnet101(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes=num_classes,
                  **kw)


def resnet152(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], num_classes=num_classes,
                  **kw)


def wide_resnet50_2(num_classes=1000, **kw):
    """As the JAX package builds it: `ResNet` passes no `base_width`, so
    this is ResNet-50's width (a fault of the reference, mirrored)."""
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes=num_classes,
                  **kw)


def wide_resnet101_2(num_classes=1000, **kw):
    """ResNet-101's width, as the JAX package builds it (see
    `wide_resnet50_2`)."""
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes=num_classes,
                  **kw)


def _conv(conv, hw):
    """(FLOPs, output size) of `conv` on a square hw x hw input: 2 per
    multiply-add."""
    (k, _), (s, _), (d, _) = conv._kernel_size, conv._stride, conv._dilation
    p = conv._padding if isinstance(conv._padding, int) else conv._padding[0]
    out = (hw + 2 * p - d * (k - 1) - 1) // s + 1
    macs = (conv._out_channels * conv._in_channels // conv._groups * k * k
            * out * out)
    return 2 * macs, out


def train_flops_per_image(model, image_size):
    """Training FLOPs per image of a `ResNet` on square images: 3 x the
    forward's convolutions and fc, 2 per multiply-add (the MFU numerator;
    pooling, BN and elementwise work are not counted)."""
    flops, hw = _conv(model.conv1, image_size)
    hw = (hw + 2 - 3) // 2 + 1                 # the 3x3 / 2 max pool
    for stage in (model.layer1, model.layer2, model.layer3, model.layer4):
        for blk in stage:
            convs = ([blk.conv1, blk.conv2, blk.conv3]
                     if isinstance(blk, BottleneckBlock)
                     else [blk.conv1, blk.conv2])
            size = hw
            for conv in convs:
                f, size = _conv(conv, size)
                flops += f
            if blk.downsample is not None:
                flops += _conv(blk.downsample[0], hw)[0]
            hw = size
    if model.num_classes > 0:
        flops += 2 * model.fc.in_features * model.fc.out_features
    return 3 * flops
