"""Pieces shared by the CNN families of the port's model zoo: the
conv + batch norm + activation unit, the channel axis of a layout, and
the analytic training FLOPs of any model of them."""
from __future__ import annotations

import torch

from ...nn import (BatchNorm2D, Conv2D, Flatten, Hardswish, ReLU,
                   Sequential, Swish)

_ACTS = {"relu": ReLU, "swish": Swish, "hardswish": Hardswish}


def refuse_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled: load "
                                  "a state dict explicitly")


def channel_axis(data_format):
    return 1 if data_format == "NCHW" else -1


def conv_bn(c_in, c_out, k, stride=1, padding=0, groups=1, act="relu", *,
            init, data_format="NCHW"):
    """Sequential(Conv2D without bias, BatchNorm2D[, act]): the JAX
    models' `_cbr` (``act="none"``: no activation)."""
    layers = [Conv2D(c_in, c_out, k, stride=stride, padding=padding,
                     groups=groups, bias_attr=False, data_format=data_format,
                     **init),
              BatchNorm2D(c_out, data_format=data_format,
                          device=init["device"])]
    if act != "none":
        layers.append(_ACTS[act]())
    return Sequential(*layers)


def flatten_nchw(x, data_format):
    """[N, C * H * W] in NCHW order in either layout: a classifier trained
    on the JAX model's NCHW flatten reads C x H x W."""
    return torch.flatten(x.permute(0, 3, 1, 2) if data_format == "NHWC"
                         else x, 1)


class ChannelsFirstFlatten(Flatten):
    """`Flatten` (from axis 1) through `flatten_nchw`."""

    def __init__(self, data_format="NCHW"):
        super().__init__()
        self._data_format = data_format

    def forward(self, x):
        return flatten_nchw(x, self._data_format)


def train_flops_per_image(model, image_size):
    """Training FLOPs per square image: 3 x the forward's `Conv2D` and
    `Linear` products (2 per multiply-add), each at the output size one
    train-mode forward of a 2-image batch gives it (so GoogLeNet's
    auxiliary heads count; two images keep batch norm defined on a 1 x 1
    map). The model's buffers and mode are put back. A ResNet forced onto
    the fused-bottleneck route (``PADDLE_TPU_FUSED_RESBLOCK=force``) runs
    its convolutions outside the modules and is not counted so."""
    flops = []

    def conv_hook(mod, inp, out):
        kh, kw = mod._kernel_size
        spatial = out.shape[1:3] if mod._data_format == "NHWC" \
            else out.shape[2:]
        flops.append(2 * mod._out_channels * mod._in_channels // mod._groups
                     * kh * kw * spatial[0] * spatial[1])

    def linear_hook(mod, inp, out):
        flops.append(2 * mod.in_features * mod.out_features)

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, Conv2D)
                                     else linear_hook)
             for m in model.modules()
             if isinstance(m, (Conv2D, torch.nn.Linear))]
    param = next(model.parameters())
    shape = (2, image_size, image_size, 3) \
        if getattr(model, "data_format", "NCHW") == "NHWC" \
        else (2, 3, image_size, image_size)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    training = model.training
    try:
        model.train()
        with torch.no_grad():
            model(torch.zeros(shape, dtype=param.dtype, device=param.device))
    finally:
        for h in hooks:
            h.remove()
        model.load_state_dict(saved)
        model.train(training)
    return 3 * sum(flops)
