"""ResNeXt (counterpart of paddle_tpu/vision/models/resnext.py): the core
`ResNet` whose bottlenecks take `groups` = cardinality and a base width of
4, built grouped from the start (the JAX model builds ResNet-50 and then
replaces its stages). The layer names are the JAX model's, so
`convert.load_jax_state` carries its weights. Grouped 3x3s keep every
block off the fused-bottleneck route (`BottleneckBlock._can_fuse` takes
groups 1 only)."""
from __future__ import annotations

from ...models.resnet import BottleneckBlock, ResNet
from ._blocks import refuse_pretrained

__all__ = ["ResNeXt", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d"]

_DEPTHS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
_WIDTHS = {32: 4, 64: 4}


class ResNeXt(ResNet):
    """ResNeXt-`depth` with `cardinality` groups of width 4 a bottleneck.
    `data_format`, `device` and `seed` as `ResNet`'s."""

    def __init__(self, depth=50, cardinality=32, num_classes=1000,
                 with_pool=True, data_format="NCHW", *, device=None, seed=0):
        super().__init__(BottleneckBlock, _DEPTHS[depth],
                         num_classes=num_classes, with_pool=with_pool,
                         data_format=data_format, device=device, seed=seed,
                         groups=cardinality,
                         width_per_group=_WIDTHS[cardinality])


def _make(depth, cardinality):
    def fn(pretrained=False, **kwargs):
        refuse_pretrained(pretrained)
        return ResNeXt(depth=depth, cardinality=cardinality, **kwargs)
    fn.__name__ = fn.__qualname__ = f"resnext{depth}_{cardinality}x4d"
    return fn


resnext50_32x4d = _make(50, 32)
resnext50_64x4d = _make(50, 64)
resnext101_32x4d = _make(101, 32)
resnext101_64x4d = _make(101, 64)
resnext152_32x4d = _make(152, 32)
resnext152_64x4d = _make(152, 64)
