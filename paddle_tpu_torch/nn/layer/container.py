"""Container layers (counterpart of paddle_tpu/nn/layer/container.py):
`Sequential`, `LayerList`, `ParameterList` and `LayerDict`.

They are `torch.nn` containers with the JAX layers' child names — ``"0"``,
``"1"``, ... for the sequences, the caller's keys for `Sequential(
OrderedDict)`, `(name, layer)` pairs and `LayerDict` — so that
`convert.load_jax_state` finds every tensor under the JAX model's name.
"""
from __future__ import annotations

import collections

from torch import nn

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(nn.Sequential):
    """Children in call order: positional layers named by their index, an
    `OrderedDict` or `(name, layer)` pairs by their names."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if isinstance(layer, (list, tuple)) and len(layer) == 2:
                self.add_module(str(layer[0]), layer[1])
            else:
                self.add_module(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


class LayerList(nn.ModuleList):
    """`torch.nn.ModuleList` with Paddle's `insert` (renumbers every
    child) and `append` / `extend` returning the list."""

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return super().__getitem__(idx)

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self.add_module(str(i), sub)


class ParameterList(nn.ParameterList):
    """Parameters named ``"0"``, ``"1"``, ...; `append` returns the
    list."""


class LayerDict(nn.ModuleDict):
    """`torch.nn.ModuleDict` with Paddle's `update` (a dict or `(key,
    layer)` pairs, returning the dict)."""

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for k, v in items:
            self[k] = v
        return self
