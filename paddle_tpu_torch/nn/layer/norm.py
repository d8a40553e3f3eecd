"""Norm layers (counterpart of paddle_tpu/nn/layer/norm.py).

`BatchNorm2D` keeps the JAX layer's state names,
`weight`, `bias` and the buffers `_mean` / `_variance`, and nothing else
(no `num_batches_tracked`: it is not `torch.nn.BatchNorm2d`), so
`convert.load_jax_state` carries a JAX state over exactly."""
from __future__ import annotations

import torch
from torch import nn

from ..functional import norm as _F

__all__ = ["BatchNorm2D", "LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    def __init__(self, hidden, epsilon=1e-5, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(hidden, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return _F.layer_norm(x, self.weight, self.bias, self.epsilon)


class RMSNorm(nn.Module):
    def __init__(self, hidden, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return _F.rms_norm(x, self.weight, self.epsilon)


class BatchNorm2D(nn.Module):
    """Paddle's signature: `momentum` 0.9 (running * m + batch * (1 - m)),
    `epsilon`, `data_format`, `use_global_stats`; gamma 1, beta 0, running
    mean 0 and variance 1, f32 unless `dtype` says otherwise."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, *, device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = (nn.Parameter(torch.ones(num_features, **kw))
                       if weight_attr is not False else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, **kw))
                     if bias_attr is not False else None)
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        return _F.batch_norm(x, self._mean, self._variance, self.weight,
                             self.bias, training=self.training,
                             momentum=self._momentum, epsilon=self._epsilon,
                             data_format=self._data_format,
                             use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")

