"""Layers (counterpart of paddle_tpu/nn/layer)."""
from .activation import (GELU, Hardsigmoid, Hardswish, ReLU, ReLU6, Silu,
                         Swish)
from .common import ChannelShuffle, Dropout, Flatten, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import Conv2D
from .norm import BatchNorm2D, LayerNorm, RMSNorm
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["GELU", "Hardsigmoid", "Hardswish", "ReLU", "ReLU6", "Silu",
           "Swish", "ChannelShuffle", "Dropout", "Flatten", "Linear",
           "LayerDict", "LayerList", "ParameterList", "Sequential", "Conv2D",
           "BatchNorm2D", "LayerNorm", "RMSNorm", "AdaptiveAvgPool2D",
           "AvgPool2D", "MaxPool2D"]
