"""Layers (counterpart of paddle_tpu/nn/layer)."""
from .activation import GELU, ReLU, ReLU6, Silu
from .common import Dropout, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import Conv2D
from .norm import BatchNorm2D, LayerNorm, RMSNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["GELU", "ReLU", "ReLU6", "Silu", "Dropout", "Linear",
           "LayerDict", "LayerList", "ParameterList", "Sequential", "Conv2D",
           "BatchNorm2D", "LayerNorm", "RMSNorm", "AdaptiveAvgPool2D",
           "MaxPool2D"]
