"""Layers (counterpart of paddle_tpu/nn/layer)."""
from .activation import ReLU
from .common import Dropout
from .conv import Conv2D
from .norm import BatchNorm2D, LayerNorm, RMSNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["ReLU", "Dropout", "Conv2D", "BatchNorm2D", "LayerNorm",
           "RMSNorm", "AdaptiveAvgPool2D", "MaxPool2D"]
