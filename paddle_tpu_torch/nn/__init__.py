"""nn surface of the port (counterpart of paddle_tpu/nn): the functionals,
containers, Linear, convolution, pooling, activation, dropout and norm
layers, weight-only quantization, gradient clipping and LoRA
(`nn.lora`)."""
from . import functional, lora
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer.activation import (GELU, Hardsigmoid, Hardswish, ReLU, ReLU6,
                               Silu, Swish)
from .layer.common import ChannelShuffle, Dropout, Flatten, Linear
from .layer.container import LayerDict, LayerList, ParameterList, Sequential
from .layer.conv import Conv2D
from .layer.norm import BatchNorm2D, LayerNorm, RMSNorm
from .layer.pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["functional", "lora", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "clip_grad_value_", "GELU",
           "Hardsigmoid", "Hardswish", "ReLU", "ReLU6", "Silu", "Swish",
           "ChannelShuffle", "Dropout", "Flatten", "Linear", "LayerDict",
           "LayerList", "ParameterList", "Sequential", "Conv2D",
           "BatchNorm2D", "LayerNorm", "RMSNorm", "AdaptiveAvgPool2D",
           "AvgPool2D", "MaxPool2D"]
