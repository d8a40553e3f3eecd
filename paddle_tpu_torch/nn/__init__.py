"""nn surface of the port (counterpart of paddle_tpu/nn): the functionals,
convolution, pooling, activation, dropout and norm layers, weight-only
quantization, gradient clipping and LoRA (`nn.lora`)."""
from . import functional, lora
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer.activation import ReLU
from .layer.common import Dropout
from .layer.conv import Conv2D
from .layer.norm import BatchNorm2D, LayerNorm, RMSNorm
from .layer.pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["functional", "lora", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "clip_grad_value_", "ReLU",
           "Dropout", "Conv2D", "BatchNorm2D", "LayerNorm", "RMSNorm",
           "AdaptiveAvgPool2D", "MaxPool2D"]
