"""Layers (counterpart of paddle_tpu/nn/layer)."""
from .common import Dropout
from .norm import LayerNorm, RMSNorm

__all__ = ["Dropout", "LayerNorm", "RMSNorm"]
