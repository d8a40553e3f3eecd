"""nn surface of the port (counterpart of paddle_tpu/nn): the functionals,
dropout and norm layers, weight-only quantization and gradient clipping."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layer.common import Dropout
from .layer.norm import LayerNorm, RMSNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "Dropout", "LayerNorm",
           "RMSNorm"]
