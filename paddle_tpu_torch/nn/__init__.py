"""nn surface of the port (counterpart of paddle_tpu/nn): the functionals,
norm layers, weight-only quantization and gradient clipping."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layer.norm import LayerNorm, RMSNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "LayerNorm", "RMSNorm"]
