"""nn surface of the port (counterpart of paddle_tpu/nn): the functionals,
norm layers and weight-only quantization the serving slice needs."""
from . import functional
from .layer.norm import LayerNorm, RMSNorm

__all__ = ["functional", "LayerNorm", "RMSNorm"]
