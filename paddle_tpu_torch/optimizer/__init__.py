"""Optimizers of the port (counterpart of paddle_tpu/optimizer)."""
from .optimizer import AdamW, Momentum

__all__ = ["AdamW", "Momentum"]
