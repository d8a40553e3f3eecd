"""Optimizers of the port (counterpart of paddle_tpu/optimizer)."""
from .optimizer import AdamW

__all__ = ["AdamW"]
