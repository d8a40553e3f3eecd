"""Functionals (counterpart of paddle_tpu/nn/functional)."""
from .activation import gelu, silu
from .attention import apply_rotary_pos_emb
from .norm import layer_norm, rms_norm

__all__ = ["gelu", "silu", "apply_rotary_pos_emb", "layer_norm", "rms_norm"]
