"""Functionals (counterpart of paddle_tpu/nn/functional)."""
from .activation import gelu, silu
from .attention import (apply_rotary_pos_emb, flash_attention,
                        scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["gelu", "silu", "apply_rotary_pos_emb", "flash_attention",
           "scaled_dot_product_attention", "cross_entropy", "layer_norm",
           "rms_norm"]
