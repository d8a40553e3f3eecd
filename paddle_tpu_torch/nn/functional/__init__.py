"""Functionals (counterpart of paddle_tpu/nn/functional)."""
from .activation import gelu, relu, silu
from .attention import (apply_rotary_pos_emb, flash_attention,
                        flash_attn_unpadded, scaled_dot_product_attention,
                        sparse_attention)
from .common import dropout
from .conv import conv2d
from .loss import cross_entropy
from .norm import batch_norm, layer_norm, rms_norm, update_running_stats
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["gelu", "relu", "silu", "apply_rotary_pos_emb",
           "flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention", "sparse_attention", "dropout",
           "conv2d", "cross_entropy", "batch_norm", "layer_norm", "rms_norm",
           "update_running_stats", "adaptive_avg_pool2d", "max_pool2d"]
