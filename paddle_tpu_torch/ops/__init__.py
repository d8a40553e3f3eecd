"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterparts of paddle_tpu/ops/pallas)."""
from .decode_attn import paged_decode_attention, paged_decode_attention_ref
from .flash_attention import (flash_attention, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq, flash_attention_bwd_ref,
                              flash_attention_fwd, flash_attention_ref,
                              flash_attention_supported)
from .weight_only import (weight_only_matmul, weight_only_matmul_nd,
                          weight_only_matmul_ref)

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "flash_attention", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_bwd_ref",
           "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_supported", "weight_only_matmul",
           "weight_only_matmul_nd", "weight_only_matmul_ref"]
