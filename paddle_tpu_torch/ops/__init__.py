"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterparts of paddle_tpu/ops/pallas)."""
from .decode_attn import paged_decode_attention, paged_decode_attention_ref
from .weight_only import (weight_only_matmul, weight_only_matmul_nd,
                          weight_only_matmul_ref)

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "weight_only_matmul", "weight_only_matmul_nd",
           "weight_only_matmul_ref"]
