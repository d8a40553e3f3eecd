"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterparts of paddle_tpu/ops/pallas)."""
import importlib
import pkgutil

from .bgmv import lora_delta, lora_delta_ref
from .block_sparse_attention import (block_sparse_attention,
                                     block_sparse_attention_ref,
                                     csr_to_block_tables)
from .decode_attn import (decode_attention, decode_attention_ref,
                          paged_decode_attention, paged_decode_attention_ref)
from .fused_resblock import (fused_bottleneck, fused_bottleneck2_fwd,
                             fused_bottleneck2_fwd_ref, fused_bottleneck_bwd,
                             fused_bottleneck_bwd_ref, fused_bottleneck_fwd,
                             fused_bottleneck_fwd_ref)
from .flash_attention import (flash_attention, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq, flash_attention_bwd_ref,
                              flash_attention_fwd, flash_attention_ref,
                              flash_attention_supported)
from .short_attention import (short_attention, short_attention_bwd,
                              short_attention_bwd_ref, short_attention_fwd,
                              short_attention_ref)
from .weight_only import (weight_only_matmul, weight_only_matmul_nd,
                          weight_only_matmul_ref)

__all__ = ["lora_delta", "lora_delta_ref", "block_sparse_attention",
           "block_sparse_attention_ref", "csr_to_block_tables",
           "decode_attention", "decode_attention_ref",
           "paged_decode_attention",
           "paged_decode_attention_ref", "flash_attention",
           "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_bwd_ref",
           "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_supported", "fused_bottleneck",
           "fused_bottleneck2_fwd", "fused_bottleneck2_fwd_ref",
           "fused_bottleneck_bwd", "fused_bottleneck_bwd_ref",
           "fused_bottleneck_fwd", "fused_bottleneck_fwd_ref",
           "short_attention",
           "short_attention_bwd", "short_attention_bwd_ref",
           "short_attention_fwd", "short_attention_ref", "weight_only_matmul",
           "weight_only_matmul_nd", "weight_only_matmul_ref",
           "counted_wrappers"]


def counted_wrappers():
    """Every kernel wrapper of this package: the functions, in any of its
    modules, with an int `.launches` (the count each adds to where it
    launches its kernel)."""
    found = {}
    for info in pkgutil.iter_modules(__path__):
        mod = importlib.import_module(f"{__name__}.{info.name}")
        for fn in vars(mod).values():
            if callable(fn) and type(getattr(fn, "launches", None)) is int:
                found[id(fn)] = fn
    return list(found.values())
