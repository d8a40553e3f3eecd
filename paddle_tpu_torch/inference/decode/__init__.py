"""Continuous-batching decode over a paged KV cache (counterpart of
paddle_tpu/inference/decode)."""
from .adapter_pool import (AdapterPool, OutOfAdapterSlots, adapter_context,
                           current_context)
from .block_pool import BlockKVCache, OutOfBlocks, RESERVED_BLOCKS
from .engine import DecodeEngine, SequenceStream

__all__ = ["AdapterPool", "OutOfAdapterSlots", "adapter_context",
           "current_context", "BlockKVCache", "OutOfBlocks",
           "RESERVED_BLOCKS", "DecodeEngine", "SequenceStream"]
