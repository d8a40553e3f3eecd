"""Continuous-batching decode over a paged KV cache (counterpart of
paddle_tpu/inference/decode)."""
from .block_pool import BlockKVCache, OutOfBlocks, RESERVED_BLOCKS
from .engine import DecodeEngine, SequenceStream

__all__ = ["BlockKVCache", "OutOfBlocks", "RESERVED_BLOCKS", "DecodeEngine",
           "SequenceStream"]
