"""Distributed surface of the port (counterpart of
paddle_tpu/distributed): the training engine, on one device or as one
rank of a context-parallel mesh, and ring / Ulysses attention."""
from .context_parallel import (active_context_parallel,
                               context_parallel_attention,
                               context_parallel_guard, ring_attention,
                               ulysses_attention, zigzag_permutation)
from .engine import ShardedTrainStep, parallelize

__all__ = ["ShardedTrainStep", "parallelize", "context_parallel_attention",
           "ring_attention", "ulysses_attention", "context_parallel_guard",
           "active_context_parallel", "zigzag_permutation"]
