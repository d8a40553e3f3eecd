"""Inference surface of the port (counterpart of paddle_tpu/inference):
the paged continuous-batching decode engine with prefix sharing,
per-request sampling and LoRA adapters, and its typed errors."""
from .decode import (AdapterPool, DecodeEngine, OutOfAdapterSlots,
                     SequenceStream)
from .sampling import SamplingParams
from .serving import (AdapterNotLoaded, Deadline, DeadlineExceeded,
                      Overloaded, PoolClosed, RequestFailed, ServingError)

__all__ = ["AdapterPool", "DecodeEngine", "OutOfAdapterSlots",
           "SequenceStream", "SamplingParams", "AdapterNotLoaded",
           "Deadline", "DeadlineExceeded", "Overloaded", "PoolClosed",
           "RequestFailed", "ServingError"]
