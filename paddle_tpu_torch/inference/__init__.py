"""Inference surface of the port (counterpart of paddle_tpu/inference):
the paged continuous-batching decode engine and its typed errors."""
from .decode import DecodeEngine, SequenceStream
from .serving import (Deadline, DeadlineExceeded, Overloaded, PoolClosed,
                      RequestFailed, ServingError)

__all__ = ["DecodeEngine", "SequenceStream", "Deadline", "DeadlineExceeded",
           "Overloaded", "PoolClosed", "RequestFailed", "ServingError"]
