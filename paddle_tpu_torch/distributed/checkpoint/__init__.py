"""Checkpointing of the port (counterpart of
paddle_tpu/distributed/checkpoint): only the commit sentinel so far,
which serving's weight hot-swap validates."""
from .api import (COMMITTED_SENTINEL, CheckpointError,
                  CheckpointNotCommittedError, commit_generation,
                  is_committed, write_commit_sentinel)

__all__ = ["COMMITTED_SENTINEL", "CheckpointError",
           "CheckpointNotCommittedError", "commit_generation",
           "is_committed", "write_commit_sentinel"]
