"""Distributed surface of the port (counterpart of
paddle_tpu/distributed): the single-device training engine."""
from .engine import ShardedTrainStep, parallelize

__all__ = ["ShardedTrainStep", "parallelize"]
