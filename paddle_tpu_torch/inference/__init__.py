"""Inference surface of the port (counterpart of paddle_tpu/inference):
the paged continuous-batching decode engine with prefix sharing,
per-request sampling and LoRA adapters; the resilient serving runtime
(`ServingPool`); and the serving tier (`ServingRouter` over
`LocalReplica`s, with failover, restarts, autoscale and weight
hot-swap).

Not ported yet, each raising `NotImplementedError` when used: `Config`,
`Predictor`, `PredictorPool`, `create_predictor`, `BatchConfig` and
`DynamicBatcher` (they serve a jit.save artifact: the Predictor / jit
slice), and `SubprocessReplica` (the subprocess-replica slice)."""
from .decode import (AdapterPool, BlockKVCache, DecodeEngine,
                     OutOfAdapterSlots, OutOfBlocks, SequenceStream)
from .replica import (LocalHeartbeats, LocalReplica, ReplicaDead,
                      ReplicaError, SubprocessReplica)
from .router import (RouterConfig, RouterStream, ServingRouter, SwapFailed,
                     commit_model_dir)
from .sampling import SamplingParams
from .serving import (PREDICTOR_SLICE, AdapterNotLoaded, CircuitBreaker,
                      Deadline, DeadlineExceeded, Overloaded, PoolClosed,
                      RequestFailed, RetryPolicy, ServingError, ServingPool)

__all__ = [
    "Config", "Predictor", "create_predictor", "PredictorPool",
    "ServingPool", "ServingError", "DeadlineExceeded", "Overloaded",
    "PoolClosed", "RequestFailed", "CircuitBreaker", "RetryPolicy",
    "Deadline", "BatchConfig", "DynamicBatcher", "DecodeEngine",
    "SequenceStream", "BlockKVCache", "OutOfBlocks", "AdapterPool",
    "OutOfAdapterSlots", "AdapterNotLoaded", "SamplingParams",
    "ServingRouter", "RouterConfig", "RouterStream", "SwapFailed",
    "commit_model_dir", "LocalReplica", "SubprocessReplica",
    "LocalHeartbeats", "ReplicaError", "ReplicaDead"]


def _unported(name):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to paddle_tpu_torch yet; it comes with "
            f"{PREDICTOR_SLICE}")

    return type(name, (), {"__init__": __init__,
                           "__doc__": f"Not ported yet: {name} comes with "
                                      f"{PREDICTOR_SLICE}."})


Config = _unported("Config")
Predictor = _unported("Predictor")
PredictorPool = _unported("PredictorPool")
BatchConfig = _unported("BatchConfig")
DynamicBatcher = _unported("DynamicBatcher")


def create_predictor(config):
    """Not ported yet: comes with the Predictor / jit slice."""
    raise NotImplementedError(
        f"create_predictor is not ported to paddle_tpu_torch yet; it comes "
        f"with {PREDICTOR_SLICE}")
