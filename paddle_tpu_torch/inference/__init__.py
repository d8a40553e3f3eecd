"""Inference surface of the port (counterpart of paddle_tpu/inference):
the deployment predictor over a `jit.save` artifact (`Config`,
`create_predictor`, `Predictor` with the reference's named handles,
`PredictorPool`), dynamic request batching (`BatchConfig`,
`DynamicBatcher`), the paged continuous-batching decode engine with
prefix sharing, per-request sampling and LoRA adapters; the resilient
serving runtime (`ServingPool`); and the serving tier (`ServingRouter`
over `LocalReplica`s in this process or `SubprocessReplica`s, each its
own process over the coordination store, with failover, restarts,
autoscale and weight hot-swap). Requests are traced (`obs.trace`) across
threads and processes.

A `Config` resolves to the GPU (and raises when there is none) unless
`disable_gpu()` asks for the CPU. The artifact's program launches the
hand-written kernels through their operators on the GPU and computes
their plain versions on the CPU.
"""
from __future__ import annotations

import contextlib as _contextlib
import queue as _queue
import threading as _threading

import numpy as np

__all__ = [
    "Config", "Predictor", "create_predictor", "PredictorPool",
    "ServingPool", "ServingError", "DeadlineExceeded", "Overloaded",
    "PoolClosed", "RequestFailed", "CircuitBreaker", "RetryPolicy",
    "Deadline", "BatchConfig", "DynamicBatcher", "DecodeEngine",
    "SequenceStream", "BlockKVCache", "OutOfBlocks", "AdapterPool",
    "OutOfAdapterSlots", "AdapterNotLoaded", "SamplingParams",
    "ServingRouter", "RouterConfig", "RouterStream", "SwapFailed",
    "commit_model_dir", "LocalReplica", "SubprocessReplica",
    "serve_replica", "LocalHeartbeats", "ReplicaError", "ReplicaDead"]


class Config:
    """Reference: paddle.inference.Config(prog_file, params_file) — here
    one artifact prefix, as `jit.save` writes it (a file path of the
    artifact is accepted too). The device is the GPU unless
    `disable_gpu()` is called; `enable_use_gpu(..., device_id)` picks a
    card."""

    def __init__(self, prog_file=None, params_file=None):
        path = prog_file or ""
        for suffix in (".pdmodel.json", ".pdmodel.txt", ".pdmodel",
                       ".pdiparams"):
            if path.endswith(suffix):
                path = path[: -len(suffix)]
                break
        self.model_prefix = path
        self._device = None                    # None: the GPU
        self.memory_pool_init_size_mb = 0

    def enable_use_gpu(self, memory_pool_init_size_mb=0, device_id=0):
        self.memory_pool_init_size_mb = memory_pool_init_size_mb
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device != "cpu"

    def device(self):
        """The device the predictor runs on (`resolve_device`'s rules:
        raises when the GPU is asked for and there is none)."""
        from .. import resolve_device

        return resolve_device(self._device)

    def switch_ir_optim(self, flag=True):
        pass  # the exported program is what runs

    def enable_memory_optim(self, flag=True):
        pass


class _Handle:
    """Input/output tensor handle (reference: ZeroCopyTensor). Input
    handles carry the exported input_spec entry, so a shape error
    surfaces at the handle."""

    def __init__(self, spec=None):
        self._arr = None
        self._spec = spec

    def copy_from_cpu(self, arr):
        self._arr = np.asarray(arr)

    def copy_to_cpu(self):
        return self._arr

    def reset(self):
        """Drop the staged array (pool hygiene between leases)."""
        self._arr = None

    def reshape(self, shape):
        """Shapes are fixed by the exported program: a matching reshape is
        a no-op, a mismatched one raises here."""
        if self._spec is None:
            return
        want = [int(s) for s in self._spec["shape"]]
        got = [int(s) for s in shape]
        if got != want:
            raise ValueError(
                f"reshape({got}) conflicts with the exported program's "
                f"fixed input shape {want} — re-export with the desired "
                f"input_spec (jit.save) instead of reshaping the handle")

    @property
    def shape(self):
        return list(self._arr.shape) if self._arr is not None else None


class Predictor:
    """The exported program with named input and output handles. Outputs
    come back as numpy arrays (bf16 as float32, exactly)."""

    def __init__(self, config: Config, _shared_layer=None):
        if _shared_layer is None:
            from ..jit.save_load import load

            self._layer = load(config.model_prefix, device=config.device())
        else:
            self._layer = _shared_layer
        spec = self._layer.input_spec
        self._inputs = {f"input_{i}": _Handle(spec=spec[i])
                        for i in range(len(spec))}
        n_out = self._layer.num_outputs or 1
        self._outputs = {f"output_{i}": _Handle() for i in range(n_out)}

    def clone(self):
        """A predictor over the same loaded program and weights, with
        handles of its own (reference: AnalysisPredictor::Clone): no
        copy, no new program."""
        return Predictor(None, _shared_layer=self._layer)

    def get_input_names(self):
        return list(self._inputs)

    def get_input_handle(self, name):
        return self._inputs[name]

    def run(self, inputs=None):
        """Handle-style (copy_from_cpu, then run()) or direct
        run([arrays]) -> list of numpy outputs."""
        from ..jit.aot import host_array

        if inputs is None:
            unset = [n for n in self.get_input_names()
                     if self._inputs[n].copy_to_cpu() is None]
            if unset:
                raise ValueError(
                    f"input handle(s) {unset} were never set: call "
                    f"get_input_handle(name).copy_from_cpu(array) for every "
                    f"input before run()")
            inputs = [self._inputs[n].copy_to_cpu()
                      for n in self.get_input_names()]
        outs = self._layer(*inputs)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        res = [host_array(o) for o in outs]
        for i, arr in enumerate(res):
            self._outputs[f"output_{i}"].copy_from_cpu(arr)
        return res

    def get_output_names(self):
        return list(self._outputs)

    def get_output_handle(self, name):
        """The output handle of `name`: the same object on every call,
        updated by every run() and cleared by reset_handles()."""
        return self._outputs[name]

    def reset_handles(self):
        """Clear every staged input and output (a pool does it when a
        member comes back from a failed request)."""
        for h in self._inputs.values():
            h.reset()
        for h in self._outputs.values():
            h.reset()


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class PredictorPool:
    """A fixed pool of cloned predictors (reference:
    services::PredictorPool): one artifact load serves every member, each
    with its own handles. `retrieve(idx)` gives member idx to a caller
    that owns the thread-to-member mapping; `acquire()` leases a member
    exclusively (a request in flight holds it alone)."""

    def __init__(self, config: Config, size: int = 1):
        if size < 1:
            raise ValueError("pool size must be >= 1")
        first = Predictor(config)
        self._preds = [first] + [first.clone() for _ in range(size - 1)]
        self._free = _queue.Queue()
        for p in self._preds:
            self._free.put(p)
        self._lock = _threading.Lock()
        self._leased = set()
        self._leases_granted = 0
        self._dirty_releases = 0

    def retrieve(self, idx: int) -> Predictor:
        if not 0 <= idx < len(self._preds):
            raise IndexError(
                f"predictor index {idx} out of range [0, {len(self._preds)})")
        return self._preds[idx]

    Retrieve = retrieve

    @_contextlib.contextmanager
    def acquire(self, timeout=None):
        """Lease a member for one request (``with pool.acquire() as p``).
        Blocks while every member is in flight, or raises TimeoutError
        after `timeout` seconds; a member released after its body raised
        comes back with its handles cleared."""
        try:
            p = self._free.get(timeout=timeout)
        except _queue.Empty:
            raise TimeoutError(
                f"no free predictor within {timeout}s "
                f"(all {len(self._preds)} members in flight)") from None
        with self._lock:
            self._leased.add(id(p))
            self._leases_granted += 1
        try:
            yield p
        except BaseException:
            p.reset_handles()
            with self._lock:
                self._dirty_releases += 1
            raise
        finally:
            with self._lock:
                self._leased.discard(id(p))
            self._free.put(p)

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._preds),
                    "in_flight": len(self._leased),
                    "leases_granted": self._leases_granted,
                    "dirty_releases": self._dirty_releases}

    def __len__(self):
        return len(self._preds)


# the serving runtime builds on Predictor above: import last
from .batching import BatchConfig, DynamicBatcher  # noqa: E402
from .decode import (AdapterPool, BlockKVCache, DecodeEngine,  # noqa: E402
                     OutOfAdapterSlots, OutOfBlocks, SequenceStream)
from .replica import (LocalHeartbeats, LocalReplica,  # noqa: E402
                      ReplicaDead, ReplicaError, SubprocessReplica,
                      serve_replica)
from .router import (RouterConfig, RouterStream,  # noqa: E402
                     ServingRouter, SwapFailed, commit_model_dir)
from .sampling import SamplingParams  # noqa: E402
from .serving import (AdapterNotLoaded, CircuitBreaker,  # noqa: E402
                      Deadline, DeadlineExceeded, Overloaded, PoolClosed,
                      RequestFailed, RetryPolicy, ServingError, ServingPool)
