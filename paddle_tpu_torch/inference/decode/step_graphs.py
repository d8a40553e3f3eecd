"""Step programs of the decode engine, one per (kind, bucket): the
counterpart of the JAX engine's bucketed AOT step executables
(paddle_tpu/inference/decode/engine.py `_decode_fn`, `_propose_fn`,
`_verify_fn` over `jit/aot.compile_jit`).

Each is a `StepProgram` (`paddle_tpu_torch._graphs`): static inputs, a
body, and on the GPU one CUDA graph captured into the memory pool that
all of an engine's programs share; on the CPU, and on the GPU for an
engine built with ``_eager_steps``, the body runs eagerly over the same
static inputs. A graph holds the KV pool's tensors and the adapter stacks
(written in place, so a replay sees their current contents) and the
model's parameters as they were at capture; every per-step tensor (the
write offsets, the adapter mask) is formed inside the body from the
static inputs. Its warm-up reads the fill values: every table entry 0, so
its KV writes land in the reserved block 0.
"""
from __future__ import annotations

import threading

import torch

from ..._graphs import StepProgram, counted_wrappers

__all__ = ["StepProgram", "StepPrograms", "counted_wrappers"]


class StepPrograms:
    """An engine's step programs by (kind, bucket), built on first use
    (`get`) on the thread that runs them. `graphs`: capture CUDA graphs
    (the GPU default); otherwise the programs run eagerly."""

    def __init__(self, device, graphs):
        self.device = device
        self.graphs = bool(graphs)
        if self.graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self._pool = None
        self._wrappers = None
        self._programs = {}
        self._lock = threading.Lock()

    def get(self, kind, bucket, make):
        """The (kind, bucket) program; `make()` returns its (fields, body)
        the first time."""
        prog = self._programs.get((kind, bucket))
        if prog is not None:
            return prog
        fields, body = make()
        prog = StepProgram(f"{kind}-b{bucket}", fields, body, self.device)
        if self.graphs:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._wrappers = counted_wrappers()
            prog.capture(self._pool, self._wrappers)
        with self._lock:
            self._programs[(kind, bucket)] = prog
        return prog

    def release(self):
        """Release every program's graph and buffers (the engine's
        shutdown, once no step can run): a graph is destroyed by its owner
        at a known point, never by the garbage collector at a random
        one."""
        with self._lock:
            progs = list(self._programs.values())
        for p in progs:
            p.release()
        self._pool = None

    @property
    def built(self):
        with self._lock:
            return len(self._programs)

    def stats(self):
        """{program name: {"graph": bool, "replays": n, "launches": {...}}}
        (`launches`: a replay's launches by wrapper)."""
        with self._lock:
            progs = list(self._programs.values())
        return {p.name: {"graph": p.graph, "replays": p.replays,
                         "launches": p.launches()} for p in progs}
