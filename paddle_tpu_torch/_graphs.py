"""Static-input programs, optionally captured as one CUDA graph: the
machinery under the decode engine's step programs
(`inference/decode/step_graphs.py`) and the bucket programs of a loaded
exported program (`jit/aot.py`).

A program is a body (a function of its static input tensors that returns
a dict of output tensors) and the static inputs it reads: device tensors,
views of one buffer, allocated once on the program's device. The caller
fills the program's host arrays (`stage()`), then `run()` copies them into
the static inputs and runs the body:

* on the GPU, after `capture`, as one `torch.cuda.CUDAGraph` replay. The
  graph is built once: an eager warm-up on a side stream (it builds the
  kernel library, makes the kernels' attribute calls and fills the
  wrappers' caches, all of which a capture must not do), then one capture
  into the given memory pool. The host arrays live in pinned memory, so a
  run is one non-blocking host-to-device copy, one replay and the copies
  of the outputs it needs (`fetch`);
* otherwise eagerly over the same static inputs.

A graph holds what its capture read: the static inputs, any tensor the
body reads (written in place, a replay sees its current contents) and the
parameters as they were at capture. Every per-run tensor is formed inside
the body from the static inputs, never outside it.

Launch accounting. The kernel wrappers count their launches in Python
(`.launches`, `.calls`, `.routes` by body), which a replay bypasses. A
capture records each wrapper's change over one run of the body, and every
replay adds it, so the counts read the same whether a program ran eagerly
or as a replay. Building a program (its warm-up and its capture) leaves
the counts as they were. Programs replay on several threads at once (a
pool's workers), so the additions and a capture's read-and-restore hold
the wrappers' count lock (`ops._counts`).
"""
from __future__ import annotations

import math

import torch

from .ops import counted_wrappers
from .ops._counts import COUNTS_LOCK

__all__ = ["StepProgram", "counted_wrappers"]

#: byte alignment of each static input inside its program's buffer
_ALIGN = 16


def _read(wrappers):
    return [(w.launches, getattr(w, "calls", None),
             dict(getattr(w, "routes", {}))) for w in wrappers]


def _restore(wrappers, counts):
    for w, (launches, calls, routes) in zip(wrappers, counts):
        w.launches = launches
        if calls is not None:
            w.calls = calls
        if routes:
            w.routes.update(routes)


class _Counts:
    """What one run of a body adds to each wrapper's counts."""

    def __init__(self, wrappers, before, after):
        self.items = []
        for w, b, a in zip(wrappers, before, after):
            launches = a[0] - b[0]
            calls = a[1] - b[1] if a[1] is not None else 0
            routes = {r: n - b[2].get(r, 0) for r, n in a[2].items()
                      if n != b[2].get(r, 0)}
            if launches or calls or routes:
                self.items.append((w, launches, calls, routes))

    def add(self):
        with COUNTS_LOCK:
            for w, launches, calls, routes in self.items:
                w.launches += launches
                if calls:
                    w.calls += calls
                for r, n in routes.items():
                    w.routes[r] = w.routes.get(r, 0) + n

    def as_dict(self):
        return {w.__name__: launches for w, launches, _, _ in self.items}


class _Staging:
    """Static inputs as views of one device buffer, and their host arrays
    (numpy views of one pinned buffer; the device buffer itself on the
    CPU). `fields`: (name, shape, dtype, fill value) tuples."""

    def __init__(self, fields, device):
        offsets, total = {}, 0
        for name, shape, dtype, _ in fields:
            offsets[name] = total
            nbytes = math.prod(shape) * dtype.itemsize
            total += -(-nbytes // _ALIGN) * _ALIGN
        self.dev = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                               device=device)
        self.host = self.dev if device.type == "cpu" else torch.empty(
            self.dev.shape, dtype=torch.uint8, pin_memory=True)

        def view(buf, name, shape, dtype):
            o = offsets[name]
            n = math.prod(shape) * dtype.itemsize
            return buf[o:o + n].view(dtype).view(shape)

        self.tensors = {name: view(self.dev, name, shape, dtype)
                        for name, shape, dtype, _ in fields}
        self.arrays = {name: view(self.host, name, shape, dtype).numpy()
                       for name, shape, dtype, _ in fields}
        self.fills = {name: fill for name, _, _, fill in fields}
        self.reset()

    def reset(self):
        for name, arr in self.arrays.items():
            arr.fill(self.fills[name])

    def upload(self):
        if self.host is not self.dev:
            self.dev.copy_(self.host, non_blocking=True)


class StepProgram:
    """One program; see the module docstring."""

    def __init__(self, name, fields, body, device):
        self.name = name
        self.device = device
        self._staging = _Staging(fields, device)
        self._body = body
        self._graph = None
        self._graphed = False        # ran as a CUDA graph (kept on release)
        self._counts = None
        # recorded after each host copy: the host arrays are not refilled
        # before the copy out of them is done
        self._uploaded = torch.cuda.Event() if device.type == "cuda" \
            else None
        self._host_out = {}
        self.outputs = None
        self.replays = 0             # runs: replays, or eager runs

    @property
    def graph(self):
        return self._graphed

    def capture(self, pool, wrappers):
        """Warm up on a side stream, then capture one run of the body into
        a CUDA graph in memory pool `pool`. Raises if the capture fails."""
        dev = self.device
        with COUNTS_LOCK:
            self._capture(pool, wrappers, dev)

    def _capture(self, pool, wrappers, dev):
        before = _read(wrappers)
        try:
            # the warm-up reads the static inputs' fill values
            self._staging.upload()
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._body(self._staging.tensors)
            torch.cuda.current_stream(dev).wait_stream(side)
            warm = _read(wrappers)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                outputs = self._body(self._staging.tensors)
            self._counts = _Counts(wrappers, warm, _read(wrappers))
        finally:
            _restore(wrappers, before)
        self._graph, self.outputs = graph, outputs
        self._graphed = True

    def release(self):
        """Drop the graph, the static buffers and the outputs (the counts
        stay readable); the program cannot run after this."""
        self._graph = self.outputs = self._staging = self._body = None
        self._host_out = {}

    def launches(self):
        """A replay's launches by wrapper name (graphs only)."""
        return self._counts.as_dict() if self._counts is not None else {}

    def stage(self):
        """The host arrays of the static inputs, reset to their fill
        values, to be filled for the next `run`."""
        if self._uploaded is not None and self.replays:
            self._uploaded.synchronize()
        self._staging.reset()
        return self._staging.arrays

    def run(self):
        """Copy the staged inputs in and run the body (a replay on the
        GPU); returns the output tensors."""
        self._staging.upload()
        if self._uploaded is not None:
            self._uploaded.record()
        if self._graph is not None:
            self._graph.replay()
            self._counts.add()
        else:
            self.outputs = self._body(self._staging.tensors)
        self.replays += 1
        return self.outputs

    def fetch(self, name, n):
        """The first n rows of output `name` as a list (waits for the
        step)."""
        out = self.outputs[name]
        if out.device.type == "cpu":
            return out[:n].tolist()
        host = self._host_out.get(name)
        if host is None or host.shape != out.shape:
            host = self._host_out[name] = torch.empty(
                out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(out.device).synchronize()
        return host[:n].tolist()
