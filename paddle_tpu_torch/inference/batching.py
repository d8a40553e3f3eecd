"""Dynamic request batching for serving (counterpart of
paddle_tpu/inference/batching.py).

* `BatchConfig`: the policy. `buckets` are the allowed batch sizes (a
  formed batch is padded to the smallest bucket that fits, so a model has
  only ``len(buckets)`` bucket programs), `max_wait_ms` the longest a
  request waits for batchmates, `deadline_margin_ms` the margin before the
  earliest deadline in a forming batch at which it flushes early.
* `DynamicBatcher`: executes a formed batch over one exported layer. It
  validates each request's feeds against the exported input_spec at
  admission, stacks the batch into the bucket program's static inputs
  (`TranslatedLayer.batched_call`, `jit.aot`: on the GPU one CUDA graph
  replay), and scatters each request's rows back as copies. Padding
  replicates the last real example (real data: no zero or NaN lanes), and
  padded rows are dropped, so every request's outputs are bit-identical
  to an unbatched `Predictor.run`.

`ServingPool(..., batching=BatchConfig(...))` wires it into the worker
loop (see serving.py). A batch of traced requests is a trace of its own
(obs.trace): its ``serving.batch`` root span links every member's trace
id, each member's trace gets a ``serving.batch_member`` event pointing
back, and the stages (``serving::batch_form``, ``_pad``, ``_dispatch``,
``_scatter``) are spans under the batch span.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..obs import trace as _otrace

__all__ = ["BatchConfig", "DynamicBatcher"]


def _np_dtype(name):
    if name == "bfloat16":
        raise TypeError("batching stacks numpy feeds, and numpy has no "
                        "bfloat16: export the program with float32 inputs")
    return np.dtype(name)


class BatchConfig:
    """Policy for dynamic batch formation.

    Args:
        buckets: allowed batch sizes (default ``(1, 2, 4, 8, 16)``),
            sorted and deduplicated; n requests pad to the smallest bucket
            >= n, and the gather loop never collects more than the largest.
        max_wait_ms: longest a dequeued request waits for batchmates before
            a partial batch is flushed; 0 batches only what is queued.
        deadline_margin_ms: flush the forming batch once the earliest
            deadline in it has at most this much left.
        cache: refused unless None (no persistent cache of bucket
            programs: `jit.aot.NO_DISK_CACHE`).
    """

    def __init__(self, buckets=(1, 2, 4, 8, 16), max_wait_ms=2.0,
                 deadline_margin_ms=5.0, cache=None):
        from ..jit.aot import refuse_cache

        bs = sorted({int(b) for b in buckets})
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.buckets = tuple(bs)
        if max_wait_ms < 0 or deadline_margin_ms < 0:
            raise ValueError("max_wait_ms / deadline_margin_ms must be >= 0")
        self.max_wait_ms = float(max_wait_ms)
        self.deadline_margin_ms = float(deadline_margin_ms)
        refuse_cache(cache)

    def __repr__(self):
        return (f"BatchConfig(buckets={self.buckets}, "
                f"max_wait_ms={self.max_wait_ms}, "
                f"deadline_margin_ms={self.deadline_margin_ms})")


class DynamicBatcher:
    """Bucketed batch execution over one exported `TranslatedLayer`.
    Thread-safe: several pool workers may execute batches at once (one
    bucket's program runs one batch at a time). Its counters are
    `ServingPool.stats()["batch"]`."""

    def __init__(self, layer, config=None, clock=time.monotonic):
        if not hasattr(layer, "batched_call"):
            raise TypeError(
                "dynamic batching needs an exported TranslatedLayer "
                f"(got {type(layer).__name__}: no batched_call) — load the "
                "artifact with paddle_tpu_torch.jit.load / inference.Config")
        self.layer = layer
        self.config = config or BatchConfig()
        self._clock = clock
        self._lock = threading.Lock()
        # obs histograms, installed by the owning ServingPool when its
        # registry is on: each request's queue wait, each dispatch's time
        self.h_queue_wait = None
        self.h_execute = None
        self._formed = 0
        self._requests = 0
        self._padded = 0
        self._occupancy_sum = 0.0
        self._by_bucket = {}
        self._flushes = {"full": 0, "wait": 0, "deadline": 0, "drain": 0}
        self._splits = 0
        self._split_requests = 0
        self._queue_wait_ms = 0.0
        self._queue_wait_max_ms = 0.0
        self._execute_ms = 0.0

    # -- policy ------------------------------------------------------------
    @property
    def max_bucket(self):
        return self.config.buckets[-1]

    def bucket_for(self, n):
        """Smallest configured bucket that fits n requests."""
        for b in self.config.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest bucket {self.max_bucket}")

    def validate(self, feeds):
        """One request's feeds against the exported input_spec: the right
        arity, exact shapes, cast to the spec's dtype. A mismatch raises
        ValueError at admission, before anything is queued."""
        spec = self.layer.input_spec
        if len(feeds) != len(spec):
            raise ValueError(
                f"expected {len(spec)} input(s) per request, got "
                f"{len(feeds)}")
        out = []
        for i, (f, s) in enumerate(zip(feeds, spec)):
            arr = np.asarray(f)
            want = tuple(s["shape"])
            if arr.shape != want:
                raise ValueError(
                    f"input {i} has shape {tuple(arr.shape)} but the "
                    f"exported program expects {want} — batching stacks "
                    f"whole examples; reshape the feed to the exported "
                    f"input_spec")
            out.append(np.ascontiguousarray(arr, dtype=_np_dtype(s["dtype"])))
        return out

    def warmup(self, buckets=None):
        """Build every bucket's program up front, so the pool takes
        traffic with no build stall. Returns the warmed buckets."""
        bs = self.config.buckets if buckets is None else sorted(
            {int(b) for b in buckets})
        for b in bs:
            if b > 0:
                self.layer.batched_call(b)
        return list(bs)

    # -- execution ---------------------------------------------------------
    def execute(self, requests):
        """Run one formed batch: pad to the bucket, run the bucket's
        program once, scatter each request's rows. Returns one result per
        request (a list of numpy outputs, as `Predictor.run` returns).
        Raises whatever the program raised: the pool splits and retries."""
        n = len(requests)
        bucket = self.bucket_for(n)
        now = self._clock()
        # a batch serves N traces, so it is a trace of its own (a span has
        # one parent): the batch span links every sampled member, each
        # member gets a back-link event, and the stage spans nest under
        # the batch span. The batch trace is sampled because its members
        # are: a back-link to a trace that recorded nothing would dangle
        members = ([r for r in requests
                    if r.ctx is not None and r.ctx.sampled]
                   if _otrace.enabled() else [])
        bspan = _otrace.null_span() if not members else _otrace.root_span(
            "serving.batch",
            attrs={"bucket": bucket, "n": n,
                   "links": [r.ctx.trace_id_hex for r in members]},
            sampled=True)
        try:
            for r in members:
                _otrace.event_in(
                    "serving.batch_member", r.ctx,
                    attrs={"request": r.id,
                           "batch_trace": bspan.trace_id_hex,
                           "batch_span": bspan.span_id_hex})
            with _otrace.span("serving::batch_form"):
                columns = list(zip(*(r.feeds for r in requests)))
            with _otrace.span("serving::batch_pad"):
                pad = bucket - n
                if pad:
                    columns = [col + (col[-1],) * pad for col in columns]
                stacked = [np.stack(col) for col in columns]

            fn = self.layer.batched_call(bucket)
            t0 = time.perf_counter()
            with _otrace.span("serving::batch_dispatch"):
                outs = fn(*stacked)
            exec_ms = (time.perf_counter() - t0) * 1e3
            if self.h_execute is not None:
                self.h_execute.observe(exec_ms / 1e3)
            with _otrace.span("serving::batch_scatter"):
                # copies, not views: a view would pin the bucket-sized
                # output
                results = [[o[j].copy() for o in outs] for j in range(n)]
        except BaseException as exc:
            bspan.end(error=exc)
            raise
        else:
            bspan.end()

        with self._lock:
            self._formed += 1
            self._requests += n
            self._padded += pad
            self._occupancy_sum += n / bucket
            self._by_bucket[bucket] = self._by_bucket.get(bucket, 0) + 1
            self._execute_ms += exec_ms
            for r in requests:
                if r.enqueued_at is not None:
                    w = max(0.0, (now - r.enqueued_at) * 1e3)
                    self._queue_wait_ms += w
                    self._queue_wait_max_ms = max(self._queue_wait_max_ms, w)
                    if self.h_queue_wait is not None and r.attempts == 1:
                        self.h_queue_wait.observe(w / 1e3, ctx=r.ctx)
        return results

    # -- bookkeeping hooks (pool-driven) -----------------------------------
    def note_flush(self, reason):
        with self._lock:
            self._flushes[reason] = self._flushes.get(reason, 0) + 1

    def note_split(self, n):
        with self._lock:
            self._splits += 1
            self._split_requests += n

    # -- observability -----------------------------------------------------
    def stats(self):
        """Snapshot. For every executed batch bucket = requests + padding,
        so ``sum(b * executed_by_bucket[b]) == requests +
        padded_examples``; ``occupancy`` is the mean real fraction of a
        dispatch."""
        with self._lock:
            formed = self._formed
            snap = {
                "buckets": list(self.config.buckets),
                "formed": formed,
                "requests": self._requests,
                "padded_examples": self._padded,
                "executed_by_bucket": dict(self._by_bucket),
                "occupancy": (self._occupancy_sum / formed) if formed else 0.0,
                "flushes": dict(self._flushes),
                "splits": self._splits,
                "split_requests": self._split_requests,
                "queue_wait_ms_total": self._queue_wait_ms,
                "queue_wait_ms_max": self._queue_wait_max_ms,
                "queue_wait_ms_avg": (self._queue_wait_ms / self._requests)
                if self._requests else 0.0,
                "execute_ms_total": self._execute_ms,
                "execute_ms_avg": (self._execute_ms / formed)
                if formed else 0.0,
            }
        snap["compile"] = self.layer.aot_stats() \
            if hasattr(self.layer, "aot_stats") else {}
        return snap
