"""The resilient serving runtime (counterpart of
paddle_tpu/inference/serving.py): the typed request errors, `Deadline`,
`CircuitBreaker`, `RetryPolicy` and `ServingPool`.

`ServingPool` supervises a fixed number of member slots, each a clone of
one base member driven by its own worker thread:

* **Deadlines**: a request's `Deadline` covers queue wait and execution.
  Expired requests fail with `DeadlineExceeded` before compute is spent
  (at admission, at dequeue and by a background sweep), and a caller
  waiting on a result enforces the same deadline itself.
* **Admission control**: a bounded queue (`max_queue_depth`); beyond it a
  request is shed with `Overloaded`, after `shutdown()` with
  `PoolClosed`.
* **Supervision**: a transient execution error quarantines the member
  (its handles reset, a fresh clone of the base in its place) and
  charges the slot's `CircuitBreaker`; the request is retried under the
  `RetryPolicy` with jittered backoff. A deterministic request error
  (`ValueError`, `TypeError`) fails fast with `RequestFailed`, is not
  retried and does not charge the member. A member stuck past a
  request's deadline by more than `hang_grace` is detected by the
  supervisor: the request fails, the worker is retired (its thread is
  abandoned) and the slot gets a fresh clone on a new worker. On the
  default monotonic clock the supervisor sleeps until the earliest
  deadline it watches (a queued request's, or an in-flight one's plus
  `hang_grace`) and is woken only when a request brings an earlier one,
  so a stream of short requests costs it no wake-up each; on a caller's
  clock it sweeps every `supervise_interval` seconds.
* **Drain**: `shutdown(drain_timeout)` stops admissions, lets queued and
  in-flight work finish within the timeout, then fails the rest with
  `PoolClosed`.
* **Observability**: `stats()` obeys ``admitted == completed + failed +
  timed_out + cancelled + queue_depth + in_flight`` (shed requests were
  never admitted). The pool observes latency histograms into the metrics
  registry (`paddle_tpu_torch.obs`) and registers `stats()` as a
  collector; `serve_metrics()` serves ``/metrics`` and ``/healthz``.

* **Dynamic batching** (``batching=BatchConfig(...)``): workers coalesce
  concurrent `infer()` requests into padded batches along the configured
  buckets, each served by one bucket program (batching.py, `jit.aot`: on
  the GPU one CUDA graph replay), deadline-aware: a batch flushes when the
  largest bucket fills, `max_wait_ms` passes or the earliest deadline in
  it nears. Each request's outputs are bit-identical to an unbatched
  `Predictor.run`. A failed multi-request batch is retried as split
  singles, so one poison request cannot fail its batchmates; `warmup()`
  builds every bucket's program before traffic.

A member is any object with `clone()`, `reset_handles()` and (for
`infer`) `run(feeds)`; ``config=`` (an `inference.Config`) builds a
`Predictor` over an exported program. ``decode_engine=`` alone makes a
generation-only pool, whose members are `_NullPredictor`s; the decode
engine runs each of its steps on such a one-slot pool.

`fault_hook(slot_index, request, member)` runs on the member's worker
thread just before execution: a raise is a member fault, a sleep a hang.
It exists for fault-injection tests; leave it None in production.
"""
from __future__ import annotations

import collections
import itertools
import math
import random
import threading
import time

import numpy as np

from ..obs import trace as _otrace

__all__ = ["ServingError", "DeadlineExceeded", "Overloaded", "PoolClosed",
           "RequestFailed", "AdapterNotLoaded", "Deadline", "CircuitBreaker",
           "RetryPolicy", "ServingPool", "DETERMINISTIC_ERRORS"]

# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------

class ServingError(RuntimeError):
    """Base of every error the serving runtime raises for a request.

    A subclass that is a request-level failure worth a postmortem (not
    routine shedding) sets ``_trace_postmortem``: constructing one under
    an active sampled trace context pins the trace's record into the
    flight recorder (obs.trace) and stamps the error's ``.trace_id``."""

    _trace_postmortem = False

    def __init__(self, *args):
        super().__init__(*args)
        if self._trace_postmortem:
            _otrace.note_failure(self)


class DeadlineExceeded(ServingError, TimeoutError):
    """The request's deadline (queue wait + execution) elapsed."""

    _trace_postmortem = True


class Overloaded(ServingError):
    """Shed at admission: the bounded queue is full."""


class PoolClosed(Overloaded):
    """Shed at admission (or cancelled in flight) because the pool or
    engine is shutting down, or the request was cancelled."""


class RequestFailed(ServingError):
    """The request's execution raised; `cause` is the original exception,
    `attempts` how many executions were tried."""

    _trace_postmortem = True

    def __init__(self, msg, cause=None, attempts=1):
        super().__init__(msg)
        self.cause = cause
        self.attempts = attempts


class AdapterNotLoaded(ValueError):
    """A request named a LoRA adapter the engine's `AdapterPool` does not
    hold (or the engine has no pool). A `ValueError`, so every layer
    treats it as a deterministic request error: no retry, no failover."""


#: deterministic request errors: the request itself is malformed, so no
#: other member or attempt can help — fail fast, no retry, no health
#: penalty for the member that surfaced it
DETERMINISTIC_ERRORS = (ValueError, TypeError)


class Deadline:
    """Absolute monotonic-clock deadline. `seconds=None` never expires."""

    def __init__(self, seconds=None, clock=time.monotonic):
        self._clock = clock
        self._at = None if seconds is None else clock() + float(seconds)

    def remaining(self):
        """Seconds left (may be negative); None if unbounded."""
        return None if self._at is None else self._at - self._clock()

    def expired(self):
        return self._at is not None and self._clock() >= self._at

    def __repr__(self):
        r = self.remaining()
        return f"Deadline(remaining={'inf' if r is None else f'{r:.3f}s'})"


# ---------------------------------------------------------------------------
# circuit breaker and retry policy
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """A slot's breaker: CLOSED -> (K consecutive failures) -> OPEN ->
    (cooldown) -> HALF_OPEN (one probe) -> CLOSED on success, OPEN on
    failure. The counts belong to the slot and survive re-clones, so a
    fault a re-clone does not fix takes the slot out of rotation."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold=3, reset_timeout=1.0, clock=time.monotonic):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.reset_timeout = float(reset_timeout)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = None
        self._probing = False
        self.trips = 0

    @property
    def state(self):
        with self._lock:
            return self._peek_state()

    def _peek_state(self):
        # lock held; OPEN -> HALF_OPEN once the cooldown has passed
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout):
            self._state = self.HALF_OPEN
            self._probing = False
        return self._state

    def allow(self):
        """True if a request may run now. HALF_OPEN hands out one probe
        until it resolves (or comes back through `cancel_probe`)."""
        with self._lock:
            st = self._peek_state()
            if st == self.CLOSED:
                return True
            if st == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def cancel_probe(self):
        """Return an unused HALF_OPEN probe."""
        with self._lock:
            self._probing = False

    def record_success(self):
        with self._lock:
            self._state = self.CLOSED
            self._consecutive = 0
            self._probing = False

    def record_failure(self):
        with self._lock:
            self._consecutive += 1
            st = self._peek_state()
            if st == self.HALF_OPEN or self._consecutive >= self.threshold:
                if self._state != self.OPEN:
                    self.trips += 1
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probing = False


class RetryPolicy:
    """Jittered exponential backoff for transient failures.
    `max_retries` re-executions after the first attempt; `max_elapsed` an
    optional wall-time budget from the first admission (layered retry
    loops compose it additively). `rng` (a `random.Random`) makes the
    jitter reproducible."""

    def __init__(self, max_retries=2, base_delay=0.02, max_delay=0.5,
                 multiplier=2.0, jitter=0.5, max_elapsed=None, rng=None):
        self.max_retries = int(max_retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.max_elapsed = None if max_elapsed is None else float(max_elapsed)
        self._rng = rng or random.Random()

    def delay(self, attempt):
        """Backoff before re-execution number `attempt` (1-based): uniform
        in [d * (1 - jitter), d]."""
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** max(0, attempt - 1))
        return d * (1.0 - self.jitter * self._rng.random())

    def should_retry(self, attempts, elapsed):
        """May a request that ran `attempts` times, `elapsed` seconds in
        flight, run again? The budget counts the un-jittered backoff this
        retry would add."""
        if attempts > self.max_retries:
            return False
        if self.max_elapsed is not None and elapsed is not None:
            next_delay = min(self.max_delay,
                             self.base_delay
                             * self.multiplier ** max(0, attempts - 1))
            if elapsed + next_delay > self.max_elapsed:
                return False
        return True


# ---------------------------------------------------------------------------
# request, members, slots
# ---------------------------------------------------------------------------

_PENDING, _RUNNING, _DONE, _ABANDONED = range(4)


class _Request:
    """One admitted request: a callable over a leased member and a
    single-assignment result with abandon semantics (the caller may give
    up at its deadline while a worker still holds it; one side wins).
    With batching, `feeds` holds the validated inputs that workers stack
    with batchmates (`fn` runs the request alone); `no_batch` marks a
    request split out of a failed batch, which then runs alone. `ctx` is
    the admitting thread's trace context, re-entered by the worker that
    executes the request; `fail()` / `abandon()` pin its postmortem when
    the error asks for one."""

    __slots__ = ("id", "fn", "deadline", "attempts", "on_timeout",
                 "feeds", "no_batch", "enqueued_at", "ctx", "_lock", "_ev",
                 "_state", "_value", "_error")

    def __init__(self, rid, fn, deadline, on_timeout=None, feeds=None):
        self.id = rid
        self.fn = fn
        self.deadline = deadline
        self.attempts = 0
        self.on_timeout = on_timeout  # pool stats hook (counted once)
        self.feeds = feeds            # batchable inputs (None: fn only)
        self.no_batch = False         # split out of a failed batch
        self.enqueued_at = None       # admission stamp (queue wait)
        self.ctx = None               # admitting trace context (or None)
        self._lock = threading.Lock()
        self._ev = threading.Event()
        self._state = _PENDING
        self._value = None
        self._error = None

    # each transition returns whether the caller won it
    def mark_running(self):
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _RUNNING
            return True

    def mark_pending(self):
        """Back to the queue (the retry path)."""
        with self._lock:
            if self._state != _RUNNING:
                return False
            self._state = _PENDING
            return True

    def complete(self, value):
        with self._lock:
            if self._state in (_DONE, _ABANDONED):
                return False
            self._state = _DONE
            self._value = value
            self._ev.set()
            return True

    def fail(self, error):
        with self._lock:
            if self._state in (_DONE, _ABANDONED):
                return False
            self._state = _DONE
            self._error = error
            self._ev.set()
        _otrace.pin_failure(self.ctx, error)
        return True

    def abandon(self, error):
        """Caller-side deadline: a late worker result is discarded."""
        with self._lock:
            if self._state in (_DONE, _ABANDONED):
                return False
            self._state = _ABANDONED
            self._error = error
            self._ev.set()
        _otrace.pin_failure(self.ctx, error)
        return True

    def done(self):
        return self._ev.is_set()

    def result(self, timeout=None):
        """Block until the request resolves, its deadline passes or
        `timeout` elapses. The deadline is enforced here as well, so this
        returns (`DeadlineExceeded`) even when the member is wedged."""
        limit = self.deadline.remaining()
        if timeout is not None and (limit is None or timeout < limit):
            limit = timeout
        if not self._ev.wait(limit):
            if self.deadline.expired():
                err = DeadlineExceeded(
                    f"request {self.id} exceeded its deadline (member "
                    f"wedged or pool saturated)")
                if self.abandon(err) and self.on_timeout is not None:
                    self.on_timeout(self)
                raise err
            raise TimeoutError(
                f"request {self.id} not resolved within {timeout}s "
                f"(deadline not yet reached — call result() again)")
        with self._lock:
            if self._error is not None:
                raise self._error
            return self._value


class _BatchTicket:
    """A formed batch in flight on one member, the slot's `current`: the
    earliest deadline in it governs hang detection, and a wedge fails
    every request in it."""

    __slots__ = ("requests", "deadline")

    def __init__(self, requests):
        self.requests = requests
        bounded = [r.deadline for r in requests
                   if r.deadline.remaining() is not None]
        self.deadline = (min(bounded, key=lambda d: d.remaining())
                         if bounded else requests[0].deadline)


def _in_flight(cur):
    """The requests of a slot's `current` (none, one, or a batch)."""
    if cur is None:
        return []
    return cur.requests if isinstance(cur, _BatchTicket) else [cur]


class _NullPredictor:
    """Stateless member of pools that supervise work which serves no
    exported program: the decode engine's step executor and a
    generation-only `ServingPool(decode_engine=...)`. Submitted callables
    receive it and ignore it."""

    def clone(self):
        return _NullPredictor()

    def reset_handles(self):
        pass


class _MemberSlot:
    """One unit of capacity: a member driven by a worker thread, and the
    slot's health record (breaker and counters belong to the slot index
    and carry over when the member or the whole slot is replaced)."""

    __slots__ = ("index", "predictor", "breaker", "generation", "retired",
                 "thread", "current", "failures", "reclones", "completed")

    def __init__(self, index, predictor, breaker, generation=0):
        self.index = index
        self.predictor = predictor
        self.breaker = breaker
        self.generation = generation
        self.retired = False
        self.thread = None
        self.current = None          # in-flight _Request, worker-owned
        self.failures = 0
        self.reclones = 0
        self.completed = 0


#: distinct registry collector names, one per pool
_POOL_SEQ = itertools.count()


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

class ServingPool:
    """Supervised member pool: bounded admission, deadlines, circuit
    breaking, retries, graceful drain (see the module docstring).

        pool = ServingPool(predictor=member, size=4, max_queue_depth=64,
                           default_timeout=0.5)
        outs = pool.infer([batch])          # or pool.submit(fn).result()
        pool.shutdown(drain_timeout=5.0)

    `submit(fn, timeout=...)` runs ``fn(member)`` on a leased member's
    worker thread. ``config=`` serves an exported program
    (``ServingPool(Config(path), size=2, batching=BatchConfig(...))``).
    With ``decode_engine=`` the pool also serves `submit_generate` /
    `generate` on that engine."""

    def __init__(self, config=None, size=1, *, predictor=None,
                 max_queue_depth=64, default_timeout=None,
                 breaker_threshold=3, breaker_reset_timeout=1.0,
                 retry=None, hang_grace=0.1, supervise_interval=0.02,
                 fault_hook=None, batching=None, decode_engine=None,
                 metrics=None, name=None, clock=time.monotonic):
        if size < 1:
            raise ValueError("pool size must be >= 1")
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        self._engine = decode_engine
        if predictor is None:
            if config is not None:
                from . import Predictor

                predictor = Predictor(config)
            elif decode_engine is not None:
                predictor = _NullPredictor()
            else:
                raise ValueError(
                    "ServingPool needs a Config or predictor= (or "
                    "decode_engine= for a generation-only pool)")
        self._base = predictor
        self._batcher = None
        if batching is not None and batching is not False:
            from .batching import BatchConfig, DynamicBatcher

            if isinstance(batching, DynamicBatcher):
                self._batcher = batching
            else:
                cfg = BatchConfig() if batching is True else batching
                layer = getattr(predictor, "_layer", predictor)
                self._batcher = DynamicBatcher(layer, cfg, clock=clock)
        self.max_queue_depth = int(max_queue_depth)
        self.default_timeout = default_timeout
        self.hang_grace = float(hang_grace)
        self._supervise_interval = float(supervise_interval)
        self._clock = clock
        self._retry = retry if retry is not None else RetryPolicy()
        self._fault_hook = fault_hook

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._retry_timers = {}            # _Request -> threading.Timer
        self._ids = itertools.count()
        self._closed = False               # admissions stopped
        self._stopping = False             # workers must exit
        self._shutdown_called = False
        self._drained = False

        # counters (all under self._lock)
        self._admitted = self._completed = self._failed = 0
        self._timed_out = self._cancelled = self._shed = 0
        self._retried = self._wedged = self._late_results = 0
        self._rebases = self._queue_peak = 0

        self.name = str(name) if name else f"pool{next(_POOL_SEQ)}"
        self._metrics_server = None
        if metrics is False:
            self._metrics = None
            self._h_latency = self._h_queue_wait = self._h_execute = None
        else:
            from ..obs.metrics import registry as _obs_registry

            reg = metrics if metrics is not None else _obs_registry()
            self._metrics = reg
            self._h_latency = reg.histogram(
                "serving.request_seconds",
                help="end-to-end request latency, admission -> "
                     "completion (successful requests)")
            self._h_queue_wait = reg.histogram(
                "serving.queue_wait_seconds",
                help="admission-queue wait before execution starts")
            self._h_execute = reg.histogram(
                "serving.execute_seconds",
                help="member execution time (one dispatch: a single "
                     "request or a whole formed batch)")
            if self._batcher is not None:
                self._batcher.h_queue_wait = self._h_queue_wait
                self._batcher.h_execute = self._h_execute

        self._slots = []
        for i in range(size):
            member = predictor if i == 0 else predictor.clone()
            slot = _MemberSlot(i, member, CircuitBreaker(
                breaker_threshold, breaker_reset_timeout, clock=clock))
            self._slots.append(slot)
            self._start_worker(slot)

        # the supervisor's next sweep on the pool clock (-inf while it is
        # awake), under _lock; see _supervise_loop
        self._sup_cv = threading.Condition(self._lock)
        self._sup_due = -math.inf
        self._sup_stopped = False
        self._sup_wakes = 0
        self._supervisor = threading.Thread(
            target=self._supervise_loop, name="ServingPool-supervisor",
            daemon=True)
        self._supervisor.start()
        if self._metrics is not None:
            # last: a scrape only ever sees a fully built pool
            self._metrics.register_collector(f"serving.pool.{self.name}",
                                             self.stats)

    # -- admission ---------------------------------------------------------
    def submit(self, fn, timeout=None):
        """Admit ``fn(member) -> result`` with a deadline of `timeout`
        seconds (None -> `default_timeout`; both None -> none) over queue
        wait and execution. Returns a future-like request (`.result()`).
        Raises `Overloaded` / `PoolClosed` / `DeadlineExceeded` when
        shedding."""
        return self._admit(fn, timeout)

    def _admit(self, fn, timeout, feeds=None):
        eff = self.default_timeout if timeout is None else timeout
        dl = Deadline(eff, clock=self._clock)
        with self._cv:
            if self._closed:
                self._shed += 1
                raise PoolClosed("pool is shut down — admission refused")
            if dl.expired():
                self._shed += 1
                raise DeadlineExceeded(
                    "dead on arrival: deadline expired before admission")
            if len(self._queue) + len(self._retry_timers) \
                    >= self.max_queue_depth:
                self._shed += 1
                raise Overloaded(
                    f"admission queue full ({self.max_queue_depth} deep) — "
                    f"request shed; retry with backoff or scale the pool")
            req = _Request(next(self._ids), fn, dl,
                           on_timeout=self._on_caller_timeout, feeds=feeds)
            req.enqueued_at = self._clock()
            if _otrace.enabled():
                req.ctx = _otrace.current()
            self._queue.append(req)
            self._admitted += 1
            depth = len(self._queue) + len(self._retry_timers)
            self._queue_peak = max(self._queue_peak, depth)
            self._cv.notify()
            self._watch(dl)
        if req.ctx is not None:
            # the admission stamp: the queue depth the request met
            _otrace.event("serving.admit",
                          attrs={"pool": self.name, "request": req.id,
                                 "queue_depth": depth})
        return req

    def infer(self, feeds, timeout=None):
        """Run ``member.run(feeds)`` on some healthy member; returns its
        outputs or raises the typed serving error. With batching,
        concurrent calls are coalesced into bucket programs, and the feeds
        are validated against the exported input_spec here (a malformed
        request raises ValueError before it is queued)."""
        if self._batcher is not None:
            feeds = self._batcher.validate(feeds)
        else:
            feeds = [f if hasattr(f, "shape") else np.asarray(f)
                     for f in feeds]
        return self._admit(lambda pred: pred.run(feeds), timeout,
                           feeds=feeds if self._batcher is not None
                           else None).result()

    def warmup(self, buckets=None):
        """Build every batch bucket's program before traffic (they live on
        the shared exported layer, so every clone and re-clone uses them).
        Returns the warmed buckets. Requires batching."""
        if self._batcher is None:
            raise RuntimeError(
                "warmup() needs batching: construct the pool with "
                "batching=BatchConfig(...)")
        return self._batcher.warmup(buckets)

    def rebase(self, predictor):
        """Swap the pool's base member for `predictor` (new weights, same
        program): every slot gets a fresh clone of the new base before it
        serves again, and later quarantine / wedge replacements clone it
        too. Executions in flight finish on the member they started with
        (`ServingRouter.swap_weights` drains first). A clone failure
        raises, so the caller can fail the swap."""
        with self._lock:
            if self._stopping:
                raise PoolClosed("cannot rebase a shut-down pool")
            self._base = predictor
            self._rebases += 1
        if self._batcher is not None and hasattr(predictor, "_layer"):
            # batched requests run the new base's layer (and its bucket
            # programs, built on first use or by warmup())
            self._batcher.layer = predictor._layer
        for slot in list(self._slots):
            try:
                fresh = predictor.clone()
            except Exception as e:
                raise RuntimeError(
                    f"rebase: could not clone the new base for slot "
                    f"{slot.index} — aborting the swap ({e})") from e
            with self._lock:
                slot.predictor = fresh
                slot.reclones += 1
                slot.generation += 1

    def swap_engine(self, engine, drain_timeout=5.0):
        """Install decode engine `engine` and shut the previous one down
        (the streaming counterpart of `rebase`; the caller drains the
        old engine's streams first)."""
        with self._lock:
            if self._stopping:
                raise PoolClosed("cannot swap the engine of a shut-down "
                                 "pool")
            old, self._engine = self._engine, engine
        if old is not None:
            old.shutdown(drain_timeout=drain_timeout)

    # -- streaming generation ----------------------------------------------
    def submit_generate(self, prompt_ids, max_new_tokens, timeout=None, *,
                        resume_committed=None, sampling=None, adapter=None):
        """Admit one generation on the attached `DecodeEngine`; returns
        its `SequenceStream`. `timeout=None` takes the pool's
        `default_timeout`; the engine's admission errors are the pool's.
        `resume_committed` is the mid-stream failover path, `sampling` a
        `SamplingParams` (or its dict form), `adapter` a LoRA adapter of
        the engine's pool (see `DecodeEngine.submit`)."""
        engine = self._engine
        if engine is None:
            raise RuntimeError(
                "submit_generate() needs a decode engine: construct the "
                "pool with decode_engine=DecodeEngine(model, ...)")
        eff = self.default_timeout if timeout is None else timeout
        return engine.submit(prompt_ids, max_new_tokens, timeout=eff,
                             resume_committed=resume_committed,
                             sampling=sampling, adapter=adapter)

    def generate(self, prompt_ids, max_new_tokens, timeout=None, *,
                 sampling=None, adapter=None):
        """Submit and drain; returns the generated token list."""
        return self.submit_generate(prompt_ids, max_new_tokens,
                                    timeout=timeout, sampling=sampling,
                                    adapter=adapter).result()

    def _on_caller_timeout(self, req):
        with self._lock:
            self._timed_out += 1

    # -- worker ------------------------------------------------------------
    def _start_worker(self, slot):
        t = threading.Thread(
            target=self._worker_loop, args=(slot,),
            name=f"ServingPool-worker-{slot.index}-g{slot.generation}",
            daemon=True)
        slot.thread = t
        t.start()

    def _next_request(self, slot):
        """The next live request for `slot`'s worker (None when there is
        none yet), or with batching a list: a batchable request and the
        batchmates gathered for it; "exit" once the pool is drained."""
        with self._cv:
            if not self._queue:
                if self._closed and not self._retry_timers \
                        and all(s.current is None for s in self._slots):
                    return "exit"
                self._cv.wait(0.02)
            while self._queue:
                cand = self._queue.popleft()
                if cand.done():
                    continue        # abandoned or failed while queued
                if cand.deadline.expired():
                    if cand.fail(DeadlineExceeded(
                            f"request {cand.id} expired after queue wait, "
                            f"before execution")):
                        self._timed_out += 1
                    continue
                if self._batcher is not None and cand.feeds is not None \
                        and not cand.no_batch:
                    return self._gather_batchmates(cand)
                return cand
        return None

    def _worker_loop(self, slot):
        br = slot.breaker
        while True:
            if slot.retired or self._stopping:
                return
            if not br.allow():
                # out of rotation (breaker open): wait out the cooldown
                time.sleep(min(0.01, self._supervise_interval))
                continue
            req = self._next_request(slot)
            if req == "exit":
                br.cancel_probe()
                return
            if isinstance(req, list):
                self._run_batch(slot, req)
                continue
            if req is None or not req.mark_running():
                br.cancel_probe()
                continue
            slot.current = req
            with self._lock:
                self._watch(req.deadline, self.hang_grace)
            req.attempts += 1
            t0 = self._clock()
            if self._h_queue_wait is not None and req.attempts == 1:
                self._h_queue_wait.observe(t0 - req.enqueued_at, ctx=req.ctx)
            try:
                if self._fault_hook is not None:
                    self._fault_hook(slot.index, req, slot.predictor)
                # the admitting thread's context: each execution attempt
                # is one span (retries are sibling attempts)
                with _otrace.span_in(
                        "serving.execute", req.ctx,
                        attrs=None if req.ctx is None else
                        {"pool": self.name, "slot": slot.index,
                         "attempt": req.attempts}):
                    result = req.fn(slot.predictor)
            except Exception as exc:  # noqa: BLE001 — classified below
                self._on_execution_error(slot, req, exc)
            else:
                done = self._clock()
                if self._h_execute is not None:
                    self._h_execute.observe(done - t0)
                self._reset_member(slot)
                if not slot.retired:
                    # a retired (wedged) worker's late success must not
                    # clear the wedge failures from the shared breaker
                    br.record_success()
                with self._lock:
                    if req.complete(result):
                        self._completed += 1
                        slot.completed += 1
                        if self._h_latency is not None:
                            self._h_latency.observe(done - req.enqueued_at,
                                                    ctx=req.ctx)
                    else:
                        self._late_results += 1
            finally:
                slot.current = None

    # -- batched dispatch --------------------------------------------------
    def _gather_batchmates(self, first):
        """_cv held. Deadline-aware batch formation: collect batchable
        queued requests up to the largest bucket, waiting at most
        `max_wait_ms` for latecomers; flush early when the bucket fills,
        the earliest deadline in the batch comes within
        `deadline_margin_ms`, or the pool drains. Collected requests leave
        the queue; the others keep their order."""
        bt = self._batcher
        cfg = bt.config
        batch = [first]
        target = bt.max_bucket
        start = self._clock()
        wait_s = cfg.max_wait_ms / 1e3
        margin_s = cfg.deadline_margin_ms / 1e3
        while True:
            if len(batch) < target and self._queue:
                rest = collections.deque()
                for c in self._queue:
                    if c.done():
                        continue
                    if (len(batch) < target and c.feeds is not None
                            and not c.no_batch):
                        if c.deadline.expired():
                            if c.fail(DeadlineExceeded(
                                    f"request {c.id} expired after queue "
                                    f"wait, before execution")):
                                self._timed_out += 1
                            continue
                        batch.append(c)
                    else:
                        rest.append(c)
                self._queue = rest
            if len(batch) >= target:
                bt.note_flush("full")
                return batch
            if self._closed or self._stopping:
                bt.note_flush("drain")
                return batch
            budget = wait_s - (self._clock() - start)
            rem = None
            for r in batch:
                rr = r.deadline.remaining()
                if rr is not None and (rem is None or rr < rem):
                    rem = rr
            if rem is not None and rem - margin_s < budget:
                if rem - margin_s <= 0:
                    bt.note_flush("deadline")
                    return batch
                budget = rem - margin_s
            if budget <= 0:
                bt.note_flush("wait")
                return batch
            # short slices: a notify may wake another idle worker, so the
            # gatherer looks at the queue again soon
            self._cv.wait(min(budget, 0.0025))

    def _run_batch(self, slot, batch):
        """Execute a formed batch on this member: one bucket program for
        the whole group, each request's rows scattered back."""
        br = slot.breaker
        live = [r for r in batch if r.mark_running()]
        if not live:
            br.cancel_probe()
            return
        ticket = _BatchTicket(live)
        slot.current = ticket
        with self._lock:
            self._watch(ticket.deadline, self.hang_grace)
        for r in live:
            r.attempts += 1
        try:
            if self._fault_hook is not None:
                for r in live:
                    self._fault_hook(slot.index, r, slot.predictor)
            results = self._batcher.execute(live)
        except Exception as exc:  # noqa: BLE001 — classified below
            self._on_batch_error(slot, live, exc)
        else:
            done = self._clock()
            self._reset_member(slot)
            if not slot.retired:
                br.record_success()
            with self._lock:
                for r, res in zip(live, results):
                    if r.complete(res):
                        self._completed += 1
                        slot.completed += 1
                        if self._h_latency is not None:
                            self._h_latency.observe(done - r.enqueued_at,
                                                    ctx=r.ctx)
                    else:
                        self._late_results += 1
        finally:
            slot.current = None

    def _on_batch_error(self, slot, batch, exc):
        """A batch raised. The fault cannot be pinned on one request, so a
        multi-request batch is retried as split singles (`no_batch`): the
        innocent complete, a poison request fails alone with its own
        typed error."""
        if len(batch) == 1:
            self._on_execution_error(slot, batch[0], exc)
            return
        self._reset_member(slot)
        if slot.retired:
            # a wedged worker's late failure: the supervisor already failed
            # the batch and charged the breaker
            with self._lock:
                for r in batch:
                    if r.fail(RequestFailed(
                            f"request {r.id} failed on a retired member: "
                            f"{type(exc).__name__}: {exc}",
                            cause=exc, attempts=r.attempts)):
                        self._failed += 1
                    else:
                        self._late_results += 1
            return
        if isinstance(exc, DETERMINISTIC_ERRORS):
            # a malformed batchmate; the member ran fine
            slot.breaker.record_success()
        else:
            with self._lock:
                slot.failures += 1
            slot.breaker.record_failure()
            self._quarantine(slot)
        self._batcher.note_split(len(batch))
        with self._cv:
            requeued = []
            for r in batch:
                if r.done():
                    continue
                if self._stopping:
                    if r.fail(PoolClosed(
                            "pool shut down before the split retry ran")):
                        self._cancelled += 1
                    continue
                if r.deadline.expired():
                    if r.fail(DeadlineExceeded(
                            f"request {r.id} expired before its split "
                            f"retry could run")):
                        self._timed_out += 1
                    continue
                if r.mark_pending():
                    r.no_batch = True
                    requeued.append(r)
            for r in reversed(requeued):
                self._queue.appendleft(r)  # splits resume at the front
            if requeued:
                self._cv.notify_all()
                for r in requeued:
                    self._watch(r.deadline)

    def _reset_member(self, slot):
        try:
            slot.predictor.reset_handles()
        except Exception:  # noqa: BLE001 — a member too broken to reset
            pass           # is replaced at its next fault

    def _on_execution_error(self, slot, req, exc):
        self._reset_member(slot)
        if slot.retired:
            # late failure of a wedged worker: the supervisor already
            # failed the request and charged the breaker
            with self._lock:
                if req.fail(RequestFailed(
                        f"request {req.id} failed on a retired member: "
                        f"{type(exc).__name__}: {exc}",
                        cause=exc, attempts=req.attempts)):
                    self._failed += 1
                else:
                    self._late_results += 1
            return
        if isinstance(exc, DETERMINISTIC_ERRORS):
            # the request is malformed, the member ran fine
            slot.breaker.record_success()
            err = RequestFailed(
                f"request {req.id} failed deterministically "
                f"({type(exc).__name__}) — not retried: {exc}",
                cause=exc, attempts=req.attempts)
            err.__cause__ = exc
            with self._lock:
                if req.fail(err):
                    self._failed += 1
                else:
                    self._late_results += 1
            return
        # a transient member fault: quarantine, breaker, maybe a retry
        with self._lock:
            slot.failures += 1
        slot.breaker.record_failure()
        self._quarantine(slot)
        delay = self._retry.delay(req.attempts)
        rem = req.deadline.remaining()
        elapsed = self._clock() - req.enqueued_at
        if self._retry.should_retry(req.attempts, elapsed) \
                and (rem is None or rem > delay) and req.mark_pending():
            with self._lock:
                self._retried += 1
            self._schedule_requeue(req, delay)
            return
        err = RequestFailed(
            f"request {req.id} failed after {req.attempts} attempt(s): "
            f"{type(exc).__name__}: {exc}", cause=exc, attempts=req.attempts)
        err.__cause__ = exc
        with self._lock:
            if req.fail(err):
                self._failed += 1
            else:
                self._late_results += 1

    def _quarantine(self, slot):
        """Replace the slot's member with a fresh clone of the base (the
        breaker and counters stay); a failed clone keeps the reset one."""
        try:
            fresh = self._base.clone()
        except Exception:  # noqa: BLE001 — keep the slot
            return
        with self._lock:
            slot.predictor = fresh
            slot.reclones += 1
            slot.generation += 1

    def _schedule_requeue(self, req, delay):
        with self._lock:
            if self._stopping:
                if req.fail(PoolClosed(
                        "pool shut down before the retry could run")):
                    self._cancelled += 1
                return
            t = threading.Timer(delay, self._requeue, args=(req,))
            t.daemon = True
            self._retry_timers[req] = t
            depth = len(self._queue) + len(self._retry_timers)
            self._queue_peak = max(self._queue_peak, depth)
            t.start()

    def _requeue(self, req):
        with self._cv:
            self._retry_timers.pop(req, None)
            if req.done():
                return
            if self._stopping:
                if req.fail(PoolClosed(
                        "pool shut down before the retry could run")):
                    self._cancelled += 1
                return
            if req.deadline.expired():
                if req.fail(DeadlineExceeded(
                        f"request {req.id} expired during retry backoff")):
                    self._timed_out += 1
                return
            self._queue.appendleft(req)  # retries resume at the front
            self._cv.notify()
            self._watch(req.deadline)

    # -- supervision -------------------------------------------------------
    def _supervise_loop(self):
        polled = self._clock is not time.monotonic
        while True:
            with self._lock:
                if self._sup_stopped:
                    return
                if polled:
                    # a caller's clock says nothing of real time: sweep
                    # at the interval
                    self._sup_cv.wait(self._supervise_interval)
                    self._sup_wakes += 1
                else:
                    now = self._clock()
                    due = self._next_sweep(now)
                    if due > now:
                        self._sup_due = due
                        self._sup_cv.wait(
                            None if due == math.inf else due - now)
                        self._sup_due = -math.inf
                        self._sup_wakes += 1
                        continue
                if self._sup_stopped:
                    return
            try:
                self._sweep_expired_queue()
                self._sweep_wedged()
            except Exception:  # noqa: BLE001 — the supervisor never dies;
                # the sweeps run again after the interval
                time.sleep(self._supervise_interval)

    def _next_sweep(self, now):
        """Under _lock: when the sweeps next have work on the pool clock —
        the earliest queued deadline, in-flight deadline plus `hang_grace`
        or (a retired slot awaiting its replacement) `supervise_interval`
        from `now`; inf when nothing is watched."""
        if self._stopping:
            return math.inf
        due = math.inf
        for req in self._queue:
            rem = req.deadline.remaining()
            if rem is not None:
                due = min(due, now + rem)
        for slot in self._slots:
            if slot.retired:
                due = min(due, now + self._supervise_interval)
                continue
            cur = slot.current
            rem = None if cur is None else cur.deadline.remaining()
            if rem is not None:
                due = min(due, now + rem + self.hang_grace)
        return due

    def _watch(self, deadline, grace=0.0):
        """Under _lock: wake the supervisor when `deadline` (plus `grace`)
        falls before its next sweep."""
        rem = deadline.remaining()
        if rem is not None and self._clock() + rem + grace < self._sup_due:
            self._sup_cv.notify()

    def _sweep_expired_queue(self):
        """Fail queued requests whose deadline passed before a worker got
        to them."""
        with self._cv:
            if not self._queue:
                return
            live = collections.deque()
            for req in self._queue:
                if req.done():
                    continue
                if req.deadline.expired():
                    if req.fail(DeadlineExceeded(
                            f"request {req.id} expired in queue")):
                        self._timed_out += 1
                    continue
                live.append(req)
            self._queue = live

    def _sweep_wedged(self):
        """Members stuck past an in-flight request's deadline by more than
        `hang_grace`: fail the request, retire the worker (its thread is
        abandoned and exits when the hang ends) and restore capacity with
        a fresh clone on a new worker."""
        if self._stopping:
            return
        for i, slot in enumerate(list(self._slots)):
            if slot.retired:
                # an earlier replacement failed (clone raised): retry
                self._replace_slot(i, slot)
                continue
            cur = slot.current
            if cur is None:
                continue
            rem = cur.deadline.remaining()
            if rem is None or rem > -self.hang_grace:
                continue
            slot.retired = True
            slot.breaker.record_failure()
            # a wedged batch fails whole: its compute is abandoned with
            # the retired worker
            with self._lock:
                self._wedged += 1
                for req in _in_flight(cur):
                    if req.fail(DeadlineExceeded(
                            f"request {req.id} wedged its member past the "
                            f"deadline; member {i} replaced")):
                        self._timed_out += 1
            self._replace_slot(i, slot)

    def _replace_slot(self, i, old):
        """Install a fresh clone and worker at slot `i` in place of the
        retired `old`; a failed clone leaves `old` for the next sweep."""
        if self._slots[i] is not old:
            return
        try:
            fresh = self._base.clone()
        except Exception:  # noqa: BLE001 — retried every sweep
            return
        new_slot = _MemberSlot(i, fresh, old.breaker,
                               generation=old.generation + 1)
        new_slot.failures = old.failures + 1
        new_slot.reclones = old.reclones + 1
        new_slot.completed = old.completed
        self._slots[i] = new_slot
        self._start_worker(new_slot)

    # -- drain / shutdown --------------------------------------------------
    def shutdown(self, drain_timeout=30.0):
        """Stop admissions at once, let in-flight and queued requests (and
        their scheduled retries) finish for up to `drain_timeout` seconds,
        then fail the rest with `PoolClosed` and stop the workers. An
        attached decode engine drains first, inside the same budget.
        Returns True on a full drain. Idempotent."""
        if self._engine is not None:
            t0 = self._clock()
            self._engine.shutdown(drain_timeout=drain_timeout)
            if drain_timeout is not None:
                drain_timeout = max(0.0, drain_timeout
                                    - (self._clock() - t0))
        with self._cv:
            if self._shutdown_called:
                return self._drained
            self._shutdown_called = True
            self._closed = True
            self._cv.notify_all()
        drained = self._wait_idle(Deadline(drain_timeout, clock=self._clock))
        with self._cv:
            for req, timer in list(self._retry_timers.items()):
                timer.cancel()
                if not req.done() and req.fail(PoolClosed(
                        "pool shut down before the retry could run")):
                    self._cancelled += 1
            self._retry_timers.clear()
            while self._queue:
                req = self._queue.popleft()
                if not req.done() and req.fail(PoolClosed(
                        "pool shut down before the request ran")):
                    self._cancelled += 1
            self._stopping = True
            self._cv.notify_all()
        for slot in self._slots:
            for req in _in_flight(slot.current):
                if not req.done() and req.fail(PoolClosed(
                        "pool shut down before the request completed")):
                    with self._lock:
                        self._cancelled += 1
        with self._lock:
            self._sup_stopped = True
            self._sup_cv.notify()
        self._supervisor.join(timeout=1.0)
        for slot in self._slots:
            if slot.thread is not None:
                slot.thread.join(timeout=0.5)
        if self._metrics is not None:
            self._metrics.unregister_collector(f"serving.pool.{self.name}",
                                               self.stats)
        server, self._metrics_server = self._metrics_server, None
        if server is not None:
            server.stop()
        self._drained = drained
        return drained

    def _wait_idle(self, dl):
        while True:
            with self._cv:
                idle = (not self._queue and not self._retry_timers
                        and all(s.current is None for s in self._slots))
            if idle:
                return True
            if dl.expired():
                return False
            time.sleep(min(0.005, self._supervise_interval))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- observability -----------------------------------------------------
    def serve_metrics(self, port=0, host="127.0.0.1"):
        """Start (or return) the background HTTP exporter over this pool's
        registry: ``/metrics``, ``/metrics.json`` and ``/healthz`` (200
        while a member is healthy and admissions are open, else 503).
        `shutdown()` stops it."""
        if self._metrics is None:
            raise RuntimeError("pool was built with metrics=False — no "
                               "registry to serve")
        from ..obs.http import MetricsServer

        def _healthz():
            s = self.stats()
            ok = s["healthy"] > 0 and not s["closed"]
            return ok, {"pool": self.name, "healthy": s["healthy"],
                        "size": s["size"], "closed": s["closed"]}

        with self._lock:
            if self._closed:
                raise PoolClosed("cannot serve metrics from a shut-down "
                                 "pool")
            if self._metrics_server is None:
                self._metrics_server = MetricsServer(
                    self._metrics, host=host, port=port,
                    healthz=_healthz).start()
            return self._metrics_server

    def load(self):
        """Routing signal: queued + retry-pending + in-flight requests,
        plus the live sequences of the attached decode engine (the JAX
        pool counts requests only, so its router sends every stream
        without a prefix-affinity hit to the first ready replica)."""
        with self._lock:
            in_flight = sum(len(_in_flight(s.current)) for s in self._slots)
            n = len(self._queue) + len(self._retry_timers) + in_flight
            engine = self._engine
        return n + (engine.load() if hasattr(engine, "load") else 0)

    def stats(self):
        """Counter snapshot. Quiesced: ``admitted == completed + failed +
        timed_out + cancelled``; at any instant the right side also holds
        ``queue_depth + in_flight``."""
        with self._lock:
            members = []
            for slot in self._slots:
                alive = (not slot.retired and slot.thread is not None
                         and slot.thread.is_alive())
                members.append({
                    "index": slot.index, "generation": slot.generation,
                    "alive": alive, "breaker": slot.breaker.state,
                    "failures": slot.failures, "reclones": slot.reclones,
                    "completed": slot.completed,
                    "in_flight": len(_in_flight(slot.current))})
            snap = {
                "name": self.name,
                "size": len(self._slots),
                "healthy": sum(1 for m in members
                               if m["alive"] and m["breaker"] == "closed"),
                "closed": self._closed,
                "admitted": self._admitted,
                "completed": self._completed,
                "failed": self._failed,
                "timed_out": self._timed_out,
                "cancelled": self._cancelled,
                "shed": self._shed,
                "retried": self._retried,
                "wedged": self._wedged,
                "late_results": self._late_results,
                "reclones": sum(m["reclones"] for m in members),
                "rebases": self._rebases,
                "breaker_trips": sum(s.breaker.trips for s in self._slots),
                "queue_depth": len(self._queue) + len(self._retry_timers),
                "queue_depth_peak": self._queue_peak,
                "in_flight": sum(m["in_flight"] for m in members),
                "members": members,
            }
        # the batcher's and the engine's snapshots take their own locks:
        # outside ours
        snap["batch"] = (self._batcher.stats()
                         if self._batcher is not None else None)
        engine = self._engine
        snap["decode"] = engine.stats() if engine is not None else None
        return snap

    def __len__(self):
        return len(self._slots)
