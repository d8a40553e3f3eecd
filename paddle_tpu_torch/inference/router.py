"""The serving tier's frontend (counterpart of
paddle_tpu/inference/router.py). `ServingPool` makes one process
resilient; `ServingRouter` makes the service resilient by fronting N
replicas (`replica.LocalReplica`, each a supervised pool behind the
handle contract):

* **Health-checked routing**: every replica heartbeats; the router runs
  the `distributed.store.Watchdog` policy loop over the beats and routes
  only to replicas that are ready, with a fresh beat and a closed
  breaker, least-loaded first.
* **Typed, contained failure**: a dead or wedged replica's request fails
  over to a healthy one when ``idempotent=True`` (the default) under the
  `RetryPolicy` of `RouterConfig.failover`; a non-idempotent request
  whose execution state is unknown surfaces `RequestFailed` instead.
  Deterministic request errors never fail over.
* **Supervised restart** with jittered backoff, a capacity floor
  (`min_healthy`: below it admissions shed `Overloaded`), and autoscale
  by queue depth or by SLO (windowed p99 latency and TTFT through
  `obs.slo.evaluate`).
* **Weight hot-swap**: `swap_weights(dir)` accepts only a committed
  directory (the checkpoint protocol's `_COMMITTED` sentinel) with a
  newer generation stamp, then rolls replica by replica: out of rotation
  -> drain -> `rebase` / `swap_engine` -> probe -> readmit. A failed roll
  rolls the swapped replicas back, so the tier converges on one
  generation; every response is stamped with the generation it ran
  under (`infer_stamped`).
* **Streaming** (`submit_generate`): prefix-affinity placement (the
  replica whose engine holds the prompt's prefix blocks), and mid-stream
  failover by re-submitting ``prompt + committed`` on a healthy replica
  (`DecodeEngine.submit(resume_committed=...)`): the client sees one
  sequence with no duplicate and no gap, and a stream never mixes two
  weight generations.

Stats laws (quiesced): ``admitted == completed + failed + timed_out +
overloaded + cancelled`` for requests, and for the streams ledger
``admitted == completed + failed + timed_out + cancelled + in_flight``.
The router touches no device: the replicas' engines do the device work.
"""
from __future__ import annotations

import hashlib
import itertools
import queue
import threading
import time
from collections import OrderedDict

import numpy as np

from ..obs import flight as _oflight
from ..obs import trace as _otrace
from .replica import LocalHeartbeats, ReplicaDead, ReplicaError
from .serving import (DETERMINISTIC_ERRORS, CircuitBreaker, Deadline,
                      DeadlineExceeded, Overloaded, PoolClosed,
                      RequestFailed, RetryPolicy, ServingError)

__all__ = ["SwapFailed", "RouterConfig", "RouterStream", "ServingRouter",
           "commit_model_dir"]


class SwapFailed(ServingError):
    """A weight hot-swap could not complete; the tier was rolled back to
    (or converges on) the previous committed generation."""

    _trace_postmortem = True  # a failed deploy retains its roll's trace


def commit_model_dir(path, generation):
    """Commit-stamp a directory of serving artifacts with the checkpoint
    protocol's `_COMMITTED` sentinel and a monotonic `generation`, so
    `ServingRouter.swap_weights` accepts it (the same sentinel the JAX
    package writes: either package accepts the other's). Write the
    artifacts first; the sentinel lands last."""
    from ..distributed.checkpoint.api import write_commit_sentinel

    write_commit_sentinel(path, generation=int(generation))
    return path


#: distinct registry collector names, one per router
_ROUTER_SEQ = itertools.count()


class RouterConfig:
    """Knobs of `ServingRouter`, with production-shaped defaults; tests
    shrink the time constants."""

    def __init__(self, *, default_timeout=None, attempt_timeout=None,
                 failover=None, min_healthy=1, no_capacity_wait=1.0,
                 heartbeat_ttl=2.0, supervise_interval=0.05,
                 start_grace=10.0, restart_backoff=None, probe_feeds=None,
                 probe_timeout=5.0, breaker_threshold=3,
                 breaker_reset_timeout=1.0, autoscale=False,
                 min_replicas=1, max_replicas=8, scale_up_depth=4.0,
                 scale_down_depth=0.5, autoscale_patience=3,
                 autoscale_slo=None, slo_scale_down_ratio=0.5,
                 slo_min_samples=8, affinity_block_tokens=16,
                 affinity_max_entries=512):
        self.default_timeout = default_timeout
        #: the cap of one dispatch (below the request deadline), so a
        #: wedged replica costs one attempt, not the whole deadline
        self.attempt_timeout = attempt_timeout
        self.failover = failover if failover is not None else RetryPolicy(
            max_retries=2, base_delay=0.005, max_delay=0.1, max_elapsed=30.0)
        self.min_healthy = int(min_healthy)
        self.no_capacity_wait = float(no_capacity_wait)
        self.heartbeat_ttl = float(heartbeat_ttl)
        self.supervise_interval = float(supervise_interval)
        self.start_grace = float(start_grace)
        self.restart_backoff = (restart_backoff if restart_backoff
                                is not None else RetryPolicy(
                                    max_retries=0, base_delay=0.1,
                                    max_delay=5.0))
        self.probe_feeds = probe_feeds
        self.probe_timeout = float(probe_timeout)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_timeout = float(breaker_reset_timeout)
        self.autoscale = bool(autoscale)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_depth = float(scale_up_depth)
        self.scale_down_depth = float(scale_down_depth)
        self.autoscale_patience = int(autoscale_patience)
        #: ``{"p99_latency_s": ceiling, "ttft_p99_s": ceiling}``: with
        #: autoscale on, the band follows these SLOs, not queue depth
        self.autoscale_slo = dict(autoscale_slo) if autoscale_slo else None
        #: scale down only when every objective is under ratio x ceiling
        self.slo_scale_down_ratio = float(slo_scale_down_ratio)
        #: fewer new observations a sweep reads as an idle tier
        self.slo_min_samples = int(slo_min_samples)
        #: streams hash this many leading prompt tokens (block-aligned; 0
        #: turns affinity off) to find the replica holding the prefix
        self.affinity_block_tokens = int(affinity_block_tokens)
        self.affinity_max_entries = int(affinity_max_entries)


_READY, _DRAINING, _DEAD, _RETIRED = "ready", "draining", "dead", "retired"


class _ReplicaRecord:
    __slots__ = ("rid", "replica", "state", "breaker", "restart_attempts",
                 "next_restart_at", "started_at", "dispatched", "completed",
                 "deaths", "retiring", "restarting", "streams", "evacuate")

    def __init__(self, rid, replica, breaker, started_at):
        self.rid = rid
        self.replica = replica
        self.state = _READY
        self.breaker = breaker
        self.restart_attempts = 0
        self.next_restart_at = None
        self.started_at = started_at
        self.dispatched = 0
        self.completed = 0
        self.deaths = 0
        self.retiring = False
        self.restarting = False
        self.streams = 0        # live stream attempts pinned here
        self.evacuate = False   # rolling or retiring: streams migrate


_STREAM_END = object()


def _cancel_quietly(stream):
    try:
        stream.cancel()
    except Exception:  # noqa: BLE001 — best effort: the engine's deadline
        pass           # reaps a sequence that cannot be cancelled


class RouterStream:
    """Client handle of a generation routed through the tier: one token
    sequence however many replicas served it. Iterate for tokens, or
    `result()` for the list; `cancel()` frees the replica-side sequence
    within a scheduler round. `generation` is the weight generation
    every token was computed under; `failovers` counts the replica
    changes the client never saw. `served_by` lists, for each replica
    attempt that served the stream, ``(replica id, tokens committed when
    it took over)``: the first is ``(rid, 0)``, a resumed one continues
    after its count (a port addition, for checking a failed-over stream
    segment by segment). `trace_id` is the hex id of the stream's
    ``router.generate`` trace once its pump started (None untraced; a
    port addition)."""

    def __init__(self, router, timeout):
        self._router = router
        self._q = queue.Queue()
        self._tokens = []
        self._status = None
        self._error = None
        self._done = threading.Event()
        self._cancel_requested = False
        self._deadline = Deadline(timeout, clock=router._clock)
        self._t0 = router._clock()
        self._ttft_observed = False
        self.generation = None
        self.failovers = 0
        self.served_by = []
        self.trace_id = None

    @property
    def tokens(self):
        """Tokens delivered so far, in order."""
        return list(self._tokens)

    @property
    def status(self):
        """None while live; "completed", "failed", "timed_out" or
        "cancelled" once terminal."""
        return self._status

    def cancel(self):
        """Stop the generation; the pump cancels the live attempt."""
        self._cancel_requested = True

    def _push(self, tok):
        self._tokens.append(tok)
        self._q.put(tok)

    def _finish(self, status, error=None):
        self._status = status
        self._error = error
        self._done.set()
        self._q.put(_STREAM_END)

    def __iter__(self):
        while True:
            try:
                item = self._q.get(timeout=self._deadline.remaining())
            except queue.Empty:
                self.cancel()
                raise DeadlineExceeded(
                    "stream deadline elapsed while iterating") from None
            if item is _STREAM_END:
                if self._status == "completed":
                    return
                raise self._error if self._error is not None else \
                    RequestFailed(f"stream ended {self._status}")
            yield item

    def result(self, timeout=None):
        """Block until the stream ends; the tokens on "completed", else
        the stream's typed error."""
        rem = self._deadline.remaining()
        wait = rem if timeout is None else (
            timeout if rem is None else min(timeout, rem))
        if not self._done.wait(wait):
            self.cancel()
            raise DeadlineExceeded("stream did not finish within the "
                                   "deadline")
        if self._status == "completed":
            return list(self._tokens)
        raise self._error if self._error is not None else \
            RequestFailed(f"stream ended {self._status}")


class ServingRouter:
    """Health-checked, failover-capable frontend over N replicas.

        router = ServingRouter(factory, size=2, model_dir=committed_dir,
                               generation=g0, config=RouterConfig(...))
        outs, gen = router.infer_stamped([batch], timeout=0.5)
        stream = router.submit_generate(prompt, 128, timeout=60.0)
        router.swap_weights(new_committed_dir)        # rolling
        router.shutdown(drain_timeout=5.0)

    `replica_factory(rid, model_dir, generation)` builds a replica handle
    (`LocalReplica`, or anything honouring the handle contract)."""

    def __init__(self, replica_factory, size=2, *, model_dir=None,
                 generation=0, config=None, heartbeats=None, watchdog=None,
                 metrics=None, name=None, clock=time.monotonic):
        if size < 1:
            raise ValueError("router needs at least one replica")
        self.config = config if config is not None else RouterConfig()
        self._factory = replica_factory
        self._clock = clock
        self._lock = threading.Lock()
        self._replica_seq = itertools.count()
        self._model_dir = model_dir
        self._generation = int(generation)
        self._closed = False
        self._shutdown_called = False
        self._drained = False
        self._swapping = False
        # serializes swap_weights against the generation sweep
        self._swap_mutex = threading.Lock()

        # counters (under self._lock)
        self._admitted = self._completed = self._failed = 0
        self._timed_out = self._overloaded = self._cancelled = 0
        self._shed = self._failovers = self._restarts = 0
        self._swaps = self._swap_rollbacks = 0
        self._scale_ups = self._scale_downs = self._deaths = 0
        self._scale_streak = 0
        self._gen_sweep_running = False
        self._spawning = False
        # the streams ledger: admitted == completed + failed + timed_out
        # + cancelled + in_flight (in_flight includes streams between
        # attempts); shed sits outside, refused at admission
        self._streams = {"admitted": 0, "completed": 0, "failed": 0,
                         "timed_out": 0, "cancelled": 0, "in_flight": 0,
                         "failovers": 0, "resumed": 0, "shed": 0,
                         "affinity_hits": 0}
        #: sha1(block-aligned prompt prefix) -> rid, LRU-capped
        self._affinity = OrderedDict()
        # private histograms feed the SLO autoscaler
        from ..obs.metrics import Histogram

        self._h_request = Histogram("router.request_seconds")
        self._h_ttft = Histogram("router.ttft_seconds")
        self._slo_window = {}   # histogram counts at the last SLO sweep

        self._records = []
        self._hb = heartbeats if heartbeats is not None else LocalHeartbeats(
            clock=clock)
        for _ in range(size):
            self._records.append(self._new_record())

        if watchdog is not None:
            self._watchdog = watchdog
        else:
            from ..distributed.store import Watchdog

            # check() is driven by our own supervisor, so death marking
            # and restart scheduling share one sweep
            self._watchdog = Watchdog(
                self._hb, ttl=self.config.heartbeat_ttl,
                interval=self.config.supervise_interval,
                on_failure=self._on_watchdog_deaths)
        self._sup_stop = threading.Event()
        self._supervisor = threading.Thread(
            target=self._supervise_loop, name="ServingRouter-supervisor",
            daemon=True)
        self._supervisor.start()

        self.name = str(name) if name else f"router{next(_ROUTER_SEQ)}"
        self._metrics_server = None
        if metrics is False:
            self._metrics = self._m_request = None
        else:
            from ..obs.metrics import registry as _obs_registry

            self._metrics = metrics if metrics is not None \
                else _obs_registry()
            self._metrics.register_collector(
                f"serving.router.{self.name}", self.stats)
            self._m_request = self._metrics.histogram(
                "router.request_seconds",
                "end-to-end routed request/stream latency",
                labels={"router": self.name})

    def _new_record(self):
        rid = f"replica-{next(self._replica_seq)}"
        rep = self._factory(rid, self._model_dir, self._generation)
        breaker = CircuitBreaker(self.config.breaker_threshold,
                                 self.config.breaker_reset_timeout,
                                 clock=self._clock)
        return _ReplicaRecord(rid, rep, breaker, self._clock())

    def heartbeats(self):
        """The heartbeat sink replicas should write to."""
        return self._hb

    def warmup(self, feeds=None, timeout=None):
        """Probe every replica once, so traffic pays no cold start."""
        feeds = feeds if feeds is not None else self.config.probe_feeds
        for rec in self._active_records():
            rec.replica.probe(feeds, timeout=timeout if timeout is not None
                              else self.config.probe_timeout)

    # -- admission + routing ----------------------------------------------
    def infer(self, feeds, timeout=None, idempotent=True):
        """Route one inference to a healthy replica; fail typed. An
        idempotent request fails over from a dead or wedged replica inside
        the failover budget; a non-idempotent one whose execution state
        is unknown surfaces `RequestFailed`."""
        return self._route(feeds, timeout, idempotent)[0]

    def infer_stamped(self, feeds, timeout=None, idempotent=True):
        """`infer`, returning ``(outputs, generation)``: the weight
        generation of the replica that served the response."""
        return self._route(feeds, timeout, idempotent)

    def _refusal(self):
        """Under the lock: the admission error of a closed router
        (PoolClosed) or of one under its floor (Overloaded), or None."""
        if self._closed:
            return PoolClosed("router is shut down — admission refused")
        healthy = sum(1 for r in self._records if r.state == _READY)
        if healthy < max(1, self.config.min_healthy):
            return Overloaded(
                f"serving tier degraded below its floor: {healthy} ready "
                f"replicas < min_healthy={self.config.min_healthy} — "
                f"shedding while supervised restarts restore capacity")
        return None

    def _attempt_timeout(self, dl):
        tmo = dl.remaining()
        cap = self.config.attempt_timeout
        if cap is not None:
            tmo = cap if tmo is None else min(tmo, cap)
        return tmo

    def _route(self, feeds, timeout, idempotent):
        # the tier's root span: one trace per request (nested under a
        # traced caller's); every failover attempt is a sibling span
        # under it, and typed failures pin the trace as a postmortem
        if not _otrace.enabled():
            return self._route_impl(feeds, timeout, idempotent)
        with _otrace.root_span("router.infer",
                               attrs={"router": self.name}) as root:
            outs, served_gen = self._route_impl(feeds, timeout, idempotent)
            root.set_attr("generation", served_gen)
            if root.parent_id is None and root.ctx is not None:
                # recovered after a failed attempt pinned the trace: keep
                # the bounded postmortem buffer for requests that failed
                # (only for a true root: a nested trace is the caller's)
                _oflight.recorder().unpin(root.ctx.trace_id)
            return outs, served_gen

    def _route_impl(self, feeds, timeout, idempotent):
        cfg = self.config
        eff = cfg.default_timeout if timeout is None else timeout
        dl = Deadline(eff, clock=self._clock)
        with self._lock:
            refused = self._refusal()
            if refused is not None:
                self._shed += 1
                raise refused
            self._admitted += 1
        start = self._clock()
        tried = set()
        attempts = 0
        last_exc = None
        no_capacity_since = None
        while True:
            with self._lock:
                if self._closed:
                    self._cancelled += 1
                    raise PoolClosed("router shut down while the request "
                                     "was being routed") from last_exc
            if dl.expired():
                with self._lock:
                    self._timed_out += 1
                raise DeadlineExceeded(
                    "request deadline elapsed while failing over"
                    if attempts else
                    "request deadline elapsed before any dispatch")
            rec = self._pick(tried)
            if rec is None and tried:
                tried.clear()       # every routable replica was tried
                rec = self._pick(tried)
            if rec is None:
                now = self._clock()
                if no_capacity_since is None:
                    no_capacity_since = now
                if now - no_capacity_since > cfg.no_capacity_wait:
                    with self._lock:
                        self._overloaded += 1
                    raise Overloaded(
                        f"no routable replica (dead/draining/tripped) for "
                        f"{cfg.no_capacity_wait}s — shed while restarts "
                        f"restore capacity") from last_exc
                time.sleep(min(0.005, cfg.supervise_interval))
                continue
            no_capacity_since = None
            attempts += 1
            with self._lock:
                rec.dispatched += 1
            att_span = _otrace.null_span() if not _otrace.enabled() \
                else _otrace.span("router.attempt",
                                  attrs={"rid": rec.rid,
                                         "attempt": attempts})
            try:
                with att_span:
                    outs, served_gen = rec.replica.infer_stamped(
                        feeds, timeout=self._attempt_timeout(dl))
            except Overloaded:
                # never admitted there: rerouting is safe even when not
                # idempotent, and no health penalty
                rec.breaker.cancel_probe()
                tried.add(rec.rid)
                if all(r.rid in tried for r in self._active_records()
                       if r.state == _READY):
                    with self._lock:
                        self._overloaded += 1
                    raise Overloaded(
                        "every healthy replica shed the request (queues "
                        "full) — back off or scale the tier")
                continue
            except DeadlineExceeded as e:
                self._note_dispatch_failure(rec)
                if dl.expired():
                    with self._lock:
                        self._timed_out += 1
                    raise
                last_exc = e          # a wedged replica: fail over
            except ReplicaDead as e:
                last_exc = e
                self._mark_dead(rec, f"died under dispatch: {e}")
            except ReplicaError as e:
                # a transport failure before execution: reroute even a
                # non-idempotent request, nothing ran
                last_exc = e
                self._note_dispatch_failure(rec)
                tried.add(rec.rid)
                if not cfg.failover.should_retry(attempts,
                                                 self._clock() - start):
                    with self._lock:
                        self._failed += 1
                    err = RequestFailed(
                        f"request send failed {attempts} time(s) "
                        f"({type(e).__name__}: {e})", cause=e,
                        attempts=attempts)
                    err.__cause__ = e
                    raise err
                with self._lock:
                    self._failovers += 1
                continue
            except RequestFailed as e:
                if isinstance(e.cause, DETERMINISTIC_ERRORS):
                    # malformed: the same on any replica
                    rec.breaker.record_success()
                    with self._lock:
                        self._failed += 1
                    raise
                last_exc = e
                self._note_dispatch_failure(rec)
            except Exception as e:  # noqa: BLE001 — an untyped escape stays
                last_exc = e        # inside the law: fail over
                self._note_dispatch_failure(rec)
            else:
                rec.breaker.record_success()
                with self._lock:
                    rec.completed += 1
                    self._completed += 1
                return outs, served_gen
            # ---- failover tail ------------------------------------------
            tried.add(rec.rid)
            if not idempotent:
                with self._lock:
                    self._failed += 1
                err = RequestFailed(
                    f"attempt on replica {rec.rid} failed with execution "
                    f"state unknown ({type(last_exc).__name__}) and the "
                    f"request is not idempotent — refusing to re-execute",
                    cause=last_exc, attempts=attempts)
                err.__cause__ = last_exc
                raise err
            if not cfg.failover.should_retry(attempts,
                                             self._clock() - start):
                with self._lock:
                    self._failed += 1
                err = RequestFailed(
                    f"request failed over {attempts} attempt(s) across "
                    f"replicas without success (last: "
                    f"{type(last_exc).__name__}: {last_exc})",
                    cause=last_exc, attempts=attempts)
                err.__cause__ = last_exc
                raise err
            with self._lock:
                self._failovers += 1
            self._backoff(attempts, dl)

    def _backoff(self, attempts, dl):
        delay = self.config.failover.delay(attempts)
        rem = dl.remaining()
        if rem is not None:
            delay = min(delay, max(0.0, rem))
        time.sleep(delay)

    def _active_records(self):
        with self._lock:
            return [r for r in self._records if r.state != _RETIRED]

    def _pick(self, exclude):
        """The least-loaded READY replica whose breaker admits traffic
        (depths read outside the lock); HALF_OPEN probes granted to the
        candidates not chosen are handed back."""
        granted = []
        with self._lock:
            for rec in self._records:
                if rec.state != _READY or rec.rid in exclude:
                    continue
                if rec.breaker.allow():
                    granted.append(rec)
        best, best_depth = None, None
        for rec in granted:
            try:
                depth = rec.replica.queue_depth()
            except Exception:  # noqa: BLE001 — a bad load signal must not
                depth = 0      # break routing
            if best is None or depth < best_depth:
                best, best_depth = rec, depth
        for rec in granted:
            if rec is not best:
                rec.breaker.cancel_probe()
        if best is not None and best.state != _READY:
            best.breaker.cancel_probe()   # lost a race with a transition
            return None
        return best

    # -- streaming ---------------------------------------------------------
    def submit_generate(self, prompt_ids, max_new_tokens, timeout=None, *,
                        sampling=None, adapter=None):
        """Route one generation; returns a `RouterStream` at once
        (admission errors raise typed). The stream's pump thread owns
        placement (prefix affinity first), mid-stream failover (resume
        with ``prompt + committed`` on another replica), migration under a
        weight swap, and the deadline. `sampling` and `adapter` ride every
        attempt unchanged, so a resumed sampled stream draws the same
        continuation."""
        eff = self.config.default_timeout if timeout is None else timeout
        with self._lock:
            refused = self._refusal()
            if refused is not None:
                self._streams["shed"] += 1
                raise refused
            self._streams["admitted"] += 1
            self._streams["in_flight"] += 1
        prompt = np.asarray(prompt_ids.cpu() if hasattr(prompt_ids, "cpu")
                            else prompt_ids)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        rs = RouterStream(self, eff)
        threading.Thread(
            target=self._stream_pump,
            args=(rs, prompt, int(max_new_tokens), sampling, adapter),
            name=f"ServingRouter-stream-{self.name}", daemon=True).start()
        return rs

    def _stream_pump(self, rs, prompt, max_new, sampling=None,
                     adapter=None):
        # the stream's root span covers the pump's life: each failover
        # attempt is a sibling `router.attempt` under it, and a process
        # replica's spans come home on its terminal frame
        if not _otrace.enabled():
            self._stream_pump_impl(rs, prompt, max_new, sampling, adapter)
            return
        with _otrace.root_span("router.generate",
                               attrs={"router": self.name}) as root:
            rs.trace_id = root.trace_id_hex
            self._stream_pump_impl(rs, prompt, max_new, sampling, adapter)
            root.set_attr("status", rs._status)
            root.set_attr("failovers", rs.failovers)
            if rs.generation is not None:
                root.set_attr("generation", rs.generation)
            if rs._status == "completed" and root.parent_id is None \
                    and root.ctx is not None:
                _oflight.recorder().unpin(root.ctx.trace_id)

    def _stream_pump_impl(self, rs, prompt, max_new, sampling=None,
                          adapter=None):
        cfg = self.config
        dl = rs._deadline
        committed = []   # every token delivered to the client, in order
        start = self._clock()
        attempts = 0
        tried = set()
        last_exc = None
        no_capacity_since = None
        akey = self._affinity_key(prompt)
        while True:
            with self._lock:
                closed = self._closed
            if closed:
                self._finish_stream(rs, "cancelled", PoolClosed(
                    "router shut down mid-stream"))
                return
            if rs._cancel_requested:
                self._finish_stream(rs, "cancelled", RequestFailed(
                    "stream cancelled by the client"))
                return
            if dl.expired():
                self._finish_stream(rs, "timed_out", DeadlineExceeded(
                    "stream deadline elapsed while failing over"
                    if attempts else
                    "stream deadline elapsed before any dispatch"))
                return
            if len(committed) >= max_new:
                # the replica died between its last token and its end
                self._finish_stream(rs, "completed")
                return
            rec = self._pick_stream(akey, tried)
            if rec is None and tried:
                tried.clear()
                rec = self._pick_stream(akey, tried)
            if rec is None:
                now = self._clock()
                if no_capacity_since is None:
                    no_capacity_since = now
                if now - no_capacity_since > cfg.no_capacity_wait:
                    msg = (f"no routable replica (dead/draining/tripped) "
                           f"for {cfg.no_capacity_wait}s")
                    err = Overloaded(msg) if not committed else \
                        RequestFailed(f"{msg} to resume the stream "
                                      f"({len(committed)} tokens "
                                      f"committed)", cause=last_exc,
                                      attempts=attempts)
                    self._finish_stream(rs, "failed", err)
                    return
                time.sleep(min(0.005, cfg.supervise_interval))
                continue
            no_capacity_since = None
            attempts += 1
            att_span = _otrace.null_span() if not _otrace.enabled() \
                else _otrace.span("router.attempt",
                                  attrs={"rid": rec.rid, "attempt": attempts,
                                         "resumed_from": len(committed)})
            with att_span:
                exc = self._stream_attempt(rs, rec, prompt, max_new,
                                           committed, dl, attempts, sampling,
                                           adapter)
                if exc is not None:
                    att_span.end(error=exc)
            if exc is None:
                return   # the attempt ended the stream
            last_exc = exc
            # ---- mid-stream failover tail --------------------------------
            tried.add(rec.rid)
            if not cfg.failover.should_retry(attempts,
                                             self._clock() - start):
                self._finish_stream(rs, "failed", RequestFailed(
                    f"stream failed over {attempts} attempt(s) across "
                    f"replicas without success (last: "
                    f"{type(last_exc).__name__}: {last_exc})",
                    cause=last_exc, attempts=attempts))
                return
            with self._lock:
                self._streams["failovers"] += 1
                if committed:
                    self._streams["resumed"] += 1
            rs.failovers += 1
            self._backoff(attempts, dl)

    def _stream_attempt(self, rs, rec, prompt, max_new, committed, dl,
                        attempts, sampling=None, adapter=None):
        """One replica attempt: admit (resuming from `committed`), check
        generation purity, pump tokens. Returns None when the stream
        reached its end inside, or the exception that makes the pump fail
        over."""
        with self._lock:
            rec.dispatched += 1
        try:
            stream, gen = rec.replica.submit_generate(
                prompt, max_new - len(committed), timeout=dl.remaining(),
                resume_committed=committed if committed else None,
                sampling=sampling, adapter=adapter,
                admission_timeout=self._attempt_timeout(dl))
        except Overloaded as e:
            rec.breaker.cancel_probe()    # never admitted: reroute
            return e
        except DeadlineExceeded as e:
            self._note_dispatch_failure(rec)
            if dl.expired():
                self._finish_stream(rs, "timed_out", e)
                return None
            return e                      # wedged at admission
        except ReplicaDead as e:
            self._mark_dead(rec, f"died under stream dispatch: {e}")
            return e
        except RequestFailed as e:
            if isinstance(e.cause, DETERMINISTIC_ERRORS):
                rec.breaker.record_success()
                self._finish_stream(rs, "failed", e)
                return None
            self._note_dispatch_failure(rec)
            return e
        except DETERMINISTIC_ERRORS as e:
            # the engine refused the request itself: no failover
            rec.breaker.record_success()
            err = RequestFailed(f"stream admission rejected "
                                f"deterministically ({type(e).__name__}: "
                                f"{e})", cause=e, attempts=attempts)
            err.__cause__ = e
            self._finish_stream(rs, "failed", err)
            return None
        except Exception as e:  # noqa: BLE001 — untyped: fail over
            self._note_dispatch_failure(rec)
            return e
        rec.breaker.record_success()
        if committed and rs.generation is not None \
                and gen != rs.generation:
            # generation purity: never splice two generations' tokens
            _cancel_quietly(stream)
            return RequestFailed(
                f"replica {rec.rid} admitted the resume under generation "
                f"{gen}; stream is generation {rs.generation} — refusing "
                f"a mixed-weights splice")
        rs.generation = gen
        rs.served_by.append((rec.rid, len(committed)))
        with self._lock:
            rec.streams += 1
        try:
            return self._pump_attempt(rs, rec, stream, dl, committed,
                                      max_new)
        finally:
            with self._lock:
                rec.streams -= 1

    def _pump_attempt(self, rs, rec, stream, dl, committed, max_new):
        """Forward one attempt's tokens to the client until its end, a
        fault or a migration signal; `_stream_attempt`'s return
        contract."""
        stall = self.config.attempt_timeout
        last_progress = self._clock()
        while True:
            try:
                polled = stream.poll(0.01)
            except Exception as e:  # noqa: BLE001 — replica trouble
                return e
            if polled[0] == "tok":
                self._deliver(rs, rec, committed, int(polled[1]))
                last_progress = self._clock()
                continue
            if polled[0] == "end":
                _, status, err = polled
                if status == "completed":
                    self._finish_stream(rs, "completed")
                    return None
                if rs._cancel_requested:
                    self._finish_stream(rs, "cancelled", RequestFailed(
                        "stream cancelled by the client"))
                    return None
                if isinstance(err, ReplicaDead):
                    self._mark_dead(rec, f"died mid-stream: {err}")
                    return err
                if status == "cancelled":
                    # an eviction the client never asked for (engine
                    # teardown under swap or retire): migrate
                    return err if err is not None else ReplicaError(
                        f"replica {rec.rid} evicted the stream")
                if isinstance(err, DeadlineExceeded):
                    self._note_dispatch_failure(rec)
                    self._finish_stream(rs, "timed_out", err)
                    return None
                if err is not None and isinstance(
                        getattr(err, "cause", None), DETERMINISTIC_ERRORS):
                    self._finish_stream(rs, "failed", err)
                    return None
                self._note_dispatch_failure(rec)
                return err if err is not None else ReplicaError(
                    f"replica {rec.rid} ended the stream without status")
            # ("empty", None): a gap; run the round checks
            if rs._cancel_requested:
                _cancel_quietly(stream)
                self._finish_stream(rs, "cancelled", RequestFailed(
                    "stream cancelled by the client"))
                return None
            with self._lock:
                closed, state, evacuate = (self._closed, rec.state,
                                           rec.evacuate)
            if closed:
                _cancel_quietly(stream)
                self._finish_stream(rs, "cancelled", PoolClosed(
                    "router shut down mid-stream"))
                return None
            if dl.expired():
                _cancel_quietly(stream)
                self._finish_stream(rs, "timed_out", DeadlineExceeded(
                    "stream deadline elapsed mid-generation"))
                return None
            if state == _DEAD:
                return ReplicaDead(f"replica {rec.rid} marked dead "
                                   f"mid-stream")
            if evacuate or state == _DRAINING:
                # a rolling swap or retire: hand back what arrived, then
                # move the stream (no breaker charge: the replica is fine)
                while True:
                    p = stream.poll(None)
                    if p[0] == "tok":
                        self._deliver(rs, rec, committed, int(p[1]))
                        continue
                    if p[0] == "end" and p[1] == "completed":
                        self._finish_stream(rs, "completed")
                        return None
                    break
                _cancel_quietly(stream)
                return ReplicaError(f"replica {rec.rid} is rolling — "
                                    f"stream migrates")
            if stall is not None \
                    and self._clock() - last_progress > stall:
                # tokens stopped flowing (a wedged replica)
                self._note_dispatch_failure(rec)
                _cancel_quietly(stream)
                return DeadlineExceeded(
                    f"replica {rec.rid} stalled mid-stream (> {stall}s "
                    f"without a token)")

    def _deliver(self, rs, rec, committed, tok):
        committed.append(tok)
        rs._push(tok)
        if not rs._ttft_observed:
            rs._ttft_observed = True
            ttft = self._clock() - rs._t0
            self._h_ttft.observe(ttft)
            if self._metrics is not None:
                self._metrics.histogram(
                    "router.ttft_seconds",
                    "time to first streamed token, per serving replica",
                    labels={"router": self.name,
                            "replica": rec.rid}).observe(ttft)

    def _finish_stream(self, rs, status, error=None):
        with self._lock:
            self._streams["in_flight"] -= 1
            self._streams[status] += 1
        dur = self._clock() - rs._t0
        self._h_request.observe(dur)
        if self._m_request is not None:
            self._m_request.observe(dur)
        rs._finish(status, error)

    def _affinity_key(self, prompt):
        blk = self.config.affinity_block_tokens
        n = 0 if blk <= 0 else (len(prompt) // blk) * blk
        if n <= 0:
            return None
        return hashlib.sha1(np.ascontiguousarray(
            np.asarray(prompt[:n], dtype=np.int64)).tobytes()).hexdigest()

    def _pick_stream(self, akey, exclude):
        """Affinity first: the replica that last served this block-aligned
        prompt prefix holds its KV blocks in its prefix cache. Else the
        least-loaded pick, remembered for the next stream sharing the
        prefix."""
        if akey is not None:
            with self._lock:
                rid = self._affinity.get(akey)
                rec = None
                if rid is not None and rid not in exclude:
                    rec = next((r for r in self._records
                                if r.rid == rid and r.state == _READY
                                and not r.evacuate), None)
                if rec is not None and rec.breaker.allow():
                    self._affinity.move_to_end(akey)
                    self._streams["affinity_hits"] += 1
                    return rec
        rec = self._pick(exclude)
        if rec is not None and akey is not None:
            with self._lock:
                self._affinity[akey] = rec.rid
                self._affinity.move_to_end(akey)
                while len(self._affinity) > \
                        self.config.affinity_max_entries:
                    self._affinity.popitem(last=False)
        return rec

    # -- failure handling --------------------------------------------------
    def _note_dispatch_failure(self, rec):
        rec.breaker.record_failure()

    def _on_watchdog_deaths(self, names):
        dead = set(names)
        for rec in self._active_records():
            if rec.rid in dead and rec.state in (_READY, _DRAINING):
                self._mark_dead(rec, "heartbeat went stale (watchdog)")

    def _mark_dead(self, rec, reason):
        """Idempotent death: out of rotation, breaker charged, restart
        scheduled with jittered backoff, and the replica killed so its
        in-flight requests fail typed (their callers fail over)."""
        with self._lock:
            if rec.state in (_DEAD, _RETIRED):
                return
            rec.state = _DEAD
            rec.deaths += 1
            rec.evacuate = False
            self._deaths += 1
            rec.restart_attempts = 0
            rec.next_restart_at = (self._clock()
                                   + self.config.restart_backoff.delay(1))
        rec.breaker.record_failure()
        try:
            rec.replica.kill()
        except Exception:  # noqa: BLE001 — a kill racing a real death
            pass           # must not stop the sweep

    # -- supervision -------------------------------------------------------
    def _supervise_loop(self):
        while not self._sup_stop.wait(self.config.supervise_interval):
            try:
                self._watchdog.check()
                self._health_sweep()
                self._restart_sweep()
                self._generation_sweep()
                self._autoscale_sweep()
            except Exception:  # noqa: BLE001 — the supervisor never dies;
                pass           # the sweeps run again next tick

    def _health_sweep(self):
        """Replicas whose beat is older than the ttl (or that never beat
        within the start grace) are marked dead even if the watchdog
        missed them."""
        ttl = self.config.heartbeat_ttl
        now = self._clock()
        for rec in self._active_records():
            if rec.state not in (_READY, _DRAINING):
                continue
            if now - rec.started_at <= ttl:
                continue   # readmission grace: a stale stamp may linger
            age = rec.replica.beat_age()
            if age is None:
                if now - rec.started_at > max(ttl, self.config.start_grace):
                    self._mark_dead(rec, "never heartbeat after start")
            elif age > ttl:
                self._mark_dead(rec, f"heartbeat stale ({age:.2f}s > ttl)")

    def _restart_sweep(self):
        """One restart thread per due dead replica (a rebuild takes long:
        it must not stall the detection of the next fault)."""
        now = self._clock()
        for rec in self._active_records():
            with self._lock:
                if rec.state != _DEAD or rec.retiring or rec.restarting:
                    continue
                if rec.next_restart_at is not None \
                        and now < rec.next_restart_at:
                    continue
                rec.restarting = True
            threading.Thread(target=self._do_restart, args=(rec,),
                             name=f"ServingRouter-restart-{rec.rid}",
                             daemon=True).start()

    def _do_restart(self, rec):
        try:
            try:
                rec.replica.restart(self._model_dir, self._generation)
                self._probe_replica(rec.replica)
            except Exception:  # noqa: BLE001 — the backoff loop's input
                rec.restart_attempts += 1
                rec.next_restart_at = (
                    self._clock() + self.config.restart_backoff.delay(
                        rec.restart_attempts + 1))
                return
            if self._sup_stop.is_set():
                # shutdown raced the restart: do not resurrect capacity
                try:
                    rec.replica.close(drain_timeout=1.0)
                except Exception:  # noqa: BLE001 — best effort
                    pass
                return
            with self._lock:
                if rec.state == _DEAD:
                    rec.state = _READY
                    rec.started_at = self._clock()
                    rec.restart_attempts = 0
                    rec.next_restart_at = None
                    self._restarts += 1
            rec.breaker.record_success()
        finally:
            with self._lock:
                rec.restarting = False

    def _generation_sweep(self):
        """A replica restarted mid-swap (or left out of a rolled-back
        swap) can come back on a stale generation: roll it to the
        committed one, on a maintenance thread, serialized against
        `swap_weights`."""
        with self._lock:
            if self._gen_sweep_running:
                return
            target_gen = self._generation
        if not any(rec.state == _READY
                   and rec.replica.generation != target_gen
                   for rec in self._active_records()):
            return
        with self._lock:
            if self._gen_sweep_running:
                return
            self._gen_sweep_running = True
        threading.Thread(target=self._do_generation_converge,
                         name="ServingRouter-gen-converge",
                         daemon=True).start()

    def _do_generation_converge(self):
        try:
            if not self._swap_mutex.acquire(blocking=False):
                return  # a deploy is rolling; converge on a later tick
            try:
                with self._lock:
                    target_dir = self._model_dir
                    target_gen = self._generation
                for rec in self._active_records():
                    if rec.state != _READY \
                            or rec.replica.generation == target_gen:
                        continue
                    try:
                        self._swap_one(
                            rec, target_dir, target_gen,
                            drain_timeout=self.config.probe_timeout)
                    except ServingError:
                        continue  # marked dead inside; restarts own it
            finally:
                self._swap_mutex.release()
        finally:
            with self._lock:
                self._gen_sweep_running = False

    def _probe_replica(self, rep):
        rep.probe(self.config.probe_feeds, timeout=self.config.probe_timeout)

    def _autoscale_sweep(self):
        cfg = self.config
        if not cfg.autoscale:
            return
        with self._lock:
            ready = [r for r in self._records if r.state == _READY]
            active = [r for r in self._records if r.state != _RETIRED]
        if not ready:
            return
        if cfg.autoscale_slo:
            self._autoscale_slo_sweep(active)
            return
        depth = sum(r.replica.queue_depth() for r in ready) / len(ready)
        if depth > cfg.scale_up_depth and len(active) < cfg.max_replicas:
            self._scale_streak = max(0, self._scale_streak) + 1
            if self._scale_streak >= cfg.autoscale_patience \
                    and not self._spawning:
                self._kick_spawn()
        elif depth < cfg.scale_down_depth and len(active) > cfg.min_replicas:
            self._scale_down_tick(active)
        else:
            self._scale_streak = 0

    def _scale_down_tick(self, active):
        self._scale_streak = min(0, self._scale_streak) - 1
        if -self._scale_streak >= self.config.autoscale_patience:
            self._scale_streak = 0
            self._retire_one(active)

    def _autoscale_slo_sweep(self, active):
        """Windowed p99s of the router's own histograms (request latency,
        TTFT) against the declared ceilings through `obs.slo.evaluate`:
        a breach (patience-gated) spawns; every objective under
        `slo_scale_down_ratio` x its ceiling, or an idle window, retires.
        Queue depth is not read."""
        from ..obs import slo as _slo

        cfg = self.config
        values = {}
        total_new = 0
        for name, hist in (("p99_latency_s", self._h_request),
                           ("ttft_p99_s", self._h_ttft)):
            if name not in cfg.autoscale_slo:
                continue
            counts = hist.counts()
            prev = self._slo_window.get(name)
            self._slo_window[name] = counts
            delta = counts if prev is None else \
                [c - p for c, p in zip(counts, prev)]
            n = sum(delta)
            total_new += n
            if n:
                values[name] = hist.quantile(0.99, delta)
        if total_new < cfg.slo_min_samples:
            # an idle tier: idle is the scale-down signal
            if len(active) > cfg.min_replicas:
                self._scale_down_tick(active)
            else:
                self._scale_streak = 0
            return
        objectives = [_slo.Objective(n, "max", unit="s", slack=1.0)
                      for n in values]
        baseline = {n: {"kind": "max", "bound": float(cfg.autoscale_slo[n])}
                    for n in values}
        if not _slo.evaluate(values, baseline, objectives)["ok"]:
            if len(active) < cfg.max_replicas:
                self._scale_streak = max(0, self._scale_streak) + 1
                if self._scale_streak >= cfg.autoscale_patience \
                        and not self._spawning:
                    self._kick_spawn()
            return
        comfy = all(values[n] < float(cfg.autoscale_slo[n])
                    * cfg.slo_scale_down_ratio for n in values)
        if comfy and len(active) > cfg.min_replicas:
            self._scale_down_tick(active)
        else:
            self._scale_streak = 0

    def _kick_spawn(self):
        self._scale_streak = 0
        with self._lock:
            if self._spawning:
                return
            self._spawning = True
        threading.Thread(target=self._spawn_replica,
                         name="ServingRouter-spawn", daemon=True).start()

    def _spawn_replica(self):
        try:
            try:
                rec = self._new_record()
                self._probe_replica(rec.replica)
            except Exception:  # noqa: BLE001 — retried on a later tick
                return
            with self._lock:
                if not self._closed:
                    self._records.append(rec)
                    self._scale_ups += 1
                    return
            try:   # shutdown raced the spawn: close, do not admit
                rec.replica.close(drain_timeout=1.0)
            except Exception:  # noqa: BLE001 — best effort
                pass
        finally:
            with self._lock:
                self._spawning = False

    def _retire_one(self, active):
        """Scale down: drain the youngest ready replica, then close it (on
        its own thread)."""
        rec = active[-1]
        with self._lock:
            if rec.state != _READY:
                return
            rec.state = _DRAINING
            rec.retiring = True
            rec.evacuate = True  # live streams migrate
        threading.Thread(target=self._do_retire, args=(rec,),
                         name=f"ServingRouter-retire-{rec.rid}",
                         daemon=True).start()

    def _do_retire(self, rec):
        dl = Deadline(self.config.probe_timeout, clock=self._clock)
        while not (rec.replica.drained() and rec.streams == 0) \
                and not dl.expired():
            time.sleep(0.005)
        try:
            rec.replica.close(drain_timeout=1.0)
        except Exception:  # noqa: BLE001 — it leaves the tier either way
            pass
        with self._lock:
            rec.state = _RETIRED
            self._scale_downs += 1
            if rec in self._records:
                self._records.remove(rec)

    # -- weight hot-swap ---------------------------------------------------
    def swap_weights(self, ckpt_dir, drain_timeout=30.0):
        """Rolling weight update: `ckpt_dir` must be committed with a
        generation newer than the serving one; then every ready replica
        goes through drain -> swap -> probe -> readmit while the others
        serve. Returns the new generation. On any failure the swapped
        replicas roll back and `SwapFailed` is raised; replicas that died
        come back on the committed generation."""
        # a deploy is traced too: the roll's drains, probes and rollback
        # record under one trace, which a SwapFailed retains
        if not _otrace.enabled():
            return self._swap_weights_impl(ckpt_dir, drain_timeout)
        with _otrace.root_span("router.swap", attrs={"dir": str(ckpt_dir)}):
            return self._swap_weights_impl(ckpt_dir, drain_timeout)

    def _swap_weights_impl(self, ckpt_dir, drain_timeout):
        from ..distributed.checkpoint.api import (CheckpointError,
                                                  commit_generation,
                                                  is_committed)

        try:
            if not is_committed(ckpt_dir):
                raise SwapFailed(
                    f"swap target {ckpt_dir!r} has no _COMMITTED sentinel "
                    f"— refusing to serve a torn snapshot")
            gen = commit_generation(ckpt_dir)
        except CheckpointError as e:
            raise SwapFailed(f"swap target {ckpt_dir!r} failed commit "
                             f"validation: {e}") from e
        if gen is None:
            raise SwapFailed(
                f"swap target {ckpt_dir!r} carries no generation stamp "
                f"(commit it with commit_model_dir)")
        with self._lock:
            if self._closed:
                raise SwapFailed("router is shut down")
            if self._swapping:
                raise SwapFailed("another weight swap is in progress")
            old_dir, old_gen = self._model_dir, self._generation
            if gen <= old_gen:
                raise SwapFailed(
                    f"swap target generation {gen} is not newer than the "
                    f"serving generation {old_gen} — refusing a rollback "
                    f"disguised as a deploy")
            self._swapping = True
        self._swap_mutex.acquire()
        swapped = []
        try:
            for rec in self._active_records():
                if rec.state != _READY:
                    continue  # dead replicas rejoin via the sweeps
                self._swap_one(rec, ckpt_dir, gen, drain_timeout)
                swapped.append(rec)
            if not swapped:
                raise SwapFailed("no ready replica to roll")
            with self._lock:
                self._model_dir, self._generation = ckpt_dir, gen
                self._swaps += 1
            return gen
        except BaseException as e:
            for rec in swapped:
                try:
                    self._swap_one(rec, old_dir, old_gen, drain_timeout)
                except ServingError:
                    continue  # marked dead; restarts on the old generation
            if swapped:
                with self._lock:
                    self._swap_rollbacks += 1
            if isinstance(e, SwapFailed):
                raise
            err = SwapFailed(f"weight swap to generation {gen} failed "
                             f"({type(e).__name__}: {e}); rolled back to "
                             f"generation {old_gen}")
            err.__cause__ = e
            raise err
        finally:
            self._swap_mutex.release()
            with self._lock:
                self._swapping = False

    def _swap_one(self, rec, model_dir, gen, drain_timeout):
        """One replica through the roll: out of rotation -> drain -> swap
        -> probe -> readmit. Raises SwapFailed (the replica back to READY
        when it is merely busy, DEAD when it is broken)."""
        with _otrace.span("router.swap_replica",
                          attrs={"rid": rec.rid, "generation": gen}):
            self._swap_one_impl(rec, model_dir, gen, drain_timeout)

    def _swap_one_impl(self, rec, model_dir, gen, drain_timeout):
        with self._lock:
            if rec.state != _READY:
                raise SwapFailed(f"replica {rec.rid} is {rec.state}, not "
                                 f"ready")
            rec.state = _DRAINING
            # live streams leave before the weights change (their pumps
            # resume elsewhere on the same generation)
            rec.evacuate = True
        dl = Deadline(drain_timeout, clock=self._clock)
        while not (rec.replica.drained() and rec.streams == 0):
            if dl.expired():
                with self._lock:
                    rec.evacuate = False
                    if rec.state == _DRAINING:
                        rec.state = _READY
                raise SwapFailed(f"replica {rec.rid} did not drain within "
                                 f"{drain_timeout}s")
            time.sleep(0.005)
        try:
            rec.replica.swap(model_dir, gen)
            self._probe_replica(rec.replica)
        except BaseException as e:
            self._mark_dead(rec, f"swap/probe failed: {e}")
            err = SwapFailed(f"replica {rec.rid} failed its weight swap "
                             f"({type(e).__name__}: {e})")
            err.__cause__ = e
            raise err
        with self._lock:
            rec.evacuate = False
            if rec.state == _DRAINING:
                rec.state = _READY
        rec.breaker.record_success()

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self, drain_timeout=30.0):
        """Stop admissions and supervision, drain and close every replica
        within `drain_timeout` in all. True when every replica closed.
        Idempotent."""
        with self._lock:
            if self._shutdown_called:
                return self._drained
            self._shutdown_called = True
            self._closed = True
        self._sup_stop.set()
        self._supervisor.join(timeout=2.0)
        dl = Deadline(drain_timeout, clock=self._clock)
        ok = True
        for rec in self._active_records():
            rem = dl.remaining()
            budget = max(0.0, rem) if rem is not None else 5.0
            try:
                rec.replica.close(drain_timeout=budget)
            except Exception:  # noqa: BLE001 — visit every replica
                ok = False
            with self._lock:
                rec.state = _RETIRED
        if self._metrics is not None:
            self._metrics.unregister_collector(
                f"serving.router.{self.name}", self.stats)
        server, self._metrics_server = self._metrics_server, None
        if server is not None:
            server.stop()
        self._drained = ok
        return ok

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- observability -----------------------------------------------------
    def serve_metrics(self, port=0, host="127.0.0.1"):
        """Start (or return) the HTTP exporter over the router's registry:
        ``/metrics``, ``/metrics.json`` and ``/healthz`` (200 while ready
        capacity meets `min_healthy` and admissions are open)."""
        if self._metrics is None:
            raise RuntimeError("router was built with metrics=False — no "
                               "registry to serve")
        from ..obs.http import MetricsServer

        def _healthz():
            s = self.stats()
            ok = s["ready"] >= self.config.min_healthy and not s["closed"]
            return ok, {"router": self.name, "ready": s["ready"],
                        "replicas": s["replicas"],
                        "generation": s["generation"], "closed": s["closed"]}

        with self._lock:
            if self._closed:
                raise PoolClosed("cannot serve metrics from a shut-down "
                                 "router")
            if self._metrics_server is None:
                self._metrics_server = MetricsServer(
                    self._metrics, host=host, port=port,
                    healthz=_healthz).start()
            return self._metrics_server

    @property
    def generation(self):
        with self._lock:
            return self._generation

    def stats(self):
        """Counters and per-replica health; see the module docstring for
        the two conservation laws."""
        with self._lock:
            replicas = []
            for rec in self._records:
                replicas.append({
                    "rid": rec.rid, "state": rec.state,
                    "generation": rec.replica.generation,
                    "breaker": rec.breaker.state, "_rec": rec,
                    "dispatched": rec.dispatched,
                    "completed": rec.completed, "deaths": rec.deaths,
                    "streams": rec.streams})
            snap = {
                "name": self.name,
                "replicas": len(replicas),
                "ready": sum(1 for r in replicas if r["state"] == _READY),
                "generation": self._generation,
                "model_dir": self._model_dir,
                "swapping": self._swapping,
                "closed": self._closed,
                "admitted": self._admitted,
                "completed": self._completed,
                "failed": self._failed,
                "timed_out": self._timed_out,
                "overloaded": self._overloaded,
                "cancelled": self._cancelled,
                "shed": self._shed,
                "failovers": self._failovers,
                "restarts": self._restarts,
                "deaths": self._deaths,
                "swaps": self._swaps,
                "swap_rollbacks": self._swap_rollbacks,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "streams": dict(self._streams),
                "members": replicas,
            }
        for r in replicas:
            rec = r.pop("_rec")
            r["queue_depth"] = (rec.replica.queue_depth()
                                if r["state"] != _RETIRED else 0)
            r["beat_age"] = rec.replica.beat_age()
        try:
            snap["health"] = self._watchdog.members_health()
        except Exception:  # noqa: BLE001 — a bad read must not break stats
            snap["health"] = None
        return snap

    def __len__(self):
        with self._lock:
            return sum(1 for r in self._records if r.state != _RETIRED)
