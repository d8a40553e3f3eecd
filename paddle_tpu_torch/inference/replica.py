"""One member of the serving tier (counterpart of
paddle_tpu/inference/replica.py): a replica is a `ServingPool` plus a
liveness heartbeat plus a control surface (drain, weight swap, restart),
behind the handle contract `ServingRouter` speaks. Two transports share
it.

`LocalReplica` hosts the pool in this process (threads as replicas): the
router's behaviour (health marking, failover, restart, rolling weight
swap) is the same as over process replicas, because it only speaks the
handle contract. Faults are first class: `kill()` models a crash (the
pool's in-flight requests fail typed, the heartbeat stops), `wedge()` a
frozen process (requests hold, heartbeats stop, the watchdog must
notice).

Handle contract (what the router consumes):
    rid, generation, model_dir
    infer(feeds, timeout)           -> outputs | typed error / ReplicaDead
    infer_stamped(feeds, timeout)   -> (outputs, generation), the stamp
                                       read atomically with execution
    submit_generate(prompt_ids, max_new, timeout, resume_committed,
                    sampling, adapter, admission_timeout)
                                    -> (stream, generation); the stream
                                       speaks the pump contract (`poll`,
                                       `cancel`)
    queue_depth(), beat_age(), drained(), probe(feeds, timeout)
    swap(model_dir, generation), restart(model_dir, generation)
    kill(), close(drain_timeout)

`SubprocessReplica` is a replica in its own OS process, a fresh
interpreter running `serve_replica` (``python -m
paddle_tpu_torch.inference.replica``) over the coordination store
(`distributed.store.TCPStore`): requests and replies are pickled values
under ``/replica/<rid>/<epoch>/...`` keys, liveness is the store's
``/hb/<rid>`` receipt stamp (a native heartbeat thread), and control
(``swap``, ``stop``) is a polled command key. `kill()` is SIGKILL,
`wedge()` SIGSTOP: a frozen process whose heartbeat thread freezes with
it. The replica process serves on the GPU unless ``device="cpu"`` is
given; without a GPU it raises and exits non-zero.

Streams over the store: the request is ``("__generate__", prompt,
max_new, timeout, committed, wire, sampling, adapter)`` on the
``req/<seq>`` channel; the replica answers ``("gen-admit",
generation)`` on ``res/<seq>`` at admission, then writes chunked token
frames ``("tok", [ids])`` and one terminal ``("end", status, kind, msg,
det[, spans])`` under ``genres/<seq>/<i>``. The client's cancel is a
``gencancel/<seq>`` key that the replica's frame pump reads every round,
so an abandoned stream frees its KV blocks within a round.

Tracing (obs.trace): the caller's trace context rides every request
(three plain values); the replica process records ``replica.infer`` (or
``replica.generate``) and its pool's spans under it, and ships the
trace's spans back with the reply, which the caller's flight recorder
ingests: one merged record across processes.

`LocalHeartbeats` has the slice of the coordination store's surface
that `distributed.store.Watchdog` reads (``keys("/hb/")`` and
``heartbeat_age``), so the router runs the real watchdog loop over
in-process replicas; over process replicas it reads the store itself.
"""
from __future__ import annotations

import threading
import time
import weakref

from ..obs import flight as _flight
from ..obs import trace as _otrace
from .serving import (DETERMINISTIC_ERRORS, Deadline, DeadlineExceeded,
                      PoolClosed, ServingError, ServingPool)

__all__ = ["ReplicaError", "ReplicaDead", "LocalHeartbeats", "LocalReplica",
           "SubprocessReplica", "serve_replica"]


class ReplicaError(ServingError):
    """Replica-level (transport or lifecycle) failure."""


class ReplicaDead(ReplicaError):
    """The replica is gone (a crash, a torn-down pool): the attempt may or
    may not have run. The router fails idempotent requests over and
    surfaces `RequestFailed` otherwise."""

    _trace_postmortem = True


class LocalHeartbeats:
    """In-process stand-in for the coordination store's ``/hb/`` keys:
    the surface `Watchdog` reads, with monotonic receipt stamps."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._stamps = {}

    def beat(self, name):
        with self._lock:
            self._stamps[name] = self._clock()

    def remove(self, name):
        """A retired member leaves the keyspace (the watchdog stops
        watching it instead of flagging a stale stamp forever)."""
        with self._lock:
            self._stamps.pop(name, None)

    def keys(self, prefix=""):
        with self._lock:
            names = list(self._stamps)
        return [k for k in (f"/hb/{n}" for n in names)
                if k.startswith(prefix)]

    def heartbeat_age(self, name):
        with self._lock:
            stamp = self._stamps.get(name)
        return None if stamp is None else self._clock() - stamp


class _LocalStream:
    """Pump-contract wrapper over an in-process `SequenceStream` that makes
    a fault injected into a `LocalReplica` look like a process fault: a
    wedged replica stops yielding (``("empty", None)``), a killed one ends
    the stream with `ReplicaDead`."""

    def __init__(self, replica, inner):
        self._rep = replica
        self._inner = inner
        self.id = inner.id
        self.deadline = inner.deadline

    @property
    def tokens(self):
        return self._inner.tokens

    @property
    def status(self):
        return self._inner.status

    def cancel(self):
        self._inner.cancel()

    def poll(self, timeout=None):
        rep = self._rep
        if rep._wedged and not rep._killed:
            # frozen: nothing flows; wait on the resume event so an
            # unwedge delivers promptly
            rep._resume.wait(timeout if timeout and timeout > 0 else 0)
            with rep._lock:
                if rep._wedged and not rep._killed:
                    return ("empty", None)
        if rep._killed:
            # a killed process's unsent tokens are lost, even those its
            # engine decoded ahead: resume from what the client got
            return ("end", "failed", ReplicaDead(
                f"replica {rep.rid} went away mid-generation"))
        kind = self._inner.poll(timeout)
        if kind[0] == "end" and kind[1] != "completed" and rep._killed:
            return ("end", "failed", ReplicaDead(
                f"replica {rep.rid} went away mid-generation"))
        return kind


class LocalReplica:
    """One serving replica in this process.

    `predictor_factory(model_dir)` builds the pool's base member (any
    object with `clone()`, `reset_handles()` and `run()`); it runs again
    on `swap()` and `restart()`. `decode_factory(generation) ->
    DecodeEngine`, when given, gives every pool this replica builds a
    decode engine of that weight generation, which `submit_generate`
    serves."""

    def __init__(self, rid, predictor_factory, model_dir=None, generation=0,
                 *, pool_size=1, pool_kwargs=None, heartbeat=None,
                 heartbeat_interval=0.05, decode_factory=None,
                 clock=time.monotonic):
        self.rid = str(rid)
        self.model_dir = model_dir
        self.generation = int(generation)
        self._factory = predictor_factory
        self._decode_factory = decode_factory
        self._pool_size = int(pool_size)
        self._pool_kwargs = dict(pool_kwargs or {})
        self._clock = clock
        self._lock = threading.Lock()
        self._killed = False
        self._wedged = False
        self._blocked = 0            # callers a wedge holds
        self._entering = 0           # callers inside the pool (swap gate)
        self._swapping = False
        self._resume = threading.Event()
        self._resume.set()
        self.restarts = 0
        self.swaps = 0
        self._hb = heartbeat if heartbeat is not None else LocalHeartbeats(
            clock=clock)
        self._hb_interval = float(heartbeat_interval)
        self._pool = self._make_pool(predictor_factory(model_dir))
        self._beat_stop = self._start_beat_thread()

    def _start_beat_thread(self):
        """A beat loop bound to its own stop event, so a restart never
        races the dying loop."""
        stop = threading.Event()
        threading.Thread(target=self._beat_loop, args=(stop,),
                         name=f"replica-{self.rid}-heartbeat",
                         daemon=True).start()
        return stop

    def _make_pool(self, base, generation=None):
        kw = dict(self._pool_kwargs)
        kw.setdefault("max_queue_depth", 16)
        if self._decode_factory is not None and "decode_engine" not in kw:
            gen = self.generation if generation is None else int(generation)
            kw["decode_engine"] = self._decode_factory(gen)
        return ServingPool(predictor=base, size=self._pool_size,
                           clock=self._clock, **kw)

    # -- liveness ----------------------------------------------------------
    def _beat_loop(self, stop):
        # beat first: a restarted replica's stamp is fresh at once
        while True:
            with self._lock:
                if self._killed:
                    return
                wedged = self._wedged
            if not wedged:      # a frozen process does not heartbeat
                self._hb.beat(self.rid)
            if stop.wait(self._hb_interval):
                return

    def beat_age(self):
        return self._hb.heartbeat_age(self.rid)

    # -- serving -----------------------------------------------------------
    def _hold_if_wedged(self, dl, what):
        if not self._wedged:
            return
        with self._lock:
            wedged = self._wedged
            if wedged:
                self._blocked += 1
        if not wedged:
            return
        try:
            self._resume.wait(dl.remaining())
        finally:
            with self._lock:
                self._blocked -= 1
        with self._lock:
            if self._wedged and not self._killed:
                raise DeadlineExceeded(f"replica {self.rid} wedged past the "
                                       f"{what} deadline")

    def _enter(self, dl, what):
        """Pass the swap gate: (generation, pool) read together."""
        while True:
            with self._lock:
                if self._killed:
                    raise ReplicaDead(f"replica {self.rid} is dead")
                if not self._swapping:
                    self._entering += 1
                    return self.generation, self._pool
            if dl.expired():
                raise DeadlineExceeded(
                    f"replica {self.rid} held the {what} at its swap gate "
                    f"past the deadline")
            time.sleep(0.002)

    def _leave(self):
        with self._lock:
            self._entering -= 1

    def infer(self, feeds, timeout=None):
        """Serve one request; a pool torn down by the replica's death
        raises `ReplicaDead` (the router's failover trigger)."""
        return self.infer_stamped(feeds, timeout=timeout)[0]

    def infer_stamped(self, feeds, timeout=None):
        """``(outputs, generation)`` with `generation` exactly the weights
        the request ran under: entry is gated against a concurrent
        `swap()`, which waits out every caller already inside."""
        dl = Deadline(timeout, clock=self._clock)
        self._hold_if_wedged(dl, "attempt")
        gen, pool = self._enter(dl, "request")
        try:
            return pool.infer(feeds, timeout=dl.remaining()), gen
        except PoolClosed as e:
            raise ReplicaDead(f"replica {self.rid} went away mid-request "
                              f"(in-flight work cancelled)") from e
        finally:
            self._leave()

    def submit_generate(self, prompt_ids, max_new_tokens, timeout=None, *,
                        resume_committed=None, sampling=None, adapter=None,
                        admission_timeout=None):
        """Admit one generation on this replica's decode engine; returns
        ``(stream, generation)``, the stamp read at admission behind the
        same swap gate as `infer_stamped`. `admission_timeout` bounds the
        gate wait apart from the generation's deadline, so a frozen
        replica sheds the attempt, not the stream."""
        adm = Deadline(admission_timeout if admission_timeout is not None
                       else timeout, clock=self._clock)
        self._hold_if_wedged(adm, "admission")
        gen, pool = self._enter(adm, "stream")
        try:
            inner = pool.submit_generate(prompt_ids, max_new_tokens,
                                         timeout=timeout,
                                         resume_committed=resume_committed,
                                         sampling=sampling, adapter=adapter)
            return _LocalStream(self, inner), gen
        except PoolClosed as e:
            raise ReplicaDead(f"replica {self.rid} went away at stream "
                              f"admission") from e
        finally:
            self._leave()

    def queue_depth(self):
        """Routing load: the pool's queued + retry-pending + in-flight
        requests, plus callers a wedge holds."""
        with self._lock:
            if self._killed or self._pool is None:
                return 0
            pool, blocked = self._pool, self._blocked
        return pool.load() + blocked

    def drained(self):
        """No caller inside the pool and nothing queued."""
        with self._lock:
            entering = self._entering
        return entering == 0 and self.queue_depth() == 0

    def probe(self, feeds=None, timeout=None):
        """Health probe: an inference over `feeds` when given, else a
        liveness check; raises a typed error when unhealthy."""
        if feeds is not None:
            return self.infer(feeds, timeout=timeout)
        with self._lock:
            if self._killed:
                raise ReplicaDead(f"replica {self.rid} is dead")
            if self._wedged:
                raise DeadlineExceeded(f"replica {self.rid} is wedged")
        return None

    # -- control plane -----------------------------------------------------
    def swap(self, model_dir, generation):
        """Hot-swap the weights: build the base member from `model_dir`
        (and, with a decode factory, the new generation's engine, before
        the old one is shut: on one GPU two generations' weights are live
        for a moment), `rebase` the pool onto it and install the engine.
        The router drains the replica first; the gate holds out any
        straggler, so no request straddles the cut."""
        base = self._factory(model_dir)
        engine = None
        if self._decode_factory is not None:
            engine = self._decode_factory(int(generation))
        with self._lock:
            if self._killed:
                if engine is not None:
                    engine.shutdown(drain_timeout=0.5)
                raise ReplicaDead(f"replica {self.rid} is dead")
            self._swapping = True
        installed = False
        try:
            while True:           # wait out callers already past the gate
                with self._lock:
                    if self._killed:
                        raise ReplicaDead(
                            f"replica {self.rid} died during weight swap")
                    if self._entering == 0:
                        pool = self._pool
                        break
                time.sleep(0.002)
            try:
                pool.rebase(base)
                if engine is not None:
                    pool.swap_engine(engine)
                installed = True
            except PoolClosed as e:
                raise ReplicaDead(
                    f"replica {self.rid} died during weight swap") from e
            with self._lock:
                if self._killed:
                    raise ReplicaDead(
                        f"replica {self.rid} died during weight swap")
                self.model_dir = model_dir
                self.generation = int(generation)
                self.swaps += 1
        finally:
            if engine is not None and not installed:
                # never orphan the new engine's scheduler and pools
                engine.shutdown(drain_timeout=0.5)
            with self._lock:
                self._swapping = False

    def restart(self, model_dir=None, generation=None):
        """Rebuild the pool from the factory (at the router's committed
        generation) and heartbeat again. Raises if the build fails; the
        router backs off and retries."""
        model_dir = self.model_dir if model_dir is None else model_dir
        gen = self.generation if generation is None else int(generation)
        with self._lock:
            old, self._pool = self._pool, None
        if old is not None:
            # the dead pool's engine goes first: one GPU holds its KV
            # pool and graphs until it is shut
            old.shutdown(drain_timeout=0)
        pool = self._make_pool(self._factory(model_dir), generation=gen)
        with self._lock:
            self._pool = pool
            self._killed = False
            self._wedged = False
            self._resume.set()
            self.model_dir = model_dir
            self.generation = gen
            self.restarts += 1
        if self._beat_stop.is_set():
            self._beat_stop = self._start_beat_thread()
        return self

    # -- fault injection / teardown ----------------------------------------
    def wedge(self):
        """Freeze: heartbeats stop, requests hold until their attempt
        deadline (or a kill). The watchdog must notice."""
        with self._lock:
            self._wedged = True
            self._resume.clear()

    def unwedge(self):
        with self._lock:
            self._wedged = False
            self._resume.set()

    def kill(self):
        """Abrupt death: the heartbeat stops, held callers are released
        with `ReplicaDead`, and the pool is torn down without a drain, so
        its queued and in-flight work fails typed. Idempotent."""
        with self._lock:
            if self._killed:
                return
            self._killed = True
            pool = self._pool
        self._beat_stop.set()
        self._resume.set()
        if pool is not None:
            pool.shutdown(drain_timeout=0)

    def close(self, drain_timeout=5.0):
        """Graceful retirement: drain the pool, stop heartbeating and
        leave the heartbeat keyspace."""
        with self._lock:
            killed, self._killed = self._killed, True
            pool = self._pool
            self._resume.set()
        self._beat_stop.set()
        if pool is not None:
            # a killed pool is shut already; shutdown is idempotent
            pool.shutdown(drain_timeout=0 if killed else drain_timeout)
        if isinstance(self._hb, LocalHeartbeats):
            self._hb.remove(self.rid)

    def stats(self):
        with self._lock:
            pool = self._pool
            snap = {"rid": self.rid, "generation": self.generation,
                    "killed": self._killed, "wedged": self._wedged,
                    "restarts": self.restarts, "swaps": self.swaps}
        snap["pool"] = pool.stats() if pool is not None \
            and not snap["killed"] else None
        return snap


# ---------------------------------------------------------------------------
# process replicas: the store-keyed transport
# ---------------------------------------------------------------------------

def _req_key(rid, epoch, seq):
    return f"/replica/{rid}/{epoch}/req/{seq}"


def _res_key(rid, epoch, seq):
    return f"/replica/{rid}/{epoch}/res/{seq}"


def _ctl_key(rid, epoch, seq):
    return f"/replica/{rid}/{epoch}/ctl/{seq}"


def _ack_key(rid, epoch, seq):
    return f"/replica/{rid}/{epoch}/ack/{seq}"


def _genres_key(rid, epoch, seq, frame):
    return f"/replica/{rid}/{epoch}/genres/{seq}/{frame}"


def _gencancel_key(rid, epoch, seq):
    return f"/replica/{rid}/{epoch}/gencancel/{seq}"


def _load_decode_factory(spec):
    """Resolve a ``module:callable`` decode-factory spec (a callable passes
    through). It is called as ``factory(generation)`` and returns a
    `DecodeEngine`, or None for a replica without one."""
    if callable(spec):
        return spec
    import importlib

    mod, _, attr = str(spec).partition(":")
    if not attr:
        raise ValueError(
            f"decode factory spec must be 'module:callable', got {spec!r}")
    return getattr(importlib.import_module(mod), attr)


def _predictor(prefix, device):
    """A `Predictor` over the artifact at `prefix` on `device` (None: the
    GPU, which raises when there is none)."""
    from . import Config, Predictor

    cfg = Config(prefix)
    if device is not None:
        import torch

        dev = torch.device(device)
        if dev.type == "cpu":
            cfg.disable_gpu()
        else:
            cfg.enable_use_gpu(device_id=dev.index or 0)
    return Predictor(cfg)


def _spans_of(ctx):
    """The wire form of this process's spans of `ctx`'s trace (shipped
    back with a reply), or None when the trace is not recorded."""
    if ctx is None or not ctx.sampled:
        return None
    return [s.to_dict() for s in _flight.recorder().spans_for(ctx.trace_id)]


def serve_replica(rid, port, model_prefix, *, host="127.0.0.1",
                  generation=0, epoch=0, pool_size=1,
                  heartbeat_interval=0.25, poll_interval=0.005,
                  default_timeout=None, decode_factory=None, device=None):
    """A replica process's main loop: serve the requests under
    ``/replica/<rid>/<epoch>/req/*`` with a local `ServingPool` over the
    exported artifact at `model_prefix` on `device` (None: the GPU),
    publish liveness under ``/hb/<rid>`` (a native heartbeat thread, from
    the moment the pool can serve) and the load under
    ``/replica/<rid>/<epoch>/depth``, and obey the ``swap <gen>
    <prefix>`` and ``stop`` commands. Runs until ``stop`` (or until the
    store goes away: the router's watchdog then declares it dead).

    With `decode_factory` (``module:callable``, called as
    ``factory(generation)``) the pool carries that decode engine and the
    loop serves streams too: ``("__generate__", ...)`` requests are
    admitted behind the swap gate, answered with ``("gen-admit",
    generation)`` and pumped as token frames (module docstring); a
    ``gencancel/<seq>`` key cancels the sequence within a pump round.

    Every key is namespaced by the spawn `epoch` (the router's handle
    bumps it per respawn), so a restarted loop never waits behind a
    previous life's consumed sequence numbers."""
    import concurrent.futures
    import pickle

    from ..distributed.store import TCPStore

    store = TCPStore(host, port)
    ep = int(epoch)
    state = {"generation": int(generation), "entering": 0,
             "swapping": False}
    gate = threading.Lock()
    engine = None
    if decode_factory is not None:
        engine = _load_decode_factory(decode_factory)(int(generation))
    pool = ServingPool(predictor=_predictor(model_prefix, device),
                       size=pool_size, default_timeout=default_timeout,
                       decode_engine=engine)
    # a stream holds its executor worker for its whole generation: room
    # for them beside the one-shot workers
    stream_slots = engine.max_active if engine is not None else 0
    ex = concurrent.futures.ThreadPoolExecutor(
        max_workers=pool_size + 2 + stream_slots)
    res_written = []     # (seq, written at): reaped after RES_TTL
    frames_written = []  # (key, written at)

    def _ship_res(seq, payload):
        store.set(_res_key(rid, ep, seq), pickle.dumps(payload))
        res_written.append((seq, time.monotonic()))

    def _enter(dl):
        """The swap gate: the generation read with the entry, or None past
        the deadline."""
        while True:
            with gate:
                if not state["swapping"]:
                    state["entering"] += 1
                    return state["generation"]
            if dl.expired():
                return None
            time.sleep(0.002)

    def _leave():
        with gate:
            state["entering"] -= 1

    def _error_payload(e):
        # the deterministic flag survives the wire, so a malformed request
        # never fails over from a process replica either
        det = isinstance(getattr(e, "cause", None), DETERMINISTIC_ERRORS)
        return ("err", type(e).__name__, str(e), det)

    def _respond(seq, feeds, timeout, wire=None):
        dl = Deadline(timeout)
        # the caller's trace context off the wire: this process's spans
        # carry its trace id and go back with the reply
        ctx = (_otrace.TraceContext.from_wire(wire)
               if wire is not None and _otrace.enabled() else None)
        gen = _enter(dl)
        if gen is None:
            _ship_res(seq, ("err", "DeadlineExceeded",
                            "held at the swap gate past the deadline",
                            False))
            return
        try:
            with _otrace.span_in(
                    "replica.infer", ctx,
                    attrs=None if ctx is None else {"rid": rid,
                                                    "generation": gen}):
                outs = pool.infer(feeds, timeout=dl.remaining())
            payload = ("ok", outs, gen)
        except ServingError as e:
            payload = _error_payload(e)
        except Exception as e:  # noqa: BLE001 — a typed RequestFailed on
            payload = ("err", "RequestFailed",  # the caller's side
                       f"{type(e).__name__}: {e}", False)
        finally:
            _leave()
        spans = _spans_of(ctx)
        _ship_res(seq, payload if spans is None else payload + (spans,))

    def _respond_generate(seq, prompt, max_new, timeout, committed, wire,
                          samp=None, adapter=None):
        dl = Deadline(timeout)
        ctx = (_otrace.TraceContext.from_wire(wire)
               if wire is not None and _otrace.enabled() else None)
        gen = _enter(dl)
        if gen is None:
            _ship_res(seq, ("err", "DeadlineExceeded",
                            "held at the swap gate past the deadline",
                            False))
            return
        try:
            with _otrace.span_in(
                    "replica.generate", ctx,
                    attrs=None if ctx is None else
                    {"rid": rid, "generation": gen,
                     "resume_committed":
                         0 if committed is None else len(committed)}):
                stream = pool.submit_generate(
                    prompt, max_new, timeout=dl.remaining(),
                    resume_committed=committed, sampling=samp,
                    adapter=adapter)
        except ServingError as e:
            spans = _spans_of(ctx)
            payload = _error_payload(e)
            _ship_res(seq, payload if spans is None else payload + (spans,))
            return
        except Exception as e:  # noqa: BLE001 — a typed RequestFailed on
            _ship_res(seq, ("err", "RequestFailed",  # the caller's side
                            f"{type(e).__name__}: {e}", False))
            return
        finally:
            _leave()

        frame = 0
        buf = []
        last_flush = time.monotonic()

        def _flush(terminal=None):
            nonlocal frame, buf, last_flush
            for item in ((("tok", buf),) if buf else ()) + (
                    (terminal,) if terminal is not None else ()):
                key = _genres_key(rid, ep, seq, frame)
                store.set(key, pickle.dumps(item))
                frames_written.append((key, time.monotonic()))
                frame += 1
            buf = []
            last_flush = time.monotonic()

        cancelled = False
        try:
            _ship_res(seq, ("gen-admit", gen))
            while True:
                polled = stream.poll(0.01)
                if polled[0] == "tok":
                    buf.append(int(polled[1]))
                    if len(buf) >= 16:
                        _flush()
                elif polled[0] == "end":
                    _, status, err = polled
                    if status == "completed":
                        payload = ("end", "completed", None, None, False)
                    else:
                        det = isinstance(getattr(err, "cause", None),
                                         DETERMINISTIC_ERRORS)
                        payload = ("end", status,
                                   type(err).__name__ if err is not None
                                   else "RequestFailed",
                                   str(err) if err is not None else "", det)
                    spans = _spans_of(ctx)
                    _flush(terminal=payload if spans is None
                           else payload + (spans,))
                    return
                elif buf and time.monotonic() - last_flush > 0.02:
                    _flush()
                if not cancelled and store.get_nowait(
                        _gencancel_key(rid, ep, seq)) is not None:
                    # the engine evicts the sequence at its next step and
                    # frees the blocks; the pump drains until the
                    # "cancelled" terminal
                    cancelled = True
                    stream.cancel()
        finally:
            store.delete_key(_gencancel_key(rid, ep, seq))

    def _swap(gen, prefix):
        nonlocal engine
        base = _predictor(prefix, device)
        new_engine = None
        if decode_factory is not None:
            new_engine = _load_decode_factory(decode_factory)(gen)
        with gate:
            state["swapping"] = True
        try:
            while True:         # wait out callers already past the gate
                with gate:
                    if state["entering"] == 0:
                        break
                time.sleep(0.002)
            pool.rebase(base)
            if new_engine is not None:
                # the router drained this replica's streams first; a
                # straggler is failed typed by the old engine's shutdown
                pool.swap_engine(new_engine)
                engine = new_engine
            with gate:
                state["generation"] = gen
        finally:
            with gate:
                state["swapping"] = False

    # reply keys a timed-out caller abandoned are reaped after RES_TTL (a
    # caller deletes every key it reads), so wedge and failover traffic
    # cannot grow the store without bound
    RES_TTL = 120.0
    served = ctl_seen = 0
    last_depth = None
    store.start_heartbeat(rid, interval=heartbeat_interval)
    try:
        while True:
            progressed = False
            raw = store.get_nowait(_req_key(rid, ep, served))
            if raw is not None:
                seq, served = served, served + 1
                store.delete_key(_req_key(rid, ep, seq))
                payload = pickle.loads(raw)
                if payload is None:
                    pass    # the caller's tombstone: a burnt sequence number
                elif payload[0] == "__generate__":
                    (_, prompt, max_new, timeout, committed,
                     wire) = payload[:6]
                    samp = payload[6] if len(payload) > 6 else None
                    adapter = payload[7] if len(payload) > 7 else None
                    ex.submit(_respond_generate, seq, prompt, max_new,
                              timeout, committed, wire, samp, adapter)
                else:
                    feeds, timeout = payload[0], payload[1]
                    wire = payload[2] if len(payload) > 2 else None
                    ex.submit(_respond, seq, feeds, timeout, wire)
                progressed = True
            ctl = store.get_nowait(_ctl_key(rid, ep, ctl_seen))
            if ctl is not None:
                seq, ctl_seen = ctl_seen, ctl_seen + 1
                store.delete_key(_ctl_key(rid, ep, seq))
                parts = ctl.decode().split(" ", 2)
                if parts[0] == "stop":
                    store.set(_ack_key(rid, ep, seq), b"ok")
                    return
                if parts[0] == "swap":
                    try:
                        _swap(int(parts[1]), parts[2])
                        store.set(_ack_key(rid, ep, seq), b"ok")
                    except Exception as e:  # noqa: BLE001 — a nack: the
                        # router turns it into SwapFailed and a rollback
                        store.set(_ack_key(rid, ep, seq),
                                  f"err {type(e).__name__}: {e}".encode())
                else:
                    store.set(_ack_key(rid, ep, seq), b"err unknown-command")
                progressed = True
            # the routing load: the pool's load counts the engine's live
            # sequences too, so a replica busy with streams is not idle
            depth = pool.load()
            if depth != last_depth:
                store.set(f"/replica/{rid}/{ep}/depth", str(depth).encode())
                last_depth = depth
            now = time.monotonic()
            while res_written and now - res_written[0][1] > RES_TTL:
                store.delete_key(_res_key(rid, ep, res_written.pop(0)[0]))
            while frames_written and now - frames_written[0][1] > RES_TTL:
                store.delete_key(frames_written.pop(0)[0])
            if not progressed:
                time.sleep(poll_interval)
    finally:
        ex.shutdown(wait=False)
        pool.shutdown(drain_timeout=1.0)
        store.stop_heartbeat()
        store.close()


class _RemoteStream:
    """Client half of the store stream transport: reads the replica
    process's token frames (``genres/<seq>/<frame>``) strictly in order,
    deleting each consumed key, and stays ended after the terminal frame.
    A replica process that dies mid-stream surfaces as ``("end",
    "failed", ReplicaDead)``, which the router's pump reads as "fail
    over". The pump contract of `SequenceStream.poll` / `_LocalStream`."""

    def __init__(self, rep, seq):
        self._rep = rep
        rep._streams.add(self)
        self._epoch = rep._epoch
        self._seq = seq
        self._frame = 0
        self._pending = []   # frame tokens not yet handed to the pump
        self.tokens = []     # every token handed out, in order
        self._ended = False
        self._status = None
        self._error = None
        self._cancelled = False

    @property
    def status(self):
        return self._status

    def cancel(self):
        """Ask the replica process to evict the sequence: one key write,
        seen by its frame pump within a round."""
        if self._cancelled or self._ended:
            return
        self._cancelled = True
        try:
            self._rep._store.set(
                _gencancel_key(self._rep.rid, self._epoch, self._seq), b"1")
        except Exception:  # noqa: BLE001 — store down: the watchdog owns
            pass           # this replica now

    def _key(self):
        return _genres_key(self._rep.rid, self._epoch, self._seq,
                           self._frame)

    def _end(self, status, error):
        self._ended = True
        self._status = status
        self._error = error
        return ("end", status, error)

    def poll(self, timeout=None):
        import pickle

        if self._pending:
            tok = self._pending.pop(0)
            self.tokens.append(tok)
            return ("tok", tok)
        if self._ended:
            return ("end", self._status, self._error)
        dl = Deadline(timeout, clock=self._rep._clock) \
            if timeout is not None and timeout > 0 else None
        store = self._rep._store
        while True:
            try:
                raw = store.get_nowait(self._key())
            except Exception as e:  # noqa: BLE001 — a store fault
                # mid-stream reads as replica death: fail over
                return self._end("failed", ReplicaDead(
                    f"replica {self._rep.rid}: stream transport lost "
                    f"({type(e).__name__}: {e})"))
            if raw is not None:
                store.delete_key(self._key())
                self._frame += 1
                payload = pickle.loads(raw)
                if payload[0] == "tok":
                    self._pending.extend(payload[1])
                    tok = self._pending.pop(0)
                    self.tokens.append(tok)
                    return ("tok", tok)
                # the terminal frame: ("end", status, kind, msg, det[, spans])
                _, status, kind, msg, det = payload[:5]
                if len(payload) > 5 and payload[5]:
                    _flight.recorder().ingest(payload[5])
                return self._end(status, None if status == "completed"
                                 else _typed_error(
                                     kind or "RequestFailed",
                                     f"replica {self._rep.rid}: {msg}",
                                     deterministic=bool(det)))
            proc = self._rep._proc
            if proc is None or proc.poll() is not None:
                # a frame written just before the death is still read:
                # death is declared only when the key is truly absent
                try:
                    raw = store.get_nowait(self._key())
                except Exception:  # noqa: BLE001 — as above
                    raw = None
                if raw is None:
                    return self._end("failed", ReplicaDead(
                        f"replica {self._rep.rid} died mid-stream"))
                continue
            if dl is None or dl.expired():
                return ("empty", None)
            time.sleep(0.003)


class SubprocessReplica:
    """The router-side handle of a replica in its own OS process, a fresh
    interpreter running `serve_replica` (never a fork: CUDA may be live
    in this process). Same contract as `LocalReplica`; its faults are
    real process faults: `kill()` is SIGKILL (the watchdog sees the
    heartbeat stop), `wedge()` SIGSTOP (even the native heartbeat thread
    stops).

    `store` is the coordination store (`distributed.store.TCPStore`) the
    process connects to; `artifact_name` the artifact's name inside a
    (committed) model directory (None: `model_dir` is the prefix itself);
    `decode_factory` a ``module:callable`` the process calls as
    ``factory(generation)`` for its decode engine; `device` where the
    process serves (None: the GPU; ``"cpu"`` on request). Construction
    returns once the process heartbeats, which it does once its pool can
    serve; it raises `ReplicaDead` if the process exits first or stays
    silent past `start_timeout`; `spawned_at` (wall clock) and `spawn_s`
    time the last spawn.

    `queue_depth()`, the routing load, is the larger of the depth the
    process publishes (its pool's load, its engine's live sequences) and
    this handle's own requests and streams in flight: the published depth
    lags a round of the serve loop, and a burst of streams placed on one
    stale reading would all land on one replica."""

    def __init__(self, rid, store, model_dir=None, generation=0, *,
                 pool_size=1, artifact_name=None, start_timeout=60.0,
                 decode_factory=None, device=None, clock=time.monotonic):
        self.rid = str(rid)
        self.model_dir = model_dir
        self.generation = int(generation)
        self._artifact_name = artifact_name
        self._store = store
        self._pool_size = int(pool_size)
        self._decode_factory = decode_factory
        self._device = None if device is None else str(device)
        self._start_timeout = float(start_timeout)
        self._clock = clock
        self._proc = None
        self.spawned_at = self.spawn_s = None
        self._lock = threading.Lock()
        self._inflight = 0              # requests sent, not yet answered
        self._streams = weakref.WeakSet()  # this handle's _RemoteStreams
        self.restarts = 0
        self.swaps = 0
        self._spawn()

    @property
    def pid(self):
        return None if self._proc is None else self._proc.pid

    def _prefix_for(self, model_dir):
        import os

        if self._artifact_name is None:
            return str(model_dir)
        return os.path.join(str(model_dir), self._artifact_name)

    def _spawn(self):
        import os
        import subprocess
        import sys

        # a fresh key-space epoch per life: a respawned loop never waits
        # behind a previous life's consumed sequence numbers
        self._epoch = self._store.add(f"/replica/{self.rid}/epoch", 1)
        argv = [sys.executable, "-m", "paddle_tpu_torch.inference.replica",
                "--rid", self.rid, "--host", str(self._store.host),
                "--port", str(self._store.port),
                "--model", self._prefix_for(self.model_dir),
                "--generation", str(self.generation),
                "--epoch", str(self._epoch),
                "--pool-size", str(self._pool_size)]
        if self._decode_factory is not None:
            argv += ["--decode-factory", str(self._decode_factory)]
        if self._device is not None:
            argv += ["--device", self._device]
        # the child imports this very package, wherever the caller's
        # working directory is
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        self.spawned_at = time.time()
        self._proc = subprocess.Popen(argv, env=env)
        dl = Deadline(self._start_timeout, clock=self._clock)
        while True:
            age = self._store.heartbeat_age(self.rid)
            if age is not None and age < 2.0:
                self.spawn_s = time.time() - self.spawned_at
                return
            if self._proc.poll() is not None:
                raise ReplicaDead(
                    f"replica {self.rid} process exited with "
                    f"{self._proc.returncode} before its first heartbeat")
            if dl.expired():
                self._proc.kill()
                self._proc.wait()
                raise ReplicaDead(
                    f"replica {self.rid} never heartbeat within "
                    f"{self._start_timeout}s of spawn")
            time.sleep(0.05)

    def _send(self, blob, what):
        """Allocate the next sequence number and write the request; returns
        the sequence number. The payload is pickled before the number is
        taken: the serve loop consumes numbers strictly in order, so a
        number taken and never written would strand it."""
        import pickle

        try:
            seq = self._store.add(f"/replica/{self.rid}/{self._epoch}/seq",
                                  1) - 1
        except Exception as e:
            raise ReplicaError(
                f"replica {self.rid}: sequence allocation failed "
                f"({type(e).__name__}: {e})") from e
        try:
            self._store.set(_req_key(self.rid, self._epoch, seq), blob)
        except Exception as e:
            # the number is burnt: a tombstone lets the loop step over it
            try:
                self._store.set(_req_key(self.rid, self._epoch, seq),
                                pickle.dumps(None))
            except Exception:  # noqa: BLE001 — store down: the watchdog
                pass           # owns this replica now
            raise ReplicaError(
                f"replica {self.rid}: {what} send failed "
                f"({type(e).__name__}: {e})") from e
        return seq

    @staticmethod
    def _raise_error(payload, rid):
        kind, msg = payload[1], payload[2]
        deterministic = bool(payload[3]) if len(payload) > 3 else False
        if len(payload) > 4 and payload[4]:
            _flight.recorder().ingest(payload[4])
        raise _typed_error(kind, f"replica {rid}: {msg}",
                           deterministic=deterministic)

    # -- serving -----------------------------------------------------------
    def infer(self, feeds, timeout=None):
        return self.infer_stamped(feeds, timeout=timeout)[0]

    def infer_stamped(self, feeds, timeout=None):
        """``(outputs, generation)``: the process reads the generation
        behind its own swap gate with the execution, so the stamp is
        exact around a racing swap. The caller's trace context rides the
        request; the process's spans come back with the reply."""
        import pickle

        if self._proc is None or self._proc.poll() is not None:
            raise ReplicaDead(f"replica {self.rid} process is gone")
        blob = pickle.dumps((feeds, timeout, _otrace.current_wire()))
        with self._lock:
            self._inflight += 1
        try:
            return self._await_reply(self._send(blob, "request"), timeout)
        finally:
            with self._lock:
                self._inflight -= 1

    def _await_reply(self, seq, timeout):
        import pickle

        dl = Deadline(timeout, clock=self._clock)
        key = _res_key(self.rid, self._epoch, seq)
        while True:
            raw = self._store.get_nowait(key)
            if raw is not None:
                self._store.delete_key(key)
                payload = pickle.loads(raw)
                if payload[0] == "ok":
                    if len(payload) > 3 and payload[3]:
                        # the process's spans (they carry its pid)
                        _flight.recorder().ingest(payload[3])
                    return payload[1], payload[2]
                self._raise_error(payload, self.rid)
            if self._proc.poll() is not None:
                raise ReplicaDead(
                    f"replica {self.rid} died mid-request "
                    f"(exit {self._proc.returncode})")
            if dl.expired():
                # abandoned: a reply that lands later is reaped by the
                # serve loop's RES_TTL sweep
                self._store.delete_key(key)
                raise DeadlineExceeded(
                    f"replica {self.rid} gave no answer within the "
                    f"attempt deadline (wedged process?)")
            time.sleep(0.003)

    def submit_generate(self, prompt_ids, max_new_tokens, timeout=None, *,
                        resume_committed=None, sampling=None, adapter=None,
                        admission_timeout=None):
        """``(stream, generation)``: send the prompt and wait for the
        process's swap-gated admission, stamped ``("gen-admit", gen)``;
        the tokens then flow as frames through the returned
        `_RemoteStream`. `admission_timeout` bounds only the wait for the
        stamp; `timeout` rides the wire as the engine's deadline.
        `sampling` crosses in its dict form, `adapter` as its name."""
        import pickle

        import numpy as np

        if self._proc is None or self._proc.poll() is not None:
            raise ReplicaDead(f"replica {self.rid} process is gone")
        committed = None if resume_committed is None else \
            [int(t) for t in resume_committed]
        samp_wire = sampling.to_dict() if hasattr(sampling, "to_dict") \
            else sampling
        blob = pickle.dumps((
            "__generate__", np.asarray(prompt_ids), int(max_new_tokens),
            timeout, committed, _otrace.current_wire(), samp_wire,
            adapter))
        with self._lock:
            self._inflight += 1
        try:
            return self._await_admission(self._send(blob, "stream"),
                                         timeout, admission_timeout)
        finally:
            with self._lock:
                self._inflight -= 1

    def _await_admission(self, seq, timeout, admission_timeout):
        import pickle

        adm = Deadline(admission_timeout if admission_timeout is not None
                       else timeout, clock=self._clock)
        key = _res_key(self.rid, self._epoch, seq)
        while True:
            raw = self._store.get_nowait(key)
            if raw is not None:
                self._store.delete_key(key)
                payload = pickle.loads(raw)
                if payload[0] == "gen-admit":
                    return _RemoteStream(self, seq), int(payload[1])
                self._raise_error(payload, self.rid)
            if self._proc.poll() is not None:
                raise ReplicaDead(
                    f"replica {self.rid} died before admitting the "
                    f"stream (exit {self._proc.returncode})")
            if adm.expired():
                # abandoned at admission: the cancel key makes a late
                # admission evict the sequence instead of generating for
                # nobody
                try:
                    self._store.set(
                        _gencancel_key(self.rid, self._epoch, seq), b"1")
                except Exception:  # noqa: BLE001 — as above
                    pass
                self._store.delete_key(key)
                raise DeadlineExceeded(
                    f"replica {self.rid} did not admit the stream "
                    f"within the attempt deadline (wedged process?)")
            time.sleep(0.003)

    def queue_depth(self):
        with self._lock:
            own = self._inflight
        own += sum(1 for st in list(self._streams)
                   if st._epoch == self._epoch and not st._ended)
        try:
            raw = self._store.get_nowait(
                f"/replica/{self.rid}/{self._epoch}/depth")
            return max(own, int(raw) if raw is not None else 0)
        except Exception:  # noqa: BLE001 — the load signal degrades on a
            return own     # store fault; routing goes on

    def drained(self):
        return self.queue_depth() == 0

    def beat_age(self):
        return self._store.heartbeat_age(self.rid)

    def probe(self, feeds=None, timeout=None):
        if feeds is not None:
            return self.infer(feeds, timeout=timeout)
        if self._proc is None or self._proc.poll() is not None:
            raise ReplicaDead(f"replica {self.rid} process is gone")
        age = self.beat_age()
        if age is None or age > self._start_timeout:
            raise ReplicaDead(f"replica {self.rid} has no fresh heartbeat")
        return None

    # -- control plane -----------------------------------------------------
    def _control(self, command, timeout=30.0):
        seq = self._store.add(
            f"/replica/{self.rid}/{self._epoch}/ctl_seq", 1) - 1
        self._store.set(_ctl_key(self.rid, self._epoch, seq),
                        command.encode())
        dl = Deadline(timeout, clock=self._clock)
        key = _ack_key(self.rid, self._epoch, seq)
        while True:
            raw = self._store.get_nowait(key)
            if raw is not None:
                self._store.delete_key(key)
                return raw.decode()
            if self._proc is None or self._proc.poll() is not None:
                raise ReplicaDead(
                    f"replica {self.rid} died before acknowledging "
                    f"{command.split()[0]!r}")
            if dl.expired():
                raise ReplicaError(
                    f"replica {self.rid} did not acknowledge "
                    f"{command.split()[0]!r} within {timeout}s")
            time.sleep(0.01)

    def swap(self, model_dir, generation):
        ack = self._control(
            f"swap {int(generation)} {self._prefix_for(model_dir)}",
            timeout=max(30.0, self._start_timeout))
        if ack != "ok":
            raise ReplicaError(
                f"replica {self.rid} refused the weight swap: {ack}")
        self.model_dir = model_dir
        self.generation = int(generation)
        self.swaps += 1

    def restart(self, model_dir=None, generation=None):
        self.kill()
        if model_dir is not None:
            self.model_dir = model_dir
        if generation is not None:
            self.generation = int(generation)
        self._store.delete_key(f"/hb/{self.rid}")
        self._spawn()
        self.restarts += 1
        return self

    # -- fault injection / teardown ----------------------------------------
    def kill(self):
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()

    def wedge(self):
        import signal

        if self._proc is not None and self._proc.poll() is None:
            self._proc.send_signal(signal.SIGSTOP)

    def unwedge(self):
        import signal

        if self._proc is not None and self._proc.poll() is None:
            self._proc.send_signal(signal.SIGCONT)

    def close(self, drain_timeout=5.0):
        try:
            if self._proc is not None and self._proc.poll() is None:
                self._control("stop", timeout=drain_timeout)
                self._proc.wait(timeout=drain_timeout)
        except Exception:  # noqa: BLE001 — a graceful stop that fails
            self.kill()    # ends in SIGKILL
        self._store.delete_key(f"/hb/{self.rid}")

    def stats(self):
        return {"rid": self.rid, "generation": self.generation,
                "killed": self._proc is None or self._proc.poll() is not None,
                "wedged": False, "restarts": self.restarts,
                "swaps": self.swaps, "pool": None}


def _typed_error(kind, msg, deterministic=False):
    from . import serving

    cls = {
        "DeadlineExceeded": serving.DeadlineExceeded,
        "Overloaded": serving.Overloaded,
        "PoolClosed": ReplicaDead,      # the replica's pool going away is
        "ReplicaDead": ReplicaDead,     # replica death from out here
        "RequestFailed": serving.RequestFailed,
    }.get(kind, serving.RequestFailed)
    err = cls(msg)
    if deterministic and cls is serving.RequestFailed:
        # the deterministic marker the wire stripped: the router keys
        # "never fail over a malformed request" off the cause's type
        err.cause = ValueError(msg)
    return err


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="a serving-tier replica process (serve_replica)")
    ap.add_argument("--rid", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--model", required=True,
                    help="exported artifact prefix (jit.save)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--generation", type=int, default=0)
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--pool-size", type=int, default=1)
    ap.add_argument("--decode-factory", default=None,
                    help="module:callable building the decode engine "
                         "(factory(generation) -> DecodeEngine); enables "
                         "streams on this replica")
    ap.add_argument("--device", default=None,
                    help="where the pool serves (default: the GPU, which "
                         "must be present; 'cpu' on request)")
    args = ap.parse_args(argv)
    serve_replica(args.rid, args.port, args.model, host=args.host,
                  generation=args.generation, epoch=args.epoch,
                  pool_size=args.pool_size,
                  decode_factory=args.decode_factory, device=args.device)


if __name__ == "__main__":
    _main()
