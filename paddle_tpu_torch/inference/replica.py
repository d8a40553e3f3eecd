"""One member of the serving tier (counterpart of
paddle_tpu/inference/replica.py): a replica is a `ServingPool` plus a
liveness heartbeat plus a control surface (drain, weight swap, restart),
behind the handle contract `ServingRouter` speaks.

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

`LocalHeartbeats` has the slice of the coordination store's surface
that `distributed.store.Watchdog` reads (``keys("/hb/")`` and
``heartbeat_age``), so the router runs the real watchdog loop over
in-process replicas. `SubprocessReplica` and `serve_replica` run over
the native coordination-store daemon and come with the subprocess-replica
slice.
"""
from __future__ import annotations

import threading
import time

from .serving import (Deadline, DeadlineExceeded, PoolClosed, ServingError,
                      ServingPool)

__all__ = ["ReplicaError", "ReplicaDead", "LocalHeartbeats", "LocalReplica",
           "SubprocessReplica", "serve_replica"]

#: the slice that ports process replicas
SUBPROCESS_SLICE = ("the subprocess-replica slice (SubprocessReplica and "
                    "serve_replica over the TCPStore coordination daemon)")


class ReplicaError(ServingError):
    """Replica-level (transport or lifecycle) failure."""


class ReplicaDead(ReplicaError):
    """The replica is gone (a crash, a torn-down pool): the attempt may or
    may not have run. The router fails idempotent requests over and
    surfaces `RequestFailed` otherwise."""


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


class SubprocessReplica:
    """A replica in its own OS process, over the coordination store: not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"SubprocessReplica is not ported to paddle_tpu_torch yet; it "
            f"comes with {SUBPROCESS_SLICE}. Use LocalReplica")


def serve_replica(*args, **kwargs):
    """The replica process's main loop: not ported yet."""
    raise NotImplementedError(
        f"serve_replica is not ported to paddle_tpu_torch yet; it comes "
        f"with {SUBPROCESS_SLICE}")
