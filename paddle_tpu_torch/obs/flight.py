"""The always-on flight recorder (counterpart of
paddle_tpu/obs/flight.py).

Aggregate telemetry (obs.metrics) answers "how slow is the p99";
it cannot answer "WHICH request blew it and WHERE". The flight
recorder keeps the per-request causal record — finished trace spans
(obs.trace) — in memory at all times, cheaply enough to leave on in
production:

* **Per-thread ring buffers** — a finished span is appended to the
  RECORDING thread's own bounded ring (`PADDLE_TPU_TRACE_RING` spans,
  default 512): owner-thread-only writes, no lock, no allocation beyond
  the span itself. Memory is bounded in SPANS, not bytes — sizing is
  ``threads x ring x ~200B``. The recorder's lock guards only the ring
  REGISTRY (first record per thread) and the postmortem table below —
  never an append.

* **Postmortem retention** — a typed serving failure on a traced
  request *pins* its trace (`pin()`): the trace's spans are copied out
  of the rings immediately and every span that finishes later for the
  same trace id is appended too, so the causal record survives ring
  wrap long after the failure. Bounded FIFO
  (`PADDLE_TPU_TRACE_POSTMORTEM` traces, default 64).

* **Cross-process merge** — spans recorded in another process (a
  `SubprocessReplica` piggybacks its spans onto the reply wire) are
  `ingest()`-ed here carrying their original pid/thread, so
  `spans_for(trace_id)` — and the `/traces/<id>` endpoint (obs.http) —
  returns ONE merged causal record for a request that hopped processes.

Readers (`spans_for` / `traces` / the HTTP endpoint / trace_dump) take
best-effort snapshots of the rings: under CPython's GIL a slot read
races at worst against one in-place overwrite, which drops or
duplicates a span in the VIEW, never corrupts the record — the same
telemetry tolerance obs.metrics documents for its unlocked counters.

Spans are host-side only: recording one touches no device, so a span may
wrap a step that launches kernels or replays a CUDA graph.
"""
from __future__ import annotations

import collections
import os
import threading
import time


__all__ = ["Span", "FlightRecorder", "recorder", "DEFAULT_RING_SPANS",
           "DEFAULT_POSTMORTEM_TRACES"]

DEFAULT_RING_SPANS = 512
DEFAULT_POSTMORTEM_TRACES = 64

# perf_counter -> wall-clock anchor: spans time themselves with the
# monotonic perf counter and are STAMPED into the epoch domain when
# finished, so spans from different processes merge on one time axis
_ANCHOR_WALL = time.time()
_ANCHOR_PERF = time.perf_counter()

# getpid() is a syscall (tens of µs under some kernels): cache it
# per process; refreshed after fork so a forked worker stamps its own pid
_PID = os.getpid()


def _refresh_pid():
    global _PID
    _PID = os.getpid()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refresh_pid)


def wall_of(perf_t):
    """Epoch seconds for a perf_counter reading (this process)."""
    return _ANCHOR_WALL + (perf_t - _ANCHOR_PERF)


class Span:
    """One finished (or being-finished) trace span. Times are epoch
    seconds (see the anchor above); ids are ints rendered as 16-hex on
    the wire."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "attrs", "status", "error", "pid", "thread")

    def __init__(self, trace_id, span_id, parent_id, name, t0, t1,
                 attrs=None, status="ok", error=None, pid=None,
                 thread=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs
        self.status = status
        self.error = error
        self.pid = pid if pid is not None else _PID
        self.thread = thread

    def to_dict(self):
        return {
            "trace_id": f"{self.trace_id:016x}",
            "span_id": f"{self.span_id:016x}",
            "parent_id": (None if self.parent_id is None
                          else f"{self.parent_id:016x}"),
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "duration_s": self.t1 - self.t0,
            "attrs": self.attrs or {},
            "status": self.status,
            "error": self.error,
            "pid": self.pid,
            "thread": self.thread,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            int(d["trace_id"], 16), int(d["span_id"], 16),
            None if d.get("parent_id") is None
            else int(d["parent_id"], 16),
            d["name"], float(d["t0"]), float(d["t1"]),
            attrs=dict(d.get("attrs") or {}) or None,
            status=d.get("status", "ok"), error=d.get("error"),
            pid=d.get("pid"), thread=d.get("thread"))

    def __repr__(self):
        return (f"Span({self.name!r} trace={self.trace_id:016x} "
                f"span={self.span_id:016x} {self.status} "
                f"{(self.t1 - self.t0) * 1e3:.3f}ms)")


class _Ring:
    """Fixed-capacity span ring owned by ONE writer thread. `slots` is
    preallocated; the writer only ever assigns one slot and bumps `n` —
    no lock, no resize, no allocation. `owner` weakly references the
    writer thread so the registry can retire rings of dead threads."""

    __slots__ = ("slots", "cap", "n", "thread_name", "owner")

    def __init__(self, cap, thread_name, owner=None):
        self.cap = cap
        self.slots = [None] * cap
        self.n = 0
        self.thread_name = thread_name
        self.owner = owner

    def owner_dead(self):
        if self.owner is None:
            return False
        t = self.owner()
        return t is None or not t.is_alive()

    def append(self, span):
        self.slots[self.n % self.cap] = span
        self.n += 1

    def snapshot(self):
        """Best-effort copy, oldest first (see module docstring)."""
        n = self.n
        items = list(self.slots)    # one pass under the GIL
        if n <= self.cap:
            return [s for s in items[:n] if s is not None]
        cut = n % self.cap
        return [s for s in items[cut:] + items[:cut] if s is not None]


class FlightRecorder:
    """Process-wide (or private) span store: per-thread rings plus the
    pinned postmortem table. One default instance (`recorder()`) backs
    obs.trace and the `/traces` endpoint."""

    def __init__(self, ring_spans=None, max_postmortems=None):
        if ring_spans is None:
            ring_spans = int(os.environ.get(
                "PADDLE_TPU_TRACE_RING", str(DEFAULT_RING_SPANS)))
        if max_postmortems is None:
            max_postmortems = int(os.environ.get(
                "PADDLE_TPU_TRACE_POSTMORTEM",
                str(DEFAULT_POSTMORTEM_TRACES)))
        if ring_spans < 1 or max_postmortems < 1:
            raise ValueError("ring_spans / max_postmortems must be >= 1")
        self.ring_spans = ring_spans
        self.max_postmortems = max_postmortems
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._rings = []            # LIVE threads' rings
        # rings whose writer thread exited keep their recent history
        # for a while (a retired pool worker's last spans must survive
        # to the next scrape) but are BOUNDED: short-lived request
        # threads on a long-running server must not grow memory forever
        self._retired = collections.deque(
            maxlen=int(os.environ.get("PADDLE_TPU_TRACE_RETIRED_RINGS",
                                      "16")))
        self._foreign = []          # ingested cross-process spans
        self._pinned = {}           # trace_id -> postmortem record
        self._pin_order = collections.deque()
        self.recorded = 0           # unlocked telemetry counters
        self.dropped_wraps = 0

    # -- hot path ----------------------------------------------------------
    def record(self, span):
        """Append one finished span to the calling thread's ring. Lock
        free except the once-per-thread ring registration; the pinned
        lookup is one dict membership test."""
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            import weakref

            t = threading.current_thread()
            ring = _Ring(self.ring_spans, t.name, owner=weakref.ref(t))
            self._tls.ring = ring
            with self._lock:
                # once-per-thread registration doubles as the sweep
                # point: dead threads' rings move to the bounded
                # retired deque (FIFO) instead of accumulating
                dead = [r for r in self._rings if r.owner_dead()]
                for r in dead:
                    self._rings.remove(r)
                    self._retired.append(r)
                self._rings.append(ring)
        if ring.n >= ring.cap:
            self.dropped_wraps += 1     # a slot is being overwritten
        ring.append(span)
        self.recorded += 1
        if span.trace_id in self._pinned:   # racy read: a pin() racing
            # this record at worst re-copies the span from the ring
            with self._lock:
                self._pin_append_locked(span)

    @staticmethod
    def _span_key(s):
        return (s.pid, s.span_id)

    def _pin_append_locked(self, span):
        rec = self._pinned.get(span.trace_id)
        if rec is not None and self._span_key(span) not in rec["keys"]:
            rec["keys"].add(self._span_key(span))
            rec["spans"].append(span)

    def ingest(self, span_dicts):
        """Merge spans recorded in ANOTHER process (wire dicts) into
        this recorder under their original pid/thread identity. Keyed
        dedup on (pid, span_id): a replica re-ships its full per-trace
        history on every reply (retries, failovers), so re-ingested
        spans must not duplicate in the foreign ring or pinned
        records."""
        spans = [Span.from_dict(d) for d in span_dicts]
        n = 0
        with self._lock:
            ring = self._foreign_ring_locked()
            have = {self._span_key(s) for s in ring.snapshot()}
            for s in spans:
                if self._span_key(s) in have:
                    continue
                have.add(self._span_key(s))
                ring.append(s)
                self._pin_append_locked(s)
                n += 1
        return n

    def _foreign_ring_locked(self):
        if not self._foreign:
            self._foreign.append(_Ring(self.ring_spans, "<foreign>"))
        return self._foreign[0]

    # -- postmortem --------------------------------------------------------
    def pin(self, trace_id, reason=""):
        """Retain `trace_id`'s causal record past ring wrap: copy its
        spans out of the rings now and keep appending later-finishing
        spans. Idempotent per trace (first reason wins; repeats count).
        An already-pinned trace takes the FAST path — no ring scan:
        `record()` is appending its later spans anyway, and a deadline
        storm must not pay O(rings x cap) per failure twice over
        (construction-time note_failure + fail-time pin_failure)."""
        with self._lock:
            rec = self._pinned.get(trace_id)
            if rec is not None:
                rec["count"] += 1
                return rec
        spans = self.spans_for(trace_id, pinned=False)
        with self._lock:
            rec = self._pinned.get(trace_id)
            if rec is not None:         # lost the pin race: merge ours
                rec["count"] += 1
                for s in spans:
                    if self._span_key(s) not in rec["keys"]:
                        rec["keys"].add(self._span_key(s))
                        rec["spans"].append(s)
                return rec
            rec = {"trace_id": trace_id, "reason": str(reason),
                   "at": time.time(),
                   "count": 1, "spans": list(spans),
                   "keys": {self._span_key(s) for s in spans}}
            self._pinned[trace_id] = rec
            self._pin_order.append(trace_id)
            while len(self._pin_order) > self.max_postmortems:
                old = self._pin_order.popleft()
                self._pinned.pop(old, None)
            return rec

    def unpin(self, trace_id):
        """Release a retained trace (the request recovered after all:
        a failover attempt's typed error pinned it, then a later
        attempt succeeded). The spans stay in the rings; only the
        retention pin is dropped."""
        with self._lock:
            if self._pinned.pop(trace_id, None) is not None:
                try:
                    self._pin_order.remove(trace_id)
                except ValueError:
                    pass

    def postmortems(self):
        """[(trace_id, reason, span_count)] newest-last snapshot."""
        with self._lock:
            return [(tid, self._pinned[tid]["reason"],
                     len(self._pinned[tid]["spans"]))
                    for tid in self._pin_order if tid in self._pinned]

    def postmortem_ids(self):
        with self._lock:
            return set(self._pinned)

    # -- queries -----------------------------------------------------------
    def _all_rings(self):
        with self._lock:
            return (list(self._rings) + list(self._retired)
                    + list(self._foreign))

    def spans_for(self, trace_id, pinned=True):
        """Every recorded span of one trace (rings + postmortem when
        `pinned`), merged across threads and processes, sorted by start
        time."""
        if isinstance(trace_id, str):
            trace_id = int(trace_id, 16)
        seen = {}
        for ring in self._all_rings():
            for s in ring.snapshot():
                if s.trace_id == trace_id:
                    seen[(s.pid, s.span_id)] = s
        if pinned:
            with self._lock:
                rec = self._pinned.get(trace_id)
                spans = list(rec["spans"]) if rec is not None else []
            for s in spans:
                seen[(s.pid, s.span_id)] = s
        return sorted(seen.values(), key=lambda s: (s.t0, s.t1))

    def traces(self, limit=50):
        """Recent traces, newest first: ``[{"trace_id", "root", "spans",
        "t0", "t1", "status", "pinned"}]``. Roots are spans without a
        parent (a subprocess fragment may have none in view)."""
        by_trace = {}
        for ring in self._all_rings():
            for s in ring.snapshot():
                rec = by_trace.setdefault(
                    s.trace_id, {"trace_id": f"{s.trace_id:016x}",
                                 "root": None, "spans": 0,
                                 "t0": s.t0, "t1": s.t1, "status": "ok"})
                rec["spans"] += 1
                rec["t0"] = min(rec["t0"], s.t0)
                rec["t1"] = max(rec["t1"], s.t1)
                if s.parent_id is None and (rec["root"] is None):
                    rec["root"] = s.name
                if s.status != "ok":
                    rec["status"] = s.status
        pinned = self.postmortem_ids()
        with self._lock:
            for tid in self._pin_order:
                p = self._pinned.get(tid)
                if p is None or tid in by_trace:
                    continue
                spans = p["spans"]
                by_trace[tid] = {
                    "trace_id": f"{tid:016x}",
                    "root": next((s.name for s in spans
                                  if s.parent_id is None), None),
                    "spans": len(spans),
                    "t0": min((s.t0 for s in spans), default=p["at"]),
                    "t1": max((s.t1 for s in spans), default=p["at"]),
                    "status": p["reason"] or "pinned"}
        out = []
        for tid, rec in by_trace.items():
            rec["pinned"] = tid in pinned
            out.append(rec)
        out.sort(key=lambda r: -r["t1"])
        return out[:limit]

    # -- export ------------------------------------------------------------
    @staticmethod
    def chrome_events(spans):
        """chrome://tracing "X" (complete) events for one trace's spans:
        microsecond epoch timestamps, original pid/thread rows, parent
        links as flow-adjacent args."""
        evs = []
        tids = {}
        for s in spans:
            tid = tids.setdefault((s.pid, s.thread),
                                  len(tids) + 1)
            args = dict(s.attrs or {})
            args["trace_id"] = f"{s.trace_id:016x}"
            args["span_id"] = f"{s.span_id:016x}"
            if s.parent_id is not None:
                args["parent_id"] = f"{s.parent_id:016x}"
            if s.status != "ok":
                args["status"] = s.status
                if s.error:
                    args["error"] = s.error
            evs.append({
                "ph": "X", "name": s.name, "cat": "trace",
                "pid": s.pid, "tid": tid,
                "ts": s.t0 * 1e6,
                "dur": max(0.0, (s.t1 - s.t0) * 1e6),
                "args": args,
            })
        return evs

    def stats(self):
        with self._lock:
            rings = len(self._rings) + len(self._foreign)
            retired = len(self._retired)
            pinned = len(self._pinned)
        return {"recorded": self.recorded, "rings": rings,
                "retired_rings": retired,
                "ring_spans": self.ring_spans, "pinned_traces": pinned,
                "dropped_wraps": self.dropped_wraps,
                "max_postmortems": self.max_postmortems}

    def reset(self):
        """Drop every ring and postmortem (tests)."""
        with self._lock:
            self._rings = []
            self._retired.clear()
            self._foreign = []
            self._pinned = {}
            self._pin_order.clear()
        self._tls = threading.local()
        self.recorded = 0
        self.dropped_wraps = 0


_DEFAULT = FlightRecorder()


def recorder():
    """The process-wide default flight recorder (obs.trace records into
    it; the `/traces` endpoint reads it)."""
    return _DEFAULT
