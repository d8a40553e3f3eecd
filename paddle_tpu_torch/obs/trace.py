"""Dapper-style distributed request tracing (counterpart of
paddle_tpu/obs/trace.py).

The metrics registry (obs.metrics) says *how slow* the p99 is; this layer says
*which request* and *where* — queue, batch formation, retry loop,
failover hop, prefill, or the device dispatch itself. A request is a
**trace** (one 64-bit id minted at the root), each timed region a
**span** (own id, parent link, name, attrs, typed-error status), and
finished spans land in the always-on flight recorder (obs.flight).

Design points:

* **Context propagation** — a per-thread context STACK
  (`current()` / `span()` push-pop). Cross-thread handoff is explicit:
  the admitting side captures `current()` (e.g. onto the serving
  pool's `_Request`), the executing side re-enters it with
  `span_in(ctx, name)` / `attach(ctx)`. Cross-process handoff rides
  `ctx.to_wire()` / `from_wire()` (three plain values — they pickle
  into the replica transport's request payload).

* **Deterministic sampling** — the sampling DECISION is a pure
  function of the trace id (`PADDLE_TPU_TRACE_SAMPLE`, default 1.0),
  made once at the root and carried on the context: every process and
  thread a trace touches agrees without coordination, so a sampled
  trace is always COMPLETE.

* **Zero overhead off** — ``PADDLE_TPU_TRACE=0`` reduces every probe
  to one module-flag check: `span()`/`root_span()` return a shared
  no-op singleton, `current()` is never consulted by instrumentation,
  and histogram exemplars (obs.metrics) stay dark. Tracing defaults ON
  (the flight recorder is cheap enough to leave on in production).

* **Host-side only** — a span reads the host clock and appends to a
  ring: it never synchronizes the device or reads a device tensor, so
  it may wrap a decode step (a CUDA-graph replay) without changing it.

* **Postmortems** — the typed serving failures that matter
  (`RequestFailed` / `DeadlineExceeded` / `ReplicaDead` /
  `SwapFailed` carry a ``_trace_postmortem = True`` class flag) pin
  their trace into the flight recorder's retained buffer at
  construction (`note_failure`) or at the request's result slot
  (`pin_failure`), and gain a ``.trace_id`` attribute so the caller
  holding the exception can fetch the causal record
  (``/traces/<id>``).

One lock guards only the shared id generator; span creation otherwise
touches per-thread state.
"""
from __future__ import annotations

import os
import random
import threading
import time

from . import flight as _flight

__all__ = [
    "TraceContext", "enabled", "enable", "disable", "sample_rate",
    "set_sample_rate", "current", "current_wire", "span", "root_span",
    "span_in", "attach", "event", "event_in", "open_span", "null_span",
    "note_failure", "pin_failure",
]


def _env_flag(name, default="1"):
    return os.environ.get(name, default).strip().lower() not in (
        "0", "false", "off", "no")


_enabled = _env_flag("PADDLE_TPU_TRACE")
_sample_rate = float(os.environ.get("PADDLE_TPU_TRACE_SAMPLE", "1.0"))

#: deterministic sampling modulus: a trace is sampled iff
#: trace_id % _SAMPLE_MOD < rate * _SAMPLE_MOD
_SAMPLE_MOD = 1 << 20

_id_lock = threading.Lock()
_id_rng = random.Random(int.from_bytes(os.urandom(16), "big"))

_tls = threading.local()


def enabled():
    """True when tracing probes are live (PADDLE_TPU_TRACE, default on)."""
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def sample_rate():
    return _sample_rate


def set_sample_rate(rate):
    global _sample_rate
    _sample_rate = float(rate)


def _new_id():
    with _id_lock:
        v = _id_rng.getrandbits(64)
    return v or 1


def _sampled(trace_id):
    if _sample_rate >= 1.0:
        return True
    if _sample_rate <= 0.0:
        return False
    # Fibonacci-hash the id before thresholding so the decision is
    # uniform for ANY id distribution (sequential test ids included),
    # while staying a pure function of the trace id — every process
    # and thread agrees without coordination
    h = (trace_id * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    return (h >> 44) < _sample_rate * _SAMPLE_MOD


class TraceContext:
    """(trace_id, span_id, sampled): where in which trace the current
    code is executing. Immutable; child spans derive new contexts."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id, span_id, sampled):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    @property
    def trace_id_hex(self):
        return f"{self.trace_id:016x}"

    @property
    def span_id_hex(self):
        return f"{self.span_id:016x}"

    def to_wire(self):
        """Plain picklable tuple for cross-process propagation."""
        return (self.trace_id, self.span_id, self.sampled)

    @classmethod
    def from_wire(cls, wire):
        if wire is None:
            return None
        t, s, samp = wire
        return cls(int(t), int(s), bool(samp))

    def __repr__(self):
        return (f"TraceContext({self.trace_id_hex}/{self.span_id_hex}"
                f"{'' if self.sampled else ' unsampled'})")


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current():
    """The innermost active TraceContext on this thread, or None."""
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


def current_wire():
    """`current().to_wire()` or None — the cross-process handoff value."""
    ctx = current()
    return None if ctx is None else ctx.to_wire()


class _NullSpan:
    """Shared no-op for every untraced probe: ``with span(...)`` costs a
    flag check and two trivial method calls."""

    __slots__ = ()
    ctx = None
    trace_id = None
    trace_id_hex = None
    span_id_hex = None
    recorded = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key, value):
        pass

    def end(self, error=None, status=None):
        pass


_NULL = _NullSpan()


def null_span():
    """The shared no-op span (for call sites that pick between a real
    span and nothing without an if/else around the `with` body)."""
    return _NULL


class _OpenSpan:
    """A live span: entered (pushed) now, recorded into the flight
    recorder at exit/end when its trace is sampled. Exceptions leaving
    the ``with`` body stamp the span's status with the error type."""

    __slots__ = ("name", "ctx", "parent_id", "attrs", "_t0", "_thread",
                 "_pushed", "_extra_pop", "recorded")

    def __init__(self, name, ctx, parent_id, attrs, extra_pop=False):
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else None
        self._t0 = time.perf_counter()
        self._thread = threading.current_thread().name
        self._pushed = True
        self._extra_pop = extra_pop  # attach-style: a foreign parent ctx
        self.recorded = False        # was pushed under this span

    # -- identity ----------------------------------------------------------
    @property
    def trace_id(self):
        return self.ctx.trace_id

    @property
    def trace_id_hex(self):
        return self.ctx.trace_id_hex

    @property
    def span_id_hex(self):
        return self.ctx.span_id_hex

    def set_attr(self, key, value):
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end(error=exc)
        return False

    def end(self, error=None, status=None):
        """Pop the context and (when sampled) record the finished span.
        Idempotent. `error` may be an exception instance or message."""
        if self._pushed:
            self._pushed = False
            s = _stack()
            if s and s[-1] is self.ctx:
                s.pop()
                # attach-style spans pushed their foreign parent too —
                # pop it ONLY when our own pop landed (an imbalanced
                # stack must never lose someone else's entry)
                if self._extra_pop and s:
                    s.pop()
        if self.recorded:
            return
        self.recorded = True
        if not self.ctx.sampled:
            return
        t1 = time.perf_counter()
        if status is None:
            status = "ok" if error is None else (
                type(error).__name__ if isinstance(error, BaseException)
                else "error")
        err = None
        if error is not None:
            err = str(error) if not isinstance(error, type) else None
        _flight.recorder().record(_flight.Span(
            self.ctx.trace_id, self.ctx.span_id, self.parent_id,
            self.name, _flight.wall_of(self._t0), _flight.wall_of(t1),
            attrs=self.attrs, status=status, error=err,
            thread=self._thread))


def span(name, attrs=None):
    """Child span of the CURRENT context; the shared no-op when tracing
    is off or no trace is active (instrumentation call sites stay free
    outside a traced request)."""
    if not _enabled:
        return _NULL
    parent = current()
    if parent is None:
        return _NULL
    ctx = TraceContext(parent.trace_id, _new_id(), parent.sampled)
    _stack().append(ctx)
    return _OpenSpan(name, ctx, parent.span_id, attrs)


def root_span(name, attrs=None, sampled=None):
    """Mint a trace (new trace id, deterministic sampling decision) —
    or a child span when a context is already active, so a traced
    caller's hop nests instead of forking a second trace.

    `sampled=` overrides the hash decision for a FRESH trace: a link
    trace (a formed batch, a decode step) minted on behalf of sampled
    member traces must itself be sampled, or the members' back-links
    would dangle at sub-1.0 sample rates."""
    if not _enabled:
        return _NULL
    parent = current()
    if parent is not None:
        ctx = TraceContext(parent.trace_id, _new_id(), parent.sampled)
        pid = parent.span_id
    else:
        tid = _new_id()
        ctx = TraceContext(tid, _new_id(),
                           _sampled(tid) if sampled is None
                           else bool(sampled))
        pid = None
    _stack().append(ctx)
    return _OpenSpan(name, ctx, pid, attrs)


def open_span(name, attrs=None, parent=None):
    """A long-lived span NOT tied to this thread's stack (e.g. a decode
    sequence whose life spans many scheduler rounds): nothing is
    pushed; finish it explicitly with `.end(error=...)`. `parent` is an
    explicit TraceContext (default: `current()`)."""
    if not _enabled:
        return _NULL
    if parent is None:
        parent = current()
    if parent is not None:
        ctx = TraceContext(parent.trace_id, _new_id(), parent.sampled)
        pid = parent.span_id
    else:
        tid = _new_id()
        ctx = TraceContext(tid, _new_id(), _sampled(tid))
        pid = None
    sp = _OpenSpan(name, ctx, pid, attrs)
    sp._pushed = False          # detached: no stack entry to pop
    return sp


def span_in(name, ctx, attrs=None):
    """Child span under an EXPLICIT context (cross-thread handoff): the
    executing thread both attaches `ctx` and opens the child in one
    push, popping both at exit."""
    if not _enabled or ctx is None:
        return _NULL
    s = _stack()
    s.append(ctx)
    child = TraceContext(ctx.trace_id, _new_id(), ctx.sampled)
    s.append(child)
    return _OpenSpan(name, child, ctx.span_id, attrs, extra_pop=True)


class _Attach:
    __slots__ = ("ctx",)

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        _stack().append(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        s = _stack()
        if s:
            s.pop()
        return False


def attach(ctx):
    """Re-enter a captured context on this thread (no span recorded):
    spans opened inside become its children."""
    if not _enabled or ctx is None:
        return _NULL
    return _Attach(ctx)


def event(name, attrs=None):
    """Zero-duration child span of the current context ("something
    happened here"): admission stamps, first-token marks, batch links."""
    sp = span(name, attrs)
    sp.end()
    return sp


def event_in(name, ctx, attrs=None):
    """`event()` under an explicit context (cross-thread)."""
    sp = span_in(name, ctx, attrs)
    sp.end()
    return sp


# ---------------------------------------------------------------------------
# postmortem capture
# ---------------------------------------------------------------------------

def note_failure(exc):
    """Called by the typed serving errors' constructors (class flag
    ``_trace_postmortem``): pin the CURRENT trace's causal record into
    the flight recorder's retained buffer and stamp the exception with
    its trace id. No-op without an active sampled trace."""
    if not _enabled:
        return
    ctx = current()
    if ctx is None or not ctx.sampled:
        return
    exc.trace_id = ctx.trace_id_hex
    _flight.recorder().pin(ctx.trace_id, reason=type(exc).__name__)


def pin_failure(ctx, exc):
    """Explicit postmortem pin for a failure resolved AWAY from the
    traced thread (a pool worker failing a request whose context lives
    on the request object). Honors the same class flag; idempotent
    with `note_failure` (one pinned record per trace)."""
    if not _enabled or ctx is None or not ctx.sampled:
        return
    if not getattr(type(exc), "_trace_postmortem", False):
        return
    if getattr(exc, "trace_id", None) is None:
        exc.trace_id = ctx.trace_id_hex
    _flight.recorder().pin(ctx.trace_id, reason=type(exc).__name__)
