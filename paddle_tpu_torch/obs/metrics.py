"""Metric primitives and the process-wide registry (counterpart of
paddle_tpu/obs/metrics.py).

* `Counter` / `Gauge` / `Histogram`: standalone metrics. The histogram
  keeps FIXED log-spaced buckets, so p50 / p95 / p99 come from about 30
  ints (interpolated inside the crossing bucket), with nothing stored per
  sample.
* Hot path: `Counter.inc()` and `Histogram.observe()` take no lock (an
  int add, plus one `bisect` for the histogram). Exact invariants (the
  serving conservation laws) are published through collector callbacks
  over the owner's own lock-guarded counters (`register_collector(name,
  pool.stats)`), so the registry never keeps a second copy of them.
* `MetricsRegistry`: get-or-create families by (name, labels) and the
  collector table. Its lock guards only the tables; collectors run and
  the snapshot is serialized outside it.
* `registry()`: the process-wide default every instrumented part of the
  port registers into unless handed a private one.
"""
from __future__ import annotations

import bisect
import math
import os
import threading
import weakref

from . import trace as _trace

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "default_latency_buckets"]


def default_latency_buckets(lo=1e-4, hi=100.0, per_decade=5):
    """Fixed log-spaced bounds (seconds): `per_decade` a factor of 10 over
    [lo, hi], 31 bounds at the defaults; neighbours differ by about
    1.58x."""
    n = int(round(math.log10(float(hi) / float(lo)) * per_decade))
    return tuple(float(lo) * (10.0 ** (i / float(per_decade)))
                 for i in range(n + 1))


def _label_key(labels):
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    __slots__ = ("name", "help", "labels")

    def __init__(self, name, help="", labels=None):
        self.name = str(name)
        self.help = str(help)
        self.labels = dict(labels) if labels else {}


class Counter(_Metric):
    """Monotonic event count; `inc()` is one unlocked int add."""

    kind = "counter"
    __slots__ = ("_value",)

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help=help, labels=labels)
        self._value = 0

    def inc(self, n=1):
        self._value += n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return {"value": self._value}


class Gauge(_Metric):
    """A point-in-time value: `set()` a number, or `set_function()` a
    callable read at snapshot time."""

    kind = "gauge"
    __slots__ = ("_value", "_fn")

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help=help, labels=labels)
        self._value = 0.0
        self._fn = None

    def set(self, v):
        self._value = float(v)

    def inc(self, n=1):
        self._value += n

    def dec(self, n=1):
        self._value -= n

    def set_function(self, fn):
        self._fn = fn

    @property
    def value(self):
        if self._fn is not None:
            return float(self._fn())
        return self._value

    def snapshot(self):
        try:
            return {"value": self.value}
        except Exception as e:  # a broken callback must not break a scrape
            return {"value": None, "error": f"{type(e).__name__}: {e}"}


class Histogram(_Metric):
    """Distribution over fixed log-spaced buckets. `observe(v)` is one
    `bisect` plus three unlocked adds. Quantiles interpolate linearly
    inside the bucket where the cumulative count crosses q * total; an
    observation past the last bound reports that bound.

    Exemplars (OpenMetrics): an observation under a sampled trace context
    (obs.trace, or `ctx=`) makes its bucket remember that trace id and
    value, one unlocked slot write, so a scrape leads from "the p99
    bucket grew" to the last request that landed there
    (``/traces/<id>``). With tracing off it is one flag check."""

    kind = "histogram"
    __slots__ = ("bounds", "_counts", "_sum", "_count", "_exemplars")

    def __init__(self, name, help="", labels=None, bounds=None):
        super().__init__(name, help=help, labels=labels)
        bs = tuple(sorted(float(b) for b in
                          (bounds if bounds is not None
                           else default_latency_buckets())))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bs
        self._counts = [0] * (len(bs) + 1)  # [-1]: overflow (+Inf)
        self._sum = 0.0
        self._count = 0
        self._exemplars = [None] * (len(bs) + 1)  # (trace id hex, value)

    def observe(self, v, ctx=None):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        self._counts[i] += 1
        self._sum += v
        self._count += 1
        if _trace.enabled():
            if ctx is None:
                ctx = _trace.current()
            if ctx is not None and ctx.sampled:
                self._exemplars[i] = (ctx.trace_id_hex, v)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def counts(self):
        """A copy of the bucket counts (the last is the overflow). Two
        copies' difference, passed to `quantile(q, counts=...)`, gives a
        windowed quantile."""
        return list(self._counts)

    def quantile(self, q, counts=None):
        """Interpolated q-quantile (q in [0, 1]) from the bucket counts."""
        counts = list(self._counts) if counts is None else counts
        total = sum(counts)
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if c and cum >= target:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i else 0.0
                frac = (target - (cum - c)) / c
                return lo + frac * (self.bounds[i] - lo)
        return self.bounds[-1]

    def exemplar_for(self, q, counts=None):
        """The ``(trace id hex, value)`` exemplar of the bucket the
        q-quantile falls in (or of the nearest lower bucket that holds
        one), or None: "which request blew the p99"."""
        counts = list(self._counts) if counts is None else counts
        total = sum(counts)
        if total == 0:
            return None
        target = q * total
        cum = 0
        crossing = len(counts) - 1
        for i, c in enumerate(counts):
            cum += c
            if c and cum >= target:
                crossing = i
                break
        for i in range(crossing, -1, -1):
            if self._exemplars[i] is not None:
                return self._exemplars[i]
        return None

    def snapshot(self):
        counts = list(self._counts)        # one instant for every field
        total = sum(counts)
        cum, buckets = 0, []
        for i, b in enumerate(self.bounds):
            cum += counts[i]
            buckets.append([b, cum])
        buckets.append(["+Inf", total])
        snap = {"count": total, "sum": self._sum,
                "avg": (self._sum / total) if total else 0.0,
                "p50": self.quantile(0.50, counts),
                "p95": self.quantile(0.95, counts),
                "p99": self.quantile(0.99, counts),
                "buckets": buckets}
        exemplars = {i: {"trace_id": ex[0], "value": ex[1]}
                     for i, ex in enumerate(self._exemplars)
                     if ex is not None}
        if exemplars:       # absent when no traced observation landed
            snap["exemplars"] = exemplars
        return snap


class MetricsRegistry:
    """Metric families by (name, labels) plus collector callbacks that
    bridge existing `stats()` dicts in. The lock guards the tables only:
    `snapshot()` copies references under it, then calls the collectors
    and serializes without it, so a collector may take its owner's
    locks."""

    #: the label set every over-cardinality observation collapses onto
    OVERFLOW_LABELS = {"_overflow": "true"}

    def __init__(self, max_label_sets=None):
        self._lock = threading.Lock()
        self._metrics = {}     # (name, label_key) -> metric
        self._kinds = {}       # name -> metric class (family-wide)
        self._collectors = {}  # name -> callable | weakref.WeakMethod
        if max_label_sets is None:
            max_label_sets = int(os.environ.get(
                "PADDLE_TPU_OBS_MAX_LABEL_SETS", "64"))
        if max_label_sets < 1:
            raise ValueError("max_label_sets must be >= 1")
        self.max_label_sets = max_label_sets
        self._label_sets = {}  # name -> distinct label sets
        self.label_overflows = 0

    def _get(self, cls, name, help, labels, **kw):
        name = str(name)
        key = (name, _label_key(labels))
        with self._lock:
            known = self._kinds.get(name)
            if known is not None and known is not cls:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{known.kind}, requested {cls.kind}")
            m = self._metrics.get(key)
            if m is None:
                if labels and \
                        self._label_sets.get(name, 0) >= self.max_label_sets:
                    # cardinality cap: one shared _overflow series
                    self.label_overflows += 1
                    labels = dict(self.OVERFLOW_LABELS)
                    key = (name, _label_key(labels))
                    m = self._metrics.get(key)
                    if m is not None:
                        return m
                else:
                    self._label_sets[name] = \
                        self._label_sets.get(name, 0) + 1
                m = cls(name, help=help, labels=labels, **kw)
                self._metrics[key] = m
                self._kinds[name] = cls
            return m

    def counter(self, name, help="", labels=None):
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=None):
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=None, bounds=None):
        h = self._get(Histogram, name, help, labels, bounds=bounds)
        if bounds is not None:
            want = tuple(sorted(float(b) for b in bounds))
            if h.bounds != want:
                raise ValueError(f"histogram {name!r} already exists with "
                                 f"bounds {h.bounds}, not {want}")
        return h

    def register_collector(self, name, fn):
        """Attach a stats-snapshot callable under `name`; its dict rides in
        `snapshot()["collectors"][name]`. Bound methods are held weakly; a
        collector returning None is pruned. Re-registering replaces."""
        if hasattr(fn, "__self__"):
            fn = weakref.WeakMethod(fn)
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name, fn=None):
        """Remove the collector under `name`; with `fn`, only when that is
        still the registered callable (a later same-named owner keeps
        its registration)."""
        with self._lock:
            if fn is None:
                self._collectors.pop(name, None)
                return
            cur = self._collectors.get(name)
            live = cur() if isinstance(cur, weakref.WeakMethod) else cur
            if live is None or live == fn:
                self._collectors.pop(name, None)

    def collector_names(self):
        with self._lock:
            return sorted(self._collectors)

    def snapshot(self):
        """``{"metrics": {name: [{kind, labels, help, ...}]},
        "collectors": {name: stats}}``, in sorted order; collectors run
        outside the registry lock."""
        with self._lock:
            metrics = sorted(self._metrics.items())
            collectors = list(self._collectors.items())
        out_m = {}
        for (name, _), m in metrics:
            out_m.setdefault(name, []).append(
                {"kind": m.kind, "labels": dict(m.labels), "help": m.help,
                 **m.snapshot()})
        out_c, dead = {}, []
        for name, fn in collectors:
            f = fn() if isinstance(fn, weakref.WeakMethod) else fn
            if f is None:
                dead.append((name, fn))
                continue
            try:
                stats = f()
            except Exception as e:  # noqa: BLE001 — one broken stats()
                out_c[name] = {"_collector_error":  # must not break the
                               f"{type(e).__name__}: {e}"}  # others
                continue
            if stats is None:
                dead.append((name, fn))
                continue
            out_c[name] = stats
        if dead:
            with self._lock:
                for name, fn in dead:
                    if self._collectors.get(name) is fn:
                        del self._collectors[name]
        return {"metrics": out_m, "collectors": out_c}

    def prometheus_text(self):
        """Text exposition (format 0.0.4) of `snapshot()`."""
        from .export import render_prometheus

        return render_prometheus(self.snapshot())


_DEFAULT = MetricsRegistry()


def registry():
    """The process-wide default registry."""
    return _DEFAULT
