"""Telemetry of the port (counterpart of paddle_tpu/obs): the metrics
registry (`Counter`, `Gauge`, `Histogram` over fixed log-spaced
buckets, with trace exemplars), the exporters (`render_json`,
`render_prometheus`, the opt-in `MetricsServer` with ``/metrics``,
``/healthz`` and ``/traces``), the SLO gate (`slo.Objective`,
`slo.evaluate`), and request tracing: `trace` (Dapper-style spans with
cross-thread and cross-process context propagation) over `flight` (the
always-on per-thread flight recorder with postmortem retention).
`ServingPool`, `ServingRouter` and `DecodeEngine` register their
`stats()` as collectors and record spans. ``PADDLE_TPU_TRACE=0`` reduces
every probe to a flag check."""
from . import flight, slo, trace
from .export import render_json, render_prometheus
from .flight import FlightRecorder, recorder
from .http import MetricsServer
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_latency_buckets, registry)
from .trace import TraceContext

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_latency_buckets", "registry", "render_json",
           "render_prometheus", "MetricsServer", "slo", "trace", "flight",
           "TraceContext", "FlightRecorder", "recorder"]
