"""Telemetry of the port (counterpart of paddle_tpu/obs): the metrics
registry (`Counter`, `Gauge`, `Histogram` over fixed log-spaced
buckets), the exporters (`render_json`, `render_prometheus`, the opt-in
`MetricsServer` with ``/metrics`` and ``/healthz``) and the SLO gate
(`slo.Objective`, `slo.evaluate`). `ServingPool`, `ServingRouter` and
`DecodeEngine` register their `stats()` as collectors. Request tracing
(`obs.trace`, `obs.flight`) is not ported yet."""
from . import slo
from .export import render_json, render_prometheus
from .http import MetricsServer
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_latency_buckets, registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_latency_buckets", "registry", "render_json",
           "render_prometheus", "MetricsServer", "slo"]
