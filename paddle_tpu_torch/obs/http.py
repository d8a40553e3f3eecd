"""Opt-in background HTTP metrics endpoint (counterpart of
paddle_tpu/obs/http.py). `MetricsServer` binds a threaded HTTP server
(an ephemeral port by default) on a daemon thread and serves

* ``GET /metrics``: the Prometheus text exposition; an OpenMetrics
  scrape (``Accept: application/openmetrics-text`` or
  ``?openmetrics=1``) also gets the histograms' trace exemplars;
* ``GET /metrics.json``: the nested-JSON registry snapshot;
* ``GET /healthz``: 200 or 503 from the attached health callable, with a
  small JSON body;
* ``GET /traces``: recent and retained traces of the flight recorder
  (obs.flight), newest first;
* ``GET /traces/<id>``: one trace's merged record, every span across
  threads and processes that shares the id; ``?format=chrome`` renders a
  chrome://tracing file instead of the span list.

A request thread holds no lock: the registry copies references under its
own lock and the collectors run outside it.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .export import render_json, render_prometheus
from .metrics import registry as _default_registry

__all__ = ["MetricsServer"]

class MetricsServer:
    """Background exporter over one registry.

        server = MetricsServer(registry, port=0).start()
        ... scrape server.url + "/metrics" ...
        server.stop()

    `healthz` is an optional callable returning ``(ok, detail_dict)``; it
    runs on the request thread."""

    def __init__(self, registry=None, *, host="127.0.0.1", port=0,
                 healthz=None):
        self.registry = registry if registry is not None \
            else _default_registry()
        self._host = host
        self._want_port = int(port)
        self._healthz = healthz
        self._lock = threading.Lock()
        self._server = None
        self._thread = None

    def start(self):
        with self._lock:
            if self._server is not None:
                return self
            server = ThreadingHTTPServer((self._host, self._want_port),
                                         _make_handler(self))
            server.daemon_threads = True
            self._server = server
            self._thread = threading.Thread(
                target=server.serve_forever, name="obs-metrics-http",
                kwargs={"poll_interval": 0.05}, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        """Shut the listener down and join its thread. Idempotent."""
        with self._lock:
            server, thread = self._server, self._thread
            self._server = self._thread = None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    @property
    def running(self):
        with self._lock:
            return self._server is not None

    @property
    def port(self):
        with self._lock:
            if self._server is None:
                raise RuntimeError("metrics server is not running")
            return self._server.server_address[1]

    @property
    def url(self):
        return f"http://{self._host}:{self.port}"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _respond(self, raw_path, accept=""):
        """(status, content type, body bytes) of one GET."""
        path, _, query = raw_path.partition("?")
        if path == "/traces" or path.startswith("/traces/"):
            return self._respond_traces(path, query)
        if path in ("/metrics", "/"):
            # exemplars are legal only in the OpenMetrics exposition (a
            # classic 0.0.4 parser fails the whole scrape on '#' after a
            # value), so they render only when the client asks for it
            openmetrics = ("application/openmetrics-text" in accept
                           or "openmetrics=1" in query)
            body = render_prometheus(self.registry.snapshot(),
                                     exemplars=openmetrics)
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8" if openmetrics
                     else "text/plain; version=0.0.4; charset=utf-8")
            return 200, ctype, body.encode()
        if path in ("/metrics.json", "/snapshot"):
            return 200, "application/json", \
                render_json(self.registry.snapshot(), indent=1).encode()
        if path == "/healthz":
            ok, detail = True, {}
            if self._healthz is not None:
                try:
                    ok, detail = self._healthz()
                except Exception as e:  # noqa: BLE001 — a broken probe
                    ok, detail = False, {  # is unhealth, not a 500
                        "error": f"{type(e).__name__}: {e}"}
            body = json.dumps({"ok": bool(ok), **(detail or {})},
                              default=str).encode()
            return (200 if ok else 503), "application/json", body
        return 404, "text/plain; charset=utf-8", b"not found\n"

    def _respond_traces(self, path, query):
        """/traces (the index) and /traces/<id> (the merged spans, JSON or
        ``?format=chrome``). The flight recorder is the process's: every
        exporter of the process serves the same spans."""
        from .flight import FlightRecorder, recorder

        rec = recorder()
        if path == "/traces":
            body = json.dumps({"traces": rec.traces(),
                               "recorder": rec.stats()},
                              sort_keys=True, default=str).encode()
            return 200, "application/json", body
        tid = path.split("/", 2)[2].strip("/")
        try:
            int(tid, 16)
        except ValueError:
            return 404, "text/plain; charset=utf-8", \
                b"malformed trace id\n"
        spans = rec.spans_for(tid)
        if not spans:
            return 404, "text/plain; charset=utf-8", \
                f"trace {tid} not found\n".encode()
        params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
        if params.get("format") == "chrome":
            body = json.dumps(
                {"traceEvents": FlightRecorder.chrome_events(spans)},
                default=str).encode()
            return 200, "application/json", body
        body = json.dumps({"trace_id": tid,
                           "spans": [s.to_dict() for s in spans]},
                          sort_keys=True, default=str).encode()
        return 200, "application/json", body


def _make_handler(server):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            try:
                status, ctype, body = server._respond(
                    self.path, accept=self.headers.get("Accept", ""))
            except Exception as e:  # noqa: BLE001 — a 500, not a dead
                status, ctype = 500, "text/plain; charset=utf-8"  # server
                body = f"{type(e).__name__}: {e}\n".encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass  # scrapes do not write to the serving process's stderr

    return Handler
