"""Request tracing of the port (`paddle_tpu_torch.obs.trace` over the
`obs.flight` recorder, the histograms' exemplars and the ``/traces``
endpoints of `obs.MetricsServer`), held to the cases of
tests/test_obs_trace.py on the port's pool, batcher, `LocalReplica`s and
router, with stub members (no model runs here).

Parity cases run one scenario through both packages and compare the span
trees: names, parent links, status and attribute keys. The reference's
`tools/trace_dump.py` scrapes the port's `MetricsServer` unedited, which
holds the ``/traces`` wire format to the reference's reader.
"""
import importlib.util
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu_torch.obs import MetricsRegistry, MetricsServer, flight, trace
from paddle_tpu_torch.obs.flight import FlightRecorder, Span
from paddle_tpu_torch.obs.trace import TraceContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _packages():
    """(obs.trace, obs.flight) of the reference and of the port."""
    from paddle_tpu.obs import flight as jflight
    from paddle_tpu.obs import trace as jtrace

    return {"ref": (jtrace, jflight), "port": (trace, flight)}


@pytest.fixture(autouse=True)
def _clean_tracing():
    """Every test starts traced at rate 1.0 with empty recorders (the
    port's, and the reference's where a parity case records into it) and
    leaves the switches as it found them."""
    saved = []
    for tr, fl in _packages().values():
        saved.append((tr, fl, tr.enabled(), tr.sample_rate()))
        tr.enable()
        tr.set_sample_rate(1.0)
        fl.recorder().reset()
    yield
    for tr, fl, was, rate in saved:
        fl.recorder().reset()
        tr.set_sample_rate(rate)
        (tr.enable if was else tr.disable)()


@pytest.fixture(scope="module", autouse=True)
def _private_compile_cache(tmp_path_factory):
    """The JAX side's persistent compile cache in this module's own
    directory: two JAX processes on one cache load each other's
    executables."""
    old = os.environ.get("PADDLE_TPU_COMPILE_CACHE")
    os.environ["PADDLE_TPU_COMPILE_CACHE"] = str(
        tmp_path_factory.mktemp("compile-cache"))
    yield
    if old is None:
        os.environ.pop("PADDLE_TPU_COMPILE_CACHE", None)
    else:
        os.environ["PADDLE_TPU_COMPILE_CACHE"] = old


class Stub:
    def clone(self):
        return Stub()

    def reset_handles(self):
        pass


def make_pool(inf=None, **kw):
    if inf is None:
        from paddle_tpu_torch import inference as inf

    kw.setdefault("size", 2)
    kw.setdefault("metrics", False)
    kw.setdefault("default_timeout", 10.0)
    return inf.ServingPool(predictor=Stub(), **kw)


# ---------------------------------------------------------------------------
# span primitives
# ---------------------------------------------------------------------------

def test_span_tree_parent_links_and_status():
    with trace.root_span("root", attrs={"k": "v"}) as root:
        with trace.span("child"):
            trace.event("mark", attrs={"n": 1})
    spans = flight.recorder().spans_for(root.trace_id)
    by = {s.name: s for s in spans}
    assert set(by) == {"root", "child", "mark"}
    assert by["root"].parent_id is None
    assert by["child"].parent_id == by["root"].span_id
    assert by["mark"].parent_id == by["child"].span_id
    assert all(s.trace_id == root.trace_id for s in spans)
    assert by["root"].attrs == {"k": "v"} and by["root"].status == "ok"
    assert by["mark"].t1 >= by["mark"].t0


def test_span_error_status_and_nested_root_joins():
    with pytest.raises(RuntimeError):
        with trace.root_span("outer") as outer:
            # a root span under an active trace nests: one trace a request
            with trace.root_span("inner") as inner:
                assert inner.trace_id == outer.trace_id
                raise RuntimeError("boom")
    by = {s.name: s for s in flight.recorder().spans_for(outer.trace_id)}
    assert by["inner"].parent_id == by["outer"].span_id
    assert by["inner"].status == "RuntimeError"
    assert "boom" in by["inner"].error
    assert by["outer"].status == "RuntimeError"


def test_cross_thread_handoff_span_in():
    got = {}

    def worker(ctx):
        assert trace.current() is None      # a fresh thread: no context
        with trace.span_in("work", ctx, attrs={"w": 1}):
            got["inner"] = trace.current()
        assert trace.current() is None      # both pops happened

    with trace.root_span("caller") as root:
        ctx = trace.current()
        t = threading.Thread(target=worker, args=(ctx,))
        t.start()
        t.join()
    by = {s.name: s for s in flight.recorder().spans_for(root.trace_id)}
    assert by["work"].parent_id == by["caller"].span_id
    assert got["inner"].trace_id == root.trace_id


def test_wire_roundtrip_and_deterministic_sampling():
    with trace.root_span("r"):
        wire = trace.current_wire()
    ctx = TraceContext.from_wire(wire)
    assert (ctx.trace_id, ctx.span_id, ctx.sampled) == wire
    assert TraceContext.from_wire(None) is None
    trace.set_sample_rate(0.5)
    decisions = {tid: trace._sampled(tid) for tid in range(1, 2000, 7)}
    assert any(decisions.values()) and not all(decisions.values())
    assert decisions == {tid: trace._sampled(tid) for tid in decisions}
    trace.set_sample_rate(0.0)
    with trace.root_span("dark") as dark:
        trace.event("inside")
    assert flight.recorder().spans_for(dark.ctx.trace_id) == []


def test_sampling_decisions_equal_the_reference():
    """A trace id gets the same sampling decision in both packages, so a
    trace crossing from one to the other is sampled whole or not."""
    jtrace = _packages()["ref"][0]
    ids = list(range(1, 3000, 11)) + [
        int.from_bytes(os.urandom(8), "big") | 1 for _ in range(500)]
    for rate in (0.0, 0.01, 0.3, 0.5, 0.99, 1.0):
        trace.set_sample_rate(rate)
        jtrace.set_sample_rate(rate)
        assert [trace._sampled(t) for t in ids] == \
            [jtrace._sampled(t) for t in ids]
    assert trace._SAMPLE_MOD == jtrace._SAMPLE_MOD


def test_tracing_off_zero_overhead_probes():
    """PADDLE_TPU_TRACE=0: every probe is a flag check returning the
    shared no-op; nothing records. Tracing on stays within 4x of off
    through a real pool (a guard against a lock, a syscall or a ring
    walk on the span path, not tracing's own cost)."""
    trace.disable()
    assert trace.span("x") is trace.null_span()
    assert trace.root_span("x") is trace.null_span()
    assert trace.span_in("x", None) is trace.null_span()
    assert trace.attach(None) is trace.null_span()
    assert trace.open_span("x") is trace.null_span()
    with trace.root_span("x"):
        assert trace.current() is None
    err = RuntimeError("e")
    trace.note_failure(err)
    assert not hasattr(err, "trace_id")
    assert flight.recorder().recorded == 0
    n = 200

    def drive(pool, traced):
        t0 = time.perf_counter()
        if traced:
            reqs = []
            for _ in range(n):
                with trace.root_span("req"):
                    reqs.append(pool.submit(lambda p: 0, timeout=30.0))
        else:
            reqs = [pool.submit(lambda p: 0, timeout=30.0)
                    for _ in range(n)]
        for r in reqs:
            r.result(timeout=30.0)
        return time.perf_counter() - t0

    pool = make_pool(max_queue_depth=n + 8)
    best = {"on": float("inf"), "off": float("inf")}
    try:
        drive(pool, False)
        trace.enable()
        drive(pool, True)
        for _ in range(5):
            trace.disable()
            best["off"] = min(best["off"], drive(pool, False))
            trace.enable()
            best["on"] = min(best["on"], drive(pool, True))
    finally:
        trace.disable()
        pool.shutdown(drain_timeout=10.0)
    assert best["on"] <= best["off"] * 4.0, best


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_ring_wrap_bounded_memory():
    rec = FlightRecorder(ring_spans=8, max_postmortems=4)
    for i in range(50):
        rec.record(Span(7, i + 1, None, f"s{i}", 0.0, 1.0))
    spans = rec.spans_for(7)
    assert len(spans) == 8
    assert {s.name for s in spans} == {f"s{i}" for i in range(42, 50)}
    assert rec.dropped_wraps == 42 and rec.recorded == 50
    st = rec.stats()
    assert st["ring_spans"] == 8 and st["rings"] == 1


def test_postmortem_pin_survives_wrap_and_evicts_fifo():
    rec = FlightRecorder(ring_spans=4, max_postmortems=2)
    rec.record(Span(1, 10, None, "doomed", 0.0, 1.0))
    rec.pin(1, reason="DeadlineExceeded")
    for i in range(20):
        rec.record(Span(99, 100 + i, None, "noise", 0.0, 1.0))
    rec.record(Span(1, 11, 10, "late-child", 2.0, 3.0))
    assert [s.name for s in rec.spans_for(1)] == ["doomed", "late-child"]
    assert rec.postmortems()[0][:2] == (1, "DeadlineExceeded")
    rec.pin(2, reason="a")
    rec.pin(3, reason="b")
    assert rec.postmortem_ids() == {2, 3}
    rec.unpin(2)
    assert rec.postmortem_ids() == {3}


def test_ingest_merges_foreign_process_spans():
    rec = FlightRecorder(ring_spans=8)
    rec.record(Span(5, 1, None, "router.infer", 0.0, 2.0))
    wire = [Span(5, 2, 1, "replica.infer", 0.5, 1.5, pid=4242,
                 thread="remote").to_dict()]
    assert rec.ingest(wire) == 1
    rec.pin(5, reason="RequestFailed")
    assert rec.ingest(wire) == 0
    assert rec.postmortems()[0][2] == 2
    spans = rec.spans_for(5)
    assert [s.name for s in spans] == ["router.infer", "replica.infer"]
    assert spans[1].pid == 4242 and spans[1].parent_id == 1
    evs = FlightRecorder.chrome_events(spans)
    assert {e["pid"] for e in evs} == {spans[0].pid, 4242}
    assert all(e["ph"] == "X" for e in evs)
    d2 = Span.from_dict(spans[1].to_dict()).to_dict()
    assert d2 == spans[1].to_dict()
    # the reference reads the port's wire form and the port the
    # reference's, field for field
    jflight = _packages()["ref"][1]
    jd = jflight.Span.from_dict(spans[1].to_dict()).to_dict()
    assert jd == spans[1].to_dict()
    assert Span.from_dict(jd).to_dict() == jd


# ---------------------------------------------------------------------------
# serving-stack propagation (stub pools)
# ---------------------------------------------------------------------------

def test_pool_execution_spans_cross_worker_thread():
    pool = make_pool()
    try:
        with trace.root_span("caller") as root:
            assert pool.submit(lambda p: 7).result() == 7
    finally:
        pool.shutdown(drain_timeout=10.0)
    by = {s.name: s for s in flight.recorder().spans_for(root.trace_id)}
    assert {"caller", "serving.admit", "serving.execute"} <= set(by)
    assert by["serving.execute"].parent_id == by["caller"].span_id
    assert by["serving.execute"].thread != by["caller"].thread
    assert by["serving.execute"].attrs["attempt"] == 1


def test_pool_failure_pins_postmortem_with_trace_id():
    from paddle_tpu_torch.inference.serving import RequestFailed

    pool = make_pool()
    try:
        with trace.root_span("failing") as root:
            with pytest.raises(RequestFailed) as ei:
                pool.submit(lambda p: (_ for _ in ()).throw(
                    ValueError("malformed"))).result()
    finally:
        pool.shutdown(drain_timeout=10.0)
    assert ei.value.trace_id == root.trace_id_hex
    assert root.trace_id in flight.recorder().postmortem_ids()
    spans = flight.recorder().spans_for(root.trace_id)
    exe = [s for s in spans if s.name == "serving.execute"]
    assert exe and exe[0].status == "ValueError"


def test_caller_side_deadline_pins_postmortem():
    from paddle_tpu_torch.inference.serving import DeadlineExceeded

    pool = make_pool(size=1)
    try:
        with trace.root_span("slow") as root:
            with pytest.raises(DeadlineExceeded) as ei:
                pool.submit(lambda p: time.sleep(0.4),
                            timeout=0.05).result()
    finally:
        pool.shutdown(drain_timeout=10.0)
    assert ei.value.trace_id == root.trace_id_hex
    assert root.trace_id in flight.recorder().postmortem_ids()


def test_untraced_pool_requests_record_nothing():
    pool = make_pool()
    try:
        assert pool.submit(lambda p: 1).result() == 1
    finally:
        pool.shutdown(drain_timeout=10.0)
    assert flight.recorder().recorded == 0


def _failover_router(inf, rep, rt):
    """A router over two LocalReplicas whose replica-0 member raises once
    (the reference test's scenario), on package `inf` (`rep`, `rt` its
    replica and router modules)."""
    class FlakyOnce(Stub):
        fails = {"left": 1}

        def __init__(self, tag):
            self.tag = tag

        def clone(self):
            return FlakyOnce(self.tag)

        def run(self, feeds):
            if self.tag == "replica-0" and FlakyOnce.fails["left"] > 0:
                FlakyOnce.fails["left"] -= 1
                raise RuntimeError("injected member fault")
            return [np.asarray(f) * 2 for f in feeds]

    hb = rep.LocalHeartbeats()

    def factory(rid, model_dir, generation):
        return rep.LocalReplica(
            rid, lambda d, r=rid: FlakyOnce(r), model_dir, generation,
            heartbeat=hb,
            pool_kwargs=dict(default_timeout=5.0,
                             retry=inf.RetryPolicy(max_retries=0)))

    return rt.ServingRouter(
        factory, size=2,
        config=rt.RouterConfig(failover=inf.RetryPolicy(
            max_retries=3, base_delay=0.001, max_delay=0.005)))


def _failover_trace(inf, rep, rt, fl):
    router = _failover_router(inf, rep, rt)
    try:
        out, = router.infer([np.ones(3, np.float32)], timeout=5.0)
        assert np.array_equal(out, np.ones(3) * 2)
    finally:
        router.shutdown()
    roots = [t for t in fl.recorder().traces() if t["root"] == "router.infer"]
    assert len(roots) == 1
    return roots[0]["trace_id"]


def test_router_failover_attempts_are_siblings_under_root():
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch.inference import replica as rep
    from paddle_tpu_torch.inference import router as rt

    tid = _failover_trace(inf, rep, rt, flight)
    spans = flight.recorder().spans_for(tid)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    attempts = sorted(by_name["router.attempt"],
                      key=lambda s: s.attrs["attempt"])
    assert len(attempts) >= 2
    root_id = by_name["router.infer"][0].span_id
    assert all(a.parent_id == root_id for a in attempts)
    assert attempts[0].status != "ok" and attempts[-1].status == "ok"
    # recovered: the transient attempt's pin was released at the root
    assert int(tid, 16) not in flight.recorder().postmortem_ids()


class FakeLayer:
    input_spec = [{"shape": (2,), "dtype": "float32"}]

    def batched_call(self, bucket, cache=None):
        def fn(x):
            return [x * 2]
        return fn


class FakeReq:
    def __init__(self, rid, feeds, ctx):
        self.id = rid
        self.feeds = feeds
        self.ctx = ctx
        self.attempts = 1
        self.enqueued_at = None


def _batch_traces(batching, tr, fl):
    """Three traced requests through one bucket-4 batch; returns (the
    member roots, the batch trace's id)."""
    bt = batching.DynamicBatcher(FakeLayer(),
                                 batching.BatchConfig(buckets=(4,)))
    roots, reqs = [], []
    for i in range(3):
        r = tr.open_span(f"req{i}")
        roots.append(r)
        reqs.append(FakeReq(i, [np.ones(2, np.float32) * i], r.ctx))
    results = bt.execute(reqs)
    for r in roots:
        r.end()
    assert [np.array_equal(res[0], np.ones(2) * 2 * i)
            for i, res in enumerate(results)] == [True] * 3
    batch_traces = [t for t in fl.recorder().traces()
                    if t["root"] == "serving.batch"]
    assert len(batch_traces) == 1
    return bt, roots, batch_traces[0]["trace_id"]


def test_batcher_links_batch_span_to_member_traces():
    from paddle_tpu_torch.inference import batching

    bt, roots, btid = _batch_traces(batching, trace, flight)
    bspans = flight.recorder().spans_for(btid)
    batch = next(s for s in bspans if s.name == "serving.batch")
    assert sorted(batch.attrs["links"]) == sorted(
        r.trace_id_hex for r in roots)
    assert batch.attrs["bucket"] == 4 and batch.attrs["n"] == 3
    stages = {s.name: s for s in bspans if s.name.startswith("serving::")}
    assert {"serving::batch_form", "serving::batch_pad",
            "serving::batch_dispatch",
            "serving::batch_scatter"} <= set(stages)
    assert all(s.parent_id == batch.span_id for s in stages.values())
    for r in roots:
        ms = flight.recorder().spans_for(r.trace_id)
        link = next(s for s in ms if s.name == "serving.batch_member")
        assert link.attrs["batch_trace"] == f"{batch.trace_id:016x}"
        assert link.attrs["batch_span"] == f"{batch.span_id:016x}"
    # below rate 1.0 the batch trace inherits its members' sampling
    r2 = trace.open_span("req-s")
    trace.set_sample_rate(0.0)
    bt.execute([FakeReq(9, [np.ones(2, np.float32)], r2.ctx)])
    r2.end()
    link2 = next(s for s in flight.recorder().spans_for(r2.trace_id)
                 if s.name == "serving.batch_member")
    assert flight.recorder().spans_for(link2.attrs["batch_trace"])
    trace.set_sample_rate(1.0)


def test_exemplar_scrape_resolves_to_trace():
    reg = MetricsRegistry()
    h = reg.histogram("unit.lat", bounds=(0.001, 1.0))
    with trace.root_span("the-slow-request") as root:
        h.observe(0.5)
    with MetricsServer(reg) as s:
        plain = urllib.request.urlopen(s.url + "/metrics",
                                       timeout=5).read().decode()
        assert "# {trace_id=" not in plain and "# EOF" not in plain
        req = urllib.request.Request(
            s.url + "/metrics",
            headers={"Accept": "application/openmetrics-text"})
        resp = urllib.request.urlopen(req, timeout=5)
        assert "openmetrics-text" in resp.headers["Content-Type"]
        text = resp.read().decode()
        assert text.rstrip().endswith("# EOF")
        ex_lines = [ln for ln in text.splitlines() if "# {trace_id=" in ln]
        assert ex_lines, text
        tid = ex_lines[0].split('trace_id="')[1].split('"')[0]
        assert tid == root.trace_id_hex
        q = urllib.request.urlopen(s.url + "/metrics?openmetrics=1",
                                   timeout=5).read().decode()
        assert "# {trace_id=" in q
        body = json.loads(urllib.request.urlopen(
            s.url + f"/traces/{tid}", timeout=5).read())
        assert [sp["name"] for sp in body["spans"]] == ["the-slow-request"]
        idx = json.loads(urllib.request.urlopen(
            s.url + "/traces", timeout=5).read())
        assert any(t["trace_id"] == tid for t in idx["traces"])
        chrome = json.loads(urllib.request.urlopen(
            s.url + f"/traces/{tid}?format=chrome", timeout=5).read())
        assert chrome["traceEvents"][0]["name"] == "the-slow-request"
        for bad in ("feedfacefeedface", "not-hex"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(s.url + f"/traces/{bad}", timeout=5)
            assert ei.value.code == 404
    h2 = reg.histogram("unit.cold", bounds=(1.0,))
    h2.observe(0.5)
    assert "exemplars" not in h2.snapshot()
    assert h.exemplar_for(0.99)[0] == root.trace_id_hex


def _trace_dump():
    spec = importlib.util.spec_from_file_location(
        "trace_dump", os.path.join(REPO, "tools", "trace_dump.py"))
    td = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(td)
    return td


def test_trace_dump_cli_reads_the_port_server(capsys):
    """The reference's tools/trace_dump.py, unedited, against the port's
    MetricsServer: the index, one trace, its chrome form and the exit
    codes."""
    td = _trace_dump()
    with trace.root_span("cli-span") as root:
        trace.event("cli-child")
    with MetricsServer(MetricsRegistry()) as s:
        assert td.main(["--url", f"127.0.0.1:{s.port}"]) == 0
        idx = json.loads(capsys.readouterr().out)
        assert any(t["trace_id"] == root.trace_id_hex
                   and t["root"] == "cli-span" for t in idx["traces"])
        assert idx["recorder"]["recorded"] == 2
        assert td.main(["--url", s.url, root.trace_id_hex]) == 0
        body = json.loads(capsys.readouterr().out)
        assert [sp["name"] for sp in body["spans"]] == ["cli-span",
                                                        "cli-child"]
        assert td.main(["--url", s.url + "/traces", root.trace_id_hex,
                        "--format", "chrome"]) == 0
        assert len(json.loads(capsys.readouterr().out)["traceEvents"]) == 2
        assert td.main(["--url", s.url, "feedfacefeedface"]) == 1
        assert td.main(["--url", s.url + "/metrics", "abc123"]) == 2
    assert td.main(["--url", "http://127.0.0.1:1/"]) == 1
    assert td.main(["--format", "chrome"]) == 2
    capsys.readouterr()


# ---------------------------------------------------------------------------
# span-tree parity with the reference
# ---------------------------------------------------------------------------

def _tree(spans, root_id=None):
    """The canonical tree under `root_id` (None: the trace's roots): each
    node (name, status, attribute keys, children), children sorted."""
    kids = sorted(
        (_node(s, spans) for s in spans if s.parent_id == root_id),
        key=repr)
    return tuple(kids)


def _node(s, spans):
    return (s.name, s.status, tuple(sorted((s.attrs or {}).keys())),
            _tree(spans, s.span_id))


def _both(fn):
    """`fn(package_modules, trace, flight)` on both packages; returns
    {"ref": ..., "port": ...}."""
    import paddle_tpu.inference as jinf
    from paddle_tpu.inference import batching as jbatching
    from paddle_tpu.inference import replica as jrep
    from paddle_tpu.inference import router as jrt

    import paddle_tpu_torch.inference as tinf
    from paddle_tpu_torch.inference import batching as tbatching
    from paddle_tpu_torch.inference import replica as trep
    from paddle_tpu_torch.inference import router as trt

    mods = {"ref": (jinf, jrep, jrt, jbatching),
            "port": (tinf, trep, trt, tbatching)}
    out = {}
    for name, (tr, fl) in _packages().items():
        tr.enable()
        tr.set_sample_rate(1.0)
        fl.recorder().reset()
        out[name] = fn(mods[name], tr, fl)
    return out


def test_failover_span_tree_equals_the_reference():
    def scenario(mods, tr, fl):
        inf, rep, rt, _ = mods
        tid = _failover_trace(inf, rep, rt, fl)
        spans = fl.recorder().spans_for(tid)
        return _tree(spans), int(tid, 16) in fl.recorder().postmortem_ids()

    got = _both(scenario)
    assert got["port"] == got["ref"]
    tree, pinned = got["port"]
    assert not pinned
    (root,) = tree
    assert root[0] == "router.infer" and root[1] == "ok"
    attempts = [c for c in root[3] if c[0] == "router.attempt"]
    assert sorted(a[1] for a in attempts) == ["RequestFailed", "ok"]
    assert all({c[0] for c in a[3]} == {"serving.admit", "serving.execute"}
               for a in attempts)


def test_pool_failure_postmortem_tree_equals_the_reference():
    def scenario(mods, tr, fl):
        inf = mods[0]
        pool = make_pool(inf)
        try:
            with tr.root_span("failing") as root:
                with pytest.raises(inf.RequestFailed) as ei:
                    pool.submit(lambda p: (_ for _ in ()).throw(
                        ValueError("malformed"))).result()
        finally:
            pool.shutdown(drain_timeout=10.0)
        assert ei.value.trace_id == root.trace_id_hex
        pm = fl.recorder().postmortems()
        return (_tree(fl.recorder().spans_for(root.trace_id)),
                [(reason, n) for tid, reason, n in pm
                 if tid == root.trace_id])

    got = _both(scenario)
    assert got["port"] == got["ref"]
    tree, pinned = got["port"]
    assert pinned == [("RequestFailed", 3)]
    assert tree[0][0] == "failing" and tree[0][1] == "ok"
    assert ("serving.execute", "ValueError") in {
        c[:2] for c in tree[0][3]}


def test_batch_span_tree_equals_the_reference():
    def scenario(mods, tr, fl):
        _, roots, btid = _batch_traces(mods[3], tr, fl)
        members = [_tree(fl.recorder().spans_for(r.trace_id))
                   for r in roots]
        return _tree(fl.recorder().spans_for(btid)), members

    got = _both(scenario)
    assert got["port"] == got["ref"]
    batch, members = got["port"]
    (root,) = batch
    assert root[0] == "serving.batch"
    assert sorted(c[0] for c in root[3]) == [
        "serving::batch_dispatch", "serving::batch_form",
        "serving::batch_pad", "serving::batch_scatter"]
    assert all(m[0][3][0][0] == "serving.batch_member" for m in members)


def test_decode_sequence_span_tree_equals_the_reference(tmp_path):
    """One generation under a caller's root span, through the JAX demo
    engine and the port's over the same weights: the same sequence tree
    (its root a child of the caller's span, the prefill, the first-token
    mark, one back-link event a decode step) and each step a trace of its
    own linking the sequence."""
    from paddle_tpu.inference.decode import demo as jdemo
    from paddle_tpu.jit.aot import CompileCache

    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.inference.decode import demo as tdemo

    jm = jdemo.tiny_model(0)
    tm = tdemo.tiny_model(0, device="cpu")
    load_jax_state(tm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    prompt = tdemo.demo_prompt(5, 8)
    engines = {
        "ref": lambda: jdemo.tiny_engine(
            0, compile_cache=CompileCache(str(tmp_path / "cache"))),
        "port": lambda: tdemo.tiny_engine(0, model=tm, device="cpu")}
    got = {}
    for name, (tr, fl) in _packages().items():
        eng = engines[name]()
        try:
            # compiles outside the trace (another prompt: the traced one
            # is no prefix-cache hit, so it prefills)
            eng.generate(tdemo.demo_prompt(6, 8), 3)
            fl.recorder().reset()
            with tr.root_span("caller") as root:
                toks = list(eng.generate(prompt, 6))
        finally:
            eng.shutdown()
        spans = fl.recorder().spans_for(root.trace_id)
        steps = [t for t in fl.recorder().traces()
                 if t["root"] == "decode.step"]
        linked = [s for t in steps
                  for s in fl.recorder().spans_for(t["trace_id"])
                  if s.name == "decode.step"]
        got[name] = (toks, _tree(spans),
                     sorted(len(s.attrs["links"]) for s in linked))
    assert got["port"] == got["ref"]
    toks, tree, links = got["port"]
    (caller,) = tree
    (seq,) = caller[3]
    assert seq[0] == "decode.sequence"
    names = [c[0] for c in seq[3]]
    assert names.count("decode.step_join") == 5 == len(links)
    assert {"decode.prefill", "decode.first_token"} <= set(names)
