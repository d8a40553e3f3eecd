"""The port's serving runtime (`paddle_tpu_torch.inference.serving`,
`paddle_tpu_torch.obs`) held to the JAX package's: `CircuitBreaker` and
`RetryPolicy` under one scripted clock and one seeded `random.Random`
give equal states and delays; tests/test_serving.py's scenarios
(deadlines, overload shedding, wedge replacement, breaker trip and heal,
retry on a fresh clone, drain and drain timeout, the threaded stress run)
run over the same stub member in both pools, with equal final `stats()`
where the scenario is deterministic and the conservation law everywhere;
the metrics exposition renders byte for byte as the reference's; and the
port's own surface (a generation-only pool over the decode engine,
`serve_metrics`, the unported names) runs on the CPU."""
import concurrent.futures
import json
import random
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.inference as jinf
import paddle_tpu.obs.export as jexport
import paddle_tpu.obs.slo as jslo

import paddle_tpu_torch.inference as tinf
from paddle_tpu_torch.inference.decode.demo import demo_prompt, tiny_engine
from paddle_tpu_torch.obs import MetricsRegistry, export, slo

PKGS = {"jax": jinf, "torch": tinf}

#: stats() keys of a deterministic scenario that must agree between pools
DET_KEYS = ("size", "healthy", "closed", "admitted", "completed", "failed",
            "timed_out", "cancelled", "shed", "retried", "wedged",
            "reclones", "rebases", "breaker_trips", "queue_depth",
            "in_flight")


class Stub:
    """The member both pools serve: run() doubles its input."""

    def clone(self):
        return Stub()

    def reset_handles(self):
        pass

    def run(self, feeds):
        return [np.asarray(f) * 2.0 for f in feeds]


def _pool(inf, **kw):
    kw.setdefault("max_queue_depth", 16)
    kw.setdefault("default_timeout", 5.0)
    kw.setdefault("metrics", False)
    return inf.ServingPool(predictor=Stub(), **kw)


def _law(s):
    """The conservation law of a shut-down pool (nothing queued; a worker
    still stuck in its request holds it as cancelled already)."""
    return s["queue_depth"] == 0 and s["admitted"] == (
        s["completed"] + s["failed"] + s["timed_out"] + s["cancelled"])


def _both(scenario, deterministic=True):
    """Run `scenario(inf) -> stats` (taken after the pool's shutdown) on
    both pools; the law must hold on each, and a deterministic scenario's
    counters agree."""
    out = {name: scenario(inf) for name, inf in PKGS.items()}
    for name, s in out.items():
        assert _law(s), (name, s)
    if deterministic:
        j, t = out["jax"], out["torch"]
        assert {k: j[k] for k in DET_KEYS} == {k: t[k] for k in DET_KEYS}
    return out


def _wait(fn, timeout=5.0):
    give_up = time.monotonic() + timeout
    while time.monotonic() < give_up:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


# ---------------------------------------------------------------------------
# breaker and retry policy: one script, both packages
# ---------------------------------------------------------------------------

def _breaker_trace(inf):
    now = [0.0]
    br = inf.CircuitBreaker(threshold=3, reset_timeout=10.0,
                            clock=lambda: now[0])
    script = [(0.0, "fail"), (0.0, "fail"), (0.0, "allow"), (0.0, "fail"),
              (0.0, "allow"), (9.9, "allow"), (10.0, "allow"),
              (10.0, "allow"), (10.0, "cancel"), (10.0, "allow"),
              (10.0, "fail"), (15.0, "allow"), (20.0, "allow"),
              (20.0, "ok"), (20.0, "fail"), (20.0, "ok"), (20.0, "fail"),
              (20.0, "fail"), (20.0, "fail"), (29.0, "allow"),
              (30.0, "allow"), (30.0, "ok")]
    trace = []
    for t, op in script:
        now[0] = t
        res = {"fail": br.record_failure, "ok": br.record_success,
               "allow": br.allow, "cancel": br.cancel_probe}[op]()
        trace.append((t, op, res, br.state, br.trips))
    return trace


def test_breaker_equals_the_reference_under_one_scripted_clock():
    j, t = _breaker_trace(jinf), _breaker_trace(tinf)
    assert j == t
    assert {s for *_, s, _ in t} == {"closed", "open", "half_open"}


def test_retry_policy_equals_the_reference_with_one_seeded_rng():
    for kw in (dict(), dict(max_retries=5, base_delay=0.01, max_delay=0.3,
                            multiplier=3.0, jitter=0.9, max_elapsed=1.0)):
        jp = jinf.RetryPolicy(rng=random.Random(11), **kw)
        tp = tinf.RetryPolicy(rng=random.Random(11), **kw)
        assert [jp.delay(a) for a in range(1, 9)] \
            == [tp.delay(a) for a in range(1, 9)]
        grid = [(a, e) for a in range(0, 8) for e in (None, 0.0, 0.5, 0.99,
                                                      2.0)]
        assert [jp.should_retry(a, e) for a, e in grid] \
            == [tp.should_retry(a, e) for a, e in grid]


def test_deadline_basics():
    d = tinf.Deadline(0.05)
    assert not d.expired() and d.remaining() > 0
    time.sleep(0.08)
    assert d.expired() and d.remaining() < 0
    assert tinf.Deadline(None).remaining() is None


# ---------------------------------------------------------------------------
# tests/test_serving.py's scenarios on both pools
# ---------------------------------------------------------------------------

def _roundtrip(inf):
    with _pool(inf, size=2) as pool:
        out, = pool.infer([np.ones(2, np.float32)])
        np.testing.assert_allclose(out, np.full(2, 2.0))
        assert len(pool) == 2
    with pytest.raises(inf.PoolClosed):
        pool.submit(lambda p: None)
    return pool.stats()


def test_infer_roundtrip_and_shutdown():
    _both(_roundtrip)


def _dead_on_arrival(inf):
    pool = _pool(inf, size=1)
    try:
        with pytest.raises(inf.DeadlineExceeded, match="dead on arrival"):
            pool.submit(lambda p: None, timeout=-1.0)
    finally:
        pool.shutdown(1)
    return pool.stats()


def test_dead_on_arrival_is_shed():
    out = _both(_dead_on_arrival)
    assert out["torch"]["shed"] == 1 and out["torch"]["admitted"] == 0


def _queue_wait(inf):
    gate = threading.Event()
    pool = _pool(inf, size=1)
    try:
        blocker = pool.submit(lambda p: (gate.wait(5), "done")[1])
        time.sleep(0.05)
        ran = []
        queued = pool.submit(lambda p: ran.append(1), timeout=0.15)
        with pytest.raises(inf.DeadlineExceeded):
            queued.result()
        gate.set()
        assert blocker.result() == "done" and ran == []
    finally:
        pool.shutdown(1)
    return pool.stats()


def test_deadline_covers_queue_wait():
    assert _both(_queue_wait)["torch"]["timed_out"] == 1


def _wedge(inf):
    pool = _pool(inf, size=1, hang_grace=0.05, supervise_interval=0.01)
    try:
        t0 = time.monotonic()
        with pytest.raises(inf.DeadlineExceeded):
            pool.submit(lambda p: time.sleep(0.6), timeout=0.15).result()
        assert time.monotonic() - t0 < 0.45
        assert _wait(lambda: pool.stats()["healthy"] == 1
                     and pool.stats()["wedged"] == 1)
        assert pool.stats()["members"][0]["generation"] == 1
        out, = pool.infer([np.ones(2, np.float32)], timeout=2.0)
        np.testing.assert_allclose(out, np.full(2, 2.0))
    finally:
        pool.shutdown(1)
    return pool.stats()


def test_wedged_member_detected_and_replaced():
    for s in _both(_wedge).values():
        assert s["wedged"] == 1 and s["timed_out"] == 1 \
            and s["completed"] == 1


def test_supervisor_sleeps_until_the_next_deadline():
    """The port's supervisor on the monotonic clock wakes for the deadlines
    it watches, not every `supervise_interval`: 300 short requests and an
    idle spell cost it at most a few wake-ups where a 1 ms sweep would
    wake it hundreds of times, and a wedged member is still found at its
    deadline plus `hang_grace`."""
    pool = _pool(tinf, size=1, hang_grace=0.05, supervise_interval=0.001)
    try:
        for _ in range(300):
            out, = pool.infer([np.ones(2, np.float32)], timeout=5.0)
        time.sleep(0.1)
        assert pool._sup_wakes <= 3, pool._sup_wakes
        t0 = time.monotonic()
        with pytest.raises(tinf.DeadlineExceeded):
            pool.submit(lambda p: time.sleep(0.6), timeout=0.15).result()
        assert _wait(lambda: pool.stats()["wedged"] == 1, timeout=2.0)
        assert time.monotonic() - t0 < 0.45
        assert _wait(lambda: pool.stats()["healthy"] == 1)
        out, = pool.infer([np.ones(2, np.float32)], timeout=2.0)
        np.testing.assert_allclose(out, np.full(2, 2.0))
    finally:
        pool.shutdown(1)
    assert _law(pool.stats())


def _overload(inf):
    gate = threading.Event()
    pool = _pool(inf, size=1, max_queue_depth=2)
    try:
        blocker = pool.submit(lambda p: (gate.wait(5), "ok")[1])
        time.sleep(0.05)
        accepted = [pool.submit(lambda p: "fast") for _ in range(2)]
        for _ in range(5):
            with pytest.raises(inf.Overloaded, match="queue full"):
                pool.submit(lambda p: "never")
        gate.set()
        assert blocker.result() == "ok"
        assert [f.result() for f in accepted] == ["fast", "fast"]
    finally:
        pool.shutdown(1)
    return pool.stats()


def test_overload_shedding_and_recovery():
    s = _both(_overload)["torch"]
    assert s["shed"] == 5 and s["admitted"] == 3 and s["completed"] == 3


def _deterministic_error(inf):
    calls = []
    pool = _pool(inf, size=1)
    try:
        def bad(p):
            calls.append(1)
            raise ValueError("malformed request")

        with pytest.raises(inf.RequestFailed) as ei:
            pool.submit(bad, timeout=2).result()
        assert isinstance(ei.value.cause, ValueError)
        assert ei.value.attempts == 1 and len(calls) == 1
    finally:
        pool.shutdown(1)
    return pool.stats()


def test_deterministic_error_fails_fast_no_retry():
    s = _both(_deterministic_error)["torch"]
    assert s["retried"] == 0 and s["reclones"] == 0 and s["failed"] == 1
    assert s["members"][0]["breaker"] == "closed"


def _transient(inf):
    seen = []
    pool = _pool(inf, size=1, retry=inf.RetryPolicy(
        max_retries=2, base_delay=0.005, max_delay=0.02))
    try:
        def flaky(p):
            seen.append(id(p))
            if len(seen) < 3:
                raise RuntimeError("transient")
            return "recovered"

        assert pool.submit(flaky, timeout=5).result() == "recovered"
        assert len(set(seen)) == 3      # every attempt on a fresh clone
    finally:
        pool.shutdown(1)
    return pool.stats()


def test_transient_error_retried_on_fresh_clone():
    s = _both(_transient)["torch"]
    assert s["retried"] == 2 and s["reclones"] == 2 and s["completed"] == 1


def _budget(inf):
    pool = _pool(inf, size=1, retry=inf.RetryPolicy(
        max_retries=1, base_delay=0.005, max_delay=0.01))
    try:
        def always(p):
            raise RuntimeError("permanent transient-looking fault")

        with pytest.raises(inf.RequestFailed) as ei:
            pool.submit(always, timeout=5).result()
        assert ei.value.attempts == 2
        assert isinstance(ei.value.cause, RuntimeError)
    finally:
        pool.shutdown(1)
    return pool.stats()


def test_retry_budget_exhaustion_is_typed():
    _both(_budget)


def _poisoned(inf):
    poisoned = {"on": True}

    def hook(slot, req, pred):
        if poisoned["on"] and slot == 0:
            raise RuntimeError("poisoned")

    # five retries (the reference test has two): a request's first three
    # attempts may all land on slot 0 before its breaker trips, and a slow
    # machine may hand slot 0 a half-open probe after that
    pool = _pool(inf, size=2, breaker_threshold=3,
                 breaker_reset_timeout=0.2, fault_hook=hook,
                 retry=inf.RetryPolicy(max_retries=5, base_delay=0.005,
                                       max_delay=0.02))
    try:
        for _ in range(16):
            out, = pool.infer([np.ones(2, np.float32)], timeout=3.0)
            np.testing.assert_allclose(out, np.full(2, 2.0))
        s = pool.stats()
        assert s["breaker_trips"] >= 1 and s["healthy"] == 1, s
        poisoned["on"] = False
        give_up = time.monotonic() + 5
        while time.monotonic() < give_up:
            pool.infer([np.ones(2, np.float32)], timeout=2.0)
            if pool.stats()["healthy"] == 2:
                break
            time.sleep(0.02)
        assert pool.stats()["healthy"] == 2
    finally:
        pool.shutdown(1)
    return pool.stats()


def test_poisoned_slot_trips_breaker_then_heals():
    for s in _both(_poisoned, deterministic=False).values():
        assert s["failed"] == 0 and s["completed"] == s["admitted"]


def _drain(inf):
    gate = threading.Event()
    pool = _pool(inf, size=1)
    inflight = pool.submit(lambda p: (gate.wait(5), "inflight")[1])
    queued = pool.submit(lambda p: "queued")
    time.sleep(0.05)
    done = []
    t = threading.Thread(
        target=lambda: done.append(pool.shutdown(drain_timeout=5)))
    t.start()
    time.sleep(0.1)
    with pytest.raises(inf.PoolClosed):
        pool.submit(lambda p: None)
    gate.set()
    t.join(timeout=5)
    assert done == [True]
    assert inflight.result() == "inflight" and queued.result() == "queued"
    return pool.stats()


def test_graceful_drain_finishes_inflight_and_queued():
    s = _both(_drain)["torch"]
    assert s["cancelled"] == 0 and s["completed"] == 2


def _drain_timeout(inf):
    gate = threading.Event()
    pool = _pool(inf, size=1)
    stuck = pool.submit(lambda p: (gate.wait(10), "late")[1])
    waiting = pool.submit(lambda p: "queued")
    time.sleep(0.05)
    assert pool.shutdown(drain_timeout=0.1) is False
    with pytest.raises(inf.PoolClosed):
        waiting.result(timeout=1)
    with pytest.raises(inf.PoolClosed):
        stuck.result(timeout=1)
    gate.set()
    assert pool.shutdown(1) is False       # idempotent: the same outcome
    return pool.stats()


def test_drain_timeout_cancels_leftovers_typed():
    assert _both(_drain_timeout)["torch"]["cancelled"] == 2


def _stress(inf):
    lock = threading.Lock()
    running, max_conc, hung = {}, [0], [False]

    def hook(slot, req, pred):
        if slot == 0 and req.id % 9 == 4 and req.attempts == 1:
            raise RuntimeError("injected crash")
        if slot == 1 and not hung[0] and req.id > 20:
            hung[0] = True
            time.sleep(0.6)   # one wedge: the supervisor replaces slot 1

    pool = _pool(inf, size=3, max_queue_depth=128, default_timeout=2.0,
                 hang_grace=0.05, supervise_interval=0.01, fault_hook=hook,
                 retry=inf.RetryPolicy(max_retries=2, base_delay=0.005,
                                       max_delay=0.02))

    def request(i):
        def fn(pred):
            with lock:
                n = running.get(id(pred), 0) + 1
                running[id(pred)] = n
                max_conc[0] = max(max_conc[0], n)
            try:
                time.sleep(0.001)
                return pred.run([np.full(2, float(i), np.float32)])
            finally:
                with lock:
                    running[id(pred)] -= 1
        try:
            out, = pool.submit(fn, timeout=2.0).result()
            np.testing.assert_allclose(out, np.full(2, 2.0 * i))
            return "ok"
        except (inf.DeadlineExceeded, inf.Overloaded,
                inf.RequestFailed) as e:
            return type(e).__name__

    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=16) as ex:
            results = list(ex.map(request, range(120)))
        assert max_conc[0] == 1, "two requests ran on one member at once"
        assert results.count("ok") >= 100, results
        assert _wait(lambda: pool.stats()["queue_depth"] == 0
                     and pool.stats()["in_flight"] == 0
                     and pool.stats()["healthy"] == 3)
        s = pool.stats()
        assert s["admitted"] == 120 and s["completed"] == results.count("ok")
        assert s["admitted"] == s["completed"] + s["failed"] \
            + s["timed_out"] + s["cancelled"]
    finally:
        assert pool.shutdown(drain_timeout=2) is True
    return pool.stats()


def test_stress_conservation_under_faults():
    """With a short switch interval, so that a lost update between the
    workers, the supervisor and the callers would show in the law."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = _both(_stress, deterministic=False)
    finally:
        sys.setswitchinterval(old)
    for s in out.values():
        assert s["admitted"] == 120 and s["retried"] >= 1


def test_rebase_reclones_every_slot():
    def scenario(inf):
        with _pool(inf, size=3) as pool:
            before = [m["generation"] for m in pool.stats()["members"]]
            pool.rebase(Stub())
            after = [m["generation"] for m in pool.stats()["members"]]
            assert after == [g + 1 for g in before]
            pool.infer([np.ones(2)])
        with pytest.raises(inf.PoolClosed):
            pool.rebase(Stub())
        return pool.stats()

    assert _both(scenario)["torch"]["rebases"] == 1


# ---------------------------------------------------------------------------
# the port's surface
# ---------------------------------------------------------------------------

def test_unported_names_raise_naming_their_slice():
    """Every name is ported now: misused, they raise as the reference's do
    (a process replica without its store, a serve loop without its
    address, warmup() without batching, batching over a member with no
    exported layer, a pool with nothing to serve)."""
    from paddle_tpu.inference.replica import serve_replica as jserve
    from paddle_tpu_torch.inference.replica import serve_replica

    for inf, serve in ((jinf, jserve), (tinf, serve_replica)):
        with pytest.raises(TypeError, match="store"):
            inf.SubprocessReplica("r0")
        with pytest.raises(TypeError, match="rid"):
            serve()
    # (the reference's pool raises AttributeError there: Stub has no _layer)
    with pytest.raises(TypeError, match="batched_call"):
        tinf.ServingPool(predictor=Stub(), batching=True)
    for inf in (jinf, tinf):
        with _pool(inf) as pool, \
                pytest.raises(RuntimeError, match="batching"):
            pool.warmup()
        with pytest.raises(ValueError, match="predictor="):
            inf.ServingPool()
    for name in ("Config", "Predictor", "PredictorPool", "BatchConfig",
                 "DynamicBatcher", "create_predictor"):
        assert name in tinf.__all__ and callable(getattr(tinf, name))


def test_generation_only_pool_serves_the_engine_and_drains_it():
    """A `ServingPool(decode_engine=...)` serves `generate` and
    `submit_generate` on the engine (the same tokens as the engine's own
    submit), nests its stats, and its shutdown drains the engine to
    allocated == 0."""
    eng = tiny_engine(0, device="cpu")
    ref = eng.generate(demo_prompt(3, 7), 6)
    pool = tinf.ServingPool(decode_engine=eng, metrics=False)
    try:
        assert pool.generate(demo_prompt(3, 7), 6) == ref
        s = pool.submit_generate(demo_prompt(3, 7), 6, timeout=30.0)
        assert list(s) == ref
        assert pool.stats()["decode"]["completed"] == 3
        assert pool.submit(lambda m: type(m).__name__).result() \
            == "_NullPredictor"
    finally:
        assert pool.shutdown(drain_timeout=10.0)
    assert eng.stats()["blocks"]["allocated"] == 0
    with pytest.raises(tinf.PoolClosed):
        eng.submit(demo_prompt(3, 7), 2)
    with pytest.raises(RuntimeError, match="decode engine"):
        _pool(tinf).submit_generate([1, 2], 2)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_serve_metrics_exports_the_conservation_law_and_health():
    reg = MetricsRegistry()
    pool = tinf.ServingPool(predictor=Stub(), size=2, metrics=reg,
                            name="scrape")
    try:
        for _ in range(3):
            pool.infer([np.ones(2)])
        server = pool.serve_metrics(port=0)
        assert pool.serve_metrics() is server
        code, text = _get(server.url + "/metrics")
        assert code == 200
        assert "serving_pool_scrape_admitted 3" in text
        assert "serving_pool_scrape_completed 3" in text
        assert "# TYPE serving_request_seconds histogram" in text
        code, body = _get(server.url + "/healthz")
        assert code == 200 and json.loads(body)["healthy"] == 2
        code, body = _get(server.url + "/metrics.json")
        assert json.loads(body)["collectors"]["serving.pool.scrape"][
            "completed"] == 3
        code, body = _get(server.url + "/traces")
        assert code == 200 and "traces" in json.loads(body)
    finally:
        pool.shutdown(1)
    assert not server.running
    assert "serving.pool.scrape" not in reg.collector_names()


def test_exposition_renders_as_the_reference():
    """The same snapshot through both renderers gives the same bytes; the
    histograms' quantiles equal the reference's on the same data."""
    from paddle_tpu.obs.metrics import Histogram as JHistogram

    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", help="a latency")
    jh = JHistogram("lat_seconds")
    for v in np.random.RandomState(0).lognormal(-4, 1.5, 500):
        h.observe(v)
        jh.observe(v)
    for q in (0.5, 0.95, 0.99):
        assert h.quantile(q) == jh.quantile(q)
    reg.counter("reqs", labels={"kind": "a"}).inc(3)
    reg.gauge("depth").set(2.5)
    reg.register_collector("pool", lambda: {
        "admitted": 4, "ok": True, "name": "x",
        "members": [{"i": 1, "alive": False}], "nested": {"a": 0.25}})
    snap = reg.snapshot()
    assert export.render_prometheus(snap) == jexport.render_prometheus(snap)
    assert export.render_json(snap) == jexport.render_json(snap)
    with pytest.raises(TypeError):
        reg.gauge("lat_seconds")


def test_slo_evaluate_equals_the_reference():
    values = {"p99": 0.2, "tput": 50.0, "ttft": 0.05}
    base = {"p99": {"kind": "max", "bound": 0.1},
            "tput": {"kind": "min", "bound": 40.0}}
    for mod, ref in ((slo, jslo),):
        objs = [mod.Objective("p99", "max", unit="s"),
                mod.Objective("tput", "min"), mod.Objective("ttft", "max"),
                mod.Objective("gone", "min")]
        robjs = [ref.Objective(o.name, o.kind, unit=o.unit) for o in objs]
        got, want = mod.evaluate(values, base, objs), \
            ref.evaluate(values, base, robjs)
        assert got["ok"] == want["ok"] is False
        assert got["breaches"] == want["breaches"] == ["p99", "ttft",
                                                       "gone"]
        keys = ("name", "kind", "unit", "value", "bound", "ok")
        assert [{k: r[k] for k in keys} for r in got["results"]] \
            == [{k: r[k] for k in keys} for r in want["results"]]
        assert "FAIL p99: 0.2 <= 0.1 s" in mod.format_report(got)
