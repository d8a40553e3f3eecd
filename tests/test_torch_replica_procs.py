"""Process replicas of the port (`SubprocessReplica` / `serve_replica`
over the port's `TCPStore`) on the CPU, at tiny size: the counterparts of
the reference's subprocess tests (tests/test_router.py, the two process
cases; tests/test_obs_trace.py, the cross-process merge), run here with
every replica process on ``device="cpu"``.

* Two processes behind a `ServingRouter(heartbeats=store)`: a SIGKILL
  under traffic fails over and the replica is respawned, then a committed
  weight swap; every output is held to the JAX `Predictor` on the same
  weights (`convert.load_jax_artifact_params`).
* A stream whose replica is SIGSTOPped, then SIGKILLed, mid-generation:
  its tokens equal the JAX demo engine's uninterrupted greedy run; a
  cancel over the store frees the replica's sequence.
* A trace minted by the router holds spans of both processes, merged by
  ``/traces/<id>``.
* A replica process SIGSTOPped mid-request and SIGCONTed after a wedge
  shorter than the heartbeat ttl (a small request, and one of 64 MB, far
  larger than the socket buffers, stopped while the process reads it) or
  longer than the ttl: the same script runs against the reference's
  `SubprocessReplica` and store, and the port must end as the reference
  does — served again by the same process, or declared dead and
  respawned — with every request answered once.

The replica processes import this module for their decode factory
(`demo_factory`), so it imports nothing of JAX at module level. Every
process is killed in a ``finally``.
"""
import concurrent.futures
import json
import os
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.distributed.store import create_master_store
from paddle_tpu_torch.inference import (RequestFailed, RetryPolicy,
                                        RouterConfig, ServingRouter,
                                        SubprocessReplica, commit_model_dir)
from paddle_tpu_torch.obs import flight, trace

HERE = os.path.dirname(os.path.abspath(__file__))
#: where `demo_factory` finds the converted demo weights (set by the test)
WEIGHTS_ENV = "PADDLE_TPU_TORCH_TEST_DEMO_WEIGHTS"
START = 120.0                   # a spawn's start_timeout (s)


def demo_factory(generation):
    """Runs in a replica process: the port's slowed demo engine of
    `generation` on the CPU, with the weights the test converted from the
    JAX demo model of that generation."""
    from paddle_tpu_torch.inference.decode import demo

    assert "jax" not in sys.modules
    model = demo.tiny_model(generation, device="cpu")
    model.load_state_dict(torch.load(os.path.join(
        os.environ[WEIGHTS_ENV], f"gen{int(generation)}.pt")))
    return demo.tiny_engine_slow(generation, model=model, device="cpu")


def _config(**over):
    kw = dict(heartbeat_ttl=2.0, supervise_interval=0.02, start_grace=START,
              attempt_timeout=15.0, probe_timeout=60.0,
              breaker_reset_timeout=0.1, no_capacity_wait=5.0,
              restart_backoff=RetryPolicy(base_delay=0.05, max_delay=0.5),
              failover=RetryPolicy(max_retries=4, base_delay=0.002,
                                   max_delay=0.01, max_elapsed=60.0))
    kw.update(over)
    return RouterConfig(**kw)


def _wait_until(fn, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


def _tier(store, size, model_dir, generation, **kw):
    """A replica factory whose first `size` replicas are spawned at once
    (later calls spawn one by one), and the dict of every replica it made
    (the test kills them all in its ``finally``)."""
    made = {}

    def spawn(rid, d, gen):
        rep = SubprocessReplica(rid, store, d, gen, artifact_name="model",
                                start_timeout=START, device="cpu", **kw)
        made.setdefault(rid, []).append(rep)
        return rep

    with concurrent.futures.ThreadPoolExecutor(size) as ex:
        first = dict(zip(
            (f"replica-{i}" for i in range(size)),
            ex.map(lambda i: spawn(f"replica-{i}", model_dir, generation),
                   range(size))))

    def factory(rid, d, gen):
        rep = first.pop(rid, None)
        return rep if rep is not None else spawn(rid, d, gen)

    return factory, made


def _kill_all(made):
    for reps in made.values():
        for rep in reps:
            rep.kill()


def _prepend_path(monkeypatch, path):
    old = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH",
                       path + (os.pathsep + old if old else ""))


def _export_linear(tmp_path, seed, name):
    """A Linear(4, 2) of `seed` (in a Sequential, as the weight bridge
    names it) exported by both packages into
    <tmp>/<name>/: the JAX artifact ``jax``, the port's ``model`` (the
    JAX weights); returns (directory, JAX prefix)."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn

    from paddle_tpu_torch.convert import load_jax_artifact_params

    d = tmp_path / name
    d.mkdir()
    x = np.zeros((1, 4), np.float32)
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(4, 2))
    jm.eval()
    paddle.jit.save(jm, str(d / "jax"), input_spec=[paddle.to_tensor(x)])
    tm = torch.nn.Sequential(torch.nn.Linear(4, 2))
    load_jax_artifact_params(tm, str(d / "jax"))
    tm.eval()
    tjit.save(tm, str(d / "model"), input_spec=[x])
    return str(d), str(d / "jax")


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


@pytest.fixture()
def store():
    s = create_master_store()
    yield s
    s.close()


def test_subprocess_replicas_failover_and_swap(tmp_path, store):
    """SIGKILL one of two processes under traffic (failover, then a
    supervised respawn), then a committed weight swap: every output equals
    the JAX Predictor's on the same weights, every stamp its generation."""
    from paddle_tpu.inference import Config as JConfig
    from paddle_tpu.inference import Predictor as JPredictor

    d0, j0 = _export_linear(tmp_path, 0, "g0")
    d1, j1 = _export_linear(tmp_path, 1, "g1")
    commit_model_dir(d0, 1)
    commit_model_dir(d1, 2)
    x = np.random.RandomState(3).rand(1, 4).astype(np.float32)
    want = {1: JPredictor(JConfig(j0)).run([x])[0],
            2: JPredictor(JConfig(j1)).run([x])[0]}
    assert not np.allclose(want[1], want[2])
    factory, made = _tier(store, 2, d0, 1)
    try:
        r = ServingRouter(factory, size=2, model_dir=d0, generation=1,
                          config=_config(), heartbeats=store, metrics=False)
        try:
            out, = r.infer([x], timeout=60.0)
            np.testing.assert_allclose(out, want[1], rtol=1e-6)
            first = r._records[0].replica
            pid = first.pid
            first.kill()
            for _ in range(4):          # idempotent traffic fails over
                out, = r.infer([x], timeout=60.0)
                np.testing.assert_allclose(out, want[1], rtol=1e-6)
            assert _wait_until(lambda: r.stats()["ready"] == 2
                               and r.stats()["deaths"] >= 1, 60.0)
            assert first.restarts == 1 and first.pid != pid
            assert r.swap_weights(d1, drain_timeout=60.0) == 2
            for _ in range(4):
                outs, g = r.infer_stamped([x], timeout=60.0)
                assert g == 2
                np.testing.assert_allclose(outs[0], want[2], rtol=1e-6)
            s = r.stats()
            assert s["admitted"] == s["completed"] == 9
            assert s["swaps"] == 1
        finally:
            r.shutdown(drain_timeout=10.0)
        assert all(rep.stats()["killed"] for reps in made.values()
                   for rep in reps)
    finally:
        _kill_all(made)


def test_subprocess_stream_failover_resumes_bit_exact(tmp_path, store,
                                                      monkeypatch):
    """A stream's replica process is frozen (SIGSTOP), then SIGKILLed,
    mid-generation: the stream fails over through the store and reads the
    JAX demo engine's uninterrupted greedy tokens, with no duplicate and
    no gap; the replica process's spans come home on its frames. A
    cancel over the store frees the surviving replica's sequence."""
    from paddle_tpu.inference.decode import demo as jdemo

    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.inference.decode import demo as tdemo

    from paddle_tpu.jit.aot import CompileCache

    wdir = tmp_path / "weights"
    wdir.mkdir()
    jm = jdemo.tiny_model(1)
    tm = tdemo.tiny_model(1, device="cpu")
    load_jax_state(tm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    torch.save(tm.state_dict(), str(wdir / "gen1.pt"))
    monkeypatch.setenv(WEIGHTS_ENV, str(wdir))
    _prepend_path(monkeypatch, HERE)
    prompt = jdemo.demo_prompt(5, 8)
    ref_eng = jdemo.tiny_engine(1, compile_cache=CompileCache(
        str(tmp_path / "cache")))
    try:
        ref = list(ref_eng.generate(prompt, 12))
    finally:
        ref_eng.shutdown()
    d0, _ = _export_linear(tmp_path, 0, "g0")
    commit_model_dir(d0, 1)
    factory, made = _tier(
        store, 2, d0, 1,
        decode_factory="test_torch_replica_procs:demo_factory")
    try:
        r = ServingRouter(factory, size=2, model_dir=d0, generation=1,
                          config=_config(affinity_block_tokens=8),
                          heartbeats=store, metrics=False)
        try:
            rs = r.submit_generate(prompt, 12, timeout=120.0)
            it = iter(rs)
            got = [next(it) for _ in range(4)]
            victim = next(m["rid"] for m in r.stats()["members"]
                          if m["streams"] > 0)
            rep = made[victim][-1]
            # frozen first, so the engine cannot run ahead, then killed:
            # the stream is mid-flight when the process dies
            rep.wedge()
            time.sleep(0.2)
            rep.kill()
            got += list(it)
            assert got == ref
            st = r.stats()["streams"]
            assert st["failovers"] >= 1 and st["resumed"] >= 1
            assert st["admitted"] == (st["completed"] + st["failed"]
                                      + st["timed_out"] + st["cancelled"]
                                      + st["in_flight"])
            pids = {s.pid for s in flight.recorder().spans_for(rs.trace_id)
                    if s.name == "replica.generate"}
            assert pids and os.getpid() not in pids
            rs2 = r.submit_generate(prompt, 12, timeout=120.0)
            next(iter(rs2))
            rs2.cancel()
            with pytest.raises(RequestFailed, match="cancelled"):
                rs2.result(timeout=30.0)
            assert _wait_until(
                lambda: all(m["streams"] == 0
                            for m in r.stats()["members"]), 30.0)
            # the replica's load counts its engine's live sequences: 0
            # means the cancelled sequence left the engine
            assert _wait_until(
                lambda: all(rec.replica.queue_depth() == 0
                            for rec in r._records
                            if rec.replica.pid != rep.pid), 30.0)
        finally:
            r.shutdown(drain_timeout=10.0)
    finally:
        _kill_all(made)


def test_subprocess_replica_trace_merges_across_processes(tmp_path, store):
    """A trace id minted by the router reaches spans recorded inside the
    replica process, and ``/traces/<id>`` serves the merged record: the
    router's spans with this pid, ``replica.infer`` and
    ``serving.execute`` with the replica process's."""
    trace.enable()
    d0, _ = _export_linear(tmp_path, 0, "model")
    factory, made = _tier(store, 1, d0, 0)
    try:
        r = ServingRouter(factory, size=1, model_dir=d0, heartbeats=store,
                          config=_config())
        try:
            x = np.random.RandomState(0).rand(1, 4).astype(np.float32)
            r.warmup(feeds=[x])
            with trace.root_span("e2e") as root:
                r.infer_stamped([x], timeout=60.0)
            spans = flight.recorder().spans_for(root.trace_id)
            by_name = {}
            for s in spans:
                by_name.setdefault(s.name, []).append(s)
            assert {"e2e", "router.infer", "router.attempt",
                    "replica.infer", "serving.admit",
                    "serving.execute"} <= set(by_name)
            remote = by_name["replica.infer"][0]
            assert remote.pid != os.getpid()
            assert remote.pid == made["replica-0"][-1].pid
            assert {s.pid for s in by_name["serving.execute"]} == \
                {remote.pid}
            assert remote.parent_id == by_name["router.attempt"][0].span_id
            server = r.serve_metrics()
            body = json.loads(urllib.request.urlopen(
                server.url + f"/traces/{root.trace_id_hex}",
                timeout=5).read())
            assert {sp["pid"] for sp in body["spans"]} == {os.getpid(),
                                                           remote.pid}
        finally:
            r.shutdown(drain_timeout=10.0)
    finally:
        _kill_all(made)


# ------------------------------------------------------------------ wedges

WEDGE_TTL = 1.0                     # the routers' heartbeat ttl (s)
#: (request floats, wedge seconds) of each case: a 16-byte request, and a
#: 64 MB one (its reply 64 MB too), larger than the socket buffers
WEDGE_CASES = {"short": (4, 0.4), "long": (4, 2.5),
               "short, 64 MB": (16_000_000, 0.4)}


def _doubler(pkg, d, n):
    """Export ``x * 2`` on [1, n] float32 with `pkg`'s `jit.save` into
    <d>/model."""
    os.makedirs(d)
    x = np.zeros((1, n), np.float32)
    if pkg == "paddle_tpu":
        import paddle_tpu as paddle
        from paddle_tpu import nn as jnn

        class Double(jnn.Layer):
            def forward(self, t):
                return t * 2.0

        m = Double()
        m.eval()
        paddle.jit.save(m, os.path.join(d, "model"),
                        input_spec=[paddle.to_tensor(x)])
    else:
        class Double(torch.nn.Module):
            def forward(self, t):
                return t * 2.0

        tjit.save(Double().eval(), os.path.join(d, "model"), input_spec=[x])


def _resident(pid):
    with open(f"/proc/{pid}/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _wedge_run(pkg, d, n, wedge_s):
    """One replica process of `pkg` behind its router and store; a
    request in flight while the process is SIGSTOPped (a 64 MB one once
    the process has read a megabyte of it), SIGCONT after `wedge_s`, then
    one more request. Returns how it ended."""
    import importlib

    inf = importlib.import_module(pkg + ".inference")
    store = importlib.import_module(
        pkg + ".distributed.store").create_master_store()
    kw = {} if pkg == "paddle_tpu" else {"device": "cpu"}
    made = []

    def factory(rid, model_dir, gen):
        rep = inf.SubprocessReplica(rid, store, model_dir, gen,
                                    artifact_name="model",
                                    start_timeout=START, **kw)
        made.append(rep)
        return rep

    cfg = inf.RouterConfig(
        heartbeat_ttl=WEDGE_TTL, supervise_interval=0.02, start_grace=START,
        attempt_timeout=30.0, probe_timeout=60.0, no_capacity_wait=60.0,
        restart_backoff=inf.RetryPolicy(base_delay=0.05, max_delay=0.5),
        failover=inf.RetryPolicy(max_retries=4, base_delay=0.002,
                                 max_delay=0.01, max_elapsed=60.0))
    x = np.random.RandomState(0).rand(1, n).astype(np.float32)
    try:
        r = inf.ServingRouter(factory, size=1, model_dir=d, config=cfg,
                              heartbeats=store, metrics=False)
        try:
            outs = [r.infer([x], timeout=60.0)[0]]
            rep = made[-1]
            pid = rep._proc.pid
            base = _resident(pid)
            with concurrent.futures.ThreadPoolExecutor(1) as ex:
                fut = ex.submit(r.infer, [x], timeout=60.0)
                deadline = time.monotonic() + 30.0
                while n > 4 and _resident(pid) - base < (1 << 20) \
                        and time.monotonic() < deadline:
                    time.sleep(0.0002)
                rep.wedge()
                in_flight = not fut.done()
                time.sleep(wedge_s)
                rep.unwedge()
                outs.append(fut.result(timeout=60.0)[0])
            outs.append(r.infer([x], timeout=60.0)[0])
            st = r.stats()
            return {"served_again": made[-1]._proc.pid == pid,
                    "deaths": st["deaths"], "in_flight": in_flight,
                    "answered": (st["admitted"], st["completed"]),
                    "correct": all(np.array_equal(o, 2 * x) for o in outs)}
        finally:
            r.shutdown(drain_timeout=5.0)
    finally:
        _kill_all({"r": made})
        store.close()


@pytest.mark.parametrize("case", list(WEDGE_CASES))
def test_wedged_process_replica_ends_as_the_reference_does(case, tmp_path,
                                                          monkeypatch):
    """SIGSTOP mid-request, SIGCONT after `case`'s wedge: the port's
    replica and the reference's, side by side, end the same way. Shorter
    than the ttl: served again by the same process (for the 64 MB
    request the port's daemon drops the stopped reader after 200 ms and
    its client reconnects and reads the request again; the reference's
    daemon waits for it, every client frozen meanwhile). Longer: declared
    dead, killed and respawned, the request answered by the new
    process."""
    _prepend_path(monkeypatch, os.path.dirname(HERE))
    n, wedge_s = WEDGE_CASES[case]
    runs = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        _doubler(pkg, str(tmp_path / pkg), n)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = {pkg: ex.submit(_wedge_run, pkg, str(tmp_path / pkg), n,
                               wedge_s)
                for pkg in ("paddle_tpu", "paddle_tpu_torch")}
        runs = {pkg: f.result() for pkg, f in futs.items()}
    for pkg, run in runs.items():
        assert run["in_flight"] and run["correct"], (pkg, run)
        assert run["answered"] == (3, 3), (pkg, run)
        assert run["served_again"] == (run["deaths"] == 0), (pkg, run)
    assert runs["paddle_tpu_torch"]["served_again"] \
        == runs["paddle_tpu"]["served_again"] == (wedge_s < WEDGE_TTL), runs
