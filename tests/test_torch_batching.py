"""Port parity of dynamic request batching (`paddle_tpu_torch.inference.
batching` and `ServingPool(config=, batching=)` over `jit.aot`'s bucket
programs), the counterparts of tests/test_batching.py.

One tiny model for the module: the JAX package's seeded
``Sequential(Linear(6, 8), ReLU, Linear(8, 3))`` exported by
`paddle_tpu.jit.save`, its weights read into the port's model
(`convert.load_jax_artifact_params`) and exported again by the port. The
references are each feed's unbatched `Predictor.run` in both packages:
every batched output of the port equals the port's own single run bit
for bit, and the JAX package's to 1e-5 relative and 1e-6 absolute (f32,
other summation order). The JAX side runs no bucket executables: the
reference's batched path fails alone on some machines (its persistent
compile cache), so the port is held to the JAX `Predictor.run` instead.

The compile-cache tests of the reference become tests of the refusal: a
CUDA graph has no serialized form, so the port keeps no persistent cache
of bucket programs (`jit.aot.NO_DISK_CACHE`). The lock-order checker test
has no counterpart (the port has no lock checker).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate

from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.convert import load_jax_artifact_params
from paddle_tpu_torch.inference import (BatchConfig, Config,
                                        DeadlineExceeded, DynamicBatcher,
                                        RequestFailed, ServingPool,
                                        create_predictor)
from paddle_tpu_torch.inference.serving import RetryPolicy

BUCKETS = (1, 2, 4, 8)


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


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("batching")
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(6, 8), jnn.ReLU(), jnn.Linear(8, 3))
    jm.eval()
    jpath = str(root / "jax")
    paddle.jit.save(jm, jpath, input_spec=[
        paddle.to_tensor(np.zeros((1, 6), np.float32))])
    tm = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                             torch.nn.Linear(8, 3))
    load_jax_artifact_params(tm, jpath)
    path = str(root / "port")
    tjit.save(tm.eval(), path, input_spec=[np.zeros((1, 6), np.float32)])
    rng = np.random.RandomState(3)
    feeds = [rng.rand(1, 6).astype(np.float32) for _ in range(16)]
    jref = jcreate(JConfig(jpath))
    want_jax = [jref.run([f])[0] for f in feeds]
    ref = create_predictor(_cpu(path))
    want = [ref.run([f])[0] for f in feeds]
    for w, j in zip(want, want_jax):
        np.testing.assert_allclose(w, j, rtol=1e-5, atol=1e-6)
    return {"path": path, "feeds": feeds, "want": want,
            "want_jax": want_jax}


def _cpu(path):
    cfg = Config(path)
    cfg.disable_gpu()
    return cfg


def _pool(exported, **kw):
    kw.setdefault("default_timeout", 30.0)
    kw.setdefault("batching", BatchConfig(buckets=BUCKETS, max_wait_ms=50.0))
    return ServingPool(predictor=create_predictor(_cpu(exported["path"])),
                       size=kw.pop("size", 1), **kw)


def _submit_wave(pool, exported, indices, timeout=30.0):
    futs = []
    for i in indices:
        feeds = pool._batcher.validate([exported["feeds"][i]])
        futs.append(pool._admit(
            lambda p, f=feeds: p.run(f), timeout, feeds=feeds))
    return futs


def _gated_wave(pool, exported, indices, timeout=30.0):
    """Park the sole worker on a gate, queue the wave, open the gate: the
    worker then forms batches from exactly that wave."""
    gate = threading.Event()
    blocker = pool.submit(lambda p: (gate.wait(10), "gate")[1])
    time.sleep(0.05)
    futs = _submit_wave(pool, exported, indices, timeout=timeout)
    gate.set()
    assert blocker.result() == "gate"
    return futs


def _check(exported, i, out):
    assert out.shape == exported["want"][i].shape
    assert (out == exported["want"][i]).all(), \
        f"request {i}: batched output differs bitwise from the single run"
    np.testing.assert_allclose(out, exported["want_jax"][i], rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# bit-equality across buckets and ragged tails
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 11])
def test_batched_outputs_bit_identical_across_buckets(exported, n):
    with _pool(exported) as pool:
        futs = _gated_wave(pool, exported, range(n))
        for i, f in enumerate(futs):
            out, = f.result()
            _check(exported, i, out)
        b = pool.stats()["batch"]
        assert sum(k * v for k, v in b["executed_by_bucket"].items()) \
            == b["requests"] + b["padded_examples"]


def test_single_request_via_bucket1_matches_plain_run(exported):
    cfg = BatchConfig(buckets=BUCKETS, max_wait_ms=0.0)
    with _pool(exported, batching=cfg) as pool:
        out, = pool.infer([exported["feeds"][0]])
        _check(exported, 0, out)
        assert pool.stats()["batch"]["executed_by_bucket"] == {1: 1}


# ---------------------------------------------------------------------------
# dispatch counting + stats
# ---------------------------------------------------------------------------

def test_dispatch_count_at_most_ceil_n_over_bucket(exported):
    with _pool(exported) as pool:
        futs = _gated_wave(pool, exported, range(8))
        for f in futs:
            f.result()
        b = pool.stats()["batch"]
        assert b["executed_by_bucket"] == {8: 1}, b
        assert b["formed"] == 1 and b["requests"] == 8
        assert b["padded_examples"] == 0
        assert b["occupancy"] == 1.0
        assert b["flushes"]["full"] == 1


def test_occupancy_queue_wait_and_conservation(exported):
    with _pool(exported) as pool:
        futs = _gated_wave(pool, exported, range(5))
        for f in futs:
            f.result()
        s = pool.stats()
        b = s["batch"]
        assert b["requests"] == 5
        assert sum(k * v for k, v in b["executed_by_bucket"].items()) \
            == 5 + b["padded_examples"]
        assert 0.0 < b["occupancy"] <= 1.0
        assert b["queue_wait_ms_total"] >= b["queue_wait_ms_max"] >= 0.0
        assert b["execute_ms_total"] > 0.0
        assert s["admitted"] == 6
        assert s["admitted"] == s["completed"] + s["failed"] \
            + s["timed_out"] + s["cancelled"]


def test_histograms_observe_queue_wait_and_execute(exported):
    """The pool's obs histograms are filled by the batch path: one
    queue-wait observation a request, one execute observation a batch."""
    from paddle_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    with _pool(exported, metrics=reg) as pool:
        futs = _gated_wave(pool, exported, range(8))
        for f in futs:
            f.result()
        assert pool._batcher.h_queue_wait is pool._h_queue_wait
        q = pool._h_queue_wait.snapshot()
        e = pool._h_execute.snapshot()
    # the gate request is one queue wait and one execution of its own
    assert q["count"] == 9 and e["count"] == 2


# ---------------------------------------------------------------------------
# deadline pressure
# ---------------------------------------------------------------------------

def test_deadline_pressure_flushes_partial_batch_early(exported):
    cfg = BatchConfig(buckets=(8,), max_wait_ms=5000.0,
                      deadline_margin_ms=150.0)
    with _pool(exported, batching=cfg) as pool:
        t0 = time.monotonic()
        futs = _submit_wave(pool, exported, range(2), timeout=0.3)
        outs = [f.result() for f in futs]
        wall = time.monotonic() - t0
        for i, (out,) in enumerate(outs):
            _check(exported, i, out)
        assert wall < 2.0, f"partial batch waited {wall:.2f}s"
        b = pool.stats()["batch"]
        assert b["flushes"]["deadline"] >= 1, b["flushes"]
        assert b["padded_examples"] >= 6


# ---------------------------------------------------------------------------
# failure isolation: split retry
# ---------------------------------------------------------------------------

def test_poison_request_is_the_only_failure_in_its_batch(exported):
    poison = {"id": None}

    def hook(slot, req, pred):
        if req.id == poison["id"]:
            raise ValueError("poison request")

    with _pool(exported, fault_hook=hook) as pool:
        gate = threading.Event()
        blocker = pool.submit(lambda p: (gate.wait(10), "g")[1])
        time.sleep(0.05)
        futs = _submit_wave(pool, exported, range(4))
        poison["id"] = futs[2].id
        gate.set()
        blocker.result()
        for i, f in enumerate(futs):
            if i == 2:
                with pytest.raises(RequestFailed) as ei:
                    f.result()
                assert isinstance(ei.value.cause, ValueError)
            else:
                out, = f.result()
                _check(exported, i, out)
        s = pool.stats()
        assert s["batch"]["splits"] == 1
        assert s["batch"]["split_requests"] == 4
        assert s["reclones"] == 0
        assert s["members"][0]["breaker"] == "closed"


def test_transient_batch_failure_splits_and_all_recover(exported):
    calls = {"n": 0}

    def hook(slot, req, pred):
        if req.feeds is not None and not req.no_batch and req.attempts == 1:
            calls["n"] += 1
            raise RuntimeError("transient member fault under a batch")

    with _pool(exported, fault_hook=hook,
               retry=RetryPolicy(max_retries=2, base_delay=0.005,
                                 max_delay=0.02)) as pool:
        futs = _gated_wave(pool, exported, range(4))
        for i, f in enumerate(futs):
            out, = f.result()
            _check(exported, i, out)
        s = pool.stats()
        assert s["batch"]["splits"] >= 1
        assert s["reclones"] >= 1
        assert s["completed"] == 5
        assert s["admitted"] == s["completed"] + s["failed"] \
            + s["timed_out"] + s["cancelled"]


def test_wedged_batch_fails_whole_and_the_slot_is_replaced(exported):
    """A member hanging under a formed batch past its earliest deadline:
    every request of the batch fails DeadlineExceeded, and a fresh member
    serves the next request."""
    hang = threading.Event()

    def hook(slot, req, pred):
        if req.feeds is not None and not hang.is_set():
            hang.wait(10.0)

    with _pool(exported, fault_hook=hook, hang_grace=0.05) as pool:
        # the worker hangs until the supervisor has retired it
        futs = _gated_wave(pool, exported, range(3), timeout=0.3)
        for f in futs:
            with pytest.raises(DeadlineExceeded):
                f.result()
        t0 = time.monotonic()
        while pool.stats()["wedged"] == 0 and time.monotonic() - t0 < 5:
            time.sleep(0.01)
        hang.set()
        out, = pool.infer([exported["feeds"][5]])
        _check(exported, 5, out)
        s = pool.stats()
        assert s["wedged"] == 1 and s["timed_out"] == 3


# ---------------------------------------------------------------------------
# warmup + build accounting
# ---------------------------------------------------------------------------

def test_warmup_precompiles_then_traffic_compiles_nothing(exported):
    with _pool(exported, size=2) as pool:
        assert pool.warmup() == sorted(BUCKETS)
        comp = pool.stats()["batch"]["compile"]
        base = comp["compiles"] + comp["disk_hits"]
        assert sorted(comp["buckets"]) == sorted(BUCKETS)
        futs = _gated_wave(pool, exported, range(8))
        for f in futs:
            f.result()
        comp = pool.stats()["batch"]["compile"]
        assert comp["compiles"] + comp["disk_hits"] == base, \
            "traffic built bucket programs after warmup"


def test_concurrent_cold_calls_build_each_bucket_once(exported):
    layer = tjit.load(exported["path"], device="cpu")
    fns, errs = [], []

    def cold():
        try:
            fns.append(layer.batched_call(4))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=cold) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    assert all(f is fns[0] for f in fns)
    st = layer.aot_stats()
    assert st["compiles"] + st["disk_hits"] == 1, st
    assert st["mem_hits"] == 5, st


def test_scatter_results_are_standalone_copies(exported):
    with _pool(exported) as pool:
        futs = _gated_wave(pool, exported, range(3))
        for f in futs:
            out, = f.result()
            assert out.base is None, "result is a view into the batch"


def test_warmup_requires_batching(exported):
    pool = ServingPool(predictor=create_predictor(_cpu(exported["path"])),
                       size=1)
    try:
        with pytest.raises(RuntimeError, match="batching"):
            pool.warmup()
    finally:
        pool.shutdown(1)


def test_reclone_shares_bucket_executables(exported):
    flaky = {"armed": True}

    def hook(slot, req, pred):
        if flaky["armed"]:
            flaky["armed"] = False
            raise RuntimeError("one transient fault")

    with _pool(exported, fault_hook=hook,
               retry=RetryPolicy(max_retries=2, base_delay=0.005,
                                 max_delay=0.02)) as pool:
        pool.warmup()
        comp0 = pool.stats()["batch"]["compile"]
        out, = pool.infer([exported["feeds"][0]])
        _check(exported, 0, out)
        s = pool.stats()
        assert s["reclones"] >= 1
        comp1 = s["batch"]["compile"]
        assert comp1["compiles"] == comp0["compiles"]
        assert comp1["disk_hits"] == comp0["disk_hits"] == 0


def test_rebase_repoints_the_batcher_to_the_new_layer(exported):
    """A rebase onto new weights (a new predictor over another layer):
    batched requests then run the new layer's bucket programs."""
    with _pool(exported) as pool:
        new = create_predictor(_cpu(exported["path"]))
        new._layer.set_state_dict({n: t * 0.5 for n, t in
                                   new._layer.state_dict().items()})
        pool.rebase(new)
        assert pool._batcher.layer is new._layer
        out, = pool.infer([exported["feeds"][1]])
        assert np.array_equal(out, new.run([exported["feeds"][1]])[0])
        assert not np.array_equal(out, exported["want"][1])


# ---------------------------------------------------------------------------
# the persistent compile cache: refused
# ---------------------------------------------------------------------------

def test_compile_cache_is_refused_naming_the_decision(exported):
    from paddle_tpu_torch.jit import aot

    with pytest.raises(NotImplementedError, match="no serialized form"):
        aot.CompileCache(root="/nonexistent", keep=3)
    with pytest.raises(NotImplementedError, match="no serialized form"):
        BatchConfig(cache=object())
    layer = tjit.load(exported["path"], device="cpu")
    with pytest.raises(NotImplementedError, match="no serialized form"):
        layer.warmup_buckets((1, 2), cache=object())
    layer.warmup_buckets((1, 2))
    assert layer.aot_stats() == {"buckets": [1, 2], "compiles": 2,
                                 "disk_hits": 0, "mem_hits": 0}


def test_every_process_builds_its_own_programs(exported):
    """The counterpart of the reference's warm-process test: a fresh load
    of the same artifact builds every bucket again (compiles == buckets,
    disk_hits == 0) and its programs give the same bits."""
    a = tjit.load(exported["path"], device="cpu")
    b = tjit.load(exported["path"], device="cpu")
    for layer in (a, b):
        layer.warmup_buckets((1, 2))
        assert layer.aot_stats()["compiles"] == 2
        assert layer.aot_stats()["disk_hits"] == 0
    x = np.stack(exported["feeds"][:2])
    assert np.array_equal(a.batched_call(2)(x)[0], b.batched_call(2)(x)[0])


# ---------------------------------------------------------------------------
# admission validation + DynamicBatcher construction
# ---------------------------------------------------------------------------

def test_wrong_shape_feed_rejected_at_admission(exported):
    with _pool(exported) as pool:
        with pytest.raises(ValueError, match="input_spec"):
            pool.infer([np.zeros((2, 6), np.float32)])
        with pytest.raises(ValueError, match="1 input"):
            pool.infer([np.zeros((1, 6), np.float32)] * 2)
        s = pool.stats()
        assert s["admitted"] == 0


def test_batcher_requires_exported_layer():
    class NotExported:
        pass

    with pytest.raises(TypeError, match="batched_call"):
        DynamicBatcher(NotExported())


def test_batch_config_validation():
    with pytest.raises(ValueError):
        BatchConfig(buckets=())
    with pytest.raises(ValueError):
        BatchConfig(buckets=(0, 2))
    with pytest.raises(ValueError):
        BatchConfig(max_wait_ms=-1)
    cfg = BatchConfig(buckets=(8, 2, 4, 2))
    assert cfg.buckets == (2, 4, 8)


def test_pool_from_config_serves_batched(exported):
    """`ServingPool(config=..., batching=...)`: the pool loads the artifact
    itself (the deployment's own entry point)."""
    pool = ServingPool(_cpu(exported["path"]), size=2,
                       batching=BatchConfig(buckets=BUCKETS, max_wait_ms=3),
                       default_timeout=30.0)
    try:
        pool.warmup()
        results = {}

        def go(i):
            results[i] = pool.infer([exported["feeds"][i]])[0]

        ts = [threading.Thread(target=go, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        for i in range(16):
            _check(exported, i, results[i])
        assert pool.stats()["batch"]["requests"] == 16
    finally:
        pool.shutdown(5)


def test_replay_counts_add_up_across_worker_threads():
    """Bucket programs replay on several pool workers at once and each
    replay adds its launches by route (`_graphs._Counts.add`): under a
    1 us switch interval eight threads lost most route counts before the
    additions took a lock (phase 12 on the H100 read 7584 routed of 7596
    flash launches)."""
    import sys
    import types

    from paddle_tpu_torch import _graphs

    w = types.SimpleNamespace(launches=0, calls=0, routes={3: 0},
                              __name__="w")
    counts = _graphs._Counts([w], [(0, 0, {3: 0})], [(12, 1, {3: 12})])
    threads = [threading.Thread(target=lambda: [counts.add()
                                                for _ in range(5000)])
               for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert (w.launches, w.calls, w.routes) == (8 * 5000 * 12, 8 * 5000,
                                               {3: 8 * 5000 * 12})
