"""The port's serving tier (`paddle_tpu_torch.inference.router` and
`replica`, `distributed.store.Watchdog`) held to the JAX package's.

tests/test_router.py's stub scenarios run on both routers, each case
parametrized over the package (``inf``) and held to the same typed
outcomes and stats laws: least-loaded routing, failover on a killed or
wedged replica, the non-idempotent refusal, the capacity floor, restart
convergence, the rolling weight swap (generation stamps, ordering
refusals, rollback), streams (prefix affinity, cancel, deadline,
bit-exact failover on kill and wedge, generation purity under a swap),
the SLO autoscale band and the watchdog over local heartbeats. The stub
members and the stub engine are the reference test's: no model runs.

Then the real engines on the CPU in float32: streams over the JAX demo
weights (converted) fail over on kill and on wedge with the JAX router's
tokens; a swap between the port's demo generations keeps every stream
within one generation; and a directory committed by either package's
`commit_model_dir` is accepted by the other's `swap_weights`."""
import concurrent.futures
import itertools
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu.inference as jinf
from paddle_tpu.distributed.store import Watchdog as JWatchdog

import paddle_tpu_torch.inference as tinf
from paddle_tpu_torch.distributed.store import Watchdog as TWatchdog

PKGS = {"jax": jinf, "torch": tinf}
WATCHDOG = {jinf: JWatchdog, tinf: TWatchdog}


@pytest.fixture(params=sorted(PKGS))
def inf(request):
    return PKGS[request.param]


class StubPredictor:
    """Pool-compatible fake: run() scales the feed by the 'weights'
    (one scale per model dir) so generation changes are bit-visible."""

    def __init__(self, scale, delay=0.0, fail_value=None):
        self.scale = float(scale)
        self.delay = float(delay)
        self.fail_value = fail_value

    def clone(self):
        return StubPredictor(self.scale, self.delay, self.fail_value)

    def reset_handles(self):
        pass

    def run(self, feeds):
        if self.delay:
            time.sleep(self.delay)
        if self.fail_value is not None and any(
                np.any(np.asarray(f) == self.fail_value) for f in feeds):
            raise ValueError("malformed request (magic fail value)")
        return [np.asarray(f, np.float64) * self.scale for f in feeds]


STUB_VOCAB = 211


def stub_ref(prompt_ids, max_new, generation=0):
    """The stub "greedy decode" as a pure function: each next token is a
    recurrence over the FULL prefix (prompt + everything generated), so
    a resume from `prompt + committed` is bit-identical to the
    uninterrupted run by construction, and the generation term makes a
    weight swap bit-visible — the stub analog of the demo checkpoint's
    seeded weights."""
    seq = [int(t) for t in prompt_ids]
    out = []
    for _ in range(int(max_new)):
        t = (sum(seq) * 31 + len(seq) + 7 * int(generation)) % STUB_VOCAB
        seq.append(t)
        out.append(t)
    return out


class _StubStream:
    """Pump-contract stream (`poll`/`cancel`/`tokens`/`status`) whose
    tokens drip on a wall clock (`delay` per token) so a test can kill,
    wedge, cancel, or swap mid-generation deterministically."""

    def __init__(self, engine, sid, toks, delay):
        self.id = sid
        self.deadline = None
        self.status = "active"
        self._engine = engine
        self._toks = toks
        self._delay = float(delay)
        self._i = 0
        self._t0 = time.monotonic()
        self._end = None

    @property
    def tokens(self):
        return self._toks[:self._i]

    def cancel(self):
        self._finish("cancelled")

    def _finish(self, status):
        if self._end is None:
            self._end = ("end", status, None)
            self.status = status
            self._engine._release(self.id)

    def poll(self, timeout=None):
        if self._end is not None:
            return self._end
        if not self._delay:
            avail = len(self._toks)
        else:
            avail = min(len(self._toks),
                        int((time.monotonic() - self._t0) / self._delay))
        if self._i < avail:
            tok = self._toks[self._i]
            self._i += 1
            return ("tok", tok)
        if self._i >= len(self._toks):
            self._finish("completed")
            return self._end
        if timeout and timeout > 0:
            time.sleep(min(timeout, self._delay))
        return ("empty", None)


class StubEngine:
    """Duck-typed decode engine for streaming tests (no XLA, no model):
    the ServingPool surface is `submit` / `shutdown` / `stats`, and
    "decoding" is the `stub_ref` recurrence. `live` tracks admitted
    sequences so tests can assert a cancelled / failed-over stream
    released its (stub) KV hold."""

    def __init__(self, inf, generation=0, delay=0.0):
        self.inf = inf
        self.generation = int(generation)
        self.delay = float(delay)
        self.closed = False
        self.live = {}
        self.submitted = 0
        self._lock = threading.Lock()
        self._ids = itertools.count()

    def submit(self, prompt_ids, max_new_tokens, timeout=None,
               resume_committed=None, sampling=None, adapter=None):
        with self._lock:
            if self.closed:
                raise self.inf.PoolClosed("stub engine is shut down")
            seq = [int(t) for t in prompt_ids] + [
                int(t) for t in (resume_committed or [])]
            toks = stub_ref(seq, max_new_tokens, self.generation)
            s = _StubStream(self, f"stub-{next(self._ids)}", toks,
                            self.delay)
            self.live[s.id] = s
            self.submitted += 1
            return s

    def _release(self, sid):
        with self._lock:
            self.live.pop(sid, None)

    def shutdown(self, drain_timeout=None):
        with self._lock:
            self.closed = True
            streams = list(self.live.values())
        for s in streams:
            s.cancel()

    def stats(self):
        with self._lock:
            return {"active": len(self.live), "submitted": self.submitted}


class Tier:
    """One test topology: shared heartbeat sink + replica registry so
    tests can reach into specific replicas to kill/wedge them. With
    `stream_delay` set, every replica carries a `StubEngine` for its
    weight generation (`decode_factory`), enabling submit_generate()
    through the tier; engines are recorded for leak assertions."""

    def __init__(self, inf, scales=None, delay=0.0, fail_value=None,
                 factory_hook=None, stream_delay=None):
        self.inf = inf
        self.hb = inf.LocalHeartbeats()
        self.scales = scales if scales is not None else {None: 1.0}
        self.delay = delay
        self.fail_value = fail_value
        self.replicas = {}
        self.factory_hook = factory_hook  # (rid, dir) -> maybe raise
        self.stream_delay = stream_delay
        self.engines = []                 # every StubEngine ever built

    def predictor(self, model_dir):
        key = model_dir if model_dir in self.scales else None
        return StubPredictor(self.scales[key], self.delay, self.fail_value)

    def factory(self, rid, model_dir, generation):
        if self.factory_hook is not None:
            self.factory_hook(rid, model_dir)

        def make(d):
            if self.factory_hook is not None:
                self.factory_hook(rid, d)
            return self.predictor(d)

        deco = None
        if self.stream_delay is not None:
            def deco(gen):
                eng = StubEngine(self.inf, gen, self.stream_delay)
                self.engines.append(eng)
                return eng

        rep = self.inf.LocalReplica(rid, make, model_dir, generation,
                           heartbeat=self.hb, heartbeat_interval=0.01,
                           decode_factory=deco,
                           pool_kwargs=dict(default_timeout=5.0,
                                            supervise_interval=0.01,
                                            hang_grace=0.05))
        self.replicas[rid] = rep
        return rep

    def engines_idle(self):
        return all(e.stats()["active"] == 0 for e in self.engines)


def fast_config(inf, **over):
    kw = dict(heartbeat_ttl=0.2, supervise_interval=0.02, start_grace=1.0,
              restart_backoff=inf.RetryPolicy(base_delay=0.03, max_delay=0.2),
              failover=inf.RetryPolicy(max_retries=3, base_delay=0.002,
                                   max_delay=0.01, max_elapsed=10.0),
              probe_timeout=2.0, breaker_reset_timeout=0.1,
              no_capacity_wait=0.5)
    kw.update(over)
    return inf.RouterConfig(**kw)


def wait_until(fn, timeout=5.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return fn()


# ---------------------------------------------------------------------------
# retry-policy budget (satellite: total-elapsed cap under layered retries)
# ---------------------------------------------------------------------------

def test_retry_policy_elapsed_budget(inf):
    p = inf.RetryPolicy(max_retries=100, base_delay=0.01, max_elapsed=1.0)
    assert p.should_retry(1, 0.0)
    assert p.should_retry(50, 0.5)
    assert not p.should_retry(1, 1.5)      # budget spent beats attempt room
    assert not p.should_retry(101, 0.0)    # attempt cap still binds
    # the budget accounts the backoff sleep the retry would add
    assert not p.should_retry(1, 0.995)
    # None elapsed (no admission stamp) falls back to attempts-only
    assert p.should_retry(1, None)
    unbounded = inf.RetryPolicy(max_retries=2)
    assert unbounded.should_retry(2, 1e9)  # no budget → attempts only
    assert not unbounded.should_retry(3, 0.0)


# ---------------------------------------------------------------------------
# routing basics
# ---------------------------------------------------------------------------

def test_routes_and_conserves(inf):
    tier = Tier(inf, scales={None: 2.0})
    with inf.ServingRouter(tier.factory, size=2, config=fast_config(inf, )) as r:
        x = np.arange(4.0)
        for _ in range(8):
            out, = r.infer([x], timeout=2.0)
            np.testing.assert_array_equal(out, x * 2.0)
        outs, gen = r.infer_stamped([x], timeout=2.0)
        assert gen == 0
        s = r.stats()
        assert s["ready"] == 2 and s["admitted"] == 9
        assert s["admitted"] == (s["completed"] + s["failed"]
                                 + s["timed_out"] + s["overloaded"]
                                 + s["cancelled"])
        assert s["completed"] == 9 and s["failovers"] == 0
    assert r.stats()["closed"]


def test_least_loaded_pick_prefers_idle_replica(inf):
    tier = Tier(inf, scales={None: 1.0}, delay=0.15)
    with inf.ServingRouter(tier.factory, size=2, config=fast_config(inf, )) as r:
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(r.infer, [np.ones(2)], 3.0) for _ in range(4)]
            for f in futs:
                f.result()
        s = r.stats()
        # both replicas served: the pick spread load instead of piling
        # every request onto replica-0
        assert all(m["dispatched"] > 0 for m in s["members"])


def test_failover_on_killed_replica_and_restart_convergence(inf):
    tier = Tier(inf, scales={None: 3.0})
    with inf.ServingRouter(tier.factory, size=2, config=fast_config(inf, )) as r:
        x = np.ones(3)
        out, = r.infer([x], timeout=2.0)
        np.testing.assert_array_equal(out, x * 3.0)
        tier.replicas["replica-0"].kill()
        # every idempotent request keeps succeeding through failover
        for _ in range(10):
            out, = r.infer([x], timeout=2.0)
            np.testing.assert_array_equal(out, x * 3.0)
        # capacity converges back to 2 via supervised restart
        assert wait_until(lambda: r.stats()["ready"] == 2)
        s = r.stats()
        assert s["deaths"] >= 1 and s["restarts"] >= 1
        assert s["admitted"] == s["completed"]  # zero requests lost
        # and the revived replica serves
        for _ in range(4):
            out, = r.infer([x], timeout=2.0)
            np.testing.assert_array_equal(out, x * 3.0)


def test_non_idempotent_request_refuses_ambiguous_reexecution(inf):
    tier = Tier(inf, )
    cfg = fast_config(inf, min_healthy=1)
    with inf.ServingRouter(tier.factory, size=1, config=cfg) as r:
        tier.replicas["replica-0"].kill()
        with pytest.raises(inf.RequestFailed) as ei:
            r.infer([np.ones(2)], timeout=1.0, idempotent=False)
        assert isinstance(ei.value.cause, inf.ReplicaDead)
        s = r.stats()
        assert s["failed"] == 1 and s["failovers"] == 0


def test_deterministic_request_error_never_fails_over(inf):
    tier = Tier(inf, fail_value=777.0)
    with inf.ServingRouter(tier.factory, size=2, config=fast_config(inf, )) as r:
        with pytest.raises(inf.RequestFailed):
            r.infer([np.full(2, 777.0)], timeout=2.0)
        s = r.stats()
        assert s["failovers"] == 0 and s["failed"] == 1
        assert s["deaths"] == 0  # no health penalty for a bad request


def test_floor_sheds_overloaded_instead_of_collapsing(inf):
    tier = Tier(inf, )
    cfg = fast_config(inf, min_healthy=2,
                      restart_backoff=inf.RetryPolicy(base_delay=0.5,
                                                  max_delay=0.5))
    with inf.ServingRouter(tier.factory, size=2, config=cfg) as r:
        tier.replicas["replica-0"].kill()
        assert wait_until(lambda: r.stats()["ready"] == 1)
        with pytest.raises(inf.Overloaded):
            r.infer([np.ones(2)], timeout=1.0)
        s = r.stats()
        assert s["shed"] >= 1
        # shed requests were never admitted: the law is undisturbed
        assert s["admitted"] == (s["completed"] + s["failed"]
                                 + s["timed_out"] + s["overloaded"]
                                 + s["cancelled"])
        # once capacity is restored, admissions resume
        assert wait_until(lambda: r.stats()["ready"] == 2, timeout=8.0)
        r.infer([np.ones(2)], timeout=2.0)


def test_wedged_replica_fails_over_and_is_restarted(inf):
    tier = Tier(inf, scales={None: 5.0})
    cfg = fast_config(inf, attempt_timeout=0.15)
    with inf.ServingRouter(tier.factory, size=2, config=cfg) as r:
        victim = tier.replicas["replica-1"]
        victim.wedge()
        x = np.ones(2)
        ok = 0
        for _ in range(8):
            out, = r.infer([x], timeout=3.0)
            np.testing.assert_array_equal(out, x * 5.0)
            ok += 1
        assert ok == 8  # wedged attempts failed over inside the deadline
        # watchdog notices the stale heartbeat (a wedged replica stops
        # beating), kills it, and the restart clears the wedge
        assert wait_until(lambda: r.stats()["deaths"] >= 1)
        assert wait_until(lambda: r.stats()["ready"] == 2)


# ---------------------------------------------------------------------------
# weight hot-swap
# ---------------------------------------------------------------------------

def _dirs(tmp_path, tier, spec):
    """Create committed model dirs {name: (scale, generation)}."""
    out = {}
    for name, (scale, gen) in spec.items():
        d = tmp_path / name
        d.mkdir()
        tier.scales[str(d)] = scale
        tier.inf.commit_model_dir(str(d), gen)
        out[name] = str(d)
    return out


def test_swap_weights_rolls_without_drops_and_stamps_generation(inf, tmp_path):
    tier = Tier(inf, scales={None: 1.0})
    dirs = _dirs(tmp_path, tier, {"g0": (1.0, 0), "g5": (4.0, 5)})
    cfg = fast_config(inf, )
    with inf.ServingRouter(tier.factory, size=3, model_dir=dirs["g0"],
                       generation=0, config=cfg) as r:
        x = np.ones(2)
        stop = threading.Event()
        seen = []
        bad = []

        def traffic():
            while not stop.is_set():
                try:
                    outs, gen = r.infer_stamped([x], timeout=3.0)
                except Exception as e:  # noqa: BLE001 — collected + asserted
                    bad.append(repr(e))
                    continue
                want = 1.0 if gen == 0 else 4.0
                if gen not in (0, 5) or not np.array_equal(
                        outs[0], x * want):
                    bad.append(f"gen {gen} -> {outs[0]!r}")
                seen.append(gen)

        threads = [threading.Thread(target=traffic) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.1)
        new_gen = r.swap_weights(dirs["g5"], drain_timeout=5.0)
        assert new_gen == 5
        time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join()
        assert not bad, bad[:5]
        assert 0 in seen and 5 in seen  # traffic flowed on both sides
        # post-swap: everything serves the new weights
        outs, gen = r.infer_stamped([x], timeout=2.0)
        assert gen == 5
        np.testing.assert_array_equal(outs[0], x * 4.0)
        s = r.stats()
        assert s["generation"] == 5 and s["swaps"] == 1
        assert all(m["generation"] == 5 for m in s["members"])
        assert s["admitted"] == s["completed"] + s["failed"] \
            + s["timed_out"] + s["overloaded"] + s["cancelled"]
        assert s["failed"] == 0 and s["timed_out"] == 0


def test_swap_refuses_torn_and_stale_generations(inf, tmp_path):
    tier = Tier(inf, scales={None: 1.0})
    dirs = _dirs(tmp_path, tier, {"g7": (2.0, 7), "g3": (3.0, 3)})
    torn = tmp_path / "torn"
    torn.mkdir()
    tier.scales[str(torn)] = 9.0
    with inf.ServingRouter(tier.factory, size=2, model_dir=dirs["g7"],
                       generation=7, config=fast_config(inf, )) as r:
        with pytest.raises(inf.SwapFailed, match="_COMMITTED"):
            r.swap_weights(str(torn))
        with pytest.raises(inf.SwapFailed, match="not newer"):
            r.swap_weights(dirs["g3"])     # older generation refused
        with pytest.raises(inf.SwapFailed, match="not newer"):
            r.swap_weights(dirs["g7"])     # same generation refused
        assert r.stats()["generation"] == 7
        # no generation stamp at all is refused too
        unstamped = tmp_path / "unstamped"
        unstamped.mkdir()
        import json
        import os
        with open(os.path.join(str(unstamped), "_COMMITTED"), "w") as f:
            json.dump({"format": 1}, f)
        with pytest.raises(inf.SwapFailed, match="generation stamp"):
            r.swap_weights(str(unstamped))


def test_failed_swap_rolls_back_to_consistent_generation(inf, tmp_path):
    tier = Tier(inf, scales={None: 1.0})
    dirs = _dirs(tmp_path, tier, {"g0": (1.0, 0), "g9": (6.0, 9)})
    boom = {"armed": False}

    def hook(rid, model_dir):
        # the SECOND replica's rebuild on the new weights explodes
        if boom["armed"] and rid == "replica-1" \
                and model_dir == dirs["g9"]:
            raise RuntimeError("injected: bad weights on replica-1")

    tier.factory_hook = hook
    with inf.ServingRouter(tier.factory, size=2, model_dir=dirs["g0"],
                       generation=0, config=fast_config(inf, )) as r:
        x = np.ones(2)
        r.infer([x], timeout=2.0)
        boom["armed"] = True
        with pytest.raises(inf.SwapFailed):
            r.swap_weights(dirs["g9"], drain_timeout=2.0)
        boom["armed"] = False
        s = r.stats()
        assert s["generation"] == 0 and s["swap_rollbacks"] == 1
        # the tier converges back to generation 0 everywhere (replica-0
        # rolled back; replica-1 restarts on the committed generation)
        assert wait_until(
            lambda: all(m["generation"] == 0 and m["state"] == "ready"
                        for m in r.stats()["members"]), timeout=8.0)
        out, = r.infer([x], timeout=2.0)
        np.testing.assert_array_equal(out, x * 1.0)


# ---------------------------------------------------------------------------
# streaming through the tier (stub engines: bit-exact by recurrence)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(PKGS))
def stream_router(request):
    """ONE healthy 2-replica streaming topology shared by every test
    that never faults it (suite-budget idiom): tests assert on stats
    DELTAS, never absolutes, and use distinct prompts so affinity
    entries don't cross-talk."""
    inf = PKGS[request.param]
    tier = Tier(inf, stream_delay=0.02)
    cfg = fast_config(inf, affinity_block_tokens=4, attempt_timeout=1.0)
    r = inf.ServingRouter(tier.factory, size=2, config=cfg)
    yield inf, tier, r
    r.shutdown(drain_timeout=5.0)


def test_stream_routes_conserves_and_prefers_prefix_affinity(stream_router):
    inf, tier, r = stream_router
    before = r.stats()["streams"]
    prompt = [3, 1, 4, 1, 5]
    want = stub_ref(prompt, 6)
    for _ in range(5):
        rs = r.submit_generate(prompt, 6, timeout=10.0)
        assert rs.result() == want
        assert rs.generation == 0 and rs.failovers == 0
    # the iterator idiom yields the same uninterrupted sequence
    assert list(r.submit_generate(prompt, 6, timeout=10.0)) == want
    s = r.stats()
    st = s["streams"]
    assert st["admitted"] - before["admitted"] == 6
    assert st["completed"] - before["completed"] == 6
    # conservation ledger (quiesced: nothing of ours is in flight)
    assert st["admitted"] == (st["completed"] + st["failed"]
                              + st["timed_out"] + st["cancelled"]
                              + st["in_flight"])
    # a repeated prefix sticks to the replica holding its KV blocks
    assert st["affinity_hits"] - before["affinity_hits"] >= 5
    assert all(m["streams"] == 0 for m in s["members"])
    assert wait_until(tier.engines_idle)


def test_stream_cancel_releases_engine_sequence(stream_router):
    inf, tier, r = stream_router
    before = r.stats()["streams"]
    rs = r.submit_generate([2, 7, 1, 8], 40, timeout=10.0)
    it = iter(rs)
    next(it)                      # mid-generation, tokens flowing
    rs.cancel()
    with pytest.raises(inf.RequestFailed, match="cancelled"):
        rs.result(timeout=5.0)
    assert rs.status == "cancelled"
    # the stub sequence is evicted within a round, not at deadline
    assert wait_until(tier.engines_idle, timeout=2.0)
    st = r.stats()["streams"]
    assert st["cancelled"] - before["cancelled"] == 1


def test_stream_deadline_expires_typed_and_releases(stream_router):
    inf, tier, r = stream_router
    before = r.stats()["streams"]
    # 40 tokens at ~20ms each can't fit a 0.25s budget
    rs = r.submit_generate([6, 6, 6, 6], 40, timeout=0.25)
    with pytest.raises(inf.DeadlineExceeded):
        rs.result()
    # the client raise races the pump's own deadline check by design:
    # the caller sees inf.DeadlineExceeded immediately and cancels; the pump
    # lands the stream terminal as timed_out OR cancelled — exactly one
    assert wait_until(lambda: rs.status is not None, timeout=2.0)
    assert rs.status in ("timed_out", "cancelled")
    assert 0 < len(rs.tokens) < 40    # it was genuinely mid-generation
    st = r.stats()["streams"]
    assert (st["timed_out"] + st["cancelled"]
            - before["timed_out"] - before["cancelled"]) == 1
    assert wait_until(tier.engines_idle, timeout=2.0)


def test_stream_failover_on_kill_is_bit_exact(inf):
    tier = Tier(inf, stream_delay=0.03)
    cfg = fast_config(inf, affinity_block_tokens=4, attempt_timeout=1.0)
    with inf.ServingRouter(tier.factory, size=2, config=cfg) as r:
        prompt = [5, 4, 3, 2]
        want = stub_ref(prompt, 12)
        rs = r.submit_generate(prompt, 12, timeout=20.0)
        it = iter(rs)
        got = [next(it), next(it)]
        victim = next(m["rid"] for m in r.stats()["members"]
                      if m["streams"] > 0)
        tier.replicas[victim].kill()
        got += list(it)
        # ONE uninterrupted sequence: no duplicates, no gaps, no splice
        assert got == want
        assert rs.failovers >= 1 and rs.status == "completed"
        st = r.stats()["streams"]
        assert st["failovers"] >= 1 and st["resumed"] >= 1
        assert st["admitted"] == (st["completed"] + st["failed"]
                                  + st["timed_out"] + st["cancelled"]
                                  + st["in_flight"])
        assert wait_until(lambda: r.stats()["ready"] == 2)
        assert wait_until(tier.engines_idle)


def test_served_by_records_each_takeover():
    """The port's RouterStream.served_by: the first attempt from token 0
    on the replica that was killed, the resume on the other replica from
    exactly the tokens the client held, and those two segments make up
    the stream."""
    tier = Tier(tinf, stream_delay=0.03)
    cfg = fast_config(tinf, affinity_block_tokens=4, attempt_timeout=1.0)
    with tinf.ServingRouter(tier.factory, size=2, config=cfg) as r:
        prompt = [5, 4, 3, 2]
        rs = r.submit_generate(prompt, 12, timeout=20.0)
        it = iter(rs)
        got = [next(it), next(it)]
        victim = next(m["rid"] for m in r.stats()["members"]
                      if m["streams"] > 0)
        tier.replicas[victim].kill()
        got += list(it)
        assert got == stub_ref(prompt, 12) and rs.failovers >= 1
        assert rs.served_by[0] == (victim, 0)
        rid, n = rs.served_by[-1]
        assert rid != victim and 2 <= n < 12
        assert [c for _, c in rs.served_by] == sorted(
            c for _, c in rs.served_by)


def test_stream_failover_on_wedge_stalls_then_resumes_bit_exact(inf):
    tier = Tier(inf, stream_delay=0.03)
    cfg = fast_config(inf, affinity_block_tokens=4, attempt_timeout=0.25)
    with inf.ServingRouter(tier.factory, size=2, config=cfg) as r:
        prompt = [8, 6, 4, 2]
        want = stub_ref(prompt, 12)
        rs = r.submit_generate(prompt, 12, timeout=20.0)
        it = iter(rs)
        got = [next(it)]
        victim = next(m["rid"] for m in r.stats()["members"]
                      if m["streams"] > 0)
        tier.replicas[victim].wedge()
        # tokens stop flowing; the stall detector moves the stream
        got += list(it)
        assert got == want
        assert rs.failovers >= 1
        # the watchdog reaps the wedged replica and restarts it
        assert wait_until(lambda: r.stats()["deaths"] >= 1)
        assert wait_until(lambda: r.stats()["ready"] == 2)


def test_stream_swap_preserves_generation_purity(inf, tmp_path):
    tier = Tier(inf, scales={None: 1.0}, stream_delay=0.01)
    dirs = _dirs(tmp_path, tier, {"g0": (1.0, 0), "g2": (2.0, 2)})
    cfg = fast_config(inf, affinity_block_tokens=4, attempt_timeout=1.0)
    prompt = [2, 3, 5, 7]
    refs = {g: stub_ref(prompt, 8, g) for g in (0, 2)}
    with inf.ServingRouter(tier.factory, size=2, model_dir=dirs["g0"],
                       generation=0, config=cfg) as r:
        stop = threading.Event()
        results, bad = [], []

        def traffic():
            while not stop.is_set():
                try:
                    rs = r.submit_generate(prompt, 8, timeout=10.0)
                    toks = rs.result()
                except (inf.RequestFailed, inf.DeadlineExceeded):
                    # purity over availability: a stream caught between
                    # generations may typed-fail, never splice
                    continue
                if toks != refs.get(rs.generation):
                    bad.append((rs.generation, toks))
                results.append(rs.generation)

        threads = [threading.Thread(target=traffic) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.1)
        assert r.swap_weights(dirs["g2"], drain_timeout=10.0) == 2
        time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join()
        assert not bad, bad[:3]   # every token sequence is ONE generation's
        assert 0 in results       # traffic flowed on both sides of the roll
        rs = r.submit_generate(prompt, 8, timeout=10.0)
        assert rs.result() == refs[2] and rs.generation == 2
        s = r.stats()
        assert s["generation"] == 2 and s["swaps"] == 1


# ---------------------------------------------------------------------------
# autoscale band (SLO-driven: p99 off the router's own histograms)
# ---------------------------------------------------------------------------

def test_autoscale_slo_spawns_on_breach_and_retires_idle(inf):
    """The band controller consumes obs-registry SLO evaluation, not raw
    queue depth: streams whose latency p99 breaches the declared ceiling
    spawn a replica (patience-gated); an idle measurement window IS the
    scale-down signal back to the floor."""
    tier = Tier(inf, stream_delay=0.02)
    cfg = fast_config(inf, autoscale=True, min_replicas=1, max_replicas=3,
                      autoscale_slo={"p99_latency_s": 0.05},
                      slo_min_samples=1, autoscale_patience=2,
                      affinity_block_tokens=0, supervise_interval=0.1)
    with inf.ServingRouter(tier.factory, size=1, config=cfg) as r:
        def one(i):
            # ~8 tokens x 20ms = 0.16s per stream >> the 50ms ceiling
            return r.submit_generate([i % 13, 2, 4], 8,
                                     timeout=20.0).result()

        with concurrent.futures.ThreadPoolExecutor(6) as ex:
            futs = [ex.submit(one, i) for i in range(30)]
            grew = wait_until(lambda: len(r) > 1, timeout=10.0)
            for f in futs:
                f.result()
        assert grew and r.stats()["scale_ups"] >= 1
        # idle: no new samples to evaluate — shrink into the band floor
        assert wait_until(lambda: len(r) == 1, timeout=10.0)
        assert r.stats()["scale_downs"] >= 1
        assert r.submit_generate([1, 2, 3], 4, timeout=10.0).result() \
            == stub_ref([1, 2, 3], 4)  # survivors still serve


# ---------------------------------------------------------------------------
# watchdog health snapshot over local heartbeats
# ---------------------------------------------------------------------------

def test_watchdog_members_health_over_local_heartbeats(inf):
    hb = inf.LocalHeartbeats()
    hb.beat("a")
    hb.beat("b")
    deaths = []
    dog = WATCHDOG[inf](hb, ttl=0.15, on_failure=lambda d: deaths.extend(d))
    h = dog.members_health()
    assert h["a"]["alive"] and not h["a"]["dead"] and h["a"]["age"] >= 0.0
    # "b" goes silent → flagged once (not per sweep), snapshot flips
    deadline = time.monotonic() + 5
    while "b" not in dog.dead and time.monotonic() < deadline:
        hb.beat("a")
        dog.check()
        time.sleep(0.02)
    for _ in range(3):
        hb.beat("a")
        dog.check()  # no double-fire while it stays dead
    assert deaths == ["b"]
    h = dog.members_health()
    assert h["b"]["dead"] and not h["b"]["alive"] and h["b"]["age"] > 0.15
    assert h["a"]["alive"]
    # revival clears the flag; a re-death fires exactly once more
    hb.beat("b")
    dog.check()
    assert "b" not in dog.dead and dog.members_health()["b"]["alive"]
    deadline = time.monotonic() + 5
    while deaths.count("b") < 2 and time.monotonic() < deadline:
        hb.beat("a")
        dog.check()
        time.sleep(0.02)
    assert deaths == ["b", "b"]
    # a retired member leaves the keyspace entirely
    hb.remove("b")
    assert "b" not in dog.members_health()




# ---------------------------------------------------------------------------
# real engines on the CPU: the port's router against the JAX router
# ---------------------------------------------------------------------------

NEW = 12
SLOW_CFG = dict(affinity_block_tokens=4,
                # the JAX engines' compiles can hold the interpreter past
                # the stub tests' 0.2 s heartbeat ttl
                heartbeat_ttl=2.0,
                # no restarts inside the test: each router keeps 3 engines
                restart_backoff=dict(base_delay=60.0, max_delay=60.0))


def _engine_tier(inf, decode_factory):
    hb = inf.LocalHeartbeats()
    reps = {}

    def factory(rid, model_dir, generation):
        rep = inf.LocalReplica(
            rid, lambda d: StubPredictor(1.0), model_dir, generation,
            heartbeat=hb, heartbeat_interval=0.01,
            decode_factory=decode_factory,
            pool_kwargs=dict(default_timeout=30.0, supervise_interval=0.01,
                             hang_grace=0.05))
        reps[rid] = rep
        return rep

    return factory, reps


def _streams_kill_then_wedge(inf, decode_factory):
    """Three replicas, no restarts: stream A loses its replica to a kill
    after 2 tokens, stream B its replica to a wedge after 1 token; both
    streams' full token lists, their failovers and the router's stats."""
    from paddle_tpu_torch.inference.decode.demo import demo_prompt

    factory, reps = _engine_tier(inf, decode_factory)
    cfg = fast_config(inf, attempt_timeout=0.5, **{
        k: (inf.RetryPolicy(**v) if isinstance(v, dict) else v)
        for k, v in SLOW_CFG.items()})
    out = {}
    with inf.ServingRouter(factory, size=3, config=cfg, metrics=False) as r:
        # warm every engine (the JAX engines compile their programs here,
        # not under the stall detector), straight through the replicas
        for rep in reps.values():
            stream, _ = rep.submit_generate(demo_prompt(99, 8), 3,
                                            timeout=60.0)
            while stream.poll(0.05)[0] != "end":
                pass
        for name, fault, n_first, seed in (("kill", "kill", 2, 5),
                                           ("wedge", "wedge", 1, 6)):
            rs = r.submit_generate(demo_prompt(seed, 8), NEW, timeout=60.0)
            it = iter(rs)
            got = [next(it) for _ in range(n_first)]
            victim = next(m["rid"] for m in r.stats()["members"]
                          if m["streams"] > 0)
            getattr(reps[victim], fault)()
            got += list(it)
            out[name] = (got, rs.failovers, rs.status)
        assert wait_until(lambda: r.stats()["deaths"] == 2, timeout=10.0)
        s = r.stats()
        out["stats"] = s
        for rep in reps.values():
            rep.unwedge()
    return out


@pytest.fixture(scope="module")
def demo_models():
    """The JAX demo model of generation 0 and the port's model holding
    its weights (float32)."""
    from paddle_tpu.inference.decode import demo as jdemo

    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.inference.decode import demo as tdemo

    jm = jdemo.tiny_model(0)
    tm = tdemo.tiny_model(0, device="cpu")
    load_jax_state(tm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    return jm, tm


def test_stream_failover_on_kill_and_wedge_equals_the_jax_router(
        demo_models, tmp_path):
    """The same streams through the JAX router over the JAX demo engines
    and through the port's over the converted weights: on a kill and on
    a wedge each stream fails over once and delivers the JAX router's
    tokens, which are the uninterrupted run's (float32, bit for bit)."""
    from paddle_tpu.inference.decode import demo as jdemo
    from paddle_tpu.jit.aot import CompileCache

    from paddle_tpu_torch.inference.decode import demo as tdemo

    caches = itertools.count()

    def jax_engine(gen):
        # each JAX engine compiles into a cache of its own
        return jdemo.tiny_engine_slow(gen, compile_cache=CompileCache(
            str(tmp_path / f"cache{next(caches)}")))

    jm, tm = demo_models
    ref = {}
    with tdemo.tiny_engine(0, model=tm, device="cpu") as e:
        for name, seed in (("kill", 5), ("wedge", 6)):
            ref[name] = e.generate(tdemo.demo_prompt(seed, 8), NEW)
    j = _streams_kill_then_wedge(jinf, jax_engine)
    t = _streams_kill_then_wedge(tinf, lambda gen: tdemo.tiny_engine_slow(
        gen, model=tm, device="cpu"))
    for name in ("kill", "wedge"):
        assert j[name][0] == ref[name]
        assert t[name] == j[name] == (ref[name], 1, "completed")
    for s in (j["stats"], t["stats"]):
        st = s["streams"]
        assert st["failovers"] == 2 and st["resumed"] == 2
        assert st["admitted"] == st["completed"] == 2
        assert st["in_flight"] == 0


def test_swap_keeps_every_stream_within_one_generation(tmp_path):
    """Port demo engines of generations 0 and 2 behind a router; streams
    run while `swap_weights` rolls to generation 2: every completed
    stream equals its stamped generation's reference, both generations
    served, and every engine drains to allocated == 0."""
    from paddle_tpu_torch.inference.decode import demo as tdemo

    models = {g: tdemo.tiny_model(g, device="cpu") for g in (0, 2)}
    prompt = tdemo.demo_prompt(9, 8)
    refs = {}
    for g, m in models.items():
        with tdemo.tiny_engine(g, model=m, device="cpu") as e:
            refs[g] = e.generate(prompt, 8)
    assert refs[0] != refs[2]
    dirs = {}
    for g in (0, 2):
        dirs[g] = str(tmp_path / f"g{g}")
        os.makedirs(dirs[g])
        tinf.commit_model_dir(dirs[g], g)
    engines = []

    def decode_factory(gen):
        e = tdemo.tiny_engine_slow(gen, model=models[gen], device="cpu")
        engines.append(e)
        return e

    factory, _ = _engine_tier(tinf, decode_factory)
    cfg = fast_config(tinf, affinity_block_tokens=4, attempt_timeout=2.0)
    results, bad = [], []
    with tinf.ServingRouter(factory, size=2, model_dir=dirs[0],
                            generation=0, config=cfg, metrics=False) as r:
        stop = threading.Event()

        def traffic():
            while not stop.is_set():
                try:
                    rs = r.submit_generate(prompt, 8, timeout=30.0)
                    toks = rs.result()
                except (tinf.RequestFailed, tinf.DeadlineExceeded):
                    continue        # typed, never a splice
                if toks != refs.get(rs.generation):
                    bad.append((rs.generation, toks))
                results.append(rs.generation)

        threads = [threading.Thread(target=traffic) for _ in range(3)]
        for th in threads:
            th.start()
        assert wait_until(lambda: 0 in results, timeout=30.0)
        assert r.swap_weights(dirs[2], drain_timeout=30.0) == 2
        assert wait_until(lambda: results.count(2) >= 2, timeout=30.0)
        stop.set()
        for th in threads:
            th.join(timeout=60.0)
            assert not th.is_alive()
        assert not bad, bad[:3]
        s = r.stats()
        assert s["generation"] == 2 and s["swaps"] == 1
        assert all(m["generation"] == 2 for m in s["members"])
    assert all(e.stats()["blocks"]["allocated"] == 0 for e in engines)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_directory_committed_by_either_package_swaps_in_the_other(
        writer, tmp_path):
    """The sentinel is the same JSON either way: the JAX package's
    `commit_model_dir` is accepted by the port's `swap_weights` and the
    port's by the JAX package's; an uncommitted or older one is refused
    by both."""
    reader = tinf if writer == "jax" else jinf
    d = str(tmp_path / "g4")
    os.makedirs(d)
    PKGS[writer].commit_model_dir(d, 4)
    with open(os.path.join(d, "_COMMITTED")) as f:
        sentinel = json.load(f)
    assert sorted(sentinel) == ["format", "generation", "unix_time",
                                "world_size"]
    tier = Tier(reader)
    with reader.ServingRouter(tier.factory, size=2, generation=1,
                              config=fast_config(reader)) as r:
        assert r.swap_weights(d) == 4
        assert r.infer_stamped([np.ones(2)], timeout=2.0)[1] == 4
        with pytest.raises(reader.SwapFailed, match="not newer"):
            r.swap_weights(d)
        torn = str(tmp_path / "torn")
        os.makedirs(torn)
        with pytest.raises(reader.SwapFailed, match="_COMMITTED"):
            r.swap_weights(torn)


def test_router_metrics_scrape_shows_the_streams_ledger():
    """One scrape of `serve_metrics()` on 127.0.0.1: the router's
    request and streams ledgers, and /healthz."""
    from paddle_tpu_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    tier = Tier(tinf, stream_delay=0.0)
    with tinf.ServingRouter(tier.factory, size=2, config=fast_config(tinf),
                            metrics=reg, name="tier") as r:
        assert r.submit_generate([1, 2, 3], 4, timeout=10.0).result() \
            == stub_ref([1, 2, 3], 4)
        r.infer([np.ones(2)], timeout=2.0)
        server = r.serve_metrics()
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
        with urllib.request.urlopen(server.url + "/healthz",
                                    timeout=10) as resp:
            health = json.loads(resp.read())
    assert "serving_router_tier_streams_admitted 1" in text
    assert "serving_router_tier_streams_completed 1" in text
    assert "serving_router_tier_completed 1" in text
    assert health["ready"] == 2 and health["ok"]
    assert not server.running
