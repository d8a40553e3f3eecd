"""The port's coordination store and watchdog (`paddle_tpu_torch.
distributed.store`: `TCPStore` over the port's own native daemon,
``native/coord_store.cc``, built with the host C++ compiler), held to
the cases of tests/test_store.py, and the same operations run against
the reference's daemon and the port's with equal results."""
import threading
import time

import pytest

from paddle_tpu_torch.distributed.store import (TCPStore, Watchdog,
                                                create_master_store)


@pytest.fixture()
def store():
    s = create_master_store(world_size=1)
    yield s
    s.close()


def test_set_get_add_delete(store):
    store.set("a", b"hello")
    assert store.get_nowait("a") == b"hello"
    assert store.get("a") == b"hello"
    assert store.get_nowait("missing") is None
    assert store.add("ctr", 5) == 5
    assert store.add("ctr", 2) == 7
    assert store.get_nowait("ctr") == b"7"
    assert store.delete_key("a")
    assert not store.delete_key("a")
    assert store.get_nowait("a") is None
    store.set("s", "text")                  # str values go as utf-8
    assert store.get_nowait("s") == b"text"


def test_binary_values_and_keys_listing(store):
    blob = bytes(range(256)) * 10
    store.set("/ws/r0", blob)
    store.set("/ws/r1", b"x")
    store.set("/other", b"y")
    assert store.get_nowait("/ws/r0") == blob
    assert sorted(store.keys("/ws/")) == ["/ws/r0", "/ws/r1"]
    assert store.host == "127.0.0.1" and store.port > 0


def test_wait_blocks_until_set(store):
    got = {}
    store2 = TCPStore(port=store.port)      # a second client connection

    def waiter():
        got["v"] = store2.wait("later", timeout=10)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    assert "v" not in got
    store.set("later", b"now")
    t.join(timeout=5)
    assert got["v"] == b"now"
    store2.close()


def test_wait_timeout(store):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        store.wait("never", timeout=0.3)
    assert time.monotonic() - t0 >= 0.25


def test_wait_releases_the_gil(store):
    """A parked wait runs in the native client without the GIL: another
    Python thread keeps running meanwhile."""
    store2 = TCPStore(port=store.port)
    ticks = []
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            ticks.append(1)
            time.sleep(0.001)

    t = threading.Thread(target=spin)
    t.start()
    try:
        with pytest.raises(TimeoutError):
            store2.wait("never", timeout=0.4)
    finally:
        stop.set()
        t.join()
        store2.close()
    assert len(ticks) > 20


def test_barrier_across_clients(store):
    world = 4
    clients = [TCPStore(port=store.port, world_size=world)
               for _ in range(world)]
    arrived = []

    def enter(i):
        clients[i].barrier("b1", timeout=10)
        arrived.append(i)

    threads = [threading.Thread(target=enter, args=(i,))
               for i in range(world - 1)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    assert arrived == []  # nobody released before the last arrival
    clients[world - 1].barrier("b1", timeout=10)
    for t in threads:
        t.join(timeout=5)
    assert sorted(arrived) == list(range(world - 1))
    # the barrier is reusable (its epoch rolls over)
    threads = [threading.Thread(target=c.barrier, args=("b1",))
               for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    for c in clients:
        c.close()


def test_heartbeat_and_watchdog(store):
    worker = TCPStore(port=store.port)
    worker.start_heartbeat("rank1", interval=0.05)
    time.sleep(0.2)
    age = store.heartbeat_age("rank1")
    assert age is not None and age < 1.0
    assert store.heartbeat_age("nobody") is None
    failures = []
    dog = Watchdog(store, ttl=0.3, interval=0.05,
                   on_failure=lambda dead: failures.extend(dead))
    assert dog.members() == ["rank1"]
    assert dog.check() == []  # alive
    worker.stop_heartbeat()
    worker.close()
    deadline = time.time() + 5
    dog.start()
    while not failures and time.time() < deadline:
        time.sleep(0.05)
    dog.stop()
    assert failures == ["rank1"]


def test_watchdog_revives_rejoined_member(store):
    failures, recoveries = [], []
    dog = Watchdog(store, ttl=0.25, interval=0.05,
                   on_failure=lambda d: failures.extend(d),
                   on_recovery=lambda r: recoveries.extend(r))
    worker = TCPStore(port=store.port)
    worker.start_heartbeat("rank7", interval=0.05)
    time.sleep(0.2)
    assert dog.check() == []
    worker.stop_heartbeat()
    worker.close()
    deadline = time.time() + 5
    while "rank7" not in dog.dead and time.time() < deadline:
        dog.check()
        time.sleep(0.05)
    assert failures == ["rank7"] and "rank7" in dog.dead
    # the member rejoins (a fresh connection, a fresh heartbeat)
    rejoined = TCPStore(port=store.port)
    rejoined.start_heartbeat("rank7", interval=0.05)
    deadline = time.time() + 5
    while "rank7" in dog.dead and time.time() < deadline:
        dog.check()
        time.sleep(0.05)
    assert "rank7" not in dog.dead
    assert recoveries == ["rank7"]
    # and it can die, and be reported, again
    rejoined.stop_heartbeat()
    rejoined.close()
    deadline = time.time() + 5
    while failures.count("rank7") < 2 and time.time() < deadline:
        dog.check()
        time.sleep(0.05)
    assert failures == ["rank7", "rank7"]


def test_watchdog_members_health_snapshot(store):
    failures = []
    dog = Watchdog(store, ttl=0.25, interval=0.05,
                   on_failure=lambda d: failures.extend(d))
    worker = TCPStore(port=store.port)
    worker.start_heartbeat("rep0", interval=0.05)
    time.sleep(0.15)
    h = dog.members_health()
    assert h["rep0"]["alive"] and not h["rep0"]["dead"]
    assert 0.0 <= h["rep0"]["age"] < 0.25
    # snapshots are pure reads: a stale member is not flagged by them
    worker.stop_heartbeat()
    worker.close()
    deadline = time.time() + 5
    while store.heartbeat_age("rep0") <= 0.3 and time.time() < deadline:
        time.sleep(0.05)
    h = dog.members_health()
    assert not h["rep0"]["alive"] and not h["rep0"]["dead"]
    assert failures == []
    for _ in range(4):
        dog.check()
    assert failures == ["rep0"]
    h = dog.members_health()
    assert h["rep0"]["dead"] and not h["rep0"]["alive"]
    # revived: fresh but flagged until the next sweep clears it
    rejoined = TCPStore(port=store.port)
    rejoined.start_heartbeat("rep0", interval=0.05)
    deadline = time.time() + 5
    while store.heartbeat_age("rep0") > 0.2 and time.time() < deadline:
        time.sleep(0.05)
    assert not dog.members_health()["rep0"]["alive"]
    dog.check()
    assert dog.members_health()["rep0"]["alive"]
    rejoined.stop_heartbeat()
    rejoined.close()
    deadline = time.time() + 5
    while failures.count("rep0") < 2 and time.time() < deadline:
        dog.check()
        time.sleep(0.05)
    assert failures == ["rep0", "rep0"]


def test_a_client_frozen_mid_command_does_not_freeze_the_daemon(store):
    """A client that sent half a command and stopped (a process SIGSTOPped
    between two writes) is dropped after the daemon's I/O timeout; the
    other clients, and the heartbeats the watchdog reads, go on. (The
    reference's daemon waits for the rest forever.)"""
    import socket
    import struct

    worker = TCPStore(port=store.port)
    worker.start_heartbeat("alive", interval=0.05)
    raw = socket.create_connection(("127.0.0.1", store.port))
    try:
        raw.sendall(b"\x01" + struct.pack("!I", 100))   # SET, key length
        time.sleep(0.1)                      # the daemon is inside it now
        done = {}

        def use():
            store.set("after", b"ok")
            done["v"] = store.get_nowait("after")

        t = threading.Thread(target=use, daemon=True)
        t0 = time.monotonic()
        t.start()
        t.join(timeout=5.0)
        assert not t.is_alive() and done["v"] == b"ok"
        assert time.monotonic() - t0 < 2.0
        time.sleep(0.3)
        age = store.heartbeat_age("alive")
        assert age is not None and age < 0.3
    finally:
        raw.close()
        worker.stop_heartbeat()
        worker.close()


def _rank_main(port, rank, world, q):
    s = TCPStore(port=port, world_size=world, timeout=20)
    s.set(f"/rdzv/{rank}", str(rank))
    s.barrier("boot")
    peers = sorted(int(s.get(f"/rdzv/{r}")) for r in range(world))
    q.put((rank, peers))
    s.close()


def test_multiprocess_rendezvous(store):
    """Processes rendezvous through the store as ranks joining a job."""
    import multiprocessing as mp

    world = 4
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(store.port, r, world, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = [q.get(timeout=120) for _ in range(world)]
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert sorted(r for r, _ in results) == list(range(world))
    for _, peers in results:
        assert peers == list(range(world))


def _script(s):
    """One fixed sequence of operations; returns every result."""
    out = []
    s.set("k", b"v\x00w")
    out.append(s.get_nowait("k"))
    out.append(s.get("k"))
    out.append(s.get_nowait("nope"))
    out += [s.add("n", 3), s.add("n", -5), s.get_nowait("n")]
    out.append(s.delete_key("k"))
    out.append(s.delete_key("k"))
    for i in range(3):
        s.set(f"/p/{i}", bytes([i]) * (i + 1))
    s.set("/q/x", b"")
    out.append(s.keys("/p/"))
    out.append(s.keys(""))
    out.append(s.get_nowait("/q/x"))
    try:
        s.wait("never", timeout=0.1)
        out.append("no timeout")
    except TimeoutError:
        out.append("timeout")
    s.barrier("b", world_size=1)
    out.append(sorted(k for k in s.keys("/barrier/")))
    out.append(s.heartbeat_age("ghost"))
    s.start_heartbeat("me", interval=0.02)
    time.sleep(0.1)
    age = s.heartbeat_age("me")
    out.append(age is not None and age < 0.5)
    s.stop_heartbeat()
    out.append(s.keys("/hb/"))
    return out


def test_same_operations_same_results_as_the_reference_daemon():
    """The same operations against the reference's daemon and the port's
    (each its own build of its own source) give the same results."""
    from paddle_tpu.distributed.store import \
        create_master_store as jcreate_master_store

    got = {}
    for name, make in (("ref", jcreate_master_store),
                       ("port", create_master_store)):
        s = make()
        try:
            got[name] = _script(s)
        finally:
            s.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] == b"v\x00w" and got["port"][3:6] == [3, -2, b"-2"]
