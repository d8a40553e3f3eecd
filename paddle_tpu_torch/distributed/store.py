"""The coordination store and the heartbeat watchdog (counterpart of
paddle_tpu/distributed/store.py).

`TCPStore` is a thin ctypes veneer over the port's native daemon and
client (``native/coord_store.cc``, poll()-driven, built with the host C++
compiler at first use), plus the rank-counting barrier. Heartbeats are
keys under ``/hb/<name>`` written by a native thread and stamped by the
daemon on receipt, so the watchdog is a pure reader. The serving tier's
process replicas speak over it (`inference.replica.SubprocessReplica`).

`Watchdog` is the policy loop over heartbeats: it reads any object with
``keys("/hb/")`` and ``heartbeat_age(name)``, a `TCPStore` or the
in-process `inference.replica.LocalHeartbeats`.
"""
from __future__ import annotations

import ctypes
import threading

from .. import native as _native

__all__ = ["TCPStore", "Watchdog", "create_master_store"]


def _lib():
    lib = _native.load("coord_store")
    if not getattr(lib, "_pts_ready", False):
        lib.pts_server_start.restype = ctypes.c_void_p
        lib.pts_server_start.argtypes = [ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
        lib.pts_server_stop.argtypes = [ctypes.c_void_p]
        lib.pts_connect.restype = ctypes.c_void_p
        lib.pts_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int64]
        lib.pts_close.argtypes = [ctypes.c_void_p]
        lib.pts_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_int]
        lib.pts_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_char_p)]
        lib.pts_wait.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_char_p)]
        lib.pts_add.restype = ctypes.c_int64
        lib.pts_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int64]
        lib.pts_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pts_keys.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_char_p)]
        lib.pts_stamp_age_ms.restype = ctypes.c_int64
        lib.pts_stamp_age_ms.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pts_heartbeat_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_int64]
        lib.pts_heartbeat_stop.argtypes = [ctypes.c_void_p]
        lib.pts_free_buf.argtypes = [ctypes.c_char_p]
        lib._pts_ready = True
    return lib


class TCPStore:
    """KV store client; rank 0 (``is_master=True``) also hosts the daemon.
    set / get / add / wait / delete_key / keys plus `barrier()`; values are
    bytes. A blocking `wait` (and `get`) runs in the native client with
    the GIL released, so other threads go on meanwhile."""

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=30.0):
        self._lib = _lib()
        self._server = None
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        if is_master:
            bound = ctypes.c_int(0)
            self._server = self._lib.pts_server_start(
                int(port), ctypes.byref(bound))
            if not self._server:
                raise RuntimeError(f"failed to host store on port {port}")
            port = bound.value
        self.host, self.port = host, int(port)
        self._h = self._lib.pts_connect(
            host.encode(), int(port), int(self.timeout * 1000))
        if not self._h:
            if self._server:
                self._lib.pts_server_stop(self._server)
            raise RuntimeError(f"could not reach store at {host}:{port}")
        self._closed = False

    # -- KV ----------------------------------------------------------------
    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        rc = self._lib.pts_set(self._h, key.encode(), value, len(value))
        if rc != 0:
            raise RuntimeError(f"store set({key!r}) failed")

    def get(self, key: str) -> bytes:
        """Blocking get: waits for the key (up to the store's timeout)."""
        return self.wait(key, timeout=self.timeout)

    def get_nowait(self, key: str):
        out = ctypes.c_char_p()
        n = self._lib.pts_get(self._h, key.encode(), ctypes.byref(out))
        if n == -2:
            return None
        if n < 0:
            raise RuntimeError(f"store get({key!r}) failed")
        val = ctypes.string_at(out, n)
        self._lib.pts_free_buf(out)
        return val

    def add(self, key: str, delta: int = 1) -> int:
        v = self._lib.pts_add(self._h, key.encode(), int(delta))
        if v == -1:
            raise RuntimeError(f"store add({key!r}) failed")
        return int(v)

    def wait(self, key: str, timeout: float | None = None) -> bytes:
        ms = int((self.timeout if timeout is None else timeout) * 1000)
        out = ctypes.c_char_p()
        n = self._lib.pts_wait(self._h, key.encode(), ms, ctypes.byref(out))
        if n == -2:
            raise TimeoutError(f"wait for key {key!r} timed out ({ms} ms)")
        if n < 0:
            raise RuntimeError(f"store wait({key!r}) failed")
        val = ctypes.string_at(out, n)
        self._lib.pts_free_buf(out)
        return val

    def delete_key(self, key: str) -> bool:
        return self._lib.pts_delete(self._h, key.encode()) == 0

    def keys(self, prefix: str = "") -> list[str]:
        out = ctypes.c_char_p()
        n = self._lib.pts_keys(self._h, prefix.encode(), ctypes.byref(out))
        if n < 0:
            raise RuntimeError("store keys() failed")
        raw = ctypes.string_at(out, n).decode()
        self._lib.pts_free_buf(out)
        return [k for k in raw.split("\n") if k]

    # -- sync --------------------------------------------------------------
    def barrier(self, name: str = "default", world_size: int | None = None,
                timeout: float | None = None) -> None:
        """Counting barrier: each rank adds 1, last arrival publishes the
        release key everyone waits on; the name is reusable."""
        world = int(world_size or self.world_size)
        n = self.add(f"/barrier/{name}/count", 1)
        epoch = (n - 1) // world  # reusable barrier name across epochs
        release = f"/barrier/{name}/release/{epoch}"
        if n % world == 0:
            self.set(release, b"1")
        self.wait(release, timeout=timeout)

    # -- liveness ----------------------------------------------------------
    def start_heartbeat(self, name: str, interval: float = 1.0) -> None:
        """Publish liveness under /hb/<name> from a native thread."""
        self._lib.pts_heartbeat_start(
            self._h, f"/hb/{name}".encode(), int(interval * 1000))

    def stop_heartbeat(self) -> None:
        self._lib.pts_heartbeat_stop(self._h)

    def heartbeat_age(self, name: str) -> float | None:
        """Seconds since `name` last heartbeat, or None if never seen."""
        age = self._lib.pts_stamp_age_ms(self._h, f"/hb/{name}".encode())
        return None if age < 0 else age / 1000.0

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._lib.pts_close(self._h)
        if self._server:
            self._lib.pts_server_stop(self._server)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class Watchdog:
    """Liveness monitor over heartbeats: a member whose heartbeat is older
    than `ttl` is reported dead through `on_failure`. Death is not
    permanent: a member that heartbeats again is revived (dropped from
    `dead`) and reported through `on_recovery`."""

    def __init__(self, store, ttl=10.0, interval=1.0, on_failure=None,
                 on_recovery=None):
        self.store = store
        self.ttl = float(ttl)
        self.interval = float(interval)
        self.on_failure = on_failure
        self.on_recovery = on_recovery
        self._stop = threading.Event()
        self._thread = None
        self.dead = set()

    def members(self):
        return [k[len("/hb/"):] for k in self.store.keys("/hb/")]

    def members_health(self):
        """``{name: {"age", "dead", "alive"}}``: `age` seconds since the
        last heartbeat (None if never seen), `dead` the current flag,
        `alive` a fresh heartbeat and no flag. A pure read."""
        out = {}
        for m in self.members():
            age = self.store.heartbeat_age(m)
            fresh = age is not None and age <= self.ttl
            out[m] = {"age": age, "dead": m in self.dead,
                      "alive": fresh and m not in self.dead}
        return out

    def check(self):
        """One sweep; returns the newly dead members. Flagged members whose
        heartbeat is fresh again are revived first."""
        newly, revived = [], []
        for m in self.members():
            age = self.store.heartbeat_age(m)
            fresh = age is not None and age <= self.ttl
            if m in self.dead:
                if fresh:
                    self.dead.discard(m)
                    revived.append(m)
                continue
            if age is not None and age > self.ttl:
                self.dead.add(m)
                newly.append(m)
        if revived and self.on_recovery is not None:
            self.on_recovery(list(revived))
        if newly and self.on_failure is not None:
            self.on_failure(list(newly))
        return newly

    def start(self):
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.interval):
                self.check()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="Watchdog")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def create_master_store(port: int = 0, world_size: int = 1,
                        timeout: float = 30.0) -> TCPStore:
    """Host the daemon on this process and connect to it (the rank-0
    helper; an ephemeral port by default)."""
    return TCPStore("127.0.0.1", port, is_master=True,
                    world_size=world_size, timeout=timeout)
