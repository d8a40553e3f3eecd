"""Heartbeat liveness (the `Watchdog` policy loop of
paddle_tpu/distributed/store.py). It reads any object with
``keys("/hb/")`` and ``heartbeat_age(name)``: the serving tier's
`inference.replica.LocalHeartbeats` today. The native coordination
store (`TCPStore`) comes with the subprocess-replica slice."""
from __future__ import annotations

import threading

__all__ = ["Watchdog"]


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
