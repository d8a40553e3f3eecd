"""The kernel wrappers' launch counts, safe across threads: a pool's
workers and a router's replicas launch the same wrapper at once, and an
unlocked `+= 1` of a count loses other threads' additions."""
import threading

#: held by every change of a wrapper's `.launches`, `.calls` or `.routes`;
#: reentrant, as a program's capture holds it while its body launches
COUNTS_LOCK = threading.RLock()


def count(wrapper, route=None, n=1):
    """Add `n` launches to `wrapper` (and to its `.routes[route]`)."""
    with COUNTS_LOCK:
        wrapper.launches += n
        if route is not None:
            wrapper.routes[route] += n


def count_call(wrapper):
    """Add one call to `wrapper.calls`."""
    with COUNTS_LOCK:
        wrapper.calls += 1
