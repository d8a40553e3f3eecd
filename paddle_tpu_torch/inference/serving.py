"""Typed serving errors and the request deadline (counterparts of the
ones in paddle_tpu/inference/serving.py, copied rather than imported so
the port stands alone). The serving pool itself is not ported yet."""
from __future__ import annotations

import time

__all__ = ["ServingError", "DeadlineExceeded", "Overloaded", "PoolClosed",
           "RequestFailed", "AdapterNotLoaded", "Deadline"]


class ServingError(RuntimeError):
    """Base of every error the serving runtime raises for a request."""


class DeadlineExceeded(ServingError, TimeoutError):
    """The request's deadline (queue wait + execution) elapsed."""


class Overloaded(ServingError):
    """Shed at admission: the bounded queue is full."""


class PoolClosed(Overloaded):
    """Shed at admission (or cancelled in flight) because the engine is
    shutting down, or the request was cancelled."""


class RequestFailed(ServingError):
    """The request's execution raised; `cause` is the original exception,
    `attempts` how many executions were tried."""

    def __init__(self, msg, cause=None, attempts=1):
        super().__init__(msg)
        self.cause = cause
        self.attempts = attempts


class AdapterNotLoaded(ValueError):
    """A request named a LoRA adapter the engine's `AdapterPool` does not
    hold (or the engine has no pool): a deterministic request error, raised
    synchronously at submit."""


class Deadline:
    """Absolute monotonic-clock deadline. `seconds=None` never expires."""

    def __init__(self, seconds=None, clock=time.monotonic):
        self._clock = clock
        self._at = None if seconds is None else clock() + float(seconds)

    def remaining(self):
        """Seconds left (may be negative); None if unbounded."""
        return None if self._at is None else self._at - self._clock()

    def expired(self):
        return self._at is not None and self._clock() >= self._at

    def __repr__(self):
        r = self.remaining()
        return f"Deadline(remaining={'inf' if r is None else f'{r:.3f}s'})"
