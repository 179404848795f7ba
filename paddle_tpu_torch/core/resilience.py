"""Deadline budgets and the process counters of the serving engine.

The port's own copy of two pieces of ``paddle_tpu/core/resilience.py``:
``Deadline`` (:160-195), an absolute time budget on the monotonic clock,
and the process counters ``bump_counter``/``counters``/``reset_counters``
(:490-515). The JAX package keeps its counters in its telemetry registry;
the port, which has no telemetry yet, keeps them in one dict behind a
lock. Retry policies, the circuit breaker and fault injection are not
ported yet.
"""
from __future__ import annotations

import threading
import time

__all__ = ["Deadline", "bump_counter", "counters", "reset_counters"]


class Deadline:
    """An absolute time budget. ``Deadline(None)`` never expires. Built on
    the monotonic clock: deadlines are process-local, and a step of the
    wall clock must not expire every budget in flight."""

    def __init__(self, seconds=None):
        self.expires_at = (None if seconds is None
                           else time.monotonic() + seconds)

    @classmethod
    def never(cls):
        return cls(None)

    def remaining(self) -> float:
        if self.expires_at is None:
            return float("inf")
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0


_lock = threading.Lock()
_counters: dict[str, int] = {}


def bump_counter(name: str, n: int = 1) -> int:
    """Add ``n`` to the process counter ``name``; returns its new value."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)
        return _counters[name]


def counters() -> dict[str, int]:
    """A copy of every process counter."""
    with _lock:
        return dict(_counters)


def reset_counters():
    """Zero every process counter (test teardown)."""
    with _lock:
        _counters.clear()
