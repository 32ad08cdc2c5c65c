"""Injectable clocks (the port's copy of ``llmq_tpu/core/clock.py``).

Every time-dependent part of the queue plane and the conversation
service takes a ``Clock``, so tests drive retry backoff, delayed
delivery and TTLs with :class:`FakeClock` instead of sleeping.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, List, Optional, Protocol, Tuple


class Clock(Protocol):
    def now(self) -> float: ...
    def sleep(self, seconds: float) -> None: ...
    def wait_on(self, cond: threading.Condition,
                timeout: Optional[float]) -> bool: ...


class SystemClock:
    """Real wall-clock."""

    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def wait_on(self, cond: threading.Condition,
                timeout: Optional[float]) -> bool:
        """Wait on a condition (caller holds the lock). True if notified."""
        return cond.wait(timeout=timeout)

    def monotonic(self) -> float:
        return time.monotonic()


class FakeClock:
    """Deterministic manual clock for tests.

    ``advance`` moves time forward and wakes the ``wait_on`` sleepers
    whose deadline has passed, so timer loops (delayed queue, TTL
    cleanup) run without real sleeping.
    """

    def __init__(self, start: float = 1_000_000.0) -> None:
        self._now = start
        self._lock = threading.Lock()
        self._waiters: List[Tuple[float, int, threading.Condition]] = []
        self._callbacks: List[Tuple[float, Callable[[], None]]] = []

    def now(self) -> float:
        with self._lock:
            return self._now

    def monotonic(self) -> float:
        return self.now()

    def sleep(self, seconds: float) -> None:
        # A no-op yield: loops wait through wait_on instead.
        return None

    def wait_on(self, cond: threading.Condition,
                timeout: Optional[float]) -> bool:
        if timeout is None:
            return cond.wait(timeout=0.05)
        with self._lock:
            heapq.heappush(self._waiters,
                           (self._now + timeout, id(cond), cond))
        # Block on the real condition briefly; advance() notifies.
        return cond.wait(timeout=0.05)

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds
            due = [w for w in self._waiters if w[0] <= self._now]
            self._waiters = [w for w in self._waiters if w[0] > self._now]
            cbs = [c for t, c in self._callbacks if t <= self._now]
            self._callbacks = [(t, c) for t, c in self._callbacks
                               if t > self._now]
        for _, _, cond in due:
            with cond:
                cond.notify_all()
        for cb in cbs:
            cb()

    def call_at(self, when: float, cb: Callable[[], None]) -> None:
        with self._lock:
            self._callbacks.append((when, cb))


SYSTEM_CLOCK = SystemClock()
