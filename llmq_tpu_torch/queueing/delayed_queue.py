"""Delayed (scheduled) message queue (the port's copy of
``llmq_tpu/queueing/delayed_queue.py``).

A time-ordered heap with a timer loop that sleeps until the earliest
``ready_at``, re-arming when an earlier item arrives, and hands due
messages to a delivery function. The worker's retry path schedules its
backoff here, and delivery re-enqueues into the source queue. Time is
injectable: with a :class:`FakeClock` tests drive delivery through
``run_due_once`` without sleeping.
"""

from __future__ import annotations

import heapq
import logging
import itertools
import threading
from typing import Callable, List, Optional, Tuple

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.types import Message

log = logging.getLogger("llmq_tpu_torch.delayed_queue")

# (ready_at, seq, target_queue, message, delivery_attempts)
_Entry = Tuple[float, int, str, Message, int]

DeliverFn = Callable[[str, Message], None]
DropFn = Callable[[str, Message, str], None]


class DelayedQueue:
    #: On delivery failure (e.g. target queue momentarily full) the entry is
    #: re-scheduled with this delay, up to MAX_DELIVERY_ATTEMPTS, then
    #: handed to ``on_drop`` (or logged as an error) — never silently lost.
    REDELIVERY_DELAY = 1.0
    MAX_DELIVERY_ATTEMPTS = 20

    def __init__(self, deliver: DeliverFn, clock: Optional[Clock] = None,
                 name: str = "delayed", on_drop: Optional[DropFn] = None) -> None:
        self.name = name
        self._deliver = deliver
        self._on_drop = on_drop
        self._clock = clock or SYSTEM_CLOCK
        self._heap: List[_Entry] = []
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- scheduling ----------------------------------------------------------

    def schedule(self, message: Message, ready_at: float,
                 target_queue: str = "") -> None:
        """Deliver ``message`` to ``target_queue`` at ``ready_at``."""
        message.scheduled_at = ready_at
        self._push_entry(ready_at, target_queue, message, 0)

    def _push_entry(self, ready_at: float, target_queue: str, message: Message,
                    attempts: int) -> None:
        with self._cond:
            heapq.heappush(self._heap,
                           (ready_at, next(self._seq), target_queue, message, attempts))
            self._cond.notify_all()  # re-arm the timer

    def schedule_after(self, message: Message, delay: float,
                       target_queue: str = "") -> None:
        self.schedule(message, self._clock.now() + delay, target_queue)

    def peek(self) -> Optional[Message]:
        with self._lock:
            return self._heap[0][3] if self._heap else None

    def next_ready_at(self) -> Optional[float]:
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def size(self) -> int:
        with self._lock:
            return len(self._heap)

    # -- delivery ------------------------------------------------------------

    def run_due_once(self) -> int:
        """Deliver everything due now; returns count. Test-friendly tick."""
        due: List[_Entry] = []
        now = self._clock.now()
        with self._lock:
            while self._heap and self._heap[0][0] <= now:
                due.append(heapq.heappop(self._heap))
        for _, _, qname, msg, attempts in due:
            try:
                self._deliver(qname, msg)
            except Exception as e:  # noqa: BLE001
                if attempts + 1 < self.MAX_DELIVERY_ATTEMPTS:
                    log.warning(
                        "delayed delivery of %s to %s failed (attempt %d); "
                        "re-scheduling: %s", msg.id, qname, attempts + 1, e)
                    self._push_entry(self._clock.now() + self.REDELIVERY_DELAY,
                                     qname, msg, attempts + 1)
                elif self._on_drop is not None:
                    self._on_drop(qname, msg, repr(e))
                else:
                    log.error(
                        "delayed delivery of %s to %s failed %d times; DROPPING: %s",
                        msg.id, qname, attempts + 1, e)
        return len(due)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(
            target=self._run_loop, name=f"delayed-{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run_loop(self) -> None:
        """Sleep until the earliest item is due, deliver, repeat."""
        while True:
            with self._cond:
                if self._stop:
                    return
                now = self._clock.now()
                if not self._heap:
                    timeout: Optional[float] = None
                elif self._heap[0][0] <= now:
                    timeout = 0.0
                else:
                    timeout = self._heap[0][0] - now
                if timeout is None or timeout > 0:
                    self._clock.wait_on(self._cond, timeout)
                    if self._stop:
                        return
            self.run_due_once()
