"""Multi-level priority queue (the port's copy of
``llmq_tpu/queueing/priority_queue.py``).

- named queues, each a min-heap ordered by (priority asc, FIFO within
  priority), with a capacity check
- pending → processing → completed/failed accounting, the queue wait
  recorded at pop, requeue accounting for the retry path
- admin removal by id and stale-message expiry through tombstones:
  expired messages are marked TIMEOUT at once and discarded when the
  heap surfaces them
- ``snapshot``: a queue's live pending messages in arrival order (WAL
  compaction)

The ordering heap runs in C++ (``native/src/mlq.cpp`` through
``llmq_tpu_torch/native/loader.py``) when it builds, with a pure-Python
core of the same semantics beside it: ``backend=`` "auto" (native if
buildable, else Python with a log line), "native" (raise if it cannot be
built) or "python".

With a tenancy fair scheduler attached (``set_fair``, done by the queue
manager when ``tenancy.enabled``), ``pop`` serves the handle the
scheduler selects (weighted fair queueing across tenants within a level)
through the core's ``pop_handle``, and every other way a pending message
leaves (admin removal, expiry) takes it out of the fair index. Without one (the default) ``pop`` is the heap's FIFO-within-
priority, at the cost of one attribute check.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.errors import (QueueEmptyError, QueueFullError,
                                        QueueNotFoundError)
from llmq_tpu_torch.core.types import Message, MessageStatus, QueueStats

log = logging.getLogger("llmq_tpu_torch.priorityqueue")


class _PyBackend:
    """Heap core keyed by integer handles, with lazy deletion; mirrors
    the C ABI of ``native/src/mlq.cpp``."""

    ERR_NOT_FOUND = -1
    ERR_FULL = -2
    ERR_EMPTY = -3
    ERR_EXISTS = -4

    def __init__(self) -> None:
        self._heaps: Dict[str, List[Tuple[int, int, int, float]]] = {}
        # Liveness index, handle → enqueue_ts. ``pop_handle``/``discard``
        # remove items HERE in O(1) and leave the heap entry behind as a
        # stale record (lazy deletion); pop/peek skip entries absent from
        # this map as they surface. Handles are never reused.
        self._live: Dict[str, Dict[int, float]] = {}
        self._caps: Dict[str, int] = {}
        # [pend, proc, comp, fail, pops, wait, ptime] — pops counts the
        # wait samples feeding avg_wait.
        self._stats: Dict[str, List[float]] = {}
        self._seq = itertools.count(1)
        self._mu = threading.Lock()

    def create_queue(self, name: str, capacity: int) -> int:
        with self._mu:
            if name in self._heaps:
                return self.ERR_EXISTS
            self._heaps[name] = []
            self._live[name] = {}
            self._caps[name] = capacity
            self._stats[name] = [0, 0, 0, 0, 0, 0.0, 0.0]
            return 0

    def remove_queue(self, name: str) -> int:
        with self._mu:
            if name not in self._heaps:
                return self.ERR_NOT_FOUND
            del self._heaps[name], self._caps[name], self._stats[name]
            del self._live[name]
            return 0

    def has_queue(self, name: str) -> bool:
        with self._mu:
            return name in self._heaps

    def push(self, name: str, handle: int, priority: int, enqueue_ts: float) -> int:
        with self._mu:
            heap = self._heaps.get(name)
            if heap is None:
                return self.ERR_NOT_FOUND
            live = self._live[name]
            cap = self._caps[name]
            if cap > 0 and len(live) >= cap:
                return self.ERR_FULL
            heapq.heappush(heap, (priority, next(self._seq), handle, enqueue_ts))
            live[handle] = enqueue_ts
            self._stats[name][0] += 1
            return 0

    def pop(self, name: str, now: float) -> Tuple[int, int, float]:
        with self._mu:
            heap = self._heaps.get(name)
            if heap is None:
                return self.ERR_NOT_FOUND, 0, 0.0
            live = self._live[name]
            while heap:
                _, _, handle, ts = heapq.heappop(heap)
                if live.pop(handle, None) is None:
                    continue   # stale: fair-popped or discarded earlier
                wait = max(0.0, now - ts)
                s = self._stats[name]
                s[0] -= 1
                s[1] += 1
                s[4] += 1
                s[5] += wait
                return 0, handle, wait
            return self.ERR_EMPTY, 0, 0.0

    def pop_handle(self, name: str, handle: int,
                   now: float) -> Tuple[int, float]:
        """Pop one given pending handle with pop accounting (mirrors
        ``mlq_pop_handle``): O(1), the heap entry is skipped as stale
        when it surfaces. Returns (err, wait)."""
        with self._mu:
            live = self._live.get(name)
            if live is None:
                return self.ERR_NOT_FOUND, 0.0
            ts = live.pop(handle, None)
            if ts is None:
                return self.ERR_EMPTY, 0.0
            wait = max(0.0, now - ts)
            s = self._stats[name]
            s[0] -= 1
            s[1] += 1
            s[4] += 1
            s[5] += wait
            # Fair pops never go through pop/peek: reclaim the stale heap
            # entries here, or the heap grows by one a message.
            self._drain_stale_locked(name)
            return 0, wait

    def _drain_stale_locked(self, name: str) -> None:
        heap = self._heaps[name]
        live = self._live[name]
        while heap and heap[0][2] not in live:
            heapq.heappop(heap)

    def peek(self, name: str) -> Tuple[int, int]:
        with self._mu:
            heap = self._heaps.get(name)
            if heap is None:
                return self.ERR_NOT_FOUND, 0
            self._drain_stale_locked(name)
            if not heap:
                return self.ERR_EMPTY, 0
            return 0, heap[0][2]

    def pop_if(self, name: str, expected_handle: int, now: float) -> int:
        """Pop only if the top is still ``expected_handle``: 0, -5 (the
        top changed) or an error code."""
        with self._mu:
            heap = self._heaps.get(name)
            if heap is None:
                return self.ERR_NOT_FOUND
            self._drain_stale_locked(name)
            if not heap:
                return self.ERR_EMPTY
            if heap[0][2] != expected_handle:
                return -5
            _, _, handle, ts = heapq.heappop(heap)
            self._live[name].pop(handle, None)
            s = self._stats[name]
            s[0] -= 1
            s[1] += 1
            s[4] += 1
            s[5] += max(0.0, now - ts)
            return 0

    def size(self, name: str) -> int:
        with self._mu:
            live = self._live.get(name)
            return self.ERR_NOT_FOUND if live is None else len(live)

    def complete(self, name: str, process_time: float) -> int:
        with self._mu:
            s = self._stats.get(name)
            if s is None:
                return self.ERR_NOT_FOUND
            if s[1] > 0:
                s[1] -= 1
            s[2] += 1
            s[6] += process_time
            return 0

    def fail(self, name: str, process_time: float) -> int:
        with self._mu:
            s = self._stats.get(name)
            if s is None:
                return self.ERR_NOT_FOUND
            if s[1] > 0:
                s[1] -= 1
            s[3] += 1
            s[6] += process_time
            return 0

    def requeue_accounting(self, name: str) -> int:
        with self._mu:
            s = self._stats.get(name)
            if s is None:
                return self.ERR_NOT_FOUND
            if s[1] > 0:
                s[1] -= 1
            return 0

    def discard(self, name: str, handle: int) -> int:
        """Remove a pending item by handle with no wait/failed accounting
        (admin deletion); O(1) lazy deletion."""
        with self._mu:
            live = self._live.get(name)
            if live is None:
                return self.ERR_NOT_FOUND
            if live.pop(handle, None) is None:
                return self.ERR_EMPTY
            self._stats[name][0] -= 1
            self._drain_stale_locked(name)
            return 0

    def stats(self, name: str) -> Tuple[int, List[int], List[float]]:
        with self._mu:
            s = self._stats.get(name)
            if s is None:
                return self.ERR_NOT_FOUND, [], []
            return 0, [int(x) for x in s[:5]], list(s[5:])

    def queue_names(self) -> List[str]:
        with self._mu:
            return sorted(self._heaps)


def _make_backend(backend: str) -> Any:
    if backend in ("auto", "native"):
        try:
            from llmq_tpu_torch.native.loader import NativeMLQ
            return NativeMLQ()
        except Exception as e:  # noqa: BLE001
            # An explicit LLMQ_NATIVE_LIB never falls back: the caller
            # asked for that library.
            if backend == "native" or os.environ.get("LLMQ_NATIVE_LIB"):
                raise
            log.info("using Python queue backend (%s)", e)
    return _PyBackend()


class MultiLevelQueue:
    """Named priority queues sharing one ordering core.

    ``backend``: "auto" (native if buildable), "native", or "python".
    """

    ERR_NOT_FOUND = -1
    ERR_FULL = -2
    ERR_EMPTY = -3
    ERR_EXISTS = -4

    def __init__(self, clock: Optional[Clock] = None,
                 backend: str = "auto") -> None:
        self._clock = clock or SYSTEM_CLOCK
        self._core = _make_backend(backend)
        self.backend_name = type(self._core).__name__
        # handle → (queue_name, Message, enqueue_ts); Python owns Message objects.
        self._messages: Dict[int, Tuple[str, Message, float]] = {}
        self._tombstones: set[int] = set()
        self._caps: Dict[str, int] = {}
        self._next_handle = itertools.count(1)
        self._mu = threading.Lock()
        #: The tenancy fair scheduler (None: FIFO within priority).
        self._fair: Any = None

    def set_fair(self, fair: Any) -> None:
        """Attach a tenancy fair scheduler (``on_push``, ``select``,
        ``discard``). Attach it before the first push:
        the fair index knows only the handles it saw arrive."""
        self._fair = fair

    # -- queue management ----------------------------------------------------

    def create_queue(self, name: str, capacity: int = 0) -> None:
        err = self._core.create_queue(name, capacity)
        if err == self.ERR_EXISTS:
            return  # idempotent, like CreateQueue on an existing name
        with self._mu:
            self._caps[name] = capacity

    def has_queue(self, name: str) -> bool:
        return self._core.has_queue(name)

    def queue_names(self) -> List[str]:
        return self._core.queue_names()

    # -- data path -----------------------------------------------------------

    def push(self, name: str, message: Message) -> None:
        now = self._clock.now()
        handle = next(self._next_handle)
        # Status is set BEFORE the message becomes visible to concurrent
        # poppers — a pop may legitimately complete the message before this
        # function returns, and must not be overwritten back to PENDING.
        message.status = MessageStatus.PENDING
        message.touch(now)
        with self._mu:
            self._messages[handle] = (name, message, now)
        err = self._core.push(name, handle, int(message.priority), now)
        if err == 0:
            if self._fair is not None:
                self._fair.on_push(name, message, handle)
            return
        with self._mu:
            self._messages.pop(handle, None)
        if err == self.ERR_NOT_FOUND:
            raise QueueNotFoundError(name)
        if err == self.ERR_FULL:
            raise QueueFullError(name, self._caps.get(name, 0))
        raise RuntimeError(f"push failed: err={err}")

    def pop(self, name: str) -> Message:
        """Most urgent message; moves it to PROCESSING. Tombstoned
        (expired) entries surfacing here are counted failed and skipped.
        The measured queue wait is attached as ``last_wait_time``.

        With a fair scheduler attached the served handle is its pick
        (the lowest weighted virtual time within this level); a queue
        whose pending work all belongs to tenants at their in-flight cap
        reads as empty: the work is deferred, not lost."""
        while True:
            if self._fair is not None:
                handle = self._fair.select(name)
                if handle is None:
                    if not self._core.has_queue(name):
                        raise QueueNotFoundError(name)
                    raise QueueEmptyError(name)
                err, wait = self._core.pop_handle(name, handle,
                                                  self._clock.now())
                if err == self.ERR_EMPTY:
                    # The fair index was ahead of the core (a concurrent
                    # admin removal won this handle): drop any local
                    # record and select again.
                    with self._mu:
                        self._tombstones.discard(handle)
                        self._messages.pop(handle, None)
                    continue
            else:
                err, handle, wait = self._core.pop(name, self._clock.now())
            if err == self.ERR_NOT_FOUND:
                raise QueueNotFoundError(name)
            if err == self.ERR_EMPTY:
                raise QueueEmptyError(name)
            with self._mu:
                tomb = handle in self._tombstones
                if tomb:
                    self._tombstones.discard(handle)
                    self._messages.pop(handle, None)
                else:
                    entry = self._messages.pop(handle, None)
            if tomb or entry is None:
                self._core.fail(name, 0.0)
                continue
            _, message, _ = entry
            message.status = MessageStatus.PROCESSING
            message.last_wait_time = wait  # type: ignore[attr-defined]
            message.touch(self._clock.now())
            return message

    def try_pop(self, name: str) -> Optional[Message]:
        try:
            return self.pop(name)
        except QueueEmptyError:
            return None

    def size(self, name: str) -> int:
        n = self._core.size(name)
        if n == self.ERR_NOT_FOUND:
            raise QueueNotFoundError(name)
        with self._mu:
            tomb_here = sum(
                1 for h in self._tombstones
                if h in self._messages and self._messages[h][0] == name)
        return max(0, n - tomb_here)

    def total_size(self) -> int:
        return sum(self.size(n) for n in self.queue_names())

    # -- stat transitions ----------------------------------------------------

    def complete_message(self, name: str, message: Message,
                         process_time: float = 0.0) -> None:
        err = self._core.complete(name, process_time)
        if err == self.ERR_NOT_FOUND:
            raise QueueNotFoundError(name)
        message.status = MessageStatus.COMPLETED
        message.touch(self._clock.now())

    def fail_message(self, name: str, message: Message,
                     process_time: float = 0.0) -> None:
        err = self._core.fail(name, process_time)
        if err == self.ERR_NOT_FOUND:
            raise QueueNotFoundError(name)
        message.status = MessageStatus.FAILED
        message.touch(self._clock.now())

    def requeue(self, name: str, message: Message) -> None:
        """Return a popped (PROCESSING) message to the queue without
        counting it completed/failed — the retry path."""
        self.requeue_accounting_for(name)
        self.push(name, message)

    def requeue_accounting_for(self, name: str) -> None:
        """Move a popped message out of PROCESSING stats without a
        completed/failed transition (it will re-enter later, e.g. via the
        delayed queue after a retry backoff)."""
        err = self._core.requeue_accounting(name)
        if err == self.ERR_NOT_FOUND:
            raise QueueNotFoundError(name)

    def remove_message(self, name: str, message_id: str) -> Optional[Message]:
        """Remove a PENDING message by id (the admin delete). Unlike expiry tombstones, this
        eagerly discards the heap entry with no wait-sample or failed
        accounting — an admin deletion is not a failure and must not
        skew avg_wait. Returns the message, or None if no pending
        message has that id."""
        if not self.has_queue(name):
            raise QueueNotFoundError(name)
        with self._mu:
            target = None
            for h, (qn, msg, _) in self._messages.items():
                if qn == name and msg.id == message_id and h not in self._tombstones:
                    target = (h, msg)
                    break
        if target is None:
            return None
        h, msg = target
        if self._core.discard(name, h) != 0:
            return None  # already popped by a concurrent consumer
        if self._fair is not None:
            self._fair.discard(name, h)
        with self._mu:
            self._messages.pop(h, None)
        msg.status = MessageStatus.FAILED
        msg.error = "removed by admin"
        return msg

    def snapshot(self, name: str) -> List[Message]:
        """Live pending messages of a queue in arrival order (tombstoned
        ones left out): WAL compaction rewrites the journal from it."""
        if not self.has_queue(name):
            raise QueueNotFoundError(name)
        with self._mu:
            rows = [(ts, h, msg) for h, (qn, msg, ts) in
                    self._messages.items()
                    if qn == name and h not in self._tombstones]
        rows.sort(key=lambda r: (r[0], r[1]))
        return [msg for _, _, msg in rows]

    # -- stale cleanup --------------------------------------------------------

    def expire_older_than(self, name: str, max_age: float) -> List[Message]:
        """Mark pending messages older than ``max_age`` as TIMEOUT.

        Without a fair scheduler they are tombstoned and discarded (with
        failed accounting) when the heap surfaces them; reported sizes
        exclude them at once. With one they leave at once: a tombstone in
        a fair deque would go on counting against its tenant's
        ``max_queue_depth`` (and might never surface while the tenant is
        deferred at its in-flight cap)."""
        if not self.has_queue(name):
            raise QueueNotFoundError(name)
        cutoff = self._clock.now() - max_age
        expired: List[Message] = []
        with self._mu:
            stale = [(h, msg) for h, (qn, msg, ts) in self._messages.items()
                     if qn == name and ts < cutoff
                     and h not in self._tombstones]
            if self._fair is None:
                for h, msg in stale:
                    self._tombstones.add(h)
                    msg.status = MessageStatus.TIMEOUT
                    expired.append(msg)
                return expired
        for h, msg in stale:
            # The accounting of a tombstone drained by pop: pending →
            # processing (a wait sample) → failed. ERR_EMPTY: a concurrent
            # pop won the race, and the message is live work now.
            err, _ = self._core.pop_handle(name, h, self._clock.now())
            if err != 0:
                continue
            self._core.fail(name, 0.0)
            self._fair.discard(name, h)
            with self._mu:
                self._messages.pop(h, None)
            msg.status = MessageStatus.TIMEOUT
            expired.append(msg)
        return expired

    # -- stats ---------------------------------------------------------------

    def get_stats(self, name: str) -> QueueStats:
        err, ints, floats = self._core.stats(name)
        if err == self.ERR_NOT_FOUND:
            raise QueueNotFoundError(name)
        return QueueStats(
            queue_name=name,
            pending_count=ints[0],
            processing_count=ints[1],
            completed_count=ints[2],
            failed_count=ints[3],
            wait_samples=ints[4],
            total_wait_time=floats[0],
            total_process_time=floats[1],
        )

    def get_all_stats(self) -> Dict[str, QueueStats]:
        return {n: self.get_stats(n) for n in self.queue_names()}
