"""Multi-level priority queue (counterpart of
``llmq_tpu/queueing/priority_queue.py``, over its pure-Python backend).

Named queues, each a min-heap ordered by (priority asc, FIFO within
priority), with a capacity check, pending → processing →
completed/failed accounting and the queue wait recorded at pop. The
JAX package's C++ core (``native/``) belongs to that package and is not
loaded here.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from llmq_tpu_torch.core.types import (Message, MessageStatus,
                                       QueueEmptyError, QueueFullError,
                                       QueueNotFoundError, QueueStats)


class _PyBackend:
    """Heap core keyed by integer handles."""

    ERR_NOT_FOUND = -1
    ERR_FULL = -2
    ERR_EMPTY = -3
    ERR_EXISTS = -4

    def __init__(self) -> None:
        self._heaps: Dict[str, List[Tuple[int, int, int, float]]] = {}
        self._caps: Dict[str, int] = {}
        # [pending, processing, completed, failed, pops, wait, proc_time]
        self._stats: Dict[str, List[float]] = {}
        self._seq = itertools.count(1)
        self._mu = threading.Lock()

    def create_queue(self, name: str, capacity: int) -> int:
        with self._mu:
            if name in self._heaps:
                return self.ERR_EXISTS
            self._heaps[name] = []
            self._caps[name] = capacity
            self._stats[name] = [0, 0, 0, 0, 0, 0.0, 0.0]
            return 0

    def has_queue(self, name: str) -> bool:
        with self._mu:
            return name in self._heaps

    def push(self, name: str, handle: int, priority: int,
             enqueue_ts: float) -> int:
        with self._mu:
            heap = self._heaps.get(name)
            if heap is None:
                return self.ERR_NOT_FOUND
            cap = self._caps[name]
            if cap > 0 and len(heap) >= cap:
                return self.ERR_FULL
            heapq.heappush(heap, (priority, next(self._seq), handle,
                                  enqueue_ts))
            self._stats[name][0] += 1
            return 0

    def pop(self, name: str, now: float) -> Tuple[int, int, float]:
        with self._mu:
            heap = self._heaps.get(name)
            if heap is None:
                return self.ERR_NOT_FOUND, 0, 0.0
            if not heap:
                return self.ERR_EMPTY, 0, 0.0
            _, _, handle, ts = heapq.heappop(heap)
            wait = max(0.0, now - ts)
            s = self._stats[name]
            s[0] -= 1
            s[1] += 1
            s[4] += 1
            s[5] += wait
            return 0, handle, wait

    def finish(self, name: str, process_time: float, ok: bool) -> int:
        with self._mu:
            s = self._stats.get(name)
            if s is None:
                return self.ERR_NOT_FOUND
            if s[1] > 0:
                s[1] -= 1
            s[2 if ok else 3] += 1
            s[6] += process_time
            return 0

    def stats(self, name: str) -> Optional[List[float]]:
        with self._mu:
            s = self._stats.get(name)
            return None if s is None else list(s)

    def queue_names(self) -> List[str]:
        with self._mu:
            return sorted(self._heaps)


class MultiLevelQueue:
    """Named priority queues sharing one ordering core."""

    def __init__(self) -> None:
        self._core = _PyBackend()
        # handle → (queue_name, Message); Python owns the Message objects.
        self._messages: Dict[int, Tuple[str, Message]] = {}
        self._caps: Dict[str, int] = {}
        self._next_handle = itertools.count(1)
        self._mu = threading.Lock()

    def create_queue(self, name: str, capacity: int = 0) -> None:
        if self._core.create_queue(name, capacity) == 0:
            with self._mu:
                self._caps[name] = capacity

    def has_queue(self, name: str) -> bool:
        return self._core.has_queue(name)

    def queue_names(self) -> List[str]:
        return self._core.queue_names()

    def push(self, name: str, message: Message) -> None:
        now = time.time()
        handle = next(self._next_handle)
        # Status is set before the message becomes visible to poppers.
        message.status = MessageStatus.PENDING
        message.touch(now)
        with self._mu:
            self._messages[handle] = (name, message)
        err = self._core.push(name, handle, int(message.priority), now)
        if err == 0:
            return
        with self._mu:
            self._messages.pop(handle, None)
        if err == _PyBackend.ERR_NOT_FOUND:
            raise QueueNotFoundError(name)
        raise QueueFullError(name, self._caps.get(name, 0))

    def pop(self, name: str) -> Message:
        """Most urgent message; moves it to PROCESSING and records the
        measured queue wait as ``last_wait_time``."""
        err, handle, wait = self._core.pop(name, time.time())
        if err == _PyBackend.ERR_NOT_FOUND:
            raise QueueNotFoundError(name)
        if err == _PyBackend.ERR_EMPTY:
            raise QueueEmptyError(name)
        with self._mu:
            _, message = self._messages.pop(handle)
        message.status = MessageStatus.PROCESSING
        message.last_wait_time = wait  # type: ignore[attr-defined]
        message.touch()
        return message

    def try_pop(self, name: str) -> Optional[Message]:
        try:
            return self.pop(name)
        except QueueEmptyError:
            return None

    def complete_message(self, name: str, message: Message,
                         process_time: float = 0.0) -> None:
        if self._core.finish(name, process_time, True) != 0:
            raise QueueNotFoundError(name)
        message.status = MessageStatus.COMPLETED
        message.touch()

    def fail_message(self, name: str, message: Message,
                     process_time: float = 0.0) -> None:
        if self._core.finish(name, process_time, False) != 0:
            raise QueueNotFoundError(name)
        message.status = MessageStatus.FAILED
        message.touch()

    def get_stats(self, name: str) -> QueueStats:
        s = self._core.stats(name)
        if s is None:
            raise QueueNotFoundError(name)
        return QueueStats(queue_name=name, pending_count=int(s[0]),
                          processing_count=int(s[1]),
                          completed_count=int(s[2]), failed_count=int(s[3]),
                          wait_samples=int(s[4]), total_wait_time=s[5],
                          total_process_time=s[6])
