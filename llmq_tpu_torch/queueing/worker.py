"""Batch consumer workers (counterpart of ``llmq_tpu/queueing/worker.py``,
trimmed: no retry backoff, dead-letter queue or watchdog).

Every ``process_interval`` a worker drains up to ``max_batch_size``
messages in strict priority order and runs each on a thread pool of
``max_concurrent`` threads, calling ``process_fn(ctx, message)`` with a
:class:`ProcessContext` carrying the message's deadline. A normal
return completes the message; an exception fails it.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Set

from llmq_tpu_torch.core.config import WorkerConfig
from llmq_tpu_torch.core.types import Message
from llmq_tpu_torch.queueing.queue_manager import QueueManager

log = logging.getLogger("llmq_tpu_torch.worker")


class ProcessContext:
    """The deadline of one message (from ``message.timeout``)."""

    def __init__(self, deadline: Optional[float]) -> None:
        self.deadline = deadline

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.time()


ProcessFn = Callable[[ProcessContext, Message], None]


class Worker:
    def __init__(self, name: str, manager: QueueManager,
                 process_fn: ProcessFn,
                 worker_config: Optional[WorkerConfig] = None) -> None:
        self.name = name
        self.manager = manager
        self.process_fn = process_fn
        self.wconfig = worker_config or manager.config.queue.worker
        self.processed = 0
        self.failed = 0
        self._stats_mu = threading.Lock()
        self._sem = threading.Semaphore(self.wconfig.max_concurrent)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._futures: Set[Future] = set()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._pool = ThreadPoolExecutor(self.wconfig.max_concurrent,
                                        thread_name_prefix=f"worker-{self.name}")
        self._thread = threading.Thread(target=self._loop,
                                        name=f"worker-loop-{self.name}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _loop(self) -> None:
        while not self._stop.wait(self.wconfig.process_interval):
            try:
                self.process_batch()
            except Exception:  # noqa: BLE001 — the loop must keep draining
                log.exception("worker %s batch failed", self.name)

    def process_batch(self) -> int:
        """Drain up to max_batch_size messages in priority order and
        dispatch them (inline when the worker is not started). Returns
        the number dispatched."""
        batch = self.manager.drain_in_priority_order(
            self.wconfig.max_batch_size)
        for msg in batch:
            self._sem.acquire()
            pool = self._pool
            if pool is None:
                self._run_one(msg)
                continue
            fut = pool.submit(self._run_one, msg)
            self._futures.add(fut)
            fut.add_done_callback(self._futures.discard)
        return len(batch)

    def _run_one(self, msg: Message) -> None:
        try:
            self._process_message(msg)
        finally:
            self._sem.release()

    def _process_message(self, msg: Message) -> None:
        start = time.time()
        deadline = start + msg.timeout if msg.timeout and msg.timeout > 0 \
            else None
        ctx = ProcessContext(deadline)
        try:
            self.process_fn(ctx, msg)
        except Exception as e:  # noqa: BLE001 — any failure fails the message
            msg.error = repr(e)
            self.manager.fail_message(msg, time.time() - start)
            with self._stats_mu:
                self.failed += 1
            log.warning("message %s failed: %r", msg.id, e)
            return
        self.manager.complete_message(msg, time.time() - start)
        with self._stats_mu:
            self.processed += 1
