"""Queue factory: registry of named managers and their workers (the
port's copy of ``llmq_tpu/queueing/factory.py``).

- ``QueueType`` ∈ standard / delayed / dead_letter / priority
- ``create_queue_manager(name, type)``: an idempotent registry; every
  manager gets a running :class:`DelayedQueue` for retry backoff and,
  with ``queue.dead_letter_enabled``, a :class:`DeadLetterQueue` that
  also takes retries that could not be delivered
- with ``queue.wal_dir`` each manager journals to
  ``<wal_dir>/<name>.wal`` and restores from it when built
- the "priority" type installs two rules: ``metadata["vip"]`` → HIGH,
  content over 10,000 characters → LOW
- ``create_workers(name, n, process_fn)``, ``get_worker_stats``,
  ``stop_all``
"""

from __future__ import annotations

import enum
import logging
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import Config
from llmq_tpu_torch.core.types import Message, Priority
from llmq_tpu_torch.queueing.dead_letter_queue import DeadLetterQueue
from llmq_tpu_torch.queueing.delayed_queue import DelayedQueue
from llmq_tpu_torch.queueing.queue_manager import (PriorityAdjustRule,
                                                   QueueManager)
from llmq_tpu_torch.queueing.worker import ProcessFn, Worker

log = logging.getLogger("llmq_tpu_torch.queue_factory")


class QueueType(str, enum.Enum):
    """Kinds of managers the factory builds."""

    STANDARD = "standard"
    DELAYED = "delayed"
    DEAD_LETTER = "dead_letter"
    PRIORITY = "priority"


@dataclass
class _Entry:
    manager: QueueManager
    delayed: DelayedQueue
    dlq: Optional[DeadLetterQueue]
    workers: List[Worker]
    qtype: QueueType


def vip_rule() -> PriorityAdjustRule:
    """metadata["vip"] truthy → HIGH."""
    return PriorityAdjustRule(
        name="vip_boost",
        condition=lambda m: bool(m.metadata.get("vip")) and m.priority > Priority.HIGH,
        target_priority=Priority.HIGH,
        description="VIP users get at least high priority",
    )


def long_content_rule(threshold: int = 10_000) -> PriorityAdjustRule:
    """content longer than threshold → LOW."""
    return PriorityAdjustRule(
        name="long_content_demote",
        condition=lambda m: len(m.content) > threshold,
        target_priority=Priority.LOW,
        description=f"Messages over {threshold} chars are demoted to low",
    )


class QueueFactory:
    def __init__(self, config: Optional[Config] = None,
                 clock: Optional[Clock] = None, backend: str = "auto") -> None:
        self.config = config or Config()
        self._clock = clock or SYSTEM_CLOCK
        self._backend = backend
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()

    # -- managers ------------------------------------------------------------

    def create_queue_manager(
        self,
        name: str,
        qtype: QueueType = QueueType.STANDARD,
        start_background: bool = True,
    ) -> QueueManager:
        """Create (or return the existing) named manager, fully wired with
        its delayed queue and DLQ."""
        qtype = QueueType(qtype)
        # Entire create is under the registry lock: a concurrent create for
        # the same name must not build (and leak the background threads of)
        # a second manager.
        with self._lock:
            entry = self._entries.get(name)
            if entry is not None:
                return entry.manager
            wal_path = None
            if self.config.queue.wal_dir:
                wal_path = os.path.join(self.config.queue.wal_dir,
                                        f"{name}.wal")
            manager = QueueManager(name, config=self.config,
                                   clock=self._clock, backend=self._backend,
                                   wal_path=wal_path)
            dlq: Optional[DeadLetterQueue] = None
            if self.config.queue.dead_letter_enabled or qtype == QueueType.DEAD_LETTER:
                dlq = DeadLetterQueue(
                    max_size=self.config.queue.dead_letter_max_size,
                    clock=self._clock, name=f"{name}-dlq",
                    enable_metrics=self.config.queue.enable_metrics)
            # Undeliverable retries (target queue persistently full/missing)
            # land in the DLQ instead of being dropped.
            on_drop = (
                (lambda qname, msg, reason: dlq.push(msg, f"undeliverable: {reason}", qname))
                if dlq is not None else None)
            delayed = DelayedQueue(
                deliver=lambda qname, msg: manager.push_message(msg, qname or None),
                clock=self._clock, name=f"{name}-delayed", on_drop=on_drop)
            if qtype == QueueType.PRIORITY:
                manager.add_priority_rule(vip_rule())
                manager.add_priority_rule(long_content_rule())
            if start_background:
                delayed.start()
                manager.start(monitor_interval=self.config.scheduler.monitor_interval)
            self._entries[name] = _Entry(manager, delayed, dlq, [], qtype)
        log.info("created queue manager %s (type=%s)", name, qtype.value)
        return manager

    def get_queue_manager(self, name: str) -> Optional[QueueManager]:
        with self._lock:
            entry = self._entries.get(name)
            return entry.manager if entry else None

    def get_delayed_queue(self, name: str) -> Optional[DelayedQueue]:
        with self._lock:
            entry = self._entries.get(name)
            return entry.delayed if entry else None

    def get_dead_letter_queue(self, name: str) -> Optional[DeadLetterQueue]:
        with self._lock:
            entry = self._entries.get(name)
            return entry.dlq if entry else None

    def manager_names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    # -- workers -------------------------------------------------------------

    def create_workers(self, manager_name: str, count: int,
                       process_fn: ProcessFn, start: bool = True,
                       on_permanent_failure: Optional[
                           Callable[[Message, str], None]] = None,
                       ) -> List[Worker]:
        with self._lock:
            entry = self._entries.get(manager_name)
        if entry is None:
            raise KeyError(f"queue manager not found: {manager_name}")
        workers: List[Worker] = []
        for i in range(count):
            w = Worker(
                name=f"{manager_name}-w{len(entry.workers) + i}",
                manager=entry.manager,
                process_fn=process_fn,
                delayed_queue=entry.delayed,
                dead_letter_queue=entry.dlq,
                clock=self._clock,
                on_permanent_failure=on_permanent_failure,
            )
            if start:
                w.start()
            workers.append(w)
        with self._lock:
            entry.workers.extend(workers)
        return workers

    def get_worker_stats(self, manager_name: str) -> Dict[str, Dict]:
        with self._lock:
            entry = self._entries.get(manager_name)
            workers = list(entry.workers) if entry else []
        return {w.name: w.stats.to_dict() for w in workers}

    # -- shutdown ------------------------------------------------------------

    def stop_all(self) -> None:
        with self._lock:
            entries = list(self._entries.values())
        for entry in entries:
            for w in entry.workers:
                w.stop()
            entry.delayed.stop()
            entry.manager.stop()
        log.info("stopped %d queue managers", len(entries))
