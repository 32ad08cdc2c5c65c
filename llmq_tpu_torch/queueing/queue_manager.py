"""Queue manager: tier queues, priority-adjust rules, monitoring (the
port's copy of ``llmq_tpu/queueing/queue_manager.py``; no WAL, tenancy
or scale signals yet).

- owns a :class:`MultiLevelQueue` and creates the four tier queues from
  config; ``push_message`` without an explicit queue routes a message to
  its tier's queue, which always exists
- ``push_message`` applies :class:`PriorityAdjustRule` s first
- ``complete_message`` / ``fail_message`` / ``requeue_message`` /
  ``stash_for_retry`` keep the per-tier :class:`QueueStats` right across
  the retry path
- ``remove_message``: admin removal of a pending message
- a background monitor expires messages older than
  ``queue.stale_message_age``
- with ``queue.enable_metrics``, the pending and processing gauges, the
  completed and failed counters, the wait and process histograms and
  the operations counter of ``metrics/registry.py``, labelled by
  manager, queue and priority
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import Config, QueueConfig
from llmq_tpu_torch.core.types import (PRIORITY_TIERS, Message, Priority,
                                       QueueStats)
from llmq_tpu_torch.metrics.registry import get_metrics
from llmq_tpu_torch.queueing.priority_queue import MultiLevelQueue

log = logging.getLogger("llmq_tpu_torch.queue_manager")


@dataclass
class PriorityAdjustRule:
    """A named rule rewriting a message's priority before enqueue."""

    name: str
    condition: Callable[[Message], bool]
    target_priority: Priority
    description: str = ""

    def apply(self, message: Message) -> bool:
        if self.condition(message):
            message.priority = self.target_priority
            return True
        return False


class QueueManager:
    def __init__(self, name: str, config: Optional[Config] = None,
                 clock: Optional[Clock] = None,
                 enable_metrics: Optional[bool] = None) -> None:
        self.name = name
        self.config: Config = config or Config()
        self.qconfig: QueueConfig = self.config.queue
        if enable_metrics is None:
            enable_metrics = self.qconfig.enable_metrics
        self._metrics = get_metrics() if enable_metrics else None
        self._clock = clock or SYSTEM_CLOCK
        self.queue = MultiLevelQueue(clock=self._clock)
        self._rules: List[PriorityAdjustRule] = []
        self._rules_mu = threading.Lock()
        self._stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        # message.id → queue name, for complete/fail and the retry path.
        self._inflight: Dict[str, str] = {}
        self._inflight_mu = threading.Lock()
        for lvl in self.qconfig.levels:
            self.queue.create_queue(Priority(lvl.priority).tier_name,
                                    capacity=self.qconfig.max_queue_size)

    # -- queue management ----------------------------------------------------

    def queue_names(self) -> List[str]:
        return self.queue.queue_names()

    def route_for(self, message: Message) -> str:
        return message.priority.tier_name

    # -- rules ---------------------------------------------------------------

    def add_priority_rule(self, rule: PriorityAdjustRule) -> None:
        with self._rules_mu:
            self._rules.append(rule)

    def remove_priority_rule(self, name: str) -> bool:
        with self._rules_mu:
            before = len(self._rules)
            self._rules = [r for r in self._rules if r.name != name]
            return len(self._rules) != before

    def list_priority_rules(self) -> List[PriorityAdjustRule]:
        with self._rules_mu:
            return list(self._rules)

    def _apply_rules(self, message: Message) -> None:
        with self._rules_mu:
            rules = list(self._rules)
        for rule in rules:
            if rule.apply(message):
                log.debug("rule %s adjusted message %s → %s", rule.name,
                          message.id, message.priority.tier_name)

    # -- data path -----------------------------------------------------------

    def push_message(self, message: Message,
                     queue_name: Optional[str] = None) -> str:
        """Apply rules, route, push. Returns the queue it landed in."""
        self._apply_rules(message)
        qname = queue_name or self.route_for(message)
        try:
            self.queue.push(qname, message)
        except Exception:
            self._op_metric("push", "error")
            raise
        with self._inflight_mu:
            self._inflight[message.id] = qname
        if self._metrics is not None:
            self._lbl(self._metrics.pending, qname, message).inc()
            self._op_metric("push", "success")
        return qname

    def pop_message(self, queue_name: str) -> Message:
        msg = self.queue.pop(queue_name)
        self._popped(queue_name, msg)
        self._op_metric("pop", "success")
        return msg

    def batch_pop(self, queue_name: str, max_count: int) -> List[Message]:
        out: List[Message] = []
        for _ in range(max_count):
            m = self.queue.try_pop(queue_name)
            if m is None:
                break
            self._popped(queue_name, m)
            out.append(m)
        if out:
            self._op_metric("batch_pop", "success")
        return out

    def _popped(self, qname: str, msg: Message) -> None:
        if self._metrics is not None:
            m = self._metrics
            self._lbl(m.pending, qname, msg).dec()
            self._lbl(m.processing, qname, msg).inc()
            self._lbl(m.wait_time, qname, msg).observe(
                getattr(msg, "last_wait_time", 0.0))

    def drain_in_priority_order(self, max_count: int) -> List[Message]:
        """Pop up to ``max_count`` across the tier queues, most urgent
        tier first (strict priority)."""
        out: List[Message] = []
        for tier in PRIORITY_TIERS:
            if len(out) >= max_count:
                break
            if self.queue.has_queue(tier):
                out.extend(self.batch_pop(tier, max_count - len(out)))
        return out

    def complete_message(self, message: Message, process_time: float = 0.0,
                         queue_name: Optional[str] = None) -> None:
        qname = (queue_name or self._pop_inflight(message.id)
                 or self.route_for(message))
        self.queue.complete_message(qname, message, process_time)
        self._finished(qname, message, process_time, "complete")

    def fail_message(self, message: Message, process_time: float = 0.0,
                     queue_name: Optional[str] = None) -> None:
        qname = (queue_name or self._pop_inflight(message.id)
                 or self.route_for(message))
        self.queue.fail_message(qname, message, process_time)
        self._finished(qname, message, process_time, "fail")

    def _finished(self, qname: str, msg: Message, process_time: float,
                  op: str) -> None:
        if self._metrics is not None:
            m = self._metrics
            self._lbl(m.processing, qname, msg).dec()
            self._lbl(m.completed if op == "complete" else m.failed,
                      qname, msg).inc()
            self._lbl(m.process_time, qname, msg).observe(process_time)
            self._op_metric(op, "success")

    def requeue_message(self, message: Message,
                        queue_name: Optional[str] = None) -> str:
        """Return a PROCESSING message to its queue."""
        qname = (queue_name or self._pop_inflight(message.id)
                 or self.route_for(message))
        self.queue.requeue(qname, message)
        with self._inflight_mu:
            self._inflight[message.id] = qname
        if self._metrics is not None:
            self._lbl(self._metrics.processing, qname, message).dec()
            self._lbl(self._metrics.pending, qname, message).inc()
            self._op_metric("requeue", "success")
        return qname

    def stash_for_retry(self, message: Message,
                        queue_name: Optional[str] = None) -> str:
        """Take a PROCESSING message out of queue accounting without a
        completed/failed transition: it re-enters through the delayed
        queue after its retry backoff."""
        qname = (queue_name or self._pop_inflight(message.id)
                 or self.route_for(message))
        self.queue.requeue_accounting_for(qname)
        if self._metrics is not None:
            self._lbl(self._metrics.processing, qname, message).dec()
            self._op_metric("retry_stash", "success")
        return qname

    def remove_message(self, message_id: str,
                       queue_name: Optional[str] = None) -> Optional[Message]:
        """Admin removal of a pending message by id, from one queue or
        all of this manager's queues."""
        names = [queue_name] if queue_name else self.queue_names()
        for qname in names:
            msg = self.queue.remove_message(qname, message_id)
            if msg is not None:
                self._pop_inflight(message_id)
                if self._metrics is not None:
                    self._lbl(self._metrics.pending, qname, msg).dec()
                    self._op_metric("remove", "success")
                return msg
        return None

    def _pop_inflight(self, message_id: str) -> Optional[str]:
        with self._inflight_mu:
            return self._inflight.pop(message_id, None)

    def _lbl(self, family, qname: str, msg: Message):
        return family.labels(self.name, qname, msg.priority.tier_name)

    def _op_metric(self, op: str, status: str) -> None:
        if self._metrics is not None:
            self._metrics.operations.labels(self.name, op, status).inc()

    # -- stats / monitor -----------------------------------------------------

    def get_stats(self, queue_name: str) -> QueueStats:
        return self.queue.get_stats(queue_name)

    def get_all_stats(self) -> Dict[str, QueueStats]:
        return self.queue.get_all_stats()

    def total_pending(self) -> int:
        return self.queue.total_size()

    def start(self, monitor_interval: float = 5.0) -> None:
        """Start the background monitor."""
        if self._monitor_thread is not None:
            return
        self._stop.clear()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, args=(monitor_interval,),
            name=f"qm-monitor-{self.name}", daemon=True)
        self._monitor_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=2.0)
            self._monitor_thread = None

    def _monitor_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.run_monitor_once()
            except Exception:  # noqa: BLE001 — the monitor must survive
                log.exception("monitor tick failed")

    def run_monitor_once(self) -> int:
        """One monitor tick (callable from tests): expire stale pending
        messages. Returns how many expired."""
        n = 0
        if self.qconfig.stale_message_age > 0:
            for qname in self.queue_names():
                expired = self.queue.expire_older_than(
                    qname, self.qconfig.stale_message_age)
                for msg in expired:
                    self._pop_inflight(msg.id)
                    if self._metrics is not None:
                        self._lbl(self._metrics.pending, qname, msg).dec()
                        self._lbl(self._metrics.failed, qname, msg).inc()
                if expired:
                    log.warning("expired %d stale messages from %s/%s",
                                len(expired), self.name, qname)
                n += len(expired)
        return n
