"""Queue manager: tier queues, priority-adjust rules, the write-ahead
log, monitoring (the port's copy of
``llmq_tpu/queueing/queue_manager.py``; no scale signals yet).

- owns a :class:`MultiLevelQueue` and creates the four tier queues from
  config; ``push_message`` without an explicit queue routes a message to
  its tier's queue, which always exists
- ``push_message`` applies :class:`PriorityAdjustRule` s first
- ``complete_message`` / ``fail_message`` / ``requeue_message`` /
  ``stash_for_retry`` keep the per-tier :class:`QueueStats` right across
  the retry path
- ``remove_message``: admin removal of a pending message
- with ``tenancy.enabled`` a :class:`FairScheduler` (``tenancy/``)
  reorders pops within each tier by tenant virtual time: delivery
  charges the tenant (``note_pop``), complete and fail true the charge
  up from measured tokens (``note_finish``), a requeue or retry stash
  frees the tenant's in-flight slot (``note_requeue``). Off (the
  default), every hook is one attribute check
- with ``wal_path`` every mutation is journaled (``queueing/wal.py``) and
  the journal's live set is restored at construction: pending messages
  re-enter in arrival order, popped-but-unfinished ones are redelivered,
  and what no longer fits a full queue is dropped with an error log. A
  push the journal cannot record raises :class:`WALError` (the REST
  layer answers 503); a failed worker-side record is logged and counted
  in ``wal_errors_total`` and the worker goes on
- a background monitor expires messages older than
  ``queue.stale_message_age`` and compacts the journal once dead records
  dominate (the slow rewrite outside the data-path lock)
- with ``queue.enable_metrics``, the pending and processing gauges, the
  completed and failed counters, the wait and process histograms and
  the operations counter of ``metrics/registry.py``, labelled by
  manager, queue and priority
"""

from __future__ import annotations

import contextlib
import logging
import threading
from dataclasses import dataclass
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import Config, QueueConfig
from llmq_tpu_torch.core.errors import QueueEmptyError, WALError
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
                 clock: Optional[Clock] = None, backend: str = "auto",
                 enable_metrics: Optional[bool] = None,
                 wal_path: Optional[str] = None) -> None:
        self.name = name
        self.config: Config = config or Config()
        self.qconfig: QueueConfig = self.config.queue
        if enable_metrics is None:
            enable_metrics = self.qconfig.enable_metrics
        self._metrics = get_metrics() if enable_metrics else None
        self._clock = clock or SYSTEM_CLOCK
        self.queue = MultiLevelQueue(clock=self._clock, backend=backend)
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
        # The fair scheduler is attached before the journal's restore,
        # so restored messages enter the fair index as live pushes do.
        self._fair = None
        tcfg = self.config.tenancy
        if tcfg.enabled:
            from llmq_tpu_torch import tenancy
            registry = tenancy.configure_tenancy(tcfg)
            self._fair = tenancy.FairScheduler(registry, clock=self._clock)
            tenancy.register_scheduler(self._fair)
            self.queue.set_fair(self._fair)

        self._wal = None
        # Pairs each queue mutation with its journal record against the
        # monitor's live-set snapshot and compaction: without it a
        # message journaled between snapshot and rewrite would vanish
        # from the journal while still live. Free when there is no WAL.
        self._wal_mu = threading.RLock()
        #: id → (queue, Message) of popped or parked, unfinished
        #: messages: live in the journal (redelivered on restart) but
        #: absent from the queue snapshot, so compaction keeps them here.
        self._wal_inflight: Dict[str, Tuple[str, Message]] = {}
        if wal_path:
            self._restore(wal_path)

    def _restore(self, wal_path: str) -> None:
        from llmq_tpu_torch.queueing.wal import QueueWAL

        restored = QueueWAL.replay(wal_path)
        self._wal = QueueWAL(wal_path)
        if not restored:
            return
        kept: List[Tuple[str, Message]] = []
        dropped = 0
        for qname, msg in restored:
            if not self.queue.has_queue(qname):
                self.queue.create_queue(qname,
                                        capacity=self.qconfig.max_queue_size)
            try:
                self.queue.push(qname, msg)
            except Exception:  # noqa: BLE001 — e.g. over capacity
                # Redelivered in-flight messages can overflow a full
                # queue: dropping them (loudly) beats never starting.
                dropped += 1
                continue
            kept.append((qname, msg))
            with self._inflight_mu:
                self._inflight[msg.id] = qname
            if self._metrics is not None:
                self._lbl(self._metrics.pending, qname, msg).inc()
        # Compact, so the journal holds exactly what was kept.
        self._wal.rewrite(kept)
        fields = {"manager": self.name, "restored": len(kept),
                  "dropped": dropped}
        if dropped:
            log.error("wal: DROPPED %d restored messages over queue "
                      "capacity (%s)", dropped, self.name,
                      extra={"fields": fields})
        log.info("wal: restored %d pending messages into %s", len(kept),
                 self.name, extra={"fields": fields})

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
        with self._wal_guard():
            # Journaled BEFORE the push: a pop or complete by a worker can
            # only follow the push, so the records stay in order. A
            # journal that cannot record the message sheds it (WALError).
            self._wal_append("push", qname, message.id, message,
                             critical=True)
            try:
                self.queue.push(qname, message)
            except Exception:
                self._wal_append("remove", qname, message.id)
                self._op_metric("push", "error")
                raise
            if self._wal:
                self._wal_inflight.pop(message.id, None)  # a delayed re-push
        with self._inflight_mu:
            self._inflight[message.id] = qname
        if self._metrics is not None:
            self._lbl(self._metrics.pending, qname, message).inc()
            self._op_metric("push", "success")
        return qname

    def pop_message(self, queue_name: str) -> Message:
        with self._wal_guard():
            msg = self.queue.pop(queue_name)
            self._journal_pop(queue_name, msg)
        self._popped(queue_name, msg)
        self._op_metric("pop", "success")
        return msg

    def batch_pop(self, queue_name: str, max_count: int) -> List[Message]:
        out: List[Message] = []
        for _ in range(max_count):
            with self._wal_guard():
                m = self.queue.try_pop(queue_name)
                if m is None:
                    break
                self._journal_pop(queue_name, m)
            self._popped(queue_name, m)
            out.append(m)
        if out:
            self._op_metric("batch_pop", "success")
        return out

    def _journal_pop(self, qname: str, msg: Message) -> None:
        if self._wal:
            self._wal_append("pop", qname, msg.id)
            self._wal_inflight[msg.id] = (qname, msg)

    def _popped(self, qname: str, msg: Message) -> None:
        if self._fair is not None:
            # Delivery: charge the tenant's virtual time (estimated
            # tokens, trued up at finish) and take an in-flight slot.
            self._fair.note_pop(msg)
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
        with self._wal_guard():
            self.queue.complete_message(qname, message, process_time)
            self._journal_done("complete", qname, message.id)
        self._finished(qname, message, process_time, "complete")

    def fail_message(self, message: Message, process_time: float = 0.0,
                     queue_name: Optional[str] = None) -> None:
        qname = (queue_name or self._pop_inflight(message.id)
                 or self.route_for(message))
        with self._wal_guard():
            self.queue.fail_message(qname, message, process_time)
            self._journal_done("fail", qname, message.id)
        self._finished(qname, message, process_time, "fail")

    def _journal_done(self, op: str, qname: str, message_id: str) -> None:
        """Journal a record that takes the message out of the in-flight
        set (complete, fail, requeue, remove)."""
        if self._wal:
            self._wal_append(op, qname, message_id)
            self._wal_inflight.pop(message_id, None)

    def _finished(self, qname: str, msg: Message, process_time: float,
                  op: str) -> None:
        if self._fair is not None:
            # True-up from measured tokens (metadata.usage) and release
            # of the tenant's in-flight slot.
            self._fair.note_finish(msg, ok=op == "complete")
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
        if self._fair is not None:
            # The slot is freed before the push, which enters the fair
            # index as fresh pending work.
            self._fair.note_requeue(message)
        with self._wal_guard():
            self.queue.requeue(qname, message)
            self._journal_done("requeue", qname, message.id)  # queued again
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
        if self._fair is not None:
            # Parked for its backoff: the tenant's in-flight slot is
            # freed (the delayed re-push enters the fair index again).
            self._fair.note_requeue(message)
        with self._wal_guard():
            self.queue.requeue_accounting_for(qname)
            # Still live (parked in the delayed queue): it stays in the
            # in-flight set that compaction keeps.
            if self._wal:
                self._wal_append("stash", qname, message.id)
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
            with self._wal_guard():
                msg = self.queue.remove_message(qname, message_id)
                if msg is not None:
                    self._journal_done("remove", qname, message_id)
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

    def _wal_guard(self) -> ContextManager[object]:
        """The lock pairing a queue mutation with its journal record;
        free when there is no WAL."""
        return self._wal_mu if self._wal else contextlib.nullcontext()

    def _wal_append(self, op: str, queue_name: str, message_id: str,
                    message: Optional[Message] = None, *,
                    critical: bool = False) -> None:
        """Journal one op. An ``OSError`` (ENOSPC, an IO fault) counts
        ``wal_errors_total{op}`` and logs. ``critical`` (the admission
        path, before the queue mutation) raises it again as
        :class:`WALError`, so the request is shed with a 503 and nothing
        is accepted without its record. A worker-side op goes on: its
        mutation already happened in memory, and a lost record only means
        a restart may redeliver (at-least-once)."""
        if not self._wal:
            return
        try:
            self._wal.append(op, queue_name, message_id, message)
        except OSError as e:
            log.error("WAL %s append failed for %s (disk fault? %s) — %s",
                      op, message_id, e,
                      "shedding request with 503" if critical
                      else "continuing WITHOUT a durability record")
            if self._metrics is not None:
                try:
                    self._metrics.wal_errors.labels(op).inc()
                except Exception:  # noqa: BLE001 — never couple the
                    pass           # fault path to the metrics plane
            if critical:
                raise WALError(op, str(e)) from e

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

    def fair_snapshot(self) -> Optional[Dict]:
        """The fair dequeue's state (virtual times, backlog, served
        tokens, share ratios); None with tenancy off."""
        return self._fair.snapshot() if self._fair is not None else None

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
        if self._wal:
            self._wal.close()

    def _monitor_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.run_monitor_once()
            except Exception:  # noqa: BLE001 — the monitor must survive
                log.exception("monitor tick failed")

    def run_monitor_once(self) -> int:
        """One monitor tick (callable from tests): expire stale pending
        messages, then compact the journal if dead records dominate.
        Returns how many expired."""
        n = 0
        if self.qconfig.stale_message_age > 0:
            for qname in self.queue_names():
                with self._wal_guard():
                    expired = self.queue.expire_older_than(
                        qname, self.qconfig.stale_message_age)
                    for msg in expired:
                        # An expired message must not come back on
                        # restart.
                        self._journal_done("remove", qname, msg.id)
                for msg in expired:
                    self._pop_inflight(msg.id)
                    if self._metrics is not None:
                        self._lbl(self._metrics.pending, qname, msg).dec()
                        self._lbl(self._metrics.failed, qname, msg).inc()
                if expired:
                    log.warning("expired %d stale messages from %s/%s",
                                len(expired), self.name, qname)
                n += len(expired)
        if self._wal and self._wal.needs_compact():
            self._compact()
        return n

    def _compact(self) -> None:
        """Rewrite the journal as the live set (the pending snapshot and
        the unfinished pops). The lock is held only to take the snapshot
        and to swap the file in; the serialization runs outside it, the
        appends made meanwhile buffered into the new file, so the data
        path never stalls for it and no push made meanwhile is erased."""
        n_live, ok, started = 0, False, False
        try:
            with self._wal_mu:
                started = self._wal.begin_compact()
                if started:
                    live = [(qname, m) for qname in self.queue_names()
                            for m in self.queue.snapshot(qname)]
                    live.extend(self._wal_inflight.values())
            if started:
                n_live = self._wal.write_compact_tmp(live)
                ok = True
        finally:
            # Once begun, always finished: a failed snapshot or write
            # aborts (buffer dropped, tmp removed), never wedges it open.
            if started:
                with self._wal_mu:
                    self._wal.finish_compact(n_live, commit=ok)
