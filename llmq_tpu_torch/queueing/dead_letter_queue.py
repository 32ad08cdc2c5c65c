"""Dead-letter queue for messages that exhausted their retries (the
port's copy of ``llmq_tpu/queueing/dead_letter_queue.py``).

A bounded store of ``DeadLetterItem{message, fail_reason, failed_at,
source_queue, retry_count}``; ``push`` runs the registered handlers;
``requeue`` / ``batch_requeue`` reset the retry state and push the
message back into its source queue. The worker's failure path pushes
here once a message's retries are spent. With metrics on, the depth is
the ``dead_letter_depth`` gauge and a raising handler counts in
``dlq_handler_errors_total``.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.errors import MessageNotFoundError
from llmq_tpu_torch.core.types import Message, MessageStatus
from llmq_tpu_torch.metrics.registry import get_metrics

if TYPE_CHECKING:
    from llmq_tpu_torch.queueing.queue_manager import QueueManager

log = logging.getLogger("llmq_tpu_torch.dead_letter_queue")


@dataclass
class DeadLetterItem:
    message: Message
    fail_reason: str
    failed_at: float
    source_queue: str
    retry_count: int

    def to_dict(self) -> Dict:
        return {
            "message": self.message.to_dict(),
            "fail_reason": self.fail_reason,
            "failed_at": self.failed_at,
            "source_queue": self.source_queue,
            "retry_count": self.retry_count,
        }


Handler = Callable[[DeadLetterItem], None]


class DeadLetterQueue:
    def __init__(self, max_size: int = 1000, clock: Optional[Clock] = None,
                 name: str = "dead_letter",
                 enable_metrics: bool = True) -> None:
        self.name = name
        self.max_size = max_size
        self._clock = clock or SYSTEM_CLOCK
        self._items: "OrderedDict[str, DeadLetterItem]" = OrderedDict()
        self._handlers: List[Handler] = []
        self._lock = threading.Lock()
        #: ``dead_letter_depth`` and ``dlq_handler_errors_total`` by
        #: queue name (None: metrics off).
        m = get_metrics() if enable_metrics else None
        self._depth = m.dead_letter_depth.labels(name) if m else None
        self._handler_errors = (m.dlq_handler_errors.labels(name) if m
                                else None)

    def _set_depth_gauge(self) -> None:
        """The parked-message count (callers hold ``self._lock``)."""
        if self._depth is not None:
            self._depth.set(len(self._items))

    def add_handler(self, handler: Handler) -> None:
        with self._lock:
            self._handlers.append(handler)

    def push(self, message: Message, fail_reason: str, source_queue: str) -> DeadLetterItem:
        """Store a dead message; the oldest item is evicted when full."""
        item = DeadLetterItem(
            message=message,
            fail_reason=fail_reason,
            failed_at=self._clock.now(),
            source_queue=source_queue,
            retry_count=message.retry_count,
        )
        with self._lock:
            if len(self._items) >= self.max_size:
                evicted_id, _ = self._items.popitem(last=False)
                log.warning("DLQ %s full; evicted oldest item %s", self.name, evicted_id)
            self._items[message.id] = item
            handlers = list(self._handlers)
            self._set_depth_gauge()
        # Handlers run outside the lock, each wrapped: a raising handler
        # must neither abort the push (the item is stored above) nor
        # starve the remaining handlers.
        for h in handlers:
            try:
                h(item)
            except Exception:  # noqa: BLE001
                log.exception("DLQ handler failed for message %s", message.id)
                if self._handler_errors is not None:
                    self._handler_errors.inc()
        return item

    def get(self, message_id: str) -> DeadLetterItem:
        with self._lock:
            item = self._items.get(message_id)
        if item is None:
            raise MessageNotFoundError(message_id)
        return item

    def items(self, limit: int = 0) -> List[DeadLetterItem]:
        with self._lock:
            out = list(self._items.values())
        return out[:limit] if limit > 0 else out

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def remove(self, message_id: str) -> bool:
        with self._lock:
            removed = self._items.pop(message_id, None) is not None
            self._set_depth_gauge()
            return removed

    def clear(self) -> int:
        with self._lock:
            n = len(self._items)
            self._items.clear()
            self._set_depth_gauge()
            return n

    # -- requeue -------------------------------------------------------------

    def requeue(self, message_id: str, manager: "QueueManager") -> Message:
        """Reset retry state and push back into the source queue. If the
        push fails (queue full/removed) the item is restored to the DLQ
        before the error propagates — a message is never in neither place."""
        with self._lock:
            item = self._items.pop(message_id, None)
            self._set_depth_gauge()
        if item is None:
            raise MessageNotFoundError(message_id)
        msg = item.message
        prev = (msg.retry_count, msg.status, msg.error, msg.scheduled_at)
        msg.retry_count = 0
        msg.status = MessageStatus.PENDING
        msg.error = ""
        msg.scheduled_at = None
        try:
            manager.push_message(msg, item.source_queue or None)
        except Exception:
            msg.retry_count, msg.status, msg.error, msg.scheduled_at = prev
            with self._lock:
                self._items[message_id] = item
                self._set_depth_gauge()
                raise
        return msg

    def batch_requeue(self, manager: "QueueManager",
                      message_ids: Optional[List[str]] = None) -> List[Message]:
        with self._lock:
            ids = message_ids if message_ids is not None else list(self._items)
        out: List[Message] = []
        for mid in ids:
            try:
                out.append(self.requeue(mid, manager))
            except MessageNotFoundError:
                continue
            except Exception as e:  # noqa: BLE001 — push failed; item restored
                log.warning("requeue of %s failed (kept in DLQ): %s", mid, e)
                continue
        return out
