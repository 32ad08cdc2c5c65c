"""Queue manager: the four tier queues and the priority-order drain
(counterpart of ``llmq_tpu/queueing/queue_manager.py``'s ``push_message``
/ ``pop_message``; no delayed queue, dead-letter queue, WAL or spool).

``push_message`` without an explicit queue routes a message to its
tier's queue, which always exists.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from llmq_tpu_torch.core.config import Config
from llmq_tpu_torch.core.types import PRIORITY_TIERS, Message, Priority
from llmq_tpu_torch.queueing.priority_queue import MultiLevelQueue


class QueueManager:
    def __init__(self, name: str, config: Optional[Config] = None) -> None:
        self.name = name
        self.config = config or Config()
        self.queue = MultiLevelQueue()
        # message.id → queue name, for complete/fail.
        self._inflight: Dict[str, str] = {}
        self._inflight_mu = threading.Lock()
        for lvl in self.config.queue.levels:
            self.queue.create_queue(
                Priority(lvl.priority).tier_name,
                capacity=self.config.queue.max_queue_size)

    @staticmethod
    def route_for(message: Message) -> str:
        return message.priority.tier_name

    def push_message(self, message: Message,
                     queue_name: Optional[str] = None) -> str:
        """Push to ``queue_name`` or the message's tier queue; returns
        the queue it landed in."""
        qname = queue_name or self.route_for(message)
        self.queue.push(qname, message)
        with self._inflight_mu:
            self._inflight[message.id] = qname
        return qname

    def pop_message(self, queue_name: str) -> Message:
        return self.queue.pop(queue_name)

    def drain_in_priority_order(self, max_count: int) -> List[Message]:
        """Pop up to ``max_count`` across the tier queues, most urgent
        tier first (strict priority)."""
        out: List[Message] = []
        for tier in PRIORITY_TIERS:
            while len(out) < max_count and self.queue.has_queue(tier):
                msg = self.queue.try_pop(tier)
                if msg is None:
                    break
                out.append(msg)
        return out

    def _pop_inflight(self, message_id: str) -> Optional[str]:
        with self._inflight_mu:
            return self._inflight.pop(message_id, None)

    def complete_message(self, message: Message,
                         process_time: float = 0.0) -> None:
        qname = self._pop_inflight(message.id) or self.route_for(message)
        self.queue.complete_message(qname, message, process_time)

    def fail_message(self, message: Message,
                     process_time: float = 0.0) -> None:
        qname = self._pop_inflight(message.id) or self.route_for(message)
        self.queue.fail_message(qname, message, process_time)
