"""Bounded in-memory message registry behind the message-query API (the
port's copy of ``llmq_tpu/api/message_store.py``).

The API server records every submitted message; the queue plane mutates
the same ``Message`` objects, so status and response show up here with
no extra plumbing. When full, the oldest *terminal* (completed / failed
/ timeout) message is evicted first; a live one only if none is
terminal.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional

from llmq_tpu_torch.core.types import Message, MessageStatus

_TERMINAL = (MessageStatus.COMPLETED, MessageStatus.FAILED,
             MessageStatus.TIMEOUT)


class MessageStore:
    def __init__(self, max_messages: int = 10_000) -> None:
        self.max_messages = max_messages
        self._messages: "OrderedDict[str, Message]" = OrderedDict()
        self._mu = threading.Lock()

    def record(self, message: Message) -> None:
        with self._mu:
            self._messages[message.id] = message
            self._messages.move_to_end(message.id)
            if len(self._messages) > self.max_messages:
                self._evict_locked()

    def _evict_locked(self) -> None:
        victim = None
        for mid, msg in self._messages.items():  # oldest first
            if msg.status in _TERMINAL:
                victim = mid
                break
        if victim is None:  # no terminal message: drop the oldest live one
            victim = next(iter(self._messages))
        del self._messages[victim]

    def get(self, message_id: str) -> Optional[Message]:
        with self._mu:
            return self._messages.get(message_id)

    def list(self, *, user_id: str = "", conversation_id: str = "",
             status: str = "", limit: int = 10,
             offset: int = 0) -> List[Message]:
        """Filtered listing, newest first."""
        with self._mu:
            msgs = list(reversed(self._messages.values()))
        if user_id:
            msgs = [m for m in msgs if m.user_id == user_id]
        if conversation_id:
            msgs = [m for m in msgs if m.conversation_id == conversation_id]
        if status:
            msgs = [m for m in msgs if m.status.value == status]
        if offset:
            msgs = msgs[offset:]
        if limit > 0:
            msgs = msgs[:limit]
        return msgs

    def count(self) -> int:
        with self._mu:
            return len(self._messages)
