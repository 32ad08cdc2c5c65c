"""Typed errors of the port (its copy of ``llmq_tpu/core/errors.py``,
trimmed to the queue plane and its journal, the conversation service and
the resource scheduler), so the REST layer maps failures to status codes
without matching strings."""

from __future__ import annotations


class LLMQError(Exception):
    """Base class of the port's errors."""


class QueueNotFoundError(LLMQError, KeyError):
    def __init__(self, name: str) -> None:
        super().__init__(f"queue not found: {name}")
        self.queue_name = name


class QueueFullError(LLMQError):
    def __init__(self, name: str, capacity: int) -> None:
        super().__init__(f"queue full: {name} (capacity {capacity})")
        self.queue_name = name
        self.capacity = capacity


class QueueEmptyError(LLMQError):
    def __init__(self, name: str) -> None:
        super().__init__(f"queue empty: {name}")
        self.queue_name = name


class MessageNotFoundError(LLMQError, KeyError):
    def __init__(self, message_id: str) -> None:
        super().__init__(f"message not found: {message_id}")
        self.message_id = message_id


class WALError(LLMQError, OSError):
    """The queue journal could not record an admission-path op (disk
    full, IO fault). The REST layer sheds the request with a 503 and a
    Retry-After instead of accepting work whose at-least-once promise it
    cannot keep. An ``OSError``, so a caller that treats a failed push
    as an IO fault keeps working."""

    def __init__(self, op: str, cause: str) -> None:
        super().__init__(f"WAL {op} failed: {cause}")
        self.op = op


class ConversationNotFoundError(LLMQError, KeyError):
    def __init__(self, conversation_id: str) -> None:
        super().__init__(f"conversation not found: {conversation_id}")
        self.conversation_id = conversation_id


class NoResourceError(LLMQError):
    """No resource can satisfy the request."""


class NoEndpointError(LLMQError):
    """No healthy endpoint can take the message."""


class AllocationNotFoundError(LLMQError, KeyError):
    def __init__(self, allocation_id: str) -> None:
        super().__init__(f"allocation not found: {allocation_id}")
        self.allocation_id = allocation_id
