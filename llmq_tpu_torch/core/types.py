"""Core data model: priorities, message lifecycle, messages,
conversations, queue stats.

The port's own copy of ``llmq_tpu/core/types.py`` (the two packages share
no module): ``Priority`` 4-level tiers where a lower value is more
urgent, ``MessageStatus`` and ``Message`` with retry accounting, a
timeout and free-form metadata, ``ConversationState`` and
``Conversation``, plus the per-queue ``QueueStats``.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from llmq_tpu_torch.core.errors import (  # noqa: F401 — re-exported
    QueueEmptyError, QueueFullError, QueueNotFoundError)


class Priority(enum.IntEnum):
    """Priority tiers; lower value = more urgent."""

    REALTIME = 1
    HIGH = 2
    NORMAL = 3
    LOW = 4

    @property
    def tier_name(self) -> str:
        return _PRIORITY_NAMES[self]

    @classmethod
    def from_name(cls, name: str) -> "Priority":
        try:
            return _PRIORITY_BY_NAME[name.strip().lower()]
        except KeyError:
            raise ValueError(f"unknown priority name: {name!r}") from None

    @classmethod
    def parse(cls, value: Any) -> "Priority":
        """Accept Priority, int, numeric string or tier name."""
        if isinstance(value, Priority):
            return value
        if isinstance(value, bool):
            raise TypeError(f"cannot parse priority from {value!r}")
        if isinstance(value, int):
            return cls(value)
        if isinstance(value, str):
            v = value.strip().lower()
            if v.isdigit():
                return cls(int(v))
            return cls.from_name(v)
        raise TypeError(f"cannot parse priority from {value!r}")


_PRIORITY_NAMES = {
    Priority.REALTIME: "realtime",
    Priority.HIGH: "high",
    Priority.NORMAL: "normal",
    Priority.LOW: "low",
}
_PRIORITY_BY_NAME = {v: k for k, v in _PRIORITY_NAMES.items()}

#: Tier names in urgency order — the canonical queue names.
PRIORITY_TIERS = tuple(_PRIORITY_NAMES[p] for p in Priority)


class MessageStatus(str, enum.Enum):
    """Message lifecycle."""

    PENDING = "pending"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"
    TIMEOUT = "timeout"


class ConversationState(str, enum.Enum):
    """Conversation lifecycle."""

    ACTIVE = "active"
    PAUSED = "paused"
    COMPLETED = "completed"
    EXPIRED = "expired"


def new_id() -> str:
    return str(uuid.uuid4())


@dataclass
class Message:
    """A unit of LLM work flowing through the queue plane."""

    id: str = field(default_factory=new_id)
    conversation_id: str = ""
    user_id: str = ""
    #: The request's tenant (``"default"`` when unset): its usage
    #: ledger's attribution and, with ``tenancy.enabled``, the key of its
    #: weight and quotas.
    tenant_id: str = "default"
    content: str = ""
    priority: Priority = Priority.NORMAL
    status: MessageStatus = MessageStatus.PENDING
    retry_count: int = 0
    max_retries: int = 3
    timeout: float = 30.0
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)
    scheduled_at: Optional[float] = None
    metadata: Dict[str, Any] = field(default_factory=dict)
    # Filled by the execution plane:
    response: str = ""
    error: str = ""

    def __post_init__(self) -> None:
        self.priority = Priority.parse(self.priority)
        if not isinstance(self.status, MessageStatus):
            self.status = MessageStatus(self.status)

    def touch(self, now: Optional[float] = None) -> None:
        self.updated_at = time.time() if now is None else now

    def can_retry(self) -> bool:
        return self.retry_count < self.max_retries

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "conversation_id": self.conversation_id,
            "user_id": self.user_id,
            "tenant_id": self.tenant_id,
            "content": self.content,
            "priority": int(self.priority),
            "status": self.status.value,
            "retry_count": self.retry_count,
            "max_retries": self.max_retries,
            "timeout": self.timeout,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
            "scheduled_at": self.scheduled_at,
            # Shallow copy: the execution plane may still be inserting
            # keys (e.g. "usage") while a caller serializes this.
            "metadata": dict(self.metadata),
            "response": self.response,
            "error": self.error,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Message":
        known = set(cls.__dataclass_fields__)  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class Conversation:
    """Multi-turn conversation state."""

    id: str = field(default_factory=new_id)
    user_id: str = ""
    state: ConversationState = ConversationState.ACTIVE
    messages: List[Message] = field(default_factory=list)
    context: str = ""
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)
    last_active_at: float = field(default_factory=time.time)
    metadata: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not isinstance(self.state, ConversationState):
            self.state = ConversationState(self.state)

    def to_dict(self, include_messages: bool = True) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "id": self.id,
            "user_id": self.user_id,
            "state": self.state.value,
            "context": self.context,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
            "last_active_at": self.last_active_at,
            "metadata": dict(self.metadata),
            "message_count": len(self.messages),
        }
        if include_messages:
            d["messages"] = [m.to_dict() for m in self.messages]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Conversation":
        d = dict(d)
        d.pop("message_count", None)
        msgs = [Message.from_dict(m) for m in d.pop("messages", [])]
        known = set(cls.__dataclass_fields__)  # type: ignore[attr-defined]
        conv = cls(**{k: v for k, v in d.items() if k in known})
        conv.messages = msgs
        return conv


@dataclass
class QueueStats:
    """Per-queue statistics."""

    queue_name: str = ""
    pending_count: int = 0
    processing_count: int = 0
    completed_count: int = 0
    failed_count: int = 0
    wait_samples: int = 0
    total_wait_time: float = 0.0
    total_process_time: float = 0.0

    @property
    def avg_wait_time(self) -> float:
        return (self.total_wait_time / self.wait_samples
                if self.wait_samples else 0.0)

    @property
    def avg_process_time(self) -> float:
        done = self.completed_count + self.failed_count
        return self.total_process_time / done if done else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "queue_name": self.queue_name,
            "pending_count": self.pending_count,
            "processing_count": self.processing_count,
            "completed_count": self.completed_count,
            "failed_count": self.failed_count,
            "avg_wait_time": self.avg_wait_time,
            "avg_process_time": self.avg_process_time,
        }
