"""Core data model: priorities, message lifecycle, messages, queue stats.

The port's own copy of ``llmq_tpu/core/types.py`` (the two packages share
no module): ``Priority`` 4-level tiers where a lower value is more
urgent, ``MessageStatus`` and ``Message`` with retry accounting, a
timeout and free-form metadata, plus the per-queue ``QueueStats``.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


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


def new_id() -> str:
    return str(uuid.uuid4())


@dataclass
class Message:
    """A unit of LLM work flowing through the queue plane."""

    id: str = field(default_factory=new_id)
    conversation_id: str = ""
    user_id: str = ""
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

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "conversation_id": self.conversation_id,
            "user_id": self.user_id,
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


class QueueNotFoundError(KeyError):
    def __init__(self, name: str) -> None:
        super().__init__(f"queue not found: {name}")
        self.queue_name = name


class QueueFullError(Exception):
    def __init__(self, name: str, capacity: int) -> None:
        super().__init__(f"queue full: {name} (capacity {capacity})")
        self.queue_name = name
        self.capacity = capacity


class QueueEmptyError(Exception):
    def __init__(self, name: str) -> None:
        super().__init__(f"queue empty: {name}")
        self.queue_name = name
