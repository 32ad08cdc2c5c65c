"""Conversation persistence stores (the port's copy of
``llmq_tpu/conversation/persistence.py``): one store interface, three
backends.

- ``InMemoryStore``: tests and a single process.
- ``SqliteStore``: a durable single-node store (standard library); one
  row per conversation with JSON messages and metadata.
- ``RedisStore``: a ``prefix+conv_id`` JSON blob plus a
  ``prefix+user:<id>`` set, with a TTL; constructing it without the
  ``redis`` client package raises a clear error.

Every backend also carries the KV-payload seam (:class:`KVPayloadStore`)
that the tiering plane (``llmq_tpu_torch/tiering/``) spills through:
opaque page-payload blobs keyed by conversation id, deleted with their
conversation.
"""

from __future__ import annotations

import json
import logging
import os
import random
import sqlite3
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Protocol, TypeVar

from llmq_tpu_torch.core.types import Conversation

log = logging.getLogger("llmq_tpu_torch.persistence")

_T = TypeVar("_T")


class ConversationStore(Protocol):
    """Save / load / list a user's / delete."""

    def save(self, conversation: Conversation) -> None: ...
    def load(self, conversation_id: str) -> Optional[Conversation]: ...
    def list_user(self, user_id: str) -> List[str]: ...
    def delete(self, conversation_id: str) -> None: ...
    def close(self) -> None: ...


class KVPayloadStore(Protocol):
    """The spill tier's seam: opaque serialized KV page payloads keyed by
    conversation id. The tiering plane feature-detects these methods (a
    store without them disables the store tier); all three backends
    below implement them."""

    def save_kv(self, conversation_id: str, blob: bytes) -> None: ...
    def load_kv(self, conversation_id: str) -> Optional[bytes]: ...
    def delete_kv(self, conversation_id: str) -> None: ...
    def list_kv(self) -> List[str]: ...


class InMemoryStore:
    def __init__(self) -> None:
        self._data: Dict[str, dict] = {}
        self._kv: Dict[str, bytes] = {}
        self._mu = threading.Lock()

    def save(self, conversation: Conversation) -> None:
        with self._mu:
            self._data[conversation.id] = conversation.to_dict()

    def load(self, conversation_id: str) -> Optional[Conversation]:
        with self._mu:
            d = self._data.get(conversation_id)
        return Conversation.from_dict(d) if d else None

    def list_user(self, user_id: str) -> List[str]:
        with self._mu:
            return [cid for cid, d in self._data.items()
                    if d.get("user_id") == user_id]

    def delete(self, conversation_id: str) -> None:
        with self._mu:
            self._data.pop(conversation_id, None)
            self._kv.pop(conversation_id, None)

    # -- KV payload seam -----------------------------------------------------

    def save_kv(self, conversation_id: str, blob: bytes) -> None:
        with self._mu:
            self._kv[conversation_id] = bytes(blob)

    def load_kv(self, conversation_id: str) -> Optional[bytes]:
        with self._mu:
            return self._kv.get(conversation_id)

    def delete_kv(self, conversation_id: str) -> None:
        with self._mu:
            self._kv.pop(conversation_id, None)

    def list_kv(self) -> List[str]:
        with self._mu:
            return list(self._kv.keys())

    def close(self) -> None:
        pass


class SqliteStore:
    """Durable store: one row per conversation with JSON messages and
    metadata columns; WAL journal mode and a busy timeout, so concurrent
    writers queue instead of raising ``database is locked``. KV payloads
    live in a BLOB table, ``kv_payloads``, which opening a database made
    before it existed creates in place (an idempotent migration)."""

    _BUSY_TIMEOUT_MS = 10_000
    #: Bounded retry of the KV-payload operations on ``database is
    #: locked``: ``busy_timeout`` queues only while a writer holds the
    #: lock, and a writer that loses the race at COMMIT under WAL still
    #: raises at once (the tiering worker and the state manager write
    #: from different threads).
    _LOCKED_RETRIES = 4
    _LOCKED_BASE_BACKOFF_S = 0.005
    _LOCKED_MAX_BACKOFF_S = 0.05

    def __init__(self, path: str = "llmq_state.db") -> None:
        self._path = path
        self._local = threading.local()
        # Jitter seeded per path, so contention runs replay the same.
        self._retry_rng = random.Random(zlib.crc32(path.encode("utf-8")))
        self._retry_mu = threading.Lock()
        self._init_schema()

    def _with_locked_retry(self, fn: Callable[[], _T]) -> _T:
        attempt = 0
        while True:
            try:
                return fn()
            except sqlite3.OperationalError as e:
                msg = str(e).lower()
                if (attempt >= self._LOCKED_RETRIES
                        or ("locked" not in msg and "busy" not in msg)):
                    raise
                attempt += 1
                backoff = min(
                    self._LOCKED_MAX_BACKOFF_S,
                    self._LOCKED_BASE_BACKOFF_S * (2 ** (attempt - 1)))
                with self._retry_mu:
                    backoff *= 1.0 + 0.2 * (
                        2.0 * self._retry_rng.random() - 1.0)
                log.debug("sqlite locked (%s); retry %d/%d in %.1f ms",
                          e, attempt, self._LOCKED_RETRIES, backoff * 1e3)
                time.sleep(max(0.0, backoff))

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._path, timeout=10.0)
            conn.execute("PRAGMA journal_mode=WAL")
            # Belt to the connect-timeout braces: the sqlite3 module's
            # ``timeout`` only covers the initial lock wait; statements
            # inside an open transaction need the PRAGMA.
            conn.execute(f"PRAGMA busy_timeout={self._BUSY_TIMEOUT_MS}")
            self._local.conn = conn
        return conn

    def _init_schema(self) -> None:
        conn = self._conn()
        with conn:
            conn.execute(
                """CREATE TABLE IF NOT EXISTS conversations (
                    id TEXT PRIMARY KEY,
                    user_id TEXT NOT NULL,
                    state TEXT NOT NULL,
                    context TEXT NOT NULL DEFAULT '',
                    messages TEXT NOT NULL DEFAULT '[]',
                    metadata TEXT NOT NULL DEFAULT '{}',
                    created_at REAL NOT NULL,
                    updated_at REAL NOT NULL,
                    last_active_at REAL NOT NULL
                )""")
            conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_conv_user "
                "ON conversations(user_id)")
            # The spill tier's table (idempotent, so a database made
            # before it upgrades on open). Payloads are opaque BLOBs,
            # stored byte for byte.
            conn.execute(
                """CREATE TABLE IF NOT EXISTS kv_payloads (
                    conversation_id TEXT PRIMARY KEY,
                    payload BLOB NOT NULL,
                    nbytes INTEGER NOT NULL,
                    updated_at REAL NOT NULL
                )""")

    def save(self, conversation: Conversation) -> None:
        d = conversation.to_dict()
        conn = self._conn()
        with conn:
            conn.execute(
                """INSERT INTO conversations
                   (id, user_id, state, context, messages, metadata,
                    created_at, updated_at, last_active_at)
                   VALUES (?,?,?,?,?,?,?,?,?)
                   ON CONFLICT(id) DO UPDATE SET
                     user_id=excluded.user_id, state=excluded.state,
                     context=excluded.context, messages=excluded.messages,
                     metadata=excluded.metadata,
                     updated_at=excluded.updated_at,
                     last_active_at=excluded.last_active_at""",
                (d["id"], d["user_id"], d["state"], d["context"],
                 json.dumps(d["messages"]), json.dumps(d["metadata"]),
                 d["created_at"], d["updated_at"], d["last_active_at"]))

    def load(self, conversation_id: str) -> Optional[Conversation]:
        cur = self._conn().execute(
            "SELECT id, user_id, state, context, messages, metadata, "
            "created_at, updated_at, last_active_at "
            "FROM conversations WHERE id=?", (conversation_id,))
        row = cur.fetchone()
        if row is None:
            return None
        return Conversation.from_dict({
            "id": row[0], "user_id": row[1], "state": row[2],
            "context": row[3], "messages": json.loads(row[4]),
            "metadata": json.loads(row[5]), "created_at": row[6],
            "updated_at": row[7], "last_active_at": row[8],
        })

    def list_user(self, user_id: str) -> List[str]:
        cur = self._conn().execute(
            "SELECT id FROM conversations WHERE user_id=? "
            "ORDER BY last_active_at DESC", (user_id,))
        return [r[0] for r in cur.fetchall()]

    def delete(self, conversation_id: str) -> None:
        conn = self._conn()
        with conn:
            conn.execute("DELETE FROM conversations WHERE id=?",
                         (conversation_id,))
            conn.execute(
                "DELETE FROM kv_payloads WHERE conversation_id=?",
                (conversation_id,))

    # -- KV payload seam -----------------------------------------------------

    def save_kv(self, conversation_id: str, blob: bytes) -> None:
        def _write() -> None:
            conn = self._conn()
            with conn:
                conn.execute(
                    """INSERT INTO kv_payloads
                       (conversation_id, payload, nbytes, updated_at)
                       VALUES (?,?,?,?)
                       ON CONFLICT(conversation_id) DO UPDATE SET
                         payload=excluded.payload, nbytes=excluded.nbytes,
                         updated_at=excluded.updated_at""",
                    (conversation_id, sqlite3.Binary(bytes(blob)),
                     len(blob), time.time()))

        self._with_locked_retry(_write)

    def load_kv(self, conversation_id: str) -> Optional[bytes]:
        def _read() -> Optional[bytes]:
            cur = self._conn().execute(
                "SELECT payload FROM kv_payloads WHERE conversation_id=?",
                (conversation_id,))
            row = cur.fetchone()
            return bytes(row[0]) if row is not None else None

        return self._with_locked_retry(_read)

    def delete_kv(self, conversation_id: str) -> None:
        def _drop() -> None:
            conn = self._conn()
            with conn:
                conn.execute(
                    "DELETE FROM kv_payloads WHERE conversation_id=?",
                    (conversation_id,))

        self._with_locked_retry(_drop)

    def list_kv(self) -> List[str]:
        cur = self._conn().execute(
            "SELECT conversation_id FROM kv_payloads")
        return [r[0] for r in cur.fetchall()]

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def destroy(self) -> None:
        self.close()
        if os.path.exists(self._path):
            os.remove(self._path)


class RedisStore:
    """``{prefix}{conv_id}`` JSON blob + ``{prefix}user:{user_id}`` set,
    with a TTL. ``client`` injects any redis-protocol client; by default
    the ``redis`` package is required at construction."""

    def __init__(self, url: str = "redis://localhost:6379/0",
                 prefix: str = "llmq:", ttl: float = 24 * 3600.0,
                 client=None) -> None:
        if client is None:
            try:
                import redis  # type: ignore[import-not-found]
            except ImportError as e:
                raise RuntimeError(
                    "RedisStore requires the 'redis' package, which is not "
                    "installed; use backend 'sqlite' "
                    "or 'memory'") from e
            client = redis.Redis.from_url(url)
        self._r = client
        self._prefix = prefix
        self._ttl = int(ttl)

    def _key(self, cid: str) -> str:
        return f"{self._prefix}{cid}"

    def _ukey(self, uid: str) -> str:
        return f"{self._prefix}user:{uid}"

    def save(self, conversation: Conversation) -> None:
        blob = json.dumps(conversation.to_dict())
        pipe = self._r.pipeline()
        pipe.set(self._key(conversation.id), blob, ex=self._ttl)
        pipe.sadd(self._ukey(conversation.user_id), conversation.id)
        pipe.expire(self._ukey(conversation.user_id), self._ttl)
        pipe.execute()

    def load(self, conversation_id: str) -> Optional[Conversation]:
        blob = self._r.get(self._key(conversation_id))
        return Conversation.from_dict(json.loads(blob)) if blob else None

    def list_user(self, user_id: str) -> List[str]:
        return sorted(m.decode() for m in self._r.smembers(self._ukey(user_id)))

    def delete(self, conversation_id: str) -> None:
        conv = self.load(conversation_id)
        pipe = self._r.pipeline()
        pipe.delete(self._key(conversation_id))
        pipe.delete(self._kvkey(conversation_id))
        if conv is not None:
            pipe.srem(self._ukey(conv.user_id), conversation_id)
        pipe.execute()

    # -- KV payload seam -----------------------------------------------------

    def _kvkey(self, cid: str) -> str:
        return f"{self._prefix}kv:{cid}"

    def save_kv(self, conversation_id: str, blob: bytes) -> None:
        self._r.set(self._kvkey(conversation_id), bytes(blob),
                    ex=self._ttl)

    def load_kv(self, conversation_id: str) -> Optional[bytes]:
        blob = self._r.get(self._kvkey(conversation_id))
        return bytes(blob) if blob is not None else None

    def delete_kv(self, conversation_id: str) -> None:
        self._r.delete(self._kvkey(conversation_id))

    def list_kv(self) -> List[str]:
        pat = f"{self._prefix}kv:"
        out: List[str] = []
        for key in self._r.keys(f"{pat}*"):
            name = key.decode() if isinstance(key, bytes) else str(key)
            out.append(name[len(pat):])
        return sorted(out)

    def close(self) -> None:
        self._r.close()


def make_store(backend: str, sqlite_path: str = "llmq_state.db",
               redis_url: str = "redis://localhost:6379/0",
               key_prefix: str = "llmq:",
               cache_ttl: float = 24 * 3600.0) -> ConversationStore:
    if backend == "memory":
        return InMemoryStore()
    if backend == "sqlite":
        return SqliteStore(sqlite_path)
    if backend == "redis":
        return RedisStore(redis_url, key_prefix, cache_ttl)
    raise ValueError(f"unknown persistence backend: {backend!r}")
