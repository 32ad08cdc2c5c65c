"""Conversation state manager (the port's copy of
``llmq_tpu/conversation/state_manager.py``).

- get-or-create with a store fallback
- ``add_message`` appends, trims the context window, persists
- ``record_response`` folds completed responses into
  ``Conversation.context``
- per-user and global conversation caps evict the least recently active
- a cleanup loop expires conversations by TTL, idle time, and 24 h after
  completion, on an injectable clock
- user and active-conversation queries

KV-pin hooks: the engine registers ``on_touch`` / ``on_evict`` callbacks
(``InferenceEngine.attach_conversation_manager``), so a conversation's
paged KV stays pinned on the card while the conversation lives here and
is freed exactly when it is evicted: one eviction policy for host and
device state. The tiering plane spills KV payloads through the same
``store`` (its KV-payload seam), and moves the prefix handle's ``tier``
as a conversation's KV changes tier.

Store fault domain (``conversation/resilience.py``): over a wrapped store
that reports itself degraded, the manager serves history from its
in-memory cache and journals conversation writes into a bounded replay
buffer, which the store's recovery callback drains. A raw backend (the
default) leaves every path as it was.

Placement records: the cluster router records which replica last served
a conversation (``record_placement``) next to the engine's prefix
handle, and its affinity pass reads it back (``placement``), so a
conversation returns to the replica that holds its cached prefix, across
router restarts too.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import ConversationConfig
from llmq_tpu_torch.core.errors import ConversationNotFoundError
from llmq_tpu_torch.core.types import (Conversation, ConversationState,
                                       Message)
from llmq_tpu_torch.conversation.persistence import (ConversationStore,
                                                     InMemoryStore)

log = logging.getLogger("llmq_tpu_torch.conversation")

_COMPLETED_LINGER = 24 * 3600.0  # completed conversations are kept 24 h


class StateManager:
    def __init__(
        self,
        config: Optional[ConversationConfig] = None,
        store: Optional[ConversationStore] = None,
        clock: Optional[Clock] = None,
    ) -> None:
        self.config = config or ConversationConfig()
        self._store = store if store is not None else InMemoryStore()
        self._persist = self.config.persist and store is not None
        self._clock = clock or SYSTEM_CLOCK
        self._convs: Dict[str, Conversation] = {}
        self._user_convs: Dict[str, List[str]] = {}
        self._mu = threading.RLock()
        self._on_touch: List[Callable[[Conversation], None]] = []
        self._on_evict: List[Callable[[Conversation], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The store fault domain, found by duck typing: a degraded store
        # serves the cache and journals writes, drained on recovery.
        cap = 256
        rcfg = getattr(self._store, "config", None)
        if rcfg is not None:
            cap = max(1, int(getattr(rcfg, "replay_buffer", cap)))
        self._replay: Deque[str] = deque(maxlen=cap)
        self._replay_mu = threading.Lock()
        reg = getattr(self._store, "register_consumer", None)
        if callable(reg):
            reg("state")
            reg("placement")
        rec = getattr(self._store, "on_recovery", None)
        if callable(rec):
            rec(self.drain_replay)

    @property
    def store(self) -> ConversationStore:
        """The backing store: the tiering plane spills KV payloads through
        its ``save_kv`` / ``load_kv`` methods when it has them
        (``persistence.KVPayloadStore``)."""
        return self._store

    def _store_degraded(self) -> bool:
        """The degraded rung (False for a raw backend): while True, reads
        serve the in-memory cache and writes journal into the replay
        buffer, so nothing pays a store call known to shed."""
        return bool(getattr(self._store, "degraded", False))

    def replay_pending(self) -> int:
        with self._replay_mu:
            return len(self._replay)

    def drain_replay(self) -> int:
        """Write the journaled conversations back to the recovered store
        (the resilience wrapper's recovery callback; safe at any time).
        A conversation evicted from memory since is skipped; a new failure
        journals it again and stops (the store may bounce)."""
        drained = 0
        while True:
            with self._replay_mu:
                if not self._replay:
                    break
                cid = self._replay.popleft()
            with self._mu:
                conv = self._convs.get(cid)
            if conv is None:
                continue
            try:
                self._store.save(conv)
                drained += 1
            except Exception:  # noqa: BLE001 — the store bounced: re-park
                with self._replay_mu:
                    self._replay.append(cid)
                break
        if drained:
            log.info("store replay buffer drained: %d conversations "
                     "re-persisted", drained)
        return drained

    # -- KV pinning hooks ----------------------------------------------------

    def on_touch(self, cb: Callable[[Conversation], None]) -> None:
        self._on_touch.append(cb)

    def on_evict(self, cb: Callable[[Conversation], None]) -> None:
        self._on_evict.append(cb)

    def _fire(self, cbs: List[Callable[[Conversation], None]],
              conv: Conversation) -> None:
        for cb in cbs:
            try:
                cb(conv)
            except Exception:  # noqa: BLE001
                log.exception("conversation hook failed for %s", conv.id)

    # -- prefix-cache handles (docs/prefix_cache.md) -------------------------

    def record_prefix_handle(self, conversation_id: str,
                             handle: Dict) -> bool:
        """Record the engine-side prefix-KV handle of a conversation:
        after a turn commits, the engine calls this with the committed
        prefix length and page count (the last committed prefix, not
        current residency: the pin may be reclaimed later while the
        radix tree still serves the blocks). Stored under
        ``conversation.metadata["prefix_kv"]``. Does not get-or-create
        (no touch hook fires: the engine calls this with its own lock
        released, and a touch callback would re-enter it) and does not
        write the store inline (the caller is the engine's scheduling
        thread): it rides along the next regular save. False if the
        conversation is unknown here."""
        with self._mu:
            conv = self._convs.get(conversation_id)
            if conv is None:
                return False
            conv.metadata["prefix_kv"] = dict(handle)
        return True

    def update_prefix_handle_tier(self, conversation_id: str,
                                  tier: str) -> bool:
        """Set a recorded prefix handle's ``tier``: "hbm", "host" or
        "store" (the tiering plane's bookkeeping), or "dropped" (the
        pin was reclaimed and nothing holds the KV any more). The
        handle's length and pages, its content identity, stay: a handle
        may outlive HBM residency by design. False when the conversation
        or its handle is unknown."""
        with self._mu:
            conv = self._convs.get(conversation_id)
            if conv is None:
                return False
            h = conv.metadata.get("prefix_kv")
            if not isinstance(h, dict):
                return False
            h["tier"] = tier
        return True

    def record_placement(self, conversation_id: str, endpoint_id: str,
                         cached_tokens: int = 0) -> bool:
        """Record which replica last served this conversation (and so
        holds its cached prefix), under
        ``conversation.metadata["placement"]``. Like the prefix handle it
        creates nothing and does not write the store inline: it rides
        along the next regular save. False if the conversation is
        unknown here."""
        with self._mu:
            conv = self._convs.get(conversation_id)
            if conv is None:
                return False
            conv.metadata["placement"] = {
                "endpoint_id": endpoint_id,
                "cached_tokens": int(cached_tokens),
                "recorded_at": self._clock.now(),
            }
        return True

    def placement(self, conversation_id: str) -> Optional[Dict]:
        """The last placement recorded by :meth:`record_placement`, or
        None."""
        with self._mu:
            conv = self._convs.get(conversation_id)
            if conv is None:
                return None
            h = conv.metadata.get("placement")
            return dict(h) if isinstance(h, dict) else None

    def prefix_handle(self, conversation_id: str) -> Optional[Dict]:
        """The last handle recorded by :meth:`record_prefix_handle`, or
        None."""
        with self._mu:
            conv = self._convs.get(conversation_id)
            if conv is None:
                return None
            h = conv.metadata.get("prefix_kv")
            return dict(h) if isinstance(h, dict) else None

    # -- core API ------------------------------------------------------------

    def get_or_create(self, conversation_id: str, user_id: str = "") -> Conversation:
        """Get or create, falling back to the store."""
        with self._mu:
            conv = self._convs.get(conversation_id)
            if conv is not None:
                conv.last_active_at = self._clock.now()
                self._fire(self._on_touch, conv)
                return conv
        loaded: Optional[Conversation] = None
        if self._persist and not self._store_degraded():
            try:
                loaded = self._store.load(conversation_id)
            except Exception:  # noqa: BLE001
                log.exception("store load failed for %s", conversation_id)
        with self._mu:
            conv = self._convs.get(conversation_id)
            if conv is None:
                conv = loaded or Conversation(
                    id=conversation_id, user_id=user_id,
                    created_at=self._clock.now(),
                    updated_at=self._clock.now(),
                    last_active_at=self._clock.now())
                self._admit_locked(conv)
            conv.last_active_at = self._clock.now()
        self._fire(self._on_touch, conv)
        return conv

    def get(self, conversation_id: str) -> Conversation:
        with self._mu:
            conv = self._convs.get(conversation_id)
        if conv is None and self._persist and not self._store_degraded():
            try:
                conv = self._store.load(conversation_id)
            except Exception:  # noqa: BLE001 — serve from memory only
                log.exception("store load failed for %s", conversation_id)
                conv = None
            if conv is not None:
                with self._mu:
                    self._admit_locked(conv)
        if conv is None:
            raise ConversationNotFoundError(conversation_id)
        return conv

    def create(self, user_id: str, conversation_id: Optional[str] = None,
               metadata: Optional[Dict] = None) -> Conversation:
        conv = Conversation(
            user_id=user_id, created_at=self._clock.now(),
            updated_at=self._clock.now(), last_active_at=self._clock.now(),
            metadata=metadata or {})
        if conversation_id:
            conv.id = conversation_id
        with self._mu:
            self._admit_locked(conv)
        self._save(conv)
        return conv

    def _admit_locked(self, conv: Conversation) -> None:
        self._convs[conv.id] = conv
        lst = self._user_convs.setdefault(conv.user_id, [])
        if conv.id not in lst:
            lst.append(conv.id)
        # Per-user cap: archive the least recently active.
        cap = self.config.max_conversations_per_user
        while cap > 0 and len(lst) > cap:
            oldest_id = min(
                (cid for cid in lst if cid in self._convs),
                key=lambda cid: self._convs[cid].last_active_at,
                default=None)
            if oldest_id is None or oldest_id == conv.id:
                break
            self._evict_locked(self._convs[oldest_id], archive=True)
        # Global cap.
        gcap = self.config.max_conversations
        while gcap > 0 and len(self._convs) > gcap:
            oldest = min(self._convs.values(), key=lambda c: c.last_active_at)
            if oldest.id == conv.id:
                break
            self._evict_locked(oldest, archive=True)

    def add_message(self, conversation_id: str, message: Message,
                    user_id: str = "") -> Conversation:
        """Append, trim the context window, persist."""
        conv = self.get_or_create(conversation_id, user_id or message.user_id)
        with self._mu:
            message.conversation_id = conversation_id
            conv.messages.append(message)
            self._trim_window_locked(conv)
            now = self._clock.now()
            conv.updated_at = now
            conv.last_active_at = now
        self._save(conv)
        return conv

    def record_response(self, conversation_id: str, message: Message) -> None:
        """Fold a completed message's response into the running context
        string."""
        conv = self.get_or_create(conversation_id, message.user_id)
        with self._mu:
            if message.response:
                sep = "\n" if conv.context else ""
                conv.context += f"{sep}{message.response}"
                if len(conv.context) > self.config.max_context_length:
                    conv.context = conv.context[-self.config.max_context_length:]
            conv.updated_at = self._clock.now()
        self._save(conv)

    def _trim_window_locked(self, conv: Conversation) -> None:
        """Sliding window: keep the most recent messages whose cumulative
        content length fits max_context_length (characters)."""
        budget = self.config.max_context_length
        if budget <= 0:
            return
        total = 0
        keep_from = len(conv.messages)
        for i in range(len(conv.messages) - 1, -1, -1):
            total += len(conv.messages[i].content)
            if total > budget and keep_from < len(conv.messages):
                break
            keep_from = i
        if keep_from > 0:
            conv.messages = conv.messages[keep_from:]

    def update_state(self, conversation_id: str,
                     state: ConversationState) -> Conversation:
        conv = self.get(conversation_id)
        with self._mu:
            conv.state = ConversationState(state)
            conv.updated_at = self._clock.now()
        self._save(conv)
        return conv

    def delete(self, conversation_id: str) -> bool:
        with self._mu:
            conv = self._convs.get(conversation_id)
            if conv is not None:
                self._evict_locked(conv, archive=False)
        if self._persist:
            try:
                self._store.delete(conversation_id)
            except Exception:  # noqa: BLE001
                log.exception("store delete failed for %s", conversation_id)
        return conv is not None

    # -- queries -------------------------------------------------------------

    def user_conversations(self, user_id: str) -> List[Conversation]:
        with self._mu:
            local = [self._convs[cid]
                     for cid in self._user_convs.get(user_id, [])
                     if cid in self._convs]
        if self._persist and not self._store_degraded():
            try:
                for cid in self._store.list_user(user_id):
                    if all(c.id != cid for c in local):
                        loaded = self._store.load(cid)
                        if loaded is not None:
                            local.append(loaded)
            except Exception:  # noqa: BLE001
                log.exception("store list_user failed for %s", user_id)
        return sorted(local, key=lambda c: c.last_active_at, reverse=True)

    def active_conversations(self) -> List[Conversation]:
        with self._mu:
            return [c for c in self._convs.values()
                    if c.state == ConversationState.ACTIVE]

    def count(self) -> int:
        with self._mu:
            return len(self._convs)

    # -- cleanup -------------------------------------------------------------

    def run_cleanup_once(self) -> int:
        now = self._clock.now()
        evicted = 0
        with self._mu:
            for conv in list(self._convs.values()):
                expired = (
                    (self.config.ttl > 0
                     and now - conv.created_at > self.config.ttl)
                    or (self.config.max_idle_time > 0
                        and now - conv.last_active_at > self.config.max_idle_time)
                    or (conv.state == ConversationState.COMPLETED
                        and now - conv.updated_at > _COMPLETED_LINGER))
                if expired:
                    if conv.state == ConversationState.ACTIVE:
                        conv.state = ConversationState.EXPIRED
                    self._evict_locked(conv, archive=True)
                    evicted += 1
        if evicted:
            log.info("cleanup evicted %d conversations", evicted)
        return evicted

    def _evict_locked(self, conv: Conversation, archive: bool) -> None:
        """Remove from memory (persisting first if configured) and fire
        KV-unpin hooks."""
        if archive:
            self._save(conv)
        self._convs.pop(conv.id, None)
        lst = self._user_convs.get(conv.user_id)
        if lst and conv.id in lst:
            lst.remove(conv.id)
            if not lst:
                self._user_convs.pop(conv.user_id, None)
        self._fire(self._on_evict, conv)

    def _save(self, conv: Conversation) -> None:
        if not self._persist:
            return
        if self._store_degraded():
            # Write-behind: journal, and spend no probe slot on every
            # save. Drained by drain_replay on recovery.
            with self._replay_mu:
                if conv.id in self._replay:
                    return
                if (self._replay.maxlen is not None
                        and len(self._replay) >= self._replay.maxlen):
                    log.warning(
                        "store replay buffer full (%d); dropping oldest "
                        "journaled write", self._replay.maxlen)
                self._replay.append(conv.id)
            return
        try:
            self._store.save(conv)
        except Exception:  # noqa: BLE001 — a store fault must not fail
            log.exception("store save failed for %s", conv.id)  # a turn
            with self._replay_mu:
                if conv.id not in self._replay:
                    self._replay.append(conv.id)
            return
        # A raw backend has no recovery callback: what it journaled on a
        # passing failure drains as soon as writes work again.
        if self.replay_pending():
            self.drain_replay()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None or self.config.cleanup_interval <= 0:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._cleanup_loop, name="conv-cleanup", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _cleanup_loop(self) -> None:
        while not self._stop.wait(self.config.cleanup_interval):
            try:
                self.run_cleanup_once()
            except Exception:  # noqa: BLE001
                log.exception("conversation cleanup failed")

    def get_stats(self) -> Dict:
        with self._mu:
            states: Dict[str, int] = {}
            for c in self._convs.values():
                states[c.state.value] = states.get(c.state.value, 0) + 1
            return {
                "conversations": len(self._convs),
                "users": len(self._user_convs),
                "by_state": states,
            }
