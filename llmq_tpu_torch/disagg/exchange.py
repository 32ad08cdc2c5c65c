"""The cluster-wide KV exchange: the conversation store as a handoff
channel (the port's copy of ``llmq_tpu/disagg/exchange.py``).

The tiering plane already serializes a conversation's KV pages into a
self-describing blob (the JAX package's format byte for byte) and keeps
it in the store's KV-payload seam. The exchange uses the same codec and
store under other ownership: a spill blob belongs to the replica that
wrote it, an exchange entry (``xchg:{conv_id}``) is published by one
replica for any peer to claim.

- **publish** stamps the wall-clock ``published_at`` and the publisher's
  role into the blob's meta and overwrites the conversation's previous
  entry (the latest turn wins).
- **claim consumes**: a claim deletes the entry, so one replica adopts
  the KV and a racing peer misses and recomputes.
- **expiry**: an entry older than ``claim_ttl_s`` at claim time is
  deleted unclaimed (its publisher likely died mid-handoff) and the
  claimer recomputes.
- **a torn blob** is deleted and recomputed, as the spill tier does.

Telemetry is buffered and flushed at the scrape
(``disagg.flush_metrics``, from ``metrics.registry.exposition``).
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from llmq_tpu_torch.tiering.plane import blob_meta, decode_blob, encode_blob

log = logging.getLogger("llmq_tpu_torch.disagg")

#: The exchange's keys share the KV-payload namespace with spill blobs;
#: the prefix keeps restart rehydration from adopting one as owned.
EXCHANGE_PREFIX = "xchg:"

_FAMILIES = ("published", "claimed", "expired", "fallback")


class KVExchange:
    """Publish and claim handoff entries in a shared store with the
    KV-payload seam. Thread-safe. ``now_fn`` injects time for tests; the
    default is the wall clock on purpose: ``published_at`` is compared
    across processes."""

    def __init__(self, store: Any, *, role: str = "unified",
                 claim_ttl_s: float = 120.0, miss_ttl_s: float = 5.0,
                 metrics: bool = True,
                 now_fn: Optional[Callable[[], float]] = None) -> None:
        self._store = store
        #: This replica's role: the label of claimed and fallback counts
        #: (published and expired carry the publisher's, from the meta).
        self.role = str(role)
        self.claim_ttl_s = float(claim_ttl_s)
        #: How long the tiering plane's negative cache keeps a miss.
        self.miss_ttl_s = float(miss_ttl_s)
        self.metrics_enabled = bool(metrics)
        self._now = now_fn if now_fn is not None else time.time
        self._mu = threading.Lock()
        #: family → role → buffered count (drained at the scrape).
        self._counts: Dict[str, Dict[str, int]] = {f: {} for f in _FAMILIES}
        #: Buffered (role, ms) publish → claim latencies.
        self._handoff_ms: List[Tuple[str, float]] = []
        #: Lifetime totals for stats(), never reset.
        self.totals: Dict[str, int] = {f: 0 for f in _FAMILIES}
        # A resilience-wrapped store names the exchange in its
        # store_degraded{consumer} gauge; a raw backend has no hook.
        reg = getattr(store, "register_consumer", None)
        if callable(reg):
            reg("exchange")
        _register(self)

    @staticmethod
    def key_for(conv_id: str) -> str:
        return EXCHANGE_PREFIX + conv_id

    def publish(self, conv_id: str, bufs: List[Any], specs: List[Any],
                meta: Optional[Dict[str, Any]] = None) -> None:
        """Write (or overwrite) the claimable entry of ``conv_id``. Empty
        ``bufs`` make a metadata-only handoff (the claimer recomputes from
        ``meta["tokens"]``). Raises on a store failure (the plane's
        worker logs it). A store that reports itself degraded is skipped
        (counted as a fallback): the claimer misses and recomputes."""
        if getattr(self._store, "degraded", False):
            log.info("store degraded; skipping exchange publish for %s",
                     conv_id)
            self._count("fallback", self.role)
            return
        m = dict(meta or {})
        m["published_at"] = self._now()
        m["role"] = self.role
        blob = encode_blob(list(bufs), list(specs), meta=m)
        self._store.save_kv(self.key_for(conv_id), blob)
        self._count("published", self.role)

    def claim(self, conv_id: str
              ) -> Optional[Tuple[List[Any], List[Any], Dict[str, Any]]]:
        """Consume the entry of ``conv_id`` → ``(bufs, specs, meta)``, or
        None (nothing published, expired, torn or a store error: every
        miss is a recompute for the caller)."""
        key = self.key_for(conv_id)
        t0 = time.perf_counter()
        try:
            blob = self._store.load_kv(key)
        except Exception:  # noqa: BLE001 — store fault, timeout, degraded
            log.exception("exchange load failed for %s", conv_id)
            self._count("fallback", self.role)
            return None
        # A load slower than the entry's own TTL serves stale KV at best
        # (a raw slow backend; the resilient store's deadline fires first).
        elapsed = time.perf_counter() - t0
        if elapsed > self.claim_ttl_s:
            self._delete(key)
            self._count("fallback", self.role)
            log.warning("exchange claim for %s spent %.1fs in the store "
                        "(claim_ttl_s=%.1fs); recompute", conv_id,
                        elapsed, self.claim_ttl_s)
            return None
        if blob is None:
            return None
        meta = blob_meta(blob) or {}
        published_at = float(meta.get("published_at") or 0.0)
        now = self._now()
        if published_at and now - published_at > self.claim_ttl_s:
            self._delete(key)
            self._count("expired", str(meta.get("role") or self.role))
            log.info("exchange entry for %s expired after %.1fs "
                     "(publisher dead?); recompute", conv_id,
                     now - published_at)
            return None
        try:
            bufs, specs = decode_blob(blob)
        except ValueError:
            self._delete(key)
            self._count("fallback", self.role)
            log.warning("torn exchange blob for %s; recompute", conv_id)
            return None
        # Consume before returning: a racing peer misses.
        self._delete(key)
        self._count("claimed", self.role)
        if published_at:
            with self._mu:
                self._handoff_ms.append(
                    (self.role, max(0.0, (now - published_at) * 1e3)))
        return bufs, specs, meta

    def note_fallback(self) -> None:
        """Count a handoff that recomputed outside :meth:`claim`."""
        self._count("fallback", self.role)

    def _delete(self, key: str) -> None:
        try:
            self._store.delete_kv(key)
        except Exception:  # noqa: BLE001 — an undeleted entry expires
            log.exception("exchange delete failed for %s", key)

    def pending(self) -> List[str]:
        """Conversation ids with an unclaimed entry (a store scan, for
        operators and tests); empty when the store cannot list."""
        if not hasattr(self._store, "list_kv"):
            return []
        try:
            keys = self._store.list_kv()
        except Exception:  # noqa: BLE001
            log.exception("exchange scan failed")
            return []
        n = len(EXCHANGE_PREFIX)
        return sorted(k[n:] for k in keys if k.startswith(EXCHANGE_PREFIX))

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            out: Dict[str, Any] = dict(self.totals)
        out["role"] = self.role
        out["claim_ttl_s"] = self.claim_ttl_s
        return out

    def _count(self, family: str, role: str) -> None:
        with self._mu:
            fam = self._counts[family]
            fam[role] = fam.get(role, 0) + 1
            self.totals[family] += 1

    def flush_metrics(self) -> None:
        """Scrape-time flush of the buffered counts and latencies."""
        if not self.metrics_enabled:
            return
        from llmq_tpu_torch.metrics.registry import get_metrics

        m = get_metrics()
        with self._mu:
            counts = {f: dict(v) for f, v in self._counts.items()}
            for fam in self._counts.values():
                fam.clear()
            handoffs, self._handoff_ms = self._handoff_ms, []
        families = {
            "published": m.kv_exchange_published,
            "claimed": m.kv_exchange_claimed,
            "expired": m.kv_exchange_expired,
            "fallback": m.kv_exchange_fallback,
        }
        for name, per_role in counts.items():
            for role, n in per_role.items():
                if n:
                    families[name].labels(role).inc(n)
        for role, ms in handoffs:
            m.kv_handoff_ms.labels(role).observe(ms)


_EXCHANGES: "weakref.WeakSet[KVExchange]" = weakref.WeakSet()
_EXCHANGES_LOCK = threading.Lock()


def _register(xchg: KVExchange) -> None:
    with _EXCHANGES_LOCK:
        _EXCHANGES.add(xchg)


def flush_metrics() -> None:
    """The scrape hook: flush every live exchange's buffered telemetry."""
    with _EXCHANGES_LOCK:
        exchanges = list(_EXCHANGES)
    for x in exchanges:
        try:
            x.flush_metrics()
        except Exception:  # noqa: BLE001 — the scrape must not fail here
            log.exception("kv-exchange metric flush failed")
