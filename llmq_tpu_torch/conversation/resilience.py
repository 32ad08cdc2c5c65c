"""The store fault domain (the port's copy of
``llmq_tpu/conversation/resilience.py``): bounded deadlines, retry, a
breaker and a brownout ladder around the conversation store.

The tiering plane spills KV payloads and the state manager persists
conversations through one store, so a stalled or dead sqlite / redis
backend could hold paths that were built to degrade. :func:`wrap_store`
wraps any ``ConversationStore`` / ``KVPayloadStore`` backend so that
every store call is **bounded and classified**:

- **Per-op wall deadline** (``store.resilience.op_timeout_s``): each op
  runs on a small pool of its own and the caller waits at most the
  deadline, so neither a dead nor a slow store holds a promotion or a
  conversation load longer. A miss raises :class:`StoreOpTimeout`.
- **Seeded jittered exponential retry** of retryable errors only (sqlite
  ``database is locked``, connection resets), at most ``retries`` times;
  anything else fails at once.
- **A store-scoped circuit breaker** (``loadbalancer/circuit_breaker.py``):
  consecutive faults trip it, deadline misses never count, one half-open
  probe per backoff window. A slow store would trip nothing, so
  ``timeout_threshold`` consecutive misses set a **timeout-degraded**
  rung that admits one probe per ``probe_interval_s`` and sheds the rest
  with :class:`StoreDegradedError`.
- **Chaos points** ``store.get``, ``store.put``, ``store.delete`` and
  ``store.kv`` fire inside the pool's worker, so injected latency meets
  the same deadline a slow backend does.
- **Degraded mode**: consumers never wait on the store; they get a fast
  exception and take their rung (the tiering plane keeps demotions in
  host memory and recomputes what it would have promoted from the store;
  the state manager serves its in-memory cache and journals writes into
  a bounded replay buffer). Recovery callbacks fire on the first success
  after a degraded stretch, so journals drain.

Telemetry is buffered and flushed at the scrape (``flush_metrics`` from
``metrics/registry.exposition``): ``store_op_ms{op,outcome}``,
``store_retries_total``, ``store_breaker_state``,
``store_degraded{consumer}``.

Off (``store.resilience.enabled: false``, the default): ``wrap_store`` is
never called and the raw backend serves as it is.
"""

from __future__ import annotations

import concurrent.futures
import logging
import random
import sqlite3
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from llmq_tpu_torch import chaos
from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import StoreResilienceConfig
from llmq_tpu_torch.loadbalancer.circuit_breaker import (STATE_VALUE,
                                                         CircuitBreaker)

log = logging.getLogger("llmq_tpu_torch.store.resilience")

#: Live wrappers, flushed at the scrape.
_STORES: "weakref.WeakSet[ResilientStore]" = weakref.WeakSet()

#: Consumers that may register for the ``store_degraded`` gauge (the
#: label contract's ``consumer`` values). The port's state manager
#: registers ``state`` and ``placement`` (the cluster router's placement
#: records), the tiering plane ``tiering``; ``exchange`` comes with the
#: disaggregation plane.
CONSUMERS = ("tiering", "exchange", "state", "placement")


class StoreDegradedError(RuntimeError):
    """Shed at once: the store is degraded (breaker OPEN, or repeated
    deadline misses) and this op did not win the probe slot."""


class StoreOpTimeout(TimeoutError):
    """The op missed its wall deadline (a dead or slow store)."""


def _retryable(exc: BaseException) -> bool:
    """Only transient contention and connection blips are worth a retry:
    a missing table retried is just a slower failure."""
    if isinstance(exc, sqlite3.OperationalError):
        msg = str(exc).lower()
        return "locked" in msg or "busy" in msg
    if isinstance(exc, (ConnectionError, ConnectionResetError)):
        return True                        # redis connection resets
    return False


class ResilientStore:
    """Wraps a ``ConversationStore`` backend. A KV-capable backend gets
    :class:`ResilientKVStore` (through :func:`wrap_store`), so that
    ``hasattr(store, "save_kv")`` keeps telling the two apart."""

    def __init__(self, inner: Any, config: Optional[StoreResilienceConfig]
                 = None, *, clock: Optional[Clock] = None) -> None:
        cfg = config or StoreResilienceConfig(enabled=True)
        self.inner = inner
        self.config = cfg
        self._clock = clock or SYSTEM_CLOCK
        self._mu = threading.Lock()
        self._rng = random.Random(cfg.seed)
        bcfg = cfg.breaker
        #: The store's breaker; this layer sets ``store_breaker_state``.
        self._breaker: Optional[CircuitBreaker] = None
        if getattr(bcfg, "enabled", True):
            self._breaker = CircuitBreaker(
                "store",
                failure_threshold=getattr(bcfg, "failure_threshold", 3),
                base_backoff=getattr(bcfg, "base_backoff", 1.0),
                max_backoff=getattr(bcfg, "max_backoff", 30.0),
                jitter=getattr(bcfg, "jitter", 0.2),
                clock=self._clock, seed=cfg.seed)
        #: One small pool bounds every op (injected latency included);
        #: a wedged backend exhausting it shows as deadline misses.
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="store-res")
        self._closed = False
        # The timeout-degraded rung (the breaker ignores timeouts).
        self._consec_timeouts = 0
        self._timeout_degraded = False
        self._next_probe = 0.0
        self._was_degraded = False
        self._consumers: set = set()
        self._recovery_cbs: List[Callable[[], None]] = []
        # Buffered telemetry, drained at the scrape.
        self._op_samples: List[Tuple[str, str, float]] = []
        self._retries_delta = 0
        self.totals: Dict[str, int] = {
            "ops": 0, "errors": 0, "timeouts": 0, "retries": 0,
            "shed": 0}
        _STORES.add(self)

    # -- consumers and recovery ------------------------------------------

    def register_consumer(self, name: str) -> None:
        """Consumers call this when they find it, so that
        ``store_degraded{consumer}`` names the planes riding this store."""
        if name in CONSUMERS:
            with self._mu:
                self._consumers.add(name)

    def on_recovery(self, cb: Callable[[], None]) -> None:
        """``cb`` runs (no lock held) on the first success after a
        degraded stretch: the state manager drains its replay buffer."""
        self._recovery_cbs.append(cb)

    # -- the degraded state ----------------------------------------------

    @property
    def degraded(self) -> bool:
        """For consumers choosing their rung before paying for an op: True
        while the breaker holds the store out or the timeout rung is
        set."""
        br = self._breaker
        if br is not None and br.blocked():
            return True
        return self._timeout_degraded

    def _admit(self, op: str) -> None:
        br = self._breaker
        if br is not None and not br.allow():
            self._note(op, "shed", 0.0)
            raise StoreDegradedError(
                f"store breaker open ({op}); retry in {br.retry_in():.2f}s")
        if self._timeout_degraded:
            now = self._clock.now()
            with self._mu:
                if now < self._next_probe:
                    probe = False
                else:
                    self._next_probe = now + max(
                        0.0, self.config.probe_interval_s)
                    probe = True
            if not probe:
                # This call never ran: give the breaker its probe slot
                # back.
                if br is not None:
                    br.record_timeout()
                self._note(op, "shed", 0.0)
                raise StoreDegradedError(
                    f"store timeout-degraded ({op}); probe pending")

    def _note(self, op: str, outcome: str, ms: float) -> None:
        with self._mu:
            self.totals["ops"] += 1
            if outcome == "error":
                self.totals["errors"] += 1
            elif outcome == "timeout":
                self.totals["timeouts"] += 1
            elif outcome == "shed":
                self.totals["shed"] += 1
            if len(self._op_samples) < 10_000:
                self._op_samples.append((op, outcome, ms))

    def _on_success(self, op: str, t0: float) -> None:
        if self._breaker is not None:
            self._breaker.record_success()
        fire: List[Callable[[], None]] = []
        with self._mu:
            self._consec_timeouts = 0
            self._timeout_degraded = False
        if self._was_degraded and not self.degraded:
            self._was_degraded = False
            fire = list(self._recovery_cbs)
            log.info("store recovered: resuming store-tier traffic")
        self._note(op, "ok", (self._clock.now() - t0) * 1e3)
        for cb in fire:
            try:
                cb()
            except Exception:  # noqa: BLE001 — recovery is best effort
                log.exception("store recovery callback failed")

    def _on_timeout(self, op: str, t0: float) -> None:
        if self._breaker is not None:
            self._breaker.record_timeout()   # neutral: no fault counted
        with self._mu:
            self._consec_timeouts += 1
            if (self._consec_timeouts >= max(1, self.config.timeout_threshold)
                    and not self._timeout_degraded):
                self._timeout_degraded = True
                self._next_probe = self._clock.now() + max(
                    0.0, self.config.probe_interval_s)
                log.error(
                    "store timeout-degraded: %d consecutive ops missed the "
                    "%.0fms deadline; consumers fall back (host-tier parks, "
                    "recompute, cache-only history)", self._consec_timeouts,
                    self.config.op_timeout_s * 1e3)
        self._was_degraded = self._was_degraded or self.degraded
        self._note(op, "timeout", (self._clock.now() - t0) * 1e3)

    def _on_failure(self, op: str, t0: float, exc: BaseException) -> None:
        if self._breaker is not None:
            self._breaker.record_failure()
        self._was_degraded = self._was_degraded or self.degraded
        log.warning("store.%s failed: %s", op, exc)
        self._note(op, "error", (self._clock.now() - t0) * 1e3)

    # -- bounded dispatch -------------------------------------------------

    def _run(self, point: str, op: str, fn: Callable[[], Any]) -> Any:
        """Runs on the pool's worker: the chaos point fires here, so an
        injected brownout meets the deadline a slow backend does."""
        chaos.fault(point, op=op)
        return fn()

    def _call(self, op: str, point: str, fn: Callable[[], Any]) -> Any:
        self._admit(op)
        t0 = self._clock.now()
        cfg = self.config
        attempt = 0
        while True:
            if self._closed:
                raise StoreDegradedError("store closed")
            try:
                fut = self._pool.submit(self._run, point, op, fn)
            except RuntimeError as e:       # the pool shut down
                raise StoreDegradedError("store closed") from e
            try:
                result = fut.result(timeout=max(0.001, cfg.op_timeout_s))
            except (TimeoutError, concurrent.futures.TimeoutError) as e:
                # A deadline miss, ChaosTimeout or ChaosPartialResponse:
                # neutral for the breaker, fuel for the timeout rung.
                fut.cancel()
                self._on_timeout(op, t0)
                raise StoreOpTimeout(
                    f"store.{op} exceeded the "
                    f"{cfg.op_timeout_s * 1e3:.0f}ms op deadline") from e
            except Exception as e:
                if attempt < max(0, cfg.retries) and _retryable(e):
                    attempt += 1
                    with self._mu:
                        self.totals["retries"] += 1
                        self._retries_delta += 1
                        backoff = min(
                            cfg.retry_max_backoff_s,
                            cfg.retry_base_backoff_s * (2 ** (attempt - 1)))
                        backoff *= 1.0 + cfg.retry_jitter * (
                            2.0 * self._rng.random() - 1.0)
                    time.sleep(max(0.0, backoff))  # lint: allow-wallclock
                    continue
                self._on_failure(op, t0, e)
                raise
            else:
                self._on_success(op, t0)
                return result

    # -- the ConversationStore surface ------------------------------------

    def save(self, conversation) -> None:
        return self._call("put", "store.put",
                          lambda: self.inner.save(conversation))

    def load(self, conversation_id: str):
        return self._call("get", "store.get",
                          lambda: self.inner.load(conversation_id))

    def list_user(self, user_id: str):
        return self._call("list", "store.get",
                          lambda: self.inner.list_user(user_id))

    def delete(self, conversation_id: str) -> None:
        return self._call("delete", "store.delete",
                          lambda: self.inner.delete(conversation_id))

    def close(self) -> None:
        self._closed = True
        self._pool.shutdown(wait=False)
        self.inner.close()

    # -- introspection ----------------------------------------------------

    def resilience_stats(self) -> Dict[str, Any]:
        """The ``store`` block of ``/health``."""
        with self._mu:
            totals = dict(self.totals)
            consumers = sorted(self._consumers)
        out: Dict[str, Any] = {
            "resilience": True,
            "degraded": self.degraded,
            "timeout_degraded": self._timeout_degraded,
            "consumers": consumers,
            **totals,
        }
        if self._breaker is not None:
            out["breaker"] = self._breaker.get_stats()
        return out

    def flush_metrics(self) -> None:
        """The scrape's drain: ops never touch a labelled child."""
        from llmq_tpu_torch.metrics.registry import get_metrics
        m = get_metrics()
        with self._mu:
            samples, self._op_samples = self._op_samples, []
            retries, self._retries_delta = self._retries_delta, 0
            consumers = sorted(self._consumers)
        for op, outcome, ms in samples:
            m.store_op_ms.labels(op, outcome).observe(ms)
        if retries:
            m.store_retries.inc(retries)
        if self._breaker is not None:
            m.store_breaker_state.set(
                float(STATE_VALUE[self._breaker.state]))
        degraded = 1.0 if self.degraded else 0.0
        for c in consumers:
            m.store_degraded.labels(c).set(degraded)


class ResilientKVStore(ResilientStore):
    """The KV-payload variant: adds the ``KVPayloadStore`` surface, so the
    tiering spill finds it as it finds the raw backend."""

    def save_kv(self, conversation_id: str, blob: bytes) -> None:
        return self._call("kv_put", "store.kv",
                          lambda: self.inner.save_kv(conversation_id, blob))

    def load_kv(self, conversation_id: str):
        return self._call("kv_get", "store.kv",
                          lambda: self.inner.load_kv(conversation_id))

    def delete_kv(self, conversation_id: str) -> None:
        return self._call("kv_delete", "store.kv",
                          lambda: self.inner.delete_kv(conversation_id))

    def list_kv(self):
        return self._call("kv_list", "store.kv",
                          lambda: self.inner.list_kv())


def wrap_store(inner: Any, config: Optional[StoreResilienceConfig] = None,
               *, clock: Optional[Clock] = None) -> ResilientStore:
    """Wrap ``inner``, keeping its KV capability visible to ``hasattr``."""
    cls = ResilientKVStore if hasattr(inner, "save_kv") else ResilientStore
    return cls(inner, config, clock=clock)


def flush_metrics() -> None:
    """The scrape hook (``metrics/registry.exposition``)."""
    for store in list(_STORES):
        store.flush_metrics()
