"""Usage plane: per-request resource attribution, goodput, waste (the
port's copy of ``llmq_tpu/observability/usage.py``).

The flight recorder records *when* a request moved through the pipeline
and the device telemetry measures *what the card did*; this module joins
the two into *who consumed the hardware*:

- **Device-seconds** — every measured chunk's device-execute time
  (``step_device_ms``) is split pro-rata across the decode rows and
  prefill-slice tokens that rode that chunk, accumulated per request on
  the engine side (plain float adds — the hot path never touches this
  module) and finalized here at completion.
- **KV page-seconds** — pages held × wall time, integrated by
  :class:`PageUsageTracker` at every alloc/free-shaped event the engine
  performs against its page allocator. Ref-counted shared prefix pages
  are charged FRACTIONALLY to their current sharers (1/k each),
  re-split whenever a sharer joins or completes, so one physical
  page-second is never billed twice. Pinned conversation KV (resident
  between turns) is billed to the conversation/tenant, not to any
  single request.
- **Waste decomposition** — device-seconds that bought no delivered
  output, by reason: ``retry`` (worker retried the message),
  ``failover`` (the cluster router re-dispatched after a local
  replica's fault), ``crash`` (engine crash recovery failed the
  in-flight work), ``preempt`` / ``shed`` (KV pages reclaimed → the
  rebuild re-prefill repeats work), ``cancelled``, ``error``.
  ``usage_waste_seconds_total{reason}``.
- **Goodput** — useful, SLO-met tokens per attributed device-second,
  over a rolling window, joined from the SLO tracker's met/missed
  verdicts at the flight recorder's flush.

Design constraints:

- **Hard off-switch** — ``observability.usage.enabled: false`` makes
  every engine-side charge a single attribute check; the ledger
  records nothing.
- **Buffered observations** — finalized records queue in a bounded
  deque; Prometheus counters move only at scrape time (``flush``),
  like the recorder's stage histograms and the device gauges.
- **Bounded cardinality** — ``tenant`` is a client-supplied label, so
  the metric label set is first-come bounded at ``max_tenants`` with
  overflow (and id-shaped values — an id-spray must not mint series)
  collapsing to ``"other"``. JSON rollups keep exact ids, LRU-bounded.
"""

from __future__ import annotations

import re
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, Iterable, List, Optional, Tuple


#: Closed enum of waste reasons (mirrored into LABEL_CONTRACT's
#: ``reason`` set — metrics/registry.py).
WASTE_REASONS = ("retry", "failover", "crash", "preempt", "shed",
                 "cancelled", "error")

#: Values that smell like per-request identifiers (the cardinality
#: guard's pattern): such a tenant id never becomes a metric label.
_ID_RX = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$"
    r"|^[0-9a-f]{12,}$"
    r"|^\d{6,}$",
    re.IGNORECASE)

DEFAULT_TENANT = "default"


def sanitize_tenant(raw: Any) -> str:
    """Normalize a client-supplied tenant id for the data plane:
    stripped, length-capped (rollup keys must stay bounded in bytes),
    defaulting to ``"default"``. Metric-label bounding happens later
    (:meth:`UsageLedger.tenant_label`) — this keeps the EXACT id for
    JSON rollups."""
    s = str(raw or "").strip()
    if not s:
        return DEFAULT_TENANT
    return s[:64]


class RequestUsage:
    """Per-request accumulator, owned by the engine (one per admitted
    sequence, charged from the engine thread only — no lock)."""

    __slots__ = ("device_s", "waste_s", "waste_reason",
                 "kv_page_s", "saved_prefill_device_s")

    def __init__(self) -> None:
        self.device_s = 0.0          # device time behind delivered output
        self.waste_s = 0.0           # device time known-wasted (rebuilds)
        self.waste_reason = ""       # why (preempt/shed), set at release
        self.kv_page_s = 0.0         # filled at finalize from the tracker
        self.saved_prefill_device_s = 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "device_seconds": round(self.device_s, 6),
            "waste_seconds": round(self.waste_s, 6),
            "kv_page_seconds": round(self.kv_page_s, 3),
            "saved_prefill_device_seconds":
                round(self.saved_prefill_device_s, 6),
        }


class PageUsageTracker:
    """Integrates pages-held × wall-time per holder.

    Holders are request ids (live sequences) or pin keys (conversation
    KV resident between turns). Each holder owns ``excl`` exclusive
    pages outright and references zero or more SHARED pages (radix
    prefix blocks): a shared page's page-seconds are split 1/k across
    its k current holders, re-split at every membership change — the
    integration is piecewise-constant between events, and every event
    integrates the elapsed interval for ALL holders first, so a
    sharer's completion re-splits from that instant onward and no
    page-second is ever double-counted.

    Events are admission/finish/page-growth-shaped (never per token);
    one event costs O(holders + shared references).
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        #: key → (excl_pages, tuple(shared page ids))
        self._holders: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
        #: shared page id → set of holder keys
        self._sharers: Dict[int, set] = {}
        self._charges: Dict[str, float] = {}
        self._last = time.monotonic()

    def _integrate_locked(self, now: float) -> None:
        dt = now - self._last
        self._last = now
        if dt <= 0 or not self._holders:
            return
        sharers = self._sharers
        charges = self._charges
        for key, (excl, shared) in self._holders.items():
            c = float(excl)
            for p in shared:
                n = len(sharers.get(p) or ())
                if n:
                    c += 1.0 / n
            if c:
                charges[key] = charges.get(key, 0.0) + c * dt

    def update(self, key: str, excl: int,
               shared: Iterable[int] = ()) -> None:
        """Set ``key``'s current holding (exclusive count + shared page
        ids). Idempotent; call after every page-set mutation."""
        shared_t = tuple(shared)
        with self._mu:
            self._integrate_locked(time.monotonic())
            old = self._holders.get(key)
            if old is not None:
                for p in old[1]:
                    s = self._sharers.get(p)
                    if s is not None:
                        s.discard(key)
                        if not s:
                            del self._sharers[p]
            self._holders[key] = (max(0, int(excl)), shared_t)
            for p in shared_t:
                self._sharers.setdefault(p, set()).add(key)

    def close(self, key: str) -> float:
        """Stop tracking ``key`` and return its accumulated
        page-seconds (0.0 for an unknown key)."""
        with self._mu:
            self._integrate_locked(time.monotonic())
            old = self._holders.pop(key, None)
            if old is not None:
                for p in old[1]:
                    s = self._sharers.get(p)
                    if s is not None:
                        s.discard(key)
                        if not s:
                            del self._sharers[p]
            return self._charges.pop(key, 0.0)

    def peek(self, key: str) -> float:
        """Accumulated page-seconds for ``key`` including time up to
        now, without closing it (stats/testing)."""
        with self._mu:
            self._integrate_locked(time.monotonic())
            return self._charges.get(key, 0.0)

    def holders(self) -> int:
        with self._mu:
            return len(self._holders)


class _Agg:
    """One rollup bucket (tenant / priority / engine / conversation)."""

    __slots__ = ("requests", "tokens", "prompt_tokens", "device_s",
                 "waste_s", "kv_page_s", "saved_prefill_device_s",
                 "first_s")

    def __init__(self) -> None:
        self.requests = 0
        self.tokens = 0
        self.prompt_tokens = 0
        self.device_s = 0.0
        self.waste_s = 0.0
        self.kv_page_s = 0.0
        self.saved_prefill_device_s = 0.0
        #: When the bucket was made: the saved-prefill rate's origin.
        self.first_s = time.monotonic()

    def add(self, rec: "_FinalRecord") -> None:
        self.requests += 1
        self.tokens += rec.tokens
        self.prompt_tokens += rec.prompt_tokens
        self.device_s += rec.useful_s
        self.waste_s += rec.waste_s
        self.kv_page_s += rec.kv_page_s
        self.saved_prefill_device_s += rec.saved_s

    def to_dict(self) -> Dict[str, Any]:
        return {
            "requests": self.requests,
            "tokens": self.tokens,
            "prompt_tokens": self.prompt_tokens,
            "device_seconds": round(self.device_s, 6),
            "waste_seconds": round(self.waste_s, 6),
            "kv_page_seconds": round(self.kv_page_s, 3),
            "saved_prefill_device_seconds":
                round(self.saved_prefill_device_s, 6),
        }


class _FinalRecord:
    """One finalized request's attribution, kept briefly for metric
    flush, waste reclassification (a retry arrives AFTER the
    engine's finalize) and the goodput join."""

    __slots__ = ("tenant", "priority", "engine", "conversation",
                 "tokens", "prompt_tokens", "useful_s", "waste_s",
                 "waste_reason", "kv_page_s", "saved_s", "ok", "ts",
                 "flushed")

    def __init__(self, tenant: str, priority: str, engine: str,
                 conversation: str, tokens: int, prompt_tokens: int,
                 useful_s: float, waste_s: float, waste_reason: str,
                 kv_page_s: float, saved_s: float,
                 ok: bool = True) -> None:
        self.tenant = tenant
        self.priority = priority
        self.engine = engine
        self.conversation = conversation
        self.tokens = tokens
        self.prompt_tokens = prompt_tokens
        self.useful_s = useful_s
        self.waste_s = waste_s
        self.waste_reason = waste_reason
        self.kv_page_s = kv_page_s
        self.saved_s = saved_s
        self.ok = ok
        self.ts = time.time()
        self.flushed = False


class UsageLedger:
    """Process-wide attribution ledger (singleton, like the flight
    recorder): the engine charges it, the worker annotates waste
    causes, the recorder's flush feeds the goodput join, /metrics
    drains it, and ``GET /api/v1/usage`` reads the rollups."""

    #: Finalized records retained for reclassification + flush.
    MAX_RECENT = 8192
    #: Goodput window entries (oldest-out).
    MAX_WINDOW = 65536

    def __init__(self, *, enabled: bool = True, max_tenants: int = 64,
                 max_conversations: int = 1024,
                 goodput_window_s: float = 300.0,
                 metrics: bool = True) -> None:
        self.enabled = enabled
        self.metrics_enabled = metrics
        self.max_tenants = int(max_tenants)
        self.max_conversations = int(max_conversations)
        self.goodput_window_s = float(goodput_window_s)
        self._mu = threading.Lock()
        self.tracker = PageUsageTracker()
        # Cumulative rollups (JSON surface; exact ids, LRU-bounded for
        # conversations).
        self._by_tenant: Dict[str, _Agg] = {}
        self._by_priority: Dict[str, _Agg] = {}
        self._by_engine: Dict[str, _Agg] = {}
        self._by_conversation: "OrderedDict[str, _Agg]" = OrderedDict()
        self._waste_by_reason: Dict[str, float] = {}
        # Conservation totals: every measured device-second lands in
        # exactly one of (attributed → some request, unattributed →
        # chunks whose rows all vanished mid-flight).
        self.total_device_s = 0.0
        self.attributed_device_s = 0.0
        self.unattributed_device_s = 0.0
        self.pinned_kv_page_s = 0.0
        self.requests_finalized = 0
        #: request id → _FinalRecord (bounded; also the metric-flush
        #: queue — unflushed records flush at scrape).
        self._recent: "OrderedDict[str, _FinalRecord]" = OrderedDict()
        #: Bounded like the recorder's pending-metrics queue: a process
        #: that is never scraped must not grow one record per request
        #: forever (oldest records drop their metric increment, never
        #: the rollups — those were applied at finalize).
        self._pending_flush: deque = deque(maxlen=self.MAX_RECENT)
        #: Metric-label set for ``tenant``: first-come bounded.
        self._tenant_labels: set = set()
        #: Pinned-conversation KV meters: conv id → tenant to bill.
        self._pin_tenants: Dict[str, str] = {}
        #: Waste causes announced BEFORE the engine finalized (the
        #: worker's retry decision can beat the engine thread's reap of
        #: a cancelled sequence) — consumed at finalize. Bounded FIFO.
        self._pending_causes: "OrderedDict[str, str]" = OrderedDict()
        #: Goodput window: (ts, tokens, device_s, slo_met).
        self._window: deque = deque(maxlen=self.MAX_WINDOW)

    def reconfigure(self, *, enabled: Optional[bool] = None,
                    max_tenants: Optional[int] = None,
                    max_conversations: Optional[int] = None,
                    goodput_window_s: Optional[float] = None) -> None:
        """Apply config in place (singleton contract — every layer
        already holds a reference)."""
        with self._mu:
            if enabled is not None:
                self.enabled = bool(enabled)
            if max_tenants is not None:
                self.max_tenants = int(max_tenants)
            if max_conversations is not None:
                self.max_conversations = int(max_conversations)
            if goodput_window_s is not None:
                self.goodput_window_s = float(goodput_window_s)

    # -- engine-side feed -----------------------------------------------------

    def note_step(self, device_s: float, attributed_s: float) -> None:
        """Conservation accounting for one measured chunk: the engine
        already split ``attributed_s`` onto its sequences' accumulators;
        the remainder (rows that finished/vanished before the split)
        is explicitly unattributed rather than silently dropped."""
        with self._mu:
            self.total_device_s += device_s
            self.attributed_device_s += attributed_s
            if device_s > attributed_s:
                self.unattributed_device_s += device_s - attributed_s

    def finalize(self, request_id: str, usage: RequestUsage, *,
                 tenant: str, priority: str, engine: str,
                 conversation: str = "", tokens: int = 0,
                 prompt_tokens: int = 0, ok: bool = True,
                 waste_reason: str = "") -> Dict[str, Any]:
        """Close one request's attribution. ``ok`` distinguishes
        delivered output (device_s stays useful) from a failed/
        cancelled request (ALL its device time becomes waste under
        ``waste_reason``). Returns the per-request usage summary the
        caller attaches to the finished handle / SSE final event."""
        with self._mu:
            announced = self._pending_causes.pop(request_id, None)
        if ok:
            useful = usage.device_s
            waste = usage.waste_s
            reason = usage.waste_reason or "preempt"
        else:
            useful = 0.0
            waste = usage.device_s + usage.waste_s
            reason = waste_reason or usage.waste_reason or "error"
            if announced and reason in ("error", "cancelled"):
                # The worker or the router already named the cause
                # (retry, failover) before the engine thread got here.
                reason = announced
        if reason not in WASTE_REASONS:
            reason = "error"
        rec = _FinalRecord(tenant, priority, engine, conversation,
                           int(tokens), int(prompt_tokens), useful,
                           waste, reason, usage.kv_page_s,
                           usage.saved_prefill_device_s, ok=ok)
        with self._mu:
            self._recent[request_id] = rec
            while len(self._recent) > self.MAX_RECENT:
                self._recent.popitem(last=False)
            self._pending_flush.append(rec)
            self.requests_finalized += 1
            self._by_tenant.setdefault(tenant, _Agg()).add(rec)
            self._by_priority.setdefault(priority, _Agg()).add(rec)
            self._by_engine.setdefault(engine, _Agg()).add(rec)
            if conversation:
                agg = self._by_conversation.get(conversation)
                if agg is None:
                    agg = self._by_conversation[conversation] = _Agg()
                else:
                    self._by_conversation.move_to_end(conversation)
                agg.add(rec)
                while len(self._by_conversation) > self.max_conversations:
                    self._by_conversation.popitem(last=False)
            if waste > 0:
                self._waste_by_reason[reason] = (
                    self._waste_by_reason.get(reason, 0.0) + waste)
        return {
            "tenant": tenant,
            "device_seconds": round(useful, 6),
            "waste_seconds": round(waste, 6),
            "waste_reason": reason if waste > 0 else "",
            "kv_page_seconds": round(usage.kv_page_s, 3),
            "saved_prefill_device_seconds":
                round(usage.saved_prefill_device_s, 6),
        }

    def conversation_saved_rate(self, conversation: str) -> float:
        """The conversation's ``saved_prefill_device_seconds`` accrual
        rate: device-seconds of prefill its cached KV saved per second
        since the ledger first saw it. The tiering plane's "saved_rate"
        policy evicts the lowest first; a conversation never credited
        scores 0.0, which leaves the ranking to recency."""
        if not self.enabled:
            return 0.0
        now = time.monotonic()
        with self._mu:
            agg = self._by_conversation.get(conversation)
            if agg is None or agg.saved_prefill_device_s <= 0.0:
                return 0.0
            return agg.saved_prefill_device_s / max(now - agg.first_s, 1.0)

    def add_pinned_kv(self, tenant: str, conversation: str,
                      page_s: float) -> None:
        """Charge a pinned conversation's between-turns KV residency to
        the conversation and tenant rollups (no single request owns
        it)."""
        if page_s <= 0:
            return
        with self._mu:
            self.pinned_kv_page_s += page_s
            agg = self._by_tenant.setdefault(tenant, _Agg())
            agg.kv_page_s += page_s
            conv = self._by_conversation.get(conversation)
            if conv is not None:
                conv.kv_page_s += page_s

    def pin_kv(self, conversation: str, n_pages: int,
               tenant: str) -> None:
        """A conversation's KV went resident between turns: start the
        pin's page-second meter (billed to the conversation/tenant at
        unpin — between-turns residency has no single owning request)."""
        if not self.enabled:
            return
        with self._mu:
            self._pin_tenants[conversation] = tenant
        self.tracker.update("pin:" + conversation, n_pages)

    def unpin_kv(self, conversation: str) -> None:
        """The pin ended (next-turn adoption, TTL, pool pressure or
        delete): close the meter and charge the rollups."""
        if not self.enabled:
            return
        page_s = self.tracker.close("pin:" + conversation)
        with self._mu:
            tenant = self._pin_tenants.pop(conversation, DEFAULT_TENANT)
        self.add_pinned_kv(tenant, conversation, page_s)

    # -- waste-cause annotation (worker / router) -----------------------------

    def _reclassify(self, request_id: str, reason: str) -> bool:
        """Move a just-finalized request's waste to a more specific
        reason. Only the engine's generic terminal classifications are
        rewritable — never a crash/preempt attribution — and only
        BEFORE the record's metrics flushed (counters cannot move
        between labels afterwards; the race window is one scrape).
        When the engine has not finalized yet (its thread may still be
        reaping the cancelled sequence), the cause is parked and
        consumed at finalize instead."""
        with self._mu:
            rec = self._recent.get(request_id)
            if rec is None or rec.flushed:
                # Announced before this attempt finalized (or the
                # previous attempt's record is already immutable):
                # park the cause for the next finalize of this id.
                self._pending_causes[request_id] = reason
                while len(self._pending_causes) > 4096:
                    self._pending_causes.popitem(last=False)
                return True
            if (rec.waste_s <= 0
                    or rec.waste_reason not in ("error", "cancelled")):
                return False
            old = rec.waste_reason
            rec.waste_reason = reason
            self._waste_by_reason[old] = max(
                0.0, self._waste_by_reason.get(old, 0.0) - rec.waste_s)
            self._waste_by_reason[reason] = (
                self._waste_by_reason.get(reason, 0.0) + rec.waste_s)
            return True

    def note_retry(self, request_id: str) -> None:
        """The worker scheduled a retry for this message: the failed
        attempt's device time was retried-away work."""
        if self.enabled:
            self._reclassify(request_id, "retry")

    def note_failover(self, request_id: str) -> None:
        """The router is dispatching again after a local replica's
        fault: that attempt's partial work was failover waste."""
        if self.enabled:
            self._reclassify(request_id, "failover")

    # -- goodput (fed from the recorder's flush) ------------------------------

    def observe_request(self, request_id: str,
                        stage_latencies: Dict[str, float], priority: str,
                        duration_ms: Optional[float],
                        ts: Optional[float] = None) -> None:
        """Join one finalized timeline's SLO verdict with its attributed
        device time (same call shape as SloTracker.observe_request —
        both are fed from FlightRecorder.flush_metrics)."""
        if not self.enabled:
            return
        with self._mu:
            rec = self._recent.get(request_id)
        if rec is None:
            return
        met = rec.ok
        try:
            from llmq_tpu_torch.observability.slo import get_slo_tracker
            targets = get_slo_tracker().targets
        except Exception:  # noqa: BLE001 — verdict degrades to "delivered"
            targets = {}
        ttft = stage_latencies.get("ttft")
        t = targets.get("ttft")
        if met and t and ttft is not None and ttft * 1e3 > t:
            met = False
        t = targets.get("realtime")
        if (met and t and priority == "realtime"
                and duration_ms is not None and duration_ms > t):
            met = False
        now = time.time() if ts is None else ts
        with self._mu:
            self._window.append(
                (now, rec.tokens, rec.useful_s + rec.waste_s, met))

    def goodput(self) -> Dict[str, Any]:
        """Rolling SLO-met tokens per attributed device-second. Waste
        counts in the denominator — wasted device time is exactly what
        goodput must punish."""
        now = time.time()
        horizon = now - self.goodput_window_s
        with self._mu:
            while self._window and self._window[0][0] < horizon:
                self._window.popleft()
            entries = list(self._window)
        n = len(entries)
        met = sum(1 for _, _, _, m in entries if m)
        tok_met = sum(t for _, t, _, m in entries if m)
        dev = sum(d for _, _, d, _ in entries)
        return {
            "window_s": self.goodput_window_s,
            "requests": n,
            "slo_met_requests": met,
            "tokens_slo_met": tok_met,
            "device_seconds": round(dev, 6),
            "tokens_per_device_second": (round(tok_met / dev, 3)
                                         if dev > 0 else 0.0),
        }

    # -- metric labels --------------------------------------------------------

    def tenant_label(self, tenant: str) -> str:
        """Bounded metric label for a tenant id: the first
        ``max_tenants`` distinct NON-id-shaped ids get their own series;
        everything else is ``"other"`` (an id-spray mints at most one
        extra series). Call sites hold self._mu."""
        if tenant in self._tenant_labels:
            return tenant
        if _ID_RX.match(tenant) or len(tenant) > 64:
            return "other"
        if len(self._tenant_labels) >= self.max_tenants:
            return "other"
        self._tenant_labels.add(tenant)
        return tenant

    def bounded_label(self, tenant: str) -> str:
        """The self-locking form of :meth:`tenant_label`: the tenancy
        plane's metric flush shares the same first-come bound, so the
        usage and fairness families agree on which ids own a series."""
        with self._mu:
            return self.tenant_label(tenant)

    # -- scrape-time flush ----------------------------------------------------

    def flush(self) -> int:
        """Drain finalized records into the Prometheus counters and set
        the goodput gauge — called from the /metrics exposition path
        (same deferred design as the recorder/device planes). Returns
        the number of records flushed."""
        if not self.enabled or not self.metrics_enabled:
            return 0
        try:
            from llmq_tpu_torch.metrics.registry import get_metrics
            m = get_metrics()
        except Exception:  # noqa: BLE001 — metrics must not fail scrapes
            return 0
        n = 0
        while True:
            try:
                rec = self._pending_flush.popleft()
            except IndexError:
                break
            with self._mu:
                rec.flushed = True
                tlabel = self.tenant_label(rec.tenant)
            if rec.useful_s > 0:
                m.usage_device_seconds.labels(
                    tlabel, rec.priority).inc(rec.useful_s)
            if rec.waste_s > 0:
                m.usage_waste_seconds.labels(
                    rec.waste_reason).inc(rec.waste_s)
            if rec.kv_page_s > 0:
                m.usage_kv_page_seconds.labels(tlabel).inc(rec.kv_page_s)
            if rec.saved_s > 0:
                m.usage_saved_prefill_seconds.labels(
                    tlabel).inc(rec.saved_s)
            n += 1
        m.goodput_tokens_per_device_s.set(
            self.goodput()["tokens_per_device_second"])
        with self._mu:
            m.usage_tenants_tracked.set(len(self._by_tenant))
        return n

    # -- reads ----------------------------------------------------------------

    def snapshot(self, top_conversations: int = 20) -> Dict[str, Any]:
        """The ``GET /api/v1/usage`` payload (and the ``usage`` block of
        engine stats)."""
        with self._mu:
            waste_total = sum(self._waste_by_reason.values())
            out: Dict[str, Any] = {
                "enabled": self.enabled,
                "totals": {
                    "requests": self.requests_finalized,
                    "device_seconds": round(self.total_device_s, 6),
                    "attributed_device_seconds":
                        round(self.attributed_device_s, 6),
                    "unattributed_device_seconds":
                        round(self.unattributed_device_s, 6),
                    "useful_device_seconds": round(
                        sum(a.device_s for a in self._by_tenant.values()),
                        6),
                    "waste_device_seconds": round(waste_total, 6),
                    "waste_ratio": (
                        round(waste_total / self.total_device_s, 4)
                        if self.total_device_s > 0 else 0.0),
                    "kv_page_seconds": round(
                        sum(a.kv_page_s
                            for a in self._by_tenant.values()), 3),
                    "pinned_kv_page_seconds":
                        round(self.pinned_kv_page_s, 3),
                    "saved_prefill_device_seconds": round(
                        sum(a.saved_prefill_device_s
                            for a in self._by_tenant.values()), 6),
                },
                "waste_by_reason": {k: round(v, 6) for k, v in
                                    self._waste_by_reason.items()},
                "tenants": {t: a.to_dict()
                            for t, a in self._by_tenant.items()},
                "priorities": {p: a.to_dict()
                               for p, a in self._by_priority.items()},
                "engines": {e: a.to_dict()
                            for e, a in self._by_engine.items()},
                "conversations": {
                    c: a.to_dict() for c, a in sorted(
                        self._by_conversation.items(),
                        key=lambda kv: kv[1].device_s,
                        reverse=True)[:max(0, int(top_conversations))]},
            }
        out["goodput"] = self.goodput()
        return out

    def get(self, request_id: str) -> Optional[Dict[str, Any]]:
        """One finalized request's attribution (None if unknown or
        already evicted)."""
        with self._mu:
            rec = self._recent.get(request_id)
            if rec is None:
                return None
            return {
                "tenant": rec.tenant,
                "priority": rec.priority,
                "engine": rec.engine,
                "tokens": rec.tokens,
                "prompt_tokens": rec.prompt_tokens,
                "device_seconds": round(rec.useful_s, 6),
                "waste_seconds": round(rec.waste_s, 6),
                "waste_reason": (rec.waste_reason
                                 if rec.waste_s > 0 else ""),
                "kv_page_seconds": round(rec.kv_page_s, 3),
                "saved_prefill_device_seconds": round(rec.saved_s, 6),
            }

    def clear(self) -> None:
        """Reset all accounting (tests only)."""
        with self._mu:
            self.tracker = PageUsageTracker()
            self._by_tenant.clear()
            self._by_priority.clear()
            self._by_engine.clear()
            self._by_conversation.clear()
            self._waste_by_reason.clear()
            self._recent.clear()
            self._pending_flush.clear()
            self._window.clear()
            self._tenant_labels.clear()
            self._pin_tenants.clear()
            self._pending_causes.clear()
            self.total_device_s = 0.0
            self.attributed_device_s = 0.0
            self.unattributed_device_s = 0.0
            self.pinned_kv_page_s = 0.0
            self.requests_finalized = 0


# -- process singleton ---------------------------------------------------------

_LOCK = threading.Lock()
_LEDGER: Optional[UsageLedger] = None


def get_usage_ledger() -> UsageLedger:
    global _LEDGER
    with _LOCK:
        if _LEDGER is None:
            _LEDGER = UsageLedger()
        return _LEDGER


def configure_usage(cfg) -> UsageLedger:
    """Apply an ``observability.usage`` config block (core.config
    UsageConfig or anything with the same fields) onto the singleton."""
    led = get_usage_ledger()
    led.reconfigure(
        enabled=getattr(cfg, "enabled", None),
        max_tenants=getattr(cfg, "max_tenants", None),
        max_conversations=getattr(cfg, "max_conversations", None),
        goodput_window_s=getattr(cfg, "goodput_window_s", None))
    return led


def reset_usage() -> None:
    """Drop all ledger state (tests only — config flags survive)."""
    led = get_usage_ledger()
    led.clear()


__all__: List[str] = [
    "DEFAULT_TENANT", "PageUsageTracker", "RequestUsage", "UsageLedger",
    "WASTE_REASONS", "configure_usage", "get_usage_ledger",
    "reset_usage", "sanitize_tenant",
]
