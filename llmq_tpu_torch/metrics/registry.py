"""Prometheus metrics, namespace ``llm_queue`` (the port's counterpart of
``llmq_tpu/metrics/registry.py``).

The port carries its own small registry instead of ``prometheus_client``
(which the card's machine does not have): counters, gauges and
histograms with labels, and :func:`exposition` in the Prometheus text
format 0.0.4, which ``GET /metrics`` serves. Each family defined here is
the JAX package's family of the same attribute name: the same metric
name, type, help, label names and buckets. Only the families that the
port's planes feed are defined; a later slice adds its plane's families.

The families are a process singleton (:func:`get_metrics`), as in the
JAX package, so the many queue managers and engines of a test process
share them. A component updates them only when ``queue.enable_metrics``
is on; the engine resolves the labelled children it updates every chunk
once, when it is built.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("llmq_tpu_torch.metrics")

_NAMESPACE = "llm_queue"

_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 2.5, 5, 10, 30, 60,
                 300)
_PROC_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
                 30)
_STALL_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250,
                     500, 1000, 2500)
#: Sub-request stage latencies (admission waits, prefill, token gaps).
_STAGE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                  0.25, 0.5, 1, 2.5, 5, 10, 30)
#: Per-chunk step-time components, in milliseconds.
_STEP_MS_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
                    25, 50, 100, 250, 500, 1000, 2500)
#: Per-program compile (on the card: graph capture) seconds.
_COMPILE_BUCKETS = (0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600)
#: Critical-path segments, in milliseconds.
_CP_MS_BUCKETS = (0.1, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                  1000, 2500, 5000, 10000, 30000, 60000, 300000)
#: Boot stages, in seconds.
_BOOT_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120,
                 300, 600)

#: Metrics-cardinality contract (the JAX package's, label for label):
#: every label a family uses must appear here. A frozenset is a closed
#: enum the observed values must stay within; ``None`` marks labels
#: bounded by configuration or hardware (engine, endpoint, chip,
#: program, queue and manager names, window labels), which may never
#: carry per-request values such as request ids.
LABEL_CONTRACT = {
    "manager": None,
    "queue": None,
    "engine": None,
    "endpoint": None,
    "chip": None,
    "program": None,
    "window": None,
    "priority": frozenset({"realtime", "high", "normal", "low",
                           "unknown"}),
    "operation": frozenset({"push", "pop", "batch_pop", "complete",
                            "fail", "requeue", "retry_stash", "remove"}),
    "status": frozenset({"success", "error", "healthy", "degraded",
                         "unhealthy", "draining"}),
    "tenant": None,
    "reason": frozenset({"affinity", "spill", "select", "failover",
                         "handoff", "backlog", "sla", "engine_down",
                         "retry", "crash", "preempt", "shed",
                         "cancelled", "error",
                         "tenant_quota", "rate", "queue_depth",
                         "inflight",
                         "burn_fast", "burn_slow", "replica_dead",
                         "breaker_open", "rate_limited", "cooldown",
                         "recovered", "idle", "operator", "capacity",
                         "degraded"}),
    "action": frozenset({"scale_up", "scale_down", "replace",
                         "escalate", "relax", "pause", "resume",
                         "skip"}),
    "path": frozenset({"mixed", "program"}),
    "tier": frozenset({"hbm", "host", "store", "recompute"}),
    "role": frozenset({"prefill", "decode", "unified"}),
    "point": None,
    "kind": frozenset({"error", "timeout", "partial", "oserror",
                       "latency", "crash"}),
    "code": frozenset({"429", "503", "500"}),
    "slo": frozenset({"ttft", "realtime"}),
    "segment": frozenset({"queue_wait", "dispatch", "admission",
                          "kv_promote", "handoff_claim", "prefill",
                          "decode_compute", "decode_stall",
                          "completion"}),
    "stage": frozenset({"provision", "artifact", "weights", "compile",
                        "warmup", "first_token"}),
    "consumer": frozenset({"tiering", "exchange", "state", "placement"}),
    "op": frozenset({"get", "put", "delete", "list",
                     "kv_get", "kv_put", "kv_delete", "kv_list",
                     "push", "pop", "complete", "fail", "requeue",
                     "stash", "remove", "fsync"}),
    "outcome": frozenset({"ok", "error", "timeout", "shed"}),
}


def _fmt(v: float) -> str:
    """A sample value or bucket bound as the text format writes it."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(v)


def _escape(s: str, quote: bool) -> str:
    s = s.replace("\\", "\\\\").replace("\n", "\\n")
    return s.replace('"', '\\"') if quote else s


class _Value:
    """One labelled time series: a number under its own lock."""

    __slots__ = ("_mu", "value")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._mu:
            self.value += amount

    def get(self) -> float:
        with self._mu:
            return self.value


class _CounterChild(_Value):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("a counter only goes up")
        super().inc(amount)


class _GaugeChild(_Value):
    __slots__ = ()

    def set(self, value: float) -> None:
        with self._mu:
            self.value = float(value)

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild:
    __slots__ = ("_mu", "_bounds", "counts", "sum")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self._mu = threading.Lock()
        self._bounds = bounds
        self.counts = [0] * len(bounds)     # per bucket, not cumulative
        self.sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        i = 0
        while self._bounds[i] < value:
            i += 1                          # the last bound is +Inf
        with self._mu:
            self.counts[i] += 1
            self.sum += value

    def snapshot(self) -> Tuple[List[int], float]:
        with self._mu:
            return list(self.counts), self.sum


class _Family:
    """A metric family: its children by label values, in first-use
    order. A family without labels has one child from the start, as
    ``prometheus_client``'s do."""

    type = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (),
                 registry: Optional["Registry"] = None) -> None:
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._mu = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values):
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}, "
                             f"got {values}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._mu:
                child = self._children.setdefault(key, self._new_child())
        return child

    def remove(self, *values) -> None:
        """Drop one labelled series (``KeyError`` if it is absent), as
        ``prometheus_client`` does."""
        key = tuple(str(v) for v in values)
        with self._mu:
            del self._children[key]

    def _series(self):
        with self._mu:
            return list(self._children.items())

    def _lbl(self, key, extra: str = "") -> str:
        parts = [f'{n}="{_escape(v, True)}"'
                 for n, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def samples(self) -> List[str]:
        return [f"{self.name}{self._lbl(k)} {_fmt(c.get())}"
                for k, c in self._series()]

    def _only(self):
        """The one child of a family without labels."""
        if self.labelnames:
            raise ValueError(f"{self.name} takes labels {self.labelnames}")
        return self._children[()]


class Counter(_Family):
    type = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)


class Gauge(_Family):
    type = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._only().set(value)


class Histogram(_Family):
    type = "histogram"

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (), *,
                 buckets: Sequence[float],
                 registry: Optional["Registry"] = None) -> None:
        bounds = sorted(float(b) for b in buckets)
        if bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.buckets = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._only().observe(value)

    def samples(self) -> List[str]:
        out = []
        for k, c in self._series():
            counts, total = c.snapshot()
            acc = 0
            for bound, n in zip(self.buckets, counts):
                acc += n
                le = 'le="' + _fmt(bound) + '"'
                out.append(f"{self.name}_bucket{self._lbl(k, le)} "
                           f"{_fmt(acc)}")
            out.append(f"{self.name}_count{self._lbl(k)} {_fmt(acc)}")
            out.append(f"{self.name}_sum{self._lbl(k)} {_fmt(total)}")
        return out


class Registry:
    def __init__(self) -> None:
        self._families: List[_Family] = []
        self._mu = threading.Lock()

    def register(self, family: _Family) -> None:
        with self._mu:
            if any(f.name == family.name for f in self._families):
                raise ValueError(f"duplicate metric family {family.name}")
            self._families.append(family)

    def families(self) -> List[_Family]:
        with self._mu:
            return list(self._families)

    def exposition(self) -> bytes:
        lines = []
        for fam in self.families():
            lines.append(f"# HELP {fam.name} "
                         f"{_escape(fam.documentation, False)}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            lines.extend(fam.samples())
        return ("\n".join(lines) + "\n").encode("utf-8")


REGISTRY = Registry()
_LOCK = threading.Lock()
_SINGLETON: Optional["QueueMetrics"] = None


class QueueMetrics:
    """The families of the planes the port has, under the JAX package's
    attribute names."""

    def __init__(self, registry: Registry) -> None:
        ns = _NAMESPACE
        labels = ["manager", "queue", "priority"]
        r = registry
        # Queue plane (queueing/queue_manager.py, dead_letter_queue.py).
        self.pending = Gauge(
            f"{ns}_messages_pending", "Pending messages per queue", labels,
            registry=r)
        self.processing = Gauge(
            f"{ns}_messages_processing", "In-flight messages per queue",
            labels, registry=r)
        self.completed = Counter(
            f"{ns}_messages_completed_total", "Completed messages", labels,
            registry=r)
        self.failed = Counter(
            f"{ns}_messages_failed_total", "Failed messages", labels,
            registry=r)
        self.wait_time = Histogram(
            f"{ns}_message_wait_seconds", "Queue wait time", labels,
            buckets=_WAIT_BUCKETS, registry=r)
        self.process_time = Histogram(
            f"{ns}_message_process_seconds", "Processing time", labels,
            buckets=_PROC_BUCKETS, registry=r)
        self.operations = Counter(
            f"{ns}_operations_total", "Queue operations",
            ["manager", "operation", "status"], registry=r)
        # Engine (engine/engine.py).
        self.decode_steps = Counter(
            f"{ns}_decode_steps_total", "Engine decode steps", ["engine"],
            registry=r)
        self.generated_tokens = Counter(
            f"{ns}_generated_tokens_total", "Tokens generated",
            ["engine", "priority"], registry=r)
        self.kv_pages_in_use = Gauge(
            f"{ns}_kv_pages_in_use", "Paged KV cache pages in use",
            ["engine"], registry=r)
        self.kv_pinned_conversations = Gauge(
            f"{ns}_kv_pinned_conversations", "Conversations with pinned KV",
            ["engine"], registry=r)
        self.batch_occupancy = Gauge(
            f"{ns}_batch_occupancy", "Decode-slot occupancy", ["engine"],
            registry=r)
        self.preemptions = Counter(
            f"{ns}_preemptions_total", "Step-boundary preemptions",
            ["engine", "priority"], registry=r)
        self.prefix_cache_hits = Counter(
            f"{ns}_prefix_cache_hits_total",
            "Admissions that adopted a cached KV prefix", ["engine"],
            registry=r)
        self.prefix_cache_misses = Counter(
            f"{ns}_prefix_cache_misses_total",
            "Admissions that found no cached prefix", ["engine"],
            registry=r)
        self.cached_prefill_tokens = Counter(
            f"{ns}_cached_prefill_tokens_total",
            "Prompt tokens whose prefill was skipped (KV served from "
            "the prefix cache or a pinned conversation)", ["engine"],
            registry=r)
        self.prefix_cache_pages = Gauge(
            f"{ns}_prefix_cache_pages",
            "KV pages currently held by the radix prefix cache",
            ["engine"], registry=r)
        # Tiered KV plane (tiering/): residency per tier, the re-arrival
        # hits by serving tier (recompute included), and the host-side
        # demote/promote latencies. Flushed at scrape
        # (``tiering.flush_metrics``): demote and promote only buffer.
        self.kv_tier_pages = Gauge(
            f"{ns}_kv_tier_pages",
            "KV pages resident per tier (hbm = pinned conversation "
            "pages in the device pool; host/store = demoted entries)",
            ["engine", "tier"], registry=r)
        self.kv_tier_bytes = Gauge(
            f"{ns}_kv_tier_bytes",
            "Serialized KV payload bytes resident per tier",
            ["engine", "tier"], registry=r)
        self.kv_tier_hits = Counter(
            f"{ns}_kv_tier_hits_total",
            "Conversation re-arrivals by the tier that served their "
            "cached prefix (recompute = re-prefilled from the "
            "remembered token stream)", ["engine", "tier"],
            registry=r)
        self.kv_tier_round_trips = Counter(
            f"{ns}_kv_tier_round_trips_total",
            "Demote→promote round-trips within the thrash window "
            "(a hot conversation bouncing between HBM and the host "
            "tier — the KVTierThrashing alert watches this)",
            ["engine"], registry=r)
        self.kv_promote_ms = Histogram(
            f"{ns}_kv_promote_ms",
            "Host-side promotion work per re-arrival (page alloc + "
            "payload unpack + inject dispatch; the device transfer "
            "itself hides behind admission)", ["engine"],
            buckets=_STEP_MS_BUCKETS, registry=r)
        self.kv_demote_ms = Histogram(
            f"{ns}_kv_demote_ms",
            "Host-side demotion work per reclaimed pin (gather "
            "dispatch + entry registration; the device→host transfer "
            "runs on the tiering worker)", ["engine"],
            buckets=_STEP_MS_BUCKETS, registry=r)
        # Disaggregation plane (disagg/): the KV exchange's lifecycle
        # and the publish→claim latency. ``role`` is the publishing
        # side's for published and expired, the claimer's own for
        # claimed and fallback. Flushed at scrape
        # (``disagg.flush_metrics``): publish and claim only buffer.
        self.kv_exchange_published = Counter(
            f"{ns}_kv_exchange_published_total",
            "Conversation KV entries published to the cluster-wide "
            "exchange (store tier under claimable keys)", ["role"],
            registry=r)
        self.kv_exchange_claimed = Counter(
            f"{ns}_kv_exchange_claimed_total",
            "Exchange entries claimed (consumed) by a replica",
            ["role"], registry=r)
        self.kv_exchange_expired = Counter(
            f"{ns}_kv_exchange_expired_total",
            "Exchange entries found past claim_ttl_s at claim time "
            "(publisher likely died mid-handoff; claimer recomputed)",
            ["role"], registry=r)
        self.kv_exchange_fallback = Counter(
            f"{ns}_kv_exchange_fallback_total",
            "Handoffs that degraded to recompute (torn blob, store "
            "error, or no published entry for a routed conversation)",
            ["role"], registry=r)
        self.kv_handoff_ms = Histogram(
            f"{ns}_kv_handoff_ms",
            "Publish→claim latency for exchange entries (wall clock "
            "across processes — how long KV waited in the exchange)",
            ["role"], buckets=_STEP_MS_BUCKETS, registry=r)
        self.mixed_step_decode_rows = Gauge(
            f"{ns}_mixed_step_decode_rows",
            "Decode rows in the most recent mixed iteration",
            ["engine"], registry=r)
        self.mixed_step_prefill_tokens = Gauge(
            f"{ns}_mixed_step_prefill_tokens",
            "Prefill tokens fused into the most recent mixed iteration",
            ["engine"], registry=r)
        self.mixed_budget_utilization = Gauge(
            f"{ns}_mixed_budget_utilization",
            "Fused prefill tokens / prefill_token_budget for the most "
            "recent mixed iteration", ["engine"], registry=r)
        self.prefill_stall_ms = Histogram(
            f"{ns}_prefill_stall_ms",
            "Estimated milliseconds active decode rows stalled behind "
            "one round of prefill dispatches",
            ["engine", "path"], buckets=_STALL_MS_BUCKETS, registry=r)
        # The replica-set plane (cluster/router.py). ``reason`` is why
        # the endpoint was chosen: "affinity" (the conversation's
        # replica), "spill" (it was saturated, draining or blocked),
        # "select" (the LB's strategy), "failover" (after another
        # replica failed within the dispatch).
        self.cluster_dispatch = Counter(
            f"{ns}_cluster_dispatch_total",
            "Messages dispatched to a cluster endpoint",
            ["endpoint", "reason"], registry=r)
        self.cluster_affinity_hit_rate = Gauge(
            f"{ns}_cluster_affinity_hit_rate",
            "Fraction of affinity-eligible dispatches routed to the "
            "conversation's prefix-holding replica (lifetime)",
            registry=r)
        self.cluster_failovers = Counter(
            f"{ns}_cluster_failovers_total",
            "In-dispatch failovers away from a failed endpoint",
            ["endpoint"], registry=r)
        self.cluster_drains = Counter(
            f"{ns}_cluster_drains_total",
            "Drain transitions per endpoint", ["endpoint"], registry=r)
        self.cluster_endpoints = Gauge(
            f"{ns}_cluster_endpoints", "Registered endpoints by status",
            ["status"], registry=r)
        self.dead_letter_depth = Gauge(
            f"{ns}_dead_letter_depth",
            "Messages currently parked in a dead-letter queue",
            ["queue"], registry=r)
        self.dlq_handler_errors = Counter(
            f"{ns}_dlq_handler_errors_total",
            "DLQ handler/subscriber callbacks that raised (the push "
            "itself and the remaining handlers still ran)",
            ["queue"], registry=r)
        # Request-lifecycle stage histograms (observability/recorder.py):
        # observed once per request at the scrape after its terminal
        # trace event. ``endpoint`` is the engine name, else "local".
        stage_labels = ["priority", "endpoint"]
        self.stage_queue_wait = Histogram(
            f"{ns}_stage_queue_wait_seconds",
            "enqueued → scheduled (time in the priority queues)",
            stage_labels, buckets=_WAIT_BUCKETS, registry=r)
        self.stage_dispatch = Histogram(
            f"{ns}_stage_dispatch_seconds",
            "scheduled → dispatched (worker pop to endpoint handoff)",
            stage_labels, buckets=_STAGE_BUCKETS, registry=r)
        self.stage_admission = Histogram(
            f"{ns}_stage_admission_seconds",
            "dispatched → admitted (engine admission wait)",
            stage_labels, buckets=_STAGE_BUCKETS, registry=r)
        self.stage_prefill = Histogram(
            f"{ns}_stage_prefill_seconds",
            "prefill_start → first_token",
            stage_labels, buckets=_STAGE_BUCKETS, registry=r)
        self.ttft = Histogram(
            f"{ns}_ttft_seconds",
            "enqueued → first_token (user-perceived time to first token)",
            stage_labels, buckets=_WAIT_BUCKETS, registry=r)
        self.decode_interarrival = Histogram(
            f"{ns}_decode_interarrival_seconds",
            "Mean inter-token gap over the request's decode phase",
            stage_labels, buckets=_STAGE_BUCKETS, registry=r)
        self.sla_breaches = Counter(
            f"{ns}_sla_breaches_total",
            "Requests whose end-to-end latency breached "
            "observability.sla_ms", ["priority"], registry=r)
        self.flightrecorder_timelines = Gauge(
            f"{ns}_flightrecorder_timelines",
            "Request timelines currently held in the flight-recorder "
            "ring", registry=r)
        self.flightrecorder_slow_retained = Gauge(
            f"{ns}_flightrecorder_slow_retained",
            "Finished timelines retained for SLA breach / failure",
            registry=r)
        # Overload shedding (api/overload.py).
        self.requests_shed = Counter(
            f"{ns}_requests_shed_total",
            "Requests rejected by overload shedding; reason is "
            "backlog|sla|engine_down, code the HTTP status returned",
            ["reason", "code"], registry=r)
        # The endpoints' circuit breakers (loadbalancer/circuit_breaker.py).
        self.circuit_breaker_state = Gauge(
            f"{ns}_circuit_breaker_state",
            "Per-endpoint breaker state (0=closed, 1=half_open, 2=open)",
            ["endpoint"], registry=r)
        self.circuit_breaker_trips = Counter(
            f"{ns}_circuit_breaker_trips_total",
            "Breaker transitions into OPEN per endpoint", ["endpoint"],
            registry=r)
        # The queue journal's faults (queueing/wal.py, queue_manager.py):
        # a push the journal cannot record is shed with a 503; a
        # worker-side op logs and the worker goes on.
        self.wal_errors = Counter(
            f"{ns}_wal_errors_total",
            "WAL journal operations that failed with an OSError "
            "(disk full / IO error); push failures shed 503, "
            "worker-side ops degrade durability but keep serving",
            ["op"], registry=r)
        # The chaos plane (chaos/).
        self.chaos_injected = Counter(
            f"{ns}_chaos_injected_total",
            "Faults injected by the chaos plane", ["point", "kind"],
            registry=r)
        # The store fault domain (conversation/resilience.py): every op on
        # the wrapped store, its bounded retries, the store's breaker and
        # the consumers on their degraded rung. Flushed at the scrape.
        self.store_op_ms = Histogram(
            f"{ns}_store_op_ms",
            "Store operation latency by op and outcome (ok|error|"
            "timeout|shed; shed = refused fast while degraded)",
            ["op", "outcome"], buckets=_STEP_MS_BUCKETS, registry=r)
        self.store_retries = Counter(
            f"{ns}_store_retries_total",
            "Bounded retries of retryable store errors (sqlite locked, "
            "redis connection resets)", registry=r)
        self.store_breaker_state = Gauge(
            f"{ns}_store_breaker_state",
            "Store-scoped breaker state (0=closed, 1=half_open, 2=open)",
            registry=r)
        self.store_degraded = Gauge(
            f"{ns}_store_degraded",
            "1 while the named consumer is running its degraded ladder "
            "rung (tiering parks in host, exchange recomputes, state "
            "serves cache + journals, placement routes role/load-only)",
            ["consumer"], registry=r)
        # Crash supervisor (engine/supervisor.py).
        self.engine_restarts = Counter(
            f"{ns}_engine_restarts_total",
            "Engine loop restarts performed by the supervisor",
            ["engine"], registry=r)
        self.engine_recovered_requests = Counter(
            f"{ns}_engine_recovered_requests_total",
            "In-flight requests failed over to the retry path by an "
            "engine crash recovery", ["engine"], registry=r)
        # Device telemetry plane (observability/device.py): per-chunk
        # step decomposition, live decode rate + MFU, HBM accounting,
        # graph-capture visibility.
        self.step_dispatch_ms = Histogram(
            f"{ns}_step_dispatch_ms",
            "Host-side batch assembly + program dispatch per decode/"
            "mixed chunk (ms)", ["engine"],
            buckets=_STEP_MS_BUCKETS, registry=r)
        self.step_device_ms = Histogram(
            f"{ns}_step_device_ms",
            "Device execution per chunk: dispatch until the output "
            "array is ready (ms)", ["engine"],
            buckets=_STEP_MS_BUCKETS, registry=r)
        self.step_readback_ms = Histogram(
            f"{ns}_step_readback_ms",
            "Token readback per chunk: device→host transfer of the "
            "sampled token matrix (ms)", ["engine"],
            buckets=_STEP_MS_BUCKETS, registry=r)
        self.step_overlapped_ms = Histogram(
            f"{ns}_step_overlapped_ms",
            "Part of a chunk's device span that overlapped other "
            "in-flight work (async pipeline) — attributed explicitly "
            "so step_device_ms stays truthful (ms)", ["engine"],
            buckets=_STEP_MS_BUCKETS, registry=r)
        self.pipeline_overlap_ratio = Gauge(
            f"{ns}_pipeline_overlap_ratio",
            "Fraction of in-flight device-span time hidden by the "
            "async decode pipeline (0 = fully serial)", ["engine"],
            registry=r)
        self.decode_tokens_per_s = Gauge(
            f"{ns}_decode_tokens_per_s",
            "Decode tokens/s over the telemetry trailing window",
            ["engine"], registry=r)
        self.mfu_pct = Gauge(
            f"{ns}_mfu_pct",
            "Live decode MFU estimate (percent of device peak FLOPs; "
            "0 for the echo backend)", ["engine"], registry=r)
        self.host_device_rtt_ms = Gauge(
            f"{ns}_host_device_rtt_ms",
            "Measured host<->device round-trip floor (ms)", ["engine"],
            registry=r)
        self.hbm_weights_bytes = Gauge(
            f"{ns}_hbm_weights_bytes",
            "Model weight bytes resident per chip", ["engine", "chip"],
            registry=r)
        self.hbm_kv_pool_bytes = Gauge(
            f"{ns}_hbm_kv_pool_bytes",
            "Paged-KV pool bytes resident per chip", ["engine", "chip"],
            registry=r)
        self.hbm_free_bytes = Gauge(
            f"{ns}_hbm_free_bytes",
            "Free HBM per chip (runtime memory_stats; absent on "
            "backends without it)", ["engine", "chip"], registry=r)
        self.hbm_limit_bytes = Gauge(
            f"{ns}_hbm_limit_bytes",
            "Total HBM per chip (runtime memory_stats)",
            ["engine", "chip"], registry=r)
        self.kv_pool_occupancy = Gauge(
            f"{ns}_kv_pool_occupancy",
            "Fraction of allocatable KV pages in use", ["engine"],
            registry=r)
        self.kv_pool_fragmentation = Gauge(
            f"{ns}_kv_pool_fragmentation",
            "External fragmentation of the free page-id space "
            "(1 - largest contiguous free run / free pages)",
            ["engine"], registry=r)
        # Speculation (speculation/, engine ``_note_spec_window``):
        # the drafter's and the verify windows' effect, and the readback
        # cadence.
        self.spec_acceptance = Histogram(
            f"{ns}_spec_acceptance_rate",
            "Per-row draft acceptance per verify window: accepted "
            "drafts / proposed drafts (drafted rows only)", ["engine"],
            buckets=(0.0, 0.25, 0.5, 0.75, 0.99, 1.0), registry=r)
        self.spec_tokens_proposed = Counter(
            f"{ns}_spec_tokens_proposed_total",
            "Draft tokens proposed by the n-gram drafter", ["engine"],
            registry=r)
        self.spec_tokens_accepted = Counter(
            f"{ns}_spec_tokens_accepted_total",
            "Draft tokens accepted by verify windows", ["engine"],
            registry=r)
        self.spec_readback_cadence = Gauge(
            f"{ns}_spec_readback_cadence",
            "Tokens committed per host readback through the "
            "speculation plane (> 1 = the per-token fetch floor is "
            "broken)", ["engine"], registry=r)
        self.compile_cache_hits = Counter(
            f"{ns}_compile_cache_hits_total",
            "Warmup programs served from the export disk cache",
            ["engine"], registry=r)
        self.compile_cache_misses = Counter(
            f"{ns}_compile_cache_misses_total",
            "Warmup programs that had to trace+lower+compile",
            ["engine"], registry=r)
        self.compile_seconds = Histogram(
            f"{ns}_compile_seconds",
            "Per-program warmup compile (or export-cache load) time",
            ["engine", "program"], buckets=_COMPILE_BUCKETS, registry=r)
        self.warmup_progress = Gauge(
            f"{ns}_warmup_progress",
            "Warmup completion fraction (0..1) — programs compiled / "
            "programs planned", ["engine"], registry=r)
        # Usage plane (observability/usage.py): who consumed the card.
        # ``tenant`` is bounded by the ledger (max_tenants; overflow and
        # id-shaped values collapse to "other").
        self.usage_device_seconds = Counter(
            f"{ns}_usage_device_seconds_total",
            "Attributed device-execute seconds behind DELIVERED output "
            "(useful work)", ["tenant", "priority"], registry=r)
        self.usage_waste_seconds = Counter(
            f"{ns}_usage_waste_seconds_total",
            "Attributed device-execute seconds that bought no delivered "
            "output, by cause (retry|failover|crash|preempt|shed|"
            "cancelled|error)", ["reason"], registry=r)
        self.usage_kv_page_seconds = Counter(
            f"{ns}_usage_kv_page_seconds_total",
            "KV page-seconds held (pages x wall time; shared prefix "
            "pages charged fractionally to their sharers)", ["tenant"],
            registry=r)
        self.usage_saved_prefill_seconds = Counter(
            f"{ns}_usage_saved_prefill_device_seconds_total",
            "Estimated prefill device-seconds SAVED by prefix-cache / "
            "conversation-KV hits", ["tenant"], registry=r)
        self.goodput_tokens_per_device_s = Gauge(
            f"{ns}_goodput_tokens_per_device_second",
            "Rolling goodput: SLO-met completion tokens per attributed "
            "device-second (waste counts in the denominator)",
            registry=r)
        self.usage_tenants_tracked = Gauge(
            f"{ns}_usage_tenants_tracked",
            "Distinct tenants with usage rollups this process",
            registry=r)
        # Tenancy plane (tenancy/): fairness and quota visibility. The
        # ``tenant`` label shares the usage ledger's first-come
        # max_tenants bound; the gauges are set at scrape time
        # (tenancy.flush_metrics).
        self.tenant_virtual_time = Gauge(
            f"{ns}_tenant_virtual_time",
            "Weighted-fair-queueing virtual time per tenant (tokens / "
            "weight served; higher = further over its share)",
            ["tenant"], registry=r)
        self.tenant_share_ratio = Gauge(
            f"{ns}_tenant_share_ratio",
            "Achieved token share / configured weight share over the "
            "tenancy.share_window_s rolling window (1.0 = exactly the "
            "configured share)", ["tenant"], registry=r)
        self.tenant_quota_rejections = Counter(
            f"{ns}_tenant_quota_rejections_total",
            "Per-tenant quota enforcement events: rate and queue_depth "
            "are admission 429s, inflight counts dispatch-time "
            "deferrals by the in-flight cap", ["reason"], registry=r)
        self.tenant_inflight = Gauge(
            f"{ns}_tenant_inflight",
            "Dispatched (popped, unfinished) messages per tenant",
            ["tenant"], registry=r)
        # Unlabelled: the evicted ids are the ones an id spray mints.
        self.tenant_registry_evictions = Counter(
            f"{ns}_tenant_registry_evictions_total",
            "Unconfigured-tenant runtime state evicted by the tenant "
            "registry's LRU bound (MAX_TRACKED) — nonzero means an id "
            "spray is churning bucket/counter state", registry=r)
        # Control plane (controlplane/): the reconcile loop's actions
        # and state, set on the controller's tick.
        self.controller_actions = Counter(
            f"{ns}_controller_actions_total",
            "Control-plane reconcile actions (scale_up/scale_down/"
            "replace/escalate/relax/pause/resume; skip = an action the "
            "rate limit or cooldown suppressed)", ["action", "reason"],
            registry=r)
        self.controller_rung = Gauge(
            f"{ns}_controller_rung",
            "Active degradation-ladder rung (0 = no degradation)",
            registry=r)
        self.controller_target_replicas = Gauge(
            f"{ns}_controller_target_replicas",
            "Replica count the controller is reconciling toward",
            registry=r)
        self.controller_live_replicas = Gauge(
            f"{ns}_controller_live_replicas",
            "Healthy/degraded replicas the controller observes",
            registry=r)
        self.controller_recovery_seconds = Histogram(
            f"{ns}_controller_recovery_seconds",
            "Replica-loss recovery time: first replacement action "
            "until the cluster is back at target with SLO burn < 1",
            buckets=(0.5, 1, 2.5, 5, 10, 20, 30, 60, 120, 300),
            registry=r)
        self.controller_paused = Gauge(
            f"{ns}_controller_paused",
            "1 while an operator has paused the controller "
            "(distinct from controlplane.enabled=false)",
            registry=r)
        # Critical-path plane (observability/critical_path.py): per-
        # request latency attribution + boot decomposition, both fed at
        # scrape time.
        self.critical_path_ms = Histogram(
            f"{ns}_critical_path_ms",
            "Per-request end-to-end latency attributed to one "
            "critical-path segment (segments conserve: they sum to "
            "the recorded e2e per request)", ["segment", "priority"],
            buckets=_CP_MS_BUCKETS, registry=r)
        self.critical_path_dominant = Counter(
            f"{ns}_critical_path_dominant_total",
            "Requests whose largest critical-path segment was this "
            "one — the fleet-wide 'where does time go' headline",
            ["segment", "priority"], registry=r)
        self.replica_ready_seconds = Histogram(
            f"{ns}_replica_ready_seconds",
            "Replica boot decomposition: seconds per boot stage "
            "(provision → artifact → weights → compile → warmup → "
            "first_token) across all ReplicaPool kinds + serve boot",
            ["stage"], buckets=_BOOT_BUCKETS, registry=r)
        # SLO layer (observability/slo.py): burn rate 1.0 = spending
        # exactly the allowed error budget over the window.
        self.slo_burn_rate = Gauge(
            f"{ns}_slo_burn_rate",
            "Error-budget burn rate per SLO and rolling window",
            ["slo", "window"], registry=r)
        self.slo_error_budget_remaining = Gauge(
            f"{ns}_slo_error_budget_remaining",
            "Remaining error-budget fraction over the longest window "
            "(0 = exhausted)", ["slo"], registry=r)


def get_metrics() -> QueueMetrics:
    global _SINGLETON
    with _LOCK:
        if _SINGLETON is None:
            _SINGLETON = QueueMetrics(REGISTRY)
        return _SINGLETON


def exposition() -> bytes:
    """The text exposition ``GET /metrics`` serves. The observability
    planes defer their observations off the request and decode paths;
    they land here, in the JAX package's order (the recorder's flush
    feeds the SLO, usage and critical-path joins, so it runs first)."""
    get_metrics()   # the families exist before their first update
    try:
        from llmq_tpu_torch.observability.recorder import get_recorder
        get_recorder().flush_metrics()
    except Exception:  # noqa: BLE001 — scrape must not fail on trace plane
        log.exception("flight-recorder flush failed")
    try:
        from llmq_tpu_torch.observability.device import flush_all
        flush_all()
    except Exception:  # noqa: BLE001
        log.exception("device telemetry flush failed")
    try:
        from llmq_tpu_torch.observability.slo import get_slo_tracker
        get_slo_tracker().flush()
    except Exception:  # noqa: BLE001
        log.exception("SLO flush failed")
    try:
        from llmq_tpu_torch.observability.usage import get_usage_ledger
        get_usage_ledger().flush()
    except Exception:  # noqa: BLE001
        log.exception("usage flush failed")
    try:
        # Tenancy plane: buffered quota-rejection counts and the
        # per-tenant virtual-time, share and in-flight gauges (after the
        # usage flush, whose tenant-label bound they share).
        from llmq_tpu_torch.tenancy import flush_metrics as tenancy_flush
        tenancy_flush()
    except Exception:  # noqa: BLE001
        log.exception("tenancy flush failed")
    try:
        # Tiered KV plane: per-tier residency, hits and the buffered
        # demote/promote observations.
        from llmq_tpu_torch.tiering import flush_metrics as tiering_flush
        tiering_flush()
    except Exception:  # noqa: BLE001
        log.exception("tiering flush failed")
    try:
        # Disaggregation plane: the exchanges' buffered lifecycle counts
        # and handoff latencies.
        from llmq_tpu_torch.disagg import flush_metrics as disagg_flush
        disagg_flush()
    except Exception:  # noqa: BLE001
        log.exception("kv exchange flush failed")
    try:
        # The store fault domain: buffered op latencies, retries, the
        # breaker state and the consumers' degraded gauges.
        from llmq_tpu_torch.conversation.resilience import \
            flush_metrics as store_flush
        store_flush()
    except Exception:  # noqa: BLE001
        log.exception("store resilience flush failed")
    try:
        from llmq_tpu_torch.observability.critical_path import \
            flush_boot_metrics
        flush_boot_metrics()
    except Exception:  # noqa: BLE001
        log.exception("boot metrics flush failed")
    return REGISTRY.exposition()
