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

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_NAMESPACE = "llm_queue"

_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 2.5, 5, 10, 30, 60,
                 300)
_PROC_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
                 30)
_STALL_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250,
                     500, 1000, 2500)

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


class Counter(_Family):
    type = "counter"

    def _new_child(self):
        return _CounterChild()


class Gauge(_Family):
    type = "gauge"

    def _new_child(self):
        return _GaugeChild()


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
        self.dead_letter_depth = Gauge(
            f"{ns}_dead_letter_depth",
            "Messages currently parked in a dead-letter queue",
            ["queue"], registry=r)
        self.dlq_handler_errors = Counter(
            f"{ns}_dlq_handler_errors_total",
            "DLQ handler/subscriber callbacks that raised (the push "
            "itself and the remaining handlers still ran)",
            ["queue"], registry=r)
        # Overload shedding (api/overload.py).
        self.requests_shed = Counter(
            f"{ns}_requests_shed_total",
            "Requests rejected by overload shedding; reason is "
            "backlog|sla|engine_down, code the HTTP status returned",
            ["reason", "code"], registry=r)
        # Crash supervisor (engine/supervisor.py).
        self.engine_restarts = Counter(
            f"{ns}_engine_restarts_total",
            "Engine loop restarts performed by the supervisor",
            ["engine"], registry=r)
        self.engine_recovered_requests = Counter(
            f"{ns}_engine_recovered_requests_total",
            "In-flight requests failed over to the retry path by an "
            "engine crash recovery", ["engine"], registry=r)


def get_metrics() -> QueueMetrics:
    global _SINGLETON
    with _LOCK:
        if _SINGLETON is None:
            _SINGLETON = QueueMetrics(REGISTRY)
        return _SINGLETON


def exposition() -> bytes:
    """The text exposition ``GET /metrics`` serves."""
    get_metrics()   # the families exist before their first update
    return REGISTRY.exposition()
