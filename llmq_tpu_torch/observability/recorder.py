"""Flight recorder: bounded per-request lifecycle timelines (the port's
copy of ``llmq_tpu/observability/recorder.py``).

Every layer a request crosses stamps a stage event into the process's
recorder — ``enqueued → scheduled → dispatched → admitted →
prefill_start → prefill_done → first_token → completed/failed`` (plus
``retry_scheduled`` on the unhappy path).

- **Bounded.** A ring of the most recent ``capacity`` request
  timelines; finished timelines that breached the configured SLA (or
  failed) are COPIED into a separate slow-retention ring so the
  interesting requests survive the firehose evicting the boring ones —
  the "flight recorder" property.
- **Cheap.** One lock, one dict append per event, no I/O, no per-token
  events (decode is summarized at completion as a mean inter-arrival);
  every Prometheus observe is deferred to the scrape
  (:meth:`FlightRecorder.flush_metrics`).
- **Host-labeled.** Each event carries its host, so a timeline read
  beside another process's shows where each stage ran.

On a timeline's FIRST terminal event the recorder derives the stage
latencies that the next scrape feeds to the stage histograms
(metrics/registry.py): ``queue_wait``, ``dispatch``, ``admission``,
``prefill``, ``ttft``, ``decode_interarrival`` — labeled by priority
tier and endpoint — and to the SLO, usage and critical-path planes.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from llmq_tpu_torch.observability.trace import trace_id_for

log = logging.getLogger("llmq_tpu_torch.observability.recorder")

#: Stages that end a request's lifecycle (first one finalizes metrics).
#: ``cancelled`` (client closed the stream / gave up) is terminal but is
#: neither a success nor a system failure — it is NOT retained in the
#: failure buffer, or a burst of ordinary disconnects would evict the
#: real failures.
TERMINAL_STAGES = ("completed", "failed", "cancelled")

#: Canonical stage order — used only for display sorting of events that
#: share a timestamp; recording is order-free.
STAGE_ORDER = ("enqueued", "received", "scheduled", "dispatched",
               "admitted", "kv_promote_start", "handoff_claim_start",
               "kv_promote_done", "handoff_claim_done",
               "prefill_start", "prefill_done", "first_token",
               "kv_publish", "decode_done",
               "failover", "retry_scheduled", "completed", "failed",
               "cancelled")
_STAGE_RANK = {s: i for i, s in enumerate(STAGE_ORDER)}


def _host_tag() -> str:
    return f"{socket.gethostname()}:{os.getpid()}"


_CP_ANALYZER = None


def _cp_analyzer():
    """Cached critical-path analyzer reference (lazy — critical_path
    imports Timeline from THIS module, so the import must not run at
    module load). One global read + one attribute check on the
    finalize path once warmed."""
    global _CP_ANALYZER
    if _CP_ANALYZER is None:
        try:
            from llmq_tpu_torch.observability.critical_path import \
                get_critical_path
            _CP_ANALYZER = get_critical_path()
        except Exception:  # noqa: BLE001 — trace plane must not fail
            return None
    return _CP_ANALYZER


class TraceEvent:
    __slots__ = ("stage", "ts", "host", "meta")

    def __init__(self, stage: str, ts: float, host: str,
                 meta: Optional[Dict[str, Any]] = None) -> None:
        self.stage = stage
        self.ts = ts
        self.host = host
        self.meta = meta or {}

    def to_dict(self) -> Dict[str, Any]:
        return {"stage": self.stage, "ts": self.ts, "host": self.host,
                "meta": dict(self.meta)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceEvent":
        return cls(str(d.get("stage", "")), float(d.get("ts", 0.0)),
                   str(d.get("host", "")), dict(d.get("meta") or {}))


class Timeline:
    """All recorded events of one request, across hosts."""

    __slots__ = ("request_id", "_trace_id", "created", "events",
                 "finalized", "breached")

    def __init__(self, request_id: str) -> None:
        self.request_id = request_id
        # Derived lazily: the md5 is only needed when a timeline is
        # serialized, and hashing on every stamp is measurable against
        # the per-request trace budget.
        self._trace_id: Optional[str] = None
        self.created = time.time()
        self.events: List[TraceEvent] = []
        self.finalized = False
        self.breached = False

    @property
    def trace_id(self) -> str:
        if self._trace_id is None:
            self._trace_id = trace_id_for(self.request_id)
        return self._trace_id

    # -- derived views (call with a CONSISTENT snapshot; the recorder
    # -- copies under its lock before handing a timeline out) ---------

    def first_ts(self, stage: str) -> Optional[float]:
        for e in self.events:
            if e.stage == stage:
                return e.ts
        return None

    def sorted_events(self) -> List[TraceEvent]:
        return sorted(self.events,
                      key=lambda e: (e.ts, _STAGE_RANK.get(e.stage, 99)))

    def duration_ms(self) -> Optional[float]:
        term = [e.ts for e in self.events if e.stage in TERMINAL_STAGES]
        if not term or not self.events:
            return None
        start = min(e.ts for e in self.events)
        return (max(term) - start) * 1e3

    def stage_latencies(self) -> Dict[str, float]:
        """Seconds between the canonical stage pairs (missing stages —
        e.g. an SSE request with no ``scheduled`` — simply
        omit their entry)."""
        ts = {}
        for e in self.events:
            ts.setdefault(e.stage, e.ts)
        out: Dict[str, float] = {}

        def delta(name: str, a: str, b: str) -> None:
            if a in ts and b in ts and ts[b] >= ts[a]:
                out[name] = ts[b] - ts[a]

        delta("queue_wait", "enqueued", "scheduled")
        delta("dispatch", "scheduled", "dispatched")
        delta("admission", "dispatched", "admitted")
        delta("prefill", "prefill_start", "first_token")
        delta("ttft", "enqueued", "first_token")
        term = "completed" if "completed" in ts else (
            "failed" if "failed" in ts else None)
        if term and "first_token" in ts:
            tokens = 0
            for e in self.events:
                if e.stage in TERMINAL_STAGES:
                    tokens = int(e.meta.get("completion_tokens", 0) or 0)
                    if tokens:
                        break
            if tokens > 1:
                out["decode_interarrival"] = max(
                    0.0, ts[term] - ts["first_token"]) / (tokens - 1)
        return out

    def label(self, key: str, default: str = "") -> str:
        """First non-empty ``meta[key]`` across events (e.g. priority
        from the queue plane, endpoint from the router)."""
        for e in self.events:
            v = e.meta.get(key)
            if v:
                return str(v)
        return default

    def _cost(self) -> Dict[str, Any]:
        """Token counts + usage attribution from the terminal event's
        meta (the engine stamps both at finish) — so the trace and
        flight-recorder surfaces show COST next to latency."""
        tokens: Dict[str, Any] = {}
        usage: Optional[Dict[str, Any]] = None
        for e in self.events:
            if e.stage not in TERMINAL_STAGES:
                continue
            for k, name in (("prompt_tokens", "prompt"),
                            ("completion_tokens", "completion"),
                            ("cached_tokens", "cached")):
                if k in e.meta and name not in tokens:
                    tokens[name] = int(e.meta[k] or 0)
            if usage is None and isinstance(e.meta.get("usage"), dict):
                usage = dict(e.meta["usage"])
        out: Dict[str, Any] = {}
        if tokens:
            out["tokens"] = tokens
        if usage is not None:
            out["usage"] = usage
        return out

    def to_dict(self) -> Dict[str, Any]:
        lat = self.stage_latencies()
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "created": self.created,
            "finalized": self.finalized,
            "sla_breached": self.breached,
            "duration_ms": self.duration_ms(),
            "priority": self.label("priority", "unknown"),
            "endpoint": self.label("endpoint",
                                   self.label("engine", "local")),
            "stage_latencies_ms": {k: round(v * 1e3, 3)
                                   for k, v in lat.items()},
            "hosts": sorted({e.host for e in self.events}),
            **self._cost(),
            "events": [e.to_dict() for e in self.sorted_events()],
        }

    def summary(self) -> Dict[str, Any]:
        last = self.sorted_events()[-1] if self.events else None
        return {
            "request_id": self.request_id,
            "created": self.created,
            "last_stage": last.stage if last else "",
            "duration_ms": self.duration_ms(),
            "sla_breached": self.breached,
            "priority": self.label("priority", "unknown"),
            "endpoint": self.label("endpoint",
                                   self.label("engine", "local")),
            **self._cost(),
            "events": len(self.events),
        }

    def _copy(self) -> "Timeline":
        tl = Timeline(self.request_id)
        tl.created = self.created
        # TraceEvents are append-only and never mutated in place once
        # recorded (to_dict copies meta on the way out), so the frozen
        # carry shares them — only the LIST is snapshotted, keeping the
        # terminal-stamp cost inside the per-request trace budget.
        tl.events = list(self.events)
        tl.finalized = self.finalized
        tl.breached = self.breached
        return tl


class FlightRecorder:
    """Process-wide bounded store of request timelines."""

    def __init__(self, *, capacity: int = 1024, slow_capacity: int = 256,
                 sla_ms: float = 5000.0, enabled: bool = True,
                 emit_metrics: bool = True,
                 host: Optional[str] = None) -> None:
        self.enabled = enabled
        self.capacity = max(1, int(capacity))
        self.sla_ms = float(sla_ms)
        self.emit_metrics = emit_metrics
        self.host = host or _host_tag()
        self._mu = threading.Lock()
        self._ring: "OrderedDict[str, Timeline]" = OrderedDict()
        self._slow: deque = deque(maxlen=max(1, int(slow_capacity)))
        self.dropped = 0          # timelines evicted from the ring
        self.sla_breaches = 0
        #: (priority, endpoint) → labeled metric children. ``.labels()``
        #: revalidates on every call (~10µs across 7 families) — cached
        #: here the flush path stays a few µs per timeline.
        self._label_cache: Dict[tuple, Dict[str, Any]] = {}
        #: Finalized-timeline metric tuples awaiting observation —
        #: drained by ``flush_metrics`` at scrape time. Bounded: under
        #: scrape outage the newest observations win.
        self._pending_metrics: deque = deque(maxlen=8192)

    def reconfigure(self, *, capacity: Optional[int] = None,
                    slow_capacity: Optional[int] = None,
                    sla_ms: Optional[float] = None,
                    enabled: Optional[bool] = None) -> None:
        """Apply config to the live singleton IN PLACE — every layer
        already holds a reference to it, so replacing the object would
        split the trace plane in two."""
        with self._mu:
            if capacity is not None:
                self.capacity = max(1, int(capacity))
                while len(self._ring) > self.capacity:
                    self._ring.popitem(last=False)
                    self.dropped += 1
            if slow_capacity is not None:
                self._slow = deque(self._slow,
                                   maxlen=max(1, int(slow_capacity)))
            if sla_ms is not None:
                self.sla_ms = float(sla_ms)
            if enabled is not None:
                self.enabled = enabled

    # -- recording -----------------------------------------------------------

    def record(self, request_id: str, stage: str, *,
               ts: Optional[float] = None, host: Optional[str] = None,
               **meta: Any) -> None:
        """Stamp one stage event. Cheap no-op when disabled; never
        raises (the trace plane must not be able to fail a request)."""
        if not self.enabled or not request_id:
            return
        self._append(request_id,
                     [TraceEvent(stage, time.time() if ts is None else ts,
                                 host or self.host, meta or None)])

    def record_many(self, request_id: str, events,
                    host: Optional[str] = None) -> None:
        """Stamp a burst of ``(stage, ts, meta|None)`` tuples in ONE
        locked append — the engine emits its whole per-request
        lifecycle (admitted … terminal) this way so the decode thread
        pays one lock, not five."""
        if not self.enabled or not request_id:
            return
        h = host or self.host
        self._append(request_id,
                     [TraceEvent(s, t, h, m) for (s, t, m) in events])

    def _append(self, request_id: str, evts: List[TraceEvent]) -> None:
        with self._mu:
            tl = self._ring.get(request_id)
            if tl is None:
                tl = Timeline(request_id)
                self._ring[request_id] = tl
                if len(self._ring) > self.capacity:
                    self._ring.popitem(last=False)
                    self.dropped += 1
            for evt in evts:
                tl.events.append(evt)
                if evt.stage in TERMINAL_STAGES and not tl.finalized:
                    tl.finalized = True
                    dur = tl.duration_ms()
                    tl.breached = bool(
                        self.sla_ms > 0 and dur is not None
                        and dur >= self.sla_ms)
                    if tl.breached:
                        self.sla_breaches += 1
                    # Failures (not cancellations) are always retained.
                    keep: Optional[Timeline] = None
                    retained = tl.breached or evt.stage == "failed"
                    if retained:
                        keep = tl._copy()
                        self._slow.append(keep)
                    if self.emit_metrics:
                        # The critical-path join needs the FULL
                        # timeline at scrape time; for retained
                        # timelines the carried copy doubles as the
                        # retention fix — the ring AND the bounded
                        # slow buffer can both churn past this request
                        # before the scrape drains its tuple
                        # (flush_metrics re-retains from the carry).
                        if keep is None:
                            cp = _cp_analyzer()
                            if cp is not None and cp.enabled:
                                keep = tl._copy()
                        # Deferred: derive the labels/latencies now
                        # (the timeline may mutate later), observe at
                        # scrape time (flush_metrics) — Prometheus
                        # label lookup + observe costs stay off the
                        # request/decode hot path entirely.
                        self._pending_metrics.append((
                            tl.request_id,
                            tl.stage_latencies(),
                            tl.label("priority", "unknown"),
                            tl.label("endpoint",
                                     tl.label("engine", "local")),
                            tl.breached,
                            dur,
                            # Terminal wall time: the SLO windows must
                            # see WHEN the request finished, not when
                            # the next scrape drained the backlog.
                            evt.ts,
                            keep,
                            retained))

    def merge(self, request_id: str,
              events: List[Dict[str, Any]]) -> None:
        """Fold another host's events (their wire dicts) into this
        request's timeline: the HTTP transport stitches a replica's
        engine stages in under the same trace id. A terminal stage that
        arrives so does not finalize the timeline again (the replica
        observed its own histograms; the local terminal stamp owns this
        process's)."""
        if not self.enabled or not request_id or not events:
            return
        parsed = []
        for d in events:
            try:
                e = TraceEvent.from_dict(d)
            except (TypeError, ValueError):
                continue
            if e.stage:
                parsed.append(e)
        if not parsed:
            return
        with self._mu:
            tl = self._ring.get(request_id)
            if tl is None:
                tl = Timeline(request_id)
                self._ring[request_id] = tl
                if len(self._ring) > self.capacity:
                    self._ring.popitem(last=False)
                    self.dropped += 1
            # Dedup on (stage, ts, host): a process routing to itself
            # shares this recorder, so its "remote" events came from here.
            seen = {(e.stage, e.ts, e.host) for e in tl.events}
            tl.events.extend(e for e in parsed
                             if (e.stage, e.ts, e.host) not in seen)

    # -- metrics -------------------------------------------------------------

    def flush_metrics(self) -> int:
        """Observe every pending finalized timeline into the stage
        histograms. Called from the /metrics scrape path (and the admin
        stats routes) — histogram freshness is scrape-granular by
        design, which keeps Prometheus costs off the request hot path.
        Returns the number of timelines flushed."""
        try:
            from llmq_tpu_torch.metrics.registry import get_metrics
            m = get_metrics()
        except Exception:  # noqa: BLE001 — metrics must not fail requests
            return 0
        if not self._pending_metrics:
            # Nothing to observe, but the occupancy gauges must still
            # track the ring (in-flight-only traffic, emit_metrics off
            # mid-run) or they freeze at their last flushed values.
            with self._mu:
                m.flightrecorder_timelines.set(len(self._ring))
                m.flightrecorder_slow_retained.set(len(self._slow))
            return 0
        try:
            from llmq_tpu_torch.observability.slo import get_slo_tracker
            slo = get_slo_tracker()
        except Exception:  # noqa: BLE001 — SLO plane must not fail scrapes
            slo = None
        try:
            from llmq_tpu_torch.observability.usage import get_usage_ledger
            usage = get_usage_ledger()
            if not usage.enabled:
                usage = None
        except Exception:  # noqa: BLE001 — usage plane must not fail scrapes
            usage = None
        cp = _cp_analyzer()
        if cp is not None and not cp.enabled:
            cp = None
        n = 0
        while True:
            try:
                (rid, lat, prio, endpoint, breached, dur_ms, done_ts,
                 carried, retained) = self._pending_metrics.popleft()
            except IndexError:
                break
            key = (prio, endpoint)
            labeled = self._label_cache.get(key)
            if labeled is None:
                labeled = {
                    "queue_wait": m.stage_queue_wait.labels(prio, endpoint),
                    "dispatch": m.stage_dispatch.labels(prio, endpoint),
                    "admission": m.stage_admission.labels(prio, endpoint),
                    "prefill": m.stage_prefill.labels(prio, endpoint),
                    "ttft": m.ttft.labels(prio, endpoint),
                    "decode_interarrival": m.decode_interarrival.labels(
                        prio, endpoint),
                    "sla_breaches": m.sla_breaches.labels(prio),
                }
                if len(self._label_cache) > 4096:  # label-churn backstop
                    self._label_cache.clear()
                self._label_cache[key] = labeled
            for name, secs in lat.items():
                fam = labeled.get(name)
                if fam is not None:
                    fam.observe(secs)
            if breached:
                labeled["sla_breaches"].inc()
            if slo is not None:
                # Same deferred cadence as the histograms: the SLO
                # burn-rate windows are fed per finalized timeline,
                # stamped at the request's COMPLETION time (a scrape
                # outage must not compress the drained backlog into
                # the fast-burn window).
                slo.observe_request(lat, prio, dur_ms, ts=done_ts)
            if usage is not None:
                # Goodput join (observability/usage.py): the SLO
                # verdict meets the request's attributed device time
                # here — the only place both sides exist.
                usage.observe_request(rid, lat, prio, dur_ms,
                                      ts=done_ts)
            live = self.get(rid) if (cp is not None or retained) \
                else None
            if cp is not None:
                # Critical-path join: prefer the LIVE timeline (events
                # stamped after the terminal, such as the worker's
                # "completed", are in it by now), fall back to the
                # carried copy when the ring already churned past it.
                tl_cp = live if live is not None else carried
                if tl_cp is not None:
                    try:
                        cp.observe(tl_cp, metrics=m)
                    except Exception:  # noqa: BLE001 — never fail scrape
                        pass
            if retained and live is None and carried is not None:
                # Retention fix: a breached/failed timeline was copied
                # into the slow buffer at finalize, but BOTH the ring
                # and the bounded slow buffer can churn past it before
                # this flush — the carried copy re-retains it so the
                # slow() debugging surface still has every pending
                # breach at the scrape that reports it.
                with self._mu:
                    self._slow.append(carried)
            n += 1
        with self._mu:
            m.flightrecorder_timelines.set(len(self._ring))
            m.flightrecorder_slow_retained.set(len(self._slow))
        return n

    # -- reads ---------------------------------------------------------------

    def get(self, request_id: str) -> Optional[Timeline]:
        """A consistent COPY of one timeline (ring first, then the
        slow-retention buffer for requests the ring already evicted)."""
        with self._mu:
            tl = self._ring.get(request_id)
            if tl is None:
                for s in reversed(self._slow):
                    if s.request_id == request_id:
                        tl = s
                        break
            return tl._copy() if tl is not None else None

    def recent(self, limit: int = 50) -> List[Timeline]:
        limit = int(limit)
        if limit <= 0:     # [-0:] would be the WHOLE ring, not none
            return []
        with self._mu:
            tls = list(self._ring.values())[-limit:]
            return [t._copy() for t in tls]

    def slow(self) -> List[Timeline]:
        with self._mu:
            return [t._copy() for t in self._slow]

    def get_stats(self) -> Dict[str, Any]:
        self.flush_metrics()
        with self._mu:
            return {
                "enabled": self.enabled,
                "host": self.host,
                "capacity": self.capacity,
                "timelines": len(self._ring),
                "slow_retained": len(self._slow),
                "slow_capacity": self._slow.maxlen,
                "sla_ms": self.sla_ms,
                "sla_breaches": self.sla_breaches,
                "dropped": self.dropped,
            }

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()
            self._slow.clear()
            # Pending scrape-time observations go too: a stale tuple
            # surviving clear() would join against a later usage ledger
            # record whose request id collides.
            self._pending_metrics.clear()
            self.dropped = 0
            self.sla_breaches = 0

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)


# -- process singleton --------------------------------------------------------

_LOCK = threading.Lock()
_RECORDER: Optional[FlightRecorder] = None


def get_recorder() -> FlightRecorder:
    """The process-wide recorder (default config until ``configure``)."""
    global _RECORDER
    with _LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def configure(cfg) -> FlightRecorder:
    """Apply an ``ObservabilityConfig`` to the singleton (in place —
    existing references stay valid)."""
    rec = get_recorder()
    rec.reconfigure(capacity=getattr(cfg, "recorder_capacity", None),
                    slow_capacity=getattr(cfg, "slow_capacity", None),
                    sla_ms=getattr(cfg, "sla_ms", None),
                    enabled=getattr(cfg, "enabled", None))
    rec.emit_metrics = bool(getattr(cfg, "emit_metrics", True))
    usage_cfg = getattr(cfg, "usage", None)
    if usage_cfg is not None:
        from llmq_tpu_torch.observability.usage import configure_usage
        led = configure_usage(usage_cfg)
        if led.enabled and not (rec.enabled and rec.emit_metrics):
            # The goodput join is FED by this recorder's metrics flush
            # (the only place SLO verdicts meet attributed device
            # time). Attribution/waste/rollups still work without it —
            # but the goodput gauge would read a silent 0.0.
            log.warning(
                "observability.usage is enabled but the trace plane "
                "(observability.enabled + emit_metrics) is off: "
                "goodput_tokens_per_device_second has no feed and "
                "will stay 0; device-second/waste attribution is "
                "unaffected")
    slo_cfg = getattr(cfg, "slo", None)
    if slo_cfg is not None:
        from llmq_tpu_torch.observability.slo import configure_slo, get_slo_tracker
        if rec.enabled and rec.emit_metrics:
            configure_slo(slo_cfg)
        else:
            # The SLO plane is FED by this recorder's metrics flush —
            # with the trace plane (or its metric emission) off, the
            # tracker would starve and report 0 burn forever while
            # requests breach. Disabling it makes that state VISIBLE
            # (no targets in engine-stats/overview snapshots) instead
            # of false-healthy.
            get_slo_tracker().reconfigure(targets={})
            if getattr(slo_cfg, "enabled", True):
                log.warning(
                    "observability.slo is enabled but the trace plane "
                    "is not (enabled=%s emit_metrics=%s) — SLO burn "
                    "rates have no feed and are disabled",
                    rec.enabled, rec.emit_metrics)
    cp_cfg = getattr(cfg, "critical_path", None)
    if cp_cfg is not None:
        from llmq_tpu_torch.observability.critical_path import \
            configure_critical_path
        ana = configure_critical_path(cp_cfg)
        if ana.enabled and not (rec.enabled and rec.emit_metrics):
            # Same feed contract as SLO/usage: the per-request join is
            # FED by this recorder's metrics flush. Force-disabling
            # makes the starved state visible (and keeps the engine's
            # extra stage marks off) instead of an empty rollup that
            # reads as "zero latency everywhere".
            ana.reconfigure(enabled=False)
            log.warning(
                "observability.critical_path is enabled but the trace "
                "plane is not (enabled=%s emit_metrics=%s) — the "
                "per-request join has no feed and is disabled",
                rec.enabled, rec.emit_metrics)
    return rec


def record(request_id: str, stage: str, **kw: Any) -> None:
    """Module-level stamp onto the singleton — the one-liner every
    layer uses. No-ops fast when tracing is disabled."""
    rec = _RECORDER
    if rec is None:
        rec = get_recorder()
    if rec.enabled:
        rec.record(request_id, stage, **kw)
