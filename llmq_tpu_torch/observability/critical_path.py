"""Critical-path plane: per-request latency attribution + boot
decomposition (the port's copy of
``llmq_tpu/observability/critical_path.py``).

Two halves, one discipline (buffer on the hot path, observe at scrape):

**Per-request critical path.** The flight recorder stamps stage
*events* and the device plane decomposes *step* time; this module joins
them into one exhaustive, conservation-checked segment decomposition of
a finished request's end-to-end latency::

    queue_wait → dispatch → admission → kv_promote|handoff_claim
        → prefill → decode_compute/decode_stall → completion

:func:`decompose` is pure (timeline in, segment intervals out) and
conserves by construction: the segment intervals tile ``[first event,
terminal event]`` exactly, so their sum equals the recorded e2e
duration (to float noise; the analyzer checks it at 2 %). Sub-spans
recorded as ``*_start``/``*_done`` mark pairs are *carved out of*
whatever base segment they overlap rather than added on top (the port
stamps none of them yet: their planes are not ported). The decode span
is split against the engine's per-chunk device attribution
(``decode_device_s`` in the terminal event's meta): the attributed
portion is ``decode_compute``, the remainder ``decode_stall``.

The :class:`CriticalPathAnalyzer` singleton is FED by
``FlightRecorder.flush_metrics`` — scrape-granular, off the request hot
path, same contract as the SLO/usage planes. It feeds the
``llm_queue_critical_path_ms{segment,priority}`` histograms, the
dominant-segment counter, and the ``GET /api/v1/analysis/critical-path``
rollup.

**Boot decomposition.** ``replica_ready_seconds{stage}`` with the
closed stages ``provision → artifact → weights → compile → warmup →
first_token``, stamped by the engine builder and the serve entry point
in-process. On the card: ``weights`` is the random init or the
``params_from_jax`` conversion plus its transfer, ``compile`` the
``nvcc`` builds of ``csrc/`` (0 s when the hashed libraries exist),
``warmup`` the eager run of every program plus every CUDA-graph
capture, ``artifact`` 0 (the port has no export cache).

``observability.critical_path.enabled: false`` is a hard off-switch:
no extra marks are stamped anywhere (every instrumented site gates on
one attribute check) and the scrape-time join is skipped.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from llmq_tpu_torch.observability.recorder import TERMINAL_STAGES, Timeline


#: Every segment a request's wall time can be attributed to. Closed
#: enum — mirrored by metrics.registry.LABEL_CONTRACT["segment"].
SEGMENTS = ("queue_wait", "dispatch", "admission", "kv_promote",
            "handoff_claim", "prefill", "decode_compute",
            "decode_stall", "completion")

#: Replica boot stages, in boot order. Closed enum — mirrored by
#: LABEL_CONTRACT["stage"].
BOOT_STAGES = ("provision", "artifact", "weights", "compile", "warmup",
               "first_token")

#: Stage-event boundaries in lifecycle order; each names the base
#: segment that ENDS at it. ``admitted`` and ``prefill_start`` both
#: close "admission" (the admit→prefill-dispatch gap is still the
#: engine's admission machinery), ``prefill_done``/``first_token``
#: both close "prefill" (sampling the first token IS prefill work).
_BOUNDARIES: Tuple[Tuple[str, str], ...] = (
    ("scheduled", "queue_wait"),
    ("dispatched", "dispatch"),
    ("admitted", "admission"),
    ("prefill_start", "admission"),
    ("prefill_done", "prefill"),
    ("first_token", "prefill"),
    ("decode_done", "decode"),
)

#: Segment the request was IN after crossing each boundary — names the
#: final interval when the request died (failed/cancelled/shed) before
#: reaching the next boundary.
_PHASE_AFTER = {
    None: "queue_wait",
    "scheduled": "dispatch",
    "dispatched": "admission",
    "admitted": "prefill",
    "prefill_start": "prefill",
    "prefill_done": "decode",
    "first_token": "decode",
    "decode_done": "completion",
}

#: ``<sub-segment>_start`` / ``<sub-segment>_done`` mark pairs carved
#: out of the base segments they overlap.
_SUB_SPANS = ("kv_promote", "handoff_claim")


def decompose(tl: Timeline) -> Optional[Dict[str, Any]]:
    """Segment decomposition of one FINALIZED timeline.

    Returns ``None`` for unfinished timelines. Otherwise a dict::

        {"segments": {segment: seconds},   # only segments > 0
         "total_s": float,                 # == sum(segments) exactly
         "dominant": str,                  # argmax segment
         "priority": str, "endpoint": str,
         "outcome": "completed"|"failed"|"cancelled"}

    Conservation is by construction: the base intervals tile
    ``[min event ts, max terminal ts]`` and sub-span carving moves
    time between segments without creating or destroying any.
    """
    if not tl.events:
        return None
    ts: Dict[str, float] = {}
    for e in tl.events:
        ts.setdefault(e.stage, e.ts)
    outcome = next((s for s in TERMINAL_STAGES if s in ts), None)
    if outcome is None:
        return None
    t0 = min(e.ts for e in tl.events)
    t_end = max(e.ts for e in tl.events if e.stage in TERMINAL_STAGES)
    # -- base intervals: consecutive boundary deltas, clamped monotone
    # -- (cross-host clock skew must not mint negative segments) ------
    intervals: List[List[Any]] = []   # [segment, a, b]
    cursor = t0
    last_boundary: Optional[str] = None
    for stage, segment in _BOUNDARIES:
        t = ts.get(stage)
        if t is None:
            continue
        t = min(max(t, cursor), t_end)
        if t > cursor:
            intervals.append([segment, cursor, t])
        cursor = t
        last_boundary = stage
    if t_end > cursor:
        intervals.append([_PHASE_AFTER[last_boundary], cursor, t_end])
    # -- carve sub-spans (``*_start``/``*_done`` pairs) out of the base
    # -- segments they overlap ----------------------------------------
    sub_totals: Dict[str, float] = {}
    for name in _SUB_SPANS:
        a = ts.get(f"{name}_start")
        b = ts.get(f"{name}_done")
        if a is None or b is None or b <= a:
            continue
        a, b = max(a, t0), min(b, t_end)
        for iv in intervals:
            lo, hi = max(iv[1], a), min(iv[2], b)
            if hi > lo:
                sub_totals[name] = sub_totals.get(name, 0.0) + (hi - lo)
                # shrink the base interval by the carved overlap; the
                # remainder keeps the base name (the sum is what the
                # rollup reads, interval geometry is internal)
                iv.append(hi - lo)
    segments: Dict[str, float] = {}
    for iv in intervals:
        carved = sum(iv[3:])
        span = (iv[2] - iv[1]) - carved
        if span > 0:
            segments[iv[0]] = segments.get(iv[0], 0.0) + span
    for name, s in sub_totals.items():
        segments[name] = segments.get(name, 0.0) + s
    # -- split the decode span against the engine's per-chunk device
    # -- attribution (decode_device_s stamped in the terminal meta) ---
    decode_span = segments.pop("decode", 0.0)
    if decode_span > 0:
        attributed = None
        for e in tl.events:
            if e.stage in TERMINAL_STAGES and "decode_device_s" in e.meta:
                try:
                    attributed = float(e.meta["decode_device_s"])
                except (TypeError, ValueError):
                    attributed = None
                break
        if attributed is None:
            # No attribution (a request that decoded no chunk, old
            # events): the whole span is presumed compute — stall must
            # be EVIDENCED, never inferred from absence of data.
            segments["decode_compute"] = decode_span
        else:
            compute = min(decode_span, max(0.0, attributed))
            segments["decode_compute"] = compute
            stall = decode_span - compute
            if stall > 0:
                segments["decode_stall"] = stall
    total = t_end - t0
    dominant = max(segments, key=segments.get) if segments else "completion"
    return {
        "segments": segments,
        "total_s": total,
        "dominant": dominant,
        "priority": tl.label("priority", "unknown"),
        "endpoint": tl.label("endpoint", tl.label("engine", "local")),
        "outcome": outcome,
    }


class CriticalPathAnalyzer:
    """Fleet-wide "where does time go" rollup over decomposed requests.

    FED by ``FlightRecorder.flush_metrics`` at scrape time — observes
    the per-segment histograms and dominant-segment counter directly
    (we are already on the scrape path) and keeps bounded in-memory
    totals for ``GET /api/v1/analysis/critical-path``.
    """

    def __init__(self, *, enabled: bool = True,
                 recent_capacity: int = 256) -> None:
        self.enabled = enabled
        self._mu = threading.Lock()
        self._totals: Dict[str, float] = {}          # segment → seconds
        self._by_priority: Dict[str, Dict[str, float]] = {}
        self._dominant: Dict[str, int] = {}          # segment → requests
        self._recent: deque = deque(maxlen=max(1, int(recent_capacity)))
        self.requests = 0
        self.conservation_failures = 0
        self._label_cache: Dict[tuple, Any] = {}

    def reconfigure(self, *, enabled: Optional[bool] = None,
                    recent_capacity: Optional[int] = None) -> None:
        with self._mu:
            if enabled is not None:
                self.enabled = enabled
            if recent_capacity is not None:
                self._recent = deque(self._recent,
                                     maxlen=max(1, int(recent_capacity)))

    def observe(self, tl: Timeline, *, metrics: Any = None) -> bool:
        """Decompose one finalized timeline into the rollup + the
        Prometheus families. Called from the recorder's scrape-time
        flush only — never on the request hot path."""
        if not self.enabled:
            return False
        d = decompose(tl)
        if d is None:
            return False
        segments, prio = d["segments"], d["priority"]
        recorded = tl.duration_ms()
        seg_sum_ms = sum(segments.values()) * 1e3
        conserved = (recorded is None or recorded <= 0
                     or abs(seg_sum_ms - recorded) <= 0.02 * recorded
                     or abs(seg_sum_ms - recorded) < 0.05)  # float floor
        if metrics is None:
            try:
                from llmq_tpu_torch.metrics.registry import get_metrics
                metrics = get_metrics()
            except Exception:  # noqa: BLE001 — never fail the scrape
                metrics = None
        with self._mu:
            self.requests += 1
            if not conserved:
                self.conservation_failures += 1
            per_prio = self._by_priority.setdefault(prio, {})
            for seg, secs in segments.items():
                self._totals[seg] = self._totals.get(seg, 0.0) + secs
                per_prio[seg] = per_prio.get(seg, 0.0) + secs
            self._dominant[d["dominant"]] = \
                self._dominant.get(d["dominant"], 0) + 1
            self._recent.append({
                "request_id": tl.request_id,
                "total_ms": round(d["total_s"] * 1e3, 3),
                "dominant": d["dominant"],
                "priority": prio,
                "endpoint": d["endpoint"],
                "outcome": d["outcome"],
                "segments_ms": {k: round(v * 1e3, 3)
                                for k, v in segments.items()},
            })
            if metrics is not None:
                for seg, secs in segments.items():
                    key = (seg, prio)
                    child = self._label_cache.get(key)
                    if child is None:
                        child = (metrics.critical_path_ms
                                 .labels(seg, prio),
                                 metrics.critical_path_dominant
                                 .labels(seg, prio))
                        if len(self._label_cache) > 4096:
                            self._label_cache.clear()
                        self._label_cache[key] = child
                    child[0].observe(secs * 1e3)
                dom_key = (d["dominant"], prio)
                child = self._label_cache.get(dom_key)
                if child is None:
                    child = (metrics.critical_path_ms
                             .labels(dom_key[0], prio),
                             metrics.critical_path_dominant
                             .labels(dom_key[0], prio))
                    self._label_cache[dom_key] = child
                child[1].inc()
        return True

    def snapshot(self, *, recent: int = 20) -> Dict[str, Any]:
        with self._mu:
            total = sum(self._totals.values())
            return {
                "enabled": self.enabled,
                "requests": self.requests,
                "conservation_failures": self.conservation_failures,
                "totals_ms": {k: round(v * 1e3, 3)
                              for k, v in sorted(self._totals.items())},
                "share": {k: round(v / total, 4)
                          for k, v in sorted(self._totals.items())}
                if total > 0 else {},
                "by_priority_ms": {
                    p: {k: round(v * 1e3, 3) for k, v in segs.items()}
                    for p, segs in sorted(self._by_priority.items())},
                "dominant": dict(sorted(self._dominant.items(),
                                        key=lambda kv: -kv[1])),
                "recent": list(self._recent)[-max(0, int(recent)):],
            }

    def clear(self) -> None:
        with self._mu:
            self._totals.clear()
            self._by_priority.clear()
            self._dominant.clear()
            self._recent.clear()
            self.requests = 0
            self.conservation_failures = 0


# -- boot decomposition --------------------------------------------------------


class BootRecord:
    """One boot (a serve process, an engine build), decomposed into
    :data:`BOOT_STAGES`."""

    __slots__ = ("replica_id", "kind", "started", "stages", "ready",
                 "total_s")

    def __init__(self, replica_id: str, kind: str) -> None:
        self.replica_id = replica_id
        self.kind = kind
        self.started = time.time()
        self.stages: "OrderedDict[str, float]" = OrderedDict()
        self.ready = False
        self.total_s: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "replica_id": self.replica_id,
            "kind": self.kind,
            "started": self.started,
            "ready": self.ready,
            "total_s": (round(self.total_s, 4)
                        if self.total_s is not None else None),
            "stages_s": {k: round(v, 4) for k, v in self.stages.items()},
        }


class BootRegistry:
    """Bounded store of boot decompositions + the pending
    ``replica_ready_seconds{stage}`` observations (flushed at scrape —
    same discipline as every other plane)."""

    def __init__(self, *, capacity: int = 64) -> None:
        self._mu = threading.Lock()
        self._records: "OrderedDict[str, BootRecord]" = OrderedDict()
        self.capacity = max(1, int(capacity))
        self._pending: deque = deque(maxlen=4096)
        self._label_cache: Dict[str, Any] = {}

    def reconfigure(self, *, capacity: Optional[int] = None) -> None:
        with self._mu:
            if capacity is not None:
                self.capacity = max(1, int(capacity))
                while len(self._records) > self.capacity:
                    self._records.popitem(last=False)

    def begin(self, replica_id: str, kind: str) -> BootRecord:
        rec = BootRecord(replica_id, kind)
        with self._mu:
            self._records[replica_id] = rec
            self._records.move_to_end(replica_id)
            while len(self._records) > self.capacity:
                self._records.popitem(last=False)
        return rec

    def stage(self, replica_id: str, stage: str, seconds: float) -> None:
        """Record one stage's duration (seconds accumulate if stamped
        twice — e.g. weights streamed in two phases)."""
        if seconds < 0 or stage not in BOOT_STAGES:
            return
        with self._mu:
            rec = self._records.get(replica_id)
            if rec is None:
                rec = BootRecord(replica_id, "unknown")
                self._records[replica_id] = rec
                while len(self._records) > self.capacity:
                    self._records.popitem(last=False)
            rec.stages[stage] = rec.stages.get(stage, 0.0) + seconds
            self._pending.append((stage, seconds))

    def adopt(self, replica_id: str, kind: str,
              stages: Dict[str, Any], *,
              total_s: Optional[float] = None) -> None:
        """Fold a child replica's boot stages (its /health ``boot``
        block) into this process's record of it: the control plane's
        pools call it. The child's stages are taken as they are; the
        pool's wall time beyond them becomes "provision" (spawn and
        health polling), so the stages still sum to the ready wall."""
        rec = self.begin(replica_id, kind)
        known = 0.0
        for stg in BOOT_STAGES:
            try:
                v = float(stages.get(stg, 0.0) or 0.0)
            except (TypeError, ValueError):
                continue
            if v > 0 and stg != "provision":
                known += v
                with self._mu:
                    rec.stages[stg] = v
                    self._pending.append((stg, v))
        if total_s is not None and total_s > 0:
            rec.total_s = total_s
            rec.ready = True
            provision = max(0.0, total_s - known)
            with self._mu:
                rec.stages["provision"] = provision
                self._pending.append(("provision", provision))

    def ready(self, replica_id: str,
              total_s: Optional[float] = None) -> None:
        with self._mu:
            rec = self._records.get(replica_id)
            if rec is None:
                return
            rec.ready = True
            rec.total_s = (total_s if total_s is not None
                           else time.time() - rec.started)

    def get(self, replica_id: str) -> Optional[Dict[str, Any]]:
        with self._mu:
            rec = self._records.get(replica_id)
            return rec.to_dict() if rec is not None else None

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            return {rid: rec.to_dict()
                    for rid, rec in self._records.items()}

    def flush(self, metrics: Any = None) -> int:
        """Observe pending stage durations into
        ``llm_queue_replica_ready_seconds{stage}`` — called from the
        /metrics exposition chain."""
        if not self._pending:
            return 0
        if metrics is None:
            try:
                from llmq_tpu_torch.metrics.registry import get_metrics
                metrics = get_metrics()
            except Exception:  # noqa: BLE001
                return 0
        n = 0
        while True:
            try:
                stage, seconds = self._pending.popleft()
            except IndexError:
                break
            child = self._label_cache.get(stage)
            if child is None:
                child = metrics.replica_ready_seconds.labels(stage)
                self._label_cache[stage] = child
            child.observe(seconds)
            n += 1
        return n

    def clear(self) -> None:
        with self._mu:
            self._records.clear()
            self._pending.clear()


# -- process singletons --------------------------------------------------------

_LOCK = threading.Lock()
_ANALYZER: Optional[CriticalPathAnalyzer] = None
_BOOT: Optional[BootRegistry] = None
#: The replica id of THIS process's own boot record (serve boot /
#: in-process engine build) — lets the engine stamp first_token without
#: knowing who built it.
_PROCESS_BOOT_ID: Optional[str] = None
_PROCESS_FIRST_TOKEN_DONE = False


def get_critical_path() -> CriticalPathAnalyzer:
    global _ANALYZER
    with _LOCK:
        if _ANALYZER is None:
            _ANALYZER = CriticalPathAnalyzer()
        return _ANALYZER


def get_boot_registry() -> BootRegistry:
    global _BOOT
    with _LOCK:
        if _BOOT is None:
            _BOOT = BootRegistry()
        return _BOOT


def configure_critical_path(cfg) -> CriticalPathAnalyzer:
    """Apply a ``CriticalPathConfig`` to the singletons (in place)."""
    ana = get_critical_path()
    ana.reconfigure(
        enabled=getattr(cfg, "enabled", None),
        recent_capacity=getattr(cfg, "recent_capacity", None))
    get_boot_registry().reconfigure(
        capacity=getattr(cfg, "boot_capacity", None))
    return ana


def cp_enabled() -> bool:
    """One-attribute-check gate for instrumented hot paths."""
    ana = _ANALYZER
    return ana.enabled if ana is not None else \
        get_critical_path().enabled


def flush_boot_metrics() -> int:
    """Exposition-chain hook (metrics/registry.py)."""
    reg = _BOOT
    if reg is None:
        return 0
    return reg.flush()


def boot_begin(replica_id: str, kind: str, *,
               process: bool = False) -> None:
    """Open a boot record. ``process=True`` marks it as THIS process's
    own boot so the engine can stamp first_token against it."""
    global _PROCESS_BOOT_ID, _PROCESS_FIRST_TOKEN_DONE
    if not cp_enabled():
        return
    get_boot_registry().begin(replica_id, kind)
    if process:
        _PROCESS_BOOT_ID = replica_id
        _PROCESS_FIRST_TOKEN_DONE = False


def boot_stage(replica_id: str, stage: str, seconds: float) -> None:
    if not cp_enabled():
        return
    get_boot_registry().stage(replica_id, stage, seconds)


def boot_ready(replica_id: str,
               total_s: Optional[float] = None) -> None:
    if not cp_enabled():
        return
    get_boot_registry().ready(replica_id, total_s)


def current_boot_id() -> Optional[str]:
    """The replica id of this process's open boot record, or None."""
    return _PROCESS_BOOT_ID


def process_boot_snapshot() -> Optional[Dict[str, Any]]:
    """This process's own boot record (for /health propagation)."""
    if _PROCESS_BOOT_ID is None:
        return None
    return get_boot_registry().get(_PROCESS_BOOT_ID)


def note_first_token() -> None:
    """Engine hook: wall time from process boot to the FIRST committed
    token across all requests — the last boot stage. Idempotent and
    one flag check after it fires."""
    global _PROCESS_FIRST_TOKEN_DONE
    if _PROCESS_FIRST_TOKEN_DONE or _PROCESS_BOOT_ID is None:
        return
    _PROCESS_FIRST_TOKEN_DONE = True
    reg = get_boot_registry()
    with reg._mu:
        rec = reg._records.get(_PROCESS_BOOT_ID)
        if rec is None:
            return
        base = rec.started + sum(rec.stages.values())
        seconds = max(0.0, time.time() - base)
        if rec.stages.get("first_token"):
            return
        rec.stages["first_token"] = seconds
        reg._pending.append(("first_token", seconds))
