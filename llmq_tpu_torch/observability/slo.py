"""SLO layer: error-budget burn rates over the request-stage telemetry
(the port's copy of ``llmq_tpu/observability/slo.py``).

The stage histograms tell you *what* latency looks like; this module
tells you whether you are *keeping your promises*: each config-defined
SLO (``observability.slo``) is a latency target plus an objective ("99 %
of requests under 2 s TTFT"), and the tracker turns the stream of
finished requests into rolling **burn rates** — how fast the error
budget is being spent, normalized so 1.0 means "exactly on budget" (the
standard multi-window burn-rate alerting input).

Built-in SLOs:

- ``ttft``      — time to first token (the ``ttft`` stage latency),
  every request.
- ``realtime``  — end-to-end latency of REALTIME-tier requests.

Feeding happens where the stage histograms are fed: the flight
recorder's ``flush_metrics`` hands every finalized timeline here, so
the SLO plane costs nothing on the request hot path and stays exactly
as fresh as the rest of the metric surface (scrape-granular).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional


def window_label(seconds: float) -> str:
    """Bounded label for a rolling window: "5m", "1h", "90s"."""
    s = int(seconds)
    if s % 3600 == 0:
        return f"{s // 3600}h"
    if s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


class SloTracker:
    """Rolling per-SLO breach accounting.

    ``targets`` maps SLO name → latency target in ms (<= 0 disables
    that SLO). ``objective`` is the success fraction promised (0.99 →
    1 % error budget). Events are (ts, breached) pairs in bounded
    deques; burn rate over a window = breach_fraction / (1−objective).
    """

    MAX_EVENTS = 65536   # per SLO; oldest-out under sustained load

    #: The JAX package's defaults: 2 s TTFT, 500 ms end to end for
    #: the realtime tier.
    DEFAULT_TARGETS = {"ttft": 2000.0, "realtime": 500.0}

    def __init__(self, *, targets: Optional[Dict[str, float]] = None,
                 objective: float = 0.99,
                 windows_s=(300.0, 3600.0),
                 metrics: bool = True) -> None:
        self._mu = threading.Lock()
        self.metrics_enabled = metrics
        self._events: Dict[str, deque] = {}
        self.reconfigure(
            targets=dict(self.DEFAULT_TARGETS) if targets is None
            else targets,
            objective=objective, windows_s=windows_s)

    def reconfigure(self, *, targets: Optional[Dict[str, float]] = None,
                    objective: Optional[float] = None,
                    windows_s=None) -> None:
        """Apply config in place (singleton contract, like the flight
        recorder's). Existing event streams survive a retarget —
        history stays comparable across a threshold tweak."""
        with self._mu:
            if targets is not None:
                self.targets = {k: float(v) for k, v in targets.items()
                                if v and float(v) > 0}
                self._events = {
                    k: self._events.get(k, deque(maxlen=self.MAX_EVENTS))
                    for k in self.targets}
            if objective is not None:
                # Clamp away a 100 % objective: a zero error budget
                # makes every burn rate infinite.
                self.objective = min(max(float(objective), 0.5), 0.9999)
            if windows_s is not None:
                ws = sorted(float(w) for w in windows_s if float(w) > 0)
                self.windows_s = tuple(ws) or (300.0, 3600.0)

    # -- feeding --------------------------------------------------------------

    def observe(self, slo: str, latency_ms: float,
                ts: Optional[float] = None) -> None:
        target = self.targets.get(slo)
        if target is None:
            return
        now = time.time() if ts is None else ts
        with self._mu:
            dq = self._events.get(slo)
            if dq is None:
                return
            dq.append((now, latency_ms > target))
            horizon = now - self.windows_s[-1]
            while dq and dq[0][0] < horizon:
                dq.popleft()

    def observe_request(self, stage_latencies: Dict[str, float],
                        priority: str,
                        duration_ms: Optional[float],
                        ts: Optional[float] = None) -> None:
        """One finished request, in the flight recorder's terms:
        ``stage_latencies`` in SECONDS (Timeline.stage_latencies),
        end-to-end ``duration_ms``, ``ts`` the request's completion
        wall time (defaults to now — pass it when draining a backlog,
        or a scrape gap mis-windows old breaches as fresh)."""
        ttft = stage_latencies.get("ttft")
        if ttft is not None:
            self.observe("ttft", ttft * 1e3, ts=ts)
        if priority == "realtime" and duration_ms is not None:
            self.observe("realtime", duration_ms, ts=ts)

    # -- derived --------------------------------------------------------------

    def burn_rates(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """{slo: {window_label: {burn_rate, requests, breaches}}}.
        Burn rate 1.0 = spending exactly the allowed error budget;
        0 when no requests finished inside the window."""
        now = time.time()
        allowed = 1.0 - self.objective
        out: Dict[str, Dict[str, Dict[str, Any]]] = {}
        with self._mu:
            snap = {k: list(dq) for k, dq in self._events.items()}
        for slo, events in snap.items():
            per: Dict[str, Dict[str, Any]] = {}
            for w in self.windows_s:
                horizon = now - w
                n = b = 0
                for ts, breached in reversed(events):
                    if ts < horizon:
                        break
                    n += 1
                    b += breached
                frac = b / n if n else 0.0
                per[window_label(w)] = {
                    "burn_rate": round(frac / allowed, 3),
                    "requests": n,
                    "breaches": b,
                }
            out[slo] = per
        return out

    def flush(self) -> None:
        """Set the burn-rate / budget gauges (scrape path)."""
        if not self.metrics_enabled or not self.targets:
            return
        from llmq_tpu_torch.metrics.registry import get_metrics
        m = get_metrics()
        rates = self.burn_rates()
        long_w = window_label(self.windows_s[-1])
        for slo, per in rates.items():
            for wl, d in per.items():
                m.slo_burn_rate.labels(slo, wl).set(d["burn_rate"])
            burn = per.get(long_w, {}).get("burn_rate", 0.0)
            m.slo_error_budget_remaining.labels(slo).set(
                max(0.0, 1.0 - burn))

    def snapshot(self) -> Dict[str, Any]:
        return {
            "objective": self.objective,
            "targets_ms": dict(self.targets),
            "windows": [window_label(w) for w in self.windows_s],
            "burn_rates": self.burn_rates(),
        }


# -- process singleton ---------------------------------------------------------

_LOCK = threading.Lock()
_TRACKER: Optional[SloTracker] = None


def get_slo_tracker() -> SloTracker:
    global _TRACKER
    with _LOCK:
        if _TRACKER is None:
            _TRACKER = SloTracker()
        return _TRACKER


def configure_slo(cfg) -> SloTracker:
    """Apply an ``observability.slo`` config block (core.config
    SloConfig or anything with the same fields) onto the singleton."""
    t = get_slo_tracker()
    if not getattr(cfg, "enabled", True):
        t.reconfigure(targets={})
        return t
    t.reconfigure(
        targets={
            "ttft": getattr(cfg, "ttft_p99_ms", 0.0),
            "realtime": getattr(cfg, "realtime_p99_ms", 0.0),
        },
        objective=getattr(cfg, "objective", 0.99),
        windows_s=getattr(cfg, "windows_s", None) or (300.0, 3600.0))
    return t
