"""Chrome trace-event export (the port's copy of
``llmq_tpu/observability/chrome.py``): one viewable file stitching host
timelines, the engine's ``SpanRecorder`` spans and (a pointer to) the
``torch.profiler`` capture.

Output is the Trace Event Format consumed by chrome://tracing and
Perfetto. Mapping:

- Each HOST in a timeline becomes a process (``pid``), named via ``M``
  metadata events.
- Consecutive stage events on one host become ``X`` (complete) slices
  — the time BETWEEN stages is the interesting quantity; the terminal
  stage closes the last slice. Every raw stage is also emitted as an
  ``i`` (instant) event so nothing is hidden by the pairing.
- ``SpanRecorder`` spans (perf_counter-based) are shifted onto the
  wall clock with the caller-supplied anchor (``wall - perf`` sampled
  in the process that owns the spans) and emitted on their own track.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional

from llmq_tpu_torch.observability.recorder import TERMINAL_STAGES, Timeline


def perf_anchor() -> float:
    """``wall - perf_counter`` offset for shifting SpanRecorder spans
    (perf_counter epoch) onto the wall clock. Only valid for spans
    recorded in THIS process."""
    return time.time() - time.perf_counter()


def chrome_trace(timelines: Iterable[Timeline], *,
                 spans: Optional[List] = None,
                 span_anchor: Optional[float] = None,
                 jax_trace_dir: Optional[str] = None) -> Dict[str, Any]:
    """Build a ``{"traceEvents": [...]}`` document."""
    events: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}

    def pid_for(host: str) -> int:
        if host not in pids:
            pids[host] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[host], "tid": 0,
                           "args": {"name": host}})
        return pids[host]

    for tl in timelines:
        by_host: Dict[str, List] = {}
        for e in tl.sorted_events():
            by_host.setdefault(e.host, []).append(e)
        for host, evts in by_host.items():
            pid = pid_for(host)
            for e in evts:
                events.append({
                    "name": e.stage, "ph": "i", "s": "t",
                    "ts": e.ts * 1e6, "pid": pid, "tid": 0,
                    "args": {"request_id": tl.request_id, **e.meta}})
            for a, b in zip(evts, evts[1:]):
                if a.stage in TERMINAL_STAGES:
                    continue
                events.append({
                    "name": f"{a.stage}→{b.stage}", "ph": "X",
                    "ts": a.ts * 1e6,
                    "dur": max(0.0, (b.ts - a.ts) * 1e6),
                    "pid": pid, "tid": 1,
                    "args": {"request_id": tl.request_id}})

    if spans:
        anchor = perf_anchor() if span_anchor is None else span_anchor
        pid = pid_for("executor-spans")
        for s in spans:
            events.append({
                "name": s.name, "ph": "X",
                "ts": (s.start + anchor) * 1e6,
                "dur": s.duration * 1e6,
                "pid": pid, "tid": 2, "args": dict(s.meta or {})})

    out: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    if jax_trace_dir:
        # Device traces are too big to inline; point the reader at the
        # torch.profiler Chrome trace next to this host trace. The key
        # keeps the JAX package's name, so one reader serves both.
        out["otherData"] = {"jax_trace_dir": jax_trace_dir}
    return out
