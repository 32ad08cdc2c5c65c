"""Tracing / profiling hooks (the port's copy of
``llmq_tpu/utils/profiling.py``).

Two layers:

- **Device tracing** — :func:`trace` wraps a code region in
  ``torch.profiler`` (host ops, and with ``cuda`` the card's kernels and
  copies through CUPTI) and writes one Chrome trace, viewable in
  Perfetto or chrome://tracing. Enabled ambiently by setting
  ``LLMQ_TRACE_DIR``, or on demand by ``POST /api/v1/admin/profile``.
- **Host spans** — :class:`SpanRecorder`, a lightweight in-process
  span log (name, start, duration) for control-plane paths (prefill
  dispatch → chunk dispatch → chunk fetch), exposed via
  ``GET /api/v1/engine/stats`` and dumpable to Chrome trace-event JSON.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

log = logging.getLogger("llmq_tpu_torch.profiling")

TRACE_DIR_ENV = "LLMQ_TRACE_DIR"

#: File name of the Chrome trace :func:`trace` writes in its directory.
TRACE_FILE = "trace.json"


def trace_dir() -> Optional[str]:
    return os.environ.get(TRACE_DIR_ENV) or None


@contextmanager
def trace(label: str = "llmq", dir: Optional[str] = None, *,
          cuda: bool = False, quiesce=None,
          stats: Optional[Dict] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the region into
    ``<dir>/<label>/trace.json`` if LLMQ_TRACE_DIR is set (or an explicit
    ``dir`` is given — the on-demand ``POST /api/v1/admin/profile``
    path); no-op otherwise. Host activity always; ``cuda`` adds the
    card's activity, which CUPTI records process-wide, whichever thread
    launched it. ``quiesce`` (e.g. an engine's ``paused``) is entered
    around the profiler's start and stop: its stop synchronizes the
    device, which must not overlap another thread's CUDA-graph
    launches; the stop also holds the interpreter while it turns the
    capture's events into a result (~7.8 s for one second of llama3-8b
    decode on an H100, ~186k kernels), so a capture stalls serving. The
    trace is written after the hold, by :func:`write_chrome_trace`.
    ``stats``, when given, receives the seconds of the held start
    (``start_s``) and stop (``stop_s``), the write's seconds
    (``write_s``) and its event count (``events``)."""
    d = dir or trace_dir()
    if not d:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(d, label)
    os.makedirs(out, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    hold = quiesce or nullcontext
    log.info("tracing %s → %s", label, out)
    prof = profile(activities=acts)
    t0 = time.perf_counter()
    with hold():
        prof.start()
    t1 = time.perf_counter()
    try:
        yield
    finally:
        t2 = time.perf_counter()
        with hold():
            prof.stop()
        t3 = time.perf_counter()
    path = os.path.join(out, TRACE_FILE)
    n = write_chrome_trace(prof.profiler.kineto_results, path)
    t4 = time.perf_counter()
    if stats is not None:
        stats.update(start_s=t1 - t0, stop_s=t3 - t2, write_s=t4 - t3,
                     events=n)
    log.info("trace written to %s (%d events, %.3f s; view with Perfetto)",
             path, n, t4 - t3)


def write_chrome_trace(result, path: str) -> int:
    """Write a stopped capture's events (its ``kineto_results``) to
    ``path`` as a Chrome trace, one event a line, from Python: Kineto's
    own ``save`` writes the whole file in one call that holds the
    interpreter (~4 s for one second of llama3-8b decode on an H100),
    which would stall the serving threads; this loop lets them run
    between events. Times are µs from the capture's start. Card events
    go under the device's pid and their stream's tid, with ``cat``
    "kernel", "gpu_memcpy" or "gpu_memset"; host events under the
    process and thread, ``cat`` "host". Returns the event count."""
    from torch.autograd import DeviceType

    base = result.trace_start_ns()
    pids = {}
    n = 0
    with open(path, "w") as f:
        f.write('{"traceEvents": [\n')
        for e in result.events():
            name = e.name()
            pid = e.device_index()
            if e.device_type() == DeviceType.CUDA:
                cat = ("gpu_memcpy" if name.startswith("Memcpy") else
                       "gpu_memset" if name.startswith("Memset") else
                       "kernel")
                pids.setdefault(pid, f"cuda:{pid}")
            else:
                cat = "host"
                pids.setdefault(pid, "host")
            f.write(("," if n else "") + json.dumps({
                "ph": "X", "cat": cat, "name": name, "pid": pid,
                "tid": e.device_resource_id(),
                "ts": (e.start_ns() - base) / 1e3,
                "dur": e.duration_ns() / 1e3,
                "args": {"correlation": e.correlation_id()}}) + "\n")
            n += 1
        for i, (pid, pname) in enumerate(pids.items()):
            f.write(("," if n or i else "") + json.dumps({
                "ph": "M", "name": "process_name", "pid": pid,
                "args": {"name": pname}}) + "\n")
        f.write("]}\n")
    return n


@contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region inside a device trace
    (``torch.profiler.record_function``)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


@dataclass
class Span:
    name: str
    start: float      # perf_counter seconds
    duration: float
    meta: Optional[Dict] = None


class SpanRecorder:
    """Bounded in-memory span ring for control-plane profiling."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self._spans: deque = deque(maxlen=capacity)  # O(1) bounded append
        self._mu = threading.Lock()

    @contextmanager
    def span(self, name: str, **meta) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, t0, time.perf_counter() - t0,
                        meta or None)

    def record(self, name: str, start: float, duration: float,
               meta: Optional[Dict] = None) -> None:
        with self._mu:
            self._spans.append(Span(name, start, duration, meta))

    def snapshot(self) -> List[Span]:
        with self._mu:
            return list(self._spans)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name count/total/mean/max in milliseconds."""
        out: Dict[str, Dict[str, float]] = {}
        for s in self.snapshot():
            d = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                        "max_ms": 0.0})
            d["count"] += 1
            d["total_ms"] += s.duration * 1e3
            d["max_ms"] = max(d["max_ms"], s.duration * 1e3)
        for d in out.values():
            d["mean_ms"] = d["total_ms"] / max(1, d["count"])
            d["total_ms"] = round(d["total_ms"], 3)
            d["mean_ms"] = round(d["mean_ms"], 3)
            d["max_ms"] = round(d["max_ms"], 3)
        return out

    def dump_chrome_trace(self, path: str) -> None:
        """Write chrome://tracing / perfetto-compatible trace events."""
        events = [
            {"name": s.name, "ph": "X", "ts": s.start * 1e6,
             "dur": s.duration * 1e6, "pid": 0, "tid": 0,
             "args": s.meta or {}}
            for s in self.snapshot()
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        log.info("wrote %d spans to %s", len(events), path)

    def clear(self) -> None:
        with self._mu:
            self._spans.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._spans)
