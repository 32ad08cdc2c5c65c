"""Device telemetry plane (the port's copy of
``llmq_tpu/observability/device.py``, on the card).

The flight recorder makes *requests* legible; this module makes the
*card* legible while serving:

- **Step-time decomposition** — every decode/mixed chunk is split into
  host dispatch (batch assembly + the chunk's launches), device execute
  (dispatch → the chunk's completion event) and token readback (the
  read of the pinned host buffer), exported as
  ``step_{dispatch,device,readback}_ms`` histograms. A chunk's device
  span ends at its completion event, which is recorded behind the
  device-to-host copy of its tokens, so the copy is part of the device
  leg and the readback leg is a read of host memory (about 0 ms).
- **Live MFU / decode tok/s** — FLOPs math over the trailing-window
  decode rate, against the card's peak from :data:`PEAK_BF16_FLOPS`.
- **HBM accounting** — weights / KV-pool / graph-pool footprints, pool
  occupancy/fragmentation, free headroom (``torch.cuda.mem_get_info``).
- **Compile visibility** — per-program CUDA-graph capture seconds and a
  warmup-progress gauge (the port has no program cache: every capture
  counts as a miss).
- **On-demand profiling** — a single-flight ``torch.profiler`` capture
  behind ``POST /api/v1/admin/profile`` (concurrent captures 409).

One :class:`DeviceTelemetry` per engine name (process-singleton map,
like ``metrics.get_metrics``): the engine, its executor and the API
server all read/write the same live registry. Hot-path writes
(``note_step``) are a few dict/deque updates; every histogram observe
waits for the scrape (``flush``). Nothing here synchronizes the card.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger("llmq_tpu_torch.observability.device")

# -- FLOPs / bandwidth / RTT math -----------------------------------------------

#: device-name substring → peak dense bf16 FLOP/s (NVIDIA's figure for
#: the H100 SXM, the one the kernel bounds in PERF.md use).
PEAK_BF16_FLOPS = {"h100": 989e12}

#: An unknown device name is held to the H100 row.
_DEFAULT_PEAK = 989e12


def peak_flops(device_kind: str, quant: str = "") -> float:
    """Peak FLOP/s for a device name; int8 weights double the rate (the
    JAX package's rule)."""
    kl = (device_kind or "").lower()
    peak = _DEFAULT_PEAK
    for k, v in PEAK_BF16_FLOPS.items():
        if k in kl:
            peak = v
            break
    if quant == "int8":
        peak *= 2
    return peak


def decode_mfu(tokens_per_s: float, n_params: int, device_kind: str,
               quant: str = "", n_chips: int = 1) -> float:
    """Decode-phase model FLOPs utilization as a FRACTION: each token
    costs ~2·n_params FLOPs (the dense matmuls; attention is negligible
    at serving context lengths). ``n_chips`` scales the denominator to
    the serving devices' aggregate peak."""
    if tokens_per_s <= 0 or n_params <= 0:
        return 0.0
    return (tokens_per_s * 2.0 * n_params
            / (peak_flops(device_kind, quant) * max(1, int(n_chips))))


#: device-name substring → peak HBM bandwidth (bytes/s): the H100 SXM's
#: HBM3. Decode attention and the weight stream are bandwidth-bound, so
#: this is reported next to MFU.
PEAK_HBM_BYTES = {"h100": 3.35e12}

_DEFAULT_PEAK_HBM = 3.35e12


def peak_hbm_bandwidth(device_kind: str) -> float:
    """Peak HBM bytes/s for a device name (the H100 row when unknown,
    matching :func:`peak_flops`)."""
    kl = (device_kind or "").lower()
    for k, v in PEAK_HBM_BYTES.items():
        if k in kl:
            return v
    return _DEFAULT_PEAK_HBM


def decode_hbm_bw_util(tokens_per_s: float, batch: int,
                       weight_bytes: int, kv_bytes_per_token: int,
                       mean_context: float, device_kind: str,
                       n_chips: int = 1, dp: int = 1) -> float:
    """Achieved HBM-bandwidth utilization of the decode loop as a
    FRACTION: each decode STEP streams the weights once for the whole
    batch plus each row's live KV window (≈ mean_context tokens), and
    steps/s = tokens_per_s / batch. A lower bound (activations, page
    padding and the KV writeback are excluded). ``n_chips`` scales the
    peak like :func:`decode_mfu`; ``dp`` scales the weight traffic
    (each data-parallel replica streams its own copy)."""
    if tokens_per_s <= 0 or batch <= 0:
        return 0.0
    steps_per_s = tokens_per_s / batch
    bytes_per_step = (weight_bytes * max(1, int(dp))
                      + batch * kv_bytes_per_token * max(0.0, mean_context))
    return (steps_per_s * bytes_per_step
            / (peak_hbm_bandwidth(device_kind) * max(1, int(n_chips))))


def measure_rtt(device, samples: int = 5) -> float:
    """Host↔device round-trip floor in ms: the median of ``samples``
    tiny synchronous round trips (one small op on ``device`` and its
    ``.item()``). Called once after warmup, never inside a graph
    capture."""
    import torch

    x = torch.zeros(8, dtype=torch.int32, device=device)
    (x + 1)[0].item()     # first use (allocation, kernel) untimed
    rtts = []
    for _ in range(max(1, samples)):
        t0 = time.perf_counter()
        (x + 1)[0].item()
        rtts.append(time.perf_counter() - t0)
    return sorted(rtts)[len(rtts) // 2] * 1e3


# -- per-engine telemetry ------------------------------------------------------


class _StepStat:
    """Running count/sum/max/last for one step component (ms)."""

    __slots__ = ("count", "total_ms", "max_ms", "last_ms")

    def __init__(self) -> None:
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        self.last_ms = 0.0

    def add(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        self.last_ms = ms
        if ms > self.max_ms:
            self.max_ms = ms

    def to_dict(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "total_ms": round(self.total_ms, 3),
            "mean_ms": round(self.total_ms / self.count, 3)
            if self.count else 0.0,
            "max_ms": round(self.max_ms, 3),
            "last_ms": round(self.last_ms, 3),
        }


class DeviceTelemetry:
    """Live device-plane state for one engine name.

    Writers: the engine's scheduling thread and its fetch lane
    (``note_step``, ``timed_fetch``), the executor's warmup and graph
    captures (``note_compile``/``note_warmup``). Readers: the /metrics
    scrape (``flush``) and ``get_stats`` snapshots. A small lock guards
    the cross-thread aggregates; the metric families are thread-safe."""

    #: Trailing window for the live decode-rate gauge.
    RATE_WINDOW_S = 30.0

    def __init__(self, name: str, *, metrics: bool = True) -> None:
        self.name = name
        #: When False, ``note_step`` skips the metric observes but
        #: keeps the host-side aggregates (``get_stats`` still reads
        #: them with metrics off).
        self.metrics_enabled = metrics
        self._mu = threading.Lock()
        self._dispatch = _StepStat()
        self._device = _StepStat()
        self._readback = _StepStat()
        self._overlapped = _StepStat()
        #: High-water mark (perf_counter) of device time already
        #: attributed to some chunk — the serial-attribution state that
        #: keeps ``step_device_ms`` truthful under the async pipeline:
        #: a chunk's device span is only credited where it extends past
        #: what earlier chunks were already charged for; the rest is
        #: ``overlapped_ms`` (see ``timed_fetch``).
        self._accounted_until = 0.0
        self._tokens_total = 0
        self._tok_window: deque = deque()   # (ts, n_tokens)
        # Model identity for the MFU estimator (executor fills these).
        self.n_params = 0
        self.device_kind = ""
        self.quant = ""
        self.n_chips = 1
        self.rtt_ms: Optional[float] = None
        # Compile surface (the executor's graph captures fill these).
        self._compile: Dict[str, Dict[str, Any]] = {}
        self._cache_hits = 0
        self._cache_misses = 0
        self._warmup_done = 0
        self._warmup_total = 0
        self.warmup_s: Optional[float] = None
        #: Callback returning the HBM snapshot dict (engine registers
        #: it; see InferenceEngine._hbm_snapshot).
        self._hbm_provider: Optional[Callable[[], Dict]] = None
        #: Cached labeled histogram children: ``.labels()`` revalidates
        #: on every call (~3 µs × 3 families) — cached, observing the
        #: whole backlog at scrape time stays cheap.
        self._step_hists: Optional[tuple] = None
        #: Step observations awaiting histogram observe — drained by
        #: ``flush`` at scrape time, the same deferred-observation
        #: design as the recorder's stage histograms: metric costs
        #: stay off the decode hot path entirely.
        #: Bounded; under scrape outage the newest observations win.
        self._pending_steps: deque = deque(maxlen=8192)
        #: Speculation accumulators (``note_spec``, once a reconciled
        #: verify window): draft tokens proposed and accepted, tokens
        #: committed through windows, and the fetches that carried them
        #: (committed / fetches is the readback cadence).
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_committed = 0
        self._spec_fetches = 0

    # -- wiring ---------------------------------------------------------------

    def configure_model(self, *, n_params: int = 0, device_kind: str = "",
                        quant: str = "", n_chips: int = 1) -> None:
        self.n_params = int(n_params)
        self.device_kind = device_kind
        self.quant = quant
        self.n_chips = max(1, int(n_chips))

    def set_hbm_provider(self, fn: Optional[Callable[[], Dict]]) -> None:
        self._hbm_provider = fn

    def set_rtt(self, rtt_ms: float) -> None:
        self.rtt_ms = float(rtt_ms)
        if self.metrics_enabled:
            self._metrics().host_device_rtt_ms.labels(self.name).set(
                self.rtt_ms)

    @staticmethod
    def _metrics():
        from llmq_tpu_torch.metrics.registry import get_metrics
        return get_metrics()

    # -- step decomposition (hot path) ----------------------------------------

    def note_step(self, dispatch_s: float, device_s: float,
                  readback_s: float, tokens: int,
                  overlapped_s: float = 0.0) -> None:
        """One decode/mixed chunk's timing split. Called once per chunk
        from the engine thread — a few locked adds, no metric observe.
        ``overlapped_s`` is the part of the chunk's
        device span that overlapped other accounted work (pipelined
        decode) — kept OUT of ``step_device_ms`` so summed device time
        never exceeds wall-clock."""
        d_ms = dispatch_s * 1e3
        x_ms = device_s * 1e3
        r_ms = readback_s * 1e3
        o_ms = overlapped_s * 1e3
        now = time.time()
        with self._mu:
            self._dispatch.add(d_ms)
            self._device.add(x_ms)
            self._readback.add(r_ms)
            self._overlapped.add(o_ms)
            if tokens > 0:
                self._tokens_total += tokens
                self._tok_window.append((now, tokens))
            # Prune opportunistically so the deque stays bounded even
            # if nothing ever flushes.
            horizon = now - self.RATE_WINDOW_S
            while self._tok_window and self._tok_window[0][0] < horizon:
                self._tok_window.popleft()
        if self.metrics_enabled:
            self._pending_steps.append((d_ms, x_ms, r_ms, o_ms))

    def note_spec(self, proposed: int, accepted: int,
                  committed: int) -> None:
        """One reconciled verify window: its draft tokens proposed and
        accepted and the tokens it committed; each call is one fetch.
        Engine thread only; plain adds under the telemetry lock."""
        with self._mu:
            self._spec_proposed += int(proposed)
            self._spec_accepted += int(accepted)
            self._spec_committed += int(committed)
            self._spec_fetches += 1

    def timed_fetch(self, handle, dispatched_at: Optional[float] = None):
        """Fetch a chunk handle's tokens with the device-execute /
        readback split: ``handle.wait_ready()`` waits on the chunk's own
        completion event (no stream-wide or device-wide wait) and bounds
        device execution; the ``fetch()`` that follows reads the pinned
        host buffer. The event is recorded behind the device-to-host
        copy of the tokens, so the copy falls in the device leg and the
        readback leg is ~0. Returns ``(result, device_s, readback_s,
        overlapped_s)``.

        Overlap attribution: with two chunks in flight, chunk N+1's wait
        would include (or hide) time already attributed to chunk N. With
        ``dispatched_at`` (perf_counter at dispatch), the chunk's device
        span is ``[dispatched_at, ready]``; only the part past the
        high-water mark of already-attributed time is NOVEL and charged
        to ``device_s`` (further capped by the measured wait, so
        post-ready idle between fetches is never billed as device time);
        the remainder of the span is returned as ``overlapped_s`` — the
        wall-clock the pipeline actually hid. Without ``dispatched_at``
        the accounting degenerates to the serial split exactly
        (device_s = wait, overlapped_s = 0)."""
        t0 = time.perf_counter()
        wait = getattr(handle, "wait_ready", None)
        if wait is not None:
            wait()
        t1 = time.perf_counter()
        res = handle.fetch()
        t2 = time.perf_counter()
        wait_s = t1 - t0
        span_start = dispatched_at if dispatched_at else t0
        with self._mu:
            acc = self._accounted_until
            span = max(0.0, t1 - span_start)
            novel = max(0.0, t1 - max(span_start, acc))
            device_s = min(novel, wait_s)
            overlapped_s = max(0.0, span - device_s)
            if t1 > acc:
                self._accounted_until = t1
        return res, device_s, t2 - t1, overlapped_s

    # -- decode rate / MFU ----------------------------------------------------

    def tokens_per_s(self) -> float:
        """Decode rate over the trailing window (0 when idle)."""
        now = time.time()
        horizon = now - self.RATE_WINDOW_S
        with self._mu:
            while self._tok_window and self._tok_window[0][0] < horizon:
                self._tok_window.popleft()
            if not self._tok_window:
                return 0.0
            total = sum(n for _, n in self._tok_window)
            span = now - self._tok_window[0][0]
        if span < 0.05:
            span = 0.05   # burst floor: avoid a div-by-~0 rate spike
        return total / span

    def mfu(self) -> float:
        return decode_mfu(self.tokens_per_s(), self.n_params,
                          self.device_kind, self.quant, self.n_chips)

    def _overlap_ratio_locked(self) -> float:
        """Single implementation of overlapped/(overlapped+device) —
        the /metrics gauge and the stats snapshot must never drift
        apart. Caller holds ``self._mu``."""
        o = self._overlapped.total_ms
        d = self._device.total_ms
        return o / (o + d) if (o + d) > 0 else 0.0

    def overlap_ratio(self) -> float:
        """Fraction of total in-flight device-span time that overlapped
        other accounted work — 0 on a fully serial engine, ~0.5 with a
        saturated depth-2 pipeline. The ``pipeline_overlap_ratio``
        gauge and ``get_stats()["pipeline"]`` read this."""
        with self._mu:
            return self._overlap_ratio_locked()

    # -- compile / warmup -----------------------------------------------------

    def note_compile(self, program: str, seconds: float,
                     cache_hit: bool) -> None:
        """One program's CUDA-graph capture (``cache_hit`` is the JAX
        package's export-cache load; the port has no program cache, so
        it passes False). ``program`` is a captured program's name
        (decode_step_fused, prefill_b<N>, mixed_step0_fused…) — a
        config-bounded label set."""
        with self._mu:
            self._compile[program] = {
                "seconds": round(seconds, 3),
                "source": "export_cache" if cache_hit else "compiled",
            }
            if cache_hit:
                self._cache_hits += 1
            else:
                self._cache_misses += 1
        if self.metrics_enabled:
            m = self._metrics()
            if cache_hit:
                m.compile_cache_hits.labels(self.name).inc()
            else:
                m.compile_cache_misses.labels(self.name).inc()
            m.compile_seconds.labels(self.name, program).observe(seconds)

    def note_warmup(self, done: int, total: int) -> None:
        with self._mu:
            self._warmup_done = done
            self._warmup_total = total
        if self.metrics_enabled and total > 0:
            self._metrics().warmup_progress.labels(self.name).set(
                done / total)

    def note_warmup_complete(self, seconds: float) -> None:
        self.warmup_s = round(seconds, 2)
        with self._mu:
            if self._warmup_total == 0:
                self._warmup_total = self._warmup_done = 1
            else:
                self._warmup_done = self._warmup_total
        if self.metrics_enabled:
            self._metrics().warmup_progress.labels(self.name).set(1.0)

    # -- scrape-time flush / snapshot -----------------------------------------

    def flush(self) -> None:
        """Drain the pending step observations into the histograms and
        set the live gauges (rate, MFU, HBM) — called from the /metrics
        scrape path, keeping all metric costs off the decode hot
        path (same design as recorder.flush_metrics)."""
        if not self.metrics_enabled:
            return
        m = self._metrics()
        hists = self._step_hists
        if hists is None:
            hists = (m.step_dispatch_ms.labels(self.name),
                     m.step_device_ms.labels(self.name),
                     m.step_readback_ms.labels(self.name),
                     m.step_overlapped_ms.labels(self.name))
            self._step_hists = hists
        while True:
            try:
                d_ms, x_ms, r_ms, o_ms = self._pending_steps.popleft()
            except IndexError:
                break
            hists[0].observe(d_ms)
            hists[1].observe(x_ms)
            hists[2].observe(r_ms)
            hists[3].observe(o_ms)
        m.pipeline_overlap_ratio.labels(self.name).set(
            self.overlap_ratio())
        rate = self.tokens_per_s()
        m.decode_tokens_per_s.labels(self.name).set(rate)
        m.mfu_pct.labels(self.name).set(
            decode_mfu(rate, self.n_params, self.device_kind,
                       self.quant, self.n_chips) * 100.0)
        hbm = self._hbm()
        if hbm is None:
            return
        m.kv_pool_occupancy.labels(self.name).set(
            hbm.get("kv_pool_occupancy", 0.0))
        m.kv_pool_fragmentation.labels(self.name).set(
            hbm.get("kv_pool_fragmentation", 0.0))
        for chip in hbm.get("chips", ()):
            cid = str(chip.get("chip", "0"))
            m.hbm_weights_bytes.labels(self.name, cid).set(
                chip.get("weights_bytes", 0))
            m.hbm_kv_pool_bytes.labels(self.name, cid).set(
                chip.get("kv_pool_bytes", 0))
            if chip.get("free_bytes") is not None:
                m.hbm_free_bytes.labels(self.name, cid).set(
                    chip["free_bytes"])
            if chip.get("limit_bytes") is not None:
                m.hbm_limit_bytes.labels(self.name, cid).set(
                    chip["limit_bytes"])

    def _hbm(self) -> Optional[Dict]:
        if self._hbm_provider is None:
            return None
        try:
            return self._hbm_provider()
        except Exception:  # noqa: BLE001 — telemetry must not fail scrapes
            log.exception("hbm provider failed for %s", self.name)
            return None

    def snapshot(self) -> Dict[str, Any]:
        """The ``device`` block of ``GET /api/v1/engine/stats``."""
        rate = self.tokens_per_s()
        with self._mu:
            out: Dict[str, Any] = {
                "steps": {
                    "count": self._dispatch.count,
                    "dispatch_ms": self._dispatch.to_dict(),
                    "device_ms": self._device.to_dict(),
                    "readback_ms": self._readback.to_dict(),
                    "overlapped_ms": self._overlapped.to_dict(),
                },
                "pipeline_overlap_ratio": round(
                    self._overlap_ratio_locked(), 4),
                "tokens_total": self._tokens_total,
                "decode_tokens_per_s": round(rate, 1),
                "mfu_pct": round(
                    decode_mfu(rate, self.n_params, self.device_kind,
                               self.quant, self.n_chips) * 100.0, 3),
                "model": {
                    "n_params": self.n_params,
                    "device_kind": self.device_kind,
                    "quant": self.quant or "bf16",
                    "n_chips": self.n_chips,
                },
                "host_device_rtt_ms": (round(self.rtt_ms, 2)
                                       if self.rtt_ms is not None
                                       else None),
                "compile": {
                    "programs": dict(self._compile),
                    "cache_hits": self._cache_hits,
                    "cache_misses": self._cache_misses,
                    "warmup_done": self._warmup_done,
                    "warmup_total": self._warmup_total,
                    "warmup_s": self.warmup_s,
                },
            }
            if self._spec_fetches:
                out["speculation"] = {
                    "proposed": self._spec_proposed,
                    "accepted": self._spec_accepted,
                    "acceptance_rate": round(
                        self._spec_accepted
                        / max(1, self._spec_proposed), 4),
                    "committed": self._spec_committed,
                    "fetches": self._spec_fetches,
                    "readback_cadence": round(
                        self._spec_committed / self._spec_fetches, 3),
                }
        hbm = self._hbm()
        if hbm is not None:
            out["hbm"] = hbm
        return out


# -- process registry ----------------------------------------------------------

_TELEMETRY_LOCK = threading.Lock()
_TELEMETRY: Dict[str, DeviceTelemetry] = {}


def get_device_telemetry(name: str = "engine0",
                         metrics: Optional[bool] = None) -> DeviceTelemetry:
    """Per-engine-name singleton (the engine and its executor address
    the same instance). ``metrics`` updates the metrics on/off flag when
    given."""
    with _TELEMETRY_LOCK:
        t = _TELEMETRY.get(name)
        if t is None:
            t = DeviceTelemetry(name, metrics=metrics
                                if metrics is not None else True)
            _TELEMETRY[name] = t
        elif metrics is not None:
            t.metrics_enabled = metrics
        return t


def flush_all() -> None:
    """Refresh every engine's live gauges — called from the /metrics
    exposition path."""
    with _TELEMETRY_LOCK:
        ts = list(_TELEMETRY.values())
    for t in ts:
        t.flush()


def reset_telemetry() -> None:
    """Drop all instances (tests only — metric families persist)."""
    with _TELEMETRY_LOCK:
        _TELEMETRY.clear()


# -- on-demand profiling (single-flight) ---------------------------------------


class ProfileInProgress(RuntimeError):
    """A profiler capture is already running — concurrent captures would
    corrupt each other's sessions (the profiler is a process-wide
    singleton), so the API answers 409."""


_PROFILE_LOCK = threading.Lock()
_PROFILE_ACTIVE: Optional[Dict[str, Any]] = None
_PROFILE_LAST: Optional[Dict[str, Any]] = None

MAX_PROFILE_S = 60.0


def start_profile(*, duration_s: float = 1.0, label: str = "ondemand",
                  base_dir: Optional[str] = None, cuda: bool = False,
                  quiesce=None) -> Dict[str, Any]:
    """Kick off a BOUNDED background ``torch.profiler`` capture through
    :func:`utils.profiling.trace` (``cuda``: the card's activity too;
    ``quiesce``: held around the profiler's start and stop) and return
    its descriptor immediately; the Chrome trace lands at
    ``<path>/trace.json``. The finished descriptor (``profile_status``'s
    ``last``) adds the seconds the engine was held at the profiler's
    start and stop (``start_s``, ``stop_s``), the trace write's seconds
    (``write_s``, the engine running) and its event count
    (``events``). The stop holds the interpreter while it turns the
    capture's events into a result (on an H100 ~7.8 s for one second of
    llama3-8b decode), so a capture stalls serving. Raises :class:`ProfileInProgress` when a
    capture is already live (the endpoint's 409). The capture is clamped
    to ``MAX_PROFILE_S`` — an unbounded trace would fill the disk on a
    busy server."""
    global _PROFILE_ACTIVE
    duration_s = min(max(float(duration_s), 0.01), MAX_PROFILE_S)
    with _PROFILE_LOCK:
        if _PROFILE_ACTIVE is not None:
            raise ProfileInProgress(
                f"profile capture already running "
                f"(started {_PROFILE_ACTIVE['started']:.0f}, "
                f"path {_PROFILE_ACTIVE['path']})")
        out_dir = base_dir or tempfile.mkdtemp(prefix="llmq-profile-")
        info = {
            "label": label,
            "path": os.path.join(out_dir, label),
            "duration_s": duration_s,
            "started": time.time(),
        }
        _PROFILE_ACTIVE = info

    def run() -> None:
        global _PROFILE_ACTIVE, _PROFILE_LAST
        from llmq_tpu_torch.utils.profiling import trace
        stats: Dict[str, Any] = {}
        try:
            with trace(label, dir=out_dir, cuda=cuda, quiesce=quiesce,
                       stats=stats):
                time.sleep(duration_s)
        except Exception:  # noqa: BLE001 — a failed capture must not wedge
            log.exception("profile capture failed (%s)", info["path"])
        finally:
            with _PROFILE_LOCK:
                _PROFILE_LAST = dict(info, **stats)
                _PROFILE_LAST["finished"] = time.time()
                _PROFILE_ACTIVE = None

    threading.Thread(target=run, name="llmq-profile", daemon=True).start()
    return dict(info)


def profile_status() -> Dict[str, Any]:
    """Current capture state for the admin route: the active capture
    descriptor (if any) plus the last finished one."""
    with _PROFILE_LOCK:
        return {
            "active": _PROFILE_ACTIVE is not None,
            "capture": dict(_PROFILE_ACTIVE) if _PROFILE_ACTIVE else None,
            "last": dict(_PROFILE_LAST) if _PROFILE_LAST else None,
        }


__all__: List[str] = [
    "DeviceTelemetry", "ProfileInProgress", "decode_mfu", "flush_all",
    "get_device_telemetry", "measure_rtt", "peak_flops",
    "profile_status", "reset_telemetry", "start_profile",
]
