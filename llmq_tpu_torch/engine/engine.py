"""Continuous-batching inference engine (the port's counterpart of
``llmq_tpu/engine/engine.py``, trimmed to the serving main path).

Messages drained from the priority queues become generation requests;
the engine packs them into a fixed set of decode slots and advances every
active sequence by a chunk of tokens per device program.

- **Fixed batch geometry.** One (batch_size, max_pages) decode geometry;
  admission, finish and preemption only permute which sequence holds
  which slot.
- **Strict-priority admission with step-boundary preemption.** Pending
  requests are served in (priority, arrival) order, and a pending
  request older than its tier's ``max_wait_time`` is promoted one tier
  per elapsed multiple. With no free slot, an arriving request preempts
  the least urgent running sequence iff strictly more urgent; the victim
  keeps its KV pages and resumes without re-prefill. Preemption waits
  while a chunk is in flight (its rows are still decoding on the device).
- **Pool pressure sheds in order of damage** (``_alloc_pages``): zero-ref
  radix leaves, idle conversation pins (LRU), pages parked with less
  urgent pending sequences, then — with no chunk in flight — a strictly
  less urgent runner (mid-prefill ones included) is preempted with its
  pages released. A released sequence rebuilds when next admitted: it
  re-prefills its whole written context and resumes decoding from its
  newest token. A row that cannot get decode pages is requeued the same
  way, never failed.
- **Paged KV with conversation pinning.** A finished conversation keeps
  its pages pinned; the next turn adopts them and prefills only its new
  tokens on top (continuation prefill). Pins end on the pin TTL, on
  delete (the conversation service's eviction, once attached), or under
  pool pressure (LRU), which frees their pages.
- **Radix prefix cache** (``prefix_cache``). Finished sequences publish
  their full-page KV blocks into a radix tree; a from-scratch admission
  adopts the longest cached page-aligned prefix by reference count (a
  shared system prompt, a conversation whose pin was reclaimed) and
  prefills only the rest, into pages of its own. Zero-ref leaves are the
  first thing evicted under pool pressure.
- **Incremental prefill in admission waves.** Every admitted sequence
  runs one prefill bucket per engine step, so a long prompt never stalls
  decoding rows for its whole length. The step's chunks go out as waves
  of up to ``prefill_batch`` prompts, one program each
  (``prefill_multi_async``; a trailing single chunk takes the one-row
  program), without a host wait; the first tokens of the final chunks
  are fetched later, all in one gather (``_resolve_prefills``).
- **Token-budget mixed batching** (``mixed_batch``). While decode rows
  are active, pending prefill runs as budgeted slices inside the first
  step of the decode chunk (executor ``mixed_chunk_start``), so a decode
  row waits for at most ``prefill_token_budget`` prefill tokens a chunk.
- **Async decode pipeline** (``async_pipeline``). Chunks are dispatched
  without a host wait (``decode_chunk_start`` / ``mixed_chunk_start``)
  and reconciled one step later. With no scheduling work waiting, the
  engine keeps up to ``depth`` chunks in flight, each dispatched from the
  previous one's device-carried end state before its tokens are fetched;
  a sequence whose final prefill chunk was dispatched joins the next
  chunk device to device (same-step join). Fetches run on two lanes
  (chunk, resolve) while the engine thread keeps admitting arrivals, and
  token callbacks and request completions run on a completion pool. The
  off-switch keeps depth 2 with every completion inline, as in the JAX
  package.

- **Crash recovery** (``recover_after_crash``, driven by
  ``engine/supervisor.py``): an ``Exception`` from ``step`` is logged and
  the loop goes on; a ``BaseException`` kills the loop thread, and the
  supervisor fails every unfinished request over to the worker retry
  path before it starts a fresh loop.
- **Cache-aware admission** (``prefill_estimate``): a waiting REALTIME
  request whose context is expected mostly cached halves the decode
  chunk cap; every completed prefill feeds a learned prefill rate
  (``prefill_tps_ewma``) and ``on_prefill_observed`` (the resource
  scheduler's estimator, bound by ``serve``).
- **Metrics** (``enable_metrics``): preemptions, prefix-cache hits,
  decode steps, generated tokens, mixed-step occupancy, prefill stalls
  and the KV-pool gauges, in the families of ``metrics/registry.py``.
- **Observability** (``observability/``, the process-wide planes):
  host spans of every dispatch and fetch (``_prof``); each chunk's
  dispatch / device / readback split (``timed_fetch`` on the fetch lane,
  ``note_step``) and the HBM snapshot of the device telemetry; each
  chunk's device time charged pro-rata to its rows (usage ledger) and to
  their decode spans (critical path); KV page-seconds; waste on rebuild
  re-prefill; each finished request's lifecycle marks into the flight
  recorder, with its usage in ``handle.usage``.

Left to later work (``ROADMAP.md``): tenancy, tiering and speculation.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import queue
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from llmq_tpu_torch import observability
from llmq_tpu_torch.core.types import Message, Priority
from llmq_tpu_torch.engine.executor import Executor
from llmq_tpu_torch.engine.kv_allocator import PageAllocator
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.metrics.registry import get_metrics
from llmq_tpu_torch.observability.critical_path import (
    get_critical_path, note_first_token as boot_note_first_token)
from llmq_tpu_torch.observability.device import get_device_telemetry
from llmq_tpu_torch.observability.usage import (DEFAULT_TENANT, RequestUsage,
                                                get_usage_ledger,
                                                sanitize_tenant)
from llmq_tpu_torch.prefixcache import PrefixCache
from llmq_tpu_torch.utils.profiling import SpanRecorder

log = logging.getLogger("llmq_tpu_torch.engine")

#: Target admission latency of a pending REALTIME request: the decode
#: chunk is capped to about this many milliseconds of the executor's
#: measured steps.
REALTIME_ADMISSION_MS = 50.0


def _pack_prefill_slices(cands, S: int, T: int,
                         budget: int) -> List[Tuple["_Sequence", List[int]]]:
    """Pack prefill candidates (most urgent first) into at most S slices
    of at most T tokens each, at most ``budget`` tokens in all. Returns
    ``[(seq, token_ids)]``."""
    pf_plan = []
    packed = 0
    for seq in cands:
        if packed >= budget or len(pf_plan) >= S:
            break
        sl = seq.todo_ids[:min(T, budget - packed)]
        if sl:
            pf_plan.append((seq, sl))
            packed += len(sl)
    return pf_plan


#: Step time assumed while the executor has timed no step (the JAX
#: engine's).
DEFAULT_STEP_MS = 4.0


def realtime_admission_cap(step_ms: Optional[float]) -> int:
    """Decode steps a waiting REALTIME request may sit behind: about
    ``REALTIME_ADMISSION_MS`` of steps, 2 to 16, at DEFAULT_STEP_MS a
    step while no step has been timed."""
    step_ms = step_ms or DEFAULT_STEP_MS
    return max(2, min(16, int(REALTIME_ADMISSION_MS / step_ms)))


@dataclass
class GenRequest:
    """One generation request (usable without the queue plane)."""

    id: str
    prompt: str
    priority: Priority = Priority.NORMAL
    conversation_id: str = ""
    history_text: str = ""       # full-history fallback on conversation KV miss
    max_new_tokens: int = 0      # 0 → engine default
    temperature: float = 0.0
    #: Billing identity for the usage plane: who this request's
    #: hardware consumption is attributed to.
    tenant_id: str = DEFAULT_TENANT

    @classmethod
    def from_message(cls, msg: Message) -> "GenRequest":
        md = msg.metadata or {}
        return cls(
            id=msg.id,
            prompt=msg.content,
            priority=msg.priority,
            conversation_id=msg.conversation_id,
            history_text=str(md.get("history_text", "")),
            max_new_tokens=int(md.get("max_new_tokens", 0) or 0),
            temperature=float(md.get("temperature", 0.0) or 0.0),
            tenant_id=sanitize_tenant(getattr(msg, "tenant_id", "")),
        )


@dataclass
class GenResult:
    text: str = ""
    tokens: List[int] = field(default_factory=list)
    prompt_tokens: int = 0
    cached_tokens: int = 0       # KV reused (conversation pin or radix match)
    finish_reason: str = ""      # eos | length | cancelled | error
    error: str = ""


class GenHandle:
    """Caller-side future for a submitted request."""

    def __init__(self, request: GenRequest) -> None:
        self.request = request
        self.result: Optional[GenResult] = None
        self.submitted_at = time.perf_counter()
        self.finished_at: Optional[float] = None
        #: perf_counter marks: ``admitted``, ``prefill_start``,
        #: ``prefill_done``, ``first_token`` (first committed token),
        #: ``decode_done`` (with the critical-path plane on).
        self.marks: Dict[str, float] = {}
        #: The usage plane's summary of this request (device_seconds,
        #: waste_seconds and its reason, kv_page_seconds,
        #: saved_prefill_device_seconds, tenant), filled at finish when
        #: the plane is enabled.
        self.usage: Optional[Dict] = None
        self._on_token = None
        self._done = threading.Event()
        self._cancelled = threading.Event()

    def on_token(self, cb) -> None:
        """Stream callback: ``cb(token_id)`` for every committed token, in
        order, a fetched chunk's tokens at once (on a completion thread
        with the async pipeline on, else on the engine thread). It must be
        cheap and must not call back into the engine."""
        self._on_token = cb

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def _finish(self, result: GenResult) -> None:
        if self._done.is_set():
            return                      # first writer wins
        self.result = result
        self.finished_at = time.perf_counter()
        self._done.set()


class _Sequence:
    """Engine-internal state of one admitted request."""

    __slots__ = ("req", "handle", "prompt_ids", "generated", "pages",
                 "block_table", "pos", "cached_len", "last_token", "slot",
                 "prefilled", "order", "adopted", "prefill_ids",
                 "prefill_start", "carry", "written_ids", "rebuild",
                 "todo_ids", "todo_pos", "todo_rebuild", "todo_resume",
                 "eff_prio", "arrival", "first_handle",
                 "prefix_match", "reuse_counted", "mixed_pending",
                 "pending_emit", "pf_tokens_run", "usage", "cp_decode_s")

    def __init__(self, req: GenRequest, handle: GenHandle, order: int,
                 max_pages: int) -> None:
        self.req = req
        self.handle = handle
        self.order = order
        self.prompt_ids: List[int] = []
        self.generated: List[int] = []   # sampled output tokens (no EOS)
        self.pages: List[int] = []
        self.block_table = np.zeros(max_pages, np.int32)
        self.pos = 0              # tokens whose KV is written
        self.cached_len = 0       # prefix reused (conversation or radix)
        self.last_token = 0       # most recent sampled token (next input)
        self.slot: Optional[int] = None
        self.prefilled = False
        self.adopted = False      # conversation cache adoption attempted
        self.prefill_ids: List[int] = []  # what prefill saw (for resume)
        self.prefill_start = 0
        self.carry: List[int] = []        # cache's pending token (_ConvKV)
        #: Token ids whose KV occupies positions [0, pos): what a
        #: page-releasing preemption (or a capacity fold) re-prefills.
        self.written_ids: List[int] = []
        self.rebuild = False      # pages were released; re-prefill written_ids
        #: Incremental prefill: tokens not yet run, next write position,
        #: and the completion context taken at admission (a rebuild
        #: resumes decoding from ``todo_resume`` instead of committing
        #: the re-prefill's sample).
        self.todo_ids: List[int] = []
        self.todo_pos = 0
        self.todo_rebuild = False
        self.todo_resume: Optional[int] = None
        #: The dispatched final prefill chunk's token, not yet fetched
        #: (an executor handle); None otherwise.
        self.first_handle = None
        #: Effective priority: the request's tier, promoted while pending.
        self.eff_prio = int(req.priority)
        self.arrival = 0.0
        #: Active radix match: one allocator ref per matched page (inside
        #: ``pages``) and one lock per matched node, released whenever the
        #: pages leave the sequence.
        self.prefix_match = None
        #: Hit or miss counted for this request (first admission only).
        self.reuse_counted = False
        #: A slice of this sequence rides the in-flight mixed chunk: no
        #: further slice may go out until that chunk is reconciled.
        self.mixed_pending = False
        #: Committed tokens not yet handed to the stream callback (the
        #: completion pool gets one batch a chunk).
        self.pending_emit: List[int] = []
        #: Prefill tokens run for this request (the learned-rate sample).
        self.pf_tokens_run = 0
        #: Usage-plane accumulator, charged by the engine thread with
        #: this sequence's share of every measured chunk; None with the
        #: plane off (every charge point is then one None check).
        self.usage: Optional[RequestUsage] = None
        #: Device+readback seconds attributed to this sequence's decode
        #: rows: the critical path splits its decode span with it.
        self.cp_decode_s = 0.0

    def sort_key(self):
        return (self.eff_prio, self.order)


@dataclass
class _ConvKV:
    """A conversation's KV kept resident between turns."""

    pages: List[int]
    block_table: np.ndarray
    length: int                  # tokens cached
    last_used: float
    #: Token ids backing the cached KV, positions [0, length).
    tokens: List[int] = field(default_factory=list)
    #: On a "length" finish the final sampled token never went through a
    #: decode step, so its KV is absent: the next turn prefills it first.
    pending: Optional[int] = None


class _InflightChunk:
    """A dispatched, not yet reconciled chunk: the executor handle, the
    per-slot sequence snapshot and the budgets it was dispatched with,
    and the fetch lane's completion box (``{ev, out, err}``). Processing
    uses the snapshot: a slot re-assigned after dispatch belongs to a
    sequence that never rode the chunk. ``pf`` (mixed chunks): the
    ``(seq, n_tokens, final)`` slices fused into step 0. ``dispatch_s``:
    the host's assembly and dispatch seconds (the step decomposition's
    dispatch leg); ``dispatched_at``: perf_counter once the chunk was
    queued, where its device span starts (overlap attribution)."""

    __slots__ = ("handle", "seqs", "budgets", "fetch_box", "pf",
                 "dispatch_s", "dispatched_at")

    def __init__(self, handle, seqs, budgets, pf=None,
                 dispatch_s: float = 0.0,
                 dispatched_at: float = 0.0) -> None:
        self.handle = handle
        self.seqs = seqs          # List[Optional[_Sequence]], len B
        self.budgets = budgets    # np.ndarray (B,) int32
        self.fetch_box: Optional[Dict] = None
        self.pf = pf
        self.dispatch_s = dispatch_s
        self.dispatched_at = dispatched_at


class _CompletionPool:
    """Completion threads: token callbacks, detokenization and handle
    completion run here, so the engine thread's only job between
    dispatches is packing the next chunk. A request's jobs always land on
    the same thread (FIFO), so its tokens always precede its finish, at
    any thread count."""

    def __init__(self, workers: int, name: str) -> None:
        self._qs: List[queue.Queue] = [queue.Queue()
                                       for _ in range(max(1, workers))]
        self._threads: List[threading.Thread] = []
        for i, q in enumerate(self._qs):
            t = threading.Thread(target=self._loop, args=(q,),
                                 name=f"completion-{i}-{name}", daemon=True)
            t.start()
            self._threads.append(t)

    def _loop(self, q: queue.Queue) -> None:
        while True:
            fn = q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — a broken consumer must
                # not kill the thread: later requests' jobs still run
                log.exception("completion job failed")

    def submit(self, key: str, fn) -> None:
        self._qs[hash(key) % len(self._qs)].put(fn)

    def drain(self, timeout: float = 10.0) -> bool:
        """True once every job submitted before the call has run."""
        evs = []
        for q in self._qs:
            ev = threading.Event()
            q.put(ev.set)
            evs.append(ev)
        ok = all(ev.wait(timeout) for ev in evs)
        if not ok:
            log.error("completion pool drain timed out after %.1f s", timeout)
        return ok

    def stop(self) -> None:
        for q in self._qs:
            q.put(None)
        for t in self._threads:
            t.join(timeout=5.0)


class _EngineMetrics:
    """The labelled children an engine updates, resolved once when it is
    built (the chunk loop never looks a label set up)."""

    def __init__(self, name: str) -> None:
        m = get_metrics()
        self.decode_steps = m.decode_steps.labels(name)
        self.generated = {p: m.generated_tokens.labels(name, p.tier_name)
                          for p in Priority}
        self.preemptions = {p: m.preemptions.labels(name, p.tier_name)
                            for p in Priority}
        self.prefix_hits = m.prefix_cache_hits.labels(name)
        self.prefix_misses = m.prefix_cache_misses.labels(name)
        self.cached_tokens = m.cached_prefill_tokens.labels(name)
        self.prefix_pages = m.prefix_cache_pages.labels(name)
        self.kv_pages = m.kv_pages_in_use.labels(name)
        self.pinned = m.kv_pinned_conversations.labels(name)
        self.occupancy = m.batch_occupancy.labels(name)
        self.mixed_rows = m.mixed_step_decode_rows.labels(name)
        self.mixed_tokens = m.mixed_step_prefill_tokens.labels(name)
        self.mixed_util = m.mixed_budget_utilization.labels(name)
        self.stall = {path: m.prefill_stall_ms.labels(name, path)
                      for path in ("mixed", "program")}


class InferenceEngine:
    def __init__(self, executor: Executor,
                 tokenizer: Optional[ByteTokenizer] = None, *,
                 name: str = "engine0", max_decode_steps: int = 256,
                 preemption: bool = True, kv_pin_ttl: float = 600.0,
                 tier_max_wait: Optional[Dict[Priority, float]] = None,
                 mixed_batch=None, prefix_cache=None,
                 async_pipeline=None, enable_metrics: bool = True) -> None:
        self.executor = executor
        self.spec = executor.spec
        self.tokenizer = tokenizer or ByteTokenizer()
        self.name = name
        self.max_decode_steps = max_decode_steps
        self.preemption_enabled = preemption
        self.kv_pin_ttl = kv_pin_ttl
        self._now = time.monotonic
        #: Per-tier SLA bound driving pending-request promotion.
        self.tier_max_wait = dict(tier_max_wait or {})
        self.allocator = PageAllocator(self.spec.num_pages,
                                       self.spec.page_size)
        #: Radix prefix cache: a ``PrefixCacheConfig`` (or anything with
        #: its fields). None or disabled: no tree, no shared pages.
        self._prefix_cache: Optional[PrefixCache] = None
        if prefix_cache is not None and getattr(prefix_cache, "enabled",
                                                False):
            self._prefix_cache = PrefixCache(
                self.allocator, self.spec.page_size,
                max_pages=int(getattr(prefix_cache, "max_cached_pages", 0)),
                policy=getattr(prefix_cache, "eviction", "lru"))
        #: Admissions that start from cached KV (a pinned conversation or
        #: a radix match) and from-scratch ones; counted with the cache on.
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.cached_prefill_tokens_total = 0
        #: Step-boundary preemptions (slot handovers and page releases).
        self.preemptions = 0
        #: The families of ``metrics/registry.py`` (None: metrics off).
        self._m: Optional[_EngineMetrics] = (
            _EngineMetrics(name) if enable_metrics else None)
        #: Host spans of this engine's dispatches and fetches.
        self._prof = SpanRecorder()
        #: Device telemetry (observability/device.py), shared by name
        #: with the executor: step decomposition, live tok/s and MFU,
        #: HBM. The HBM provider holds the engine weakly: the registry
        #: lives as long as the process.
        self._telemetry = get_device_telemetry(name,
                                               metrics=enable_metrics)
        eng_ref = weakref.ref(self)

        def hbm_provider():
            eng = eng_ref()
            return eng._hbm_snapshot() if eng is not None else None

        self._hbm_provider = hbm_provider
        self._telemetry.set_hbm_provider(hbm_provider)
        info_fn = getattr(executor, "telemetry_info", None)
        if info_fn is not None and self._telemetry.n_params == 0:
            try:
                self._telemetry.configure_model(**info_fn())
            except Exception:  # noqa: BLE001 — telemetry must not block init
                log.exception("telemetry model info failed for %s", name)
        #: The usage ledger this engine charges (with the plane off every
        #: charge point is one attribute check) and the critical-path
        #: analyzer (off: no extra marks).
        self._usage = get_usage_ledger()
        self._cp = get_critical_path()
        #: Decode-stall attribution: estimated ms the decode rows spent
        #: behind prefill dispatched while they were active.
        self.prefill_stall_events = 0
        self.prefill_stall_ms_total = 0.0
        #: Learned prefill throughput (tokens/s EWMA over completed
        #: admissions).
        self.prefill_tps_ewma: Optional[float] = None
        #: ``fn(tokens, seconds)`` called once per completed prefill (the
        #: resource scheduler's ``observe_prefill``, bound by ``serve``).
        self.on_prefill_observed = None
        #: Token-budget mixed batching: a ``MixedBatchConfig`` (or
        #: anything with its fields). None or disabled keeps the unfused
        #: scheduling exactly.
        self._mixed_cfg = (mixed_batch if mixed_batch is not None
                           and getattr(mixed_batch, "enabled", False)
                           else None)
        self.mixed_steps = 0
        self.mixed_prefill_tokens_total = 0
        #: Async decode pipeline: an ``AsyncPipelineConfig`` (or anything
        #: with its fields). Off: depth 2 (one chunk in flight plus at
        #: most one carried dispatch a step), completions inline.
        self._pipe_cfg = (async_pipeline if async_pipeline is not None
                          and getattr(async_pipeline, "enabled", False)
                          else None)
        self._pipe_depth = (max(1, min(4, int(getattr(
            self._pipe_cfg, "depth", 2)))) if self._pipe_cfg is not None
            else 2)
        #: Completion threads (0: completions inline on the engine thread).
        self._completion_workers = (max(1, min(8, int(getattr(
            self._pipe_cfg, "completion_workers", 1))))
            if self._pipe_cfg is not None else 0)
        self._completion: Optional[_CompletionPool] = None
        #: Dispatched, not yet reconciled chunks, oldest first.
        self._inflight: "deque[_InflightChunk]" = deque()
        #: Chunks dispatched at each pipeline occupancy (the depth after
        #: the dispatch); keys preallocated, so readers on other threads
        #: never see the dict resize.
        self.pipeline_depth_hist: Dict[int, int] = {d: 0 for d in range(1, 5)}
        #: Fetch lanes: lane → (thread, queue); see _offload_fetch.
        self._fetch_lanes: Dict[str, tuple] = {}
        self.steps = 0
        self.tokens_generated_total = 0
        #: Device transfers that took over 5 s (the engine kept admitting
        #: arrivals meanwhile), and their total ms.
        self.stall_events = 0
        self.stall_ms_total = 0.0
        self._slots: List[Optional[_Sequence]] = [None] * self.spec.batch_size
        self._pending: List = []           # heap of (prio, order, _Sequence)
        self._inbox: List[_Sequence] = []  # submitted, not yet in heap
        self._conv_cache: Dict[str, _ConvKV] = {}
        self._conv_busy: Dict[str, int] = {}    # conv id → holder seq.order
        self._conv_drop_pending: set = set()    # dropped while busy
        #: Token streams of conversations whose pin was reclaimed (TTL or
        #: pool pressure) while the radix tree may still hold their
        #: prefix: a later delete must still prune them. Up to 4 streams
        #: a conversation; filled only with the prefix cache on.
        self._conv_evicted_tokens: Dict[str, List[List[int]]] = {}
        self._order = itertools.count()
        #: The conversation service (attach_conversation_manager): a
        #: finished turn records its prefix handle there.
        self._state_manager = None
        #: Prefix-handle ``tier`` updates queued under ``self._mu`` and
        #: written to the conversation service once it is released (its
        #: lock sits above the engine's).
        self._pending_tier_notes: List[Tuple[str, str]] = []
        self._mu = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: A hold on the loop between two steps (:meth:`paused`).
        self._pause_lock = threading.Lock()
        self._pause_req = threading.Event()
        self._pause_parked = threading.Event()
        self._pause_lift = threading.Event()

    # -- submission ----------------------------------------------------------

    def submit(self, req: GenRequest, *, on_token=None) -> GenHandle:
        handle = GenHandle(req)
        if on_token is not None:
            # Attached before the engine can see the sequence, so no
            # committed token is missed.
            handle.on_token(on_token)
        seq = _Sequence(req, handle, next(self._order),
                        self.spec.max_pages_per_seq)
        if self._usage.enabled:
            seq.usage = RequestUsage()
        with self._mu:
            self._inbox.append(seq)
        self._wake.set()
        return handle

    def generate(self, prompt: str, *, max_new_tokens: int = 0,
                 temperature: float = 0.0, conversation_id: str = "",
                 priority: Priority = Priority.NORMAL,
                 timeout: Optional[float] = 120.0) -> GenResult:
        """Synchronous convenience: submit and wait (the engine loop must
        be running, or be stepped by another thread)."""
        h = self.submit(GenRequest(
            id=f"gen-{next(self._order)}", prompt=prompt,
            priority=priority, conversation_id=conversation_id,
            max_new_tokens=max_new_tokens, temperature=temperature))
        if not h.wait(timeout):
            h.cancel()
            raise TimeoutError("generate timed out")
        assert h.result is not None
        if h.result.finish_reason == "error":
            raise RuntimeError(h.result.error)
        return h.result

    def process_fn(self, ctx, msg: Message) -> None:
        """The queue worker's process function: blocks until the engine
        finishes ``msg`` (honouring the worker's deadline) and fills its
        response and ``metadata["usage"]``."""
        req = GenRequest.from_message(msg)
        handle = self.submit(req)
        timeout = ctx.remaining() if ctx is not None else None
        if not handle.wait(timeout):
            handle.cancel()
            raise TimeoutError(
                f"engine did not finish message {msg.id} before deadline")
        res = handle.result
        assert res is not None
        if res.finish_reason == "error":
            raise RuntimeError(res.error)
        if res.finish_reason == "cancelled":
            raise RuntimeError("request cancelled")
        msg.response = res.text
        usage = {
            "prompt_tokens": res.prompt_tokens,
            "cached_tokens": res.cached_tokens,
            "completion_tokens": len(res.tokens),
            "finish_reason": res.finish_reason,
        }
        if handle.usage is not None:
            # The usage ledger's summary: what this request cost.
            usage.update(handle.usage)
        msg.metadata["usage"] = usage

    # -- conversation service hooks -------------------------------------------

    def attach_conversation_manager(self, state_manager) -> None:
        """Tie KV pin lifetime to the conversation service: touches
        refresh the pin, evictions (delete, idle/TTL cleanup, the
        conversation caps) free the pages."""
        state_manager.on_touch(lambda conv: self.touch_conversation(conv.id))
        state_manager.on_evict(lambda conv: self.drop_conversation(conv.id))
        #: Never called while holding self._mu: the state manager fires
        #: its hooks under its own lock, so the lock order is strictly
        #: state manager → engine.
        self._state_manager = state_manager

    def touch_conversation(self, conv_id: str) -> None:
        with self._mu:
            kv = self._conv_cache.get(conv_id)
            if kv is not None:
                kv.last_used = self._now()

    def cached_conversations(self) -> List[str]:
        with self._mu:
            return list(self._conv_cache)

    def drop_conversation(self, conv_id: str) -> None:
        """Delete a conversation's cached KV: its pin and, with the
        prefix cache on, every stream it published to the radix tree."""
        with self._mu:
            self._drop_conversation_locked(conv_id)
        self._flush_tier_notes()

    def _drop_conversation_locked(self, conv_id: str,
                                  invalidate: bool = True) -> None:
        """``invalidate``: the conversation is deleted, so its content
        must leave the radix tree too; False: only its pin ends (TTL or
        pool pressure), and the tree is what lets its next turn still
        reuse the prefix."""
        streams = list(self._conv_evicted_tokens.pop(conv_id, None) or [])
        kv = self._conv_cache.pop(conv_id, None)
        if kv is not None:
            self.allocator.unpin(conv_id)
            if self._usage.enabled:
                # The pin's page-second meter closes with the pin.
                self._usage.unpin_kv(conv_id)
            if not invalidate and (
                    self._prefix_cache is None
                    or self._prefix_cache.cached_blocks(kv.tokens) == 0):
                # The pin is reclaimed and no radix block holds its
                # stream: the KV is gone, and the prefix handle must say
                # so (``prefill_estimate`` then expects no reuse).
                self._note_tier(conv_id, "dropped")
            self.allocator.free(kv.pages)
            streams.append(kv.tokens)
        if self._prefix_cache is not None and streams:
            if invalidate:
                # Prune every stream the conversation ever published (an
                # expired pin and a later turn may have diverged). Each
                # prune takes the unlocked, childless tail; a prefix
                # shared with another live stream survives.
                for t in streams:
                    self._prefix_cache.invalidate(t)
            else:
                # Remember the streams so that a later delete still
                # prunes them; bounded in tokens and in conversations.
                self._conv_evicted_tokens[conv_id] = streams[-4:]
                total = sum(len(t) for ss in self._conv_evicted_tokens.values()
                            for t in ss)
                while (total > 1_000_000
                       or len(self._conv_evicted_tokens) > 4096):
                    oldest = next(iter(self._conv_evicted_tokens))
                    if (oldest == conv_id
                            and len(self._conv_evicted_tokens) == 1):
                        break
                    dropped = self._conv_evicted_tokens.pop(oldest)
                    total -= sum(len(t) for t in dropped)
        if kv is None and conv_id in self._conv_busy:
            # An active sequence owns the pages; don't re-cache at finish.
            self._conv_drop_pending.add(conv_id)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        # The engine that serves reports its name's HBM: an engine built
        # later under the same name, and collected since, must not leave
        # the telemetry without a provider.
        self._telemetry.set_hbm_provider(self._hbm_provider)
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"engine-{self.name}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        lanes, self._fetch_lanes = self._fetch_lanes, {}
        for _t, q in lanes.values():
            q.put(None)
        for t, _q in lanes.values():
            t.join(timeout=10.0)
        # The completion pool last: nothing can enqueue to it any more,
        # so the drain sees every job. Made again if the engine restarts.
        comp, self._completion = self._completion, None
        if comp is not None:
            comp.drain()
            comp.stop()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def healthy(self) -> bool:
        """Alive iff the engine loop is running."""
        return self.running

    def recover_after_crash(self) -> Dict:
        """Crash-recovery reset, called only with the loop thread dead
        (``engine/supervisor.py``). Every sequence the dead loop owned
        (slot holders, pending, inbox) has its pages, slot and radix
        locks released and its handle finished with reason "error",
        which unblocks the worker parked in ``process_fn``: it raises and
        the worker retry path requeues the message through the delayed
        queue. A handle that finished before the crash is left alone, so
        a completed request is never also retried.

        The in-flight chunks are dropped (their carries and tokens
        belong to the dead loop; their staging slots recycle on their
        own events, and their fetches complete on the lanes unread).
        The executor's CUDA graphs and static buffers are untouched: the
        restarted loop replays them. Returns counts for the supervisor."""
        assert not self.running, "recover_after_crash needs a dead loop"
        self._inflight.clear()
        # Dedup barrier: a finish the dead loop already queued on the
        # completion pool must land before the handle.done checks below,
        # or a completed request would also be failed into the retry
        # path.
        self._drain_completions()
        with self._mu:
            inbox, self._inbox = self._inbox, []
        pending = [s for (_, _, s) in self._pending]
        self._pending = []
        holders = [s for s in self._slots if s is not None]
        recovered = 0
        already_done = 0
        for seq in holders + pending + inbox:
            if seq.slot is not None:
                try:
                    self.executor.release_slot(seq.slot)
                except Exception:  # noqa: BLE001 — the reset must win
                    pass
                self._slots[seq.slot] = None
                seq.slot = None
            seq.first_handle = None
            seq.mixed_pending = False
            if seq.handle.done:
                already_done += 1
                if seq.pages:
                    self.allocator.free(seq.pages)
                    seq.pages = []
                continue
            self._finish(seq, "error",
                         "engine crashed; request requeued by supervisor",
                         waste_reason="crash")
            recovered += 1
        self._wake.clear()
        log.warning(
            "engine %s crash recovery: %d request(s) failed over to the "
            "retry path, %d already finished", self.name, recovered,
            already_done)
        return {"recovered": recovered, "already_done": already_done}

    @contextmanager
    def paused(self, timeout: float = 30.0) -> Iterator[None]:
        """Hold the engine loop between two steps while the body runs: the
        engine launches nothing meanwhile, and what it queued on the card
        runs on. For work that must not overlap the loop's launches: a
        ``torch.profiler`` start or stop, whose device synchronize with
        CUPTI tracing on deadlocked against a CUDA-graph launch on this
        loop (an H100). A loop that is not running needs no hold."""
        with self._pause_lock:
            if not self.running:
                yield
                return
            self._pause_lift.clear()
            self._pause_parked.clear()
            self._pause_req.set()
            self._wake.set()
            try:
                if not self._pause_parked.wait(timeout):
                    raise TimeoutError(f"engine {self.name} did not pause "
                                       f"within {timeout} s")
                yield
            finally:
                self._pause_req.clear()
                self._pause_lift.set()

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                if self._pause_req.is_set():
                    self._pause_parked.set()
                    self._pause_lift.wait(0.05)
                    continue
                try:
                    did_work = self.step()
                except Exception:  # noqa: BLE001 — the loop keeps serving
                    log.exception("engine step failed")
                    did_work = False
                if not did_work:
                    self._wake.wait(0.005)
                    self._wake.clear()
        except BaseException:
            # A BaseException kills this thread; the supervisor sees the
            # dead loop and owns the recovery.
            log.exception("engine %s loop died; the supervisor takes "
                          "over", self.name)
            raise

    # -- core step -----------------------------------------------------------

    def step(self) -> bool:
        """One scheduling round (``InferenceEngine.step`` of the JAX
        package). Returns True if any work happened. One stepper at a
        time.

        With a chunk in flight: admission and prefill dispatch (which
        only queue programs behind it; preemption waits); then, while no
        scheduling work waits (arrivals, pending admissions, cancels, a
        new row to join by a fresh dispatch, mixed slices), the pipeline
        is filled to ``depth`` chunks dispatched from the newest chunk's
        device-carried end state, before the oldest chunk's tokens are
        fetched; then the first tokens of dispatched prefills are
        resolved, and the oldest chunk is reconciled. Once none is in
        flight, admission runs again (preemption allowed) and the next
        chunk is assembled from the reconciled state.

        With none in flight: one fresh chunk (mixed when decode rows and
        pending prefill coexist), joined by every sequence whose final
        prefill chunk was just dispatched; then the resolve."""
        self._ingest()
        self._expire_pins()
        admitted = self._admit()
        prefilled = self._advance_prefill()
        if self._inflight:
            while (len(self._inflight) < self._pipe_depth
                   and not self._has_scheduling_work()
                   and not self._geometry_changed(self._inflight[-1])
                   and not self._mixed_work_waiting()):
                nxt = self._dispatch_speculative(self._inflight[-1])
                if nxt is None:
                    break
                self._inflight.append(nxt)
            # Resolve before processing: a join row's first token must be
            # committed before any of its chunk rows.
            self._resolve_prefills()
            # The oldest chunk stays in the deque while its fetch
            # completes: the admissions serviced meanwhile see it.
            self._process_chunk(self._inflight[0])
            self._inflight.popleft()
            if not self._inflight:
                # Reconciled: admission again, now that preemption is
                # allowed; the extra prefill pass only if it seated
                # someone.
                if self._admit():
                    self._advance_prefill()
                if self._mixed_applicable():
                    self._mixed_once()
                else:
                    self._decode_once()
            return True
        # Dispatch before the resolve: a final prefill chunk dispatched
        # this step still holds its handle, so it joins this chunk on the
        # device.
        if self._mixed_applicable():
            stepped = self._mixed_once()
        else:
            stepped = self._decode_once()
        resolved = self._resolve_prefills()
        return resolved or admitted or prefilled or stepped

    def run_until_idle(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if not self.step():
                with self._mu:
                    idle = (not self._inbox and not self._pending
                            and not self._inflight
                            and all(s is None for s in self._slots))
                if idle:
                    # Every queued completion lands before returning.
                    self._drain_completions()
                    return
        raise RuntimeError("engine did not go idle")

    # -- admission -----------------------------------------------------------

    def _ingest(self) -> None:
        with self._mu:
            newly, self._inbox = self._inbox, []
        now = self._now()
        for seq in newly:
            seq.arrival = now
            heapq.heappush(self._pending, (seq.eff_prio, seq.order, seq))
        self._promote_overdue()

    def _promote_overdue(self) -> None:
        """A pending request waiting past its tier's max_wait_time gains
        one tier per elapsed multiple (floor REALTIME)."""
        if not self.tier_max_wait or not self._pending:
            return
        now = self._now()
        changed = False
        for _, _, seq in self._pending:
            mw = self.tier_max_wait.get(seq.req.priority)
            if not mw or mw <= 0:
                continue
            promo = int((now - seq.arrival) / mw)
            eff = max(int(Priority.REALTIME), int(seq.req.priority) - promo)
            if eff != seq.eff_prio:
                seq.eff_prio = eff
                changed = True
        if changed:
            self._pending = [(s.eff_prio, o, s) for (_, o, s) in self._pending]
            heapq.heapify(self._pending)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _least_urgent_active(
            self, exclude: Optional[_Sequence] = None, *,
            include_prefilling: bool = False) -> Optional[_Sequence]:
        """Least urgent slot holder. A mid-prefill sequence can't resume
        in place, so it is never a slot-preemption victim; it is one for
        page-release shedding (``include_prefilling``): the release folds
        its remainder into ``written_ids`` and it restarts through the
        rebuild, so a low-tier long prompt never holds the pool against
        a realtime sequence."""
        worst: Optional[_Sequence] = None
        for s in self._slots:
            if s is None or s is exclude:
                continue
            if not s.prefilled and not include_prefilling:
                continue
            if worst is None or s.sort_key() > worst.sort_key():
                worst = s
        return worst

    def _admit(self) -> bool:
        admitted = False
        # Turns blocked behind their conversation's live turn are skipped
        # (not a head-of-line break) and capacity stays reserved for the
        # most urgent of them: less urgent entries are deferred, except
        # the blocked conversations' own holders.
        conv_blocked = []
        deferred = []
        blocked_floor = None
        blocked_holders = set()
        while self._pending:
            prio, order, seq = self._pending[0]
            if seq.handle.cancelled:
                heapq.heappop(self._pending)
                self._finish(seq, "cancelled")
                continue
            conv = seq.req.conversation_id
            if conv:
                holder = self._conv_busy.get(conv)
                if holder is not None and holder != seq.order:
                    heapq.heappop(self._pending)
                    conv_blocked.append((prio, order, seq))
                    if blocked_floor is None or (prio, order) < blocked_floor:
                        blocked_floor = (prio, order)
                    blocked_holders.add(holder)
                    continue
            if (blocked_floor is not None and (prio, order) > blocked_floor
                    and seq.order not in blocked_holders):
                heapq.heappop(self._pending)
                deferred.append((prio, order, seq))
                continue
            slot = self._free_slot()
            if (slot is None and self.preemption_enabled
                    and not self._inflight):
                # No preemption while a chunk is in flight: the victim's
                # row is still decoding on the device. The pending request
                # blocks carried dispatches, so the next reconcile clears
                # the pipeline and preemption runs then.
                victim = self._least_urgent_active()
                if victim is not None and victim.sort_key() > (prio, order):
                    self._preempt(victim, release_pages=False)
                    slot = self._free_slot()
            if slot is None:
                break
            heapq.heappop(self._pending)
            if not self._start_sequence(seq, slot):
                # No pages even after reclaiming idle conversations.
                heapq.heappush(self._pending, (prio, order, seq))
                break
            admitted = True
        for entry in conv_blocked + deferred:
            heapq.heappush(self._pending, entry)
        return admitted

    def _preempt(self, victim: _Sequence, release_pages: bool) -> None:
        """Step-boundary preemption: the victim's slot is handed over; its
        KV pages stay resident (cheap resume) unless the pool itself is
        the contended resource, in which case it later resumes by
        re-prefilling its whole written context (``written_ids``, which
        includes any adopted conversation history)."""
        assert victim.slot is not None
        self._slots[victim.slot] = None
        self.executor.release_slot(victim.slot)
        victim.slot = None
        if release_pages:
            self._release_sequence_pages(victim)
        heapq.heappush(self._pending, (victim.eff_prio, victim.order, victim))
        self.preemptions += 1
        if self._m is not None:
            self._m.preemptions[victim.req.priority].inc()
        log.info("preempted %s (%s)%s", victim.req.id,
                 victim.req.priority.tier_name,
                 " releasing pages" if release_pages else "")

    def _release_sequence_pages(self, seq: _Sequence,
                                waste_reason: str = "preempt") -> None:
        """Take ``seq``'s KV pages back into the pool; the sequence
        rebuilds by re-prefilling ``written_ids`` when next admitted. The
        rebuild's prefill writes every position it reads again (over
        int8 pools its scale entries too) before any decode step reads
        them. The usage plane bills that re-prefill as waste under
        ``waste_reason`` ("preempt" for a preemption, "shed" for a
        pending sequence's pages reclaimed)."""
        if seq.usage is not None:
            if not seq.usage.waste_reason:
                seq.usage.waste_reason = waste_reason
            self._usage.tracker.update(seq.req.id, 0)
        if seq.prefix_match is not None:
            # Matched shared pages: drop this sequence's node locks (the
            # free below drops its page refs; the tree's own refs keep
            # the shared KV for everyone else). The rebuild re-matches.
            self._prefix_cache.unlock(seq.prefix_match)
            seq.prefix_match = None
        if seq.pages:
            self.allocator.free(seq.pages)
            seq.pages = []
        seq.block_table[:] = 0
        seq.pos = 0
        seq.cached_len = 0
        # A dispatched prefill's sample refers to released pages: the
        # rebuild re-prefills and samples again at the same position.
        seq.first_handle = None
        if seq.todo_ids:
            # Mid-prefill victim: fold the remainder into written_ids, so
            # the rebuild re-prefills the complete context.
            seq.written_ids = seq.written_ids + seq.todo_ids
            seq.todo_ids = []
        if seq.prefilled or seq.written_ids:
            seq.rebuild = True
        seq.prefilled = False

    def _unmatch(self, seq: _Sequence) -> None:
        """Undo a radix match whose admission could not complete: unlock
        its nodes, drop this sequence's page refs and reset its position,
        so that a retry recomputes (and matches) from scratch."""
        self._prefix_cache.unlock(seq.prefix_match)
        seq.prefix_match = None
        if seq.pages:
            self.allocator.free(seq.pages)
            seq.pages = []
        seq.block_table[:] = 0
        seq.pos = 0
        seq.cached_len = 0
        if seq.usage is not None:
            self._usage.tracker.update(seq.req.id, 0)

    def _reclaim_idle_conversation(self) -> bool:
        """LRU-evict one idle pinned conversation. True if pages freed."""
        with self._mu:
            if not self._conv_cache:
                return False
            cid = min(self._conv_cache,
                      key=lambda c: self._conv_cache[c].last_used)
            self._drop_conversation_locked(cid, invalidate=False)
        self._flush_tier_notes()
        log.info("evicted conversation KV %s under pool pressure", cid)
        return True

    def _note_tier(self, conv_id: str, tier: str) -> None:
        """Queue a prefix-handle ``tier`` update (callers hold
        ``self._mu``); :meth:`_flush_tier_notes` writes it."""
        if self._state_manager is not None:
            self._pending_tier_notes.append((conv_id, tier))

    def _flush_tier_notes(self) -> None:
        if not self._pending_tier_notes:
            return
        with self._mu:
            notes, self._pending_tier_notes = self._pending_tier_notes, []
        for cid, tier in notes:
            try:
                self._state_manager.update_prefix_handle_tier(cid, tier)
            except Exception:  # noqa: BLE001 — bookkeeping, not a gate
                log.exception("prefix-handle tier update failed for %s",
                              cid)

    def _reclaim_pending_pages(self, requester: _Sequence) -> bool:
        """Release the pages of a *pending* sequence (slot-preempted
        earlier, pages kept for a cheap resume) strictly less urgent than
        ``requester``. Without this, pages parked in the pending heap are
        invisible to shedding, and admission can deadlock with the pool
        exhausted and every slot empty."""
        worst: Optional[_Sequence] = None
        for _, _, seq in self._pending:
            if seq is requester or not seq.pages:
                continue
            if worst is None or seq.sort_key() > worst.sort_key():
                worst = seq
        if worst is None or worst.sort_key() <= requester.sort_key():
            return False
        self._release_sequence_pages(worst, waste_reason="shed")
        log.info("reclaimed pages of pending %s for %s", worst.req.id,
                 requester.req.id)
        return True

    def _alloc_pages(self, n: int,
                     requester: _Sequence) -> Optional[List[int]]:
        """Allocate ``n`` pages, shedding while the pool is short, in
        increasing order of damage: zero-ref radix leaves (no running
        sequence reads them), idle pinned conversations (LRU), pages
        parked with less urgent pending sequences, then — only while no
        chunk is in flight — preempt-with-release of a strictly less
        urgent runner. A victim is always less urgent than
        ``requester``: a low-tier request never strips a realtime
        sequence's KV."""
        while True:
            pages = self.allocator.alloc(n)
            if pages is not None:
                return pages
            deficit = n - self.allocator.available()
            if (self._prefix_cache is not None
                    and self._prefix_cache.evict_pages(deficit) > 0):
                continue
            if self._reclaim_idle_conversation():
                continue
            if self._reclaim_pending_pages(requester):
                continue
            if self._inflight:
                # Shedding a decoding row would free pages a chunk in
                # flight is still writing: wait for the reconcile (the
                # unadmitted request blocks carried dispatches).
                return None
            victim = self._least_urgent_active(exclude=requester,
                                               include_prefilling=True)
            if (victim is not None and self.preemption_enabled
                    and victim.sort_key() > requester.sort_key()):
                self._preempt(victim, release_pages=True)
                continue
            return None

    def _start_sequence(self, seq: _Sequence, slot: int) -> bool:
        """Admit ``seq`` into ``slot``. Returns False only when pages are
        unavailable (seq stays pending)."""
        req = seq.req
        conv = req.conversation_id
        if seq.prefilled:
            # Resuming a slot-only preemption: KV intact, take the slot.
            self.executor.resume(slot, seq.prefill_ids, seq.prefill_start)
            seq.slot = slot
            self._slots[slot] = seq
            seq.handle.marks.setdefault("admitted", time.perf_counter())
            return True
        if conv and not seq.adopted:
            # Adopt the conversation's cached KV exactly once (single
            # ownership: the cache entry moves into this sequence).
            with self._mu:
                kv = self._conv_cache.pop(conv, None)
                if kv is not None:
                    self.allocator.unpin(conv)
                self._conv_busy[conv] = seq.order
            seq.adopted = True
            if kv is not None and self._usage.enabled:
                # The pin's meter ends; the pages go on this sequence's.
                self._usage.unpin_kv(conv)
            if kv is not None:
                seq.cached_len = kv.length
                seq.pos = kv.length
                seq.block_table[:] = kv.block_table
                seq.pages = list(kv.pages)
                seq.written_ids = list(kv.tokens)
                if kv.pending is not None:
                    seq.carry = [kv.pending]
        if not seq.prompt_ids:
            text = req.prompt
            if seq.cached_len == 0 and req.history_text:
                text = req.history_text + req.prompt
            ids = self.tokenizer.encode(text)
            seq.prompt_ids = ids or [self.tokenizer.bos_id]

        resume_last: Optional[int] = None
        if seq.rebuild:
            # Pages were reclaimed mid-flight: re-prefill the exact
            # written context (adopted history + prompt + generated so
            # far), then resume decoding from the newest token.
            ids = list(seq.written_ids)
            start_pos = 0
            if seq.generated:
                resume_last = seq.generated[-1]
        else:
            start_pos = seq.cached_len
            # KV to build: the carried token, the prompt and every
            # sampled token but the newest (whose KV its decode step
            # writes).
            ids = seq.carry + seq.prompt_ids
            if seq.generated:
                ids = ids + seq.generated[:-1]
                resume_last = seq.generated[-1]
        capacity = self.spec.max_pages_per_seq * self.spec.page_size
        if start_pos + len(ids) + 1 > capacity and start_pos > 0:
            # The cached prefix + new tokens exceed the block table: fold
            # the prefix into a from-scratch prefill so the window can
            # slide. The fold moves the history into ``carry``, so a
            # retried admission recomputes the same stream.
            seq.carry = seq.written_ids + seq.carry
            seq.written_ids = []
            ids = seq.carry + seq.prompt_ids
            if seq.generated:
                ids = ids + seq.generated[:-1]
            if seq.pages:
                self.allocator.free(seq.pages)
                seq.pages = []
            seq.block_table[:] = 0
            start_pos = 0
            seq.pos = 0
            seq.cached_len = 0
        if len(ids) + 1 > capacity:
            keep = capacity - max(1, min(self.max_decode_steps,
                                         capacity // 4))
            if keep < 1:
                self._finish(seq, "error", "prompt exceeds KV capacity")
                return True
            ids = ids[-keep:]
        # Radix prefix reuse: a from-scratch prefill adopts the longest
        # cached page-aligned prefix. At least the final token stays in
        # ``ids`` and is prefilled; matched pages are shared by reference
        # count, and this sequence's writes start at ``start_pos``, in
        # blocks of its own, never in a shared page.
        match_seed: Optional[List[int]] = None
        if (self._prefix_cache is not None and start_pos == 0
                and not seq.pages and len(ids) > 1):
            m = self._prefix_cache.match(ids)
            if m.nodes:
                n_m = len(m.pages)
                seq.pages = list(m.pages)
                seq.block_table[:n_m] = m.pages
                seq.prefix_match = m
                seq.pos = m.length
                seq.cached_len = m.length
                match_seed = ids[:m.length]
                ids = ids[m.length:]
                start_pos = m.length
        have = len(seq.pages)
        need = PageAllocator.pages_for(start_pos + len(ids) + 1,
                                       self.spec.page_size) - have
        if need > self.allocator.total:
            self._finish(seq, "error",
                         f"request needs {need} pages; pool has "
                         f"{self.allocator.total}")
            return True
        if need > 0:
            pages = self._alloc_pages(need, seq)
            if pages is None:
                if match_seed is not None:
                    # Give the matched pages back: a retry recomputes ids
                    # from scratch.
                    self._unmatch(seq)
                elif seq.pages:
                    # Pending with pages (adopted KV kept for the
                    # retry): metered while it waits.
                    self._usage_pages(seq)
                return False
            seq.block_table[have:have + need] = pages
            seq.pages.extend(pages)
        seq.todo_ids = ids
        seq.todo_pos = start_pos
        seq.todo_rebuild = seq.rebuild
        seq.todo_resume = resume_last
        seq.rebuild = False
        if seq.todo_rebuild or start_pos == 0 or match_seed is not None:
            # written_ids mirrors [0, pos): the matched prefix, if any.
            seq.written_ids = list(match_seed or [])
        if not (seq.todo_rebuild and seq.generated):
            seq.prefill_ids = ids
            seq.prefill_start = start_pos
        if self._prefix_cache is not None and not seq.reuse_counted:
            seq.reuse_counted = True
            if seq.cached_len > 0:
                self.prefix_hits += 1
                self.cached_prefill_tokens_total += seq.cached_len
            else:
                self.prefix_misses += 1
            if self._m is not None:
                if seq.cached_len > 0:
                    self._m.prefix_hits.inc()
                    self._m.cached_tokens.inc(seq.cached_len)
                else:
                    self._m.prefix_misses.inc()
        seq.slot = slot
        self._slots[slot] = seq        # slot held; prefilled=False
        seq.handle.marks.setdefault("admitted", time.perf_counter())
        self._usage_pages(seq)
        return True

    # -- prefill -------------------------------------------------------------

    def _advance_prefill(self) -> bool:
        """Dispatch one prefill bucket for EVERY mid-prefill sequence
        (``InferenceEngine._advance_prefill`` of the JAX package, the
        branch of an executor with async prefill): most urgent first, in
        waves of up to ``prefill_batch`` chunks, one ``prefill_multi_async``
        program each; a trailing single chunk (or every chunk, with
        ``prefill_batch`` 1) takes ``prefill_async``. Nothing waits for
        the device: a sequence whose final chunk went out keeps its
        handle in ``first_handle`` for :meth:`_resolve_prefills` (and a
        decode join)."""
        cands = [s for s in self._slots if s is not None and not s.prefilled
                 and s.first_handle is None and not s.mixed_pending]
        reaped = False
        for s in list(cands):
            if s.handle.cancelled:
                self._finish_active(s, "cancelled")
                cands.remove(s)
                reaped = True
        if not cands:
            return reaped
        decode_active = any(s is not None and s.prefilled
                            for s in self._slots)
        if self._mixed_on() and decode_active:
            # Mixed mode owns prefill while decode rows are hot: the next
            # mixed chunk runs these sequences' slices inside the decode
            # program (budget-bounded) instead of whole buckets first.
            return reaped
        cands.sort(key=lambda s: s.sort_key())
        ex = self.executor
        t0 = time.perf_counter()
        chunk_len = ex.prefill_buckets[-1]
        work = []
        for seq in cands:
            seq.handle.marks.setdefault("prefill_start", time.perf_counter())
            chunk = seq.todo_ids[:chunk_len]
            seq.todo_ids = seq.todo_ids[chunk_len:]
            work.append((seq, chunk))
        npf = ex.prefill_batch
        handles: List = []
        for i0 in range(0, len(work), npf):
            grp = work[i0:i0 + npf]
            reqs = [(chunk, seq.todo_pos, seq.block_table,
                     seq.req.temperature) for seq, chunk in grp]
            seqs = [seq for seq, _ in grp]
            if len(grp) == 1:
                with self._prof.span("engine.prefill",
                                     tokens=len(reqs[0][0])):
                    handles.append(self._dispatch(
                        lambda: ex.prefill_async(*reqs[0]), seqs))
            else:
                with self._prof.span("engine.prefill_multi",
                                     seqs=len(grp),
                                     tokens=sum(len(r[0]) for r in reqs)):
                    handles.extend(self._dispatch(
                        lambda: ex.prefill_multi_async(reqs), seqs))
        self._note_prefill_dispatch(
            sum(len(c) for _, c in work), time.perf_counter() - t0,
            decode_active=decode_active, fused=False)
        for (seq, chunk), h in zip(work, handles):
            seq.todo_pos += len(chunk)
            seq.pos = seq.todo_pos
            seq.pf_tokens_run += len(chunk)
            seq.written_ids.extend(chunk)
            if not seq.todo_ids:
                seq.first_handle = h
        return True

    def _resolve_prefills(self) -> bool:
        """Fetch the first tokens of the prefills dispatched so far and
        complete those admissions: every pending handle in one gather, on
        the resolve lane, while this thread keeps admitting arrivals."""
        pending = [s for s in self._slots
                   if s is not None and s.first_handle is not None]
        if not pending:
            return False
        handles = [s.first_handle for s in pending]
        gather = self.executor.gather_scalars
        with self._prof.span("engine.resolve_fetch", n=len(pending)):
            box = self._offload_fetch(lambda: gather(handles),
                                      lane="resolve")
            self._service_while(box["ev"])
        if box["err"] is not None:
            self._fail(pending, f"prefill fetch failed: {box['err']}")
            raise box["err"]
        for seq, first, h in zip(pending, box["out"], handles):
            if seq.first_handle is not h or seq.slot is None:
                # Cancelled, finished or shed during the wait: the sample
                # belongs to a prefill whose pages may be gone; a rebuild
                # re-prefills and samples again.
                continue
            seq.first_handle = None
            self._complete_prefill(seq, int(first))
            self._flush_emits(seq)   # the first token does not wait a chunk
        return True

    def _note_prefill_dispatch(self, tokens: int, host_seconds: float,
                               *, decode_active: bool,
                               fused: bool) -> None:
        """Account one round of prefill dispatches as decode stall while
        decode rows were active: the larger of the host time spent here
        and the learned rate's device time for ``tokens`` (an async
        dispatch returns before the program, which the decode rows wait
        behind or, fused, ride with)."""
        if tokens <= 0:
            return
        est_ms = host_seconds * 1e3
        if self.prefill_tps_ewma and self.prefill_tps_ewma > 0:
            est_ms = max(est_ms, tokens / self.prefill_tps_ewma * 1e3)
        if not decode_active:
            return
        self.prefill_stall_events += 1
        self.prefill_stall_ms_total += est_ms
        if self._m is not None:
            self._m.stall["mixed" if fused else "program"].observe(est_ms)

    def _observe_prefill_rate(self, seq: _Sequence) -> None:
        """Feed the learned prefill rate (and ``on_prefill_observed``)
        from a completed admission's prefill_start → prefill_done span."""
        marks = seq.handle.marks
        t0 = marks.get("prefill_start")
        t1 = marks.get("prefill_done")
        tokens = seq.pf_tokens_run
        if t0 is None or t1 is None or t1 <= t0 or tokens <= 0:
            return
        dt = t1 - t0
        rate = tokens / dt
        if self.prefill_tps_ewma is None:
            self.prefill_tps_ewma = rate
        else:
            self.prefill_tps_ewma = 0.8 * self.prefill_tps_ewma + 0.2 * rate
        if self.on_prefill_observed is not None:
            try:
                self.on_prefill_observed(tokens, dt)
            except Exception:  # noqa: BLE001 — accounting, not a gate
                log.exception("on_prefill_observed hook failed")

    def _complete_prefill(self, seq: _Sequence, first: int) -> None:
        """Admission completes after the final prefill chunk: ``first``
        is the token sampled at its last position. A rebuild instead
        resumes from its newest generated token."""
        if seq.todo_rebuild and seq.generated:
            # The KV is rebuilt; the slot's executor state gets the
            # original prefill stream, not the replayed mix.
            self.executor.resume(seq.slot, seq.prefill_ids,
                                 seq.prefill_start)
        seq.prefilled = True
        seq.handle.marks.setdefault("prefill_done", time.perf_counter())
        self._observe_prefill_rate(seq)
        if seq.todo_resume is not None:
            seq.last_token = seq.todo_resume
            return
        self._commit_token(seq, first)

    # -- mixed prefill+decode batching ---------------------------------------

    def _mixed_on(self) -> bool:
        """Mixed batching configured AND the executor has a mixed
        geometry."""
        return (self._mixed_cfg is not None
                and int(getattr(self.executor, "mixed_prefill_slices", 0)) > 0
                and int(getattr(self.executor, "mixed_slice_tokens", 0)) > 0
                and getattr(self.executor, "mixed_chunk_start", None)
                is not None)

    def _mixed_work_waiting(self) -> bool:
        """A mid-prefill slot has slices left (whether or not one rides
        the chunk in flight): no carried decode-only dispatch, so that
        the reconcile can fuse them."""
        if not self._mixed_on():
            return False
        return any(s is not None and not s.prefilled and s.todo_ids
                   for s in self._slots)

    def _mixed_applicable(self) -> bool:
        """Run a mixed chunk this round: mixed batching is on, decode rows
        are active, and a mid-prefill slot has a slice to dispatch."""
        if not self._mixed_on():
            return False
        if not any(s is not None and s.prefilled for s in self._slots):
            return False
        return any(s is not None and not s.prefilled and s.todo_ids
                   and s.first_handle is None and not s.mixed_pending
                   for s in self._slots)

    def _mixed_once(self) -> bool:
        """Dispatch one mixed chunk: the active decode rows' chunk plus up
        to ``prefill_token_budget`` tokens of pending prefill slices in
        its first step. Streams are those of the unfused path: slices
        write the same K/V at the same positions, a prompt's final slice
        samples the same first token, and decode rows never read another
        sequence's pages."""
        chunk = min(max(1, self.executor.chunk_size), self._admission_cap())
        S = int(self.executor.mixed_prefill_slices)
        T = int(self.executor.mixed_slice_tokens)
        # Bucket mode packs S slices of T tokens. In ragged mode T is the
        # packed buffer's whole capacity and one slice may take it all.
        budget = int(self._mixed_cfg.prefill_token_budget)
        if getattr(self.executor, "ragged_attention", False):
            budget = min(budget, T)
        else:
            budget = min(budget, S * T)
        budgets_by_order = self._budget_chunk_rows(
            chunk, [s for s in self._slots if s is not None and s.prefilled])
        active = [s for s in self._slots if s is not None and s.prefilled]
        # Slices are packed after decode budgeting, which may have
        # finished rows and freed pages.
        cands = [s for s in self._slots
                 if s is not None and not s.prefilled and s.todo_ids
                 and s.first_handle is None and not s.mixed_pending]
        for s in list(cands):
            if s.handle.cancelled:
                self._finish_active(s, "cancelled")
                cands.remove(s)
        cands.sort(key=lambda s: s.sort_key())
        pf_plan = _pack_prefill_slices(cands, S, T, budget)
        if not pf_plan:
            return self._decode_once()
        packed = sum(len(sl) for _, sl in pf_plan)
        t_asm = time.perf_counter()   # step decomposition: dispatch leg
        tokens, positions, block_tables, temps, budgets = \
            self._chunk_arrays(active, budgets_by_order)
        pf, infl_pf = [], []
        for seq, sl in pf_plan:
            seq.handle.marks.setdefault("prefill_start", time.perf_counter())
            pf.append((seq.slot, sl, seq.todo_pos, seq.block_table,
                       seq.req.temperature))
            seq.todo_ids = seq.todo_ids[len(sl):]
            seq.todo_pos += len(sl)
            seq.pos = seq.todo_pos
            seq.pf_tokens_run += len(sl)
            seq.written_ids.extend(sl)
            infl_pf.append((seq, len(sl), not seq.todo_ids))
        if self._m is not None:
            self._m.mixed_rows.set(len(active))
            self._m.mixed_tokens.set(packed)
            self._m.mixed_util.set(packed / budget if budget else 0.0)
        t0 = time.perf_counter()
        with self._prof.span("engine.mixed_chunk", active=len(active),
                             chunk=chunk, slices=len(pf), pf_tokens=packed):
            handle = self._dispatch(
                lambda: self.executor.mixed_chunk_start(
                    tokens, positions, block_tables, temps, budgets, pf),
                active + [seq for seq, _ in pf_plan])
        now = time.perf_counter()
        self._note_prefill_dispatch(packed, now - t0,
                                    decode_active=bool(active), fused=True)
        seqs: List[Optional[_Sequence]] = [None] * self.spec.batch_size
        for seq in active:
            seqs[seq.slot] = seq
        for seq, _n, _final in infl_pf:
            seq.mixed_pending = True
        self._push_chunk(_InflightChunk(handle, seqs, budgets, pf=infl_pf,
                                        dispatch_s=now - t_asm,
                                        dispatched_at=now))
        self.mixed_steps += 1
        self.mixed_prefill_tokens_total += packed
        return True

    def _finish_mixed_prefills(self, pf, pf_first) -> None:
        """Reconcile the slices of a processed mixed chunk: clear their
        in-flight latch and complete the admissions whose final slice ran
        (their first token is ``pf_first[i]``)."""
        for i, (seq, _n, final) in enumerate(pf):
            seq.mixed_pending = False
            if seq.slot is None or seq.prefilled:
                continue
            if seq.handle.cancelled:
                self._finish_active(seq, "cancelled")
            elif final:
                self._complete_prefill(seq, int(pf_first[i]))
                self._flush_emits(seq)

    # -- decode --------------------------------------------------------------

    def _budget_for(self, seq: _Sequence, chunk: int) -> int:
        """Tokens ``seq`` may produce this chunk: bounded by its
        max_new_tokens allowance and the block-table capacity."""
        limit = seq.req.max_new_tokens or self.max_decode_steps
        remaining = max(1, limit - len(seq.generated))
        capacity = self.spec.max_pages_per_seq * self.spec.page_size
        headroom = capacity - seq.pos
        return max(1, min(chunk, remaining, headroom))

    def _ensure_decode_pages(self, seq: _Sequence, budget: int) -> bool:
        """Back positions ``[seq.pos, seq.pos + budget)`` with pages."""
        need = PageAllocator.pages_for(
            seq.pos + budget, self.spec.page_size) - len(seq.pages)
        if need <= 0:
            return True
        pages = self._alloc_pages(need, seq)
        if pages is None:
            return False
        seq.block_table[len(seq.pages):len(seq.pages) + need] = pages
        seq.pages.extend(pages)
        self._usage_pages(seq)
        return True

    def _admission_cap(self) -> int:
        """Decode-chunk cap while an urgent request waits: the chunk
        length is its admission latency. No urgent waiter → no cap. With
        the prefix cache on, a REALTIME waiter whose context is expected
        mostly cached gets half the cap: its prefill is just the tail, so
        its admission wait is its time to first token."""
        if not self._pending or self._pending[0][0] > int(Priority.HIGH):
            return 1 << 30
        if self._pending[0][0] > int(Priority.REALTIME):
            return 16
        cap = realtime_admission_cap(getattr(self.executor, "step_ms",
                                             None))
        if self._prefix_cache is not None:
            head = self._pending[0][2]
            # Tokens estimated from the text: nothing is tokenized on
            # this path.
            cpt = getattr(self.tokenizer, "chars_per_token", 1.0) or 1.0
            est_tokens = max(1, int(len(head.req.prompt) / cpt))
            cached, new = self.prefill_estimate(head.req.conversation_id,
                                                est_tokens)
            if cached > new:
                cap = max(2, cap // 2)
        return cap

    def prefill_estimate(self, conversation_id: str,
                         prompt_tokens: int) -> Tuple[int, int]:
        """(expected cached, expected new) prefill tokens of an arriving
        request: the resident length of its conversation's pinned KV;
        with the pin reclaimed, the prefix handle the conversation
        service recorded (the radix tree usually still holds its full
        pages; a sizing estimate, not an allocation); otherwise none
        cached."""
        cached = 0
        if conversation_id:
            with self._mu:
                kv = self._conv_cache.get(conversation_id)
                if kv is not None:
                    cached = kv.length
            if (cached == 0 and self._state_manager is not None
                    and self._prefix_cache is not None):
                # Outside self._mu: the state manager's lock sits above
                # the engine's.
                try:
                    h = self._state_manager.prefix_handle(conversation_id)
                except Exception:  # noqa: BLE001 — an estimate, not a gate
                    h = None
                if h and str(h.get("tier", "")) != "dropped":
                    ps = self.spec.page_size
                    cached = (int(h.get("length", 0)) // ps) * ps
        return cached, max(0, int(prompt_tokens))

    def _budget_chunk_rows(self, chunk: int, rows) -> Dict[int, int]:
        """Eligibility and budgets of the rows of the next fresh chunk
        (shared by the plain and the mixed chunk): finish cancelled and
        full rows, back each survivor's budget with pages. A joining row
        (final prefill dispatched, not yet resolved) gets one token less:
        its resolve commits the first. Returns ``seq.order → budget``."""
        budgets_by_order: Dict[int, int] = {}
        for seq in rows:
            if seq.slot is None:
                continue    # shed by an earlier row's page allocation
            if seq.handle.cancelled:
                self._finish_active(seq, "cancelled")
                continue
            if seq.pos // self.spec.page_size >= self.spec.max_pages_per_seq:
                self._finish_active(seq, "length")  # block table exhausted
                continue
            budget = self._budget_for(seq, chunk)
            if not seq.prefilled:
                budget = max(0, budget - 1)
            if budget and not self._ensure_decode_pages(seq, budget):
                # Pool exhausted even after shedding everyone else:
                # requeue this one (it rebuilds) rather than truncate it.
                if seq.slot is not None:
                    self._preempt(seq, release_pages=True)
                continue
            budgets_by_order[seq.order] = budget
        return budgets_by_order

    def _chunk_arrays(self, rows: List[_Sequence],
                      budgets_by_order: Dict[int, int]):
        """Full-batch (tokens, positions, block_tables, temperatures,
        budgets) of a fresh chunk; empty slots stay zero (budget 0). A
        joining row's token is a placeholder: its override supplies it on
        the device."""
        B = self.spec.batch_size
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        block_tables = np.zeros((B, self.spec.max_pages_per_seq), np.int32)
        temps = np.zeros(B, np.float32)
        budgets = np.zeros(B, np.int32)
        for seq in rows:
            i = seq.slot
            if seq.prefilled:
                tokens[i] = seq.last_token
            positions[i] = seq.pos
            block_tables[i] = seq.block_table
            temps[i] = seq.req.temperature
            budgets[i] = budgets_by_order[seq.order]
        return tokens, positions, block_tables, temps, budgets

    def _decode_once(self) -> bool:
        """Dispatch one fresh decode chunk from the reconciled host state.
        A sequence whose final prefill chunk is dispatched but unresolved
        joins it (same-step join): its first token goes in device to
        device, and its admission completes at the next resolve, which
        always runs before this chunk is processed."""
        chunk = min(max(1, self.executor.chunk_size), self._admission_cap())
        joining = []
        if chunk > 1:
            # A rebuild never joins: its re-prefill's sample is discarded
            # (it resumes from its newest generated token), so the device
            # must not feed that sample on.
            joining = [s for s in self._slots
                       if s is not None and not s.prefilled
                       and s.first_handle is not None and not s.todo_ids
                       and s.todo_resume is None and not s.todo_rebuild
                       and not s.handle.cancelled]
        active = [s for s in self._slots if s is not None and s.prefilled]
        if not active and not joining:
            self._set_gauges()
            return False
        budgets_by_order = self._budget_chunk_rows(chunk, active + joining)
        active = [s for s in self._slots if s is not None and s.prefilled]
        joining = [s for s in joining
                   if s.slot is not None and s.first_handle is not None
                   and s.order in budgets_by_order]
        if not active and not joining:
            self._set_gauges()
            return False
        rows = active + joining
        t_asm = time.perf_counter()   # step decomposition: dispatch leg
        tokens, positions, block_tables, temps, budgets = \
            self._chunk_arrays(rows, budgets_by_order)
        if chunk > 1:
            overrides = [(s.slot, s.first_handle, s.pos) for s in joining]
            with self._prof.span("engine.decode_dispatch",
                                 active=len(active), chunk=chunk,
                                 joined=len(joining)):
                handle = self._dispatch(
                    lambda: self.executor.decode_chunk_start(
                        tokens, positions, block_tables, temps, budgets,
                        overrides=overrides), rows)
            now = time.perf_counter()
            seqs: List[Optional[_Sequence]] = [None] * self.spec.batch_size
            for seq in rows:
                seqs[seq.slot] = seq
            self._push_chunk(_InflightChunk(handle, seqs, budgets,
                                            dispatch_s=now - t_asm,
                                            dispatched_at=now))
            return True
        # One-step chunks: the blocking single step (its host wait is
        # the device leg; the tokens arrive with it).
        t_call = time.perf_counter()
        with self._prof.span("engine.decode_chunk", active=len(active),
                             chunk=chunk):
            out = self.executor.decode(tokens, positions, block_tables,
                                       temps)[:, None]
        t_done = time.perf_counter()
        out = np.asarray(out)
        t_rb = time.perf_counter()
        self._count_step()
        if self._usage.enabled or self._cp.enabled:
            parts = [(seq, max(1, int(budgets[seq.slot])), False)
                     for seq in active if seq.slot is not None]
            if self._usage.enabled:
                self._charge_step(t_done - t_call, parts)
            if self._cp.enabled:
                self._cp_decode_share(
                    (t_done - t_call) + (t_rb - t_done), parts,
                    [(seq, w) for seq, w, _ in parts])
        tok0 = self.tokens_generated_total
        for seq in active:
            self._commit_row(seq, out[seq.slot], int(budgets[seq.slot]))
            self._flush_emits(seq)
        self._telemetry.note_step(t_call - t_asm, t_done - t_call,
                                  t_rb - t_done,
                                  self.tokens_generated_total - tok0)
        self._set_gauges()
        return True

    def _push_chunk(self, infl: _InflightChunk) -> None:
        self._inflight.append(infl)
        self.pipeline_depth_hist[len(self._inflight)] += 1
        self._start_fetch(infl)
        self._count_step()

    def _count_step(self) -> None:
        """One decode (or mixed) chunk dispatched."""
        self.steps += 1
        if self._m is not None:
            self._m.decode_steps.inc()

    def _set_gauges(self) -> None:
        if self._m is None:
            return
        self._m.kv_pages.set(self.allocator.used())
        self._m.pinned.set(len(self._conv_cache))
        self._m.occupancy.set(sum(1 for s in self._slots if s is not None))
        if self._prefix_cache is not None:
            self._m.prefix_pages.set(self._prefix_cache.pages)

    # -- the async pipeline ---------------------------------------------------

    def _has_scheduling_work(self) -> bool:
        """Anything that needs host scheduling before the next chunk, and
        so forbids a carried dispatch. Mid-prefill sequences do not: their
        lanes are latched in the carry, and they join by a fresh dispatch
        once resolved (:meth:`_geometry_changed`)."""
        with self._mu:
            if self._inbox:
                return True
        if self._pending:
            return True
        return any(s is not None and s.handle.cancelled for s in self._slots)

    def _geometry_changed(self, infl: _InflightChunk) -> bool:
        """A prefilled sequence outside the in-flight chunk's snapshot (a
        completed admission) needs a host-assembled dispatch to join the
        batch: its lane in the carry is latched."""
        return any(s is not None and s.prefilled and infl.seqs[i] is not s
                   for i, s in enumerate(self._slots))

    def _dispatch_speculative(
            self, infl: _InflightChunk) -> Optional[_InflightChunk]:
        """Dispatch the next chunk from the in-flight chunk's
        device-carried end state, before its tokens are fetched. Budgets
        are upper bounds (as if every chunk in flight used its whole
        budget on every row): a row that cannot be bounded gets budget 0
        and stays latched, and pages must come without any shedding,
        which could touch rows still decoding. Sequences whose final
        prefill chunk is dispatched but unresolved join as overrides.
        Returns None when no carried dispatch is possible."""
        B = self.spec.batch_size
        chunk = min(max(1, self.executor.chunk_size), self._admission_cap())
        capacity = self.spec.max_pages_per_seq * self.spec.page_size
        plan = []   # (seq, slot, budget, pages_needed)
        for slot in range(B):
            seq = infl.seqs[slot]
            if seq is None or seq.slot != slot or not seq.prefilled:
                continue
            # The host's pos and generated were last reconciled before the
            # oldest chunk in flight; each chunk this row rides may use
            # its whole budget first.
            prev_b = sum(int(c.budgets[slot]) for c in self._inflight
                         if c.seqs[slot] is seq)
            gen_upper = len(seq.generated) + prev_b
            pos_upper = seq.pos + prev_b
            limit = seq.req.max_new_tokens or self.max_decode_steps
            b = min(chunk, limit - gen_upper, capacity - pos_upper)
            if b <= 0:
                continue
            need = PageAllocator.pages_for(
                pos_upper + b, self.spec.page_size) - len(seq.pages)
            plan.append((seq, slot, b, max(0, need)))
        join_plan = []
        for slot in range(B):
            seq = self._slots[slot]
            if (seq is None or seq.prefilled
                    or any(c.seqs[slot] is seq for c in self._inflight)
                    or seq.first_handle is None or seq.todo_ids
                    or seq.todo_resume is not None or seq.todo_rebuild
                    or seq.handle.cancelled):
                continue
            b = self._budget_for(seq, chunk) - 1   # the resolve commits one
            if b <= 0:
                continue
            need = PageAllocator.pages_for(
                seq.pos + b, self.spec.page_size) - len(seq.pages)
            join_plan.append((seq, slot, b, max(0, need)))
        if not plan and not join_plan:
            return None
        if sum(n for *_, n in plan + join_plan) > self.allocator.available():
            return None     # would need shedding: reconcile instead
        t_asm = time.perf_counter()   # step decomposition: dispatch leg
        budgets = np.zeros(B, np.int32)
        block_tables = np.zeros((B, self.spec.max_pages_per_seq), np.int32)
        temps = np.zeros(B, np.float32)
        for seq, slot, b, need in plan + join_plan:
            if need > 0:
                pages = self.allocator.alloc(need)
                assert pages is not None    # checked above
                seq.block_table[len(seq.pages):len(seq.pages) + need] = pages
                seq.pages.extend(pages)
                self._usage_pages(seq)
            budgets[slot] = b
            block_tables[slot] = seq.block_table
            temps[slot] = seq.req.temperature
        overrides = [(slot, seq.first_handle, seq.pos)
                     for seq, slot, _, _ in join_plan]
        seqs = list(infl.seqs)
        for seq, slot, _, _ in join_plan:
            seqs[slot] = seq
        with self._prof.span("engine.decode_chunk", active=len(plan),
                             chunk=chunk, speculative=1,
                             joined=len(join_plan)):
            handle = self._dispatch(
                lambda: self.executor.decode_chunk_start(
                    None, None, block_tables, temps, budgets,
                    carry=infl.handle, overrides=overrides),
                [seq for seq, *_ in plan + join_plan])
        now = time.perf_counter()
        nxt = _InflightChunk(handle, seqs, budgets, dispatch_s=now - t_asm,
                             dispatched_at=now)
        self.pipeline_depth_hist[len(self._inflight) + 1] += 1
        self._start_fetch(nxt)
        self._count_step()
        return nxt

    def _process_chunk(self, infl: _InflightChunk) -> None:
        """Commit an in-flight chunk's tokens from its dispatch snapshot
        (cancellations are left to the fresh path: a carried chunk may
        already run on rows a cancel would free). While the fetch lane
        waits for the transfer, this thread services arrivals."""
        box = infl.fetch_box
        with self._prof.span("engine.chunk_fetch"):
            self._service_while(box["ev"])
        if box["err"] is not None:
            self._fail_inflight(f"chunk fetch failed: {box['err']}")
            raise box["err"]
        out, device_s, readback_s, overlapped_s = box["out"]
        pf_first = None
        if infl.pf is not None:
            out, pf_first = out
        if self._usage.enabled or self._cp.enabled:
            # Attribute before committing: a row that finishes in the
            # commit loop finalizes its ledger record there and must
            # already carry this chunk's share.
            parts = []
            decode_rows = []
            for slot in range(self.spec.batch_size):
                seq = infl.seqs[slot]
                if seq is not None and seq.slot == slot:
                    w = max(1, int(infl.budgets[slot]))
                    parts.append((seq, w, False))
                    decode_rows.append((seq, w))
            if infl.pf is not None:
                for seq, n_tok, _final in infl.pf:
                    parts.append((seq, n_tok, seq.todo_rebuild))
            if self._usage.enabled:
                self._charge_step(device_s, parts)
            if self._cp.enabled:
                # Serial cost = novel device time + readback: overlapped
                # spans are already excluded by timed_fetch.
                self._cp_decode_share(device_s + readback_s, parts,
                                      decode_rows)
        tok0 = self.tokens_generated_total
        for slot in range(self.spec.batch_size):
            seq = infl.seqs[slot]
            if seq is None or seq.slot != slot:
                continue    # finished while the chunk was in flight
            self._commit_row(seq, out[slot], int(infl.budgets[slot]))
            self._flush_emits(seq)
        if infl.pf is not None:
            self._finish_mixed_prefills(infl.pf, pf_first)
        self._telemetry.note_step(infl.dispatch_s, device_s, readback_s,
                                  self.tokens_generated_total - tok0,
                                  overlapped_s=overlapped_s)
        self._set_gauges()

    # -- usage attribution ------------------------------------------------------

    def _cp_decode_share(self, chunk_s: float, parts, decode_rows) -> None:
        """The decode rows' pro-rata share of one chunk's serial device
        cost into ``cp_decode_s`` (the critical path's decode
        compute/stall split). ``parts`` is every ``(seq, weight, waste)``
        the chunk ran, prefill slices included; ``decode_rows`` the
        ``(seq, weight)`` subset decoding."""
        if chunk_s <= 0:
            return
        total_w = 0
        for _, w, _ in parts:
            total_w += w
        if total_w <= 0:
            return
        for seq, w in decode_rows:
            seq.cp_decode_s += chunk_s * (w / total_w)

    def _charge_step(self, device_s: float, parts) -> None:
        """Split one measured chunk's device seconds pro-rata across the
        rows and slices that rode it: ``parts`` is ``[(seq, weight,
        waste)]``, weight the decode budget or the slice's tokens,
        ``waste`` a rebuild's re-prefill (work a preemption already paid
        for once). Plain float adds; one conservation note a chunk."""
        u = self._usage
        if not u.enabled or device_s <= 0:
            return
        total_w = 0
        for _, w, _ in parts:
            total_w += w
        attributed = 0.0
        if total_w > 0:
            for seq, w, waste in parts:
                ru = seq.usage
                if ru is None:
                    continue
                share = device_s * (w / total_w)
                if waste:
                    ru.waste_s += share
                    if not ru.waste_reason:
                        ru.waste_reason = "preempt"
                else:
                    ru.device_s += share
                attributed += share
        u.note_step(device_s, attributed)

    def _usage_pages(self, seq: _Sequence) -> None:
        """Refresh the page-seconds tracker with ``seq``'s holding: radix
        matched pages are shared (charged fractionally across their
        sharers), the rest exclusive. After every page-set change, never
        per token."""
        u = self._usage
        if not u.enabled or seq.usage is None:
            return
        shared = (seq.prefix_match.pages
                  if seq.prefix_match is not None else ())
        u.tracker.update(seq.req.id, len(seq.pages) - len(shared), shared)

    def _offload_fetch(self, fn, lane: str = "chunk") -> Dict:
        """Run a blocking fetch on a fetch lane (a thread that only waits
        on events and reads host memory); returns its completion box
        ``{ev, out, err}``, which the caller waits on through
        :meth:`_service_while`. Two lanes, so that a prefill's first
        token never queues behind a chunk's fetch."""
        lanes = self._fetch_lanes
        if lane not in lanes:
            q: queue.Queue = queue.Queue()
            t = threading.Thread(target=self._fetch_loop, args=(q,),
                                 name=f"fetch-{lane}-{self.name}",
                                 daemon=True)
            t.start()
            lanes[lane] = (t, q)
        box = {"ev": threading.Event(), "out": None, "err": None}
        lanes[lane][1].put((fn, box))
        return box

    def _start_fetch(self, infl: _InflightChunk) -> None:
        """The chunk's fetch on the chunk lane, through the telemetry's
        timed fetch: the box then holds ``(tokens, device_s, readback_s,
        overlapped_s)``."""
        infl.fetch_box = self._offload_fetch(
            lambda: self._telemetry.timed_fetch(
                infl.handle, dispatched_at=infl.dispatched_at))

    @staticmethod
    def _fetch_loop(q: queue.Queue) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            fn, box = item
            try:
                box["out"] = fn()
            except Exception as e:  # noqa: BLE001 — re-raised by the waiter
                box["err"] = e
            box["ev"].set()

    def _service_while(self, ev: threading.Event) -> None:
        """Service arrivals while a fetch completes: ingest, free-slot
        admission and the admitted wave's first prefill bucket, all of
        which only queue work behind what is in flight."""
        t0 = time.perf_counter()
        warned = False
        while not ev.wait(0.002):
            if self._wake.is_set():
                self._wake.clear()
                self._ingest()
                if self._admit():
                    self._advance_prefill()
            if not warned and time.perf_counter() - t0 > 5.0:
                log.warning("device transfer stalled > 5 s (engine %s keeps "
                            "servicing arrivals)", self.name)
                warned = True
        if warned:
            self.stall_events += 1
            self.stall_ms_total += (time.perf_counter() - t0) * 1e3

    def _dispatch(self, fn, seqs: List[_Sequence]):
        """Run an executor dispatch; if it raises, fail ``seqs`` and every
        chunk in flight (their carries are lost) and raise again."""
        try:
            return fn()
        except Exception as e:
            self._fail(seqs, f"dispatch failed: {e}")
            self._fail_inflight(f"dispatch failed: {e}")
            raise

    def _fail(self, seqs, error: str) -> None:
        for seq in seqs:
            seq.first_handle = None
            seq.mixed_pending = False
            if seq.slot is not None:
                self._finish_active(seq, "error", error)

    def _fail_inflight(self, error: str) -> None:
        """Fail every sequence that rides a chunk in flight and drop the
        chunks."""
        chunks, self._inflight = list(self._inflight), deque()
        for c in chunks:
            self._fail([s for i, s in enumerate(c.seqs)
                        if s is not None and s.slot == i]
                       + [s for s, _n, _f in c.pf or ()], error)

    # -- completions -----------------------------------------------------------

    def _completion_pool(self) -> _CompletionPool:
        """Made at first use, from the engine thread only."""
        if self._completion is None:
            self._completion = _CompletionPool(self._completion_workers,
                                               self.name)
        return self._completion

    def _drain_completions(self) -> bool:
        if self._completion is not None:
            return self._completion.drain()
        return True

    def _flush_emits(self, seq: _Sequence) -> None:
        """Hand a sequence's buffered tokens to its stream callback as one
        completion job (a chunk's tokens at once)."""
        if not seq.pending_emit:
            return
        toks, seq.pending_emit = seq.pending_emit, []
        handle, req_id = seq.handle, seq.req.id

        def emit() -> None:
            for t in toks:
                cb = handle._on_token
                if cb is None:
                    return
                try:
                    cb(t)
                except Exception:  # noqa: BLE001 — broken stream consumer
                    log.exception("on_token callback of %s failed; "
                                  "detaching", req_id)
                    handle._on_token = None

        self._completion_pool().submit(req_id, emit)

    def _deliver_finish(self, seq: _Sequence, reason: str,
                        error: str) -> None:
        """The request-facing tail of :meth:`_finish` on the completion
        pool: the trace record, detokenization and the handle's
        completion. Runs after the sequence's last token batch (same
        request key, one FIFO thread): tokens, then done."""
        try:
            self._record_trace(seq, reason)
        except Exception:  # noqa: BLE001 — tracing must not block delivery
            log.exception("trace record failed for %s", seq.req.id)
        self._finish_handle(seq, reason, error)

    def _finish_handle(self, seq: _Sequence, reason: str,
                       error: str) -> None:
        seq.handle._finish(GenResult(
            text=self.tokenizer.decode(seq.generated),
            tokens=list(seq.generated),
            prompt_tokens=len(seq.prompt_ids),
            cached_tokens=seq.cached_len,
            finish_reason=reason,
            error=error))

    # -- commit ----------------------------------------------------------------

    def _commit_row(self, seq: _Sequence, row: np.ndarray,
                    budget: int) -> None:
        """Commit one row of a chunk. Token j's input was written at
        ``seq.pos`` when it was fed — mirroring the device loop."""
        for j in range(budget):
            nxt = int(row[j])
            seq.written_ids.append(seq.last_token)
            seq.pos += 1
            self._commit_token(seq, nxt)
            if seq.slot is None:   # finished (eos/length)
                break

    def _commit_token(self, seq: _Sequence, nxt: int) -> None:
        if nxt == self.spec.eos_id:
            self._finish_active(seq, "eos")
            return
        seq.generated.append(nxt)
        seq.last_token = nxt
        self.tokens_generated_total += 1
        if self._m is not None:
            self._m.generated[seq.req.priority].inc()
        handle = seq.handle
        if len(seq.generated) == 1:
            handle.marks.setdefault("first_token", time.perf_counter())
            if self._cp.enabled:
                # The process's first committed token closes its boot
                # decomposition (one flag check after it fires).
                boot_note_first_token()
        if handle._on_token is not None:
            if self._completion_workers > 0:
                seq.pending_emit.append(nxt)
            else:
                try:
                    handle._on_token(nxt)
                except Exception:  # noqa: BLE001 — broken stream consumer
                    log.exception("on_token callback of %s failed; "
                                  "detaching", seq.req.id)
                    handle._on_token = None
        limit = seq.req.max_new_tokens or self.max_decode_steps
        if len(seq.generated) >= limit:
            self._finish_active(seq, "length")

    # -- finish --------------------------------------------------------------

    def _finish_active(self, seq: _Sequence, reason: str,
                       error: str = "") -> None:
        if self._cp.enabled and seq.generated:
            # Decode ends here: what follows (page trim, prefix publish,
            # pin, detokenization and the handle's finish on the
            # completion pool) is the "completion" segment.
            seq.handle.marks.setdefault("decode_done", time.perf_counter())
        if seq.slot is not None:
            self.executor.release_slot(seq.slot)
            self._slots[seq.slot] = None
            seq.slot = None
        conv = seq.req.conversation_id
        # Publish the finished sequence's full-block KV prefix into the
        # radix tree (which takes page refs of its own; the sequence's
        # are released below as before). Skipped on a written_ids/pos
        # mismatch: a mis-keyed block would serve wrong KV.
        publish = (self._prefix_cache is not None
                   and reason in ("eos", "length")
                   and len(seq.written_ids) == seq.pos)
        handle_rec = None
        if conv and reason in ("eos", "length"):
            # Trim pages past the written length before pinning: decode
            # budgets allocate ahead.
            keep = PageAllocator.pages_for(seq.pos, self.spec.page_size)
            if len(seq.pages) > keep:
                extra = seq.pages[keep:]
                seq.pages = seq.pages[:keep]
                seq.block_table[keep:keep + len(extra)] = 0
                self.allocator.free(extra)
            with self._mu:
                if conv in self._conv_drop_pending:
                    self._conv_drop_pending.discard(conv)
                    if seq.prefix_match is not None:
                        # Unlock before invalidating: this sequence's own
                        # match locks the path the prune must take.
                        self._prefix_cache.unlock(seq.prefix_match)
                        seq.prefix_match = None
                    self.allocator.free(seq.pages)
                    if self._prefix_cache is not None:
                        self._prefix_cache.invalidate(seq.written_ids)
                else:
                    if len(seq.written_ids) != seq.pos:
                        log.warning("written_ids/pos mismatch for %s: "
                                    "%d vs %d", seq.req.id,
                                    len(seq.written_ids), seq.pos)
                    if publish:
                        self._prefix_cache.insert(seq.written_ids,
                                                  list(seq.pages))
                    self._conv_cache[conv] = _ConvKV(
                        pages=list(seq.pages),
                        block_table=seq.block_table.copy(),
                        length=seq.pos,
                        last_used=self._now(),
                        tokens=list(seq.written_ids),
                        pending=(seq.last_token if reason == "length"
                                 else None))
                    self.allocator.pin(conv, seq.pages)
                    if self._usage.enabled:
                        # Between turns the pin's meter bills the
                        # conversation and tenant until adoption or drop.
                        self._usage.pin_kv(conv, len(seq.pages),
                                           seq.req.tenant_id)
                    if self._prefix_cache is not None:
                        handle_rec = {"length": seq.pos,
                                      "pages": len(seq.pages),
                                      "updated_at": time.time(),
                                      "tier": "hbm"}
            seq.pages = []
        elif publish and seq.pages:
            self._prefix_cache.insert(seq.written_ids, list(seq.pages))
        if handle_rec is not None and self._state_manager is not None:
            # Outside self._mu: the state manager's lock is above the
            # engine's (its eviction hooks call back in).
            try:
                self._state_manager.record_prefix_handle(conv, handle_rec)
            except Exception:  # noqa: BLE001 — accounting, not a gate
                log.exception("prefix-handle record failed for %s", conv)
        self._finish(seq, reason, error)

    def _finish(self, seq: _Sequence, reason: str, error: str = "",
                waste_reason: str = "") -> None:
        if seq.prefix_match is not None:
            self._prefix_cache.unlock(seq.prefix_match)
            seq.prefix_match = None
        if seq.pages:
            self.allocator.free(seq.pages)
            seq.pages = []
        conv = seq.req.conversation_id
        if conv:
            with self._mu:
                if self._conv_busy.get(conv) == seq.order:
                    del self._conv_busy[conv]
                self._conv_drop_pending.discard(conv)
        if seq.usage is not None and self._usage.enabled:
            # Close the attribution: page-seconds from the tracker, the
            # prefix-reuse credit from the learned prefill rate, then one
            # ledger finalize. A failed or cancelled request's device time
            # all becomes waste (``waste_reason`` names the cause when the
            # caller knows it: "crash" from the crash recovery).
            ru = seq.usage
            ru.kv_page_s += self._usage.tracker.close(seq.req.id)
            if seq.cached_len > 0 and self.prefill_tps_ewma:
                ru.saved_prefill_device_s = (
                    seq.cached_len / self.prefill_tps_ewma)
            seq.handle.usage = self._usage.finalize(
                seq.req.id, ru,
                tenant=seq.req.tenant_id,
                priority=seq.req.priority.tier_name,
                engine=self.name,
                conversation=conv,
                tokens=len(seq.generated),
                prompt_tokens=len(seq.prompt_ids),
                ok=reason in ("eos", "length"),
                waste_reason=waste_reason or (
                    "cancelled" if reason == "cancelled" else "error"))
        if self._completion_workers > 0:
            # Engine state is released above; the request-facing tail
            # leaves the dispatch path, after the sequence's tokens.
            self._flush_emits(seq)
            self._completion_pool().submit(
                seq.req.id, lambda: self._deliver_finish(seq, reason, error))
            return
        self._record_trace(seq, reason)
        self._finish_handle(seq, reason, error)

    def _record_trace(self, seq: _Sequence, reason: str) -> None:
        """Stamp the engine-side lifecycle events of a finished sequence
        into the flight recorder, in one locked append. Handle marks are
        perf_counter-based; the wall anchor shifts them onto the shared
        clock. One call per request, never per token."""
        rec = observability.get_recorder()
        if not rec.enabled:
            return
        anchor = observability.perf_anchor()
        prio = seq.req.priority.tier_name
        marks = seq.handle.marks
        events = [(stage, marks[stage] + anchor,
                   {"engine": self.name, "priority": prio})
                  for stage in ("admitted", "prefill_start", "prefill_done",
                                "first_token", "decode_done")
                  if stage in marks]
        # A cancellation (the client closed the stream or gave up) is a
        # terminal of its own: neither a success nor a failure.
        terminal = ("completed" if reason in ("eos", "length")
                    else "cancelled" if reason == "cancelled"
                    else "failed")
        meta = {"engine": self.name, "priority": prio,
                "finish_reason": reason,
                "completion_tokens": len(seq.generated),
                "prompt_tokens": len(seq.prompt_ids),
                "cached_tokens": seq.cached_len,
                "tenant": seq.req.tenant_id}
        if self._cp.enabled and seq.cp_decode_s > 0:
            # The decode span's attribution, for the critical path's
            # compute/stall split.
            meta["decode_device_s"] = round(seq.cp_decode_s, 6)
        if seq.handle.usage is not None:
            meta["usage"] = seq.handle.usage
        events.append((terminal, time.time(), meta))
        rec.record_many(seq.req.id, events)

    def _expire_pins(self) -> None:
        if self.kv_pin_ttl <= 0:
            return
        now = self._now()
        with self._mu:
            stale = [cid for cid, kv in self._conv_cache.items()
                     if now - kv.last_used > self.kv_pin_ttl]
            for cid in stale:
                # The pin TTL ends HBM residency only: the radix tree keeps
                # the prefix for the next turn.
                self._drop_conversation_locked(cid, invalidate=False)
        self._flush_tier_notes()

    def _hbm_snapshot(self) -> Dict:
        """HBM accounting for the device telemetry: pool occupancy and
        fragmentation, pinned and prefix-cache pages from the host
        allocator, and the card's byte totals from the executor
        (``hbm_info``). Called from scrapes and stats, never the step
        path."""
        alloc = self.allocator
        used, total = alloc.used(), alloc.total
        out: Dict = {
            "kv_pages_used": used,
            "kv_pages_total": total,
            "kv_pool_occupancy": round(used / total, 4) if total else 0.0,
            "kv_pool_fragmentation": alloc.fragmentation(),
            "pinned_pages": alloc.pinned_pages(),
            "prefix_cache_pages": (self._prefix_cache.pages
                                   if self._prefix_cache is not None
                                   else 0),
        }
        info_fn = getattr(self.executor, "hbm_info", None)
        if info_fn is not None:
            try:
                out["chips"] = info_fn()
            except Exception:  # noqa: BLE001 — accounting, not a gate
                log.exception("hbm_info failed for %s", self.name)
        return out

    # -- stats ---------------------------------------------------------------

    def get_stats(self) -> Dict:
        with self._mu:
            pending = len(self._pending) + len(self._inbox)
            cached = len(self._conv_cache)
        out = {
            "name": self.name,
            "slots": self.spec.batch_size,
            "active": sum(1 for s in self._slots if s is not None),
            "pending": pending,
            "decode_steps": self.steps,
            "tokens_generated": self.tokens_generated_total,
            "kv_pages_used": self.allocator.used(),
            "kv_pages_total": self.allocator.total,
            "cached_conversations": cached,
            "stall_events": self.stall_events,
            "stall_ms_total": round(self.stall_ms_total, 1),
            "prefill_stall_events": self.prefill_stall_events,
            "prefill_stall_ms_total": round(self.prefill_stall_ms_total, 1),
            "prefill_tps_ewma": (round(self.prefill_tps_ewma, 1)
                                 if self.prefill_tps_ewma else None),
            "profile": self._prof.summary(),
            # Step decomposition, live tok/s and MFU, HBM, captures.
            "device": self._telemetry.snapshot(),
        }
        if self._pipe_cfg is not None:
            out["pipeline"] = {
                "depth": self._pipe_depth,
                "completion_workers": self._completion_workers,
                "depth_hist": {str(k): v for k, v in
                               sorted(self.pipeline_depth_hist.items())
                               if v},
                "overlap_ratio": self._telemetry.overlap_ratio(),
            }
        if self._mixed_cfg is not None:
            out["mixed_batch"] = {
                "steps": self.mixed_steps,
                "prefill_tokens": self.mixed_prefill_tokens_total,
                "prefill_token_budget":
                    int(self._mixed_cfg.prefill_token_budget),
            }
        if self._prefix_cache is not None:
            pc = self._prefix_cache.get_stats()
            total = self.prefix_hits + self.prefix_misses
            pc["admission_hits"] = self.prefix_hits
            pc["admission_misses"] = self.prefix_misses
            pc["admission_hit_rate"] = (
                round(self.prefix_hits / total, 4) if total else 0.0)
            pc["cached_prefill_tokens"] = self.cached_prefill_tokens_total
            pc["shared_pages"] = self.allocator.shared_pages()
            out["prefix_cache"] = pc
        return out
