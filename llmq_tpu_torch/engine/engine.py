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
- **Paged KV with conversation pinning.** A finished conversation keeps
  its pages pinned; the next turn adopts them and prefills only its new
  tokens on top (continuation prefill). Pins end on the pin TTL, on
  delete, or under pool pressure (LRU), which frees their pages.
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

Left to later work (``ROADMAP.md``): preemption with page release,
cache-aware scheduling, metrics, tenancy, tiering and speculation.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from llmq_tpu_torch.core.types import Message, Priority
from llmq_tpu_torch.engine.executor import Executor
from llmq_tpu_torch.engine.kv_allocator import PageAllocator
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.prefixcache import PrefixCache

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


def realtime_admission_cap(step_ms: Optional[float]) -> int:
    """Decode steps a waiting REALTIME request may sit behind: about
    ``REALTIME_ADMISSION_MS`` of steps, 2 to 16; 2 while no step has been
    timed."""
    if not step_ms:
        return 2
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
        #: ``prefill_done``, ``first_token`` (first committed token).
        self.marks: Dict[str, float] = {}
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
                 "prefill_start", "carry", "written_ids", "todo_ids",
                 "todo_pos", "eff_prio", "arrival", "first_handle",
                 "prefix_match", "reuse_counted", "mixed_pending",
                 "pending_emit")

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
        #: Token ids whose KV occupies positions [0, pos).
        self.written_ids: List[int] = []
        #: Incremental prefill: tokens not yet run, next write position.
        self.todo_ids: List[int] = []
        self.todo_pos = 0
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
    ``(seq, n_tokens, final)`` slices fused into step 0."""

    __slots__ = ("handle", "seqs", "budgets", "fetch_box", "pf")

    def __init__(self, handle, seqs, budgets, pf=None) -> None:
        self.handle = handle
        self.seqs = seqs          # List[Optional[_Sequence]], len B
        self.budgets = budgets    # np.ndarray (B,) int32
        self.fetch_box: Optional[Dict] = None
        self.pf = pf


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


class InferenceEngine:
    def __init__(self, executor: Executor,
                 tokenizer: Optional[ByteTokenizer] = None, *,
                 name: str = "engine0", max_decode_steps: int = 256,
                 preemption: bool = True, kv_pin_ttl: float = 600.0,
                 tier_max_wait: Optional[Dict[Priority, float]] = None,
                 mixed_batch=None, prefix_cache=None,
                 async_pipeline=None) -> None:
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
        self._mu = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- submission ----------------------------------------------------------

    def submit(self, req: GenRequest, *, on_token=None) -> GenHandle:
        handle = GenHandle(req)
        if on_token is not None:
            # Attached before the engine can see the sequence, so no
            # committed token is missed.
            handle.on_token(on_token)
        seq = _Sequence(req, handle, next(self._order),
                        self.spec.max_pages_per_seq)
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
        msg.metadata["usage"] = {
            "prompt_tokens": res.prompt_tokens,
            "cached_tokens": res.cached_tokens,
            "completion_tokens": len(res.tokens),
            "finish_reason": res.finish_reason,
        }

    def cached_conversations(self) -> List[str]:
        with self._mu:
            return list(self._conv_cache)

    def drop_conversation(self, conv_id: str) -> None:
        """Delete a conversation's cached KV: its pin and, with the
        prefix cache on, every stream it published to the radix tree."""
        with self._mu:
            self._drop_conversation_locked(conv_id)

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

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                did_work = self.step()
            except Exception:  # noqa: BLE001 — the loop must keep serving
                log.exception("engine step failed")
                did_work = False
            if not did_work:
                self._wake.wait(0.005)
                self._wake.clear()

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

    def _least_urgent_active(self) -> Optional[_Sequence]:
        """Least urgent prefilled slot holder (a mid-prefill sequence
        can't resume in place, so it is never a slot-preemption victim)."""
        worst: Optional[_Sequence] = None
        for s in self._slots:
            if s is None or not s.prefilled:
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
                    self._preempt(victim)
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

    def _preempt(self, victim: _Sequence) -> None:
        """Step-boundary preemption: the victim's slot is handed over; its
        KV pages stay resident and it resumes without re-prefill."""
        assert victim.slot is not None
        self._slots[victim.slot] = None
        self.executor.release_slot(victim.slot)
        victim.slot = None
        heapq.heappush(self._pending, (victim.eff_prio, victim.order, victim))
        log.info("preempted %s (%s)", victim.req.id,
                 victim.req.priority.tier_name)

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

    def _reclaim_idle_conversation(self) -> bool:
        """LRU-evict one idle pinned conversation. True if pages freed."""
        with self._mu:
            if not self._conv_cache:
                return False
            cid = min(self._conv_cache,
                      key=lambda c: self._conv_cache[c].last_used)
            self._drop_conversation_locked(cid, invalidate=False)
        log.info("evicted conversation KV %s under pool pressure", cid)
        return True

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, shedding while the pool is short, cheapest
        first: zero-ref radix leaves (no running sequence reads them; a
        later request merely prefills what it would have reused), then
        idle pinned conversations (LRU). Neither touches a row that a
        chunk in flight decodes."""
        while True:
            pages = self.allocator.alloc(n)
            if pages is not None:
                return pages
            deficit = n - self.allocator.available()
            if (self._prefix_cache is not None
                    and self._prefix_cache.evict_pages(deficit) > 0):
                continue
            if not self._reclaim_idle_conversation():
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

        start_pos = seq.cached_len
        # KV to build: the carried token and the prompt (the newest
        # sampled token's KV is written by its decode step).
        ids = seq.carry + seq.prompt_ids
        capacity = self.spec.max_pages_per_seq * self.spec.page_size
        if start_pos + len(ids) + 1 > capacity and start_pos > 0:
            # The cached prefix + new tokens exceed the block table: fold
            # the prefix into a from-scratch prefill so the window can
            # slide. The fold moves the history into ``carry``, so a
            # retried admission recomputes the same stream.
            seq.carry = seq.written_ids + seq.carry
            seq.written_ids = []
            ids = seq.carry + seq.prompt_ids
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
            pages = self._alloc_pages(need)
            if pages is None:
                if match_seed is not None:
                    # Give the matched pages back: a retry recomputes ids
                    # from scratch.
                    self._unmatch(seq)
                return False
            seq.block_table[have:have + need] = pages
            seq.pages.extend(pages)
        seq.todo_ids = ids
        seq.todo_pos = start_pos
        if start_pos == 0 or match_seed is not None:
            # written_ids mirrors [0, pos): the matched prefix, if any.
            seq.written_ids = list(match_seed or [])
        seq.prefill_ids = ids
        seq.prefill_start = start_pos
        if self._prefix_cache is not None and not seq.reuse_counted:
            seq.reuse_counted = True
            if seq.cached_len > 0:
                self.prefix_hits += 1
                self.cached_prefill_tokens_total += seq.cached_len
            else:
                self.prefix_misses += 1
        seq.slot = slot
        self._slots[slot] = seq        # slot held; prefilled=False
        seq.handle.marks.setdefault("admitted", time.perf_counter())
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
        if self._mixed_on() and any(s is not None and s.prefilled
                                    for s in self._slots):
            # Mixed mode owns prefill while decode rows are hot: the next
            # mixed chunk runs these sequences' slices inside the decode
            # program (budget-bounded) instead of whole buckets first.
            return reaped
        cands.sort(key=lambda s: s.sort_key())
        ex = self.executor
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
                handles.append(self._dispatch(
                    lambda: ex.prefill_async(*reqs[0]), seqs))
            else:
                handles.extend(self._dispatch(
                    lambda: ex.prefill_multi_async(reqs), seqs))
        for (seq, chunk), h in zip(work, handles):
            seq.todo_pos += len(chunk)
            seq.pos = seq.todo_pos
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
        box = self._offload_fetch(lambda: gather(handles), lane="resolve")
        self._service_while(box["ev"])
        if box["err"] is not None:
            self._fail(pending, f"prefill fetch failed: {box['err']}")
            raise box["err"]
        for seq, first, h in zip(pending, box["out"], handles):
            if seq.first_handle is not h or seq.slot is None:
                continue    # cancelled or finished during the wait
            seq.first_handle = None
            self._complete_prefill(seq, int(first))
            self._flush_emits(seq)   # the first token does not wait a chunk
        return True

    def _complete_prefill(self, seq: _Sequence, first: int) -> None:
        """Admission completes after the final prefill chunk: ``first``
        is the token sampled at its last position."""
        seq.prefilled = True
        seq.handle.marks.setdefault("prefill_done", time.perf_counter())
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
            seq.written_ids.extend(sl)
            infl_pf.append((seq, len(sl), not seq.todo_ids))
        handle = self._dispatch(
            lambda: self.executor.mixed_chunk_start(
                tokens, positions, block_tables, temps, budgets, pf),
            active + [seq for seq, _ in pf_plan])
        seqs: List[Optional[_Sequence]] = [None] * self.spec.batch_size
        for seq in active:
            seqs[seq.slot] = seq
        for seq, _n, _final in infl_pf:
            seq.mixed_pending = True
        self._push_chunk(_InflightChunk(handle, seqs, budgets, pf=infl_pf))
        self.mixed_steps += 1
        self.mixed_prefill_tokens_total += sum(len(sl) for _, sl in pf_plan)
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
        pages = self._alloc_pages(need)
        if pages is None:
            return False
        seq.block_table[len(seq.pages):len(seq.pages) + need] = pages
        seq.pages.extend(pages)
        return True

    def _admission_cap(self) -> int:
        """Decode-chunk cap while an urgent request waits: the chunk
        length is its admission latency. No urgent waiter → no cap."""
        if not self._pending or self._pending[0][0] > int(Priority.HIGH):
            return 1 << 30
        if self._pending[0][0] > int(Priority.REALTIME):
            return 16
        return realtime_admission_cap(getattr(self.executor, "step_ms",
                                              None))

    def _budget_chunk_rows(self, chunk: int, rows) -> Dict[int, int]:
        """Eligibility and budgets of the rows of the next fresh chunk
        (shared by the plain and the mixed chunk): finish cancelled and
        full rows, back each survivor's budget with pages. A joining row
        (final prefill dispatched, not yet resolved) gets one token less:
        its resolve commits the first. Returns ``seq.order → budget``."""
        budgets_by_order: Dict[int, int] = {}
        for seq in rows:
            if seq.slot is None:
                continue
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
                # Pool exhausted by running sequences: preemption with
                # page release is not ported, so the request fails
                # rather than being silently truncated.
                self._finish_active(seq, "error",
                                    "KV pool exhausted during decode")
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
            joining = [s for s in self._slots
                       if s is not None and not s.prefilled
                       and s.first_handle is not None and not s.todo_ids
                       and not s.handle.cancelled]
        active = [s for s in self._slots if s is not None and s.prefilled]
        if not active and not joining:
            return False
        budgets_by_order = self._budget_chunk_rows(chunk, active + joining)
        active = [s for s in self._slots if s is not None and s.prefilled]
        joining = [s for s in joining
                   if s.slot is not None and s.first_handle is not None
                   and s.order in budgets_by_order]
        if not active and not joining:
            return False
        rows = active + joining
        tokens, positions, block_tables, temps, budgets = \
            self._chunk_arrays(rows, budgets_by_order)
        if chunk > 1:
            overrides = [(s.slot, s.first_handle, s.pos) for s in joining]
            handle = self._dispatch(
                lambda: self.executor.decode_chunk_start(
                    tokens, positions, block_tables, temps, budgets,
                    overrides=overrides), rows)
            seqs: List[Optional[_Sequence]] = [None] * self.spec.batch_size
            for seq in rows:
                seqs[seq.slot] = seq
            self._push_chunk(_InflightChunk(handle, seqs, budgets))
            return True
        # One-step chunks: the blocking single step.
        out = self.executor.decode(tokens, positions, block_tables,
                                   temps)[:, None]
        self.steps += 1
        for seq in active:
            self._commit_row(seq, out[seq.slot], int(budgets[seq.slot]))
            self._flush_emits(seq)
        return True

    def _push_chunk(self, infl: _InflightChunk) -> None:
        self._inflight.append(infl)
        self.pipeline_depth_hist[len(self._inflight)] += 1
        self._start_fetch(infl)
        self.steps += 1

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
        budgets = np.zeros(B, np.int32)
        block_tables = np.zeros((B, self.spec.max_pages_per_seq), np.int32)
        temps = np.zeros(B, np.float32)
        for seq, slot, b, need in plan + join_plan:
            if need > 0:
                pages = self.allocator.alloc(need)
                assert pages is not None    # checked above
                seq.block_table[len(seq.pages):len(seq.pages) + need] = pages
                seq.pages.extend(pages)
            budgets[slot] = b
            block_tables[slot] = seq.block_table
            temps[slot] = seq.req.temperature
        overrides = [(slot, seq.first_handle, seq.pos)
                     for seq, slot, _, _ in join_plan]
        seqs = list(infl.seqs)
        for seq, slot, _, _ in join_plan:
            seqs[slot] = seq
        handle = self._dispatch(
            lambda: self.executor.decode_chunk_start(
                None, None, block_tables, temps, budgets,
                carry=infl.handle, overrides=overrides),
            [seq for seq, *_ in plan + join_plan])
        nxt = _InflightChunk(handle, seqs, budgets)
        self.pipeline_depth_hist[len(self._inflight) + 1] += 1
        self._start_fetch(nxt)
        self.steps += 1
        return nxt

    def _process_chunk(self, infl: _InflightChunk) -> None:
        """Commit an in-flight chunk's tokens from its dispatch snapshot
        (cancellations are left to the fresh path: a carried chunk may
        already run on rows a cancel would free). While the fetch lane
        waits for the transfer, this thread services arrivals."""
        box = infl.fetch_box
        self._service_while(box["ev"])
        if box["err"] is not None:
            self._fail_inflight(f"chunk fetch failed: {box['err']}")
            raise box["err"]
        out, pf_first = box["out"], None
        if infl.pf is not None:
            out, pf_first = out
        for slot in range(self.spec.batch_size):
            seq = infl.seqs[slot]
            if seq is None or seq.slot != slot:
                continue    # finished while the chunk was in flight
            self._commit_row(seq, out[slot], int(infl.budgets[slot]))
            self._flush_emits(seq)
        if infl.pf is not None:
            self._finish_mixed_prefills(infl.pf, pf_first)

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
        infl.fetch_box = self._offload_fetch(infl.handle.fetch)

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
        """The request-facing tail of :meth:`_finish`: detokenization and
        the handle's completion. Runs after the sequence's last token
        batch (same request key, one FIFO thread): tokens, then done."""
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
        handle = seq.handle
        if len(seq.generated) == 1:
            handle.marks.setdefault("first_token", time.perf_counter())
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
            seq.pages = []
        elif publish and seq.pages:
            self._prefix_cache.insert(seq.written_ids, list(seq.pages))
        self._finish(seq, reason, error)

    def _finish(self, seq: _Sequence, reason: str, error: str = "") -> None:
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
        if self._completion_workers > 0:
            # Engine state is released above; the request-facing tail
            # leaves the dispatch path, after the sequence's tokens.
            self._flush_emits(seq)
            self._completion_pool().submit(
                seq.req.id, lambda: self._deliver_finish(seq, reason, error))
            return
        self._deliver_finish(seq, reason, error)

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
        }
        if self._pipe_cfg is not None:
            out["pipeline"] = {
                "depth": self._pipe_depth,
                "completion_workers": self._completion_workers,
                "depth_hist": {str(k): v for k, v in
                               sorted(self.pipeline_depth_hist.items())
                               if v},
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
