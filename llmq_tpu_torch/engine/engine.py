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
  keeps its KV pages and resumes without re-prefill.
- **Paged KV with conversation pinning.** A finished conversation keeps
  its pages pinned; the next turn adopts them and prefills only its new
  tokens on top (continuation prefill). Pins end on the pin TTL, on
  delete, or under pool pressure (LRU), which frees their pages.
- **Incremental prefill in admission waves.** Every admitted sequence
  runs one prefill bucket per engine step, so a long prompt never stalls
  decoding rows for its whole length. The step's chunks go out as waves
  of up to ``prefill_batch`` prompts, one program each
  (``prefill_multi_async``; a trailing single chunk takes the one-row
  program), without a host wait; the first tokens of the final chunks
  are fetched after the step's decode chunk, all in one transfer
  (``_resolve_prefills``).
- **Token-budget mixed batching** (``mixed_batch``). While decode rows
  are active, pending prefill runs as budgeted slices inside the first
  step of the decode chunk (executor ``mixed_chunk``), so a decode row
  waits for at most ``prefill_token_budget`` prefill tokens a chunk.

Left to later work (``ROADMAP.md``): the async decode pipeline (its
fetch lanes and device-side joins), the prefix cache, preemption with
page release, metrics, tenancy, tiering and speculation.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from llmq_tpu_torch.core.types import Message, Priority
from llmq_tpu_torch.engine.executor import Executor
from llmq_tpu_torch.engine.kv_allocator import PageAllocator
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

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
    cached_tokens: int = 0       # KV reused from the conversation cache
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
        self._done = threading.Event()
        self._cancelled = threading.Event()

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
                 "todo_pos", "eff_prio", "arrival", "first_handle")

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
        self.cached_len = 0       # prefix reused from conversation cache
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


class InferenceEngine:
    def __init__(self, executor: Executor,
                 tokenizer: Optional[ByteTokenizer] = None, *,
                 name: str = "engine0", max_decode_steps: int = 256,
                 preemption: bool = True, kv_pin_ttl: float = 600.0,
                 tier_max_wait: Optional[Dict[Priority, float]] = None,
                 mixed_batch=None) -> None:
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
        #: Token-budget mixed batching: a ``MixedBatchConfig`` (or
        #: anything with its fields). None or disabled keeps the unfused
        #: scheduling exactly.
        self._mixed_cfg = (mixed_batch if mixed_batch is not None
                           and getattr(mixed_batch, "enabled", False)
                           else None)
        self.mixed_steps = 0
        self.mixed_prefill_tokens_total = 0
        self._slots: List[Optional[_Sequence]] = [None] * self.spec.batch_size
        self._pending: List = []           # heap of (prio, order, _Sequence)
        self._inbox: List[_Sequence] = []  # submitted, not yet in heap
        self._conv_cache: Dict[str, _ConvKV] = {}
        self._conv_busy: Dict[str, int] = {}    # conv id → holder seq.order
        self._conv_drop_pending: set = set()    # dropped while busy
        self._order = itertools.count()
        self._mu = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- submission ----------------------------------------------------------

    def submit(self, req: GenRequest) -> GenHandle:
        handle = GenHandle(req)
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
        with self._mu:
            self._drop_conversation_locked(conv_id)

    def _drop_conversation_locked(self, conv_id: str) -> None:
        kv = self._conv_cache.pop(conv_id, None)
        if kv is not None:
            self.allocator.unpin(conv_id)
            self.allocator.free(kv.pages)
        elif conv_id in self._conv_busy:
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
        """One scheduling round: ingest, expire pins, admit, dispatch one
        prefill bucket per mid-prefill sequence (unless mixed batching
        owns prefill), then one chunk: mixed when decode rows and pending
        prefill coexist, else plain decode; then fetch the first tokens
        of the prefills dispatched so far. Dispatch comes before that
        fetch, as in the JAX engine's step with no chunk in flight, so
        the fetch waits behind work already queued. Returns True if any
        work happened. One stepper at a time."""
        self._ingest()
        self._expire_pins()
        admitted = self._admit()
        prefilled = self._advance_prefill()
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
                            and all(s is None for s in self._slots))
                if idle:
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
            if slot is None and self.preemption_enabled:
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

    def _reclaim_idle_conversation(self) -> bool:
        """LRU-evict one idle pinned conversation. True if pages freed."""
        with self._mu:
            if not self._conv_cache:
                return False
            cid = min(self._conv_cache,
                      key=lambda c: self._conv_cache[c].last_used)
            self._drop_conversation_locked(cid)
        log.info("evicted conversation KV %s under pool pressure", cid)
        return True

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, reclaiming idle pinned conversations
        (LRU first) while the pool is short."""
        while True:
            pages = self.allocator.alloc(n)
            if pages is not None:
                return pages
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
                return False
            seq.block_table[have:have + need] = pages
            seq.pages.extend(pages)
        seq.todo_ids = ids
        seq.todo_pos = start_pos
        if start_pos == 0:
            seq.written_ids = []
        seq.prefill_ids = ids
        seq.prefill_start = start_pos
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
        handle in ``first_handle`` for :meth:`_resolve_prefills`."""
        cands = [s for s in self._slots if s is not None and not s.prefilled
                 and s.first_handle is None]
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
            if len(grp) == 1:
                handles.append(ex.prefill_async(*reqs[0]))
            else:
                handles.extend(ex.prefill_multi_async(reqs))
        for (seq, chunk), h in zip(work, handles):
            seq.todo_pos += len(chunk)
            seq.pos = seq.todo_pos
            seq.written_ids.extend(chunk)
            if not seq.todo_ids:
                seq.first_handle = h        # fetched after this step's chunk
        return True

    def _resolve_prefills(self) -> bool:
        """Fetch the first tokens of the prefills dispatched so far and
        complete those admissions: every pending handle in ONE transfer
        (``gather_scalars``; ``InferenceEngine._resolve_prefills`` of the
        JAX package, whose fetch lanes are not ported: the fetch runs
        here on the engine thread)."""
        pending = [s for s in self._slots
                   if s is not None and s.first_handle is not None]
        if not pending:
            return False
        firsts = self.executor.gather_scalars([s.first_handle
                                               for s in pending])
        for seq, first in zip(pending, firsts):
            seq.first_handle = None
            self._complete_prefill(seq, int(first))
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
                and getattr(self.executor, "mixed_chunk", None) is not None)

    def _mixed_applicable(self) -> bool:
        """Run a mixed chunk this round: mixed batching is on, decode rows
        are active, and a mid-prefill slot has tokens left."""
        if not self._mixed_on():
            return False
        if not any(s is not None and s.prefilled for s in self._slots):
            return False
        return any(s is not None and not s.prefilled and s.todo_ids
                   and s.first_handle is None for s in self._slots)

    def _mixed_once(self) -> bool:
        """One mixed chunk: the active decode rows' chunk plus up to
        ``prefill_token_budget`` tokens of pending prefill slices in its
        first step. Streams are those of the unfused path: slices write
        the same K/V at the same positions, a prompt's final slice
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
        budgets_by_order = self._budget_chunk_rows(chunk)
        active = [s for s in self._slots if s is not None and s.prefilled]
        # Slices are packed after decode budgeting, which may have
        # finished rows and freed pages.
        cands = [s for s in self._slots
                 if s is not None and not s.prefilled and s.todo_ids]
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
        pf = []
        for seq, sl in pf_plan:
            seq.handle.marks.setdefault("prefill_start", time.perf_counter())
            pf.append((seq.slot, sl, seq.todo_pos, seq.block_table,
                       seq.req.temperature))
            seq.todo_ids = seq.todo_ids[len(sl):]
            seq.todo_pos += len(sl)
            seq.pos = seq.todo_pos
            seq.written_ids.extend(sl)
        out, pf_first = self.executor.mixed_chunk(
            tokens, positions, block_tables, temps, budgets, pf)
        self.mixed_steps += 1
        self.mixed_prefill_tokens_total += sum(len(sl) for _, sl in pf_plan)
        for seq in active:
            if seq.slot is not None:
                self._commit_row(seq, out[seq.slot], int(budgets[seq.slot]))
        self._finish_mixed_prefills(pf_plan, pf_first)
        return True

    def _finish_mixed_prefills(self, pf_plan, pf_first) -> None:
        """Complete the admissions whose final slice ran in this mixed
        chunk: their first token is ``pf_first[i]``."""
        for i, (seq, _sl) in enumerate(pf_plan):
            if seq.slot is None or seq.prefilled:
                continue
            if seq.handle.cancelled:
                self._finish_active(seq, "cancelled")
            elif not seq.todo_ids:
                self._complete_prefill(seq, int(pf_first[i]))

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

    def _budget_chunk_rows(self, chunk: int) -> Dict[int, int]:
        """Eligibility and budgets of the decode rows of the next chunk
        (shared by the plain and the mixed chunk): finish cancelled and
        full rows, back each survivor's budget with pages. Returns
        ``seq.order → budget``."""
        budgets_by_order: Dict[int, int] = {}
        for seq in [s for s in self._slots if s is not None and s.prefilled]:
            if seq.handle.cancelled:
                self._finish_active(seq, "cancelled")
                continue
            if seq.pos // self.spec.page_size >= self.spec.max_pages_per_seq:
                self._finish_active(seq, "length")  # block table exhausted
                continue
            budget = self._budget_for(seq, chunk)
            if not self._ensure_decode_pages(seq, budget):
                # Pool exhausted by running sequences: preemption with
                # page release is not ported, so the request fails
                # rather than being silently truncated.
                self._finish_active(seq, "error",
                                    "KV pool exhausted during decode")
                continue
            budgets_by_order[seq.order] = budget
        return budgets_by_order

    def _chunk_arrays(self, active: List[_Sequence],
                      budgets_by_order: Dict[int, int]):
        """Full-batch (tokens, positions, block_tables, temperatures,
        budgets) of a chunk; empty slots stay zero (budget 0)."""
        B = self.spec.batch_size
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        block_tables = np.zeros((B, self.spec.max_pages_per_seq), np.int32)
        temps = np.zeros(B, np.float32)
        budgets = np.zeros(B, np.int32)
        for seq in active:
            i = seq.slot
            tokens[i] = seq.last_token
            positions[i] = seq.pos
            block_tables[i] = seq.block_table
            temps[i] = seq.req.temperature
            budgets[i] = budgets_by_order[seq.order]
        return tokens, positions, block_tables, temps, budgets

    def _decode_once(self) -> bool:
        chunk = min(max(1, self.executor.chunk_size), self._admission_cap())
        budgets_by_order = self._budget_chunk_rows(chunk)
        active = [s for s in self._slots if s is not None and s.prefilled]
        if not active:
            return False
        tokens, positions, block_tables, temps, budgets = \
            self._chunk_arrays(active, budgets_by_order)
        if chunk > 1:
            out = self.executor.decode_chunk(tokens, positions, block_tables,
                                             temps, budgets)
        else:
            out = self.executor.decode(tokens, positions, block_tables,
                                       temps)[:, None]
        for seq in active:
            self._commit_row(seq, out[seq.slot], int(budgets[seq.slot]))
        return True

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
        if len(seq.generated) == 1:
            seq.handle.marks.setdefault("first_token", time.perf_counter())
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
                    self.allocator.free(seq.pages)
                else:
                    if len(seq.written_ids) != seq.pos:
                        log.warning("written_ids/pos mismatch for %s: "
                                    "%d vs %d", seq.req.id,
                                    len(seq.written_ids), seq.pos)
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
        self._finish(seq, reason, error)

    def _finish(self, seq: _Sequence, reason: str, error: str = "") -> None:
        if seq.pages:
            self.allocator.free(seq.pages)
            seq.pages = []
        conv = seq.req.conversation_id
        if conv:
            with self._mu:
                if self._conv_busy.get(conv) == seq.order:
                    del self._conv_busy[conv]
                self._conv_drop_pending.discard(conv)
        seq.handle._finish(GenResult(
            text=self.tokenizer.decode(seq.generated),
            tokens=list(seq.generated),
            prompt_tokens=len(seq.prompt_ids),
            cached_tokens=seq.cached_len,
            finish_reason=reason,
            error=error))

    def _expire_pins(self) -> None:
        if self.kv_pin_ttl <= 0:
            return
        now = self._now()
        with self._mu:
            stale = [cid for cid, kv in self._conv_cache.items()
                     if now - kv.last_used > self.kv_pin_ttl]
            for cid in stale:
                self._drop_conversation_locked(cid)
