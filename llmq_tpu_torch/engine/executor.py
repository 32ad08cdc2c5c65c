"""Paged continuous-batching executor over ``models/llama.py`` (the
port's counterpart of ``JaxExecutor`` in ``llmq_tpu/engine/executor.py``,
serving one device in bf16).

The engine schedules against :class:`ExecutorSpec` and calls the
:class:`Executor` protocol: ``prefill`` (bucketed chunks over one block
table), ``decode`` (one step for every slot), ``decode_chunk`` (up to
``chunk_size`` steps with sampling, EOS and budget latches kept on the
device), ``release_slot`` and ``resume``; with a mixed geometry also
``mixed_chunk`` (a decode chunk whose first step carries budgeted
prefill slices).

Mixed geometry: ``mixed_prefill_slices`` (S) slices of up to
``mixed_slice_tokens`` (T) tokens each. With ``ragged_attention`` the
slices pack into one token buffer instead (T is then the buffer's live
capacity, which one slice may take whole), and ALL prefill, ``prefill``
included, runs through that ragged step with the decode rows frozen.

The KV pool is one ``(L, P, page_size, GD)`` tensor pair updated **in
place** by every program — the port's counterpart of JAX's buffer
donation: the working set stays one pool plus transient activations.
With ``cache_dtype=torch.int8`` the pair is int8 and two bf16 scale
pools ``(L, P, H_kv, page_size)`` ride beside it through every program
(the int8 routes of ``ops/attention.py``); weights may be w8a8 leaves
(``ops/quant.py``) either way.

The decode step runs over static buffers (:class:`_StepBuffers`): the
inputs, the carry and the exit flag live at fixed device addresses that
every call fills in place. On the card each executor captures that step
once per decode route into a CUDA graph (at :meth:`TorchExecutor.warmup`,
or at its first decode call), and every decode step of ``decode_chunk``,
``decode`` and steps 1..K-1 of ``mixed_chunk`` is a replay of it: the
port's counterpart of JAX's one-program decode step. On the CPU the same
step body runs eagerly. Prefill and the mixed step 0 stay eager.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Protocol

import numpy as np
import torch

from llmq_tpu_torch.core.config import resolve_device
from llmq_tpu_torch.models.llama import Llama, LlamaConfig, init_kv_pages
from llmq_tpu_torch.ops import kernels
from llmq_tpu_torch.ops.attention import RAGGED_Q_BLOCK
from llmq_tpu_torch.ops.sampling import sample_token

log = logging.getLogger("llmq_tpu_torch.executor")

#: Bounds of the step time warmup calibrates, in ms (JAX's clamp).
STEP_MS_RANGE = (0.05, 250.0)


@dataclass(frozen=True)
class ExecutorSpec:
    """Geometry the engine schedules against."""

    batch_size: int          # decode slots
    page_size: int           # tokens per KV page
    num_pages: int           # total pool pages (page 0 reserved)
    max_pages_per_seq: int   # block-table width
    eos_id: int


class Executor(Protocol):
    spec: ExecutorSpec
    #: Tokens produced per decode_chunk call (1 → engine single-steps).
    chunk_size: int
    #: Measured wall milliseconds per decode step (None until measured).
    step_ms: Optional[float]

    def prefill(self, tokens: List[int], start_pos: int,
                block_table: np.ndarray, temperature: float,
                slot: int) -> int:
        """Write ``tokens``' KV at absolute positions
        ``[start_pos, start_pos+len)`` through ``block_table`` and return
        the first sampled next token."""
        ...

    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               block_tables: np.ndarray,
               temperatures: np.ndarray) -> np.ndarray:
        """One batched decode step over full-batch arrays; returns (B,)
        next tokens (inactive slots' rows point at page 0 and their
        outputs are ignored)."""
        ...

    def decode_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: np.ndarray, temperatures: np.ndarray,
                     budgets: np.ndarray) -> np.ndarray:
        """Up to ``chunk_size`` decode steps; per row identical to that
        many ``decode`` calls. A row latches on EOS (for good) or when its
        ``budgets[b]`` steps are spent (this chunk only); latched rows
        emit EOS and write KV to page 0. Returns (B, chunk_size)."""
        ...

    def release_slot(self, slot: int) -> None:
        ...

    def resume(self, slot: int, tokens: List[int], start_pos: int) -> None:
        ...


@dataclass
class _StepBuffers:
    """The decode step's static device buffers. Every chunk fills them in
    place, and a captured step reads and writes them at fixed
    addresses."""

    tok: torch.Tensor        # (B,) int32: each row's input token
    pos: torch.Tensor        # (B,) int32: its position
    bt: torch.Tensor         # (B, MP) int32 block tables
    temps: torch.Tensor      # (B,) f32
    budgets: torch.Tensor    # (B,) int32: steps each row may take
    frozen: torch.Tensor     # (B,) bool: the EOS latch
    out: torch.Tensor        # (B, K) int32, EOS-padded
    j: torch.Tensor          # (1,) int64: the step index
    left: torch.Tensor       # () bool: a row has a step after this one

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)]


@dataclass
class _StepGraph:
    """One decode route's captured step."""

    graph: "torch.cuda.CUDAGraph"
    #: Kernel launches (``kernels.LAUNCHES`` names) one replay makes.
    launches: Dict[str, int]
    #: Device memory the capture reserved: the graph's private pool.
    pool_bytes: int


class TorchExecutor:
    """Serves ``model_cfg`` with ``params`` (the JAX tree layout, see
    ``models/llama.py``, already on ``device``) on ``device``. One prefill program per length
    bucket: prompts longer than the largest bucket stream through it in
    chunks over the same block table. Decoding runs B slots of a fixed
    (B, max_pages) geometry."""

    def __init__(self, model_cfg: LlamaConfig, params, *,
                 batch_size: int = 8, page_size: int = 16,
                 num_pages: int = 512,
                 prefill_buckets: Optional[List[int]] = None,
                 top_k: int = 0, top_p: float = 1.0, eos_id: int = 2,
                 seed: int = 0, chunk_size: int = 16,
                 fused_decode: bool = True,
                 mixed_prefill_slices: int = 0, mixed_slice_tokens: int = 0,
                 ragged_attention: bool = False,
                 ragged_token_capacity: int = 0, ragged_max_slices: int = 0,
                 cache_dtype: Optional[torch.dtype] = None,
                 device: str = "cuda") -> None:
        if cache_dtype == torch.int8 and not fused_decode:
            # The JAX package's int8-KV decode step has no split route.
            raise ValueError("fused_decode=False has no int8-KV route: the "
                             "int8 decode step is the fused kernel only")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.model = Llama(model_cfg, params)
        self.spec = ExecutorSpec(batch_size, page_size, num_pages,
                                 max(1, model_cfg.max_seq_len // page_size),
                                 eos_id)
        self.chunk_size = max(1, chunk_size)
        self.prefill_buckets = sorted(prefill_buckets or [32, 128, 512])
        self._top_k = top_k
        self._top_p = top_p
        #: Decode route: fused write+attention kernel, or the split
        #: row-write kernel + decode-attention kernel (ops/attention.py).
        self.fused_decode = fused_decode
        #: Mixed geometry: S slices × T tokens (0 → no mixed_chunk).
        self.mixed_prefill_slices = max(0, mixed_prefill_slices)
        self.mixed_slice_tokens = max(0, mixed_slice_tokens)
        if self.mixed_prefill_slices == 0 or self.mixed_slice_tokens == 0:
            self.mixed_prefill_slices = self.mixed_slice_tokens = 0
        #: Ragged mode: the engine packs against (S slices, T = capacity
        #: tokens in all); the packed buffer holds the capacity plus one
        #: partial q-block per slice, rounded up to the q-block.
        self.ragged_attention = bool(ragged_attention)
        self.ragged_buffer = 0
        if self.ragged_attention:
            S = max(1, ragged_max_slices or self.mixed_prefill_slices or 2)
            cap = max(RAGGED_Q_BLOCK, ragged_token_capacity
                      or self.mixed_prefill_slices * self.mixed_slice_tokens
                      or 128)
            self.mixed_prefill_slices = S
            self.mixed_slice_tokens = cap
            need = cap + S * (RAGGED_Q_BLOCK - 1)
            self.ragged_buffer = -(-need // RAGGED_Q_BLOCK) * RAGGED_Q_BLOCK
        self.cache = init_kv_pages(model_cfg, num_pages, page_size,
                                   self.device, dtype=cache_dtype)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        #: Wall milliseconds per decode step, host loop and readback
        #: included: calibrated by :meth:`warmup`, else first measured at
        #: the second decode call (the first pays the kernels' build and
        #: the capture), then a moving average. None until measured; the
        #: engine sizes its realtime admission cap from it.
        self.step_ms: Optional[float] = None
        self._decode_calls = 0
        #: Seconds of :meth:`warmup`: ``capture`` (the decode step's
        #: graph) and ``warmup`` (the rest). Empty until it runs.
        self.warmup_split: Dict[str, float] = {}
        B, MP, K = batch_size, self.spec.max_pages_per_seq, self.chunk_size

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self._buf = _StepBuffers(
            tok=zeros(B, torch.int32), pos=zeros(B, torch.int32),
            bt=zeros((B, MP), torch.int32), temps=zeros(B, torch.float32),
            budgets=zeros(B, torch.int32), frozen=zeros(B, torch.bool),
            out=zeros((B, K), torch.int32), j=zeros(1, torch.int64),
            left=zeros((), torch.bool))
        #: On the card the decode step is a CUDA graph; the CPU has none.
        self._graphs_on = self.device.type == "cuda"
        # Host staging of the inputs and of each step's exit flag: pinned
        # on the card, so the copies are asynchronous.
        pin = self._graphs_on

        def host(like: torch.Tensor) -> torch.Tensor:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=pin)

        b = self._buf
        self._stage = {name: host(getattr(b, name))
                       for name in ("tok", "pos", "bt", "temps", "budgets")}
        self._left_host = torch.zeros(K, dtype=torch.bool, pin_memory=pin)
        self._left_events = ([torch.cuda.Event() for _ in range(K)]
                             if pin else None)
        #: The captured decode step of each route (key: ``fused_decode``).
        self.step_graphs: Dict[bool, _StepGraph] = {}
        #: Graph replays so far: the host's launches of decode steps.
        self.graph_replays = 0
        self._capture_stream: Optional[torch.cuda.Stream] = None

    # -- helpers -------------------------------------------------------------

    def _t(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _time_steps(self, t0: float, steps: int) -> None:
        self._decode_calls += 1
        if self._decode_calls == 1 or steps <= 0:
            return
        ms = (time.perf_counter() - t0) * 1e3 / steps
        self.step_ms = (ms if self.step_ms is None
                        else 0.8 * self.step_ms + 0.2 * ms)

    def _sample(self, logits: torch.Tensor, temperatures) -> torch.Tensor:
        temps = self._t(temperatures, torch.float32)
        return sample_token(logits, self._gen, temperature=temps,
                            top_k=self._top_k, top_p=self._top_p)

    # -- Executor API --------------------------------------------------------

    @torch.inference_mode()
    def _prefill_chunk(self, chunk: List[int], start_pos: int,
                       bt: torch.Tensor, temperature: float) -> torch.Tensor:
        """Run ONE bucketed prefill chunk: pad to the bucket, clamp the
        padding positions, write KV in place. Returns the sampled next
        token as a (1,) device tensor (no host sync)."""
        T = self._bucket_for(len(chunk))
        n = len(chunk)
        padded = np.zeros((1, T), np.int32)
        padded[0, :n] = chunk
        positions = np.minimum(np.arange(T, dtype=np.int32) + start_pos,
                               start_pos + n - 1)[None, :]
        logits = self.model.forward_prefill(
            self._t(padded, torch.int32), self._t(positions, torch.int32),
            self._t([n], torch.int32), self.cache, bt)
        return self._sample(logits[:, n - 1], [temperature])

    def prefill(self, tokens: List[int], start_pos: int,
                block_table: np.ndarray, temperature: float,
                slot: int) -> int:
        if self.ragged_attention:
            return self._ragged_prefill(tokens, start_pos, block_table,
                                        temperature)
        bt = self._t(block_table, torch.int32).reshape(1, -1)
        pos = start_pos
        remaining = list(tokens)
        tok = None
        while remaining:
            chunk = remaining[: self.prefill_buckets[-1]]
            remaining = remaining[len(chunk):]
            tok = self._prefill_chunk(chunk, pos, bt, temperature)
            pos += len(chunk)
        if tok is None:
            return self.spec.eos_id
        return int(tok.item())

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               block_tables: np.ndarray,
               temperatures: np.ndarray) -> np.ndarray:
        """One step for every row: the decode step with a budget of 1."""
        t0 = time.perf_counter()
        self._fill(tokens, positions, block_tables, temperatures,
                   np.ones(self.spec.batch_size, np.int32))
        self._run_step(eager=False)
        out = self._out()[:, 0]
        self._time_steps(t0, 1)
        return out

    @torch.inference_mode()
    def decode_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: np.ndarray, temperatures: np.ndarray,
                     budgets: np.ndarray) -> np.ndarray:
        """Up to K decode steps with the JAX program's semantics: ``out``
        is EOS-padded (B, K); the EOS latch is persistent, the budget
        pause is this chunk's only; a paused row keeps its last real
        token; the loop ends once every row is latched or out of budget.
        On the card each step is one replay of the captured step."""
        return self._decode_chunk(tokens, positions, block_tables,
                                  temperatures, budgets, eager=False)

    @torch.inference_mode()
    def _decode_chunk(self, tokens, positions, block_tables, temperatures,
                      budgets, *, eager: bool) -> np.ndarray:
        """:meth:`decode_chunk`; ``eager`` runs the step body instead of
        replaying its graph (warmup before capture, and comparisons)."""
        t0 = time.perf_counter()
        self._fill(tokens, positions, block_tables, temperatures, budgets)
        ran = self._decode_steps(0, self._chunk_steps(budgets), eager)
        result = self._out()
        self._time_steps(t0, ran)
        return result

    @torch.inference_mode()
    def mixed_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                    block_tables: np.ndarray, temperatures: np.ndarray,
                    budgets: np.ndarray, pf: List) -> tuple:
        """A decode chunk whose step 0 also runs prefill slices: the
        mixed forward (bucket: ``forward_mixed``; ragged:
        ``forward_mixed_ragged``) advances the decode rows one token and
        writes each slice's K/V, then steps 1..K-1 are ``decode_chunk``'s
        step (replayed on the card) with its latch semantics, carrying on
        from step 0 in the same buffers. ``pf``: ``(slot, tokens,
        start_pos, block_table, temperature)`` per slice, at most
        ``mixed_prefill_slices`` of them, each at most
        ``mixed_slice_tokens`` tokens (ragged: all of them together).
        Returns ``(out (B, K), pf_first (len(pf),))``; ``pf_first[i]``
        is sampled at slice i's last token, the first generated token
        when the slice ends its prompt."""
        if self.mixed_prefill_slices <= 0:
            raise RuntimeError("mixed batching disabled for this executor")
        t0 = time.perf_counter()
        self._fill(tokens, positions, block_tables, temperatures, budgets)
        b = self._buf
        active = (~b.frozen) & (b.j < b.budgets)
        dec_logits, pf_logits = self._mixed_forward(b.tok, b.pos, b.bt,
                                                    active, pf)
        pf_first = self._sample(pf_logits, [p[4] for p in pf])
        self._advance(active, dec_logits)
        self._flag(0)
        ran = 1 + self._decode_steps(1, self._chunk_steps(budgets), False)
        result = self._out(), pf_first.cpu().numpy()
        self._time_steps(t0, ran)
        return result

    # -- warmup ---------------------------------------------------------------

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every program once, capture the decode step, calibrate
        ``step_ms`` (``JaxExecutor.warmup``, llmq_tpu/engine/executor.py:
        1811). In order: one eager prefill per bucket (ragged mode: one
        small ragged prefill), one eager decode chunk and, with a mixed
        geometry, one mixed chunk (on the card these build every kernel
        library, set every kernel attribute, make every split workspace
        and warm cuBLAS, all outside capture); the decode step's graph
        (card only); then ``step_ms`` from three pairs of a 1-step and a
        K-step chunk, as JAX: each pair's difference over the K-step
        chunk's effective steps, the median, clamped to
        :data:`STEP_MS_RANGE`. Every write goes through all-zero block
        tables to page 0. Records ``warmup_split``."""
        t_start = time.perf_counter()
        B, MP, K = (self.spec.batch_size, self.spec.max_pages_per_seq,
                    self.chunk_size)
        bt = np.zeros(MP, np.int32)
        if self.ragged_attention:
            self.prefill([1] * min(8, self.mixed_slice_tokens), 0, bt, 0.0, 0)
        else:
            prev = 0
            for bucket in self.prefill_buckets:
                # Lengths prev+1..bucket run as the bucket-sized chunk.
                self.prefill([1] * min(bucket, prev + 1), 0, bt, 0.0, 0)
                prev = bucket
        zeros = np.zeros(B, np.int32)
        zbt = np.zeros((B, MP), np.int32)
        ztemp = np.zeros(B, np.float32)
        ones = np.ones(B, np.int32)
        self._decode_chunk(zeros, zeros, zbt, ztemp, ones, eager=True)
        if self.mixed_prefill_slices:
            self.mixed_chunk(zeros, zeros, zbt, ztemp, ones,
                             [(0, [1], 0, bt, 0.0)])
        t_capture = time.perf_counter()
        if self._graphs_on:
            self._step_graph()
            torch.cuda.synchronize(self.device)
        capture_s = time.perf_counter() - t_capture
        if K > 1:
            full = np.full(B, K, np.int32)
            samples = []
            for _ in range(3):
                t0 = time.perf_counter()
                self.decode_chunk(zeros, zeros, zbt, ztemp, ones)
                t1 = time.perf_counter()
                out = self.decode_chunk(zeros, zeros, zbt, ztemp, full)
                t2 = time.perf_counter()
                # The loop runs while any row lives: the steps it took are
                # the columns in which some row has not yet hit EOS.
                eff = int((out != self.spec.eos_id).any(axis=0).sum()) or 1
                if eff > 1:
                    samples.append(((t2 - t1) - (t1 - t0)) / (eff - 1) * 1e3)
            if samples:
                median = sorted(samples)[len(samples) // 2]
                lo, hi = STEP_MS_RANGE
                self.step_ms = float(min(hi, max(lo, median)))
            else:
                self.step_ms = None
                log.warning("decode step timing unusable (EOS latched every "
                            "chunk); the admission cap falls back")
        self.warmup_split = {
            "capture": capture_s,
            "warmup": time.perf_counter() - t_start - capture_s}
        log.info("warmup: %.2f s (capture %.2f s); decode step %s ms",
                 sum(self.warmup_split.values()), capture_s,
                 f"{self.step_ms:.2f}" if self.step_ms else "not measured")

    # -- the decode step ------------------------------------------------------

    def _chunk_steps(self, budgets: np.ndarray) -> int:
        return min(self.chunk_size, int(np.max(budgets)) if len(budgets)
                   else 0)

    def _fill(self, tokens, positions, block_tables, temperatures,
              budgets) -> None:
        """Start a chunk: copy the inputs into the static buffers through
        the host staging (asynchronously on the card; every call ends in
        a readback, so the staging is free again at the next call), and
        reset the carry: no row latched, ``out`` all EOS, step 0."""
        b = self._buf
        for name, arr in (("tok", tokens), ("pos", positions),
                          ("bt", block_tables), ("temps", temperatures),
                          ("budgets", budgets)):
            stage = self._stage[name]
            arr = np.asarray(arr)
            if arr.shape != tuple(stage.shape):
                raise ValueError(f"{name}: shape {arr.shape}, the executor's "
                                 f"geometry needs {tuple(stage.shape)}")
            stage.numpy()[...] = arr
            getattr(b, name).copy_(stage, non_blocking=True)
        b.frozen.zero_()
        b.out.fill_(self.spec.eos_id)
        b.j.zero_()

    def _out(self) -> np.ndarray:
        """The chunk's (B, K) tokens on the host (a copy: the buffer is
        refilled by the next call)."""
        return self._buf.out.to("cpu", copy=True).numpy()

    def _step(self) -> None:
        """One decode step over the static buffers, in place: the forward
        for the rows still active at step ``j`` (the others write to page
        0), sampling, the carry and the exit flag. It reads nothing back
        to the host, so it can be captured."""
        b = self._buf
        active = (~b.frozen) & (b.j < b.budgets)
        logits = self.model.forward_decode(b.tok, b.pos, self.cache, b.bt,
                                           active, fused=self.fused_decode)
        self._advance(active, logits)

    def _advance(self, active: torch.Tensor, logits: torch.Tensor) -> None:
        """Sample step ``j`` and update the carry in place: inactive rows
        emit EOS and keep their token; an EOS latches its row. Then
        ``j += 1`` and ``left`` says whether a row has a step ``j``."""
        b = self._buf
        eos = self.spec.eos_id
        nxt = sample_token(logits, self._gen, temperature=b.temps,
                           top_k=self._top_k, top_p=self._top_p)
        b.out.index_copy_(1, b.j, torch.where(active, nxt, eos)[:, None])
        b.tok.copy_(torch.where(active, nxt, b.tok))
        b.pos.add_(active.to(torch.int32))
        b.frozen.logical_or_(active & (nxt == eos))
        b.j.add_(1)
        b.left.copy_(((~b.frozen) & (b.j < b.budgets)).any())

    def _run_step(self, eager: bool) -> None:
        """One decode step: on the card a replay of the current route's
        captured step (captured first if it is not yet), whose kernel
        launches are then added to ``kernels.LAUNCHES``; on the CPU, or
        with ``eager``, the step body itself."""
        if eager or not self._graphs_on:
            self._step()
            return
        g = self._step_graph()
        g.graph.replay()
        for name, n in g.launches.items():
            kernels.LAUNCHES[name] += n
        self.graph_replays += 1

    def _step_graph(self) -> _StepGraph:
        """The current route's captured step, captured at first use."""
        g = self.step_graphs.get(self.fused_decode)
        if g is None:
            g = self.step_graphs[self.fused_decode] = self._capture()
        return g

    def _capture(self) -> _StepGraph:
        """Capture :meth:`_step` for the current route. One eager step on
        the capture stream comes first, every row frozen so that its
        writes land on page 0: the kernel libraries, their attributes,
        the split workspaces and that stream's cuBLAS workspace then all
        exist before capture. The buffers are restored afterwards. The
        private generator is registered with the graph, so each replay
        draws fresh numbers. The capture launches nothing: its launch
        counts are taken back out of ``kernels.LAUNCHES`` and kept as
        what each replay adds. A failed capture raises."""
        dev, b = self.device, self._buf
        saved = [t.clone() for t in b.tensors()]
        b.frozen.fill_(True)
        b.bt.zero_()
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            self._step()
        launches = {name: n - before[name]
                    for name, n in kernels.LAUNCHES.items()
                    if n != before[name]}
        kernels.LAUNCHES.update(before)
        pool = torch.cuda.memory_reserved(dev) - reserved
        for t, v in zip(b.tensors(), saved):
            t.copy_(v)
        log.info("captured the decode step (%s route): %d kernel launches "
                 "a replay, pool %.1f MiB",
                 "fused" if self.fused_decode else "split",
                 sum(launches.values()), pool / 2**20)
        return _StepGraph(graph, launches, pool)

    def _flag(self, j: int) -> None:
        """Queue the copy of step ``j``'s exit flag into its host slot,
        and (on the card) an event behind it."""
        self._left_host[j].copy_(self._buf.left, non_blocking=True)
        if self._left_events is not None:
            self._left_events[j].record()

    def _left_after(self, j: int) -> bool:
        """Step ``j``'s exit flag, waiting only for step ``j`` itself."""
        if self._left_events is not None:
            self._left_events[j].synchronize()
        return bool(self._left_host[j])

    def _decode_steps(self, first: int, steps: int, eager: bool) -> int:
        """Decode steps ``first..steps-1``; returns how many ran. Step
        ``j - 1``'s exit flag is read only after step ``j`` is queued, so
        the device never waits for the host: the one extra step that can
        run has every row inactive (its writes go to page 0 and its
        outputs stay EOS). With ``first > 0`` step ``first - 1``'s flag
        must be queued already."""
        ran = 0
        for j in range(first, steps):
            self._run_step(eager)
            self._flag(j)
            ran += 1
            if j > 0 and not self._left_after(j - 1):
                break
        return ran

    def _mixed_forward(self, tok, pos, bt, active, pf: List):
        """Step 0 of a mixed chunk: (dec_logits (B, V), slice logits at
        each slice's last token (len(pf), V))."""
        S, T = self.mixed_prefill_slices, self.mixed_slice_tokens
        if not 0 < len(pf) <= S:
            raise ValueError(f"{len(pf)} slices for a geometry of {S}")
        if self.ragged_attention:
            if sum(len(p[1]) for p in pf) > T:
                raise ValueError(f"ragged pack exceeds the capacity {T}")
            return self._ragged_forward(tok, pos, bt, active, pf)
        if any(not 0 < len(p[1]) <= T for p in pf):
            raise ValueError(f"a slice is empty or wider than {T}")
        n = len(pf)
        width = max(len(p[1]) for p in pf)
        toks = np.zeros((n, width), np.int32)
        poss = np.zeros((n, width), np.int32)
        lens = np.zeros(n, np.int32)
        bts = np.zeros((n, self.spec.max_pages_per_seq), np.int32)
        for i, (_slot, t, sp, slice_bt, _temp) in enumerate(pf):
            toks[i, :len(t)] = t
            poss[i] = np.minimum(np.arange(width) + sp, sp + len(t) - 1)
            lens[i] = len(t)
            bts[i] = slice_bt
        dec_logits, pf_logits = self.model.forward_mixed(
            tok, pos, self.cache, bt, self._t(toks, torch.int32),
            self._t(poss, torch.int32), self._t(lens, torch.int32),
            self._t(bts, torch.int32), active, fused=self.fused_decode)
        last = self._t(lens - 1, torch.int64)
        return dec_logits, pf_logits[torch.arange(n, device=self.device),
                                     last]

    def _ragged_forward(self, tok, pos, bt, active, pf: List):
        """Pack the slices into the (N,) buffer, each segment starting on
        a q-block boundary, and run ``forward_mixed_ragged``."""
        N, qblk = self.ragged_buffer, RAGGED_Q_BLOCK
        n = len(pf)
        toks = np.zeros(N, np.int32)
        poss = np.zeros(N, np.int32)
        qoff = np.zeros(n, np.int32)
        qlen = np.zeros(n, np.int32)
        bts = np.zeros((n, self.spec.max_pages_per_seq), np.int32)
        off = 0
        for i, (_slot, t, sp, slice_bt, _temp) in enumerate(pf):
            L = len(t)
            if L == 0 or off + L > N:
                raise ValueError(f"slices do not pack into {N} rows")
            toks[off:off + L] = t
            poss[off:off + L] = np.arange(L) + sp
            qoff[i], qlen[i] = off, L
            bts[i] = slice_bt
            off += -(-L // qblk) * qblk
        return self.model.forward_mixed_ragged(
            tok, pos, self.cache, bt, self._t(toks, torch.int32),
            self._t(poss, torch.int32), self._t(qoff, torch.int32),
            self._t(qlen, torch.int32), self._t(bts, torch.int32), active)

    @torch.inference_mode()
    def _ragged_prefill(self, tokens: List[int], start_pos: int,
                        block_table: np.ndarray, temperature: float) -> int:
        """Prefill through the ragged step with every decode row frozen
        (no bucket program runs in ragged mode). The prompt is cut into
        pieces of at most the capacity; consecutive pieces share a step
        while they fit (all slice writes of a layer precede its attention
        launch, so a later piece sees an earlier one's K/V). Returns the
        token sampled after the last piece."""
        cap, S = self.mixed_slice_tokens, self.mixed_prefill_slices
        qblk, N = RAGGED_Q_BLOCK, self.ragged_buffer
        B, MP = self.spec.batch_size, self.spec.max_pages_per_seq
        pieces = [(list(tokens[o:o + cap]), start_pos + o)
                  for o in range(0, len(tokens), cap)]
        if not pieces:
            return self.spec.eos_id
        zeros = self._t(np.zeros(B, np.int32), torch.int32)
        zbt = self._t(np.zeros((B, MP), np.int32), torch.int32)
        frozen = torch.zeros(B, dtype=torch.bool, device=self.device)
        i = 0
        while i < len(pieces):
            group, live, padded = [], 0, 0
            while i < len(pieces) and len(group) < S:
                n = len(pieces[i][0])
                pad = -(-n // qblk) * qblk
                if group and (live + n > cap or padded + pad > N):
                    break
                group.append(pieces[i])
                live, padded, i = live + n, padded + pad, i + 1
            pf = [(0, chunk, sp, block_table, temperature)
                  for chunk, sp in group]
            _dec, pf_logits = self._ragged_forward(zeros, zeros, zbt, frozen,
                                                   pf)
        return int(self._sample(pf_logits[-1:], [temperature]).item())

    def release_slot(self, slot: int) -> None:
        pass  # no per-slot state: block tables carry everything

    def resume(self, slot: int, tokens: List[int], start_pos: int) -> None:
        pass

