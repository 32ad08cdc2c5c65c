"""Paged continuous-batching executor over ``models/llama.py`` (the
port's counterpart of ``JaxExecutor`` in ``llmq_tpu/engine/executor.py``,
serving one device in bf16).

The engine schedules against :class:`ExecutorSpec` and calls the
:class:`Executor` protocol: ``prefill`` (bucketed chunks over one block
table), ``decode`` (one step for every slot), ``decode_chunk`` (up to
``chunk_size`` steps with sampling, EOS and budget latches kept on the
device), ``release_slot`` and ``resume``; with a mixed geometry also
``mixed_chunk`` (a decode chunk whose first step carries budgeted
prefill slices), and their dispatch-only forms ``decode_chunk_start``
and ``mixed_chunk_start``. Prefill also runs without a host wait:
``prefill_async`` (one chunk) and ``prefill_multi_async`` (an admission
wave of up to ``prefill_batch`` prompts' chunks in one program) return
:class:`PrefillHandle` s, whose first tokens ``gather_scalars`` reads
(each dispatch queued their copy to host memory).

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
step body runs eagerly.

Every prefill program and the mixed step 0 run the same way
(:class:`_Program`: static inputs, pinned staging, one graph each): the
counterparts of JAX's ``prefill_b{T}`` (one row), ``prefill_multi_b{T}``
(``prefill_batch`` rows; unused rows hold one token against the null
page), the mixed step 0 padded to its full (S, T) geometry (one graph
per decode route) and the ragged step 0, which ragged prefill replays
with every decode row frozen. Their graphs share one memory pool: their
replays are serialised on one stream, and each replay's sampled tokens
are copied at once into a ring of result slots outside the pool (which a
decode join reads on the device) and on into pinned host memory behind
an event (which the handles read).

The async decode pipeline (``JaxExecutor.decode_chunk_start``):
``decode_chunk_start`` and ``mixed_chunk_start`` queue a chunk's steps and
return a :class:`ChunkHandle` / :class:`MixedChunkHandle` without reading
the device: they queue ``min(K, max budget)`` steps with no exit test (a
step in which every row is latched writes page 0 only and emits EOS, so
``out`` and the carry equal what JAX's loop leaves). The chunk's tokens
go to pinned host memory with an event behind them; ``fetch()`` waits on
that event, ``ready()`` queries it, and the chunk's device time (CUDA
events) feeds ``step_ms``. A handle keeps the chunk's end state (``tok``,
``pos`` and ``frozen``, the EOS latch) on the device, and a dispatch with
``carry=`` starts from it; ``overrides`` join just-prefilled sequences
device to device from the prefill result ring, so a first token never
visits the host. Every host input goes through a ring of pinned staging
slots (:class:`HostStaging`), each reused only once the event behind its
last copy has completed, so chunks queued back to back never overwrite
each other's inputs. The blocking ``decode_chunk`` keeps its early exit.
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
from llmq_tpu_torch.observability.device import (get_device_telemetry,
                                                 measure_rtt)
from llmq_tpu_torch.ops import kernels
from llmq_tpu_torch.ops.attention import RAGGED_Q_BLOCK
from llmq_tpu_torch.ops.quant import is_quantized, param_count, params_bytes
from llmq_tpu_torch.ops.sampling import sample_token

log = logging.getLogger("llmq_tpu_torch.executor")

#: Bounds of the step time warmup calibrates, in ms (JAX's clamp).
STEP_MS_RANGE = (0.05, 250.0)

#: Prefill dispatches whose sampled tokens the result ring holds on the
#: device at once. A dispatch that comes round to a slot whose handles
#: are not yet fetched fetches them first (the ring is the staging
#: fence): no later wave overwrites an unresolved handle.
RESULT_RING = 8

#: Host staging slots a program (:class:`HostStaging`): the JAX engine's
#: ``max(8, depth + 4)``, which is 8 at every pipeline depth (1 to 4).
STAGING_RING = 8


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
    #: Prefill chunks per ``prefill_multi_async`` program.
    prefill_batch: int
    prefill_buckets: List[int]

    def prefill(self, tokens: List[int], start_pos: int,
                block_table: np.ndarray, temperature: float,
                slot: int) -> int:
        """Write ``tokens``' KV at absolute positions
        ``[start_pos, start_pos+len)`` through ``block_table`` and return
        the first sampled next token."""
        ...

    def prefill_async(self, tokens: List[int], start_pos: int,
                      block_table: np.ndarray, temperature: float):
        """``prefill`` of one chunk without the host wait: returns a
        handle of the sampled token."""
        ...

    def prefill_multi_async(self, reqs: List) -> List:
        """Up to ``prefill_batch`` chunks ``(tokens, start_pos,
        block_table, temperature)`` in one program; one handle each."""
        ...

    def gather_scalars(self, handles: List) -> np.ndarray:
        """The handles' tokens (a wait on the copies their dispatches
        queued, no transfer of its own)."""
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

    def decode_chunk_start(self, tokens, positions, block_tables,
                           temperatures, budgets, carry=None,
                           overrides=None) -> "ChunkHandle":
        """``decode_chunk`` dispatched without a host wait: ``carry`` (an
        earlier handle) supplies the rows' tokens, positions and EOS
        latches on the device; ``overrides`` ``(slot, prefill handle,
        pos)`` join just-prefilled sequences device to device."""
        ...

    def mixed_chunk_start(self, tokens, positions, block_tables,
                          temperatures, budgets,
                          pf: List) -> "MixedChunkHandle":
        """``mixed_chunk`` dispatched without a host wait."""
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
    idle: torch.Tensor       # (1,) int64: decode steps run with no live row

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)]


class _StageSlot:
    """One slot of a :class:`HostStaging` ring: host buffers (pinned on
    the card) with numpy views made once, and the event recorded behind
    the last copy out of them."""

    __slots__ = ("bufs", "views", "event", "recorded")

    def __init__(self, shapes: Dict[str, tuple], pin: bool) -> None:
        self.bufs = {k: torch.zeros(shape, dtype=dt, pin_memory=pin)
                     for k, (shape, dt) in shapes.items()}
        self.views = {k: t.numpy() for k, t in self.bufs.items()}
        self.event = torch.cuda.Event() if pin else None
        self.recorded = False

    def record(self) -> None:
        """Fence the copies just queued out of this slot."""
        if self.event is not None:
            self.event.record()
            self.recorded = True


class HostStaging:
    """Rings of host staging slots, one ring per tag (a program's inputs,
    or the decode step's): the port's counterpart of the JAX package's
    ``HostStaging``. A dispatch takes the next slot of its tag, fills it,
    queues its copies to the device and records the slot's event; a slot
    is filled again only once that event has completed, so dispatches
    queued back to back (chunks in flight) never overwrite inputs that a
    queued copy has not read yet. On the CPU the copies are synchronous
    and no event is needed."""

    def __init__(self, ring: int, pin: bool) -> None:
        self.ring = ring
        self._pin = pin
        self._slots: Dict[str, List[_StageSlot]] = {}
        self._next: Dict[str, int] = {}

    def take(self, tag: str, shapes: Dict[str, tuple]) -> _StageSlot:
        """The next slot of ``tag`` (``shapes``: name → (shape, dtype),
        fixed per tag), once the last copy out of it has run."""
        slots = self._slots.get(tag)
        if slots is None:
            slots = self._slots[tag] = [_StageSlot(shapes, self._pin)
                                        for _ in range(self.ring)]
            self._next[tag] = 0
        i = self._next[tag]
        self._next[tag] = (i + 1) % self.ring
        slot = slots[i]
        if slot.recorded:
            slot.event.synchronize()
        return slot


class ChunkHandle:
    """A dispatched decode chunk (``JaxExecutor``'s ``ChunkHandle``):
    its (B, K) tokens on their way to pinned host memory behind an event,
    and the device-resident end state (``tok``, ``pos``, ``frozen``: the
    EOS latch) that a carried dispatch starts from. ``fetch()`` waits for
    the tokens; ``ready()`` says whether that would return at once. The
    first fetch reports the chunk's device time a step to its executor
    (CUDA events on the card, the dispatch's host wall on the CPU)."""

    __slots__ = ("tok", "pos", "frozen", "steps", "_host", "_shape",
                 "_start", "_done", "_host_ms", "_note", "_value")

    def __init__(self, tok, pos, frozen, host, shape, steps, start, done,
                 host_ms, note) -> None:
        self.tok = tok
        self.pos = pos
        self.frozen = frozen
        self.steps = steps
        self._host = host
        self._shape = shape
        self._start = start
        self._done = done
        self._host_ms = host_ms
        self._note = note
        self._value: Optional[np.ndarray] = None

    def ready(self) -> bool:
        return self._done is None or self._done.query()

    def wait_ready(self) -> None:
        """Wait on this chunk's own completion event, recorded behind the
        copy of its tokens to host memory (no stream-wide wait); at once
        on the CPU."""
        if self._done is not None:
            self._done.synchronize()

    def _wait(self) -> np.ndarray:
        if self._value is None:
            ms = self._host_ms
            if self._done is not None:
                self._done.synchronize()
                ms = (self._start.elapsed_time(self._done) / self.steps
                      if self.steps else None)
            self._value = self._host.numpy()
            self._note(ms)
        return self._value

    def fetch(self) -> np.ndarray:
        """The chunk's (B, K) tokens, EOS-padded."""
        return self._wait().reshape(self._shape)


class MixedChunkHandle(ChunkHandle):
    """A dispatched mixed chunk: a :class:`ChunkHandle` whose transfer
    also carries the slices' sampled tokens (one copy for both)."""

    __slots__ = ()

    def fetch(self) -> tuple:
        """``(decode tokens (B, K), slice first tokens (len(pf),))``."""
        v = self._wait()
        n = self._shape[0] * self._shape[1]
        return v[:n].reshape(self._shape), v[n:]


@dataclass
class _StepGraph:
    """One captured program: a decode route's step, a prefill program or
    a mixed step 0."""

    graph: "torch.cuda.CUDAGraph"
    #: Kernel launches (``kernels.LAUNCHES`` names) one replay makes.
    launches: Dict[str, int]
    #: Device memory the capture reserved (the decode step: its private
    #: pool; a prefill program: what it added to the shared pool).
    pool_bytes: int
    #: Seconds of the eager run before capture and of the capture.
    capture_s: float = 0.0
    #: The tensor the captured body returned: each replay rewrites it.
    out: Optional[torch.Tensor] = None


@dataclass
class _Program:
    """A prefill program or mixed step 0: the static device inputs that
    its graph reads; their host staging is the ``name`` ring of the
    executor's :class:`HostStaging`."""

    name: str
    shapes: Dict[str, tuple]
    bufs: Dict[str, torch.Tensor]


class _HostCopy:
    """A dispatch's result-ring slot copied to host memory (pinned on the
    card) with the event behind the copy."""

    __slots__ = ("host", "event", "_values")

    def __init__(self, host: torch.Tensor, event) -> None:
        self.host = host
        self.event = event
        self._values: Optional[np.ndarray] = None

    def read(self, row: int) -> int:
        if self._values is None:
            if self.event is not None:
                self.event.synchronize()
            self._values = self.host.numpy()
        return int(self._values[row])


class PrefillHandle:
    """A dispatched prefill's sampled first token: row ``row`` of slot
    ``slot`` of its executor's result ring (on the device, where a decode
    join reads it) and of that slot's host copy, until fetched, then
    ``value``."""

    __slots__ = ("slot", "row", "value", "copy")

    def __init__(self, slot: int, row: int, copy: _HostCopy) -> None:
        self.slot = slot
        self.row = row
        self.copy = copy
        self.value: Optional[int] = None


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
                 prefill_batch: int = 4,
                 device: str = "cuda", telemetry_name: str = "engine0",
                 telemetry_metrics: bool = True) -> None:
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
        #: Prompts per admission-wave program (``prefill_multi_async``),
        #: at most the batch size, as in the JAX package.
        self.prefill_batch = max(1, min(prefill_batch, batch_size))
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
        #: Device telemetry (observability/device.py), shared by name with
        #: the engine built over this executor: graph captures land here
        #: as compiles, warmup as progress, the RTT floor after warmup.
        #: ``telemetry_metrics``: warmup runs before the engine exists to
        #: set the metrics flag.
        self._telemetry = get_device_telemetry(telemetry_name,
                                               metrics=telemetry_metrics)
        self._telemetry.configure_model(**self.telemetry_info())
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        #: Milliseconds per decode step: calibrated by :meth:`warmup`,
        #: else first measured at the second decode call (the first pays
        #: the kernels' build and the capture), then a moving average: of
        #: the host wall of a blocking call, and of a dispatched chunk's
        #: device time (CUDA events; the CPU: its dispatch's wall) at its
        #: fetch. None until measured; the engine sizes its realtime
        #: admission cap from it.
        self.step_ms: Optional[float] = None
        self._decode_calls = 0
        #: Seconds of :meth:`warmup`: ``capture`` (every graph) and
        #: ``warmup`` (the rest). Empty until it runs.
        self.warmup_split: Dict[str, float] = {}
        #: Seconds of ``nvcc`` builds in :meth:`warmup` (0 on the CPU, or
        #: when the hashed libraries already exist): the "compile" boot
        #: stage, inside ``warmup_split["warmup"]``.
        self.compile_s = 0.0
        B, MP, K = batch_size, self.spec.max_pages_per_seq, self.chunk_size

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self._buf = _StepBuffers(
            tok=zeros(B, torch.int32), pos=zeros(B, torch.int32),
            bt=zeros((B, MP), torch.int32), temps=zeros(B, torch.float32),
            budgets=zeros(B, torch.int32), frozen=zeros(B, torch.bool),
            out=zeros((B, K), torch.int32), j=zeros(1, torch.int64),
            left=zeros((), torch.bool), idle=zeros(1, torch.int64))
        #: On the card the decode step is a CUDA graph; the CPU has none.
        self._graphs_on = self.device.type == "cuda"
        # Host staging of every input (one ring a program, one for the
        # decode step), of each step's exit flag and of every result:
        # pinned on the card, so the copies are asynchronous, with events
        # behind them.
        pin = self._pin = self.device.type == "cuda"
        self._staging = HostStaging(STAGING_RING, pin)
        self._left_host = torch.zeros(K, dtype=torch.bool, pin_memory=pin)
        self._left_events = ([torch.cuda.Event() for _ in range(K)]
                             if pin else None)
        #: The captured decode step of each route (key: ``fused_decode``).
        self.step_graphs: Dict[bool, _StepGraph] = {}
        #: Graph replays so far: the host's launches of decode steps.
        self.graph_replays = 0
        self._capture_stream: Optional[torch.cuda.Stream] = None
        #: Prefill programs and mixed step 0s by name (``prefill_b128``,
        #: ``prefill_multi_b128``, ``mixed_step0``, ``ragged_step0``),
        #: made at first use.
        self._programs: Dict[str, _Program] = {}
        #: Their captured graphs by name (the mixed step 0's per decode
        #: route: ``mixed_step0_fused``, ``mixed_step0_split``) and the
        #: host's replays of each.
        self.program_graphs: Dict[str, _StepGraph] = {}
        self.program_replays: Dict[str, int] = {}
        #: The memory pool every program graph of this executor shares.
        self._graph_pool = None
        # The result ring (see RESULT_RING): one row of sampled tokens
        # per dispatch, and the handles each slot holds.
        width = max(self.prefill_batch, self.mixed_prefill_slices, 1)
        self._ring = zeros((RESULT_RING, width), torch.int32)
        self._ring_handles: List[List[PrefillHandle]] = [
            [] for _ in range(RESULT_RING)]
        self._ring_next = 0

    # -- helpers -------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _time_steps(self, t0: float, steps: int) -> None:
        self._note_step_ms((time.perf_counter() - t0) * 1e3 / steps
                           if steps > 0 else None)

    def _note_step_ms(self, ms: Optional[float]) -> None:
        """One decode call's milliseconds a step into ``step_ms`` (the
        first call, which builds and captures, is left out)."""
        self._decode_calls += 1
        if self._decode_calls == 1 or ms is None:
            return
        self.step_ms = (ms if self.step_ms is None
                        else 0.8 * self.step_ms + 0.2 * ms)

    def _event(self, timing: bool = False):
        """A CUDA event recorded now on the current stream (None on the
        CPU, where every copy is synchronous)."""
        if not self._pin:
            return None
        ev = torch.cuda.Event(enable_timing=timing)
        ev.record()
        return ev

    def telemetry_info(self) -> Dict:
        """Model identity for the MFU estimator."""
        params = self.model.params
        return {"n_params": param_count(params),
                "device_kind": self._device_kind(),
                "quant": ("int8" if is_quantized(params["layers"]["wq"])
                          else ""),
                "n_chips": 1}

    def _device_kind(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return self.device.type

    def hbm_info(self) -> List[Dict]:
        """HBM accounting of the card this executor serves on: weight
        bytes, KV-pool bytes (the K/V pools, and the scale pools of an
        int8 cache), the CUDA-graph pools' bytes, and free and total
        memory from ``torch.cuda.mem_get_info`` (None on the CPU). Called
        from scrapes and stats only, never from the step path."""
        entry = {"chip": str(self.device.index or 0),
                 "kind": self._device_kind(),
                 "weights_bytes": params_bytes(self.model.params),
                 "kv_pool_bytes": sum(t.numel() * t.element_size()
                                      for t in self.cache.values()),
                 "graph_pool_bytes": sum(
                     g.pool_bytes for g in list(self.step_graphs.values())
                     + list(self.program_graphs.values())),
                 "free_bytes": None, "limit_bytes": None}
        if self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            entry["free_bytes"] = int(free)
            entry["limit_bytes"] = int(total)
            entry["reserved_bytes"] = int(torch.cuda.memory_stats(
                self.device).get("reserved_bytes.all.current", 0))
        return [entry]

    def _note_capture(self, name: str, g: _StepGraph) -> None:
        """A captured program counts as one compile in the telemetry (the
        seconds of its eager run and capture; no program cache)."""
        self._telemetry.note_compile(name, g.capture_s, False)

    @property
    def idle_steps(self) -> int:
        """Decode steps run so far in which no row was live (a dispatched
        chunk runs its full step count; the blocking chunk's one extra
        step): a host read, for statistics only."""
        return int(self._buf.idle[0])

    # -- Executor API --------------------------------------------------------

    def prefill(self, tokens: List[int], start_pos: int,
                block_table: np.ndarray, temperature: float,
                slot: int) -> int:
        """Synchronous prefill: :meth:`prefill_async` over the prompt's
        bucket-sized chunks (ragged mode: the ragged step's pieces), then
        one fetch of the last chunk's token."""
        if not len(tokens):
            return self.spec.eos_id
        if self.ragged_attention:
            h = self._ragged_prefill_start(
                [(tokens, start_pos, block_table, temperature)])[0]
            return int(self.gather_scalars([h])[0])
        pos, h = start_pos, None
        largest = self.prefill_buckets[-1]
        for o in range(0, len(tokens), largest):
            chunk = list(tokens[o:o + largest])
            h = self.prefill_async(chunk, pos, block_table, temperature)
            pos += len(chunk)
        return int(self.gather_scalars([h])[0])

    def prefill_async(self, tokens: List[int], start_pos: int,
                      block_table: np.ndarray,
                      temperature: float) -> PrefillHandle:
        """One prefill chunk (at most the largest bucket; ragged mode: any
        length) dispatched without a host wait: the one-row program of
        its bucket. Returns the handle of its sampled next token."""
        req = (list(tokens), start_pos, block_table, temperature)
        if self.ragged_attention:
            return self._ragged_prefill_start([req])[0]
        if len(tokens) > self.prefill_buckets[-1]:
            raise ValueError("prefill_async takes one bucket-sized chunk")
        return self._prefill_wave([req], rows=1)[0]

    def prefill_multi_async(self, reqs: List) -> List[PrefillHandle]:
        """Up to ``prefill_batch`` prompts' chunks in ONE program,
        dispatched without a host wait (``JaxExecutor.prefill_multi_async``):
        the weights stream once for the wave. ``reqs``: ``(tokens,
        start_pos, block_table, temperature)`` each, every chunk at most
        the largest bucket. Ragged mode packs the requests into ragged
        steps instead. Returns one handle per request."""
        if not 0 < len(reqs) <= self.prefill_batch:
            raise ValueError(f"{len(reqs)} requests for a wave of "
                             f"{self.prefill_batch}")
        reqs = [(list(t), sp, bt, temp) for t, sp, bt, temp in reqs]
        if self.ragged_attention:
            return self._ragged_prefill_start(reqs)
        if any(not 0 < len(r[0]) <= self.prefill_buckets[-1] for r in reqs):
            raise ValueError("a wave's chunk is empty or exceeds the "
                             "largest bucket")
        return self._prefill_wave(reqs, rows=self.prefill_batch)

    def gather_scalars(self, handles: List[PrefillHandle]) -> np.ndarray:
        """The handles' tokens. Each dispatch queued its tokens' copy to
        host memory when it was made, so this only waits on those copies'
        events and reads host memory: no transfer of its own, and safe
        off the thread that dispatches."""
        for h in handles:
            if h.value is None:
                h.value = h.copy.read(h.row)
        return np.array([h.value for h in handles], dtype=np.int64)

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
    def decode_chunk_start(self, tokens, positions, block_tables: np.ndarray,
                           temperatures: np.ndarray, budgets: np.ndarray,
                           carry: Optional[ChunkHandle] = None,
                           overrides: Optional[List] = None) -> ChunkHandle:
        """Dispatch one chunk without reading the device
        (``JaxExecutor.decode_chunk_start``): ``min(K, max budget)`` step
        replays, no exit test. With ``carry`` (an earlier handle) the
        rows' tokens, positions and EOS latches come from its end state on
        the device (``tokens`` and ``positions`` are ignored); without
        it they come from the host and no row starts latched.
        ``overrides``: ``(slot, prefill handle, pos)`` triples whose input
        token is the prefill's sampled token, copied device to device
        from the result ring (a same-step join: the first token never
        visits the host); the slot's position and latch are overridden
        too, so a join may land on a lane whose previous owner finished.
        Block tables, temperatures and budgets come from the host."""
        t0 = time.perf_counter()
        self._fill(tokens, positions, block_tables, temperatures, budgets,
                   carry=carry)
        self._join(overrides or ())
        start = self._event(timing=True)
        steps = self._chunk_steps(budgets)
        for _ in range(steps):
            self._run_step(eager=False)
        return self._handle(ChunkHandle, steps, t0, start)

    def _join(self, overrides) -> None:
        """Write each override's token, position and cleared latch into
        its slot of the step buffers, on the device."""
        b = self._buf
        for slot, h, pos in overrides:
            if h.value is not None:
                b.tok[slot].fill_(h.value)
            else:
                b.tok[slot].copy_(self._ring[h.slot, h.row])
            b.pos[slot].fill_(pos)
            b.frozen[slot].fill_(False)

    def _handle(self, cls, steps: int, t0: float, start,
                first: Optional[torch.Tensor] = None) -> ChunkHandle:
        """Close a dispatch: queue one copy of ``out`` (and, for a mixed
        chunk, the slices' ``first`` tokens) to host memory with a timing
        event behind it, and keep the end state on the device for a later
        carry. Everything is queued in stream order, before any later
        dispatch resets the step buffers or replays ``first``'s graph."""
        b = self._buf
        dev = b.out.view(-1)
        if first is not None:
            dev = torch.cat([dev, first])
        host = torch.empty(dev.shape, dtype=torch.int32,
                           pin_memory=self._pin)
        host.copy_(dev, non_blocking=self._pin)
        done = self._event(timing=True)
        host_ms = (None if done is not None or steps <= 0 else
                   (time.perf_counter() - t0) * 1e3 / steps)
        return cls(b.tok.clone(), b.pos.clone(), b.frozen.clone(), host,
                   tuple(b.out.shape), steps, start, done, host_ms,
                   self._note_step_ms)

    @torch.inference_mode()
    def _decode_chunk(self, tokens, positions, block_tables, temperatures,
                      budgets, *, eager: bool) -> np.ndarray:
        """:meth:`decode_chunk`; ``eager`` runs the step body instead of
        replaying its graph (warmup before capture, and comparisons)."""
        t0 = time.perf_counter()
        self._fill(tokens, positions, block_tables, temperatures, budgets)
        ran = self._decode_steps(self._chunk_steps(budgets), eager)
        result = self._out()
        self._time_steps(t0, ran)
        return result

    def mixed_chunk_start(self, tokens: np.ndarray, positions: np.ndarray,
                          block_tables: np.ndarray, temperatures: np.ndarray,
                          budgets: np.ndarray,
                          pf: List) -> MixedChunkHandle:
        """:meth:`mixed_chunk` dispatched without reading the device
        (``JaxExecutor.mixed_chunk_start``; in ragged mode its
        ``_ragged_chunk_start``): step 0, then ``min(K, max budget) - 1``
        decode steps with no exit test. A fresh dispatch: no row starts
        latched. ``fetch()`` returns ``(out, pf_first)`` in one
        transfer."""
        return self._mixed_chunk_start(tokens, positions, block_tables,
                                       temperatures, budgets, pf,
                                       eager=False)

    def mixed_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                    block_tables: np.ndarray, temperatures: np.ndarray,
                    budgets: np.ndarray, pf: List) -> tuple:
        """A decode chunk whose step 0 also runs prefill slices: the
        mixed step 0 (bucket: ``forward_mixed`` over the full (S, T)
        slice geometry, unused slices one token against the null page;
        ragged: ``forward_mixed_ragged`` over the packed buffer) advances
        the decode rows one token and writes each slice's K/V, then steps
        1..K-1 are ``decode_chunk``'s step with its latch semantics,
        carrying on from step 0 in the same buffers. On the card step 0
        is one replay of its graph for the current decode route, then
        each later step one replay of the decode step's. ``pf``:
        ``(slot, tokens, start_pos, block_table, temperature)`` per
        slice, at most ``mixed_prefill_slices`` of them, each at most
        ``mixed_slice_tokens`` tokens (ragged: all of them together).
        Returns ``(out (B, K), pf_first (len(pf),))``; ``pf_first[i]``
        is sampled at slice i's last token, the first generated token
        when the slice ends its prompt."""
        return self._mixed_chunk(tokens, positions, block_tables,
                                 temperatures, budgets, pf, eager=False)

    def _mixed_chunk(self, tokens, positions, block_tables, temperatures,
                     budgets, pf: List, *, eager: bool) -> tuple:
        """:meth:`mixed_chunk`; ``eager`` runs step 0 and the decode
        steps eagerly instead of replaying their graphs."""
        return self._mixed_chunk_start(tokens, positions, block_tables,
                                       temperatures, budgets, pf,
                                       eager=eager).fetch()

    @torch.inference_mode()
    def _mixed_chunk_start(self, tokens, positions, block_tables,
                           temperatures, budgets, pf: List, *,
                           eager: bool) -> MixedChunkHandle:
        if self.mixed_prefill_slices <= 0:
            raise RuntimeError("mixed batching disabled for this executor")
        S, T = self.mixed_prefill_slices, self.mixed_slice_tokens
        if not 0 < len(pf) <= S:
            raise ValueError(f"{len(pf)} slices for a geometry of {S}")
        reqs = [(list(t), sp, bt, temp) for _slot, t, sp, bt, temp in pf]
        if self.ragged_attention:
            if sum(len(r[0]) for r in reqs) > T:
                raise ValueError(f"ragged pack exceeds the capacity {T}")
        elif any(not 0 < len(r[0]) <= T for r in reqs):
            raise ValueError(f"a slice is empty or wider than {T}")
        t0 = time.perf_counter()
        name, p = self._step0_program()
        self._fill(tokens, positions, block_tables, temperatures, budgets)
        self._stage_step0(p, reqs)
        start = self._event(timing=True)
        first = self._launch(name, p, self._step0_body, eager)
        steps = max(1, self._chunk_steps(budgets))
        for _ in range(1, steps):
            self._run_step(eager)
        return self._handle(MixedChunkHandle, steps, t0, start,
                            first[:len(pf)])

    # -- warmup ---------------------------------------------------------------

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every program once, capture the graphs, calibrate
        ``step_ms`` (``JaxExecutor.warmup``, llmq_tpu/engine/executor.py:
        1620-1811). In order: each program once eagerly, every write
        through all-zero block tables to page 0: bucket mode one prefill
        per bucket with one row and with ``prefill_batch`` rows, ragged
        mode one ragged prefill; one decode chunk; with a mixed geometry
        one mixed chunk (on the card these build every kernel library,
        set every kernel attribute, make every split workspace and warm
        cuBLAS, all outside capture). Then (card only) the graphs: each
        prefill program's, largest first, then the decode step's and the
        mixed step 0's of each decode route (fused and split; an int8
        cache has the fused one). Then ``step_ms`` from three pairs of a
        1-step and a K-step chunk, as JAX: each pair's difference over
        the K-step chunk's effective steps, the median, clamped to
        :data:`STEP_MS_RANGE`. Records ``warmup_split`` and ``compile_s``
        (on the card every kernel library is built first, timed apart),
        notes each captured graph as a compile in the device telemetry,
        then measures the round-trip floor."""
        t_start = time.perf_counter()
        self.compile_s = 0.0
        if self.device.type == "cuda":
            kernels.build()
            self.compile_s = time.perf_counter() - t_start
        graphs_before = len(self.step_graphs) + len(self.program_graphs)
        B, MP, K = (self.spec.batch_size, self.spec.max_pages_per_seq,
                    self.chunk_size)
        bt = np.zeros(MP, np.int32)
        zeros = np.zeros(B, np.int32)
        zbt = np.zeros((B, MP), np.int32)
        ztemp = np.zeros(B, np.float32)
        ones = np.ones(B, np.int32)
        waves = []

        def programs(eager: bool, mixed: bool = True) -> None:
            if self.ragged_attention:
                waves.append(self._ragged_prefill_start(
                    [([1] * min(8, self.mixed_slice_tokens), 0, bt, 0.0)],
                    eager=eager))
            else:
                # Largest program first: its capture sizes the shared pool,
                # which the smaller ones then reuse. Lengths prev+1..bucket
                # run as the bucket's programs.
                lows = [0] + self.prefill_buckets[:-1]
                for prev, bucket in reversed(list(zip(lows,
                                                      self.prefill_buckets))):
                    req = ([1] * min(bucket, prev + 1), 0, bt, 0.0)
                    for rows in sorted({1, self.prefill_batch}, reverse=True):
                        waves.append(self._prefill_wave([req] * rows, rows,
                                                        eager=eager))
            if mixed and self.mixed_prefill_slices:
                self._mixed_chunk(zeros, zeros, zbt, ztemp, ones,
                                  [(0, [1], 0, bt, 0.0)], eager=eager)

        programs(eager=True)
        self._decode_chunk(zeros, zeros, zbt, ztemp, ones, eager=True)
        t_capture = time.perf_counter()
        if self._graphs_on:
            # Every prefill program, then every decode route's step and
            # mixed step 0 (an int8 cache has the fused route only); each
            # captured at its first replay here.
            programs(eager=False, mixed=False)
            route = self.fused_decode
            for fused in ([True, False] if "k_scale" not in self.cache
                          else [True]):
                self.fused_decode = fused
                self._step_graph()
                if self.mixed_prefill_slices:
                    self._mixed_chunk(zeros, zeros, zbt, ztemp, ones,
                                      [(0, [1], 0, bt, 0.0)], eager=False)
            self.fused_decode = route
            torch.cuda.synchronize(self.device)
        capture_s = time.perf_counter() - t_capture
        for hs in waves:
            self.gather_scalars(hs)
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
        captured = (len(self.step_graphs) + len(self.program_graphs)
                    - graphs_before)
        self._telemetry.note_warmup(captured, captured)
        self._telemetry.note_warmup_complete(sum(self.warmup_split.values()))
        try:
            # The serving-path round-trip floor, on /metrics.
            self._telemetry.set_rtt(measure_rtt(self.device))
        except Exception:  # noqa: BLE001 — telemetry only
            log.exception("rtt measurement failed")
        log.info("warmup: %.2f s (capture %.2f s: %d graphs, %.1f MiB of "
                 "shared program pool); decode step %s ms",
                 sum(self.warmup_split.values()), capture_s,
                 len(self.step_graphs) + len(self.program_graphs),
                 sum(g.pool_bytes for g in self.program_graphs.values())
                 / 2**20,
                 f"{self.step_ms:.2f}" if self.step_ms else "not measured")

    def release_graphs(self) -> None:
        """Drop every captured graph and program buffer (their memory
        returns to the allocator's cache); later calls capture again."""
        self.step_graphs.clear()
        self.program_graphs.clear()
        self._programs.clear()
        self._graph_pool = None

    # -- the decode step ------------------------------------------------------

    def _chunk_steps(self, budgets: np.ndarray) -> int:
        return min(self.chunk_size, int(np.max(budgets)) if len(budgets)
                   else 0)

    def _fill(self, tokens, positions, block_tables, temperatures,
              budgets, carry: Optional[ChunkHandle] = None) -> None:
        """Start a chunk: copy the host inputs into the static buffers
        through the next slot of the step's staging ring (asynchronously
        on the card), set the carry and reset ``out`` (all EOS) and the
        step index. Without ``carry`` no row starts latched; with it the
        rows' tokens, positions and latches are its end state, copied on
        the device."""
        b = self._buf
        names = (() if carry is not None else ("tok", "pos")) + (
            "bt", "temps", "budgets")
        slot = self._staging.take("step", {
            n: (tuple(getattr(b, n).shape), getattr(b, n).dtype)
            for n in ("tok", "pos", "bt", "temps", "budgets")})
        arrays = {"tok": tokens, "pos": positions, "bt": block_tables,
                  "temps": temperatures, "budgets": budgets}
        for name in names:
            view, arr = slot.views[name], np.asarray(arrays[name])
            if arr.shape != view.shape:
                raise ValueError(f"{name}: shape {arr.shape}, the executor's "
                                 f"geometry needs {view.shape}")
            view[...] = arr
            getattr(b, name).copy_(slot.bufs[name], non_blocking=self._pin)
        slot.record()
        if carry is None:
            b.frozen.zero_()
        else:
            b.tok.copy_(carry.tok)
            b.pos.copy_(carry.pos)
            b.frozen.copy_(carry.frozen)
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
        b.idle.add_((~active.any()).to(torch.int64))
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
        self._replay(self._step_graph())
        self.graph_replays += 1

    def _replay(self, g: _StepGraph) -> None:
        g.graph.replay()
        for name, n in g.launches.items():
            kernels.LAUNCHES[name] += n

    def _step_graph(self) -> _StepGraph:
        """The current route's captured step, captured at first use."""
        g = self.step_graphs.get(self.fused_decode)
        if g is None:
            g = self.step_graphs[self.fused_decode] = self._capture(
                self._step, pool=None)
            self._note_capture("decode_step_fused" if self.fused_decode
                               else "decode_step_split", g)
            log.info("captured the decode step (%s route): %d kernel "
                     "launches a replay, pool %.1f MiB",
                     "fused" if self.fused_decode else "split",
                     sum(g.launches.values()), g.pool_bytes / 2**20)
        return g

    def _capture(self, body, pool) -> _StepGraph:
        """Capture ``body`` (the decode step, or a program's body over its
        inputs, which the caller has set to write the null page only).
        One eager run on the capture stream comes first, every decode row
        frozen so that its writes land on page 0: the kernel libraries,
        their attributes, the split workspaces and that stream's cuBLAS
        workspace then all exist before capture. The decode step's
        buffers are restored afterwards. ``pool``: a shared graph memory
        pool, or None for a private one. The private generator is
        registered with the graph, so each replay draws fresh numbers.
        The capture launches nothing: its launch counts are taken back
        out of ``kernels.LAUNCHES`` and kept as what each replay adds. A
        failed capture raises."""
        dev, b = self.device, self._buf
        t0 = time.perf_counter()
        saved = [t.clone() for t in b.tensors()]
        b.frozen.fill_(True)
        b.bt.zero_()
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            body()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = body()
        launches = {name: n - before[name]
                    for name, n in kernels.LAUNCHES.items()
                    if n != before[name]}
        kernels.LAUNCHES.update(before)
        pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        for t, v in zip(b.tensors(), saved):
            t.copy_(v)
        return _StepGraph(graph, launches, pool_bytes,
                          time.perf_counter() - t0, out)

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

    def _decode_steps(self, steps: int, eager: bool) -> int:
        """The blocking chunk's decode steps ``0..steps-1``; returns how
        many ran. Step ``j - 1``'s exit flag is read only after step ``j``
        is queued, so the device never waits for the host: the one extra
        step that can run has every row inactive (its writes go to page 0
        and its outputs stay EOS)."""
        ran = 0
        for j in range(steps):
            self._run_step(eager)
            self._flag(j)
            ran += 1
            if j > 0 and not self._left_after(j - 1):
                break
        return ran

    # -- prefill programs and the mixed step 0 --------------------------------

    def _program(self, name: str, shapes: Dict[str, tuple]) -> _Program:
        """The named program's static inputs (made at first use): device
        buffers of ``shapes`` (name → (shape, dtype))."""
        p = self._programs.get(name)
        if p is None:
            p = self._programs[name] = _Program(
                name, dict(shapes),
                {k: torch.zeros(shape, dtype=dt, device=self.device)
                 for k, (shape, dt) in shapes.items()})
        return p

    def _rows_shapes(self, n: int, T: int) -> Dict[str, tuple]:
        """Inputs of a bucket-style program: n rows of T tokens."""
        MP = self.spec.max_pages_per_seq
        return {"tok": ((n, T), torch.int32), "pos": ((n, T), torch.int32),
                "len": ((n,), torch.int32), "bt": ((n, MP), torch.int32),
                "temps": ((n,), torch.float32)}

    def _step0_program(self):
        """(graph name, program) of the mixed step 0 on the current decode
        route: bucket mode S rows of T tokens, ragged mode the packed
        (N,) buffer and S slice descriptors."""
        S, MP = self.mixed_prefill_slices, self.spec.max_pages_per_seq
        if self.ragged_attention:
            N = self.ragged_buffer
            return "ragged_step0", self._program("ragged_step0", {
                "tok": ((N,), torch.int32), "pos": ((N,), torch.int32),
                "qoff": ((S,), torch.int32), "qlen": ((S,), torch.int32),
                "bt": ((S, MP), torch.int32),
                "temps": ((S,), torch.float32)})
        route = "fused" if self.fused_decode else "split"
        return (f"mixed_step0_{route}", self._program(
            "mixed_step0", self._rows_shapes(S, self.mixed_slice_tokens)))

    def _stage_inputs(self, p: _Program, fill) -> None:
        """Write a program's inputs: take the next slot of its staging
        ring (once the last copy out of that slot has run), let ``fill``
        write the slot's numpy views, then copy every input to the device
        (asynchronously on the card) and fence the slot."""
        slot = self._staging.take(p.name, p.shapes)
        for v in slot.views.values():
            v[...] = 0
        fill(slot.views)
        for k, buf in p.bufs.items():
            buf.copy_(slot.bufs[k], non_blocking=self._pin)
        slot.record()

    @staticmethod
    def _fill_rows(v, reqs: List) -> None:
        """Bucket-style inputs: request i in row i, right-padded, its
        padding positions clamped to its last token; unused rows one
        token against the null page (JAX's convention)."""
        T = v["tok"].shape[1]
        v["len"][...] = 1
        for i, (t, sp, bt, temp) in enumerate(reqs):
            n = len(t)
            v["tok"][i, :n] = t
            v["pos"][i] = np.minimum(np.arange(T) + sp, sp + n - 1)
            v["len"][i] = n
            v["bt"][i] = bt
            v["temps"][i] = temp

    def _fill_ragged(self, v, reqs: List) -> None:
        """Ragged inputs: the requests packed into the (N,) buffer, each
        segment on a q-block boundary; unused slices have qlen 0."""
        N, qblk = self.ragged_buffer, RAGGED_Q_BLOCK
        off = 0
        for i, (t, sp, bt, temp) in enumerate(reqs):
            n = len(t)
            if n == 0 or off + n > N:
                raise ValueError(f"slices do not pack into {N} rows")
            v["tok"][off:off + n] = t
            v["pos"][off:off + n] = np.arange(n) + sp
            v["qoff"][i], v["qlen"][i] = off, n
            v["bt"][i] = bt
            v["temps"][i] = temp
            off += -(-n // qblk) * qblk

    def _stage_step0(self, p: _Program, reqs: List) -> None:
        if self.ragged_attention:
            self._stage_inputs(p, lambda v: self._fill_ragged(v, reqs))
        else:
            self._stage_inputs(p, lambda v: self._fill_rows(v, reqs))

    def _prefill_body(self, p: _Program) -> torch.Tensor:
        """A prefill program: the forward over its rows, the LM head at
        each row's last token, sampling. Returns (n,) int32 tokens."""
        b = p.bufs
        logits = self.model.forward_prefill_last(b["tok"], b["pos"],
                                                 b["len"], self.cache,
                                                 b["bt"])
        return sample_token(logits, self._gen, temperature=b["temps"],
                            top_k=self._top_k, top_p=self._top_p)

    def _step0_body(self, p: _Program) -> torch.Tensor:
        """A mixed step 0 over the decode step's buffers and the slices in
        ``p``: the mixed forward, the slices' tokens sampled at their last
        token, then the decode rows' step 0 (:meth:`_advance`). Returns
        the (S,) slice tokens."""
        sb, b = self._buf, p.bufs
        active = (~sb.frozen) & (sb.j < sb.budgets)
        if self.ragged_attention:
            dec_logits, pf_logits = self.model.forward_mixed_ragged(
                sb.tok, sb.pos, self.cache, sb.bt, b["tok"], b["pos"],
                b["qoff"], b["qlen"], b["bt"], active)
        else:
            dec_logits, pf_logits = self.model.forward_mixed(
                sb.tok, sb.pos, self.cache, sb.bt, b["tok"], b["pos"],
                b["len"], b["bt"], active, fused=self.fused_decode,
                last_only=True)
        first = sample_token(pf_logits, self._gen, temperature=b["temps"],
                             top_k=self._top_k, top_p=self._top_p)
        self._advance(active, dec_logits)
        return first

    def _program_graph(self, name: str, p: _Program, body) -> _StepGraph:
        """Program ``name``'s graph, captured at its first replay into
        the shared pool. Its staged inputs are kept aside meanwhile and
        set to write the null page only (every row one token, all-zero
        block tables)."""
        g = self.program_graphs.get(name)
        if g is not None:
            return g
        saved = {k: t.clone() for k, t in p.bufs.items()}
        for k, t in p.bufs.items():
            t.fill_(1 if k == "len" else 0)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        g = self.program_graphs[name] = self._capture(lambda: body(p),
                                                      self._graph_pool)
        self._note_capture(name, g)
        for k, t in p.bufs.items():
            t.copy_(saved[k])
        self.program_replays.setdefault(name, 0)
        log.info("captured %s: %d kernel launches a replay, %.1f MiB added "
                 "to the shared pool, %.2f s", name, sum(g.launches.values()),
                 g.pool_bytes / 2**20, g.capture_s)
        return g

    def _launch(self, name: str, p: _Program, body,
                eager: bool) -> torch.Tensor:
        """Run program ``name`` over its staged inputs: on the card one
        replay of its graph (captured first if it is not yet; its kernels
        added to ``kernels.LAUNCHES``), on the CPU or with ``eager`` the
        body itself. Returns its tokens; a replay's are rewritten by the
        next replay of the same graph."""
        if eager or not self._graphs_on:
            return body(p)
        g = self._program_graph(name, p, body)
        self._replay(g)
        self.program_replays[name] += 1
        return g.out

    def _ring_put(self, tokens: torch.Tensor,
                  rows: List[int]) -> List[PrefillHandle]:
        """Copy a dispatch's tokens into the next result-ring slot, queue
        that slot's copy to host memory with an event behind it, and hand
        out handles to ``rows`` of it. Handles the slot still holds
        unfetched are fetched first (a join of one then uses its value)."""
        slot = self._ring_next
        self._ring_next = (slot + 1) % RESULT_RING
        for h in self._ring_handles[slot]:
            if h.value is None:
                h.value = h.copy.read(h.row)
        row = self._ring[slot]
        row[:tokens.shape[0]].copy_(tokens)
        host = torch.empty(row.shape, dtype=torch.int32, pin_memory=self._pin)
        host.copy_(row, non_blocking=self._pin)
        copy = _HostCopy(host, self._event())
        hs = [PrefillHandle(slot, r, copy) for r in rows]
        self._ring_handles[slot] = hs
        return hs

    @torch.inference_mode()
    def _prefill_wave(self, reqs: List, rows: int, *,
                      eager: bool = False) -> List[PrefillHandle]:
        """One bucket program over ``reqs`` (each a chunk of at most the
        largest bucket) in its ``rows``-row variant: ``prefill_b{T}`` for
        one row, ``prefill_multi_b{T}`` for a wave."""
        T = self._bucket_for(max(len(r[0]) for r in reqs))
        name = f"prefill_b{T}" if rows == 1 else f"prefill_multi_b{T}"
        p = self._program(name, self._rows_shapes(rows, T))
        self._stage_inputs(p, lambda v: self._fill_rows(v, reqs))
        out = self._launch(name, p, self._prefill_body, eager)
        return self._ring_put(out, list(range(len(reqs))))

    @torch.inference_mode()
    def _ragged_prefill_start(self, reqs: List, *,
                              eager: bool = False) -> List:
        """Prefill through the ragged step with every decode row frozen
        (no bucket program runs in ragged mode;
        ``JaxExecutor._ragged_prefill_start``). Each prompt is cut into
        pieces of at most the capacity, packed in order, as many per step
        as fit (all slice writes of a layer precede its attention launch,
        so a later piece sees an earlier one's K/V). Returns one handle
        per request (None for an empty one): its token sampled after its
        last piece."""
        cap, S = self.mixed_slice_tokens, self.mixed_prefill_slices
        qblk, N = RAGGED_Q_BLOCK, self.ragged_buffer
        pieces = []
        for ri, (toks, sp, bt, temp) in enumerate(reqs):
            toks = list(toks)
            for o in range(0, len(toks), cap):
                chunk = toks[o:o + cap]
                pieces.append((ri, (chunk, sp + o, bt, temp),
                               o + len(chunk) >= len(toks)))
        results: List = [None] * len(reqs)
        name, p = self._step0_program()
        i = 0
        while i < len(pieces):
            group, live, padded = [], 0, 0
            while i < len(pieces) and len(group) < S:
                n = len(pieces[i][1][0])
                pad = -(-n // qblk) * qblk
                if group and (live + n > cap or padded + pad > N):
                    break
                group.append(pieces[i])
                live, padded, i = live + n, padded + pad, i + 1
            self._freeze_rows()
            self._stage_step0(p, [req for _ri, req, _fin in group])
            first = self._launch(name, p, self._step0_body, eager)
            fin = [j for j, (_ri, _req, done) in enumerate(group) if done]
            if fin:
                for j, h in zip(fin, self._ring_put(first, fin)):
                    results[group[j][0]] = h
        return results

    def _freeze_rows(self) -> None:
        """Every decode row inactive for a ragged prefill step: budgets
        0 and all-zero block tables, so their writes land on page 0 and
        their samples are discarded (device fills; no host copy)."""
        b = self._buf
        for t in (b.tok, b.pos, b.bt, b.budgets, b.j):
            t.zero_()
        b.frozen.fill_(True)

    def release_slot(self, slot: int) -> None:
        pass  # no per-slot state: block tables carry everything

    def resume(self, slot: int, tokens: List[int], start_pos: int) -> None:
        pass
