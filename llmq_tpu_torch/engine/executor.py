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

Speculation (``speculation_draft_k`` > 0; ``JaxExecutor.verify_chunk``):
``verify_chunk_start`` runs one verify window of up to W = draft_k + 1
teacher-forced decode steps over the same static buffers. With device
accept (the default) each step is the decode step's own forward with a
verify carry (:meth:`TorchExecutor._advance_verify`: step j feeds draft
j, a row freezes the step after its sample differs from its draft or is
EOS, ``n_commit`` counts its active steps), replayed from a graph of its
own per decode route and ended early as the blocking chunk is; with host
accept one graph runs ``forward_verify`` over all W steps and samples
every position after it, and the host computes ``n_commit``
(:func:`verify_host_ncommit`). Both sample with the position-keyed
sampler (``ops/sampling.py`` ``sample_token_keyed``), so a committed
token depends on (seed, row, position) and its prefix only; the window's
tokens (and ``n_commit``) come back in one transfer. With
``speculation_draft_k`` 0 the executor has no ``verify_chunk`` and no
``verify_chunk_start`` (None), and builds no verify program.

Mesh serving (``mesh=``, a ``parallel.Mesh`` with a ``tp`` axis; JAX's
mesh branch): one process per rank. Each rank's executor holds its ``tp``
shard of the weights (``parallel.shard_params``) and of the pool (``H_kv
/ tp`` KV heads) and launches the port's kernels on it; the model's
collectives stitch the shards (one all-reduce after ``wo``, one after
``w_down``, the vocab-sharded embedding and LM head). Rank 0 (the driver)
serves; before each entry point that dispatches device work (a prefill
program or wave, a decode or mixed chunk, warmup, a graph release) it
broadcasts a descriptor over the mesh's gloo control group (the entry
point's name and its host arguments: tokens, positions, block tables,
lengths, budgets, temperatures; a handle argument as its number), and
every other rank (a follower, :meth:`TorchExecutor.follow`) makes the
same call on its own executor. Every rank samples the same gathered
logits with its generator seeded alike and drawn in the same order, so
the carry of a K-step chunk (``tok``, ``pos``, ``frozen``) is the same
on every rank and each rank's host logic (early exits, ring fetches)
takes the same turns. Only the engine's entry points are mirrored, never
a call one of them makes. A call whose arguments are refused
(:class:`MeshArgumentError`, raised before any device work) fails alike on
every rank and the mesh goes on; any other failure leaves the mesh: a
follower whose call failed exits its loop at once, so the driver's next
collective fails on the closed peer, and a driver whose call failed
broadcasts an abort that makes its followers leave. The driver sends a
heartbeat while idle and a stop at :meth:`TorchExecutor.release_mesh`; a
follower whose driver is gone raises out of its loop within the mesh's
timeout. On the card a ``tp > 1`` group
must be NCCL (its collectives are captured in the CUDA graphs); at ``tp``
1 there is no collective, so a gloo world of several ranks may share one
card. Ragged attention is turned off, as in JAX.

A ``dp`` axis that divides both the batch and the pool (JAX's
``dp_shards`` rule; otherwise dp degrades to replication with JAX's
warning) splits them into replicas (``parallel/dp.py``). Replica d runs
rows ``[d·B/dp, (d+1)·B/dp)`` on programs captured at B/dp rows over a
pool of its universe's P/dp pages, its own null slot and its guest slots;
every rank slices its rows out of the broadcast full-batch arguments and
translates their block tables to local slots before a launch (a host
map: no kernel changes). The two design answers of the port:

- *The null page per universe.* The allocator stays JAX's (page 0
  reserved in universe 0 only). Every replica's local slot 0 is its null
  page, and page 0 maps there on every rank, so inactive rows, unused
  wave rows and padding write there as they write page 0 on one device.
- *Cross-universe pages are served.* Before a program every rank plans,
  from the same descriptor, the pages outside its universe that its rows
  and prefills touch; their home replicas send them into its guest
  slots, shard to shard over the gloo dp group, and after the program
  every guest page it can write goes home, so the home copy is always
  current (a row writes from its position on, a prefill over its range;
  a shared prefix before them stays read only). The guest region holds
  the most foreign pages one program can touch, so nothing JAX serves is
  refused (``hbm_info`` states it).

Each prefill (a wave's member, a ``prefill_async`` chunk, a mixed
chunk's slice) runs on the replica whose universe holds the page of its
first written position: its slot's universe unless the allocator fell
back, and then no page needs to move. A decode join whose prefill ran on
another replica has the token moved to it first. Every other replica's
first tp rank sends its rows' results (tokens, ``n_commit``, first
tokens) to the driver after each program, from a thread that waits for
the program's copy while the rank dispatches on; a receiver thread on
the driver files them and the driver's handles join them in the engine's
order (a replica that ran nothing for a call sends nothing); the K-step
carry stays on each replica's device. A blocking chunk's and a verify
window's early exit is decided on the flags of every replica (a max over
the dp group), so every rank's host logic takes the same turns.

The tiered KV plane's transport runs on any mesh with JAX's full page
(every KV head, :meth:`TorchExecutor.kv_page_spec`): an export is
mirrored, the ranks of each page's home replica send their head shards
to the driver, which assembles the pages; an import sends each of those
ranks its slice of the payload.

:class:`EchoExecutor` (JAX's, for ``executor.backend: echo``) echoes the
prompt on the host with numpy, no model and no tensor, through the same
entry points: blocking by default (its futures API None, so the engine
takes its blocking branches), or dispatching to a FIFO device-queue
thread with ``async_chunks``.
"""

from __future__ import annotations

import atexit
import functools
import logging
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

from llmq_tpu_torch.core.config import resolve_device
from llmq_tpu_torch.models.llama import Llama, LlamaConfig, init_kv_pages
from llmq_tpu_torch.observability.device import (get_device_telemetry,
                                                 measure_rtt)
from llmq_tpu_torch.ops import kernels
from llmq_tpu_torch.ops.attention import RAGGED_Q_BLOCK
from llmq_tpu_torch.ops.quant import is_quantized, param_count, params_bytes
from llmq_tpu_torch.ops.sampling import sample_token, sample_token_keyed
from llmq_tpu_torch.parallel.dp import leaf_views, page_bytes

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
                 "_start", "_done", "_host_ms", "_note", "_value", "mid",
                 "_merge", "__weakref__")

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
        #: Its number on a mesh (the same on every rank), else None.
        self.mid: Optional[int] = None
        #: On a dp mesh's driver: ``(ready, merge)``, whether the other
        #: replicas' rows have arrived and the function that joins them
        #: with this replica's values (:meth:`TorchExecutor._dp_merge`).
        self._merge = None

    def ready(self) -> bool:
        if self._value is not None:
            return True
        return ((self._done is None or self._done.query())
                and (self._merge is None or self._merge[0]()))

    def wait_ready(self) -> None:
        """Wait on this chunk's own completion event, recorded behind the
        copy of its tokens to host memory (no stream-wide wait), and on a
        dp mesh's driver for the other replicas' rows; at once on the
        CPU."""
        if self._done is not None:
            self._done.synchronize()
        if self._merge is not None:
            self._wait()

    def _wait(self) -> np.ndarray:
        if self._value is None:
            ms = self._host_ms
            if self._done is not None:
                self._done.synchronize()
                ms = (self._start.elapsed_time(self._done) / self.steps
                      if self.steps else None)
            value = self._host.numpy()
            if self._merge is not None:
                value = self._merge[1](value)
            self._value = value
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


def verify_host_ncommit(out: np.ndarray, drafts: np.ndarray,
                        qlens: np.ndarray, eos: int) -> np.ndarray:
    """The accept rule of a fetched verify window on the host (the JAX
    package's ``verify_host_ncommit``): the mirror of the device-accept
    step's freeze, used in host-accept mode. Per row: walk the window,
    count a commit per step, stop after the step whose sample is EOS, is
    the row's last window position, or differs from its draft (that
    sample is the correction and is committed)."""
    B, W = out.shape
    nc = np.zeros(B, np.int32)
    for i in range(B):
        w = int(qlens[i])
        n = 0
        for j in range(min(w, W)):
            n += 1
            t = int(out[i, j])
            if t == eos or j >= w - 1:
                break
            if int(drafts[i, j]) != t:
                break
        nc[i] = n
    return nc


@dataclass
class _VerifyBuffers:
    """A verify window's static device buffers beside the decode step's
    (whose ``tok``, ``pos``, ``bt``, ``temps`` carry the rows' last
    committed tokens, positions, tables and temperatures, and whose
    ``budgets`` carry the window sizes ``qlens``)."""

    drafts: torch.Tensor     # (B, W) int32: the drafts, column W-1 is -1
    out: torch.Tensor        # (B, W) int32, EOS-padded
    ncommit: torch.Tensor    # (B,) int32: committed steps (device accept)
    rows: torch.Tensor       # (B,) int64: 0..B-1, the sampler's row keys

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)]


class VerifyHandle(ChunkHandle):
    """A dispatched verify window (``JaxExecutor``'s ``VerifyHandle``):
    ``fetch()`` resolves to ``(out (B, W), n_commit (B,))`` from one
    transfer. With device accept ``n_commit`` came with the tokens; with
    host accept (``drafts`` given) it is computed here from the fetched
    tokens by :func:`verify_host_ncommit`. A window carries nothing to a
    later dispatch."""

    __slots__ = ("_drafts", "_qlens", "_eos")

    def __init__(self, host, shape, steps, start, done, host_ms, note,
                 drafts=None, qlens=None, eos: int = 2) -> None:
        super().__init__(None, None, None, host, shape, steps, start, done,
                         host_ms, note)
        self._drafts = drafts
        self._qlens = qlens
        self._eos = eos

    def fetch(self) -> tuple:
        v = self._wait()
        n = self._shape[0] * self._shape[1]
        out = v[:n].reshape(self._shape)
        if self._drafts is None:
            return out, v[n:]
        return out, verify_host_ncommit(out, self._drafts, self._qlens,
                                        self._eos)


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

    __slots__ = ("slot", "row", "value", "copy", "mid", "replica")

    def __init__(self, slot: int, row: int, copy,
                 replica: int = 0) -> None:
        self.slot = slot
        self.row = row
        self.copy = copy
        self.value: Optional[int] = None
        #: Its number on a mesh (the same on every rank), else None.
        self.mid: Optional[int] = None
        #: The dp replica whose program sampled it (0 without dp); on
        #: the other replicas the handle holds no ring row.
        self.replica = replica


class _DpCopy:
    """Another replica's prefill tokens of one call, on a dp mesh's
    driver: ``read(row)`` waits for that replica's results
    (:meth:`~llmq_tpu_torch.parallel.dp.DpPlane.take`) once for every
    handle of the call. On a follower it is never read: a replica that
    needs another's token has it moved (``TorchExecutor._dp_tokens``)."""

    __slots__ = ("_take", "_replica", "_values")

    def __init__(self, take, replica: int) -> None:
        self._take = take
        self._replica = replica
        self._values = None

    def read(self, row: int) -> int:
        if self._values is None:
            self._values = self._take()[self._replica]
        return int(self._values[row])


class _Ref:
    """A handle in a mesh descriptor: its number, and a prefill handle's
    token when the driver has read it."""

    __slots__ = ("mid", "value")

    def __init__(self, mid: int, value: Optional[int]) -> None:
        self.mid = mid
        self.value = value

    def __reduce__(self):
        return (_Ref, (self.mid, self.value))


#: Handles a follower keeps by number: more than the result ring and the
#: pipeline ever hold unresolved.
MESH_HANDLES = 256


class MeshArgumentError(ValueError):
    """An entry point's arguments refused before any device work: a check
    of the arguments alone, which every rank of a mesh makes alike on the
    same descriptor, so the mesh goes on after it."""


class _MeshRelay:
    """The driver/follower protocol of a mesh executor: the descriptor of
    each entry point the engine calls, the handles numbered alike on
    every rank, the driver's abort after a failed call, its heartbeat and
    its stop. Descriptors go over the mesh's gloo ``control`` group from
    rank ``src``, the mesh's first rank."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.src = mesh.ranks[0]
        self.driver = mesh.is_driver
        self.lock = threading.RLock()
        self.next_mid = 0
        self.handles: "OrderedDict[int, object]" = OrderedDict()
        self.stopped = False
        #: Called after the driver's stop went out: the dp results
        #: receiver's wait for its followers' last messages.
        self.on_release: Optional[Callable[[], None]] = None
        self.sent_at = time.monotonic()
        self._beat: Optional[threading.Thread] = None
        #: The mesh's timeout (``LLMQ_CLUSTER_TIMEOUT``): an idle driver
        #: sends a heartbeat within half of it.
        self.heartbeat_s = mesh.timeout_s
        if self.driver and mesh.size > 1:
            self._beat = threading.Thread(target=self._heartbeat,
                                          name="mesh-heartbeat", daemon=True)
            self._beat.start()
            # A driver that exits without releasing still stops its
            # followers.
            atexit.register(self.release)

    def release(self) -> None:
        """The driver's stop to its followers, once; later calls raise."""
        with self.lock:
            if self.stopped or not self.driver:
                return
            self.stopped = True
            if self.mesh.size > 1:
                try:
                    self.send(("stop",))
                except Exception:  # noqa: BLE001 — the group is gone
                    log.exception("mesh stop failed")
            if self.on_release is not None:
                self.on_release()

    def send(self, msg) -> None:
        import torch.distributed as dist

        dist.broadcast_object_list([msg], src=self.src,
                                   group=self.mesh.control)
        self.sent_at = time.monotonic()

    def recv(self):
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=self.src,
                                   group=self.mesh.control)
        return box[0]

    def _heartbeat(self) -> None:
        """Keep an idle driver's followers inside the group's timeout."""
        while True:
            time.sleep(self.heartbeat_s / 4)
            with self.lock:
                if self.stopped:
                    return
                if time.monotonic() - self.sent_at >= self.heartbeat_s / 2:
                    try:
                        self.send(("ping",))
                    except Exception:  # noqa: BLE001 — the group is gone
                        log.exception("mesh heartbeat failed")
                        self.stopped = True
                        return

    def encode(self, x):
        if isinstance(x, (ChunkHandle, PrefillHandle)):
            if x.mid is None:
                raise RuntimeError("a handle made inside another call "
                                   "cannot cross the mesh")
            return _Ref(x.mid, x.value if isinstance(x, PrefillHandle)
                        else None)
        if isinstance(x, (list, tuple)):
            return type(x)(self.encode(v) for v in x)
        if isinstance(x, dict):
            return {k: self.encode(v) for k, v in x.items()}
        return x

    def decode(self, x):
        if isinstance(x, _Ref):
            h = self.handles.get(x.mid)
            if h is None:
                raise RuntimeError(f"mesh handle {x.mid} is not held here")
            if x.value is not None and isinstance(h, PrefillHandle):
                h.value = x.value
            return h
        if isinstance(x, (list, tuple)):
            return type(x)(self.decode(v) for v in x)
        if isinstance(x, dict):
            return {k: self.decode(v) for k, v in x.items()}
        return x

    def number(self, out) -> None:
        """Number the handles a mirrored call returned (one per handle,
        in order, alike on every rank); a follower keeps them."""
        for h in (out if isinstance(out, list) else [out]):
            if isinstance(h, (ChunkHandle, PrefillHandle)):
                h.mid = self.next_mid
                self.next_mid += 1
                if not self.driver:
                    self.handles[h.mid] = h
                    while len(self.handles) > MESH_HANDLES:
                        self.handles.popitem(last=False)


def _mirrored(fn):
    """An entry point the engine calls on :class:`TorchExecutor` (never
    one the executor calls itself): on a mesh driver it first broadcasts
    its descriptor, then runs, and broadcasts an abort if it failed past
    its argument checks; on every rank the handles it returns are
    numbered."""
    name = fn.__name__

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        relay = self._relay
        if relay is None:
            return fn(self, *args, **kwargs)
        with relay.lock:
            sends = relay.driver and relay.mesh.size > 1
            if sends:
                if relay.stopped:
                    raise RuntimeError("the mesh was released")
                relay.send(("call", name, relay.encode(args),
                            relay.encode(kwargs)))
            try:
                out = fn(self, *args, **kwargs)
            except MeshArgumentError:
                raise
            except Exception:
                if sends:
                    try:
                        relay.send(("abort", name))
                    except Exception:  # noqa: BLE001 — a follower left
                        log.exception("mesh abort of %s failed", name)
                raise
            relay.number(out)
            return out

    return call


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
                 speculation_draft_k: int = 0,
                 speculation_device_sampling: bool = True,
                 device: str = "cuda", telemetry_name: str = "engine0",
                 telemetry_metrics: bool = True, mesh=None) -> None:
        if cache_dtype == torch.int8 and not fused_decode:
            # The JAX package's int8-KV decode step has no split route.
            raise ValueError("fused_decode=False has no int8-KV route: the "
                             "int8 decode step is the fused kernel only")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        #: The rank mesh this executor serves over (None: one device).
        self.mesh = mesh
        #: dp page universes of the pool (``JaxExecutor.dp_shards``): the
        #: mesh's dp where it divides both the batch and the pool, else 1.
        self.dp_shards = 1
        self._relay: Optional[_MeshRelay] = None
        #: This replica's plane of the dp universes (None without them).
        self._dp = None
        kv_heads = None
        tp = None
        if mesh is not None:
            if ragged_attention:
                log.warning("ragged_attention requested but mesh sharding "
                            "is configured; keeping the bucket path (the "
                            "ragged kernel is single-chip)")
                ragged_attention = False
            params, tp, kv_heads = self._shard(model_cfg, params, mesh)
            if mesh.dp > 1:
                if num_pages % mesh.dp == 0 and batch_size % mesh.dp == 0:
                    self.dp_shards = mesh.dp
                else:
                    log.warning(
                        "mesh dp=%d does not divide num_pages=%d / "
                        "batch_size=%d; dp degrades to replication",
                        mesh.dp, num_pages, batch_size)
            self._relay = _MeshRelay(mesh)
        self.model = Llama(model_cfg, params, tp=tp)
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
        #: This replica's rows (B/dp on a dp mesh, else B): the size of
        #: every program's batch.
        self._rows = batch_size
        local_pages = num_pages
        if self.dp_shards > 1:
            from llmq_tpu_torch.parallel.dp import DpPlane

            rows = batch_size // self.dp_shards
            self._dp = DpPlane(
                mesh, num_pages, batch_size, self.spec.max_pages_per_seq,
                guest_rows=max(rows + self.mixed_prefill_slices,
                               self.prefill_batch))
            self._rows = rows
            local_pages = self._dp.local_pages
            #: Per row, a position at or before the one its next program
            #: writes first (0: unknown), alike on every rank: the pages
            #: before it are a read-only prefix that need not go home.
            self._dp_floor = np.zeros(batch_size, np.int64)
            self._relay.on_release = self._dp.close
        self.cache = init_kv_pages(model_cfg, local_pages, page_size,
                                   self.device, dtype=cache_dtype,
                                   kv_heads=kv_heads)
        #: The pool's KV-head shards (1 unless tp splits whole heads): a
        #: transported page holds every head.
        self._kv_shards = model_cfg.n_kv_heads // (kv_heads
                                                    or model_cfg.n_kv_heads)
        #: The driver's full-page payload of a mesh import in progress.
        self._import_stage: Optional[torch.Tensor] = None
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
        #: Speculation: ``verify_draft_k`` > 0 builds the verify window
        #: (static width W = draft_k + 1); its draws are keyed by (this
        #: base seed, row, position), not taken from ``_gen``.
        self.verify_draft_k = max(0, int(speculation_draft_k))
        self._spec_device_sampling = bool(speculation_device_sampling)
        self._spec_seed = (seed ^ 0x5BEC) & 0xFFFFFFFF
        #: The verify program's body: one device-accept step, or the
        #: whole host-accept window.
        self._verify_body = (self._verify_step if self._spec_device_sampling
                             else self._verify_window)
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
        B, MP, K = self._rows, self.spec.max_pages_per_seq, self.chunk_size

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
        W = self.verify_draft_k + 1
        self._vbuf: Optional[_VerifyBuffers] = None
        if self.verify_draft_k:
            self._vbuf = _VerifyBuffers(
                drafts=torch.full((B, W), -1, dtype=torch.int32,
                                  device=self.device),
                out=zeros((B, W), torch.int32), ncommit=zeros(B, torch.int32),
                # The global rows: a replica keys its draws as one
                # device keys those rows.
                rows=torch.arange(B, dtype=torch.int64, device=self.device)
                + (self._dp.row0 if self._dp is not None else 0))
        else:
            # The off-switch: no verify program, and the engine sees no
            # verify entry point at all.
            self.verify_chunk = None
            self.verify_chunk_start = None
        # One exit flag a step of the longest early-exit loop (a decode
        # chunk or a device-accept verify window).
        n_flags = max(K, W)
        self._left_host = torch.zeros(n_flags, dtype=torch.bool,
                                      pin_memory=pin)
        self._left_events = ([torch.cuda.Event() for _ in range(n_flags)]
                             if pin else None)
        #: The captured decode step of each route (key: ``fused_decode``).
        self.step_graphs: Dict[bool, _StepGraph] = {}
        #: Graph replays so far: the host's launches of decode steps.
        self.graph_replays = 0
        #: The verify window's captured programs by name
        #: (``verify_step_fused|split`` with device accept,
        #: ``verify_window_fused|split`` with host accept) and the host's
        #: replays of them.
        self.verify_graphs: Dict[str, _StepGraph] = {}
        self.verify_replays = 0
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
        #: Tiered KV transport: the stream that copies promoted pages to
        #: the device (made at the first promotion on the card) and, on
        #: the card, the timing events of the last gather, host → device
        #: copy and inject (``name → (start event, end event, bytes)``).
        self._h2d_stream = None
        self.kv_last_transfer: Dict[str, tuple] = {}

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
                # MFU over every card of the mesh.
                "n_chips": self.mesh.size if self.mesh is not None else 1}

    def _device_kind(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return self.device.type

    def _shard(self, cfg: LlamaConfig, params, mesh):
        """This rank's shard of ``params`` under the partition rules, its
        :class:`~llmq_tpu_torch.models.llama.TensorParallel`, and the KV
        heads its pool holds. Refuses a mesh it cannot serve over: one of
        several ranks without its world, and on the card one without a
        process group or whose ``tp > 1`` group is not NCCL."""
        from llmq_tpu_torch.parallel.sharding import (kv_cache_shardings,
                                                      param_shardings,
                                                      shard_params,
                                                      tensor_parallel)

        if self.device.type == "cuda" and mesh.group is None:
            raise ValueError(
                "a CUDA executor's mesh needs its NCCL process group: join "
                "the world first (parallel.distributed_init, or the "
                "LLMQ_COORDINATOR variables)")
        if (self.device.type == "cuda" and mesh.tp > 1
                and mesh.backend != "nccl"):
            raise ValueError(
                f"a CUDA executor's tp group must be NCCL (got "
                f"{mesh.backend}): its collectives are captured in the "
                f"CUDA graphs; join with device cuda")
        if mesh.size > 1 and mesh.control is None:
            raise ValueError(
                f"a mesh of {mesh.size} ranks needs its world: join it "
                f"first (parallel.distributed_init, or the "
                f"LLMQ_COORDINATOR variables)")
        quantized = is_quantized(params["layers"]["wq"])
        shardings = param_shardings(cfg, mesh, quantized=quantized,
                                    params=params)
        local = shard_params(params, shardings, mesh)
        kv = kv_cache_shardings(cfg, mesh)["k"]
        kv_heads = cfg.n_kv_heads // (mesh.tp if kv[3] == "tp" else 1)
        return local, tensor_parallel(mesh, shardings), kv_heads

    def follow(self) -> None:
        """A follower rank's loop: receive each descriptor the driver
        broadcasts and make the same call on this executor, until the
        driver's stop. A call whose arguments were refused
        (:class:`MeshArgumentError`) failed alike on the driver and the
        loop goes on. Any other failure raises out of the loop at once:
        this rank's own (the driver may wait in a collective it skipped,
        and fails on the closed peer once this rank leaves) and the
        driver's abort (its call failed where this rank's ran). A lost
        driver raises within the mesh's timeout."""
        relay = self._relay
        if relay is None or relay.driver:
            raise RuntimeError("follow() runs on a mesh rank other than 0")
        log.info("rank %d following the mesh driver (rank %d)",
                 self.mesh.rank, relay.src)
        while True:
            msg = relay.recv()
            kind = msg[0]
            if kind == "stop":
                log.info("rank %d: the driver released the mesh",
                         self.mesh.rank)
                if self._dp is not None:
                    self._dp.bye()
                return
            if kind == "ping":
                continue
            if kind == "hbm":
                import torch.distributed as dist

                dist.gather_object(self._hbm_entry(), None, dst=relay.src,
                                   group=self.mesh.control)
                continue
            if kind == "abort":
                raise RuntimeError(f"the driver's {msg[1]} failed where "
                                   f"rank {self.mesh.rank}'s ran")
            _kind, name, args, kwargs = msg
            try:
                getattr(self, name)(*relay.decode(args),
                                    **relay.decode(kwargs))
            except MeshArgumentError as e:
                log.warning("rank %d: mirrored %s refused its arguments, "
                            "as the driver's did: %s", self.mesh.rank,
                            name, e)
            except Exception as e:
                raise RuntimeError(f"mirrored {name} failed on rank "
                                   f"{self.mesh.rank}: {e}") from e

    def release_mesh(self) -> None:
        """On the driver, send the followers their stop (once); later
        device calls raise. No-op elsewhere."""
        if self._relay is not None:
            self._relay.release()

    def hbm_info(self) -> List[Dict]:
        """HBM accounting of the card this executor serves on: weight
        bytes, KV-pool bytes (the K/V pools, and the scale pools of an
        int8 cache), the CUDA-graph pools' bytes, and free and total
        memory from ``torch.cuda.mem_get_info`` (None on the CPU). On a
        mesh one entry per rank, ``chip`` its rank: the driver gathers the
        followers' (a host collective over the control group, between
        dispatches). Called from scrapes and stats only, never from the
        step path."""
        relay = self._relay
        if relay is None or relay.mesh.size == 1:
            return [self._hbm_entry()]
        if not relay.driver:
            return [self._hbm_entry()]
        import torch.distributed as dist

        with relay.lock:
            if relay.stopped:
                return [self._hbm_entry()]
            relay.send(("hbm",))
            entries: List = [None] * relay.mesh.size
            dist.gather_object(self._hbm_entry(), entries, dst=relay.src,
                               group=self.mesh.control)
        return entries

    def _hbm_entry(self) -> Dict:
        """This rank's entry of :meth:`hbm_info`."""
        chip = (self.mesh.rank if self.mesh is not None
                else self.device.index or 0)
        pool = sum(t.numel() * t.element_size() for t in self.cache.values())
        guests = 0
        if self._dp is not None:
            # The universe is this rank's share of the pool; the null and
            # guest slots are stated apart.
            per_page = pool // self._dp.local_pages
            guests = per_page * (1 + self._dp.guests)
            pool = per_page * self._dp.per
        entry = {"chip": str(chip),
                 "kind": self._device_kind(),
                 "weights_bytes": params_bytes(self.model.params),
                 "kv_pool_bytes": pool,
                 "graph_pool_bytes": sum(
                     g.pool_bytes for g in list(self.step_graphs.values())
                     + list(self.program_graphs.values())
                     + list(self.verify_graphs.values())),
                 "free_bytes": None, "limit_bytes": None}
        if self._dp is not None:
            entry["guest_pages"] = self._dp.guests
            entry["guest_pool_bytes"] = guests
        if self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            entry["free_bytes"] = int(free)
            entry["limit_bytes"] = int(total)
            entry["reserved_bytes"] = int(torch.cuda.memory_stats(
                self.device).get("reserved_bytes.all.current", 0))
        return entry

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

    @_mirrored
    def prefill(self, tokens: List[int], start_pos: int,
                block_table: np.ndarray, temperature: float,
                slot: int) -> int:
        """Synchronous prefill: :meth:`prefill_async` over the prompt's
        bucket-sized chunks (ragged mode: the ragged step's pieces), then
        one fetch of the last chunk's token."""
        if not len(tokens):
            return self.spec.eos_id
        if self._dp is not None:
            return self._dp_prefill(list(tokens), start_pos, block_table,
                                    temperature)
        if self.ragged_attention:
            h = self._ragged_prefill_start(
                [(tokens, start_pos, block_table, temperature)])[0]
            return int(self.gather_scalars([h])[0])
        return int(self.gather_scalars([self._prefill_chunks(
            tokens, start_pos, block_table, temperature)])[0])

    def _prefill_chunks(self, tokens, start_pos: int, block_table,
                        temperature: float) -> PrefillHandle:
        """A prompt through the one-row programs in chunks of the largest
        bucket; the handle of the last chunk's token."""
        pos, h = start_pos, None
        largest = self.prefill_buckets[-1]
        for o in range(0, len(tokens), largest):
            chunk = list(tokens[o:o + largest])
            h = self._prefill_wave([(chunk, pos, block_table, temperature)],
                                   rows=1)[0]
            pos += len(chunk)
        return h

    @_mirrored
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
            raise MeshArgumentError("prefill_async takes one bucket-sized "
                                    "chunk")
        if self._dp is not None:
            return self._dp_prefill_wave([req], rows=1)[0]
        return self._prefill_wave([req], rows=1)[0]

    @_mirrored
    def prefill_multi_async(self, reqs: List) -> List[PrefillHandle]:
        """Up to ``prefill_batch`` prompts' chunks in ONE program,
        dispatched without a host wait (``JaxExecutor.prefill_multi_async``):
        the weights stream once for the wave. ``reqs``: ``(tokens,
        start_pos, block_table, temperature)`` each, every chunk at most
        the largest bucket. Ragged mode packs the requests into ragged
        steps instead. Returns one handle per request."""
        if not 0 < len(reqs) <= self.prefill_batch:
            raise MeshArgumentError(f"{len(reqs)} requests for a wave of "
                                    f"{self.prefill_batch}")
        reqs = [(list(t), sp, bt, temp) for t, sp, bt, temp in reqs]
        if self.ragged_attention:
            return self._ragged_prefill_start(reqs)
        if any(not 0 < len(r[0]) <= self.prefill_buckets[-1] for r in reqs):
            raise MeshArgumentError("a wave's chunk is empty or exceeds "
                                    "the largest bucket")
        if self._dp is not None:
            return self._dp_prefill_wave(reqs, rows=self.prefill_batch)
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

    @_mirrored
    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               block_tables: np.ndarray,
               temperatures: np.ndarray) -> np.ndarray:
        """One step for every row: the decode step with a budget of 1."""
        if self._dp is not None:
            return self._dp_rows("decode", tokens, positions, block_tables,
                                 temperatures,
                                 np.ones(self.spec.batch_size, np.int32))
        return self._decode_one(tokens, positions, block_tables,
                                temperatures)

    def _decode_one(self, tokens, positions, block_tables,
                    temperatures) -> np.ndarray:
        t0 = time.perf_counter()
        self._fill(tokens, positions, block_tables, temperatures,
                   np.ones(self._rows, np.int32))
        self._run_step(eager=False)
        out = self._out()[:, 0]
        self._time_steps(t0, 1)
        return out

    @_mirrored
    @torch.inference_mode()
    def decode_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: np.ndarray, temperatures: np.ndarray,
                     budgets: np.ndarray) -> np.ndarray:
        """Up to K decode steps with the JAX program's semantics: ``out``
        is EOS-padded (B, K); the EOS latch is persistent, the budget
        pause is this chunk's only; a paused row keeps its last real
        token; the loop ends once every row is latched or out of budget.
        On the card each step is one replay of the captured step."""
        if self._dp is not None:
            return self._dp_rows("decode_chunk", tokens, positions,
                                 block_tables, temperatures, budgets)
        return self._decode_chunk(tokens, positions, block_tables,
                                  temperatures, budgets, eager=False)

    @_mirrored
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
        if self._dp is not None:
            return self._dp_rows("decode_chunk_start", tokens, positions,
                                 block_tables, temperatures, budgets,
                                 carry=carry, overrides=overrides)
        return self._chunk_start(tokens, positions, block_tables,
                                 temperatures, budgets, carry, overrides)

    def _chunk_start(self, tokens, positions, block_tables, temperatures,
                     budgets, carry=None, overrides=None,
                     steps: Optional[int] = None) -> ChunkHandle:
        t0 = time.perf_counter()
        self._fill(tokens, positions, block_tables, temperatures, budgets,
                   carry=carry)
        self._join(overrides or ())
        start = self._event(timing=True)
        if steps is None:
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
                      budgets, *, eager: bool,
                      steps: Optional[int] = None) -> np.ndarray:
        """:meth:`decode_chunk`; ``eager`` runs the step body instead of
        replaying its graph (warmup before capture, and comparisons).
        ``steps``: the loop's bound (default the budgets')."""
        t0 = time.perf_counter()
        self._fill(tokens, positions, block_tables, temperatures, budgets)
        ran = self._decode_steps(
            self._chunk_steps(budgets) if steps is None else steps,
            lambda: self._run_step(eager))
        result = self._out()
        self._time_steps(t0, ran)
        return result

    @_mirrored
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
        if self._dp is not None:
            return self._dp_mixed_start(tokens, positions, block_tables,
                                        temperatures, budgets, pf)
        return self._mixed_chunk_start(tokens, positions, block_tables,
                                       temperatures, budgets, pf,
                                       eager=False)

    @_mirrored
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
        if self._dp is not None:
            return self._dp_mixed_start(tokens, positions, block_tables,
                                        temperatures, budgets, pf).fetch()
        return self._mixed_chunk(tokens, positions, block_tables,
                                 temperatures, budgets, pf, eager=False)

    def _mixed_chunk(self, tokens, positions, block_tables, temperatures,
                     budgets, pf: List, *, eager: bool) -> tuple:
        """:meth:`mixed_chunk`; ``eager`` runs step 0 and the decode
        steps eagerly instead of replaying their graphs."""
        return self._mixed_chunk_start(tokens, positions, block_tables,
                                       temperatures, budgets, pf,
                                       eager=eager).fetch()

    def _check_slices(self, pf: List) -> None:
        """Refuse a mixed chunk's slices that its geometry cannot take
        (before any device work)."""
        if self.mixed_prefill_slices <= 0:
            raise MeshArgumentError("mixed batching disabled for this "
                                    "executor")
        S, T = self.mixed_prefill_slices, self.mixed_slice_tokens
        if not 0 < len(pf) <= S:
            raise MeshArgumentError(f"{len(pf)} slices for a geometry of "
                                    f"{S}")
        lens = [len(t) for _slot, t, _sp, _bt, _temp in pf]
        if self.ragged_attention:
            if sum(lens) > T:
                raise MeshArgumentError(f"ragged pack exceeds the capacity "
                                        f"{T}")
        elif any(not 0 < n <= T for n in lens):
            raise MeshArgumentError(f"a slice is empty or wider than {T}")

    @torch.inference_mode()
    def _mixed_chunk_start(self, tokens, positions, block_tables,
                           temperatures, budgets, pf: List, *,
                           eager: bool, steps: Optional[int] = None
                           ) -> MixedChunkHandle:
        """The mixed chunk; ``steps`` (a dp replica's: the global bound,
        its slices already checked and possibly none) else the budgets'
        bound after the slices' checks."""
        if steps is None:
            self._check_slices(pf)
            steps = self._chunk_steps(budgets)
        reqs = [(list(t), sp, bt, temp) for _slot, t, sp, bt, temp in pf]
        t0 = time.perf_counter()
        name, p = self._step0_program()
        self._fill(tokens, positions, block_tables, temperatures, budgets)
        self._stage_step0(p, reqs)
        start = self._event(timing=True)
        first = self._launch(name, p, self._step0_body, eager)
        steps = max(1, steps)
        for _ in range(1, steps):
            self._run_step(eager)
        return self._handle(MixedChunkHandle, steps, t0, start,
                            first[:len(pf)])

    # -- speculation: the verify window --------------------------------------

    @_mirrored
    @torch.inference_mode()
    def verify_chunk_start(self, tokens, positions, block_tables: np.ndarray,
                           temperatures: np.ndarray, drafts: np.ndarray,
                           qlens: np.ndarray) -> VerifyHandle:
        """Dispatch one verify window (``JaxExecutor.verify_chunk_start``):
        ``tokens`` (B,) are the rows' last committed tokens, ``drafts``
        (B, k ≤ draft_k) the teacher-forced proposals (what lies past a
        row's own drafts is never compared), ``qlens`` (B,) each row's
        window size (its drafts + 1; 0 skips the row). One fetch of the
        handle resolves ``(out, n_commit)`` for every row.

        Device accept runs the window's steps as the blocking decode
        chunk runs its own (on the card each a replay of the verify
        step's graph, step ``j - 1``'s exit flag read once step ``j`` is
        queued), so a window that every row rejects at step 0 costs two
        steps and the call returns once the last step is queued; host
        accept queues the whole window (one replay) without a wait.
        On a dp mesh each replica verifies its rows; the driver's handle
        joins every row's tokens and ``n_commit``."""
        if self._dp is not None:
            return self._dp_rows("verify_chunk_start", tokens, positions,
                                 block_tables, temperatures, qlens,
                                 drafts=drafts)
        return self._verify_start(tokens, positions, block_tables,
                                  temperatures, drafts, qlens, eager=False)

    def verify_chunk(self, tokens, positions, block_tables, temperatures,
                     drafts, qlens) -> tuple:
        """:meth:`verify_chunk_start`, then its fetch: ``(out (B, W),
        n_commit (B,))``."""
        return self.verify_chunk_start(tokens, positions, block_tables,
                                       temperatures, drafts, qlens).fetch()

    @torch.inference_mode()
    def _verify_start(self, tokens, positions, block_tables, temperatures,
                      drafts, qlens, *, eager: bool,
                      steps: Optional[int] = None) -> VerifyHandle:
        """:meth:`verify_chunk_start`; ``eager`` runs the bodies instead
        of replaying their graphs (warmup before capture, and
        comparisons); ``steps`` bounds a device-accept window (default
        its rows' largest)."""
        if not self.verify_draft_k:
            raise RuntimeError("speculation disabled for this executor")
        t0 = time.perf_counter()
        v = self._vbuf
        B, W = v.out.shape
        qlens = np.asarray(qlens, np.int32)
        self._fill(tokens, positions, block_tables, temperatures, qlens)
        d = np.asarray(drafts, np.int32).reshape(B, -1)
        if d.shape[1] > W - 1:
            raise ValueError(f"{d.shape[1]} drafts a row for a window of {W}")
        slot = self._staging.take("verify", {"drafts": ((B, W),
                                                        torch.int32)})
        view = slot.views["drafts"]
        view[...] = -1      # never sampled: the last step always freezes
        view[:, :d.shape[1]] = d
        v.drafts.copy_(slot.bufs["drafts"], non_blocking=self._pin)
        slot.record()
        v.out.fill_(self.spec.eos_id)
        v.ncommit.zero_()
        start = self._event(timing=True)
        if self._spec_device_sampling:
            if steps is None:
                steps = min(W, int(qlens.max()) if len(qlens) else 0)
            ran = self._decode_steps(steps, lambda: self._run_verify(eager))
            dev = torch.cat([v.out.view(-1), v.ncommit])
            extra = {}
        else:
            self._run_verify(eager)
            ran = W
            dev = v.out.view(-1)
            extra = {"drafts": d, "qlens": qlens, "eos": self.spec.eos_id}
        host = torch.empty(dev.shape, dtype=torch.int32,
                           pin_memory=self._pin)
        host.copy_(dev, non_blocking=self._pin)
        done = self._event(timing=True)
        host_ms = (None if done is not None or ran <= 0 else
                   (time.perf_counter() - t0) * 1e3 / ran)
        return VerifyHandle(host, (B, W), ran, start, done, host_ms,
                            self._note_step_ms, **extra)

    def _verify_step(self) -> None:
        """One device-accept verify step: the decode step's forward
        (:meth:`_forward_active`) with the verify carry."""
        active, logits = self._forward_active()
        self._advance_verify(active, logits)

    def _advance_verify(self, active: torch.Tensor,
                        logits: torch.Tensor) -> None:
        """The device-accept carry (``JaxExecutor``'s ``_verify_chunk``
        loop body): sample step ``j`` keyed by (row, position + 1), emit
        it for active rows (EOS otherwise), count it into ``n_commit``,
        feed draft ``j`` as the next input, and freeze a row whose sample
        is EOS or differs from that draft. Then ``j += 1`` and ``left``
        says whether a row has a step ``j``."""
        b, v = self._buf, self._vbuf
        eos = self.spec.eos_id
        nxt = sample_token_keyed(logits, self._spec_seed, v.rows, b.pos + 1,
                                 temperature=b.temps, top_k=self._top_k,
                                 top_p=self._top_p)
        v.out.index_copy_(1, b.j, torch.where(active, nxt, eos)[:, None])
        v.ncommit.add_(active.to(torch.int32))
        nd = v.drafts.index_select(1, b.j)[:, 0]
        b.frozen.logical_or_(active & ((nxt == eos) | (nxt != nd)))
        # A -1 (no draft) freezes its row and is never fed on.
        b.tok.copy_(torch.where(active & (nd >= 0), nd, b.tok))
        b.pos.add_(active.to(torch.int32))
        b.j.add_(1)
        b.left.copy_(((~b.frozen) & (b.j < b.budgets)).any())

    def _verify_window(self) -> None:
        """The host-accept window (``JaxExecutor``'s raw
        ``_verify_chunk``): ``forward_verify`` over the window's inputs
        (the last committed token, then the drafts) with real KV writes
        for every step below a row's ``qlens``, then every position
        sampled at once with the same keys as the device-accept step."""
        b, v = self._buf, self._vbuf
        B, W = v.out.shape
        # Steps past a row's window run masked; a -1 there (no draft)
        # must still be a token id.
        toks = torch.cat([b.tok[:, None], v.drafts[:, :W - 1]],
                         dim=1).clamp_(min=0)
        logits = self.model.forward_verify(toks, b.pos, b.budgets,
                                           self.cache, b.bt,
                                           fused=self.fused_decode)
        steps = torch.arange(1, W + 1, dtype=torch.int32, device=b.pos.device)
        positions = (b.pos[:, None] + steps[None, :]).reshape(-1)
        rows = v.rows[:, None].expand(B, W).reshape(-1)
        temps = b.temps[:, None].expand(B, W).reshape(-1)
        out = sample_token_keyed(logits.reshape(B * W, -1), self._spec_seed,
                                 rows, positions, temperature=temps,
                                 top_k=self._top_k, top_p=self._top_p)
        v.out.copy_(out.view(B, W))

    def _run_verify(self, eager: bool) -> None:
        """One device-accept verify step, or the whole host-accept window:
        on the card a replay of the current route's captured program
        (captured first if it is not yet), on the CPU or with ``eager``
        the body itself."""
        if eager or not self._graphs_on:
            self._verify_body()
            return
        self._replay(self._verify_graph())
        self.verify_replays += 1

    def _verify_graph(self) -> _StepGraph:
        """The current route's captured verify program, captured at first
        use into a pool of its own."""
        kind = "step" if self._spec_device_sampling else "window"
        name = (f"verify_{kind}_"
                f"{'fused' if self.fused_decode else 'split'}")
        g = self.verify_graphs.get(name)
        if g is None:
            g = self.verify_graphs[name] = self._capture(self._verify_body,
                                                         pool=None)
            self._note_capture(name, g)
            log.info("captured %s: %d kernel launches a replay, pool "
                     "%.1f MiB", name, sum(g.launches.values()),
                     g.pool_bytes / 2**20)
        return g

    # -- warmup ---------------------------------------------------------------

    @_mirrored
    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every program once, capture the graphs, calibrate
        ``step_ms`` (``JaxExecutor.warmup``, llmq_tpu/engine/executor.py:
        1620-1811). In order: each program once eagerly, every write
        through all-zero block tables to page 0: bucket mode one prefill
        per bucket with one row and with ``prefill_batch`` rows, ragged
        mode one ragged prefill; one decode chunk; with speculation one
        verify window; with a mixed geometry
        one mixed chunk (on the card these build every kernel library,
        set every kernel attribute, make every split workspace and warm
        cuBLAS, all outside capture). Then (card only) the graphs: each
        prefill program's, largest first, then the decode step's, the
        verify program's (with speculation) and the mixed step 0's of
        each decode route (fused and split; an int8 cache has the fused
        one). Then ``step_ms`` from three pairs of a
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
        graphs_before = self._n_graphs()
        B, MP, K = (self._rows, self.spec.max_pages_per_seq,
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
        if self.verify_draft_k:
            # The verify window once: one step a row, trash drafts,
            # every write on page 0 through the all-zero block tables.
            self._verify_start(zeros, zeros, zbt, ztemp,
                               np.zeros((B, self.verify_draft_k), np.int32),
                               ones, eager=True).fetch()
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
                if self.verify_draft_k:
                    self._verify_graph()
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
                self._decode_chunk(zeros, zeros, zbt, ztemp, ones,
                                   eager=False)
                t1 = time.perf_counter()
                out = self._decode_chunk(zeros, zeros, zbt, ztemp, full,
                                         eager=False)
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
        captured = self._n_graphs() - graphs_before
        if self.device.type == "cuda":
            # The eager runs' transients leave the allocator's cache (the
            # graphs keep their own pools): ranks may share the card.
            torch.cuda.empty_cache()
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
                 self._n_graphs(),
                 sum(g.pool_bytes for g in self.program_graphs.values())
                 / 2**20,
                 f"{self.step_ms:.2f}" if self.step_ms else "not measured")

    def _n_graphs(self) -> int:
        return (len(self.step_graphs) + len(self.program_graphs)
                + len(self.verify_graphs))

    @_mirrored
    def release_graphs(self) -> None:
        """Drop every captured graph and program buffer (their memory
        returns to the allocator's cache); later calls capture again."""
        self.step_graphs.clear()
        self.program_graphs.clear()
        self.verify_graphs.clear()
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
        active, logits = self._forward_active()
        self._advance(active, logits)

    def _forward_active(self):
        """The forward of a decode step (shared by the verify step, whose
        KV and logits are then those of plain decode): the rows still
        active at step ``j`` run at their positions, the others write to
        page 0. Returns ``(active (B,), logits (B, V))``."""
        b = self._buf
        active = (~b.frozen) & (b.j < b.budgets)
        logits = self.model.forward_decode(b.tok, b.pos, self.cache, b.bt,
                                           active, fused=self.fused_decode)
        b.idle.add_((~active.any()).to(torch.int64))
        return active, logits

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
        buffers (and the verify window's) are restored afterwards, and
        the step index is 0 meanwhile. ``pool``: a shared graph memory
        pool, or None for a private one. The private generator is
        registered with the graph, so each replay draws fresh numbers.
        The capture launches nothing: its launch counts are taken back
        out of ``kernels.LAUNCHES`` and kept as what each replay adds. A
        failed capture raises."""
        dev, b = self.device, self._buf
        t0 = time.perf_counter()
        kept = b.tensors() + (self._vbuf.tensors() if self._vbuf else [])
        saved = [t.clone() for t in kept]
        b.frozen.fill_(True)
        b.bt.zero_()
        b.j.zero_()
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
        for t, v in zip(kept, saved):
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

    def _decode_steps(self, steps: int, run) -> int:
        """The blocking chunk's decode steps ``0..steps-1`` (a verify
        window's, with ``run`` its step); returns how many ran. Step
        ``j - 1``'s exit flag is read only after step ``j`` is queued, so
        the device never waits for the host: the one extra step that can
        run has every row inactive (its writes go to page 0 and its
        outputs stay EOS)."""
        ran = 0
        for j in range(steps):
            run()
            self._flag(j)
            ran += 1
            if j > 0:
                left = self._left_after(j - 1)
                if self._dp is not None:
                    left = self._dp.any(left)
                if not left:
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

    # -- dp replicas (parallel/dp.py) ----------------------------------------

    def _dp_local(self, a):
        """This replica's rows of a full-batch host array (None stays)."""
        if a is None:
            return None
        r0 = self._dp.row0
        return np.asarray(a)[r0:r0 + self._rows]

    def _dp_assign(self, reqs: List) -> List[int]:
        """The replica each prefill request ``(tokens, start_pos,
        block_table, temperature)`` runs on: the universe of the page its
        first position is written to (replica 0 for the null page)."""
        ps, dp = self.spec.page_size, self._dp
        out = []
        for _t, sp, bt, _temp in reqs:
            bt = np.asarray(bt).ravel()
            page = int(bt[min(int(sp) // ps, len(bt) - 1)])
            out.append(dp.universe(page) if page else 0)
        return out

    def _dp_writes(self, block_tables, live, reqs: List = ()) -> set:
        """The pages a program can write: a ``live`` row's from the page
        of its position floor on, a prefill request's over its written
        range. Only these of its guests go home after it."""
        ps, out = self.spec.page_size, set()
        if block_tables is not None:
            bt = np.asarray(block_tables)
            for r in np.nonzero(np.asarray(live))[0]:
                first = int(self._dp_floor[r]) // ps
                out.update(int(p) for p in bt[r, first:])
        for t, sp, rbt, _temp in reqs:
            rbt = np.asarray(rbt).ravel()
            out.update(int(p) for p in rbt[int(sp) // ps:
                                           -(-(int(sp) + len(t)) // ps)])
        out.discard(0)
        return out

    def _dp_floor_update(self, positions, live, overrides=None) -> None:
        """The rows' position floors at a row program: the host's
        positions when given (a carried chunk's continuing rows keep
        theirs: positions only grow), a join's own, 0 for a row that is
        not live (its next occupant is unknown)."""
        f = self._dp_floor
        if positions is not None:
            f[:] = np.asarray(positions)
        f[~np.asarray(live)] = 0
        for slot, _h, pos in overrides or ():
            f[slot] = int(pos)

    def _dp_plan(self, block_tables, live, reqs: List = (),
                 assign: List[int] = ()) -> List[Dict[int, int]]:
        """Plan a program's guests (the ``live`` rows' tables on their
        replicas, each request's table on its replica) and pull them."""
        dp = self._dp
        tables: List[List] = [[] for _ in range(dp.dp)]
        if block_tables is not None:
            bt = np.asarray(block_tables)
            for row in np.nonzero(np.asarray(live))[0]:
                tables[dp.replica_of_row(row)].append(bt[row])
        for (_t, _sp, rbt, _temp), a in zip(reqs, assign):
            tables[a].append(rbt)
        plan = dp.plan(tables)
        dp.pull(self.cache, plan)
        return plan

    def _dp_tokens(self, overrides) -> List:
        """The decode joins of this replica's rows, in local rows; a join
        whose prefill ran on another replica has the token moved here
        first (every rank makes the same moves)."""
        dp, out = self._dp, []
        for slot, h, pos in overrides:
            d = dp.replica_of_row(slot)
            if h.replica != d:
                v = dp.move_token(
                    lambda h=h: (h.value if h.value is not None
                                 else h.copy.read(h.row)),
                    src=h.replica, dst=d)
                if v is not None:
                    h.value = v
            if d == dp.d:
                out.append((slot - dp.row0, h, pos))
        return out

    def _dp_rows(self, kind: str, tokens, positions, block_tables,
                 temperatures, budgets, carry=None, overrides=None,
                 drafts=None):
        """A row program on a dp mesh (``kind``: the entry point):
        guests in, this replica's rows through the one-device body at
        the global step bound, guests home, results to the driver."""
        dp = self._dp
        B = self.spec.batch_size
        budgets = np.asarray(budgets, np.int32)
        d = None
        if kind == "verify_chunk_start":
            W = self.verify_draft_k + 1
            d = np.asarray(drafts, np.int32).reshape(B, -1)
            if d.shape[1] > W - 1:
                raise MeshArgumentError(f"{d.shape[1]} drafts a row for a "
                                        f"window of {W}")
        bt = np.asarray(block_tables)
        self._dp_floor_update(positions, budgets > 0, overrides)
        plan = self._dp_plan(bt, budgets > 0)
        ovr = self._dp_tokens(overrides) if overrides else None
        loc = self._dp_local
        args = (loc(tokens), loc(positions),
                dp.translate(loc(bt), plan[dp.d]), loc(temperatures),
                loc(budgets))
        steps = self._chunk_steps(budgets)
        if kind == "decode":
            out = self._decode_one(*args[:4])
        elif kind == "decode_chunk":
            out = self._decode_chunk(*args, eager=False, steps=steps)
        elif kind == "decode_chunk_start":
            out = self._chunk_start(*args, carry=carry, overrides=ovr,
                                    steps=steps)
        else:
            vsteps = (min(W, int(budgets.max()) if B else 0)
                      if self._spec_device_sampling else None)
            out = self._verify_start(*args[:4], loc(d), args[4],
                                     eager=False, steps=vsteps)
        dp.push(self.cache, plan, self._dp_writes(bt, budgets > 0))
        extra = None
        if kind == "verify_chunk_start":
            if self._spec_device_sampling:
                R = self._rows
                extra = [list(range(e * R, (e + 1) * R))
                         for e in range(dp.dp)]
            elif self.mesh.is_driver:
                # Host accept: the driver's handle computes n_commit over
                # every row.
                out._drafts, out._qlens = d, budgets
        return self._dp_finish(out, extra)

    def _dp_mixed_start(self, tokens, positions, block_tables, temperatures,
                        budgets, pf: List) -> MixedChunkHandle:
        """A mixed chunk on a dp mesh: each replica runs its decode rows
        and the slices assigned to it (:meth:`_dp_assign`, possibly
        none); the driver's handle returns the slices' first tokens in
        ``pf``'s order."""
        self._check_slices(pf)
        dp = self._dp
        reqs = [(t, sp, pbt, temp) for _s, t, sp, pbt, temp in pf]
        assign = self._dp_assign(reqs)
        budgets = np.asarray(budgets, np.int32)
        bt = np.asarray(block_tables)
        self._dp_floor_update(positions, budgets > 0)
        plan = self._dp_plan(bt, budgets > 0, reqs, assign)
        mine = [(slot, t, sp, dp.translate(pbt, plan[dp.d]), temp)
                for (slot, t, sp, pbt, temp), a in zip(pf, assign)
                if a == dp.d]
        loc = self._dp_local
        h = self._mixed_chunk_start(
            loc(tokens), loc(positions), dp.translate(loc(bt), plan[dp.d]),
            loc(temperatures), loc(budgets), mine, eager=False,
            steps=self._chunk_steps(budgets))
        dp.push(self.cache, plan, self._dp_writes(bt, budgets > 0, reqs))
        return self._dp_finish(h, [[i for i, a in enumerate(assign) if a == e]
                                   for e in range(dp.dp)])

    def _dp_prefill_wave(self, reqs: List, rows: int) -> List[PrefillHandle]:
        """A prefill wave (or one chunk) on a dp mesh: each replica runs
        its requests in its ``rows``-row program; one handle per request
        on every rank, the other replicas' as placeholders (on the driver
        they read the replica's results)."""
        dp = self._dp
        assign = self._dp_assign(reqs)
        plan = self._dp_plan(None, (), reqs, assign)
        mine = [(t, sp, dp.translate(bt, plan[dp.d]), temp)
                for (t, sp, bt, temp), a in zip(reqs, assign) if a == dp.d]
        local = self._prefill_wave(mine, rows=rows) if mine else []
        for h in local:
            h.replica = dp.d
        dp.push(self.cache, plan, self._dp_writes(None, (), reqs))
        seq = dp.next_seq()
        if dp.publisher and local:
            dp.publish(seq, lambda: np.array([h.copy.read(h.row)
                                              for h in local], np.int64))
        take = None
        if self.mesh.is_driver:
            take = self._dp_taker(seq, sorted(set(assign) - {0}))
        out, mine_it, count = [], iter(local), [0] * dp.dp
        for a in assign:
            if a == dp.d:
                out.append(next(mine_it))
                continue
            out.append(PrefillHandle(-1, count[a], _DpCopy(take, a)
                                     if take is not None else None,
                                     replica=a))
            count[a] += 1
        return out

    def _dp_prefill(self, tokens, start_pos: int, block_table,
                    temperature: float) -> int:
        """The blocking prefill on a dp mesh: the request's replica runs
        it; the driver returns its token."""
        dp = self._dp
        req = (tokens, start_pos, block_table, temperature)
        (e,) = self._dp_assign([req])
        plan = self._dp_plan(None, (), [req], [e])
        value = -1
        if e == dp.d:
            value = int(self.gather_scalars([self._prefill_chunks(
                tokens, start_pos, dp.translate(block_table, plan[dp.d]),
                temperature)])[0])
        dp.push(self.cache, plan, self._dp_writes(None, (), [req]))
        seq = dp.next_seq()
        if dp.publisher and e == dp.d:
            dp.publish(seq, np.array([value], np.int64))
        if self.mesh.is_driver and e != dp.d:
            return int(dp.take(seq, [e])[e][0])
        return value

    def _dp_taker(self, seq: int, replicas: List[int]):
        """A function that takes call ``seq``'s results from ``replicas``
        once (dropped with the call's handles, it discards them)."""
        box: Dict[str, Dict] = {}
        dp = self._dp

        def take() -> Dict:
            if "v" not in box:
                box["v"] = dp.take(seq, replicas)
            return box["v"]
        if replicas:
            dp.expect(seq, replicas, take)
        return take

    def _dp_finish(self, out, extra: Optional[List[List[int]]] = None):
        """Close a row program on a dp mesh: a publisher sends its rows'
        results (a handle's once its copy ran, or a blocking call's
        array); the driver's result joins them with its own
        (:meth:`_dp_merge`): a handle at its fetch, an array now.
        ``extra``: per replica, the global indices of the values that
        follow its rows' tokens (the slices' first tokens, or
        ``n_commit``)."""
        dp = self._dp
        seq = dp.next_seq()
        B = self.spec.batch_size
        driver = self.mesh.is_driver
        if isinstance(out, ChunkHandle):
            if dp.publisher:
                def rows(out=out):
                    out.wait_ready()
                    return out._host.numpy().copy()
                dp.publish(seq, rows)
            if driver:
                X = out._shape[1]
                out._shape = (B, X)
                out._merge = (functools.partial(dp.ready, seq),
                              functools.partial(self._dp_merge, seq, X,
                                                extra))
                dp.expect(seq, range(1, dp.dp), out)
            return out
        local = np.asarray(out)
        if dp.publisher:
            dp.publish(seq, local.copy())
        if not driver:
            return local
        X = int(np.prod(local.shape[1:])) if local.ndim > 1 else 1
        return self._dp_merge(seq, X, None, local.reshape(-1)).reshape(
            (B,) + local.shape[1:]).astype(local.dtype)

    def _dp_merge(self, seq: int, X: int, extra, local) -> np.ndarray:
        """Every replica's flat results of call ``seq`` as one device's:
        the rows' ``X`` values each in row order, then the ``extra``
        values at their global indices."""
        dp, R = self._dp, self._rows
        parts = {e: np.asarray(v).reshape(-1) for e, v in
                 {0: local, **dp.take(seq)}.items()}
        outs = [parts[e][:R * X] for e in range(dp.dp)]
        if not extra:
            return np.concatenate(outs)
        vals = np.zeros(sum(len(i) for i in extra), outs[0].dtype)
        for e in range(dp.dp):
            vals[extra[e]] = parts[e][R * X:]
        return np.concatenate(outs + [vals])

    # -- tiered KV page transport (tiering/) ---------------------------------

    def _kv_leaves(self) -> List[str]:
        """The cache leaves in the JAX package's ``jax.tree.leaves`` order
        (sorted keys: k, k_scale, v, v_scale), which the tiering payload
        and its store blob follow."""
        return sorted(self.cache)

    def kv_page_spec(self) -> List[tuple]:
        """Per-leaf payload ``(shape, dtype name)`` of ONE page, the page
        axis (1) removed, leaves in :meth:`_kv_leaves` order: the tiering
        plane's codec keys off it (the scale pools of an int8 cache ride
        as ordinary leaves). On a mesh too it is JAX's full page, every
        KV head, so the host tier, the store blob and the exchange keep
        one format."""
        return [(shape, str(dt).replace("torch.", ""))
                for _name, dt, shape, _axis in self._page_leaves()]

    def _page_leaves(self):
        """``(name, dtype, one page's full shape, its head axis)`` per
        leaf in :meth:`_kv_leaves` order: ``(L, page_size, H_kv·D)`` with
        the heads on axis 2, scales ``(L, H_kv, page_size)`` on axis 1."""
        out = []
        for name in self._kv_leaves():
            t = self.cache[name]
            shape = [int(t.shape[0])] + [int(d) for d in t.shape[2:]]
            axis = 1 if name.endswith("_scale") else 2
            shape[axis] *= self._kv_shards
            out.append((name, t.dtype, tuple(shape), axis))
        return out

    def _full_page_bytes(self) -> int:
        return sum(int(np.prod(shape)) * torch.empty((), dtype=dt
                                                     ).element_size()
                   for _n, dt, shape, _a in self._page_leaves())

    def _page_views(self, packed: torch.Tensor, shard: Optional[int] = None):
        """Per leaf, the ``(N, L, ...)`` view of a page-major uint8
        buffer of full pages, or with ``shard`` the view of head shard
        ``shard`` inside it."""
        n, offs, out = packed.shape[0], 0, []
        for _name, dt, shape, axis in self._page_leaves():
            per = int(np.prod(shape)) * torch.empty((), dtype=dt
                                                    ).element_size()
            v = packed[:, offs:offs + per].view(dt).view((n,) + shape)
            if shard is not None:
                w = shape[axis] // self._kv_shards
                v = v.narrow(axis + 1, shard * w, w)
            out.append(v)
            offs += per
        return out

    def _home_slot(self, page: int) -> int:
        return self._dp.home_slot(page) if self._dp is not None else page

    def _homes(self, pages: List[int]) -> Dict[int, List[int]]:
        """Replica → the indices of ``pages`` in its universe (without dp
        universes every page is replica 0's, and every replica's)."""
        out: Dict[int, List[int]] = {}
        for i, p in enumerate(pages):
            e = self._dp.universe(p) if self._dp is not None else 0
            out.setdefault(e, []).append(i)
        return out

    def _page_index(self, pages: List[int]) -> torch.Tensor:
        """``pages`` as an int64 index on the device, copied from pinned
        memory without a host wait on the card."""
        idx = torch.tensor(list(pages), dtype=torch.int64)
        if self.device.type == "cuda":
            return idx.pin_memory().to(self.device, non_blocking=True)
        return idx

    def export_kv_pages(self, pages: List[int]) -> "ExportedPages":
        """Gather ``pages``' payloads out of the pool, without a host
        wait: queued on the current stream (the one the programs replay
        on), so FIFO order keeps the gather ahead of any later program
        that rewrites the pages the caller frees next. The result holds
        the page-major buffer (``packed``, what the tiering worker copies
        to host memory after ``event``) and, as a list, each leaf's
        ``(L, N, ...)`` view of it (the JAX package's per-leaf gathers).
        On a mesh of several ranks see :meth:`_mesh_export`. Engine
        thread only."""
        if self.mesh is not None and self.mesh.size > 1:
            return self._mesh_export(list(pages))
        n = len(pages)
        nbytes = page_bytes(self.cache)
        start = self._event(timing=True)
        idx = self._page_index(pages)
        packed = torch.empty((n, nbytes), dtype=torch.uint8,
                             device=self.device)
        leaves = []
        with torch.inference_mode():
            for _name, pool, view in leaf_views(self.cache, packed):
                view.copy_(pool.index_select(1, idx).transpose(0, 1))
                leaves.append(view.transpose(0, 1))
        event = self._event(timing=True)
        if self._pin:
            self.kv_last_transfer["gather"] = (start, event, n * nbytes)
        return ExportedPages(leaves, packed, event)

    def import_kv_pages(self, pages: List[int], leaves) -> Optional[object]:
        """Scatter payloads back into the pool at fresh ``pages``
        (promotion), in place (``index_copy_`` along the page axis): every
        captured graph keeps reading the same pool tensors. ``leaves`` is
        the tiering plane's :class:`~llmq_tpu_torch.tiering.PagePayload`
        (per-page host buffers, pinned on the card) or per-leaf
        ``(L, N, ...)`` arrays or tensors in :meth:`_kv_leaves` order.
        On the card a payload's pages are copied to the device on a
        stream of their own and the current stream waits for them before
        the scatter, so a later program reads the injected pages. Returns
        the event behind those copies (the fence before the host buffers
        may be reused), or None when nothing reads host memory
        asynchronously. On a mesh of several ranks see
        :meth:`_mesh_import`. Engine thread only."""
        if self.mesh is not None and self.mesh.size > 1:
            self._import_stage = self._full_pages(leaves)
            try:
                self._mesh_import(list(pages))
            finally:
                self._import_stage = None
            return None
        idx = self._page_index(pages)
        done = None
        with torch.inference_mode():
            if hasattr(leaves, "tensors"):
                host = leaves.tensors()
                nbytes = host[0].numel() if host else 0
                if self._pin:
                    if self._h2d_stream is None:
                        self._h2d_stream = torch.cuda.Stream(self.device)
                    s = self._h2d_stream
                    with torch.cuda.stream(s):
                        h0 = self._event(timing=True)
                        stage = torch.empty((len(host), nbytes),
                                            dtype=torch.uint8,
                                            device=self.device)
                        for j, t in enumerate(host):
                            stage[j].copy_(t, non_blocking=True)
                        done = self._event(timing=True)
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(done)
                    stage.record_stream(cur)
                    self.kv_last_transfer["h2d"] = (h0, done,
                                                    len(host) * nbytes)
                else:
                    stage = (torch.stack(host) if host else
                             torch.empty((0, 0), dtype=torch.uint8))
                i0 = self._event(timing=True)
                for _name, pool, view in leaf_views(self.cache, stage):
                    pool.index_copy_(1, idx, view.transpose(0, 1))
            else:
                i0 = self._event(timing=True)
                for name, leaf in zip(self._kv_leaves(), leaves):
                    pool = self.cache[name]
                    pool.index_copy_(1, idx, _as_pool_tensor(
                        leaf, pool.dtype, self.device))
            if self._pin:
                self.kv_last_transfer["inject"] = (
                    i0, self._event(timing=True), 0)
        return done


    @_mirrored
    def _mesh_export(self, pages: List[int]) -> Optional["ExportedPages"]:
        """:meth:`export_kv_pages` on a mesh (mirrored): the ranks of each
        page's home replica gather their head shards and send them to the
        driver over the control group; the driver assembles JAX's full
        pages in host memory (``packed`` on the CPU, no event). A
        follower returns None."""
        import torch.distributed as dist

        from llmq_tpu_torch.parallel.dp import gather

        mesh = self.mesh
        me, driver = mesh.ranks[mesh.rank], mesh.ranks[0]
        full = self._full_page_bytes()
        packed = (torch.zeros((len(pages), full), dtype=torch.uint8)
                  if me == driver else None)
        for e, idx in sorted(self._homes(pages).items()):
            slots = [self._home_slot(pages[i]) for i in idx]
            for t in range(self._kv_shards):
                src = mesh.rank_of(dp=e, tp=t)
                if src == me:
                    buf = gather(self.cache, slots)
                    if me != driver:
                        dist.send(buf, dst=driver, group=mesh.control)
                        continue
                elif me == driver:
                    buf = torch.empty((len(idx), full // self._kv_shards),
                                      dtype=torch.uint8)
                    dist.recv(buf, src=src, group=mesh.control)
                else:
                    continue
                rows = torch.tensor(idx, dtype=torch.int64)
                for g, (_n, _p, v) in zip(self._page_views(packed, t),
                                          leaf_views(self.cache, buf)):
                    g.index_copy_(0, rows, v)
        if packed is None:
            return None
        leaves = [v.transpose(0, 1) for v in self._page_views(packed)]
        return ExportedPages(leaves, packed, None)

    def _full_pages(self, leaves) -> torch.Tensor:
        """An import payload (the tiering plane's per-page host buffers,
        or per-leaf ``(L, N, ...)`` arrays) as JAX's full pages, one
        page-major uint8 host buffer."""
        if hasattr(leaves, "tensors"):
            host = leaves.tensors()
            return (torch.stack([t.cpu() for t in host]) if host else
                    torch.empty((0, 0), dtype=torch.uint8))
        arrays = list(leaves)
        n = int(np.asarray(arrays[0]).shape[1]) if arrays else 0
        packed = torch.empty((n, self._full_page_bytes()), dtype=torch.uint8)
        for v, leaf, (_n, dt, _s, _a) in zip(self._page_views(packed),
                                             arrays, self._page_leaves()):
            v.copy_(_as_pool_tensor(leaf, dt, torch.device("cpu")
                                    ).transpose(0, 1))
        return packed

    @_mirrored
    def _mesh_import(self, pages: List[int]) -> None:
        """:meth:`import_kv_pages` on a mesh (mirrored): the driver sends
        every rank of each page's home replica its head shard of the
        payload (:attr:`_import_stage`, set by the driver's caller) over
        the control group, and each scatters it into its pool; without
        dp universes every replica holds the page."""
        import torch.distributed as dist

        from llmq_tpu_torch.parallel.dp import scatter

        mesh = self.mesh
        me, driver = mesh.ranks[mesh.rank], mesh.ranks[0]
        local = page_bytes(self.cache)
        homes = self._homes(pages)
        if self._dp is None:
            homes = {e: homes.get(0, []) for e in range(mesh.dp)}
        for e, idx in sorted(homes.items()):
            slots = [self._home_slot(pages[i]) for i in idx]
            rows = torch.tensor(idx, dtype=torch.int64)
            for t in range(mesh.tp):
                dst = mesh.rank_of(dp=e, tp=t)
                buf = torch.empty((len(idx), local), dtype=torch.uint8)
                if me == driver:
                    shard = t if self._kv_shards > 1 else 0
                    for (_n, _p, v), g in zip(
                            leaf_views(self.cache, buf),
                            self._page_views(self._import_stage, shard)):
                        v.copy_(g.index_select(0, rows))
                    if dst != me:
                        dist.send(buf, dst=dst, group=mesh.control)
                        continue
                elif dst == me:
                    dist.recv(buf, src=driver, group=mesh.control)
                else:
                    continue
                scatter(self.cache, slots, buf)


class ExportedPages(list):
    """``export_kv_pages``' result: as a list, each cache leaf's gather
    ``(L, N, ...)`` (views of ``packed``); ``packed``, the ``(N, page
    bytes)`` uint8 page-major buffer; ``event``, recorded behind the
    gather on the stream that made it (None on the CPU)."""

    def __init__(self, leaves, packed: torch.Tensor, event) -> None:
        super().__init__(leaves)
        self.packed = packed
        self.event = event


#: Signed integer dtype of each itemsize: how a host array's bytes enter
#: torch before they are viewed as the pool's dtype (bfloat16 arrays from
#: numpy or ml_dtypes included).
_INT_BY_SIZE = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def _as_pool_tensor(leaf, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A per-leaf payload (a tensor, or a numpy array of the pool's
    element size: bfloat16 as 2-byte words) as a tensor of the pool's
    dtype on ``device``, byte for byte."""
    if isinstance(leaf, torch.Tensor):
        t = leaf if leaf.dtype == dtype else leaf.view(dtype)
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
        if not a.flags.writeable:
            a = a.copy()
        t = torch.from_numpy(a.view(_INT_BY_SIZE[a.dtype.itemsize])
                             ).view(dtype)
    return t.to(device)


# -- echo ----------------------------------------------------------------------


class _EchoOutProbe:
    """Stands in for a chunk's device output on the echo async path, so
    that the fetch lane's timed fetch can time the simulated device's
    run: ``block_until_ready`` waits until the device-queue thread ran
    the program."""

    __slots__ = ("_ev",)

    def __init__(self, ev: threading.Event) -> None:
        self._ev = ev

    def block_until_ready(self) -> None:
        self._ev.wait()


class EchoChunkHandle:
    """An echo chunk in flight (``async_chunks``): its results appear when
    the executor's device-queue thread runs the program. ``_tok``,
    ``_pos`` and ``_done`` are the end state a carried dispatch reads; the
    device queue is FIFO, so by the time the next program runs this one
    has set them."""

    __slots__ = ("out", "_ev", "_out", "_tok", "_pos", "_done",
                 "pf_first", "_err", "_mixed", "_ncommit", "_verify")

    def __init__(self, mixed: bool = False, verify: bool = False) -> None:
        self._ev = threading.Event()
        self.out = _EchoOutProbe(self._ev)
        self._out = None
        self._tok = None
        self._pos = None
        self._done = None
        self.pf_first = None
        self._err: Optional[BaseException] = None
        self._mixed = mixed
        #: A verify window: fetch() returns (out, n_commit).
        self._verify = verify
        self._ncommit = None

    def _set(self, out, tok, pos, done, pf_first=None, ncommit=None) -> None:
        self._out, self._tok, self._pos, self._done = out, tok, pos, done
        self.pf_first = pf_first
        self._ncommit = ncommit
        self._ev.set()

    def _fail(self, err: BaseException) -> None:
        self._err = err
        self._ev.set()

    def wait_ready(self) -> None:
        """The device leg of the timed fetch: the program has run."""
        self.out.block_until_ready()

    def fetch(self):
        self._ev.wait()
        if self._err is not None:
            raise self._err
        if self._verify:
            return self._out, self._ncommit
        if self._mixed:
            return self._out, self.pf_first
        return self._out


class EchoExecutor:
    """Echoes the prompt: token i of the response is prompt token i, then
    EOS. No model, no device and no tensor (host numpy only), but the
    engine drives its whole slot and page machinery against it: the
    queue plane, chaos and store-resilience scenarios run on it, and
    ``executor.backend: echo`` serves it (only when named: see
    ``core/config.py``). The port's copy of JAX's ``EchoExecutor``.

    Synchronous (the default): ``prefill``, ``decode``, ``decode_chunk``,
    ``mixed_chunk`` and ``verify_chunk`` run inline, and the futures API
    is hidden (None), so the engine takes its blocking branches. With
    ``async_chunks`` the ``*_chunk_start`` entry points return
    :class:`EchoChunkHandle` s run by one FIFO device-queue thread, as
    ``TorchExecutor``'s dispatches run on the card's stream."""

    #: The tiered KV plane may demote and promote this backend's
    #: conversations as metadata-only entries: its "KV" is fully given by
    #: the token stream the engine registers at prefill.
    kv_content_free = True

    def __init__(self, batch_size: int = 8, page_size: int = 16,
                 num_pages: int = 512, max_pages_per_seq: int = 32,
                 eos_id: int = 2, chunk_size: int = 1,
                 mixed_prefill_slices: int = 2,
                 mixed_slice_tokens: int = 64,
                 async_chunks: bool = False) -> None:
        self.spec = ExecutorSpec(batch_size, page_size, num_pages,
                                 max_pages_per_seq, eos_id)
        self.chunk_size = chunk_size
        #: Mixed-batch geometry: caps for the engine's packing (there is
        #: no program behind them).
        self.mixed_prefill_slices = max(0, mixed_prefill_slices)
        self.mixed_slice_tokens = max(0, mixed_slice_tokens)
        self._slot_prompt: Dict[int, List[int]] = {}
        self._slot_end: Dict[int, int] = {}   # absolute pos after prompt
        self._mu = threading.Lock()
        self._async_chunks = bool(async_chunks)
        self._devq: Optional[queue.Queue] = None
        self._dev_thread: Optional[threading.Thread] = None
        #: The deterministic verify seam: ``fn(slot, n_drafts) -> int``
        #: caps the drafts a window may accept for that slot. The echoed
        #: correction is the true next token, so a cap changes acceptance
        #: counts (windows, pages, rollbacks) and never the stream.
        self.verify_accept_cap: Optional[Callable[[int, int], int]] = None
        #: The drafter's width cap (None: the echo has no compiled width).
        self.verify_draft_k: Optional[int] = None
        if not self._async_chunks:
            # The engine finds the futures API with getattr: None keeps
            # it on the blocking path.
            self.decode_chunk_start = None    # type: ignore[assignment]
            self.mixed_chunk_start = None     # type: ignore[assignment]
            self.verify_chunk_start = None    # type: ignore[assignment]

    def _register_prefill(self, slot: int, tokens: List[int],
                          start_pos: int) -> List[int]:
        """Register a prefill chunk for ``slot`` and return the slot's
        accumulated prompt: a chunk contiguous with what the slot holds
        extends it (mixed slices, a prefill finished across paths);
        anything else replaces it (an admission, a resume)."""
        cur_end = self._slot_end.get(slot)
        if cur_end is not None and cur_end == start_pos:
            self._slot_prompt[slot].extend(tokens)
        else:
            self._slot_prompt[slot] = list(tokens)
        self._slot_end[slot] = start_pos + len(tokens)
        return self._slot_prompt[slot]

    def prefill(self, tokens: List[int], start_pos: int,
                block_table: np.ndarray, temperature: float,
                slot: int) -> int:
        with self._mu:
            stream = self._register_prefill(slot, list(tokens), start_pos)
        return stream[0] if stream else self.spec.eos_id

    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               block_tables: np.ndarray,
               temperatures: np.ndarray) -> np.ndarray:
        out = np.full(self.spec.batch_size, self.spec.eos_id, np.int32)
        with self._mu:
            for slot, prompt in self._slot_prompt.items():
                # positions[slot] is the absolute position of the last
                # emitted token; k is its index in the echo stream.
                k = int(positions[slot]) - self._slot_end[slot]
                nxt = k + 1
                if 0 <= nxt < len(prompt):
                    out[slot] = prompt[nxt]
        return out

    def decode_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: np.ndarray, temperatures: np.ndarray,
                     budgets: np.ndarray) -> np.ndarray:
        K = self.chunk_size
        B = self.spec.batch_size
        out = np.full((B, K), self.spec.eos_id, np.int32)
        tok = np.asarray(tokens, np.int32).copy()
        pos = np.asarray(positions, np.int32).copy()
        done = np.asarray(budgets, np.int32) <= 0
        for j in range(K):
            active = ~done
            nxt = self.decode(tok, pos, block_tables, temperatures)
            nxt = np.where(active, nxt, self.spec.eos_id).astype(np.int32)
            out[:, j] = nxt
            pos = pos + active.astype(np.int32)
            done = done | (nxt == self.spec.eos_id) | (j + 1 >= budgets)
            tok = nxt
        return out

    def mixed_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                    block_tables: np.ndarray, temperatures: np.ndarray,
                    budgets: np.ndarray, pf) -> tuple:
        """The mixed chunk: ``pf`` holds one ``(slot, tokens, start_pos,
        block_table, temperature)`` per prefill slice; the slices register
        before the decode steps, as the fused step writes their KV first.
        Returns ``(out (B, K), pf_first (S,))``, ``pf_first[i]`` the next
        token as of slice i's end (meaningful for a prompt's final
        slice)."""
        pf_first = np.full(len(pf), self.spec.eos_id, np.int32)
        with self._mu:
            for i, (slot, toks, start_pos, _bt, _temp) in enumerate(pf):
                stream = self._register_prefill(slot, list(toks),
                                                start_pos)
                if stream:
                    pf_first[i] = stream[0]
        out = self.decode_chunk(tokens, positions, block_tables,
                                temperatures, budgets)
        return out, pf_first

    # -- the speculation verify window ---------------------------------------

    def _verify_rows(self, positions: np.ndarray, drafts: np.ndarray,
                     qlens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One verify window per row against the echo stream, with the
        verify program's semantics: step j emits the true token at
        ``positions[slot] + j + 1``; the row stops at the first draft
        mismatch (that emission is the correction), at EOS, or at the
        window's end; ``n_commit`` counts the steps run.
        ``verify_accept_cap`` injects rejections without changing the
        stream."""
        B = self.spec.batch_size
        n_drafts = int(drafts.shape[1]) if drafts.ndim == 2 else 0
        eos = self.spec.eos_id
        out = np.full((B, n_drafts + 1), eos, np.int32)
        ncommit = np.zeros(B, np.int32)
        with self._mu:
            for slot in range(B):
                w = int(qlens[slot])
                if w <= 0:
                    continue
                prompt = self._slot_prompt.get(slot)
                end = self._slot_end.get(slot, 0)
                cap = w - 1
                if self.verify_accept_cap is not None:
                    cap = max(0, min(cap, int(self.verify_accept_cap(
                        slot, w - 1))))
                n = 0
                for j in range(w):
                    k = int(positions[slot]) + j - end
                    nxt = eos
                    if prompt is not None and 0 <= k + 1 < len(prompt):
                        nxt = int(prompt[k + 1])
                    out[slot, j] = nxt
                    n += 1
                    if nxt == eos or j >= w - 1:
                        break
                    if j >= cap or int(drafts[slot, j]) != nxt:
                        break
                ncommit[slot] = n
        return out, ncommit

    def verify_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: np.ndarray, temperatures: np.ndarray,
                     drafts: np.ndarray, qlens: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """A blocking verify window. Returns ``(out (B, n_drafts + 1),
        n_commit (B,))``."""
        return self._verify_rows(np.asarray(positions, np.int32),
                                 np.asarray(drafts, np.int32),
                                 np.asarray(qlens, np.int32))

    # -- the futures API (async_chunks) ----------------------------------------

    def _device_submit(self, fn, mixed: bool = False,
                       verify: bool = False) -> EchoChunkHandle:
        """Queue one simulated program on the FIFO device-queue thread
        (in order, as a stream: a carried dispatch reads the previous
        handle's end state, set by then)."""
        if self._devq is None:
            self._devq = queue.Queue()
            self._dev_thread = threading.Thread(
                target=self._device_loop, args=(self._devq,),
                name="echo-device", daemon=True)
            self._dev_thread.start()
        h = EchoChunkHandle(mixed=mixed, verify=verify)
        self._devq.put((fn, h))
        return h

    @staticmethod
    def _device_loop(q: queue.Queue) -> None:
        # The queue comes in as an argument: close() drops the attribute
        # before it posts the sentinel, and the loop drains its own queue.
        while True:
            item = q.get()
            if item is None:
                return
            fn, h = item
            try:
                fn(h)
            except BaseException as e:  # noqa: BLE001 — raised at fetch
                h._fail(e)

    def close(self) -> None:
        """Stop the device-queue thread (made again at the next
        dispatch)."""
        q, self._devq = self._devq, None
        t, self._dev_thread = self._dev_thread, None
        if q is not None:
            q.put(None)
        if t is not None:
            t.join(timeout=5.0)

    def _run_chunk_async(self, tok, pos, frozen, budgets):
        """A chunk with the decode program's carry semantics: ``frozen``
        (the EOS latch) persists into the carry; a spent budget only
        pauses the row for this chunk."""
        K, B = self.chunk_size, self.spec.batch_size
        eos = self.spec.eos_id
        out = np.full((B, K), eos, np.int32)
        tok = np.asarray(tok, np.int32).copy()
        pos = np.asarray(pos, np.int32).copy()
        frozen = np.asarray(frozen, bool).copy()
        budgets = np.asarray(budgets, np.int32)
        for j in range(K):
            active = (~frozen) & (j < budgets)
            if not active.any():
                break           # the loop's early exit
            nxt = self.decode(tok, pos, None, None)
            out[:, j] = np.where(active, nxt, eos).astype(np.int32)
            tok = np.where(active, nxt, tok).astype(np.int32)
            pos = pos + active.astype(np.int32)
            frozen = frozen | (active & (nxt == eos))
        return out, tok, pos, frozen

    def decode_chunk_start(self, tokens, positions, block_tables,
                           temperatures, budgets,
                           carry: Optional[EchoChunkHandle] = None,
                           overrides: Optional[List] = None
                           ) -> EchoChunkHandle:
        """Dispatch a decode chunk (``TorchExecutor.decode_chunk_start``):
        with ``carry``, the rows' tokens, positions and latches come from
        the previous chunk's end state; ``overrides`` ``(slot, first
        token, pos)`` seed a joining lane. The inputs are copied at
        dispatch (the engine may rewrite its arrays before the program
        runs)."""
        B = self.spec.batch_size
        toks = (None if tokens is None
                else np.asarray(tokens, np.int32).copy())
        poss = (None if positions is None
                else np.asarray(positions, np.int32).copy())
        buds = np.asarray(budgets, np.int32).copy()
        ovr = [(int(s), sc, int(p)) for s, sc, p in (overrides or ())]

        def run(h: EchoChunkHandle) -> None:
            if carry is not None:
                tok, pos, done = carry._tok, carry._pos, carry._done
            else:
                tok, pos = toks, poss
                done = np.zeros(B, bool)
            tok = np.asarray(tok, np.int32).copy()
            pos = np.asarray(pos, np.int32).copy()
            done = np.asarray(done, bool).copy()
            for slot, sc, p in ovr:
                tok[slot] = int(np.asarray(sc))
                pos[slot] = p
                done[slot] = False
            h._set(*self._run_chunk_async(tok, pos, done, buds))

        return self._device_submit(run)

    def mixed_chunk_start(self, tokens, positions, block_tables,
                          temperatures, budgets,
                          pf: List) -> EchoChunkHandle:
        """Dispatch a mixed chunk: its slices register on the device-queue
        thread, ahead of any later carried chunk."""
        toks = np.asarray(tokens, np.int32).copy()
        poss = np.asarray(positions, np.int32).copy()
        buds = np.asarray(budgets, np.int32).copy()
        pf_snap = [(int(slot), list(t), int(sp))
                   for slot, t, sp, _bt, _temp in pf]

        def run(h: EchoChunkHandle) -> None:
            pf_first = np.full(len(pf_snap), self.spec.eos_id, np.int32)
            with self._mu:
                for i, (slot, t, sp) in enumerate(pf_snap):
                    stream = self._register_prefill(slot, t, sp)
                    if stream:
                        pf_first[i] = stream[0]
            done = np.zeros(self.spec.batch_size, bool)
            out, tok, pos, done = self._run_chunk_async(
                toks, poss, done, buds)
            h._set(out, tok, pos, done, pf_first=pf_first)

        return self._device_submit(run, mixed=True)

    def verify_chunk_start(self, tokens, positions, block_tables,
                           temperatures, drafts, qlens
                           ) -> EchoChunkHandle:
        """Dispatch a verify window; the handle's fetch returns ``(out,
        n_commit)``."""
        poss = np.asarray(positions, np.int32).copy()
        drfs = np.asarray(drafts, np.int32).copy()
        qls = np.asarray(qlens, np.int32).copy()

        def run(h: EchoChunkHandle) -> None:
            out, ncommit = self._verify_rows(poss, drfs, qls)
            h._set(out, None, None, None, ncommit=ncommit)

        return self._device_submit(run, verify=True)

    def release_slot(self, slot: int) -> None:
        with self._mu:
            self._slot_prompt.pop(slot, None)
            self._slot_end.pop(slot, None)

    def resume(self, slot: int, tokens: List[int], start_pos: int) -> None:
        with self._mu:
            self._slot_prompt[slot] = list(tokens)
            self._slot_end[slot] = start_pos + len(tokens)
