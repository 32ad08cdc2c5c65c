"""Tiered KV plane: HBM → pinned host memory → conversation store (the
port's copy of ``llmq_tpu/tiering/plane.py``).

A conversation's pinned KV pages otherwise live in the device pool or
die: the pin TTL and pool pressure free a between-turns conversation's
pages outright. This plane puts a memory hierarchy under that cliff.

- **Demotion** (engine thread): when a conversation pin is reclaimed (TTL
  or pool pressure, never delete), the engine hands its pages here before
  it frees them. The executor gathers the pages on the device
  (``export_kv_pages``: queued on the stream that runs the programs, so
  FIFO order keeps the gather ahead of any later program that rewrites
  the freed pages, with an event behind it) and the worker thread copies
  them to host memory on a stream of its own, after that event: the
  engine thread never waits, and a demotion never stalls the async decode
  pipeline.
- **Host tier**: payloads land in preallocated page-sized buffers
  (:class:`HostTierPool`): one arena allocated at start, pinned on the
  card (plain memory on the CPU), recycled through a freelist.
- **Store tier**: past host capacity the coldest entries spill to the
  conversation store's KV-payload seam (``persistence.py`` ``save_kv``),
  serialized by :func:`encode_blob`, int8 scale pools included as
  ordinary cache leaves. A re-arrival loads the blob back on the worker
  while the request waits in admission.
- **Promotion**: ``InferenceEngine.submit`` calls :meth:`prepare` at a
  conversation's re-arrival (a store load starts at once, overlapping the
  queue wait); admission then :meth:`claim` s the entry, allocates pages
  and injects the payload back into the pool (``import_kv_pages``, which
  copies straight from the pinned buffers; they return to the freelist
  only once that copy's event has completed), and the ordinary
  conversation adoption runs unchanged.
- **Recompute fallback**: an entry whose payload is gone (store spill off
  or failed, promote timeout, pool too contended) still remembers its
  exact token stream, and the engine re-prefills it: always correct,
  merely slower. Counted as the ``recompute`` tier.

Eviction and spill order is recency of observed re-arrival (``prepare``
and ``claim`` touch an entry), or, under ``eviction_policy:
saved_rate``, the usage ledger's saved-prefill rate of the conversation
first.

The store blob is the JAX package's format byte for byte (magic, a JSON
header of the leaf specs, the page count and an optional ``meta``
sidecar, then the per-page payloads), so a blob either package spills
decodes in the other. bfloat16 leaves travel as their raw 2-byte words
(numpy has no bfloat16); the header still names them ``bfloat16``.

**The cluster exchange** (disaggregation plane, ``disagg/``): with
``exchange`` set, ``prepare(remote=True)`` turns a local miss into a claim
from the exchange on the worker, which lands as an ordinary store entry
(``from_exchange``) that admission claims and injects; a miss is
negative-cached for the exchange's ``miss_ttl_s``. ``export_to_exchange``
publishes a held entry's payload (a prefill replica after each finished
turn, any replica at drain). A claimed blob with another page spec keeps
its token stream and drops its bytes.

Hard off-switch: ``executor.kv_tiering.enabled: false`` (the default)
builds no plane, and every engine path is the HBM-only one.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("llmq_tpu_torch.tiering")

#: The closed tier set (the ``tier`` label of the metric families).
TIERS = ("hbm", "host", "store", "recompute")

#: A promotion this soon after its demotion counts as a thrash round trip.
ROUND_TRIP_WINDOW_S = 60.0

_BLOB_MAGIC = b"LLMQKV1\n"

#: A page-payload spec: (one page's shape per leaf, page axis removed;
#: the leaf's dtype, a numpy dtype or a name such as "bfloat16").
Spec = Tuple[Tuple[int, ...], Any]


def dtype_name(dtype: Any) -> str:
    """The dtype's name as a blob header writes it ("bfloat16", "int8",
    "float32", ...)."""
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def storage_dtype(dtype: Any) -> np.dtype:
    """The numpy dtype a leaf's bytes are held in on the host: the dtype
    itself, or 2-byte words for bfloat16."""
    name = dtype_name(dtype)
    if name == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(name)


class HostTierPool:
    """Preallocated page-sized host buffers for demoted KV payloads.

    One buffer holds one page's serialized payload (every cache leaf's
    slice for that page, concatenated). The buffers are page-sized views
    into ONE arena allocated up to ``capacity_bytes`` at construction
    (pinned with ``pin=True``, so the card copies into and out of it
    asynchronously) and recycled through a freelist: a demotion never
    allocates. A buffer
    returns to the freelist only once its content was consumed (injected,
    or serialized to the store); :meth:`give` with a ``fence`` (the event
    behind a copy still reading the buffers) defers that until the fence
    has completed."""

    def __init__(self, capacity_bytes: int, page_nbytes: int,
                 pin: bool = False) -> None:
        import torch

        self.page_nbytes = max(0, int(page_nbytes))
        if self.page_nbytes > 0:
            n = max(0, int(capacity_bytes) // self.page_nbytes)
        else:
            n = 0
        self.pinned = bool(pin and n > 0)
        self._arena_t = torch.empty(n * self.page_nbytes, dtype=torch.uint8,
                                    pin_memory=self.pinned)
        self._arena = self._arena_t.numpy()
        #: Taken buffers by ``id``: (index, the view handed out). A view
        #: is made at take (a slice of the arena never allocates), so a
        #: pool of many small pages costs nothing to build.
        self._out: Dict[int, Tuple[int, np.ndarray]] = {}
        self._free: List[int] = list(range(n))
        #: Buffers given back behind a fence that had not completed yet:
        #: (fence, buffer indices), oldest first.
        self._fenced: List[Tuple[Any, List[int]]] = []
        self._mu = threading.Lock()
        self.total_buffers = n

    def _reap_locked(self, wait: bool = False) -> None:
        """Return fenced buffers whose fence has completed (``wait``: the
        oldest fence is waited for, so at least one batch comes back)."""
        keep = []
        for k, (fence, idx) in enumerate(self._fenced):
            if wait and k == 0:
                fence.synchronize()
            if fence.query():
                self._free.extend(idx)
            else:
                keep.append((fence, idx))
        self._fenced = keep

    def take(self, n: int) -> Optional[List[np.ndarray]]:
        """``n`` buffers, or None if the pool can't provide all of them
        (all or nothing, like the page allocator)."""
        if n <= 0:
            return []
        per = self.page_nbytes
        with self._mu:
            self._reap_locked()
            while len(self._free) < n and self._fenced:
                self._reap_locked(wait=True)
            if len(self._free) < n:
                return None
            out = []
            for _ in range(n):
                i = self._free.pop()
                b = self._arena[i * per:(i + 1) * per]
                self._out[id(b)] = (i, b)
                out.append(b)
        return out

    def give(self, bufs: List[np.ndarray], fence: Any = None) -> None:
        """Return pool buffers to the freelist; with ``fence`` (an event
        recorded behind a copy out of them), only once it has completed.
        Buffers not of this pool (a store load's transient arrays) are
        ignored, and a second give of a buffer is a no-op."""
        if not bufs:
            return
        with self._mu:
            idx = []
            for b in bufs:
                hit = self._out.get(id(b))
                if hit is not None and hit[1] is b:
                    del self._out[id(b)]
                    idx.append(hit[0])
            if fence is not None and idx and not fence.query():
                self._fenced.append((fence, idx))
            else:
                self._free.extend(idx)

    def tensor(self, buf: np.ndarray):
        """The torch tensor over ``buf``'s bytes: the pinned arena's own
        slice for a pool buffer, else a tensor sharing the array's
        memory."""
        import torch

        hit = self._out.get(id(buf))
        if hit is not None and hit[1] is buf:
            per = self.page_nbytes
            return self._arena_t[hit[0] * per:(hit[0] + 1) * per]
        return torch.from_numpy(buf)

    def free_buffers(self) -> int:
        with self._mu:
            self._reap_locked()
            return len(self._free)

    @property
    def total_bytes(self) -> int:
        return self.total_buffers * self.page_nbytes

    def used_bytes(self) -> int:
        return (self.total_buffers - self.free_buffers()) * self.page_nbytes


# -- payload codec -------------------------------------------------------------


def page_payload_nbytes(specs: List[Spec]) -> int:
    """Serialized bytes of ONE page across every cache leaf."""
    total = 0
    for shape, dtype in specs:
        n = 1
        for d in shape:
            n *= int(d)
        total += n * storage_dtype(dtype).itemsize
    return total


def _host_array(leaf: Any) -> np.ndarray:
    """A leaf as a numpy array in its storage dtype: a torch tensor is
    moved to host memory (bfloat16 as its 2-byte words); any failure
    raises."""
    if hasattr(leaf, "detach"):
        import torch

        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16)
    return arr


def pack_pages(leaves: List[Any], bufs: List[np.ndarray]) -> None:
    """Serialize per-leaf page gathers (leaf i: ``(L, N, ...)`` with the
    page axis at 1) into ``N`` flat per-page buffers: buffer j is
    ``[leaf0[:, j] bytes][leaf1[:, j] bytes]...``. One copy per (page,
    leaf), straight into the destination through a dtype view."""
    n = len(bufs)
    offs = 0
    for leaf in leaves:
        arr = _host_array(leaf)
        if arr.ndim <= 1:
            continue
        per = arr.nbytes // max(1, arr.shape[1])
        shape = (arr.shape[0],) + arr.shape[2:]
        for j in range(n):
            dst = bufs[j][offs:offs + per].view(arr.dtype).reshape(shape)
            np.copyto(dst, arr[:, j], casting="no")
        offs += per


def unpack_pages(bufs: List[np.ndarray], specs: List[Spec]
                 ) -> List[np.ndarray]:
    """Inverse of :func:`pack_pages`: the per-leaf arrays ``(L, N, ...)``
    (page axis 1) in their storage dtypes (bfloat16 as uint16 words). The
    promotion path does not use it (``import_kv_pages`` copies from the
    per-page buffers themselves); tests and tools do."""
    n = len(bufs)
    out: List[np.ndarray] = []
    offs = 0
    for shape, dtype in specs:
        dt = storage_dtype(dtype)
        count = 1
        for d in shape:
            count *= int(d)
        per = count * dt.itemsize
        pages = [bufs[j][offs:offs + per].view(dt).reshape(shape)
                 for j in range(n)]
        out.append(np.stack(pages, axis=1))
        offs += per
    return out


def encode_blob(bufs: List[np.ndarray], specs: List[Spec],
                meta: Optional[Dict[str, Any]] = None) -> bytes:
    """Self-describing store blob: magic, the header's length (8 bytes,
    big-endian), a JSON header (leaf specs, page count, optional ``meta``
    sidecar: the conversation's token stream, length and owner), then the
    concatenated per-page payloads. The JAX package's format."""
    header_obj: Dict[str, Any] = {
        "specs": [[list(shape), dtype_name(dtype)] for shape, dtype in specs],
        "n_pages": len(bufs),
    }
    if meta is not None:
        header_obj["meta"] = meta
    header = json.dumps(header_obj).encode()
    parts = [_BLOB_MAGIC, len(header).to_bytes(8, "big"), header]
    parts.extend(bytes(b) for b in bufs)
    return b"".join(parts)


def decode_blob(blob: bytes) -> Tuple[List[np.ndarray], List[Spec]]:
    """Inverse of :func:`encode_blob` → (per-page flat uint8 arrays,
    specs with dtype names). Raises ValueError on a torn or foreign blob:
    the caller falls back to recompute, never injects garbage."""
    if not blob.startswith(_BLOB_MAGIC):
        raise ValueError("not a KV payload blob")
    off = len(_BLOB_MAGIC)
    hlen = int.from_bytes(blob[off:off + 8], "big")
    off += 8
    header = json.loads(blob[off:off + hlen])
    off += hlen
    specs: List[Spec] = [(tuple(int(d) for d in shape), str(name))
                         for shape, name in header["specs"]]
    per = page_payload_nbytes(specs)
    n = int(header["n_pages"])
    if len(blob) - off != per * n:
        raise ValueError("KV payload blob truncated")
    bufs = [np.frombuffer(blob[off + j * per:off + (j + 1) * per],
                          np.uint8).copy() for j in range(n)]
    return bufs, specs


def blob_meta(blob: bytes) -> Optional[Dict[str, Any]]:
    """The header's ``meta`` sidecar alone (no payload byte is touched);
    None for a foreign, torn or meta-less blob. Never raises."""
    if not blob.startswith(_BLOB_MAGIC):
        return None
    off = len(_BLOB_MAGIC)
    hlen = int.from_bytes(blob[off:off + 8], "big")
    try:
        header = json.loads(blob[off + 8:off + 8 + hlen])
    except ValueError:
        return None
    meta = header.get("meta") if isinstance(header, dict) else None
    return dict(meta) if isinstance(meta, dict) else None


class PagePayload:
    """A claimed entry's payload as ``import_kv_pages`` takes it: the
    per-page host buffers (pinned arena slices for pool buffers) and the
    leaf specs that cut each buffer into its leaves."""

    __slots__ = ("bufs", "specs", "_pool")

    def __init__(self, bufs: List[np.ndarray], specs: List[Spec],
                 pool: HostTierPool) -> None:
        self.bufs = bufs
        self.specs = specs
        self._pool = pool

    def tensors(self) -> list:
        """One uint8 tensor per page (``page_payload_nbytes`` long)."""
        return [self._pool.tensor(b) for b in self.bufs]

    def leaves(self) -> List[np.ndarray]:
        """The per-leaf ``(L, N, ...)`` arrays (:func:`unpack_pages`)."""
        return unpack_pages(self.bufs, self.specs)


# -- entries -------------------------------------------------------------------


class TierEntry:
    """One demoted conversation's KV: the exact token stream (always: it
    is the recompute fallback), plus the page payload when the executor
    has content to preserve."""

    __slots__ = ("conv_id", "tokens", "length", "pending", "n_pages",
                 "tier", "payload", "pooled", "ready", "demoted_at",
                 "last_used", "wait_since", "loading", "source_tier",
                 "abandoned", "spilling", "from_exchange", "store_ms")

    def __init__(self, conv_id: str, tokens: List[int], length: int,
                 pending: Optional[int], n_pages: int,
                 now: float) -> None:
        self.conv_id = conv_id
        self.tokens = tokens
        self.length = length
        self.pending = pending
        self.n_pages = n_pages
        #: Where the payload lives: "host" (buffers), "store" (a spilled
        #: blob) or "recompute" (the token stream only).
        self.tier = "recompute"
        #: Per-page flat uint8 buffers (host pool, or a load's transient
        #: arrays).
        self.payload: Optional[List[np.ndarray]] = None
        #: Whether ``payload`` came from the HostTierPool (give it back).
        self.pooled = False
        #: Set once the entry is claimable (extract or load finished, or
        #: nothing to wait for).
        self.ready = threading.Event()
        self.demoted_at = now
        self.last_used = now
        #: perf_counter of the first claim that had to wait (the promote
        #: timeout runs from it).
        self.wait_since: Optional[float] = None
        #: A store → host load is in flight.
        self.loading = False
        #: The tier the payload was served from at claim (a store entry
        #: loaded back is still a store hit).
        self.source_tier = "host"
        #: Claimed by a timeout while the worker still ran: the late
        #: extract or load gives its buffers back instead of publishing.
        self.abandoned = False
        #: Claimed by a spill job: already leaving the host tier, so the
        #: bound does not spill everything while the first spill runs.
        self.spilling = False
        #: Claimed from the cluster exchange (a prefill → decode
        #: handoff), not this replica's own tiers: the critical path
        #: names its admission wait ``handoff_claim``.
        self.from_exchange = False
        #: Milliseconds this entry's claim waited on the store (the
        #: critical path's store-wait attribution).
        self.store_ms = 0.0


# -- the plane -----------------------------------------------------------------


class KVTieringPlane:
    """The engine's tier manager. Threads: ``demote`` and ``claim`` run
    on the engine thread only (they use the executor's pool); ``prepare``,
    ``forget`` and ``stats`` are thread-safe; every blocking job (device
    → host copies, store I/O, spill serialization) runs on the plane's
    own worker thread, ``kv-tiering-<name>``, started at the first job."""

    def __init__(self, cfg: Any, name: str, executor: Any, *,
                 clock: Any = None, metrics: bool = True,
                 on_ready: Optional[Callable[[], None]] = None) -> None:
        self.cfg = cfg
        self.name = name
        self._executor = executor
        self._clock = clock
        self.metrics_enabled = bool(metrics)
        self._on_ready = on_ready
        self._export = getattr(executor, "export_kv_pages", None)
        self._import = getattr(executor, "import_kv_pages", None)
        self._content_free = bool(getattr(executor, "kv_content_free",
                                          False))
        spec_fn = getattr(executor, "kv_page_spec", None)
        self._specs: Optional[List[Spec]] = (
            spec_fn() if spec_fn is not None and self._export is not None
            else None)
        page_nbytes = (page_payload_nbytes(self._specs)
                       if self._specs else 0)
        # Pinned on the card, plain memory on the CPU: the caller's
        # device decides.
        dev = getattr(executor, "device", None)
        self.pool = HostTierPool(
            int(getattr(cfg, "host_capacity_mb", 256)) * (1 << 20),
            page_nbytes, pin=getattr(dev, "type", "") == "cuda")
        self.host_max_conversations = int(
            getattr(cfg, "host_max_conversations", 4096))
        self.store_spill = bool(getattr(cfg, "store_spill", True))
        self.promote_timeout_s = float(
            getattr(cfg, "promote_timeout_s", 5.0))
        #: "saved_rate" ranks every eviction (pin reclaim in the engine,
        #: host → store spill here) by the usage ledger's saved-prefill
        #: rate, recency breaking ties; "lru" is recency alone.
        self.eviction_policy = str(getattr(cfg, "eviction_policy", "lru"))
        #: The conversation store with the KV-payload seam
        #: (``save_kv`` / ``load_kv`` / ``delete_kv``), feature-detected:
        #: a store without it disables the store tier.
        self._store: Any = None
        #: The cluster KV exchange of the disaggregation plane (a
        #: ``disagg.KVExchange``), set by its coordinator; None: local
        #: tiers only.
        self.exchange: Any = None
        #: Exchange misses (conv id → time): not asked again for the
        #: exchange's ``miss_ttl_s``.
        self._xchg_miss: Dict[str, float] = {}
        self._entries: Dict[str, TierEntry] = {}
        self._store_ids: set = set()   # conv ids with a spilled blob
        self._mu = threading.Lock()
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        #: The worker's copy stream on the card (made at its first copy).
        self._d2h_stream = None
        #: ``() -> (pages, bytes)`` of the HBM-pinned pages (the engine's
        #: allocator), for the ``hbm`` row of kv_tier_pages.
        self.hbm_provider: Optional[
            Callable[[], Optional[Tuple[int, int]]]] = None
        #: ``cb(conv_id, tier)`` when an entry's tier changes on the
        #: worker (spill, degradation): the engine forwards it to the
        #: prefix handle, so ``prefill_estimate`` never promises a prefix
        #: nothing can serve.
        self.on_tier_change: Optional[Callable[[str, str], None]] = None
        # Counters and buffered observations (flushed to the metric
        # families at scrape; demote and promote never touch a label).
        self.hits: Dict[str, int] = {t: 0 for t in TIERS}
        self.demotions = 0
        self.promotions = 0
        self.spills = 0
        self.round_trips = 0
        self.store_errors = 0
        #: Device → host copies that raised (the entry then keeps its
        #: token stream only) and payload injections that failed in the
        #: engine (it recomputes): both are faults, counted, never silent.
        self.transfer_errors = 0
        self.inject_failures = 0
        #: Device → host copies: count, bytes and device milliseconds (by
        #: CUDA events on the worker's stream; 0 on the CPU).
        self.d2h_count = 0
        self.d2h_bytes = 0
        self.d2h_ms = 0.0
        self._demote_ms: List[float] = []
        self._promote_ms: List[float] = []
        self._flushed_hits: Dict[str, int] = {t: 0 for t in TIERS}
        self._flushed_round_trips = 0
        _register(self)

    # -- lifecycle -----------------------------------------------------------

    def _now(self) -> float:
        if self._clock is not None:
            return float(self._clock.now())
        return time.perf_counter()

    def _submit(self, fn: Callable[[], None]) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._loop, name=f"kv-tiering-{self.name}",
                daemon=True)
            self._worker.start()
        self._q.put(fn)

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — one failed job must not
                log.exception("kv-tiering job failed")  # kill the lane

    def flush_jobs(self, timeout: float = 5.0) -> bool:
        """Wait (bounded) until every job queued before the call has run:
        the lane is FIFO."""
        done = threading.Event()
        self._submit(done.set)
        return done.wait(timeout)

    def stop(self) -> None:
        w, self._worker = self._worker, None
        if w is not None:
            self._q.put(None)
            w.join(timeout=5.0)

    # -- demotion (engine thread) ---------------------------------------------

    def demote(self, conv_id: str, pages: List[int], tokens: List[int],
               length: int, pending: Optional[int]) -> str:
        """Capture a reclaimed pin's KV before the engine frees its pages:
        dispatch the device gather (no host wait) and hand the copy to the
        worker. With no payload to keep (a content-free executor, or no
        export seam) the entry is metadata only and ready at once. Returns
        the entry's tier as far as known now ("host", or "recompute" when
        only the token stream survives): the caller's prefix-handle note;
        later changes on the worker fire ``on_tier_change``. The caller
        frees the pages afterwards either way."""
        t0 = time.perf_counter()
        now = self._now()
        entry = TierEntry(conv_id, list(tokens), int(length), pending,
                          len(pages), now)
        if self._export is not None and self._specs and pages:
            try:
                dev = self._export(list(pages))
            except Exception:  # noqa: BLE001 — the token stream survives
                log.exception("kv export failed for %s", conv_id)
                with self._mu:
                    self.transfer_errors += 1
                dev = None
            if dev is not None:
                entry.tier = "host"
                self._submit(lambda: self._extract(entry, dev))
            else:
                entry.ready.set()
        else:
            # Metadata only: exact for a content-free executor (the token
            # stream IS the state); otherwise the recompute fallback.
            entry.tier = "host" if self._content_free else "recompute"
            entry.ready.set()
        with self._mu:
            old = self._entries.pop(conv_id, None)
            self._entries[conv_id] = entry
            self.demotions += 1
            self._demote_ms.append((time.perf_counter() - t0) * 1e3)
        if old is not None:
            self._discard(old)
        self._bound_host_locked_out()
        return entry.tier

    def _publish(self, entry: TierEntry, tier: str,
                 payload: Optional[List[np.ndarray]],
                 pooled: bool) -> None:
        """Worker → claim handoff: the final state lands under the plane
        lock, THEN ready fires, so a claim never sees a half-published
        entry. An entry abandoned meanwhile (promote timeout) gets its
        buffers back instead."""
        with self._mu:
            if entry.abandoned:
                abandoned = True
            else:
                abandoned = False
                entry.tier = tier
                entry.payload = payload
                entry.pooled = pooled
                entry.loading = False
                entry.spilling = False
                # A fresh readiness epoch: a later wait gets the whole
                # promote timeout.
                entry.wait_since = None
            entry.ready.set()
        if abandoned and payload is not None and pooled:
            self.pool.give(payload)
        if not abandoned and tier == "host":
            # A demote burst can outrun the extracts (no ready victim to
            # spill at demote time): the bound is enforced again as each
            # entry becomes resident.
            self._bound_host_locked_out()
        if not abandoned and tier == "recompute":
            # The payload is gone for good: the prefix handle must stop
            # promising a cached prefix.
            self._tier_changed(entry.conv_id, "dropped")
        elif not abandoned and tier == "store":
            self._tier_changed(entry.conv_id, "store")
        self._notify()

    def _tier_changed(self, conv_id: str, tier: str) -> None:
        """Fire ``on_tier_change`` with no plane lock held (the callback
        takes the state manager's lock)."""
        cb = self.on_tier_change
        if cb is None:
            return
        try:
            cb(conv_id, tier)
        except Exception:  # noqa: BLE001 — bookkeeping, not a gate
            log.exception("tier-change callback failed for %s", conv_id)

    def _extract(self, entry: TierEntry, dev: Any) -> None:
        """Worker: copy the dispatched gather to host buffers (spilling
        colder entries when the pool is full, straight to the store past
        that). A failed copy is counted and leaves the token stream."""
        if entry.abandoned:
            entry.ready.set()
            return
        bufs = self._buffers_for(entry.n_pages)
        assert self._specs is not None
        if bufs is not None:
            if self._copy_out(dev, bufs):
                self._publish(entry, "host", bufs, pooled=True)
            else:
                self.pool.give(bufs)
                self._publish(entry, "recompute", None, pooled=False)
        elif self.store_spill and self._store_ok():
            tmp = [np.empty(self.pool.page_nbytes, np.uint8)
                   for _ in range(entry.n_pages)]
            if (self._copy_out(dev, tmp)
                    and self._spill_blob(entry.conv_id, tmp,
                                         self._entry_meta(entry))):
                self._publish(entry, "store", None, pooled=False)
            else:
                self._publish(entry, "recompute", None, pooled=False)
        else:
            self._publish(entry, "recompute", None, pooled=False)

    def _copy_out(self, dev: Any, bufs: List[np.ndarray]) -> bool:
        """Worker: the exported pages into ``bufs`` (one per page). An
        executor export with a page-major ``packed`` tensor is copied page
        by page straight into the buffers (on the card: on the worker's
        stream, after the export's event, then waited on by its own
        event); per-leaf arrays are moved to the host and packed. False
        (logged and counted) if the copy raised."""
        try:
            packed = getattr(dev, "packed", None)
            if packed is None:
                pack_pages([_host_array(a) for a in dev], bufs)
                return True
            nbytes = len(bufs) * self.pool.page_nbytes
            if packed.device.type == "cuda":
                import torch

                if self._d2h_stream is None:
                    self._d2h_stream = torch.cuda.Stream(packed.device)
                s = self._d2h_stream
                s.wait_event(dev.event)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(s):
                    start.record()
                    for j, b in enumerate(bufs):
                        self.pool.tensor(b).copy_(packed[j],
                                                  non_blocking=True)
                    end.record()
                # The gather was made on the engine's stream and is read
                # on this one: the allocator must not reuse it before the
                # copies ran (the reference held until ``end`` also
                # guarantees it).
                packed.record_stream(s)
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                for j, b in enumerate(bufs):
                    self.pool.tensor(b).copy_(packed[j])
                ms = 0.0
            with self._mu:
                self.d2h_count += 1
                self.d2h_bytes += nbytes
                self.d2h_ms += ms
            return True
        except Exception:  # noqa: BLE001 — counted: a fault, not a path
            log.exception("kv device-to-host copy failed")
            with self._mu:
                self.transfer_errors += 1
            return False

    def _buffers_for(self, n: int) -> Optional[List[np.ndarray]]:
        """Worker: host-pool buffers for ``n`` pages, spilling the coldest
        ready host entries to the store to make room."""
        bufs = self.pool.take(n)
        while bufs is None and self.store_spill and self._store_ok():
            victim = self._coldest_host_entry()
            if victim is None:
                break
            self._spill_entry(*victim)
            bufs = self.pool.take(n)
        return bufs

    def _claim_for_spill_locked(
            self, victim: TierEntry) -> Tuple[List[np.ndarray], bool]:
        """Under ``self._mu``: take exclusive ownership of a spill
        victim's payload. The buffers move into the job: a promote-timeout
        claim racing the queued spill must find no payload, or it could
        hand the buffers back while the spill still reads them."""
        victim.ready.clear()
        victim.spilling = True
        bufs = victim.payload or []
        victim.payload = None
        pooled, victim.pooled = victim.pooled, False
        return bufs, pooled

    def _evict_key(self, entry: TierEntry) -> Tuple[float, float]:
        """Eviction rank, lowest first: under "saved_rate" the usage
        ledger's saved-prefill rate, then recency (the whole key under
        "lru", and in effect whenever the ledger has no signal)."""
        if self.eviction_policy == "saved_rate":
            from llmq_tpu_torch.observability.usage import get_usage_ledger
            return (get_usage_ledger().conversation_saved_rate(
                entry.conv_id), entry.last_used)
        return (0.0, entry.last_used)

    def _coldest_host_entry(
            self) -> Optional[Tuple[TierEntry, List[np.ndarray], bool]]:
        """Worker: claim the coldest spillable host entry (its readiness
        drops, so a concurrent promotion waits, and its payload moves to
        the caller), all under the lock."""
        with self._mu:
            cands = [e for e in self._entries.values()
                     if e.tier == "host" and e.pooled
                     and e.ready.is_set() and e.payload
                     and not e.abandoned and not e.spilling]
            if not cands:
                return None
            victim = min(cands, key=self._evict_key)
            bufs, pooled = self._claim_for_spill_locked(victim)
            return victim, bufs, pooled

    def _spill_entry(self, entry: TierEntry, bufs: List[np.ndarray],
                     pooled: bool) -> None:
        """Worker: move a claimed spill victim's payload to the store,
        then give its buffers back."""
        if not bufs:
            self._publish(entry, "recompute", None, pooled=False)
            return
        ok = self._spill_blob(entry.conv_id, bufs, self._entry_meta(entry))
        self._publish(entry, "store" if ok else "recompute", None,
                      pooled=False)
        if pooled:
            self.pool.give(bufs)

    def _entry_meta(self, entry: TierEntry) -> Dict[str, Any]:
        """The blob's ``meta`` sidecar: what a restarted process needs to
        rebuild the entry."""
        return {
            "conv_id": entry.conv_id,
            "tokens": list(entry.tokens),
            "length": int(entry.length),
            "pending": entry.pending,
            "n_pages": int(entry.n_pages),
            "owner": self.name,
            "content_free": bool(self._content_free),
        }

    def _spill_blob(self, conv_id: str, bufs: List[np.ndarray],
                    meta: Optional[Dict[str, Any]] = None) -> bool:
        assert self._specs is not None
        try:
            self.store.save_kv(conv_id,
                               encode_blob(bufs, self._specs, meta=meta))
        except Exception:  # noqa: BLE001 — spill is best-effort
            log.exception("kv spill failed for %s", conv_id)
            with self._mu:
                self.store_errors += 1
            return False
        with self._mu:
            self.spills += 1
            self._store_ids.add(conv_id)
        return True

    @property
    def store(self) -> Any:
        return self._store

    @store.setter
    def store(self, value: Any) -> None:
        self._store = value
        # A resilience-wrapped store names this plane in its
        # store_degraded{consumer} gauge.
        reg = getattr(value, "register_consumer", None)
        if callable(reg):
            reg("tiering")

    def _store_ok(self) -> bool:
        """The store tier is usable: a store with the KV-payload seam that
        does not report itself degraded."""
        return (self.store is not None
                and hasattr(self.store, "save_kv")
                and not getattr(self.store, "degraded", False))

    def _bound_host_locked_out(self) -> None:
        """Past ``host_max_conversations`` resident entries the coldest
        ready ones spill to the store (payload entries) or are dropped.
        Store entries do not count: their weight is the blob."""
        with self._mu:
            resident = [e for e in self._entries.values()
                        if e.tier != "store" and not e.spilling]
            over = len(resident) - self.host_max_conversations
            if over <= 0:
                return
            victims = sorted(
                (e for e in resident
                 if e.ready.is_set() and not e.abandoned),
                key=self._evict_key)[:over]
            dropped: List[TierEntry] = []
            jobs: List[Tuple[TierEntry, List[np.ndarray], bool]] = []
            for v in victims:
                if (v.payload is not None and self.store_spill
                        and self._store_ok()):
                    jobs.append((v, *self._claim_for_spill_locked(v)))
                else:
                    del self._entries[v.conv_id]
                    v.abandoned = True
                    dropped.append(v)
        for v in dropped:
            self._discard(v)
            self._tier_changed(v.conv_id, "dropped")
        for job in jobs:
            self._submit(lambda job=job: self._spill_entry(*job))

    # -- promotion ------------------------------------------------------------

    def _needs_load_locked(self, entry: TierEntry) -> bool:
        """Under ``self._mu``: a ready store entry whose payload is still
        only a blob (claiming it as is would make a store hit a
        recompute): start the load instead."""
        return (entry.ready.is_set() and entry.tier == "store"
                and entry.payload is None and not entry.loading
                and not entry.abandoned and self._store_ok())

    def prepare(self, conv_id: str, *, remote: bool = False) -> bool:
        """Re-arrival hint (any thread): start loading a store entry's
        blob back now, so the load overlaps the queue wait and admission.
        True when the plane holds (or is loading) an entry for
        ``conv_id``. ``remote`` (a decode replica seeing a follow-up turn
        it never served) makes a local miss a claim from the exchange on
        the worker, behind a placeholder store entry that admission waits
        on; a miss deletes the placeholder (recompute) and is not asked
        again for the exchange's ``miss_ttl_s``."""
        start_load = False
        fetch: Optional[TierEntry] = None
        with self._mu:
            entry = self._entries.get(conv_id)
            if entry is None:
                xchg = self.exchange
                if not remote or xchg is None:
                    return False
                now = self._now()
                miss = self._xchg_miss.get(conv_id)
                if (miss is not None
                        and now - miss < float(getattr(xchg, "miss_ttl_s",
                                                       5.0))):
                    return False
                self._xchg_miss.pop(conv_id, None)
                if len(self._xchg_miss) > 4096:
                    self._xchg_miss.clear()
                entry = TierEntry(conv_id, [], 0, None, 0, now)
                entry.tier = "store"
                entry.source_tier = "store"
                entry.from_exchange = True
                entry.loading = True
                self._entries[conv_id] = entry
                fetch = entry
            else:
                entry.last_used = self._now()
                if self._needs_load_locked(entry):
                    entry.loading = True
                    entry.ready.clear()
                    start_load = True
        if fetch is not None:
            self._submit(lambda: self._exchange_fetch(fetch))
            return True
        if start_load:
            self._submit(lambda: self._load(entry))
        return True

    def _same_spec(self, specs: List[Spec]) -> bool:
        """``specs`` (a claimed blob's) cut pages as this pool does."""
        mine = self._specs
        return (mine is not None and len(specs) == len(mine)
                and all(tuple(a[0]) == tuple(b[0])
                        and dtype_name(a[1]) == dtype_name(b[1])
                        for a, b in zip(specs, mine)))

    def _exchange_fetch(self, entry: TierEntry) -> None:
        """Worker: claim a peer's published KV and publish it here as a
        ready store entry (the promote path is the receive path). A miss
        (nothing published, expired, torn) deletes the placeholder, so
        admission recomputes; a foreign page spec keeps the token stream
        and drops the payload: foreign bytes are never injected."""
        xchg = self.exchange
        res = None
        t0 = time.perf_counter()
        if xchg is not None and not entry.abandoned:
            try:
                res = xchg.claim(entry.conv_id)
            except Exception:  # noqa: BLE001 — the claim is best-effort
                log.exception("kv exchange claim failed for %s",
                              entry.conv_id)
        entry.store_ms += (time.perf_counter() - t0) * 1e3
        if res is None:
            with self._mu:
                if self._entries.get(entry.conv_id) is entry:
                    del self._entries[entry.conv_id]
                self._xchg_miss[entry.conv_id] = self._now()
                entry.abandoned = True
                entry.ready.set()
            self._notify()
            return
        bufs, specs, meta = res
        entry.tokens = list(meta.get("tokens") or [])
        entry.length = int(meta.get("length") or len(entry.tokens))
        pending = meta.get("pending")
        entry.pending = int(pending) if pending is not None else None
        entry.n_pages = int(meta.get("n_pages") or len(bufs))
        if self._content_free:
            # The token stream is the state: a metadata entry is exact.
            self._publish(entry, "host", None, pooled=False)
            return
        if bufs and self._same_spec(specs):
            bufs2 = self.pool.take(len(bufs))
            if bufs2 is not None:
                for dst, src in zip(bufs2, bufs):
                    dst[:len(src)] = src
                payload, pooled = bufs2, True
            else:
                payload, pooled = bufs, False   # transient arrays
            entry.source_tier = "store"
            self._publish(entry, "store", payload, pooled=pooled)
            return
        if bufs:
            log.warning("exchange KV for %s has a foreign page spec; "
                        "recompute", entry.conv_id)
        self._publish(entry, "recompute", None, pooled=False)

    def export_to_exchange(self, conv_id: str) -> bool:
        """Queue the publication of a held entry to the exchange. It runs
        on the FIFO worker behind any extract in flight, so the payload
        is complete when the job reads it. True when a job was queued."""
        if self.exchange is None:
            return False
        with self._mu:
            if conv_id not in self._entries:
                return False
        self._submit(lambda: self._exchange_publish(conv_id))
        return True

    def _exchange_publish(self, conv_id: str) -> None:
        """Worker: serialize a ready entry to the exchange. A host payload
        is held exclusively meanwhile (as a spill holds it) and put back
        after; a store entry republishes its blob; an entry without a
        payload ships its metadata alone."""
        xchg = self.exchange
        if xchg is None:
            return
        with self._mu:
            entry = self._entries.get(conv_id)
            if (entry is None or not entry.ready.is_set()
                    or entry.abandoned or entry.spilling):
                return
            tier = entry.tier
            if entry.payload is not None:
                bufs, pooled = self._claim_for_spill_locked(entry)
            else:
                bufs, pooled = [], False
        meta = self._entry_meta(entry)
        try:
            if bufs:
                xchg.publish(conv_id, bufs, self._specs or [], meta)
            elif tier == "store" and self._store_ok():
                blob = None
                try:
                    blob = self.store.load_kv(conv_id)
                except Exception:  # noqa: BLE001 — metadata only then
                    log.exception("kv store load for exchange publish "
                                  "failed for %s", conv_id)
                sbufs: List[np.ndarray] = []
                sspecs: List[Spec] = []
                if blob is not None:
                    try:
                        sbufs, sspecs = decode_blob(blob)
                    except ValueError:
                        log.warning("corrupt KV blob for %s; publishing "
                                    "metadata only", conv_id)
                xchg.publish(conv_id, sbufs, sspecs, meta)
            else:
                xchg.publish(conv_id, [], [], meta)
        except Exception:  # noqa: BLE001 — publish is best-effort; the
            log.exception(         # claimer recomputes
                "kv exchange publish failed for %s", conv_id)
        finally:
            if bufs:
                self._publish(entry, tier, bufs, pooled)

    def rehydrate(self, owner: Optional[str] = None
                  ) -> List[Tuple[str, Dict[str, Any]]]:
        """Restart recovery: scan the store's KV payloads and adopt the
        blobs this replica owns (``owner``: the name stamped in each
        blob's meta at spill time) as ready store entries, so a restarted
        process serves its spilled conversations as store hits. Exchange
        keys and meta-less blobs are skipped. Returns the adopted
        ``(conv_id, meta)`` pairs."""
        if not self._store_ok() or not hasattr(self.store, "list_kv"):
            return []
        try:
            ids = list(self.store.list_kv())
        except Exception:  # noqa: BLE001 — recovery is best-effort
            log.exception("kv store scan failed during rehydrate")
            return []
        adopted: List[Tuple[str, Dict[str, Any]]] = []
        now = self._now()
        for cid in ids:
            if cid.startswith("xchg:"):
                continue   # exchange entries are claimable, not owned
            with self._mu:
                if cid in self._entries:
                    continue
            try:
                blob = self.store.load_kv(cid)
            except Exception:  # noqa: BLE001
                log.exception("kv blob read failed for %s", cid)
                continue
            if blob is None:
                continue
            meta = blob_meta(blob)
            if meta is None:
                continue
            if owner is not None and meta.get("owner") != owner:
                continue
            tokens = list(meta.get("tokens") or [])
            length = int(meta.get("length") or len(tokens))
            if not tokens and length > 0:
                continue   # no recompute fallback: unusable
            pending = meta.get("pending")
            entry = TierEntry(
                cid, tokens, length,
                int(pending) if pending is not None else None,
                int(meta.get("n_pages") or 0), now)
            entry.tier = "store"
            entry.source_tier = "store"
            entry.ready.set()
            with self._mu:
                if cid in self._entries:
                    continue
                self._entries[cid] = entry
                self._store_ids.add(cid)
            adopted.append((cid, meta))
        if adopted:
            log.info("rehydrated %d spilled conversation(s) from the "
                     "store tier", len(adopted))
        return adopted

    def _load(self, entry: TierEntry) -> None:
        """Worker: store blob → host payload (published atomically)."""
        blob = None
        t0 = time.perf_counter()
        try:
            blob = self.store.load_kv(entry.conv_id)
        except Exception:  # noqa: BLE001
            log.exception("kv store load failed for %s", entry.conv_id)
            with self._mu:
                self.store_errors += 1
        entry.store_ms += (time.perf_counter() - t0) * 1e3
        if blob is not None and not entry.abandoned:
            try:
                bufs, _specs = decode_blob(blob)
                bufs2 = self.pool.take(len(bufs))
                if bufs2 is not None:
                    for dst, src in zip(bufs2, bufs):
                        dst[:len(src)] = src
                    payload, pooled = bufs2, True
                else:
                    payload, pooled = bufs, False   # transient arrays
                entry.source_tier = "store"
                self._publish(entry, "store", payload, pooled=pooled)
                return
            except ValueError:
                log.warning("corrupt KV blob for %s; recompute",
                            entry.conv_id)
        self._publish(entry, "recompute", None, pooled=False)

    def claim(self, conv_id: str) -> Tuple[str, Optional[TierEntry]]:
        """Admission-side takeover (engine thread): ``("none", None)``
        when the plane holds nothing, ``("wait", None)`` while an extract
        or load is in flight (the sequence stays pending, decode goes
        on), or ``("ready", entry)`` with the entry now the caller's:
        inject its payload (when present) or recompute from its tokens,
        then :meth:`release` it. A wait past ``promote_timeout_s``
        degrades to a ready entry without payload: recompute beats
        stalling admission."""
        start_load = False
        with self._mu:
            entry = self._entries.get(conv_id)
            if entry is None:
                return "none", None
            entry.last_used = self._now()
            if self._needs_load_locked(entry):
                # No prepare() ran (an engine driven directly): the claim
                # starts the load itself.
                entry.loading = True
                entry.ready.clear()
                start_load = True
            elif entry.ready.is_set():
                del self._entries[conv_id]
                return "ready", entry
            now = time.perf_counter()
            if entry.wait_since is None:
                entry.wait_since = now
            elif now - entry.wait_since >= self.promote_timeout_s:
                # Degrade to recompute. The payload stays on the entry
                # for release() to return: an in-flight spill owns its
                # buffers (taken at claim-for-spill), and an in-flight
                # extract or load sees ``abandoned`` and gives its own.
                entry.abandoned = True
                entry.tier = "recompute"
                del self._entries[conv_id]
                return "ready", entry
        if start_load:
            self._submit(lambda: self._load(entry))
        # A bounded sub-millisecond wait outside the lock: a caller that
        # steps the engine synchronously does not spin through its step
        # budget while the worker finishes.
        entry.ready.wait(0.0005)
        with self._mu:
            if (entry.ready.is_set()
                    and self._entries.get(conv_id) is entry
                    and not self._needs_load_locked(entry)):
                del self._entries[conv_id]
                return "ready", entry
        return "wait", None

    @property
    def content_free(self) -> bool:
        """The executor's KV has no content to keep: a metadata-only entry
        restores exactly."""
        return self._content_free

    def restash(self, conv_id: str, entry: TierEntry) -> None:
        """Put a claimed, unconsumed entry back (the promotion was
        deferred: the pool was contended with chunks in flight). It stays
        ready; a newer entry for the conversation wins."""
        with self._mu:
            if conv_id not in self._entries:
                entry.wait_since = None
                self._entries[conv_id] = entry
                return
        self._discard(entry)

    def note_promoted(self, entry: TierEntry, tier: str,
                      host_ms: float) -> None:
        """Book a finished promotion: ``tier`` served it (host, store or
        recompute); ``host_ms`` is the admission-side work (page
        allocation, inject dispatch)."""
        with self._mu:
            self.promotions += 1
            self.hits[tier] = self.hits.get(tier, 0) + 1
            self._promote_ms.append(host_ms)
            if (tier in ("host", "store")
                    and self._now() - entry.demoted_at
                    <= ROUND_TRIP_WINDOW_S):
                self.round_trips += 1

    def note_hit(self, tier: str) -> None:
        """Count a re-arrival served without the plane: ``hbm`` (the pin
        was still resident)."""
        with self._mu:
            self.hits[tier] = self.hits.get(tier, 0) + 1

    def note_inject_failure(self) -> None:
        """The engine's inject of a claimed payload raised (it recomputes
        instead): counted in ``stats()["inject_failures"]``."""
        with self._mu:
            self.inject_failures += 1

    def unpack(self, entry: TierEntry) -> Optional[PagePayload]:
        """The entry's payload for ``executor.import_kv_pages``; None for a
        metadata-only entry (content-free executor, or the recompute
        fallback)."""
        if entry.payload is None or self._specs is None:
            return None
        return PagePayload(entry.payload, self._specs, self.pool)

    def release(self, entry: TierEntry, fence: Any = None) -> None:
        """Return a claimed entry's pool buffers, once ``fence`` (the
        inject's copy event, when it read them asynchronously) has
        completed."""
        self._discard(entry, fence)

    def _discard(self, entry: TierEntry, fence: Any = None) -> None:
        entry.abandoned = True
        bufs, entry.payload = entry.payload, None
        if bufs is not None and entry.pooled:
            self.pool.give(bufs, fence)
            entry.pooled = False

    def forget(self, conv_id: str) -> None:
        """The conversation was deleted: drop every tier's copy (host
        buffers back to the pool, the store blob deleted on the
        worker)."""
        with self._mu:
            entry = self._entries.pop(conv_id, None)
            spilled = conv_id in self._store_ids
            self._store_ids.discard(conv_id)
        if entry is not None:
            self._discard(entry)
        if spilled and self._store_ok():
            self._submit(lambda: self._delete_blob(conv_id))

    def _delete_blob(self, conv_id: str) -> None:
        try:
            self.store.delete_kv(conv_id)
        except Exception:  # noqa: BLE001
            log.exception("kv blob delete failed for %s", conv_id)
            with self._mu:
                self.store_errors += 1

    def _notify(self) -> None:
        cb = self._on_ready
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — wake-up is best-effort
                pass

    # -- visibility -----------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        with self._mu:
            tiers = [e.tier for e in self._entries.values()]
        return {t: tiers.count(t) for t in ("host", "store", "recompute")}

    def stats(self) -> Dict[str, Any]:
        counts = self.counts()
        used, total = self.pool.used_bytes(), self.pool.total_bytes
        with self._mu:
            return {
                "entries": len(self._entries),
                "host_entries": counts["host"],
                "store_entries": counts["store"],
                "recompute_entries": counts["recompute"],
                "host_bytes_used": used,
                "host_bytes_total": total,
                "host_pinned": self.pool.pinned,
                "page_payload_bytes": self.pool.page_nbytes,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "spills": self.spills,
                "round_trips": self.round_trips,
                "store_errors": self.store_errors,
                "transfer_errors": self.transfer_errors,
                "inject_failures": self.inject_failures,
                "d2h_copies": self.d2h_count,
                "d2h_bytes": self.d2h_bytes,
                "d2h_ms": round(self.d2h_ms, 3),
                "hits": dict(self.hits),
            }

    def flush_metrics(self) -> None:
        """Scrape-time flush (``metrics.registry.exposition``): gauges set,
        counter deltas applied, buffered observations drained."""
        if not self.metrics_enabled:
            return
        from llmq_tpu_torch.metrics.registry import get_metrics

        m = get_metrics()
        with self._mu:
            entries = list(self._entries.values())
            demote_ms, self._demote_ms = self._demote_ms, []
            promote_ms, self._promote_ms = self._promote_ms, []
            hit_deltas = {t: self.hits.get(t, 0)
                          - self._flushed_hits.get(t, 0) for t in TIERS}
            self._flushed_hits = dict(self.hits)
            rt_delta = self.round_trips - self._flushed_round_trips
            self._flushed_round_trips = self.round_trips
        host_pages = sum(e.n_pages for e in entries if e.tier == "host")
        store_pages = sum(e.n_pages for e in entries if e.tier == "store")
        per = self.pool.page_nbytes
        m.kv_tier_pages.labels(self.name, "host").set(host_pages)
        m.kv_tier_pages.labels(self.name, "store").set(store_pages)
        m.kv_tier_bytes.labels(self.name, "host").set(host_pages * per)
        m.kv_tier_bytes.labels(self.name, "store").set(store_pages * per)
        hbm = self.hbm_provider() if self.hbm_provider is not None else None
        if hbm is not None:
            pages, nbytes = hbm
            m.kv_tier_pages.labels(self.name, "hbm").set(pages)
            m.kv_tier_bytes.labels(self.name, "hbm").set(nbytes)
        for t in TIERS:
            if hit_deltas.get(t):
                m.kv_tier_hits.labels(self.name, t).inc(hit_deltas[t])
        if rt_delta:
            m.kv_tier_round_trips.labels(self.name).inc(rt_delta)
        for v in demote_ms:
            m.kv_demote_ms.labels(self.name).observe(v)
        for v in promote_ms:
            m.kv_promote_ms.labels(self.name).observe(v)


# -- flush registry ------------------------------------------------------------

_PLANES: "weakref.WeakSet[KVTieringPlane]" = weakref.WeakSet()
_PLANES_LOCK = threading.Lock()


def _register(plane: KVTieringPlane) -> None:
    with _PLANES_LOCK:
        _PLANES.add(plane)


def flush_metrics() -> None:
    """Scrape hook: flush every live plane's buffered telemetry."""
    with _PLANES_LOCK:
        planes = list(_PLANES)
    for p in planes:
        try:
            p.flush_metrics()
        except Exception:  # noqa: BLE001 — scrape must not fail here
            log.exception("kv-tiering metric flush failed")
