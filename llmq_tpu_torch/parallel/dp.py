"""dp page universes on the device: each dp replica's local pool, its
guest pages, and the host traffic between replicas (the port's
counterpart of what GSPMD does for JAX's dp-sharded pool,
``llmq_tpu/engine/executor.py`` ``dp_shards``).

JAX splits the pool's page axis over ``dp``: replica d holds the page
universe ``[d·P/dp, (d+1)·P/dp)`` and GSPMD moves whatever a program of
one replica reads from another. A port rank holds its shard explicitly,
so this module makes those moves itself, between programs, on the host:

- **The local pool.** Replica d's pool holds ``1 + P/dp + G`` pages: slot
  0 is its null page (page 0 maps there on every rank: inactive rows and
  padding write there, as they write page 0 on one device), slots
  ``1 .. P/dp`` its universe (page ``g`` at ``1 + g - d·P/dp``), and the
  last G slots its **guest** pages. The allocator stays JAX's: page 0 is
  reserved in universe 0 only, whose slot 1 is then never written.
- **Guests.** A row may hold pages of another universe (the allocator's
  cross-universe fallback, a sequence adopted into another universe's
  slot, radix pages shared across rows). Before a program every rank
  plans, from the same descriptor, the foreign pages each replica's
  rows and prefills touch, and each page's home replica sends its
  payload into a guest slot of the reader (:meth:`DpPlane.pull`). After
  the program every guest page it can write goes home
  (:meth:`DpPlane.push`; a row's pages before its position and a
  prefill's pages outside its range are read only): the home copy is
  always current, and a guest lives one program. G is the most foreign
  pages one program of a replica can touch, so nothing JAX serves is
  refused.
- **Results.** The driver (rank 0, replica 0) runs the engine; each other
  replica's first tp rank sends its rows' results to it over the
  ``results`` group from a sender thread (which waits for a chunk's copy
  while the rank dispatches on), and a receiver thread on the driver
  files them by call (:meth:`DpPlane.publish`, :meth:`DpPlane.take`). A
  replica sends only what the driver takes; what a dropped handle would
  have taken is discarded (:meth:`DpPlane.expect`).

Pages and tokens move between ranks with the same tp coordinate (each
its own head shard) over the mesh's gloo ``dp_group``, in one order that
every rank derives from the descriptor, so sends and receives always
pair up."""

from __future__ import annotations

import logging
import pickle
import queue
import threading
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Set

import numpy as np
import torch

log = logging.getLogger("llmq_tpu_torch.dp")


def guest_slots(dp: int, num_pages: int, rows: int,
                max_pages_per_seq: int) -> int:
    """Guest slots a replica needs so that no program is refused: the
    most foreign pages ``rows`` sequences of a program can touch (each up
    to ``max_pages_per_seq``), at most every other universe's pages."""
    return min((dp - 1) * (num_pages // dp), rows * max_pages_per_seq)


def page_bytes(cache: Dict[str, torch.Tensor]) -> int:
    """Bytes of one page of ``cache``, every leaf."""
    return sum(t[:, 0].numel() * t.element_size() for t in cache.values())


def leaf_views(cache: Dict[str, torch.Tensor], packed: torch.Tensor):
    """``(name, pool, view)`` per leaf in sorted order (JAX's
    ``jax.tree.leaves``): the leaf's ``(N, L, ...)`` slice of a page-major
    ``(N, page bytes)`` uint8 buffer."""
    n, offs = packed.shape[0], 0
    for name in sorted(cache):
        pool = cache[name]
        rest = tuple(pool.shape[2:])
        per = pool.shape[0] * int(np.prod(rest)) * pool.element_size()
        view = packed[:, offs:offs + per].view(pool.dtype).view(
            (n, pool.shape[0]) + rest)
        yield name, pool, view
        offs += per


def gather(cache: Dict[str, torch.Tensor], slots: Sequence[int]
           ) -> torch.Tensor:
    """The pages at local ``slots``, page-major, as a host uint8 tensor
    (waits for the device work queued before it)."""
    dev = next(iter(cache.values())).device
    idx = torch.tensor(list(slots), dtype=torch.int64, device=dev)
    packed = torch.empty((len(slots), page_bytes(cache)), dtype=torch.uint8,
                         device=dev)
    for _name, pool, view in leaf_views(cache, packed):
        view.copy_(pool.index_select(1, idx).transpose(0, 1))
    return packed.cpu()


def scatter(cache: Dict[str, torch.Tensor], slots: Sequence[int],
            packed: torch.Tensor) -> None:
    """Write a page-major buffer into the pool at local ``slots``, in
    place (queued on the current stream)."""
    dev = next(iter(cache.values())).device
    idx = torch.tensor(list(slots), dtype=torch.int64, device=dev)
    packed = packed.to(dev)
    for _name, pool, view in leaf_views(cache, packed):
        pool.index_copy_(1, idx, view.transpose(0, 1))


class DpPlane:
    """Replica ``mesh.dp_rank``'s view of the dp universes: the local
    pool's geometry, the plan of a program's guests, the moves, and (on
    the driver) the mailbox of the other replicas' results."""

    def __init__(self, mesh, num_pages: int, batch_size: int,
                 max_pages_per_seq: int, guest_rows: int) -> None:
        self.mesh = mesh
        self.dp = mesh.dp
        self.d = mesh.dp_rank
        self.t = mesh.tp_rank
        #: Pages of a universe and rows of a replica.
        self.per = num_pages // self.dp
        self.rows = batch_size // self.dp
        self.row0 = self.d * self.rows
        #: Guest slots, after the null page and the universe.
        self.guests = guest_slots(self.dp, num_pages, guest_rows,
                                  max_pages_per_seq)
        self.local_pages = 1 + self.per + self.guests
        self.guest0 = 1 + self.per
        #: Calls that returned results so far (alike on every rank).
        self.seq = 0
        #: Page moves (one a replica pair and direction of a program),
        #: the pages moved in and out, their bytes and seconds (this
        #: rank's side).
        self.moves = {"count": 0, "pages_in": 0, "pages_out": 0,
                      "bytes": 0, "seconds": 0.0}
        #: The driver's results by (call, replica); the calls whose
        #: handles may still take theirs (call → replicas); results of
        #: dropped handles still to arrive, discarded when they do.
        self._box: Dict[tuple, object] = {}
        self._open: Dict[int, List[int]] = {}
        self._gone: Set[tuple] = set()
        self._cv = threading.Condition()
        self._dead: Optional[BaseException] = None
        self._rx: Optional[threading.Thread] = None
        self._tx: Optional[threading.Thread] = None
        if mesh.is_driver and self.dp > 1:
            self._rx = threading.Thread(target=self._receive,
                                        name="dp-results", daemon=True)
            self._rx.start()
        self._outbox: "queue.Queue" = queue.Queue()

    # -- geometry ------------------------------------------------------------

    def universe(self, page: int) -> int:
        return min(int(page) // self.per, self.dp - 1)

    def home_slot(self, page: int) -> int:
        """A page's slot in its home replica's pool (page 0: the null
        slot)."""
        page = int(page)
        if page == 0:
            return 0
        return 1 + page - self.universe(page) * self.per

    def replica_of_row(self, row: int) -> int:
        return int(row) // self.rows

    def rank_of(self, d: int, t: Optional[int] = None) -> int:
        """The global rank of replica ``d``'s tp rank ``t`` (this rank's
        tp coordinate by default)."""
        return self.mesh.rank_of(dp=d, tp=self.t if t is None else t)

    # -- the plan ------------------------------------------------------------

    def plan(self, tables: List[List[np.ndarray]]) -> List[Dict[int, int]]:
        """Per replica, its foreign pages → guest slots: every nonzero
        page of its ``tables`` outside its universe, in page order.
        Raises if a replica needs more guests than it has (which the
        sizing rules out)."""
        out = []
        for d, ts in enumerate(tables):
            pages = set()
            for t in ts:
                a = np.asarray(t).ravel()
                a = a[a != 0]
                pages.update(int(p) for p in a
                             if min(int(p) // self.per, self.dp - 1) != d)
            pages = sorted(pages)
            if len(pages) > self.guests:
                raise RuntimeError(f"replica {d} needs {len(pages)} guest "
                                   f"pages, has {self.guests}")
            out.append({p: self.guest0 + i for i, p in enumerate(pages)})
        return out

    def translate(self, table: np.ndarray, guests: Dict[int, int]
                  ) -> np.ndarray:
        """A global block table (any shape) in this replica's local slots:
        page 0 → the null slot, its universe → its slots, a foreign page →
        its guest slot."""
        t = np.asarray(table)
        out = np.zeros(t.shape, np.int32)
        u = np.minimum(t // self.per, self.dp - 1)
        own = (u == self.d) & (t != 0)
        out[own] = t[own] - self.d * self.per + 1
        foreign = (u != self.d) & (t != 0)
        if foreign.any():
            out[foreign] = [guests[int(p)] for p in t[foreign]]
        return out

    # -- moves ---------------------------------------------------------------

    def _pairs(self, plan: List[Dict[int, int]],
               only: Optional[Set[int]] = None):
        """(reader d, home e, pages) of every move of ``plan`` (with
        ``only``, of those pages alone), in one order on every rank."""
        for d, guests in enumerate(plan):
            for e in range(self.dp):
                if e == d:
                    continue
                pages = [p for p in guests if self.universe(p) == e
                         and (only is None or p in only)]
                if pages:
                    yield d, e, pages

    def pull(self, cache: Dict[str, torch.Tensor],
             plan: List[Dict[int, int]]) -> None:
        """Each guest page from its home replica into the reader's guest
        slot."""
        self._move(cache, plan, inward=True)

    def push(self, cache: Dict[str, torch.Tensor],
             plan: List[Dict[int, int]], written: Set[int]) -> None:
        """Each guest page of ``written`` (the pages the program could
        write, alike on every rank) back from the reader to its home
        replica, after the program."""
        self._move(cache, plan, inward=False, only=written)

    def _move(self, cache, plan, inward: bool,
              only: Optional[Set[int]] = None) -> None:
        import time

        import torch.distributed as dist

        group = self.mesh.dp_group
        nbytes = page_bytes(cache)
        for d, e, pages in self._pairs(plan, only):
            src, dst = (e, d) if inward else (d, e)
            if self.d not in (src, dst):
                continue
            t0 = time.perf_counter()
            home = [self.home_slot(p) for p in pages]
            guest = [plan[d][p] for p in pages]
            if self.d == src:
                buf = gather(cache, home if inward else guest)
                dist.send(buf, dst=self.rank_of(dst), group=group)
            else:
                buf = torch.empty((len(pages), nbytes), dtype=torch.uint8)
                dist.recv(buf, src=self.rank_of(src), group=group)
                scatter(cache, guest if inward else home, buf)
            self.moves["count"] += 1
            self.moves["pages_in" if inward else "pages_out"] += len(pages)
            self.moves["bytes"] += len(pages) * nbytes
            self.moves["seconds"] += time.perf_counter() - t0

    def move_token(self, value, src: int, dst: int) -> Optional[int]:
        """A prefill's sampled token from replica ``src`` (``value()``
        reads it there) to replica ``dst``, which gets it back."""
        import torch.distributed as dist

        group = self.mesh.dp_group
        if self.d == src:
            dist.send(torch.tensor([int(value())], dtype=torch.int64),
                      dst=self.rank_of(dst), group=group)
        elif self.d == dst:
            box = torch.zeros(1, dtype=torch.int64)
            dist.recv(box, src=self.rank_of(src), group=group)
            return int(box[0])
        return None

    def any(self, flag: bool) -> bool:
        """Whether any replica's ``flag`` is set (every rank the same
        answer: a K-step loop's exit is decided on the gathered state)."""
        import torch.distributed as dist

        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.dp_group)
        return bool(t[0])

    # -- results -------------------------------------------------------------

    def next_seq(self) -> int:
        self.seq += 1
        return self.seq

    @property
    def publisher(self) -> bool:
        """Whether this rank sends its replica's results to the driver
        (the first tp rank of every replica but the driver's)."""
        return self.d > 0 and self.t == 0

    def publish(self, seq: int, payload) -> None:
        """Send this replica's results of call ``seq`` to the driver:
        an array, or a function that returns it (called on the sender
        thread, so a wait for the program's copy holds up no dispatch).
        Sent in call order."""
        if self._tx is None:
            self._tx = threading.Thread(target=self._send,
                                        name="dp-publish", daemon=True)
            self._tx.start()
        self._outbox.put((seq, payload))

    def _send(self) -> None:
        """A publisher's sender: each queued result to the driver, until
        the goodbye (call -1) has gone."""
        import torch.distributed as dist

        while True:
            seq, payload = self._outbox.get()
            try:
                value = payload() if callable(payload) else payload
                data = pickle.dumps((seq, self.d, value))
                buf = torch.frombuffer(bytearray(data), dtype=torch.uint8)
                dst = self.mesh.ranks[0]
                dist.send(torch.tensor([buf.numel()], dtype=torch.int64),
                          dst=dst, group=self.mesh.results)
                dist.send(buf, dst=dst, group=self.mesh.results)
            except Exception:  # noqa: BLE001 — the driver times out
                log.exception("dp results of call %d not sent", seq)
                return
            if seq < 0:
                return

    def bye(self, timeout: float = 10.0) -> None:
        """A publisher's last message, after every queued result: its
        driver's receiver may stop."""
        if self.publisher:
            self.publish(-1, None)
            self._tx.join(timeout)

    def close(self, timeout: float = 10.0) -> None:
        """The driver's end: wait (bounded) for the receiver to take every
        publisher's last message, so no thread is left inside a
        collective when the process exits."""
        if self._rx is not None:
            self._rx.join(timeout)

    def _receive(self) -> None:
        """The driver's receiver: file each replica's results by (call,
        replica), or discard them if their handle was dropped, until every
        publisher said goodbye or the group broke."""
        import torch.distributed as dist

        left = self.dp - 1
        try:
            while left:
                n = torch.zeros(1, dtype=torch.int64)
                src = dist.recv(n, group=self.mesh.results)
                buf = torch.empty(int(n[0]), dtype=torch.uint8)
                dist.recv(buf, src=src, group=self.mesh.results)
                seq, d, payload = pickle.loads(buf.numpy().tobytes())
                if seq < 0:
                    left -= 1
                    continue
                with self._cv:
                    if (seq, d) in self._gone:
                        self._gone.discard((seq, d))
                        continue
                    self._box[(seq, d)] = payload
                    self._cv.notify_all()
        except Exception as e:  # noqa: BLE001 — raised at the next take
            with self._cv:
                self._dead = e
                self._cv.notify_all()

    def expect(self, seq: int, replicas: Iterable[int], holder) -> None:
        """On the driver: call ``seq``'s results from ``replicas`` belong
        to ``holder`` (a handle, or the function its handles take them
        through). If it is dropped untaken, they are discarded."""
        with self._cv:
            self._open[seq] = list(replicas)
        weakref.finalize(holder, self._abandon, seq)

    def _abandon(self, seq: int) -> None:
        with self._cv:
            for e in self._open.pop(seq, ()):
                if self._box.pop((seq, e), None) is None:
                    self._gone.add((seq, e))

    def ready(self, seq: int) -> bool:
        with self._cv:
            return all((seq, e) in self._box for e in range(1, self.dp))

    def take(self, seq: int, replicas: Optional[Iterable[int]] = None,
             timeout: Optional[float] = None) -> Dict:
        """The results of call ``seq`` from ``replicas`` (default: every
        other replica), replica → payload, waiting for them."""
        want = list(range(1, self.dp) if replicas is None else replicas)
        wait = self.mesh.timeout_s if timeout is None else timeout
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._dead is not None or all(
                    (seq, e) in self._box for e in want), timeout=wait)
            if not all((seq, e) in self._box for e in want):
                if self._dead is not None:
                    raise RuntimeError(f"dp results lost: {self._dead}")
                if not ok:
                    raise TimeoutError(f"dp results of call {seq} did not "
                                       f"arrive in {wait:.0f} s")
            self._open.pop(seq, None)
            return {e: self._box.pop((seq, e)) for e in want}
