"""Host-side allocator for the paged KV pool (the port's copy of
``llmq_tpu/engine/kv_allocator.py``).

- **page 0 is reserved** as the null/padding page: inactive decode rows
  and padded block-table entries point at it; it is never handed out.
- free pages are a LIFO list — O(1) alloc/free, recently freed pages
  are reused first.
- allocation is all-or-nothing, so a half-admitted sequence never holds
  part of the pool.
- **ref-counted sharing** (prefix cache): a page handed out by
  :meth:`alloc` starts at refcount 1; :meth:`retain` adds holders (the
  radix prefix cache sharing one physical page across sequences) and
  :meth:`free` drops one holder — the page returns to the free list only
  when its last holder lets go. Code that never calls ``retain`` sees
  exclusive ownership.
- conversations pin their pages between turns under a name; the engine
  unpins on adoption, pin TTL or pool-pressure reclaim.
- **dp page universes** (``dp_shards`` > 1): the page-id space splits
  into ``dp_shards`` universes ``[d·P/dp, (d+1)·P/dp)`` with a free list
  each, the host half of a ``dp × tp`` mesh whose pool splits its page
  axis over ``dp``. ``alloc(n, shard=d)`` takes all ``n`` pages from
  universe ``d``; ``free`` returns each page to the universe that owns
  it; page 0 is reserved in universe 0 only. At ``dp_shards=1`` (and
  with ``shard=None``) the allocator hands out the same sequence as one
  free list.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class PageAllocator:
    def __init__(self, num_pages: int, page_size: int,
                 dp_shards: int = 1) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        dp_shards = max(1, int(dp_shards))
        if dp_shards > 1 and num_pages % dp_shards != 0:
            raise ValueError(
                f"num_pages ({num_pages}) must divide evenly into "
                f"{dp_shards} dp shards")
        self.num_pages = num_pages
        self.page_size = page_size
        self.dp_shards = dp_shards
        #: Pages per dp universe.
        self.pages_per_shard = num_pages // dp_shards
        # One LIFO free list per universe, universe 0 without page 0; at
        # one universe this is the single list in the same order.
        self._free_by_shard: List[List[int]] = []
        for d in range(dp_shards):
            lo = d * self.pages_per_shard + (1 if d == 0 else 0)
            hi = (d + 1) * self.pages_per_shard
            self._free_by_shard.append(list(range(hi - 1, lo - 1, -1)))
        self._refs: Dict[int, int] = {}        # page id → holder count
        self._pins: Dict[str, List[int]] = {}
        self._mu = threading.Lock()

    def shard_of(self, page: int) -> int:
        """The dp universe a page id belongs to (0 with one universe)."""
        return page // self.pages_per_shard

    def alloc(self, n: int,
              shard: Optional[int] = None) -> Optional[List[int]]:
        """Allocate ``n`` pages (each at refcount 1) from one universe, or
        None if it can't supply all: universe ``shard``, or with None the
        one with the most free pages."""
        if n <= 0:
            return []
        with self._mu:
            if shard is None:
                free = max(self._free_by_shard, key=len)
            else:
                if not 0 <= shard < self.dp_shards:
                    raise ValueError(f"bad dp shard {shard}")
                free = self._free_by_shard[shard]
            if len(free) < n:
                return None
            pages = [free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
        return pages

    def retain(self, pages: List[int]) -> None:
        """Add one holder to each page: the prefix cache retains a page
        per tree node, and every sequence whose block table adopts a
        shared page retains it for the duration of the match."""
        with self._mu:
            for p in pages:
                if p not in self._refs:
                    raise ValueError(f"retain of unallocated page {p}")
                self._refs[p] += 1

    def free(self, pages: List[int]) -> None:
        """Drop one holder per page; a page whose last holder left returns
        to the free list. Holders never write a page whose refcount
        exceeds their own share: they allocate a fresh page instead."""
        with self._mu:
            for p in pages:
                if p <= 0 or p >= self.num_pages:
                    raise ValueError(f"bad page id {p}")
                refs = self._refs.get(p)
                if refs is None:
                    raise ValueError(f"double free of page {p}")
                if refs > 1:
                    self._refs[p] = refs - 1
                else:
                    del self._refs[p]
                    self._free_by_shard[p // self.pages_per_shard].append(p)

    def refcount(self, page: int) -> int:
        """Current holder count (0 = free)."""
        with self._mu:
            return self._refs.get(page, 0)

    def pin(self, key: str, pages: List[int]) -> None:
        """Record ``pages`` as pinned for ``key`` (a conversation id).
        Pinned pages stay owned by the caller; this is accounting."""
        with self._mu:
            self._pins[key] = list(pages)

    def unpin(self, key: str) -> List[int]:
        with self._mu:
            return self._pins.pop(key, [])

    def pinned_pages(self) -> int:
        with self._mu:
            return sum(len(p) for p in self._pins.values())

    @property
    def total(self) -> int:
        """Allocatable pages (excludes reserved page 0)."""
        return self.num_pages - 1

    def available(self, shard: Optional[int] = None) -> int:
        with self._mu:
            if shard is not None:
                return len(self._free_by_shard[shard])
            return sum(len(f) for f in self._free_by_shard)

    def available_by_shard(self) -> List[int]:
        """Free pages per dp universe (one entry with one universe)."""
        with self._mu:
            return [len(f) for f in self._free_by_shard]

    def used(self) -> int:
        return self.total - self.available()

    def shared_pages(self) -> int:
        """Pages with more than one holder (prefix-cache sharing)."""
        with self._mu:
            return sum(1 for r in self._refs.values() if r > 1)

    def fragmentation(self) -> float:
        """External fragmentation of the free page-id space:
        1 − (largest contiguous free run / free pages); 0 when the free
        list is empty or one run. Paged attention needs no contiguity:
        this is an observability signal of how interleaved the live
        working set has become (read at scrapes; the sort runs outside
        the lock so alloc/free never wait behind it)."""
        with self._mu:
            free = [p for f in self._free_by_shard for p in f]
        free.sort()
        if not free:
            return 0.0
        best = run = 1
        for a, b in zip(free, free[1:]):
            run = run + 1 if b == a + 1 else 1
            if run > best:
                best = run
        return round(1.0 - best / len(free), 4)

    @staticmethod
    def pages_for(tokens: int, page_size: int) -> int:
        """Pages needed to hold ``tokens`` positions."""
        return -(-tokens // page_size)
