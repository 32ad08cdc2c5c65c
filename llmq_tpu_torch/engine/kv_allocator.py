"""Host-side allocator for the paged KV pool (the port's copy of
``llmq_tpu/engine/kv_allocator.py`` at one page universe).

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
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class PageAllocator:
    def __init__(self, num_pages: int, page_size: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}        # page id → holder count
        self._pins: Dict[str, List[int]] = {}
        self._mu = threading.Lock()

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages (each at refcount 1), or None if the pool
        can't supply all."""
        if n <= 0:
            return []
        with self._mu:
            if len(self._free) < n:
                return None
            pages = [self._free.pop() for _ in range(n)]
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
                    self._free.append(p)

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

    def available(self) -> int:
        with self._mu:
            return len(self._free)

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
            free = list(self._free)
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
