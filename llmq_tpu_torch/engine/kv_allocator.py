"""Host-side allocator for the paged KV pool (the port's copy of
``llmq_tpu/engine/kv_allocator.py`` at one page universe).

- **page 0 is reserved** as the null/padding page: inactive decode rows
  and padded block-table entries point at it; it is never handed out.
- free pages are a LIFO list — O(1) alloc/free, recently freed pages
  are reused first.
- allocation is all-or-nothing, so a half-admitted sequence never holds
  part of the pool.
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
        self._used: set = set()
        self._pins: Dict[str, List[int]] = {}
        self._mu = threading.Lock()

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, or None if the pool can't supply all."""
        if n <= 0:
            return []
        with self._mu:
            if len(self._free) < n:
                return None
            pages = [self._free.pop() for _ in range(n)]
            self._used.update(pages)
        return pages

    def free(self, pages: List[int]) -> None:
        with self._mu:
            for p in pages:
                if p <= 0 or p >= self.num_pages:
                    raise ValueError(f"bad page id {p}")
                if p not in self._used:
                    raise ValueError(f"double free of page {p}")
                self._used.discard(p)
                self._free.append(p)

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

    @staticmethod
    def pages_for(tokens: int, page_size: int) -> int:
        """Pages needed to hold ``tokens`` positions."""
        return -(-tokens // page_size)
