"""Radix-tree prefix KV cache over the paged allocator (the port's copy of
``llmq_tpu/prefixcache/radix.py``).

Finished sequences publish their page-aligned KV prefix into a radix
tree keyed on token-ID blocks, and new admissions that share a prefix —
the next turn of the same conversation, or an unrelated request with the
same system prompt — adopt the cached pages instead of re-prefilling
them.

Design:

- **One node per page-aligned block.** Each tree edge is exactly
  ``page_size`` token ids and each node owns exactly one physical KV
  page. Positions are implied by depth (block *i* covers absolute token
  positions ``[i·page_size, (i+1)·page_size)``), which is what makes a
  cached page reusable at all: RoPE bakes absolute positions into the
  cached keys, so a prefix match from the root is the only alignment at
  which sharing is sound.
- **Sharing is ref-counted, never copied.** The tree holds one
  :class:`PageAllocator` reference per cached page; every sequence whose
  block table adopts a shared page holds another (``match`` retains).
  A page returns to the pool only when its last holder lets go.
- **Copy-on-write at block granularity.** Shared pages are immutable by
  protocol: a sequence's writes always target positions at or past its
  matched length, which land in freshly-allocated blocks — divergence
  "copies" by re-prefilling the divergent tail into the sequence's own
  pages rather than mutating a shared one. The partial-block tail of a
  prefix (fewer than ``page_size`` tokens) is never published, so no
  shared page is ever half-written.
- **Eviction takes zero-ref leaves only.** A node matched by an
  in-flight sequence carries a ``lock_ref`` pin and is skipped; interior
  nodes are unreachable for eviction until their children go (children's
  pages are useless without the parent's — a match walks from the
  root). Policy is LRU by default ("lru"), insertion-order with "fifo".
- **Explicit invalidation.** ``invalidate(ids)`` walks a token stream's
  path and prunes its unlocked, childless tail — the conversation-delete
  hook. Shared ancestors (another conversation's live prefix, or any
  locked node) survive.
- **Demotion seam** (``set_demotion_callback``): an evicted leaf whose
  page is leaving the pool for good is shown to a callback as
  ``(token path, page)`` before the free, where a lower tier may capture
  it. Never for a shared page, never from ``invalidate``, and a failing
  callback does not stop the eviction.

The int8-KV path needs nothing special here: per-page quantization
scales live in pools indexed by the same page id as the KV they scale
(``models/llama.py`` ``init_kv_pages``), so sharing a page id shares
its scale rows by construction.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from llmq_tpu_torch.core.config import \
    VALID_PREFIX_EVICTION as EVICTION_POLICIES
from llmq_tpu_torch.engine.kv_allocator import PageAllocator

log = logging.getLogger("llmq_tpu_torch.prefixcache")


class RadixNode:
    __slots__ = ("key", "page", "parent", "children", "lock_ref",
                 "last_used", "created")

    def __init__(self, key: Optional[Tuple[int, ...]], page: int,
                 parent: Optional["RadixNode"], now: float,
                 seq_no: int) -> None:
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        #: In-flight pin count: matches held by admitted sequences whose
        #: block tables reference this page. Locked nodes are immune to
        #: every eviction path.
        self.lock_ref = 0
        self.last_used = now
        self.created = seq_no


@dataclass
class PrefixMatch:
    """Result of :meth:`PrefixCache.match` — the caller now holds one
    allocator reference per page and one lock per node; release both
    with :meth:`PrefixCache.unlock` (pages are released through the
    caller's normal ``allocator.free`` of its block table)."""

    length: int                      # tokens covered (page-aligned)
    pages: List[int] = field(default_factory=list)
    nodes: List[RadixNode] = field(default_factory=list)


class PrefixCache:
    """Radix tree mapping page-aligned token-ID prefixes to ref-counted
    KV pages in ``allocator``'s id space."""

    def __init__(self, allocator: PageAllocator, page_size: int, *,
                 max_pages: int = 0, policy: str = "lru",
                 clock=None) -> None:
        if policy not in EVICTION_POLICIES:
            raise ValueError(
                f"unknown prefix-cache eviction policy {policy!r}; "
                f"valid: {EVICTION_POLICIES}")
        self.allocator = allocator
        self.page_size = page_size
        #: Cap on pages held by the tree; 0 = bounded only by the pool
        #: (pool pressure evicts through :meth:`evict_pages`).
        self.max_pages = max_pages
        self.policy = policy
        self._now = clock if clock is not None else time.monotonic
        self._root = RadixNode(None, 0, None, 0.0, 0)
        self._pages = 0                  # nodes (== pages) in the tree
        self._seq = 0                    # insertion order for fifo
        self._mu = threading.RLock()
        #: The demotion seam: ``cb(token_path, page)`` for an evicted
        #: leaf whose page the tree holds the last reference of, fired
        #: before the free. None (the default): evict is free, nothing
        #: else. Never fired from :meth:`invalidate`: deleted content
        #: must not linger in a lower tier.
        self._on_demote: Optional[Callable[[List[int], int], None]] = None
        # Counters (read by engine metrics/stats):
        self.hits = 0
        self.misses = 0
        self.cached_tokens_served = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    # -- lookup --------------------------------------------------------------

    def match(self, ids: List[int]) -> PrefixMatch:
        """Longest page-aligned cached prefix of ``ids``, capped at
        ``len(ids) - 1`` tokens — at least one token is always left for
        the caller to prefill (sampling the first output token needs
        live logits). Matched pages are retained in the allocator and
        their nodes lock-pinned; the caller owns both until
        :meth:`unlock` (nodes) and its own page free (pages)."""
        ps = self.page_size
        n_blocks = max(0, (len(ids) - 1) // ps)
        m = PrefixMatch(0)
        with self._mu:
            node = self._root
            now = self._now()
            for b in range(n_blocks):
                key = tuple(ids[b * ps:(b + 1) * ps])
                child = node.children.get(key)
                if child is None:
                    break
                node = child
                m.nodes.append(node)
                m.pages.append(node.page)
            if not m.nodes:
                self.misses += 1
                return m
            self.allocator.retain(m.pages)
            for nd in m.nodes:
                nd.lock_ref += 1
                nd.last_used = now
            m.length = len(m.nodes) * ps
            self.hits += 1
            self.cached_tokens_served += m.length
        return m

    def cached_blocks(self, ids: List[int]) -> int:
        """Read-only probe: how many full page-aligned blocks of
        ``ids`` the tree currently holds, WITHOUT retaining pages or
        locking nodes (sizing heuristics, not admission)."""
        ps = self.page_size
        n = 0
        with self._mu:
            node = self._root
            for b in range(len(ids) // ps):
                child = node.children.get(tuple(ids[b * ps:(b + 1) * ps]))
                if child is None:
                    break
                node = child
                n += 1
        return n

    def unlock(self, match: Optional[PrefixMatch]) -> None:
        """Drop the in-flight pins of a match (idempotent via the
        caller clearing its reference). Page references are NOT touched
        — the sequence releases those through its normal block-table
        free."""
        if match is None or not match.nodes:
            return
        with self._mu:
            now = self._now()
            for nd in match.nodes:
                if nd.lock_ref > 0:
                    nd.lock_ref -= 1
                nd.last_used = now

    # -- publication ---------------------------------------------------------

    def insert(self, ids: List[int], pages: List[int]) -> int:
        """Publish the full-block prefix of ``ids`` (backed by ``pages``,
        the sequence's block table in order). The tree retains every page
        it newly adopts — the caller keeps its own references and frees
        them as usual, so ownership composes with conversation pinning.
        Blocks already present keep the tree's existing page (a
        concurrent duplicate prefill's page is simply not adopted; the
        caller's free reclaims it). Returns the number of pages newly
        cached."""
        ps = self.page_size
        n_blocks = min(len(ids) // ps, len(pages))
        if n_blocks <= 0:
            return 0
        added = 0
        with self._mu:
            node = self._root
            now = self._now()
            for b in range(n_blocks):
                key = tuple(ids[b * ps:(b + 1) * ps])
                child = node.children.get(key)
                if child is None:
                    page = pages[b]
                    self.allocator.retain([page])
                    self._seq += 1
                    child = RadixNode(key, page, node, now, self._seq)
                    node.children[key] = child
                    self._pages += 1
                    added += 1
                else:
                    child.last_used = now
                node = child
            self.inserted_pages += added
            if self.max_pages > 0 and self._pages > self.max_pages:
                self._evict_locked(target_nodes=self._pages - self.max_pages)
        return added

    # -- eviction ------------------------------------------------------------

    def set_demotion_callback(
            self, cb: Optional[Callable[[List[int], int], None]]) -> None:
        """Install (or clear, with None) the demotion seam. The callback
        runs under the cache lock: it must be cheap and must not call
        back into the cache."""
        with self._mu:
            self._on_demote = cb

    def _node_path(self, node: RadixNode) -> List[int]:
        """The token ids of the path root → ``node``: the content
        identity of the node's page."""
        keys: List[Tuple[int, ...]] = []
        cur: Optional[RadixNode] = node
        while cur is not None and cur.key is not None:
            keys.append(cur.key)
            cur = cur.parent
        out: List[int] = []
        for k in reversed(keys):
            out.extend(k)
        return out

    def _demote_hook(self, victim: RadixNode) -> None:
        """Fire the demotion seam for an evicted leaf whose page the tree
        holds the last reference of (a shared page is not leaving the
        pool)."""
        if self._on_demote is None:
            return
        if self.allocator.refcount(victim.page) != 1:
            return
        try:
            self._on_demote(self._node_path(victim), victim.page)
        except Exception:  # noqa: BLE001 — the seam must not break eviction
            log.exception("prefix-cache demotion callback failed")

    def _evictable(self) -> List[RadixNode]:
        out: List[RadixNode] = []
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            elif nd.lock_ref == 0:
                out.append(nd)
        return out

    def _evict_locked(self, target_nodes: int = 0,
                      target_pool_pages: int = 0) -> int:
        """Remove zero-ref leaves until ``target_nodes`` nodes are gone
        or the allocator gained ``target_pool_pages`` free pages.
        Returns pages actually returned to the pool (a released tree
        reference on a still-shared page frees nothing yet)."""
        removed = 0
        pool_freed = 0
        keyf = ((lambda nd: nd.last_used) if self.policy == "lru"
                else (lambda nd: nd.created))
        # Pool-pressure mode only takes leaves whose page the tree is
        # the LAST holder of — evicting a still-shared leaf (e.g. one a
        # conversation pin also holds) would churn cache entries for
        # zero pool gain.
        eligible = (lambda nd: self.allocator.refcount(nd.page) == 1
                    ) if target_pool_pages else (lambda nd: True)
        # ONE tree traversal per call: candidates go into a policy-keyed
        # heap; a parent that becomes an unlocked childless leaf joins
        # incrementally. (Stale entries — nodes locked or re-shared
        # after heaping — are re-checked at pop.)
        heap = [(keyf(nd), id(nd), nd) for nd in self._evictable()
                if eligible(nd)]
        heapq.heapify(heap)
        while heap:
            if target_nodes and removed >= target_nodes:
                break
            if target_pool_pages and pool_freed >= target_pool_pages:
                break
            _, _, victim = heapq.heappop(heap)
            if victim.children or victim.lock_ref > 0 or not eligible(victim):
                continue
            last_holder = self.allocator.refcount(victim.page) == 1
            assert victim.parent is not None
            self._demote_hook(victim)
            del victim.parent.children[victim.key]
            self.allocator.free([victim.page])
            self._pages -= 1
            removed += 1
            self.evicted_pages += 1
            if last_holder:
                pool_freed += 1
            parent = victim.parent
            if (parent is not self._root and not parent.children
                    and parent.lock_ref == 0 and eligible(parent)):
                heapq.heappush(heap, (keyf(parent), id(parent), parent))
        return pool_freed

    def evict_pages(self, n: int) -> int:
        """Pool-pressure hook: free up to ``n`` pages back to the pool
        by evicting unlocked leaves. Returns pages actually freed."""
        if n <= 0:
            return 0
        with self._mu:
            return self._evict_locked(target_pool_pages=n)

    def invalidate(self, ids: List[int]) -> int:
        """Prune the cached path of ``ids`` bottom-up: the deepest
        unlocked, childless nodes go; the prune stops at the first node
        that is locked or still has other children (a prefix shared with
        someone else). Conversation-delete hook. Returns nodes
        removed."""
        ps = self.page_size
        removed = 0
        with self._mu:
            node = self._root
            path: List[RadixNode] = []
            for b in range(len(ids) // ps):
                child = node.children.get(tuple(ids[b * ps:(b + 1) * ps]))
                if child is None:
                    break
                path.append(child)
                node = child
            for nd in reversed(path):
                if nd.children or nd.lock_ref > 0:
                    break
                assert nd.parent is not None
                del nd.parent.children[nd.key]
                self.allocator.free([nd.page])
                self._pages -= 1
                self.evicted_pages += 1
                removed += 1
        return removed

    def invalidate_all(self) -> int:
        """Drop every unlocked cached page (hard reset hook)."""
        with self._mu:
            before = self._pages
            while self._evict_locked(target_nodes=self._pages):
                pass
            return before - self._pages

    # -- stats ---------------------------------------------------------------

    @property
    def pages(self) -> int:
        with self._mu:
            return self._pages

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def get_stats(self) -> Dict:
        with self._mu:
            return {
                "pages": self._pages,
                "max_pages": self.max_pages,
                "policy": self.policy,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hit_rate(), 4),
                "cached_tokens_served": self.cached_tokens_served,
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages,
            }
