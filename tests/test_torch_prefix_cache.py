"""The port's prefix cache against the JAX package on the CPU.

- The allocator's reference counts (``retain``, ``free`` that frees at
  zero, ``refcount``, ``shared_pages``) against
  ``llmq_tpu.engine.kv_allocator.PageAllocator`` under the same seeded
  script of operations: every result and every count equal, errors
  raised by both.
- The radix tree against ``llmq_tpu.prefixcache.radix.PrefixCache``:
  hypothesis sequences of ``match``, ``insert``, ``unlock``,
  ``evict_pages``, ``invalidate`` and ``cached_blocks`` over token
  streams that share prefixes, each side over its own allocator with the
  same clock: the same match lengths and pages, the same return values,
  stats and pool counts.
- The port's engine against the JAX engine with the prefix cache (and
  the async pipeline) on, over requests that share a page-aligned prefix,
  one after another and together, plus a two-turn conversation and a
  deleted conversation; with mixed batching off ("bucket"), on ("mixed")
  and ragged. Greedy streams (f32 weights, exact), ``cached_tokens`` per
  request, admission hits and misses and the pages in use once idle are
  equal; a shared page's reference count is above one while two
  sequences read it.
"""

import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.core.config import AsyncPipelineConfig as JPipe  # noqa: E402
from llmq_tpu.core.config import MixedBatchConfig as JMixed  # noqa: E402
from llmq_tpu.core.config import PrefixCacheConfig as JPrefix  # noqa: E402
from llmq_tpu.core.types import Priority as JPriority  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.kv_allocator import PageAllocator as JAlloc  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.prefixcache.radix import PrefixCache as JPrefixCache  # noqa: E402

from llmq_tpu_torch.core.config import (AsyncPipelineConfig,  # noqa: E402
                                        MixedBatchConfig, PrefixCacheConfig)
from llmq_tpu_torch.core.types import Priority  # noqa: E402
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.kv_allocator import PageAllocator  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.prefixcache import PrefixCache  # noqa: E402

torch.set_num_threads(1)


# -- the allocator ------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("error", type(e).__name__)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_refcounts_match_jax(seed):
    """300 seeded operations (alloc, retain of held pages, free, a double
    free, a retain of a free page, pin and unpin) on both allocators:
    every return value, error, ``refcount`` of every page,
    ``shared_pages``, ``available`` and ``used`` equal after each."""
    rng = np.random.default_rng(seed)
    port, ref = PageAllocator(24, 16), JAlloc(24, 16)
    held = []       # one entry per reference the script holds
    for _ in range(300):
        op = rng.integers(0, 6)
        if op == 0:
            n = int(rng.integers(0, 6))
            a, b = port.alloc(n), ref.alloc(n)
            assert a == b
            held.extend(a or [])
        elif op == 1 and held:
            pages = [held[i] for i in rng.integers(0, len(held), 2)]
            assert _outcome(port.retain, pages) == _outcome(ref.retain,
                                                            pages)
            held.extend(pages)
        elif op == 2 and held:
            i = int(rng.integers(0, len(held)))
            page = held.pop(i)
            assert _outcome(port.free, [page]) == _outcome(ref.free, [page])
        elif op == 3:
            free = [p for p in range(1, 24) if ref.refcount(p) == 0]
            if free:
                page = free[int(rng.integers(0, len(free)))]
                assert _outcome(port.free, [page]) == \
                    _outcome(ref.free, [page]) == ("error", "ValueError")
                assert _outcome(port.retain, [page]) == \
                    _outcome(ref.retain, [page]) == ("error", "ValueError")
        elif op == 4 and held:
            key = f"c{int(rng.integers(0, 3))}"
            port.pin(key, held[:3])
            ref.pin(key, held[:3])
        elif op == 5:
            key = f"c{int(rng.integers(0, 3))}"
            assert port.unpin(key) == ref.unpin(key)
        assert [port.refcount(p) for p in range(24)] == \
            [ref.refcount(p) for p in range(24)]
        assert port.shared_pages() == ref.shared_pages()
        assert port.available() == ref.available()
        assert port.used() == ref.used()
        assert port.pinned_pages() == ref.pinned_pages()
    assert port.shared_pages() > 0


# -- the radix tree -----------------------------------------------------------

PS = 4
_ROOTS = [[3, 4, 5, 6, 7, 8, 9, 10], [3, 4, 5, 6, 11, 12, 13, 14],
          [20, 21, 22, 23, 24, 25, 26, 27]]


def _stream(i: int, n: int):
    """Token stream ``i`` (streams 0 and 1 share their first page, 3 and
    4 extend stream 0 and 2), cut to ``n`` tokens."""
    base = _ROOTS[i % 3] + [40 + i] * 4 + list(range(50 + 8 * i, 58 + 8 * i))
    return base[:n]


_OPS = st.lists(st.one_of(
    st.tuples(st.just("insert"), st.integers(0, 4), st.integers(1, 20)),
    st.tuples(st.just("match"), st.integers(0, 4), st.integers(1, 20)),
    st.tuples(st.just("unlock"), st.integers(0, 7)),
    st.tuples(st.just("evict"), st.integers(0, 6)),
    st.tuples(st.just("invalidate"), st.integers(0, 4), st.integers(1, 20)),
    st.tuples(st.just("probe"), st.integers(0, 4), st.integers(1, 20))),
    max_size=40)


class _Side:
    """One package's tree over its own allocator, driven by the script:
    an insert allocates the stream's pages, publishes them and drops its
    own references (a finished sequence); a match is held until
    unlocked, as an admitted sequence holds it."""

    def __init__(self, alloc_cls, cache_cls, **kw) -> None:
        self.alloc = alloc_cls(20, PS)
        self.cache = cache_cls(self.alloc, PS, clock=_clock(), **kw)
        self.held = []

    def run(self, op):
        kind = op[0]
        if kind == "insert":
            ids = _stream(op[1], op[2])
            pages = self.alloc.alloc(max(1, len(ids) // PS))
            if pages is None:
                return None
            added = self.cache.insert(ids, pages)
            self.alloc.free(pages)
            return added
        if kind == "match":
            m = self.cache.match(_stream(op[1], op[2]))
            if m.nodes:
                self.held.append(m)
            return (m.length, list(m.pages))
        if kind == "unlock":
            if not self.held:
                return None
            m = self.held.pop(op[1] % len(self.held))
            self.cache.unlock(m)
            self.alloc.free(m.pages)
            return len(m.pages)
        if kind == "evict":
            return self.cache.evict_pages(op[1])
        if kind == "invalidate":
            return self.cache.invalidate(_stream(op[1], op[2]))
        return self.cache.cached_blocks(_stream(op[1], op[2]))


def _clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


@pytest.mark.parametrize("policy", ["lru", "fifo"])
@pytest.mark.parametrize("max_pages", [0, 5])
@settings(max_examples=40, deadline=None)
@given(ops=_OPS)
def test_radix_tree_matches_jax(policy, max_pages, ops):
    """Tolerance: none. Each operation returns the same value on both
    trees (match lengths and pages included), and after each the stats,
    the pool's counts and every page's reference count agree."""
    port = _Side(PageAllocator, PrefixCache, max_pages=max_pages,
                 policy=policy)
    ref = _Side(JAlloc, JPrefixCache, max_pages=max_pages, policy=policy)
    for op in ops + [("unlock", 0)] * 8 + [("evict", 20)]:
        assert port.run(op) == ref.run(op), op
        assert port.cache.get_stats() == ref.cache.get_stats(), op
        assert port.alloc.available() == ref.alloc.available(), op
        assert [port.alloc.refcount(p) for p in range(20)] == \
            [ref.alloc.refcount(p) for p in range(20)], op
    # Every match released and every evictable leaf gone: nothing held.
    assert port.cache.pages == ref.cache.pages == 0
    assert port.alloc.used() == ref.alloc.used() == 0


def test_invalidate_all_and_a_locked_path_match_jax():
    """``invalidate_all`` drops every unlocked page and spares a locked
    path, on both trees alike."""
    sides = [_Side(PageAllocator, PrefixCache), _Side(JAlloc, JPrefixCache)]
    for op in [("insert", 0, 16), ("insert", 1, 16), ("insert", 2, 12),
               ("match", 0, 13)]:
        assert sides[0].run(op) == sides[1].run(op)
    assert sides[0].cache.invalidate_all() == sides[1].cache.invalidate_all()
    assert sides[0].cache.pages == sides[1].cache.pages == 3
    assert sides[0].alloc.shared_pages() == sides[1].alloc.shared_pages() == 3


# -- the engine ---------------------------------------------------------------

KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512)
GEOM = dict(batch_size=4, page_size=16, num_pages=64, prefill_buckets=[16, 32],
            eos_id=2, chunk_size=4, mixed_prefill_slices=2,
            mixed_slice_tokens=8, ragged_token_capacity=16,
            ragged_max_slices=2)
MAX_STEPS = 10
#: A 32-token system prompt: two whole pages.
SYSTEM = "You are the queue's kind robot. "
assert len(SYSTEM) == 32
TAILS = ["Say hi.", "What is a page?", "Name a priority tier.",
         "Count to three.", "Why cache a prefix?"]


@pytest.fixture(scope="module")
def models():
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _mixed(mode):
    return dict(enabled=mode != "bucket", prefill_token_budget=16,
                max_slices=2)


def _workload(eng, make_req, prio_of):
    """Two requests sharing SYSTEM one after another (the second hits),
    three together (a wave; all hit), a two-turn conversation that
    starts with SYSTEM, then the conversation deleted and a last shared
    request. Returns ({id: result}, the peak of shared pages)."""
    hs, shared = {}, [0]

    def run(ids):
        for rid in ids:
            hs[rid] = eng.submit(make_req(rid, *REQS[rid], prio_of))
        while True:
            busy = eng.step()
            shared[0] = max(shared[0], eng.allocator.shared_pages())
            if not busy and all(hs[r].done for r in ids):
                break
        eng.run_until_idle()

    run(["s0"])
    run(["s1"])
    run(["w0", "w1", "w2"])
    run(["c0"])
    run(["c1"])
    eng.drop_conversation("conv")
    run(["s2"])
    return {rid: h.result for rid, h in hs.items()}, shared[0]


REQS = {
    "s0": (SYSTEM + TAILS[0], "", "normal"),
    "s1": (SYSTEM + TAILS[1], "", "normal"),
    "w0": (SYSTEM + TAILS[2], "", "high"),
    "w1": (SYSTEM + TAILS[3], "", "low"),
    "w2": (SYSTEM + TAILS[4] * 3, "", "normal"),
    "c0": (SYSTEM + "Start a chat.", "conv", "high"),
    "c1": (" And go on.", "conv", "high"),
    "s2": (SYSTEM + TAILS[0], "", "normal"),
}


@pytest.fixture(scope="module")
def jax_runs(models):
    jcfg, jparams, _, _ = models
    runs = {}
    for mode in ("bucket", "mixed", "ragged"):
        eng = JEngine(JaxExecutor(jcfg, jparams, prefill_batch=4,
                                  ragged_attention=mode == "ragged", **GEOM),
                      JTok(), enable_metrics=False,
                      max_decode_steps=MAX_STEPS,
                      mixed_batch=JMixed(**_mixed(mode)),
                      prefix_cache=JPrefix(enabled=True),
                      async_pipeline=JPipe())
        res, shared = _workload(
            eng, lambda rid, text, conv, prio, p: JGenRequest(
                id=rid, prompt=text, priority=p(prio),
                conversation_id=conv, max_new_tokens=6),
            JPriority.from_name)
        runs[mode] = (res, shared, eng.prefix_hits, eng.prefix_misses,
                      eng.allocator.used(), eng.get_stats()["prefix_cache"])
        eng.stop()
    return runs


@pytest.mark.parametrize("mode", ["bucket", "mixed", "ragged"])
def test_engine_prefix_reuse_matches_jax(models, jax_runs, mode):
    """Tolerance: none (f32 weights, greedy). Streams, finish reasons and
    ``cached_tokens`` per request, admission hits and misses, the tree's
    page count and the pages in use once idle equal the JAX engine's;
    every request after the first that shares SYSTEM reports its 32
    tokens cached, and pages were shared while they ran."""
    _, _, tcfg, tparams = models
    eng = InferenceEngine(
        TorchExecutor(tcfg, tparams, device="cpu", prefill_batch=4,
                      ragged_attention=mode == "ragged", **GEOM),
        ByteTokenizer(), max_decode_steps=MAX_STEPS,
        mixed_batch=MixedBatchConfig(**_mixed(mode)),
        prefix_cache=PrefixCacheConfig(enabled=True),
        async_pipeline=AsyncPipelineConfig())
    res, shared = _workload(
        eng, lambda rid, text, conv, prio, p: GenRequest(
            id=rid, prompt=text, priority=p(prio), conversation_id=conv,
            max_new_tokens=6),
        Priority.from_name)
    jres, jshared, jhits, jmisses, jused, jpc = jax_runs[mode]
    for rid in REQS:
        assert res[rid].tokens == jres[rid].tokens, rid
        assert res[rid].finish_reason == jres[rid].finish_reason, rid
        assert res[rid].cached_tokens == jres[rid].cached_tokens, rid
    assert [res[r].cached_tokens for r in ("s0", "s1", "w0", "w1", "w2")] \
        == [0, 32, 32, 32, 32]
    assert res["c1"].cached_tokens > 32      # the conversation's own pin
    assert (eng.prefix_hits, eng.prefix_misses) == (jhits, jmisses)
    assert eng.allocator.used() == jused
    pc = eng.get_stats()["prefix_cache"]
    for key in ("pages", "hits", "misses", "cached_tokens_served",
                "inserted_pages", "evicted_pages", "admission_hits",
                "admission_misses", "cached_prefill_tokens"):
        assert pc[key] == jpc[key], key
    assert shared == jshared > 0
    eng.stop()


def test_pool_pressure_evicts_zero_ref_leaves_first(models):
    """A pool too small for a new prompt while the tree holds idle pages:
    zero-ref leaves are evicted (no pinned conversation is reclaimed),
    the request completes, and the tree shrinks."""
    _, _, tcfg, tparams = models
    geom = dict(GEOM, num_pages=9)
    eng = InferenceEngine(
        TorchExecutor(tcfg, tparams, device="cpu", **geom), ByteTokenizer(),
        max_decode_steps=4, prefix_cache=PrefixCacheConfig(enabled=True))
    h = eng.submit(GenRequest(id="a", prompt="y" * 70, max_new_tokens=2))
    eng.run_until_idle()
    before = eng.get_stats()["prefix_cache"]["pages"]
    assert h.result.finish_reason == "length" and before == 4
    assert eng.allocator.available() == 8 - before
    h = eng.submit(GenRequest(id="b", prompt="z" * 100, max_new_tokens=2))
    eng.run_until_idle()
    assert h.result.finish_reason == "length"
    assert eng.get_stats()["prefix_cache"]["evicted_pages"] > 0
    eng.stop()
