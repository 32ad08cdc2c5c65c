"""The port's conversation service against the JAX package's: the state
manager over the memory, sqlite (in ``tmp_path``) and redis stores (the
redis one over an in-memory protocol double), driven through the same
script on fake clocks from the same start; then the engine's KV-pin
hooks: a touch refreshes the pin, and every eviction path of the state
manager (delete, idle cleanup, the per-user cap) frees the
conversation's pinned pages."""

import types

import pytest
import torch

from llmq_tpu.conversation import persistence as jpersist
from llmq_tpu.conversation.state_manager import StateManager as JStateManager
from llmq_tpu.core.clock import FakeClock
from llmq_tpu.core.config import ConversationConfig as JConvConfig
from llmq_tpu.core import types as jtypes

from llmq_tpu_torch.conversation import persistence as tpersist
from llmq_tpu_torch.conversation.state_manager import StateManager
from llmq_tpu_torch.core.config import ConversationConfig
from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine
from llmq_tpu_torch.engine.executor import TorchExecutor
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.models import llama as T
from llmq_tpu_torch.core.config import PrefixCacheConfig

torch.set_num_threads(1)


class _Pipeline:
    def __init__(self, r):
        self._r, self._ops = r, []

    def __getattr__(self, name):
        def op(*a, **kw):
            self._ops.append((name, a, kw))
            return self
        return op

    def execute(self):
        for name, a, kw in self._ops:
            getattr(self._r, name)(*a, **kw)
        self._ops = []


class _FakeRedis:
    """The redis calls RedisStore makes; values come back as bytes."""

    def __init__(self):
        self.kv, self.sets, self.ttls = {}, {}, {}

    def set(self, k, v, ex=None):
        self.kv[k] = v.encode() if isinstance(v, str) else v
        if ex is not None:
            self.ttls[k] = ex

    def get(self, k):
        return self.kv.get(k)

    def delete(self, k):
        self.kv.pop(k, None)
        self.sets.pop(k, None)

    def sadd(self, k, *members):
        self.sets.setdefault(k, set()).update(
            m.encode() if isinstance(m, str) else m for m in members)

    def smembers(self, k):
        return set(self.sets.get(k, set()))

    def srem(self, k, *members):
        for m in members:
            self.sets.get(k, set()).discard(
                m.encode() if isinstance(m, str) else m)

    def expire(self, k, ttl):
        self.ttls[k] = ttl

    def pipeline(self):
        return _Pipeline(self)

    def close(self):
        pass


def _ns(jax_side, backend, path):
    mod = jpersist if jax_side else tpersist
    if backend == "memory":
        store = mod.InMemoryStore()
    elif backend == "sqlite":
        store = mod.make_store("sqlite", sqlite_path=str(path))
    else:
        store = mod.RedisStore(prefix="t:", ttl=60.0, client=_FakeRedis())
    clock = FakeClock()
    cfg = (JConvConfig if jax_side else ConversationConfig)(
        max_context_length=100, max_idle_time=60.0, ttl=3600.0,
        max_conversations_per_user=3, max_conversations=5)
    sm = (JStateManager if jax_side else StateManager)(cfg, store=store,
                                                      clock=clock)
    t = jtypes if jax_side else ttypes
    return types.SimpleNamespace(sm=sm, store=store, clock=clock, t=t,
                                 make_sm=lambda: (JStateManager if jax_side
                                                  else StateManager)(
                                     cfg, store=store, clock=clock))


def _conv(c):
    d = c.to_dict()
    for m in d.get("messages", []):      # wall-clock message stamps
        m.pop("created_at")
        m.pop("updated_at")
    return d


def _script(ns):
    """One run of the conversation service; returns its trace."""
    sm, t, clock = ns.sm, ns.t, ns.clock
    trace, touched, evicted = [], [], []
    sm.on_touch(lambda c: touched.append(c.id))
    sm.on_evict(lambda c: evicted.append(c.id))
    sm.on_touch(lambda c: 1 / 0)              # a failing hook is survived
    sm.create("alice", conversation_id="c1", metadata={"k": 1})
    clock.advance(1.0)
    for i, text in enumerate(["hello there " * 3, "second " * 4,
                              "third message is a long one " * 2]):
        sm.add_message("c1", t.Message(id=f"m{i}", content=text,
                                       user_id="alice", created_at=0.0))
        clock.advance(1.0)
    msg = sm.get("c1").messages[-1]
    msg.response = "a reply"
    sm.record_response("c1", msg)
    sm.record_response("c1", t.Message(id="x", response="more",
                                       created_at=0.0))
    trace.append(("c1", _conv(sm.get("c1"))))
    trace.append(("prefix", sm.record_prefix_handle("c1", {"length": 7}),
                  sm.record_prefix_handle("nope", {"length": 1}),
                  sm.prefix_handle("c1"), sm.prefix_handle("nope")))
    sm.update_state("c1", t.ConversationState.COMPLETED)
    for i in range(4):                         # the per-user cap is 3
        sm.get_or_create(f"u{i}", "bob")
        clock.advance(1.0)
    trace.append(("bob", [c.id for c in sm.user_conversations("bob")]))
    for i in range(3):                         # the global cap is 5
        sm.create("carol", conversation_id=f"k{i}")
        clock.advance(1.0)
    trace.append(("count", sm.count(), sm.get_stats()))
    try:
        sm.get("never")
    except KeyError as e:
        trace.append(("missing", type(e).__name__))
    clock.advance(30.0)
    sm.get_or_create("k2", "carol")            # keeps k2 fresh
    clock.advance(40.0)
    trace.append(("cleanup", sm.run_cleanup_once(), sm.count(),
                  sorted(c.id for c in sm.active_conversations())))
    trace.append(("delete", sm.delete("k2"), sm.delete("k2")))
    # A fresh manager over the same store reloads archived state.
    sm2 = ns.make_sm()
    trace.append(("reload", _conv(sm2.get("c1")),
                  sorted(c.id for c in sm2.user_conversations("bob"))))
    trace.append(("hooks", touched, evicted))
    return trace


@pytest.mark.parametrize("backend", ["memory", "sqlite", "redis"])
def test_state_manager_matches_jax(backend, tmp_path):
    """Tolerance: none (fake clocks). Create, messages with the context
    window, responses folded into the context, prefix handles, state
    changes, both caps, idle cleanup, delete, reload from the store and
    the touch/evict hook calls leave the same trace."""
    j = _script(_ns(True, backend, tmp_path / "jax.db"))
    t = _script(_ns(False, backend, tmp_path / "port.db"))
    assert t == j


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_stores_match_jax(backend, tmp_path):
    """The bare stores: save, load, list a user's, delete."""
    out = []
    for jax_side, mod, t in ((True, jpersist, jtypes),
                             (False, tpersist, ttypes)):
        store = mod.make_store(backend, sqlite_path=str(
            tmp_path / f"{jax_side}.db"))
        conv = t.Conversation(id="c", user_id="u", created_at=1.0,
                              updated_at=2.0, last_active_at=3.0,
                              messages=[t.Message(id="m", content="hi",
                                                  created_at=0.0,
                                                  updated_at=0.0)])
        store.save(conv)
        store.save(t.Conversation(id="d", user_id="u", created_at=1.0,
                                  updated_at=2.0, last_active_at=4.0))
        got = store.load("c").to_dict()
        listed = sorted(store.list_user("u"))
        store.delete("c")
        out.append((got, listed, store.load("c"), store.list_user("u")))
        store.close()
    assert out[0] == out[1]


def test_redis_store_needs_its_client():
    with pytest.raises(RuntimeError, match="redis"):
        tpersist.make_store("redis")
    with pytest.raises(ValueError, match="unknown persistence backend"):
        tpersist.make_store("postgres")


# -- the engine's KV-pin hooks --------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = T.get_config("llama3-tiny", dtype=torch.float32)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _engine(tiny, prefix=False):
    cfg, params = tiny
    ex = TorchExecutor(cfg, params, device="cpu", batch_size=2, page_size=16,
                       num_pages=64, prefill_buckets=[16, 32], chunk_size=4,
                       eos_id=-1)
    return InferenceEngine(ex, ByteTokenizer(), max_decode_steps=8,
                           prefix_cache=PrefixCacheConfig() if prefix
                           else None)


def _turn(eng, sm, conv, text, user="u"):
    sm.get_or_create(conv, user)
    h = eng.submit(GenRequest(id=f"{conv}-{text}", prompt=text,
                              conversation_id=conv))
    eng.run_until_idle()
    return h.result


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "radix"])
def test_engine_pins_follow_the_conversation_service(tiny, prefix):
    """A finished turn pins its KV and records its prefix handle; a
    touch refreshes the pin; ``delete``, the idle cleanup and the
    per-user cap each evict a conversation, which unpins it and frees
    its pages (with the radix tree on, its published blocks too)."""
    clock = FakeClock()
    sm = StateManager(ConversationConfig(max_idle_time=60.0,
                                         max_conversations_per_user=2),
                      clock=clock)
    eng = _engine(tiny, prefix)
    eng.attach_conversation_manager(sm)
    for conv in ("a", "b"):
        res = _turn(eng, sm, conv, f"first turn of {conv}")
        assert res.finish_reason == "length"
    assert sorted(eng.cached_conversations()) == ["a", "b"]
    if prefix:
        assert sm.prefix_handle("a")["length"] > 0
    used_two = eng.allocator.used()
    before = eng._conv_cache["a"].last_used
    eng._now = lambda: before + 100.0
    sm.get_or_create("a")                       # touch
    assert eng._conv_cache["a"].last_used == before + 100.0
    assert sm.delete("a")
    assert eng.cached_conversations() == ["b"]
    assert eng.allocator.used() < used_two
    clock.advance(61.0)
    assert sm.run_cleanup_once() == 1           # b was idle
    assert eng.cached_conversations() == []
    assert eng.allocator.used() == 0
    for conv in ("c", "d", "e"):                # the per-user cap is 2
        _turn(eng, sm, conv, f"turn of {conv}")
        clock.advance(1.0)
    assert sorted(eng.cached_conversations()) == ["d", "e"]
    for conv in ("d", "e"):
        sm.delete(conv)
    assert eng.allocator.used() == 0
    if prefix:
        assert eng._prefix_cache.get_stats()["pages"] == 0


def test_second_turn_reuses_the_pin_after_a_touch(tiny):
    sm = StateManager(ConversationConfig())
    eng = _engine(tiny)
    eng.attach_conversation_manager(sm)
    _turn(eng, sm, "c", "hello there")
    res = _turn(eng, sm, "c", " and again")
    assert res.cached_tokens > 0
