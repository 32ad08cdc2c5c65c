"""Pool pressure: the port's page-release preemption and rebuild against
the JAX package's engine on the same small pools (f32 weights carried
across by ``params_from_jax``, greedy rows, no EOS: every comparison is
exact).

Scenarios mirror the JAX package's own tests:

- ``lru``: two pinned conversations, then a request that needs the pool:
  the least recently used pin is evicted (tests/test_engine.py:331).
- ``guard``: a LOW request that does not fit waits; it never strips the
  REALTIME runner's pages (tests/test_engine.py:400).
- ``pending``: one slot; a LOW runner is slot-preempted (keeping its
  pages) and the REALTIME request that took the slot needs those parked
  pages: with every slot empty and the pool full, admission must reclaim
  them rather than deadlock (tests/test_engine.py:424).
- ``conversation``: a conversation turn whose adopted pages are reclaimed
  rebuilds with its whole history (tests/test_engine.py:444).
- ``midprefill``: a REALTIME decoder's growth strips a LOW sequence whose
  prefill is not finished; it is rebuilt with its full prompt
  (tests/test_engine.py:870).
- ``self``: two equal rows grow past the pool; the one that cannot get a
  page requeues itself and rebuilds, instead of failing.
- ``mixed``: ``midprefill`` with token-budget mixed batching
  (tests/test_mixed_batch.py:78): streams equal to the unfused ones.

Each scenario runs with the async pipeline on and off. Asserted: equal
streams and finish reasons, the same preemption victims in the same
order with the same ``release_pages`` flags, no ``"error"`` finish, and
the pool back to the conversation pins once idle.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.core.config import AsyncPipelineConfig as JPipe  # noqa: E402
from llmq_tpu.core.config import MixedBatchConfig as JMixed  # noqa: E402
from llmq_tpu.core.types import Priority as JPriority  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402

from llmq_tpu_torch.core.config import (AsyncPipelineConfig,  # noqa: E402
                                        MixedBatchConfig)
from llmq_tpu_torch.core.types import Priority  # noqa: E402
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402

torch.set_num_threads(1)
KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512, max_seq_len=128)
#: No token is EOS: every row runs to its budget, in both packages.
COMMON = dict(prefill_buckets=[16, 32], eos_id=-1, chunk_size=4,
              mixed_prefill_slices=2, mixed_slice_tokens=8)


@pytest.fixture(scope="module")
def models():
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


class _Side:
    """One package's engine types and the recorders wrapped around its
    engine's ``_preempt`` and ``_reclaim_pending_pages``."""

    def __init__(self, jax_side: bool, models, executors) -> None:
        self.jax = jax_side
        self.models = models
        self.executors = executors

    def engine(self, slots, pages, page_size, steps, pipe, mixed):
        key = (self.jax, slots, pages, page_size)
        jcfg, jparams, tcfg, tparams = self.models
        geom = dict(COMMON, batch_size=slots, num_pages=pages,
                    page_size=page_size)
        if key not in self.executors:
            # One executor a geometry: the JAX one compiles once, and the
            # pools are rewritten before they are read by any new owner.
            if self.jax:
                self.executors[key] = JaxExecutor(jcfg, jparams, **geom)
            else:
                self.executors[key] = TorchExecutor(tcfg, tparams,
                                                    device="cpu", **geom)
        ex = self.executors[key]
        if self.jax:
            eng = JEngine(ex, JTok(), enable_metrics=False,
                          max_decode_steps=steps,
                          async_pipeline=JPipe() if pipe else None,
                          mixed_batch=(JMixed(prefill_token_budget=16)
                                       if mixed else None))
        else:
            eng = InferenceEngine(
                ex, ByteTokenizer(), max_decode_steps=steps,
                async_pipeline=AsyncPipelineConfig() if pipe else None,
                mixed_batch=(MixedBatchConfig(prefill_token_budget=16)
                             if mixed else None))
        victims, reclaims = [], []
        orig = eng._preempt
        eng._preempt = lambda v, release_pages: (
            victims.append((v.req.id, release_pages)),
            orig(v, release_pages))[1]
        orig_reclaim = eng._reclaim_pending_pages

        def reclaim(requester):
            ok = orig_reclaim(requester)
            reclaims.append((requester.req.id, ok))
            return ok

        eng._reclaim_pending_pages = reclaim
        return eng, victims, reclaims

    def req(self, rid, prompt, prio, n, conv=""):
        if self.jax:
            return JGenRequest(id=rid, prompt=prompt,
                               priority=JPriority.from_name(prio),
                               max_new_tokens=n, conversation_id=conv)
        return GenRequest(id=rid, prompt=prompt,
                          priority=Priority.from_name(prio),
                          max_new_tokens=n, conversation_id=conv)


def _lru(side, pipe, mixed):
    eng, vic, rec = side.engine(2, 24, 8, 64, pipe, mixed)
    hs = {"a": eng.submit(side.req("a", "a" * 30, "normal", 30, "ca"))}
    eng.run_until_idle()
    hs["b"] = eng.submit(side.req("b", "b" * 30, "normal", 30, "cb"))
    eng.run_until_idle()
    before = sorted(eng.cached_conversations())
    hs["big"] = eng.submit(side.req("big", "x" * 60, "normal", 60))
    eng.run_until_idle()
    return eng, hs, vic, rec, {"pins_before": before}


def _guard(side, pipe, mixed):
    eng, vic, rec = side.engine(2, 8, 8, 64, pipe, mixed)
    hs = {"rt": eng.submit(side.req("rt", "R" * 24, "realtime", 20))}
    eng.step()
    hs["low"] = eng.submit(side.req("low", "L" * 24, "low", 8))
    eng.step()
    active = eng.get_stats()["active"]
    eng.run_until_idle()
    return eng, hs, vic, rec, {"active_while_waiting": active}


def _pending(side, pipe, mixed):
    eng, vic, rec = side.engine(1, 12, 8, 64, pipe, mixed)
    hs = {"low": eng.submit(side.req("low", "L" * 60, "low", 16))}
    for _ in range(3):
        eng.step()
    hs["h"] = eng.submit(side.req("h", "H" * 30, "high", 8))
    hs["rt"] = eng.submit(side.req("rt", "R" * 30, "realtime", 8))
    eng.run_until_idle()
    return eng, hs, vic, rec, {}


def _conversation(side, pipe, mixed):
    eng, vic, rec = side.engine(1, 16, 8, 64, pipe, mixed)
    hs = {"t1": eng.submit(side.req("t1", "history of the chat", "low", 4,
                                    "c"))}
    eng.run_until_idle()
    hs["t2"] = eng.submit(side.req("t2", " and turn two", "low", 24, "c"))
    eng.step()
    eng.step()
    hs["rt"] = eng.submit(side.req("rt", "X" * 60, "realtime", 50))
    eng.run_until_idle()
    return eng, hs, vic, rec, {}


def _midprefill(side, pipe, mixed):
    eng, vic, rec = side.engine(2, 16, 4, 64, pipe, mixed)
    hs = {"rt": eng.submit(side.req("rt", "r" * 12, "realtime", 40)),
          "lo": eng.submit(side.req("lo", "l" * 40, "low", 4))}
    eng.run_until_idle()
    return eng, hs, vic, rec, {}


def _self_requeue(side, pipe, mixed):
    eng, vic, rec = side.engine(2, 6, 16, 40, pipe, mixed)
    hs = {f"r{i}": eng.submit(side.req(f"r{i}", f"{i}" * 30, "normal", 40))
          for i in range(2)}
    eng.run_until_idle()
    return eng, hs, vic, rec, {}


SCENARIOS = {"lru": (_lru, False), "guard": (_guard, False),
             "pending": (_pending, False),
             "conversation": (_conversation, False),
             "midprefill": (_midprefill, False),
             "self": (_self_requeue, False),
             "mixed": (_midprefill, True)}


@pytest.fixture(scope="module")
def executors():
    return {}


def _run(models, executors, name, pipe, jax_side):
    fn, mixed = SCENARIOS[name]
    eng, hs, vic, rec, extra = fn(_Side(jax_side, models, executors), pipe,
                                  mixed)
    out = {rid: (h.result.tokens, h.result.finish_reason)
           for rid, h in hs.items()}
    pinned = sorted(eng.cached_conversations())
    radix = (eng._prefix_cache.get_stats()["pages"]
             if eng._prefix_cache is not None else 0)
    used = eng.allocator.used()
    pin_pages = eng.allocator.pinned_pages()
    eng.stop()
    return dict(out=out, victims=vic, reclaims=rec, extra=extra,
                pinned=pinned, used=used, pin_pages=pin_pages, radix=radix)


@pytest.mark.parametrize("pipe", [True, False], ids=["pipeline", "nopipe"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_pool_pressure_matches_jax(models, executors, name, pipe):
    """Tolerance: none. The port's engine and the JAX package's engine
    under the same pool pressure: equal streams and finish reasons, the
    same victims in the same order with the same release flags, no
    error finish, and no page leaked once idle."""
    j = _run(models, executors, name, pipe, jax_side=True)
    t = _run(models, executors, name, pipe, jax_side=False)
    assert t["out"] == j["out"]
    assert t["victims"] == j["victims"]
    # Pending-page reclaims that freed pages, in order (how often a
    # waiting admission retried and found nothing depends on timing).
    assert [r for r in t["reclaims"] if r[1]] == \
        [r for r in j["reclaims"] if r[1]]
    assert t["extra"] == j["extra"]
    assert t["pinned"] == j["pinned"]
    assert all(reason != "error" for _, reason in t["out"].values())
    # Idle: only the conversation pins hold pages (no radix tree here).
    assert t["used"] == t["pin_pages"] == j["used"]


@pytest.fixture(scope="module")
def port_runs(models, executors):
    return {(name, pipe): _run(models, executors, name, pipe,
                               jax_side=False)
            for name in SCENARIOS for pipe in (True, False)}


def test_scenarios_shed_as_designed(port_runs):
    """Each scenario reaches the shedding stage it stands for (so the
    comparison above is not vacuous), with the pipeline on and off."""
    for pipe in (True, False):
        r = {n: port_runs[(n, pipe)] for n in SCENARIOS}
        assert r["lru"]["extra"]["pins_before"] == ["ca", "cb"]
        assert "ca" not in r["lru"]["pinned"] and not r["lru"]["victims"]
        assert r["guard"]["extra"]["active_while_waiting"] == 1
        assert ("rt", True) not in r["guard"]["victims"]
        assert ("low", False) in r["pending"]["victims"]
        assert (("rt", True) in r["pending"]["reclaims"]
                or ("h", True) in r["pending"]["reclaims"])
        assert any(ok for _, ok in r["conversation"]["reclaims"])
        assert r["conversation"]["pinned"] == ["c"]
        for name in ("midprefill", "mixed"):
            assert ("lo", True) in r[name]["victims"], name
        assert any(rel for _, rel in r["self"]["victims"])
        for name, run in r.items():
            for rid, (tokens, reason) in run["out"].items():
                assert reason == "length", (name, rid)


def test_mixed_streams_equal_unfused(port_runs):
    """Tolerance: none. Under mixed batching the stripped-and-rebuilt
    sequences give the unfused streams (tests/test_mixed_batch.py:78)."""
    for pipe in (True, False):
        assert port_runs[("mixed", pipe)]["out"] == \
            port_runs[("midprefill", pipe)]["out"]


def test_rebuilt_streams_equal_unpressured(models, executors, port_runs):
    """Tolerance: none. A rebuilt sequence's stream is the one it gets
    on a pool with room to spare (f32: the rebuild's prefill reproduces
    the KV that decode wrote)."""
    side = _Side(False, models, executors)
    for name, rid, prompt, prio, n, page_size in (
            ("midprefill", "lo", "l" * 40, "low", 4, 4),
            ("midprefill", "rt", "r" * 12, "realtime", 40, 4),
            ("pending", "low", "L" * 60, "low", 16, 8),
            ("self", "r0", "0" * 30, "normal", 40, 16),
            ("self", "r1", "1" * 30, "normal", 40, 16)):
        eng, _, _ = side.engine(2, 128, page_size, 64, False, False)
        h = eng.submit(side.req(rid, prompt, prio, n))
        eng.run_until_idle()
        eng.stop()
        for pipe in (True, False):
            assert port_runs[(name, pipe)]["out"][rid][0] == \
                h.result.tokens, (name, rid, pipe)
