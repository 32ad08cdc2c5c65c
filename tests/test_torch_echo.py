"""The port's echo executor against the JAX package's, on the CPU.

- ``EchoExecutor`` call for call: the blocking ``decode_chunk``,
  ``mixed_chunk`` and ``verify_chunk`` (with the ``verify_accept_cap``
  seam) and the futures API on its device-queue thread (carried and
  joined chunks) give JAX's arrays on the same seeded inputs.
- The port's engine on the port's echo against JAX's engine on JAX's
  echo, stepped in lockstep: the same slots and pages after every step
  and the same token streams, blocking and at async depth 2, plain, with
  mixed batching, and with speculation's verify windows.
- ``kv_content_free``: conversations demote to the host tier as
  metadata-only entries and promote back, through the port's tiering
  plane, with JAX's hits and streams.
- ``build_engine`` with ``executor.backend: echo`` gives JAX's builder's
  geometry; ``load_config`` with ``configs/config.yaml`` named (or
  ``LLMQ_EXECUTOR_BACKEND=echo``) gives the echo backend, while the same
  file found by the search is refused; ``check`` runs end to end on it.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from llmq_tpu.core import config as JC
from llmq_tpu.core.clock import FakeClock as JFakeClock
from llmq_tpu.engine.builder import build_engine as jbuild
from llmq_tpu.engine.engine import GenRequest as JGenRequest
from llmq_tpu.engine.engine import InferenceEngine as JEngine
from llmq_tpu.engine.executor import EchoExecutor as JEcho
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok

from llmq_tpu_torch.core import config as TC
from llmq_tpu_torch.core.clock import FakeClock as TFakeClock
from llmq_tpu_torch.engine.builder import build_engine as tbuild
from llmq_tpu_torch.engine.engine import GenRequest as TGenRequest
from llmq_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmq_tpu_torch.engine.executor import EchoExecutor as TEcho
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer as TTok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(REPO, "configs", "config.yaml")
B, EOS = 4, 2


def _pair(**kw):
    kw = dict(dict(batch_size=B, page_size=8, num_pages=64,
                   max_pages_per_seq=16, eos_id=EOS, chunk_size=4,
                   mixed_prefill_slices=2, mixed_slice_tokens=8), **kw)
    return JEcho(**kw), TEcho(**kw)


def _prefilled(pair, rng):
    """Both executors with the same seeded prompts in every slot; returns
    the (tokens, positions) of their first decode inputs."""
    tok = np.zeros(B, np.int32)
    pos = np.zeros(B, np.int32)
    for slot in range(B):
        prompt = [int(x) for x in rng.integers(3, 250, rng.integers(2, 9))]
        for ex in pair:
            first = ex.prefill(prompt, 0, None, 0.0, slot)
        tok[slot], pos[slot] = first, len(prompt)
    return tok, pos


# -- the executor, call for call ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blocking_calls_equal_jaxs(seed):
    """Tolerance: none. decode_chunk over mixed budgets (0 included),
    then a mixed chunk with a continuation slice and a fresh one, then
    verify windows with and without the accept cap."""
    rng = np.random.default_rng(seed)
    pair = _pair()
    tok, pos = _prefilled(pair, rng)
    budgets = rng.integers(0, 5, B).astype(np.int32)
    outs = [ex.decode_chunk(tok, pos, None, None, budgets) for ex in pair]
    np.testing.assert_array_equal(outs[0], outs[1])
    pf = [(1, [7, 8, 9], int(pos[1]), None, 0.0),
          (3, [int(x) for x in rng.integers(3, 250, 5)], 0, None, 0.0)]
    outs = [ex.mixed_chunk(tok, pos, None, None, budgets, pf)
            for ex in pair]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    drafts = rng.integers(3, 250, (B, 3)).astype(np.int32)
    drafts[0] = outs[0][0][0, :3]           # a row whose drafts hold
    qlens = np.array([4, 2, 0, 1], np.int32)
    for cap in (None, lambda slot, n: slot % 2):
        for ex in pair:
            ex.verify_accept_cap = cap
        got = [ex.verify_chunk(tok, pos, None, None, drafts, qlens)
               for ex in pair]
        for a, b in zip(*got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_futures_api_equals_jaxs(seed):
    """Tolerance: none. A fresh chunk, a carried one with an override
    joining a lane, a mixed chunk and a verify window, each fetched from
    the device-queue thread's handle, in both packages; the blocking
    executor hides the futures API (None)."""
    rng = np.random.default_rng(seed)
    pair = _pair(async_chunks=True)
    tok, pos = _prefilled(pair, rng)
    budgets = rng.integers(1, 5, B).astype(np.int32)
    res = []
    for ex in pair:
        h1 = ex.decode_chunk_start(tok, pos, None, None, budgets)
        h2 = ex.decode_chunk_start(None, None, None, None, budgets,
                                   carry=h1, overrides=[(2, 77, 3)])
        h3 = ex.mixed_chunk_start(tok, pos, None, None, budgets,
                                  [(0, [5, 6], int(pos[0]), None, 0.0)])
        h4 = ex.verify_chunk_start(tok, pos, None, None,
                                   np.full((B, 2), 9, np.int32),
                                   np.array([3, 1, 0, 2], np.int32))
        res.append([h1.fetch(), h2.fetch(), *h3.fetch(), *h4.fetch(),
                    h2._tok, h2._pos, h2._done])
        ex.close()
    for a, b in zip(*res):
        np.testing.assert_array_equal(a, b)
    for ex in _pair():
        assert ex.decode_chunk_start is None
        assert ex.mixed_chunk_start is None
        assert ex.verify_chunk_start is None
    assert TEcho.kv_content_free is JEcho.kv_content_free is True


def test_a_failed_program_raises_at_fetch():
    ex = TEcho(batch_size=B, async_chunks=True)
    h = ex.decode_chunk_start(np.zeros(B), np.zeros(B), None, None,
                              np.ones(3, np.int32))   # wrong budget width
    with pytest.raises(Exception):
        h.fetch()
    ex.close()


# -- the engines, step by step ----------------------------------------------------


def _engine(pkg, async_chunks, mode, **extra):
    E, X, Tk, C = ((JEngine, JEcho, JTok, JC) if pkg == "jax"
                   else (TEngine, TEcho, TTok, TC))
    tok = Tk()
    ex = X(batch_size=B, page_size=8, num_pages=64, max_pages_per_seq=16,
           eos_id=tok.eos_id, chunk_size=4, mixed_prefill_slices=2,
           mixed_slice_tokens=8, async_chunks=async_chunks)
    kw = dict(enable_metrics=False, max_decode_steps=24,
              async_pipeline=C.AsyncPipelineConfig(enabled=async_chunks,
                                                   depth=2),
              prefix_cache=C.PrefixCacheConfig(enabled=True))
    if mode == "mixed":
        kw["mixed_batch"] = C.MixedBatchConfig(enabled=True,
                                               prefill_token_budget=16)
    if mode == "verify":
        kw["speculation"] = C.SpeculationConfig(enabled=True, draft_k=3)
    kw.update(extra)
    return E(ex, tok, name=f"echo-{pkg}", **kw)


def _state(e):
    return [None if s is None else (s.req.id, list(s.pages), s.prefilled,
                                    len(s.generated))
            for s in e._slots]


@pytest.mark.parametrize("mode", ["plain", "mixed", "verify"])
@pytest.mark.parametrize("async_chunks", [False, True],
                         ids=["blocking", "depth2"])
def test_engine_steps_equal_jaxs(async_chunks, mode):
    """Tolerance: none. Seven prompts through four slots (admission
    waves, page growth, finishes, a shared prefix): after every step the
    same requests hold the same slots and pages, and every stream and
    finish reason is JAX's."""
    engines = {p: _engine(p, async_chunks, mode) for p in ("jax", "port")}
    prompts = [f"hello world {i} " * (1 + i % 3) for i in range(7)]
    prompts[5] = prompts[2]
    handles = {}
    for p, e in engines.items():
        G = JGenRequest if p == "jax" else TGenRequest
        handles[p] = [e.submit(G(id=f"r{i}", prompt=pr, max_new_tokens=20))
                      for i, pr in enumerate(prompts)]
        # Every arrival is in the inbox: a step's ingest takes them all.
        # With the wake cleared, a wait for a fetch services nothing, so
        # no admission depends on how long the device thread takes.
        e._wake.clear()
    for step in range(400):
        a = engines["jax"].step()
        b = engines["port"].step()
        assert _state(engines["port"]) == _state(engines["jax"]), step
        if not a and not b:
            break
    for e in engines.values():
        e.run_until_idle()
        e.stop()
    got = {p: [(h.result.tokens, h.result.finish_reason, h.result.text)
               for h in hs] for p, hs in handles.items()}
    assert got["port"] == got["jax"]
    assert all(r[1] in ("eos", "length") for r in got["port"])
    js, ts = engines["jax"].get_stats(), engines["port"].get_stats()
    assert ts["decode_steps"] == js["decode_steps"]
    if mode == "mixed":
        assert engines["port"].mixed_steps == engines["jax"].mixed_steps > 0
    if mode == "verify":
        assert ts["speculation"] == js["speculation"]
        assert ts["speculation"]["tokens_accepted"] > 0


@pytest.mark.parametrize("cap", [0, 1])
def test_verify_accept_cap_keeps_the_stream(cap):
    """The accept cap rejects drafts without changing the stream, with
    JAX's window counts."""
    got = {}
    for p in ("jax", "port"):
        e = _engine(p, False, "verify")
        e.executor.verify_accept_cap = lambda slot, n: cap
        G = JGenRequest if p == "jax" else TGenRequest
        hs = [e.submit(G(id=f"c{i}", prompt="abc abc abc abc " * 2,
                         max_new_tokens=20)) for i in range(3)]
        e.run_until_idle()
        e.stop()
        got[p] = ([h.result.tokens for h in hs],
                  e.get_stats()["speculation"])
    assert got["port"] == got["jax"]


# -- content-free KV through the tiering plane -----------------------------------


def test_content_free_demotion_through_the_tiering_plane():
    """Tolerance: none. Pins reclaimed by the TTL demote as metadata-only
    host entries (no payload), the next turns promote them back as host
    hits with their cached tokens, and the streams, hits and counts are
    JAX's."""
    got = {}
    for p, C, Clock, G in (("jax", JC, JFakeClock, JGenRequest),
                           ("port", TC, TFakeClock, TGenRequest)):
        clock = Clock()
        e = _engine(p, True, "plain", kv_pin_ttl=5.0, clock=clock,
                    kv_tiering=C.KVTieringConfig(
                        enabled=True, host_capacity_mb=4,
                        host_max_conversations=16))
        out = []
        for turn in range(2):
            hs = [e.submit(G(id=f"c{i}.{turn}",
                             prompt=f"conversation {i} turn {turn} " * 2,
                             conversation_id=f"c{i}", max_new_tokens=8))
                  for i in range(3)]
            e.run_until_idle()
            out.append([(h.result.tokens, h.result.cached_tokens)
                        for h in hs])
            clock.advance(6.0)
            e.step()
            plane = e._tiering
            deadline = 0
            while sum(plane.counts().values()) < 3 and deadline < 2000:
                e.step()
                deadline += 1
        st = e.get_stats()["kv_tiering"]
        e.stop()
        got[p] = (out, st["hits"], st["demotions"], st["promotions"],
                  plane.counts())
    assert got["port"] == got["jax"]
    out, hits, demotions, promotions, counts = got["port"]
    assert hits["host"] == 3 and demotions == 6 and promotions == 3
    assert all(c > 0 for _t, c in out[1])


# -- the builder and the config ---------------------------------------------------


@pytest.mark.parametrize("extra,model", [
    ("", ""),
    (", async_pipeline: {enabled: false}", ""),
    (", mixed_batch: {enabled: false}", ""),
    (", ragged_attention: {enabled: true}, decode_chunk: 8", ""),
    (", max_batch_size: 3, page_size: 32, kv_pages: 96",
     "model: {max_seq_len: 1024}\n"),
])
def test_builder_geometry_equals_jaxs(tmp_path, extra, model):
    """``executor.backend: echo`` builds JAX's builder's echo: the spec,
    the chunk, the mixed geometry, the ragged flag and whether the
    futures API is there; no device is asked for."""
    path = tmp_path / "c.yaml"
    path.write_text("executor: {backend: echo%s}\n%s" % (extra, model))
    je = jbuild(JC.load_config(str(path), env=False), enable_metrics=False)
    te = tbuild(TC.load_config(str(path), env=False))
    try:
        jx, tx = je.executor, te.executor
        assert type(tx) is TEcho
        assert tuple(vars(tx.spec).values()) == tuple(vars(jx.spec).values())
        for attr in ("chunk_size", "mixed_prefill_slices",
                     "mixed_slice_tokens", "ragged_attention",
                     "_async_chunks"):
            assert getattr(tx, attr) == getattr(jx, attr), attr
        assert (tx.decode_chunk_start is None) == (
            jx.decode_chunk_start is None)
    finally:
        je.stop()
        te.stop()


def test_named_file_selects_echo_and_the_searched_one_is_refused(
        tmp_path, monkeypatch):
    """The repository's ``configs/config.yaml`` selects echo when named
    (path, ``LLMQ_CONFIG``) or by ``LLMQ_EXECUTOR_BACKEND=echo``; found by
    the search it is refused with the remedy, so a card is never left
    serving echo by accident. The dataclass default stays torch."""
    assert TC.Config().executor.backend == "torch"
    assert TC.load_config(CANONICAL, env=False).executor.backend == "echo"
    assert TC.load_config(environ={"LLMQ_CONFIG": CANONICAL}) \
        .executor.backend == "echo"
    monkeypatch.chdir(tmp_path)
    assert TC.load_config(environ={"LLMQ_EXECUTOR_BACKEND": "echo"}) \
        .executor.backend == "echo"
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "config.yaml").write_text(open(CANONICAL).read())
    with pytest.raises(ValueError, match="found by the config search.*"
                       "pass --config.*LLMQ_EXECUTOR_BACKEND=echo"):
        TC.load_config(environ={})
    with pytest.raises(ValueError, match="found by the config search"):
        TC.load_config(environ={"LLMQ_EXECUTOR_BACKEND": "echo"})


def test_check_runs_end_to_end_on_the_named_echo_backend(tmp_path):
    """``python -m llmq_tpu_torch --config <echo file> --device cpu
    check`` completes its message through REST on the echo backend."""
    cfg = tmp_path / "echo.yaml"
    cfg.write_text("executor: {backend: echo}\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("LLMQ_CONFIG", None)
    res = subprocess.run(
        [sys.executable, "-m", "llmq_tpu_torch", "--config", str(cfg),
         "--device", "cpu", "check"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "CHECK OK" in res.stdout
    assert "backend=echo" in res.stdout + res.stderr
