"""The port's async decode pipeline against its blocking path and the JAX
package on the CPU (f32 weights, tiny model: H=4, H_kv=2, D=64, 2
layers; greedy rows, so every comparison is exact).

- ``decode_chunk_start`` with ``carry`` equals two host-assembled
  ``decode_chunk`` calls: the tokens, the pools, and the end state of
  ``tok``, ``pos`` and ``frozen`` (the EOS latch), over budgets 0..K and
  an EOS mid-chunk; the steps in which no row was live are counted.
- An ``overrides`` join (the prefill's token copied device to device)
  equals a join through the host, on a fresh and on a carried dispatch,
  the latter onto a lane whose previous owner hit EOS.
- ``mixed_chunk_start`` equals the blocking ``mixed_chunk`` and JAX's
  ``mixed_chunk_start``, bucket and ragged, and carries into the next
  chunk like a host-assembled one.
- The dispatches read nothing back to the host: ``item``, ``tolist``,
  ``cpu``, ``numpy`` and ``Tensor.__bool__`` raise inside
  ``decode_chunk_start`` (fresh, carried, joined) and
  ``mixed_chunk_start`` (bucket, ragged, int8 pools).
- The staging ring waits on a slot's event only when the slot comes
  round.
- The port's engine gives the same streams at depths 1, 2 and 3 and with
  the pipeline off, and JAX's streams with the pipeline on (a wave with a
  preemption; multi-turn conversations with mixed batching and the prefix
  cache); tokens reach the stream callback before done, on completion
  threads, at one and two workers; a cancel with a chunk in flight leaks
  no slot or page; a failed fetch fails its requests.
"""

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.core.config import AsyncPipelineConfig as JPipe  # noqa: E402
from llmq_tpu.core.config import MixedBatchConfig as JMixed  # noqa: E402
from llmq_tpu.core.config import PrefixCacheConfig as JPrefix  # noqa: E402
from llmq_tpu.core.types import Priority as JPriority  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402

from llmq_tpu_torch.core.config import (AsyncPipelineConfig,  # noqa: E402
                                        MixedBatchConfig, PrefixCacheConfig)
from llmq_tpu_torch.core.types import Priority  # noqa: E402
from llmq_tpu_torch.engine import executor as E  # noqa: E402
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402

torch.set_num_threads(1)
KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512)
K = 4
GEOM = dict(batch_size=5, page_size=16, num_pages=64, prefill_buckets=[16, 32],
            chunk_size=K, mixed_prefill_slices=2, mixed_slice_tokens=8,
            ragged_token_capacity=16, ragged_max_slices=2)
PROMPTS = [[5, 9, 13, 17, 21], [40, 41, 42], [7] * 9, [300, 200, 100, 50],
           [11, 12]]
HOST_READS = ("item", "__bool__", "tolist", "cpu", "numpy")


@pytest.fixture(scope="module")
def models():
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tables(B, MP):
    bt = np.zeros((B, MP), np.int32)
    for b in range(B):
        bt[b, :3] = [1 + 3 * b, 2 + 3 * b, 3 + 3 * b]
    return bt


def _prefilled(ex, bt, rows=range(5)):
    toks = [ex.prefill(PROMPTS[b], 0, bt[b], 0.0, b) for b in rows]
    return (np.asarray(toks, np.int32),
            np.asarray([len(PROMPTS[b]) for b in rows], np.int32))


def _host_carry(out, tok, pos, frozen, budgets, eos):
    """The end state a chunk leaves, from its tokens: a live row advances
    a position a step until its budget ends or it emits EOS (which
    latches it); a latched row does not move."""
    tok, pos, frozen = tok.copy(), pos.copy(), frozen.copy()
    for b in range(len(tok)):
        if frozen[b]:
            continue
        n = 0
        for t in out[b, :budgets[b]]:
            n += 1
            tok[b] = t
            if t == eos:
                frozen[b] = True
                break
        pos[b] += n
    return tok, pos, frozen


def _pools_equal(a, b):
    for k in a.cache:
        assert torch.equal(a.cache[k][:, 1:], b.cache[k][:, 1:]), k


@pytest.fixture(scope="module")
def eos(models):
    """An EOS id that row 0 emits at step 1 of the first chunk (a token of
    its greedy stream), so the latch fires mid-chunk."""
    _, _, tcfg, tparams = models
    ex = TorchExecutor(tcfg, tparams, device="cpu", eos_id=-1, **GEOM)
    bt = _tables(5, ex.spec.max_pages_per_seq)
    tok, pos = _prefilled(ex, bt)
    out = ex.decode_chunk(tok, pos, bt, np.zeros(5, np.float32),
                          np.full(5, K, np.int32))
    assert out[0, 0] != out[0, 1] and out[0, 1] not in out[1:, :2]
    return int(out[0, 1])


@pytest.mark.parametrize("budgets", [([4, 0, 2, 3, 1], [4, 4, 1, 0, 4]),
                                     ([4, 4, 4, 4, 4], [2, 3, 4, 1, 0]),
                                     ([0, 0, 0, 0, 0], [4, 4, 4, 4, 4])])
def test_carried_chunk_equals_two_host_chunks(models, eos, budgets):
    """Tolerance: none. Chunk 2 dispatched with ``carry=`` chunk 1, before
    chunk 1 is fetched, gives the tokens, pools and end state of chunk 2
    assembled on the host from chunk 1's tokens (a latched row there has
    budget 0); the steps with no live row are counted (and no step when
    every budget is 0)."""
    _, _, tcfg, tparams = models
    b1, b2 = (np.asarray(b, np.int32) for b in budgets)
    ex = TorchExecutor(tcfg, tparams, device="cpu", eos_id=eos, **GEOM)
    ref = TorchExecutor(tcfg, tparams, device="cpu", eos_id=eos, **GEOM)
    bt = _tables(5, ex.spec.max_pages_per_seq)
    tok, pos = _prefilled(ex, bt)
    _prefilled(ref, bt)
    temps = np.zeros(5, np.float32)
    idle0 = ex.idle_steps
    h1 = ex.decode_chunk_start(tok, pos, bt, temps, b1)
    h2 = ex.decode_chunk_start(None, None, bt, temps, b2, carry=h1)
    out1 = ref.decode_chunk(tok, pos, bt, temps, b1)
    tok1, pos1, fr1 = _host_carry(out1, tok, pos, np.zeros(5, bool), b1, eos)
    out2 = ref.decode_chunk(tok1, pos1, bt, temps, np.where(fr1, 0, b2))
    tok2, pos2, fr2 = _host_carry(out2, tok1, pos1, fr1, b2, eos)
    np.testing.assert_array_equal(h1.fetch(), out1)
    np.testing.assert_array_equal(h2.fetch(), out2)
    np.testing.assert_array_equal(h1.frozen.numpy(), fr1)
    np.testing.assert_array_equal(h2.tok.numpy(), tok2)
    np.testing.assert_array_equal(h2.pos.numpy(), pos2)
    np.testing.assert_array_equal(h2.frozen.numpy(), fr2)
    _pools_equal(ex, ref)
    assert h1.ready() and h2.ready()
    # Steps queued with every row latched or out of budget.
    assert h1.steps == min(K, b1.max()) and h2.steps == min(K, b2.max())
    idle = (_live_steps(out1, b1, h1.steps, eos, np.zeros(5, bool))
            + _live_steps(out2, b2, h2.steps, eos, fr1)).count(False)
    assert ex.idle_steps - idle0 == idle
    if b1.max() == 0:
        assert h1.steps == 0 and (h1.fetch() == eos).all()


def _live_steps(out, budgets, steps, eos, frozen):
    """Per queued step: whether some row was live in it."""
    frozen = frozen.copy()
    live = []
    for j in range(steps):
        act = (~frozen) & (j < budgets)
        live.append(bool(act.any()))
        frozen |= act & (out[:, j] == eos)
    return live


@pytest.mark.parametrize("how", ["fresh", "carried"])
def test_override_join_equals_host_join(models, eos, how):
    """Tolerance: none. Row 4's prompt is prefilled with ``prefill_async``
    and joins a chunk through ``overrides`` (its token copied on the
    device from the result ring, before anything is fetched); the same
    join through the host (the token fetched, then passed as an input)
    gives the same tokens and pools. Carried: the join lands on lane 0,
    whose sequence hit EOS in the chunk before."""
    _, _, tcfg, tparams = models
    ex = TorchExecutor(tcfg, tparams, device="cpu", eos_id=eos, **GEOM)
    ref = TorchExecutor(tcfg, tparams, device="cpu", eos_id=eos, **GEOM)
    B, MP = 5, ex.spec.max_pages_per_seq
    bt = _tables(B, MP)
    temps = np.zeros(B, np.float32)
    tok, pos = _prefilled(ex, bt, range(4))
    _prefilled(ref, bt, range(4))
    tok, pos = np.append(tok, 0), np.append(pos, 0)
    new_bt = bt.copy()
    lane = 4 if how == "fresh" else 0
    new_bt[lane, :3] = [40, 41, 42]
    prompt = [60, 61, 62, 63, 64, 65]
    budgets = np.array([K, K, K, K, K if how == "fresh" else 0], np.int32)
    if how == "fresh":
        h = ex.prefill_async(prompt, 0, new_bt[lane], 0.0)
        out = ex.decode_chunk_start(tok, pos, new_bt, temps, budgets,
                                    overrides=[(lane, h, len(prompt))])
        first = ref.prefill(prompt, 0, new_bt[lane], 0.0, lane)
        rtok, rpos = tok.copy(), pos.copy()
        rtok[lane], rpos[lane] = first, len(prompt)
        want = ref.decode_chunk(rtok, rpos, new_bt, temps, budgets)
        np.testing.assert_array_equal(out.fetch(), want)
    else:
        b1 = np.array([K, 2, K, K, 0], np.int32)
        h1 = ex.decode_chunk_start(tok, pos, bt, temps, b1)
        h = ex.prefill_async(prompt, 0, new_bt[lane], 0.0)
        h2 = ex.decode_chunk_start(None, None, new_bt, temps, budgets,
                                   carry=h1,
                                   overrides=[(lane, h, len(prompt))])
        out1 = ref.decode_chunk(tok, pos, bt, temps, b1)
        assert out1[0, 1] == eos           # lane 0's owner latched
        tok1, pos1, fr1 = _host_carry(out1, tok, pos, np.zeros(B, bool), b1,
                                      eos)
        first = ref.prefill(prompt, 0, new_bt[lane], 0.0, lane)
        tok1[lane], pos1[lane], fr1[lane] = first, len(prompt), False
        want = ref.decode_chunk(tok1, pos1, new_bt, temps,
                                np.where(fr1, 0, budgets))
        np.testing.assert_array_equal(h1.fetch(), out1)
        np.testing.assert_array_equal(h2.fetch(), want)
    assert int(ex.gather_scalars([h])[0]) == first
    _pools_equal(ex, ref)


@pytest.mark.parametrize("mode", ["bucket", "ragged"])
def test_mixed_chunk_start_equals_mixed_chunk_and_jax(models, mode):
    """Tolerance: none. ``mixed_chunk_start`` (fetched later, in one
    transfer) gives the blocking ``mixed_chunk``'s tokens and slice
    tokens, and JAX's ``mixed_chunk_start``'s; a decode chunk carried
    from it equals one assembled on the host; pools equal."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(GEOM, eos_id=2, ragged_attention=mode == "ragged")
    ex = TorchExecutor(tcfg, tparams, device="cpu", **kw)
    ref = TorchExecutor(tcfg, tparams, device="cpu", **kw)
    jex = JaxExecutor(jcfg, jparams, **kw)
    B, MP = 5, ex.spec.max_pages_per_seq
    bt = _tables(B, MP)
    temps = np.zeros(B, np.float32)
    tok, pos = _prefilled(ex, bt, range(3))
    _prefilled(ref, bt, range(3))
    jtok = [jex.prefill(PROMPTS[b], 0, bt[b], 0.0, b) for b in range(3)]
    assert list(tok) == jtok
    tok, pos = np.append(tok, [0, 0]), np.append(pos, [0, 0])
    budgets = np.array([K, 2, K, 0, 0], np.int32)
    pf = [(3, [70, 71, 72, 73, 74], 0, bt[3], 0.0), (4, [80, 81], 0, bt[4],
                                                      0.0)]
    h = ex.mixed_chunk_start(tok, pos, bt, temps, budgets, pf)
    h2 = ex.decode_chunk_start(None, None, bt, temps,
                               np.array([K, K, K, 0, 0], np.int32), carry=h)
    out, first = ref.mixed_chunk(tok, pos, bt, temps, budgets, pf)
    jout, jfirst = jex.mixed_chunk_start(tok, pos, bt, temps, budgets,
                                         pf).fetch()
    hout, hfirst = h.fetch()
    np.testing.assert_array_equal(hout, out)
    np.testing.assert_array_equal(hfirst, first)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(first, np.asarray(jfirst)[:len(pf)])
    tok1, pos1, fr1 = _host_carry(out, tok, pos, np.zeros(B, bool), budgets,
                                  2)
    want = ref.decode_chunk(tok1, pos1, bt, temps,
                            np.where(fr1, 0, [K, K, K, 0, 0]).astype(
                                np.int32))
    np.testing.assert_array_equal(h2.fetch(), want)
    _pools_equal(ex, ref)


def _trap(monkeypatch):
    def host_read(*_a, **_k):
        raise AssertionError("host read inside a dispatch")

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, host_read)


@pytest.mark.parametrize("call", ["decode_fresh", "decode_carried_joined",
                                  "mixed_bucket", "mixed_ragged",
                                  "mixed_int8"])
def test_dispatch_makes_no_host_read(models, call, monkeypatch):
    """``decode_chunk_start`` and ``mixed_chunk_start`` queue their work
    without reading the device: every host read of a tensor raises while
    they run (the executor's staging slots and programs exist already,
    as after warmup), and the handles then fetch tokens."""
    _, _, tcfg, tparams = models
    kw = dict(GEOM, eos_id=2, ragged_attention=call == "mixed_ragged")
    if call == "mixed_int8":
        kw["cache_dtype"] = torch.int8
    ex = TorchExecutor(tcfg, tparams, device="cpu", **kw)
    B, MP = 5, ex.spec.max_pages_per_seq
    bt = _tables(B, MP)
    temps = np.zeros(B, np.float32)
    tok, pos = _prefilled(ex, bt, range(4))
    tok, pos = np.append(tok, 0), np.append(pos, 0)
    full = np.array([K, K, K, K, 0], np.int32)
    pf = [(4, [70, 71, 72], 0, bt[4], 0.0)]
    # First calls make the staging rings and programs.
    ex.mixed_chunk_start(tok, pos, bt, temps, full, pf).fetch()
    h0 = ex.decode_chunk_start(tok, pos, bt, temps, full)
    hp = ex.prefill_async([90, 91], 0, bt[4], 0.0)
    _trap(monkeypatch)
    if call == "decode_fresh":
        h = ex.decode_chunk_start(tok, pos, bt, temps, full)
    elif call == "decode_carried_joined":
        h = ex.decode_chunk_start(None, None, bt, temps,
                                  np.full(B, K, np.int32), carry=h0,
                                  overrides=[(4, hp, 2)])
    else:
        h = ex.mixed_chunk_start(tok, pos, bt, temps, full, pf)
    monkeypatch.undo()
    out = h.fetch()
    out = out[0] if isinstance(out, tuple) else out
    assert out.shape == (B, K) and (out >= 0).all()


def test_staging_ring_waits_only_when_a_slot_comes_round(monkeypatch):
    """A slot is handed out again only after the event behind its last
    copy has completed; the other slots never wait."""
    waits = []

    class Ev:
        def __init__(self, *_a, **_k):
            self.n = None

        def record(self):
            pass

        def synchronize(self):
            waits.append(self.n)

    monkeypatch.setattr(torch.cuda, "Event", Ev)
    monkeypatch.setattr(torch, "zeros", lambda *a, pin_memory=False, **k:
                        torch.empty(*a, **k).zero_())
    ring = E.HostStaging(3, pin=True)
    shapes = {"x": ((2,), torch.int32)}
    for i in range(7):
        slot = ring.take("t", shapes)
        slot.event.n = i
        slot.record()
    assert waits == [0, 1, 2, 3]
    assert ring.take("u", shapes).recorded is False


# -- the engine ---------------------------------------------------------------

EGEOM = dict(batch_size=4, page_size=16, num_pages=96, prefill_buckets=[16, 32],
             eos_id=2, chunk_size=4, mixed_prefill_slices=2,
             mixed_slice_tokens=8)
WAVE = [("a long prompt that needs slicing into chunks", "low"),
        ("second prompt arrives", "normal"),
        ("urgent!", "realtime"),
        ("fourth one trails behind the others", "high")]


def _port_engine(models, pipe=None, mixed=None, prefix=None, slots=4):
    _, _, tcfg, tparams = models
    ex = TorchExecutor(tcfg, tparams, device="cpu",
                       **dict(EGEOM, batch_size=slots))
    return InferenceEngine(ex, ByteTokenizer(), max_decode_steps=16,
                           mixed_batch=mixed, prefix_cache=prefix,
                           async_pipeline=pipe)


def _jax_engine(models, pipe=None, mixed=None, prefix=None, slots=4):
    jcfg, jparams, _, _ = models
    ex = JaxExecutor(jcfg, jparams, **dict(EGEOM, batch_size=slots))
    return JEngine(ex, JTok(), enable_metrics=False, max_decode_steps=16,
                   mixed_batch=mixed, prefix_cache=prefix,
                   async_pipeline=pipe)


def _wave(eng, make_req, prio_of):
    """The JAX package's preemption wave: four prompts two steps apart,
    one of them REALTIME, on a single slot."""
    hs = []
    for i, (p, prio) in enumerate(WAVE):
        hs.append(eng.submit(make_req(f"j{i}", p, prio_of(prio))))
        eng.step()
        eng.step()
    eng.run_until_idle()
    out = [h.result.tokens for h in hs]
    eng.stop()
    return out


def _treq(rid, p, prio):
    return GenRequest(id=rid, prompt=p, priority=prio, max_new_tokens=10)


def _jreq(rid, p, prio):
    return JGenRequest(id=rid, prompt=p, priority=prio, max_new_tokens=10)


@pytest.fixture(scope="module")
def off_streams(models):
    return _wave(_port_engine(models, slots=1), _treq, Priority.from_name)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_engine_streams_equal_at_every_depth(models, off_streams, depth):
    """Tolerance: none. The preemption wave on one slot gives the same
    streams with the pipeline at depths 1, 2 and 3 as with it off, and at
    depth 2 and over chunks were in flight two deep."""
    eng = _port_engine(models, AsyncPipelineConfig(depth=depth), slots=1)
    assert _wave(eng, _treq, Priority.from_name) == off_streams
    deepest = max(int(d) for d in eng.get_stats()["pipeline"]["depth_hist"])
    assert deepest <= depth and (depth == 1 or deepest >= 2)


@pytest.mark.parametrize("depth", [2, 3])
def test_engine_matches_jax_with_the_pipeline_on(models, depth):
    """Tolerance: none. The same wave through the port's and the JAX
    engine, both with the pipeline at ``depth``: the same streams."""
    assert _wave(_port_engine(models, AsyncPipelineConfig(depth=depth),
                              slots=1), _treq, Priority.from_name) == \
        _wave(_jax_engine(models, JPipe(depth=depth), slots=1), _jreq,
              JPriority.from_name)


def test_mixed_prefix_continuation_matches_jax(models):
    """Tolerance: none. Two turns of three conversations over the prefix
    cache with mixed batching and the pipeline on: the port's streams
    and cached counts are JAX's, and turn 2 reuses cached KV."""
    def run(eng, make_req):
        out = []
        for turn in range(2):
            hs = []
            for c in range(3):
                hs.append(eng.submit(make_req(
                    f"t{turn}c{c}", f" turn {turn} for conversation {c}",
                    f"conv{c}")))
                eng.step()
            eng.run_until_idle()
            out.append([(h.result.tokens, h.result.cached_tokens)
                        for h in hs])
        eng.stop()
        return out

    mixed = dict(enabled=True, prefill_token_budget=16, max_slices=2)
    port = run(_port_engine(models, AsyncPipelineConfig(),
                            MixedBatchConfig(**mixed),
                            PrefixCacheConfig(), slots=3),
               lambda rid, p, c: GenRequest(id=rid, prompt=p,
                                            conversation_id=c,
                                            max_new_tokens=8))
    ref = run(_jax_engine(models, JPipe(), JMixed(**mixed), JPrefix(),
                          slots=3),
              lambda rid, p, c: JGenRequest(id=rid, prompt=p,
                                            conversation_id=c,
                                            max_new_tokens=8))
    assert port == ref
    assert all(cached > 0 for _tok, cached in port[1])


@pytest.mark.parametrize("workers", [1, 2])
def test_tokens_reach_the_callback_before_done(models, workers):
    """Each request's callback sees its committed tokens in order, all of
    them before its handle completes, on completion threads only."""
    eng = _port_engine(models, AsyncPipelineConfig(
        completion_workers=workers))
    streams, threads, seen_at_done = {}, set(), {}

    def cb(rid):
        def on_token(t):
            threads.add(threading.current_thread().name)
            streams.setdefault(rid, []).append(t)
        return on_token

    hs = []
    for i, (p, prio) in enumerate(WAVE):
        rid = f"s{i}"
        h = eng.submit(GenRequest(id=rid, prompt=p,
                                  priority=Priority.from_name(prio),
                                  max_new_tokens=12), on_token=cb(rid))
        hs.append((rid, h))
        eng.step()
    eng.run_until_idle()
    for rid, h in hs:
        assert h.wait(5.0)
        seen_at_done[rid] = list(streams.get(rid, []))
        assert h.result.tokens == seen_at_done[rid], rid
    assert threads and all(t.startswith("completion-") for t in threads)
    eng.stop()


def test_callbacks_inline_with_the_pipeline_off(models):
    eng = _port_engine(models)
    seen = []
    h = eng.submit(GenRequest(id="x", prompt="inline tokens",
                              max_new_tokens=6),
                   on_token=lambda t: seen.append(
                       threading.current_thread().name))
    eng.run_until_idle()
    assert h.result is not None and seen
    assert set(seen) == {threading.current_thread().name}
    assert eng._completion is None


def test_cancel_with_a_chunk_in_flight(models):
    """A cancel that lands while chunks are dispatched is acted on at the
    next fresh dispatch: the stale chunk's tokens are dropped with the
    row, and no slot or page leaks."""
    eng = _port_engine(models, AsyncPipelineConfig())
    doomed = eng.submit(GenRequest(id="doomed",
                                   prompt="cancel me mid flight " * 2,
                                   max_new_tokens=16))
    keep = eng.submit(GenRequest(id="keep", prompt="steady " * 4,
                                 max_new_tokens=16))
    for _ in range(30):
        eng.step()
        if eng._inflight and doomed.request and not doomed.done:
            break
    assert eng._inflight
    doomed.cancel()
    eng.run_until_idle()
    assert doomed.result.finish_reason == "cancelled"
    assert keep.result.finish_reason in ("eos", "length")
    assert eng.allocator.used() == 0
    assert all(s is None for s in eng._slots)
    eng.stop()


def test_a_failed_fetch_fails_its_requests(models):
    """A chunk whose fetch raises: the error comes back on the stepping
    thread, every request riding the chunk finishes with an error (no
    retry, no blocking fallback), and the engine serves the next
    request."""
    eng = _port_engine(models, AsyncPipelineConfig())
    ex = eng.executor
    start = ex.decode_chunk_start

    def broken(*a, **k):
        h = start(*a, **k)

        class Broken:
            tok, pos, frozen = h.tok, h.pos, h.frozen

            def fetch(self):
                raise RuntimeError("device lost")
        return Broken()

    ex.decode_chunk_start = broken
    hs = [eng.submit(GenRequest(id=f"f{i}", prompt=f"doomed {i}",
                                max_new_tokens=8)) for i in range(2)]
    with pytest.raises(RuntimeError, match="device lost"):
        for _ in range(20):
            eng.step()
    eng.run_until_idle()
    for h in hs:
        assert h.result.finish_reason == "error"
        assert "device lost" in h.result.error
    ex.decode_chunk_start = start
    h = eng.submit(GenRequest(id="ok", prompt="fine now", max_new_tokens=4))
    eng.run_until_idle()
    assert h.result.finish_reason in ("eos", "length")
    assert eng.allocator.used() == 0
    eng.stop()


# -- configuration ------------------------------------------------------------

def test_config_defaults_validation_and_switches_match_jax(monkeypatch,
                                                           tmp_path):
    """The two blocks take the JAX package's defaults and validation, are
    reached through the same ``LLMQ_EXECUTOR_*`` variables (an invalid
    value raises there too), and the builder hands them to the engine:
    on by default, off by their switches."""
    # No config file in the working directory: defaults and env only.
    monkeypatch.chdir(tmp_path)
    from llmq_tpu.core import config as JC

    from llmq_tpu_torch.core import config as TC
    from llmq_tpu_torch.engine.builder import build_engine

    for name in ("AsyncPipelineConfig", "PrefixCacheConfig"):
        assert vars(getattr(TC, name)()) == vars(getattr(JC, name)()), name
    assert TC.VALID_PREFIX_EVICTION == JC.VALID_PREFIX_EVICTION
    for bad in (dict(depth=0), dict(depth=5), dict(completion_workers=9)):
        for mod in (TC, JC):
            with pytest.raises(ValueError):
                mod.AsyncPipelineConfig(**bad)
    for mod in (TC, JC):
        with pytest.raises(ValueError, match="eviction"):
            mod.PrefixCacheConfig(eviction="random")
    cfg = TC.load_config(environ={
        "LLMQ_EXECUTOR_ASYNC_PIPELINE_DEPTH": "3",
        "LLMQ_EXECUTOR_ASYNC_PIPELINE_COMPLETION_WORKERS": "2",
        "LLMQ_EXECUTOR_PREFIX_CACHE_EVICTION": "fifo",
        "LLMQ_EXECUTOR_PREFIX_CACHE_MAX_CACHED_PAGES": "7"})
    assert (cfg.executor.async_pipeline.depth,
            cfg.executor.async_pipeline.completion_workers) == (3, 2)
    assert (cfg.executor.prefix_cache.eviction,
            cfg.executor.prefix_cache.max_cached_pages) == ("fifo", 7)
    with pytest.raises(ValueError):
        TC.load_config(environ={"LLMQ_EXECUTOR_ASYNC_PIPELINE_DEPTH": "9"})

    def build(environ):
        cfg = TC.load_config(environ=environ)
        cfg.model.name = "llama3-tiny"
        cfg.device = "cpu"
        return build_engine(cfg)

    on = build({})
    assert on._pipe_cfg is not None and on._pipe_depth == 2
    assert on._completion_workers == 1 and on._prefix_cache is not None
    assert on.executor._staging.ring == 8
    off = build({"LLMQ_EXECUTOR_ASYNC_PIPELINE_ENABLED": "false",
                 "LLMQ_EXECUTOR_PREFIX_CACHE_ENABLED": "false"})
    assert off._pipe_cfg is None and off._pipe_depth == 2
    assert off._completion_workers == 0 and off._prefix_cache is None
    for eng in (on, off):
        h = eng.submit(GenRequest(id="x", prompt="hello", max_new_tokens=3))
        eng.run_until_idle()
        assert h.result.finish_reason in ("eos", "length")
        eng.stop()


def test_threaded_submitters_under_a_short_switch_interval(models):
    """Stress: 12 submitter threads (more than the cores) against a running
    engine with two completion threads and both fetch lanes, the
    interpreter switching threads every 10 µs. Every request completes
    exactly once, its callback saw exactly its tokens in order, and the
    pool holds nothing but the radix tree's pages once idle."""
    import sys

    eng = _port_engine(models, AsyncPipelineConfig(completion_workers=2),
                       MixedBatchConfig(enabled=True, prefill_token_budget=16,
                                        max_slices=2), PrefixCacheConfig())
    streams, handles, mu = {}, {}, threading.Lock()

    def submit(t):
        for i in range(3):
            rid = f"t{t}-{i}"
            seen = streams.setdefault(rid, [])
            h = eng.submit(GenRequest(id=rid, prompt=f"{t} stress {i} " * 3,
                                      max_new_tokens=6),
                           on_token=seen.append)
            with mu:
                handles[rid] = h

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    try:
        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for h in handles.values():
            assert h.wait(120)
    finally:
        eng.stop()
        sys.setswitchinterval(old)
    assert len(handles) == 36
    for rid, h in handles.items():
        assert h.result.finish_reason in ("eos", "length"), rid
        assert streams[rid] == h.result.tokens, rid
    assert eng.allocator.used() == eng.get_stats()["prefix_cache"]["pages"]
