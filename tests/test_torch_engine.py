"""The port's engine + TorchExecutor (CPU, plain twins) against the JAX
package's InferenceEngine + JaxExecutor on the same f32 weights.

Workload: prompts across all four priorities, a prompt longer than the
largest prefill bucket (chunked prefill), a two-turn conversation, and
one keep-pages preemption (four LOW requests decoding in four slots,
then a REALTIME arrival). The JAX engine runs with mixed batching, the
prefix cache and the async pipeline off and one-prompt prefill waves.
Greedy token streams must be identical (f32, exact), and so must the
turn-2 ``cached_tokens`` and every ``finish_reason``.

A second workload runs with token-budget mixed batching on, in bucket
mode and in ragged mode, against JAX engines with the same settings:
arrivals while others decode, a prompt of ~10 ragged capacities and a
two-turn conversation; streams must match JAX and each other.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.core.types import Priority as JPriority  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402

from llmq_tpu_torch.core.types import Priority  # noqa: E402
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402

KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512)

# The suite runs in several xdist workers on shared cores: one intra-op
# thread per worker avoids oversubscribing them (and runs faster here).
torch.set_num_threads(1)
GEOM = dict(batch_size=4, page_size=16, num_pages=128,
            prefill_buckets=[16, 32], eos_id=2, chunk_size=4)
MAX_STEPS = 12

PRIOS = ["realtime", "high", "normal", "low"]
PROMPTS = ["Queue the realtime one.", "High priority text here!",
           "normal: a middle-sized prompt", "low and slow"]
LONG = ("This prompt is deliberately longer than the largest prefill "
        "bucket, so it streams through in several chunks.")


def _workload(make_req, submit, step, run_until_idle, prio_of):
    """Drive one engine through the workload; returns {id: result}."""
    handles = {}
    for i, (p, text) in enumerate(zip(PRIOS, PROMPTS)):
        handles[f"p{i}"] = submit(make_req(f"p{i}", text, prio_of(p)))
    handles["long"] = submit(make_req("long", LONG, prio_of("low"),
                                      max_new_tokens=6))
    run_until_idle()
    handles["t1"] = submit(make_req("t1", "Hello there, conversation.",
                                    prio_of("high"), conversation_id="c1",
                                    max_new_tokens=6))
    run_until_idle()
    handles["t2"] = submit(make_req("t2", " And a second turn.",
                                    prio_of("high"), conversation_id="c1",
                                    max_new_tokens=6))
    run_until_idle()
    # Keep-pages preemption: fill every slot with decoding LOW work,
    # then a REALTIME arrival must displace one of them.
    lows = [f"low{i}" for i in range(4)]
    for i, rid in enumerate(lows):
        handles[rid] = submit(make_req(rid, f"background job {i}",
                                       prio_of("low"), max_new_tokens=40))
    for _ in range(200):
        if all("prefill_done" in handles[r].marks for r in lows):
            break
        step()
    handles["rt"] = submit(make_req("rt", "urgent!", prio_of("realtime"),
                                    max_new_tokens=8))
    run_until_idle()
    return {rid: h.result for rid, h in handles.items()}


@pytest.fixture(scope="module")
def results():
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")

    jex = JaxExecutor(jcfg, jparams, prefill_batch=1,
                      mixed_prefill_slices=0, **GEOM)
    jeng = JEngine(jex, JTok(), enable_metrics=False,
                   max_decode_steps=MAX_STEPS)
    jpre = []
    orig = jeng._preempt
    jeng._preempt = lambda victim, release_pages: (
        jpre.append((victim.req.id, release_pages)),
        orig(victim, release_pages))[1]

    def jreq(rid, text, prio, conversation_id="", max_new_tokens=0):
        return JGenRequest(id=rid, prompt=text, priority=prio,
                           conversation_id=conversation_id,
                           max_new_tokens=max_new_tokens)

    jres = _workload(jreq, jeng.submit, jeng.step, jeng.run_until_idle,
                     lambda p: JPriority.from_name(p))

    tex = TorchExecutor(tcfg, tparams, device="cpu", **GEOM)
    teng = InferenceEngine(tex, ByteTokenizer(), max_decode_steps=MAX_STEPS)
    tpre = []
    torig = teng._preempt
    teng._preempt = lambda victim, release_pages: (
        tpre.append((victim.req.id, release_pages)),
        torig(victim, release_pages))[1]

    def treq(rid, text, prio, conversation_id="", max_new_tokens=0):
        return GenRequest(id=rid, prompt=text, priority=prio,
                          conversation_id=conversation_id,
                          max_new_tokens=max_new_tokens)

    tres = _workload(treq, teng.submit, teng.step, teng.run_until_idle,
                     lambda p: Priority.from_name(p))
    return {"jax": jres, "torch": tres, "jax_preempt": jpre,
            "torch_preempt": tpre, "torch_engine": teng}


def test_greedy_streams_identical(results):
    j, t = results["jax"], results["torch"]
    assert set(j) == set(t)
    for rid in j:
        assert t[rid].tokens == j[rid].tokens, rid
        assert t[rid].text == j[rid].text, rid
        assert t[rid].prompt_tokens == j[rid].prompt_tokens, rid


def test_finish_reasons_match(results):
    j, t = results["jax"], results["torch"]
    for rid in j:
        assert t[rid].finish_reason == j[rid].finish_reason, rid
        assert t[rid].finish_reason in ("eos", "length"), rid


def test_turn_two_reuses_cached_kv(results):
    j, t = results["jax"], results["torch"]
    assert t["t1"].cached_tokens == j["t1"].cached_tokens == 0
    assert t["t2"].cached_tokens == j["t2"].cached_tokens > 0
    for rid in j:
        assert t[rid].cached_tokens == j[rid].cached_tokens, rid


def test_chunked_prefill_prompt_served(results):
    t = results["torch"]
    assert t["long"].prompt_tokens > GEOM["prefill_buckets"][-1] * 2
    assert len(t["long"].tokens) == 6 or t["long"].finish_reason == "eos"


def test_keep_pages_preemption_in_both(results):
    """A LOW slot holder was displaced by the REALTIME arrival, kept its
    pages (JAX: release_pages False), and still finished its stream."""
    jpre, tpre = results["jax_preempt"], results["torch_preempt"]
    assert jpre and all(not rel for _, rel in jpre)
    assert tpre and all(not rel for _, rel in tpre)
    assert tpre and all(v.startswith("low") for v, _ in tpre)
    assert {v for v, _ in jpre} == {v for v, _ in tpre}
    t = results["torch"]
    for rid, _ in tpre:
        assert t[rid].finish_reason in ("eos", "length")


def test_engine_leaves_pool_clean(results):
    """After the workload only the conversation's pinned pages remain."""
    eng = results["torch_engine"]
    assert eng.cached_conversations() == ["c1"]
    assert eng.allocator.used() == eng.allocator.pinned_pages() > 0
    eng.drop_conversation("c1")
    assert eng.allocator.used() == 0


def _pressure_workload(make_req, submit, run_until_idle, prio_of):
    """Two pinned conversations, then a prompt that only fits once the
    least recently used pin is reclaimed, then both second turns."""
    out = {}
    for rid, conv, text in (("a1", "ca", "alpha conversation, first turn"),
                            ("b1", "cb", "bravo conversation, first turn")):
        out[rid] = submit(make_req(rid, text, prio_of("high"),
                                   conversation_id=conv, max_new_tokens=6))
        run_until_idle()
    out["big"] = submit(make_req("big", "x" * 120, prio_of("normal"),
                                 max_new_tokens=6))
    run_until_idle()
    for rid, conv, text in (("a2", "ca", " alpha again"),
                            ("b2", "cb", " bravo again")):
        out[rid] = submit(make_req(rid, text, prio_of("high"),
                                   conversation_id=conv, max_new_tokens=6))
        run_until_idle()
    return {rid: h.result for rid, h in out.items()}


def test_pool_pressure_reclaims_lru_pin_like_jax():
    """11 usable pages of 16: the 120-token prompt needs 8, so the older
    pin (conversation ca) is reclaimed and its second turn starts from
    scratch, while cb's second turn still reuses its KV. Both engines
    agree on every stream and cached count."""
    geom = dict(GEOM, num_pages=12)
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = T.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jeng = JEngine(JaxExecutor(jcfg, jparams, prefill_batch=1,
                               mixed_prefill_slices=0, **geom),
                   JTok(), enable_metrics=False, max_decode_steps=MAX_STEPS)
    teng = InferenceEngine(
        TorchExecutor(T.get_config("llama3-tiny", dtype=torch.float32, **KW),
                      tparams, device="cpu", **geom),
        ByteTokenizer(), max_decode_steps=MAX_STEPS)
    j = _pressure_workload(
        lambda rid, text, prio, conversation_id="", max_new_tokens=0:
        JGenRequest(id=rid, prompt=text, priority=prio,
                    conversation_id=conversation_id,
                    max_new_tokens=max_new_tokens),
        jeng.submit, jeng.run_until_idle, JPriority.from_name)
    t = _pressure_workload(
        lambda rid, text, prio, conversation_id="", max_new_tokens=0:
        GenRequest(id=rid, prompt=text, priority=prio,
                   conversation_id=conversation_id,
                   max_new_tokens=max_new_tokens),
        teng.submit, teng.run_until_idle, Priority.from_name)
    assert t["a2"].cached_tokens == j["a2"].cached_tokens == 0
    assert t["b2"].cached_tokens == j["b2"].cached_tokens > 0
    for rid in j:
        assert t[rid].tokens == j[rid].tokens, rid
        assert t[rid].finish_reason == j[rid].finish_reason, rid


def _tiny_engine(**kw):
    cfg = T.get_config("llama3-tiny", dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    geom = dict(GEOM, num_pages=kw.pop("num_pages", GEOM["num_pages"]),
                batch_size=kw.pop("batch_size", GEOM["batch_size"]))
    return InferenceEngine(TorchExecutor(cfg, params, device="cpu", **geom),
                           ByteTokenizer(), **kw)


def test_pin_ttl_expiry_frees_the_conversation():
    import time

    eng = _tiny_engine(kv_pin_ttl=0.05, max_decode_steps=4)
    h = eng.submit(GenRequest(id="c", prompt="pin me", conversation_id="c"))
    eng.run_until_idle()
    assert h.result.finish_reason == "length"
    assert eng.cached_conversations() == ["c"] and eng.allocator.used() > 0
    time.sleep(0.1)
    eng.step()
    assert eng.cached_conversations() == []
    assert eng.allocator.used() == 0


def test_decode_without_pages_fails_the_request_not_truncates():
    """5 usable pages, two 30-token prompts growing toward 70 positions:
    the row that cannot get its next page is not truncated and no longer
    fails either (the name predates page-release preemption): it is
    preempted with its pages released, rebuilds once the other
    finishes, and both complete all 40 tokens, each the stream it gets
    alone."""
    eng = _tiny_engine(num_pages=6, batch_size=2, max_decode_steps=40)
    released = []
    orig = eng._preempt
    eng._preempt = lambda v, release_pages: (
        released.append((v.req.id, release_pages)),
        orig(v, release_pages))[1]
    hs = [eng.submit(GenRequest(id=f"r{i}", prompt=f"{i}" * 30,
                                max_new_tokens=40)) for i in range(2)]
    eng.run_until_idle()
    reasons = sorted(h.result.finish_reason for h in hs)
    assert reasons == ["length", "length"], reasons
    assert all(len(h.result.tokens) == 40 for h in hs)
    assert released and all(rel for _, rel in released)
    assert eng.allocator.used() == 0
    alone = _tiny_engine(num_pages=6, batch_size=1, max_decode_steps=40)
    for i, h in enumerate(hs):
        a = alone.submit(GenRequest(id=f"a{i}", prompt=f"{i}" * 30,
                                    max_new_tokens=40))
        alone.run_until_idle()
        assert a.result.tokens == h.result.tokens, i


@pytest.mark.parametrize("step_ms,cap", [(None, 12), (1.0, 16), (4.0, 12),
                                         (39.0, 2)])
def test_realtime_admission_cap_follows_measured_step_time(step_ms, cap):
    """A waiting REALTIME request caps the decode chunk at about 50 ms of
    the executor's measured steps (at least 2, at most 16); before any
    step is timed the JAX engine's 4 ms a step is assumed."""
    eng = _tiny_engine()
    eng.executor.step_ms = step_ms
    eng.submit(GenRequest(id="rt", prompt="urgent",
                          priority=Priority.REALTIME))
    eng._ingest()
    assert eng._admission_cap() == cap


def test_executor_times_decode_steps_after_the_first_call():
    """The first decode call (kernel build, allocator growth) is not
    timed; later calls feed a positive per-step moving average."""
    ex = _tiny_engine().executor
    B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
    args = (np.zeros(B, np.int32), np.zeros(B, np.int32),
            np.zeros((B, MP), np.int32), np.zeros(B, np.float32))
    ex.decode(*args)
    assert ex.step_ms is None
    ex.decode_chunk(*args, np.full(B, 2, np.int32))
    assert ex.step_ms is not None and ex.step_ms > 0


# -- token-budget mixed batching, bucket and ragged ----------------------------

MIXED_GEOM = dict(batch_size=3, page_size=16, num_pages=96,
                  prefill_buckets=[16, 64], eos_id=2, chunk_size=4,
                  mixed_prefill_slices=2, mixed_slice_tokens=8,
                  ragged_token_capacity=16, ragged_max_slices=2)
MIXED_WAVE = [("hello world this is a long prompt " * 3, "normal"),
              ("short", "realtime"),
              ("medium sized prompt here", "low"),
              ("another quite long prompt for slicing " * 2, "high"),
              ("fifth request", "normal"),
              ("x" * 150, "low")]     # ~10x the ragged capacity of 16


def _mixed_workload(submit, step, run_until_idle, make_req):
    """Arrivals while earlier requests decode (two engine steps apart),
    a prompt far beyond the ragged capacity, then a two-turn
    conversation whose second turn is a continuation prefill."""
    handles = {}
    for i, (text, prio) in enumerate(MIXED_WAVE):
        handles[f"w{i}"] = submit(make_req(f"w{i}", text, prio))
        step()
        step()
    run_until_idle()
    for turn, text in enumerate(("Hello there, conversation.",
                                 " And a second turn, a little longer.")):
        handles[f"t{turn}"] = submit(make_req(f"t{turn}", text, "high",
                                              conversation_id="c1"))
        run_until_idle()
    return {rid: h.result for rid, h in handles.items()}


def _jax_mixed(ragged: bool):
    from llmq_tpu.core.config import MixedBatchConfig as JMixed

    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    jex = JaxExecutor(jcfg, jparams, ragged_attention=ragged, **MIXED_GEOM)
    jeng = JEngine(jex, JTok(), enable_metrics=False,
                   max_decode_steps=MAX_STEPS,
                   mixed_batch=JMixed(enabled=True, prefill_token_budget=16,
                                      max_slices=2))
    res = _mixed_workload(
        jeng.submit, jeng.step, jeng.run_until_idle,
        lambda rid, text, prio, conversation_id="": JGenRequest(
            id=rid, prompt=text, priority=JPriority.from_name(prio),
            conversation_id=conversation_id, max_new_tokens=10))
    return res, jeng.mixed_steps


def _torch_mixed(ragged: bool, mixed: bool = True):
    from llmq_tpu_torch.core.config import MixedBatchConfig

    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(
        np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg)), device="cpu")
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    geom = dict(MIXED_GEOM)
    if not (mixed or ragged):
        geom.update(mixed_prefill_slices=0, mixed_slice_tokens=0)
    teng = InferenceEngine(
        TorchExecutor(tcfg, tparams, device="cpu", ragged_attention=ragged,
                      **geom),
        ByteTokenizer(), max_decode_steps=MAX_STEPS,
        mixed_batch=MixedBatchConfig(enabled=mixed, prefill_token_budget=16,
                                     max_slices=2))
    res = _mixed_workload(
        teng.submit, teng.step, teng.run_until_idle,
        lambda rid, text, prio, conversation_id="": GenRequest(
            id=rid, prompt=text, priority=Priority.from_name(prio),
            conversation_id=conversation_id, max_new_tokens=10))
    return res, teng


@pytest.fixture(scope="module")
def mixed_runs():
    return {"unfused": _torch_mixed(ragged=False, mixed=False)[0],
            "bucket": _torch_mixed(ragged=False),
            "ragged": _torch_mixed(ragged=True)}


def _same_streams(a, b):
    assert set(a) == set(b)
    for rid in a:
        assert a[rid].tokens == b[rid].tokens, rid
        assert a[rid].finish_reason == b[rid].finish_reason, rid
        assert a[rid].cached_tokens == b[rid].cached_tokens, rid


@pytest.mark.parametrize("mode", ["bucket", "ragged"])
def test_mixed_engine_streams_match_jax(mixed_runs, mode):
    """Greedy streams token for token against the JAX engine built with
    the same mixed_batch / ragged_attention settings (JAX's ragged
    program takes its plain route on the CPU); both engines took mixed
    steps, and turn 2 reused the conversation's KV."""
    jres, jsteps = _jax_mixed(ragged=(mode == "ragged"))
    tres, teng = mixed_runs[mode]
    assert jsteps > 0 and teng.mixed_steps > 0
    assert teng.mixed_prefill_tokens_total > 0
    _same_streams(tres, jres)
    assert tres["t1"].cached_tokens > 0
    assert tres["w5"].prompt_tokens >= 150


def test_ragged_on_equals_off_and_unfused(mixed_runs):
    """In the port, ragged on, ragged off (bucket mixed) and mixed
    batching off give identical streams, with mixed steps taken in both
    mixed modes; the engine leaves only the conversation's pages."""
    ragged, r_eng = mixed_runs["ragged"]
    bucket, b_eng = mixed_runs["bucket"]
    assert r_eng.mixed_steps > 0 and b_eng.mixed_steps > 0
    _same_streams(ragged, bucket)
    _same_streams(ragged, mixed_runs["unfused"])
    for eng in (r_eng, b_eng):
        assert eng.allocator.used() == eng.allocator.pinned_pages()


def test_ragged_prefill_runs_no_bucket_program(monkeypatch):
    """In ragged mode every prefill, the one with no decode row active
    included, goes through the ragged step: forward_prefill never runs,
    and a prompt of several capacities streams through."""
    _res, eng = _torch_mixed(ragged=True)
    calls = []
    monkeypatch.setattr(eng.executor.model, "forward_prefill",
                        lambda *a, **k: calls.append(a))
    h = eng.submit(GenRequest(id="long", prompt="y" * 70, max_new_tokens=3))
    eng.run_until_idle()
    assert h.result.finish_reason in ("eos", "length") and not calls
    assert h.result.prompt_tokens >= 70


# -- int8 serving: w8a8 weights and int8 KV pools -------------------------------
#
# With both switches on, a K/V value one f32 ulp apart before quantization
# can round to the neighbouring int8 value in one package and not the
# other, and int8 activations downstream amplify that to ~0.04 on the
# logits (tests/test_torch_model.py, INT8_KV_ATOL). A greedy stream can
# then part at a near-tie. So the streams are compared token for token,
# and where one parts from the JAX engine's, the parting is checked by
# teacher forcing: both packages' models, fed the same context (the
# JAX stream up to that token), must rank the two tokens within
# INT8_KV_ATOL of each other. The int8-weights-only and int8-KV-only
# engines must give the JAX streams exactly.

INT8_KV_ATOL = 0.1


def _int8_params(quant=True):
    """The f32 tiny model, quantized by the JAX package when ``quant``,
    and the same tree carried across (int8 and f32 leaves)."""
    from llmq_tpu.ops.quant import quantize_params as jquantize

    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    if quant:
        jparams = jquantize(jparams)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams


def _int8_engines(quant, kv, ragged):
    """Both engines on the mixed workload; returns (jax results, torch
    results, torch executor, models)."""
    from llmq_tpu.core.config import MixedBatchConfig as JMixed
    from llmq_tpu_torch.core.config import MixedBatchConfig

    jcfg, jparams, tparams = _int8_params(quant)
    jeng = JEngine(JaxExecutor(jcfg, jparams, ragged_attention=ragged,
                               cache_dtype=jnp.int8 if kv else None,
                               **MIXED_GEOM),
                   JTok(), enable_metrics=False, max_decode_steps=MAX_STEPS,
                   mixed_batch=JMixed(enabled=True, prefill_token_budget=16,
                                      max_slices=2))
    jres = _mixed_workload(
        jeng.submit, jeng.step, jeng.run_until_idle,
        lambda rid, text, prio, conversation_id="": JGenRequest(
            id=rid, prompt=text, priority=JPriority.from_name(prio),
            conversation_id=conversation_id, max_new_tokens=10))
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tex = TorchExecutor(tcfg, tparams, device="cpu", ragged_attention=ragged,
                        cache_dtype=torch.int8 if kv else None, **MIXED_GEOM)
    teng = InferenceEngine(tex, ByteTokenizer(), max_decode_steps=MAX_STEPS,
                           mixed_batch=MixedBatchConfig(
                               enabled=True, prefill_token_budget=16,
                               max_slices=2))
    tres = _mixed_workload(
        teng.submit, teng.step, teng.run_until_idle,
        lambda rid, text, prio, conversation_id="": GenRequest(
            id=rid, prompt=text, priority=Priority.from_name(prio),
            conversation_id=conversation_id, max_new_tokens=10))
    assert jeng.mixed_steps > 0 and teng.mixed_steps > 0
    return jres, tres, tex, (jcfg, jparams, tcfg, tparams)


def _teacher_forced_last_logits(models, context):
    """Both packages' f32 logits after ``context`` (one prefill chunk on
    fresh int8 pools): the next-token distributions at that point."""
    jcfg, jparams, tcfg, tparams = models
    n = len(context)
    pages = -(-(n + 1) // 16)
    bt = np.zeros((1, 8), np.int32)
    bt[0, :pages] = np.arange(1, pages + 1)
    toks = np.asarray([context], np.int32)
    pos = np.arange(n, dtype=np.int32)[None]
    lens = np.asarray([n], np.int32)
    jl, _ = J.forward_prefill(jparams, jcfg, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(lens),
                              J.init_kv_pages(jcfg, 16, 16, dtype=jnp.int8),
                              jnp.asarray(bt))
    tl = T.forward_prefill(tparams, tcfg, torch.tensor(toks),
                           torch.tensor(pos), torch.tensor(lens),
                           T.init_kv_pages(tcfg, 16, 16, "cpu",
                                           dtype=torch.int8),
                           torch.tensor(bt))
    return np.asarray(jl)[0, -1], tl[0, -1].numpy()


def _contexts():
    """Each request's context before its first generated token, as the
    engine builds it (turn 2: turn 1's prompt and stream, then its own
    prompt)."""
    tok = ByteTokenizer()
    ctx = {f"w{i}": tok.encode(text) for i, (text, _) in enumerate(MIXED_WAVE)}
    ctx["t0"] = tok.encode("Hello there, conversation.")
    return ctx, tok.encode(" And a second turn, a little longer.")


@pytest.mark.parametrize("mode", ["bucket", "ragged"])
def test_int8_engine_streams_match_jax(mode):
    """int8 weights and int8 KV, mixed batching on, ragged off then on,
    on the mixed workload (arrivals while others decode, a prompt of ~10
    ragged capacities, a two-turn conversation). Every stream equals the
    JAX engine's token for token up to where it parts at a near-tie
    (checked by teacher forcing, see above), finish reasons and cached
    counts too; both engines took mixed steps and the pools carry
    scales."""
    jres, tres, tex, models = _int8_engines(True, True, mode == "ragged")
    assert set(tex.cache) == {"k", "v", "k_scale", "v_scale"}
    assert tex.cache["k"].dtype == torch.int8
    assert tres["t1"].cached_tokens > 0
    ctx, t1_prompt = _contexts()
    ctx["t1"] = ctx["t0"] + jres["t0"].tokens + t1_prompt
    assert set(tres) == set(jres)
    parted = []
    for rid, j in jres.items():
        t = tres[rid]
        i = next((k for k, (a, b) in enumerate(zip(j.tokens, t.tokens))
                  if a != b), None)
        if i is None:
            assert t.tokens == j.tokens, rid
            assert t.finish_reason == j.finish_reason, rid
            assert t.cached_tokens == j.cached_tokens, rid
            continue
        parted.append(rid)
        jl, tl = _teacher_forced_last_logits(models, ctx[rid] + j.tokens[:i])
        a, b = j.tokens[i], t.tokens[i]
        for logits in (jl, tl):
            assert abs(logits[a] - logits[b]) <= INT8_KV_ATOL, (rid, i)
            assert logits.max() - max(logits[a], logits[b]) <= INT8_KV_ATOL
    assert len(parted) <= len(jres) // 2, parted


@pytest.mark.parametrize("quant,kv", [(True, False), (False, True)])
def test_int8_weights_or_kv_alone_streams_equal_jax(quant, kv):
    """One switch on at a time (they are independent, as in JAX), ragged
    on: the port's greedy streams equal the JAX engine's exactly."""
    jres, tres, tex, _models = _int8_engines(quant, kv, ragged=True)
    assert ("k_scale" in tex.cache) == kv
    _same_streams(tres, jres)


def test_int8_kv_has_no_split_decode_route():
    """As in the JAX package, the int8-KV decode step is the fused kernel
    only: asking for the split route with an int8 cache raises at
    construction."""
    cfg = T.get_config("llama3-tiny", dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="no int8-KV route"):
        TorchExecutor(cfg, params, device="cpu", fused_decode=False,
                      cache_dtype=torch.int8, **GEOM)


# -- cache-aware admission (the prefix cache's estimate) ------------------------

def _cache_aware_run(eng, sm, make_req, prio_of):
    """Two conversations (one of several pages, one shorter than a page)
    served to their end; four LOW rows decoding in the four slots; then a
    REALTIME second turn of the long conversation waits. Returns the
    estimates and admission caps the engine reports along the way."""
    out = {}
    for conv in ("c", "d"):
        sm.get_or_create(conv, "u")
    eng.attach_conversation_manager(sm)
    h = eng.submit(make_req("c1", "A conversation of several KV pages, "
                                  "turn one.", prio_of("high"),
                            conversation_id="c", max_new_tokens=6))
    eng.run_until_idle()
    eng.submit(make_req("d1", "tiny", prio_of("high"), conversation_id="d",
                        max_new_tokens=4))
    eng.run_until_idle()
    out["turn1"] = list(h.result.tokens)
    out["pinned"] = (eng.prefill_estimate("c", 7),
                     eng.prefill_estimate("d", 7))
    out["unknown"] = (eng.prefill_estimate("nobody", 7),
                      eng.prefill_estimate("", 5))
    lows = [eng.submit(make_req(f"low{i}", f"background job {i}",
                                prio_of("low"), max_new_tokens=12))
            for i in range(4)]
    for _ in range(200):
        if all("prefill_done" in x.marks for x in lows):
            break
        eng.step()
    eng.submit(make_req("c2", " ok?", prio_of("realtime"),
                        conversation_id="c", max_new_tokens=4))
    eng._ingest()
    caps = {}
    for step_ms in (None, 2.0, 30.0):
        eng.executor.step_ms = step_ms
        caps[step_ms] = eng._admission_cap()
    out["caps"] = caps
    eng.executor.step_ms = None
    eng.run_until_idle()
    # The pins reclaimed (LRU, as under pool pressure): "c" keeps a
    # handle the radix tree still covers, "d" (under a page) does not.
    while eng._reclaim_idle_conversation():
        pass
    out["handle"] = (eng.prefill_estimate("c", 7),
                     eng.prefill_estimate("d", 7))
    return out


@pytest.fixture(scope="module")
def cache_aware_runs():
    from llmq_tpu.conversation.state_manager import StateManager as JSM
    from llmq_tpu.core.config import ConversationConfig as JConvCfg
    from llmq_tpu.core.config import PrefixCacheConfig as JPrefixCfg

    from llmq_tpu_torch.conversation.state_manager import StateManager
    from llmq_tpu_torch.core.config import (ConversationConfig,
                                            PrefixCacheConfig)

    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jeng = JEngine(JaxExecutor(jcfg, jparams, prefill_batch=1,
                               mixed_prefill_slices=0, **GEOM), JTok(),
                   enable_metrics=False, max_decode_steps=MAX_STEPS,
                   prefix_cache=JPrefixCfg())
    teng = InferenceEngine(TorchExecutor(tcfg, tparams, device="cpu",
                                         **GEOM), ByteTokenizer(),
                           max_decode_steps=MAX_STEPS,
                           prefix_cache=PrefixCacheConfig(),
                           enable_metrics=False)
    return {
        "jax": _cache_aware_run(
            jeng, JSM(JConvCfg()),
            lambda rid, text, prio, **kw: JGenRequest(
                id=rid, prompt=text, priority=prio, **kw),
            JPriority.from_name),
        "port": _cache_aware_run(
            teng, StateManager(ConversationConfig()),
            lambda rid, text, prio, **kw: GenRequest(
                id=rid, prompt=text, priority=prio, **kw),
            Priority.from_name)}


def test_realtime_turn_with_pinned_kv_gets_the_halved_cap_like_jax(
        cache_aware_runs):
    """Tolerance: none. A waiting REALTIME turn whose conversation's KV is
    pinned (cached tokens > new) halves the admission cap in both
    engines, with no measured step time (4 ms assumed) and with one."""
    from llmq_tpu_torch.engine.engine import realtime_admission_cap

    j, t = cache_aware_runs["jax"], cache_aware_runs["port"]
    assert t["turn1"] == j["turn1"]
    assert t["caps"] == j["caps"]
    assert t["caps"] == {ms: max(2, realtime_admission_cap(ms) // 2)
                         for ms in (None, 2.0, 30.0)}


def test_prefill_estimate_matches_jax(cache_aware_runs):
    """Tolerance: none. Pinned conversations report their resident
    length; with the pin reclaimed, the recorded handle's full pages
    while the radix tree covers them, else none; unknown ones none."""
    j, t = cache_aware_runs["jax"], cache_aware_runs["port"]
    for key in ("pinned", "unknown", "handle"):
        assert t[key] == j[key], key
    (c, _), (d, _) = t["pinned"]
    assert c > 16 and 0 < d < 16
    assert t["unknown"] == ((0, 7), (0, 5))
    assert t["handle"][0][0] == (c // 16) * 16 > 0
    assert t["handle"][1] == (0, 7)
