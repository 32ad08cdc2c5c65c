"""The port's usage plane against the JAX package's: the page-second
tracker (shared pages split across their sharers), the ledger's
finalize, rollups, waste reasons and their reclassification, pinned KV,
the goodput window, the tenant label bound and the scrape-time counters,
on fake clocks shared by both packages' modules; then two tiny f32
engines attributing the same requests. Every comparison is exact unless
it says otherwise."""

import types
import uuid

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from prometheus_client import generate_latest  # noqa: E402
from prometheus_client.parser import text_string_to_metric_families  # noqa: E402

from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.kv_allocator import PageAllocator as JAlloc  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.metrics import registry as jreg  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.observability import slo as jslo  # noqa: E402
from llmq_tpu.observability import usage as jusage  # noqa: E402

from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.kv_allocator import PageAllocator  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.metrics import registry as treg  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.observability import slo as tslo  # noqa: E402
from llmq_tpu_torch.observability import usage as tusage  # noqa: E402

torch.set_num_threads(1)

MODS = {"jax": types.SimpleNamespace(usage=jusage, slo=jslo),
        "port": types.SimpleNamespace(usage=tusage, slo=tslo)}


class FakeTime:
    def __init__(self, t: float = 1_700_000_000.0) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    monotonic = perf_counter = time

    def advance(self, s: float) -> None:
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    fake = FakeTime()
    for mod in (jusage, tusage, jslo, tslo):
        monkeypatch.setattr(mod, "time", fake)
    return fake


@pytest.mark.parametrize("raw", [None, "", "  acme  ", "x" * 90, 42,
                                 "tenant/with spaces"])
def test_sanitize_tenant_is_jaxs(raw):
    assert tusage.sanitize_tenant(raw) == jusage.sanitize_tenant(raw)


def _tracker_run(mod, clock):
    tr = mod.usage.PageUsageTracker()
    out = []
    tr.update("a", 3)
    clock.advance(1.0)
    tr.update("b", 2, [7, 8])
    clock.advance(2.0)
    tr.update("c", 1, [8])
    clock.advance(0.5)
    out.append(tr.peek("a"))
    tr.update("b", 0, [7])
    clock.advance(4.0)
    out += [tr.close("b"), tr.close("nope"), tr.holders()]
    clock.advance(1.0)
    out += [tr.close("a"), tr.close("c"), tr.holders()]
    return out


def test_page_seconds_split_shared_pages_as_jax(clock):
    out = {}
    for side, mod in MODS.items():
        clock.t = 1000.0
        out[side] = _tracker_run(mod, clock)
    assert out["port"] == out["jax"]
    # b: 2 own + pages 7 and 8 alone for 2 s, then page 8 split with c
    # for 0.5 s, then page 7 alone for 4 s.
    assert out["port"][1] == pytest.approx(4.0 * 2 + 3.5 * 0.5 + 1.0 * 4)


def _ledger_run(mod, clock, tag):
    led = mod.usage.UsageLedger(max_tenants=2, max_conversations=2,
                                goodput_window_s=60.0, metrics=False)
    out = []

    def usage(dev, waste=0.0, reason="", kv=0.0, saved=0.0):
        u = mod.usage.RequestUsage()
        u.device_s, u.waste_s, u.waste_reason = dev, waste, reason
        u.kv_page_s, u.saved_prefill_device_s = kv, saved
        return u

    led.note_step(0.5, 0.4)
    led.note_step(0.2, 0.3)
    recs = [
        ("ok1", usage(0.1, kv=2.0), dict(tenant="acme", priority="high",
                                         conversation="c1", tokens=10,
                                         prompt_tokens=5)),
        ("rebuilt", usage(0.2, 0.05, "preempt"),
         dict(tenant="acme", priority="low", tokens=8, prompt_tokens=40)),
        ("shed", usage(0.3, 0.07, "shed", saved=0.01),
         dict(tenant="beta", priority="normal", conversation="c2",
              tokens=3)),
        ("failed", usage(0.2, 0.1, "preempt"),
         dict(tenant="gamma", priority="realtime", ok=False,
              waste_reason="crash")),
        ("cancel", usage(0.05), dict(tenant="deadbeefdeadbeef",
                                     priority="high", ok=False,
                                     waste_reason="cancelled",
                                     conversation="c3")),
        ("err", usage(0.04), dict(tenant="acme", priority="low", ok=False)),
    ]
    # A retry announced before the engine finalized is consumed there.
    led.note_retry(f"{tag}-err")
    for rid, u, kw in recs:
        out.append(led.finalize(f"{tag}-{rid}", u, engine="e", **kw))
        clock.advance(1.0)
    # A retry after the engine's finalize reclassifies "cancelled".
    led.note_retry(f"{tag}-cancel")
    led.note_retry(f"{tag}-failed")       # crash is not rewritable
    led.pin_kv("c1", 4, "acme")
    clock.advance(3.0)
    led.unpin_kv("c1")
    led.unpin_kv("never")
    for i, rid in enumerate(("ok1", "rebuilt", "shed", "failed")):
        led.observe_request(f"{tag}-{rid}",
                            {"ttft": (0.5, 2.5, 0.1, 0.1)[i]},
                            ("high", "low", "realtime", "realtime")[i],
                            (100.0, 100.0, 600.0, 10.0)[i])
    led.observe_request("unknown", {}, "high", 1.0)
    out += [led.snapshot(), led.get(f"{tag}-shed"), led.get("nope"),
            led.goodput(), [led.tenant_label(t) for t in
                            ("acme", "beta", "gamma", str(uuid.UUID(int=3)),
                             "acme")]]
    clock.advance(120.0)
    out.append(led.goodput())
    led.clear()
    out.append(led.snapshot())
    return out


def test_ledger_rollups_waste_and_goodput_are_jaxs(clock):
    out = {}
    for side, mod in MODS.items():
        clock.t = 1_700_000_000.0
        out[side] = _ledger_run(mod, clock, "L")
    assert out["port"] == out["jax"]
    snap = out["port"][6]
    assert snap["waste_by_reason"] == {"preempt": 0.05, "shed": 0.07,
                                       "crash": 0.3, "retry": 0.09,
                                       "cancelled": 0.0}
    assert snap["goodput"]["slo_met_requests"] == 1


def test_ledger_flush_counters_are_jaxs(clock):
    """The scrape-time flush moves the same counters by the same
    amounts (as deltas: the families are process-wide)."""
    tenant = f"t{uuid.uuid4().hex[:6]}"
    fams = ("usage_device_seconds_total", "usage_waste_seconds_total",
            "usage_kv_page_seconds_total",
            "usage_saved_prefill_device_seconds_total")

    def read(side):
        text = (generate_latest(jreg.REGISTRY).decode() if side == "jax"
                else treg.REGISTRY.exposition().decode())
        got = {}
        for fam in text_string_to_metric_families(text):
            for s in fam.samples:
                if s.name.startswith("llm_queue_") and \
                        s.name[len("llm_queue_"):] in fams:
                    key = (s.name, tuple(sorted(s.labels.items())))
                    got[key] = s.value
        return got

    deltas = {}
    for side, mod in MODS.items():
        before = read(side)
        led = mod.usage.UsageLedger(max_tenants=1)
        u = mod.usage.RequestUsage()
        u.device_s, u.kv_page_s, u.saved_prefill_device_s = 0.25, 3.0, 0.5
        led.finalize(f"{side}-a", u, tenant=tenant, priority="high",
                     engine="e", tokens=4)
        u = mod.usage.RequestUsage()
        u.device_s = 0.125
        led.finalize(f"{side}-b", u, tenant=tenant + "x", priority="low",
                     engine="e", ok=False, waste_reason="shed")
        assert led.flush() == 2
        after = read(side)
        deltas[side] = {k: v - before.get(k, 0.0) for k, v in after.items()
                        if v != before.get(k, 0.0)}
    assert deltas["port"] == deltas["jax"]
    assert len(deltas["port"]) == 4


def test_allocator_fragmentation_is_jaxs():
    rng = np.random.default_rng(3)
    j, t = JAlloc(64, 16), PageAllocator(64, 16)
    held = []
    for step in range(60):
        if held and rng.random() < 0.45:
            i = int(rng.integers(len(held)))
            pj, pt = held.pop(i)
            j.free(pj)
            t.free(pt)
        else:
            n = int(rng.integers(1, 5))
            pj, pt = j.alloc(n), t.alloc(n)
            assert pj == pt
            if pj is not None:
                held.append((pj, pt))
        assert t.fragmentation() == j.fragmentation(), step
    assert t.fragmentation() > 0


# -- two engines, one ledger each ------------------------------------------------

KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512, max_seq_len=256)
GEOM = dict(batch_size=4, page_size=16, num_pages=128, prefill_buckets=[16, 32],
            eos_id=-1, chunk_size=4, mixed_prefill_slices=2,
            mixed_slice_tokens=8)


def _serve(eng, make_req, tag):
    """A conversation's two turns (the second adopts the first's pinned
    KV), two tenants, a row decoding while others prefill."""
    ids = []

    def go(rid, text, n, **kw):
        ids.append(f"{tag}-{rid}")
        return eng.submit(make_req(ids[-1], text, n, **kw))

    go("t1", "Hello there, conversation.", 6, conversation_id=f"{tag}-c",
       tenant_id="acme")
    eng.run_until_idle()
    go("t2", " And a second turn.", 6, conversation_id=f"{tag}-c",
       tenant_id="acme")
    go("long", "The long one decodes while others arrive " * 2, 20,
       tenant_id="beta")
    for _ in range(4):
        eng.step()
    go("late", "late arrival: " + "y" * 50, 5, tenant_id="beta")
    eng.run_until_idle()
    return ids


@pytest.fixture(scope="module")
def engines():
    jusage.get_usage_ledger().reconfigure(enabled=True)
    tusage.get_usage_ledger().reconfigure(enabled=True)
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tag = f"use{uuid.uuid4().hex[:8]}"
    jeng = JEngine(JaxExecutor(jcfg, jparams, telemetry_name=f"{tag}-j",
                               **GEOM), JTok(), name=f"{tag}-j",
                   max_decode_steps=32)
    teng = InferenceEngine(TorchExecutor(tcfg, tparams, device="cpu",
                                         telemetry_name=f"{tag}-t", **GEOM),
                           ByteTokenizer(), name=f"{tag}-t",
                           max_decode_steps=32)
    out = {"jax": (jeng, _serve(jeng, lambda rid, text, n, **kw: JGenRequest(
        id=rid, prompt=text, max_new_tokens=n, **kw), f"{tag}-j")),
        "port": (teng, _serve(teng, lambda rid, text, n, **kw: GenRequest(
            id=rid, prompt=text, max_new_tokens=n, **kw), f"{tag}-t"))}
    yield out
    jeng.stop()
    teng.stop()


def test_engines_attribute_the_same_tokens_and_tenants(engines):
    """Tolerance: none for the counts, tenants and reasons; the measured
    seconds are two engines' clocks, held to their invariants: page
    seconds positive, the cached turn credited with saved prefill, and
    every request's attributed device time within what the ledger
    measured."""
    (jeng, jids), (teng, tids) = engines["jax"], engines["port"]
    jl, tl = jusage.get_usage_ledger(), tusage.get_usage_ledger()
    for jid, tid in zip(jids, tids):
        j, t = jl.get(jid), tl.get(tid)
        for k in ("tenant", "priority", "tokens", "prompt_tokens",
                  "waste_reason", "waste_seconds"):
            assert t[k] == j[k], (tid, k, t, j)
        assert set(t) == set(j)
        assert t["kv_page_seconds"] > 0
    t2 = tl.get(tids[1])
    assert t2["saved_prefill_device_seconds"] > 0
    assert jl.get(jids[1])["saved_prefill_device_seconds"] > 0
    snap = tl.snapshot()
    assert snap["totals"]["attributed_device_seconds"] <= \
        snap["totals"]["device_seconds"] + 1e-9
    assert sum(tl.get(t)["device_seconds"] for t in tids) <= \
        snap["totals"]["attributed_device_seconds"] + 1e-6


def test_handle_and_message_usage_carry_jaxs_fields(engines):
    """``process_fn`` fills ``metadata["usage"]`` with JAX's ten fields."""
    from llmq_tpu.core.types import Message as JMessage

    from llmq_tpu_torch.core.types import Message

    (jeng, _), (teng, _) = engines["jax"], engines["port"]
    got = {}
    for side, eng, cls in (("jax", jeng, JMessage), ("port", teng, Message)):
        eng.start()
        try:
            msg = cls(id=f"{side}-{uuid.uuid4()}", content="usage fields",
                      metadata={"max_new_tokens": 3}, tenant_id="acme")
            eng.process_fn(None, msg)
        finally:
            eng.stop()
        got[side] = msg.metadata["usage"]
    assert set(got["port"]) == set(got["jax"])
    assert len(got["port"]) == 10
    for k in ("tenant", "prompt_tokens", "completion_tokens", "cached_tokens",
              "finish_reason", "waste_reason"):
        assert got["port"][k] == got["jax"][k], k
