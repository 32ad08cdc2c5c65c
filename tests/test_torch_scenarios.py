"""The port's scenario engine against the JAX package's, on the CPU.

Mirrors ``tests/test_scenarios.py`` case for case on the port's
``llmq_tpu_torch.scenarios`` (spec model and compiler, reduced-scale
closed-loop runs on the echo engine, the tenant registry's eviction
counter, and the two ``slow`` full-scale bars), and holds the two
packages together:

- both compilers give the same ``schedule_digest``, ``total_turns`` and
  ``planned_tenant_tokens`` for every shipped spec at scales 0.05, 0.1
  and 1.0 (tolerance: none), and refuse the same bad specs with the same
  messages;
- on the echo engine with a ``FakeClock``, both ``run_scenario`` give the
  same report fields: requests, tokens, chaos fired, recoveries, share
  errors, tenancy rejections and invariants (tolerance: none, except
  that the attempts an ``engine.step`` crash fails are the ones in
  flight when it lands, a race between the driver and the engine thread
  in both packages: there the failed, retried and submitted counts are
  held to ``submitted == completed + failed`` and ``retried == failed``
  in each, and the streams the checker saw, which count the failed
  attempts that streamed a token before the crash, to at least one a
  completed turn);
- an inline spec of 3 conversations x 2 turns through both drivers over
  float32 ``llama3-tiny`` engines with the same weights
  (``params_from_jax``) gives each turn the same tokens and text;
- the ``scenarios`` subcommand prints JAX's summary keys on echo and
  exits with JAX's codes (``tests/test_torch_scenarios_cli.py``).
"""

from __future__ import annotations

import json
import logging
import os
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu import chaos as jchaos  # noqa: E402
from llmq_tpu import scenarios as jscn  # noqa: E402
from llmq_tpu.core import config as JC  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.metrics import registry as jreg  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.observability.recorder import get_recorder as jrecorder  # noqa: E402
from llmq_tpu.observability.usage import get_usage_ledger as jledger  # noqa: E402
from llmq_tpu import tenancy as jten  # noqa: E402

from llmq_tpu_torch import chaos as tchaos  # noqa: E402
from llmq_tpu_torch import scenarios as tscn  # noqa: E402
from llmq_tpu_torch.core import config as TC  # noqa: E402
from llmq_tpu_torch.engine.engine import InferenceEngine as TEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer as TTok  # noqa: E402
from llmq_tpu_torch.metrics import registry as treg  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.observability.recorder import get_recorder as trecorder  # noqa: E402
from llmq_tpu_torch.observability.usage import get_usage_ledger as tledger  # noqa: E402
from llmq_tpu_torch import tenancy as tten  # noqa: E402

pytestmark = [
    pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning"),
]

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(
    name="jax", scn=jscn, chaos=jchaos, C=JC, ten=jten, ledger=jledger,
    recorder=jrecorder, exposition=lambda: jreg.exposition().decode())
PORT = types.SimpleNamespace(
    name="port", scn=tscn, chaos=tchaos, C=TC, ten=tten, ledger=tledger,
    recorder=trecorder, exposition=lambda: treg.exposition().decode())
PKGS = (JAX, PORT)

#: Loggers that narrate every preemption, eviction and crash of a run.
_NOISY = ("llmq.engine", "llmq.supervisor", "llmq.chaos", "llmq.tiering",
          "llmq.scenarios", "llmq_tpu_torch.engine",
          "llmq_tpu_torch.supervisor", "llmq_tpu_torch.chaos",
          "llmq_tpu_torch.tiering", "llmq_tpu_torch.scenarios")


@pytest.fixture(autouse=True)
def _quiet_and_reset():
    """Each case leaves both packages' chaos, tenancy, usage ledger and
    flight recorder as it found them (the ledger's switch too)."""
    prev = {}
    for name in _NOISY:
        lg = logging.getLogger(name)
        prev[name] = lg.level
        lg.setLevel(logging.ERROR)
    was = {P.name: P.ledger().enabled for P in PKGS}
    yield
    for name, lvl in prev.items():
        logging.getLogger(name).setLevel(lvl)
    for P in PKGS:
        P.chaos.configure(P.C.ChaosConfig(enabled=False))
        P.ten.reset_tenancy()
        led = P.ledger()
        led.reconfigure(enabled=was[P.name])
        led.clear()
        P.recorder().clear()


def _same(run):
    """``run`` over both packages; the outcomes must be equal."""
    out = {P.name: run(P) for P in PKGS}
    assert out["jax"] == out["port"], out
    return out["port"]


# -- spec + compiler -----------------------------------------------------------


class TestSpecAndCompiler:
    def test_shipped_scenarios_all_load(self):
        def run(P):
            names = P.scn.list_scenarios()
            for want in P.scn.SHIPPED:
                assert want in names
            for name in P.scn.SHIPPED:
                spec = P.scn.load_named(name)
                assert spec.name == name
                assert spec.phases and spec.populations
            return names, list(P.scn.SHIPPED)

        _same(run)
        assert tscn.scenario_dir() == os.path.join(REPO, "configs",
                                                   "scenarios")

    def test_compile_is_deterministic(self):
        """Same spec + seed ⇒ identical schedule, in each package and
        across them."""
        def run(P):
            out = {}
            for name in P.scn.SHIPPED:
                spec = P.scn.load_named(name)
                a = P.scn.compile_scenario(spec, scale=0.02)
                b = P.scn.compile_scenario(spec, scale=0.02)
                assert a.schedule_digest() == b.schedule_digest(), name
                assert [x.t for x in a.arrivals] == \
                    [x.t for x in b.arrivals]
                out[name] = a.schedule_digest()
            return out

        _same(run)

    def test_seed_changes_schedule(self):
        def run(P):
            spec = P.scn.load_named("agentic_tool_loops")
            base = P.scn.compile_scenario(spec, scale=0.1).schedule_digest()
            spec.seed += 1
            other = P.scn.compile_scenario(spec, scale=0.1).schedule_digest()
            assert other != base
            return base, other

        _same(run)

    def test_scale_thins_arrivals(self):
        def run(P):
            spec = P.scn.load_named("conversation_soak_100k")
            small = P.scn.compile_scenario(spec, scale=0.01)
            big = P.scn.compile_scenario(spec, scale=0.03)
            assert 0 < len(small.arrivals) < len(big.arrivals)
            assert len(small.arrivals) <= int(spec.max_conversations * 0.01)
            return len(small.arrivals), len(big.arrivals)

        _same(run)

    def test_unknown_key_rejected(self):
        def run(P):
            with pytest.raises(ValueError, match="unknown") as e:
                P.scn.spec_from_dict({"name": "x", "bogus": 1})
            return str(e.value)

        _same(run)

    def test_bad_arrival_kind_rejected(self):
        def run(P):
            with pytest.raises(ValueError, match="arrival kind") as e:
                P.scn.spec_from_dict({
                    "name": "x",
                    "phases": [{"name": "p", "duration_s": 1.0,
                                "arrival": {"kind": "zipf"}}],
                    "populations": [{"name": "p0"}],
                })
            return str(e.value)

        _same(run)

    def test_replay_arrivals_from_trace(self, tmp_path):
        trace = tmp_path / "trace.jsonl"
        trace.write_text('{"at": 0.25}\n0.75\n{"at": 99.0}\n2.5\n')

        def run(P):
            spec = P.scn.spec_from_dict({
                "name": "rp", "seed": 7,
                "phases": [{"name": "p", "duration_s": 3.0,
                            "arrival": {"kind": "replay",
                                        "trace_file": str(trace)}}],
                "populations": [{"name": "p0", "turns_min": 1,
                                 "turns_max": 1}],
            })
            compiled = P.scn.compile_scenario(spec)
            # 99.0 falls outside the phase; the rest replay in order.
            assert [a.t for a in compiled.arrivals] == [0.25, 0.75, 2.5]
            return compiled.schedule_digest()

        _same(run)

    def test_replay_requires_trace_file(self):
        def run(P):
            with pytest.raises(ValueError, match="trace_file") as e:
                P.scn.spec_from_dict({
                    "name": "x",
                    "phases": [{"name": "p", "duration_s": 1.0,
                                "arrival": {"kind": "replay"}}],
                    "populations": [{"name": "p0"}],
                })
            return str(e.value)

        _same(run)


@pytest.mark.parametrize("scale", [0.05, 0.1, 1.0])
@pytest.mark.parametrize("name", jscn.SHIPPED)
def test_schedule_equals_jaxs(name, scale):
    """Tolerance: none. The port's compiler materialises the JAX
    compiler's schedule: digest, turns and planned tenant tokens."""
    def run(P):
        c = P.scn.compile_scenario(P.scn.load_named(name), scale=scale)
        return (c.schedule_digest(), c.total_turns,
                c.planned_tenant_tokens(), len(c.arrivals),
                [(e.at_s, e.point, e.kind, e.times) for e in c.chaos])

    _same(run)


def test_chip_smokes_scenario_digests_are_jaxs():
    """Tolerance: none. The schedule digests ``chip_smoke.py``'s
    ``serve-scenarios`` gates on are the JAX compiler's for those specs
    at those scales."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert [n for n, _s, _d in mod.SCENARIO_RUNS] == [
        "agentic_tool_loops", "diurnal_tenant_mix_with_flash_crowd",
        "rag_long_prompt_flood"]
    for name, scale, digest in mod.SCENARIO_RUNS:
        assert jscn.compile_scenario(jscn.load_named(name),
                                     scale=scale).schedule_digest() == digest


@pytest.mark.parametrize("data,match", [
    ({"name": "x", "phases": [{"name": "p"}], "populations": [{"name": "a"}],
      "nope": 1}, "unknown ScenarioSpec keys"),
    ({"name": "x", "phases": [{"name": "p", "burst": 2}],
      "populations": [{"name": "a"}]}, "unknown PhaseSpec keys"),
    ({"name": "x", "phases": [{"name": "p", "arrival": {"kind": "zipf"}}],
      "populations": [{"name": "a"}]}, "arrival kind"),
    ({"name": "x", "phases": [{"name": "p", "arrival": {"kind": "replay"}}],
      "populations": [{"name": "a"}]}, "trace_file"),
    ({"name": "x", "phases": [], "populations": [{"name": "a"}]},
     "no phases"),
    ({"name": "x", "phases": [{"name": "p"}],
      "populations": [{"name": "a", "turns_min": 3, "turns_max": 2}]},
     "turn depth"),
    ({"name": "x", "phases": [{"name": "p"}], "populations": [{"name": "a"}],
      "chaos_events": [{"kind": "meteor"}]}, "chaos kind"),
])
def test_refusals_equal_jaxs(data, match):
    """Tolerance: none. The same bad spec raises the same ValueError
    message in both packages."""
    def run(P):
        with pytest.raises(ValueError, match=match) as e:
            P.scn.spec_from_dict(data)
        return str(e.value)

    _same(run)


# -- reduced-scale closed-loop runs (CI smoke) ---------------------------------


class TestScenarioRuns:
    def test_agentic_loop_report_contract(self, tmp_path):
        """Each run emits SCENARIO_<name>.json with goodput, share-error,
        waste and tier-hit fields populated (the port's run)."""
        rep = tscn.run_scenario("agentic_tool_loops", scale=0.05,
                                out_dir=str(tmp_path), emit_json=True)
        req = rep["requests"]
        assert req["submitted"] > 0
        assert req["completed"] == req["turns_planned"]
        assert req["failed"] == 0 and req["shed"] == 0
        # Goodput joined from the usage ledger, not driver arithmetic.
        assert rep["goodput"]["tokens_per_device_second"] > 0
        assert rep["driver_goodput_tps"] > 0
        assert rep["slo"]["met_requests"] > 0
        se = rep["share_error"]
        assert set(se["tenants"]) == {"agents-team", "batch-agents"}
        assert se["max_abs_error"] < 0.2
        assert "by_reason" in rep["waste"] and "ratio" in rep["waste"]
        assert rep["tier_hits"]["requests_by_tier"]
        inv = rep["invariants"]
        assert inv["violations"] == 0
        assert inv["submitted"] == req["submitted"]
        assert inv["terminal"]["completed"] == req["completed"]
        # FakeClock compression: 30 virtual seconds in far less wall.
        assert rep["duration"]["compression"] > 1.0
        path = os.path.join(str(tmp_path),
                            "SCENARIO_agentic_tool_loops.json")
        assert rep["report_path"] == path
        with open(path, "r", encoding="utf-8") as f:
            on_disk = json.load(f)
        for key in ("goodput", "share_error", "waste", "tier_hits",
                    "invariants", "timeline", "schedule_digest"):
            assert key in on_disk, key

    def test_run_is_deterministic(self):
        a = tscn.run_scenario("rag_long_prompt_flood", scale=0.1)
        b = tscn.run_scenario("rag_long_prompt_flood", scale=0.1)
        assert a["schedule_digest"] == b["schedule_digest"]
        assert a["requests"]["turns_planned"] == \
            b["requests"]["turns_planned"]
        assert a["tokens"] == b["tokens"]

    def test_flash_crowd_survives_chaos_kill(self):
        """The mid-run engine crash: the supervisor recovers and the
        driver retries, zero loss, no duplicate terminal states."""
        rep = tscn.run_scenario("diurnal_tenant_mix_with_flash_crowd",
                                scale=0.1)
        req = rep["requests"]
        assert req["chaos_events_fired"] == 1
        assert req["engine_recoveries"] >= 1
        assert req["completed"] == req["turns_planned"]
        assert req["submitted"] == req["completed"] + req["failed"]
        assert req["retried"] == req["failed"]
        assert rep["invariants"]["violations"] == 0
        assert rep["goodput"]["tokens_per_device_second"] > 0
        assert set(rep["share_error"]["tenants"]) == \
            {"gold", "silver", "bronze"}

    def test_spray_probe_sheds_at_quota_edge(self):
        """Sprayed fresh tenants get turn 1 admitted (burst debt) and
        turn 2 shed by the rate quota; the configured tenant keeps
        flowing; the rejection counter drains through the flush."""
        rep = tscn.run_scenario("adversarial_id_spray_quota_probe",
                                scale=0.15)
        req = rep["requests"]
        assert req["shed"] > 0
        assert req["completed"] > 0
        assert rep["tenancy"]["rejections"].get("rate", 0) == req["shed"]
        assert "acme" in rep["share_error"]["tenants"]
        assert rep["share_error"]["tenants"]["acme"]["achieved_share"] > 0
        assert "llm_queue_tenant_registry_evictions_total" in \
            PORT.exposition()

    def test_soak_ci_smoke(self):
        """Reduced-scale soak: both kills fire and recover, zero loss,
        goodput populated, a timeline to judge steady state on."""
        rep = tscn.run_scenario("conversation_soak_100k", scale=0.02)
        req = rep["requests"]
        assert req["chaos_events_fired"] == 2
        assert req["engine_recoveries"] == 2
        assert req["completed"] == req["turns_planned"]
        assert req["submitted"] == req["completed"] + req["failed"]
        assert rep["invariants"]["violations"] == 0
        assert rep["goodput"]["tokens_per_device_second"] > 0
        assert len(rep["timeline"]) >= 6
        assert tscn.steady_state_deviation(rep) is not None


def _report_fields(rep):
    """The fields both packages' reports must share."""
    out = {"requests": dict(rep["requests"]), "tokens": rep["tokens"],
           "share_error": rep["share_error"],
           "invariants": dict(rep["invariants"]),
           "tier_hits": rep["tier_hits"]["requests_by_tier"],
           "timeline_buckets": len(rep["timeline"]),
           "schedule_digest": rep["schedule_digest"],
           "tenancy": rep.get("tenancy")}
    out["invariants"]["terminal"] = dict(out["invariants"]["terminal"])
    return out


@pytest.mark.parametrize("name,scale", [
    ("agentic_tool_loops", 0.05),
    ("rag_long_prompt_flood", 0.05),
    ("diurnal_tenant_mix_with_flash_crowd", 0.05),
    ("adversarial_id_spray_quota_probe", 0.05),
    ("conversation_soak_100k", 0.02),
    ("store_brownout", 0.05),
    ("disagg_long_prompt_handoff", 0.05),
])
def test_echo_report_equals_jaxs(name, scale):
    """Both packages' ``run_scenario`` on their echo engines with a
    FakeClock: the same requests, tokens, chaos fired, recoveries, share
    errors, tenancy rejections, tier hits and invariants (tolerance:
    none; the crash-failed attempts as the module docstring says)."""
    got = {P.name: _report_fields(P.scn.run_scenario(name, scale=scale))
           for P in PKGS}
    crash = any(ev.point == "engine.step"
                for ev in jscn.load_named(name).chaos_events)
    if crash:
        for rep in got.values():
            req, inv = rep["requests"], rep["invariants"]
            assert req["submitted"] == req["completed"] + req["failed"]
            assert req["retried"] == req["failed"] >= 1
            assert inv["submitted"] == req["submitted"]
            assert inv["terminal"].get("failed", 0) == req["failed"]
            assert inv["streams"] >= req["completed"]
            for d, keys in ((req, ("submitted", "failed", "retried")),
                            (inv, ("submitted", "streams")),
                            (inv["terminal"], ("failed",))):
                for k in keys:
                    d.pop(k, None)
    assert got["jax"] == got["port"], got
    rep = got["port"]
    assert rep["invariants"]["violations"] == 0
    req = rep["requests"]
    assert req["completed"] + req["shed"] == req["turns_planned"]


# -- the f32 llama3-tiny engines -----------------------------------------------

KW = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          vocab_size=512, max_seq_len=256)
GEOM = dict(batch_size=4, page_size=8, num_pages=128,
            prefill_buckets=[16, 64, 128], chunk_size=4)

#: 3 conversations x 2 turns, all arriving in the first tick; turn 2
#: re-arrives as soon as turn 1 completes, with turn 1's text in its
#: history.
TINY_SPEC = {
    "name": "tiny_pairs", "seed": 11, "tick_s": 0.25, "retries": 0,
    "max_conversations": 3,
    "phases": [{"name": "p", "duration_s": 1.0,
                "arrival": {"kind": "poisson", "rate": 200.0}}],
    "populations": [{"name": "chat", "tenants": {"a": 1.0, "b": 1.0},
                     "turns_min": 2, "turns_max": 2,
                     "prompt_tokens_min": 4, "prompt_tokens_max": 8,
                     "followup_tokens_min": 2, "followup_tokens_max": 4,
                     "output_tokens_min": 6, "output_tokens_max": 10}],
}


def test_tiny_model_turns_equal_jaxs():
    """Tolerance: none. The same inline spec through both drivers over
    float32 llama3-tiny engines with the same weights: every turn's
    tokens and text are equal, and every turn completes."""
    jcfg = J.llama3_tiny(dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.llama3_tiny(dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")

    def run(P):
        if P is JAX:
            tok = JTok()
            ex = JaxExecutor(jcfg, jparams, eos_id=tok.eos_id, **GEOM)
            eng = JEngine(ex, tok, name="scn-tiny", enable_metrics=False,
                          max_decode_steps=12)
        else:
            tok = TTok()
            ex = TorchExecutor(tcfg, tparams, eos_id=tok.eos_id,
                               device="cpu", **GEOM)
            eng = TEngine(ex, tok, name="scn-tiny", enable_metrics=False,
                          max_decode_steps=12)
        target = P.scn.EngineTarget(eng, own=True)
        turns = {}
        poll = target.poll

        def recording_poll(handle):
            res = poll(handle)
            if res is not None:
                turns[handle.request.id] = (res["token_ids"], res["text"],
                                            res["ok"])
            return res

        target.poll = recording_poll
        try:
            rep = P.scn.run_scenario(TINY_SPEC, target=target)
        finally:
            target.stop()
        return {"turns": turns, "requests": rep["requests"],
                "tokens": rep["tokens"]}

    got = _same(run)
    assert len(got["turns"]) == 6
    assert all(ok and ids for ids, _text, ok in got["turns"].values())
    assert got["requests"]["completed"] == 6


def test_pool_target_report_equals_jaxs():
    """Tolerance: none. ``agentic_tool_loops`` at 0.05 round robin over
    two echo replicas of each package's ``LocalEnginePool`` (their own
    threaded supervisors): the same requests, tokens, share errors and
    invariants, and decommissioning stops both replicas."""
    from llmq_tpu.controlplane import LocalEnginePool as JPool
    from llmq_tpu_torch.controlplane import LocalEnginePool as TPool

    def run(P):
        pool = (JPool if P is JAX else TPool)(
            lambda seq: P.scn.make_echo_engine(f"pool-{seq}"))
        target = P.scn.PoolTarget(pool, 2)
        engines = target.engines()
        try:
            rep = P.scn.run_scenario("agentic_tool_loops", target=target,
                                     scale=0.05)
        finally:
            target.stop()
        assert not any(e.running for e in engines)
        return _report_fields(rep), [e.name for e in engines]

    got = _same(run)
    assert got[0]["requests"]["completed"] == 78


def test_gateway_target_plays_over_the_ports_rest_server(tmp_path,
                                                         monkeypatch):
    """``GatewayTarget`` posts each turn to a port ``App``'s
    ``/api/v1/generate`` (the echo executor behind the REST server):
    every turn of the inline spec completes once, with its conversation
    id and history, and the invariant checker finds nothing."""
    from llmq_tpu_torch.__main__ import App

    monkeypatch.chdir(tmp_path)
    cfg = TC.load_config(os.devnull, env=False)
    cfg.executor.backend = "echo"
    cfg.device = "cpu"
    app = App(cfg, with_workers=False)
    port = app.start(host="127.0.0.1", port=0)
    seen = []
    submit = app.engine.submit

    def watched(req, **kw):
        seen.append((req.id, req.conversation_id, bool(req.history_text)))
        return submit(req, **kw)

    app.engine.submit = watched
    target = tscn.GatewayTarget(f"http://127.0.0.1:{port}", workers=4,
                                timeout_s=60.0)
    try:
        rep = tscn.run_scenario(TINY_SPEC, target=target)
    finally:
        target.stop()
        app.stop()
    req = rep["requests"]
    assert req["completed"] == req["turns_planned"] == 6
    assert req["failed"] == 0 and rep["invariants"]["violations"] == 0
    assert sorted(r for r, _c, _h in seen) == sorted(
        f"tiny_pairs-c{c}.t{t}" for c in range(3) for t in range(2))
    assert all(h == rid.endswith(".t1") for rid, _c, h in seen)
    assert {c for _r, c, _h in seen} == {f"tiny_pairs-c{c}"
                                         for c in range(3)}


# -- tenant-registry eviction counter ------------------------------------------


def _evictions_sample(text: str) -> float:
    """The eviction counter's sample in an exposition."""
    for line in text.splitlines():
        if line.startswith("llm_queue_tenant_registry_evictions_total "):
            return float(line.split()[-1])
    return 0.0


class TestRegistryEvictionCounter:
    def test_lru_bound_evictions_counted_and_drained(self):
        def run(P):
            reg = P.ten.configure_tenancy(P.C.TenancyConfig(
                enabled=True,
                default=P.C.TenantClassConfig(token_rate=1000.0,
                                              burst_tokens=2000.0)))
            for i in range(reg.MAX_TRACKED + 500):
                reg.admit_tokens(f"ev-spray-{i}", 4.0)
            assert reg.evictions_total == 500
            drained = reg.drain_evictions()
            assert drained == reg.evictions_total
            assert reg.drain_evictions() == 0
            reg.admit_tokens("ev-one-more", 4.0)
            reg.clear()
            assert reg.evictions_total == 0 and reg.drain_evictions() == 0
            return reg.MAX_TRACKED, drained

        _same(run)

    def test_counter_flushes_into_exposition(self):
        def run(P):
            reg = P.ten.configure_tenancy(P.C.TenancyConfig(
                enabled=True,
                default=P.C.TenantClassConfig(token_rate=1000.0,
                                              burst_tokens=2000.0)))
            # Settle any pending drains.
            before = _evictions_sample(P.exposition())
            for i in range(reg.MAX_TRACKED + 100):
                reg.admit_tokens(f"fl-spray-{i}", 4.0)
            text = P.exposition()           # the scrape drives the flush
            assert "llm_queue_tenant_registry_evictions_total" in text
            return _evictions_sample(text) - before

        assert _same(run) == 100


# -- full-scale acceptance bars ------------------------------------------------


@pytest.mark.slow
class TestFullScaleSoak:
    def test_conversation_soak_100k_holds_goodput(self):
        """~10^5 conversations on the echo engine, FakeClock-compressed:
        goodput within 10% of steady state through one diurnal cycle and
        two chaos kills, zero loss, zero duplicates, monotone streams."""
        rep = tscn.run_scenario("conversation_soak_100k", scale=1.0)
        req = rep["requests"]
        assert req["conversations"] > 80_000
        assert req["chaos_events_fired"] == 2
        assert req["engine_recoveries"] == 2
        assert req["completed"] == req["turns_planned"]
        assert req["submitted"] == req["completed"] + req["failed"]
        assert req["retried"] == req["failed"]
        assert rep["invariants"]["violations"] == 0
        assert rep["goodput"]["tokens_per_device_second"] > 0
        dev = tscn.steady_state_deviation(rep)
        assert dev is not None and dev <= 0.10, (
            f"goodput deviated {dev:.1%} from steady state; timeline="
            f"{[(b['t_start'], b['goodput_tps']) for b in rep['timeline']]}")

    def test_spray_full_scale_trips_lru_evictions(self):
        """6000 sprayed tenant ids blow through MAX_TRACKED: the LRU
        bound evicts, the counter proves the churn, the quota edge sheds
        every second turn; the counts equal JAX's."""
        got = {P.name: P.scn.run_scenario(
            "adversarial_id_spray_quota_probe", scale=1.0) for P in PKGS}
        rep = got["port"]
        assert rep["tenancy"]["registry_evictions"] > 0
        assert rep["requests"]["shed"] > 0
        assert rep["tenancy"]["rejections"]["rate"] == \
            rep["requests"]["shed"]
        assert tten.get_tenant_registry().evictions_total == \
            rep["tenancy"]["registry_evictions"]
        assert rep["tenancy"] == got["jax"]["tenancy"]
        assert rep["requests"] == got["jax"]["requests"]
