"""The port's trace plane against the JAX package's: the W3C
``traceparent`` both ways, the flight recorder's timelines, ring and
slow buffer, the stage histograms its flush feeds, the Chrome export, the
SLO burn rates, the host spans, the configuration that switches the
planes, and two tiny f32 engines (the same weights, the same requests)
leaving the same lifecycle in their recorders. Clocks are fakes shared
by both packages' modules; every comparison is exact unless it says
otherwise."""

import types
import uuid

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from prometheus_client import generate_latest  # noqa: E402
from prometheus_client.parser import text_string_to_metric_families  # noqa: E402

import llmq_tpu.observability as jobs  # noqa: E402
from llmq_tpu.core import config as JC  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.metrics import registry as jreg  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.observability import chrome as jchrome  # noqa: E402
from llmq_tpu.observability import critical_path as jcp  # noqa: E402
from llmq_tpu.observability import device as jdev  # noqa: E402
from llmq_tpu.observability import recorder as jrec  # noqa: E402
from llmq_tpu.observability import slo as jslo  # noqa: E402
from llmq_tpu.observability import trace as jtrace  # noqa: E402
from llmq_tpu.observability import usage as jusage  # noqa: E402
from llmq_tpu.utils import profiling as jprof  # noqa: E402

import llmq_tpu_torch.observability as tobs  # noqa: E402
from llmq_tpu_torch.core import config as TC  # noqa: E402
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.metrics import registry as treg  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.observability import chrome as tchrome  # noqa: E402
from llmq_tpu_torch.observability import critical_path as tcp  # noqa: E402
from llmq_tpu_torch.observability import device as tdev  # noqa: E402
from llmq_tpu_torch.observability import recorder as trec  # noqa: E402
from llmq_tpu_torch.observability import slo as tslo  # noqa: E402
from llmq_tpu_torch.observability import trace as ttrace  # noqa: E402
from llmq_tpu_torch.observability import usage as tusage  # noqa: E402
from llmq_tpu_torch.utils import profiling as tprof  # noqa: E402

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(trace=jtrace, recorder=jrec, chrome=jchrome,
                                 slo=jslo, prof=jprof, obs=jobs, cfg=JC),
    "port": types.SimpleNamespace(trace=ttrace, recorder=trec, chrome=tchrome,
                                  slo=tslo, prof=tprof, obs=tobs, cfg=TC),
}
TIMED = (jrec, jslo, jusage, jcp, jdev, jchrome, jprof,
         trec, tslo, tusage, tcp, tdev, tchrome, tprof)


class FakeTime:
    """One clock for ``time.time``, ``monotonic`` and ``perf_counter``."""

    def __init__(self, t: float = 1_700_000_000.0) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    monotonic = perf_counter = time

    def sleep(self, s: float) -> None:
        self.t += s

    advance = sleep


@pytest.fixture
def clock(monkeypatch):
    fake = FakeTime()
    for mod in TIMED:
        monkeypatch.setattr(mod, "time", fake)
    return fake


@pytest.fixture
def default_planes():
    """Both packages' process planes at their defaults after the test."""
    yield
    jobs.configure(JC.ObservabilityConfig())
    tobs.configure(TC.ObservabilityConfig())


# -- traceparent ----------------------------------------------------------------

@pytest.mark.parametrize("rid", [str(uuid.UUID(int=7)), "gen-12", "",
                                 "A5D6-not-hex", "x" * 200])
def test_trace_ids_are_jaxs(rid):
    assert ttrace.trace_id_for(rid) == jtrace.trace_id_for(rid)


@pytest.mark.parametrize("maker,parser", [
    (ttrace.make_traceparent, jtrace.parse_traceparent),
    (jtrace.make_traceparent, ttrace.parse_traceparent)],
    ids=["port-to-jax", "jax-to-port"])
def test_traceparent_round_trips_between_the_packages(maker, parser):
    rid = str(uuid.uuid4())
    header = maker(rid, "00f067aa0ba902b7")
    got = parser(header)
    assert got.trace_id == rid.replace("-", "")
    assert (got.span_id, got.flags) == ("00f067aa0ba902b7", "01")
    assert ttrace.parse_traceparent(header) == \
        tuple(jtrace.parse_traceparent(header))


@pytest.mark.parametrize("header", [
    None, "", "garbage", "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    " 00-" + "A" * 32 + "-" + "B" * 16 + "-01 "])
def test_malformed_traceparents_parse_as_in_jax(header):
    t, j = ttrace.parse_traceparent(header), jtrace.parse_traceparent(header)
    assert (t is None) == (j is None)
    if t is not None:
        assert tuple(t) == tuple(j)


# -- flight recorder --------------------------------------------------------------

#: (outcome, seconds from first token to terminal): five requests through
#: a ring of three (SLA 50 ms, slow buffer of two).
OUTCOMES = [("completed", 0.01), ("completed", 0.2), ("failed", 0.005),
            ("cancelled", 0.3), ("completed", 0.02)]


def _recorder_run(pkg, clock, *, emit_metrics=False, endpoint="e"):
    rec = pkg.recorder.FlightRecorder(capacity=3, slow_capacity=2,
                                      sla_ms=50.0, host="h:1",
                                      emit_metrics=emit_metrics)
    for i, (outcome, dur) in enumerate(OUTCOMES):
        rid = f"r{i}"
        prio = ("realtime", "high", "normal", "low", "high")[i]
        rec.record(rid, "enqueued", priority=prio, user_id="u")
        clock.advance(0.001)
        rec.record(rid, "scheduled", worker="w", priority=prio)
        clock.advance(0.002)
        t = clock.t
        rec.record_many(rid, [
            ("admitted", t, {"engine": endpoint, "priority": prio}),
            ("prefill_start", t + 0.001, {"engine": endpoint}),
            ("prefill_done", t + 0.004, None),
            ("first_token", t + 0.004, None)])
        clock.advance(0.004 + dur)
        rec.record(rid, outcome, completion_tokens=5, prompt_tokens=3,
                   cached_tokens=0, usage={"device_seconds": 0.1})
        clock.advance(0.001)
        # A second terminal (the worker's after the engine's) does not
        # finalize again.
        rec.record(rid, outcome, completion_tokens=5)
    rec.record("r4", "decode_done", ts=clock.t - 0.002, host="peer:2", x=1)
    return rec


def test_recorder_timelines_ring_and_slow_buffer_are_jaxs(clock):
    out = {}
    for side, pkg in PKGS.items():
        clock.t = 1_700_000_000.0
        rec = _recorder_run(pkg, clock)
        out[side] = {
            "recent": [t.to_dict() for t in rec.recent(10)],
            "recent0": rec.recent(0),
            "slow": [t.to_dict() for t in rec.slow()],
            "summaries": [t.summary() for t in rec.recent(2)],
            "get": [None if tl is None else tl.to_dict()
                    for tl in map(rec.get, ("r0", "r1", "r2", "r3", "r4"))],
            "latencies": rec.get("r4").stage_latencies(),
            "stats": rec.get_stats(),
            "len": len(rec),
        }
    assert out["port"] == out["jax"]
    assert out["port"]["stats"]["dropped"] == 2
    assert [t["request_id"] for t in out["port"]["slow"]] == ["r2", "r3"]


def test_recorder_reconfigure_disable_and_clear_are_jaxs(clock):
    out = {}
    for side, pkg in PKGS.items():
        clock.t = 1_700_000_000.0
        rec = _recorder_run(pkg, clock)
        rec.reconfigure(capacity=1, slow_capacity=1, sla_ms=1000.0,
                        enabled=False)
        rec.record("z", "enqueued")
        rec.record_many("z", [("x", 1.0, None)])
        shot = (len(rec), [t.request_id for t in rec.slow()],
                rec.get_stats())
        rec.reconfigure(enabled=True)
        rec.clear()
        out[side] = (shot, rec.get_stats(), rec.recent(5))
    assert out["port"] == out["jax"]


def test_module_record_no_ops_when_disabled(default_planes):
    for pkg in PKGS.values():
        cfg = pkg.cfg.ObservabilityConfig(enabled=False)
        rec = pkg.obs.configure(cfg)
        rid = f"off-{uuid.uuid4()}"
        pkg.obs.record(rid, "enqueued")
        assert rec.get(rid) is None and not rec.enabled


def test_stage_histograms_are_jaxs(clock):
    """The scrape-time flush observes the same stage latencies into the
    same families (priority × endpoint), with the same SLA breaches."""
    tag = f"ep{uuid.uuid4().hex[:8]}"
    samples = {}
    for side, pkg in PKGS.items():
        clock.t = 1_700_000_000.0
        rec = _recorder_run(pkg, clock, emit_metrics=True, endpoint=tag)
        assert rec.flush_metrics() == len(OUTCOMES)
        text = (generate_latest(jreg.REGISTRY).decode() if side == "jax"
                else treg.REGISTRY.exposition().decode())
        got = {}
        for fam in text_string_to_metric_families(text):
            for s in fam.samples:
                if s.name.endswith("_created"):
                    continue
                if s.labels.get("endpoint") == tag:
                    got[(s.name, tuple(sorted(s.labels.items())))] = s.value
        samples[side] = got
    assert samples["port"] == samples["jax"]
    assert any("ttft" in name for name, _ in samples["port"])


# -- chrome export and host spans ----------------------------------------------

def test_chrome_export_is_jaxs(clock):
    docs = {}
    for side, pkg in PKGS.items():
        clock.t = 1_700_000_000.0
        rec = _recorder_run(pkg, clock)
        spans = [pkg.prof.Span("engine.prefill", 10.0, 0.002, {"tokens": 9}),
                 pkg.prof.Span("engine.chunk_fetch", 10.5, 0.004)]
        docs[side] = (
            pkg.chrome.chrome_trace(rec.recent(10), spans=spans,
                                    span_anchor=1_699_999_000.0,
                                    jax_trace_dir="/traces/x"),
            pkg.chrome.chrome_trace(rec.recent(1)))
    assert docs["port"] == docs["jax"]
    assert docs["port"][0]["otherData"] == {"jax_trace_dir": "/traces/x"}


def test_span_recorder_is_jaxs(clock, tmp_path):
    out = {}
    for side, pkg in PKGS.items():
        clock.t = 50.0
        sr = pkg.prof.SpanRecorder(capacity=3)
        for name, dt in (("a", 0.001), ("b", 0.004), ("a", 0.003),
                         ("c", 0.002)):
            with sr.span(name, rows=2):
                clock.advance(dt)
        path = tmp_path / f"{side}.json"
        sr.dump_chrome_trace(str(path))
        out[side] = (sr.summary(), [vars(s) for s in sr.snapshot()],
                     len(sr), path.read_text())
    assert out["port"] == out["jax"]


def test_trace_writes_a_torch_profiler_chrome_trace(tmp_path):
    """``utils.profiling.trace`` is a no-op without a directory and writes
    ``<dir>/<label>/trace.json`` with one; ``annotate`` names a region in
    it."""
    with tprof.trace("none"):
        pass
    with tprof.trace("unit", dir=str(tmp_path)):
        with tprof.annotate("llmq.region"):
            torch.ones(4).sum()
    text = (tmp_path / "unit" / tprof.TRACE_FILE).read_text()
    assert '"traceEvents"' in text and "llmq.region" in text


# -- SLO burn -----------------------------------------------------------------------

def test_slo_burn_rates_are_jaxs(clock):
    out = {}
    for side, pkg in PKGS.items():
        clock.t = 1_700_000_000.0
        t = pkg.slo.SloTracker(targets={"ttft": 100.0, "realtime": 50.0,
                                        "off": 0.0},
                               objective=0.9, windows_s=(60.0, 600.0),
                               metrics=False)
        for i in range(40):
            t.observe_request({"ttft": 0.05 if i % 3 else 0.2},
                              "realtime" if i % 2 else "high",
                              30.0 if i % 5 else 80.0)
            clock.advance(20.0)
        t.observe("unknown", 1.0)
        first = t.burn_rates()
        t.reconfigure(objective=1.0, windows_s=[30.0, -1, 90.0])
        out[side] = (first, t.snapshot(),
                     [pkg.slo.window_label(w) for w in (90, 300, 3600, 7200)])
    assert out["port"] == out["jax"]


def test_slo_gauges_are_jaxs(clock):
    vals = {}
    for side, pkg in PKGS.items():
        clock.t = 1_700_000_000.0
        t = pkg.slo.SloTracker(targets={"ttft": 100.0}, windows_s=(61.0,
                                                                   601.0))
        for i in range(10):
            t.observe("ttft", 150.0 if i < 3 else 10.0)
            clock.advance(1.0)
        t.flush()
        m = jreg.get_metrics() if side == "jax" else treg.get_metrics()
        vals[side] = [
            (m.slo_burn_rate.labels("ttft", w)._value.get() if side == "jax"
             else m.slo_burn_rate.labels("ttft", w).get())
            for w in ("61s", "601s")]
    assert vals["port"] == vals["jax"] == [30.0, 30.0]


def test_slo_and_critical_path_follow_the_trace_plane(default_planes):
    """With the recorder or its metric emission off, the SLO tracker has
    no targets and the critical-path analyzer is off, as in JAX."""
    for pkg in PKGS.values():
        for kw in ({"enabled": False}, {"emit_metrics": False}):
            pkg.obs.configure(pkg.cfg.ObservabilityConfig(**kw))
            assert pkg.obs.get_slo_tracker().targets == {}
            assert not pkg.obs.get_critical_path().enabled
        pkg.obs.configure(pkg.cfg.ObservabilityConfig())
        assert pkg.obs.get_slo_tracker().targets == {"ttft": 2000.0,
                                                     "realtime": 500.0}
        assert pkg.obs.get_critical_path().enabled


def test_exported_names_are_jaxs():
    names = {n for n in dir(jobs) if not n.startswith("_")}
    assert {n for n in dir(tobs) if not n.startswith("_")} == names


# -- two engines, one lifecycle ---------------------------------------------------

KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512, max_seq_len=256)
GEOM = dict(batch_size=4, page_size=16, num_pages=128, prefill_buckets=[16, 32],
            eos_id=-1, chunk_size=4, mixed_prefill_slices=2,
            mixed_slice_tokens=8)
PROMPTS = [("realtime", "A short one.", 6),
           ("high", "High priority text that spans two prefill chunks, "
                    "mostly.", 9),
           ("normal", "normal: a middle prompt", 5),
           ("low", "low and slow, decoding while the rest prefill", 12)]


def _serve(eng, make_req, prio_of, tag):
    ids = []
    for i, (p, text, n) in enumerate(PROMPTS):
        ids.append(f"{tag}-{i}")
        eng.submit(make_req(ids[-1], text, prio_of(p), n))
    eng.run_until_idle()
    # A second wave arrives while the first row decodes (mixed chunks).
    ids.append(f"{tag}-long")
    eng.submit(make_req(ids[-1], "The long one keeps decoding " * 2,
                        prio_of("low"), 24))
    for _ in range(6):
        eng.step()
    for i in range(2):
        ids.append(f"{tag}-late{i}")
        eng.submit(make_req(ids[-1], f"late arrival {i}: " + "x" * 40,
                            prio_of("high"), 4))
    eng.run_until_idle()
    return ids


@pytest.fixture(scope="module")
def engines():
    from llmq_tpu.core.config import AsyncPipelineConfig as JPipe
    from llmq_tpu.core.types import Priority as JPriority

    from llmq_tpu_torch.core.config import AsyncPipelineConfig
    from llmq_tpu_torch.core.types import Priority

    jobs.configure(JC.ObservabilityConfig())
    tobs.configure(TC.ObservabilityConfig())
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tag = f"obs{uuid.uuid4().hex[:8]}"
    jeng = JEngine(JaxExecutor(jcfg, jparams, telemetry_name=f"{tag}-j",
                               **GEOM), JTok(), name=f"{tag}-j",
                   max_decode_steps=32, async_pipeline=JPipe())
    teng = InferenceEngine(TorchExecutor(tcfg, tparams, device="cpu",
                                         telemetry_name=f"{tag}-t", **GEOM),
                           ByteTokenizer(), name=f"{tag}-t",
                           max_decode_steps=32,
                           async_pipeline=AsyncPipelineConfig())
    out = {
        "jax": (jeng, _serve(jeng, lambda rid, text, p, n: JGenRequest(
            id=rid, prompt=text, priority=p, max_new_tokens=n),
            JPriority.from_name, f"{tag}-j")),
        "port": (teng, _serve(teng, lambda rid, text, p, n: GenRequest(
            id=rid, prompt=text, priority=p, max_new_tokens=n),
            Priority.from_name, f"{tag}-t")),
    }
    yield out
    jeng.stop()
    teng.stop()


def _stages(pkg, rid):
    tl = pkg.obs.get_recorder().get(rid)
    return [e.stage for e in tl.sorted_events()]


def test_engines_record_jaxs_lifecycle_per_request(engines):
    """Tolerance: none. Per request the same stage names in the same
    order, the same token counts on the terminal event, and usage on
    it."""
    jeng, jids = engines["jax"]
    teng, tids = engines["port"]
    assert len(jids) == len(tids) == 7
    for jid, tid in zip(jids, tids):
        js, ts = _stages(PKGS["jax"], jid), _stages(PKGS["port"], tid)
        assert ts == js, (tid, ts, js)
        assert ts[-1] == "completed" and "decode_done" in ts
        jt = PKGS["jax"].obs.get_recorder().get(jid).to_dict()
        tt = PKGS["port"].obs.get_recorder().get(tid).to_dict()
        assert tt["tokens"] == jt["tokens"]
        assert set(tt["usage"]) == set(jt["usage"])
        assert set(tt["stage_latencies_ms"]) == set(jt["stage_latencies_ms"])


def test_engine_segments_conserve(engines):
    """Each request's critical-path segments sum to its recorded end to
    end within the analyzer's tolerance, on both packages."""
    for side, (eng, ids) in engines.items():
        for rid in ids:
            tl = PKGS[side].obs.get_recorder().get(rid)
            d = PKGS[side].obs.decompose(tl)
            total = sum(d["segments"].values()) * 1e3
            rec = tl.duration_ms()
            assert abs(total - rec) <= max(0.02 * rec, 0.05), (side, rid)
            assert d["outcome"] == "completed"
            assert set(d["segments"]) <= set(PKGS[side].obs.SEGMENTS)


def test_engine_stats_keys_are_jaxs(engines):
    (jeng, _), (teng, _) = engines["jax"], engines["port"]
    j, t = jeng.get_stats(), teng.get_stats()
    assert set(t) == set(j)
    assert set(t["device"]) == set(j["device"])
    assert set(t["device"]["steps"]) == set(j["device"]["steps"])
    assert set(t["device"]["compile"]) == set(j["device"]["compile"])
    assert set(t["device"]["hbm"]) == set(j["device"]["hbm"])
    assert set(t["pipeline"]) == set(j["pipeline"])
    assert set(t["profile"]) == set(j["profile"])
    assert t["device"]["steps"]["count"] > 0
    # Tokens committed by chunks (a resolved first token is not one).
    assert 0 < t["device"]["tokens_total"] <= teng.tokens_generated_total
    assert t["device"]["tokens_total"] == j["device"]["tokens_total"]
