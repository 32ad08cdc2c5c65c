"""The port's metrics registry against the JAX package's: the families
(name, type, help, labels, buckets), the samples that the same queue,
worker, dead-letter, shedder, supervisor and engine scenario leaves in
each registry (as deltas: both registries are process singletons), the
text exposition parsed by ``prometheus_client``'s parser, and the
cardinality contract ``tests/test_metrics_cardinality.py`` holds for the
JAX package."""

import re
import threading
import uuid

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from prometheus_client import generate_latest  # noqa: E402
from prometheus_client.parser import text_string_to_metric_families  # noqa: E402

from llmq_tpu.api import overload as joverload  # noqa: E402
from llmq_tpu.api.server import ApiError as JApiError  # noqa: E402
from llmq_tpu.core import clock as jclock  # noqa: E402
from llmq_tpu.core import config as JC  # noqa: E402
from llmq_tpu.core import types as jtypes  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.supervisor import EngineSupervisor as JSupervisor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.metrics import registry as jreg  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.queueing import dead_letter_queue as jdlq  # noqa: E402
from llmq_tpu.queueing import delayed_queue as jdelayed  # noqa: E402
from llmq_tpu.queueing import queue_manager as jqm  # noqa: E402
from llmq_tpu.queueing import worker as jworker  # noqa: E402

from llmq_tpu_torch.api import overload as toverload  # noqa: E402
from llmq_tpu_torch.api.server import ApiError as TApiError  # noqa: E402
from llmq_tpu_torch.core import config as TC  # noqa: E402
from llmq_tpu_torch.core import types as ttypes  # noqa: E402
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.supervisor import EngineSupervisor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.metrics import registry as treg  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.queueing import dead_letter_queue as tdlq  # noqa: E402
from llmq_tpu_torch.queueing import delayed_queue as tdelayed  # noqa: E402
from llmq_tpu_torch.queueing import queue_manager as tqm  # noqa: E402
from llmq_tpu_torch.queueing import worker as tworker  # noqa: E402

torch.set_num_threads(1)


def _jax_exposition() -> str:
    jreg.get_metrics()
    return generate_latest(jreg.REGISTRY).decode()


def _port_exposition() -> str:
    return treg.exposition().decode()


def _samples(text: str, tag: str):
    """{(sample name, labels): value} of the samples whose labels carry
    ``tag`` (a run's unique names), with the tag removed; ``_created``
    samples aside (the port does not write them)."""
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            if not any(tag in v for v in s.labels.values()):
                continue
            labels = tuple(sorted((k, v.replace(tag, "X"))
                                  for k, v in s.labels.items()))
            out[(s.name, labels)] = s.value
    return out


def _by_name(text: str):
    return {f.name: f for f in text_string_to_metric_families(text)}


# -- families -----------------------------------------------------------------

def test_every_port_family_is_jaxs():
    """Tolerance: none. Name, type, help, label names and buckets."""
    port, jax_m = treg.get_metrics(), jreg.get_metrics()
    fams = vars(port)
    assert len(fams) == 64      # the observability planes' families too
    for attr, fam in fams.items():
        jf = getattr(jax_m, attr)
        name = jf._name + ("_total" if jf._type == "counter" else "")
        assert (fam.name, fam.type, fam.documentation, fam.labelnames) == (
            name, jf._type, jf._documentation, jf._labelnames), attr
        if fam.type == "histogram":
            assert list(fam.buckets) == list(jf._upper_bounds), attr


def test_exposition_parses_like_jaxs():
    """The port's text exposition parses with ``prometheus_client``'s
    parser into the same families (name, type, help) as JAX's."""
    port, jax_fams = _by_name(_port_exposition()), _by_name(
        _jax_exposition())
    assert len(port) == 64
    for name, fam in port.items():
        jf = jax_fams[name]
        assert (fam.type, fam.documentation) == (jf.type,
                                                 jf.documentation), name


def test_exposition_escapes_labels_and_help():
    reg = treg.Registry()
    c = treg.Counter("t_total", 'help with \\ and "q"\nnext', ["a"],
                     registry=reg)
    c.labels('v"\\\n').inc(2)
    h = treg.Histogram("t_ms", "h", ["a"], buckets=(1, 10), registry=reg)
    h.labels("x").observe(5.0)
    h.labels("x").observe(50.0)
    g = treg.Gauge("t_g", "g", registry=reg)
    g.labels().set(-1.5)
    fams = _by_name(reg.exposition().decode())
    assert fams["t"].documentation == 'help with \\ and "q"\nnext'
    assert fams["t"].samples[0].labels == {"a": 'v"\\\n'}
    assert fams["t"].samples[0].value == 2.0
    assert [(s.name, s.labels.get("le"), s.value)
            for s in fams["t_ms"].samples] == [
        ("t_ms_bucket", "1.0", 0.0), ("t_ms_bucket", "10.0", 1.0),
        ("t_ms_bucket", "+Inf", 2.0), ("t_ms_count", None, 2.0),
        ("t_ms_sum", None, 55.0)]
    assert fams["t_g"].samples[0].value == -1.5
    with pytest.raises(ValueError):
        c.labels("x").inc(-1)
    with pytest.raises(ValueError):
        c.labels("x", "y")


# -- the queue plane, the shedder and the supervisor ------------------------

class _DeadEngine:
    """An engine whose loop thread died: what the supervisor recovers."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.running = False
        self._thread = object()
        self._stop = threading.Event()

    def recover_after_crash(self):
        return {"recovered": 2, "already_done": 1}

    def start(self) -> None:
        pass


def _plane_scenario(pkg: str, tag: str) -> None:
    """Pushes across the tiers, a retried message, a dead letter with a
    failing DLQ handler, an admin removal, a requeue, a stale expiry,
    two sheds and one supervised restart, on a fake clock."""
    clock = jclock.FakeClock()
    if pkg == "jax":
        Config, Message, Priority = JC.Config, jtypes.Message, \
            jtypes.Priority
        mk_qm = lambda cfg: jqm.QueueManager(  # noqa: E731
            f"{tag}-qm", config=cfg, clock=clock, backend="python",
            enable_metrics=True)
        mk_dq, mk_dlq, Worker = (jdelayed.DelayedQueue,
                                 jdlq.DeadLetterQueue, jworker.Worker)
        shedder_cls, err = joverload.OverloadShedder, JApiError
        sup_cls = JSupervisor
    else:
        Config, Message, Priority = TC.Config, ttypes.Message, \
            ttypes.Priority
        mk_qm = lambda cfg: tqm.QueueManager(  # noqa: E731
            f"{tag}-qm", config=cfg, clock=clock)
        mk_dq, mk_dlq, Worker = (tdelayed.DelayedQueue,
                                 tdlq.DeadLetterQueue, tworker.Worker)
        shedder_cls, err = toverload.OverloadShedder, TApiError
        sup_cls = EngineSupervisor
    cfg = Config()
    cfg.queue.retry.initial_backoff = 0.5
    cfg.queue.stale_message_age = 100.0
    mgr = mk_qm(cfg)
    dq = mk_dq(lambda q, m: mgr.push_message(m, q or None), clock=clock)
    dlq = mk_dlq(clock=clock, name=f"{tag}-dlq")
    dlq.add_handler(lambda item: (_ for _ in ()).throw(
        RuntimeError("broken alert hook")))
    attempts = {}

    def process(ctx, m):
        attempts[m.id] = attempts.get(m.id, 0) + 1
        clock.advance(0.02 * attempts[m.id])
        if m.id == "flaky" and attempts[m.id] == 1:
            raise RuntimeError("first attempt")
        if m.id == "doomed":
            raise RuntimeError("always")
        m.response = "ok"

    w = Worker("w0", mgr, process, delayed_queue=dq, dead_letter_queue=dlq,
               clock=clock)

    def msg(mid, prio, **kw):
        return Message(id=mid, content=mid, priority=Priority.from_name(prio),
                       created_at=0.0, **kw)

    for mid, prio, kw in (("ok", "high", {}), ("flaky", "realtime", {}),
                          ("doomed", "low", {"max_retries": 1}),
                          ("gone", "normal", {}), ("n2", "normal", {})):
        mgr.push_message(msg(mid, prio, **kw))
        clock.advance(0.3)
    assert mgr.remove_message("gone") is not None
    for _ in range(4):
        w.process_batch()
        clock.advance(1.0)
        dq.run_due_once()
    mgr.push_message(msg("back", "high"))
    popped = mgr.pop_message("high")
    mgr.requeue_message(popped)
    mgr.push_message(msg("stale", "low"))
    # Two sheds: the queue-depth limit, then the engine down.
    ocfg = Config().overload
    ocfg.queue_depth_limit = 1
    eng = _DeadEngine(f"{tag}-eng")
    shed = shedder_cls(ocfg, cfg.queue)
    for shedder in (shed, shedder_cls(ocfg, cfg.queue, engine=eng)):
        with pytest.raises(err):
            shedder.admit(msg("x", "normal"), mgr, 0.0)
    clock.advance(200.0)
    mgr.run_monitor_once()
    assert dlq.size() == 1
    sup = sup_cls(eng, config=cfg.executor.supervisor)
    assert sup.check_once()


@pytest.fixture(scope="module")
def plane_deltas():
    out = {}
    for pkg, expo in (("jax", _jax_exposition), ("port", _port_exposition)):
        tag = f"m{uuid.uuid4().hex[:8]}"
        shed0 = _by_name(expo())["llm_queue_requests_shed"].samples
        _plane_scenario(pkg, tag)
        text = expo()
        shed1 = _by_name(text)["llm_queue_requests_shed"].samples
        before = {(s.name, tuple(sorted(s.labels.items()))): s.value
                  for s in shed0}
        shed = {k: s.value - before.get(k, 0.0) for s in shed1
                for k in [(s.name, tuple(sorted(s.labels.items())))]
                if not s.name.endswith("_created")}
        out[pkg] = (_samples(text, tag), {k: v for k, v in shed.items()
                                          if v})
    return out


def test_queue_plane_samples_match_jax(plane_deltas):
    """Tolerance: none (fake clock). Every sample the scenario left under
    its own manager, queue and engine names: pending and processing
    gauges, completed and failed counters, the wait and process
    histograms' buckets, counts and sums, the operations counter, the
    dead-letter depth and handler errors, and the supervisor's restart
    and recovery counters."""
    j, t = plane_deltas["jax"][0], plane_deltas["port"][0]
    port_families = {n for n, _ in t}
    j = {k: v for k, v in j.items() if k[0] in port_families}
    assert t == j
    names = {n for n, _ in t}
    for want in ("llm_queue_messages_completed_total",
                 "llm_queue_messages_failed_total",
                 "llm_queue_message_wait_seconds_bucket",
                 "llm_queue_message_process_seconds_sum",
                 "llm_queue_operations_total", "llm_queue_dead_letter_depth",
                 "llm_queue_dlq_handler_errors_total",
                 "llm_queue_engine_restarts_total",
                 "llm_queue_engine_recovered_requests_total"):
        assert want in names, want


def test_shed_counter_matches_jax(plane_deltas):
    j, t = plane_deltas["jax"][1], plane_deltas["port"][1]
    assert t == j
    assert sum(t.values()) == 2


def test_metrics_off_records_nothing():
    """``enable_metrics`` False: the queue manager, the dead-letter
    queue, the shedder and the supervisor leave no sample."""
    tag = f"off{uuid.uuid4().hex[:8]}"
    cfg = TC.Config()
    cfg.queue.enable_metrics = False
    mgr = tqm.QueueManager(f"{tag}-qm", cfg)
    mgr.push_message(ttypes.Message(id="a", content="a"))
    mgr.complete_message(mgr.pop_message("normal"), 0.1)
    dlq = tdlq.DeadLetterQueue(name=f"{tag}-dlq", enable_metrics=False)
    dlq.push(ttypes.Message(id="b", content="b"), "x", "normal")
    sup = EngineSupervisor(_DeadEngine(f"{tag}-eng"),
                           config=cfg.executor.supervisor,
                           enable_metrics=False)
    assert sup.check_once()
    assert _samples(_port_exposition(), tag) == {}


# -- the engine ------------------------------------------------------------

KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512)
GEOM = dict(batch_size=4, page_size=16, num_pages=128,
            prefill_buckets=[16, 32], eos_id=2, chunk_size=4)


def _engine_workload(eng, make_req, prio_of):
    """Prompts across the tiers, a two-turn conversation (turn 2 cached),
    then four LOW rows decoding and a REALTIME arrival (one keep-pages
    preemption)."""
    for i, (p, text) in enumerate((("realtime", "Queue the realtime one."),
                                   ("high", "High priority text here!"),
                                   ("normal", "normal: a middle prompt"),
                                   ("low", "low and slow"))):
        eng.submit(make_req(f"p{i}", text, prio_of(p)))
    eng.run_until_idle()
    for rid, text in (("t1", "Hello there, conversation."),
                      ("t2", " And a second turn.")):
        eng.submit(make_req(rid, text, prio_of("high"),
                            conversation_id="c1", max_new_tokens=6))
        eng.run_until_idle()
    lows = [eng.submit(make_req(f"low{i}", f"background job {i}",
                                prio_of("low"), max_new_tokens=40))
            for i in range(4)]
    for _ in range(200):
        if all("prefill_done" in h.marks for h in lows):
            break
        eng.step()
    eng.submit(make_req("rt", "urgent!", prio_of("realtime"),
                        max_new_tokens=8))
    eng.run_until_idle()


@pytest.fixture(scope="module")
def engine_runs():
    from llmq_tpu.core.config import PrefixCacheConfig as JPrefixCfg

    from llmq_tpu_torch.core.config import PrefixCacheConfig

    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    out = {}
    tag = f"e{uuid.uuid4().hex[:8]}"
    jeng = JEngine(JaxExecutor(jcfg, jparams, prefill_batch=1,
                               mixed_prefill_slices=0, **GEOM), JTok(),
                   name=f"{tag}-jax", enable_metrics=True,
                   max_decode_steps=12, prefix_cache=JPrefixCfg())
    _engine_workload(jeng, lambda rid, text, prio, **kw: JGenRequest(
        id=rid, prompt=text, priority=prio, **kw), jtypes.Priority.from_name)
    out["jax"] = (jeng, _samples(_jax_exposition(), f"{tag}-jax"))
    teng = InferenceEngine(TorchExecutor(tcfg, tparams, device="cpu",
                                         **GEOM), ByteTokenizer(),
                           name=f"{tag}-port", max_decode_steps=12,
                           prefix_cache=PrefixCacheConfig())
    _engine_workload(teng, lambda rid, text, prio, **kw: GenRequest(
        id=rid, prompt=text, priority=prio, **kw),
        ttypes.Priority.from_name)
    out["port"] = (teng, _samples(_port_exposition(), f"{tag}-port"))
    return out


def _family(samples, name):
    """A family's non-zero samples: the port resolves an engine's
    labelled children when it builds the engine, so its zero series
    exist before JAX's lazily made ones do."""
    return {labels: v for (n, labels), v in samples.items()
            if n == name and v}


@pytest.mark.parametrize("name", [
    "llm_queue_generated_tokens_total", "llm_queue_preemptions_total",
    "llm_queue_prefix_cache_hits_total", "llm_queue_prefix_cache_misses_total",
    "llm_queue_cached_prefill_tokens_total", "llm_queue_kv_pages_in_use",
    "llm_queue_kv_pinned_conversations", "llm_queue_batch_occupancy",
    "llm_queue_prefix_cache_pages"])
def test_engine_samples_match_jax(engine_runs, name):
    """Tolerance: none (f32, greedy). The engine's counters by priority
    and its pool gauges once idle are the JAX engine's (non-zero series:
    a counter at 0 and one not yet made read the same)."""
    j, t = engine_runs["jax"][1], engine_runs["port"][1]
    assert _family(t, name) == _family(j, name)
    assert any(n == name for n, _ in t), name


def test_device_telemetry_families_follow_the_engines_chunks(engine_runs):
    """The step decomposition histograms hold one sample per chunk the
    engine's telemetry noted (flushed at the scrape), the live gauges
    exist for the engine, and the HBM gauges carry the executor's bytes."""
    eng, s = engine_runs["port"]
    chunks = eng._telemetry.snapshot()["steps"]["count"]
    assert chunks > 0
    for leg in ("dispatch", "device", "readback", "overlapped"):
        got = _family(s, f"llm_queue_step_{leg}_ms_count")
        assert list(got.values()) == [float(chunks)], leg
    text = _port_exposition()
    tag = eng.name
    for fam in ("llm_queue_decode_tokens_per_s", "llm_queue_mfu_pct",
                "llm_queue_pipeline_overlap_ratio",
                "llm_queue_kv_pool_occupancy"):
        assert f'{fam}{{engine="{tag}"}}' in text, fam
    chip = eng.executor.hbm_info()[0]
    assert f'llm_queue_hbm_weights_bytes{{engine="{tag}",chip="0"}} ' \
        f'{float(chip["weights_bytes"])!r}' in text


def test_engine_counters_equal_the_engines_own(engine_runs):
    eng, s = engine_runs["port"]
    gen = _family(s, "llm_queue_generated_tokens_total")
    assert sum(gen.values()) == eng.tokens_generated_total
    pre = _family(s, "llm_queue_preemptions_total")
    assert sum(pre.values()) == eng.preemptions >= 1
    steps = _family(s, "llm_queue_decode_steps_total")
    assert sum(steps.values()) == eng.steps > 0
    pages = _family(s, "llm_queue_kv_pages_in_use")
    assert list(pages.values()) == [float(eng.allocator.used())]


# -- the cardinality contract -------------------------------------------------

#: Values that look like per-request identifiers.
_ID_RX = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$"
    r"|^[0-9a-f]{12,}$"
    r"|^\d{6,}$", re.IGNORECASE)


def test_label_contract_is_jaxs():
    assert treg.LABEL_CONTRACT == jreg.LABEL_CONTRACT


def test_every_label_is_declared_and_bounded(plane_deltas, engine_runs):
    """Every label the port's families use is in LABEL_CONTRACT; closed
    enums hold only their values; the other labels never carry ids."""
    for fam in text_string_to_metric_families(_port_exposition()):
        for s in fam.samples:
            for label, value in s.labels.items():
                if label == "le":
                    continue
                assert label in treg.LABEL_CONTRACT, (fam.name, label)
                allowed = treg.LABEL_CONTRACT[label]
                if isinstance(allowed, frozenset):
                    assert value in allowed, (fam.name, label, value)
                else:
                    assert not _ID_RX.match(value), (fam.name, label, value)
    for fam in treg.REGISTRY.families():
        assert set(fam.labelnames) <= set(treg.LABEL_CONTRACT), fam.name


@pytest.mark.parametrize("metrics_on,queue_on", [
    (True, True), (False, True), (True, False), (False, False)])
def test_engine_metrics_follow_metrics_enabled_like_jaxs_builder(
        metrics_on, queue_on):
    """Both builders turn the engine's families on or off with
    ``metrics.enabled``; ``queue.enable_metrics`` is the queue plane's."""
    from llmq_tpu.engine.builder import build_engine as jbuild

    from llmq_tpu_torch.engine.builder import build_engine as tbuild

    jcfg, tcfg = JC.Config(), TC.Config()
    for cfg in (jcfg, tcfg):
        cfg.metrics.enabled = metrics_on
        cfg.queue.enable_metrics = queue_on
    tcfg.device, tcfg.model.name = "cpu", "llama3-tiny"
    jeng = jbuild(jcfg)                                   # the echo engine
    teng = tbuild(tcfg, model_dtype=torch.float32)
    assert (jeng._metrics is not None) is (teng._m is not None) is metrics_on
