"""The port's critical-path plane against the JAX package's: ``decompose``
on the same timelines, the analyzer's rollup, the boot registry and the
process boot record closed by the first token, on fake clocks shared by
both packages' modules; then the port's builder stamping its boot stages.
Every comparison is exact unless it says otherwise."""

import types

import pytest
import torch

pytest.importorskip("jax")

from llmq_tpu.metrics import registry as jreg  # noqa: E402
from llmq_tpu.observability import critical_path as jcp  # noqa: E402
from llmq_tpu.observability import recorder as jrec  # noqa: E402

from llmq_tpu_torch.metrics import registry as treg  # noqa: E402
from llmq_tpu_torch.observability import critical_path as tcp  # noqa: E402
from llmq_tpu_torch.observability import recorder as trec  # noqa: E402

torch.set_num_threads(1)

MODS = {"jax": types.SimpleNamespace(cp=jcp, rec=jrec, m=jreg.get_metrics),
        "port": types.SimpleNamespace(cp=tcp, rec=trec, m=treg.get_metrics)}


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
    for mod in (jcp, tcp, jrec, trec):
        monkeypatch.setattr(mod, "time", fake)
    return fake


#: Timelines as (stage, seconds after the first event, meta) lists.
TIMELINES = {
    "happy": [("enqueued", 0.0, {"priority": "high"}),
              ("scheduled", 0.010, {}), ("dispatched", 0.011, {}),
              ("admitted", 0.013, {"engine": "e0"}),
              ("prefill_start", 0.014, {}), ("prefill_done", 0.030, {}),
              ("first_token", 0.031, {}), ("decode_done", 0.131, {}),
              ("completed", 0.133, {"decode_device_s": 0.07,
                                    "completion_tokens": 9})],
    "no_attribution": [("enqueued", 0.0, {"priority": "low"}),
                       ("scheduled", 0.002, {}), ("admitted", 0.004, {}),
                       ("prefill_start", 0.004, {}),
                       ("first_token", 0.020, {}),
                       ("completed", 0.060, {})],
    "over_attributed": [("admitted", 0.0, {"priority": "realtime"}),
                        ("prefill_start", 0.001, {}),
                        ("first_token", 0.005, {}),
                        ("decode_done", 0.015, {}),
                        ("completed", 0.016, {"decode_device_s": 1.0})],
    "failed_in_queue": [("enqueued", 0.0, {"priority": "normal"}),
                        ("retry_scheduled", 0.5, {}),
                        ("failed", 0.9, {})],
    "cancelled_prefill": [("enqueued", 0.0, {}), ("dispatched", 0.001, {}),
                          ("admitted", 0.002, {}),
                          ("prefill_start", 0.003, {}),
                          ("cancelled", 0.009, {})],
    "sub_spans": [("enqueued", 0.0, {"priority": "high"}),
                  ("scheduled", 0.01, {}), ("admitted", 0.02, {}),
                  ("kv_promote_start", 0.015, {}),
                  ("kv_promote_done", 0.04, {}),
                  ("prefill_start", 0.045, {}), ("first_token", 0.05, {}),
                  ("completed", 0.07, {})],
    "skewed": [("enqueued", 0.0, {}), ("scheduled", 0.02, {}),
               ("admitted", 0.01, {}), ("first_token", 0.03, {}),
               ("completed", 0.025, {}), ("completed", 0.04, {})],
    "unfinished": [("enqueued", 0.0, {}), ("admitted", 0.01, {})],
    "empty": [],
}


def _timeline(mod, spec, t0=1_700_000_000.0):
    tl = mod.rec.Timeline("req-1")
    tl.created = t0
    tl.events = [mod.rec.TraceEvent(s, t0 + dt, "h:1", dict(meta))
                 for s, dt, meta in spec]
    return tl


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_decompose_is_jaxs(name):
    got = {side: mod.cp.decompose(_timeline(mod, TIMELINES[name]))
           for side, mod in MODS.items()}
    assert got["port"] == got["jax"]
    d = got["port"]
    if d is not None:
        assert sum(d["segments"].values()) == pytest.approx(d["total_s"])


def test_analyzer_rollup_is_jaxs():
    out = {}
    for side, mod in MODS.items():
        ana = mod.cp.CriticalPathAnalyzer(recent_capacity=3)
        for i, name in enumerate(sorted(TIMELINES)):
            tl = _timeline(mod, TIMELINES[name], 1_700_000_000.0 + i)
            tl.request_id = f"req-{name}"
            ana.observe(tl, metrics=mod.m())
        ana.reconfigure(enabled=False)
        off = ana.observe(_timeline(mod, TIMELINES["happy"]))
        ana.reconfigure(enabled=True, recent_capacity=2)
        out[side] = (ana.snapshot(recent=5), off)
        ana.clear()
        out[side] += (ana.snapshot(),)
    assert out["port"] == out["jax"]
    assert out["port"][0]["conservation_failures"] == 0
    assert out["port"][0]["requests"] == 7


def _boot_run(mod, clock):
    reg = mod.cp.BootRegistry(capacity=2)
    reg.begin("serve:a", "serve")
    clock.advance(1.0)
    for stage, secs in (("weights", 3.5), ("compile", 0.0), ("warmup", 7.25),
                        ("weights", 0.5), ("bogus", 1.0), ("artifact", -1.0)):
        reg.stage("serve:a", stage, secs)
    reg.stage("engine-x", "weights", 2.0)     # no record yet: made
    reg.begin("pool:b", "pool")
    reg.ready("serve:a", 12.0)
    reg.ready("pool:b")
    reg.ready("missing")
    out = [reg.snapshot(), reg.get("serve:a"), reg.get("engine-x"),
           list(reg._pending)]
    reg.reconfigure(capacity=1)
    out.append(reg.snapshot())
    return out


def test_boot_registry_is_jaxs(clock):
    out = {}
    for side, mod in MODS.items():
        clock.t = 1_700_000_000.0
        out[side] = _boot_run(mod, clock)
    assert out["port"] == out["jax"]


def test_process_boot_closes_at_the_first_token(clock, monkeypatch):
    """``boot_begin(process=True)`` opens this process's record; the
    first committed token stamps ``first_token`` once (the wall from the
    record's start past its stamped stages); the flush observes every
    stage into ``replica_ready_seconds{stage}``."""
    out = {}
    for side, mod in MODS.items():
        clock.t = 1_700_000_000.0
        reg = mod.cp.BootRegistry()
        monkeypatch.setattr(mod.cp, "_BOOT", reg)
        monkeypatch.setattr(mod.cp, "_PROCESS_BOOT_ID", None)
        monkeypatch.setattr(mod.cp, "_PROCESS_FIRST_TOKEN_DONE", False)
        mod.cp.note_first_token()                   # no record: nothing
        mod.cp.boot_begin("serve:0.0.0.0:8080", "serve", process=True)
        mod.cp.boot_stage("serve:0.0.0.0:8080", "weights", 2.0)
        clock.advance(5.0)
        mod.cp.note_first_token()
        clock.advance(5.0)
        mod.cp.note_first_token()                   # once only
        mod.cp.boot_ready("serve:0.0.0.0:8080", 4.0)
        out[side] = (mod.cp.current_boot_id(), mod.cp.process_boot_snapshot(),
                     list(reg._pending), reg.flush(mod.m()), reg.flush())
    assert out["port"] == out["jax"]
    assert out["port"][1]["stages_s"] == {"weights": 2.0, "first_token": 3.0}


def test_the_builder_stamps_the_boot_stages(monkeypatch, tmp_path):
    """The port's builder opens the process record when no entry point
    did and stamps ``weights``; with warmup the ``artifact`` (0: no
    export cache), ``compile`` (0 on the CPU: no nvcc build) and
    ``warmup`` stages; the engine's first token closes it."""
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.engine.engine import GenRequest

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcp, "_BOOT", tcp.BootRegistry())
    monkeypatch.setattr(tcp, "_PROCESS_BOOT_ID", None)
    monkeypatch.setattr(tcp, "_PROCESS_FIRST_TOKEN_DONE", False)
    cfg = Config()
    cfg.device, cfg.model.name = "cpu", "llama3-tiny"
    eng = build_engine(cfg, name="boot-engine", model_dtype=torch.float32,
                       warmup=True)
    rec = tcp.process_boot_snapshot()
    assert rec["replica_id"] == "boot-engine" and rec["kind"] == "engine"
    assert set(rec["stages_s"]) == {"weights", "artifact", "compile",
                                    "warmup"}
    assert rec["stages_s"]["artifact"] == rec["stages_s"]["compile"] == 0.0
    assert rec["stages_s"]["weights"] > 0 and rec["stages_s"]["warmup"] > 0
    eng.submit(GenRequest(id="boot-first", prompt="hi", max_new_tokens=2))
    eng.run_until_idle()
    assert tcp.process_boot_snapshot()["stages_s"]["first_token"] >= 0
    assert set(tcp.process_boot_snapshot()["stages_s"]) <= \
        set(tcp.BOOT_STAGES)
    eng.stop()
