"""The port's device telemetry against the JAX package's: the MFU and
bandwidth math (JAX's tables given the port's H100 row), ``note_step``
snapshots, ``timed_fetch``'s overlap attribution over fake chunk handles,
the compile and warmup notes, the scrape-time histograms, the executor's
model identity and HBM bytes against ``JaxExecutor``'s, the engine's HBM
snapshot, the RTT probe and the single-flight on-demand profile. Clocks
are fakes shared by both packages' modules; every comparison is exact
unless it says otherwise."""

import json
import time
import types
import uuid

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from prometheus_client import generate_latest  # noqa: E402
from prometheus_client.parser import text_string_to_metric_families  # noqa: E402

from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.metrics import registry as jreg  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.observability import device as jdev  # noqa: E402

from llmq_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.metrics import registry as treg  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.observability import device as tdev  # noqa: E402
from llmq_tpu_torch.ops.quant import params_bytes  # noqa: E402

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"


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
    for mod in (jdev, tdev):
        monkeypatch.setattr(mod, "time", fake)
    return fake


@pytest.fixture
def jax_h100(monkeypatch):
    """JAX's peak tables holding the port's H100 row (and falling back
    to it), so the formulas can be compared."""
    monkeypatch.setattr(jdev, "PEAK_BF16_FLOPS", dict(tdev.PEAK_BF16_FLOPS))
    monkeypatch.setattr(jdev, "_DEFAULT_PEAK", tdev._DEFAULT_PEAK)
    monkeypatch.setattr(jdev, "PEAK_HBM_BYTES", dict(tdev.PEAK_HBM_BYTES))
    monkeypatch.setattr(jdev, "_DEFAULT_PEAK_HBM", tdev._DEFAULT_PEAK_HBM)


def test_peak_tables_hold_nvidia_rows_only():
    assert tdev.PEAK_BF16_FLOPS == {"h100": 989e12}
    assert tdev.PEAK_HBM_BYTES == {"h100": 3.35e12}
    assert tdev.peak_flops(H100) == tdev.peak_flops("mystery") == 989e12
    assert tdev.peak_flops(H100, "int8") == 2 * 989e12
    assert tdev.peak_hbm_bandwidth("cpu") == 3.35e12


@pytest.mark.parametrize("kind", [H100, "nvidia h100 pcie", "cpu", ""])
@pytest.mark.parametrize("quant", ["", "int8"])
def test_mfu_and_bandwidth_math_are_jaxs(jax_h100, kind, quant):
    for rate, n, chips in ((112.5, 8_030_261_248, 1), (0.0, 10, 1),
                           (900.0, 0, 1), (740.0, 8_030_261_248, 4)):
        assert tdev.decode_mfu(rate, n, kind, quant, chips) == \
            jdev.decode_mfu(rate, n, kind, quant, chips)
    args = (800.0, 8, 16_060_522_496, 131072, 600.0, kind)
    assert tdev.decode_hbm_bw_util(*args) == jdev.decode_hbm_bw_util(*args)
    assert tdev.decode_hbm_bw_util(*args, n_chips=2, dp=2) == \
        jdev.decode_hbm_bw_util(*args, n_chips=2, dp=2)
    assert tdev.decode_hbm_bw_util(0.0, 8, 1, 1, 1.0, kind) == 0.0


def _steps_run(mod, clock, name):
    t = mod.DeviceTelemetry(name, metrics=False)
    t.configure_model(n_params=8_030_261_248, device_kind=H100, quant="",
                      n_chips=1)
    for i in range(12):
        clock.advance(0.02)
        t.note_step(0.0005 * i, 0.009 + 0.0001 * i, 0.00001,
                    8 if i % 3 else 0, overlapped_s=0.004 * (i % 2))
    clock.advance(31.0)
    t.note_step(0.001, 0.01, 0.0, 16)
    for prog, secs in (("decode_step_fused", 1.25), ("prefill_b128", 0.5)):
        t.note_compile(prog, secs, False)
    t.note_compile("prefill_b512", 0.125, True)
    t.note_warmup(2, 3)
    shot = t.snapshot()
    t.note_warmup_complete(4.321)
    return [shot, t.snapshot(), t.tokens_per_s(), t.mfu(),
            t.overlap_ratio()]


def test_note_step_snapshots_are_jaxs(clock, jax_h100):
    out = {}
    for side, mod in (("jax", jdev), ("port", tdev)):
        clock.t = 1_700_000_000.0
        out[side] = _steps_run(mod, clock, f"{side}-steps")
    assert out["port"] == out["jax"]
    assert out["port"][0]["steps"]["count"] == 13
    assert out["port"][1]["compile"]["warmup_s"] == 4.32


def test_speculation_block_is_jaxs(clock, jax_h100):
    """Tolerance: none. The same reconciled windows noted into both
    packages' telemetry give the same snapshot ``speculation`` block
    (none before the first window), the rest of the snapshot equal too."""
    windows = [(3, 2, 3), (0, 0, 1), (6, 1, 4), (2, 2, 3), (0, 0, 2)]
    out = {}
    for side, mod in (("jax", jdev), ("port", tdev)):
        clock.t = 1_700_000_000.0
        t = mod.DeviceTelemetry(f"{side}-spec", metrics=False)
        t.configure_model(n_params=8_030_261_248, device_kind=H100,
                          quant="", n_chips=1)
        shots = [t.snapshot()]
        for proposed, accepted, committed in windows:
            clock.advance(0.01)
            t.note_step(0.0002, 0.009, 0.00001, committed)
            t.note_spec(proposed, accepted, committed)
            shots.append(t.snapshot())
        out[side] = shots
    assert out["port"] == out["jax"]
    assert "speculation" not in out["port"][0]
    assert out["port"][-1]["speculation"] == {
        "proposed": 11, "accepted": 5, "acceptance_rate": 0.4545,
        "committed": 13, "fetches": 5, "readback_cadence": 2.6}


class _JaxHandle:
    """A chunk handle as JAX's ``timed_fetch`` reads it."""

    def __init__(self, clock, ready_at, readback):
        self.clock, self.ready_at, self.readback = clock, ready_at, readback
        self.out = types.SimpleNamespace(block_until_ready=self._wait)

    def _wait(self):
        self.clock.t = max(self.clock.t, self.ready_at)

    def fetch(self):
        self.clock.advance(self.readback)
        return np.full((2, 4), 7, np.int32)


class _PortHandle(_JaxHandle):
    """The same chunk as the port's ``ChunkHandle`` is read: its own
    completion event, then the pinned host buffer."""

    def __init__(self, clock, ready_at, readback):
        super().__init__(clock, ready_at, readback)
        del self.out
        self.wait_ready = self._wait


#: (seconds after the start at dispatch, seconds at ready, readback s,
#: whether the chunk carries its dispatch time): a depth-2 pipeline's
#: overlapping spans, a serial chunk, one whose fetch comes long after it
#: was ready, and one without a dispatch stamp.
CHUNKS = [(0.0, 0.010, 0.0, True), (0.001, 0.019, 0.0001, True),
          (0.012, 0.028, 0.0, True), (0.030, 0.041, 0.0002, True),
          (0.045, 0.050, 0.0, True), (0.070, 0.080, 0.0, False)]


def test_timed_fetch_attributes_overlap_like_jax(clock):
    out = {}
    for side, mod, cls in (("jax", jdev, _JaxHandle),
                           ("port", tdev, _PortHandle)):
        t0 = clock.t = 1_700_000_000.0
        tel = mod.DeviceTelemetry(f"{side}-fetch", metrics=False)
        got = []
        for i, (disp, ready, rb, stamped) in enumerate(CHUNKS):
            clock.t = max(clock.t, t0 + disp + 0.0005)
            if i == 4:
                clock.t = t0 + 0.060            # fetched late
            h = cls(clock, t0 + ready, rb)
            res, dev, rbk, ovl = tel.timed_fetch(
                h, dispatched_at=(t0 + disp) if stamped else None)
            got.append((res.tolist(), round(dev, 9), round(rbk, 9),
                        round(ovl, 9)))
            tel.note_step(0.0, dev, rbk, 8, overlapped_s=ovl)
        out[side] = (got, tel.overlap_ratio())
    assert out["port"] == out["jax"]
    assert out["port"][1] > 0


def test_scrape_histograms_are_jaxs(clock, jax_h100):
    """``flush`` observes the same step legs into the same histograms and
    sets the same gauges (rate, MFU, overlap, HBM from the provider)."""
    name = f"dt{uuid.uuid4().hex[:8]}"
    hbm = {"kv_pool_occupancy": 0.25, "kv_pool_fragmentation": 0.5,
           "chips": [{"chip": "0", "weights_bytes": 1000,
                      "kv_pool_bytes": 200, "free_bytes": 5,
                      "limit_bytes": 10}]}
    got = {}
    for side, mod in (("jax", jdev), ("port", tdev)):
        clock.t = 1_700_000_000.0
        tel = mod.DeviceTelemetry(name, metrics=True)
        tel.configure_model(n_params=1000, device_kind=H100)
        tel.set_hbm_provider(lambda: hbm)
        for i in range(5):
            clock.advance(0.01)
            tel.note_step(0.0002 * i, 0.009, 0.0001, 8, overlapped_s=0.003)
        tel.flush()
        text = (generate_latest(jreg.REGISTRY).decode() if side == "jax"
                else treg.REGISTRY.exposition().decode())
        got[side] = {(s.name, tuple(sorted(s.labels.items()))): s.value
                     for fam in text_string_to_metric_families(text)
                     for s in fam.samples
                     if s.labels.get("engine") == name
                     and not s.name.endswith("_created")}
    assert got["port"] == got["jax"]
    assert ("llm_queue_hbm_weights_bytes",
            (("chip", "0"), ("engine", name))) in got["port"]


def test_measure_rtt_on_the_cpu():
    ms = tdev.measure_rtt(torch.device("cpu"), samples=3)
    assert 0 < ms < 1000


# -- the executor and the engine --------------------------------------------------

KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512, max_seq_len=256)
GEOM = dict(batch_size=4, page_size=16, num_pages=64, prefill_buckets=[16, 32],
            eos_id=-1, chunk_size=4)


@pytest.fixture(scope="module")
def executors():
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tag = f"dx{uuid.uuid4().hex[:8]}"
    jex = JaxExecutor(jcfg, jparams, telemetry_name=f"{tag}-j", **GEOM)
    tex = TorchExecutor(tcfg, tparams, device="cpu", telemetry_name=f"{tag}-t",
                        **GEOM)
    return jex, tex


def test_model_identity_and_hbm_bytes_are_jaxs(executors):
    """The executor's parameter count and its weight and KV-pool bytes
    are ``JaxExecutor``'s for the same model and pool."""
    jex, tex = executors
    j, t = jex.telemetry_info(), tex.telemetry_info()
    assert (t["n_params"], t["quant"], t["n_chips"]) == \
        (j["n_params"], j["quant"], j["n_chips"])
    assert t["device_kind"] == "cpu"
    jc, tc = jex.hbm_info()[0], tex.hbm_info()[0]
    assert (tc["weights_bytes"], tc["kv_pool_bytes"]) == \
        (jc["weights_bytes"], jc["kv_pool_bytes"])
    assert tc["weights_bytes"] == params_bytes(tex.model.params)
    assert set(jc) < set(tc)
    assert tc["graph_pool_bytes"] == 0 and tc["free_bytes"] is None


def test_engine_hbm_snapshot_is_jaxs(executors):
    jex, tex = executors
    j = JEngine(jex, JTok(), name=jex._telemetry.name)._hbm_snapshot()
    t = InferenceEngine(tex, ByteTokenizer(),
                        name=tex._telemetry.name)._hbm_snapshot()
    assert {k: v for k, v in t.items() if k != "chips"} == \
        {k: v for k, v in j.items() if k != "chips"}
    assert set(t) == set(j)


def test_started_engine_reports_hbm_after_a_same_named_one_is_gone(
        executors):
    """An engine built later under the same name takes the telemetry's
    HBM provider; once it is collected, the engine that starts serving
    takes the provider back, so the HBM gauges do not go dark."""
    import gc

    _, tex = executors
    name = tex._telemetry.name
    serving = InferenceEngine(tex, ByteTokenizer(), name=name)
    other = InferenceEngine(tex, ByteTokenizer(), name=name)
    del other
    gc.collect()
    assert "hbm" not in tex._telemetry.snapshot()
    serving.start()
    try:
        hbm = tex._telemetry.snapshot()["hbm"]
    finally:
        serving.stop()
    assert hbm == serving._hbm_snapshot()
    assert hbm["chips"][0]["weights_bytes"] == params_bytes(tex.model.params)


def test_warmup_notes_progress_and_rtt(executors):
    """On the CPU no graph is captured (no compile is noted), warmup
    completes the progress and the round-trip floor is measured. The
    snapshot rounds it to 2 decimals of a ms, as JAX's does, which a
    few-microsecond CPU round trip reads as 0.0: the measurement itself
    must be positive and the snapshot must show it rounded."""
    _, tex = executors
    tex.warmup()
    shot = tex._telemetry.snapshot()
    assert shot["compile"]["programs"] == {}
    assert shot["compile"]["warmup_done"] == shot["compile"]["warmup_total"]
    assert shot["compile"]["warmup_s"] == round(
        sum(tex.warmup_split.values()), 2)
    assert tex._telemetry.rtt_ms > 0 and tex.compile_s == 0.0
    assert shot["host_device_rtt_ms"] == round(tex._telemetry.rtt_ms, 2)


def test_profile_is_single_flight(tmp_path):
    """A capture answers its descriptor, a second start while it runs
    raises ``ProfileInProgress``, and once done the status holds it and
    its Chrome trace is on disk (host activity only on the CPU)."""
    info = tdev.start_profile(duration_s=0.3, label="unit",
                              base_dir=str(tmp_path))
    assert set(info) == {"label", "path", "duration_s", "started"}
    with pytest.raises(tdev.ProfileInProgress):
        tdev.start_profile(duration_s=0.1, base_dir=str(tmp_path))
    assert tdev.profile_status()["active"]
    deadline = time.time() + 30
    while tdev.profile_status()["active"] and time.time() < deadline:
        torch.ones(64).sum()
        time.sleep(0.01)
    st = tdev.profile_status()
    assert not st["active"] and st["last"]["label"] == "unit"
    doc = json.loads((tmp_path / "unit" / "trace.json").read_text())
    assert "traceEvents" in doc
    assert set(tdev.profile_status()) == set(jdev.profile_status())


def test_profile_holds_the_engine_while_the_profiler_starts_and_stops(
        executors, tmp_path):
    """The capture enters ``quiesce`` around the profiler's start and its
    stop (its device synchronize must not overlap a graph launch); an
    engine's ``paused`` parks the loop between two steps: nothing is
    dispatched while held, and serving resumes after."""
    from contextlib import contextmanager

    from llmq_tpu_torch.engine.engine import GenRequest

    held = []

    @contextmanager
    def quiesce():
        held.append("in")
        yield
        held.append("out")

    tdev.start_profile(duration_s=0.05, label="held", base_dir=str(tmp_path),
                       quiesce=quiesce)
    deadline = time.time() + 30
    while tdev.profile_status()["active"] and time.time() < deadline:
        time.sleep(0.01)
    assert held == ["in", "out", "in", "out"]
    _, tex = executors
    eng = InferenceEngine(tex, ByteTokenizer(), name=f"{tex._telemetry.name}-p",
                          max_decode_steps=24)
    with eng.paused():                  # no loop running: nothing to hold
        pass
    eng.start()
    try:
        h = eng.submit(GenRequest(id="pause-1", prompt="held while paused",
                                  max_new_tokens=24))
        while "first_token" not in h.marks and time.time() < deadline:
            time.sleep(0.005)
        with eng.paused():
            steps = eng.steps
            time.sleep(0.2)
            assert eng.steps == steps and not h.done
        assert h.wait(60) and h.result.finish_reason == "length"
    finally:
        eng.stop()


def test_profile_writes_its_trace_after_the_hold(tmp_path, monkeypatch):
    """The capture holds ``quiesce`` only around the profiler's start and
    stop: the Chrome trace is written after the hold is released (the
    engine serves while it is written), one event a line, and the
    finished descriptor carries the held seconds, the write's seconds
    and the event count."""
    from contextlib import contextmanager

    from llmq_tpu_torch.utils import profiling as tprof

    held = []
    written = []
    write = tprof.write_chrome_trace

    def writing(result, path):
        written.append(list(held))
        return write(result, path)

    @contextmanager
    def quiesce():
        held.append("in")
        yield
        held.append("out")

    monkeypatch.setattr(tprof, "write_chrome_trace", writing)
    tdev.start_profile(duration_s=0.05, label="write", base_dir=str(tmp_path),
                       quiesce=quiesce)
    deadline = time.time() + 30
    while tdev.profile_status()["active"] and time.time() < deadline:
        time.sleep(0.01)
    assert written == [["in", "out", "in", "out"]]
    last = tdev.profile_status()["last"]
    assert {"start_s", "stop_s", "write_s", "events"} <= set(last)
    assert last["stop_s"] > 0 and last["events"] >= 0
    lines = (tmp_path / "write" / tprof.TRACE_FILE).read_text().splitlines()
    assert lines[0] == '{"traceEvents": [' and lines[-1] == "]}"
    events = [json.loads(ln.lstrip(",")) for ln in lines[1:-1]]
    assert sum(e["ph"] == "X" for e in events) == last["events"]
