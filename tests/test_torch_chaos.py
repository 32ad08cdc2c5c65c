"""The port's chaos plane against the JAX package's, on the CPU: the same
seeded fault scenarios through both packages' echo engines, queue planes,
journals and REST servers in one process, each ending with both
packages' ``InvariantChecker`` (zero loss, zero duplicate completions,
monotone token streams) and holding the port's outcomes to JAX's.

Mirrors ``tests/test_chaos.py``: injector determinism (the same seed
fires the same pattern in both), engine crash recovery under the
supervisor (its give-up case too), WAL faults, the overload burst, the
off-switch equivalence (the default serve's streams with the ``chaos``
and ``store.resilience`` blocks at their defaults equal those without
them; no injector, no wrapped store, no ``store`` key in ``/health``),
the supervisor's edge cases, ``tests/test_speculation.py``'s crash
with a verify window in flight, and the flapping transport (a seeded
``transport.request`` fault with p=0.4 across two replicas behind the
cluster router)."""

from __future__ import annotations

import json
import time
import types
import urllib.error
import urllib.request

import pytest

from llmq_tpu import chaos as jchaos
from llmq_tpu.api.server import ApiServer as JApiServer
from llmq_tpu.cluster.router import ClusterRouter as JClusterRouter
from llmq_tpu.loadbalancer.load_balancer import LoadBalancer as JLB
from llmq_tpu.core import config as JC
from llmq_tpu.core import types as jtypes
from llmq_tpu.engine.engine import GenRequest as JGenRequest
from llmq_tpu.engine.engine import InferenceEngine as JEngine
from llmq_tpu.engine.executor import EchoExecutor as JEcho
from llmq_tpu.engine.supervisor import EngineSupervisor as JSupervisor
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok
from llmq_tpu.queueing import dead_letter_queue as jdlq
from llmq_tpu.queueing import factory as jfactory
from llmq_tpu.queueing import queue_manager as jqm
from llmq_tpu.queueing import wal as jwal
from llmq_tpu.queueing import worker as jworker

from llmq_tpu_torch import chaos as tchaos
from llmq_tpu_torch.api.server import ApiServer as TApiServer
from llmq_tpu_torch.cluster.router import ClusterRouter as TClusterRouter
from llmq_tpu_torch.loadbalancer.load_balancer import LoadBalancer as TLB
from llmq_tpu_torch.core import config as TC
from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.engine.engine import GenRequest as TGenRequest
from llmq_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmq_tpu_torch.engine.executor import EchoExecutor as TEcho
from llmq_tpu_torch.engine.supervisor import EngineSupervisor as TSupervisor
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from llmq_tpu_torch.queueing import dead_letter_queue as tdlq
from llmq_tpu_torch.queueing import factory as tfactory
from llmq_tpu_torch.queueing import queue_manager as tqm
from llmq_tpu_torch.queueing import wal as twal
from llmq_tpu_torch.queueing import worker as tworker

pytestmark = [
    # Injected EngineCrash kills engine threads on purpose.
    pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning"),
]

JAX = types.SimpleNamespace(
    name="jax", chaos=jchaos, C=JC, config=JC.default_config,
    Engine=JEngine, Echo=JEcho, Tok=JTok, GenRequest=JGenRequest,
    Supervisor=JSupervisor, Message=jtypes.Message,
    Priority=jtypes.Priority, QueueManager=jqm.QueueManager,
    DLQ=jdlq.DeadLetterQueue, Worker=jworker.Worker, WAL=jwal.QueueWAL,
    ApiServer=JApiServer, QueueFactory=jfactory.QueueFactory,
    QueueType=jfactory.QueueType, ClusterRouter=JClusterRouter, LB=JLB)
PORT = types.SimpleNamespace(
    name="port", chaos=tchaos, C=TC, config=TC.Config,
    Engine=TEngine, Echo=TEcho, Tok=TTok, GenRequest=TGenRequest,
    Supervisor=TSupervisor, Message=ttypes.Message,
    Priority=ttypes.Priority, QueueManager=tqm.QueueManager,
    DLQ=tdlq.DeadLetterQueue, Worker=tworker.Worker, WAL=twal.QueueWAL,
    ApiServer=TApiServer, QueueFactory=tfactory.QueueFactory,
    QueueType=tfactory.QueueType, ClusterRouter=TClusterRouter, LB=TLB)
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _chaos_reset():
    """Every scenario leaves both processes' chaos planes disarmed."""
    yield
    jchaos.configure(None)
    tchaos.configure(None)


def _arm(P, seed: int, *rules):
    inj = P.chaos.configure(P.C.ChaosConfig(enabled=True, seed=seed))
    for r in rules:
        inj.add_rule(**r)
    return inj


def _engine(P, name: str, **kw):
    kw.setdefault("enable_metrics", False)
    kw.setdefault("max_decode_steps", 24)
    return P.Engine(P.Echo(batch_size=4), P.Tok(), name=name, **kw)


def _stack(P, engine, checker, name: str, *, backoff: float = 0.05):
    """Queue manager, worker and DLQ wired into the checker: completions
    counted where a duplicate would deliver twice, dead letters as
    terminal."""
    cfg = P.config()
    cfg.queue.enable_metrics = False
    cfg.queue.worker.process_interval = 0.005
    cfg.queue.retry.initial_backoff = backoff
    cfg.queue.retry.max_backoff = backoff * 4
    mgr = P.QueueManager(name, config=cfg, enable_metrics=False)
    dlq = P.DLQ(name=f"{name}-dlq")
    dlq.add_handler(lambda item: checker.dead_lettered(item.message.id))
    orig_complete = mgr.complete_message

    def complete(m, t=0.0, q=None):
        checker.completed(m.id)
        orig_complete(m, t, q)

    mgr.complete_message = complete
    worker = P.Worker("w0", mgr, engine.process_fn, dead_letter_queue=dlq)
    return mgr, worker, dlq


def _await_terminal(checker, n, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        s = checker.summary()
        if sum(s["terminal"].values()) >= n:
            return s
        time.sleep(0.02)
    raise AssertionError(f"only {checker.summary()} terminal after "
                         f"{timeout}s")


def _wait_dead(engine, timeout=5.0):
    deadline = time.time() + timeout
    while engine.running and time.time() < deadline:
        time.sleep(0.01)
    assert not engine.running


# -- the injector --------------------------------------------------------------


class TestInjectorDeterminism:
    @pytest.mark.parametrize("seed", [1234, 99, 7])
    @pytest.mark.parametrize("kind,exc", [("error", "ChaosFault"),
                                          ("oserror", "ChaosOSError")])
    def test_same_seed_same_firing_pattern(self, seed, kind, exc):
        """Tolerance: none. A probability-0.5 rule fires on the same
        calls in both packages from the same seed, and another seed moves
        the pattern."""
        def pattern(P, s):
            inj = P.chaos.FaultInjector(seed=s)
            inj.add_rule("p", kind=kind, probability=0.5)
            fired = []
            for _ in range(64):
                try:
                    inj.fault("p")
                    fired.append(0)
                except getattr(P.chaos, exc):
                    fired.append(1)
            return fired

        a = pattern(PORT, seed)
        assert a == pattern(JAX, seed)
        assert 10 < sum(a) < 54
        assert pattern(PORT, seed + 1) != a

    def test_times_after_and_match_filters(self):
        got = {}
        for P in PKGS:
            inj = P.chaos.FaultInjector(seed=0)
            inj.add_rule("t", kind="error", times=2, after=1,
                         endpoint="only-this")
            outcomes = []
            for _ in range(5):
                try:
                    inj.fault("t", endpoint="only-this")
                    outcomes.append("ok")
                except P.chaos.ChaosFault:
                    outcomes.append("fault")
            inj.fault("t", endpoint="someone-else")   # filtered
            got[P.name] = (outcomes, inj.get_stats())
        assert got["port"] == got["jax"]
        assert got["port"][0] == ["ok", "fault", "fault", "ok", "ok"]
        assert got["port"][1]["injected"] == {"t:error": 2}

    @pytest.mark.parametrize("kind,exc", [
        ("timeout", TimeoutError), ("partial", TimeoutError),
        ("oserror", OSError), ("crash", BaseException)])
    def test_kinds_raise_the_same_classes(self, kind, exc):
        """Each kind raises its class (``crash`` is no Exception) and a
        ``latency`` rule sleeps and returns, in both packages."""
        for P in PKGS:
            inj = P.chaos.FaultInjector(seed=1)
            inj.add_rule("k", kind=kind, times=1)
            inj.add_rule("slow", kind="latency", latency_ms=30, times=1)
            with pytest.raises(exc) as e:
                inj.fault("k")
            assert (kind == "crash") == (not isinstance(e.value, Exception))
            t0 = time.perf_counter()
            inj.fault("slow")
            assert time.perf_counter() - t0 >= 0.025
        with pytest.raises(ValueError):
            tchaos.FaultInjector().add_rule("x", kind="explode")

    def test_disabled_is_a_noop(self):
        for P in PKGS:
            P.chaos.configure(P.C.ChaosConfig(enabled=False, faults=[
                {"point": "engine.step", "kind": "crash"}]))
            assert P.chaos.get_injector() is None
            P.chaos.fault("engine.step")


# -- the engine under the supervisor -------------------------------------------


class TestEngineCrashRecovery:
    @pytest.mark.parametrize("P", PKGS, ids=lambda P: P.name)
    def test_crash_under_load_zero_loss(self, P):
        """The engine thread killed at its 7th step while serving: the
        supervisor restarts it, the requests in flight fail over to the
        worker's retry, and every request completes exactly once."""
        _arm(P, 11, {"point": "engine.step", "kind": "crash", "times": 1,
                     "after": 6})
        checker = P.chaos.InvariantChecker()
        engine = _engine(P, f"crashload-{P.name}")
        engine.start()
        sup = P.Supervisor(engine, config=P.C.SupervisorConfig(
            check_interval=0.02, max_restarts=10), enable_metrics=False)
        sup.start()
        mgr, worker, dlq = _stack(P, engine, checker, f"crash-{P.name}")
        worker.start()
        try:
            for i in range(10):
                m = P.Message(id=f"c{i}", content=f"chaos payload {i}",
                              user_id="u", timeout=20.0)
                checker.submitted(m.id)
                mgr.push_message(m)
            s = _await_terminal(checker, 10)
        finally:
            worker.stop()
            sup.stop()
            engine.stop()
            mgr.stop()
        checker.check()
        assert s["terminal"].get("completed", 0) == 10, s
        assert dlq.size() == 0
        assert sup.restarts >= 1
        assert sup.recovered_total >= 1

    def test_crash_mid_stream_monotone_tokens(self):
        """A crash with tokens streamed ends the stream with an explicit
        error whose tokens are a prefix of the result; a retry completes
        on the restarted engine with JAX's stream."""
        out = {}
        for P in PKGS:
            inj = _arm(P, 12)
            checker = P.chaos.InvariantChecker()
            engine = _engine(P, f"crashstream-{P.name}")
            sup = P.Supervisor(engine, config=P.C.SupervisorConfig(),
                               enable_metrics=False)
            h = engine.submit(P.GenRequest(
                id="s0", prompt="stream me through a crash",
                max_new_tokens=24), on_token=checker.on_token("s0"))
            checker.submitted("s0")
            for _ in range(200):
                engine.step()
                if len(checker._streams.get("s0", [])) >= 3:
                    break
            assert len(checker._streams.get("s0", [])) >= 3
            inj.add_rule("engine.step", kind="crash", times=1)
            engine.start()
            _wait_dead(engine)
            assert sup.check_once()
            assert h.wait(2.0)
            assert h.result.finish_reason == "error"
            checker.failed("s0")
            checker.completed("s0", tokens=h.result.tokens)
            checker._terminal["s0"].remove("completed")
            assert engine.running
            h2 = engine.submit(P.GenRequest(
                id="s1", prompt="stream me through a crash",
                max_new_tokens=24), on_token=checker.on_token("s1"))
            checker.submitted("s1")
            assert h2.wait(10.0)
            assert h2.result.finish_reason in ("eos", "length")
            checker.completed("s1", tokens=h2.result.tokens)
            engine.stop()
            checker.check()
            out[P.name] = (h.result.tokens, h2.result.tokens,
                           h2.result.finish_reason)
        assert out["port"] == out["jax"]

    def test_hbm_alloc_faults_delay_but_never_lose(self):
        """Simulated allocation failures act as an exhausted pool: the
        requesters stay pending, every request completes with JAX's
        stream, and the faults fired in both."""
        out = {}
        for P in PKGS:
            inj = _arm(P, 13, {"point": "engine.hbm_alloc",
                               "kind": "error", "times": 5})
            engine = _engine(P, f"hbm-{P.name}")
            handles = [engine.submit(P.GenRequest(
                id=f"a{i}", prompt=f"alloc fault {i}", max_new_tokens=8))
                for i in range(4)]
            engine.run_until_idle()
            engine.stop()
            for h in handles:
                assert h.result is not None
                assert h.result.finish_reason in ("eos", "length")
            out[P.name] = ([(h.result.tokens, h.result.finish_reason)
                            for h in handles],
                           inj.get_stats()["injected"])
        assert out["port"] == out["jax"]
        assert out["port"][1] == {"engine.hbm_alloc:error": 5}

    @pytest.mark.parametrize("P", PKGS, ids=lambda P: P.name)
    def test_supervisor_gives_up_on_crash_loop(self, P):
        """A crash loop is not restarted for ever: after ``max_restarts``
        in the window the engine stays down and reads unhealthy."""
        _arm(P, 14, {"point": "engine.step", "kind": "crash"})
        engine = _engine(P, f"crashloop-{P.name}")
        sup = P.Supervisor(engine, config=P.C.SupervisorConfig(
            max_restarts=2, restart_window=60.0), enable_metrics=False)
        engine.start()
        restarts = 0
        deadline = time.time() + 10.0
        while not sup.gave_up and time.time() < deadline:
            if not engine.running:
                if sup.check_once():
                    restarts += 1
            time.sleep(0.005)
        assert sup.gave_up
        assert restarts == 2
        assert not engine.running
        assert not engine.healthy()


# -- a flapping transport ------------------------------------------------------


class TestFlappingTransport:
    def test_flapping_replicas_zero_loss(self):
        """Dispatch over HTTP fails at random (p=0.4, seeded) across two
        replicas: failover, the worker's retries and the dead-letter
        backstop leave every message completed or parked, none lost and
        none delivered twice, in both packages."""
        got = {}
        for P in PKGS:
            _arm(P, 21, {"point": "transport.request", "kind": "error",
                         "probability": 0.4})
            checker = P.chaos.InvariantChecker()
            engines, servers = [], []
            router = P.ClusterRouter(
                P.LB(P.C.LoadBalancerConfig(strategy="round_robin",
                                            health_check_interval=0.0)),
                config=P.C.ClusterConfig(
                    failover_retries=3,
                    breaker=P.C.BreakerConfig(failure_threshold=3,
                                              base_backoff=0.05,
                                              jitter=0.2)),
                enable_metrics=False)
            for i in range(2):
                eng = _engine(P, f"flap{i}")
                eng.start()
                api = P.ApiServer(P.config(), engine=eng)
                port = api.start(host="127.0.0.1", port=0)
                engines.append(eng)
                servers.append(api)
                router.register_remote(f"http://127.0.0.1:{port}",
                                       endpoint_id=f"127.0.0.1:{port}")
            mgr, worker, _dlq = _stack(P, router, checker, "flap")
            worker.start()
            try:
                for i in range(16):
                    m = P.Message(id=f"f{i}", content=f"flap {i}",
                                  user_id="u", timeout=15.0)
                    checker.submitted(m.id)
                    mgr.push_message(m)
                s = _await_terminal(checker, 16, timeout=40.0)
            finally:
                worker.stop()
                mgr.stop()
                for api in servers:
                    api.stop()
                for eng in engines:
                    eng.stop()
            checker.check()
            got[P.name] = (s["terminal"].get("completed", 0)
                           + s["terminal"].get("dead_lettered", 0),
                           P.chaos.get_injector().get_stats()["injected"].get(
                               "transport.request:error", 0) > 0)
            P.chaos.configure(None)
        assert got["port"] == got["jax"] == (16, True)


# -- the journal ---------------------------------------------------------------


class TestWalFaults:
    def test_append_fault_fails_push_loudly_and_cleanly(self, tmp_path):
        """An injected append fault reaches the client and leaves nothing
        half recorded: both journals replay to the pushes that
        succeeded, and each package replays the other's journal alike."""
        restored = {}
        for P in PKGS:
            _arm(P, 31, {"point": "wal.append", "kind": "oserror",
                         "times": 1, "match": {"op": "push"}})
            path = str(tmp_path / f"{P.name}.wal")
            mgr = P.QueueManager(f"walchaos-{P.name}", enable_metrics=False,
                                 wal_path=path)
            with pytest.raises(OSError):
                mgr.push_message(P.Message(id="w0", content="x",
                                           user_id="u"))
            for i in range(1, 4):
                mgr.push_message(P.Message(id=f"w{i}", content="x",
                                           user_id="u"))
            assert mgr.total_pending() == 3
            mgr.stop()
            P.chaos.configure(None)
            restored[P.name] = path
        for path in restored.values():
            for P in PKGS:
                assert {m.id for _, m in P.WAL.replay(path)} == {
                    "w1", "w2", "w3"}

    def test_fsync_fault_never_loses_acknowledged_records(self, tmp_path):
        """fsync faults narrow the durability window and lose nothing:
        every record, the two faulted appends included, replays."""
        for P in PKGS:
            _arm(P, 32, {"point": "wal.fsync", "kind": "oserror",
                         "times": 2})
            path = str(tmp_path / f"fsync-{P.name}.wal")
            wal = P.WAL(path, fsync_every=1)
            outcomes = []
            for i in range(6):
                m = P.Message(id=f"s{i}", content="x", user_id="u")
                try:
                    wal.append("push", "normal", m.id, m)
                    outcomes.append("ok")
                except OSError:
                    outcomes.append("fsync-fault")
            wal.close()
            assert outcomes == ["fsync-fault"] * 2 + ["ok"] * 4
            assert {m.id for _, m in P.WAL.replay(path)} == {
                f"s{i}" for i in range(6)}


# -- the REST edge under a burst -----------------------------------------------


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v1/messages",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class TestOverloadBurst:
    def _burst_stack(self, P, depth_limit=8):
        cfg = P.config()
        cfg.queue.enable_metrics = False
        cfg.queue.worker.process_interval = 0.005
        cfg.loadbalancer.health_check_interval = 0.0
        cfg.overload.queue_depth_limit = depth_limit
        cfg.overload.retry_after = 2.0
        engine = _engine(P, f"burst-{P.name}")
        engine.start()
        factory = P.QueueFactory(cfg)
        factory.create_queue_manager("standard", P.QueueType.STANDARD)
        server = P.ApiServer(cfg, queue_factory=factory, engine=engine)
        return engine, factory, server

    def test_4x_burst_sheds_with_explicit_429_and_retry_after(self):
        """A 4x burst: past the backlog limit an explicit 429 with
        Retry-After, everything admitted completes once workers drain the
        queue, nothing vanishes; the same split as JAX's."""
        split = {}
        for P in PKGS:
            engine, factory, server = self._burst_stack(P)
            checker = P.chaos.InvariantChecker()
            port = server.start(host="127.0.0.1", port=0)
            accepted, shed = [], []
            try:
                for i in range(32):
                    checker.submitted(f"b{i}")
                    status, payload, hdrs = _post(port, {
                        "id": f"b{i}", "content": f"burst {i}",
                        "user_id": "u"})
                    if status == 202:
                        accepted.append(f"b{i}")
                        continue
                    assert status == 429, status
                    assert "retry_after" in payload
                    assert int(hdrs["Retry-After"]) >= 1
                    checker.shed(f"b{i}", 429)
                    shed.append(f"b{i}")
                mgr = factory.get_queue_manager("standard")
                orig_complete = mgr.complete_message

                def complete(m, t=0.0, q=None, _c=checker, _o=orig_complete):
                    _c.completed(m.id)
                    _o(m, t, q)

                mgr.complete_message = complete
                factory.create_workers("standard", 2, engine.process_fn)
                _await_terminal(checker, 32)
            finally:
                server.stop()
                factory.stop_all()
                engine.stop()
            checker.check()
            split[P.name] = (accepted, shed,
                             server.shedder.get_stats()["shed"]["backlog"])
        assert split["port"] == split["jax"]
        assert len(split["port"][0]) == 8 and split["port"][2] == 24

    def test_engine_down_sheds_503_with_retry_after(self):
        got = {}
        for P in PKGS:
            engine, factory, server = self._burst_stack(P)
            try:
                engine.stop()
                status, payload, _ = server.dispatch(
                    "POST", "/api/v1/messages",
                    json.dumps({"content": "x", "user_id": "u"}).encode())
                got[P.name] = (status, payload["retry_after"] >= 0.5,
                               server.shedder.get_stats()["shed"][
                                   "engine_down"])
                assert "engine" in payload["error"]
            finally:
                server.stop()
                factory.stop_all()
        assert got["port"] == got["jax"] == (503, True, 1)


# -- the off-switch --------------------------------------------------------------


class TestOffSwitchEquivalence:
    """chaos.enabled false: no injector and the same streams and
    scheduling; an armed injector whose rules match nothing changes
    nothing either."""

    @staticmethod
    def _scenario(P):
        engine = _engine(P, f"equiv-{P.name}")
        prios = [P.Priority.REALTIME, P.Priority.HIGH, P.Priority.NORMAL,
                 P.Priority.LOW]
        handles = [engine.submit(P.GenRequest(
            id=f"e{i}", prompt=f"equivalence payload {i} " * (1 + i % 3),
            priority=prios[i % 4], max_new_tokens=16)) for i in range(8)]
        engine.run_until_idle()
        engine.stop()
        return [(h.request.id, h.result.finish_reason,
                 tuple(h.result.tokens), h.result.text) for h in handles]

    def test_disabled_chaos_is_byte_identical(self):
        baseline = self._scenario(JAX)
        for P in PKGS:
            P.chaos.configure(None)
            assert self._scenario(P) == baseline
            P.chaos.configure(P.C.ChaosConfig(enabled=False, faults=[
                {"point": "engine.step", "kind": "crash"},
                {"point": "engine.hbm_alloc", "kind": "error"}]))
            assert P.chaos.get_injector() is None
            assert self._scenario(P) == baseline
            P.chaos.configure(P.C.ChaosConfig(enabled=True, seed=5, faults=[
                {"point": "no.such.point", "kind": "error"}]))
            assert P.chaos.get_injector() is not None
            assert self._scenario(P) == baseline

    def test_disabled_overload_builds_no_shedder(self):
        for P in PKGS:
            cfg = P.config()
            cfg.overload.enabled = False
            assert P.ApiServer(cfg).shedder is None
            assert P.ApiServer(P.config()).shedder is not None

    @pytest.mark.parametrize("blocks", ["absent", "defaults"])
    def test_default_serve_with_the_blocks_at_defaults(self, tmp_path,
                                                       monkeypatch, blocks):
        """The default serve (the echo backend, named) with the ``chaos``
        and ``store.resilience`` blocks at their defaults answers as
        without them: the same streams as the JAX engine's, no injector,
        the raw store unwrapped, and no ``store`` key in ``/health``."""
        from llmq_tpu_torch.__main__ import App
        from llmq_tpu_torch.conversation.persistence import InMemoryStore

        text = "executor: {backend: echo}\n"
        if blocks == "defaults":
            text += ("chaos: {enabled: false, seed: 0, faults: []}\n"
                     "store: {resilience: {enabled: false, "
                     "op_timeout_s: 0.25, retries: 2}}\n")
        path = tmp_path / "serve.yaml"
        path.write_text(text)
        monkeypatch.delenv("LLMQ_CONFIG", raising=False)
        cfg = TC.load_config(str(path), environ={})
        cfg.device = "cpu"
        tchaos.configure(cfg.chaos)
        assert tchaos.get_injector() is None
        app = App(cfg, with_api=True, with_workers=False)
        try:
            assert type(app.state_manager.store) is InMemoryStore
            status, health = app.api.health_check(None)
            assert status == 200 and "store" not in health
            got = []
            for i in range(4):
                h = app.engine.submit(TGenRequest(
                    id=f"o{i}", prompt=f"off switch {i} " * (1 + i),
                    max_new_tokens=12))
                got.append(h)
            app.engine.run_until_idle()
            streams = [(h.result.tokens, h.result.finish_reason)
                       for h in got]
        finally:
            app.engine.stop()
            app.factory.stop_all()
        from llmq_tpu.engine.builder import build_engine as jbuild

        jeng = jbuild(JC.load_config(str(path), env=False),
                      enable_metrics=False)
        jh = [jeng.submit(JGenRequest(id=f"o{i}",
                                      prompt=f"off switch {i} " * (1 + i),
                                      max_new_tokens=12))
              for i in range(4)]
        jeng.run_until_idle()
        jeng.stop()
        assert streams == [(h.result.tokens, h.result.finish_reason)
                           for h in jh]


# -- the supervisor's edges ------------------------------------------------------


class TestSupervisorEdgeCases:
    @pytest.mark.parametrize("P", PKGS, ids=lambda P: P.name)
    def test_give_up_still_recovers_final_crash_in_flight(self, P):
        """When the crash-loop bound trips, the final crash's requests are
        still failed over: nobody waits out a deadline against a dead
        engine."""
        _arm(P, 41, {"point": "engine.step", "kind": "crash"})
        engine = _engine(P, f"giveup-{P.name}")
        sup = P.Supervisor(engine, config=P.C.SupervisorConfig(
            max_restarts=0), enable_metrics=False)
        h = engine.submit(P.GenRequest(id="g0", prompt="doomed",
                                       max_new_tokens=8))
        engine.start()
        _wait_dead(engine)
        assert not sup.check_once()
        assert sup.gave_up
        assert h.wait(2.0)
        assert h.result.finish_reason == "error"
        assert sup.recovered_total == 1

    @pytest.mark.parametrize("P", PKGS, ids=lambda P: P.name)
    def test_deliberate_stop_is_not_resurrected(self, P):
        """A death with the stop flag set is a stop, not a crash."""
        inj = _arm(P, 42)
        engine = _engine(P, f"stopping-{P.name}")
        engine.start()
        sup = P.Supervisor(engine, config=P.C.SupervisorConfig(),
                           enable_metrics=False)
        inj.add_rule("engine.step", kind="crash", times=1)
        _wait_dead(engine)
        engine._stop.set()
        assert not sup.check_once()
        assert sup.restarts == 0
        assert not engine.running
        engine.stop()


# -- a verify window in flight -----------------------------------------------------


class TestEchoChaosRecovery:
    def test_crash_with_verify_window_in_flight(self):
        """A chaos ``engine.step`` crash with a verify window dispatched:
        the supervisor drops it, the streamed prefix stays monotone (no
        token of the dead window leaks) and is a prefix of the retry's
        greedy stream, and the retry completes on the restarted engine
        with JAX's stream."""
        out = {}
        for P in PKGS:
            inj = P.chaos.configure(P.C.ChaosConfig(enabled=True, seed=21))
            checker = P.chaos.InvariantChecker()
            tok = P.Tok()
            ex = P.Echo(batch_size=4, page_size=8, num_pages=256,
                        max_pages_per_seq=16, eos_id=tok.eos_id,
                        chunk_size=4, mixed_prefill_slices=2,
                        mixed_slice_tokens=8, async_chunks=True)
            eng = P.Engine(ex, tok, enable_metrics=False,
                           name=f"spec-chaos-{P.name}", max_decode_steps=64,
                           speculation=P.C.SpeculationConfig(
                               enabled=True, draft_k=4, ngram_max=3),
                           async_pipeline=P.C.AsyncPipelineConfig(
                               enabled=True, depth=2, completion_workers=1))
            prompt = "stream me through a crash " * 3
            h = eng.submit(P.GenRequest(id="s0", prompt=prompt,
                                        max_new_tokens=48),
                           on_token=checker.on_token("s0"))
            checker.submitted("s0")
            for _ in range(200):
                eng.step()
                # The committed tokens reach the stream on the completion
                # thread: wait for it, so a loaded host cannot finish the
                # request before three have streamed.
                eng._drain_completions()
                if eng._inflight and len(checker._streams.get("s0",
                                                              [])) >= 3:
                    break
            assert eng._inflight
            inj.add_rule("engine.step", kind="crash", times=1)
            eng.start()
            _wait_dead(eng)
            sup = P.Supervisor(eng, config=P.C.SupervisorConfig(),
                               enable_metrics=False)
            assert sup.check_once()
            assert not eng._inflight
            assert h.wait(2.0)
            assert h.result.finish_reason == "error"
            checker.failed("s0")
            checker.completed("s0", tokens=h.result.tokens)
            checker._terminal["s0"].remove("completed")
            h2 = eng.submit(P.GenRequest(id="s1", prompt=prompt,
                                         max_new_tokens=24),
                            on_token=checker.on_token("s1"))
            checker.submitted("s1")
            assert h2.wait(10.0)
            assert h2.result.finish_reason in ("eos", "length")
            eng._drain_completions()
            checker.completed("s1", tokens=h2.result.tokens)
            eng.stop()
            sup.stop()
            checker.check()
            assert eng.spec_tokens_accepted > 0
            # How far s0 got before the crash depends on when the
            # completion thread delivered its tokens; the retry's stream
            # does not, and the two agree as far as both go.
            streamed = checker._streams["s0"]
            n = min(len(streamed), len(h2.result.tokens))
            assert n > 0 and streamed[:n] == h2.result.tokens[:n]
            out[P.name] = h2.result.tokens
        assert out["port"] == out["jax"]
