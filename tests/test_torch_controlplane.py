"""The port's control plane against the JAX package's, on the CPU: each
scenario runs through both packages (their ``ReplicaController``,
``DegradationLadder``, pools, overload shedders, routers, REST servers
and ``App``) on the same fake clocks, burns and managers, and the
actions, reasons, rungs, shed verdicts and stats must be equal
(tolerance: none). Where threads race (the chaos cases) each package is
held to the JAX test's invariants and the two summaries are compared.

Mirrors ``tests/test_controlplane.py`` case for case: the reconcile loop
(bootstrap, burn and backlog scale-up with the cooldown, idle scale-down
by drain then decommission, the capacity guard, the action rate limit, a
down static peer, pause), the ladder (hysteresis, the rungs' sheds in
order, the backlog and headroom factors, the tenant-weight rung, the
controller's ticks), the chaos cases (a replica killed mid-stream and
replaced with none lost or duplicated; a flapping replica without
thrash), the REST surfaces (the overview's block, pause and resume on
/health, disabled answering otherwise), the wiring (the off switch, the
``App`` over its local engine, the autoscaler superseded, ``LLMQ_CONFIG``
exported for child replicas), the pools (local, exec, and a real
``python -m llmq_tpu_torch --backend echo`` child through the subprocess
pool) and the autoscaler's injected clock. Added: the subprocess pool's
scale-up, SIGKILL replacement and scale-down of a real child under the
controller's own loop, with the child's role passed down.
"""

from __future__ import annotations

import argparse
import calendar
import json
import os
import signal
import socket
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import pytest

from llmq_tpu import chaos as jchaos
from llmq_tpu import tenancy as jtenancy
from llmq_tpu.__main__ import App as JApp
from llmq_tpu.__main__ import _load as jload
from llmq_tpu.api import overload as joverload
from llmq_tpu.api.server import ApiError as JApiError
from llmq_tpu.api.server import ApiServer as JApiServer
from llmq_tpu.chaos import InvariantChecker as JChecker
from llmq_tpu.cluster.router import ClusterRouter as JRouter
from llmq_tpu import controlplane as jcp
from llmq_tpu.controlplane import pool as jpool
from llmq_tpu.core import clock as jclock
from llmq_tpu.core import config as JC
from llmq_tpu.core import types as jtypes
from llmq_tpu.engine.engine import GenRequest as JGenRequest
from llmq_tpu.engine.engine import InferenceEngine as JEngine
from llmq_tpu.engine.executor import EchoExecutor as JEcho
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok
from llmq_tpu.loadbalancer import load_balancer as jlb
from llmq_tpu.queueing.dead_letter_queue import DeadLetterQueue as JDLQ
from llmq_tpu.queueing.queue_manager import QueueManager as JQM
from llmq_tpu.queueing.worker import Worker as JWorker
from llmq_tpu.scheduling.autoscaler import Autoscaler as JAutoscaler

from llmq_tpu_torch import chaos as tchaos
from llmq_tpu_torch import tenancy as ttenancy
from llmq_tpu_torch.__main__ import App as TApp
from llmq_tpu_torch.__main__ import _load as tload
from llmq_tpu_torch.api import overload as toverload
from llmq_tpu_torch.api.server import ApiError as TApiError
from llmq_tpu_torch.api.server import ApiServer as TApiServer
from llmq_tpu_torch.chaos import InvariantChecker as TChecker
from llmq_tpu_torch.cluster.router import ClusterRouter as TRouter
from llmq_tpu_torch import controlplane as tcp
from llmq_tpu_torch.controlplane import pool as tpool
from llmq_tpu_torch.core import clock as tclock
from llmq_tpu_torch.core import config as TC
from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.engine.engine import GenRequest as TGenRequest
from llmq_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmq_tpu_torch.engine.executor import EchoExecutor as TEcho
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from llmq_tpu_torch.loadbalancer import load_balancer as tlb
from llmq_tpu_torch.queueing.dead_letter_queue import DeadLetterQueue as TDLQ
from llmq_tpu_torch.queueing.queue_manager import QueueManager as TQM
from llmq_tpu_torch.queueing.worker import Worker as TWorker
from llmq_tpu_torch.scheduling.autoscaler import Autoscaler as TAutoscaler

pytestmark = [pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(
    name="jax", C=JC, config=JC.default_config, chaos=jchaos,
    tenancy=jtenancy, App=JApp, load=jload, Shedder=joverload.OverloadShedder,
    ApiError=JApiError, ApiServer=JApiServer, Checker=JChecker,
    Router=JRouter, cp=jcp, pool=jpool, FakeClock=jclock.FakeClock,
    Message=jtypes.Message, Priority=jtypes.Priority,
    GenRequest=JGenRequest, Engine=JEngine, Echo=JEcho, Tok=JTok, lb=jlb,
    DLQ=JDLQ, QM=JQM, Worker=JWorker, Autoscaler=JAutoscaler)
PORT = types.SimpleNamespace(
    name="port", C=TC, config=TC.Config, chaos=tchaos,
    tenancy=ttenancy, App=TApp, load=tload, Shedder=toverload.OverloadShedder,
    ApiError=TApiError, ApiServer=TApiServer, Checker=TChecker,
    Router=TRouter, cp=tcp, pool=tpool, FakeClock=tclock.FakeClock,
    Message=ttypes.Message, Priority=ttypes.Priority,
    GenRequest=TGenRequest, Engine=TEngine, Echo=TEcho, Tok=TTok, lb=tlb,
    DLQ=TDLQ, QM=TQM, Worker=TWorker, Autoscaler=TAutoscaler)
PKGS = (JAX, PORT)


def _same(run):
    """``run`` over both packages; the outcomes must be equal."""
    out = {P.name: run(P) for P in PKGS}
    assert out["jax"] == out["port"], out
    return out["port"]


@pytest.fixture(autouse=True)
def _chaos_reset():
    yield
    jchaos.configure(None)
    tchaos.configure(None)


class FakeBurn:
    """The SLO tracker's stand-in: the case sets the burn."""

    def __init__(self) -> None:
        self.fast = 0.0
        self.slow = 0.0

    def burn_rates(self) -> Dict:
        return {"ttft": {"5m": {"burn_rate": self.fast},
                         "1h": {"burn_rate": self.slow}}}


class FakeManager:
    def __init__(self, pending: int = 0) -> None:
        self.pending = pending

    def total_pending(self) -> int:
        return self.pending


def _echo_engine(P, name, *, pipelined=False):
    tok = P.Tok()
    ex = P.Echo(batch_size=8, page_size=8, num_pages=512,
                max_pages_per_seq=16, eos_id=tok.eos_id, chunk_size=4,
                async_chunks=pipelined)
    return P.Engine(
        ex, tok, name=name, enable_metrics=False, max_decode_steps=32,
        async_pipeline=(P.C.AsyncPipelineConfig(enabled=True, depth=2)
                        if pipelined else None))


def _router(P, **cluster_kw):
    lb = P.lb.LoadBalancer(P.C.LoadBalancerConfig(
        strategy="round_robin", health_check_interval=0.0))
    cluster_kw.setdefault("failover_retries", 3)
    cluster_kw.setdefault("breaker", P.C.BreakerConfig(
        failure_threshold=3, base_backoff=0.05, jitter=0.2))
    return P.Router(lb, config=P.C.ClusterConfig(**cluster_kw),
                    enable_metrics=False)


def _controller(P, router, *, pool=None, cfg=None, burn=None, manager=None,
                shedder=None, clock=None, supervisor=None):
    return P.cp.ReplicaController(
        config=cfg or P.C.ControlPlaneConfig(enabled=True, interval=0.0),
        router=router, pool=pool, queue_manager=manager, shedder=shedder,
        slo_tracker=burn or FakeBurn(), supervisor=supervisor, clock=clock,
        enable_metrics=False)


def _pool(P, prefix="pool", *, pipelined=False, max_restarts=0):
    def factory(seq):
        return _echo_engine(P, f"{prefix}-{seq}", pipelined=pipelined)

    return P.cp.LocalEnginePool(
        factory, supervise=True,
        supervisor_config=P.C.SupervisorConfig(check_interval=0.02,
                                               max_restarts=max_restarts))


def _stack(P, process_like, checker, name, *, backoff=0.05):
    """A queue manager, a worker and a dead-letter queue wired into the
    invariant checker (the chaos harness's pattern)."""
    cfg = P.config()
    cfg.queue.enable_metrics = False
    cfg.queue.worker.process_interval = 0.005
    cfg.queue.retry.initial_backoff = backoff
    cfg.queue.retry.max_backoff = backoff * 4
    mgr = P.QM(name, config=cfg, enable_metrics=False)
    dlq = P.DLQ(name=f"{name}-dlq")
    dlq.add_handler(lambda item: checker.dead_lettered(item.message.id))
    orig_complete = mgr.complete_message

    def complete(m, t=0.0, q=None):
        checker.completed(m.id)
        orig_complete(m, t, q)

    mgr.complete_message = complete
    worker = P.Worker("w0", mgr, process_like.process_fn,
                      dead_letter_queue=dlq)
    return mgr, worker, dlq


def _cfg(P, **kw):
    return P.C.ControlPlaneConfig(enabled=True, interval=0.0, **kw)


def _statuses(router):
    return sorted(e.status.value for e in router.lb.endpoints())


# -- the reconcile loop ---------------------------------------------------------


class TestReconcile:
    def test_bootstrap_to_min_replicas(self):
        def run(P):
            router = _router(P)
            ctl = _controller(P, router, pool=_pool(P, "boot"),
                              cfg=_cfg(P, min_replicas=2, max_replicas=4))
            try:
                out = ctl.run_once()
                return (out["target"], len(router.lb.endpoints()),
                        out["actions"], sorted(ctl.action_counts.items()))
            finally:
                ctl.stop()

        got = _same(run)
        assert got[:2] == (2, 2)
        assert [a for a, _ in got[2]].count("scale_up") == 2

    def test_burn_drives_scale_up_with_cooldown(self):
        def run(P):
            clock, burn, router = P.FakeClock(), FakeBurn(), _router(P)
            cfg = _cfg(P, min_replicas=1, max_replicas=4, cooldown=10.0)
            ctl = _controller(P, router, pool=_pool(P, "burnup"), cfg=cfg,
                              burn=burn, clock=clock)
            trail = []
            try:
                ctl.run_once()
                trail.append(ctl.target)
                burn.fast = cfg.fast_burn_threshold + 1
                for adv in (0.0, 0.0, 11.0):
                    clock.advance(adv)
                    out = ctl.run_once()
                    trail.append((ctl.target, out["actions"]))
                burn.fast, burn.slow = 0.0, cfg.slow_burn_threshold + 1
                for _ in range(2):
                    clock.advance(11.0)
                    out = ctl.run_once()
                    trail.append((ctl.target, out["actions"]))
                return trail, sorted(ctl.action_counts.items())
            finally:
                ctl.stop()

        trail, _ = _same(run)
        assert trail[0] == 1
        assert trail[1][0] == 2 and ("scale_up", "burn_fast") in trail[1][1]
        assert ("skip", "cooldown") in trail[2][1] and trail[2][0] == 2
        assert trail[3][0] == 3
        assert ("scale_up", "burn_slow") in trail[4][1] and trail[4][0] == 4
        assert trail[5][0] == 4

    def test_backlog_drives_scale_up(self):
        def run(P):
            router = _router(P)
            ctl = _controller(P, router, pool=_pool(P, "backlog"),
                              cfg=_cfg(P, backlog_per_replica=64,
                                       max_replicas=4, cooldown=0.0),
                              manager=FakeManager(pending=1000),
                              clock=P.FakeClock())
            try:
                ctl.run_once()
                out = ctl.run_once()
                return out["actions"], out["target"], ctl.ladder.level
            finally:
                ctl.stop()

        actions, _, _ = _same(run)
        assert ("scale_up", "backlog") in actions

    def test_idle_scale_down_drains_then_decommissions(self):
        def run(P):
            clock, router, pool = P.FakeClock(), _router(P), _pool(P, "down")
            ctl = _controller(P, router, pool=pool,
                              cfg=_cfg(P, min_replicas=1, max_replicas=4,
                                       cooldown=5.0),
                              clock=clock, manager=FakeManager(0))
            trail = []
            try:
                ctl.run_once()
                ctl.target = 3
                ctl.run_once()
                trail.append(len(router.lb.endpoints()))
                clock.advance(6.0)
                out = ctl.run_once()
                trail.append((out["actions"], ctl.target,
                              _statuses(router)))
                ctl.run_once()
                trail.append((_statuses(router), pool.decommissioned))
                for _ in range(6):
                    clock.advance(6.0)
                    ctl.run_once()
                trail.append((ctl.target, len(router.lb.endpoints()),
                              pool.get_stats()))
                return trail
            finally:
                ctl.stop()

        trail = _same(run)
        assert trail[0] == 3
        assert trail[1][0] == [("scale_down", "idle")] and trail[1][1] == 2
        assert trail[1][2].count("draining") == 1
        assert trail[2] == (["healthy", "healthy"], 1)
        assert trail[3][:2] == (1, 1)

    def test_capacity_guard_blocks_scale_down(self):
        def run(P):
            router = _router(P)
            ctl = _controller(P, router, pool=_pool(P, "cap"),
                              cfg=_cfg(P, min_replicas=1, cooldown=0.0,
                                       scale_down_headroom=1.5),
                              clock=P.FakeClock(), manager=FakeManager(0))
            try:
                ctl.run_once()
                ctl.target = 2
                ctl.run_once()
                ctl._peak_replica_tok_s = 100.0
                vetoed = ctl._capacity_allows_scale_down(
                    {"tokens_per_s": 150.0}, healthy_n=2)
                allowed = ctl._capacity_allows_scale_down(
                    {"tokens_per_s": 40.0}, healthy_n=2)
                return vetoed, allowed, ctl.action_counts.get("skip:capacity")
            finally:
                ctl.stop()

        assert _same(run) == (False, True, 1)

    def test_action_rate_limit_holds(self):
        def run(P):
            clock, burn, router = P.FakeClock(), FakeBurn(), _router(P)
            ctl = _controller(P, router, pool=_pool(P, "thrash"),
                              cfg=_cfg(P, min_replicas=1, max_replicas=8,
                                       cooldown=0.0,
                                       max_actions_per_minute=3),
                              burn=burn, clock=clock)
            try:
                ctl.run_once()
                burn.fast = 100.0
                for _ in range(10):
                    ctl.run_once()
                    clock.advance(0.5)
                limited = (ctl.scale_action_total(),
                           ctl.action_counts.get("skip:rate_limited", 0))
                clock.advance(61.0)
                resumed = ctl.run_once()["actions"]
                ctl.config.max_actions_per_minute = 0
                before = ctl.scale_action_total()
                for _ in range(4):
                    ctl.run_once()
                return limited, resumed, ctl.scale_action_total() - before
            finally:
                ctl.stop()

        limited, resumed, more = _same(run)
        assert limited[0] <= 3 and limited[1] > 0
        assert ("scale_up", "burn_fast") in resumed and more >= 3

    def test_down_static_peer_does_not_pin_fleet_or_recovery(self):
        def run(P):
            clock, router = P.FakeClock(), _router(P)
            router.lb.add_endpoint(P.lb.Endpoint(
                id="peer-down", url="http://10.0.0.9:1",
                status=P.lb.EndpointStatus.UNHEALTHY))
            ctl = _controller(P, router, pool=_pool(P, "peerdown"),
                              cfg=_cfg(P, min_replicas=1, max_replicas=4,
                                       cooldown=5.0),
                              clock=clock, manager=FakeManager(0))
            try:
                ctl.run_once()
                ctl.target = 3
                ctl.run_once()
                clock.advance(6.0)
                out = ctl.run_once()
                ctl._recovering_since = clock.now() - 2.0
                clock.advance(6.0)
                ctl.run_once()
                return out["actions"], ctl.last_recovery_s
            finally:
                ctl.stop()

        actions, rec = _same(run)
        assert ("scale_down", "idle") in actions and rec is not None

    def test_pause_still_reaps_inflight_drain(self):
        def run(P):
            clock, router, pool = (P.FakeClock(), _router(P),
                                   _pool(P, "pausedrain"))
            ctl = _controller(P, router, pool=pool,
                              cfg=_cfg(P, min_replicas=1, cooldown=5.0),
                              clock=clock, manager=FakeManager(0))
            try:
                ctl.run_once()
                ctl.target = 2
                ctl.run_once()
                clock.advance(6.0)
                first = ctl.run_once()["actions"]
                ctl.pause()
                out = ctl.run_once()
                return (first, out["paused"], len(router.lb.endpoints()),
                        pool.decommissioned)
            finally:
                ctl.stop()

        assert _same(run) == ([("scale_down", "idle")], True, 1, 1)

    def test_paused_observes_but_never_acts(self):
        def run(P):
            burn, router = FakeBurn(), _router(P)
            ctl = _controller(P, router, pool=_pool(P, "paused"), burn=burn,
                              cfg=_cfg(P, min_replicas=2, cooldown=0.0))
            try:
                ctl.pause()
                burn.fast = 100.0
                out = ctl.run_once()
                snap = ctl.snapshot()
                paused = (out["paused"], out["actions"],
                          len(router.lb.endpoints()), snap["paused"],
                          snap["inputs"]["fast_burn"])
                burn.fast = 0.0
                ctl.resume()
                out = ctl.run_once()
                return (paused, out["paused"], len(router.lb.endpoints()),
                        ctl.action_counts.get("pause:operator"),
                        ctl.action_counts.get("resume:operator"))
            finally:
                ctl.stop()

        assert _same(run) == ((True, [], 0, True, 100.0), False, 2, 1, 1)


# -- the degradation ladder -------------------------------------------------------


def _shedder(P, registry=None):
    cfg = P.C.OverloadConfig(enabled=True, queue_depth_limit=100,
                             deadline_headroom=1.0)
    return P.Shedder(cfg, None, tenant_registry=registry,
                     enable_metrics=False)


def _verdict(P, shedder, msg, mgr=None):
    """None when admitted, else (status, reason words, retry_after)."""
    try:
        shedder.admit(msg, mgr, 0.0)
        return None
    except P.ApiError as e:
        return (e.status, e.message.split(":")[0], e.retry_after)


class TestLadder:
    def test_hysteresis_escalate_and_relax(self):
        def run(P):
            ladder = P.cp.DegradationLadder(P.C.default_rungs(),
                                            relax_after_ticks=3)
            ticks = [(True, False)] * 4 + [(False, True)] * 2 + \
                [(False, False)] + [(False, True)] * 3
            return [(ladder.tick(hot=h, calm=c), ladder.level)
                    for h, c in ticks], ladder.snapshot()

        trail, snap = _same(run)
        assert [lv for _, lv in trail] == [1, 2, 3, 3, 3, 3, 3, 3, 3, 2]
        assert trail[-1][0] == "relax" and trail[3][0] is None

    def test_rungs_tighten_admission_in_order(self):
        def run(P):
            shedder = _shedder(P)
            ladder = P.cp.DegradationLadder(P.C.default_rungs(),
                                            shedder=shedder,
                                            relax_after_ticks=1)
            low = P.Message(id="m-low", content="x", user_id="u",
                            priority=P.Priority.LOW)
            rt = P.Message(id="m-rt", content="x", user_id="u",
                           priority=P.Priority.REALTIME)
            out = [_verdict(P, shedder, low)]
            ladder.tick(hot=True, calm=False)
            out.append(_verdict(P, shedder, low))
            ladder.tick(hot=True, calm=False)
            out.append(_verdict(P, shedder, low))
            out.append(_verdict(P, shedder, rt))
            out.append(shedder.get_stats())
            ladder.tick(hot=False, calm=True)
            out.append(_verdict(P, shedder, low))
            ladder.tick(hot=False, calm=True)
            out.append((shedder._degradation, shedder.get_stats()))
            return out

        out = _same(run)
        assert out[0] is None and out[1] is None
        assert out[2][:2] == (429, "overloaded (degraded)")
        assert out[3] is None
        assert out[4]["shed"]["degraded"] == 1
        assert out[4]["degradation"] == "shed_batch"
        assert out[5] is None
        assert out[6][0] is None and out[6][1]["degradation"] is None

    def test_backlog_and_headroom_factors_scale_thresholds(self):
        def run(P):
            shedder = _shedder(P)
            mgr = FakeManager(pending=80)
            msg = P.Message(id="m0", content="x", user_id="u")
            before = _verdict(P, shedder, msg, mgr)
            shedder.set_degradation({"name": "tighten",
                                     "backlog_factor": 0.7})
            after = _verdict(P, shedder, msg, mgr)
            # The headroom factor: a 10 s request with a 6 s wait passes
            # at headroom 1.0 and is shed at 0.5.
            slow = P.Message(id="m1", content="x", user_id="u",
                             timeout=10.0)
            shedder.set_degradation(None)
            h1 = shedder.admit(slow, None, 6.0)
            shedder.set_degradation({"name": "t", "headroom_factor": 0.5})
            try:
                shedder.admit(slow, None, 6.0)
                h2 = None
            except P.ApiError as e:
                h2 = (e.status, e.message.split(":")[0])
            return before, after, h1, h2

        before, after, h1, h2 = _same(run)
        assert before is None and after[:2] == (429, "overloaded (backlog)")
        assert h1 is None and h2 == (429, "overloaded (sla)")

    def test_low_weight_tenants_shed_last_rung(self):
        def run(P):
            reg = P.tenancy.configure_tenancy(P.C.TenancyConfig(
                enabled=True, tenants={"gold": {"weight": 4.0},
                                       "bronze": {"weight": 0.5}}))
            try:
                shedder = _shedder(P, registry=reg)
                shedder.set_degradation(P.C.default_rungs()[2])
                gold = P.Message(id="g0", content="x", user_id="u",
                                 priority=P.Priority.REALTIME,
                                 tenant_id="gold")
                bronze = P.Message(id="b0", content="x", user_id="u",
                                   priority=P.Priority.REALTIME,
                                   tenant_id="bronze")
                return (_verdict(P, shedder, gold),
                        _verdict(P, shedder, bronze))
            finally:
                P.tenancy.reset_tenancy()

        gold, bronze = _same(run)
        assert gold is None and bronze[:2] == (429, "overloaded (degraded)")

    def test_controller_ladder_integration(self):
        def run(P):
            clock, burn, router = P.FakeClock(), FakeBurn(), _router(P)
            shedder = _shedder(P)
            ctl = _controller(P, router, pool=_pool(P, "lad"),
                              cfg=_cfg(P, min_replicas=1, max_replicas=1,
                                       cooldown=0.0, relax_after_ticks=2),
                              burn=burn, clock=clock, shedder=shedder)
            try:
                ctl.run_once()
                burn.fast = 2.0
                up = ctl.run_once()["actions"]
                mid = (ctl.ladder.level, shedder._degradation)
                burn.fast = 0.0
                ctl.run_once()
                down = ctl.run_once()["actions"]
                return up, mid, down, ctl.ladder.level, shedder._degradation
            finally:
                ctl.stop()

        up, mid, down, level, deg = _same(run)
        assert ("escalate", "burn_fast") in up and mid[0] == 1
        assert mid[1] is not None
        assert ("relax", "recovered") in down and (level, deg) == (0, None)


# -- chaos ------------------------------------------------------------------------


class TestChaosRecovery:
    @pytest.mark.chaos
    def test_kill_replica_mid_stream_controller_restores_slo(self):
        """A seeded EngineCrash kills replica kill-1 mid-stream with two
        chunks in flight; its supervisor gives up, the controller
        replaces it, and no message is lost or duplicated, in both
        packages."""
        def run(P):
            P.chaos.configure(P.C.ChaosConfig(enabled=True, seed=11, faults=[
                {"point": "engine.step", "kind": "crash", "times": 1,
                 "after": 8, "match": {"engine": "kill-1"}}]))
            checker = P.Checker()
            router = _router(P)
            pool = _pool(P, "kill", pipelined=True, max_restarts=0)
            cfg = _cfg(P, min_replicas=2, max_replicas=3, cooldown=0.0,
                       recovery_budget_s=20.0)
            ctl = _controller(P, router, pool=pool, cfg=cfg)
            mgr, worker, dlq = _stack(P, router, checker,
                                      f"killrec-{P.name}")
            try:
                ctl.run_once()
                assert len(router.lb.endpoints()) == 2
                doomed = router.lb.get_endpoint_by_id(
                    "kill-1").metadata["engine"]
                sh = doomed.submit(
                    P.GenRequest(id="stream0",
                                 prompt="stream through the kill " * 4,
                                 max_new_tokens=32),
                    on_token=checker.on_token("stream0"))
                checker.submitted("stream0")
                worker.start()
                for i in range(14):
                    m = P.Message(id=f"k{i}", content=f"kill payload {i} " * 3,
                                  user_id="u", timeout=25.0)
                    checker.submitted(m.id)
                    mgr.push_message(m)
                # JAX's case allows 20 s; a loaded host running both
                # packages gets more (the loop ends at the first success).
                deadline = time.time() + 60.0
                replaced = False
                while time.time() < deadline:
                    ctl.run_once()
                    replaced = replaced or bool(
                        ctl.action_counts.get("replace:replica_dead"))
                    s = checker.summary()
                    if (replaced and sum(s["terminal"].values()) >= 14
                            and ctl.last_recovery_s is not None):
                        break
                    time.sleep(0.05)
                assert sh.wait(5.0)
                streamed = len(checker._streams.get("stream0", []))
                checker.failed("stream0")
                checker.completed("stream0", tokens=sh.result.tokens)
                checker._terminal["stream0"].remove("completed")
                s = checker.summary()
            finally:
                worker.stop()
                mgr.stop()
                ctl.stop()
            checker.check()
            eps = router.lb.endpoints()
            inj = P.chaos.get_injector()
            return dict(
                finish=sh.result.finish_reason, mid_stream=streamed >= 2,
                landed=(s["terminal"].get("completed", 0)
                        + s["terminal"].get("dead_lettered", 0)),
                failed=s["terminal"].get("failed", 0), dlq=dlq.size(),
                crashes=inj.get_stats()["injected"].get("engine.step:crash"),
                replaced=ctl.action_counts.get("replace:replica_dead", 0) >= 1,
                in_budget=(ctl.last_recovery_s is not None
                           and ctl.last_recovery_s <= cfg.recovery_budget_s),
                endpoints=len(eps),
                healthy=all(e.status in (P.lb.EndpointStatus.HEALTHY,
                                         P.lb.EndpointStatus.DEGRADED)
                            for e in eps),
                provisioned=pool.get_stats()["provisioned"])

        assert _same(run) == dict(
            finish="error", mid_stream=True, landed=14, failed=1, dlq=0,
            crashes=1, replaced=True, in_budget=True, endpoints=2,
            healthy=True, provisioned=3)

    @pytest.mark.chaos
    def test_flapping_replica_breaker_and_controller_dont_thrash(self):
        def run(P):
            P.chaos.configure(P.C.ChaosConfig(enabled=True, seed=21, faults=[
                {"point": "transport.request", "kind": "error",
                 "probability": 0.4}]))
            checker = P.Checker()
            engines, servers, urls = [], [], []
            for i in range(2):
                eng = _echo_engine(P, f"flapctl{i}")
                eng.start()
                api = P.ApiServer(P.config(), engine=eng)
                port = api.start(host="127.0.0.1", port=0)
                engines.append(eng)
                servers.append(api)
                urls.append(f"http://127.0.0.1:{port}")
            router = _router(P)
            for url in urls:
                router.register_remote(url, endpoint_id=url.split("//")[1])
            cfg = _cfg(P, min_replicas=2, max_replicas=4, cooldown=0.0,
                       max_actions_per_minute=2, backlog_per_replica=4)
            ctl = _controller(P, router, pool=_pool(P, "flapspill"), cfg=cfg)
            mgr, worker, dlq = _stack(P, router, checker, f"flapctl-{P.name}")
            ctl.queue_manager = mgr
            try:
                ctl.run_once()
                worker.start()
                for i in range(16):
                    m = P.Message(id=f"fl{i}", content=f"flap {i}",
                                  user_id="u", timeout=15.0)
                    checker.submitted(m.id)
                    mgr.push_message(m)
                deadline = time.time() + 90.0
                while time.time() < deadline:
                    ctl.run_once()
                    if sum(checker.summary()["terminal"].values()) >= 16:
                        break
                    time.sleep(0.05)
                s = checker.summary()
            finally:
                worker.stop()
                mgr.stop()
                for api in servers:
                    api.stop()
                for eng in engines:
                    eng.stop()
                ctl.stop()
            checker.check()
            inj = P.chaos.get_injector()
            return dict(
                landed=(s["terminal"].get("completed", 0)
                        + s["terminal"].get("dead_lettered", 0)),
                faults=inj.get_stats()["injected"].get(
                    "transport.request:error", 0) > 0,
                replaced=(ctl.action_counts.get("replace:replica_dead", 0)
                          + ctl.action_counts.get("replace:breaker_open", 0)),
                within_limit=(ctl.scale_action_total()
                              <= cfg.max_actions_per_minute))

        assert _same(run) == dict(landed=16, faults=True, replaced=0,
                                  within_limit=True)


# -- the REST surfaces ---------------------------------------------------------------


def _server(P):
    router = _router(P)
    eng = _echo_engine(P, "apisrv")
    router.register_engine(eng)
    ctl = _controller(P, router, pool=_pool(P, "api"), cfg=_cfg(P))
    srv = P.ApiServer(P.config(), engine=eng, cluster_router=router,
                      controller=ctl)
    return srv, ctl, eng


class TestApiSurfaces:
    def test_overview_gains_controller_block(self):
        def run(P):
            srv, ctl, eng = _server(P)
            try:
                ctl.run_once()
                status, payload, _ = srv.dispatch(
                    "GET", "/api/v1/cluster/overview", b"")
                blk = payload["controller"]
                return (status, sorted(blk), blk["enabled"], blk["paused"],
                        blk["target_replicas"], blk["rung"],
                        sorted(blk["inputs"]), sorted(blk["recovery"]),
                        sorted(blk["ladder"]), blk["pool"]["kind"])
            finally:
                ctl.stop()
                eng.stop()

        got = _same(run)
        assert got[0] == 200 and got[2:4] == (True, False) and got[4] >= 1

    def test_admin_pause_resume_and_health_visibility(self):
        def run(P):
            srv, ctl, eng = _server(P)
            out = []
            try:
                out.append(srv.dispatch("GET", "/health", b"")[1][
                    "controller"])
                s, p, _ = srv.dispatch("POST", "/api/v1/admin/controller",
                                       json.dumps({"action": "pause"}
                                                  ).encode())
                out.append((s, p, ctl.paused))
                out.append(srv.dispatch("GET", "/health", b"")[1][
                    "controller"])
                out.append(srv.dispatch("GET", "/api/v1/admin/controller",
                                        b"")[1]["paused"])
                s, p, _ = srv.dispatch("POST", "/api/v1/admin/controller",
                                       json.dumps({"action": "resume"}
                                                  ).encode())
                out.append((s, p))
                out.append(srv.dispatch("POST", "/api/v1/admin/controller",
                                        json.dumps({"action": "explode"}
                                                   ).encode())[0])
                return out
            finally:
                ctl.stop()
                eng.stop()

        assert _same(run) == [
            "running", (200, {"status": "paused"}, True), "paused", True,
            (200, {"status": "running"}), 400]

    def test_disabled_is_distinct_from_paused(self):
        def run(P):
            srv = P.ApiServer(P.config())
            s, _, _ = srv.dispatch("POST", "/api/v1/admin/controller",
                                   json.dumps({"action": "pause"}).encode())
            g, _, _ = srv.dispatch("GET", "/api/v1/admin/controller", b"")
            _, payload, _ = srv.dispatch("GET", "/health", b"")
            return s, g, "controller" in payload

        assert _same(run) == (503, 503, False)


# -- wiring ----------------------------------------------------------------------------


def _echo_app_cfg(P, *, controlplane=False):
    cfg = P.config()
    cfg.executor.backend = "echo"
    cfg.queue.enable_metrics = False
    cfg.loadbalancer.health_check_interval = 0.0
    if P is PORT:
        cfg.device = "cpu"
    if controlplane:
        cfg.controlplane.enabled = True
        cfg.controlplane.interval = 0.0
    return cfg


class TestWiring:
    def test_off_switch_builds_nothing(self):
        def run(P):
            cfg = P.config()
            return (cfg.controlplane.enabled,
                    P.cp.build_controller(cfg, router=object()),
                    vars(cfg.controlplane.pool),
                    cfg.controlplane.rungs)

        assert _same(run)[:2] == (False, None)

    def test_app_wires_controller_over_local_engine(self):
        def run(P):
            app = P.App(_echo_app_cfg(P, controlplane=True), with_api=True,
                        with_workers=True, with_engine=True)
            try:
                return (app.cluster_router is not None,
                        app.controller is not None,
                        app.api.controller is app.controller,
                        app.controller.ladder.shedder is app.api.shedder,
                        [e.id for e in app.load_balancer.endpoints()])
            finally:
                app.stop()

        got = _same(run)
        assert got[:4] == (True, True, True, True) and len(got[4]) == 1

    def test_controller_supersedes_legacy_autoscaler(self):
        def run(P):
            out = []
            for cp_on in (True, False):
                app = P.App(_echo_app_cfg(P, controlplane=cp_on),
                            with_api=True, with_workers=True,
                            with_engine=True, with_scheduler=True)
                try:
                    out.append((app.controller is None,
                                app.autoscaler is None))
                finally:
                    app.stop()
            return out

        assert _same(run) == [(False, True), (True, False)]

    def test_load_exports_config_path_for_subprocess_replicas(
            self, tmp_path, monkeypatch):
        def run(P):
            cfg_file = tmp_path / f"replica-{P.name}.yaml"
            cfg_file.write_text("server: {port: 9321}\n")
            monkeypatch.delenv("LLMQ_CONFIG", raising=False)
            args = argparse.Namespace(
                config=str(cfg_file), host=None, port=None, backend=None,
                log_format=None, peers=None, model=None, device=None)
            cfg = P.load(args)
            return (cfg.server.port,
                    os.environ["LLMQ_CONFIG"] == str(cfg_file.resolve()))

        assert _same(run) == (9321, True)

    def test_app_default_config_has_no_controller(self):
        def run(P):
            app = P.App(_echo_app_cfg(P), with_api=True, with_workers=True,
                        with_engine=True)
            try:
                return (app.controller, app.api.controller,
                        getattr(app, "disagg", None))
            finally:
                app.stop()

        assert _same(run) == (None, None, None)


# -- pools -----------------------------------------------------------------------------


class TestPools:
    def test_local_pool_lifecycle(self):
        def run(P):
            pool = _pool(P, "lifec")
            ep = pool.provision(1)
            eng = ep.metadata["engine"]
            up = (ep.id, ep.url, ep.metadata["pool"], eng.running)
            pool.decommission(ep)
            return up, eng.running, pool.get_stats()

        assert _same(run) == (("lifec-1", "local://lifec-1", True, True),
                              False, {"kind": "local", "live": 0,
                                      "provisioned": 1, "decommissioned": 1})

    def test_local_pool_decommission_recovers_crashed_engine(self):
        def run(P):
            P.chaos.configure(P.C.ChaosConfig(enabled=True, seed=3, faults=[
                {"point": "engine.step", "kind": "crash", "times": 1,
                 "match": {"engine": "dead-1"}}]))
            pool = _pool(P, "dead", max_restarts=0)
            ep = pool.provision(1)
            eng = ep.metadata["engine"]
            h = eng.submit(P.GenRequest(id="d0", prompt="doomed",
                                        max_new_tokens=16))
            deadline = time.time() + 5.0
            while eng.running and time.time() < deadline:
                time.sleep(0.02)
            crashed = not eng.running
            pool.decommission(ep)
            return crashed, h.wait(2.0), h.result.finish_reason

        assert _same(run) == (True, True, "error")

    def test_exec_pool_contract(self, tmp_path):
        class _Health(BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

            def log_message(self, fmt, *args):
                pass

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Health)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

        def run(P):
            marker = tmp_path / f"decommissioned-{P.name}"
            rollback = tmp_path / f"rollback-{P.name}"
            cfg = P.C.ReplicaPoolConfig(
                kind="exec",
                provision_cmd=(f"echo ignored; "
                               f"echo http://127.0.0.1:{port}"),
                decommission_cmd=f"echo $LLMQ_REPLICA_ID >> {marker}",
                ready_timeout=5.0)
            pool = P.pool.ExecReplicaPool(cfg)
            ep = pool.provision(7)
            out = [(ep.url, ep.id, ep.metadata["pool"])]
            pool.decommission(ep)
            out.append(marker.read_text().strip())
            ep2 = P.pool.ExecReplicaPool(P.C.ReplicaPoolConfig(
                kind="exec", provision_cmd="echo whatever",
                url_template=f"http://127.0.0.1:{port}",
                ready_timeout=5.0)).provision(3)
            out.append(ep2.url)
            out.append(P.pool.ExecReplicaPool(P.C.ReplicaPoolConfig(
                kind="exec", provision_cmd="exit 3")).provision(1))
            out.append(P.pool.ExecReplicaPool(P.C.ReplicaPoolConfig(
                kind="exec", provision_cmd="echo http://127.0.0.1:9",
                decommission_cmd=f"echo $LLMQ_REPLICA_SEQ >> {rollback}",
                ready_timeout=0.3)).provision(5))
            out.append(rollback.read_text().strip())
            out.append(pool.get_stats())
            return out

        try:
            got = _same(run)
        finally:
            httpd.shutdown()
        assert got[0] == (f"http://127.0.0.1:{port}", f"127.0.0.1:{port}",
                          True)
        assert got[1] == f"127.0.0.1:{port}" and got[3:6] == [None, None, "5"]

    def test_subprocess_pool_serves_real_replica(self, tmp_path, monkeypatch):
        """One real ``python -m llmq_tpu_torch --backend echo`` child: the
        pool provisions it ready, the port's router dispatches to it over
        HTTP, and decommission SIGTERMs it down (JAX's case, the port's
        process)."""
        _child_env(monkeypatch, tmp_path)
        base = _free_port()
        pool = tpool.SubprocessReplicaPool(TC.ReplicaPoolConfig(
            kind="subprocess", base_port=base,
            args=["--backend", "echo", "--device", "cpu"],
            ready_timeout=60.0), log_dir=str(tmp_path))
        router = _router(PORT)
        t0 = time.time()
        ep = pool.provision(0)
        try:
            assert ep is not None, (tmp_path / f"replica-{base}.log"
                                    ).read_text()[-2000:]
            assert (ep.id, ep.metadata["pool"]) == (f"127.0.0.1:{base}",
                                                    True)
            router.lb.add_endpoint(ep)
            msg = PORT.Message(id="sub0", content="subprocess replica",
                               user_id="u", timeout=30.0)
            router.process_fn(None, msg)
            assert msg.response == "subprocess replica"
            pid = pool.pids()[ep.id]
        finally:
            pool.stop()
        assert pool.get_stats()["live"] == 0
        assert not _alive(pid)
        assert time.time() - t0 < CHILD_CASE_LIMIT_S


#: Wall limit of each real-child case (its own; ~10-25 s here).
CHILD_CASE_LIMIT_S = 180.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _child_env(monkeypatch, tmp_path):
    """A child replica runs from ``tmp_path`` (no config file there to
    find) with the repository importable."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LLMQ_CONFIG", raising=False)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))


def test_controller_scales_replaces_and_retires_a_real_child(tmp_path,
                                                              monkeypatch):
    """The port's controller over an echo engine and the subprocess
    pool: a backlog provisions a real child (``scale_up``, reason
    ``backlog``) that receives dispatches; SIGKILL of the child is
    detected and the controller replaces it (``replace``,
    ``replica_dead``) with every message landing once; with the traffic
    gone the replacement is drained and decommissioned, its process gone,
    and the local engine never leaves. The disaggregation role reaches
    the child through ``LLMQ_DISAGG_ROLE``."""
    _child_env(monkeypatch, tmp_path)
    # The parent's configuration reaches the child through the
    # environment: here, the disaggregation plane on.
    monkeypatch.setenv("LLMQ_DISAGG_ENABLED", "true")
    t0 = time.time()
    base = _free_port()
    P = PORT
    checker = P.Checker()
    local = _echo_engine(P, "local0")
    local.start()
    # Breakers off: the load balancer's health probes find the death
    # (with them on, the dispatch failures can trip the child's breaker
    # first and the reason reads "breaker_open").
    router = _router(P, failover_retries=3,
                     breaker=TC.BreakerConfig(enabled=False))
    router.register_engine(local)
    pool = tpool.SubprocessReplicaPool(TC.ReplicaPoolConfig(
        kind="subprocess", base_port=base,
        args=["--backend", "echo", "--device", "cpu"], ready_timeout=60.0),
        log_dir=str(tmp_path))
    manager = FakeManager(0)
    clock = P.FakeClock()
    ctl = _controller(P, router, pool=pool, manager=manager, clock=clock,
                      cfg=_cfg(P, min_replicas=1, max_replicas=2,
                               backlog_per_replica=2, cooldown=5.0))
    ctl.disagg = TC.DisaggConfig(enabled=True)
    try:
        ctl.run_once()
        manager.pending = 10
        out = ctl.run_once()
        assert ("scale_up", "backlog") in out["actions"], out
        child = next(e for e in router.lb.endpoints()
                     if e.metadata.get("pool"))
        assert child.metadata["disagg_role"] == "decode"
        pid = pool.pids()[child.id]
        health = json.loads(_urlopen(child.url + "/health"))
        assert health["role"] == "decode" and health["engine"] == "running"
        mids = []
        for i in range(6):
            m = P.Message(id=f"rc{i}", content=f"payload {i}", user_id="u",
                          timeout=30.0)
            checker.submitted(m.id)
            router.process_fn(None, m)
            checker.completed(m.id)
            mids.append(m.metadata["endpoint_id"])
        assert child.id in mids and local.name in mids
        os.kill(pid, signal.SIGKILL)
        for i in range(4):
            m = P.Message(id=f"rk{i}", content=f"after kill {i}",
                          user_id="u", timeout=30.0)
            checker.submitted(m.id)
            router.process_fn(None, m)
            checker.completed(m.id)
        replaced = False
        deadline = time.time() + 90.0
        while time.time() < deadline and not replaced:
            clock.advance(1.0)
            replaced = ("replace", "replica_dead") in ctl.run_once()[
                "actions"]
        assert replaced, ctl.snapshot()
        checker.check()
        assert not _alive(pid)
        new = [e for e in router.lb.endpoints() if e.metadata.get("pool")]
        assert len(new) == 1 and new[0].id != child.id
        new_pid = pool.pids()[new[0].id]
        manager.pending = 0
        clock.advance(6.0)
        assert ("scale_down", "idle") in ctl.run_once()["actions"]
        ctl.run_once()
        assert [e.id for e in router.lb.endpoints()] == [local.name]
        assert not _alive(new_pid)
        assert pool.get_stats()["live"] == 0
        assert time.time() - t0 < CHILD_CASE_LIMIT_S
    finally:
        ctl.stop()
        local.stop()


def _urlopen(url: str) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read().decode()


# -- the autoscaler's clock --------------------------------------------------------------


class TestAutoscalerClock:
    def test_adaptive_strategy_follows_injected_clock(self):
        biz = calendar.timegm((2026, 7, 29, 11, 0, 0))
        off = calendar.timegm((2026, 7, 29, 23, 0, 0))
        shift = calendar.timegm(time.localtime(biz)) - int(biz)

        def run(P):
            clock = P.FakeClock(start=float(biz - shift))
            mgr = P.QM(f"asclk-{P.name}", enable_metrics=False)
            lb = P.lb.LoadBalancer(P.C.LoadBalancerConfig(
                health_check_interval=0.0))

            def provision(seq):
                return P.lb.Endpoint(id=f"as{seq}", url=f"local://as{seq}")

            a = P.Autoscaler(mgr, lb, P.C.SchedulerConfig(
                strategy="adaptive", min_endpoints=1, max_endpoints=4,
                cooldown=0.0), provision_fn=provision,
                decommission_fn=lambda ep: None, clock=clock)
            lb.add_endpoint(P.lb.Endpoint(id="seed", url="local://seed"))
            try:
                up = a.run_once()["action"], len(lb.endpoints())
                clock.advance(float(off - biz))
                down = a.run_once()["action"], len(lb.endpoints())
                return up, down
            finally:
                mgr.stop()

        assert _same(run) == (("up", 3), ("down", 1))
