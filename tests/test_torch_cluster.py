"""The port's replica-set plane against the JAX package's, on the CPU:
each scenario runs through both packages (their echo engines behind
their own REST servers, their ``ClusterRouter`` and ``build_cluster_router``,
their ``App``), and the outcomes must be equal (tolerance: none, unless
a case says otherwise).

Mirrors ``tests/test_router.py`` and ``tests/test_cluster.py``: routing
across engines, conversation affinity and its placement record surviving
a router restart, drain with spill and undrain, failover within one
dispatch, every replica down, a draining peer failing its probe, the
endpoint drain route through the live router, the cluster routes (503
without a router), a gateway ``App`` whose workers drain through the
router, the drain-during-failover race, the breakers taking an endpoint
out of rotation and back. Added: the seven metric families against the
router's counters, the overview with a dead replica, and two
``python -m llmq_tpu_torch serve`` processes behind a ``gateway
--peers`` with one SIGKILLed (the config-only bring-up). The last case
holds a two-turn conversation routed over two port replicas of the f32
tiny model to JAX's ``ClusterRouter`` over two JAX replicas on the same
weights, token for token."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from llmq_tpu.__main__ import App as JApp
from llmq_tpu.api.server import ApiServer as JApiServer
from llmq_tpu.cluster import ClusterRouter as JClusterRouter
from llmq_tpu.cluster import build_cluster_router as jbuild
from llmq_tpu.conversation.state_manager import StateManager as JSM
from llmq_tpu.core import config as JC
from llmq_tpu.core import types as jtypes
from llmq_tpu.engine.engine import InferenceEngine as JEngine
from llmq_tpu.engine.executor import EchoExecutor as JEcho
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok
from llmq_tpu.loadbalancer import load_balancer as jlb
from llmq_tpu.loadbalancer import transport as jtransport
from llmq_tpu.metrics import registry as jreg
from llmq_tpu.queueing import dead_letter_queue as jdlq
from llmq_tpu.queueing import queue_manager as jqm
from llmq_tpu.queueing import worker as jworker

from llmq_tpu_torch.__main__ import App as TApp
from llmq_tpu_torch.api.server import ApiServer as TApiServer
from llmq_tpu_torch.cluster import ClusterRouter as TClusterRouter
from llmq_tpu_torch.cluster import build_cluster_router as tbuild
from llmq_tpu_torch.conversation.state_manager import StateManager as TSM
from llmq_tpu_torch.core import config as TC
from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmq_tpu_torch.engine.executor import EchoExecutor as TEcho
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from llmq_tpu_torch.loadbalancer import load_balancer as tlb
from llmq_tpu_torch.loadbalancer import transport as ttransport
from llmq_tpu_torch.metrics import registry as treg
from llmq_tpu_torch.queueing import dead_letter_queue as tdlq
from llmq_tpu_torch.queueing import queue_manager as tqm
from llmq_tpu_torch.queueing import worker as tworker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(
    name="jax", C=JC, config=JC.default_config, Engine=JEngine, Echo=JEcho,
    Tok=JTok, ApiServer=JApiServer, Message=jtypes.Message,
    MessageStatus=jtypes.MessageStatus, lb=jlb,
    transport=jtransport, ClusterRouter=JClusterRouter, build=jbuild,
    SM=JSM, App=JApp, QueueManager=jqm.QueueManager,
    DLQ=jdlq.DeadLetterQueue, Worker=jworker.Worker,
    exposition=lambda: jreg.exposition().decode())
PORT = types.SimpleNamespace(
    name="port", C=TC, config=TC.Config, Engine=TEngine, Echo=TEcho,
    Tok=TTok, ApiServer=TApiServer, Message=ttypes.Message,
    MessageStatus=ttypes.MessageStatus, lb=tlb,
    transport=ttransport, ClusterRouter=TClusterRouter, build=tbuild,
    SM=TSM, App=TApp, QueueManager=tqm.QueueManager,
    DLQ=tdlq.DeadLetterQueue, Worker=tworker.Worker,
    exposition=lambda: treg.exposition().decode())
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _planes_cleared():
    """Each case's timelines and usage records (both packages' flight
    recorders and usage ledgers are process-wide, and the transport
    merges into them) are cleared after it: a later file in the same
    worker finds them as it would without this one."""
    yield
    from llmq_tpu import observability as jobs
    from llmq_tpu_torch import observability as tobs
    for mod in (jobs, tobs):
        mod.get_recorder().clear()
        mod.get_usage_ledger().clear()


def _engine(P, name):
    eng = P.Engine(P.Echo(batch_size=4), P.Tok(), name=name,
                   enable_metrics=False)
    eng.start()
    return eng


class _Pair:
    """n echo replicas of one package, each behind its own REST server."""

    def __init__(self, P, n=2):
        self.engines, self.servers, self.urls = [], [], []
        for i in range(n):
            eng = _engine(P, f"replica{i}")
            api = P.ApiServer(P.config(), engine=eng)
            port = api.start(host="127.0.0.1", port=0)
            self.engines.append(eng)
            self.servers.append(api)
            self.urls.append(f"http://127.0.0.1:{port}")

    def close(self):
        for s in self.servers:
            s.stop()
        for e in self.engines:
            if e.running:
                e.stop()

    def index(self, url):
        return self.urls.index(url)


def _both(scenario, n=2):
    """The scenario over each package's replicas. Endpoint ids carry the
    replicas' ports, so a trace names replicas by index (``ix``)."""
    out = {}
    for P in PKGS:
        pair = _Pair(P, n)
        try:
            out[P.name] = scenario(P, pair)
        finally:
            pair.close()
    assert out["port"] == out["jax"]
    return out["port"]


def _router(P, urls, *, state_manager=None, metrics=False, **ccfg):
    lb = P.lb.LoadBalancer(P.C.LoadBalancerConfig(
        strategy="round_robin", health_check_interval=0.0))
    cfg = P.config()
    cfg.cluster = P.C.ClusterConfig(peers=list(urls), **ccfg)
    cfg.queue.enable_metrics = metrics
    return P.build(cfg, lb, state_manager=state_manager)


def _ix(router, pair, eid):
    """The replica index behind endpoint ``eid``."""
    return pair.index(router.lb.get_endpoint_by_id(eid).url)


def _msg(P, mid, content, conv=""):
    return P.Message(id=mid, content=content, user_id="u",
                     conversation_id=conv, timeout=30.0)


class TestClusterRouter:
    def test_build_from_config_registers_peers(self):
        def run(P, pair):
            router = _router(P, pair.urls + [pair.urls[0] + "/"])
            eps = router.lb.endpoints()
            none = P.build(P.config(), P.lb.LoadBalancer())
            return ([pair.index(e.url) for e in eps],
                    [e.id == e.url.split("://")[1] for e in eps],
                    router.get_stats()["local_endpoint_id"], none)

        assert _both(run) == ([0, 1], [True, True], None, None)

    def test_messages_route_across_engines(self):
        def run(P, pair):
            router = _router(P, pair.urls)
            out = []
            for i in range(6):
                m = _msg(P, f"m{i}", f"hello {i}")
                router.process_fn(None, m)
                out.append((m.response, _ix(router, pair,
                                            m.metadata["endpoint_id"])))
            s = router.get_stats()
            return out, s["dispatches"], s["affinity_eligible"]

        out, n, eligible = _both(run)
        assert {ix for _, ix in out} == {0, 1} and (n, eligible) == (6, 0)

    def test_affinity_turn2_returns_to_prefix_replica(self):
        def run(P, pair):
            sm = P.SM(P.C.ConversationConfig(cleanup_interval=0))
            sm.get_or_create("conv-a", "u")
            router = _router(P, pair.urls, state_manager=sm)
            m1 = _msg(P, "t1", "first turn", "conv-a")
            router.process_fn(None, m1)
            m2 = _msg(P, "t2", "second turn", "conv-a")
            router.process_fn(None, m2)
            first = m1.metadata["endpoint_id"]
            s = router.get_stats()
            pl = sm.placement("conv-a")
            holder = pair.engines[_ix(router, pair, first)]
            return (m2.metadata["endpoint_id"] == first,
                    s["affinity_hits"], s["affinity_eligible"],
                    s["affinity_hit_rate"], pl["endpoint_id"] == first,
                    sorted(pl), "conv-a" in holder.cached_conversations())

        assert _both(run) == (True, 1, 1, 1.0, True,
                              ["cached_tokens", "endpoint_id",
                               "recorded_at"], True)

    def test_placement_handle_survives_router_restart(self):
        def run(P, pair):
            sm = P.SM(P.C.ConversationConfig(cleanup_interval=0))
            sm.get_or_create("conv-b", "u")
            router = _router(P, pair.urls, state_manager=sm)
            m1 = _msg(P, "p1", "turn", "conv-b")
            router.process_fn(None, m1)
            router2 = _router(P, pair.urls, state_manager=sm)
            m2 = _msg(P, "p2", "turn 2", "conv-b")
            router2.process_fn(None, m2)
            return (m2.metadata["endpoint_id"] == m1.metadata["endpoint_id"],
                    router2.get_stats()["affinity_hits"])

        assert _both(run) == (True, 1)

    def test_drain_spills_affine_conversation(self):
        def run(P, pair):
            router = _router(P, pair.urls)
            m1 = _msg(P, "d1", "x", "conv-c")
            router.process_fn(None, m1)
            home = m1.metadata["endpoint_id"]
            drained = router.drain_endpoint(home, wait=2.0)
            st = router.lb.get_endpoint_by_id(home).status.value
            m2 = _msg(P, "d2", "y", "conv-c")
            router.process_fn(None, m2)
            out = (drained, st, m2.metadata["endpoint_id"] != home,
                   m2.status != P.MessageStatus.FAILED,
                   router.get_stats()["spills"], router.undrain_endpoint(home),
                   router.lb.get_endpoint_by_id(home).status.value,
                   router.undrain_endpoint("nope"),
                   router.drain_endpoint("nope"))
            return out

        assert _both(run) == (True, "draining", True, True, 1, True,
                              "degraded", False, False)

    def test_failover_retries_on_other_replica(self):
        def run(P, pair):
            router = _router(P, pair.urls, failover_retries=2)
            m1 = _msg(P, "f0", "probe", "conv-f")
            router.process_fn(None, m1)
            home = m1.metadata["endpoint_id"]
            pair.engines[_ix(router, pair, home)].stop()
            m2 = _msg(P, "f1", "after failover", "conv-f")
            router.process_fn(None, m2)
            s = router.get_stats()
            ep = router.lb.get_endpoint_by_id(home)
            return (m2.response, m2.metadata["endpoint_id"] != home,
                    s["failovers"], ep.total_errors, ep.connections,
                    s["breakers"][home]["consecutive_failures"])

        assert _both(run) == ("after failover", True, 1, 1, 0, 1)

    def test_all_replicas_down_raises_for_worker_retry_path(self):
        def run(P, pair):
            router = _router(P, pair.urls, failover_retries=3)
            for e in pair.engines:
                e.stop()
            with pytest.raises(RuntimeError) as e:
                router.process_fn(None, _msg(P, "x0", "doomed"))
            s = router.get_stats()
            return "failed" in str(e.value), s["failovers"], s["dispatches"]

        assert _both(run) == (True, 2, 0)

    def test_session_and_none_affinity(self):
        def run(P, pair):
            out = []
            for aff in ("session", "none"):
                router = _router(P, pair.urls, affinity=aff)
                picks = []
                for i in range(4):
                    m = _msg(P, f"{aff}{i}", "x", "conv-s")
                    router.process_fn(None, m)
                    picks.append(_ix(router, pair, m.metadata["endpoint_id"]))
                out.append((picks, router.get_stats()["affinity_eligible"],
                            router.lb.get_stats()["active_sessions"]))
            return out

        (sess, _, n_sess), (none, _, n_none) = _both(run)
        assert len(set(sess)) == 1 and n_sess == 1
        assert set(none) == {0, 1} and n_none == 0


class TestHintArrival:
    def test_hint_goes_through_the_tiering_planes_prepare(self):
        """``InferenceEngine.hint_arrival`` calls the tiering plane's
        ``prepare`` for a conversation, as JAX's does; without a plane or
        without a conversation id it does nothing."""
        def run(P):
            eng = P.Engine(P.Echo(batch_size=2), P.Tok(), name="h",
                           enable_metrics=False)
            calls = []
            eng._tiering = types.SimpleNamespace(prepare=calls.append)
            eng.hint_arrival("conv-1")
            eng.hint_arrival("")
            eng._tiering = None
            eng.hint_arrival("conv-2")
            return calls

        assert _each(run) == ["conv-1"]


class TestDrainingHealth:
    def test_draining_health_fails_peer_probe(self):
        def run(P, pair):
            client = P.transport.HttpEngineClient(pair.urls[0])
            before = client.healthy()
            pair.servers[0].draining = True
            with urllib.request.urlopen(f"{pair.urls[0]}/health",
                                        timeout=5) as r:
                status = json.loads(r.read())["status"]
            return before, client.healthy(), status

        assert _both(run) == (True, False, "draining")

    def test_endpoint_drain_route(self):
        def run(P, pair):
            router = _router(P, pair.urls, metrics=False)
            api = P.ApiServer(P.config(), load_balancer=router.lb,
                              cluster_router=router)
            eid = router.lb.endpoints()[0].id
            out = []
            for body in (b"", json.dumps({"drain": False}).encode()):
                status, payload, _ = api.dispatch(
                    "POST", f"/api/v1/endpoints/{eid}/drain", body)
                out.append((status, payload["status"],
                            router.lb.get_endpoint_by_id(eid).status.value))
            status, payload, _ = api.dispatch(
                "POST", "/api/v1/endpoints/nope/drain", b"")
            out.append(status)
            status, payload, _ = api.dispatch("GET", "/api/v1/cluster/stats",
                                              b"")
            out.append((status, sorted(payload)))
            bare = P.ApiServer(P.config())
            for route in ("stats", "overview"):
                status, payload, _ = bare.dispatch(
                    "GET", f"/api/v1/cluster/{route}", b"")
                out.append((status, payload["error"]))
            return out

        out = _both(run)
        assert out[:3] == [(200, "draining", "draining"),
                           (200, "degraded", "degraded"), 404]
        assert "affinity_hit_rate" in out[3][1]
        assert out[4] == (503, "cluster router not configured "
                               "(set cluster.peers / --peers)")


def _counter_samples(P, family):
    """{labels tuple: value} of one family in the package's exposition."""
    out = {}
    for fam in text_string_to_metric_families(P.exposition()):
        if fam.name == family:
            for s in fam.samples:
                if s.name.endswith("_created"):
                    continue
                out[tuple(sorted(s.labels.items()))] = s.value
    return out


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0)}


class TestMetrics:
    def test_cluster_and_breaker_families_equal_the_routers_counts(self):
        """The five ``cluster_*`` families and the two breaker families
        move by what ``get_stats()`` counts, by the same amounts in both
        packages (the registries are process-wide: deltas, by replica
        index)."""
        fams = ("llm_queue_cluster_dispatch", "llm_queue_cluster_failovers",
                "llm_queue_cluster_drains",
                "llm_queue_circuit_breaker_trips")

        def run(P, pair):
            before = {f: _counter_samples(P, f) for f in fams}
            sm = P.SM(P.C.ConversationConfig(cleanup_interval=0))
            sm.get_or_create("conv-m", "u")
            router = _router(P, pair.urls, state_manager=sm, metrics=True,
                             breaker=P.C.BreakerConfig(
                                 failure_threshold=1, base_backoff=30.0,
                                 jitter=0.0))
            for i, conv in enumerate(("conv-m", "conv-m", "", "")):
                router.process_fn(None, _msg(P, f"q{i}", "x", conv))
            pair.engines[1].stop()
            for i in range(3):
                router.process_fn(None, _msg(P, f"r{i}", "y"))
            eid0 = router.lb.endpoints()[0].id
            router.drain_endpoint(eid0)
            router.undrain_endpoint(eid0)
            s = router.get_stats()
            ids = {e.id: pair.index(e.url) for e in router.lb.endpoints()}

            def by_ix(d):
                return sorted((tuple((k, ids.get(v, v)) for k, v in lab), n)
                              for lab, n in d.items())

            deltas = {f: by_ix(_delta(_counter_samples(P, f), before[f]))
                      for f in fams}
            gauges = {}
            for f in ("llm_queue_cluster_affinity_hit_rate",
                      "llm_queue_cluster_endpoints",
                      "llm_queue_circuit_breaker_state"):
                # Samples without an endpoint label, or of this router's.
                gauges[f] = by_ix({k: v for k, v in
                                   _counter_samples(P, f).items()
                                   if dict(k).get("endpoint", "") in
                                   ("", *ids)})
            counted = (s["dispatches"], s["failovers"], s["affinity_hits"],
                       s["affinity_eligible"], s["spills"],
                       {ids[k]: v["state"] for k, v in s["breakers"].items()})
            return deltas, gauges, counted

        deltas, gauges, counted = _both(run)
        dispatches, failovers, hits, eligible, spills, breakers = counted
        assert sum(n for _, n in deltas["llm_queue_cluster_dispatch"]) == \
            dispatches == 7
        assert sum(n for _, n in deltas["llm_queue_cluster_failovers"]) == \
            failovers == 1
        assert deltas["llm_queue_cluster_drains"] == [
            ((("endpoint", 0),), 1.0)]
        assert deltas["llm_queue_circuit_breaker_trips"] == [
            ((("endpoint", 1),), 1.0)]
        assert breakers == {0: "closed", 1: "open"}
        assert gauges["llm_queue_cluster_affinity_hit_rate"] == [
            ((), hits / eligible)]
        assert dict(gauges["llm_queue_circuit_breaker_state"])[
            (("endpoint", 1),)] == 2.0


class TestOverview:
    def test_overview_lists_replicas_and_degrades_per_replica(self):
        """Tolerance: none on the structure; the dead replica's entry is
        an ``error`` one and the rollup answers within its probe
        timeout (2 s) plus 1 s. A replica's ``boot`` block is its
        process's boot record, present once any serve boot has opened
        one in the process (an earlier test may have): left out of the
        comparison."""
        def keys(entry):
            return sorted(k for k in entry if k != "boot")

        def run(P, pair):
            router = _router(P, pair.urls)
            up = router.overview()
            pair.servers[1].stop()
            t0 = time.monotonic()
            down = router.overview()
            took = time.monotonic() - t0
            return ([keys(r) for r in up["replicas"]],
                    up["aggregate"]["endpoints"], up["aggregate"]["reporting"],
                    sorted(up["aggregate"]),
                    [keys(r) for r in down["replicas"]],
                    "error" in down["replicas"][1], took < 3.0)

        out = _both(run)
        assert out[1:3] == (2, 2) and out[5] and out[6]


class TestAppWiring:
    def test_gateway_app_routes_through_cluster(self):
        """A gateway ``App`` with peers grows workers (no engine) that
        drain its queues through the router; its drain flips /health."""
        def run(P, pair):
            cfg = P.config()
            cfg.server.host = "127.0.0.1"
            cfg.server.port = 0
            cfg.queue.enable_metrics = False
            cfg.queue.worker.process_interval = 0.005
            cfg.loadbalancer.health_check_interval = 0.0
            cfg.cluster.peers = list(pair.urls)
            app = P.App(cfg, with_api=True, with_workers=False,
                        with_engine=False)
            shape = (app.cluster_router is not None, bool(app.workers),
                     app.engine is None, app.autoscaler is None)
            app.start()
            try:
                port = app.api._httpd.server_address[1]  # noqa: SLF001
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/api/v1/messages",
                    data=json.dumps({"content": "via cluster",
                                     "user_id": "t"}).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=10) as r:
                    mid = json.loads(r.read())["message_id"]
                deadline = time.time() + 15
                m = {}
                while time.time() < deadline:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/api/v1/messages/{mid}",
                            timeout=5) as r:
                        m = json.loads(r.read())
                    if m["status"] == "completed":
                        break
                    time.sleep(0.02)
                drained = app.drain(timeout=5.0)
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    health = json.loads(r.read())["status"]
            finally:
                app.stop()
            return shape, m["status"], m["response"], drained, health

        assert _both(run) == ((True, True, True, True), "completed",
                              "via cluster", True, "draining")


class TestDisaggSteering:
    def test_build_sets_role_steering_and_its_stats(self):
        """``disagg.enabled`` makes the built router steer by role in both
        packages: local engines report their ``disagg_role``, a long first
        turn goes to the prefill engine and a short one to decode, and
        ``get_stats`` gains the ``disagg`` block; off, no block."""
        def run(P, pair):
            out = []
            for enabled in (False, True):
                cfg = P.config()
                cfg.queue.enable_metrics = False
                cfg.cluster.peers = []
                cfg.disagg.enabled = enabled
                cfg.disagg.long_prompt_tokens = 32
                lb = P.lb.LoadBalancer(P.C.LoadBalancerConfig(
                    strategy="round_robin", health_check_interval=0.0))
                router = P.ClusterRouter(lb, config=cfg.cluster,
                                         enable_metrics=False)
                if enabled:
                    router.disagg = cfg.disagg
                for eng, role in zip(pair.engines, ("prefill", "decode")):
                    eng.disagg_role = role
                    router.register_engine(eng, endpoint_id=eng.name)
                picks = []
                for mid, content in (("l", "x" * 200), ("s", "hi")):
                    m = _msg(P, f"{mid}{enabled}", content)
                    m.timeout = 30.0
                    router.process_fn(None, m)
                    picks.append(m.metadata["endpoint_id"])
                out.append((picks, router.get_stats().get("disagg")))
                for eng in pair.engines:
                    eng.disagg_role = "unified"
            return out

        off, on = _both(run)
        assert off[1] is None
        assert on == (["replica0", "replica1"],
                      {"role_routes": 2, "handoffs": 0,
                       "roles": {"replica0": "prefill",
                                 "replica1": "decode"}})

    def test_app_wires_prefill_eta_and_the_role(self):
        """An echo ``App`` with the control plane and the disaggregation
        plane on: the router built over the local engine steers by role
        with the resource scheduler's learned prefill ETA, the engine
        carries the configured role, and ``/health`` advertises it."""
        def run(P):
            cfg = P.config()
            cfg.executor.backend = "echo"
            cfg.queue.enable_metrics = False
            cfg.loadbalancer.health_check_interval = 0.0
            cfg.controlplane.enabled = True
            cfg.controlplane.interval = 0.0
            cfg.disagg.enabled = True
            cfg.disagg.role = "decode"
            cfg.executor.kv_tiering.enabled = True
            if P is PORT:
                cfg.device = "cpu"
            app = P.App(cfg, with_api=True, with_workers=True,
                        with_engine=True)
            try:
                r = app.cluster_router
                health = app.api.dispatch("GET", "/health", b"")[1]
                return (r.disagg is cfg.disagg,
                        r.prefill_eta == app.resource_scheduler.prefill_eta_ms,
                        app.disagg.role, app.engine.disagg_role,
                        app.disagg.exchange is not None,
                        app.engine._tiering.exchange is app.disagg.exchange,
                        health["role"], health["controller"],
                        app.controller.disagg is cfg.disagg)
            finally:
                app.stop()

        got = {P.name: run(P) for P in PKGS}
        assert got["port"] == got["jax"] == (
            True, True, "decode", "decode", True, True, "decode", "running",
            True)


class _FakeEngine:
    """An in-process engine double for the router's policies."""

    def __init__(self, name: str, fail: bool = False) -> None:
        self.name = name
        self.fail = fail
        self.calls = []
        self.on_call = None
        self.hints = []

    def healthy(self) -> bool:
        return True

    def hint_arrival(self, conversation_id: str) -> None:
        self.hints.append(conversation_id)

    def process_fn(self, ctx, msg) -> None:
        self.calls.append(msg.id)
        if self.on_call is not None:
            self.on_call()
        if self.fail:
            raise RuntimeError(f"{self.name} exploded")
        msg.response = f"ok-{self.name}"


def _policy_router(P, engines, **ccfg):
    lb = P.lb.LoadBalancer(P.C.LoadBalancerConfig(
        strategy="round_robin", health_check_interval=0.0))
    router = P.ClusterRouter(lb, config=P.C.ClusterConfig(**ccfg),
                             enable_metrics=False)
    for e in engines:
        router.register_engine(e)
    return router


def _each(scenario):
    out = {P.name: scenario(P) for P in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


class TestDrainDuringFailoverRace:
    def test_draining_failover_target_is_skipped(self):
        def run(P):
            a, b, c = (_FakeEngine("a", fail=True), _FakeEngine("b"),
                       _FakeEngine("c"))
            router = _policy_router(P, [a, b, c], failover_retries=2)
            a.on_call = lambda: router.lb.set_draining("b", True)
            msg = P.Message(id="race0", content="x", user_id="u",
                            conversation_id="conv-r", timeout=10.0)
            router.process_fn(None, msg)
            return (msg.metadata["endpoint_id"], msg.response, a.calls,
                    b.calls, c.calls, a.hints, c.hints,
                    router.get_stats()["local_endpoint_id"])

        assert _each(run) == ("c", "ok-c", ["race0"], [], ["race0"],
                              ["conv-r"], ["conv-r"], "a")

    def test_no_third_replica_lands_in_dlq_never_vanishes(self):
        def run(P):
            a, b = _FakeEngine("a", fail=True), _FakeEngine("b")
            router = _policy_router(P, [a, b], failover_retries=2)
            a.on_call = lambda: router.lb.set_draining("b", True)
            cfg = P.config()
            cfg.queue.enable_metrics = False
            mgr = P.QueueManager("drainrace", config=cfg,
                                 enable_metrics=False)
            dlq = P.DLQ(name="drainrace-dlq")
            worker = P.Worker("w", mgr, router.process_fn,
                              dead_letter_queue=dlq)
            msg = P.Message(id="race1", content="x", user_id="u",
                            timeout=10.0)
            msg.max_retries = 0
            mgr.push_message(msg)
            worker.process_batch()
            out = (b.calls, dlq.size(), dlq.get("race1").message.id)
            mgr.stop()
            return out

        assert _each(run) == ([], 1, "race1")


class TestRouterBreakers:
    def test_open_breaker_takes_endpoint_out_of_rotation(self):
        def run(P):
            a, b = _FakeEngine("a", fail=True), _FakeEngine("b")
            router = _policy_router(
                P, [a, b], failover_retries=2,
                breaker=P.C.BreakerConfig(failure_threshold=2,
                                          base_backoff=30.0, jitter=0.0))
            out = []
            for i in range(2):
                m = P.Message(id=f"t{i}", content="x", user_id="u",
                              timeout=10.0)
                router.process_fn(None, m)
                out.append(m.response)
            out.append(router.breakers.blocked("a"))
            before = len(a.calls)
            for i in range(4):
                m = P.Message(id=f"s{i}", content="x", user_id="u",
                              timeout=10.0)
                router.process_fn(None, m)
                out.append(m.metadata["endpoint_id"])
            out += [len(a.calls) - before,
                    router.get_stats()["breakers"]["a"]["state"]]
            return out

        assert _each(run) == ["ok-b", "ok-b", True, "b", "b", "b", "b", 0,
                              "open"]

    def test_half_open_probe_recovers_endpoint(self):
        def run(P):
            a, b = _FakeEngine("a", fail=True), _FakeEngine("b")
            router = _policy_router(
                P, [a, b], failover_retries=2,
                breaker=P.C.BreakerConfig(failure_threshold=1,
                                          base_backoff=0.05, jitter=0.0))
            router.process_fn(None, P.Message(id="p0", content="x",
                                              user_id="u", timeout=10.0))
            blocked = router.breakers.blocked("a")
            a.fail = False
            time.sleep(0.08)
            seen = set()
            for i in range(8):
                m = P.Message(id=f"h{i}", content="x", user_id="u",
                              timeout=10.0)
                router.process_fn(None, m)
                seen.add(m.metadata["endpoint_id"])
            return (blocked, sorted(seen),
                    router.get_stats()["breakers"]["a"]["state"])

        assert _each(run) == (True, ["a", "b"], "closed")


class TestRouterErrors:
    def test_engine_error_feeds_error_rate(self):
        """tests/test_router.py: an engine error is charged to the
        endpoint's error rate and raised to the worker (one attempt per
        message, as the ``EngineRouter`` there dispatches)."""
        def run(P):
            lb = P.lb.LoadBalancer(P.C.LoadBalancerConfig(
                strategy="round_robin", health_check_interval=0.0))
            router = P.ClusterRouter(
                lb, config=P.C.ClusterConfig(failover_retries=0),
                enable_metrics=False)
            router.register_engine(_FakeEngine("bad", fail=True))
            with pytest.raises(RuntimeError, match="exploded"):
                router.process_fn(None, P.Message(id="e0", content="x",
                                                  user_id="u"))
            ep = lb.get_endpoint_by_id("bad")
            lb.add_endpoint(P.lb.Endpoint(id="bare", url=""))
            lb.set_endpoint_status("bad", P.lb.EndpointStatus.UNHEALTHY)
            with pytest.raises(RuntimeError, match="no attached engine"):
                router.process_fn(None, P.Message(id="e1", content="x",
                                                  user_id="u"))
            return (ep.total_errors, round(ep.error_rate, 12),
                    ep.connections, lb.get_endpoint_by_id("bare").total_errors)

        assert _each(run) == (1, 0.1, 0, 1)


# -- the config-only bring-up over OS processes -------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_health(url: str, deadline_s: float = 60.0) -> None:
    deadline = time.time() + deadline_s
    last = None
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"{url}/health", timeout=2) as r:
                if r.status == 200:
                    return
        except OSError as e:
            last = e
        time.sleep(0.1)
    raise TimeoutError(f"{url} never became healthy: {last}")


def _post(url, path, body):
    req = urllib.request.Request(
        f"{url}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(f"{url}{path}", timeout=10) as r:
        return json.loads(r.read())


def _spawn(args, cwd, env):
    return subprocess.Popen(
        [sys.executable, "-m", "llmq_tpu_torch", "--host", "127.0.0.1"]
        + args, cwd=cwd, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


def test_config_only_bringup_failover_and_live_add(tmp_path):
    """Two ``serve`` replicas (echo on the CPU) and a ``gateway --peers``
    stood up from flags alone: traffic reaches both, a conversation's
    turn 2 returns to its replica with the replica's engine stages in
    the gateway's trace of turn 1 under the same trace id, one replica
    SIGKILLed loses no message, and an endpoint added at run time takes
    dispatches. The JAX package's test drives the same path."""
    env = dict(os.environ)
    # A config another test left named must not reach the children.
    env.pop("LLMQ_CONFIG", None)
    env.update({"LLMQ_QUEUE_ENABLE_METRICS": "false",
                "LLMQ_LOADBALANCER_STRATEGY": "round_robin",
                "LLMQ_LOADBALANCER_HEALTH_CHECK_INTERVAL": "0.5",
                "LLMQ_QUEUE_WORKER_PROCESS_INTERVAL": "0.01",
                "LLMQ_EXECUTOR_BACKEND": "echo",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    gw_port = _free_port()
    gw = f"http://127.0.0.1:{gw_port}"
    replicas = [_spawn(["--device", "cpu", "--port", str(p), "serve"],
                       str(tmp_path), env) for p in ports]
    procs = list(replicas)
    live = _Pair(PORT, 1)
    try:
        procs.append(_spawn(["--port", str(gw_port), "--peers",
                             f"{urls[0]},{urls[1]}", "gateway"],
                            str(tmp_path), env))
        for u in urls + [gw]:
            _wait_health(u)

        def drain_all(mids, deadline_s=30.0):
            deadline = time.time() + deadline_s
            left = set(mids)
            while left and time.time() < deadline:
                for mid in list(left):
                    m = _get(gw, f"/api/v1/messages/{mid}")
                    if m["status"] == "completed" and m["response"]:
                        left.discard(mid)
                if left:
                    time.sleep(0.05)
            return left

        mids = [_post(gw, "/api/v1/messages",
                      {"content": f"req {i}", "user_id": "t"})["message_id"]
                for i in range(8)]
        assert drain_all(mids) == set()
        eps = {e["id"]: e for e in _get(gw, "/api/v1/endpoints")["endpoints"]}
        assert set(eps) == {u.split("//")[1] for u in urls}
        assert all(e["total_requests"] > 0 for e in eps.values()), eps

        conv = _post(gw, "/api/v1/conversations",
                     {"user_id": "t"})["conversation_id"]
        t1 = _post(gw, f"/api/v1/conversations/{conv}/messages",
                   {"content": "turn one", "user_id": "t"})["message_id"]
        assert drain_all([t1]) == set()
        t2 = _post(gw, f"/api/v1/conversations/{conv}/messages",
                   {"content": "turn two", "user_id": "t"})["message_id"]
        assert drain_all([t2]) == set()
        m1, m2 = (_get(gw, f"/api/v1/messages/{t}") for t in (t1, t2))
        assert m1["metadata"]["endpoint_id"] == m2["metadata"]["endpoint_id"]
        assert _get(gw, "/api/v1/cluster/stats")["affinity_hit_rate"] > 0

        tl = _get(gw, f"/api/v1/requests/{t1}/trace")
        stages = {e["stage"] for e in tl["events"]}
        assert {"enqueued", "dispatched", "admitted", "first_token",
                "completed"} <= stages, stages
        assert len(tl["hosts"]) >= 2, tl["hosts"]
        gw_host = next(e["host"] for e in tl["events"]
                       if e["stage"] == "enqueued")
        eng_hosts = {e["host"] for e in tl["events"]
                     if e["stage"] in ("admitted", "first_token")}
        assert eng_hosts and gw_host not in eng_hosts, tl
        assert tl["trace_id"] == t1.replace("-", "")
        remote = [e for e in tl["events"] if e["stage"] == "dispatched"
                  and e["meta"].get("traceparent")]
        assert remote and remote[0]["meta"]["traceparent"].startswith(
            f"00-{tl['trace_id']}-")

        replicas[0].send_signal(signal.SIGKILL)
        replicas[0].wait(timeout=10)
        mids = [_post(gw, "/api/v1/messages",
                      {"content": f"post-kill {i}", "user_id": "t"}
                      )["message_id"] for i in range(8)]
        assert drain_all(mids) == set()
        dead = urls[0].split("//")[1]
        stats = _get(gw, "/api/v1/cluster/stats")
        assert stats["failovers"] >= 1 or \
            stats["breakers"].get(dead, {}).get("trips", 0) >= 1 or \
            _get(gw, "/api/v1/endpoints")["endpoints"][0]["status"] != \
            "healthy", stats
        ov = _get(gw, "/api/v1/cluster/overview")
        assert {r["id"]: "error" in r for r in ov["replicas"]}[dead]

        out = _post(gw, "/api/v1/endpoints", {"id": "r3", "url": live.urls[0]})
        assert out["endpoint_id"] == "r3"
        mids = [_post(gw, "/api/v1/messages",
                      {"content": f"live-add {i}", "user_id": "t"}
                      )["message_id"] for i in range(6)]
        assert drain_all(mids) == set()
        eps = {e["id"]: e for e in _get(gw, "/api/v1/endpoints")["endpoints"]}
        assert eps["r3"]["total_requests"] > 0, eps
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
        live.close()


# -- a two-turn conversation over two model replicas --------------------------


def test_two_turns_over_two_tiny_model_replicas_match_jax():
    """Tolerance: none. Two replicas of the f32 llama3-tiny (the same
    weights, ``params_from_jax``) behind each package's ``ClusterRouter``
    with a state manager: turn 1 goes by round robin, turn 2 returns to
    its replica by placement and reports the cached prefix, a third
    conversation lands on the other replica; the responses (the greedy
    token streams as bytes), usage and placements equal JAX's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from llmq_tpu.engine.executor import JaxExecutor
    from llmq_tpu.models import llama as J
    from llmq_tpu_torch.core.config import PrefixCacheConfig
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.models import llama as T

    kw = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
              vocab_size=512, max_seq_len=256)
    geom = dict(batch_size=2, page_size=8, num_pages=64,
                prefill_buckets=[16, 64], chunk_size=4)
    jcfg = J.llama3_tiny(dtype=jnp.float32, **kw)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.llama3_tiny(dtype=torch.float32, **kw)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")

    def engines(P):
        out = []
        for i in range(2):
            tok = P.Tok()
            if P is JAX:
                ex = JaxExecutor(jcfg, jparams, eos_id=tok.eos_id,
                                 cache_dtype=jnp.float32, **geom)
                pc = JC.PrefixCacheConfig(enabled=True)
            else:
                ex = TorchExecutor(tcfg, tparams, eos_id=tok.eos_id,
                                   device="cpu", cache_dtype=torch.float32,
                                   **geom)
                pc = PrefixCacheConfig(enabled=True)
            eng = P.Engine(ex, tok, name=f"m{i}", enable_metrics=False,
                           max_decode_steps=8, prefix_cache=pc)
            eng.start()
            out.append(eng)
        return out

    def run(P):
        engs = engines(P)
        try:
            sm = P.SM(P.C.ConversationConfig(cleanup_interval=0))
            lb = P.lb.LoadBalancer(P.C.LoadBalancerConfig(
                strategy="round_robin", health_check_interval=0.0))
            router = P.ClusterRouter(lb, config=P.C.ClusterConfig(),
                                     state_manager=sm, enable_metrics=False)
            for e in engs:
                router.register_engine(e)
            trace = []
            history = ""
            for i, (conv, text) in enumerate((
                    ("c1", "the quick brown fox jumps"),
                    ("c2", "over the lazy dog again"),
                    ("c1", " and then some"))):
                sm.get_or_create(conv, "u")
                prompt = (history + text) if conv == "c1" and i else text
                m = P.Message(id=f"turn{i}", content=prompt, user_id="u",
                              conversation_id=conv, timeout=60.0,
                              metadata={"max_new_tokens": 8})
                router.process_fn(None, m)
                if conv == "c1":
                    history = prompt + m.response
                usage = m.metadata["usage"]
                trace.append((m.metadata["endpoint_id"], m.response,
                              usage["prompt_tokens"],
                              usage["completion_tokens"],
                              usage.get("cached_tokens", 0),
                              sm.placement(conv)["endpoint_id"]))
            s = router.get_stats()
            return trace, s["affinity_hits"], s["affinity_eligible"]
        finally:
            for e in engs:
                e.stop()

    trace, hits, eligible = _each(run)
    assert [t[0] for t in trace] == ["m0", "m1", "m0"]
    assert (hits, eligible) == (1, 1)
    assert trace[2][4] > 0
