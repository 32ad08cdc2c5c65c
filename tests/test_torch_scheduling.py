"""The port's resource scheduler, topology and load balancer (the
endpoint registry, its health checks and draining) against the JAX
package's, side by side on fake clocks: each scenario runs over a
namespace of either package's classes and the two traces must be equal.
It mirrors tests/test_scheduling.py and tests/test_load_balancer.py for
what the port has (the endpoint autoscaler's four strategies included),
and adds the cache-aware admission seam: the prefill estimator, the
learned prefill rate and the overload shedder's deadline check. The
autoscaler's first
tick removes an endpoint at the JAX package's defaults: both packages'
``App`` in serve mode with one peer do it alike."""

import time
import types

import pytest
import torch

from llmq_tpu.api import overload as joverload
from llmq_tpu.api.server import ApiError as JApiError
from llmq_tpu.core import config as JC
from llmq_tpu.core import errors as jerrors
from llmq_tpu.core import types as jtypes
from llmq_tpu.core.clock import FakeClock
from llmq_tpu.loadbalancer import load_balancer as jlb
from llmq_tpu.queueing import queue_manager as jqm
from llmq_tpu.scheduling import autoscaler as jas
from llmq_tpu.scheduling import resource_scheduler as jrs
from llmq_tpu.scheduling.topology import TpuTopology

from llmq_tpu_torch.api import overload as toverload
from llmq_tpu_torch.api.server import ApiError as TApiError
from llmq_tpu_torch.core import config as TC
from llmq_tpu_torch.core import errors as terrors
from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.loadbalancer import load_balancer as tlb
from llmq_tpu_torch.queueing import queue_manager as tqm
from llmq_tpu_torch.scheduling import autoscaler as tas
from llmq_tpu_torch.scheduling import resource_scheduler as trs
from llmq_tpu_torch.scheduling.topology import GpuTopology


def _ns(pkg, clock):
    if pkg == "jax":
        return types.SimpleNamespace(
            name="jax", clock=clock, rs=jrs, lb=jlb, C=JC, qm=jqm, auto=jas,
            errors=jerrors, Message=jtypes.Message, Priority=jtypes.Priority,
            Shedder=joverload.OverloadShedder, ApiError=JApiError,
            declare=lambda n, hosts=1: TpuTopology.declare(
                n, num_hosts=hosts, kind="v5e"))
    return types.SimpleNamespace(
        name="port", clock=clock, rs=trs, lb=tlb, C=TC, qm=tqm, auto=tas,
        errors=terrors, Message=ttypes.Message, Priority=ttypes.Priority,
        Shedder=toverload.OverloadShedder, ApiError=TApiError,
        declare=lambda n, hosts=1: GpuTopology.declare(
            n, num_hosts=hosts, kind="v5e", hbm_gb=16.0))


def _both(scenario):
    return (scenario(_ns("jax", FakeClock())),
            scenario(_ns("port", FakeClock())))


def _res(ns, rid="r0", chips=8.0, hbm=128.0, **kw):
    R = ns.rs
    return R.Resource(id=rid, capabilities={"chip"},
                      capacity={R.ResourceType.CHIP: chips,
                                R.ResourceType.HBM_GB: hbm}, **kw)


def _req(ns, chips=4.0, hbm=64.0, caps=("chip",), **kw):
    R = ns.rs
    return R.ResourceRequest(capabilities=set(caps),
                             amounts={R.ResourceType.CHIP: chips,
                                      R.ResourceType.HBM_GB: hbm}, **kw)


def _used(r):
    return {t.value: v for t, v in r.used.items()}


# -- resource scheduler -----------------------------------------------------

def _allocation_scenario(ns):
    R, trace = ns.rs, []
    rs = R.ResourceScheduler(clock=ns.clock)
    rs.register_resource(_res(ns))
    alloc = rs.request_resource_now(_req(ns))
    r = rs.get_resource("r0")
    trace.append(("alloc", _used(r), r.load, alloc.expires_at))
    try:
        rs.release_allocation(alloc.id, "wrong")
    except PermissionError:
        trace.append("bad token refused")
    rs.release_allocation(alloc.id, alloc.token)
    trace.append(("released", _used(r), r.load))
    busy = _res(ns, "busy")
    busy.used = {R.ResourceType.CHIP: 6.0, R.ResourceType.HBM_GB: 96.0}
    rs.register_resource(busy)
    trace.append(("least loaded",
                  rs.request_resource_now(_req(ns, 2.0, 32.0)).resource_id))
    for label, req in (("caps", _req(ns, caps=("chip", "fp8"))),
                       ("capacity", _req(ns, 64.0, 1024.0))):
        try:
            rs.request_resource_now(req)
        except ns.errors.NoResourceError:
            trace.append(("refused", label))
    off = _res(ns, "off")
    off.status = R.ResourceStatus.OFFLINE
    rs2 = R.ResourceScheduler(clock=ns.clock)
    rs2.register_resource(off)
    try:
        rs2.request_resource_now(_req(ns))
    except ns.errors.NoResourceError:
        trace.append(("refused", "offline"))
    trace.append(("stats", {k: v for k, v in rs.get_stats().items()
                            if k != "topology"}))
    return trace


def test_allocation_matches_jax():
    """Tolerance: none. Charges, load, least-loaded choice, token check,
    and the capability, capacity and offline filters."""
    j, t = _both(_allocation_scenario)
    assert t == j
    assert ("refused", "offline") in t and ("least loaded", "r0") in t


def _pending_scenario(ns):
    R, trace = ns.rs, []
    rs = R.ResourceScheduler(clock=ns.clock)
    rs.register_resource(_res(ns))
    blocker = rs.request_resource_now(_req(ns, 8.0, 128.0))
    low = _req(ns, 8.0, 128.0, priority=ns.Priority.LOW)
    rt = _req(ns, 8.0, 128.0, priority=ns.Priority.REALTIME)
    trace.append((rs.request_resource(low), rs.request_resource(rt),
                  rs.pending_count()))
    rs.release_allocation(blocker.id, blocker.token)
    trace.append((rs.get_allocation_for_request(rt.id) is not None,
                  rs.get_allocation_for_request(low.id) is not None,
                  rs.pending_count()))
    timed = _req(ns, 16.0, 256.0, timeout=5.0)
    rs.request_resource(timed)
    ns.clock.advance(6.0)
    trace.append(("expired", rs.process_pending_once(), rs.pending_count()))
    return trace


def test_pending_queue_matches_jax():
    """Tolerance: none. A REALTIME request takes freed capacity before an
    earlier LOW one; a timed-out pending request expires cleanly."""
    j, t = _both(_pending_scenario)
    assert t == j
    assert t[1] == (True, False, 1)


def _monitor_scenario(ns):
    R, C, trace = ns.rs, ns.C, []
    cfg = C.ResourceSchedulerConfig(heartbeat_timeout=30.0,
                                    allocation_timeout=10.0)
    rs = R.ResourceScheduler(cfg, clock=ns.clock)
    rs.register_resource(_res(ns))
    rs.request_resource_now(_req(ns))
    pinned = rs.request_resource_now(_req(ns, 2.0, 32.0,
                                          metadata={"pinned": True}))
    ns.clock.advance(11.0)
    rs.heartbeat("r0")
    trace.append(("expiry", rs.run_monitor_once(),
                  _used(rs.get_resource("r0")), pinned.expires_at))
    ns.clock.advance(31.0)
    trace.append(("offline", rs.run_monitor_once(),
                  rs.get_resource("r0").status.value))
    trace.append(("beat", rs.heartbeat("r0"), rs.heartbeat("nope"),
                  rs.get_resource("r0").status.value))
    ns.clock.advance(29.0)
    trace.append(("inside the timeout", rs.run_monitor_once(),
                  rs.get_resource("r0").status.value))
    return trace


def test_monitor_matches_jax():
    """Tolerance: none. Allocation expiry (a pinned one never expires),
    heartbeat timeout and recovery."""
    j, t = _both(_monitor_scenario)
    assert t == j
    assert t[-1] == ("inside the timeout",
                     {"offline": 0, "expired_allocations": 0}, "online")


def _carving_scenario(ns):
    rs = ns.rs.ResourceScheduler(clock=ns.clock)
    rows = rs.register_topology_resources(ns.declare(16, 2),
                                          chips_per_resource=8)
    return [(r.id, {t.value: v for t, v in r.capacity.items()}, r.endpoint,
             r.metadata) for r in rows] + [rs.get_stats()["topology"]]


def test_topology_carving_matches_jax():
    j, t = _both(_carving_scenario)
    assert t == j
    assert t[0][1] == {"chip": 8.0, "hbm_gb": 128.0}


def test_capability_tags_name_the_platform_not_tpu():
    """The card's resources carry its platform and its name."""
    rs = trs.ResourceScheduler(clock=FakeClock())
    rows = rs.register_topology_resources(
        GpuTopology.declare(2, kind="NVIDIA H100 80GB HBM3", hbm_gb=79.6),
        chips_per_resource=1)
    assert [sorted(r.capabilities) for r in rows] == \
        [["NVIDIA H100 80GB HBM3", "cuda"]] * 2
    assert rows[1].capacity[trs.ResourceType.HBM_GB] == 79.6


def test_topology_discover_cpu_and_cuda(monkeypatch):
    """An explicit CPU device is one host chip (16 GB, as the JAX
    package's CPU devices are); on ``cuda`` every card is read through
    torch.cuda; without CUDA, discovery on ``cuda`` raises."""
    topo = GpuTopology.discover("cpu")
    assert (topo.num_chips, topo.chips[0].platform, topo.total_hbm_gb) == (
        1, "cpu", 16.0)
    assert set(topo.to_dict()) == set(TpuTopology.declare(1).to_dict())
    assert set(topo.chips[0].to_dict()) == set(
        TpuTopology.declare(1).chips[0].to_dict())
    props = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                                  total_memory=85_520_809_984)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: props)
    topo = GpuTopology.discover("cuda")
    assert topo.num_chips == 4 and topo.chips[3].id == 3
    assert topo.chips[0].kind == "NVIDIA H100 80GB HBM3"
    assert topo.chips[0].hbm_gb == pytest.approx(85_520_809_984 / 2**30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GpuTopology.discover("cuda")


# -- cache-aware admission --------------------------------------------------

def _estimator_scenario(ns):
    R, trace = ns.rs, []
    rs = R.ResourceScheduler(clock=ns.clock)
    rs.register_resource(R.Resource(id="t", capacity={
        R.ResourceType.TOKENS: 1000.0}))
    trace.append(("no rate", rs.prefill_eta_ms(0), rs.prefill_eta_ms(100)))
    rs.set_prefill_estimator(
        lambda md: (int(md.get("cached", 0)), int(md.get("prompt_tokens", 0))))
    for md in ({"cached": 300, "prompt_tokens": 100}, {"prompt_tokens": 100},
               {"cached": 50}):
        a = rs.request_resource_now(R.ResourceRequest(
            amounts={R.ResourceType.TOKENS: 400.0}, metadata=md))
        trace.append(("charged", {t.value: v for t, v in a.charged.items()}))
        rs.release_allocation(a.id, a.token)
    for tokens, secs in ((1000, 0.5), (600, 0.2), (0, 1.0), (10, 0.0)):
        rs.observe_prefill(tokens, secs)
    st = rs.get_stats()
    trace.append(("learned", round(rs.prefill_eta_ms(1200), 6),
                  st["prefill_tokens_per_s"], st["prefill_observations"],
                  st["prefill_eta_ms_per_1k"]))
    return trace


def test_prefill_estimator_and_learned_rate_match_jax():
    """Tolerance: none. A TOKENS request is charged its expected new
    share; the learned rate is an EWMA of the observed prefills."""
    j, t = _both(_estimator_scenario)
    assert t == j
    assert t[1] == ("charged", {"tokens": 100.0})
    rate = 0.8 * 2000.0 + 0.2 * 3000.0
    assert t[-1][1] == pytest.approx(1200 / rate * 1e3)


def _shed_scenario(ns):
    """The deadline check adds the prompt's prefill ETA at the learned
    rate: admitted before a rate is learned, shed after."""
    C, trace = ns.C, []
    rs = ns.rs.ResourceScheduler(clock=ns.clock)
    cfg = C.Config()
    shed = ns.Shedder(cfg.overload, cfg.queue, resource_scheduler=rs)
    msg = ns.Message(content="x" * 8000, timeout=10.0)   # 2000 tokens
    shed.admit(msg, None, 8.0)
    trace.append("admitted without a rate")
    rs.observe_prefill(500, 1.0)
    try:
        shed.admit(msg, None, 8.0)
    except ns.ApiError as e:
        trace.append((e.status, round(e.retry_after, 6), e.message))
    shed.admit(ns.Message(content="x" * 40, timeout=10.0), None, 8.0)
    trace.append(dict(shed.shed_counts))
    return trace


def test_shedder_adds_the_learned_prefill_eta_like_jax():
    j, t = _both(_shed_scenario)
    assert t[:2] == j[:2]
    assert t[1][0] == 429
    assert {k: v for k, v in j[2].items() if v} == \
        {k: v for k, v in t[2].items() if v} == {"sla": 1}


# -- the endpoint autoscaler ---------------------------------------------------

def _autoscaler(ns, strategy="dynamic", pending=0):
    qm = ns.qm.QueueManager("as", clock=ns.clock, enable_metrics=False)
    for _ in range(pending):
        qm.push_message(ns.Message())
    lb = ns.lb.LoadBalancer(ns.C.LoadBalancerConfig(health_check_interval=0),
                            clock=ns.clock)
    cfg = ns.C.SchedulerConfig(strategy=strategy, scale_up_threshold=10,
                               scale_down_threshold=1, min_endpoints=1,
                               max_endpoints=3, cooldown=0.0)
    prov, deco = [], []

    def provision(seq):
        ep = ns.lb.Endpoint(id=f"auto-{seq}", url=f"local://auto-{seq}")
        prov.append(ep.id)
        return ep

    a = ns.auto.Autoscaler(qm, lb, cfg, provision_fn=provision,
                           decommission_fn=lambda ep: deco.append(ep.id),
                           clock=ns.clock)
    return qm, lb, a, prov, deco


def _ids(lb):
    return sorted(e.id for e in lb.endpoints())


def _dynamic_scenario(ns):
    trace = []
    qm, lb, a, prov, _ = _autoscaler(ns, pending=20)
    lb.add_endpoint(ns.lb.Endpoint(id="seed"))
    trace.append((a.run_once(), _ids(lb), list(prov)))
    qm.stop()
    qm, lb, a, _, deco = _autoscaler(ns, pending=0)
    lb.add_endpoint(ns.lb.Endpoint(id="seed-0"))
    lb.add_endpoint(ns.lb.Endpoint(id="seed-1"))
    lb.get_endpoint_by_id("seed-0").connections = 2
    trace.append((a.run_once(), _ids(lb), list(deco)))
    trace.append(a.run_once())              # at min_endpoints
    qm.stop()
    qm, lb, a, _, _ = _autoscaler(ns, pending=20)
    a.config.cooldown = 60.0
    lb.add_endpoint(ns.lb.Endpoint(id="seed"))
    trace += [a.run_once()["action"], a.run_once()["action"]]
    ns.clock.advance(61.0)
    trace += [a.run_once()["action"], a.run_once()["action"]]
    ns.clock.advance(61.0)
    trace.append(a.run_once())              # at max_endpoints
    qm.stop()
    qm, lb, a, _, _ = _autoscaler(ns, strategy="static", pending=50)
    trace.append(a.run_once())
    a2 = ns.auto.Autoscaler(qm, lb, ns.C.SchedulerConfig(cooldown=0.0),
                            clock=ns.clock)
    trace.append(a2.run_once())             # no provision_fn: logged only
    qm.stop()
    return trace


def test_dynamic_scaling_matches_jax():
    """Tolerance: none. Up with a backlog (provisioned), down without one
    (the least busy endpoint, decommissioned), min and max held, the
    cooldown, ``static`` idle, and a scale-up without an actuator."""
    j, t = _both(_dynamic_scenario)
    assert t == j
    assert t[0][0]["action"] == "up" and t[0][1] == ["auto-1", "seed"]
    assert t[1][0]["action"] == "down" and t[1][2] == ["seed-1"]
    assert t[2]["action"] == "none"
    assert t[3:7] == ["up", "cooldown", "up", "cooldown"]
    assert t[7] == {"pending": 20, "endpoints": 3, "action": "none"}
    assert t[8]["action"] == "none" and t[9]["action"] == "none"


def _adaptive_scenario(ns):
    out = []
    for lt in ((2026, 7, 29, 11, 0, 0, 2, 210, 0),    # Wednesday 11:00
               (2026, 8, 1, 11, 0, 0, 5, 213, 0)):    # Saturday 11:00
        qm, lb, a, prov, deco = _autoscaler(ns, strategy="adaptive")
        lb.add_endpoint(ns.lb.Endpoint(id="seed"))
        lb.add_endpoint(ns.lb.Endpoint(id="seed-2"))
        a._localtime = lambda lt=lt: time.struct_time(lt)
        out.append((a.run_once(), _ids(lb), prov, deco))
        qm.stop()
    # The clock drives local time when none is pinned.
    qm, lb, a, _, _ = _autoscaler(ns, strategy="adaptive")
    out.append(tuple(a._localtime())[:6] == tuple(
        time.localtime(ns.clock.now()))[:6])
    qm.stop()
    return out


def test_adaptive_business_hours_match_jax():
    j, t = _both(_adaptive_scenario)
    assert t == j
    assert t[0][0]["action"] == "none"       # max-1 = 2 already
    assert t[1][0]["action"] == "down" and len(t[1][1]) == 1
    assert t[2] is True


def _hybrid_scenario(ns):
    qm, lb, a, _, _ = _autoscaler(ns, strategy="hybrid", pending=5)
    fast = ns.lb.Endpoint(id="fast", response_time=0.1)
    slow = ns.lb.Endpoint(id="slow", response_time=1.0)
    glacial = ns.lb.Endpoint(id="glacial", response_time=50.0)
    for e in (fast, slow, glacial):
        lb.add_endpoint(e)
    out = (a.run_once(), fast.weight, slow.weight, glacial.weight)
    qm.stop()
    return out


def test_hybrid_applies_weights_like_jax():
    j, t = _both(_hybrid_scenario)
    assert t == j
    assert t[1:] == (1.0, 0.1, 0.1)


def test_autoscaler_loop_starts_and_stops():
    """The monitor loop ticks every ``monitor_interval`` on its thread
    and stops within its join bound."""
    for ns in (_ns("jax", FakeClock()), _ns("port", FakeClock())):
        qm, lb, a, _, _ = _autoscaler(ns, pending=20)
        a.config.monitor_interval = 0.02
        lb.add_endpoint(ns.lb.Endpoint(id="seed"))
        a.start()
        deadline = time.time() + 5
        while len(lb.endpoints()) < 3 and time.time() < deadline:
            time.sleep(0.01)
        a.stop()
        qm.stop()
        assert len(lb.endpoints()) == 3, ns.name


def test_serve_apps_first_tick_removes_an_endpoint_like_jax(tmp_path,
                                                           monkeypatch):
    """Tolerance: none. Both packages' ``App`` in serve mode (echo
    backend, one peer, the default ``scheduler`` block, the autoscaler
    on a fake clock): the first tick scales down and the local endpoint
    leaves the load balancer, which keeps only the peer. With
    ``scheduler.min_endpoints: 2`` nothing leaves."""
    from llmq_tpu.__main__ import App as JApp
    from llmq_tpu_torch.__main__ import App as TApp

    monkeypatch.chdir(tmp_path)
    peer = "http://127.0.0.1:9"
    out = {}
    for name, App, cfg in (("jax", JApp, JC.default_config()),
                           ("port", TApp, TC.Config())):
        cfg.executor.backend = "echo"
        cfg.queue.enable_metrics = False
        cfg.cluster.peers = [peer]
        if name == "port":
            cfg.device = "cpu"
            app = App(cfg, with_scheduler=True)
        else:
            app = App(cfg, with_api=True, with_workers=True,
                      with_engine=True, with_scheduler=True)
        try:
            before = sorted(e.url.split("://")[0]
                            for e in app.load_balancer.endpoints())
            app.autoscaler._clock = FakeClock()
            first = app.autoscaler.run_once()
            left = [e.url for e in app.load_balancer.endpoints()]
            app.autoscaler.config.min_endpoints = 2
            app.load_balancer.add_endpoint(
                app.load_balancer.endpoints()[0].__class__(
                    id="back", url="local://back"))
            app.autoscaler._last_scale_at = -1e9
            kept = app.autoscaler.run_once()
        finally:
            app.stop()
        out[name] = (before, first, left, kept["action"],
                     app.cluster_router.get_stats()["local_endpoint_id"]
                     is not None)
    assert out["port"] == out["jax"]
    assert out["port"] == (["http", "local"],
                           {"pending": 0, "endpoints": 2, "action": "down"},
                           [peer], "none", True)


# -- load balancer ------------------------------------------------------------

def _lb(ns, probe=None):
    return ns.lb.LoadBalancer(
        ns.C.LoadBalancerConfig(health_check_interval=0), clock=ns.clock,
        probe=probe)


def _registry_scenario(ns):
    S, trace = ns.lb.EndpointStatus, []
    lb = _lb(ns)
    for i in range(3):
        lb.add_endpoint(ns.lb.Endpoint(id=f"e{i}", url=f"local://e{i}"))
    lb.add_endpoint(ns.lb.Endpoint(
        id="b0", model_type="embed", weight=2.0, max_connections=4,
        metadata={"chips": 8, "engine": object()}))
    trace.append(sorted(e.id for e in lb.endpoints()))
    trace.append([e.id for e in lb.endpoints("embed")])
    trace.append((lb.set_endpoint_status("e1", S.UNHEALTHY),
                  lb.set_endpoint_status("nope", S.HEALTHY),
                  lb.set_draining("nope"), lb.set_draining("b0")))
    trace.append((lb.remove_endpoint("e0"), lb.remove_endpoint("e0"),
                  lb.get_endpoint_by_id("e0")))
    lb.add_endpoint(ns.lb.Endpoint(id="e2", url="local://again"))
    trace.append([e.to_dict() for e in lb.endpoints()])
    trace.append([e.id for e in lb.endpoints("llm")])
    stats = lb.get_stats()
    trace.append({k: v for k, v in stats.items()
                  if k not in ("strategy", "active_sessions")})
    trace.append(sorted(stats))
    trace.append((stats["strategy"], stats["active_sessions"]))
    return trace


def test_registry_and_stats_match_jax():
    """Tolerance: none. Add, list by model type, status, draining,
    removal and re-adding, the endpoints' payloads and the stats, the
    JAX package's keys and values (the strategy selects now, and the
    sessions are held: ``tests/test_torch_loadbalancer.py``)."""
    j, t = _both(_registry_scenario)
    assert t == j
    assert t[1] == ["b0"] and t[5] == ["e1", "e2"]
    assert t[-1] == ("round_robin", 0)
    stats = tlb.LoadBalancer().get_stats()
    assert (stats["strategy"], stats["active_sessions"]) == (
        jlb.LoadBalancer().get_stats()["strategy"], 0)


def _health_scenario(ns):
    trace = []
    health = {"ok": True}
    lb = _lb(ns, probe=lambda ep: health["ok"])
    lb.add_endpoint(ns.lb.Endpoint(id="e0"))
    for ok in (False, False, False, True, True, True, True):
        health["ok"] = ok
        trace.append(lb.check_health_once()["e0"].value)
    lb.set_draining("e0")
    health["ok"] = False
    trace.append(lb.check_health_once()["e0"].value)
    lb.set_draining("e0", False)
    trace.append(lb.get_endpoint_by_id("e0").status.value)
    health["ok"] = True
    trace.append([lb.check_health_once()["e0"].value for _ in range(2)])
    ns.clock.advance(5.0)
    lb.check_health_once()
    trace.append(lb.get_endpoint_by_id("e0").last_health_check)
    bad = _lb(ns, probe=lambda ep: 1 / 0)
    bad.add_endpoint(ns.lb.Endpoint(id="x"))
    trace.append(bad.check_health_once()["x"].value)
    trace.append({k: v for k, v in lb.get_stats().items()
                  if k not in ("endpoints", "strategy")})
    return trace


def test_health_machine_matches_jax():
    """Tolerance: none. healthy → degraded → unhealthy, recovery through
    degraded, draining untouched by probes and left through degraded,
    and a crashing probe as a failure."""
    j, t = _both(_health_scenario)
    assert t == j
    assert t[:7] == ["degraded", "degraded", "unhealthy", "unhealthy",
                     "degraded", "degraded", "healthy"]
    assert t[7:10] == ["draining", "degraded", ["degraded", "healthy"]]


def test_default_probe_matches_jax():
    """An attached engine's ``healthy()`` decides (a raising one is
    down), a bare ``local://`` or empty URL is up, and a TCP URL is
    probed by connecting."""
    class Eng:
        def __init__(self, ok):
            self.ok = ok

        def healthy(self):
            if self.ok is None:
                raise RuntimeError("probe crashed")
            return self.ok

    def run(mod):
        return [mod.default_probe(mod.Endpoint(id="a", url=url,
                                               metadata=md), timeout=0.5)
                for url, md in (("local://e", {}), ("", {}),
                                ("local://e", {"engine": Eng(False)}),
                                ("local://e", {"engine": Eng(None)}),
                                ("http://x", {"engine": Eng(True)}),
                                ("tcp://127.0.0.1:1", {}))]

    assert run(tlb) == run(jlb) == [True, True, False, False, True, False]


# -- the serving process ----------------------------------------------------

def _cpu_app(monkeypatch, tmp_path):
    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.engine.builder import build_engine

    monkeypatch.chdir(tmp_path)
    cfg = TC.Config()
    cfg.device = "cpu"
    cfg.model.name = "llama3-tiny"
    cfg.resource_scheduler.heartbeat_timeout = 3.0
    cfg.resource_scheduler.monitor_interval = 0.5
    cfg.executor.supervisor.enabled = False
    eng = build_engine(cfg, model_dtype=torch.float32)
    return App(cfg, engine=eng), eng


def test_app_holds_the_engines_chip_and_heartbeats_it(monkeypatch,
                                                      tmp_path):
    """On every serve the device is registered as a CHIP/HBM_GB resource,
    the engine holds its one chip (pinned), the heartbeat keeps it
    online past twice the timeout, and the allocation is released at
    stop; the estimator and the prefill observation are wired."""
    app, eng = _cpu_app(monkeypatch, tmp_path)
    rs = app.resource_scheduler
    app.start(host="127.0.0.1", port=0)
    try:
        res = rs.resources()
        assert len(res) == 1 and sorted(res[0].capabilities) == ["cpu"]
        assert res[0].used == {trs.ResourceType.CHIP: 1.0}
        assert app.engine_allocation.expires_at == 0.0
        h = eng.submit(__import__(
            "llmq_tpu_torch.engine.engine", fromlist=["GenRequest"]
        ).GenRequest(id="a", prompt="hello there", max_new_tokens=3))
        assert h.wait(60)
        time.sleep(6.5)
        assert rs.get_resource(res[0].id).status == trs.ResourceStatus.ONLINE
        assert rs.get_stats()["prefill_observations"] >= 1
        assert rs.prefill_eta_ms(1200) > 0
        assert rs._prefill_estimator({"conversation_id": "",
                                      "prompt_tokens": 7}) == (0, 7)
    finally:
        app.stop()
    assert rs.allocations() == []
