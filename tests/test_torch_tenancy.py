"""The port's tenancy plane against the JAX package's, on the CPU: every
scenario runs through both packages on the same inputs (fake clocks
where time matters) and their results must be equal (tolerance: none).

- ``TenantRegistry``: class resolution, token buckets (debt, refill,
  retry times), depth and in-flight counters, the LRU that spares
  configured tenants, the token estimates; ``weighted_token_caps`` on a
  grid and on seeded random weights.
- Fair dequeue through ``QueueManager`` on the Python and the native
  queue core: pop orders (4:1 interleave, FIFO within a tenant, single
  tenant and off-switch against FIFO, no credit for idling, priority
  over debt, in-flight deferral and its release on fail, requeue and
  retry stash, admin removal, expiry, a queue created after the
  manager), virtual times after the finish
  true-up, and the queue statistics.
- Quotas at the overload seam: 429 reasons, codes, ``Retry-After``, the
  shed counts and the registry's rejection totals; quotas with overload
  off; the REST path with ``X-Tenant-Id`` and ``/api/v1/tenancy``.
- Engine decode fairness and the two-pass prefill pack, on seeded random
  inputs; the off-switch's echo run.
- The echo convergence run (served tokens 4:1 within JAX's band), the
  WAL restore and the spool round trip, and the five metric families.
- Stream parity: f32 llama3-tiny, two tenants at 4:1, the port's engine
  on ``TorchExecutor`` against JAX's on ``JaxExecutor``, bucket and
  ragged mixed batching: equal chunk budgets, pack plans and greedy
  streams, token for token.

Both packages' registries are process singletons: every test resets
both before and after, and the JAX package's tenancy families are put
back as they were after a test that flushed them.
"""

from __future__ import annotations

import importlib
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch


def _ns(pkg: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    return SimpleNamespace(
        pkg=pkg, C=m("core.config"), clock=m("core.clock"),
        types=m("core.types"), errors=m("core.errors"),
        QM=m("queueing.queue_manager").QueueManager, ten=m("tenancy"),
        overload=m("api.overload"), server=m("api.server"),
        factory=m("queueing.factory"), engine=m("engine.engine"),
        executor=m("engine.executor"), tok=m("engine.tokenizer"),
        spool=m("queueing.spool"), metrics=m("metrics.registry"),
        usage=m("observability.usage"))


J = _ns("llmq_tpu")
T = _ns("llmq_tpu_torch")
BOTH = (J, T)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_tenancy():
    for P in BOTH:
        P.ten.reset_tenancy()
    yield
    for P in BOTH:
        P.ten.reset_tenancy()


@pytest.fixture(params=["python", "native"])
def queue_backend(request) -> str:
    """The Python and the native ordering core, in both packages."""
    if request.param == "native":
        from llmq_tpu.native.loader import native_available as j_ok
        from llmq_tpu_torch.native.loader import native_available as t_ok
        if not (j_ok() and t_ok()):
            pytest.skip("native queue core not buildable here")
    return request.param


@pytest.fixture
def jax_tenancy_metrics():
    """Put the JAX package's five tenancy families (and its flush's
    record of written series) back as they were: the JAX package's own
    tests read them."""
    jm = J.metrics.get_metrics()
    fams = [jm.tenant_virtual_time, jm.tenant_share_ratio,
            jm.tenant_quota_rejections, jm.tenant_inflight,
            jm.tenant_registry_evictions]

    def values(f):
        return {k: c._value.get() for k, c in f._metrics.items()} \
            if f._labelnames else {(): f._value.get()}

    before = [values(f) for f in fams]
    flushed = {k: set(v) for k, v in J.ten._FLUSHED.items()}
    yield
    for f, snap in zip(fams, before):
        if not f._labelnames:
            f._value.set(snap[()])
            continue
        with f._lock:
            for k in list(f._metrics):
                if k not in snap:
                    del f._metrics[k]
        for k, v in snap.items():
            f.labels(*k)._value.set(v)
    J.ten._FLUSHED.clear()
    J.ten._FLUSHED.update(flushed)


def _cfg(P, enabled=True, tenants=None, **default_kw):
    cfg = P.C.Config()
    cfg.queue.enable_metrics = False
    cfg.tenancy = P.C.TenancyConfig(
        enabled=enabled, tenants=dict(tenants or {}),
        default=P.C.TenantClassConfig(**default_kw))
    return cfg


def _mk(P, mid, tenant="default", prio="normal", content="x" * 40, **md):
    m = P.types.Message(id=mid, content=content,
                        priority=P.types.Priority.from_name(prio),
                        tenant_id=tenant)
    m.metadata.update(md)
    return m


def _both(fn, *args, **kw):
    """``fn`` run through each package; asserts the results are equal and
    returns them."""
    out = []
    for P in BOTH:
        P.ten.reset_tenancy()
        out.append(fn(P, *args, **kw))
    assert out[1] == out[0], (out[0], out[1])
    return out


def _try_pop(mgr, queue):
    """The manager's ``pop_message``, or None when the queue is empty."""
    try:
        return mgr.pop_message(queue)
    except (J.errors.QueueEmptyError, T.errors.QueueEmptyError):
        return None


def _drain(mgr, queue="normal"):
    out = []
    while True:
        m = _try_pop(mgr, queue)
        if m is None:
            return out
        out.append(m)
        mgr.complete_message(m)


# -- registry -----------------------------------------------------------------

class TestTenantRegistry:
    def test_spec_resolution_named_vs_default(self):
        def run(P):
            reg = P.ten.TenantRegistry()
            reg.configure(P.C.TenancyConfig(
                enabled=True, tenants={"acme": {"weight": 4.0,
                                                "max_inflight": 2}},
                default=P.C.TenantClassConfig(weight=1.0)))
            return (reg.enabled, reg.weight_for("acme"),
                    reg.spec_for("acme").max_inflight,
                    reg.weight_for("anyone-else"), reg.is_configured("acme"),
                    reg.snapshot())
        _both(run)

    @pytest.mark.parametrize("weight", [0.0, -1.0])
    def test_invalid_weight_rejected(self, weight):
        for P in BOTH:
            with pytest.raises(ValueError, match="weight must be > 0"):
                P.C.TenantClassConfig(weight=weight)

    def test_token_buckets_debt_refill_and_retry_times(self):
        def run(P):
            clock = P.clock.FakeClock()
            reg = P.ten.TenantRegistry(clock=clock)
            reg.configure(P.C.TenancyConfig(enabled=True, tenants={
                "t": {"token_rate": 100.0, "burst_tokens": 200.0},
                "debt": {"token_rate": 10.0, "burst_tokens": 50.0},
                "noburst": {"token_rate": 30.0}}))
            log = []
            for tenant, n, dt, kw in [
                    ("t", 200, 0, {}), ("t", 100, 0, {}), ("t", 100, 1.0, {}),
                    ("t", 50, 0.1, {"consume": False}), ("t", 60, 0, {}),
                    ("t", 300, 0, {"force": True}), ("t", 1, 0.5, {}),
                    ("debt", 500, 0, {}), ("debt", 1, 0, {}),
                    ("debt", 1, 30.0, {}), ("noburst", 30, 0, {}),
                    ("noburst", 1, 0, {}), ("free", 10_000, 0, {})]:
                clock.advance(dt)
                ok, retry = reg.admit_tokens(tenant, n, **kw)
                log.append((tenant, n, ok, round(retry, 9)))
            return log
        _both(run)

    def test_depth_and_inflight_counters(self):
        def run(P):
            reg = P.ten.TenantRegistry()
            reg.configure(P.C.TenancyConfig(
                enabled=True, tenants={"t": {"max_inflight": 1,
                                             "max_queue_depth": 2}}))
            log = []
            for op in ("note_enqueued", "note_enqueued", "note_dequeued",
                       "acquire_inflight", "release_inflight",
                       "note_dequeued", "note_dequeued", "release_inflight",
                       "acquire_inflight", "acquire_inflight"):
                getattr(reg, op)("t")
                log.append((op, reg.queue_depth("t"), reg.inflight("t"),
                            reg.over_queue_depth("t"),
                            reg.at_inflight_cap("t")))
            return log, reg.inflight_by_tenant()
        _both(run)

    def test_bucket_lru_never_evicts_configured_tenant(self):
        def run(P):
            reg = P.ten.TenantRegistry(clock=P.clock.FakeClock())
            reg.MAX_TRACKED = 8
            reg.configure(P.C.TenancyConfig(
                enabled=True, tenants={"vip": {"token_rate": 1000.0}},
                default=P.C.TenantClassConfig(token_rate=1000.0)))
            log = [reg.admit_tokens("vip", 500)]
            for i in range(50):
                reg.admit_tokens(f"spray-{i}", 1)
            log += [reg.admit_tokens("vip", 400), reg.admit_tokens("vip", 400)]
            return log, reg.evictions_total, reg.drain_evictions(), \
                reg.drain_evictions()
        j, _ = _both(run)
        assert j[0][1][0] and not j[0][2][0] and j[1] == 50 - 7

    def test_rejections_and_drain(self):
        def run(P):
            reg = P.ten.TenantRegistry()
            for r in ("rate", "queue_depth", "inflight", "bogus", "rate"):
                reg.note_rejection(r)
            return dict(reg.rejections_total), reg.drain_rejections(), \
                reg.drain_rejections()
        _both(run)

    def test_estimate_tokens(self):
        def run(P):
            msgs = [_mk(P, "a", content="x" * 400),
                    _mk(P, "b", content="x" * 40, max_new_tokens=10),
                    _mk(P, "c", content=""),
                    _mk(P, "d", content="y" * 3, max_new_tokens="bad"),
                    _mk(P, "e", content="z" * 1001, max_new_tokens=-5)]
            return ([P.ten.estimate_tokens(m) for m in msgs],
                    [P.overload.estimate_prompt_tokens(m) for m in msgs])
        _both(run)

    def test_one_estimate_shared_by_the_shedder(self):
        from llmq_tpu_torch.api import overload
        from llmq_tpu_torch.tenancy import registry
        assert overload.estimate_prompt_tokens is \
            registry.estimate_prompt_tokens


# -- weighted caps ------------------------------------------------------------

class TestWeightedTokenCaps:
    @pytest.mark.parametrize("weights,total", [
        ({"a": 4.0, "b": 1.0}, 100), ({"a": 4.0, "b": 1.0}, 128),
        ({"a": 1, "b": 1, "c": 1}, 100), ({"a": 1000.0, "b": 0.001}, 10),
        ({}, 100), ({"a": 1.0}, 0), ({"a": 3.0, "b": 1.0}, 32),
        ({"a": 1.0, "b": 2.0, "c": 5.0}, 2), ({"a": 1.0, "b": 1.0}, 1)])
    def test_grid(self, weights, total):
        _both(lambda P: P.ten.weighted_token_caps(dict(weights), total))

    def test_seeded_random_weights(self):
        rng = random.Random(17)
        for _ in range(300):
            n = rng.randint(1, 6)
            weights = {f"t{i}": rng.choice([0.001, 0.5, 1.0, 2.0, 4.0,
                                            rng.uniform(0.01, 50.0)])
                       for i in range(n)}
            total = rng.randint(0, 300)
            j, t = _both(lambda P: P.ten.weighted_token_caps(
                dict(weights), total))
            if total >= n and weights:
                assert sum(t.values()) == total and min(t.values()) >= 1


# -- fair dequeue -------------------------------------------------------------

def _order(P, backend, tenants, pushes, *, pops=None, enabled=True,
           queues=("normal",)):
    """Push ``pushes`` ((id, tenant, prio)), then drain ``queues`` (or pop
    ``pops`` times from normal, completing each); returns the ids in
    pop order and the virtual times."""
    mgr = P.QM("wfq", config=_cfg(P, enabled, tenants), backend=backend,
               clock=P.clock.FakeClock())
    for mid, tenant, prio in pushes:
        mgr.push_message(_mk(P, mid, tenant, prio))
    got = []
    if pops is None:
        for q in queues:
            got += [m.id for m in _drain(mgr, q)]
    else:
        for _ in range(pops):
            m = mgr.pop_message("normal")
            got.append(m.id)
            mgr.complete_message(m)
    snap = mgr.fair_snapshot()
    mgr.stop()
    return got, snap and snap["virtual_times"]


class TestFairDequeue:
    def test_weighted_interleave_4_to_1(self, queue_backend):
        pushes = [(f"{t}{i}", t, "normal") for i in range(40) for t in "ab"]
        j, _ = _both(_order, queue_backend,
                     {"a": {"weight": 4.0}, "b": {"weight": 1.0}}, pushes)
        head = [mid[0] for mid in j[0][:25]]
        assert 2.5 <= head.count("a") / head.count("b") <= 6.0

    def test_fifo_within_tenant(self, queue_backend):
        pushes = [(f"a{i}", "a", "normal") for i in range(10)]
        j, _ = _both(_order, queue_backend, {"a": {"weight": 2.0}}, pushes)
        assert j[0] == [f"a{i}" for i in range(10)]

    def test_single_tenant_and_off_switch_match_fifo(self, queue_backend):
        pushes = [(f"m{i}", "default", "normal" if i % 3 else "high")
                  for i in range(30)]
        on, _ = _both(_order, queue_backend, {}, pushes,
                      queues=("high", "normal"))
        off, _ = _both(_order, queue_backend, {}, pushes, enabled=False,
                       queues=("high", "normal"))
        assert on[0] == off[0]
        mixed = [(f"m{i}", "abc"[i % 3], "normal") for i in range(30)]
        off2, _ = _both(_order, queue_backend, {"a": {"weight": 100.0}},
                        mixed, enabled=False)
        assert off2[0] == [f"m{i}" for i in range(30)]

    def test_off_switch_builds_no_scheduler(self):
        for P in BOTH:
            mgr = P.QM("off", config=_cfg(P, enabled=False))
            assert mgr._fair is None and mgr.queue._fair is None
            assert mgr.fair_snapshot() is None
            mgr.stop()

    def test_idle_tenant_hoards_no_credit(self, queue_backend):
        def run(P):
            mgr = P.QM("idle", backend=queue_backend,
                       config=_cfg(P, tenants={"a": {"weight": 1.0},
                                               "b": {"weight": 1.0}}))
            for i in range(60):
                mgr.push_message(_mk(P, f"a{i}", "a"))
            for _ in range(40):
                mgr.complete_message(mgr.pop_message("normal"))
            for i in range(60):
                mgr.push_message(_mk(P, f"b{i}", "b"))
            head = []
            for _ in range(20):
                m = mgr.pop_message("normal")
                head.append(m.id)
                mgr.complete_message(m)
            mgr.stop()
            return head
        j, _ = _both(run)
        assert 6 <= sum(1 for mid in j if mid[0] == "b") <= 14

    def test_priority_beats_tenant_debt(self, queue_backend):
        def run(P):
            mgr = P.QM("prio", backend=queue_backend, config=_cfg(
                P, tenants={"heavy": {"weight": 1.0},
                            "light": {"weight": 100.0}}))
            for i in range(20):
                mgr.push_message(_mk(P, f"h{i}", "heavy"))
                mgr.complete_message(mgr.pop_message("normal"))
            mgr.push_message(_mk(P, "light-normal", "light"))
            mgr.push_message(_mk(P, "heavy-rt", "heavy", "realtime"))
            out = [m.id for m in mgr.drain_in_priority_order(10)]
            mgr.stop()
            return out
        j, _ = _both(run)
        assert j == ["heavy-rt", "light-normal"]

    def test_inflight_cap_defers_and_releases(self, queue_backend):
        def run(P):
            mgr = P.QM("cap", backend=queue_backend, config=_cfg(
                P, tenants={"capped": {"max_inflight": 1},
                            "t": {"max_inflight": 1}}))
            reg = P.ten.get_tenant_registry()
            log = []
            for mid, t in (("c1", "capped"), ("c2", "capped"),
                           ("free1", "free")):
                mgr.push_message(_mk(P, mid, t))
            m1, m2 = mgr.pop_message("normal"), mgr.pop_message("normal")
            log.append(sorted([m1.id, m2.id]))
            for _ in range(20):
                log.append(_try_pop(mgr, "normal"))
            log.append((mgr.total_pending(), dict(reg.rejections_total)))
            mgr.complete_message(m1)
            mgr.complete_message(m2)
            log.append([m.id for m in _drain(mgr)])
            # Released on failure, requeue and retry stash.
            for mid in ("f1", "f2"):
                mgr.push_message(_mk(P, mid, "t"))
            mgr.fail_message(mgr.pop_message("normal"))
            m = mgr.pop_message("normal")
            log.append(m.id)
            mgr.requeue_message(m)
            m = mgr.pop_message("normal")
            log.append(m.id)
            mgr.stash_for_retry(m)
            mgr.push_message(_mk(P, "f4", "t"))
            log.append(mgr.pop_message("normal").id)
            log.append((reg.inflight_by_tenant(), dict(reg.rejections_total)))
            mgr.stop()
            return log
        j, _ = _both(run)
        assert j[1] is None and j[21] == (1, {"inflight": 1})

    def test_admin_remove_and_expiry_leave_the_fair_index(
            self, queue_backend):
        def run(P):
            clock = P.clock.FakeClock()
            cfg = _cfg(P)
            cfg.queue.stale_message_age = 10.0
            mgr = P.QM("adm", config=cfg, clock=clock, backend=queue_backend)
            reg = P.ten.get_tenant_registry()
            log = []
            mgr.push_message(_mk(P, "r1", "t"))
            mgr.push_message(_mk(P, "r2", "t"))
            log.append(mgr.remove_message("r1").id)
            log.append(reg.queue_depth("t"))
            clock.advance(60.0)
            mgr.push_message(_mk(P, "new", "t"))
            mgr.run_monitor_once()       # expires r2
            log.append(reg.queue_depth("t"))
            log.append(mgr.pop_message("normal").id)
            log.append(reg.queue_depth("t"))
            log.append(_try_pop(mgr, "normal"))
            s = mgr.get_stats("normal")
            log.append((s.pending_count, s.processing_count,
                        s.failed_count, s.wait_samples))
            mgr.stop()
            return log
        j, _ = _both(run)
        assert j[:6] == ["r1", 1, 1, "new", 0, None]

    def test_a_created_queue_has_its_own_fair_index(self, queue_backend):
        def run(P):
            mgr = P.QM("rq", backend=queue_backend, config=_cfg(
                P, tenants={"gold": {"weight": 4.0}}))
            mgr.queue.create_queue("extra")
            for i in range(4):
                mgr.push_message(_mk(P, f"b{i}", "bronze"), "extra")
            for i in range(4):
                mgr.push_message(_mk(P, f"g{i}", "gold"), "extra")
            mgr.push_message(_mk(P, "n0", "bronze"))
            reg = P.ten.get_tenant_registry()
            out = [mgr.remove_message("b1").id, reg.queue_depth("bronze")]
            out.append([m.id for m in _drain(mgr, "extra")])
            out += [reg.queue_depth("bronze"), _try_pop(mgr, "normal").id,
                    mgr.fair_snapshot()["backlog"]]
            mgr.stop()
            return out
        j, _ = _both(run)
        # Admin removal leaves the index; the rest pops 4:1 by weight.
        assert j == ["b1", 4, ["b0", "g0", "g1", "g2", "g3", "b2", "b3"],
                     1, "n0", {}]

    def test_true_up_from_measured_usage(self, queue_backend):
        def run(P):
            mgr = P.QM("tu", backend=queue_backend, clock=P.clock.FakeClock(),
                       config=_cfg(P, tenants={"a": {"weight": 1.0},
                                               "b": {"weight": 2.0}}))
            for i in range(4):
                mgr.push_message(_mk(P, f"a{i}", "a"))
                mgr.push_message(_mk(P, f"b{i}", "b", max_new_tokens=7))
            m = mgr.pop_message("normal")
            m.metadata["usage"] = {"prompt_tokens": 5000,
                                   "completion_tokens": 5000}
            mgr.complete_message(m)
            order = [x.id for x in _drain(mgr)]
            snap = mgr.fair_snapshot()
            mgr.stop()
            return order, snap
        j, _ = _both(run)
        assert j[1]["virtual_times"]["a"] > 9000

    def test_capped_tenant_does_not_pin_virtual_floor(self):
        def run(P):
            reg = P.ten.configure_tenancy(
                _cfg(P, tenants={"a": {"max_inflight": 1}}).tenancy)
            fair = P.ten.FairScheduler(reg, clock=P.clock.FakeClock())
            msgs, handles = {}, iter(range(1000))

            def push(mid, tenant):
                m, h = _mk(P, mid, tenant), next(handles)
                msgs[h] = m
                fair.on_push("normal", m, h)

            def serve():
                h = fair.select("normal")
                fair.note_pop(msgs[h])
                return msgs[h].id
            push("a1", "a")
            log = [serve()]
            push("a2", "a")
            for i in range(6):
                push(f"b{i}", "b")
            log += [serve() for _ in range(6)]
            push("c1", "c")
            return log, fair.virtual_times(), fair.snapshot()
        j, _ = _both(run)
        assert j[1]["c"] > j[1]["a"]

    def test_share_window_ages_out_on_the_manager_clock(self):
        def run(P):
            clock = P.clock.FakeClock()
            reg = P.ten.configure_tenancy(
                _cfg(P, tenants={"a": {"weight": 1.0}}).tenancy)
            fair = P.ten.FairScheduler(reg, clock=clock)
            msg = _mk(P, "s1", "a")
            fair.note_pop(msg)
            msg.metadata["usage"] = {"prompt_tokens": 5,
                                     "completion_tokens": 5}
            fair.note_finish(msg)
            first = fair.share_ratios()
            clock.advance(reg.share_window_s + 1.0)
            return first, fair.share_ratios()
        j, _ = _both(run)
        assert j == ({"a": 1.0}, {})

    def test_queue_stats_unaffected_by_fair_pops(self, queue_backend):
        def run(P):
            mgr = P.QM("acct", backend=queue_backend,
                       config=_cfg(P, tenants={"a": {"weight": 4.0}}))
            for i in range(6):
                mgr.push_message(_mk(P, f"a{i}", "a"))
                mgr.push_message(_mk(P, f"b{i}", "b"))
            ids = []
            for _ in range(8):
                m = mgr.pop_message("normal")
                ids.append(m.id)
                mgr.complete_message(m)
            s = mgr.get_stats("normal")
            mgr.stop()
            return ids, (s.pending_count, s.processing_count,
                         s.completed_count, s.wait_samples)
        j, _ = _both(run)
        assert j[1] == (4, 0, 8, 8)

    def test_seeded_random_scripts_pop_alike(self, queue_backend):
        """Random pushes, pops, completions, failures, requeues and
        removals over three weighted tenants, one capped: the same
        messages come out in the same order in both packages."""
        def run(P, seed):
            rng = random.Random(seed)
            clock = P.clock.FakeClock()
            mgr = P.QM("rand", backend=queue_backend, clock=clock,
                       config=_cfg(P, tenants={
                           "a": {"weight": 3.0}, "b": {"weight": 1.0},
                           "c": {"weight": 2.0, "max_inflight": 2}}))
            held, log, n = [], [], 0
            for _ in range(150):
                op = rng.random()
                clock.advance(rng.random())
                if op < 0.4:
                    mgr.push_message(_mk(
                        P, f"m{n}", rng.choice("abc"),
                        rng.choice(["high", "normal"]),
                        content="x" * rng.randint(0, 400),
                        max_new_tokens=rng.randint(1, 64)))
                    n += 1
                elif op < 0.7:
                    m = _try_pop(mgr, rng.choice(["high", "normal"]))
                    log.append(m and m.id)
                    if m is not None:
                        held.append(m)
                elif held:
                    m = held.pop(rng.randrange(len(held)))
                    kind = rng.random()
                    if kind < 0.6:
                        m.metadata["usage"] = {
                            "prompt_tokens": rng.randint(1, 100),
                            "completion_tokens": rng.randint(1, 64)}
                        mgr.complete_message(m)
                    elif kind < 0.8:
                        mgr.fail_message(m)
                    else:
                        mgr.requeue_message(m)
                    log.append((m.id, round(kind, 3)))
                elif n:
                    r = mgr.remove_message(f"m{rng.randrange(n)}")
                    log.append(r and r.id)
            snap = mgr.fair_snapshot()
            reg = P.ten.get_tenant_registry()
            out = (log, snap, reg.snapshot())
            mgr.stop()
            return out
        for seed in range(4):
            _both(run, seed)


# -- quotas -------------------------------------------------------------------

def _shed(P, shedder, msg, manager=None):
    try:
        shedder.admit(msg, manager, 0.0)
    except P.server.ApiError as e:
        return (e.status, round(e.retry_after, 9), e.message)
    return "admitted"


class TestQuota429:
    def _shedder(self, P, tenants, **default_kw):
        cfg = P.C.Config()
        cfg.tenancy = P.C.TenancyConfig(
            enabled=True, tenants=tenants,
            default=P.C.TenantClassConfig(**default_kw))
        reg = P.ten.configure_tenancy(cfg.tenancy)
        reg._clock = P.clock.FakeClock()    # retry times off a fixed clock
        return P.overload.OverloadShedder(
            P.C.OverloadConfig(), cfg.queue, tenant_registry=reg,
            enable_metrics=False), reg

    def test_rate_limit_429_with_retry_after(self):
        def run(P):
            shedder, reg = self._shedder(
                P, {"t": {"token_rate": 50.0, "burst_tokens": 100.0}})
            out = [_shed(P, shedder, _mk(P, f"q{i}", "t", content="x" * 400))
                   for i in range(3)]
            return out, shedder.shed_counts["tenant_quota"], \
                dict(reg.rejections_total)
        j, _ = _both(run)
        assert j[0][0] == "admitted" and j[0][1][0] == 429
        assert "tenant_quota" in j[0][1][2] and j[0][1][1] > 0

    def test_global_shed_does_not_drain_bucket(self):
        def run(P):
            shedder, reg = self._shedder(
                P, {"t": {"token_rate": 50.0, "burst_tokens": 100.0}})
            shedder.queue_depth_limit = 1
            deep = SimpleNamespace(total_pending=lambda: 50)
            out = [_shed(P, shedder, _mk(P, f"g{i}", "t", content="x" * 100),
                         deep) for i in range(5)]
            return out, reg.admit_tokens("t", 100, consume=False), \
                shedder.shed_counts["tenant_quota"]
        j, _ = _both(run)
        assert all("backlog" in o[2] for o in j[0]) and j[1][0]

    def test_queue_depth_429_and_other_tenants(self):
        def run(P):
            shedder, reg = self._shedder(P, {
                "t": {"max_queue_depth": 2},
                "noisy": {"token_rate": 1.0, "burst_tokens": 1.0}})
            reg.note_enqueued("t")
            out = [_shed(P, shedder, _mk(P, "q1", "t"))]
            reg.note_enqueued("t")
            out += [_shed(P, shedder, _mk(P, "q2", "t")),
                    _shed(P, shedder, _mk(P, "ok", "quiet")),
                    _shed(P, shedder, _mk(P, "n1", "noisy")),
                    _shed(P, shedder, _mk(P, "n2", "noisy"))]
            return out, dict(reg.rejections_total)
        j, _ = _both(run)
        assert j[0][1][0] == 429 and j[1] == {"queue_depth": 1, "rate": 1}

    def test_quota_enforced_when_overload_disabled(self):
        def run(P):
            cfg = _cfg(P, tenants={"t": {"token_rate": 10.0,
                                         "burst_tokens": 20.0}})
            cfg.overload.enabled = False
            shedder = P.overload.build_shedder(cfg)
            shedder.tenant_registry._clock = P.clock.FakeClock()
            deep = SimpleNamespace(total_pending=lambda: 10 ** 6)
            return [_shed(P, shedder, _mk(P, "ok", "quiet"), deep),
                    _shed(P, shedder, _mk(P, "d1", "t", content="x" * 100)),
                    _shed(P, shedder, _mk(P, "d2", "t", content="x" * 100))]
        j, _ = _both(run)
        assert j[2][0] == 429
        for P in BOTH:
            cfg = _cfg(P, enabled=False)
            cfg.overload.enabled = False
            assert P.overload.build_shedder(cfg) is None

    def test_disabled_registry_is_inert(self):
        def run(P):
            cfg = P.C.Config()
            reg = P.ten.configure_tenancy(cfg.tenancy)
            shedder = P.overload.OverloadShedder(
                P.C.OverloadConfig(), cfg.queue, tenant_registry=reg,
                enable_metrics=False)
            return _shed(P, shedder, _mk(P, "any", "t"))
        _both(run)

    def test_end_to_end_429_through_api(self):
        def run(P):
            cfg = _cfg(P, tenants={"noisy": {"token_rate": 10.0,
                                             "burst_tokens": 80.0}})
            factory = P.factory.QueueFactory(cfg)
            factory.create_queue_manager(
                "standard", P.factory.QueueType.STANDARD,
                start_background=False)
            api = P.server.ApiServer(cfg, queue_factory=factory)
            P.ten.get_tenant_registry()._clock = P.clock.FakeClock()
            body = json.dumps({"content": "y" * 400}).encode()
            hdr = {"x-tenant-id": "noisy"}
            s1, _, _ = api.dispatch("POST", "/api/v1/messages", body, hdr)
            s2, p2, _ = api.dispatch("POST", "/api/v1/messages", body, hdr)
            s3, snap, _ = api.dispatch("GET", "/api/v1/tenancy", b"")
            factory.stop_all()
            fair = snap["fair"]["standard"]
            return (s1, s2, round(p2["retry_after"], 9), p2["error"], s3,
                    sorted(snap), snap["tenants"], snap["rejections"],
                    sorted(fair), fair["backlog"], fair["served_tokens"])
        j, _ = _both(run)
        assert j[:2] == (202, 429) and j[7] == {"rate": 1}

    def test_tenancy_route_503_while_disabled(self):
        def run(P):
            api = P.server.ApiServer(P.C.Config())
            status, payload, _ = api.dispatch("GET", "/api/v1/tenancy", b"")
            return status, payload
        j, _ = _both(run)
        assert j[0] == 503


# -- engine decode fairness and the prefill pack ------------------------------

def _echo_engine(P, **kw):
    tok = P.tok.ByteTokenizer()
    ex = P.executor.EchoExecutor(batch_size=4, page_size=8, num_pages=256,
                                 max_pages_per_seq=16, eos_id=tok.eos_id,
                                 chunk_size=8)
    return P.engine.InferenceEngine(ex, tok, name="tenancy-echo",
                                    enable_metrics=False,
                                    max_decode_steps=32, **kw)


def _rows(spec):
    rows, budgets = [], {}
    for i, (tenant, budget) in enumerate(spec):
        rows.append(SimpleNamespace(slot=i, order=i,
                                    req=SimpleNamespace(tenant_id=tenant)))
        budgets[i] = budget
    return rows, budgets


class TestEngineDecodeFairness:
    def _fair(self, P, weights, spec):
        P.ten.configure_tenancy(P.C.TenancyConfig(
            enabled=True, tenants={t: {"weight": w}
                                   for t, w in weights.items()}))
        eng = _echo_engine(P)
        rows, budgets = _rows(spec)
        eng._apply_decode_fairness(rows, budgets)
        eng.stop()
        return budgets

    @pytest.mark.parametrize("weights,spec", [
        ({"a": 1.0, "b": 1.0}, [("a", 8), ("a", 8), ("a", 8)]),
        ({"a": 1.0, "b": 1.0}, [("a", 8), ("a", 8), ("a", 8), ("b", 8)]),
        ({"a": 3.0, "b": 1.0}, [("a", 8), ("a", 8), ("b", 8), ("b", 8)]),
        ({"a": 1.0, "b": 1000.0}, [("a", 8), ("a", 8), ("b", 8)]),
        ({"gold": 4.0, "bronze": 1.0}, [("gold", 16)] * 4 + [("bronze", 16)] * 4),
        ({"a": 1.0, "b": 1.0}, [("a", 0), ("b", 5), ("a", 1)])])
    def test_caps_equal_jaxs(self, weights, spec):
        j, _ = _both(self._fair, weights, spec)
        for (tenant, b0), b in zip(spec, j.values()):
            assert b <= b0 and (b >= 1 or b0 == 0)

    def test_seeded_random_rows(self):
        rng = random.Random(5)
        for _ in range(200):
            tenants = {f"t{i}": rng.choice([0.5, 1.0, 2.0, 4.0, 9.0])
                       for i in range(rng.randint(1, 4))}
            spec = [(rng.choice(sorted(tenants)), rng.randint(0, 16))
                    for _ in range(rng.randint(1, 8))]
            j, _ = _both(self._fair, tenants, spec)
            for (tenant, b0), b in zip(spec, j.values()):
                assert b <= b0 and (b >= 1 or b0 == 0)

    @staticmethod
    def _cand(order, tenant, todo):
        return SimpleNamespace(order=order,
                               req=SimpleNamespace(tenant_id=tenant),
                               todo_ids=list(range(todo)))

    def _plan(self, P, cands, S, T, budget, caps):
        plan = P.engine._pack_prefill_slices(
            [self._cand(*c) for c in cands], S, T, budget, caps)
        return [(s.order, s.req.tenant_id, list(sl)) for s, sl in plan]

    @pytest.mark.parametrize("cands,S,T,budget,caps,want", [
        ([(0, "a", 10), (1, "b", 800)], 4, 512, 512, {"a": 256, "b": 256},
         {"a": 10, "b": 502}),
        ([(0, "a", 800), (1, "b", 800)], 4, 512, 512, {"a": 256, "b": 256},
         {"a": 256, "b": 256}),
        ([(0, "g", 1500), (1, "b", 1500)], 2, 128, 128,
         {"g": 102, "b": 26}, {"g": 102, "b": 26}),
        ([(0, "g", 1500), (1, "b", 1500)], 2, 64, 128,
         {"g": 102, "b": 26}, {"g": 64, "b": 64}),
        ([(i, "a", 300) for i in range(4)], 2, 256, 400, None, None)])
    def test_pack_plans_equal_jaxs(self, cands, S, T, budget, caps, want):
        j, _ = _both(self._plan, cands, S, T, budget, caps)
        if want is not None:
            got = {}
            for _, tid, sl in j:
                got[tid] = got.get(tid, 0) + len(sl)
            assert got == want
        else:
            assert [(o, len(sl)) for o, _, sl in j] == [(0, 256), (1, 144)]

    def test_seeded_random_packs(self):
        rng = random.Random(11)
        for _ in range(300):
            tenants = ["a", "b", "c"][:rng.randint(1, 3)]
            cands = [(i, rng.choice(tenants), rng.randint(1, 300))
                     for i in range(rng.randint(1, 6))]
            S, T = rng.randint(1, 4), rng.choice([8, 16, 64, 128])
            budget = rng.randint(8, 256)
            caps = (None if rng.random() < 0.3 else
                    {t: rng.randint(1, budget) for t in tenants})
            j, _ = _both(self._plan, cands, S, T, budget, caps)
            assert len(j) <= S and sum(len(sl) for *_, sl in j) <= budget

    def test_two_tenant_echo_run_with_tenancy_off(self):
        def run(P):
            eng = _echo_engine(P)
            assert not eng._tenancy.enabled
            eng.start()
            try:
                hs = [eng.submit(P.engine.GenRequest(
                    id=f"r{i}", prompt=f"hi {i}", max_new_tokens=6,
                    tenant_id="a" if i % 2 else "b")) for i in range(6)]
                for h in hs:
                    assert h.wait(10.0)
                return [(h.result.tokens, h.result.finish_reason) for h in hs]
            finally:
                eng.stop()
        _both(run)


# -- convergence, durability --------------------------------------------------

class TestConvergenceEcho:
    def test_token_share_converges_to_weights(self, queue_backend):
        def run(P):
            mgr = P.QM("conv", backend=queue_backend, config=_cfg(
                P, tenants={"a": {"weight": 4.0}, "b": {"weight": 1.0}}))
            tok = P.tok.ByteTokenizer()
            ex = P.executor.EchoExecutor(
                batch_size=8, page_size=8, num_pages=512,
                max_pages_per_seq=16, eos_id=tok.eos_id, chunk_size=8)
            eng = P.engine.InferenceEngine(ex, tok, name="conv-echo",
                                           enable_metrics=False,
                                           max_decode_steps=16)
            eng.start()
            order = []
            try:
                n = 60
                for i in range(n):
                    for t in "ab":
                        mgr.push_message(_mk(P, f"{t}{i}", t,
                                             content=f"hello {t}",
                                             max_new_tokens=8))
                while len(order) < n:
                    m = _try_pop(mgr, "normal")
                    if m is None:
                        break
                    eng.process_fn(None, m)
                    mgr.complete_message(m)
                    order.append(m.id)
                return order, dict(mgr._fair.served_tokens)
            finally:
                eng.stop()
                mgr.stop()
        j, _ = _both(run)
        tokens = j[1]
        assert 4 * 0.6 <= tokens["a"] / tokens["b"] <= 4 * 1.6


class TestTenantDurability:
    def test_tenant_survives_wal_recovery_with_fairness(self, tmp_path):
        def run(P):
            wal = str(tmp_path / f"{P.pkg}.wal")
            cfg = _cfg(P, tenants={"a": {"weight": 4.0},
                                   "b": {"weight": 1.0}})
            mgr = P.QM("wal", config=cfg, wal_path=wal)
            for i in range(10):
                mgr.push_message(_mk(P, f"a{i}", "a"))
                mgr.push_message(_mk(P, f"b{i}", "b"))
            mgr.stop()
            mgr2 = P.QM("wal", config=cfg, wal_path=wal)
            out = [(m.id, m.tenant_id) for m in _drain(mgr2)]
            mgr2.stop()
            return out
        j, _ = _both(run)
        head = [t for _, t in j[:10]]
        assert len(j) == 20 and head.count("a") > head.count("b")

    def test_journal_of_one_package_restores_in_the_other(self, tmp_path):
        """A journal JAX's manager wrote restores into the port's fair
        index in JAX's own restored order."""
        wal = str(tmp_path / "shared.wal")
        cfg = _cfg(J, tenants={"a": {"weight": 4.0}, "b": {"weight": 1.0}})
        mgr = J.QM("wal", config=cfg, wal_path=wal)
        for i in range(6):
            mgr.push_message(_mk(J, f"a{i}", "a"))
            mgr.push_message(_mk(J, f"b{i}", "b"))
        mgr.stop()
        import shutil
        shutil.copy(wal, wal + ".copy")
        orders = []
        for P, path in ((J, wal), (T, wal + ".copy")):
            P.ten.reset_tenancy()
            cfgp = _cfg(P, tenants={"a": {"weight": 4.0},
                                    "b": {"weight": 1.0}})
            m2 = P.QM("wal", config=cfgp, wal_path=path)
            orders.append([m.id for m in _drain(m2)])
            m2.stop()
        assert orders[0] == orders[1] and len(orders[0]) == 12

    def test_tenant_survives_spool_roundtrip(self, tmp_path):
        def run(P):
            sd = str(tmp_path / f"spool-{P.pkg}")
            P.spool.SpoolProducer(sd).push(_mk(P, "s1", "acme-corp"),
                                           queue_name="normal")
            got = []
            P.spool.SpoolConsumer(sd, lambda q, m: got.append(
                (q, m.id, m.tenant_id))).run_once()
            return got
        j, _ = _both(run)
        assert j == [("normal", "s1", "acme-corp")]


# -- metrics ------------------------------------------------------------------

def _tenant_samples(P):
    from prometheus_client.parser import text_string_to_metric_families
    out = {}
    text = P.metrics.exposition().decode()
    for fam in text_string_to_metric_families(text):
        if not fam.name.startswith("llm_queue_tenant_"):
            continue
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


@pytest.mark.usefixtures("jax_tenancy_metrics")
class TestTenancyMetrics:
    def test_families_flush_alike(self):
        """One scenario per package, each scraped before and after: the
        tenancy samples move by the same amounts, and series of tenants
        that left are removed."""
        def run(P):
            P.usage.reset_usage()
            before = _tenant_samples(P)
            cfg = _cfg(P, tenants={"acme": {"weight": 4.0,
                                            "max_inflight": 1}})
            mgr = P.QM("met", config=cfg, backend="python",
                       clock=P.clock.FakeClock())
            mgr.push_message(_mk(P, "m1", "acme", max_new_tokens=16))
            mgr.push_message(_mk(P, "m2", "acme"))
            mgr.push_message(_mk(P, "d1", "transient"))
            mgr.push_message(_mk(P, "sp", "0123456789abcdef" * 2))
            m = mgr.pop_message("normal")
            t = mgr.pop_message("normal")
            mid = _tenant_samples(P)
            m.metadata["usage"] = {"prompt_tokens": 10,
                                   "completion_tokens": 16}
            mgr.complete_message(m)
            mgr.complete_message(t)
            after = _tenant_samples(P)
            mgr.stop()

            def delta(a, b):
                return {k: round(v - b.get(k, 0.0), 6) for k, v in a.items()
                        if v != b.get(k, 0.0) or k not in b}
            return delta(mid, before), delta(after, before), \
                sorted(k for k in before if k not in after)
        j, _ = _both(run)
        mid, after, _ = j
        assert (("llm_queue_tenant_inflight", (("tenant", "transient"),))
                in mid)
        assert (("llm_queue_tenant_inflight", (("tenant", "transient"),))
                not in after)
        assert not any("0123456789abcdef" in str(k) for k in after)


# -- stream parity on TorchExecutor -------------------------------------------

KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512)
MIXED_GEOM = dict(batch_size=4, page_size=16, num_pages=160,
                  prefill_buckets=[16, 64], eos_id=2, chunk_size=4,
                  mixed_prefill_slices=2, mixed_slice_tokens=16,
                  ragged_token_capacity=32, ragged_max_slices=2)
WAVE = [("gold", "gold decoder, a prompt that runs for a while " * 2),
        ("bronze", "bronze decoder with text"),
        ("gold", "gold again, long enough to slice " * 4),
        ("bronze", "bronze long prompt for the capped pack " * 4),
        ("gold", "short gold"),
        ("bronze", "x" * 120)]


def _tenant_stream_run(P, model, ragged: bool):
    """One engine of package ``P`` with tenancy on (gold 4, bronze 1):
    arrivals while others decode; returns streams, the chunk budgets
    after fairness and the pack plans."""
    P.ten.configure_tenancy(P.C.TenancyConfig(
        enabled=True, tenants={"gold": {"weight": 4.0},
                               "bronze": {"weight": 1.0}}))
    mixed = P.C.MixedBatchConfig(enabled=True, prefill_token_budget=32,
                                 max_slices=2)
    eng = P.engine.InferenceEngine(model(ragged), P.tok.ByteTokenizer(),
                                   enable_metrics=False, max_decode_steps=16,
                                   mixed_batch=mixed)
    budgets, plans = [], []
    orig_fair = eng._apply_decode_fairness

    def fair(rows, b):
        before = dict(b)
        orig_fair(rows, b)
        budgets.append(sorted(
            (s.order, s.req.tenant_id, before[s.order], b[s.order])
            for s in rows if s.order in b))
    eng._apply_decode_fairness = fair
    orig_pack = P.engine._pack_prefill_slices

    def pack(cands, S, T, budget, caps):
        def ids(plan):
            return [(s.req.id, s.req.tenant_id, len(sl)) for s, sl in plan]
        plan = orig_pack(cands, S, T, budget, caps)
        plans.append((caps, ids(plan),
                      ids(orig_pack(cands, S, T, budget, None))))
        return plan
    P.engine._pack_prefill_slices = pack
    try:
        hs = {}
        for i, (tenant, text) in enumerate(WAVE):
            hs[f"w{i}"] = eng.submit(P.engine.GenRequest(
                id=f"w{i}", prompt=text, max_new_tokens=12,
                tenant_id=tenant))
            eng.step()
        eng.run_until_idle()
    finally:
        P.engine._pack_prefill_slices = orig_pack
    return ({k: (h.result.tokens, h.result.finish_reason)
             for k, h in hs.items()}, budgets, plans)


@pytest.mark.parametrize("mode", ["bucket", "ragged"])
def test_two_tenant_streams_equal_jaxs(mode):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from llmq_tpu.engine.executor import JaxExecutor
    from llmq_tpu.models import llama as JL
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.models import llama as TL

    jcfg = JL.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = JL.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = TL.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = TL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    ragged = mode == "ragged"
    models = {J.pkg: lambda r: JaxExecutor(jcfg, jparams, ragged_attention=r,
                                           **MIXED_GEOM),
              T.pkg: lambda r: TorchExecutor(tcfg, tparams, device="cpu",
                                             ragged_attention=r,
                                             **MIXED_GEOM)}
    j, t = _both(lambda P: _tenant_stream_run(P, models[P.pkg], ragged))
    streams, budgets, plans = j
    assert all(r in ("eos", "length") for _, r in streams.values())
    # Both tenants shared a decode chunk, and fairness cut a budget there
    # (never below 1).
    assert any(len({t for _, t, _, _ in b}) > 1 for b in budgets)
    assert any(post < pre for b in budgets for _, _, pre, post in b)
    assert all(post >= 1 for b in budgets for _, _, pre, post in b if pre)
    # A capped step packed both tenants. With one packed capacity
    # (ragged) the caps change the plan (gold 26 + bronze 6 where the
    # uncapped pack gives gold all 32); with S slices of T tokens
    # (bucket) pass 2 widens every slice back to T, as in JAX.
    assert any(caps and len({t for _, t, _ in plan}) > 1
               for caps, plan, _ in plans)
    changed = [(caps, plan, free) for caps, plan, free in plans
               if plan != free]
    assert bool(changed) == ragged, changed
