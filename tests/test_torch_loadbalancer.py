"""The port's endpoint selection against the JAX package's, side by side
on fake clocks: every scenario runs over a namespace of either package's
classes, and the two traces must be equal (tolerance: none, unless a
case says otherwise).

Mirrors ``tests/test_load_balancer.py`` case for case: the four
strategies (round robin with a cursor per model type, least connections,
weighted random from a seeded stream, adaptive load's score with its
exploration), health filtering and connection headroom, the probe's
state machine, add and remove, session affinity with its TTL, and the
release's response-time EWMA and error decay. Seeded selection consumes
the random stream as JAX's does, so the picks are the same endpoints."""

from __future__ import annotations

import random
import types

import pytest

from llmq_tpu.core import config as JC
from llmq_tpu.core import errors as jerrors
from llmq_tpu.core import types as jtypes
from llmq_tpu.core.clock import FakeClock
from llmq_tpu.loadbalancer import load_balancer as jlb

from llmq_tpu_torch.core import config as TC
from llmq_tpu_torch.core import errors as terrors
from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.loadbalancer import load_balancer as tlb

JAX = types.SimpleNamespace(name="jax", lb=jlb, C=JC, errors=jerrors,
                            Message=jtypes.Message)
PORT = types.SimpleNamespace(name="port", lb=tlb, C=TC, errors=terrors,
                             Message=ttypes.Message)


def _both(scenario):
    """The scenario's trace in each package, each on a fresh fake clock;
    they must be equal."""
    j = scenario(JAX, FakeClock())
    t = scenario(PORT, FakeClock())
    assert t == j
    return t


def make_lb(P, strategy="round_robin", clock=None, probe=None, seed=7,
            session_affinity=True):
    cfg = P.C.LoadBalancerConfig(strategy=strategy, health_check_interval=0,
                                 session_affinity=session_affinity)
    return P.lb.LoadBalancer(cfg, clock=clock, probe=probe,
                             rng=random.Random(seed))


def eps(P, n, **kw):
    return [P.lb.Endpoint(id=f"e{i}", url=f"local://e{i}", **kw)
            for i in range(n)]


class TestRoundRobin:
    def test_fairness(self):
        def run(P, clock):
            lb = make_lb(P, "round_robin", clock)
            for e in eps(P, 3):
                lb.add_endpoint(e)
            return [lb.get_endpoint().id for _ in range(9)]

        picks = _both(run)
        assert picks.count("e0") == picks.count("e1") == picks.count("e2") == 3

    def test_per_type_cursor(self):
        def run(P, clock):
            lb = make_lb(P, "round_robin", clock)
            lb.add_endpoint(P.lb.Endpoint(id="a0", model_type="llm"))
            lb.add_endpoint(P.lb.Endpoint(id="a1", model_type="llm"))
            lb.add_endpoint(P.lb.Endpoint(id="b0", model_type="embed"))
            m = P.Message(metadata={"model_type": "embed"})
            return [lb.get_endpoint(m).id, lb.get_endpoint().id,
                    lb.get_endpoint(m).id, lb.get_endpoint().id]

        assert _both(run) == ["b0", "a0", "b0", "a1"]


class TestLeastConnections:
    def test_picks_least_busy(self):
        def run(P, clock):
            lb = make_lb(P, "least_connections", clock)
            for e in eps(P, 3):
                lb.add_endpoint(e)
            for eid, n in (("e0", 5), ("e1", 1), ("e2", 3)):
                lb.get_endpoint_by_id(eid).connections = n
            return [lb.get_endpoint().id for _ in range(4)]

        # e1 books each pick (1 → 4 connections); then e2, at 3, wins.
        assert _both(run) == ["e1", "e1", "e1", "e2"]


class TestWeightedRandom:
    def test_distribution(self):
        """Tolerance: the same 1000 picks in both packages from one seed;
        the heavy endpoint's share within (0.8, 0.98)."""
        def run(P, clock):
            lb = make_lb(P, "weighted_random", clock, session_affinity=False)
            lb.add_endpoint(P.lb.Endpoint(id="heavy", weight=9.0))
            lb.add_endpoint(P.lb.Endpoint(id="light", weight=1.0))
            picks = []
            for _ in range(1000):
                ep = lb.get_endpoint()
                picks.append(ep.id)
                lb.release_endpoint(ep.id)
            return picks

        picks = _both(run)
        assert 0.8 < picks.count("heavy") / 1000 < 0.98

    def test_zero_weights_choose_uniformly(self):
        def run(P, clock):
            lb = make_lb(P, "weighted_random", clock, seed=3)
            for e in eps(P, 3, weight=0.0):
                lb.add_endpoint(e)
            return [lb.get_endpoint().id for _ in range(30)]

        assert len(set(_both(run))) == 3


class TestAdaptive:
    def test_picks_best_scored(self):
        def run(P, clock):
            lb = make_lb(P, "adaptive_load", clock, seed=1)
            lb.add_endpoint(P.lb.Endpoint(id="bad", response_time=2.0,
                                          error_rate=0.5))
            lb.add_endpoint(P.lb.Endpoint(id="good", response_time=0.1,
                                          error_rate=0.0))
            return [lb.get_endpoint().id for _ in range(50)]

        picks = _both(run)
        assert picks.count("good") >= 40      # 10% exploration allowed
        assert "bad" in picks                 # the exploration happened


class TestHealthFiltering:
    def test_unhealthy_excluded(self):
        def run(P, clock):
            lb = make_lb(P, "round_robin", clock)
            for e in eps(P, 2):
                lb.add_endpoint(e)
            lb.set_endpoint_status("e0", P.lb.EndpointStatus.UNHEALTHY)
            return [lb.get_endpoint().id for _ in range(5)]

        assert _both(run) == ["e1"] * 5

    def test_degraded_still_selectable(self):
        def run(P, clock):
            lb = make_lb(P, "round_robin", clock)
            lb.add_endpoint(P.lb.Endpoint(
                id="e0", status=P.lb.EndpointStatus.DEGRADED))
            return lb.get_endpoint().id

        assert _both(run) == "e0"

    def test_no_endpoint_raises(self):
        def run(P, clock):
            lb = make_lb(P, clock=clock)
            with pytest.raises(P.errors.NoEndpointError) as e:
                lb.get_endpoint()
            return str(e.value)

        assert "llm" in _both(run)

    def test_max_connections_respected(self):
        def run(P, clock):
            lb = make_lb(P, "round_robin", clock)
            lb.add_endpoint(P.lb.Endpoint(id="e0", max_connections=1))
            lb.get_endpoint()
            with pytest.raises(P.errors.NoEndpointError):
                lb.get_endpoint()
            lb.release_endpoint("e0")
            return lb.get_endpoint().id

        assert _both(run) == "e0"

    def test_draining_and_exclude_skip(self):
        def run(P, clock):
            lb = make_lb(P, "round_robin", clock)
            for e in eps(P, 3):
                lb.add_endpoint(e)
            lb.set_draining("e1")
            out = [lb.get_endpoint(exclude={"e0"}).id for _ in range(3)]
            out.append(lb.acquire_endpoint("e1"))
            out.append(lb.acquire_endpoint("e0").id)
            return out

        assert _both(run) == ["e2", "e2", "e2", None, "e0"]


class TestHealthProbe:
    def test_state_machine(self):
        def run(P, clock):
            health = {"ok": True}
            lb = make_lb(P, clock=clock, probe=lambda ep: health["ok"])
            lb.add_endpoint(P.lb.Endpoint(id="e0"))
            out = []
            for ok in (False, False, False, True, True, True, True):
                health["ok"] = ok
                lb.check_health_once()
                out.append(lb.get_endpoint_by_id("e0").status.value)
            return out

        assert _both(run) == ["degraded", "degraded", "unhealthy",
                              "unhealthy", "degraded", "degraded", "healthy"]

    def test_probe_crash_counts_as_failure(self):
        def run(P, clock):
            def bad_probe(ep):
                raise RuntimeError("probe broke")
            lb = make_lb(P, clock=clock, probe=bad_probe)
            lb.add_endpoint(P.lb.Endpoint(id="e0"))
            lb.check_health_once()
            return lb.get_endpoint_by_id("e0").status.value

        assert _both(run) == "degraded"


class TestAddRemove:
    def test_add_remove(self):
        def run(P, clock):
            lb = make_lb(P, clock=clock)
            lb.add_endpoint(P.lb.Endpoint(id="e0"))
            return (lb.remove_endpoint("e0"), lb.remove_endpoint("e0"),
                    lb.endpoints())

        assert _both(run) == (True, False, [])

    def test_remove_clears_sessions(self):
        def run(P, clock):
            lb = make_lb(P, clock=clock)
            lb.add_endpoint(P.lb.Endpoint(id="e0"))
            had = lb.get_endpoint(session_id="s1").id
            held = lb.get_stats()["active_sessions"]
            lb.remove_endpoint("e0")
            return had, held, lb.get_stats()["active_sessions"]

        assert _both(run) == ("e0", 1, 0)


class TestSessionAffinity:
    def test_sticky(self):
        def run(P, clock):
            lb = make_lb(P, "round_robin", clock)
            for e in eps(P, 3):
                lb.add_endpoint(e)
            return [lb.get_endpoint(session_id="conv-1").id
                    for _ in range(6)] + [lb.get_endpoint().id]

        out = _both(run)
        assert len(set(out[:6])) == 1

    def test_ttl_expiry(self):
        def run(P, clock):
            lb = make_lb(P, "round_robin", clock)
            lb.config.session_ttl = 10.0
            for e in eps(P, 2):
                lb.add_endpoint(e)
            lb.get_endpoint(session_id="s")
            clock.advance(5.0)
            refreshed = lb.get_endpoint(session_id="s").id
            clock.advance(9.0)          # 14 s after the first, 9 after
            # Still held: round robin alone would pick e1 here.
            alive = lb.get_endpoint(session_id="s").id
            clock.advance(11.0)
            return (refreshed, alive, lb.cleanup_sessions(),
                    lb.get_stats()["active_sessions"],
                    lb.get_endpoint(session_id="s").id)

        assert _both(run) == ("e0", "e0", 1, 0, "e1")

    def test_affinity_skips_unhealthy(self):
        def run(P, clock):
            lb = make_lb(P, "round_robin", clock)
            for e in eps(P, 2):
                lb.add_endpoint(e)
            first = lb.get_endpoint(session_id="s").id
            lb.set_endpoint_status(first, P.lb.EndpointStatus.UNHEALTHY)
            other = lb.get_endpoint(session_id="s").id
            return first, other, lb.get_endpoint(session_id="s").id

        first, other, held = _both(run)
        assert other != first and held == other

    def test_affinity_off_holds_no_session(self):
        def run(P, clock):
            lb = make_lb(P, "round_robin", clock, session_affinity=False)
            for e in eps(P, 2):
                lb.add_endpoint(e)
            picks = [lb.get_endpoint(session_id="s").id for _ in range(4)]
            return picks, lb.get_stats()["active_sessions"]

        assert _both(run) == (["e0", "e1", "e0", "e1"], 0)


class TestRelease:
    def test_ewma_and_error_decay(self):
        """Tolerance: 1e-12 on the EWMA and the error rate (the same
        float arithmetic in both packages)."""
        def run(P, clock):
            lb = make_lb(P, clock=clock)
            lb.add_endpoint(P.lb.Endpoint(id="e0"))
            out = []
            for rt, err in ((1.0, False), (2.0, False), (0.0, True),
                            (0.0, False)):
                lb.get_endpoint()
                lb.release_endpoint("e0", response_time=rt, is_error=err)
                ep = lb.get_endpoint_by_id("e0")
                out.append((ep.response_time, ep.error_rate,
                            ep.total_errors, ep.connections))
            lb.release_endpoint("nope")          # unknown: ignored
            return out, lb.get_stats()

        out, stats = _both(run)
        assert out[0][0] == 1.0
        assert out[1][0] == pytest.approx(1.1, abs=1e-12)
        assert out[2][1] == pytest.approx(0.1, abs=1e-12)
        assert out[3][1] == pytest.approx(0.095, abs=1e-12)
        assert out[3][3] == 0 and stats["endpoints"][0]["total_requests"] == 4
