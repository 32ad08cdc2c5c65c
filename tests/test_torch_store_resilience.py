"""The port's store fault domain against the JAX package's, on the CPU:
``conversation/resilience.py`` (deadlines, seeded retry, the store's
breaker and timeout-degraded rung, the chaos points inside the worker),
``loadbalancer/circuit_breaker.py``, and the consumers' degraded rungs,
each scenario run through both packages in one process on the same
seeds and held to the same outcome.

Mirrors ``tests/test_store_resilience.py``: the wrapper's units, the
breaker and its ladder, the chaos points, the state manager's cache-only
reads and replay buffer, the tiering plane's gate, sqlite's bounded
locked-retry, the WAL's 503 rung, ``/health``'s ``store`` block and the
metric families, and the store blackout acceptance (tiering and the
state manager over one wrapped store, the async pipeline on; on the echo
engine, and on the port's engine over a tiny f32 model whose turn in the
store tier recomputes token for token as JAX's). The breaker's own unit
cases are here too. The KV exchange's degraded rung (a publish skipped
while the store is degraded, a claim bounded by the deadline or its
TTL, each a recompute) is ``TestExchangeDegraded``, and the echo
acceptance carries the exchange leg. The state manager registers
``state`` and ``placement`` in both packages."""

from __future__ import annotations

import json
import sqlite3
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu import chaos as jchaos  # noqa: E402
from llmq_tpu.api.server import ApiServer as JApiServer  # noqa: E402
from llmq_tpu.conversation import persistence as jpers  # noqa: E402
from llmq_tpu.conversation import resilience as jres  # noqa: E402
from llmq_tpu.conversation.state_manager import StateManager as JSM  # noqa: E402
from llmq_tpu.core import clock as jclock  # noqa: E402
from llmq_tpu.core import config as JC  # noqa: E402
from llmq_tpu.core import errors as jerrors  # noqa: E402
from llmq_tpu.core import types as jtypes  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import EchoExecutor as JEcho  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.loadbalancer import circuit_breaker as jcb  # noqa: E402
from llmq_tpu.metrics import registry as jreg  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.queueing import factory as jfactory  # noqa: E402
from llmq_tpu.queueing import queue_manager as jqm  # noqa: E402
from llmq_tpu.tiering import KVTieringPlane as JPlane  # noqa: E402
from llmq_tpu.disagg import KVExchange as JExchange  # noqa: E402

from llmq_tpu_torch import chaos as tchaos  # noqa: E402
from llmq_tpu_torch.api.server import ApiServer as TApiServer  # noqa: E402
from llmq_tpu_torch.conversation import persistence as tpers  # noqa: E402
from llmq_tpu_torch.conversation import resilience as tres  # noqa: E402
from llmq_tpu_torch.conversation.state_manager import StateManager as TSM  # noqa: E402
from llmq_tpu_torch.core import clock as tclock  # noqa: E402
from llmq_tpu_torch.core import config as TC  # noqa: E402
from llmq_tpu_torch.core import errors as terrors  # noqa: E402
from llmq_tpu_torch.core import types as ttypes  # noqa: E402
from llmq_tpu_torch.engine.engine import GenRequest as TGenRequest  # noqa: E402
from llmq_tpu_torch.engine.engine import InferenceEngine as TEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import EchoExecutor as TEcho  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer as TTok  # noqa: E402
from llmq_tpu_torch.loadbalancer import circuit_breaker as tcb  # noqa: E402
from llmq_tpu_torch.metrics import registry as treg  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.queueing import factory as tfactory  # noqa: E402
from llmq_tpu_torch.queueing import queue_manager as tqm  # noqa: E402
from llmq_tpu_torch.tiering import KVTieringPlane as TPlane  # noqa: E402
from llmq_tpu_torch.disagg import KVExchange as TExchange  # noqa: E402

torch.set_num_threads(1)

pytestmark = [
    pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning"),
]

JAX = types.SimpleNamespace(
    name="jax", chaos=jchaos, C=JC, config=JC.default_config, res=jres,
    pers=jpers, SM=JSM, FakeClock=jclock.FakeClock, errors=jerrors,
    types=jtypes, Engine=JEngine, Echo=JEcho, Tok=JTok,
    GenRequest=JGenRequest, cb=jcb, Plane=JPlane, ApiServer=JApiServer,
    QueueFactory=jfactory.QueueFactory, QueueType=jfactory.QueueType,
    QueueManager=jqm.QueueManager, Exchange=JExchange)
PORT = types.SimpleNamespace(
    name="port", chaos=tchaos, C=TC, config=TC.Config, res=tres,
    pers=tpers, SM=TSM, FakeClock=tclock.FakeClock, errors=terrors,
    types=ttypes, Engine=TEngine, Echo=TEcho, Tok=TTok,
    GenRequest=TGenRequest, cb=tcb, Plane=TPlane, ApiServer=TApiServer,
    QueueFactory=tfactory.QueueFactory, QueueType=tfactory.QueueType,
    QueueManager=tqm.QueueManager, Exchange=TExchange)
PKGS = (JAX, PORT)
BOTH = pytest.mark.parametrize("P", PKGS, ids=lambda P: P.name)


@pytest.fixture(autouse=True)
def _chaos_reset():
    yield
    jchaos.configure(None)
    tchaos.configure(None)


def _arm(P, seed: int, *rules):
    inj = P.chaos.configure(P.C.ChaosConfig(enabled=True, seed=seed))
    for r in rules:
        inj.add_rule(**r)
    return inj


def wait_until(fn, timeout=5.0, step=0.002):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if fn():
            return True
        time.sleep(step)
    return False


def _rcfg(P, **kw):
    """A tight deadline, a jitter-free breaker, sub-second windows."""
    breaker = kw.pop("breaker", None) or P.C.BreakerConfig(
        enabled=True, failure_threshold=3, base_backoff=5.0,
        max_backoff=20.0, jitter=0.0)
    base = dict(enabled=True, op_timeout_s=0.05, retries=2,
                retry_base_backoff_s=0.001, retry_max_backoff_s=0.005,
                retry_jitter=0.2, timeout_threshold=2,
                probe_interval_s=10.0, seed=7)
    base.update(kw)
    return P.C.StoreResilienceConfig(breaker=breaker, **base)


class ScriptedStore:
    """A store in front of ``P``'s InMemoryStore whose next ``fail_times``
    ops raise ``fail_with(...)`` and whose every op sleeps ``sleep_s``
    first: a scripted dead or slow backend."""

    def __init__(self, P):
        self.raw = P.pers.InMemoryStore()
        self.fail_with = ConnectionError
        self.fail_times = 0
        self.sleep_s = 0.0
        self.calls = []

    def _gate(self, name):
        self.calls.append(name)
        if self.sleep_s:
            time.sleep(self.sleep_s)
        if self.fail_times > 0:
            self.fail_times -= 1
            raise self.fail_with(f"scripted {name} fault")

    def save(self, conv):
        self._gate("save")
        self.raw.save(conv)

    def load(self, cid):
        self._gate("load")
        return self.raw.load(cid)

    def list_user(self, uid):
        self._gate("list_user")
        return self.raw.list_user(uid)

    def delete(self, cid):
        self._gate("delete")
        self.raw.delete(cid)

    def save_kv(self, cid, blob):
        self._gate("save_kv")
        self.raw.save_kv(cid, blob)

    def load_kv(self, cid):
        self._gate("load_kv")
        return self.raw.load_kv(cid)

    def delete_kv(self, cid):
        self._gate("delete_kv")
        self.raw.delete_kv(cid)

    def list_kv(self):
        self._gate("list_kv")
        return self.raw.list_kv()

    def close(self):
        self.raw.close()


def _conv(P, cid="c1", uid="u1"):
    return P.types.Conversation(id=cid, user_id=uid, created_at=1.0,
                                updated_at=1.0, last_active_at=1.0)


def _trip(store, inner, n=3):
    inner.fail_times = n
    for _ in range(n):
        with pytest.raises(ConnectionError):
            store.load_kv("x")
    assert store.degraded


def _same(fn):
    """Run ``fn(P)`` for both packages and hold the port's result to
    JAX's."""
    got = {P.name: fn(P) for P in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


# -- the circuit breaker -------------------------------------------------------


def _breaker_script(P, jitter):
    fk = P.FakeClock()
    br = P.cb.CircuitBreaker("ep", failure_threshold=2, base_backoff=1.0,
                             max_backoff=4.0, jitter=jitter, clock=fk)
    log = []

    def snap(tag):
        st = br.get_stats()
        log.append((tag, st["state"], st["consecutive_failures"],
                    st["trips"], round(st["retry_in"], 9), br.blocked()))

    snap("start")
    for _ in range(2):
        br.record_failure()
    snap("tripped")
    log.append(("allow-open", br.allow()))
    fk.advance(br.retry_in() + 0.01)
    log.append(("probe", br.allow(), br.allow()))     # one probe a window
    br.record_timeout()                               # gives the slot back
    log.append(("reprobe", br.allow()))
    br.record_failure()                               # probe failed
    snap("reopened")                                  # backoff doubled
    fk.advance(br.retry_in() + 0.01)
    br.allow()
    br.record_success()
    snap("closed")
    br.record_failure()
    br.record_probe_success()                         # clears the streak
    br.record_failure()
    snap("sparse")
    for _ in range(6):
        br.record_failure()
        fk.advance(br.retry_in() + 0.01)
        br.allow()
    snap("capped")
    return log


class TestCircuitBreaker:
    @pytest.mark.parametrize("jitter", [0.0, 0.2, 1.0])
    def test_state_machine_and_backoff_ladder_equal_jaxs(self, jitter):
        """Tolerance: none. The same outcomes on the same fake clock: trip
        at the threshold, one half-open probe a window, a timeout gives
        the slot back, a failed probe doubles the seeded-jitter backoff
        up to its cap, a success closes, a health probe clears a closed
        streak only."""
        log = _same(lambda P: _breaker_script(P, jitter))
        assert log[1][1] == "open" and log[2] == ("allow-open", False)
        assert log[3] == ("probe", True, False)
        assert log[4] == ("reprobe", True)

    @pytest.mark.parametrize("endpoint", ["store", "ep-a", "ep-b"])
    def test_default_seed_hashes_the_endpoint_id(self, endpoint):
        """Tolerance: none. Without a seed the jitter stream comes from
        the endpoint id: the same id gives JAX's backoffs, trip after
        trip, and two ids never share a stream."""
        def run(P):
            fk = P.FakeClock()
            br = P.cb.CircuitBreaker(endpoint, failure_threshold=1,
                                     base_backoff=1.0, max_backoff=64.0,
                                     jitter=0.5, clock=fk)
            waits = []
            for _ in range(5):
                br.record_failure()
                waits.append(round(br.retry_in(), 12))
                fk.advance(br.retry_in() + 0.01)
                assert br.allow()
            return waits

        waits = _same(run)
        assert len(set(waits)) == 5
        if endpoint != "store":
            br = tcb.CircuitBreaker("store", failure_threshold=1,
                                    base_backoff=1.0, jitter=0.5,
                                    clock=PORT.FakeClock())
            br.record_failure()
            assert round(br.retry_in(), 12) != waits[0]

    def test_open_error_and_stats_equal_jaxs(self):
        """``CircuitOpenError`` carries the endpoint and the wait, and
        ``get_stats`` reports the same keys and values as JAX's through a
        trip and a close."""
        def run(P):
            fk = P.FakeClock()
            br = P.cb.CircuitBreaker("ep", failure_threshold=1,
                                     base_backoff=2.0, jitter=0.0,
                                     clock=fk, seed=3)
            out = [br.get_stats()]
            br.record_failure()
            err = P.cb.CircuitOpenError("ep", br.retry_in())
            out += [br.get_stats(), str(err), err.endpoint, err.retry_in,
                    isinstance(err, RuntimeError)]
            fk.advance(2.5)
            out.append((br.allow(), br.get_stats()["state"]))
            br.record_success()
            out.append(br.get_stats())
            return out

        out = _same(run)
        assert out[1]["state"] == "open" and out[-1]["state"] == "closed"


# -- the wrapper ---------------------------------------------------------------


class TestWrapStore:
    def test_picks_kv_class_by_feature_detection(self):
        def run(P):
            kv = P.res.wrap_store(P.pers.InMemoryStore(), _rcfg(P))

            class NoKV:
                def save(self, c): pass
                def load(self, cid): return None
                def list_user(self, uid): return []
                def delete(self, cid): pass
                def close(self): pass

            plain = P.res.wrap_store(NoKV(), _rcfg(P))
            out = (type(kv).__name__, hasattr(kv, "save_kv"),
                   type(plain).__name__, hasattr(plain, "save_kv"))
            kv.close()
            plain.close()
            return out

        assert _same(run) == ("ResilientKVStore", True, "ResilientStore",
                              False)

    def test_roundtrip_is_transparent(self):
        def run(P):
            store = P.res.wrap_store(P.pers.InMemoryStore(), _rcfg(P))
            store.save(_conv(P, "c1"))
            out = [store.load("c1").id]
            store.save_kv("c1", b"\x00payload\xff")
            out += [store.load_kv("c1"), store.list_kv()]
            store.delete_kv("c1")
            out += [store.load_kv("c1"), list(store.list_user("u1"))]
            store.delete("c1")
            out += [store.load("c1"), dict(store.totals)]
            store.close()
            return out

        out = _same(run)
        assert out[1] == b"\x00payload\xff" and out[-1]["errors"] == 0

    @pytest.mark.parametrize("exc,want", [
        (sqlite3.OperationalError("database is locked"), True),
        (sqlite3.OperationalError("database is busy"), True),
        (sqlite3.OperationalError("no such table: x"), False),
        (ConnectionResetError("reset"), True),
        (ConnectionError("refused"), True),
        (ValueError("nope"), False)])
    def test_retryable_classification(self, exc, want):
        assert tres._retryable(exc) is jres._retryable(exc) is want


class TestDeadlineAndRetry:
    @BOTH
    def test_deadline_bounds_a_slow_store(self, P):
        inner = ScriptedStore(P)
        inner.sleep_s = 0.5
        store = P.res.wrap_store(inner, _rcfg(P, op_timeout_s=0.05))
        t0 = time.perf_counter()
        with pytest.raises(P.res.StoreOpTimeout):
            store.load_kv("c1")
        assert time.perf_counter() - t0 < 0.4
        assert store.totals["timeouts"] == 1
        assert store.resilience_stats()["breaker"]["state"] == "closed"
        store.close()

    @pytest.mark.parametrize("case", ["locked_then_ok", "reset_then_ok",
                                      "non_retryable", "bounded"])
    def test_retries_equal_jaxs(self, case):
        """Tolerance: none. The retry counts, the calls the backend saw
        and the outcome, in both packages."""
        def run(P):
            inner = ScriptedStore(P)
            locked = (lambda m: sqlite3.OperationalError(
                "database is locked"))
            fail_with, times, retries = {
                "locked_then_ok": (locked, 2, 2),
                "reset_then_ok": (ConnectionResetError, 1, 1),
                "non_retryable": (ValueError, 5, 2),
                "bounded": (locked, 100, 2)}[case]
            inner.fail_with, inner.fail_times = fail_with, times
            store = P.res.wrap_store(inner, _rcfg(P, retries=retries))
            inner.raw.save_kv("c1", b"blob")
            try:
                outcome = store.load_kv("c1")
            except Exception as e:  # noqa: BLE001 — the outcome compared
                outcome = type(e).__name__
            out = (outcome, inner.calls.count("load_kv"),
                   store.totals["retries"], store.totals["errors"])
            store.close()
            return out

        want = {"locked_then_ok": (b"blob", 3, 2, 0),
                "reset_then_ok": (b"blob", 2, 1, 0),
                "non_retryable": ("ValueError", 1, 0, 1),
                "bounded": ("OperationalError", 3, 2, 1)}[case]
        assert _same(run) == want


class TestBreakerAndDegradedLadder:
    def test_trip_sheds_fast_without_touching_the_backend(self):
        def run(P):
            inner = ScriptedStore(P)
            store = P.res.wrap_store(inner, _rcfg(P, retries=0),
                                     clock=P.FakeClock())
            _trip(store, inner)
            dispatched = len(inner.calls)
            t0 = time.perf_counter()
            with pytest.raises(P.res.StoreDegradedError):
                store.load_kv("x")
            assert time.perf_counter() - t0 < 0.05
            out = (len(inner.calls) - dispatched, store.totals["shed"],
                   store.resilience_stats()["breaker"]["state"])
            store.close()
            return out

        assert _same(run) == (0, 1, "open")

    def test_probe_recovers_and_fires_recovery_callbacks(self):
        def run(P):
            fk = P.FakeClock()
            inner = ScriptedStore(P)
            store = P.res.wrap_store(inner, _rcfg(P, retries=0), clock=fk)
            store.register_consumer("tiering")
            store.register_consumer("nonsense")
            fired = []
            store.on_recovery(lambda: fired.append(1))
            _trip(store, inner)
            out = [list(fired)]
            fk.advance(6.0)
            out.append(store.degraded)
            inner.raw.save_kv("x", b"back")
            out += [store.load_kv("x"), list(fired)]
            st = store.resilience_stats()
            out += [st["breaker"]["state"], st["consumers"], st["degraded"]]
            store.close()
            return out

        assert _same(run) == [[], False, b"back", [1], "closed",
                              ["tiering"], False]

    def test_timeout_degraded_rung_probes_on_interval(self):
        def run(P):
            fk = P.FakeClock()
            inner = ScriptedStore(P)
            inner.sleep_s = 0.2
            store = P.res.wrap_store(inner, _rcfg(
                P, op_timeout_s=0.05, timeout_threshold=2,
                probe_interval_s=10.0), clock=fk)
            for _ in range(2):
                t0 = time.perf_counter()
                with pytest.raises(P.res.StoreOpTimeout):
                    store.load_kv("c1")
                assert time.perf_counter() - t0 < 0.4
            st = store.resilience_stats()
            out = [store.degraded, st["timeout_degraded"],
                   st["breaker"]["state"]]
            dispatched = len(inner.calls)
            with pytest.raises(P.res.StoreDegradedError):
                store.load_kv("c1")
            out.append(len(inner.calls) - dispatched)
            fk.advance(11.0)
            inner.sleep_s = 0.0
            inner.raw.save_kv("c1", b"ok")
            out += [store.load_kv("c1"), store.degraded]
            store.close()
            return out

        assert _same(run) == [True, True, "closed", 0, b"ok", False]


class TestChaosPoints:
    def test_store_kv_error_fires_in_the_seam(self):
        def run(P):
            store = P.res.wrap_store(P.pers.InMemoryStore(), _rcfg(P))
            _arm(P, 41, {"point": "store.kv", "kind": "error", "times": 1})
            with pytest.raises(P.chaos.ChaosFault):
                store.load_kv("c1")
            out = (store.totals["errors"], store.load_kv("c1"))
            store.close()
            return out

        assert _same(run) == (1, None)

    def test_match_filters_on_op(self):
        def run(P):
            store = P.res.wrap_store(P.pers.InMemoryStore(), _rcfg(P))
            _arm(P, 42, {"point": "store.kv", "kind": "error", "times": 1,
                         "match": {"op": "kv_put"}})
            out = [store.load_kv("c1")]
            with pytest.raises(P.chaos.ChaosFault):
                store.save_kv("c1", b"x")
            out.append(dict(store.totals))
            store.close()
            return out

        _same(run)

    @pytest.mark.parametrize("point,call", [
        ("store.get", "load"), ("store.put", "save"),
        ("store.delete", "delete"), ("store.kv", "load_kv")])
    def test_injected_latency_is_bounded_by_the_deadline(self, point, call):
        """The chaos point fires inside the worker: a 300 ms injected
        brownout meets the 50 ms deadline, as a slow backend would."""
        def run(P):
            store = P.res.wrap_store(P.pers.InMemoryStore(),
                                     _rcfg(P, op_timeout_s=0.05))
            _arm(P, 43, {"point": point, "kind": "latency",
                         "latency_ms": 300, "times": 1})
            arg = _conv(P) if call == "save" else "c1"
            t0 = time.perf_counter()
            with pytest.raises(P.res.StoreOpTimeout):
                getattr(store, call)(arg)
            assert time.perf_counter() - t0 < 0.25
            out = (store.totals["timeouts"],
                   P.chaos.get_injector().get_stats()["injected"])
            store.close()
            return out

        assert _same(run) == (1, {f"{point}:latency": 1})


# -- the consumers' degraded rungs ----------------------------------------------


class TestStateManagerDegraded:
    @staticmethod
    def _stack(P, **rkw):
        inner = ScriptedStore(P)
        fk = P.FakeClock()
        store = P.res.wrap_store(inner, _rcfg(P, retries=0, **rkw),
                                 clock=fk)
        sm = P.SM(P.C.ConversationConfig(persist=True), store=store)
        return fk, inner, store, sm

    def test_writes_journal_and_reads_serve_cache_while_degraded(self):
        def run(P):
            fk, inner, store, sm = self._stack(P)
            inner.fail_times = 3
            for i in range(3):
                sm.create("u1", conversation_id=f"c{i}")
            out = [store.degraded, sm.replay_pending()]
            dispatched = len(inner.calls)
            sm.create("u1", conversation_id="c3")
            out += [len(inner.calls) - dispatched, sm.replay_pending(),
                    sm.get("c0").id]
            with pytest.raises(P.errors.ConversationNotFoundError):
                sm.get("never-existed")
            out.append(len(inner.calls) - dispatched)
            store.close()
            return out

        assert _same(run) == [True, 3, 0, 4, "c0", 0]

    def test_recovery_drains_the_replay_buffer(self):
        def run(P):
            fk, inner, store, sm = self._stack(P)
            inner.fail_times = 3
            for i in range(3):
                sm.create("u1", conversation_id=f"c{i}")
            out = [sm.replay_pending()]
            fk.advance(6.0)
            sm.create("u1", conversation_id="c3")
            out += [sm.replay_pending(),
                    [inner.raw.load(f"c{i}") is not None for i in range(4)]]
            store.close()
            return out

        assert _same(run) == [3, 0, [True] * 4]

    def test_replay_buffer_is_bounded(self):
        def run(P):
            fk, inner, store, sm = self._stack(P, replay_buffer=4)
            inner.fail_times = 3
            for i in range(10):
                sm.create("u1", conversation_id=f"c{i}")
            out = (store.degraded, sm.replay_pending())
            store.close()
            return out

        assert _same(run) == (True, 4)

    def test_consumers_registered(self):
        """The state manager registers ``state`` and ``placement`` (the
        cluster router's placement records), as JAX's does."""
        got = {}
        for P in PKGS:
            _, _, store, sm = self._stack(P)
            got[P.name] = set(store.resilience_stats()["consumers"])
            store.close()
        assert got["port"] == got["jax"] == {"state", "placement"}

    def test_raw_backend_keeps_every_path(self):
        """A raw backend is never degraded and journals only a failed
        save, drained at the next good one, as JAX's."""
        def run(P):
            inner = ScriptedStore(P)
            sm = P.SM(P.C.ConversationConfig(persist=True), store=inner)
            out = [sm._store_degraded()]
            inner.fail_times = 1
            sm.create("u1", conversation_id="a")
            out.append(sm.replay_pending())
            sm.create("u1", conversation_id="b")
            out += [sm.replay_pending(), inner.raw.load("a") is not None]
            return out

        assert _same(run) == [False, 1, 0, True]


class TestTieringDegraded:
    def test_store_ok_gates_off_a_degraded_store(self):
        def run(P):
            inner = ScriptedStore(P)
            fk = P.FakeClock()
            store = P.res.wrap_store(inner, _rcfg(P, retries=0), clock=fk)
            plane = P.Plane(P.C.KVTieringConfig(enabled=True), "p",
                            P.Echo(batch_size=2))
            plane.store = store
            out = ["tiering" in store.resilience_stats()["consumers"],
                   plane._store_ok()]
            _trip(store, inner)
            out.append(plane._store_ok())
            fk.advance(6.0)
            out.append(plane._store_ok())
            plane.stop()
            store.close()
            return out

        assert _same(run) == [True, True, False, True]


# -- sqlite's locked retry -----------------------------------------------------


class TestExchangeDegraded:
    def test_publish_skips_while_degraded(self):
        def run(P):
            fk = P.FakeClock()
            inner = ScriptedStore(P)
            store = P.res.wrap_store(inner, _rcfg(P, retries=0), clock=fk)
            x = P.Exchange(store, role="prefill", metrics=False)
            consumers = store.resilience_stats()["consumers"]
            _trip(store, inner)
            x.publish("c1", [], [], meta={"tokens": [1, 2, 3]})
            out = ("exchange" in consumers, inner.raw.list_kv(),
                   dict(x.totals))
            store.close()
            return out

        registered, kv, totals = _same(run)
        assert registered and kv == []
        assert (totals["fallback"], totals["published"]) == (1, 0)

    def test_claim_under_injected_latency_degrades_to_recompute(self):
        def run(P):
            store = P.res.wrap_store(P.pers.InMemoryStore(),
                                     _rcfg(P, op_timeout_s=0.05))
            x = P.Exchange(store, role="decode", claim_ttl_s=2.0,
                           metrics=False)
            x.publish("c1", [], [], meta={"tokens": [1, 2]})
            _arm(P, 51, {"point": "store.kv", "kind": "latency",
                         "latency_ms": 400, "times": 1,
                         "match": {"op": "kv_get"}})
            t0 = time.perf_counter()
            first = x.claim("c1")
            bounded = time.perf_counter() - t0 < 0.35
            fallback = x.totals["fallback"]
            got = x.claim("c1")
            store.close()
            return first, bounded, fallback, got[2]["tokens"]

        assert _same(run) == (None, True, 1, [1, 2])

    def test_claim_wall_budget_on_a_raw_slow_store(self):
        def run(P):
            class SlowLoad(P.pers.InMemoryStore):
                def load_kv(self, cid):
                    time.sleep(0.08)
                    return super().load_kv(cid)

            raw = SlowLoad()
            x = P.Exchange(raw, role="decode", claim_ttl_s=0.05,
                           metrics=False)
            x.publish("c1", [], [], meta={"tokens": [9]})
            return x.claim("c1"), x.totals["fallback"], raw.list_kv()

        assert _same(run) == (None, 1, [])


class TestSqliteLockedRetry:
    @BOTH
    def test_locked_retry_unit(self, P, tmp_path):
        store = P.pers.SqliteStore(str(tmp_path / "u.db"))
        attempts = {"n": 0}

        def flaky():
            attempts["n"] += 1
            if attempts["n"] <= 2:
                raise sqlite3.OperationalError("database is locked")
            return "ok"

        assert store._with_locked_retry(flaky) == "ok"
        assert attempts["n"] == 3
        store.close()

    def test_locked_retry_is_bounded_and_selective(self, tmp_path):
        def run(P):
            store = P.pers.SqliteStore(str(tmp_path / f"b-{P.name}.db"))
            calls = {"n": 0}

            def always_locked():
                calls["n"] += 1
                raise sqlite3.OperationalError("database is locked")

            with pytest.raises(sqlite3.OperationalError):
                store._with_locked_retry(always_locked)
            n_locked = calls["n"]

            def schema_error():
                calls["n"] += 1
                raise sqlite3.OperationalError("no such table: kv_payloads")

            calls["n"] = 0
            with pytest.raises(sqlite3.OperationalError):
                store._with_locked_retry(schema_error)
            store.close()
            return n_locked, calls["n"]

        assert _same(run) == (1 + tpers.SqliteStore._LOCKED_RETRIES, 1)

    @BOTH
    def test_cross_connection_contention_four_threads(self, P, tmp_path):
        """Two connections over one file, four threads: busy_timeout and
        the bounded retry absorb every lock race."""
        path = str(tmp_path / "cont.db")
        stores = [P.pers.SqliteStore(path), P.pers.SqliteStore(path)]
        errors = []
        stop = threading.Event()

        def worker(wid):
            st = stores[wid % 2]
            try:
                for i in range(60):
                    cid = f"w{wid}-{i % 5}"
                    st.save_kv(cid, bytes([wid]) * 1024)
                    blob = st.load_kv(cid)
                    assert blob is None or blob[:1] == bytes([wid])
                    if i % 9 == 0:
                        st.delete_kv(cid)
                    if stop.is_set():
                        return
            except Exception as e:  # noqa: BLE001 — collected for assert
                errors.append(e)
                stop.set()

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        for st in stores:
            st.close()


# -- the WAL's 503 rung ---------------------------------------------------------


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v1/messages",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class TestWalShed:
    def test_admission_path_fault_sheds_503_with_retry_after(self,
                                                             tmp_path):
        """A full-disk append fault on a push answers 503 with
        Retry-After at the REST edge, and the next push is admitted, as
        JAX's."""
        def run(P):
            cfg = P.config()
            cfg.queue.enable_metrics = False
            cfg.queue.worker.process_interval = 0.005
            cfg.loadbalancer.health_check_interval = 0.0
            cfg.queue.wal_dir = str(tmp_path / P.name)
            tok = P.Tok()
            engine = P.Engine(P.Echo(batch_size=4, eos_id=tok.eos_id), tok,
                              name=f"walshed-{P.name}",
                              enable_metrics=False, max_decode_steps=16)
            engine.start()
            factory = P.QueueFactory(cfg)
            factory.create_queue_manager("standard", P.QueueType.STANDARD)
            server = P.ApiServer(cfg, queue_factory=factory, engine=engine)
            port = server.start(host="127.0.0.1", port=0)
            try:
                _arm(P, 61, {"point": "wal.append", "kind": "oserror",
                             "times": 1, "match": {"op": "push"}})
                status, payload, hdrs = _post(port, {
                    "id": "wal0", "content": "x", "user_id": "u"})
                out = [status, "WAL push failed" in payload["error"],
                       payload["retry_after"], hdrs.get("Retry-After")]
                status, _, _ = _post(port, {"id": "wal1", "content": "x",
                                            "user_id": "u"})
                out.append(status)
            finally:
                server.stop()
                factory.stop_all()
                engine.stop()
            return out

        assert _same(run) == [503, True, 1.0, "1", 202]

    @BOTH
    def test_worker_side_fault_is_counted_and_loop_survives(self, P,
                                                            tmp_path):
        """A journal fault on a worker-side op (complete) is counted in
        ``wal_errors_total{op}`` and the manager goes on."""
        def count(text):
            for line in text.splitlines():
                if line.startswith('llm_queue_wal_errors_total{op="complete"}'):
                    return float(line.split()[-1])
            return 0.0

        expo = ((lambda: jreg.exposition().decode()) if P is JAX
                else (lambda: treg.exposition().decode()))
        before = count(expo())
        try:
            mgr = P.QueueManager(f"walstore-{P.name}",
                                 wal_path=str(tmp_path / "w.wal"))
            _arm(P, 62, {"point": "wal.append", "kind": "oserror",
                         "times": 1, "match": {"op": "complete"}})
            qname = mgr.push_message(P.types.Message(id="m0", content="x",
                                                     user_id="u"))
            mgr.complete_message(mgr.pop_message(qname), 0.0, qname)
            assert mgr.total_pending() == 0
            qname = mgr.push_message(P.types.Message(id="m1", content="x",
                                                     user_id="u"))
            mgr.complete_message(mgr.pop_message(qname), 0.0, qname)
            mgr.stop()
            assert count(expo()) - before == 1.0
        finally:
            if P is JAX:
                # The JAX package's own copy of this test reads this
                # process-wide count as an absolute 1, and may run after
                # this one in the same process: leave it as found.
                fam = jreg.get_metrics().wal_errors
                try:
                    fam.remove("complete")
                except KeyError:
                    pass
                if before:
                    fam.labels("complete").inc(before)


# -- /health and the metric families ---------------------------------------------


class TestHealthAndMetrics:
    @staticmethod
    def _server(P, sm):
        cfg = P.config()
        cfg.queue.enable_metrics = False
        cfg.loadbalancer.health_check_interval = 0.0
        tok = P.Tok()
        engine = P.Engine(P.Echo(batch_size=2, eos_id=tok.eos_id), tok,
                          name=f"storehealth-{P.name}", enable_metrics=False)
        engine.start()
        factory = P.QueueFactory(cfg)
        factory.create_queue_manager("standard", P.QueueType.STANDARD)
        server = P.ApiServer(cfg, queue_factory=factory, engine=engine,
                             state_manager=sm)
        return server, factory, engine

    def test_health_carries_store_block_when_wrapped(self):
        blocks = {}
        for P in PKGS:
            store = P.res.wrap_store(P.pers.InMemoryStore(), _rcfg(P))
            sm = P.SM(P.C.ConversationConfig(persist=True), store=store)
            server, factory, engine = self._server(P, sm)
            port = server.start(host="127.0.0.1", port=0)
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=10) as r:
                    blocks[P.name] = json.loads(r.read())["store"]
            finally:
                server.stop()
                factory.stop_all()
                engine.stop()
                store.close()
        t, j = blocks["port"], blocks["jax"]
        assert t.keys() == j.keys()
        assert t == j
        assert t["consumers"] == ["placement", "state"]
        assert t["resilience"] is True and t["replay_pending"] == 0
        assert t["breaker"]["state"] == "closed"

    @BOTH
    def test_raw_backend_has_no_store_block(self, P):
        cfg = P.config()
        assert cfg.store.resilience.enabled is False
        assert cfg.store.enabled is False
        raw = P.pers.InMemoryStore()
        assert not hasattr(raw, "degraded")
        assert not hasattr(raw, "resilience_stats")
        sm = P.SM(P.C.ConversationConfig(persist=True), store=raw)
        assert sm._store_degraded() is False
        server, factory, engine = self._server(P, sm)
        try:
            assert server._store_block() is None
            status, body = server.health_check(None)
            assert status == 200 and "store" not in body
        finally:
            factory.stop_all()
            engine.stop()

    def test_new_metric_families_flush_at_scrape(self):
        """The port's store families flush at the scrape with the samples
        JAX's write for the same ops."""
        import gc

        from prometheus_client import generate_latest

        # The breaker-state gauge is one series a process, set by every
        # live wrapper at the scrape: collect the earlier tests' closed
        # stores (a state manager and its store hold each other) first.
        gc.collect()
        texts = {}
        for P, expo in ((JAX, lambda: generate_latest(
                jreg.REGISTRY).decode()),
                        (PORT, lambda: treg.exposition().decode())):
            store = P.res.wrap_store(P.pers.InMemoryStore(), _rcfg(P))
            store.register_consumer("exchange")
            store.save_kv("c1", b"x")
            assert store.load_kv("c1") == b"x"
            P.res.flush_metrics()
            texts[P.name] = expo()
            assert store.totals["ops"] == 2
            store.close()
        for text in texts.values():
            assert 'store_op_ms_count{op="kv_put",outcome="ok"}' in text
            assert "llm_queue_store_retries_total" in text
            assert "llm_queue_store_breaker_state 0.0" in text
            assert 'llm_queue_store_degraded{consumer="exchange"} 0.0' \
                in text


# -- acceptance: a store blackout mid-workload --------------------------------------


def _accept_rcfg(P, seed=11):
    """A real-clock breaker with sub-second backoff, so recovery lands
    inside the test."""
    return P.C.StoreResilienceConfig(
        enabled=True, op_timeout_s=0.25, retries=1,
        retry_base_backoff_s=0.001, retry_max_backoff_s=0.005,
        timeout_threshold=3, probe_interval_s=0.05, seed=seed,
        breaker=P.C.BreakerConfig(enabled=True, failure_threshold=3,
                                  base_backoff=0.15, max_backoff=0.6,
                                  jitter=0.0))


def _turn(P, eng, sm, checker, rid, conv, prompt, budget_s=4.0):
    """One turn through the submit path with the service layer's state
    write, bounded in wall time (a dead store never stalls it)."""
    checker.submitted(rid)
    sm.add_message(conv, P.types.Message(id=rid, content=prompt,
                                         user_id="u"))
    t0 = time.perf_counter()
    h = eng.submit(P.GenRequest(id=rid, prompt=prompt, conversation_id=conv,
                                max_new_tokens=8))
    eng.run_until_idle()
    wall = time.perf_counter() - t0
    assert h.result is not None and h.result.finish_reason in (
        "eos", "length"), rid
    assert wall < budget_s, f"{rid} took {wall:.2f}s with the store dead"
    checker.completed(rid, tokens=h.result.tokens)
    return h


class TestStoreBlackoutAcceptance:
    def test_echo_engine_blackout_recovery(self):
        """Tiering and the state manager over one wrapped store, the async
        pipeline at depth 2: a blackout mid-workload sheds to the degraded
        rungs (bounded turns, zero loss), and after the store comes back
        the replay buffer drains and host-tier promotions go on; every
        turn's tokens are JAX's."""
        def run(P):
            store = P.res.wrap_store(P.pers.InMemoryStore(),
                                     _accept_rcfg(P))
            sm = P.SM(P.C.ConversationConfig(persist=True), store=store)
            tok = P.Tok()
            fclock = P.FakeClock()
            eng = P.Engine(
                P.Echo(batch_size=4, page_size=8, num_pages=128,
                       max_pages_per_seq=16, eos_id=tok.eos_id,
                       chunk_size=4, async_chunks=True),
                tok, name=f"storechaos-{P.name}", enable_metrics=False,
                kv_pin_ttl=5.0, clock=fclock,
                kv_tiering=P.C.KVTieringConfig(
                    enabled=True, host_capacity_mb=4,
                    host_max_conversations=16, store_spill=True),
                prefix_cache=P.C.PrefixCacheConfig(enabled=True),
                async_pipeline=P.C.AsyncPipelineConfig(enabled=True,
                                                       depth=2))
            eng.attach_conversation_manager(sm)
            x = P.Exchange(store, role="unified", metrics=False)
            eng._tiering.exchange = x
            checker = P.chaos.InvariantChecker()
            convs = [f"bc{i}" for i in range(4)]
            toks = []
            try:
                for i, c in enumerate(convs):
                    toks.append(_turn(P, eng, sm, checker, f"{c}.t1", c,
                                      f"warm {i} text").result.tokens)
                fclock.advance(6.0)
                eng.step()
                plane = eng._tiering
                assert wait_until(
                    lambda: sum(plane.counts().values()) == len(convs))
                toks.append(_turn(P, eng, sm, checker, f"{convs[0]}.t2",
                                  convs[0], " more").result.tokens)
                assert eng.get_stats()["kv_tiering"]["hits"]["host"] >= 1

                _arm(P, 71, {"point": "store.*", "kind": "error",
                             "times": 500})
                for i, c in enumerate(convs):
                    toks.append(_turn(P, eng, sm, checker, f"{c}.t3", c,
                                      f" blackout {i}").result.tokens)
                for i in range(4, 8):
                    toks.append(_turn(P, eng, sm, checker, f"bc{i}.t1",
                                      f"bc{i}", f"new {i} during blackout"
                                      ).result.tokens)
                st = store.resilience_stats()
                assert st["breaker"]["trips"] >= 1
                assert store.totals["errors"] >= 3
                # The fresh arrivals' exchange claims meet the degraded
                # store and shed fast; the state manager journals.
                assert store.totals["shed"] > 0
                assert sm.replay_pending() > 0

                P.chaos.configure(None)
                assert wait_until(lambda: not store.degraded, timeout=5.0)
                toks.append(_turn(P, eng, sm, checker, f"{convs[1]}.t4",
                                  convs[1], " back").result.tokens)
                assert wait_until(lambda: sm.replay_pending() == 0,
                                  timeout=5.0)
                for c in convs:
                    assert store.inner.load(c) is not None
                # A publish → claim handoff lands through the recovered
                # store.
                x.publish("hand", [], [], meta={"tokens": [1, 2]})
                got = x.claim("hand")
                assert got is not None and got[2]["tokens"] == [1, 2]
                fclock.advance(6.0)
                eng.step()
                assert wait_until(
                    lambda: sum(plane.counts().values()) >= len(convs))
                hits0 = eng.get_stats()["kv_tiering"]["hits"]["host"]
                toks.append(_turn(P, eng, sm, checker, f"{convs[2]}.t5",
                                  convs[2], " again").result.tokens)
                assert eng.get_stats()["kv_tiering"]["hits"]["host"] > hits0
                checker.check()
            finally:
                eng.stop()
                store.close()
            return toks

        _same(run)

    def test_port_engine_blackout_matches_baseline(self):
        """The port's engine on a tiny f32 model (JAX's weights): a
        conversation whose KV sat in the store tier decodes its next turn
        during a blackout by recompute, bounded, token for token equal to
        a pin-resident baseline and to JAX's engine on the same leg; the
        store tier serves again after the recovery."""
        kw = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  ffn_dim=128, vocab_size=512, max_seq_len=256)
        jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **kw)
        jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
        tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **kw)
        tparams = T.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        geom = dict(batch_size=2, page_size=8, num_pages=64,
                    prefill_buckets=[16, 64], chunk_size=4)

        def build(P, tiering, store):
            tok = P.Tok()
            if P is JAX:
                ex = JaxExecutor(jcfg, jparams, eos_id=tok.eos_id, **geom)
            else:
                ex = TorchExecutor(tcfg, tparams, device="cpu",
                                   eos_id=tok.eos_id, **geom)
            fclock = P.FakeClock()
            eng = P.Engine(ex, tok, name=f"storechaos-m-{P.name}",
                           enable_metrics=False, max_decode_steps=12,
                           clock=fclock, kv_pin_ttl=5.0, kv_tiering=tiering,
                           async_pipeline=P.C.AsyncPipelineConfig(
                               enabled=True, depth=2))
            if store is not None and eng._tiering is not None:
                eng._tiering.store = store
            return eng, fclock

        prompts = {"j0": ("the quick brown fox", " jumps over"),
                   "j1": ("a slow green turtle", " crawls by")}

        def run(P):
            eng, _ = build(P, None, None)
            base = {}
            for c, (p1, p2) in prompts.items():
                h1 = eng.submit(P.GenRequest(id=f"{c}.b1", prompt=p1,
                                             conversation_id=c,
                                             max_new_tokens=8))
                eng.run_until_idle()
                h2 = eng.submit(P.GenRequest(id=f"{c}.b2", prompt=p2,
                                             conversation_id=c,
                                             max_new_tokens=8))
                eng.run_until_idle()
                base[c] = (h1.result.tokens, h2.result.tokens)
            eng.stop()
            assert all(t1 and t2 for t1, t2 in base.values())

            store = P.res.wrap_store(P.pers.InMemoryStore(),
                                     _accept_rcfg(P, seed=12))
            checker = P.chaos.InvariantChecker()
            eng, fclock = build(P, P.C.KVTieringConfig(
                enabled=True, host_max_conversations=1, store_spill=True),
                store)
            sm = P.SM(P.C.ConversationConfig(persist=True), store=store)
            eng.attach_conversation_manager(sm)
            plane = eng._tiering
            try:
                out = {}
                for c, (p1, _) in prompts.items():
                    h = _turn(P, eng, sm, checker, f"{c}.t1", c, p1,
                              budget_s=60.0)
                    out[c] = [h.result.tokens]
                fclock.advance(6.0)
                eng.step()
                assert wait_until(lambda: sum(plane.counts().values()) == 2)
                assert store.totals["ops"] > 0
                _arm(P, 72, {"point": "store.*", "kind": "error",
                             "times": 200})
                for c, (_, p2) in prompts.items():
                    h = _turn(P, eng, sm, checker, f"{c}.t2", c, p2)
                    out[c].append(h.result.tokens)
                assert store.resilience_stats()["breaker"]["trips"] >= 1
                assert store.totals["errors"] > 0
                for c in prompts:
                    assert tuple(out[c]) == base[c], c

                P.chaos.configure(None)
                assert wait_until(lambda: not store.degraded, timeout=5.0)
                store.load("j0")
                assert wait_until(lambda: sm.replay_pending() == 0,
                                  timeout=5.0)
                fclock.advance(6.0)
                eng.step()
                assert wait_until(lambda: sum(plane.counts().values()) == 2)
                for c, (p1, _) in prompts.items():
                    _turn(P, eng, sm, checker, f"{c}.t3", c, p1,
                          budget_s=60.0)
                assert eng.get_stats()["kv_tiering"]["hits"]["store"] >= 1
                checker.check()
            finally:
                eng.stop()
                store.close()
            return base, out

        _same(run)
