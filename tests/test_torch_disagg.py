"""The port's disaggregation plane against the JAX package's, on the CPU:
each scenario runs through both packages (their exchanges, tiering
planes, echo engines, coordinators and cluster routers) and the outcomes
must be equal (tolerance: none).

Mirrors ``tests/test_disagg.py`` case for case: the exchange's publish,
claim-as-consume, TTL expiry by the publisher's role, torn blobs,
``pending`` and ``stats``; the off switch; role routing learned from
/health probes (long first turns to prefill, short ones to decode, the
handoff that leaves a prefill replica's affinity, a wrong-role-only
cluster, unified replicas); the planes' exchange (payload round trip,
the miss's negative cache, a local prepare, a foreign page spec); the
conversation handoff on echo engines (zero recompute; an expired claim
recomputing as a unified engine does; drain migration); rehydration;
the metric families; role-aware scaling; and the SIGKILL of a prefill
replica mid-handoff over real ``python -m llmq_tpu_torch --backend echo``
processes. Added: a blob JAX's exchange publishes into a shared sqlite
store is claimed by the port's plane bit for bit, and the reverse; and a
prefill → decode handoff on the f32 ``llama3-tiny`` model whose turn-2
stream equals JAX's two-engine flow and a unified engine's, with 0
recomputed tokens.
"""

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

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.api.server import ApiServer as JApiServer  # noqa: E402
from llmq_tpu.cluster import build_cluster_router as jbuild  # noqa: E402
from llmq_tpu.cluster.router import ClusterRouter as JRouter  # noqa: E402
from llmq_tpu.controlplane import LocalEnginePool as JLocalPool  # noqa: E402
from llmq_tpu.controlplane import ReplicaController as JController  # noqa: E402
from llmq_tpu.conversation import persistence as jpers  # noqa: E402
from llmq_tpu.conversation.state_manager import StateManager as JSM  # noqa: E402
from llmq_tpu.core import config as JC  # noqa: E402
from llmq_tpu.core import types as jtypes  # noqa: E402
from llmq_tpu import disagg as jdisagg  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import EchoExecutor as JEcho  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.loadbalancer.load_balancer import LoadBalancer as JLB  # noqa: E402
from llmq_tpu.metrics import registry as jreg  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.observability.usage import get_usage_ledger as jledger  # noqa: E402
from llmq_tpu.tiering import KVTieringPlane as JPlane  # noqa: E402

from llmq_tpu_torch.api.server import ApiServer as TApiServer  # noqa: E402
from llmq_tpu_torch.chaos.invariants import InvariantChecker  # noqa: E402
from llmq_tpu_torch.cluster import build_cluster_router as tbuild  # noqa: E402
from llmq_tpu_torch.cluster.router import ClusterRouter as TRouter  # noqa: E402
from llmq_tpu_torch.controlplane import LocalEnginePool as TLocalPool  # noqa: E402
from llmq_tpu_torch.controlplane import ReplicaController as TController  # noqa: E402
from llmq_tpu_torch.conversation import persistence as tpers  # noqa: E402
from llmq_tpu_torch.conversation.state_manager import StateManager as TSM  # noqa: E402
from llmq_tpu_torch.core import config as TC  # noqa: E402
from llmq_tpu_torch.core import types as ttypes  # noqa: E402
from llmq_tpu_torch import disagg as tdisagg  # noqa: E402
from llmq_tpu_torch.engine.engine import GenRequest as TGenRequest  # noqa: E402
from llmq_tpu_torch.engine.engine import InferenceEngine as TEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import EchoExecutor as TEcho  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer as TTok  # noqa: E402
from llmq_tpu_torch.loadbalancer.load_balancer import LoadBalancer as TLB  # noqa: E402
from llmq_tpu_torch.metrics import registry as treg  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.observability.usage import get_usage_ledger as tledger  # noqa: E402
from llmq_tpu_torch.tiering import KVTieringPlane as TPlane  # noqa: E402

pytestmark = [pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning"),
    pytest.mark.filterwarnings("ignore::FutureWarning")]

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(
    name="jax", C=JC, config=JC.default_config, pers=jpers, SM=JSM,
    dis=jdisagg, Engine=JEngine, Echo=JEcho, Tok=JTok,
    GenRequest=JGenRequest, Plane=JPlane, ApiServer=JApiServer,
    build=jbuild, Router=JRouter, LB=JLB, Message=jtypes.Message,
    LocalPool=JLocalPool, Controller=JController,
    exposition=lambda: jreg.exposition().decode())
PORT = types.SimpleNamespace(
    name="port", C=TC, config=TC.Config, pers=tpers, SM=TSM,
    dis=tdisagg, Engine=TEngine, Echo=TEcho, Tok=TTok,
    GenRequest=TGenRequest, Plane=TPlane, ApiServer=TApiServer,
    build=tbuild, Router=TRouter, LB=TLB, Message=ttypes.Message,
    LocalPool=TLocalPool, Controller=TController,
    exposition=lambda: treg.exposition().decode())
PKGS = (JAX, PORT)


def _same(run):
    """``run`` over both packages; the outcomes must be equal."""
    out = {P.name: run(P) for P in PKGS}
    assert out["jax"] == out["port"], out
    return out["port"]


@pytest.fixture(autouse=True)
def _usage_off():
    """Both usage ledgers off for each case (as JAX's file does) and put
    back as they were after."""
    leds = [jledger(), tledger()]
    was = [led.enabled for led in leds]
    for led in leds:
        led.reconfigure(enabled=False)
        led.clear()
    yield
    for led, w in zip(leds, was):
        led.reconfigure(enabled=w)
        led.clear()


def wait_until(fn, timeout=10.0, step=0.002):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if fn():
            return True
        time.sleep(step)
    return False


class FakeKVExec:
    """A numpy "device" whose page p holds the value p in every element
    (JAX's file's), for either package's plane."""

    def __init__(self):
        self.injected = {}

    def kv_page_spec(self):
        return [((2, 4, 8), np.dtype(np.float32))]

    def export_kv_pages(self, pages):
        return [np.stack([np.full((2, 4, 8), float(p), np.float32)
                          for p in pages], axis=1)]

    def import_kv_pages(self, pages, leaves):
        for i, p in enumerate(pages):
            self.injected[p] = np.asarray(leaves[0][:, i]).copy()


def mk_plane(P, name="planeA", store=None, cfg=None):
    plane = P.Plane(cfg or P.C.KVTieringConfig(enabled=True), name,
                    FakeKVExec())
    plane.store = store if store is not None else P.pers.InMemoryStore()
    return plane


def _leaves(plane, entry):
    """A claimed entry's per-leaf arrays: JAX's plane returns them, the
    port's a ``PagePayload``."""
    got = plane.unpack(entry)
    return got.leaves() if hasattr(got, "leaves") else got


def _bufs(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, 256, np.uint8).astype(np.uint8)
            for _ in range(n)]


SPECS = [((2, 4, 8), np.dtype(np.float32))]


class FakeNow:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _claim_ready(plane, conv):
    got = {}

    def claimed():
        got["s"], got["e"] = plane.claim(conv)
        return got["s"] == "ready"

    assert wait_until(claimed)
    return got["e"]


# -- the exchange --------------------------------------------------------------


class TestKVExchange:
    def test_publish_claim_roundtrip_bit_identical(self):
        def run(P):
            store = P.pers.InMemoryStore()
            pub = P.dis.KVExchange(store, role="prefill", metrics=False)
            sub = P.dis.KVExchange(store, role="decode", metrics=False)
            bufs = _bufs(3)
            meta = {"conv_id": "c", "tokens": [1, 2, 3], "length": 3,
                    "pending": None, "n_pages": 3, "owner": "prefill0"}
            pub.publish("c", bufs, SPECS, meta)
            gbufs, gspecs, gmeta = sub.claim("c")
            assert all(np.array_equal(np.asarray(a)[:256], b)
                       for a, b in zip(gbufs, bufs))
            assert "published_at" in gmeta
            return (len(gbufs), [tuple(s[0]) for s in gspecs],
                    gmeta["tokens"], gmeta["role"],
                    pub.totals["published"], sub.totals["claimed"])

        assert _same(run) == (3, [SPECS[0][0]], [1, 2, 3], "prefill", 1, 1)

    def test_claim_is_consume(self):
        def run(P):
            store = P.pers.InMemoryStore()
            x = P.dis.KVExchange(store, metrics=False)
            x.publish("c", _bufs(1), SPECS, {"conv_id": "c"})
            first = x.claim("c") is not None
            return (first, x.claim("c"),
                    P.dis.KVExchange.key_for("c") in store.list_kv())

        assert _same(run) == (True, None, False)

    def test_ttl_expiry_counts_publisher_role(self):
        def run(P):
            now = FakeNow()
            store = P.pers.InMemoryStore()
            pub = P.dis.KVExchange(store, role="prefill", claim_ttl_s=10.0,
                                   metrics=False, now_fn=now)
            sub = P.dis.KVExchange(store, role="decode", claim_ttl_s=10.0,
                                   metrics=False, now_fn=now)
            pub.publish("c", _bufs(1), SPECS, {"conv_id": "c"})
            now.t += 11.0
            return (sub.claim("c"), dict(sub.totals),
                    dict(sub._counts["expired"]), store.list_kv())

        got = _same(run)
        assert got[0] is None and got[1]["expired"] == 1
        assert got[2] == {"prefill": 1} and got[3] == []

    def test_torn_blob_counts_fallback(self):
        def run(P):
            store = P.pers.InMemoryStore()
            x = P.dis.KVExchange(store, role="decode", metrics=False)
            x.publish("c", _bufs(2), SPECS, {"conv_id": "c"})
            key = P.dis.KVExchange.key_for("c")
            store.save_kv(key, store.load_kv(key)[:-20])
            return x.claim("c"), dict(x.totals), store.list_kv()

        got = _same(run)
        assert got[0] is None and got[1]["fallback"] == 1 and got[2] == []

    def test_pending_and_stats(self):
        def run(P):
            store = P.pers.InMemoryStore()
            x = P.dis.KVExchange(store, role="prefill", metrics=False)
            x.publish("a", _bufs(1), SPECS, {"conv_id": "a"})
            x.publish("b", _bufs(1), SPECS, {"conv_id": "b"})
            return x.pending(), x.stats()

        pending, st = _same(run)
        assert pending == ["a", "b"]
        assert st["role"] == "prefill" and st["published"] == 2

    @pytest.mark.parametrize("publisher", ["jax", "port"])
    def test_blob_crosses_packages_bit_exact(self, tmp_path, publisher):
        """One package's plane publishes a demoted conversation into a
        shared sqlite store; the other's plane claims it through
        ``prepare(remote=True)`` and unpacks the same bytes, tokens and
        meta."""
        pub_p, sub_p = (JAX, PORT) if publisher == "jax" else (PORT, JAX)
        path = str(tmp_path / "shared.db")
        a = mk_plane(pub_p, "prefillA", pub_p.pers.SqliteStore(path))
        b = mk_plane(sub_p, "decodeB", sub_p.pers.SqliteStore(path))
        a.exchange = pub_p.dis.KVExchange(a.store, role="prefill",
                                          metrics=False)
        b.exchange = sub_p.dis.KVExchange(b.store, role="decode",
                                          metrics=False)
        try:
            a.demote("c", [3, 5], list(range(16)), 16, None)
            assert a.flush_jobs()
            assert a.export_to_exchange("c")
            assert a.flush_jobs()
            blob = a.store.load_kv("xchg:c")
            assert b.prepare("c", remote=True)
            entry = _claim_ready(b, "c")
            assert (entry.tokens, entry.length, entry.n_pages,
                    entry.source_tier, entry.from_exchange) == (
                list(range(16)), 16, 2, "store", True)
            leaves = _leaves(b, entry)
            want = np.stack([np.full((2, 4, 8), 3.0, np.float32),
                             np.full((2, 4, 8), 5.0, np.float32)], axis=1)
            assert np.asarray(leaves[0]).tobytes() == want.tobytes()
            # The payload bytes the claimer holds are the blob's own.
            bufs, _ = sys.modules[sub_p.Plane.__module__].decode_blob(blob)
            assert all(np.asarray(x)[:len(y)].tobytes() == y.tobytes()
                       for x, y in zip(entry.payload, bufs))
            b.release(entry)
            assert b.store.list_kv() == []      # claim consumed it
            assert (a.exchange.totals["published"],
                    b.exchange.totals["claimed"]) == (1, 1)
        finally:
            a.stop()
            b.stop()


# -- the off switch --------------------------------------------------------------


def mk_echo_engine(P, name="disagg0", tiering=None, metrics=False):
    tok = P.Tok()
    ex = P.Echo(batch_size=4, page_size=8, num_pages=128,
                max_pages_per_seq=16, eos_id=tok.eos_id, chunk_size=4)
    return P.Engine(ex, tok, enable_metrics=metrics, name=name,
                    kv_pin_ttl=600.0, kv_tiering=tiering,
                    prefix_cache=P.C.PrefixCacheConfig(enabled=True))


def run_turn(P, eng, rid, prompt, conv, history="", tokens=8):
    h = eng.submit(P.GenRequest(id=rid, prompt=prompt,
                                conversation_id=conv,
                                history_text=history,
                                max_new_tokens=tokens))
    eng.run_until_idle()
    assert h.result is not None and h.result.finish_reason in (
        "eos", "length")
    return h


class TestOffSwitch:
    def test_default_config_disabled(self):
        def run(P):
            cfg = P.config()
            return cfg.disagg.enabled, cfg.disagg.role, vars(cfg.disagg)

        enabled, role, _ = _same(run)
        assert (enabled, role) == (False, "unified")

    def test_build_disagg_none_and_engine_hooks_inert(self):
        def run(P):
            eng = mk_echo_engine(P, tiering=P.C.KVTieringConfig(enabled=True))
            try:
                built = P.dis.build_disagg(P.config(), eng,
                                           P.pers.InMemoryStore())
                h = run_turn(P, eng, "t1", "hello off-switch", "c")
                return (built, eng.disagg_role, eng.on_conversation_cached,
                        eng._tiering.exchange, h.result.text)
            finally:
                eng.stop()

        got = _same(run)
        assert got[:4] == (None, "unified", None, None) and got[4]

    def test_invalid_role_rejected(self):
        for P in PKGS:
            with pytest.raises(ValueError, match="unknown disagg role"):
                P.C.DisaggConfig(role="speculate")

    def test_health_omits_role_when_unified(self):
        def run(P):
            eng = mk_echo_engine(P)
            api = P.ApiServer(P.config(), engine=eng)
            try:
                before = "role" in api.health_check(None)[1]
                eng.disagg_role = "prefill"
                return before, api.health_check(None)[1]["role"]
            finally:
                eng.stop()

        assert _same(run) == (False, "prefill")

    def test_router_routes_identically_without_disagg(self):
        def run(P):
            eng_a, eng_b = mk_echo_engine(P, "ra"), mk_echo_engine(P, "rb")
            lb = P.LB(P.C.LoadBalancerConfig(strategy="round_robin",
                                             health_check_interval=0.0))
            eng_a.start()
            eng_b.start()
            router = P.Router(lb, config=P.C.ClusterConfig(),
                              enable_metrics=False)
            router.register_engine(eng_a, endpoint_id="ra")
            router.register_engine(eng_b, endpoint_id="rb")
            try:
                pref = router._role_pref(P.Message(
                    id="m", content="x" * 4096, user_id="u"), None)
                seen = []
                for i in range(4):
                    m = P.Message(id=f"m{i}", content="x" * 4096,
                                  user_id="u", timeout=30.0)
                    router.process_fn(None, m)
                    seen.append(m.metadata["endpoint_id"])
                return (router.disagg, pref, seen,
                        "disagg" in router.get_stats())
            finally:
                eng_a.stop()
                eng_b.stop()

        disagg, pref, seen, has_block = _same(run)
        assert (disagg, pref, has_block) == (None, None, False)
        assert set(seen) == {"ra", "rb"}


# -- role routing (roles learned from /health) ------------------------------------


class _Roled:
    """One echo replica per role, each behind its own REST server with
    its role on /health."""

    def __init__(self, P, roles):
        self.engines, self.servers, self.urls = [], [], []
        for i, role in enumerate(roles):
            eng = mk_echo_engine(P, f"replica{i}")
            eng.start()
            eng.disagg_role = role
            api = P.ApiServer(P.config(), engine=eng)
            port = api.start(host="127.0.0.1", port=0)
            self.engines.append(eng)
            self.servers.append(api)
            self.urls.append(f"http://127.0.0.1:{port}")

    def close(self):
        for s in self.servers:
            s.stop()
        for e in self.engines:
            e.stop()

    def roles_by_index(self, router):
        """role → replica index (endpoint ids carry each run's ports)."""
        out = {}
        for e in router.lb.endpoints():
            out[router._role_of(e)] = self.urls.index(e.url)
        return out


def _disagg_router(P, urls, *, state_manager=None, long_prompt_tokens=32,
                   **ccfg):
    lb = P.LB(P.C.LoadBalancerConfig(strategy="round_robin",
                                     health_check_interval=0.0))
    cfg = P.config()
    cfg.cluster = P.C.ClusterConfig(peers=list(urls), **ccfg)
    cfg.disagg = P.C.DisaggConfig(enabled=True,
                                  long_prompt_tokens=long_prompt_tokens)
    cfg.queue.enable_metrics = False
    router = P.build(cfg, lb, state_manager=state_manager)
    lb.check_health_once()
    return router


def _ep_index(router, roled, eid):
    return roled.urls.index(router.lb.get_endpoint_by_id(eid).url)


class TestRoleRouting:
    def test_roles_learned_from_health_probes(self):
        def run(P):
            roled = _Roled(P, ["prefill", "decode"])
            try:
                return roled.roles_by_index(_disagg_router(P, roled.urls))
            finally:
                roled.close()

        assert _same(run) == {"prefill": 0, "decode": 1}

    def test_long_first_turn_to_prefill_short_to_decode(self):
        def run(P):
            roled = _Roled(P, ["prefill", "decode"])
            try:
                router = _disagg_router(P, roled.urls, long_prompt_tokens=32)
                long_turn = P.Message(id="m1", content="x" * 200,
                                      user_id="u", timeout=30.0)
                router.process_fn(None, long_turn)
                short = P.Message(id="m2", content="hi", user_id="u",
                                  timeout=30.0)
                router.process_fn(None, short)
                return (_ep_index(router, roled,
                                  long_turn.metadata["endpoint_id"]),
                        _ep_index(router, roled,
                                  short.metadata["endpoint_id"]),
                        router.get_stats()["disagg"]["role_routes"])
            finally:
                roled.close()

        long_ix, short_ix, routes = _same(run)
        assert (long_ix, short_ix) == (0, 1) and routes >= 2

    def test_followup_handoff_leaves_prefill_affinity(self):
        def run(P):
            roled = _Roled(P, ["prefill", "decode"])
            sm = P.SM(P.C.ConversationConfig(cleanup_interval=0))
            try:
                sm.get_or_create("conv-h", "u")
                router = _disagg_router(P, roled.urls, state_manager=sm,
                                        long_prompt_tokens=32)
                t1 = P.Message(id="t1", content="y" * 200, user_id="u",
                               conversation_id="conv-h", timeout=30.0)
                router.process_fn(None, t1)
                t2 = P.Message(id="t2", content="followup", user_id="u",
                               conversation_id="conv-h", timeout=30.0,
                               metadata={"history_text": "y" * 200})
                router.process_fn(None, t2)
                st = router.get_stats()["disagg"]
                return (_ep_index(router, roled, t1.metadata["endpoint_id"]),
                        _ep_index(router, roled, t2.metadata["endpoint_id"]),
                        st["handoffs"], st["role_routes"])
            finally:
                roled.close()
                sm.stop()

        assert _same(run)[:3] == (0, 1, 1)

    def test_wrong_role_only_cluster_still_dispatches(self):
        def run(P):
            roled = _Roled(P, ["prefill", "prefill"])
            try:
                router = _disagg_router(P, roled.urls)
                m = P.Message(id="m1", content="hi", user_id="u",
                              timeout=30.0)
                router.process_fn(None, m)
                return (bool(m.metadata.get("endpoint_id")),
                        router.get_stats()["disagg"]["role_routes"])
            finally:
                roled.close()

        assert _same(run) == (True, 0)

    def test_unified_endpoints_serve_any_preference(self):
        def run(P):
            roled = _Roled(P, ["unified"])
            try:
                router = _disagg_router(P, roled.urls)
                out = []
                for i, content in enumerate(("z" * 200, "hi")):
                    m = P.Message(id=f"m{i}", content=content, user_id="u",
                                  timeout=30.0)
                    router.process_fn(None, m)
                    out.append(bool(m.metadata.get("endpoint_id")))
                st = router.get_stats()["disagg"]
                return (out, st["handoffs"], st["role_routes"],
                        sorted(st["roles"].values()))
            finally:
                roled.close()

        assert _same(run) == ([True, True], 0, 0, ["unified"])

    def test_prefill_eta_overrides_the_token_threshold(self):
        """With a learned rate the ETA decides (``long_prompt_ms``); a
        short prompt whose ETA reaches it goes to prefill. Estimated
        tokens are ``len(content) // 4`` in both."""
        def run(P):
            roled = _Roled(P, ["prefill", "decode"])
            try:
                router = _disagg_router(P, roled.urls,
                                        long_prompt_tokens=10 ** 6)
                seen = []
                router.prefill_eta = lambda n: (seen.append(n) or 1e3)
                m = P.Message(id="m1", content="abcd" * 5, user_id="u",
                              timeout=30.0)
                router.process_fn(None, m)
                router.prefill_eta = lambda n: 1.0
                m2 = P.Message(id="m2", content="x" * 4000, user_id="u",
                               timeout=30.0)
                router.process_fn(None, m2)
                return (seen, _ep_index(router, roled,
                                        m.metadata["endpoint_id"]),
                        _ep_index(router, roled,
                                  m2.metadata["endpoint_id"]))
            finally:
                roled.close()

        assert _same(run) == ([5], 0, 1)


# -- the planes' exchange --------------------------------------------------------


class TestPlaneExchange:
    def test_cross_plane_payload_roundtrip(self):
        def run(P):
            store = P.pers.InMemoryStore()
            a, b = mk_plane(P, "prefillA", store), mk_plane(P, "decodeB",
                                                            store)
            a.exchange = P.dis.KVExchange(store, role="prefill",
                                          metrics=False)
            b.exchange = P.dis.KVExchange(store, role="decode",
                                          metrics=False)
            try:
                a.demote("c", [3, 5], list(range(16)), 16, None)
                assert a.flush_jobs()
                queued = a.export_to_exchange("c")
                assert a.flush_jobs()
                prepared = b.prepare("c", remote=True)
                entry = _claim_ready(b, "c")
                leaves = _leaves(b, entry)
                out = (queued, prepared, entry.tokens, entry.source_tier,
                       float(np.asarray(leaves[0])[:, 0].min()),
                       float(np.asarray(leaves[0])[:, 1].max()))
                b.release(entry)
                return out
            finally:
                a.stop()
                b.stop()

        assert _same(run) == (True, True, list(range(16)), "store", 3.0, 5.0)

    def test_exchange_miss_degrades_and_negative_caches(self):
        def run(P):
            store = P.pers.InMemoryStore()
            b = mk_plane(P, "decodeB", store)
            b.exchange = P.dis.KVExchange(store, role="decode", metrics=False,
                                          miss_ttl_s=60.0)
            try:
                first = b.prepare("ghost", remote=True)
                assert wait_until(lambda: b.claim("ghost")[0] == "none")
                return first, b.prepare("ghost", remote=True)
            finally:
                b.stop()

        assert _same(run) == (True, False)

    def test_miss_cache_expires_after_miss_ttl(self):
        """The negative cache holds for ``miss_ttl_s`` on the plane's
        clock, then the exchange is asked again."""
        def run(P):
            store = P.pers.InMemoryStore()
            b = mk_plane(P, "decodeB", store)
            b.exchange = P.dis.KVExchange(store, role="decode", metrics=False,
                                          miss_ttl_s=60.0)
            now = [0.0]
            b._now = lambda: now[0]
            try:
                assert b.prepare("ghost", remote=True)
                assert wait_until(lambda: b.claim("ghost")[0] == "none")
                held = b.prepare("ghost", remote=True)
                now[0] += 61.0
                again = b.prepare("ghost", remote=True)
                assert wait_until(lambda: b.claim("ghost")[0] == "none")
                return held, again
            finally:
                b.stop()

        assert _same(run) == (False, True)

    def test_local_prepare_never_touches_exchange(self):
        def run(P):
            store = P.pers.InMemoryStore()
            b = mk_plane(P, "decodeB", store)
            b.exchange = P.dis.KVExchange(store, metrics=False)
            try:
                return (b.prepare("nothing-local", remote=False),
                        b.claim("nothing-local"))
            finally:
                b.stop()

        assert _same(run) == (False, ("none", None))

    def test_foreign_spec_refused_tokens_survive(self):
        def run(P):
            store = P.pers.InMemoryStore()
            b = mk_plane(P, "decodeB", store)
            b.exchange = P.dis.KVExchange(store, role="decode", metrics=False)
            pub = P.dis.KVExchange(store, role="prefill", metrics=False)
            foreign = [((4, 8, 16), np.dtype(np.int8))]
            fbufs = [np.zeros(4 * 8 * 16, np.uint8) for _ in range(2)]
            pub.publish("c", fbufs, foreign,
                        {"conv_id": "c", "tokens": [9, 8, 7], "length": 3,
                         "n_pages": 2})
            try:
                assert b.prepare("c", remote=True)
                entry = _claim_ready(b, "c")
                out = entry.payload, entry.tier, entry.tokens
                b.release(entry)
                return out
            finally:
                b.stop()

        assert _same(run) == (None, "recompute", [9, 8, 7])

    def test_publish_of_a_store_entry_republishes_its_blob(self):
        """A held entry already spilled to the store publishes its blob's
        pages (the plane reads them back), not metadata alone."""
        def run(P):
            store = P.pers.InMemoryStore()
            a = mk_plane(P, "prefillA", store,
                         P.C.KVTieringConfig(enabled=True,
                                             host_capacity_mb=0))
            a.exchange = P.dis.KVExchange(store, role="prefill",
                                          metrics=False)
            sub = P.dis.KVExchange(store, role="decode", metrics=False)
            try:
                a.demote("c", [4], list(range(8)), 8, None)
                assert wait_until(lambda: a.counts().get("store", 0) == 1)
                assert a.export_to_exchange("c")
                assert a.flush_jobs()
                bufs, specs, meta = sub.claim("c")
                return (len(bufs), [tuple(s[0]) for s in specs],
                        meta["tokens"], meta["owner"])
            finally:
                a.stop()

        assert _same(run) == (1, [(2, 4, 8)], list(range(8)), "prefillA")


# -- the conversation handoff (echo engines) ---------------------------------------


def mk_disagg_engine(P, name, role, store, *, claim_ttl=120.0, now_fn=None,
                     metrics=False):
    eng = mk_echo_engine(P, name, tiering=P.C.KVTieringConfig(enabled=True),
                         metrics=metrics)
    sm = P.SM(P.C.ConversationConfig(cleanup_interval=0), store=store)
    eng.attach_conversation_manager(sm)
    xchg = P.dis.KVExchange(store, role=role, claim_ttl_s=claim_ttl,
                            metrics=metrics, now_fn=now_fn)
    coord = P.dis.DisaggCoordinator(
        P.C.DisaggConfig(enabled=True, role=role, claim_ttl_s=claim_ttl),
        eng, xchg)
    return eng, sm, coord


class TestConversationHandoff:
    def test_prefill_publishes_decode_claims_zero_recompute(self):
        def run(P):
            store = P.pers.InMemoryStore()
            peng, psm, pcoord = mk_disagg_engine(P, "prefill0", "prefill",
                                                 store)
            deng, dsm, dcoord = mk_disagg_engine(P, "decode0", "decode",
                                                 store)
            try:
                psm.get_or_create("c", "u")
                h1 = run_turn(P, peng, "t1", "the quick brown fox", "c")
                assert wait_until(lambda: P.dis.KVExchange.key_for("c")
                                  in store.list_kv())
                h2 = run_turn(P, deng, "t2", " jumps over", "c",
                              history="the quick brown fox")
                st = deng.get_stats()["kv_tiering"]
                return (h1.result.text, h2.result.text, h2.result.kv_tier,
                        h2.result.cached_tokens,
                        st["hits"].get("recompute", 0),
                        pcoord.exchange.totals["published"],
                        dcoord.exchange.totals["claimed"],
                        peng.cached_conversations())
            finally:
                for x in (peng, deng, psm, dsm):
                    x.stop()

        got = _same(run)
        assert got[2] == "store" and got[3] > 0 and got[4] == 0
        assert got[5:] == (1, 1, [])

    def test_expired_claim_falls_back_to_recompute_identically(self):
        def run(P):
            base = mk_echo_engine(P, "base0",
                                  tiering=P.C.KVTieringConfig(enabled=True))
            want = run_turn(P, base, "tb", " jumps over", "c",
                            history="the quick brown fox").result.tokens
            base.stop()
            now = FakeNow()
            store = P.pers.InMemoryStore()
            peng, psm, _ = mk_disagg_engine(P, "prefill0", "prefill", store,
                                            claim_ttl=10.0, now_fn=now)
            deng, dsm, dcoord = mk_disagg_engine(P, "decode0", "decode",
                                                 store, claim_ttl=10.0,
                                                 now_fn=now)
            try:
                psm.get_or_create("c", "u")
                run_turn(P, peng, "t1", "the quick brown fox", "c")
                assert wait_until(lambda: P.dis.KVExchange.key_for("c")
                                  in store.list_kv())
                now.t += 11.0
                h2 = run_turn(P, deng, "t2", " jumps over", "c",
                              history="the quick brown fox")
                return (h2.result.tokens == want, h2.result.tokens,
                        dcoord.exchange.totals["expired"])
            finally:
                for x in (peng, deng, psm, dsm):
                    x.stop()

        got = _same(run)
        assert got[0] is True and got[2] == 1

    def test_drain_publish_warm_migrates_conversations(self):
        def run(P):
            store = P.pers.InMemoryStore()
            aeng, asm, acoord = mk_disagg_engine(P, "unified0", "unified",
                                                 store)
            beng, bsm, _ = mk_disagg_engine(P, "decode0", "decode", store)
            try:
                asm.get_or_create("warm", "u")
                run_turn(P, aeng, "t1", "conversation to migrate", "warm")
                key = P.dis.KVExchange.key_for("warm")
                before = key in store.list_kv()
                n = acoord.publish_warm()
                assert acoord.plane.flush_jobs()
                after = key in store.list_kv()
                h2 = run_turn(P, beng, "t2", " resumed elsewhere", "warm",
                              history="conversation to migrate")
                st = beng.get_stats()["kv_tiering"]
                return (before, n, after, h2.result.kv_tier,
                        st["hits"].get("recompute", 0), h2.result.tokens)
            finally:
                for x in (aeng, beng, asm, bsm):
                    x.stop()

        assert _same(run)[:5] == (False, 1, True, "store", 0)

    def test_publish_hook_stamps_kv_publish_and_handoff_claim(self):
        """The prefill side's trace carries a ``kv_publish`` stage event;
        the decode side's turn 2 a ``handoff_claim`` span in place of
        ``kv_promote``, in both packages' flight recorders."""
        from llmq_tpu import observability as jobs
        from llmq_tpu_torch import observability as tobs

        def run(P):
            obs = jobs if P is JAX else tobs
            store = P.pers.InMemoryStore()
            peng, psm, _ = mk_disagg_engine(P, "prefill0", "prefill", store)
            deng, dsm, _ = mk_disagg_engine(P, "decode0", "decode", store)
            try:
                psm.get_or_create("c", "u")
                run_turn(P, peng, f"{P.name}-p1", "the quick brown fox", "c")
                assert wait_until(lambda: P.dis.KVExchange.key_for("c")
                                  in store.list_kv())
                run_turn(P, deng, f"{P.name}-d2", " jumps over", "c")
                rec = obs.get_recorder()

                def stages(rid):
                    tl = rec.get(rid)
                    return [e.stage for e in tl.events] if tl else []

                s1, s2 = stages(f"{P.name}-p1"), stages(f"{P.name}-d2")
                return ("kv_publish" in s1,
                        [s for s in s2 if "promote" in s or "handoff" in s])
            finally:
                for x in (peng, deng, psm, dsm):
                    x.stop()
                obs.get_recorder().clear()

        assert _same(run) == (True, ["handoff_claim_start",
                                     "handoff_claim_done"])


# -- the float32 model handoff ------------------------------------------------------


KW = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          vocab_size=512, max_seq_len=256)
GEOM = dict(batch_size=2, page_size=8, num_pages=64,
            prefill_buckets=[16, 64], chunk_size=4)


@pytest.fixture(scope="module")
def models():
    jcfg = J.llama3_tiny(dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.llama3_tiny(dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _model_engine(P, models, name, tiering):
    jcfg, jparams, tcfg, tparams = models
    tok = P.Tok()
    if P is JAX:
        ex = JaxExecutor(jcfg, jparams, eos_id=tok.eos_id, **GEOM)
    else:
        ex = TorchExecutor(tcfg, tparams, eos_id=tok.eos_id, device="cpu",
                           **GEOM)
    return P.Engine(ex, tok, name=name, enable_metrics=False,
                    max_decode_steps=12, kv_pin_ttl=600.0,
                    kv_tiering=tiering)


def test_f32_model_handoff_equals_jax_and_unified(models):
    """Turn 1 on a prefill engine, turn 2 on a decode engine that never
    saw the conversation, over one store: the decode side claims turn
    1's KV from the exchange (a store hit, its cached tokens the whole
    turn-1 stream, 0 recomputed) and its tokens equal a unified engine's
    (the pin resident) and JAX's two-engine flow's, token for token."""
    def run(P):
        uni = _model_engine(P, models, "uni", None)
        u1 = run_turn(P, uni, "u1", "the quick brown fox", "c", tokens=10)
        u2 = run_turn(P, uni, "u2", " jumps over", "c", tokens=10)
        uni.stop()
        store = P.pers.InMemoryStore()
        tier = P.C.KVTieringConfig(enabled=True)
        engines, coords = [], []
        for name, role in (("prefill0", "prefill"), ("decode0", "decode")):
            eng = _model_engine(P, models, name, tier)
            eng._tiering.store = store
            coords.append(P.dis.DisaggCoordinator(
                P.C.DisaggConfig(enabled=True, role=role), eng,
                P.dis.KVExchange(store, role=role, metrics=False)))
            engines.append(eng)
        peng, deng = engines
        try:
            h1 = run_turn(P, peng, "t1", "the quick brown fox", "c",
                          tokens=10)
            assert wait_until(lambda: P.dis.KVExchange.key_for("c")
                              in store.list_kv(), timeout=30.0)
            h2 = run_turn(P, deng, "t2", " jumps over", "c", tokens=10)
            st = deng.get_stats()["kv_tiering"]
            return dict(
                unified=[u1.result.tokens, u2.result.tokens],
                disagg=[h1.result.tokens, h2.result.tokens],
                cached=[u2.result.cached_tokens, h2.result.cached_tokens],
                tier=h2.result.kv_tier,
                recompute=st["hits"].get("recompute", 0),
                claimed=coords[1].exchange.totals["claimed"])
        finally:
            peng.stop()
            deng.stop()

    got = _same(run)
    assert got["disagg"] == got["unified"] and all(got["unified"])
    assert got["tier"] == "store" and got["recompute"] == 0
    assert got["cached"][0] == got["cached"][1] > 0
    assert got["claimed"] == 1


# -- rehydration ---------------------------------------------------------------------


class TestRehydration:
    def test_plane_rehydrate_owned_blobs_only(self):
        def run(P):
            store = P.pers.InMemoryStore()
            cfg = P.C.KVTieringConfig(enabled=True, host_capacity_mb=0)
            a = mk_plane(P, "replica0", store, cfg)
            a.demote("mine", [2, 4], list(range(16)), 16, None)
            assert wait_until(lambda: a.counts().get("store", 0) == 1)
            a.stop()
            b = mk_plane(P, "replica1", store, cfg)
            b.demote("theirs", [6], list(range(8)), 8, None)
            assert wait_until(lambda: b.counts().get("store", 0) == 1)
            b.stop()
            P.dis.KVExchange(store, metrics=False).publish(
                "xc", _bufs(1), SPECS, {"conv_id": "xc"})
            restarted = mk_plane(P, "replica0", store, cfg)
            try:
                adopted = [cid for cid, _ in
                           restarted.rehydrate(owner="replica0")]
                status, entry = restarted.claim("mine")
                leaves = _leaves(restarted, entry)
                out = (adopted, status, entry.source_tier,
                       float(np.asarray(leaves[0])[:, 0].max()))
                restarted.release(entry)
                return out
            finally:
                restarted.stop()

        assert _same(run) == (["mine"], "ready", "store", 2.0)

    def test_rehydrate_registers_prefix_handles(self):
        def run(P):
            store = P.pers.InMemoryStore()
            cfg = P.C.KVTieringConfig(enabled=True, host_capacity_mb=0)
            a = mk_plane(P, "restart0", store, cfg)
            a.demote("c", [3], list(range(8)), 8, None)
            assert wait_until(lambda: a.counts().get("store", 0) == 1)
            a.stop()
            eng = mk_echo_engine(P, "restart0",
                                 tiering=P.C.KVTieringConfig(enabled=True))
            sm = P.SM(P.C.ConversationConfig(cleanup_interval=0),
                      store=store)
            sm.get_or_create("c", "u")
            sm.stop()
            eng._tiering.stop()
            eng._tiering = P.Plane(cfg, "restart0", FakeKVExec())
            sm2 = P.SM(P.C.ConversationConfig(cleanup_interval=0),
                       store=store)
            eng.attach_conversation_manager(sm2)
            try:
                n = eng.rehydrate_tiered_conversations()
                h = sm2.prefix_handle("c")
                cached, _ = eng.prefill_estimate("c", 4)
                return (n, h["tier"], h["length"], h["pages"], cached > 0)
            finally:
                eng.stop()
                sm2.stop()

        assert _same(run) == (1, "store", 8, 1, True)

    def test_build_disagg_rehydrates_on_start(self):
        def run(P):
            store = P.pers.InMemoryStore()
            cfg = P.C.KVTieringConfig(enabled=True, host_capacity_mb=0)
            a = mk_plane(P, "boot0", store, cfg)
            a.demote("c", [5], list(range(8)), 8, None)
            assert wait_until(lambda: a.counts().get("store", 0) == 1)
            a.stop()
            full = P.config()
            full.disagg = P.C.DisaggConfig(enabled=True, role="decode")
            eng = mk_echo_engine(P, "boot0",
                                 tiering=P.C.KVTieringConfig(enabled=True))
            eng._tiering.stop()
            eng._tiering = P.Plane(cfg, "boot0", FakeKVExec())
            sm = P.SM(P.C.ConversationConfig(cleanup_interval=0),
                      store=store)
            sm.get_or_create("c", "u")
            eng.attach_conversation_manager(sm)
            try:
                coord = P.dis.build_disagg(full, eng, store)
                return (coord is not None, coord.role,
                        eng._tiering.counts().get("store", 0),
                        eng.disagg_role, eng._tiering.exchange is not None,
                        eng.on_conversation_cached is None)
            finally:
                eng.stop()
                sm.stop()

        assert _same(run) == (True, "decode", 1, "decode", True, True)


# -- metrics -------------------------------------------------------------------------


def _snapshot(fam):
    """A prometheus_client family's children, for putting them back."""
    out = {}
    for k, c in list(fam._metrics.items()):
        if hasattr(c, "_buckets"):
            out[k] = ("h", [b.get() for b in c._buckets], c._sum.get())
        else:
            out[k] = ("v", c._value.get())
    return out


def _restore(fam, snap):
    with fam._lock:
        for k in list(fam._metrics):
            if k not in snap:
                del fam._metrics[k]
    for k, v in snap.items():
        c = fam.labels(*k)
        if v[0] == "h":
            for b, x in zip(c._buckets, v[1]):
                b.set(x)
            c._sum.set(v[2])
        else:
            c._value.set(v[1])


@pytest.fixture
def jax_exchange_metrics():
    """The JAX package's five exchange families as they were: its own
    test reads them as absolute values."""
    jm = jreg.get_metrics()
    fams = [jm.kv_exchange_published, jm.kv_exchange_claimed,
            jm.kv_exchange_expired, jm.kv_exchange_fallback,
            jm.kv_handoff_ms]
    snaps = [_snapshot(f) for f in fams]
    yield
    for f, s in zip(fams, snaps):
        _restore(f, s)


def _sample(text, name, labels):
    for ln in text.splitlines():
        if ln.startswith(f"{name}{{{labels}}} "):
            return float(ln.rsplit(" ", 1)[1])
    return 0.0


class TestDisaggMetrics:
    def test_label_contract_covers_disagg(self):
        assert treg.LABEL_CONTRACT["role"] == jreg.LABEL_CONTRACT["role"] == \
            frozenset({"prefill", "decode", "unified"})
        assert "handoff" in treg.LABEL_CONTRACT["reason"]
        assert treg.LABEL_CONTRACT["reason"] == jreg.LABEL_CONTRACT["reason"]

    def test_exchange_families_flushed_at_scrape(self, jax_exchange_metrics):
        keys = [("llm_queue_kv_exchange_published_total", 'role="prefill"'),
                ("llm_queue_kv_exchange_claimed_total", 'role="decode"'),
                ("llm_queue_kv_exchange_expired_total", 'role="prefill"'),
                ("llm_queue_kv_exchange_fallback_total", 'role="decode"'),
                ("llm_queue_kv_handoff_ms_count", 'role="decode"')]

        def run(P):
            text0 = P.exposition()
            before = [_sample(text0, n, lab) for n, lab in keys]
            store = P.pers.InMemoryStore()
            now = FakeNow()
            pub = P.dis.KVExchange(store, role="prefill", claim_ttl_s=10.0,
                                   metrics=True, now_fn=now)
            sub = P.dis.KVExchange(store, role="decode", claim_ttl_s=10.0,
                                   metrics=True, now_fn=now)
            pub.publish("a", _bufs(1), SPECS, {"conv_id": "a"})
            assert sub.claim("a") is not None
            pub.publish("b", _bufs(1), SPECS, {"conv_id": "b"})
            now.t += 11.0
            assert sub.claim("b") is None
            sub.note_fallback()
            text = P.exposition()
            P.dis.flush_metrics()
            return ([_sample(text, n, lab) - b
                     for (n, lab), b in zip(keys, before)],
                    sub.totals["claimed"])

        assert _same(run) == ([2.0, 1.0, 1.0, 1.0, 1.0], 1)


# -- role-aware scaling ------------------------------------------------------------------


class TestRoleAwareScaling:
    def test_new_replica_joins_underrepresented_side(self):
        def run(P):
            engines = []

            def factory(seq):
                eng = mk_echo_engine(P, f"pool{seq}")
                eng.start()
                engines.append(eng)
                return eng

            lb = P.LB(P.C.LoadBalancerConfig(strategy="round_robin",
                                             health_check_interval=0.0))
            router = P.Router(lb, config=P.C.ClusterConfig(),
                              enable_metrics=False)
            pool = P.LocalPool(factory, supervise=False)
            ctl = P.Controller(
                config=P.C.ControlPlaneConfig(enabled=True, interval=0),
                router=router, pool=pool, enable_metrics=False)
            ctl.disagg = P.C.DisaggConfig(enabled=True)
            out = []
            try:
                out.append(ctl._role_for_new_replica())
                out.append(ctl._provision_one())
                out.append(router._role_of(router.lb.endpoints()[0]))
                out.append(ctl._role_for_new_replica())
                out.append(ctl._provision_one())
                out.append(sorted(router._role_of(e)
                                  for e in router.lb.endpoints()))
                ctl.disagg = None
                out.append(ctl._role_for_new_replica())
                out.append(ctl._provision_one())
                out.append(pool.role_hint)
                return out
            finally:
                pool.stop()
                for e in engines:
                    if e.running:
                        e.stop()

        assert _same(run) == ["decode", True, "decode", "prefill", True,
                              ["decode", "prefill"], None, True, None]


# -- SIGKILL mid-handoff over real processes -----------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_health(url: str, proc, timeout: float = 90.0) -> None:
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"{url}'s process exited {proc.returncode}")
        try:
            with urllib.request.urlopen(f"{url}/health", timeout=2) as r:
                if r.status == 200:
                    return
        except OSError as e:
            last = e
        time.sleep(0.1)
    raise TimeoutError(f"{url} never became healthy: {last}")


def _post(url: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"{url}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _get(url: str, path: str) -> dict:
    with urllib.request.urlopen(f"{url}{path}", timeout=10) as r:
        return json.loads(r.read())


def _scrape(url: str) -> str:
    with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
        return r.read().decode()


def _counter(text: str, family: str) -> float:
    total = 0.0
    for ln in text.splitlines():
        if ln.startswith(family) and " " in ln:
            total += float(ln.rsplit(" ", 1)[1])
    return total


def _spawn(args, cwd, env, log):
    return subprocess.Popen(
        [sys.executable, "-m", "llmq_tpu_torch"] + args, cwd=cwd, env=env,
        stdout=open(log, "wb"), stderr=subprocess.STDOUT)


#: Wall limit of the real-process case (its own; typically ~25 s here).
SIGKILL_CASE_LIMIT_S = 240.0


def test_prefill_sigkill_mid_handoff_zero_loss_zero_dup(tmp_path):
    """One prefill and one decode ``python -m llmq_tpu_torch --backend
    echo`` replica over one sqlite store, a ``gateway --peers`` routing
    by role. Long first turns land on the prefill replica, which
    publishes each finished turn; the prefill replica is SIGKILLed with
    a second wave in flight; every message reaches exactly one
    completion (InvariantChecker), the follow-ups avoid the dead replica
    and the decode replica claims the dead one's published KV."""
    t0 = time.time()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("LLMQ_CONFIG", None)
    env.update({
        "LLMQ_QUEUE_ENABLE_METRICS": "true",
        "LLMQ_LOADBALANCER_STRATEGY": "round_robin",
        "LLMQ_LOADBALANCER_HEALTH_CHECK_INTERVAL": "0.5",
        "LLMQ_QUEUE_WORKER_PROCESS_INTERVAL": "0.01",
        "LLMQ_DISAGG_ENABLED": "true",
        "LLMQ_DISAGG_LONG_PROMPT_TOKENS": "32",
        "LLMQ_EXECUTOR_KV_TIERING_ENABLED": "true",
        "LLMQ_PERSISTENCE_BACKEND": "sqlite",
        "LLMQ_PERSISTENCE_SQLITE_PATH": str(tmp_path / "shared.db"),
    })
    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    procs = []
    for port, role in zip(ports, ("prefill", "decode")):
        procs.append(_spawn(["--backend", "echo", "--device", "cpu",
                             "--host", "127.0.0.1", "--port", str(port),
                             "serve"], tmp_path,
                            dict(env, LLMQ_DISAGG_ROLE=role),
                            tmp_path / f"{role}.log"))
    prefill = procs[0]
    gw_port = _free_port()
    gw = f"http://127.0.0.1:{gw_port}"
    ck = InvariantChecker()
    try:
        for u, p in zip(urls, procs):
            _wait_health(u, p)
        assert _get(urls[0], "/health")["role"] == "prefill"
        assert _get(urls[1], "/health")["role"] == "decode"
        procs.append(_spawn(["--host", "127.0.0.1", "--port", str(gw_port),
                             "--peers", f"{urls[0]},{urls[1]}", "gateway"],
                            tmp_path, env, tmp_path / "gateway.log"))
        _wait_health(gw, procs[-1])

        def roles_learned():
            st = _get(gw, "/api/v1/cluster/stats")
            r = (st.get("disagg") or {}).get("roles") or {}
            return set(r.values()) == {"prefill", "decode"}

        assert wait_until(roles_learned, timeout=20.0, step=0.2)

        def drain_all(mids, deadline_s=60.0):
            deadline = time.time() + deadline_s
            left = set(mids)
            while left and time.time() < deadline:
                for mid in list(left):
                    m = _get(gw, f"/api/v1/messages/{mid}")
                    if m["status"] == "completed" and m["response"]:
                        ck.completed(mid)
                        left.discard(mid)
                    elif m["status"] == "failed":
                        ck.failed(mid)
                        left.discard(mid)
                if left:
                    time.sleep(0.05)
            return left

        convs, turn1 = [], []
        for i in range(6):
            conv = _post(gw, "/api/v1/conversations",
                         {"user_id": "t"})["conversation_id"]
            convs.append(conv)
            mid = _post(gw, f"/api/v1/conversations/{conv}/messages",
                        {"content": f"long prompt {i} " + "x" * 220,
                         "user_id": "t"})["message_id"]
            ck.submitted(mid)
            turn1.append(mid)
        assert drain_all(turn1) == set()
        by_ep = {}
        for mid in turn1:
            ep = _get(gw, f"/api/v1/messages/{mid}")["metadata"][
                "endpoint_id"]
            by_ep[ep] = by_ep.get(ep, 0) + 1
        roles = _get(gw, "/api/v1/cluster/stats")["disagg"]["roles"]
        prefill_ep = next(e for e, r in roles.items() if r == "prefill")
        assert by_ep == {prefill_ep: 6}
        assert wait_until(lambda: _counter(
            _scrape(urls[0]),
            'llm_queue_kv_exchange_published_total{role="prefill"}') >= 6,
            timeout=10.0, step=0.1)

        wave2 = []
        for i in range(4):
            mid = _post(gw, "/api/v1/messages",
                        {"content": f"wave2 {i} " + "y" * 220,
                         "user_id": "t"})["message_id"]
            ck.submitted(mid)
            wave2.append(mid)
        prefill.send_signal(signal.SIGKILL)
        prefill.wait(timeout=10)

        turn2 = []
        for conv in convs:
            mid = _post(gw, f"/api/v1/conversations/{conv}/messages",
                        {"content": "follow-up", "user_id": "t"}
                        )["message_id"]
            ck.submitted(mid)
            turn2.append(mid)
        assert drain_all(wave2) == set()
        assert drain_all(turn2) == set()
        ck.check()
        for mid in turn2:
            ep = _get(gw, f"/api/v1/messages/{mid}")["metadata"][
                "endpoint_id"]
            assert ep != prefill_ep
        dec = _scrape(urls[1])
        assert _counter(
            dec, 'llm_queue_kv_exchange_claimed_total{role="decode"}') >= 1
        assert "llm_queue_kv_handoff_ms_count" in dec
        assert time.time() - t0 < SIGKILL_CASE_LIMIT_S
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=5)
