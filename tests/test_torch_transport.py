"""The port's HTTP transport to peer serve processes against the JAX
package's, on the CPU: each case runs through both packages' echo
engines behind their own ``ApiServer`` (or, for the OS-process case,
both packages' routers over the same two port ``serve`` processes), and
the outcomes must be equal (tolerance: none).

Mirrors ``tests/test_transport.py`` case for case: a generate over HTTP
with its usage, a dead engine behind a live server reading unhealthy,
a router over two peers with conversation affinity and failover
through the health machine (the cluster router with ``session``
affinity: the dispatch is its own), two real ``python -m
llmq_tpu_torch serve`` processes with one SIGKILLed, the probe's causes
(``refused`` feeds the breaker; ``draining`` and ``stopped`` do not),
the deadline gate before any I/O, an open breaker refusing without a
socket, and a clean probe clearing a closed breaker's streak. Added: a
504 from the peer is a TimeoutError that never feeds the breaker, and
the ``transport.*`` chaos points."""

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

import pytest

from llmq_tpu import chaos as jchaos
from llmq_tpu.api.server import ApiServer as JApiServer
from llmq_tpu.cluster import ClusterRouter as JClusterRouter
from llmq_tpu.core import config as JC
from llmq_tpu.core import types as jtypes
from llmq_tpu.engine.engine import InferenceEngine as JEngine
from llmq_tpu.engine.executor import EchoExecutor as JEcho
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok
from llmq_tpu.loadbalancer import circuit_breaker as jcb
from llmq_tpu.loadbalancer import load_balancer as jlb
from llmq_tpu.loadbalancer import transport as jtransport

from llmq_tpu_torch import chaos as tchaos
from llmq_tpu_torch.api.server import ApiServer as TApiServer
from llmq_tpu_torch.cluster import ClusterRouter as TClusterRouter
from llmq_tpu_torch.core import config as TC
from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.engine.engine import InferenceEngine as TEngine
from llmq_tpu_torch.engine.executor import EchoExecutor as TEcho
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from llmq_tpu_torch.loadbalancer import circuit_breaker as tcb
from llmq_tpu_torch.loadbalancer import load_balancer as tlb
from llmq_tpu_torch.loadbalancer import transport as ttransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(
    name="jax", chaos=jchaos, C=JC, config=JC.default_config, Engine=JEngine,
    Echo=JEcho, Tok=JTok, ApiServer=JApiServer, Message=jtypes.Message,
    Priority=jtypes.Priority, cb=jcb, lb=jlb, Router=JClusterRouter,
    transport=jtransport)
PORT = types.SimpleNamespace(
    name="port", chaos=tchaos, C=TC, config=TC.Config, Engine=TEngine,
    Echo=TEcho, Tok=TTok, ApiServer=TApiServer, Message=ttypes.Message,
    Priority=ttypes.Priority, cb=tcb, lb=tlb, Router=TClusterRouter,
    transport=ttransport)
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _chaos_reset():
    """Every case leaves both processes' chaos planes disarmed."""
    yield
    jchaos.configure(None)
    tchaos.configure(None)


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


def _engine(P, name="engine0"):
    eng = P.Engine(P.Echo(batch_size=4), P.Tok(), name=name,
                   enable_metrics=False)
    eng.start()
    return eng


class _Pair:
    """Two echo engines of one package, each behind its own REST server."""

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


def _both(scenario):
    """The scenario over each package's pair; the outcomes must match."""
    out = {}
    for P in PKGS:
        pair = _Pair(P)
        try:
            out[P.name] = scenario(P, pair)
        finally:
            pair.close()
    assert out["port"] == out["jax"]
    return out["port"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _free_port_url() -> str:
    return f"http://127.0.0.1:{_free_port()}"


def _lb(P):
    return P.lb.LoadBalancer(P.C.LoadBalancerConfig(
        strategy="round_robin", health_check_interval=0.0))


def _router(P, lb):
    """The load balancer's session affinity and one attempt per message:
    a dead replica leaves the rotation through the health machine."""
    return P.Router(lb, config=P.C.ClusterConfig(affinity="session",
                                                 failover_retries=0),
                    enable_metrics=False)


def test_http_client_generates():
    def run(P, pair):
        client = P.transport.HttpEngineClient(pair.urls[0])
        ok = client.healthy()
        msg = P.Message(id="t1", content="hello transport", user_id="u")
        client.process_fn(None, msg)
        usage = msg.metadata["usage"]
        return (ok, msg.response, usage["completion_tokens"] > 0,
                client.last_health.get("engine"))

    assert _both(run) == (True, "hello transport", True, "running")


def test_http_client_reports_dead_engine_unhealthy():
    def run(P, pair):
        client = P.transport.HttpEngineClient(pair.urls[0])
        before = client.healthy()
        pair.engines[0].stop()      # the server stays up, the engine is gone
        return before, client.healthy(), client.probe()

    assert _both(run) == (True, False, "stopped")


def test_gateway_routes_with_affinity_and_failover():
    def run(P, pair):
        lb = _lb(P)
        router = _router(P, lb)
        router.register_remote(pair.urls[0], endpoint_id="eng0")
        router.register_remote(pair.urls[1], endpoint_id="eng1")
        trace = []
        for i in range(4):
            msg = P.Message(id=f"a{i}", content=f"turn {i}", user_id="u",
                            conversation_id="conv-x")
            router.process_fn(None, msg)
            trace.append((msg.response, msg.metadata["endpoint_id"]))
        sticky = trace[0][1]
        pair.engines[0 if sticky == "eng0" else 1].stop()
        for _ in range(4):     # degraded → unhealthy takes 3 failures
            lb.check_health_once()
        msg = P.Message(id="f1", content="after failover", user_id="u",
                        conversation_id="conv-x")
        router.process_fn(None, msg)
        trace.append((msg.response, msg.metadata["endpoint_id"]))
        trace.append({e.id: (e.status.value, e.total_requests,
                             e.connections) for e in lb.endpoints()})
        return trace

    trace = _both(run)
    assert {t[1] for t in trace[:4]} == {"eng0"}
    assert trace[4] == ("after failover", "eng1")


def _spawn_serve(port: int, cwd: str) -> subprocess.Popen:
    env = dict(os.environ)
    # A config another test left named must not reach the children.
    env.pop("LLMQ_CONFIG", None)
    env.update({"LLMQ_QUEUE_ENABLE_METRICS": "false",
                "LLMQ_EXECUTOR_BACKEND": "echo",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    return subprocess.Popen(
        [sys.executable, "-m", "llmq_tpu_torch", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), "serve"],
        cwd=cwd, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


def _wait_health(url: str, deadline_s: float = 60.0) -> None:
    deadline = time.time() + deadline_s
    last = None
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"{url}/health", timeout=2) as r:
                if json.loads(r.read()).get("engine") == "running":
                    return
        except OSError as e:
            last = e
        time.sleep(0.1)
    raise TimeoutError(f"{url} never became healthy: {last}")


def test_two_os_process_serve_failover(tmp_path):
    """Two ``python -m llmq_tpu_torch serve`` processes (echo backend on
    the CPU) behind both packages' routers: round robin over both hosts,
    then one host SIGKILLed and every message served by the other after
    the probes, with the same picks in both packages."""
    ports = [_free_port(), _free_port()]
    procs = [_spawn_serve(p, str(tmp_path)) for p in ports]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    routers = {}
    try:
        for u in urls:
            _wait_health(u)
        phase1 = {}
        for P in PKGS:
            lb = _lb(P)
            router = _router(P, lb)
            router.register_remote(urls[0], endpoint_id="host0")
            router.register_remote(urls[1], endpoint_id="host1")
            routers[P.name] = (lb, router)
            out = []
            for i in range(6):
                msg = P.Message(id=f"{P.name}-m{i}", content=f"req {i}",
                                user_id="u", priority=P.Priority.HIGH)
                router.process_fn(None, msg)
                out.append((msg.response, msg.metadata["endpoint_id"]))
            phase1[P.name] = out
        assert phase1["port"] == phase1["jax"]
        assert {e for _, e in phase1["port"]} == {"host0", "host1"}
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=10)
        phase2 = {}
        for P in PKGS:
            lb, router = routers[P.name]
            for _ in range(4):
                lb.check_health_once()
            out = [lb.get_endpoint_by_id("host0").status.value]
            for i in range(4):
                msg = P.Message(id=f"{P.name}-k{i}",
                                content=f"post-kill {i}", user_id="u")
                router.process_fn(None, msg)
                out.append((msg.response, msg.metadata["endpoint_id"]))
            phase2[P.name] = out
        assert phase2["port"] == phase2["jax"]
        assert phase2["port"][0] == "unhealthy"
        assert all(e == "host1" for _, e in phase2["port"][1:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()


# -- probe causes and the breaker ----------------------------------------------


def test_probe_refused_fast_fails_and_feeds_breaker():
    out = {}
    for P in PKGS:
        url = _free_port_url()
        br = P.cb.CircuitBreaker(url, failure_threshold=2, base_backoff=0.05)
        client = P.transport.HttpEngineClient(url, probe_timeout=0.5,
                                              breaker=br)
        trace = [client.probe(), br.consecutive_failures, client.probe(),
                 br.state.value, client.healthy()]
        out[P.name] = trace
    assert out["port"] == out["jax"] == ["refused", 1, "refused", "open",
                                         False]


def test_probe_draining_and_stopped_are_not_endpoint_faults():
    def run(P, pair):
        br = P.cb.CircuitBreaker(pair.urls[0], failure_threshold=1)
        client = P.transport.HttpEngineClient(pair.urls[0], breaker=br)
        trace = [client.probe()]
        pair.servers[0].draining = True
        trace += [client.probe(), client.healthy()]
        pair.servers[0].draining = False
        pair.engines[0].stop()
        trace += [client.probe(), client.healthy(),
                  br.consecutive_failures, br.state.value]
        return trace

    assert _both(run) == ["ok", "draining", False, "stopped", False, 0,
                          "closed"]


def test_expired_deadline_raises_timeout_without_dispatching():
    """An expired context raises TimeoutError before any I/O (the URL is a
    closed port: a dispatch would raise RuntimeError), and leaves the
    breaker untouched."""
    class _Expired:
        def remaining(self):
            return -0.5

    for P in PKGS:
        url = _free_port_url()
        br = P.cb.CircuitBreaker(url, failure_threshold=1)
        client = P.transport.HttpEngineClient(url, breaker=br)
        with pytest.raises(TimeoutError, match="deadline expired"):
            client.process_fn(_Expired(), P.Message(id="dx", content="x",
                                                    user_id="u"))
        assert (br.consecutive_failures, br.state.value) == (0, "closed")


def test_open_breaker_fast_fails_dispatch_without_io():
    for P in PKGS:
        url = _free_port_url()
        br = P.cb.CircuitBreaker(url, failure_threshold=1, base_backoff=30.0)
        br.record_failure()                   # OPEN for ~30 s
        client = P.transport.HttpEngineClient(url, timeout=30.0, breaker=br)
        t0 = time.monotonic()
        with pytest.raises(P.cb.CircuitOpenError):
            client.process_fn(None, P.Message(id="cb", content="x",
                                              user_id="u"))
        assert time.monotonic() - t0 < 0.5    # no socket was opened


def test_probe_success_resets_consecutive_failures():
    def run(P, pair):
        br = P.cb.CircuitBreaker(pair.urls[0], failure_threshold=2)
        up = P.transport.HttpEngineClient(pair.urls[0], breaker=br)
        down = P.transport.HttpEngineClient(_free_port_url(),
                                            probe_timeout=0.5, breaker=br)
        return [down.probe(), br.consecutive_failures, up.probe(),
                br.consecutive_failures, down.probe(), br.state.value]

    assert _both(run) == ["refused", 1, "ok", 0, "refused", "closed"]


def test_peer_deadline_miss_is_a_timeout_not_a_fault():
    """A 504 from the peer (its engine missed the deadline) raises
    TimeoutError, gives back a half-open probe slot and never counts as
    a fault; a 500 (a stopped engine answers 503, a failed generation
    500) raises RuntimeError and does."""
    def run(P, pair):
        br = P.cb.CircuitBreaker(pair.urls[0], failure_threshold=5)
        client = P.transport.HttpEngineClient(pair.urls[0], breaker=br)
        trace = []
        eng = pair.engines[0]
        real = eng.process_fn

        def slow(ctx, msg):
            raise TimeoutError("engine missed the deadline")

        eng.process_fn = slow
        try:
            client.process_fn(None, P.Message(id="d1", content="x",
                                              user_id="u"))
        except TimeoutError as e:
            trace.append(("timeout", "timed out" in str(e)))
        trace.append(br.consecutive_failures)

        def broken(ctx, msg):
            raise RuntimeError("bad weights")

        eng.process_fn = broken
        try:
            client.process_fn(None, P.Message(id="d2", content="x",
                                              user_id="u"))
        except RuntimeError as e:
            trace.append(("error", "(500)" in str(e)))
        trace.append(br.consecutive_failures)
        eng.process_fn = real
        msg = P.Message(id="d3", content="back", user_id="u")
        client.process_fn(None, msg)
        trace += [msg.response, br.consecutive_failures]
        return trace

    assert _both(run) == [("timeout", True), 0, ("error", True), 1,
                          "back", 0]


@pytest.mark.parametrize("point,kind,expect", [
    ("transport.request", "error", ("ChaosFault", 1)),
    ("transport.request", "timeout", ("ChaosTimeout", 0)),
    ("transport.probe", "error", ("refused", 1)),
    ("transport.probe", "timeout", ("timeout", 0)),
])
def test_transport_chaos_points(point, kind, expect):
    """The ``transport.*`` fault points fire where JAX's do: a request
    error feeds the breaker, a request timeout does not; a probe error
    reads as a refused connection (and feeds it), a probe timeout as a
    slow probe."""
    def run(P, pair):
        inj = P.chaos.configure(P.C.ChaosConfig(enabled=True, seed=5))
        inj.add_rule(point, kind=kind, times=1)
        br = P.cb.CircuitBreaker(pair.urls[0], failure_threshold=3)
        client = P.transport.HttpEngineClient(pair.urls[0], breaker=br)
        if point == "transport.probe":
            got = client.probe()
        else:
            try:
                client.process_fn(None, P.Message(id="c", content="x",
                                                  user_id="u"))
                got = "sent"
            except Exception as e:  # noqa: BLE001
                got = type(e).__name__
        failures = br.consecutive_failures
        after = client.probe() if point == "transport.probe" else None
        return got, failures, after, inj.get_stats()["injected"]

    got, failures, after, injected = _both(run)
    assert (got, failures) == expect
    assert injected == {f"{point}:{kind}": 1}
    if after is not None:
        assert after == "ok"
