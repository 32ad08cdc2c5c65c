"""The port's entry points on the CPU: ``serve --config <file> --device
cpu`` in a subprocess answers a request and drains on SIGTERM; a file
that does not load ends the command with the reason; and the serving
process's drain finishes the work in flight."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERVE_YAML = """\
# A CPU serving process for the entry-point tests.
server: {host: 127.0.0.1, port: 0}
model: {name: llama3-tiny}
logging: {level: info, format: console, output: stdout}
queue:
  worker: {count: 2, process_interval: 0.01}
executor: {kv_pages: 256}
"""


def _http(base, method, path, body=None, timeout=30):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


class _Proc:
    """A subprocess whose stdout lines are collected on a thread."""

    def __init__(self, args, cwd) -> None:
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("LLMQ_CONFIG", None)
        self.p = subprocess.Popen(
            [sys.executable, "-m", "llmq_tpu_torch", *args], cwd=cwd,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.lines = []
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self) -> None:
        for line in self.p.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, prefix: str, timeout: float = 120.0) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            for line in list(self.lines):
                if line.startswith(prefix):
                    return line
            if self.p.poll() is not None:
                break
            time.sleep(0.02)
        raise AssertionError(f"no {prefix!r} line: {self.lines[-30:]}")

    def finish(self, sig, timeout: float = 120.0) -> int:
        self.p.send_signal(sig)
        try:
            return self.p.wait(timeout)
        finally:
            if self.p.poll() is None:
                self.p.kill()
                self.p.wait(10)
            self._t.join(10)


def test_serve_with_config_answers_and_drains_on_sigterm(tmp_path,
                                                         monkeypatch):
    """The file configures the process (its port, model, log format);
    one request is answered over REST; SIGTERM drains (the log says the
    engine was idle at the end) before the process exits 0. The test
    process's ``LLMQ_CONFIG`` stays unset (another test file run earlier
    in the same worker may have left one behind: cleared first)."""
    monkeypatch.delenv("LLMQ_CONFIG", raising=False)
    cfg = tmp_path / "serve.yaml"
    cfg.write_text(SERVE_YAML)
    proc = _Proc(["--config", str(cfg), "--device", "cpu", "serve"],
                 cwd=tmp_path)
    try:
        line = proc.wait_for("serving llama3-tiny on cpu at ")
        base = line.rsplit(" at ", 1)[1]
        status, r = _http(base, "POST", "/api/v1/messages", {
            "content": "hello from the entry-point test",
            "metadata": {"max_new_tokens": 8}})
        assert status == 202
        deadline = time.time() + 60
        while time.time() < deadline:
            _, m = _http(base, "GET", f"/api/v1/messages/{r['message_id']}")
            if m["status"] in ("completed", "failed"):
                break
            time.sleep(0.05)
        assert m["status"] == "completed" and "usage" in m["metadata"]
        _, h = _http(base, "GET", "/health")
        assert h["status"] == "ok" and h["engine"] == "running"
        # Work in flight at SIGTERM: the drain waits for it.
        for i in range(3):
            _http(base, "POST", "/api/v1/messages", {
                "content": f"{i} keep decoding for a while",
                "metadata": {"max_new_tokens": 200}})
        rc = proc.finish(signal.SIGTERM)
    finally:
        if proc.p.poll() is None:
            proc.p.kill()
    out = "\n".join(proc.lines)
    assert rc == 0, out[-3000:]
    assert "draining (timeout 30 s)" in out
    assert "drain complete (idle=True)" in out
    assert out.index("drain complete") < out.index("shutting down")
    assert os.environ.get("LLMQ_CONFIG") is None


def test_serve_sigint_stops_without_draining(tmp_path):
    cfg = tmp_path / "serve.yaml"
    cfg.write_text(SERVE_YAML)
    proc = _Proc(["-c", str(cfg), "--device", "cpu", "--log-format",
                  "json", "serve"], cwd=tmp_path)
    proc.wait_for("serving llama3-tiny on cpu at ")
    rc = proc.finish(signal.SIGINT)
    out = "\n".join(proc.lines)
    assert rc == 0, out[-3000:]
    assert "draining" not in out
    assert any(json.loads(x).get("msg") == "shutting down ..."
               for x in proc.lines if x.startswith("{"))


def test_serve_refuses_an_unported_plane_in_the_file(tmp_path):
    cfg = tmp_path / "serve.yaml"
    # The disaggregation, scenario and mesh planes are ported: the case
    # now holds XLA's compilation cache, which the port does not read.
    cfg.write_text(SERVE_YAML + "tpu: {compilation_cache_dir: /tmp/xla}\n")
    res = subprocess.run(
        [sys.executable, "-m", "llmq_tpu_torch", "--config", str(cfg),
         "--device", "cpu", "serve"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode != 0
    assert ("tpu.compilation_cache_dir='/tmp/xla' is not ported yet"
            in res.stderr)


def test_serve_in_the_repository_root_names_the_remedy():
    """The repository's root holds the JAX package's
    ``configs/config.yaml`` (its echo backend); the search finds it, and
    the command exits 2 saying to pass ``--config``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("LLMQ_CONFIG", None)
    res = subprocess.run(
        [sys.executable, "-m", "llmq_tpu_torch", "--device", "cpu", "serve"],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode == 2, res.stderr[-2000:]
    assert "configs/config.yaml, found by the config search" in res.stderr
    assert "pass --config" in res.stderr
    assert "Traceback" not in res.stderr


def test_app_drain_finishes_the_work_in_flight(monkeypatch, tmp_path):
    """In process: four messages decoding, then ``POST
    /api/v1/admin/drain``: /health reads "draining", the drain ends idle
    and every message completes once; the workers took no new work."""
    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.engine.builder import build_engine

    monkeypatch.chdir(tmp_path)
    cfg = Config()
    cfg.device = "cpu"
    cfg.model.name = "llama3-tiny"
    cfg.queue.worker.process_interval = 0.01
    cfg.executor.supervisor.enabled = False
    eng = build_engine(cfg, model_dtype=torch.float32)
    app = App(cfg, engine=eng)
    base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
    gate = threading.Event()
    real_step = eng.step

    def held_step():
        gate.wait(30)
        return real_step()

    eng.step = held_step            # the four queue up before any runs
    try:
        mids = [_http(base, "POST", "/api/v1/messages", {
            "content": f"{i} drain check", "metadata": {
                "max_new_tokens": 32}})[1]["message_id"] for i in range(4)]
        deadline = time.time() + 30
        while eng.get_stats()["pending"] < 4 and time.time() < deadline:
            time.sleep(0.01)
        assert eng.get_stats()["pending"] == 4
        status, r = _http(base, "POST", "/api/v1/admin/drain")
        assert (status, r) == (202, {"status": "draining"})
        _, h = _http(base, "GET", "/health")
        assert h["status"] == "draining"
        eng.__dict__.pop("step")
        gate.set()
        assert app.drain(timeout=60) is True

        def statuses():
            return [_http(base, "GET", f"/api/v1/messages/{m}")[1]
                    for m in mids]

        deadline = time.time() + 10   # the workers record the last ones
        while time.time() < deadline and any(
                m["status"] != "completed" for m in statuses()):
            time.sleep(0.02)
        done = statuses()
        assert [m["status"] for m in done] == ["completed"] * 4
        assert all(m["retry_count"] == 0 for m in done)
        assert not any(w.running for w in app.workers)
        status, r = _http(base, "POST", "/api/v1/messages",
                          {"content": "after the drain"})
        assert status == 202
        time.sleep(0.3)
        _, late = _http(base, "GET", f"/api/v1/messages/{r['message_id']}")
        assert late["status"] == "pending"
    finally:
        eng.__dict__.pop("step", None)
        gate.set()
        app.stop()


# -- the split deployment ------------------------------------------------------

KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512, max_seq_len=256)
GEOM = dict(batch_size=4, page_size=16, num_pages=128, prefill_buckets=[16, 32],
            eos_id=-1, chunk_size=4, mixed_prefill_slices=2,
            mixed_slice_tokens=8)
#: The usage plane's measured seconds (each engine's own clock): compared
#: by type, every other usage field by value.
USAGE_MEASURED = {"device_seconds", "waste_seconds", "kv_page_seconds",
                  "saved_prefill_device_seconds"}
SPLIT_MESSAGES = [("realtime", "a split deployment, realtime"),
                  ("low", "a split deployment, low"),
                  ("high", "a split deployment, high"),
                  ("normal", "a split deployment, normal")]


def _split_run(pkg, tmp_path, monkeypatch):
    """A gateway App and a queue-manager App of one package in this
    process, joined only by a spool directory (each with its own WAL
    directory): the messages go in through the gateway's REST API and
    their results come back on it. Returns the finished messages, the
    gateway's queue stats and the gateway App's parts."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from llmq_tpu.models import llama as J

    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    spool = str(tmp_path / f"{pkg}-spool")
    if pkg == "jax":
        import llmq_tpu.engine as jengine_pkg
        from llmq_tpu.__main__ import App
        from llmq_tpu.core.config import default_config
        from llmq_tpu.engine.engine import InferenceEngine as JEngine
        from llmq_tpu.engine.executor import JaxExecutor
        from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok

        engine = JEngine(JaxExecutor(jcfg, jparams, **GEOM), JTok(),
                         enable_metrics=False, max_decode_steps=16)
        monkeypatch.setattr(jengine_pkg, "build_engine",
                            lambda cfg, warmup=False: engine)
        new_cfg = default_config
        qm_kw = {}
    else:
        from llmq_tpu_torch.__main__ import App
        from llmq_tpu_torch.core.config import Config
        from llmq_tpu_torch.engine.engine import InferenceEngine
        from llmq_tpu_torch.engine.executor import TorchExecutor
        from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
        from llmq_tpu_torch.models import llama as T

        tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
        tparams = T.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        engine = InferenceEngine(
            TorchExecutor(tcfg, tparams, device="cpu", **GEOM),
            ByteTokenizer(), max_decode_steps=16)
        new_cfg = Config
        qm_kw = {"engine": engine}
    cfgs = {}
    for role in ("gateway", "queue-manager"):
        cfg = new_cfg()
        cfg.queue.spool_dir = spool
        cfg.queue.wal_dir = str(tmp_path / f"{pkg}-{role}-wal")
        cfg.queue.worker.process_interval = 0.01
        cfg.queue.worker.count = 2
        cfg.server.host, cfg.server.port = "127.0.0.1", 0
        cfg.loadbalancer.health_check_interval = 0
        cfg.executor.supervisor.enabled = False
        cfgs[role] = cfg
    if pkg == "port":
        # The gateway never touches the card: "cuda" here, where there is
        # none, must not matter.
        cfgs["gateway"].device = "cuda"
        cfgs["queue-manager"].device = "cpu"
    gateway = App(cfgs["gateway"], with_api=True, with_workers=False,
                  with_engine=False)
    consumer = App(cfgs["queue-manager"], with_api=False, with_workers=True,
                   with_engine=True, **qm_kw)
    consumer.start()
    gateway.start()
    base = f"http://127.0.0.1:{gateway.api._httpd.server_address[1]}"
    try:
        mids = [_http(base, "POST", "/api/v1/messages", {
            "content": text, "priority": prio, "user_id": "split",
            "metadata": {"max_new_tokens": 6}})[1]["message_id"]
            for prio, text in SPLIT_MESSAGES]
        deadline = time.time() + 60
        done = {}
        while len(done) < len(mids) and time.time() < deadline:
            for mid in mids:
                _, m = _http(base, "GET", f"/api/v1/messages/{mid}")
                if m["status"] in ("completed", "failed"):
                    done[mid] = m
            time.sleep(0.02)
        _, stats = _http(base, "GET", "/api/v1/queues/stats")
        parts = {"health": _http(base, "GET", "/health")[1],
                 "engine": gateway.engine, "workers": gateway.workers,
                 "consumer_api": consumer.api,
                 "spool_left": sorted(os.listdir(spool))}
        if pkg == "port":
            from llmq_tpu_torch import observability
            parts["traces"] = [observability.get_recorder().get(mid).to_dict()
                               for mid in mids]
            parts["cores"] = (gateway.queue_cores(), consumer.queue_cores())
            for path in ("/api/v1/engine/stats", "/api/v1/generate"):
                req = urllib.request.Request(
                    base + path, method="GET" if "stats" in path else "POST",
                    data=None if "stats" in path else b'{"content": "x"}',
                    headers={"Content-Type": "application/json"})
                try:
                    urllib.request.urlopen(req, timeout=10)
                    parts[path] = 200
                except urllib.error.HTTPError as e:
                    parts[path] = e.code
    finally:
        gateway.stop()
        consumer.stop()
    return [done.get(mid) for mid in mids], stats, parts


def _counts(stats):
    """Queue stats without the measured wait and process times."""
    if isinstance(stats, dict):
        return {k: _counts(v) for k, v in stats.items()
                if "wait" not in k and "time" not in k}
    return stats


def _usage_core(m):
    usage = m["metadata"]["usage"]
    return {k: (type(v).__name__ if k in USAGE_MEASURED else v)
            for k, v in usage.items()}


@pytest.fixture
def usage_ledgers_on():
    """Both packages' usage ledgers at their default (on) for the case,
    and put back after: another file's fixture may leave one off (JAX's
    ``tests/test_disagg.py`` turns its own off at teardown, and xdist may
    run it first in the same worker)."""
    from llmq_tpu.observability.usage import get_usage_ledger as jled
    from llmq_tpu_torch.observability.usage import get_usage_ledger as tled

    leds = [jled(), tled()]
    was = [led.enabled for led in leds]
    for led in leds:
        led.reconfigure(enabled=True)
    yield
    for led, w in zip(leds, was):
        led.reconfigure(enabled=w)


def test_split_apps_answer_like_jaxs(tmp_path, monkeypatch, usage_ledgers_on):
    """Tolerance: none. A gateway App (no engine; configured for
    ``cuda`` where there is none) and a queue-manager App (llama3-tiny in
    float32 on the CPU, JAX's weights through ``params_from_jax``) joined
    only by a spool directory: every message posted to the gateway
    completes on it with the JAX package's greedy response, usage and
    priority; the gateway's queue stats count the completions; the
    spool is drained; the gateway's traces record the completion from
    the spool; both processes run the native queue core."""
    monkeypatch.chdir(tmp_path)
    pytest.importorskip("jax")
    jax_done, jax_stats, _ = _split_run("jax", tmp_path, monkeypatch)
    port_done, port_stats, parts = _split_run("port", tmp_path, monkeypatch)
    assert all(m is not None for m in jax_done + port_done)
    for j, t in zip(jax_done, port_done):
        assert t["status"] == j["status"] == "completed"
        assert t["response"] == j["response"]
        assert t["priority"] == j["priority"]
        assert _usage_core(t) == _usage_core(j)
    assert _counts(port_stats) == _counts(jax_stats)
    completed = sum(port_stats["standard"][tier]["completed_count"]
                    for tier in ("realtime", "high", "normal", "low"))
    assert completed == len(SPLIT_MESSAGES)
    assert parts["engine"] is None and parts["workers"] == []
    assert parts["consumer_api"] is None and "engine" not in parts["health"]
    assert parts["spool_left"] == ["done"]
    assert parts["/api/v1/engine/stats"] == 503
    assert parts["/api/v1/generate"] == 503
    for tl in parts["traces"]:
        spool_events = [e for e in tl["events"]
                        if e.get("meta", {}).get("source") == "spool"]
        assert [e["stage"] for e in spool_events] == ["completed"], tl
    gw_cores, qm_cores = parts["cores"]
    assert set(gw_cores.values()) == set(qm_cores.values()) == {"NativeMLQ"}


SPLIT_YAML = """\
# The split deployment's two processes on the CPU; each gets its own
# LLMQ_QUEUE_WAL_DIR (both have managers of the same names).
server: {host: 127.0.0.1, port: 0}
model: {name: llama3-tiny, max_seq_len: 1024}
logging: {level: info, format: json, output: stdout}
queue:
  worker: {count: 2, process_interval: 0.01}
  spool_dir: SPOOL
executor: {kv_pages: 256, max_decode_steps: 1024}
"""


def _json_lines(proc, msg_prefix):
    out = []
    for line in list(proc.lines):
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("msg", "").startswith(msg_prefix):
                out.append(rec)
    return out


def _wait_json(proc, msg_prefix, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        found = _json_lines(proc, msg_prefix)
        if found:
            return found[-1]
        if proc.p.poll() is not None:
            break
        time.sleep(0.02)
    raise AssertionError(f"no {msg_prefix!r} log line: {proc.lines[-30:]}")


def _finished(base, mids, timeout):
    deadline = time.time() + timeout
    done = {}
    while len(done) < len(mids) and time.time() < deadline:
        for mid in mids:
            if mid not in done:
                _, m = _http(base, "GET", f"/api/v1/messages/{mid}")
                if m["status"] in ("completed", "failed"):
                    done[mid] = m
        time.sleep(0.05)
    return done


def test_gateway_and_queue_manager_processes_survive_a_kill(tmp_path,
                                                             monkeypatch):
    """``gateway`` and ``queue-manager --device cpu`` as processes joined
    by a spool: messages posted to the gateway complete on it; the
    queue-manager is SIGKILLed while it holds messages, restarts on its
    WAL and redelivers them, and every message completes; the gateway
    stops with messages in flight, restarts on its WAL and relays them
    again, and they complete; each stops on SIGTERM with exit code 0."""
    from llmq_tpu_torch.queueing.wal import QueueWAL

    monkeypatch.delenv("LLMQ_CONFIG", raising=False)
    spool = tmp_path / "spool"
    cfg = tmp_path / "split.yaml"
    cfg.write_text(SPLIT_YAML.replace("SPOOL", str(spool)))

    def start(role, *args):
        monkeypatch.setenv("LLMQ_QUEUE_WAL_DIR", str(tmp_path / role))
        return _Proc(["--config", str(cfg), *args, role], cwd=tmp_path)

    gateway = start("gateway")
    qm = start("queue-manager", "--device", "cpu")
    qm2 = gateway2 = None
    try:
        base = gateway.wait_for("gateway at ").rsplit(" at ", 1)[1]
        up = _wait_json(qm, "queue-manager consuming")
        assert set(up["queue_cores"].values()) == {"NativeMLQ"}
        assert up["native_lib"].endswith(".so") and "_build" in up["native_lib"]
        gw_up = _wait_json(gateway, "gateway serving at")
        assert set(gw_up["queue_cores"].values()) == {"NativeMLQ"}
        first = [_http(base, "POST", "/api/v1/messages", {
            "content": f"{i} through the spool", "priority": prio,
            "metadata": {"max_new_tokens": 8}})[1]["message_id"]
            for i, prio in enumerate(["high", "low", "realtime"])]
        done = _finished(base, first, 120)
        assert [done[m]["status"] for m in first] == ["completed"] * 3
        assert all(done[m]["metadata"]["usage"]["completion_tokens"] == 8
                   for m in first)
        # Long requests; the kill comes once the queue-manager's journal
        # holds them all (each append is flushed).
        held = [_http(base, "POST", "/api/v1/messages", {
            "content": f"{i} held across a kill",
            "metadata": {"max_new_tokens": 600}})[1]["message_id"]
            for i in range(4)]
        journal = str(tmp_path / "queue-manager" / "standard.wal")
        deadline = time.time() + 60
        while time.time() < deadline and not set(held) <= {
                m.id for _, m in QueueWAL.replay(journal)}:
            time.sleep(0.01)
        qm.p.kill()
        qm.p.wait(30)
        live = {m.id for _, m in QueueWAL.replay(journal)}
        unfinished = {m for m in held
                      if _http(base, "GET", f"/api/v1/messages/{m}")[1][
                          "status"] != "completed"}
        assert unfinished and unfinished <= live
        qm2 = start("queue-manager", "--device", "cpu")
        restored = _wait_json(qm2, "wal: restored")
        assert restored["manager"] == "standard"
        assert restored["restored"] >= len(unfinished)
        done = _finished(base, held, 180)
        assert [done.get(m, {}).get("status") for m in held] == \
            ["completed"] * 4
        _, stats = _http(base, "GET", "/api/v1/queues/stats")
        assert sum(stats["standard"][t]["processing_count"]
                   for t in ("realtime", "high", "normal", "low")) == 0
        assert sorted(os.listdir(spool)) == ["done"]
        # The gateway stops with messages in flight and restarts on its
        # WAL: they are relayed again and complete (its message store
        # starts empty, as JAX's; the completions show in the traces).
        moved = [_http(base, "POST", "/api/v1/messages", {
            "content": f"{i} across a gateway restart",
            "metadata": {"max_new_tokens": 400}})[1]["message_id"]
            for i in range(3)]
        deadline = time.time() + 60
        while time.time() < deadline and not set(moved) <= {
                m.id for _, m in QueueWAL.replay(journal)}:
            time.sleep(0.01)
        assert gateway.finish(signal.SIGTERM) == 0
        held = {m.id for _, m in QueueWAL.replay(
            str(tmp_path / "gateway" / "standard.wal"))}
        assert held == set(moved)
        gateway2 = start("gateway")
        base = gateway2.wait_for("gateway at ").rsplit(" at ", 1)[1]
        assert _wait_json(gateway2, "wal: restored")["restored"] == 3

        def spool_completions(mid):
            _, tl = _http(base, "GET", f"/api/v1/requests/{mid}/trace")
            return sum(1 for e in tl["events"] if e["stage"] == "completed"
                       and (e.get("meta") or {}).get("source") == "spool")

        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                if all(spool_completions(m) for m in moved):
                    break
            except urllib.error.HTTPError:
                pass                      # no trace recorded yet
            time.sleep(0.05)
        assert all(spool_completions(m) >= 1 for m in moved)
        assert qm2.finish(signal.SIGTERM) == 0
        assert gateway2.finish(signal.SIGTERM) == 0
    finally:
        for proc in (gateway, qm, qm2, gateway2):
            if proc is not None and proc.p.poll() is None:
                proc.p.kill()
                proc.p.wait(10)


def test_serve_with_peers_and_the_scheduler_subcommand(tmp_path):
    """``--peers`` makes ``serve`` route through the cluster plane over its
    own engine and the peer (echo backend on the CPU, the peer an
    in-process port server): both serve, the cluster routes answer, and
    ``scheduler.min_endpoints: 2`` keeps both routable past the
    autoscaler's first tick. ``scheduler`` starts its monitor loop with
    no API, workers or engine and exits 0 on SIGTERM."""
    from llmq_tpu_torch.api.server import ApiServer
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.engine.engine import InferenceEngine
    from llmq_tpu_torch.engine.executor import EchoExecutor
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    peer_engine = InferenceEngine(EchoExecutor(batch_size=4),
                                  ByteTokenizer(), name="peer",
                                  enable_metrics=False)
    peer_engine.start()
    peer = ApiServer(Config(), engine=peer_engine)
    peer_url = f"http://127.0.0.1:{peer.start(host='127.0.0.1', port=0)}"
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text("server: {host: 127.0.0.1, port: 0}\n"
                   "executor: {backend: echo}\n"
                   "loadbalancer: {strategy: round_robin}\n"
                   "queue: {worker: {count: 2, process_interval: 0.01}}\n"
                   "scheduler: {monitor_interval: 0.2, min_endpoints: 2}\n")
    proc = _Proc(["-c", str(cfg), "--device", "cpu", "--peers", peer_url,
                  "serve"], cwd=tmp_path)
    try:
        base = proc.wait_for("serving ").rsplit(" at ", 1)[1]
        time.sleep(0.5)          # past two autoscaler ticks
        mids = [_http(base, "POST", "/api/v1/messages",
                      {"content": f"c{i}"})[1]["message_id"]
                for i in range(4)]
        served = _finished(base, mids, 60)
        _, stats = _http(base, "GET", "/api/v1/cluster/stats")
        _, ov = _http(base, "GET", "/api/v1/cluster/overview")
        rc = proc.finish(signal.SIGINT)
    finally:
        if proc.p.poll() is None:
            proc.p.kill()
        peer.stop()
        peer_engine.stop()
    assert rc == 0
    peer_id = peer_url.split("//")[1]
    assert {e["id"] for e in stats["endpoints"]["endpoints"]} == {
        stats["local_endpoint_id"], peer_id}
    assert {m["metadata"]["endpoint_id"] for m in served.values()} == {
        stats["local_endpoint_id"], peer_id}
    assert ov["aggregate"]["endpoints"] == 2
    sched = _Proc(["-c", str(cfg), "scheduler"], cwd=tmp_path)
    sched.wait_for("scheduler monitoring (strategy=dynamic)")
    assert sched.finish(signal.SIGTERM) == 0
