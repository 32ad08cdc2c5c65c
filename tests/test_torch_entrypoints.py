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
import urllib.request

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


def test_serve_with_config_answers_and_drains_on_sigterm(tmp_path):
    """The file configures the process (its port, model, log format);
    one request is answered over REST; SIGTERM drains (the log says the
    engine was idle at the end) before the process exits 0."""
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
    cfg.write_text(SERVE_YAML + "disagg: {enabled: true}\n")
    res = subprocess.run(
        [sys.executable, "-m", "llmq_tpu_torch", "--config", str(cfg),
         "--device", "cpu", "serve"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode != 0
    assert "disagg.enabled=True is not ported yet" in res.stderr


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
