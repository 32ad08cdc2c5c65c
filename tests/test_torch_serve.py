"""The port's REST path on the CPU with a tiny model: ApiServer → queue
manager → worker → engine → TorchExecutor, plus the queue plane and
config pieces it stands on."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from llmq_tpu_torch.__main__ import App, main
from llmq_tpu_torch.core.config import Config, load_config
from llmq_tpu_torch.core.types import (Message, MessageStatus, Priority,
                                       QueueEmptyError, QueueFullError)
from llmq_tpu_torch.queueing.priority_queue import MultiLevelQueue
from llmq_tpu_torch.queueing.queue_manager import QueueManager
from llmq_tpu_torch.queueing.worker import Worker

# The suite runs in several xdist workers on shared cores: one intra-op
# thread per worker avoids oversubscribing them (and runs faster here).
torch.set_num_threads(1)


def _tiny_cfg() -> Config:
    cfg = Config()
    cfg.model.name = "llama3-tiny"
    cfg.device = "cpu"
    cfg.executor.kv_pages = 64
    cfg.executor.prefill_buckets = [16, 64]
    cfg.executor.decode_chunk = 4
    cfg.executor.max_decode_steps = 6
    cfg.queue.worker.count = 2
    return cfg


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _poll(base, mid, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        status, m = _http("GET", f"{base}/api/v1/messages/{mid}")
        assert status == 200
        if m["status"] in ("completed", "failed"):
            return m
        time.sleep(0.02)
    raise AssertionError(f"{mid} did not finish")


@pytest.fixture(scope="module")
def served():
    threads_before = set(threading.enumerate())
    app = App(_tiny_cfg())
    port = app.start(host="127.0.0.1", port=0)
    yield app, f"http://127.0.0.1:{port}"
    app.stop()
    time.sleep(0.2)
    leftover = [t for t in threading.enumerate()
                if t not in threads_before and t.is_alive()
                and not t.daemon]
    assert not leftover, leftover


def test_health(served):
    _, base = served
    status, body = _http("GET", f"{base}/health")
    assert status == 200
    assert body["status"] == "ok" and body["engine"] == "running"


def test_post_then_poll_to_completed_with_usage(served):
    _, base = served
    status, r = _http("POST", f"{base}/api/v1/messages",
                      {"content": "hello port", "priority": "high"})
    assert status == 202 and r["message_id"] and r["priority"] == 2
    m = _poll(base, r["message_id"])
    assert m["status"] == "completed", m
    usage = m["metadata"]["usage"]
    assert usage["prompt_tokens"] == len("hello port".encode())
    assert usage["completion_tokens"] >= 1
    assert usage["finish_reason"] in ("eos", "length")
    assert usage["cached_tokens"] == 0


def test_conversation_second_turn_reports_cached_tokens(served):
    _, base = served
    usages = []
    for text in ("first turn of the chat", " second turn"):
        status, r = _http("POST", f"{base}/api/v1/messages",
                          {"content": text, "conversation_id": "conv-x"})
        assert status == 202
        usages.append(_poll(base, r["message_id"])["metadata"]["usage"])
    assert usages[0]["cached_tokens"] == 0
    assert usages[1]["cached_tokens"] > 0


def test_all_priorities_complete(served):
    _, base = served
    # A deadline the shedder can meet: with the resource scheduler's
    # learned prefill rate, a LOW message at the 30 s default timeout is
    # shed before any LOW wait is measured (the 30 s table estimate plus
    # the prefill ETA exceeds it), in the JAX package's process too.
    mids = [_http("POST", f"{base}/api/v1/messages",
                  {"content": f"tier {p}", "priority": p,
                   "timeout": 120.0})[1]["message_id"]
            for p in ("low", "normal", "high", "realtime", 3)]
    for mid in mids:
        assert _poll(base, mid)["status"] == "completed"


def test_unknown_id_404_bad_priority_400_bad_route(served):
    _, base = served
    assert _http("GET", f"{base}/api/v1/messages/nope")[0] == 404
    assert _http("POST", f"{base}/api/v1/messages",
                 {"content": "x", "priority": "urgent-ish"})[0] == 400
    assert _http("POST", f"{base}/api/v1/messages",
                 {"content": "x", "priority": 9})[0] == 400
    assert _http("POST", f"{base}/api/v1/messages",
                 {"content": 5})[0] == 400
    assert _http("GET", f"{base}/api/v1/nothing")[0] == 404
    assert _http("POST", f"{base}/health")[0] == 405


def test_check_command_runs_on_cpu(capsys, monkeypatch, tmp_path):
    # Outside the repository root, whose configs/config.yaml names the
    # JAX package's echo backend (which the port refuses).
    monkeypatch.chdir(tmp_path)
    rc = main(["--model", "llama3-tiny", "--device", "cpu", "check",
               "--timeout", "60"])
    assert rc == 0
    assert "CHECK OK" in capsys.readouterr().out


def test_strict_priority_drain_and_capacity():
    mgr = QueueManager("q")
    for i, p in enumerate([Priority.LOW, Priority.NORMAL, Priority.REALTIME,
                           Priority.HIGH, Priority.REALTIME]):
        mgr.push_message(Message(id=f"m{i}", content="x", priority=p))
    order = [m.id for m in mgr.drain_in_priority_order(10)]
    assert order == ["m2", "m4", "m3", "m1", "m0"]
    assert all(mgr.queue.get_stats(t).processing_count >= 0
               for t in mgr.queue.queue_names())
    q = MultiLevelQueue()
    q.create_queue("tiny", capacity=1)
    q.push("tiny", Message(content="a"))
    with pytest.raises(QueueFullError):
        q.push("tiny", Message(content="b"))
    assert q.pop("tiny").status == MessageStatus.PROCESSING
    with pytest.raises(QueueEmptyError):
        q.pop("tiny")


def test_worker_completes_and_fails_messages():
    mgr = QueueManager("w")

    def process(ctx, msg):
        assert ctx.remaining() is not None and ctx.remaining() > 0
        if msg.content == "boom":
            raise RuntimeError("boom")
        msg.response = msg.content.upper()

    w = Worker("w0", mgr, process)
    # max_retries=0: the failure is permanent at once (the retry path
    # has tests of its own in test_torch_queue_plane.py).
    ok, bad = Message(content="fine"), Message(content="boom", max_retries=0)
    mgr.push_message(ok)
    mgr.push_message(bad)
    assert w.process_batch() == 2
    assert ok.status == MessageStatus.COMPLETED and ok.response == "FINE"
    assert bad.status == MessageStatus.FAILED and "boom" in bad.error
    assert (w.stats.succeeded, w.stats.failed) == (1, 1)


def test_config_env_overrides_and_defaults(monkeypatch, tmp_path):
    # No config file in the working directory: defaults and env only.
    monkeypatch.chdir(tmp_path)
    cfg = load_config(environ={"LLMQ_EXECUTOR_KV_PAGES": "64",
                               "LLMQ_SERVER_PORT": "9000",
                               "LLMQ_EXECUTOR_PREFILL_BUCKETS": "16,32",
                               "LLMQ_MODEL_NAME": "llama3-tiny",
                               "LLMQ_UNRELATED_THING": "ignored"})
    assert cfg.executor.kv_pages == 64 and cfg.server.port == 9000
    assert cfg.executor.prefill_buckets == [16, 32]
    assert cfg.model.name == "llama3-tiny"
    d = Config()
    assert (d.executor.max_batch_size, d.executor.page_size,
            d.executor.kv_pages, d.executor.decode_chunk) == (8, 16, 512, 16)
    assert d.executor.prefill_buckets == [128, 512, 2048]
    assert d.model.max_seq_len == 2048 and d.device == "cuda"
    assert [lvl.name for lvl in d.queue.levels] == [
        "realtime", "high", "normal", "low"]


def test_mixed_and_ragged_config_blocks_from_env(monkeypatch, tmp_path):
    """executor.mixed_batch (on by default) and executor.ragged_attention
    (off by default) are nested blocks that LLMQ_* variables reach."""
    from llmq_tpu_torch.core.config import (MixedBatchConfig,
                                            RaggedAttentionConfig)

    # No config file in the working directory: defaults and env only.
    monkeypatch.chdir(tmp_path)
    d = Config().executor
    assert (d.mixed_batch.enabled, d.mixed_batch.prefill_token_budget,
            d.mixed_batch.max_slices, d.mixed_batch.slice_tokens) == (
                True, 128, 2, 64)
    assert (d.ragged_attention.enabled,
            d.ragged_attention.prefill_token_capacity,
            d.ragged_attention.max_slices) == (False, 0, 0)
    cfg = load_config(environ={
        "LLMQ_EXECUTOR_RAGGED_ATTENTION_ENABLED": "true",
        "LLMQ_EXECUTOR_RAGGED_ATTENTION_MAX_SLICES": "3",
        "LLMQ_EXECUTOR_MIXED_BATCH_PREFILL_TOKEN_BUDGET": "96",
        "LLMQ_EXECUTOR_MIXED_BATCH_ENABLED": "false"})
    ex = cfg.executor
    assert ex.ragged_attention.enabled and ex.ragged_attention.max_slices == 3
    assert ex.mixed_batch.prefill_token_budget == 96
    assert not ex.mixed_batch.enabled
    with pytest.raises(ValueError, match="prefill_token_budget"):
        MixedBatchConfig(prefill_token_budget=4)
    with pytest.raises(ValueError, match="max_slices"):
        RaggedAttentionConfig(max_slices=17)


@pytest.mark.parametrize("mixed,ragged,geometry", [
    (True, False, (2, 64, False, 0)),
    (True, True, (2, 128, True, 144)),
    (False, True, (2, 128, True, 144)),
    (False, False, (0, 0, False, 0)),
])
def test_builder_derives_mixed_geometry(mixed, ragged, geometry):
    """build_engine turns the two config blocks into the executor's
    (slices, slice tokens, ragged, packed buffer) and hands mixed_batch
    to the engine: a 128-token capacity over 2 slices packs into 144
    rows (128 + 2 x 7, on q-blocks of 8)."""
    from llmq_tpu_torch.engine.builder import build_engine

    cfg = _tiny_cfg()
    cfg.executor.mixed_batch.enabled = mixed
    cfg.executor.ragged_attention.enabled = ragged
    eng = build_engine(cfg)
    ex = eng.executor
    assert (ex.mixed_prefill_slices, ex.mixed_slice_tokens,
            ex.ragged_attention, ex.ragged_buffer) == geometry
    assert (eng._mixed_cfg is not None) == mixed


def test_ragged_serving_over_rest():
    """The REST path with ragged attention on: concurrent messages and a
    two-turn conversation complete; turn 2 is a continuation prefill
    through the ragged step and reports cached tokens."""
    cfg = _tiny_cfg()
    cfg.executor.ragged_attention.enabled = True
    app = App(cfg)
    port = app.start(host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        mids = [_http("POST", f"{base}/api/v1/messages",
                      {"content": f"message {i} " * (i + 1),
                       "priority": p})[1]["message_id"]
                for i, p in enumerate(("low", "normal", "high", "realtime"))]
        usages = []
        for text in ("first turn of the chat", " second turn"):
            status, r = _http("POST", f"{base}/api/v1/messages",
                              {"content": text, "conversation_id": "rg"})
            usages.append(_poll(base, r["message_id"])["metadata"]["usage"])
        for mid in mids:
            assert _poll(base, mid)["status"] == "completed"
        assert usages[1]["cached_tokens"] > 0
        assert app.engine.executor.ragged_attention
    finally:
        app.stop()


def test_int8_serving_over_rest():
    """The REST path with int8 weights and int8 KV (the JAX package's
    tests/test_quant.py:276-304 counterpart): the executor's weights are
    w8a8 leaves, its pools carry scale pools, concurrent messages and a
    two-turn conversation complete, and turn 2 reports cached tokens."""
    from llmq_tpu_torch.ops.quant import is_quantized

    cfg = _tiny_cfg()
    cfg.model.quantization = "int8"
    cfg.model.kv_quantization = "int8"
    app = App(cfg)
    port = app.start(host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        ex = app.engine.executor
        assert is_quantized(ex.model.params["layers"]["w_up"])
        assert is_quantized(ex.model.params["embed"])
        assert sorted(ex.cache) == ["k", "k_scale", "v", "v_scale"]
        assert ex.cache["k"].dtype == torch.int8
        assert ex.cache["k_scale"].shape == (2, 64, 2, 16)
        mids = [_http("POST", f"{base}/api/v1/messages",
                      {"content": f"int8 message {i} " * (i + 1),
                       "priority": p})[1]["message_id"]
                for i, p in enumerate(("low", "high", "realtime"))]
        usages = []
        for text in ("first turn of the chat", " second turn"):
            status, r = _http("POST", f"{base}/api/v1/messages",
                              {"content": text, "conversation_id": "q8"})
            assert status == 202
            usages.append(_poll(base, r["message_id"])["metadata"]["usage"])
        for mid in mids:
            assert _poll(base, mid)["status"] == "completed"
        assert usages[0]["cached_tokens"] == 0
        assert usages[1]["cached_tokens"] > 0
    finally:
        app.stop()


def test_check_command_runs_int8_from_env(monkeypatch, capsys, caplog,
                                          tmp_path):
    """Both switches through their LLMQ_* variables reach the entry
    point: ``check`` builds (boot log) and serves the int8 engine on the
    CPU."""
    import logging

    monkeypatch.setenv("LLMQ_MODEL_QUANTIZATION", "int8")
    monkeypatch.setenv("LLMQ_MODEL_KV_QUANTIZATION", "int8")
    monkeypatch.chdir(tmp_path)    # no config file: defaults and env
    with caplog.at_level(logging.INFO, logger="llmq_tpu_torch.builder"):
        rc = main(["--model", "llama3-tiny", "--device", "cpu", "check",
                   "--timeout", "60"])
    assert rc == 0
    assert "CHECK OK" in capsys.readouterr().out
    assert "quantization=int8 kv_quantization=int8" in caplog.text
