"""The engine crash supervisor on the port's engine (CPU, tiny f32
model): the JAX package's tests/test_async_pipeline.py:290 (a crash with
two chunks in flight: no loss, no duplicate) with the crash injected by a
patched ``step`` that raises a ``BaseException``, then the same crash
under a worker: the message fails over, retries through the delayed
queue and completes exactly once."""

import time

import pytest
import torch

from llmq_tpu_torch.core.config import (AsyncPipelineConfig, Config,
                                        SupervisorConfig)
from llmq_tpu_torch.core.types import Message, MessageStatus
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine
from llmq_tpu_torch.engine.executor import TorchExecutor
from llmq_tpu_torch.engine.supervisor import EngineSupervisor
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.models import llama as T
from llmq_tpu_torch.queueing.dead_letter_queue import DeadLetterQueue
from llmq_tpu_torch.queueing.delayed_queue import DelayedQueue
from llmq_tpu_torch.queueing.queue_manager import QueueManager
from llmq_tpu_torch.queueing.worker import Worker

torch.set_num_threads(1)
PROMPT = "stream me through a crash " * 3
GEOM = dict(batch_size=2, page_size=16, num_pages=64, prefill_buckets=[16, 32],
            eos_id=-1, chunk_size=4)


class _Crash(BaseException):
    """Kills the engine loop (an ``Exception`` would only be logged)."""


@pytest.fixture(scope="module")
def model():
    cfg = T.get_config("llama3-tiny", dtype=torch.float32)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _engine(model, depth=3):
    cfg, params = model
    return InferenceEngine(TorchExecutor(cfg, params, device="cpu", **GEOM),
                           ByteTokenizer(), max_decode_steps=64,
                           async_pipeline=AsyncPipelineConfig(depth=depth))


def _arm_crash(eng):
    """The engine's next step raises _Crash (once)."""
    orig = eng.step

    def crashing():
        eng.step = orig
        raise _Crash("injected")

    eng.step = crashing


def _alone(model, n):
    eng = _engine(model)
    h = eng.submit(GenRequest(id="alone", prompt=PROMPT, max_new_tokens=n))
    eng.run_until_idle()
    eng.stop()
    return h.result.tokens


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_crash_with_two_chunks_in_flight_zero_loss_zero_dup(model):
    """The loop dies with two chunks in flight: ``check_once`` detects it,
    recovers (every chunk dropped, the completion pool drained before the
    handle is failed) and restarts; the stream is a prefix of the full
    greedy stream with no token twice; a retry completes on the
    restarted, still pipelined engine with the full stream."""
    full = _alone(model, 48)
    eng = _engine(model)
    sup = EngineSupervisor(eng, config=SupervisorConfig())
    streamed = []
    h = eng.submit(GenRequest(id="s0", prompt=PROMPT, max_new_tokens=48),
                   on_token=streamed.append)
    for _ in range(200):
        eng.step()
        if len(eng._inflight) >= 2 and len(streamed) >= 3:
            break
    assert len(eng._inflight) >= 2
    _arm_crash(eng)
    eng.start()
    deadline = time.time() + 5.0
    while eng.running and time.time() < deadline:
        time.sleep(0.01)
    assert not eng.running
    assert sup.check_once()               # detect + recover + restart
    assert eng.running and sup.restarts == 1
    assert sup.recovered_total == 1
    assert not eng._inflight
    assert h.wait(2.0) and h.result.finish_reason == "error"
    assert "crashed" in h.result.error
    eng._drain_completions()
    assert streamed == full[:len(streamed)]       # a prefix, no duplicate
    assert h.result.tokens == streamed
    assert all(s is None for s in eng._slots) and not eng._pending
    assert eng.allocator.used() == 0
    h2 = eng.submit(GenRequest(id="s1", prompt=PROMPT, max_new_tokens=48))
    assert h2.wait(30.0) and h2.result.finish_reason == "length"
    assert h2.result.tokens == full
    assert not sup.check_once()           # alive: nothing to do
    sup.stop()
    eng.stop()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_crash_loop_gives_up_but_still_recovers(model):
    """More than ``max_restarts`` crashes inside the window: no restart,
    but the final crash's requests are still failed over."""
    eng = _engine(model)
    sup = EngineSupervisor(eng, config=SupervisorConfig(max_restarts=0))
    h = eng.submit(GenRequest(id="g", prompt=PROMPT, max_new_tokens=8))
    _arm_crash(eng)
    eng.start()
    deadline = time.time() + 5.0
    while eng.running and time.time() < deadline:
        time.sleep(0.01)
    assert not sup.check_once() and sup.gave_up and not eng.running
    assert h.wait(2.0) and h.result.finish_reason == "error"
    assert sup.get_stats() == {"restarts": 0, "recovered_requests": 1,
                               "gave_up": True, "running": False}


def test_deliberate_stop_is_not_a_crash(model):
    eng = _engine(model)
    sup = EngineSupervisor(eng, config=SupervisorConfig())
    eng.start()
    eng.stop()
    assert not sup.check_once() and sup.restarts == 0


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_message_retries_to_completion_after_crash(model):
    """Real threads: a message decoding through the worker when the loop
    dies is failed over by the supervisor, retried through the delayed
    queue after its backoff and completed exactly once, with the full
    greedy response; the dead-letter queue stays empty."""
    full = _alone(model, 64)
    cfg = Config()
    cfg.queue.retry.initial_backoff = 0.05
    cfg.queue.worker.process_interval = 0.01
    mgr = QueueManager("sup", cfg)
    dq = DelayedQueue(lambda q, m: mgr.push_message(m, q or None))
    dlq = DeadLetterQueue()
    eng = _engine(model, depth=2)
    sup = EngineSupervisor(eng, config=SupervisorConfig(check_interval=0.02))
    calls = []
    completions = []

    def process(ctx, m):
        calls.append(m.retry_count)
        eng.process_fn(ctx, m)
        completions.append(m.id)

    w = Worker("w", mgr, process, delayed_queue=dq, dead_letter_queue=dlq)
    msg = Message(content=PROMPT, timeout=60.0,
                  metadata={"max_new_tokens": 64})
    eng.start()
    sup.start()
    dq.start()
    w.start()
    try:
        mgr.push_message(msg)
        deadline = time.time() + 30.0
        while (eng.tokens_generated_total < 8 or not eng._inflight) and \
                time.time() < deadline:
            time.sleep(0.001)
        assert eng._inflight, "no chunk in flight to crash"
        _arm_crash(eng)
        while msg.status != MessageStatus.COMPLETED and \
                time.time() < deadline:
            time.sleep(0.01)
    finally:
        w.stop()
        dq.stop()
        sup.stop()
        eng.stop()
    assert msg.status == MessageStatus.COMPLETED, (msg.status, msg.error)
    assert sup.restarts == 1 and msg.retry_count == 1
    assert calls == [0, 1] and completions == [msg.id]
    assert dlq.size() == 0
    assert msg.response == ByteTokenizer().decode(full)
    assert msg.metadata["usage"]["completion_tokens"] == 64
    assert w.stats.to_dict()["retried"] == 1
    stats = mgr.get_stats("normal")
    assert (stats.completed_count, stats.failed_count,
            stats.processing_count) == (1, 0, 0)
