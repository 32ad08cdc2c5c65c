"""The port's queue plane against the JAX package's, side by side: the
priority queue, the queue manager, the delayed queue, the dead-letter
queue, the worker (retry backoff, dead letters, timeouts, the watchdog)
and the factory. Each scenario is one function over a namespace of
either package's classes, each driven by a fake clock from the same start; the two
packages must leave the same trace (message states, stats, orders,
delays). It mirrors tests/test_delayed_queue.py,
tests/test_dead_letter_queue.py, tests/test_worker.py,
tests/test_factory.py and tests/test_queue_manager.py.
"""

import threading
import time
import types

import pytest

from llmq_tpu.core import clock as jclock
from llmq_tpu.core import errors as jerrors
from llmq_tpu.core import types as jtypes
from llmq_tpu.core.config import Config as JConfig
from llmq_tpu.queueing import dead_letter_queue as jdlq
from llmq_tpu.queueing import delayed_queue as jdelayed
from llmq_tpu.queueing import factory as jfactory
from llmq_tpu.queueing import queue_manager as jqm
from llmq_tpu.queueing import worker as jworker

from llmq_tpu_torch.core import errors as terrors
from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.core.config import Config as TConfig
from llmq_tpu_torch.queueing import dead_letter_queue as tdlq
from llmq_tpu_torch.queueing import delayed_queue as tdelayed
from llmq_tpu_torch.queueing import factory as tfactory
from llmq_tpu_torch.queueing import queue_manager as tqm
from llmq_tpu_torch.queueing import worker as tworker


def _jax_ns(clock):
    return types.SimpleNamespace(
        name="jax", clock=clock, Message=jtypes.Message,
        Status=jtypes.MessageStatus, Priority=jtypes.Priority,
        Config=JConfig, errors=jerrors,
        QueueManager=lambda name, config=None: jqm.QueueManager(
            name, config=config, clock=clock, backend="python",
            enable_metrics=False),
        Rule=jqm.PriorityAdjustRule,
        DelayedQueue=lambda deliver, **kw: jdelayed.DelayedQueue(
            deliver, clock=clock, **kw),
        DLQ=lambda **kw: jdlq.DeadLetterQueue(clock=clock, **kw),
        Worker=lambda *a, **kw: jworker.Worker(*a, clock=clock, **kw),
        Exponential=jworker.ExponentialBackoff, Fixed=jworker.FixedBackoff,
        Factory=lambda config=None: jfactory.QueueFactory(
            config, clock=clock, backend="python"),
        QueueType=jfactory.QueueType)


def _port_ns(clock):
    return types.SimpleNamespace(
        name="port", clock=clock, Message=ttypes.Message,
        Status=ttypes.MessageStatus, Priority=ttypes.Priority,
        Config=TConfig, errors=terrors,
        QueueManager=lambda name, config=None: tqm.QueueManager(
            name, config=config, clock=clock),
        Rule=tqm.PriorityAdjustRule,
        DelayedQueue=lambda deliver, **kw: tdelayed.DelayedQueue(
            deliver, clock=clock, **kw),
        DLQ=lambda **kw: tdlq.DeadLetterQueue(clock=clock, **kw),
        Worker=lambda *a, **kw: tworker.Worker(*a, clock=clock, **kw),
        Exponential=tworker.ExponentialBackoff, Fixed=tworker.FixedBackoff,
        Factory=lambda config=None: tfactory.QueueFactory(config,
                                                          clock=clock),
        QueueType=tfactory.QueueType)


def _msg(ns, mid, prio="normal", **kw):
    return ns.Message(id=mid, content=kw.pop("content", mid),
                      priority=ns.Priority.from_name(prio), created_at=0.0,
                      **kw)


def _state(m):
    """A message's observable state (the wall-clock creation time aside)."""
    d = m.to_dict()
    d.pop("created_at")
    return d


def _stats(mgr):
    return {q: s.to_dict() for q, s in mgr.get_all_stats().items()}


def _both(scenario):
    """Run ``scenario`` on both packages, each on a fresh fake clock at
    the same start; returns (jax_trace, port_trace)."""
    return (scenario(_jax_ns(jclock.FakeClock())),
            scenario(_port_ns(jclock.FakeClock())))


# -- priority queue + queue manager ---------------------------------------------

def _manager_scenario(ns):
    trace = []
    cfg = ns.Config()
    cfg.queue.max_queue_size = 3
    cfg.queue.stale_message_age = 50.0
    mgr = ns.QueueManager("qm", cfg)
    mgr.add_priority_rule(ns.Rule(
        name="vip", condition=lambda m: bool(m.metadata.get("vip")),
        target_priority=ns.Priority.REALTIME))
    order = [("a", "low"), ("b", "normal"), ("c", "realtime"),
             ("d", "high"), ("e", "normal"), ("f", "normal")]
    for mid, prio in order:
        md = {"vip": True} if mid == "e" else {}
        trace.append(("push", mid, mgr.push_message(
            _msg(ns, mid, prio, metadata=md))))
        ns.clock.advance(1.0)
    m_full = _msg(ns, "g", "normal")
    mgr.push_message(_msg(ns, "h", "normal"))
    try:
        mgr.push_message(m_full)
    except ns.errors.QueueFullError as e:
        trace.append(("full", e.queue_name, e.capacity))
    trace.append(("sizes", {q: mgr.queue.size(q) for q in mgr.queue_names()},
                  mgr.total_pending()))
    trace.append(("rules", [r.name for r in mgr.list_priority_rules()],
                  mgr.remove_priority_rule("vip"),
                  mgr.remove_priority_rule("vip")))
    removed = mgr.remove_message("b")
    trace.append(("removed", _state(removed), mgr.remove_message("zz")))
    popped = mgr.drain_in_priority_order(3)
    trace.append(("drain", [m.id for m in popped],
                  [round(m.last_wait_time, 6) for m in popped]))
    mgr.complete_message(popped[0], 0.5)
    mgr.fail_message(popped[1], 0.25)
    trace.append(("requeue", mgr.requeue_message(popped[2])))
    stashed = mgr.pop_message("normal")
    trace.append(("stash", stashed.id, mgr.stash_for_retry(stashed)))
    ns.clock.advance(60.0)
    mgr.run_monitor_once()
    trace.append(("after_expiry", _stats(mgr), mgr.total_pending()))
    try:
        mgr.pop_message("normal")
    except ns.errors.QueueEmptyError:
        trace.append(("empty", "normal"))
    trace.append(("messages", [_state(m) for m in popped]))
    return trace


def test_queue_manager_matches_jax():
    """Tolerance: none (fake clock). Rules, routing, capacity, admin
    removal, strict-priority drain with measured waits, complete / fail /
    requeue / stash accounting and stale expiry leave the same trace."""
    j, t = _both(_manager_scenario)
    assert t == j


# -- delayed queue -----------------------------------------------------------

def _delayed_scenario(ns):
    trace, delivered, dropped = [], [], []
    fail_for = {"x"}

    def deliver(qname, m):
        if m.id in fail_for:
            raise RuntimeError("queue full")
        delivered.append((qname, m.id, ns.clock.now()))

    dq = ns.DelayedQueue(deliver, name="d",
                         on_drop=lambda q, m, r: dropped.append((q, m.id)))
    dq.schedule_after(_msg(ns, "late"), 5.0, "normal")
    dq.schedule_after(_msg(ns, "early"), 1.0, "high")
    dq.schedule(_msg(ns, "abs"), ns.clock.now() + 3.0, "low")
    dq.schedule_after(_msg(ns, "x"), 2.0, "normal")
    trace.append(("peek", dq.peek().id, dq.next_ready_at() - ns.clock.now(),
                  dq.size()))
    for dt in (0.5, 1.0, 1.0, 1.0, 2.0):
        ns.clock.advance(dt)
        trace.append(("tick", dq.run_due_once(), dq.size()))
    for _ in range(dq.MAX_DELIVERY_ATTEMPTS):
        ns.clock.advance(dq.REDELIVERY_DELAY)
        dq.run_due_once()
    trace.append(("delivered", delivered, "dropped", dropped, dq.size()))
    return trace


def test_delayed_queue_matches_jax():
    """Tolerance: none. Due order, redelivery after a failed delivery and
    the drop to ``on_drop`` after MAX_DELIVERY_ATTEMPTS match."""
    j, t = _both(_delayed_scenario)
    assert t == j


# -- dead-letter queue -----------------------------------------------------------

def _dlq_scenario(ns):
    trace, seen = [], []
    cfg = ns.Config()
    cfg.queue.max_queue_size = 2
    mgr = ns.QueueManager("dl", cfg)
    dlq = ns.DLQ(max_size=3, name="dlq")
    dlq.add_handler(lambda item: seen.append(item.message.id))
    dlq.add_handler(lambda item: 1 / 0)      # a broken handler is survived
    for i in range(5):
        m = _msg(ns, f"m{i}", ("low", "high")[i % 2], retry_count=i,
                 status=ns.Status.FAILED, error="boom")
        dlq.push(m, f"reason {i}", m.priority.tier_name)
        ns.clock.advance(1.0)
    trace.append(("items", [it.to_dict()["message"]["id"]
                            for it in dlq.items()],
                  [(it.fail_reason, it.source_queue, it.retry_count,
                    it.failed_at - ns.clock.now())
                   for it in dlq.items(limit=2)], dlq.size(), seen))
    try:
        dlq.get("m0")
    except ns.errors.MessageNotFoundError as e:
        trace.append(("evicted", e.message_id))
    back = dlq.requeue("m3", mgr)
    trace.append(("requeued", _state(back), _stats(mgr)))
    mgr.push_message(_msg(ns, "fill", "low"))
    mgr.push_message(_msg(ns, "fill2", "low"))
    try:
        dlq.requeue("m2", mgr)       # source queue "low" is full
    except ns.errors.QueueFullError:
        m2 = dlq.get("m2").message
        trace.append(("restored", m2.retry_count, m2.status.value, m2.error))
    trace.append(("batch", [m.id for m in dlq.batch_requeue(mgr)],
                  dlq.size(), dlq.remove("m2"), dlq.clear()))
    return trace


def test_dead_letter_queue_matches_jax():
    """Tolerance: none. Bounded eviction, handlers (one raising), get,
    requeue with reset retry state, the restore when the push fails, and
    batch requeue match."""
    j, t = _both(_dlq_scenario)
    assert t == j


# -- worker ------------------------------------------------------------------------

def _worker_scenario(ns):
    """Retries through the delayed queue with exponential backoff, the
    dead-letter queue after max_retries, a permanent failure hook, a
    successful overrun and an overrun that fails."""
    trace, attempts, permanent = [], {}, []

    def process(ctx, m):
        attempts[m.id] = attempts.get(m.id, 0) + 1
        if m.id == "slow-ok":
            ns.clock.advance(m.timeout + 1.0)
            m.response = "done"
            return
        if m.id == "slow-bad":
            ns.clock.advance(m.timeout + 1.0)
            raise RuntimeError("wedged decode step")
        if m.id == "flaky" and attempts[m.id] < 3:
            raise RuntimeError(f"attempt {attempts[m.id]}")
        if m.id == "doomed":
            raise RuntimeError("always")
        m.response = m.content.upper()

    cfg = ns.Config()
    cfg.queue.retry.initial_backoff = 0.5
    cfg.queue.retry.backoff_multiplier = 3.0
    cfg.queue.worker.max_batch_size = 4
    mgr = ns.QueueManager("w", cfg)
    dq = ns.DelayedQueue(lambda q, m: mgr.push_message(m, q or None))
    dlq = ns.DLQ()
    w = ns.Worker("w0", mgr, process, delayed_queue=dq,
                  dead_letter_queue=dlq,
                  on_permanent_failure=lambda m, r: permanent.append(m.id))
    msgs = [_msg(ns, "ok", "high"), _msg(ns, "flaky", "realtime"),
            _msg(ns, "doomed", "low", max_retries=2),
            _msg(ns, "slow-ok", timeout=5.0, max_retries=0),
            _msg(ns, "slow-bad", timeout=5.0, max_retries=0)]
    for m in msgs:
        mgr.push_message(m)
    for step in range(8):
        n = w.process_batch()
        trace.append(("batch", step, n, dq.size(),
                      [(m.id, m.status.value, m.retry_count,
                        m.scheduled_at and round(m.scheduled_at
                                                 - ns.clock.now(), 6))
                       for m in msgs]))
        ns.clock.advance(1.0)
        dq.run_due_once()
    stats = w.stats.to_dict()
    stats.pop("avg_process_time")
    trace.append(("final", [_state(m) for m in msgs], stats, _stats(mgr),
                  [(it.message.id, it.fail_reason, it.source_queue)
                   for it in dlq.items()], permanent, attempts))
    b, f = ns.Exponential(1.0, 60.0, 2.0), ns.Fixed(2.5)
    trace.append(("backoff", [b.next_backoff(n) for n in (1, 2, 3, 10)],
                  [f.next_backoff(n) for n in (1, 99)]))
    # A dead letter requeued by hand goes back on its queue.
    back = dlq.requeue("doomed", mgr)
    trace.append(("dlq-requeue", back.retry_count, back.status.value))
    return trace


def test_worker_retry_backoff_and_dead_letters_match_jax():
    """Tolerance: none (fake clock). Message states, retry counts and
    backoff delays after every batch, the worker's stats, the per-tier
    stats, the dead letters with their reasons and the permanent-failure
    hook's calls match."""
    j, t = _both(_worker_scenario)
    # Failure reasons carry the exception's repr, the same text in both.
    assert t == j


def _watchdog_run(ns):
    release = threading.Event()
    entered = threading.Event()
    ran_after = threading.Event()

    def handler(ctx, m):
        if m.metadata.get("wedge"):
            entered.set()
            release.wait(10.0)
        else:
            ran_after.set()

    cfg = ns.Config()
    cfg.queue.worker.max_concurrent = 1
    cfg.queue.worker.process_interval = 0.01
    cfg.queue.worker.hard_deadline = True
    cfg.queue.worker.hard_deadline_grace = 2.0
    mgr = ns.QueueManager("wd", cfg)
    dlq = ns.DLQ()
    w = ns.Worker("wd0", mgr, handler, dead_letter_queue=dlq)
    wedged = _msg(ns, "wedged", timeout=1.0, max_retries=0,
                  metadata={"wedge": True})
    mgr.push_message(wedged)
    w.start()
    try:
        deadline = time.monotonic() + 5.0
        assert entered.wait(5.0), ns.name   # the call's deadline is set
        ns.clock.advance(1.5)            # past 1×, inside 2× grace
        time.sleep(0.2)
        inside = (wedged.status.value, dlq.size())
        ns.clock.advance(1.0)            # past the 2× hard deadline
        while dlq.size() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        mgr.push_message(_msg(ns, "after", timeout=5.0, max_retries=0))
        assert ran_after.wait(5.0), ns.name
    finally:
        release.set()
        time.sleep(0.1)
        w.stop()
    stats = w.stats.to_dict()
    stats.pop("avg_process_time")
    return [inside, wedged.status.value, dlq.size(),
            dlq.items()[0].fail_reason.split(" after")[0], stats]


def test_watchdog_matches_jax():
    """Tolerance: none. A call wedged past ``hard_deadline_grace`` × its
    timeout is abandoned in both packages: not before the grace ends,
    then TIMEOUT and a dead letter; the slot is backed by a replacement
    thread (the next message runs); the late return is dropped."""
    j, t = _both(_watchdog_run)
    assert t == j
    assert j[0] == ("processing", 0) and j[1] == "timeout"


# -- factory -----------------------------------------------------------------------

def _factory_scenario(ns):
    trace = []
    cfg = ns.Config()
    f = ns.Factory(cfg)
    for name, qtype in (("standard", "standard"), ("delayed", "delayed"),
                        ("priority", "priority"), ("dead", "dead_letter")):
        f.create_queue_manager(name, ns.QueueType(qtype),
                               start_background=False)
    assert f.create_queue_manager("standard") is \
        f.get_queue_manager("standard")
    trace.append(("names", f.manager_names(),
                  [f.get_dead_letter_queue(n) is not None
                   for n in f.manager_names()]))
    pri = f.get_queue_manager("priority")
    vip = _msg(ns, "vip", "low", metadata={"vip": True})
    big = _msg(ns, "big", "high", content="x" * 10_001)
    trace.append(("rules", [r.name for r in pri.list_priority_rules()],
                  pri.push_message(vip), pri.push_message(big)))
    done = []
    ws = f.create_workers("standard", 2, lambda ctx, m: done.append(m.id),
                          start=False)
    trace.append(("workers", [w.name for w in ws],
                  sorted(f.get_worker_stats("standard"))))
    std = f.get_queue_manager("standard")
    std.push_message(_msg(ns, "one"))
    ws[0].process_batch()
    st = f.get_worker_stats("standard")
    trace.append(("stats", done, {k: {s: v for s, v in d.items()
                                      if s != "avg_process_time"}
                                  for k, d in st.items()}))
    try:
        f.create_workers("nope", 1, lambda ctx, m: None)
    except KeyError:
        trace.append(("missing", True))
    f.get_delayed_queue("standard").schedule_after(_msg(ns, "later"), 1.0,
                                                  "normal")
    ns.clock.advance(2.0)
    f.get_delayed_queue("standard").run_due_once()
    trace.append(("delayed", std.total_pending()))
    f.stop_all()
    return trace


def test_factory_matches_jax():
    """Tolerance: none. The four queue types (dead-letter queues wired,
    the priority type's VIP and long-content rules), workers named and
    counted per manager, delayed delivery and removal match."""
    j, t = _both(_factory_scenario)
    assert t == j


def test_factory_undeliverable_retry_lands_in_dead_letters():
    """The factory's delayed queue hands a retry it cannot deliver to the
    manager's dead-letter queue (both packages)."""
    for ns in (_jax_ns(jclock.FakeClock()), _port_ns(jclock.FakeClock())):
        f = ns.Factory(ns.Config())
        f.create_queue_manager("standard", start_background=False)
        dq = f.get_delayed_queue("standard")
        dq.schedule_after(_msg(ns, "lost"), 0.0, "no-such-queue")
        for _ in range(dq.MAX_DELIVERY_ATTEMPTS):
            dq.run_due_once()
            ns.clock.advance(dq.REDELIVERY_DELAY)
        dlq = f.get_dead_letter_queue("standard")
        assert dlq.size() == 1, ns.name
        assert dlq.get("lost").fail_reason.startswith("undeliverable")
        f.stop_all()


def test_worker_real_loop_retries_through_running_delayed_queue():
    """Real threads, real clock: a failing first attempt is retried after
    the configured backoff by the worker's own delayed-queue thread."""
    from llmq_tpu_torch.core.config import Config

    cfg = Config()
    cfg.queue.retry.initial_backoff = 0.05
    cfg.queue.worker.process_interval = 0.01
    mgr = tqm.QueueManager("loop", cfg)
    calls = []
    done = threading.Event()

    def process(ctx, m):
        calls.append(time.monotonic())
        if len(calls) == 1:
            raise RuntimeError("first attempt fails")
        done.set()

    w = tworker.Worker("w", mgr, process)
    m = ttypes.Message(content="x")
    mgr.push_message(m)
    w.start()
    try:
        assert done.wait(5.0)
    finally:
        w.stop()
    assert m.retry_count == 1 and len(calls) == 2
    assert calls[1] - calls[0] >= 0.05
    assert not w.running


@pytest.mark.parametrize("retry_count,delay", [(1, 1.0), (2, 2.0), (3, 4.0),
                                               (7, 60.0)])
def test_backoff_from_config_matches_jax(retry_count, delay):
    """The config's exponential schedule (1 s × 2ⁿ⁻¹, capped at 60 s) and
    the fixed one, in both packages."""
    for ns in (_jax_ns(jclock.FakeClock()), _port_ns(jclock.FakeClock())):
        cfg = ns.Config()
        w = ns.Worker("b", ns.QueueManager("b", cfg), lambda c, m: None)
        assert w.backoff.next_backoff(retry_count) == delay
        cfg.queue.retry.strategy = "fixed"
        w = ns.Worker("b", ns.QueueManager("b", cfg), lambda c, m: None)
        assert w.backoff.next_backoff(retry_count) == 1.0


def test_threaded_stress_completes_each_message_once():
    """Shared queue state under contention: 300 messages through one
    manager, two workers of 16 threads each and a running delayed queue,
    with a short switch interval; every third message fails its first
    attempt. Each message completes exactly once and the per-tier stats
    add up (a lost update in the queue core, the stats or the retry
    path breaks one of these)."""
    import sys

    from llmq_tpu_torch.core.config import Config

    cfg = Config()
    cfg.queue.retry.initial_backoff = 0.01
    cfg.queue.worker.process_interval = 0.001
    cfg.queue.worker.max_concurrent = 16
    mgr = tqm.QueueManager("stress", cfg)
    dq = tdelayed.DelayedQueue(lambda q, m: mgr.push_message(m, q or None))
    done, mu = {}, threading.Lock()

    def process(ctx, m):
        if int(m.id) % 3 == 0 and m.retry_count == 0:
            raise RuntimeError("first attempt fails")
        with mu:
            done[m.id] = done.get(m.id, 0) + 1

    workers = [tworker.Worker(f"s{i}", mgr, process, delayed_queue=dq)
               for i in range(2)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        dq.start()
        for w in workers:
            w.start()
        prios = list(ttypes.Priority)
        for i in range(300):
            mgr.push_message(ttypes.Message(id=str(i),
                                            priority=prios[i % 4]))
        deadline = time.monotonic() + 30.0
        while len(done) < 300 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        for w in workers:
            w.stop()
        dq.stop()
        sys.setswitchinterval(old)
    assert len(done) == 300 and set(done.values()) == {1}
    stats = mgr.get_all_stats()
    assert sum(s.completed_count for s in stats.values()) == 300
    assert all(s.pending_count == 0 and s.processing_count == 0
               and s.failed_count == 0 for s in stats.values())
    retried = sum(w.stats.to_dict()["retried"] for w in workers)
    assert retried == 100 and not any(w.running for w in workers)


# -- a process function raising a BaseException -----------------------------

class _Crash(BaseException):
    """Not an Exception: what a dying engine loop or an injected crash
    raises through the process function."""


def _base_exception_scenario(ns):
    """The first attempt raises a BaseException subclass: the worker
    schedules retry 1/N through the delayed queue, and the second attempt
    completes the message."""
    attempts = []

    def process(ctx, m):
        attempts.append(m.id)
        if len(attempts) == 1:
            raise _Crash("the loop died under this message")
        m.response = "done"

    cfg = ns.Config()
    cfg.queue.retry.initial_backoff = 0.5
    mgr = ns.QueueManager("crash", cfg)
    dq = ns.DelayedQueue(lambda q, m: mgr.push_message(m, q or None))
    w = ns.Worker("w0", mgr, process, delayed_queue=dq,
                  dead_letter_queue=ns.DLQ())
    m = _msg(ns, "m", "normal", max_retries=3)
    mgr.push_message(m)
    trace = []
    for step in range(3):
        n = w.process_batch()
        trace.append((step, n, m.status.value, m.retry_count,
                      m.scheduled_at and round(m.scheduled_at
                                               - ns.clock.now(), 6),
                      dq.size()))
        ns.clock.advance(1.0)
        dq.run_due_once()
    stats = w.stats.to_dict()
    stats.pop("avg_process_time")
    trace.append((_state(m), stats, _stats(mgr), attempts))
    return trace


def test_base_exception_enters_the_retry_path_like_jax():
    """Tolerance: none (fake clock, synchronous batches). Retry 1 of 3 is
    scheduled after the backoff, and the message completes once."""
    j, t = _both(_base_exception_scenario)
    assert t == j
    final = t[-1][0]
    assert final["status"] == "completed" and final["retry_count"] == 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_base_exception_retried_by_the_threaded_worker(pkg):
    """Real threads and clock: the pool thread survives the BaseException
    and the message completes after one retry, long before the
    watchdog's deadline."""
    cfg = (JConfig if pkg == "jax" else TConfig)()
    cfg.queue.retry.initial_backoff = 0.05
    cfg.queue.worker.process_interval = 0.01
    if pkg == "jax":
        mgr = jqm.QueueManager("crash-loop", cfg, backend="python",
                               enable_metrics=False)
        Worker, Message = jworker.Worker, jtypes.Message
    else:
        mgr = tqm.QueueManager("crash-loop", cfg)
        Worker, Message = tworker.Worker, ttypes.Message
    done = threading.Event()
    calls = []

    def process(ctx, m):
        calls.append(m.id)
        if len(calls) == 1:
            raise _Crash("the loop died under this message")
        done.set()

    w = Worker("w", mgr, process)
    m = Message(content="x", timeout=30.0)
    mgr.push_message(m)
    w.start()
    try:
        assert done.wait(10.0), pkg
    finally:
        w.stop()
    assert m.retry_count == 1 and len(calls) == 2
    deadline = time.time() + 5.0
    while m.status.value != "completed" and time.time() < deadline:
        time.sleep(0.01)
    assert m.status.value == "completed"
