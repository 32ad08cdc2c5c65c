"""The port's write-ahead log and its queue manager against the JAX
package's, side by side: the same op sequence writes the same journal
and replays to the same live set in both packages; a journal written by
either package restores in the other; the torn tail, the restore
overflow, the compaction races and crash windows, the stale expiry and
the factory's ``wal_dir`` behave as in ``tests/test_wal.py``; a journal
that cannot record a push raises ``WALError`` and counts
``wal_errors_total``."""

import errno
import logging
import os
import sys
import threading

import numpy as np
import pytest

from llmq_tpu.core import clock as jclock
from llmq_tpu.core import errors as jerrors
from llmq_tpu.core import types as jtypes
from llmq_tpu.core.config import Config as JConfig
from llmq_tpu.queueing import factory as jfactory
from llmq_tpu.queueing import queue_manager as jqm
from llmq_tpu.queueing import wal as jwal

from llmq_tpu_torch.core import clock as tclock
from llmq_tpu_torch.core import errors as terrors
from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.core.config import Config as TConfig
from llmq_tpu_torch.metrics import registry as treg
from llmq_tpu_torch.queueing import factory as tfactory
from llmq_tpu_torch.queueing import queue_manager as tqm
from llmq_tpu_torch.queueing import wal as twal

PKGS = {
    "jax": dict(types=jtypes, errors=jerrors, Config=JConfig, qm=jqm,
                wal=jwal, factory=jfactory, clock=jclock),
    "port": dict(types=ttypes, errors=terrors, Config=TConfig, qm=tqm,
                 wal=twal, factory=tfactory, clock=tclock),
}
OTHER = {"jax": "port", "port": "jax"}


def mk(pkg, mid, prio=3, content="x"):
    t = PKGS[pkg]["types"]
    return t.Message(id=mid, content=content, user_id="u",
                     priority=t.Priority(prio), created_at=1000.0,
                     updated_at=1000.0)


def manager(pkg, path, config=None, clock=None):
    p = PKGS[pkg]
    return p["qm"].QueueManager("m", config=config, clock=clock,
                                backend="python", enable_metrics=False,
                                wal_path=str(path))


def live(pkg, path):
    """The replayed live set as comparable rows."""
    return [(q, m.id, int(m.priority), m.content, m.metadata)
            for q, m in PKGS[pkg]["wal"].QueueWAL.replay(str(path))]


def _script(seed: int, n: int = 60):
    """A random op sequence over a handful of ids: (op, queue, id)."""
    rng = np.random.default_rng(seed)
    ops = ["push", "pop", "complete", "fail", "remove", "requeue", "stash"]
    out = []
    for _ in range(n):
        op = ops[int(rng.integers(len(ops)))]
        mid = f"m{int(rng.integers(12))}"
        q = ("normal", "high")[int(rng.integers(2))]
        out.append((op, q, mid, int(rng.integers(1, 5))))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_same_ops_write_the_same_journal_and_replay(tmp_path, seed):
    """Tolerance: none. One op sequence appended through each package's
    QueueWAL gives byte-identical files, and each package's replay of
    each file gives the same live set."""
    paths = {}
    for pkg in PKGS:
        path = tmp_path / f"{pkg}.wal"
        w = PKGS[pkg]["wal"].QueueWAL(str(path), fsync_every=8)
        for op, q, mid, prio in _script(seed):
            msg = mk(pkg, mid, prio, content=f"{mid}-{prio}") \
                if op == "push" else None
            w.append(op, q, mid, msg)
        w.close()
        paths[pkg] = path
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    sets = {(r, w): live(r, paths[w]) for r in PKGS for w in PKGS}
    assert len({repr(v) for v in sets.values()}) == 1, sets


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_journal_restores_in_the_other_package(tmp_path, writer):
    """Tolerance: none. A queue manager of one package journals pushes,
    pops, completes, a requeue and an admin removal; the other package's
    manager restores the same pending set in the same order (popped but
    unfinished messages redelivered, finished and removed ones not)."""
    path = tmp_path / "q.wal"
    qm = manager(writer, path)
    for i, p in enumerate([4, 1, 3, 1, 3, 2, 3]):
        msg = mk(writer, f"m{i}", p, content=f"c{i} wörld")
        msg.metadata["k"] = i
        qm.push_message(msg)
    done = qm.pop_message("realtime")            # m1, completed
    qm.complete_message(done, 0.1)
    qm.pop_message("realtime")                   # m3, in flight
    back = qm.pop_message("normal")              # m2, requeued
    qm.requeue_message(back)
    qm.remove_message("m6")
    qm.stop()
    reader = OTHER[writer]
    qm2 = manager(reader, path)
    got = [(m.id, int(m.priority), m.content, m.metadata)
           for m in qm2.drain_in_priority_order(10)]
    qm2.stop()
    assert got == [("m3", 1, "c3 wörld", {"k": 3}),
                   ("m5", 2, "c5 wörld", {"k": 5}),
                   ("m2", 3, "c2 wörld", {"k": 2}),
                   ("m4", 3, "c4 wörld", {"k": 4}),
                   ("m0", 4, "c0 wörld", {"k": 0})]
    # The restore compacted the journal to the restored set, which the
    # drain left popped and unfinished: both packages replay it alike.
    assert live("jax", path) == live("port", path)
    assert [r[1] for r in live(reader, path)] == ["m0", "m2", "m3", "m4",
                                                  "m5"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_torn_trailing_line_is_skipped(tmp_path, pkg):
    path = tmp_path / "q.wal"
    qm = manager(pkg, path)
    qm.push_message(mk(pkg, "good"))
    qm.stop()
    with open(path, "a") as f:
        f.write('{"op": "push", "q": "normal", "id": "torn", "ms')
    assert live("jax", path) == live("port", path)
    qm2 = manager(pkg, path)
    assert [m.id for m in qm2.drain_in_priority_order(10)] == ["good"]
    qm2.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_restart_compacts_the_journal(tmp_path, pkg):
    path = tmp_path / "q.wal"
    qm = manager(pkg, path)
    for i in range(50):
        qm.push_message(mk(pkg, f"m{i}"))
    for m in qm.drain_in_priority_order(49):
        qm.complete_message(m, 0.0)
    qm.stop()
    assert sum(1 for _ in open(path)) >= 148
    manager(pkg, path).stop()
    assert [r[1] for r in live(pkg, path)] == ["m49"]
    assert sum(1 for _ in open(path)) == 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_restore_overflow_drops_and_starts(tmp_path, pkg):
    """More live records than the queue holds: the overflow is dropped
    with an error log and the manager starts (5 of 7 restored)."""
    cfg = PKGS[pkg]["Config"]()
    cfg.queue.max_queue_size = 5
    path = tmp_path / "q.wal"
    qm = manager(pkg, path, config=cfg)
    for i in range(5):
        qm.push_message(mk(pkg, f"m{i}"))
    qm.pop_message("normal")
    qm.pop_message("normal")
    qm.push_message(mk(pkg, "m5"))
    qm.push_message(mk(pkg, "m6"))
    qm.stop()
    records = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = records.append
    logger = logging.getLogger({"jax": "llmq.queue_manager",
                                "port": "llmq_tpu_torch.queue_manager"}[pkg])
    logger.addHandler(handler)
    try:
        qm2 = manager(pkg, path, config=cfg)
    finally:
        logger.removeHandler(handler)
    assert qm2.total_pending() == 5
    assert [r.getMessage() for r in records] == [
        "wal: DROPPED 2 restored messages over queue capacity (m)"]
    qm2.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_stale_expiry_is_not_resurrected(tmp_path, pkg):
    clock = PKGS[pkg]["clock"].FakeClock()
    path = tmp_path / "q.wal"
    qm = manager(pkg, path, clock=clock)
    qm.qconfig.stale_message_age = 10.0
    qm.push_message(mk(pkg, "old"))
    clock.advance(100.0)
    qm.push_message(mk(pkg, "fresh"))
    qm.run_monitor_once()
    qm.stop()
    qm2 = manager(pkg, path, clock=clock)
    assert [m.id for m in qm2.drain_in_priority_order(10)] == ["fresh"]
    qm2.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_monitor_compacts_a_running_journal(tmp_path, pkg):
    path = tmp_path / "q.wal"
    qm = manager(pkg, path)
    qm.qconfig.stale_message_age = 0
    for i in range(400):
        qm.push_message(mk(pkg, f"m{i}"))
    for m in qm.drain_in_priority_order(399):
        qm.complete_message(m, 0.0)
    assert sum(1 for _ in open(path)) >= 1100
    qm.run_monitor_once()
    assert sum(1 for _ in open(path)) == 1
    qm.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_push_during_compaction_is_not_erased(tmp_path, pkg):
    """A push made while the monitor compacts waits for the snapshot and
    then survives the swap (buffered into the new file or appended after
    it)."""
    path = tmp_path / "q.wal"
    qm = manager(pkg, path)
    qm.qconfig.stale_message_age = 0
    for i in range(600):
        qm.push_message(mk(pkg, f"m{i}"))
    for m in qm.drain_in_priority_order(600):
        qm.complete_message(m, 0.0)
    in_snapshot, release = threading.Event(), threading.Event()
    orig = qm.queue.snapshot

    def stalling(qname):
        in_snapshot.set()
        release.wait(5.0)
        return orig(qname)

    qm.queue.snapshot = stalling
    compact = threading.Thread(target=qm.run_monitor_once)
    compact.start()
    assert in_snapshot.wait(5.0)
    pushed = threading.Event()
    pusher = threading.Thread(
        target=lambda: (qm.push_message(mk(pkg, "late")), pushed.set()))
    pusher.start()
    assert not pushed.wait(0.3)
    release.set()
    compact.join(5.0)
    pusher.join(5.0)
    assert pushed.is_set()
    qm.stop()
    assert [r[1] for r in live(pkg, path)] == ["late"]
    assert live("jax", path) == live("port", path)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_compaction_aborts_cleanly_on_a_failed_snapshot(tmp_path, pkg):
    path = tmp_path / "q.wal"
    qm = manager(pkg, path)
    qm.qconfig.stale_message_age = 0
    for i in range(600):
        qm.push_message(mk(pkg, f"m{i}"))
    for m in qm.drain_in_priority_order(600):
        qm.complete_message(m, 0.0)

    def boom(qname):
        raise RuntimeError("snapshot failed")

    orig = qm.queue.snapshot
    qm.queue.snapshot = boom
    with pytest.raises(RuntimeError):
        qm.run_monitor_once()
    assert qm._wal._compact_buf is None
    assert not (tmp_path / "q.wal.tmp").exists()
    qm.queue.snapshot = orig
    qm.run_monitor_once()
    assert sum(1 for _ in open(path)) == 0
    qm.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rewrite_refuses_during_a_compaction(tmp_path, pkg):
    w = PKGS[pkg]["wal"].QueueWAL(str(tmp_path / "q.wal"))
    assert w.begin_compact()
    assert not w.begin_compact()
    with pytest.raises(RuntimeError):
        w.rewrite([])
    w.finish_compact(0, commit=False)
    w.rewrite([])
    w.close()


def _seed_journal(pkg, path):
    """10 pushes, 4 completed: a live set of 6."""
    w = PKGS[pkg]["wal"].QueueWAL(str(path), fsync_every=1)
    msgs = [mk(pkg, f"c{i}") for i in range(10)]
    for m in msgs:
        w.append("push", "normal", m.id, m)
    for m in msgs[:4]:
        w.append("complete", "normal", m.id)
    return w, [("normal", m) for m in msgs[4:]], {m.id for m in msgs[4:]}


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("window", ["before_swap_torn_tmp", "after_swap",
                                    "torn_compacted_tail"])
def test_compaction_crash_windows(tmp_path, pkg, window):
    """A crash at any point of a compaction leaves a journal that both
    packages replay to the live set (a torn last record loses only
    itself)."""
    path = tmp_path / "q.wal"
    w, live_set, expected = _seed_journal(pkg, path)
    assert w.begin_compact()
    n = w.write_compact_tmp(live_set)
    if window == "before_swap_torn_tmp":
        w._compact_tmp.flush()
        tmp = str(path) + ".tmp"
        with open(tmp, "r+b") as f:
            f.truncate(max(1, os.path.getsize(tmp) // 2))
    else:
        w.finish_compact(n)
        if window == "after_swap":
            extra = mk(pkg, "after")
            w.append("push", "normal", extra.id, extra)
            expected = expected | {"after"}
        w.close()
        if window == "torn_compacted_tail":
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) - 7)
    got = {r[1] for r in live(pkg, path)}
    assert got == {r[1] for r in live(OTHER[pkg], path)}
    if window == "torn_compacted_tail":
        assert got < expected and len(got) == len(expected) - 1
    else:
        assert got == expected


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_concurrent_pushers_completers_and_compactions(tmp_path, pkg):
    """Every message not completed replays; nothing completed comes
    back as pending."""
    path = tmp_path / "q.wal"
    qm = manager(pkg, path)
    qm.qconfig.stale_message_age = 0
    done = threading.Event()
    completed = []

    def pusher(tag):
        for i in range(300):
            qm.push_message(mk(pkg, f"{tag}-{i}"))

    def completer():
        while not done.is_set():
            for m in qm.drain_in_priority_order(16):
                qm.complete_message(m, 0.0)
                completed.append(m.id)

    def compactor():
        while not done.is_set():
            qm.run_monitor_once()

    threads = [threading.Thread(target=pusher, args=(t,)) for t in "ab"]
    threads += [threading.Thread(target=completer),
                threading.Thread(target=compactor)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # switch threads often
    try:
        for t in threads:
            t.start()
        for t in threads[:2]:
            t.join(30.0)
        done.set()
        for t in threads[2:]:
            t.join(10.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    leftover = {m.id for m in qm.drain_in_priority_order(10_000)}
    qm.stop()
    restored = {r[1] for r in live(pkg, path)}
    assert leftover <= restored
    assert not (restored & set(completed) - leftover)
    assert len(leftover) + len(completed) == 600


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_factory_gives_each_manager_its_journal(tmp_path, pkg):
    fac_mod = PKGS[pkg]["factory"]
    cfg = PKGS[pkg]["Config"]()
    cfg.queue.enable_metrics = False
    cfg.queue.wal_dir = str(tmp_path)
    fac = fac_mod.QueueFactory(cfg, backend="python")
    man = fac.create_queue_manager("std", fac_mod.QueueType.STANDARD,
                                   start_background=False)
    man.push_message(mk(pkg, "f1"))
    fac.stop_all()
    assert (tmp_path / "std.wal").exists()
    fac2 = fac_mod.QueueFactory(cfg, backend="python")
    man2 = fac2.create_queue_manager("std", fac_mod.QueueType.STANDARD,
                                     start_background=False)
    assert man2.total_pending() == 1
    fac2.stop_all()


class _FullDisk:
    """A journal whose appends fail as a full disk does."""

    def __init__(self, wal, ops):
        self._wal, self._ops = wal, ops

    def append(self, op, *a, **kw):
        if op in self._ops:
            raise OSError(errno.ENOSPC, "No space left on device")
        return self._wal.append(op, *a, **kw)

    def __getattr__(self, name):
        return getattr(self._wal, name)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_journal_that_cannot_record_a_push_sheds_it(tmp_path, pkg):
    """The push raises WALError (an OSError too) and nothing is queued;
    a worker-side record that fails is logged and counted, the pop
    itself stands."""
    p = PKGS[pkg]
    fam = treg.get_metrics().wal_errors
    before = {op: fam.labels(op).get() for op in ("push", "pop")}
    qm = p["qm"].QueueManager("walerr", backend="python",
                              enable_metrics=True,
                              wal_path=str(tmp_path / "q.wal"))
    wal = qm._wal
    qm._wal = _FullDisk(wal, {"push"})
    with pytest.raises(p["errors"].WALError) as e:
        qm.push_message(mk(pkg, "a"))
    assert isinstance(e.value, OSError) and e.value.op == "push"
    assert qm.total_pending() == 0
    qm._wal = wal
    qm.push_message(mk(pkg, "b"))
    qm._wal = _FullDisk(wal, {"pop"})
    assert qm.pop_message("normal").id == "b"
    qm._wal = wal
    qm.stop()
    if pkg == "port":
        assert {op: fam.labels(op).get() - before[op]
                for op in before} == {"push": 1.0, "pop": 1.0}
