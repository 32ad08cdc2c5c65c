"""The port's spool transport (``queueing/spool.py``) against the JAX
package's, on fake clocks: the same messages published at the same times
give the same file names and records; a consumer of either package
claims what a producer of the other published, in priority order; a
claim by rename lets exactly one consumer win; a stale claim comes back
after ``claim_ttl`` and not before; an unreadable file is parked; a
failed delivery returns the file; ``done/`` acknowledgements cross
packages and stay until their callback succeeds. As in
``tests/test_spool.py``."""

import json
import os
import threading

import pytest

from llmq_tpu.core import types as jtypes
from llmq_tpu.queueing import spool as jspool

from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.queueing import queue_manager as tqm
from llmq_tpu_torch.queueing import spool as tspool
from llmq_tpu_torch.queueing.worker import Worker

PKGS = {"jax": (jspool, jtypes), "port": (tspool, ttypes)}


class FakeTime:
    """Stands in for a spool module's ``time``: ``time()`` is ``now``."""

    def __init__(self, now: float) -> None:
        self.now = now

    def time(self) -> float:
        return self.now


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock for both packages' spool modules."""
    clock = FakeTime(1_700_000_000.0)
    monkeypatch.setattr(jspool, "time", clock)
    monkeypatch.setattr(tspool, "time", clock)
    return clock


def msg(pkg, mid, prio=3, content="x"):
    types = PKGS[pkg][1]
    return types.Message(id=mid, content=content, priority=types.Priority(prio),
                         created_at=1000.0, updated_at=1000.0)


def _publish(pkg, sd, clock, prios):
    spool = PKGS[pkg][0]
    prod = spool.SpoolProducer(str(sd))
    names = []
    for i, p in enumerate(prios):
        clock.now += 0.25
        names.append(prod.push(msg(pkg, f"m{i}", p, f"body {i}"),
                               "normal" if p == 3 else ""))
    return names


def test_file_names_and_records_are_jaxs(tmp_path, clocks):
    """Tolerance: none. The same messages published at the same (fake)
    times give the same file names and byte-identical records."""
    prios = [4, 1, 3, 2, 1, 3]
    start = clocks.now
    names = {}
    for pkg in PKGS:
        clocks.now = start
        names[pkg] = _publish(pkg, tmp_path / pkg, clocks, prios)
    assert names["jax"] == names["port"]
    assert names["port"][0] == "4-1700000000.250000-000001-m0.msg"
    for name in names["port"]:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        names["port"] + ["done"])


@pytest.mark.parametrize("producer,consumer", [("jax", "port"),
                                               ("port", "jax"),
                                               ("port", "port")])
def test_a_consumer_claims_the_other_packages_files_in_priority_order(
        tmp_path, clocks, producer, consumer):
    prios = [4, 1, 3, 2, 1, 3, 4, 2]
    _publish(producer, tmp_path, clocks, prios)
    got = []
    cons = PKGS[consumer][0].SpoolConsumer(
        str(tmp_path), lambda q, m: got.append((q, m.id, int(m.priority),
                                                m.content)))
    assert cons.run_once() == len(prios)
    assert [g[2] for g in got] == sorted(prios)
    assert [g[1] for g in got] == ["m1", "m4", "m3", "m7", "m2", "m5",
                                   "m0", "m6"]
    assert all(g[0] == ("normal" if g[2] == 3 else None) for g in got)
    assert all(g[3] == f"body {g[1][1:]}" for g in got)
    assert PKGS[consumer][0].pending_files(str(tmp_path)) == []


def test_claim_by_rename_lets_one_consumer_win(tmp_path):
    """Four consumers, three of the port and one of the JAX package, scan
    one spool at once: every message is delivered exactly once."""
    prod = tspool.SpoolProducer(str(tmp_path))
    for i in range(40):
        prod.push(msg("port", f"m{i}"))
    seen = []
    lock = threading.Lock()

    def deliver(q, m):
        with lock:
            seen.append(m.id)

    consumers = [tspool.SpoolConsumer(str(tmp_path), deliver,
                                      consumer_id=f"c{i}") for i in range(3)]
    consumers.append(jspool.SpoolConsumer(str(tmp_path), deliver,
                                          consumer_id="j0"))
    threads = [threading.Thread(target=c.run_once) for c in consumers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(seen) == sorted(f"m{i}" for i in range(40))
    assert len(seen) == len(set(seen))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_stale_claim_comes_back_after_its_ttl(tmp_path, clocks, pkg):
    """A claim left by a consumer that died mid-delivery stays claimed
    until ``claim_ttl`` seconds after its claim, then is redelivered."""
    spool = PKGS[pkg][0]
    spool.SpoolProducer(str(tmp_path)).push(msg(pkg, "m1"))
    name = spool.pending_files(str(tmp_path))[0]
    claim = tmp_path / f"{name}.dead.claim"
    os.rename(tmp_path / name, claim)
    stamp = os.path.getmtime(claim)
    got = []
    cons = spool.SpoolConsumer(str(tmp_path), lambda q, m: got.append(m.id),
                               consumer_id="alive", claim_ttl=120.0)
    clocks.now = stamp + 119.0
    assert cons.run_once() == 0 and claim.exists()
    clocks.now = stamp + 121.0
    assert cons.run_once() == 1
    assert got == ["m1"] and not claim.exists()
    assert spool.pending_files(str(tmp_path)) == []


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_claim_is_stamped_with_its_claim_time(tmp_path, clocks, pkg):
    """A file published long ago and claimed now is not stale: the TTL
    runs from the claim, not from the publish."""
    spool = PKGS[pkg][0]
    spool.SpoolProducer(str(tmp_path)).push(msg(pkg, "old"))
    name = spool.pending_files(str(tmp_path))[0]
    os.utime(tmp_path / name, (0, 0))           # published at the epoch
    held = []

    def deliver(q, m):
        held.extend(os.listdir(tmp_path))
        claim = next(n for n in held if n.endswith(".claim"))
        held.append(os.path.getmtime(tmp_path / claim))

    spool.SpoolConsumer(str(tmp_path), deliver).run_once()
    assert held[-1] > 1e9


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_poison_file_is_parked(tmp_path, pkg):
    spool = PKGS[pkg][0]
    prod = spool.SpoolProducer(str(tmp_path))
    (tmp_path / "0-000-000001-bad.msg").write_text("{not json")
    prod.push(msg(pkg, "good"))
    got = []
    spool.SpoolConsumer(str(tmp_path), lambda q, m: got.append(m.id)).run_once()
    assert got == ["good"]
    assert sorted(os.listdir(tmp_path)) == [
        "0-000-000001-bad.msg.poison", "done"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_failed_delivery_returns_the_file(tmp_path, pkg):
    """Backpressure (the local queue full) returns the message to the
    spool for a later scan instead of losing it."""
    spool = PKGS[pkg][0]
    spool.SpoolProducer(str(tmp_path)).push(msg(pkg, "m1"))
    name = spool.pending_files(str(tmp_path))[0]

    def full(q, m):
        raise RuntimeError("queue full")

    assert spool.SpoolConsumer(str(tmp_path), full).run_once() == 0
    assert spool.pending_files(str(tmp_path)) == [name]


@pytest.mark.parametrize("acker,collector", [("port", "jax"),
                                             ("jax", "port"),
                                             ("port", "port")])
def test_acknowledgements_cross_packages(tmp_path, acker, collector):
    """A consumer's ``done/`` record is read by the other package's
    collector; a record whose callback fails stays for the next scan."""
    cons = PKGS[acker][0].SpoolConsumer(str(tmp_path), lambda q, m: None)
    m = msg(acker, "m1", 2, "hello")
    m.response = "world"
    m.status = PKGS[acker][1].MessageStatus.COMPLETED
    m.metadata["usage"] = {"completion_tokens": 5}
    cons.ack_done(m)
    assert json.loads((tmp_path / "done" / "m1.json").read_text()) == \
        m.to_dict()
    calls = []

    def flaky(done):
        calls.append(done)
        if len(calls) == 1:
            raise RuntimeError("store down")

    coll = PKGS[collector][0].SpoolCollector(str(tmp_path), flaky)
    assert coll.run_once() == 0 and (tmp_path / "done" / "m1.json").exists()
    assert coll.run_once() == 1 and coll.run_once() == 0
    done = calls[-1]
    assert (done.id, done.response, done.status.value, done.metadata) == (
        "m1", "world", "completed", {"usage": {"completion_tokens": 5}})


def test_two_queue_planes_joined_only_by_the_spool(tmp_path):
    """The split topology in one process: a gateway manager drains into
    the spool, a consumer manager's worker processes and acknowledges,
    the collector hands the result back."""
    sd = str(tmp_path)
    gw = tqm.QueueManager("gateway", backend="python", enable_metrics=False)
    prod = tspool.SpoolProducer(sd)
    gw.push_message(ttypes.Message(id="m1", content="ping", timeout=30.0))
    for m in gw.drain_in_priority_order(10):
        prod.push(m)
    cm = tqm.QueueManager("consumer", backend="python", enable_metrics=False)
    cons = tspool.SpoolConsumer(sd, lambda q, m: cm.push_message(m, q))

    def process(ctx, m):
        m.response = m.content + " pong"
        ack = ttypes.Message.from_dict(m.to_dict())
        ack.status = ttypes.MessageStatus.COMPLETED
        cons.ack_done(ack)

    w = Worker("w0", cm, process)
    assert cons.run_once() == 1
    w.process_batch()
    done = []
    assert tspool.SpoolCollector(sd, done.append).run_once() == 1
    assert (done[0].response, done[0].status) == (
        "ping pong", ttypes.MessageStatus.COMPLETED)
