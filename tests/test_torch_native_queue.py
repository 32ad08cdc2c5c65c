"""The port's binding of the native queue core (``native/src/mlq.cpp``
through ``llmq_tpu_torch/native/loader.py``) against the JAX package's
binding of the same source and against the port's Python core: seeded
random scripts of push, pop, pop_handle, pop_if, peek, discard, the
stat transitions and stats give the same answers from all three cores
(hypothesis); the multi-level queue over each core serves the same
order. The loader builds at first use into ``llmq_tpu_torch/_build/``
under a name from the source's hash, once across concurrent processes;
``LLMQ_NATIVE_LIB`` loads a library as it is and a path that does not
load is an error; ``auto`` falls back to the Python core, ``native``
raises."""

import os
import subprocess
import sys
import textwrap

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from llmq_tpu.native import loader as jloader
from llmq_tpu.queueing import priority_queue as jpq

from llmq_tpu_torch.core import types as ttypes
from llmq_tpu_torch.native import loader as tloader
from llmq_tpu_torch.queueing import priority_queue as tpq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not (tloader.native_available() and jloader.native_available()),
    reason="the native queue core does not build here (no g++)")

QUEUES = ("a", "b")
OPS = st.lists(st.tuples(
    st.sampled_from(["push", "push", "push", "pop", "pop_handle",
                     "pop_if", "peek", "discard", "complete", "fail",
                     "requeue_accounting", "size", "stats"]),
    st.sampled_from(QUEUES + ("missing",)),
    st.integers(1, 4),           # priority
    st.integers(0, 40),          # a handle index (may be stale)
    st.floats(0.0, 5.0, allow_nan=False)), max_size=120)


def _cores():
    return {"port_native": tloader.NativeMLQ(),
            "jax_native": jloader.NativeMLQ(),
            "port_python": tpq._PyBackend()}


def _run(core, script):
    """Every answer the core gives over the script."""
    out = []
    for name in QUEUES:
        out.append(core.create_queue(name, 6))
    out.append(core.create_queue("a", 6))           # exists
    now, next_handle = 100.0, 1
    for op, q, prio, idx, dt in script:
        now += dt
        if op == "push":
            out.append(core.push(q, next_handle, prio, now))
            next_handle += 1
        elif op == "pop":
            out.append(core.pop(q, now))
        elif op == "pop_handle":
            out.append(core.pop_handle(q, idx, now))
        elif op == "pop_if":
            err, top = core.peek(q)
            out.append(core.pop_if(q, top if idx % 2 else idx, now))
        elif op == "peek":
            out.append(core.peek(q))
        elif op == "discard":
            out.append(core.discard(q, idx))
        elif op in ("complete", "fail"):
            out.append(getattr(core, op)(q, dt))
        elif op == "requeue_accounting":
            out.append(core.requeue_accounting(q))
        elif op == "size":
            out.append(core.size(q))
        else:
            err, ints, floats = core.stats(q)
            out.append((err, ints, floats) if err == 0 else err)
    out.append([core.stats(q) for q in QUEUES])
    out.append(core.queue_names())
    out.append(core.remove_queue("b"))
    out.append(core.remove_queue("b"))
    out.append((core.has_queue("a"), core.has_queue("b")))
    return out


@settings(max_examples=60, deadline=None)
@given(OPS)
def test_three_cores_answer_alike(script):
    """Tolerance: none (waits and process times are the same float
    sums in each core)."""
    answers = {name: _run(core, script) for name, core in _cores().items()}
    assert answers["port_native"] == answers["jax_native"], script
    assert answers["port_python"] == answers["port_native"], script


@pytest.mark.parametrize("seed", range(4))
def test_multi_level_queues_over_each_core_serve_alike(seed):
    """The port's queue over its native and Python cores and the JAX
    package's over its native core: pops, sizes, a removal, an expiry
    and the stats agree."""
    import random

    from llmq_tpu.core import clock as jclock
    from llmq_tpu.core import types as jtypes

    from llmq_tpu_torch.core import clock as tclock

    rng = random.Random(seed)
    script = [(rng.choice(["push"] * 3 + ["pop", "remove", "expire"]),
               rng.randint(1, 4), rng.random()) for _ in range(80)]
    queues = {"port_native": (tpq.MultiLevelQueue(tclock.FakeClock(),
                                                  "native"), ttypes),
              "port_python": (tpq.MultiLevelQueue(tclock.FakeClock(),
                                                  "python"), ttypes),
              "jax_native": (jpq.MultiLevelQueue(jclock.FakeClock(),
                                                 "native"), jtypes)}
    assert [q.backend_name for q, _ in queues.values()] == [
        "NativeMLQ", "_PyBackend", "NativeMLQ"]
    trace = {}
    for name, (q, types) in queues.items():
        rng = random.Random(seed + 1000)      # the removals' ids
        clock = q._clock
        q.create_queue("q", 50)
        out, n = [], 0
        for op, prio, dt in script:
            clock.advance(dt)
            if op == "push":
                try:
                    q.push("q", types.Message(id=f"m{n}", content="x",
                                              priority=types.Priority(prio)))
                    out.append(("push", n))
                except Exception as e:  # noqa: BLE001 — full
                    out.append(type(e).__name__)
                n += 1
            elif op == "pop":
                m = q.try_pop("q")
                out.append(None if m is None else
                           (m.id, round(m.last_wait_time, 9)))
            elif op == "remove":
                m = q.remove_message("q", f"m{rng.randint(0, n)}")
                out.append(None if m is None else m.id)
            else:
                out.append(sorted(m.id for m in q.expire_older_than("q", 3.0)))
            out.append(q.size("q"))
        out.append(q.get_stats("q").pending_count)
        out.append([m.id for m in q.snapshot("q")])
        trace[name] = out
    assert trace["port_native"] == trace["jax_native"]
    assert trace["port_python"] == trace["port_native"]


def test_library_is_built_from_the_source_into_the_build_dir():
    path = tloader.library_path()
    assert path.parent == tloader.BUILD_DIR
    assert path.name.startswith("libmlq-") and path.suffix == ".so"
    assert tloader.SRC == tloader.BUILD_DIR.parent.parent / "native" / \
        "src" / "mlq.cpp"
    assert tloader.build() == path and path.exists()
    assert tloader.loaded_path() == str(path)
    assert "-Werror" in tloader.CXX_FLAGS and "-O2" in tloader.CXX_FLAGS


def test_concurrent_builds_make_one_library(tmp_path):
    """Four processes build into one empty directory at once: all load
    the same library and no temporary file is left (the compiler writes
    a temporary name under the lock, moved into place)."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from pathlib import Path
        from llmq_tpu_torch.native import loader
        loader.BUILD_DIR = Path({str(tmp_path)!r})
        from llmq_tpu_torch.queueing.priority_queue import MultiLevelQueue
        print(MultiLevelQueue(backend="native").backend_name,
              loader.loaded_path())
    """)
    env = {k: v for k, v in os.environ.items() if k != "LLMQ_NATIVE_LIB"}
    procs = [subprocess.Popen([sys.executable, "-c", script], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1
    name, path = lines.pop().split()
    assert name == "NativeMLQ"
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(path), "libmlq.lock"])


@pytest.mark.parametrize("backend", ["native", "auto"])
def test_a_bad_override_path_is_an_error(backend):
    script = ("from llmq_tpu_torch.queueing.priority_queue import "
              "MultiLevelQueue\n"
              "try:\n"
              f"    q = MultiLevelQueue(backend={backend!r})\n"
              "    raise SystemExit('fell back to ' + q.backend_name)\n"
              "except OSError:\n"
              "    raise SystemExit(0)\n")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, timeout=120,
        env={**os.environ, "LLMQ_NATIVE_LIB": "/nonexistent/lib.so"},
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_an_override_is_loaded_as_it_is(tmp_path):
    """A copy of the built library at another path is what loads (no
    build, no hash check)."""
    import shutil

    copy = tmp_path / "libcopy.so"
    shutil.copy(tloader.build(), copy)
    script = ("from llmq_tpu_torch.queueing.priority_queue import "
              "MultiLevelQueue\n"
              "from llmq_tpu_torch.native import loader\n"
              "q = MultiLevelQueue()\n"
              "print(q.backend_name, loader.loaded_path())\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          timeout=120, capture_output=True, text=True,
                          env={**os.environ, "LLMQ_NATIVE_LIB": str(copy)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["NativeMLQ", str(copy)]


def test_auto_falls_back_and_native_raises_without_a_core(monkeypatch,
                                                          caplog):
    monkeypatch.delenv("LLMQ_NATIVE_LIB", raising=False)
    monkeypatch.setattr(tloader, "_lib", None)
    monkeypatch.setattr(tloader, "_load_failed", True)
    with caplog.at_level("INFO", logger="llmq_tpu_torch.priorityqueue"):
        q = tpq.MultiLevelQueue(backend="auto")
    assert q.backend_name == "_PyBackend"
    assert any("using Python queue backend" in r.getMessage()
               for r in caplog.records)
    with pytest.raises(RuntimeError, match="native queue core unavailable"):
        tpq.MultiLevelQueue(backend="native")
    assert tpq.MultiLevelQueue(backend="python").backend_name == "_PyBackend"


def test_the_default_backend_is_jaxs():
    import inspect

    from llmq_tpu.queueing import queue_manager as jqm

    from llmq_tpu_torch.queueing import queue_manager as tqm

    for t, j in ((tpq.MultiLevelQueue, jpq.MultiLevelQueue),
                 (tqm.QueueManager, jqm.QueueManager)):
        assert inspect.signature(t).parameters["backend"].default == \
            inspect.signature(j).parameters["backend"].default == "auto"
    assert tpq.MultiLevelQueue().backend_name == "NativeMLQ"
