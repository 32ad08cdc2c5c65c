"""The port's lockdep instrument against the JAX package's, on the CPU.

Mirrors ``TestLockdep`` and ``TestInvariantCheckerUnderLockdep`` of
``tests/test_analysis.py``: every scripted lock sequence runs once under
the JAX package's lockdep and once under the port's
(``llmq_tpu_torch.analysis.lockdep``), each checker the package's own,
and the two must flag the same violations (their kinds and count), the
same lock-order edges between the script's allocation sites and the same
same-site nestings (tolerance: none). Added: the port's ``install()``
refuses to nest over another instrument, and an echo scenario runs under
the port's lockdep with no violation, as it does under JAX's.

Under ``LLMQ_LOCKDEP=1`` the test harness has installed the JAX
package's instrument for the whole session; each script lifts it while
the port's runs and puts it back after (never two patches at once), and
clears the script's own violations, as ``test_analysis.py``'s
``lockdep_session`` does.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

import pytest

from llmq_tpu.analysis import lockdep as jld
from llmq_tpu.chaos.invariants import InvariantChecker as JChecker

from llmq_tpu_torch.analysis import lockdep as tld
from llmq_tpu_torch.chaos.invariants import InvariantChecker as TChecker

pytestmark = [
    pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning"),
]

HERE = os.path.basename(__file__)
PKGS = (("jax", jld, JChecker), ("port", tld, TChecker))


@contextlib.contextmanager
def lockdep_session(ld):
    """Install ``ld`` for one script and leave the process as found: the
    other package's instrument is lifted first and restored after."""
    other = tld if ld is jld else jld
    other_was = other.is_installed()
    if other_was:
        other.uninstall()
    was = ld.is_installed()
    ld.install()
    ld.reset()
    try:
        yield ld
    finally:
        ld.reset()
        if not was:
            ld.uninstall()
        if other_was:
            other.install()


def _summary(ld):
    """What a script left in ``ld``'s graph: violation kinds in order,
    the edges and same-site nestings among this file's allocation sites,
    and whether ``check()`` raises."""
    graph = ld._graph
    ours = {s for s in graph.sites_seen if s.startswith(HERE + ":")}
    try:
        ld.check()
        raised = False
    except ld.LockOrderViolation:
        raised = True
    return {
        "violations": [v.split(":")[0] for v in ld.violations()],
        "edges": sorted((a, b) for a, succ in graph.edges.items()
                        for b in succ if a in ours and b in ours),
        "self_sites": sorted(s for s in graph.self_sites if s in ours),
        "check_raises": raised,
    }


def _both(script):
    """``script(ld, checker_cls)`` under each package's instrument; the
    summaries (and anything the script returns) must be equal."""
    out = {}
    for name, ld, checker in PKGS:
        with lockdep_session(ld):
            ret = script(ld, checker)
            out[name] = (_summary(ld), ret)
    assert out["jax"] == out["port"], out
    return out["port"][0]


class TestLockdep:
    def test_abba_cycle_detected(self):
        def script(ld, _c):
            a = threading.Lock()
            b = threading.Lock()

            def order_ab():
                with a:
                    with b:
                        pass

            def order_ba():
                with b:
                    with a:
                        pass

            # Sequentially: no deadlock ever happens, yet the potential
            # must be detected from the order graph.
            t1 = threading.Thread(target=order_ab)
            t1.start(); t1.join()
            t2 = threading.Thread(target=order_ba)
            t2.start(); t2.join()

        got = _both(script)
        assert got["violations"] == ["lock-order cycle"]
        assert got["check_raises"]

    def test_three_lock_cycle_detected(self):
        def script(ld, _c):
            a = threading.Lock()
            b = threading.Lock()
            c = threading.Lock()
            for first, second in ((a, b), (b, c), (c, a)):
                t = threading.Thread(
                    target=lambda f=first, s=second: [
                        f.acquire(), s.acquire(), s.release(), f.release()])
                t.start(); t.join()

        got = _both(script)
        assert "lock-order cycle" in got["violations"]
        assert len(got["edges"]) == 3

    def test_consistent_order_is_clean(self):
        def script(ld, _c):
            a = threading.Lock()
            b = threading.RLock()
            for _ in range(5):
                with a:
                    with b:
                        pass
            rep = ld.report()
            return rep["edges"] >= 1 and not rep["violations"]

        got = _both(script)
        assert not got["check_raises"] and len(got["edges"]) == 1

    def test_held_lock_sleep_flagged(self):
        def script(ld, _c):
            lk = threading.Lock()
            with lk:
                time.sleep(0.001)

        got = _both(script)
        assert got["violations"] == ["held-lock blocking call"]

    def test_sleep_without_lock_is_clean(self):
        def script(ld, _c):
            time.sleep(0.001)

        assert not _both(script)["check_raises"]

    def test_condition_wait_notify_no_false_positive(self):
        def script(ld, _c):
            got_all = []
            for mk in (threading.Lock, threading.RLock, None):
                cond = threading.Condition(mk() if mk else None)
                got = []

                def waiter():
                    with cond:
                        got.append(cond.wait(timeout=2.0))

                t = threading.Thread(target=waiter)
                t.start()
                time.sleep(0.05)
                with cond:
                    cond.notify_all()
                t.join()
                got_all.append(got)
            return got_all

        got = _both(script)
        assert not got["check_raises"]

    def test_rlock_reentrancy_no_self_edge(self):
        def script(ld, _c):
            r = threading.RLock()
            with r:
                with r:
                    pass
            return ld.report()["edges"]

        got = _both(script)
        assert not got["check_raises"] and not got["edges"]
        assert not got["self_sites"]

    def test_try_acquire_failure_adds_no_edge(self):
        def script(ld, _c):
            a = threading.Lock()
            b = threading.Lock()
            with b:
                pass
            tried = []

            def hold_b_and_try_a():
                with b:
                    # a is held by the main thread: the failed try must
                    # not record b -> a (try-locks cannot deadlock).
                    tried.append(a.acquire(blocking=False))

            with a:
                t = threading.Thread(target=hold_b_and_try_a)
                t.start(); t.join()
            with a:
                with b:
                    pass
            return tried

        got = _both(script)
        assert not got["check_raises"]

    def test_uninstall_restores_factories(self):
        def script(ld, _c):
            return isinstance(threading.Lock(), ld._TrackedLock)

        _both(script)
        for _name, ld, _c in PKGS:
            with lockdep_session(ld):
                assert isinstance(threading.Lock(), ld._TrackedLock)
            if not ld.is_installed():
                assert not isinstance(threading.Lock(), ld._TrackedLock)

    def test_same_site_nesting_is_a_self_site(self):
        """Two locks from one allocation line nested: recorded as a
        self site, never an edge or a violation."""
        def script(ld, _c):
            locks = [threading.Lock() for _ in range(2)]
            with locks[0]:
                with locks[1]:
                    pass

        got = _both(script)
        assert len(got["self_sites"]) == 1 and not got["edges"]
        assert not got["check_raises"]

    def test_port_refuses_to_nest_over_another_instrument(self):
        """The port's ``install()`` raises while the JAX package's
        instrument holds ``threading.Lock``, and patches nothing."""
        was = jld.is_installed()
        with lockdep_session(jld):
            before = threading.Lock
            with pytest.raises(RuntimeError, match="another lock instrument"):
                tld.install()
            assert not tld.is_installed() and threading.Lock is before
        assert jld.is_installed() == was


class TestInvariantCheckerUnderLockdep:
    """Each package's chaos InvariantChecker driven concurrently under
    its package's instrument: the checker verifies the engine, lockdep
    verifies the checker."""

    N_THREADS = 8
    N_PER_THREAD = 200

    def _drive(self, checker, tid):
        for i in range(self.N_PER_THREAD):
            rid = f"t{tid}-r{i}"
            checker.submitted(rid)
            cb = checker.on_token(rid)
            for tok in range(4):
                cb(tok)
            if i % 7 == 0:
                checker.shed(rid, 429)
            elif i % 5 == 0:
                checker.failed(rid, "injected")
            else:
                checker.completed(rid, tokens=[0, 1, 2, 3, 99])
            if i % 13 == 0:
                checker.violations()   # a reader racing the writers

    def test_concurrent_checker_is_lock_clean_and_correct(self):
        def script(ld, checker_cls):
            checker = checker_cls()
            threads = [threading.Thread(target=self._drive,
                                        args=(checker, t))
                       for t in range(self.N_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            checker.check()
            return checker.summary()

        got = _both(script)
        assert not got["check_raises"]

    def test_checker_still_detects_violations_under_lockdep(self):
        def script(ld, checker_cls):
            checker = checker_cls()
            checker.submitted("lost")
            checker.submitted("dup")
            checker.completed("dup")
            checker.completed("dup")
            v = checker.violations()
            return (any("LOST" in x for x in v),
                    any("DUPLICATE" in x for x in v))

        got = _both(script)
        assert not got["check_raises"]


def test_echo_scenario_under_lockdep():
    """``agentic_tool_loops`` at scale 0.05 on each package's echo engine
    under its package's lockdep: every turn completes and neither
    instrument records a violation."""
    from llmq_tpu import scenarios as jscn
    from llmq_tpu.observability.usage import get_usage_ledger as jledger
    from llmq_tpu_torch import scenarios as tscn
    from llmq_tpu_torch.observability.usage import (
        get_usage_ledger as tledger)

    quiet = [logging.getLogger(n) for n in ("llmq.engine",
                                            "llmq_tpu_torch.engine")]
    levels = [lg.level for lg in quiet]
    for lg in quiet:
        lg.setLevel(logging.ERROR)
    leds = {"jax": jledger(), "port": tledger()}
    was = {k: led.enabled for k, led in leds.items()}
    out = {}
    try:
        for (name, ld, _c), scn in zip(PKGS, (jscn, tscn)):
            with lockdep_session(ld):
                rep = scn.run_scenario("agentic_tool_loops", scale=0.05)
                graph = ld.report()
                out[name] = (rep["requests"]["completed"],
                             rep["invariants"]["violations"],
                             graph["violations"], graph["sites"] > 0)
    finally:
        for lg, lvl in zip(quiet, levels):
            lg.setLevel(lvl)
        for k, led in leds.items():
            led.reconfigure(enabled=was[k])
            led.clear()
    assert out["jax"] == out["port"] == (78, 0, [], True), out
