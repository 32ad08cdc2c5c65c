"""Python lockdep: runtime lock-order-graph instrument (docs/analysis.md),
the port's copy of ``llmq_tpu/analysis/lockdep.py``.

Linux lockdep for the Python side of the engine: while installed, every
lock created through ``threading.Lock()`` / ``threading.RLock()`` is a
tracked proxy. Each successful acquisition records the *held → acquired*
edge set per thread into one global lock-order graph, keyed by the
lock's **allocation site** (file:line of the ``Lock()`` call) — the
Python analogue of lockdep's lock classes. Two violation kinds:

1. **Lock-order cycle** — thread X ever takes A then B while thread Y
   (or X, later) ever takes B then A. The classic ABBA deadlock needs
   the two orders to interleave *at runtime* to wedge; the graph proves
   the *potential* on any single clean run, which is the whole point.
2. **Held-lock blocking call** — ``time.sleep(>0)`` executed while any
   tracked lock is held. A sleeping lock-holder turns every contender's
   latency into the sleep duration; on the engine's step path that is a
   stall, on the API path a tail-latency cliff.

Edges between two locks from the SAME allocation site (e.g. two
per-queue locks out of one constructor line) are recorded but reported
separately (``self_sites``) and do not fail ``check()``: same-site
ordering needs an instance-level annotation scheme to judge, and the
repo's per-queue/per-tenant locks are never nested with each other.
Reentrant RLock re-acquisitions add no edges.

Zero overhead when off: nothing is patched until ``install()``; the
opt-in is ``LLMQ_LOCKDEP=1`` for ``chip_smoke.py`` (install happens after
``torch`` is imported and before any other ``llmq_tpu_torch`` module
creates a lock, and the run fails at its end on any violation).

Unlike the JAX package's copy, the proxies wrap the raw ``_thread``
factories, never ``threading.Lock`` / ``RLock`` as found at import, and
``install()`` refuses while another instrument holds ``threading.Lock``
patched (the JAX package's, which its test harness installs under the
same variable): two patches would nest, each tracking the other's locks.

Usage::

    from llmq_tpu_torch.analysis import lockdep
    lockdep.install()
    try:
        ...   # drive concurrent code
        lockdep.check()      # raises LockOrderViolation with stacks
    finally:
        lockdep.uninstall()
"""

from __future__ import annotations

import _thread
import os
import threading
import time
import traceback
from types import FunctionType, TracebackType
from typing import Any, Dict, List, Optional, Set, Tuple, Type

__all__ = [
    "LockOrderViolation",
    "install",
    "uninstall",
    "is_installed",
    "reset",
    "violations",
    "check",
    "report",
    "enabled_by_env",
]

ENV_VAR = "LLMQ_LOCKDEP"

#: Frames from these basenames are skipped when attributing an
#: allocation site / capturing an acquisition stack.
_INTERNAL_FILES = ("lockdep.py", "threading.py")

# The raw factories the proxies wrap (``threading.Lock`` and
# ``threading.RLock`` build these while unpatched).
_orig_lock = _thread.allocate_lock
_orig_rlock = _thread.RLock
# What install() replaced, restored by uninstall(); ``_orig_sleep`` is the
# sleep the tracked one calls.
_orig_sleep = time.sleep
_replaced: Tuple[Any, Any, Any] = (threading.Lock, threading.RLock,
                                   time.sleep)

# The tracker's own mutex must be a RAW lock — an instrumented one
# would recurse into the tracker.
_state_mu = _orig_lock()


class LockOrderViolation(AssertionError):
    """Raised by ``check()``; message carries every violation at once."""


class _TlsHeld(threading.local):
    def __init__(self) -> None:
        # [(site, lock_id, reentry_count)] in acquisition order.
        self.stack: List[List[Any]] = []


class _Graph:
    """Site-level lock-order graph + violation log (one per install)."""

    def __init__(self) -> None:
        #: site -> set of sites acquired while it was held.
        self.edges: Dict[str, Set[str]] = {}
        #: (from, to) -> one sample stack (list of frame strings).
        self.samples: Dict[Tuple[str, str], List[str]] = {}
        self.self_sites: Set[str] = set()
        self.violations: List[str] = []
        self.sites_seen: Set[str] = set()

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src → dst in the edge graph, or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self.edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def add_edge(self, held_site: str, new_site: str, stack: List[str]) -> None:
        if held_site == new_site:
            self.self_sites.add(held_site)
            return
        succ = self.edges.setdefault(held_site, set())
        if new_site in succ:
            return
        # Cycle check BEFORE inserting: a path new → held plus this
        # edge held → new closes a cycle.
        back = self._path(new_site, held_site)
        succ.add(new_site)
        self.samples[(held_site, new_site)] = stack
        if back is not None:
            fwd = " -> ".join([held_site, new_site])
            rev = " -> ".join(back)
            rev_sample = self.samples.get(
                (back[0], back[1]) if len(back) > 1 else (held_site, new_site),
                [])
            self.violations.append(
                f"lock-order cycle: [{fwd}] conflicts with established "
                f"order [{rev}]\n"
                f"  this acquisition:\n    " + "\n    ".join(stack) + "\n"
                f"  conflicting order first seen at:\n    "
                + "\n    ".join(rev_sample))


_graph = _Graph()
_held = _TlsHeld()
_installed = False


def _site_of_caller() -> str:
    """file:line of the nearest frame outside lockdep/threading."""
    for line in reversed(traceback.extract_stack(limit=16)):
        base = os.path.basename(line.filename)
        if base not in _INTERNAL_FILES:
            return f"{base}:{line.lineno}"
    return "<unknown>"


def _stack_sample(limit: int = 12) -> List[str]:
    out = []
    for fr in traceback.extract_stack(limit=limit):
        base = os.path.basename(fr.filename)
        if base in _INTERNAL_FILES:
            continue
        out.append(f"{base}:{fr.lineno} in {fr.name}")
    return out[-6:]


def _note_acquired(lock_id: int, site: str) -> None:
    stack = _held.stack
    for entry in stack:
        if entry[1] == lock_id:   # reentrant re-acquire: no new edges
            entry[2] += 1
            return
    if stack:
        sample = _stack_sample()
        with _state_mu:
            _graph.sites_seen.add(site)
            for held_site, held_id, _ in stack:
                if held_id != lock_id:
                    _graph.add_edge(held_site, site, sample)
    else:
        with _state_mu:
            _graph.sites_seen.add(site)
    stack.append([site, lock_id, 1])


def _note_released(lock_id: int) -> None:
    stack = _held.stack
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][1] == lock_id:
            stack[i][2] -= 1
            if stack[i][2] <= 0:
                del stack[i]
            return
    # Release of a lock acquired before install / on another thread
    # (locks may legally be released by a different thread): ignore.


class _TrackedLock:
    """Proxy over a raw lock, recording the order graph. Supports the
    ``threading.Condition`` integration surface via delegation."""

    _factory = staticmethod(_orig_lock)

    def __init__(self) -> None:
        self._inner = self._factory()
        self._site = _site_of_caller()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquired(id(self), self._site)
        return got

    def release(self) -> None:
        self._inner.release()
        _note_released(id(self))

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, name: str) -> Any:
        # Forward everything else raw (_at_fork_reinit and friends).
        # Only reached for names not defined on the proxy class, so the
        # tracked acquire/release above always win; for a plain Lock
        # the RLock-only hooks (_is_owned, _release_save, ...) raise
        # AttributeError from the raw lock exactly as Condition's
        # hasattr probes expect.
        return getattr(self._inner, name)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, exc_type: Optional[Type[BaseException]],
                 exc: Optional[BaseException],
                 tb: Optional[TracebackType]) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<lockdep {type(self).__name__} site={self._site} {self._inner!r}>"


class _TrackedRLock(_TrackedLock):
    _factory = staticmethod(_orig_rlock)

    # threading.Condition probes for these with hasattr: an RLock proxy
    # must forward them (wrapped, so the held-stack stays accurate
    # across cond.wait's release/reacquire); a plain Lock proxy must
    # NOT define them — Condition's fallbacks for raw locks go through
    # release()/acquire(), which are already tracked.
    def _acquire_restore(self, state: Any) -> None:
        self._inner._acquire_restore(state)  # type: ignore[attr-defined]
        _note_acquired(id(self), self._site)

    def _release_save(self) -> Any:
        state = self._inner._release_save()  # type: ignore[attr-defined]
        _note_released(id(self))
        return state

    def _is_owned(self) -> bool:
        return self._inner._is_owned()  # type: ignore[attr-defined]


def _tracked_lock_factory() -> _TrackedLock:
    return _TrackedLock()


def _tracked_rlock_factory() -> _TrackedRLock:
    return _TrackedRLock()


def _tracked_sleep(seconds: float) -> None:
    if seconds and seconds > 0 and _held.stack:
        sites = [s for s, _, _ in _held.stack]
        sample = _stack_sample()
        with _state_mu:
            _graph.violations.append(
                f"held-lock blocking call: time.sleep({seconds!r}) while "
                f"holding {sites}\n    " + "\n    ".join(sample))
    _orig_sleep(seconds)


def install() -> None:
    """Patch ``threading.Lock``/``RLock`` and ``time.sleep``. Locks
    created before install are untracked (install early — chip_smoke's
    hook runs before any other llmq_tpu_torch import). Raises
    ``RuntimeError`` while another instrument holds ``threading.Lock``
    patched."""
    global _installed, _orig_sleep, _replaced
    with _state_mu:
        if _installed:
            return
        if isinstance(threading.Lock, FunctionType):
            raise RuntimeError(
                "threading.Lock is patched by another lock instrument: "
                "uninstall it first (two patches would nest)")
        _installed = True
        _replaced = (threading.Lock, threading.RLock, time.sleep)
        _orig_sleep = time.sleep
    threading.Lock = _tracked_lock_factory        # type: ignore[misc,assignment]
    threading.RLock = _tracked_rlock_factory      # type: ignore[misc,assignment]
    time.sleep = _tracked_sleep


def uninstall() -> None:
    global _installed
    with _state_mu:
        if not _installed:
            return
        _installed = False
    threading.Lock, threading.RLock, time.sleep = _replaced  # type: ignore[misc]


def is_installed() -> bool:
    return _installed


def enabled_by_env() -> bool:
    return os.environ.get(ENV_VAR, "") == "1"


def reset() -> None:
    """Clear the graph and violation log (state survives across
    install/uninstall so a test harness can inspect after teardown)."""
    global _graph
    with _state_mu:
        _graph = _Graph()


def violations() -> List[str]:
    with _state_mu:
        return list(_graph.violations)


def check() -> None:
    """Raise ``LockOrderViolation`` listing every violation."""
    v = violations()
    if v:
        raise LockOrderViolation(
            f"{len(v)} lockdep violation(s):\n\n" + "\n\n".join(v))


def report() -> Dict[str, Any]:
    with _state_mu:
        return {
            "installed": _installed,
            "sites": len(_graph.sites_seen),
            "edges": sum(len(v) for v in _graph.edges.values()),
            "self_sites": sorted(_graph.self_sites),
            "violations": list(_graph.violations),
        }
