"""Deterministic, seeded fault injection (the port's copy of
``llmq_tpu/chaos/injector.py``).

The durability machinery (WAL redelivery, the dead-letter backstop, the
engine supervisor, the store's breaker) exists to survive faults that
unit tests never produce. This module produces them on demand, at named
fault points of the real code paths:

=====================  ================================================
fault point            seam
=====================  ================================================
``engine.step``        ``InferenceEngine.step``, before scheduling
``engine.hbm_alloc``   ``InferenceEngine._alloc_pages`` (a failed page
                       allocation: the requester stays pending)
``wal.append``         ``QueueWAL.append``, before the journal write
``wal.fsync``          ``QueueWAL.append``'s fsync
``store.get``          ``ResilientStore`` load / list_user
``store.put``          ``ResilientStore`` save
``store.delete``       ``ResilientStore`` delete
``store.kv``           ``ResilientKVStore`` save_kv / load_kv /
                       delete_kv / list_kv (the tiering spill)
``transport.request``  ``HttpEngineClient.process_fn``, before dispatch
``transport.probe``    ``HttpEngineClient.probe`` (``healthy()``)
=====================  ================================================

The ``store.*`` points fire inside the resilience wrapper's worker
(``conversation/resilience.py``), so an injected ``latency`` longer than
``store.resilience.op_timeout_s`` surfaces as a deadline miss, like a
slow backend. At ``transport.request`` an ``error`` is an endpoint
fault (it feeds the endpoint's breaker) and a ``timeout`` a deadline
miss (it does not); at ``transport.probe`` an ``error`` reads as a
refused connection and a ``timeout`` as a slow probe.

A seam is one line, ``chaos.fault(point, **ctx)``, which returns after
one module-attribute check while chaos is disabled (the default).

Determinism: every rule owns a :class:`random.Random` seeded from
``(chaos.seed, rule index)``, and its probability draws consume that
stream in call order, so a scenario replays exactly from the same seed,
rules and call sequence. No global random state is touched.

Kinds:

- ``error``    → :class:`ChaosFault` (a RuntimeError)
- ``timeout``  → :class:`ChaosTimeout` (a TimeoutError: a deadline miss)
- ``partial``  → :class:`ChaosPartialResponse` (a ChaosTimeout: the work
  may have run but the answer was lost)
- ``oserror``  → :class:`ChaosOSError` (WAL write / fsync faults)
- ``latency``  → sleep ``latency_ms``, then go on
- ``crash``    → :class:`EngineCrash` (a BaseException: it passes every
  ``except Exception`` and kills the engine loop thread; the supervisor
  restarts it)
"""

from __future__ import annotations

import fnmatch
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger("llmq_tpu_torch.chaos")

VALID_KINDS = ("error", "timeout", "partial", "oserror", "latency",
               "crash")


class ChaosFault(RuntimeError):
    """Injected replica or engine failure (retryable)."""

    def __init__(self, point: str, seq: int) -> None:
        super().__init__(f"chaos: injected fault at {point} (#{seq})")
        self.point = point
        self.seq = seq


class ChaosTimeout(TimeoutError):
    """Injected deadline miss (never trips a breaker)."""

    def __init__(self, point: str, seq: int) -> None:
        super().__init__(f"chaos: injected timeout at {point} (#{seq})")
        self.point = point
        self.seq = seq


class ChaosPartialResponse(ChaosTimeout):
    """Injected lost response: the work may have happened. A TimeoutError,
    so every indeterminate-outcome guard applies."""


class ChaosOSError(OSError):
    """Injected filesystem fault (WAL write / fsync)."""

    def __init__(self, point: str, seq: int) -> None:
        super().__init__(f"chaos: injected I/O error at {point} (#{seq})")
        self.point = point
        self.seq = seq


class EngineCrash(BaseException):
    """Injected engine-thread death. Not an Exception: the engine loop's
    ``except Exception`` must not absorb it; the thread dies and the
    supervisor (``engine/supervisor.py``) takes over."""

    def __init__(self, point: str, seq: int) -> None:
        super().__init__(f"chaos: injected engine crash at {point} "
                         f"(#{seq})")
        self.point = point
        self.seq = seq


@dataclass
class FaultRule:
    """One configured fault: where, what, how often, how many times."""

    point: str                    # exact name or fnmatch pattern
    kind: str = "error"
    probability: float = 1.0      # firing probability per eligible call
    times: int = 0                # most injections; 0 = unlimited
    #: Eligible calls let through before the rule arms ("crash the
    #: engine on its 10th step").
    after: int = 0
    latency_ms: float = 0.0       # kind "latency"
    #: Context equality filters: {"op": "push"} fires only when the
    #: seam's context carries that value.
    match: Dict[str, str] = field(default_factory=dict)
    injected: int = 0
    seen: int = 0

    def __post_init__(self) -> None:
        if self.kind not in VALID_KINDS:
            raise ValueError(f"unknown chaos fault kind {self.kind!r}; "
                             f"valid: {VALID_KINDS}")

    def matches(self, point: str, ctx: Dict) -> bool:
        if not (self.point == point or fnmatch.fnmatch(point, self.point)):
            return False
        for k, v in self.match.items():
            if str(ctx.get(k)) != str(v):
                return False
        return True


class FaultInjector:
    """The seeded rule engine behind the module-level :func:`fault`."""

    def __init__(self, seed: int = 0,
                 rules: Optional[List[Dict]] = None) -> None:
        self.seed = int(seed)
        self._mu = threading.Lock()
        self._rules: List[FaultRule] = []
        self._rngs: List[random.Random] = []
        #: (point, kind) → injections fired, readable with metrics off.
        self.injected: Dict[Tuple[str, str], int] = {}
        for r in rules or []:
            self.add_rule(**r)

    def add_rule(self, point: str, kind: str = "error",
                 probability: float = 1.0, times: int = 0,
                 after: int = 0, latency_ms: float = 0.0,
                 match: Optional[Dict] = None,
                 **extra_match: Any) -> FaultRule:
        """Register one rule. Keyword arguments past the rule's fields
        become context filters: ``add_rule("wal.append", op="push")``."""
        m = dict(match or {})
        m.update(extra_match)
        rule = FaultRule(point=point, kind=kind,
                         probability=float(probability), times=int(times),
                         after=int(after), latency_ms=float(latency_ms),
                         match=m)
        with self._mu:
            self._rules.append(rule)
            # A rule's draws depend only on (seed, its index, its own
            # calls): adding a rule never perturbs another's pattern.
            self._rngs.append(
                random.Random(self.seed * 1000003 + len(self._rules)))
        return rule

    def clear(self) -> None:
        with self._mu:
            self._rules = []
            self._rngs = []

    def _arm(self, point: str, ctx: Dict) -> Optional[FaultRule]:
        """The first matching rule that fires, under the lock (the seeded
        draw and the counters move together)."""
        with self._mu:
            for rule, rng in zip(self._rules, self._rngs):
                if not rule.matches(point, ctx):
                    continue
                rule.seen += 1
                if rule.seen <= rule.after:
                    continue
                if rule.times and rule.injected >= rule.times:
                    continue
                if rule.probability < 1.0 and rng.random() > rule.probability:
                    continue
                rule.injected += 1
                key = (point, rule.kind)
                self.injected[key] = self.injected.get(key, 0) + 1
                self._count_metric(point, rule.kind)
                return rule
        return None

    @staticmethod
    def _count_metric(point: str, kind: str) -> None:
        try:
            from llmq_tpu_torch.metrics.registry import get_metrics
            get_metrics().chaos_injected.labels(point, kind).inc()
        except Exception:  # noqa: BLE001 — injection must not depend on
            pass           # the metrics plane

    def fault(self, point: str, **ctx: Any) -> None:
        """Evaluate ``point`` against the rules: raise or sleep as the
        first rule that fires says, else return."""
        rule = self._arm(point, ctx)
        if rule is None:
            return
        seq = self.injected[(point, rule.kind)]
        log.warning("chaos: injecting %s at %s (#%d)", rule.kind, point,
                    seq, extra={"fields": {"point": point,
                                           "kind": rule.kind}})
        if rule.kind == "latency":
            time.sleep(max(0.0, rule.latency_ms) / 1e3)
            return
        if rule.kind == "timeout":
            raise ChaosTimeout(point, seq)
        if rule.kind == "partial":
            raise ChaosPartialResponse(point, seq)
        if rule.kind == "oserror":
            raise ChaosOSError(point, seq)
        if rule.kind == "crash":
            raise EngineCrash(point, seq)
        raise ChaosFault(point, seq)

    def get_stats(self) -> Dict:
        with self._mu:
            return {
                "seed": self.seed,
                "rules": [{"point": r.point, "kind": r.kind,
                           "probability": r.probability,
                           "times": r.times, "injected": r.injected}
                          for r in self._rules],
                "injected": {f"{p}:{k}": n
                             for (p, k), n in self.injected.items()},
            }


#: The process's injector; None while chaos is disabled, and then
#: :func:`fault` returns after one attribute check.
_injector: Optional[FaultInjector] = None


def configure(cfg: Any) -> Optional[FaultInjector]:
    """Install the process injector from a ``ChaosConfig`` (or anything
    with ``enabled`` / ``seed`` / ``faults``). Disabled or None removes
    it."""
    global _injector
    if cfg is None or not getattr(cfg, "enabled", False):
        _injector = None
        return None
    inj = FaultInjector(seed=int(getattr(cfg, "seed", 0) or 0),
                        rules=list(getattr(cfg, "faults", []) or []))
    _injector = inj
    log.warning("chaos plane ENABLED: seed=%d, %d rule(s)", inj.seed,
                len(inj._rules))
    return inj


def get_injector() -> Optional[FaultInjector]:
    return _injector


def fault(point: str, **ctx: Any) -> None:
    """The seam instrumented code calls: a no-op while chaos is off."""
    inj = _injector
    if inj is None:
        return
    inj.fault(point, **ctx)
