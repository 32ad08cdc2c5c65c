"""Circuit breaker with jittered exponential backoff (the port's copy of
``llmq_tpu/loadbalancer/circuit_breaker.py``).

Consecutive failures trip the breaker; while OPEN every call is refused
at once (no socket, no timeout) until a jittered exponential backoff
elapses and one HALF_OPEN probe is let through. A success closes the
breaker; a failed probe opens it again with the backoff doubled (up to
its cap).

Deadline misses (TimeoutError) never count as faults: a guarded resource
that is merely slow is not broken, and tripping on timeouts would turn an
overload into an outage of its own making.

The jitter is seeded per breaker (from its id, or a given seed), so chaos
scenarios replay exactly.

States: CLOSED → (``failure_threshold`` consecutive failures) → OPEN →
(backoff elapses) → HALF_OPEN → success → CLOSED | failure → OPEN.

The cluster router holds one breaker per endpoint (:class:`BreakerBoard`),
shared with each endpoint's HTTP transport, and their state and trips
feed ``circuit_breaker_state{endpoint}`` and
``circuit_breaker_trips_total{endpoint}``. The store fault domain
(``conversation/resilience.py``) holds one for the conversation store,
without metrics of its own here: it sets ``store_breaker_state``.
"""

from __future__ import annotations

import enum
import logging
import random
import threading
import zlib
from typing import Dict, Optional

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock

log = logging.getLogger("llmq_tpu_torch.circuit_breaker")


class BreakerState(str, enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


#: The state gauge's encoding.
STATE_VALUE = {BreakerState.CLOSED: 0, BreakerState.HALF_OPEN: 1,
               BreakerState.OPEN: 2}


class CircuitOpenError(RuntimeError):
    """A call refused because the breaker is OPEN (the caller treats the
    endpoint as unavailable for now, not as a fresh fault)."""

    def __init__(self, endpoint: str, retry_in: float) -> None:
        super().__init__(
            f"circuit open for {endpoint}; next probe in {retry_in:.2f}s")
        self.endpoint = endpoint
        self.retry_in = retry_in


class CircuitBreaker:
    def __init__(self, endpoint_id: str, *,
                 failure_threshold: int = 3,
                 base_backoff: float = 1.0,
                 max_backoff: float = 30.0,
                 jitter: float = 0.2,
                 clock: Optional[Clock] = None,
                 seed: Optional[int] = None,
                 metrics=None) -> None:
        self.endpoint_id = endpoint_id
        #: The metric families (or None). They ride the breaker, since
        #: whoever holds it records the outcomes (the HTTP transport for
        #: a remote endpoint, the router for a local engine).
        self._metrics = metrics
        self.failure_threshold = max(1, int(failure_threshold))
        self.base_backoff = float(base_backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = max(0.0, min(1.0, float(jitter)))
        self._clock = clock or SYSTEM_CLOCK
        # The id hashes into the seed: two breakers never share a jitter
        # stream, and a rerun of a scenario replays it.
        if seed is None:
            seed = zlib.crc32(endpoint_id.encode("utf-8"))
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.trips = 0
        #: Consecutive trips without a success between: the backoff
        #: ladder's rung.
        self._trip_streak = 0
        self._open_until = 0.0
        #: True while the HALF_OPEN probe is out: one caller a window.
        self._probe_inflight = False

    # -- gate ----------------------------------------------------------------

    def allow(self) -> bool:
        """May a call go now? OPEN → False until the backoff elapses, then
        exactly one caller gets the HALF_OPEN probe slot."""
        with self._mu:
            if self.state == BreakerState.CLOSED:
                return True
            now = self._clock.now()
            if self.state == BreakerState.OPEN and now >= self._open_until:
                self.state = BreakerState.HALF_OPEN
                self._probe_inflight = False
                self._set_gauge()
            if self.state == BreakerState.HALF_OPEN:
                if self._probe_inflight:
                    return False
                self._probe_inflight = True
                log.info("breaker %s half-open: probe dispatch allowed",
                         self.endpoint_id)
                return True
            return False

    def blocked(self) -> bool:
        """Whether a new call would be refused now (OPEN inside the window,
        or HALF_OPEN with the probe out), without taking the probe slot."""
        with self._mu:
            if self.state == BreakerState.CLOSED:
                return False
            if self.state == BreakerState.HALF_OPEN:
                return self._probe_inflight
            return self._clock.now() < self._open_until

    def retry_in(self) -> float:
        """Seconds until the next probe slot (0 when not OPEN)."""
        with self._mu:
            if self.state != BreakerState.OPEN:
                return 0.0
            return max(0.0, self._open_until - self._clock.now())

    # -- outcomes ------------------------------------------------------------

    def record_success(self) -> None:
        """A call succeeded: the only evidence that closes the breaker and
        resets the backoff ladder."""
        with self._mu:
            self.consecutive_failures = 0
            self._trip_streak = 0
            self._probe_inflight = False
            if self.state != BreakerState.CLOSED:
                log.info("breaker %s closed (probe succeeded)",
                         self.endpoint_id)
                self.state = BreakerState.CLOSED
                # Only on a transition: this runs on every success.
                self._set_gauge()

    def record_probe_success(self) -> None:
        """A passing health probe: weaker evidence than a call. It clears a
        CLOSED breaker's failure streak but never closes an OPEN one."""
        with self._mu:
            if self.state == BreakerState.CLOSED:
                self.consecutive_failures = 0

    def record_timeout(self) -> None:
        """A call missed its deadline: neither fault nor success, but it
        gives back a half-open probe slot the call may hold (or the
        resource would stay excluded for good)."""
        with self._mu:
            self._probe_inflight = False

    def record_failure(self) -> None:
        """One fault (never a deadline miss: callers filter TimeoutError
        first)."""
        with self._mu:
            self.consecutive_failures += 1
            if self.state == BreakerState.HALF_OPEN:
                self._trip(probe_failed=True)
            elif (self.state == BreakerState.CLOSED
                  and self.consecutive_failures >= self.failure_threshold):
                self._trip()

    def _trip(self, probe_failed: bool = False) -> None:
        self._trip_streak += 1
        self.trips += 1
        backoff = min(self.max_backoff,
                      self.base_backoff * (2.0 ** (self._trip_streak - 1)))
        if self.jitter:
            backoff *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        self.state = BreakerState.OPEN
        self._probe_inflight = False
        self._open_until = self._clock.now() + backoff
        if self._metrics is not None:
            try:
                self._metrics.circuit_breaker_trips.labels(
                    self.endpoint_id).inc()
            except Exception:  # noqa: BLE001 — metrics never fail a call
                log.exception("breaker trip counter failed")
        self._set_gauge()
        log.warning("breaker %s OPEN for %.2fs (%s, trip #%d)",
                    self.endpoint_id, backoff,
                    "half-open probe failed" if probe_failed
                    else f"{self.consecutive_failures} consecutive failures",
                    self.trips)

    def _set_gauge(self) -> None:
        """Caller holds self._mu."""
        if self._metrics is not None:
            try:
                self._metrics.circuit_breaker_state.labels(
                    self.endpoint_id).set(STATE_VALUE[self.state])
            except Exception:  # noqa: BLE001
                log.exception("breaker state gauge failed")

    def get_stats(self) -> Dict:
        with self._mu:
            return {
                "endpoint": self.endpoint_id,
                "state": self.state.value,
                "consecutive_failures": self.consecutive_failures,
                "trips": self.trips,
                "retry_in": (max(0.0, self._open_until - self._clock.now())
                             if self.state == BreakerState.OPEN else 0.0),
            }



class BreakerBoard:
    """A router's breakers, one per endpoint id, each made on first use
    from one config (``cluster.breaker``; None → the defaults)."""

    def __init__(self, config=None, *, clock: Optional[Clock] = None,
                 enable_metrics: bool = True) -> None:
        self.config = config
        self._clock = clock
        self._mu = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._metrics = None
        if enable_metrics:
            from llmq_tpu_torch.metrics.registry import get_metrics
            self._metrics = get_metrics()

    @property
    def enabled(self) -> bool:
        return self.config is None or getattr(self.config, "enabled", True)

    def breaker(self, endpoint_id: str) -> CircuitBreaker:
        with self._mu:
            br = self._breakers.get(endpoint_id)
            if br is None:
                cfg = self.config
                br = CircuitBreaker(
                    endpoint_id,
                    failure_threshold=getattr(cfg, "failure_threshold", 3),
                    base_backoff=getattr(cfg, "base_backoff", 1.0),
                    max_backoff=getattr(cfg, "max_backoff", 30.0),
                    jitter=getattr(cfg, "jitter", 0.2),
                    clock=self._clock,
                    metrics=self._metrics)
                self._breakers[endpoint_id] = br
            return br

    def allow(self, endpoint_id: str) -> bool:
        if not self.enabled:
            return True
        return self.breaker(endpoint_id).allow()

    def blocked(self, endpoint_id: str) -> bool:
        """Selection's check (never takes the half-open probe slot). An
        endpoint without a breaker yet is not blocked."""
        if not self.enabled:
            return False
        with self._mu:
            br = self._breakers.get(endpoint_id)
        return br.blocked() if br is not None else False

    def record(self, endpoint_id: str, ok: bool) -> None:
        """An outcome of an engine without a breaker of its own (the HTTP
        transport records on the shared breaker itself)."""
        if not self.enabled:
            return
        br = self.breaker(endpoint_id)
        if ok:
            br.record_success()
        else:
            br.record_failure()

    def record_timeout(self, endpoint_id: str) -> None:
        if not self.enabled:
            return
        with self._mu:
            br = self._breakers.get(endpoint_id)
        if br is not None:
            br.record_timeout()

    def get_stats(self) -> Dict:
        with self._mu:
            return {eid: br.get_stats()
                    for eid, br in self._breakers.items()}
