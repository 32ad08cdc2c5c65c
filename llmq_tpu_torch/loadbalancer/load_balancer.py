"""Load balancer over inference endpoints (the port's copy of
``llmq_tpu/loadbalancer/load_balancer.py``).

- an endpoint registry grouped by model type, which the REST endpoints
  routes add to, list, drain and delete
- selection (``get_endpoint``, by ``metadata["model_type"]``, default
  "llm"): ``round_robin`` (a cursor per model type),
  ``least_connections``, ``weighted_random`` and ``adaptive_load``
  (score = 0.4·load + 0.4·normalised response time + 0.2·error rate,
  lowest wins, the runner-up one time in ten), over the healthy and
  degraded endpoints with connection headroom; ``acquire_endpoint``
  books one endpoint the caller chose (the cluster router's affinity)
- session affinity with a TTL, and the sessions' cleanup
- ``release_endpoint`` keeps a response-time EWMA (9:1) and a decaying
  error rate, which ``adaptive_load`` scores
- health: healthy → degraded → unhealthy, recovering through degraded,
  driven by a pluggable probe (default: the attached engine's
  ``healthy()`` when the endpoint's metadata holds one, a TCP connect
  for http/tcp URLs, up for a bare ``local://``)
- ``draining``: an operator state, no new dispatch, which probes
  neither end nor change

An endpoint is typically a host running an engine in process
(``url="local://engine0"``) or behind HTTP (``loadbalancer/transport.py``).
Selection consumes the random stream as the JAX package's does, so a
seeded ``weighted_random`` or ``adaptive_load`` picks the same endpoints.
"""

from __future__ import annotations

import enum
import logging
import random
import socket
import threading
import urllib.parse
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import LoadBalancerConfig
from llmq_tpu_torch.core.errors import NoEndpointError
from llmq_tpu_torch.core.types import Message

log = logging.getLogger("llmq_tpu_torch.loadbalancer")

DEFAULT_MODEL_TYPE = "llm"


class EndpointStatus(str, enum.Enum):
    """DRAINING is the graceful-removal state: no new dispatch,
    in-flight work finishes, probes neither resurrect nor demote it."""

    HEALTHY = "healthy"
    DEGRADED = "degraded"
    UNHEALTHY = "unhealthy"
    DRAINING = "draining"


@dataclass
class Endpoint:
    id: str
    name: str = ""
    url: str = ""                     # http://host:port | local://engine | tcp://host:port
    model_type: str = DEFAULT_MODEL_TYPE
    weight: float = 1.0
    max_connections: int = 0          # 0 = unlimited
    status: EndpointStatus = EndpointStatus.HEALTHY
    connections: int = 0
    response_time: float = 0.0        # EWMA seconds
    error_rate: float = 0.0           # decaying [0,1]
    total_requests: int = 0
    total_errors: int = 0
    last_health_check: float = 0.0
    consecutive_failures: int = 0
    consecutive_successes: int = 0
    metadata: Dict = field(default_factory=dict)  # e.g. {"chips": 8, "hbm_gb": 128}

    @property
    def load(self) -> float:
        if self.max_connections > 0:
            return min(1.0, self.connections / self.max_connections)
        # Soft load proxy when unbounded: saturate around 100 connections.
        return min(1.0, self.connections / 100.0)

    def to_dict(self) -> Dict:
        return {
            "id": self.id,
            "name": self.name,
            "url": self.url,
            "model_type": self.model_type,
            "weight": self.weight,
            "status": self.status.value,
            "connections": self.connections,
            "response_time": self.response_time,
            "error_rate": self.error_rate,
            "total_requests": self.total_requests,
            "total_errors": self.total_errors,
            "load": self.load,
            # JSON-safe subset only: local:// endpoints carry the live
            # engine OBJECT in metadata (the health probe's contract) —
            # serializing it would 500 every endpoint-listing route.
            "metadata": {k: v for k, v in self.metadata.items()
                         if isinstance(v, (str, int, float, bool,
                                           type(None), list, dict))},
        }


#: Probe returns True when the endpoint is healthy.
ProbeFn = Callable[[Endpoint], bool]


def default_probe(endpoint: Endpoint, timeout: float = 2.0) -> bool:
    """Consults an attached engine/transport's ``healthy()`` when one is
    present in metadata (in-process engines AND http transports — the
    transport checks the peer's /health engine state, so a host whose
    server is up but whose engine died still fails over); otherwise
    TCP-connect for http/https/tcp URLs, trivially-up for bare
    ``local://``."""
    url = endpoint.url
    engine = endpoint.metadata.get("engine")
    if engine is not None and hasattr(engine, "healthy"):
        try:
            return bool(engine.healthy())
        except Exception:  # noqa: BLE001
            return False
    if url.startswith("local://") or not url:
        return True  # in-process with no engine attached: trivially up
    try:
        parsed = urllib.parse.urlparse(url)
        host = parsed.hostname or "localhost"
        port = parsed.port or (443 if parsed.scheme == "https" else 80)
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


# Health state machine thresholds.
_FAILURES_TO_DEGRADE = 1
_FAILURES_TO_UNHEALTHY = 3
_SUCCESSES_TO_RECOVER = 2


class LoadBalancer:
    def __init__(
        self,
        config: Optional[LoadBalancerConfig] = None,
        clock: Optional[Clock] = None,
        probe: Optional[ProbeFn] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.config = config or LoadBalancerConfig()
        self._clock = clock or SYSTEM_CLOCK
        self._probe = probe or default_probe
        self._rng = rng or random.Random()
        self._endpoints: Dict[str, Endpoint] = {}
        self._by_type: Dict[str, List[str]] = {}
        self._rr_cursor: Dict[str, int] = {}
        self._sessions: Dict[str, tuple] = {}  # session_id → (endpoint_id, expires_at)
        self._mu = threading.RLock()
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None

    # -- registry -----------------------------------------------------------

    def add_endpoint(self, endpoint: Endpoint) -> None:
        with self._mu:
            self._endpoints[endpoint.id] = endpoint
            self._by_type.setdefault(endpoint.model_type, [])
            if endpoint.id not in self._by_type[endpoint.model_type]:
                self._by_type[endpoint.model_type].append(endpoint.id)
        log.info("endpoint added: %s (%s, type=%s)",
                 endpoint.id, endpoint.url, endpoint.model_type)

    def remove_endpoint(self, endpoint_id: str) -> bool:
        with self._mu:
            ep = self._endpoints.pop(endpoint_id, None)
            if ep is None:
                return False
            ids = self._by_type.get(ep.model_type, [])
            if endpoint_id in ids:
                ids.remove(endpoint_id)
            self._sessions = {
                sid: (eid, exp) for sid, (eid, exp) in self._sessions.items()
                if eid != endpoint_id}
            return True

    def get_endpoint_by_id(self, endpoint_id: str) -> Optional[Endpoint]:
        with self._mu:
            return self._endpoints.get(endpoint_id)

    def endpoints(self, model_type: Optional[str] = None) -> List[Endpoint]:
        with self._mu:
            if model_type is None:
                return list(self._endpoints.values())
            return [self._endpoints[i] for i in self._by_type.get(model_type, [])]

    def set_endpoint_status(self, endpoint_id: str, status: EndpointStatus) -> bool:
        with self._mu:
            ep = self._endpoints.get(endpoint_id)
            if ep is None:
                return False
            ep.status = EndpointStatus(status)
            return True

    def set_draining(self, endpoint_id: str, draining: bool = True) -> bool:
        """Enter/leave the DRAINING state. Leaving re-enters via
        DEGRADED so the probe must prove health before full traffic."""
        with self._mu:
            ep = self._endpoints.get(endpoint_id)
            if ep is None:
                return False
            if draining:
                ep.status = EndpointStatus.DRAINING
            elif ep.status == EndpointStatus.DRAINING:
                ep.status = EndpointStatus.DEGRADED
                ep.consecutive_successes = 0
            return True

    # -- selection -----------------------------------------------------------

    def acquire_endpoint(self, endpoint_id: str,
                         session_id: Optional[str] = None
                         ) -> Optional[Endpoint]:
        """Book an endpoint the caller chose (the cluster router's
        affinity). None, and the caller selects another way, when the
        endpoint is gone, UNHEALTHY or DRAINING, or has no headroom."""
        with self._mu:
            ep = self._endpoints.get(endpoint_id)
            if (ep is None
                    or ep.status in (EndpointStatus.UNHEALTHY,
                                     EndpointStatus.DRAINING)
                    or (ep.max_connections > 0
                        and ep.connections >= ep.max_connections)):
                return None
            ep.connections += 1
            ep.total_requests += 1
            if session_id and self.config.session_affinity:
                self._sessions[session_id] = (
                    ep.id, self._clock.now() + self.config.session_ttl)
            return ep

    def get_endpoint(self, message: Optional[Message] = None,
                     session_id: Optional[str] = None,
                     exclude: Optional[set] = None) -> Endpoint:
        """Select and book one endpoint for ``message``'s model type.
        ``exclude``: endpoint ids to skip (a failover re-picks among the
        replicas not yet tried). Raises :class:`NoEndpointError` when
        none is selectable."""
        model_type = DEFAULT_MODEL_TYPE
        if message is not None:
            model_type = message.metadata.get("model_type", DEFAULT_MODEL_TYPE)
        with self._mu:
            # The session's endpoint first, while it is selectable.
            if session_id and self.config.session_affinity:
                hit = self._sessions.get(session_id)
                if hit is not None:
                    eid, expires = hit
                    ep = self._endpoints.get(eid)
                    if (ep is not None and expires > self._clock.now()
                            and ep.status not in (EndpointStatus.UNHEALTHY,
                                                  EndpointStatus.DRAINING)
                            and eid not in (exclude or ())
                            and ep.model_type == model_type
                            and (ep.max_connections <= 0
                                 or ep.connections < ep.max_connections)):
                        ep.connections += 1
                        ep.total_requests += 1
                        self._sessions[session_id] = (
                            eid, self._clock.now() + self.config.session_ttl)
                        return ep
                    self._sessions.pop(session_id, None)
            candidates = self._healthy_endpoints(model_type, exclude)
            if not candidates:
                raise NoEndpointError(
                    f"no healthy endpoint for model type {model_type!r}")
            ep = self._select(candidates, model_type)
            ep.connections += 1
            ep.total_requests += 1
            if session_id and self.config.session_affinity:
                self._sessions[session_id] = (
                    ep.id, self._clock.now() + self.config.session_ttl)
            return ep

    def _healthy_endpoints(self, model_type: str,
                           exclude: Optional[set] = None) -> List[Endpoint]:
        """Healthy and degraded endpoints with connection headroom;
        DRAINING ones take no new dispatch."""
        out = []
        for eid in self._by_type.get(model_type, []):
            if eid in (exclude or ()):
                continue
            ep = self._endpoints[eid]
            if ep.status in (EndpointStatus.UNHEALTHY,
                             EndpointStatus.DRAINING):
                continue
            if ep.max_connections > 0 and ep.connections >= ep.max_connections:
                continue
            out.append(ep)
        return out

    def _select(self, candidates: List[Endpoint], model_type: str) -> Endpoint:
        strategy = self.config.strategy
        if strategy == "round_robin":
            return self._round_robin(candidates, model_type)
        if strategy == "least_connections":
            return min(candidates, key=lambda e: e.connections)
        if strategy == "weighted_random":
            return self._weighted_random(candidates)
        return self._adaptive(candidates)

    def _round_robin(self, candidates: List[Endpoint], model_type: str) -> Endpoint:
        """One cursor per model type."""
        cur = self._rr_cursor.get(model_type, 0)
        self._rr_cursor[model_type] = cur + 1
        return candidates[cur % len(candidates)]

    def _weighted_random(self, candidates: List[Endpoint]) -> Endpoint:
        total = sum(max(0.0, e.weight) for e in candidates)
        if total <= 0:
            return self._rng.choice(candidates)
        r = self._rng.uniform(0, total)
        acc = 0.0
        for e in candidates:
            acc += max(0.0, e.weight)
            if r <= acc:
                return e
        return candidates[-1]

    def _adaptive(self, candidates: List[Endpoint]) -> Endpoint:
        """Score = 0.4·load + 0.4·normalised response time + 0.2·error
        rate; the lowest wins, the runner-up one time in ten."""
        max_rt = max((e.response_time for e in candidates), default=0.0) or 1.0
        scored = sorted(
            candidates,
            key=lambda e: 0.4 * e.load + 0.4 * (e.response_time / max_rt)
            + 0.2 * e.error_rate)
        if len(scored) > 1 and self._rng.random() < 0.1:
            return scored[1]
        return scored[0]

    def release_endpoint(self, endpoint_id: str, response_time: float = 0.0,
                         is_error: bool = False) -> None:
        """Give back one booking: the response time feeds a 9:1 EWMA, an
        error raises the error rate by a tenth of what is left, a success
        decays it by 5%."""
        with self._mu:
            ep = self._endpoints.get(endpoint_id)
            if ep is None:
                return
            ep.connections = max(0, ep.connections - 1)
            if response_time > 0:
                if ep.response_time == 0:
                    ep.response_time = response_time
                else:
                    ep.response_time = 0.9 * ep.response_time + 0.1 * response_time
            if is_error:
                ep.total_errors += 1
                ep.error_rate = min(1.0, 0.9 * ep.error_rate + 0.1)
            else:
                ep.error_rate *= 0.95

    # -- sessions ------------------------------------------------------------

    def cleanup_sessions(self) -> int:
        """Drop the expired sessions; returns how many."""
        now = self._clock.now()
        with self._mu:
            dead = [sid for sid, (_, exp) in self._sessions.items() if exp <= now]
            for sid in dead:
                del self._sessions[sid]
            return len(dead)

    # -- health --------------------------------------------------------------

    def check_health_once(self) -> Dict[str, EndpointStatus]:
        """Probe every endpoint and advance the state machine. Callable
        directly from tests; the background loop just calls this."""
        with self._mu:
            eps = list(self._endpoints.values())
        results: Dict[str, EndpointStatus] = {}
        for ep in eps:
            try:
                ok = self._probe(ep)
            except Exception:  # noqa: BLE001 — probe crash counts as failure
                ok = False
            with self._mu:
                if ep.id not in self._endpoints:
                    continue
                ep.last_health_check = self._clock.now()
                if ep.status == EndpointStatus.DRAINING:
                    # Drain is an OPERATOR state, not a health verdict:
                    # probes must neither resurrect a draining endpoint
                    # nor demote it (set_draining(False) re-enters via
                    # DEGRADED and the probe takes over from there).
                    results[ep.id] = ep.status
                    continue
                if ok:
                    ep.consecutive_failures = 0
                    ep.consecutive_successes += 1
                    if ep.status == EndpointStatus.UNHEALTHY:
                        # Recovery passes through degraded.
                        if ep.consecutive_successes >= _SUCCESSES_TO_RECOVER:
                            ep.status = EndpointStatus.DEGRADED
                            ep.consecutive_successes = 0
                    elif ep.status == EndpointStatus.DEGRADED:
                        if ep.consecutive_successes >= _SUCCESSES_TO_RECOVER:
                            ep.status = EndpointStatus.HEALTHY
                else:
                    ep.consecutive_successes = 0
                    ep.consecutive_failures += 1
                    if ep.consecutive_failures >= _FAILURES_TO_UNHEALTHY:
                        ep.status = EndpointStatus.UNHEALTHY
                    elif ep.consecutive_failures >= _FAILURES_TO_DEGRADE:
                        if ep.status == EndpointStatus.HEALTHY:
                            ep.status = EndpointStatus.DEGRADED
                results[ep.id] = ep.status
        return results

    def start(self) -> None:
        """Start the health-check and session-cleanup loop (suppressed
        when the interval is <= 0)."""
        if self.config.health_check_interval <= 0 or self._health_thread:
            return
        self._stop.clear()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="lb-health", daemon=True)
        self._health_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=2.0)
            self._health_thread = None

    def _health_loop(self) -> None:
        while not self._stop.wait(self.config.health_check_interval):
            try:
                self.check_health_once()
                self.cleanup_sessions()
            except Exception:  # noqa: BLE001
                log.exception("health check tick failed")

    # -- stats ---------------------------------------------------------------

    def get_stats(self) -> Dict:
        with self._mu:
            return {
                "strategy": self.config.strategy,
                "endpoint_count": len(self._endpoints),
                "healthy": sum(1 for e in self._endpoints.values()
                               if e.status == EndpointStatus.HEALTHY),
                "degraded": sum(1 for e in self._endpoints.values()
                                if e.status == EndpointStatus.DEGRADED),
                "unhealthy": sum(1 for e in self._endpoints.values()
                                 if e.status == EndpointStatus.UNHEALTHY),
                "draining": sum(1 for e in self._endpoints.values()
                                if e.status == EndpointStatus.DRAINING),
                "active_sessions": len(self._sessions),
                "endpoints": [e.to_dict() for e in self._endpoints.values()],
            }
