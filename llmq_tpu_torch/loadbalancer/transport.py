"""HTTP transport to an engine in another serve process (the port's copy
of ``llmq_tpu/loadbalancer/transport.py``).

An :class:`HttpEngineClient` stands in for an ``InferenceEngine`` at the
two seams the router and the health checks use:

- ``process_fn(ctx, msg)``: POST the message to the peer's synchronous
  generate route (``POST /api/v1/generate``) within the worker's
  remaining deadline, and copy the completion, its usage and the peer's
  trace events back;
- ``healthy()``: GET the peer's ``/health`` and require its engine to
  be running, so a peer whose HTTP server is up but whose engine died
  reads unhealthy and traffic fails over.

So one process routes over in-process engines (``local://``) and peer
serve processes (``http://``) alike. The module imports nothing of
``torch``: a gateway that routes to peers never touches a card.
"""

from __future__ import annotations

import errno
import json
import urllib.error
import urllib.request
from typing import Optional

from llmq_tpu_torch import chaos, observability
from llmq_tpu_torch.core.types import Message
from llmq_tpu_torch.loadbalancer.circuit_breaker import CircuitOpenError


def _is_timeout(exc: BaseException) -> bool:
    """A socket timeout, through urllib's wrapping."""
    seen = exc
    for _ in range(4):
        if isinstance(seen, TimeoutError):
            return True
        seen = getattr(seen, "reason", None) or getattr(
            seen, "__cause__", None)
        if seen is None:
            return False
    return False


def _is_refused(exc: BaseException) -> bool:
    """A refused connection, through urllib's wrapping (``URLError``
    carries the socket error as ``reason``)."""
    seen = exc
    for _ in range(4):
        if isinstance(seen, ConnectionRefusedError):
            return True
        if isinstance(seen, OSError) and seen.errno in (
                errno.ECONNREFUSED, errno.EHOSTUNREACH):
            return True
        seen = getattr(seen, "reason", None) or getattr(
            seen, "__cause__", None)
        if seen is None:
            return False
    return False


class HttpEngineClient:
    """An engine behind a serve process's REST API.

    ``breaker`` (``loadbalancer/circuit_breaker.py``), when attached,
    gates the dispatch: an OPEN breaker refuses at once with
    :class:`CircuitOpenError`, and the outcomes feed it (endpoint faults
    count, deadline misses never do)."""

    def __init__(self, base_url: str, *, timeout: float = 120.0,
                 probe_timeout: float = 2.0, breaker=None) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.probe_timeout = probe_timeout
        self.name = self.base_url
        self.breaker = breaker
        #: The last ``/health`` body that parsed.
        self.last_health: dict = {}

    def probe(self) -> str:
        """One health probe and its cause: "ok", or "refused" (nothing
        listens: the replica process is gone; the only cause that feeds
        the breaker, since a slow, failing, draining or stopped peer is
        not a broken one), "timeout", "http_error", "bad_response",
        "draining" or "stopped"."""
        try:
            chaos.fault("transport.probe", endpoint=self.name)
        except chaos.ChaosTimeout:
            return "timeout"
        except chaos.ChaosFault:
            if self.breaker is not None:
                self.breaker.record_failure()
            return "refused"
        try:
            with urllib.request.urlopen(
                    f"{self.base_url}/health",
                    timeout=self.probe_timeout) as resp:
                if resp.status != 200:
                    return "http_error"
                data = json.loads(resp.read().decode("utf-8"))
        except (urllib.error.URLError, OSError, ValueError) as e:
            if _is_refused(e):
                # The strongest down signal, known in one round trip: the
                # data path stops paying connect timeouts before the next
                # dispatch.
                if self.breaker is not None:
                    self.breaker.record_failure()
                return "refused"
            if isinstance(e, TimeoutError) or _is_timeout(e):
                return "timeout"
            return "bad_response" if isinstance(e, ValueError) \
                else "http_error"
        self.last_health = data
        # A draining peer is leaving the replica set, and a stopped
        # engine cannot generate: both unhealthy for routing.
        if data.get("status") == "draining":
            return "draining"
        if data.get("engine", "running") != "running":
            return "stopped"
        # Probe-grade evidence: it clears a CLOSED breaker's failure
        # streak (sparse refusals must not read as consecutive) but never
        # closes an OPEN one; only a dispatch that succeeds does.
        if self.breaker is not None:
            self.breaker.record_probe_success()
        return "ok"

    def healthy(self) -> bool:
        return self.probe() == "ok"

    def engine_stats(self, timeout: Optional[float] = None) -> dict:
        """The peer's ``GET /api/v1/engine/stats`` (its engine counters
        and device block), with the probe's timeout by default. Raises on
        any failure: the cluster overview turns it into an error entry."""
        with urllib.request.urlopen(
                f"{self.base_url}/api/v1/engine/stats",
                timeout=timeout or self.probe_timeout) as resp:
            if resp.status != 200:
                raise RuntimeError(
                    f"engine stats HTTP {resp.status} from {self.name}")
            return json.loads(resp.read().decode("utf-8"))

    def process_fn(self, ctx, msg: Message) -> None:
        """Worker seam: relay one message to the peer and fold the
        completion back into ``msg`` (``InferenceEngine.process_fn``'s
        contract).

        The gates run in this order: the deadline (an expired one raises
        TimeoutError before anything is sent, and tells the breaker
        nothing), the breaker, the chaos point, then the dispatch."""
        timeout: Optional[float] = self.timeout
        if ctx is not None:
            rem = ctx.remaining()
            if rem is not None:
                if rem <= 0:
                    raise TimeoutError(
                        f"message {msg.id} deadline expired before dispatch")
                timeout = min(self.timeout, rem)
        if self.breaker is not None and not self.breaker.allow():
            raise CircuitOpenError(self.name, self.breaker.retry_in())
        try:
            chaos.fault("transport.request", endpoint=self.name)
        except chaos.ChaosTimeout:
            # An outcome unknown by design: never an endpoint fault, but
            # a held half-open probe slot is given back.
            if self.breaker is not None:
                self.breaker.record_timeout()
            raise
        except chaos.ChaosFault:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        payload = msg.to_dict()
        payload["timeout"] = timeout
        # The W3C trace context rides the hop: the replica binds its
        # engine events to the same trace id.
        traceparent = observability.make_traceparent(msg.id)
        # The socket gets headroom over the server's budget: the server
        # enforces ``timeout`` and answers a miss with a 504 that is
        # classed below. With no headroom the socket usually fires first,
        # and a healthy peer's deadline miss would read as unreachable.
        sock_timeout = timeout + max(2.0, 0.1 * timeout)
        req = urllib.request.Request(
            f"{self.base_url}/api/v1/generate",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json",
                     "traceparent": traceparent}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=sock_timeout) as resp:
                data = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = json.loads(e.read().decode("utf-8")).get("error", "")
            except Exception:  # noqa: BLE001 — the detail is best effort
                pass
            if e.code == 504:
                # The peer missed the deadline: not an endpoint fault.
                if self.breaker is not None:
                    self.breaker.record_timeout()
                raise TimeoutError(
                    f"remote engine {self.base_url} timed out: {detail}"
                ) from None
            if self.breaker is not None:
                self.breaker.record_failure()
            raise RuntimeError(
                f"remote engine {self.base_url} failed "
                f"({e.code}): {detail}") from None
        except (urllib.error.URLError, OSError) as e:
            # A read-phase socket timeout (raw TimeoutError) means the peer
            # took the request and overran budget plus headroom: a
            # deadline miss. A connect-phase one arrives wrapped in
            # URLError and means the host is unreachable: a fault.
            if isinstance(e, TimeoutError) and not isinstance(
                    e, urllib.error.URLError):
                if self.breaker is not None:
                    self.breaker.record_timeout()
                raise TimeoutError(
                    f"remote engine {self.base_url} exceeded its "
                    f"{timeout:.0f}s budget (+headroom)") from None
            if self.breaker is not None:
                self.breaker.record_failure()
            raise RuntimeError(
                f"remote engine {self.base_url} unreachable: {e}") from None
        if self.breaker is not None:
            self.breaker.record_success()
        msg.response = data.get("response", "")
        usage = data.get("usage")
        if usage:
            msg.metadata["usage"] = usage
        trace_events = data.get("trace")
        if trace_events:
            # The replica's engine stages join this process's timeline of
            # the request (GET /api/v1/requests/:id/trace).
            observability.get_recorder().merge(msg.id, trace_events)
