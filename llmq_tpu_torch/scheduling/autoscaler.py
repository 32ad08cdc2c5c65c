"""The endpoint autoscaler (the port's copy of
``llmq_tpu/scheduling/autoscaler.py``).

One tick (``run_once``, every ``scheduler.monitor_interval`` seconds
once started) reads the queue manager's pending count and the load
balancer's endpoints and acts by ``scheduler.strategy``:

- ``static``: nothing;
- ``dynamic``: one endpoint more when pending ≥ ``scale_up_threshold``
  (up to ``max_endpoints``), one fewer when pending ≤
  ``scale_down_threshold`` (down to ``min_endpoints``), at most once per
  ``cooldown``;
- ``adaptive``: business hours (Monday to Friday, 9 to 17, local time
  of the clock) run near ``max_endpoints``, other hours at
  ``min_endpoints``;
- ``hybrid``: ``dynamic``, then every endpoint's weight set to its share
  of the fastest response time (at least 0.1).

Scaling acts: a ``provision_fn`` returns a new endpoint to add, and
scaling down removes the endpoints with the fewest connections from the
load balancer (calling ``decommission_fn`` first, when given). Without a
``provision_fn`` a scale-up is only logged.

``_last_scale_at`` starts at 0, so the cooldown has passed at the first
tick: at the defaults (``dynamic``, ``scale_down_threshold`` 10,
``min_endpoints`` 1) a serve process with one peer and little backlog
removes an endpoint on its first tick, as the JAX package's does. A
deployment that must keep every replica routable sets
``scheduler.min_endpoints`` to its replica count.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from typing import Callable, Optional

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import SchedulerConfig
from llmq_tpu_torch.loadbalancer.load_balancer import Endpoint, LoadBalancer

log = logging.getLogger("llmq_tpu_torch.autoscaler")

#: provision(seq) returns a new Endpoint to add; decommission(endpoint)
#: tears one down. Both come from the deployment.
ProvisionFn = Callable[[int], Optional[Endpoint]]
DecommissionFn = Callable[[Endpoint], None]


class ScalingStrategy(str, enum.Enum):
    STATIC = "static"
    DYNAMIC = "dynamic"
    ADAPTIVE = "adaptive"
    HYBRID = "hybrid"


class Autoscaler:
    def __init__(
        self,
        queue_manager,
        load_balancer: LoadBalancer,
        config: Optional[SchedulerConfig] = None,
        provision_fn: Optional[ProvisionFn] = None,
        decommission_fn: Optional[DecommissionFn] = None,
        clock: Optional[Clock] = None,
        localtime_fn: Optional[Callable[[], time.struct_time]] = None,
    ) -> None:
        self.queue_manager = queue_manager
        self.load_balancer = load_balancer
        self.config = config or SchedulerConfig()
        self.strategy = ScalingStrategy(self.config.strategy)
        self._provision = provision_fn
        self._decommission = decommission_fn
        self._clock = clock or SYSTEM_CLOCK
        # Local time comes from the injected clock (a pure conversion),
        # so a fake clock drives the adaptive strategy too.
        self._localtime = (localtime_fn
                           or (lambda: time.localtime(self._clock.now())))
        self._last_scale_at = 0.0
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one tick ------------------------------------------------------------

    def run_once(self) -> dict:
        total_pending = self.queue_manager.total_pending()
        n_endpoints = len(self.load_balancer.endpoints())
        action = "none"
        if self.strategy == ScalingStrategy.DYNAMIC:
            action = self._dynamic(total_pending, n_endpoints)
        elif self.strategy == ScalingStrategy.ADAPTIVE:
            action = self._adaptive(n_endpoints)
        elif self.strategy == ScalingStrategy.HYBRID:
            action = self._dynamic(total_pending, n_endpoints)
            self._rebalance_weights()
        return {"pending": total_pending, "endpoints": n_endpoints,
                "action": action}

    # -- strategies ----------------------------------------------------------

    def _dynamic(self, pending: int, n: int) -> str:
        now = self._clock.now()
        if now - self._last_scale_at < self.config.cooldown:
            return "cooldown"
        if pending >= self.config.scale_up_threshold and n < self.config.max_endpoints:
            return self._scale_to(n + 1, f"pending={pending}")
        if pending <= self.config.scale_down_threshold and n > self.config.min_endpoints:
            return self._scale_to(n - 1, f"pending={pending}")
        return "none"

    def _adaptive(self, n: int) -> str:
        now = self._clock.now()
        if now - self._last_scale_at < self.config.cooldown:
            return "cooldown"
        lt = self._localtime()
        business = lt.tm_wday < 5 and 9 <= lt.tm_hour < 17
        target = (max(self.config.max_endpoints - 1, self.config.min_endpoints)
                  if business else self.config.min_endpoints)
        if target == n:
            return "none"
        return self._scale_to(min(max(target, self.config.min_endpoints),
                                  self.config.max_endpoints),
                              f"{'business' if business else 'off'}-hours")

    def _scale_to(self, target: int, reason: str) -> str:
        current = self.load_balancer.endpoints()
        n = len(current)
        if target > n:
            if self._provision is None:
                log.warning("scale up wanted (%s) but no provision_fn", reason)
                return "none"
            for _ in range(target - n):
                self._seq += 1
                ep = self._provision(self._seq)
                if ep is None:
                    break
                self.load_balancer.add_endpoint(ep)
            self._last_scale_at = self._clock.now()
            log.info("scaled up to %d endpoints (%s)",
                     len(self.load_balancer.endpoints()), reason)
            return "up"
        if target < n:
            # The least busy endpoints go first.
            removed = 0
            for ep in sorted(current, key=lambda e: e.connections)[:n - target]:
                if self._decommission is not None:
                    try:
                        self._decommission(ep)
                    except Exception:  # noqa: BLE001
                        log.exception("decommission of %s failed", ep.id)
                self.load_balancer.remove_endpoint(ep.id)
                removed += 1
            self._last_scale_at = self._clock.now()
            log.info("scaled down by %d endpoints (%s)", removed, reason)
            return "down"
        return "none"

    def _rebalance_weights(self) -> None:
        """Weight ∝ 1 / response time (``hybrid``), applied."""
        eps = self.load_balancer.endpoints()
        with_rt = [e for e in eps if e.response_time > 0]
        if len(with_rt) < 2:
            return
        min_rt = min(e.response_time for e in with_rt)
        for e in with_rt:
            e.weight = round(max(0.1, min_rt / e.response_time), 3)

    # -- loop ----------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.config.monitor_interval):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001
                log.exception("autoscaler tick failed")
