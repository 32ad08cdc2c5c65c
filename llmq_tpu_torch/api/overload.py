"""Overload shedding at the API admission edge (the port's copy of
``llmq_tpu/api/overload.py``).

Once the backlog exceeds what the engine can serve within the SLA,
accepting more work makes every queued request later; the move that
keeps latency is to reject at the edge, explicitly, with a
``Retry-After`` the client can act on. With ``tenancy.enabled`` a
per-tenant quota gate runs first (0. below); then three global checks,
in cost order:

0. **tenant quota** → 429 ``tenant_quota``: the tenant's queue-depth cap
   is reached, or its token bucket (``token_rate``, ``burst_tokens``)
   cannot cover the request's estimate (peeked, not consumed; the
   bucket is charged only once every global check has passed, so a
   request shed by a global check never drains its tenant's quota).
1. **engine down** → 503: the engine loop is restarting (the crash
   supervisor) or gone.
2. **queue backlog** → 429: pending messages across the manager's
   queues reached ``overload.queue_depth_limit`` (default 90% of
   ``queue.max_queue_size``, so clients back off before the hard
   queue-full 503).
3. **deadline headroom** → 429: the estimated wait plus the prompt's
   prefill ETA at the resource scheduler's learned rate already exceeds
   the request's own ``timeout`` × ``deadline_headroom``.

While the control plane's degradation ladder holds a rung
(``set_degradation``), the rung first sheds whole priority tiers and
tenants under a fairness-weight bound (429 ``degraded``), and scales the
backlog limit by its ``backlog_factor`` and the deadline headroom by its
``headroom_factor``.

Every shed counts in ``shed_counts`` and in ``requests_shed_total`` (by
reason and code, with ``queue.enable_metrics``) and carries
``Retry-After`` (header and body). ``overload.enabled: false`` builds no
shedder at all, unless tenancy is on: then the shedder runs the quota
gate alone, every global check neutralized.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

from llmq_tpu_torch.core.types import Message
from llmq_tpu_torch.metrics.registry import get_metrics
from llmq_tpu_torch.observability.usage import sanitize_tenant
from llmq_tpu_torch.tenancy.registry import (estimate_prompt_tokens,
                                             estimate_tokens)

log = logging.getLogger("llmq_tpu_torch.overload")


class OverloadShedder:
    def __init__(self, config, queue_config=None, *, engine=None,
                 resource_scheduler=None, tenant_registry=None,
                 enable_metrics: bool = True) -> None:
        #: An OverloadConfig (or anything with its fields).
        self.config = config
        self.engine = engine
        #: Anything with ``prefill_eta_ms(tokens)`` (the resource
        #: scheduler); None: the prefill ETA is 0.
        self.resource_scheduler = resource_scheduler
        #: The tenancy plane's registry (None, or disabled: no quota
        #: gate).
        self.tenant_registry = tenant_registry
        self._metrics = get_metrics() if enable_metrics else None
        limit = int(getattr(config, "queue_depth_limit", 0) or 0)
        if limit <= 0 and queue_config is not None:
            limit = int(0.9 * getattr(queue_config, "max_queue_size",
                                      10000))
        self.queue_depth_limit = limit
        #: The degradation ladder's active rung; None: no rung, and the
        #: admit path is the plain one.
        self._degradation: Optional[dict] = None
        self._mu = threading.Lock()
        self.shed_counts = {"backlog": 0, "sla": 0, "engine_down": 0,
                            "tenant_quota": 0, "degraded": 0}

    def admit(self, msg: Message, manager=None,
              estimated_wait: float = 0.0) -> None:
        """Raise ``ApiError`` (429/503, with ``retry_after``) when the
        request should be shed; return to admit. ``manager`` None skips
        the backlog check (the SSE path has its own stream gates)."""
        retry_base = max(0.5, float(getattr(self.config, "retry_after",
                                            1.0)))
        # One estimate per request: the quota peek and the charge after
        # the global checks see the same figure.
        est_tokens = estimate_tokens(msg)
        self._reject_over_quota(msg, est_tokens, retry_base)
        deg = self._degradation
        if deg is not None:
            self._reject_degraded(msg, deg, retry_base)
        eng = self.engine
        if eng is not None and not getattr(eng, "running", True):
            self._shed("engine_down", 503, retry_base,
                       "engine not running on this host (restarting or "
                       "failed) — retry or use another replica")
        depth_limit = self.queue_depth_limit
        if deg is not None and depth_limit > 0:
            depth_limit = max(1, int(depth_limit
                                     * float(deg.get("backlog_factor",
                                                     1.0))))
        if manager is not None and depth_limit > 0:
            try:
                depth = manager.total_pending()
            except Exception:  # noqa: BLE001 — advisory check
                depth = 0
            if depth >= depth_limit:
                self._shed(
                    "backlog", 429,
                    max(retry_base, float(estimated_wait)),
                    f"queue backlog too deep ({depth} pending >= "
                    f"{depth_limit})")
        headroom = float(getattr(self.config, "deadline_headroom", 0.0))
        if deg is not None and headroom > 0:
            headroom *= float(deg.get("headroom_factor", 1.0))
        if headroom > 0 and msg.timeout and msg.timeout > 0:
            eta = float(estimated_wait) + self._prefill_eta_s(msg)
            if eta > msg.timeout * headroom:
                self._shed(
                    "sla", 429,
                    max(retry_base, eta - float(msg.timeout)),
                    f"cannot meet deadline: estimated {eta:.1f}s to "
                    f"first service exceeds the request's "
                    f"{msg.timeout:.1f}s budget")
        self._charge_tenant(msg, est_tokens)

    def _reject_over_quota(self, msg: Message, est_tokens: int,
                           retry_base: float) -> None:
        """The per-tenant quota gate, cheapest check first: the
        queue-depth cap, then the token bucket, peeked. It runs before
        the global checks, so a tenant over its quota gets its own 429
        with a Retry-After from its bucket."""
        reg = self.tenant_registry
        if reg is None or not reg.enabled:
            return
        # The key the fair scheduler counts depth and in-flight under.
        tenant = sanitize_tenant(getattr(msg, "tenant_id", ""))
        if reg.over_queue_depth(tenant):
            reg.note_rejection("queue_depth")
            self._shed(
                "tenant_quota", 429, retry_base,
                f"tenant {tenant!r} queue depth cap reached "
                f"({reg.queue_depth(tenant)} pending >= "
                f"{reg.spec_for(tenant).max_queue_depth})")
        ok, retry_after = reg.admit_tokens(tenant, est_tokens,
                                           consume=False)
        if not ok:
            reg.note_rejection("rate")
            self._shed(
                "tenant_quota", 429, max(retry_base, retry_after),
                f"tenant {tenant!r} token-rate limit exceeded "
                f"(sustained {reg.spec_for(tenant).token_rate:.0f} "
                f"tok/s)")

    def set_degradation(self, spec: Optional[dict]) -> None:
        """Apply the control plane's active rung, or clear it with None.
        The admit path reads the attribute once a request."""
        self._degradation = dict(spec) if spec else None
        if spec:
            log.warning("degradation rung active: %s",
                        spec.get("name", "?"))
        else:
            log.info("degradation cleared (admission back to normal)")

    def _reject_degraded(self, msg: Message, deg: dict,
                         retry_base: float) -> None:
        """The rung's outright sheds: its priority tiers (batch first),
        then tenants whose configured weight is under its bound."""
        tier = msg.priority.tier_name
        if tier in (deg.get("shed_priorities") or ()):
            self._shed(
                "degraded", 429, retry_base,
                f"degradation rung {deg.get('name', '?')!r} is "
                f"shedding the {tier!r} tier — retry later")
        weight_bound = float(deg.get("shed_tenant_weight_below", 0.0)
                             or 0.0)
        reg = self.tenant_registry
        if weight_bound > 0 and reg is not None and reg.enabled:
            tenant = sanitize_tenant(getattr(msg, "tenant_id", ""))
            if reg.spec_for(tenant).weight < weight_bound:
                self._shed(
                    "degraded", 429, retry_base,
                    f"degradation rung {deg.get('name', '?')!r} is "
                    f"shedding tenants under weight {weight_bound} "
                    f"(tenant {tenant!r})")

    def _charge_tenant(self, msg: Message, est_tokens: int) -> None:
        """The request passed every gate: its tokens leave the tenant's
        bucket, unconditionally (a concurrent admit may have drained the
        bucket since the peek; admitted work is charged as debt, not
        refused again)."""
        reg = self.tenant_registry
        if reg is None or not reg.enabled:
            return
        tenant = sanitize_tenant(getattr(msg, "tenant_id", ""))
        reg.admit_tokens(tenant, est_tokens, consume=True, force=True)

    def _prefill_eta_s(self, msg: Message) -> float:
        """Learned prefill cost of this prompt (seconds); 0 without a
        resource scheduler or before it has observations."""
        rs = self.resource_scheduler
        if rs is None:
            return 0.0
        est_tokens = estimate_prompt_tokens(msg)
        if est_tokens <= 0:
            return 0.0
        try:
            eta_ms = rs.prefill_eta_ms(est_tokens)
        except Exception:  # noqa: BLE001 — advisory
            return 0.0
        return (eta_ms or 0.0) / 1e3

    def _shed(self, reason: str, code: int, retry_after: float,
              detail: str) -> None:
        from llmq_tpu_torch.api.server import ApiError
        with self._mu:
            self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1
        if self._metrics is not None:
            self._metrics.requests_shed.labels(reason, str(code)).inc()
        log.warning("shedding request (%s → %d, retry in %.1fs): %s",
                    reason, code, retry_after, detail)
        raise ApiError(code, f"overloaded ({reason}): {detail}",
                       retry_after=retry_after)

    def get_stats(self) -> dict:
        deg = self._degradation
        with self._mu:
            return {"queue_depth_limit": self.queue_depth_limit,
                    "shed": dict(self.shed_counts),
                    "degradation": (deg.get("name", "?") if deg
                                    else None)}


def build_shedder(config, *, engine=None,
                  resource_scheduler=None) -> Optional[OverloadShedder]:
    """An :class:`OverloadShedder` from a full ``Config``, or None when
    both ``overload.enabled`` and ``tenancy.enabled`` are false. With
    tenancy on the shedder holds the process's tenant registry (the one
    the queue managers' fair dequeue feeds); with overload off as well,
    its global checks are neutralized and only the quota gate runs."""
    ocfg = getattr(config, "overload", None)
    overload_on = ocfg is not None and getattr(ocfg, "enabled", False)
    tcfg = getattr(config, "tenancy", None)
    tenancy_on = tcfg is not None and getattr(tcfg, "enabled", False)
    if not overload_on and not tenancy_on:
        return None
    tenant_registry = None
    if tenancy_on:
        from llmq_tpu_torch.tenancy import configure_tenancy
        tenant_registry = configure_tenancy(tcfg)
    qcfg = getattr(config, "queue", None)
    metrics_on = getattr(qcfg, "enable_metrics", True)
    if not overload_on:
        from llmq_tpu_torch.core.config import OverloadConfig
        neutral = OverloadConfig(enabled=False, queue_depth_limit=0,
                                 deadline_headroom=0.0)
        return OverloadShedder(neutral, None,
                               tenant_registry=tenant_registry,
                               enable_metrics=metrics_on)
    return OverloadShedder(ocfg, qcfg, engine=engine,
                           resource_scheduler=resource_scheduler,
                           tenant_registry=tenant_registry,
                           enable_metrics=metrics_on)
