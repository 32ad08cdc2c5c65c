"""Tenancy plane (the port's copy of ``llmq_tpu/tenancy/``): weighted
fair queueing, quotas, burst isolation.

Turns ``Message.tenant_id`` (the usage plane's attribution label) into
an enforcement boundary:

- :class:`~llmq_tpu_torch.tenancy.fair_queue.FairScheduler` — virtual-time
  weighted fair dequeue within each priority level, layered over
  ``MultiLevelQueue`` by the queue manager;
- :class:`~llmq_tpu_torch.tenancy.registry.TenantRegistry` — tenant classes
  (``tenancy.tenants`` + default), token-rate burst buckets, queue-depth
  and in-flight caps; a process singleton so the API edge, queue plane
  and engine share one set of counters;
- engine-level decode fairness — per-tenant weight-proportional caps on
  the mixed batcher's decode-row/prefill-token budget under contention
  (:func:`weighted_token_caps`).

``tenancy.enabled: false`` (the default) is a hard off-switch: nothing
here is constructed and the dequeue path is byte-identical to
FIFO-within-priority.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import TYPE_CHECKING, Any, Dict, Optional

from llmq_tpu_torch.tenancy.fair_queue import (FairScheduler,
                                               share_ratios_from_window)
from llmq_tpu_torch.tenancy.registry import (QUOTA_REASONS, TenantRegistry,
                                             estimate_tokens)

if TYPE_CHECKING:
    from llmq_tpu_torch.core.config import TenancyConfig

_LOCK = threading.Lock()
_REGISTRY: Optional[TenantRegistry] = None


def get_tenant_registry() -> TenantRegistry:
    """The process-wide tenant registry (disabled until a config block
    with ``tenancy.enabled: true`` is applied)."""
    global _REGISTRY
    with _LOCK:
        if _REGISTRY is None:
            _REGISTRY = TenantRegistry()
        return _REGISTRY


def configure_tenancy(cfg: "TenancyConfig") -> TenantRegistry:
    """Apply a ``tenancy`` config block (core.config.TenancyConfig or
    same-shaped object) onto the singleton registry."""
    reg = get_tenant_registry()
    reg.configure(cfg)
    return reg


def reset_tenancy() -> None:
    """Disable and clear the singleton (tests only)."""
    reg = get_tenant_registry()
    reg.clear()
    reg.enabled = False
    with reg._mu:  # noqa: SLF001 — test-only reset of config state
        reg._specs = {}
        from llmq_tpu_torch.core.config import TenantClassConfig
        reg._default = TenantClassConfig()


#: FairSchedulers registered for the metrics flush (weak-ref'd: bench
#: and test managers come and go; the registry must not keep them — or
#: their queues — alive).
_SCHEDULERS: "weakref.WeakSet[FairScheduler]" = weakref.WeakSet()

#: Gauge label values written at the previous flush, per family — a
#: tenant that leaves (finishes its in-flight work, ages out of the
#: share window, scheduler GC'd) must have its series REMOVED, not
#: frozen at the last flushed value forever.
_FLUSHED: Dict[str, set] = {"inflight": set(), "vt": set(), "share": set()}
_FLUSH_MU = threading.Lock()


def _set_series(gauge: Any, family: str, values: Dict[str, float]) -> None:
    """Write one gauge family's current label→value set and remove any
    series flushed last round that has no current value."""
    for lab, v in values.items():
        gauge.labels(lab).set(v)
    cur = set(values)
    for lab in _FLUSHED[family] - cur:
        try:
            gauge.remove(lab)
        except KeyError:
            pass
    _FLUSHED[family] = cur


def register_scheduler(sched: FairScheduler) -> None:
    _SCHEDULERS.add(sched)


def flush_metrics() -> None:
    """Scrape-time flush (called from ``metrics.registry.exposition``,
    after the usage flush): quota-rejection counters,
    per-tenant virtual time / share ratio / in-flight gauges. Tenant
    label cardinality is bounded by the usage ledger's first-come
    ``max_tenants`` mapping — the same bound the usage families use."""
    reg = get_tenant_registry()
    try:
        from llmq_tpu_torch.metrics.registry import get_metrics
        m = get_metrics()
    except Exception:  # noqa: BLE001 — scrape must not fail on tenancy
        return
    for reason, n in reg.drain_rejections().items():
        m.tenant_quota_rejections.labels(reason).inc(n)
    evicted = reg.drain_evictions()
    if evicted:
        m.tenant_registry_evictions.inc(evicted)
    if not reg.enabled:
        return
    from llmq_tpu_torch.observability.usage import get_usage_ledger
    label = get_usage_ledger().bounded_label
    inflight = reg.inflight_by_tenant()
    # Aggregate ACROSS schedulers before touching a gauge — the default
    # serve runs one FairScheduler per queue manager, and per-scheduler
    # writes would leave each gauge at whichever manager flushed last.
    # Virtual time: max (the tenant's most-advanced counter is the one
    # selection is holding against it). Share: ratios computed from the
    # merged served-token window so a tenant active on several managers
    # reads one coherent global share.
    vts: Dict[str, float] = {}
    window: Dict[str, int] = {}
    for sched in list(_SCHEDULERS):
        for tenant, vt in sched.virtual_times().items():
            vts[tenant] = max(vts.get(tenant, 0.0), vt)
        for tenant, tokens in sched.window_tokens().items():
            window[tenant] = window.get(tenant, 0) + tokens
    # Tenants past the label bound collapse onto "other" — aggregate
    # WITHIN each label (sum in-flight, max vt; share merges tokens and
    # weights inside share_ratios_from_window) so the collapsed series
    # reads a true combined value, not whichever tenant flushed last.
    inflight_lab: Dict[str, float] = {}
    for t in set(inflight) | set(reg.known_tenants()):
        # Configured tenants always report in-flight (a named tenant
        # idling at 0 is signal, not noise); unconfigured ids only
        # while actually in flight.
        lab = label(t)
        inflight_lab[lab] = inflight_lab.get(lab, 0.0) + float(
            inflight.get(t, 0))
    vt_lab: Dict[str, float] = {}
    for t, vt in vts.items():
        lab = label(t)
        vt_lab[lab] = max(vt_lab.get(lab, 0.0), vt)
    with _FLUSH_MU:
        # Series for tenants that LEFT since the last flush are
        # removed, never left frozen at their last value.
        _set_series(m.tenant_inflight, "inflight", inflight_lab)
        _set_series(m.tenant_virtual_time, "vt", vt_lab)
        _set_series(m.tenant_share_ratio, "share",
                    share_ratios_from_window(reg, window, key=label))


def weighted_token_caps(weights: Dict[str, float],
                        total: int) -> Dict[str, int]:
    """Split ``total`` token units across tenants proportionally to
    their weights (largest-remainder rounding; every tenant with a
    positive weight gets at least 1 when total allows). The engine uses
    this to cap each tenant's share of a contended chunk budget."""
    if total <= 0 or not weights:
        return {t: 0 for t in weights}
    wsum = sum(max(1e-9, w) for w in weights.values())
    raw = {t: total * max(1e-9, w) / wsum for t, w in weights.items()}
    caps = {t: int(math.floor(v)) for t, v in raw.items()}
    leftover = total - sum(caps.values())
    for t in sorted(raw, key=lambda t: raw[t] - caps[t], reverse=True):
        if leftover <= 0:
            break
        caps[t] += 1
        leftover -= 1
    if total >= len(caps):
        # Min-1 floor, funded by the largest caps so the split still
        # sums to ``total`` (a zero cap would starve a tenant's rows
        # entirely; the engine additionally floors per-ROW budgets).
        for t in caps:
            if caps[t] <= 0:
                donor = max(caps, key=lambda d: caps[d])
                if caps[donor] > 1:
                    caps[donor] -= 1
                    caps[t] = 1
    return caps


__all__ = [
    "FairScheduler", "QUOTA_REASONS", "TenantRegistry",
    "configure_tenancy", "estimate_tokens", "flush_metrics",
    "get_tenant_registry", "register_scheduler", "reset_tenancy",
    "share_ratios_from_window", "weighted_token_caps",
]
