"""Tenant registry: classes, quotas, burst buckets, live counters (the
port's copy of ``llmq_tpu/tenancy/registry.py``).

The enforcement half of the tenancy plane: the usage ledger can *bill*
a tenant for device-seconds; this registry is what lets the serving
path *bound* one. It owns

- the tenant → class mapping (``tenancy.tenants`` + the default class
  every unlisted tenant falls into),
- per-tenant **token buckets** (sustained ``token_rate`` with
  ``burst_tokens`` capacity) consumed at the API admission edge,
- per-tenant **queue-depth** counters fed by the fair dequeue layer
  (``max_queue_depth`` → 429 at the overload seam), and
- per-tenant **in-flight** counters (``max_inflight`` → the fair
  dequeue defers a capped tenant's queued work at worker dispatch
  instead of rejecting it).

State for client-supplied tenant ids is LRU-bounded: an id spray can
mint at most ``MAX_TRACKED`` bucket/counter entries; named (configured)
tenants are never evicted. Rejection/deferral counts are buffered and
drained into ``tenant_quota_rejections_total{reason}`` at scrape time
(the established deferred-flush discipline — the dequeue hot path never
touches a Prometheus child).
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import TenantClassConfig

log = logging.getLogger("llmq_tpu_torch.tenancy")

#: Closed enum for ``tenant_quota_rejections_total{reason}``
#: (in metrics/registry.py's LABEL_CONTRACT): ``rate`` and
#: ``queue_depth`` are admission-edge 429s; ``inflight`` counts
#: dispatch-time deferrals (queued work held back by the in-flight
#: cap — not a rejection the client sees).
QUOTA_REASONS = ("rate", "queue_depth", "inflight")

#: Crude prompt-size estimate when only text is available — the one
#: chars-per-token figure every admission-path heuristic shares (the
#: tokenizer must not run on admission paths).
_CHARS_PER_TOKEN = 4.0

#: Expected completion tokens when the request doesn't say
#: (``metadata.max_new_tokens``); deliberately modest — the finish-time
#: true-up corrects the virtual-time charge with measured tokens.
_DEFAULT_COMPLETION_TOKENS = 64


def estimate_prompt_tokens(msg: Any) -> int:
    """Prompt-only token estimate (chars/4); shared by every admission
    gate so quota accounting and shed heuristics can't silently drift
    onto different figures."""
    return int(len(getattr(msg, "content", "") or "") / _CHARS_PER_TOKEN)


def estimate_tokens(msg: Any) -> int:
    """Admission-time token estimate for one message: prompt chars/4
    plus the requested (or default) completion budget. Trued-up against
    the usage ledger's measured counts at finish."""
    prompt = estimate_prompt_tokens(msg)
    md = getattr(msg, "metadata", None) or {}
    try:
        completion = int(md.get("max_new_tokens", 0) or 0)
    except (TypeError, ValueError):
        completion = 0
    if completion <= 0:
        completion = _DEFAULT_COMPLETION_TOKENS
    return max(1, prompt + completion)


class _Bucket:
    """One tenant's token bucket (sustained rate + burst capacity)."""

    __slots__ = ("level", "last")

    def __init__(self, level: float, last: float) -> None:
        self.level = level
        self.last = last


class TenantRegistry:
    """Process-wide tenant state (singleton via
    :func:`llmq_tpu_torch.tenancy.get_tenant_registry`): the queue manager's
    fair dequeue, the API overload shedder and the engine's chunk
    budgeting all consult the SAME instance, so depth/in-flight
    accounting stays coherent across layers."""

    #: LRU bound on per-tenant runtime state for UNCONFIGURED ids.
    MAX_TRACKED = 4096

    def __init__(self, clock: Optional[Clock] = None) -> None:
        self._clock = clock or SYSTEM_CLOCK
        self.enabled = False
        self.share_window_s = 60.0
        self._default = TenantClassConfig()
        self._specs: Dict[str, TenantClassConfig] = {}
        self._mu = threading.Lock()
        self._buckets: "OrderedDict[str, _Bucket]" = OrderedDict()
        self._inflight: Dict[str, int] = {}
        self._queued: Dict[str, int] = {}
        #: reason → count, drained at scrape (flush_metrics).
        self._pending_rejections: Dict[str, int] = {}
        self.rejections_total: Dict[str, int] = {}
        #: LRU evictions of unconfigured-tenant state (id-spray
        #: visibility): buffered like rejections, drained into
        #: ``tenant_registry_evictions_total`` at scrape time.
        self._pending_evictions: int = 0
        self.evictions_total: int = 0

    # -- configuration -------------------------------------------------------

    def configure(self, cfg: Any) -> None:
        """Apply a ``tenancy`` config block (core.config.TenancyConfig
        or same-shaped object) in place — singleton contract, like the
        usage ledger's ``reconfigure``."""
        specs: Dict[str, TenantClassConfig] = {}
        for tid, raw in (getattr(cfg, "tenants", None) or {}).items():
            if isinstance(raw, TenantClassConfig):
                specs[str(tid)] = raw
                continue
            fields = {str(k).replace("-", "_"): v
                      for k, v in (raw or {}).items()}
            specs[str(tid)] = TenantClassConfig(**fields)
        default = getattr(cfg, "default", None)
        with self._mu:
            self.enabled = bool(getattr(cfg, "enabled", False))
            self.share_window_s = float(
                getattr(cfg, "share_window_s", 60.0) or 60.0)
            self._specs = specs
            if default is not None:
                self._default = default

    def spec_for(self, tenant: str) -> TenantClassConfig:
        with self._mu:
            return self._specs.get(tenant, self._default)

    def weight_for(self, tenant: str) -> float:
        return max(1e-9, float(self.spec_for(tenant).weight))

    def known_tenants(self) -> Dict[str, TenantClassConfig]:
        with self._mu:
            return dict(self._specs)

    def is_configured(self, tenant: str) -> bool:
        with self._mu:
            return tenant in self._specs

    # -- token-rate bucket (admission edge) ----------------------------------

    def admit_tokens(self, tenant: str, n: int, *,
                     consume: bool = True,
                     force: bool = False) -> Tuple[bool, float]:
        """Check (and by default consume) ``n`` tokens from the
        tenant's bucket. Returns ``(True, 0.0)`` when admitted (or
        unlimited), else ``(False, retry_after_seconds)`` — the time
        until the bucket holds ``n`` tokens again (capped by the burst
        size, so an oversized request reports the bucket-full horizon,
        not infinity).

        ``consume=False`` peeks: refills the bucket and reports the
        verdict without subtracting (the shedder's pre-global-check
        gate). ``force=True`` subtracts even when the level is short —
        the shedder charges an ADMITTED request unconditionally after
        the peek, so a concurrent drain becomes debt, not a double
        reject."""
        spec = self.spec_for(tenant)
        rate = float(spec.token_rate)
        if rate <= 0:
            return True, 0.0
        burst = float(spec.burst_tokens)
        if burst <= 0:
            burst = max(rate, 1.0)
        now = self._clock.now()
        with self._mu:
            b = self._buckets.get(tenant)
            if b is None:
                b = _Bucket(burst, now)
                self._buckets[tenant] = b
                self._trim_locked(self._buckets)
            else:
                self._buckets.move_to_end(tenant)
                b.level = min(burst, b.level + max(0.0, now - b.last) * rate)
                b.last = now
            need = min(float(n), burst)   # an over-burst request can
            ok = b.level >= need          # never wait its way in
            if (ok or force) and consume:
                b.level -= float(n)       # (debt drains at `rate`)
            if ok:
                return True, 0.0
            return False, max(0.05, (need - b.level) / rate)

    # -- queue-depth counters (fed by the fair dequeue layer) ----------------

    def note_enqueued(self, tenant: str) -> None:
        with self._mu:
            self._queued[tenant] = self._queued.get(tenant, 0) + 1

    def note_dequeued(self, tenant: str) -> None:
        with self._mu:
            n = self._queued.get(tenant, 0) - 1
            if n > 0:
                self._queued[tenant] = n
            else:
                self._queued.pop(tenant, None)

    def queue_depth(self, tenant: str) -> int:
        with self._mu:
            return self._queued.get(tenant, 0)

    def over_queue_depth(self, tenant: str) -> bool:
        cap = int(self.spec_for(tenant).max_queue_depth)
        return cap > 0 and self.queue_depth(tenant) >= cap

    # -- in-flight counters (worker dispatch) --------------------------------

    def acquire_inflight(self, tenant: str) -> None:
        with self._mu:
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1

    def release_inflight(self, tenant: str) -> None:
        with self._mu:
            n = self._inflight.get(tenant, 0) - 1
            if n > 0:
                self._inflight[tenant] = n
            else:
                self._inflight.pop(tenant, None)

    def inflight(self, tenant: str) -> int:
        with self._mu:
            return self._inflight.get(tenant, 0)

    def at_inflight_cap(self, tenant: str) -> bool:
        """Non-consuming check the fair dequeue uses to DEFER a capped
        tenant's queued work (advisory under concurrent poppers — the
        acquire happens at delivery, so N racing pops can overshoot the
        cap by at most N-1)."""
        cap = int(self.spec_for(tenant).max_inflight)
        if cap <= 0:
            return False
        with self._mu:
            return self._inflight.get(tenant, 0) >= cap

    # -- rejection accounting ------------------------------------------------

    def note_rejection(self, reason: str) -> None:
        if reason not in QUOTA_REASONS:
            reason = "rate"
        with self._mu:
            self._pending_rejections[reason] = (
                self._pending_rejections.get(reason, 0) + 1)
            self.rejections_total[reason] = (
                self.rejections_total.get(reason, 0) + 1)

    def drain_rejections(self) -> Dict[str, int]:
        """Buffered rejection counts since the last drain (the scrape
        flush moves them into the Prometheus counter)."""
        with self._mu:
            out, self._pending_rejections = self._pending_rejections, {}
            return out

    def drain_evictions(self) -> int:
        """Buffered LRU-eviction count since the last drain (scrape
        flush → ``tenant_registry_evictions_total``)."""
        with self._mu:
            out, self._pending_evictions = self._pending_evictions, 0
            return out

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            tenants = sorted(set(self._specs) | set(self._queued)
                             | set(self._inflight))
            return {
                "enabled": self.enabled,
                "tenants": {
                    t: {
                        "weight": float(self._specs.get(
                            t, self._default).weight),
                        "queued": self._queued.get(t, 0),
                        "inflight": self._inflight.get(t, 0),
                    } for t in tenants},
                "rejections": dict(self.rejections_total),
            }

    def inflight_by_tenant(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._inflight)

    def clear(self) -> None:
        """Reset runtime counters (tests only; config survives)."""
        with self._mu:
            self._buckets.clear()
            self._inflight.clear()
            self._queued.clear()
            self._pending_rejections.clear()
            self.rejections_total = {}
            self._pending_evictions = 0
            self.evictions_total = 0

    def _trim_locked(self, lru: "OrderedDict[str, Any]") -> None:
        while len(lru) > self.MAX_TRACKED:
            # Oldest NON-configured entry goes (an id spray must not
            # evict — and thereby refill — a named tenant's bucket).
            for key in lru:
                if key not in self._specs:
                    del lru[key]
                    self._pending_evictions += 1
                    self.evictions_total += 1
                    break
            else:
                break
