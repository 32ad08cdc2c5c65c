"""Weighted fair dequeue over the multi-level priority queue (the port's
copy of ``llmq_tpu/tenancy/fair_queue.py``).

The scheduling half of the tenancy plane. Within each
priority level, ``pop()`` serves the tenant with the lowest **weighted
virtual time** instead of global FIFO — the same fine-grained work-unit
accounting argument as Slice-Level Scheduling (arXiv 2406.13511),
applied across tenants instead of across instances: fairness is
enforced at token granularity, not request granularity, and the
counters are fed back from *measured* tokens (estimated at pop,
trued-up from the usage ledger's per-request accounting at finish)
rather than predicted ones (arXiv 2606.01839's observation-over-
prediction stance).

Mechanics (start-time fair queueing):

- each tenant ``t`` has one scalar virtual time ``vt[t]`` shared by all
  priority levels; serving ``n`` tokens advances it by ``n / weight_t``
  — heavy tenants' counters race ahead, so selection (min ``vt``)
  automatically favors everyone else;
- a **virtual floor** tracks the minimum ``vt`` among backlogged
  tenants at each service; a tenant arriving from idle is clamped UP to
  the floor (``vt[t] = max(vt[t], floor)``), so idle time never
  accumulates into unbounded credit (the lag clamp);
- within one tenant, order stays FIFO (handles are monotonic);
- strict priority between levels is untouched — the scheduler only
  reorders *within* a queue name, and the worker still drains tiers in
  urgency order, so a realtime request beats batch regardless of its
  tenant's debt;
- a tenant at its ``max_inflight`` cap is skipped by selection — its
  queued work is deferred, not rejected — and the deferral is counted
  in ``tenant_quota_rejections_total{reason="inflight"}``.

With a single active tenant the selected handle is always the FIFO
head, so an enabled-but-single-tenant system dequeues in exactly the
order the plain path would. ``tenancy.enabled: false`` never constructs
this class at all (the hard off-switch: one ``is None`` check in
``MultiLevelQueue.pop``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Optional, Tuple

from llmq_tpu_torch.core.clock import Clock
from llmq_tpu_torch.observability.usage import sanitize_tenant
from llmq_tpu_torch.tenancy.registry import TenantRegistry, estimate_tokens

log = logging.getLogger("llmq_tpu_torch.tenancy.fair")


def share_ratios_from_window(registry: TenantRegistry,
                             window: Dict[str, int],
                             *, key: Optional[Callable[[str], str]] = None,
                             ) -> Dict[str, float]:
    """Achieved token share ÷ configured weight share for one rolling
    window of served tokens (tenant → tokens). The weight denominator
    is the sum over tenants ACTIVE in the window — fairness is judged
    among the tenants actually competing, so an idle tenant's weight
    doesn't dilute everyone else's target. Module-level so the metric
    flush can apply it to a window merged across several schedulers.

    ``key`` optionally coarsens tenants (the metric flush passes the
    bounded label mapper): tokens AND weights sum within a key before
    the ratio, so a collapsed "other" series reads a true aggregate
    rather than whichever collapsed tenant was written last."""
    total = sum(window.values())
    if total <= 0:
        return {}
    wsum = sum(registry.weight_for(t) for t in window)
    if wsum <= 0:
        return {}
    toks: Dict[str, int] = {}
    wts: Dict[str, float] = {}
    for tenant, tokens in window.items():
        k = tenant if key is None else key(tenant)
        toks[k] = toks.get(k, 0) + tokens
        wts[k] = wts.get(k, 0.0) + registry.weight_for(tenant)
    return {k: (toks[k] / total) / (wts[k] / wsum)
            for k in toks if wts[k] > 0}


class FairScheduler:
    """Per-manager WFQ state layered over one
    :class:`~llmq_tpu_torch.queueing.priority_queue.MultiLevelQueue`.

    The queue wrapper calls :meth:`on_push` / :meth:`select` /
    :meth:`discard`; the queue manager calls
    :meth:`note_pop` (charge + in-flight acquire on delivery),
    :meth:`note_finish` (true-up + release) and :meth:`note_requeue`
    (release without true-up). All entry points take the scheduler's
    own lock — callers hold no queue lock across them.
    """

    #: Bounded pop-estimate records awaiting their finish true-up.
    MAX_PENDING_EST = 8192

    def __init__(self, registry: TenantRegistry, *,
                 clock: Optional[Clock] = None) -> None:
        self.registry = registry
        #: Clock for the rolling share window (the manager passes its
        #: own, so fake-clock tests can age entries deterministically).
        self._clock = clock
        self._mu = threading.Lock()
        #: queue name → tenant → FIFO deque of handles.
        self._qs: Dict[str, Dict[str, deque]] = {}
        #: handle → tenant (for discard bookkeeping).
        self._tenant_of: Dict[int, str] = {}
        #: tenant → queued handles across ALL queues of this scheduler
        #: (backlog indicator for the idle-clamp and the floor).
        self._backlog: Dict[str, int] = {}
        #: LRU like the registry's buckets — an id spray must not grow
        #: per-tenant state (or the /metrics flush walk) without bound;
        #: idle unconfigured tenants are evicted past MAX_TRACKED.
        self._vt: "OrderedDict[str, float]" = OrderedDict()
        self._vfloor = 0.0
        #: message id → (tenant, estimated tokens) awaiting true-up.
        self._est: "OrderedDict[str, Tuple[str, int]]" = OrderedDict()
        #: (wall ts, tenant, tokens) — rolling achieved-share window.
        self._served: deque = deque(maxlen=65536)
        #: Lifetime served tokens per tenant (stats/bench surface).
        self.served_tokens: "OrderedDict[str, int]" = OrderedDict()
        #: Handles already counted as inflight-deferred — each queued
        #: message mints at most ONE deferral event, not one per poll.
        self._deferred_counted: set = set()

    def _now(self) -> float:
        return (self._clock.now() if self._clock is not None
                else time.monotonic())  # lint: allow-wallclock — no
        # clock attached (standalone scheduler): wall time is the only
        # feed for the rolling share window.

    # -- queue-side hooks (called by MultiLevelQueue) ------------------------

    def on_push(self, qname: str, message: Any, handle: int) -> None:
        tenant = sanitize_tenant(getattr(message, "tenant_id", ""))
        with self._mu:
            per_tenant = self._qs.setdefault(qname, {})
            dq = per_tenant.get(tenant)
            if dq is None:
                dq = per_tenant[tenant] = deque()
            if self._backlog.get(tenant, 0) == 0:
                # Idle → backlogged transition: clamp the tenant's
                # virtual time up to the floor. Credit for sitting out
                # does not accumulate; debt (vt above the floor — a
                # heavy tenant that just burst) is kept.
                self._vt[tenant] = max(self._vt.get(tenant, 0.0),
                                       self._vfloor)
            else:
                self._vt.setdefault(tenant, self._vfloor)
            self._vt.move_to_end(tenant)
            dq.append(handle)
            self._backlog[tenant] = self._backlog.get(tenant, 0) + 1
            self._tenant_of[handle] = tenant
            self._trim_tenants_locked()
        self.registry.note_enqueued(tenant)

    def select(self, qname: str) -> Optional[int]:
        """Pick (and remove) the next handle to pop from ``qname``: the
        FIFO head of the eligible tenant with the lowest virtual time.
        Returns None when the queue holds nothing dispatchable — either
        truly empty or every queued tenant is at its in-flight cap."""
        newly_deferred = 0
        with self._mu:
            per_tenant = self._qs.get(qname)
            if not per_tenant:
                return None
            # Advance the floor to the current virtual time — the min
            # vt among backlogged tenants ELIGIBLE for service (this
            # scheduler), so an idle tenant re-arriving mid-burst lands
            # exactly where service currently is, never behind it. A
            # tenant deferred at its in-flight cap is excluded: its vt
            # is frozen while its long-running work drains, and letting
            # it pin the floor would clamp every new arrival far below
            # the actively-served tenants — a backlog-sized starvation
            # window for them, the exact thing the clamp exists to
            # prevent.
            backlogged = [t for t, n in self._backlog.items() if n > 0]
            capped = {t for t in backlogged
                      if self.registry.at_inflight_cap(t)}
            eligible = [t for t in backlogged if t not in capped]
            if eligible:
                self._vfloor = max(
                    self._vfloor,
                    min(self._vt.get(t, 0.0) for t in eligible))
            best_tenant: Optional[str] = None
            best_key: Optional[Tuple[float, int]] = None
            for tenant, dq in per_tenant.items():
                if not dq:
                    continue
                if tenant in capped:
                    # One deferral event per HELD-BACK HANDLE, not per
                    # poll — workers poll every few ms, and a per-poll
                    # count would measure poll cadence, not deferred
                    # work.
                    if dq[0] not in self._deferred_counted:
                        self._deferred_counted.add(dq[0])
                        newly_deferred += 1
                    continue
                key = (self._vt.get(tenant, 0.0), dq[0])
                if best_key is None or key < best_key:
                    best_key = key
                    best_tenant = tenant
            if best_tenant is None:
                handle = None
            else:
                dq = per_tenant[best_tenant]
                handle = dq.popleft()
                if not dq:
                    # Drop drained deques — _qs must stay bounded by
                    # BACKLOGGED tenants, not tenants ever seen (an id
                    # spray would otherwise grow this map and the
                    # select() scan without bound).
                    del per_tenant[best_tenant]
                self._forget_locked(best_tenant, handle)
        if handle is not None:
            # The handle left the fair index — whatever happens next
            # (delivery, tombstone drain, a lost race with an admin
            # removal) it is no longer pending, so the tenant's depth
            # counter moves HERE, exactly once.
            self.registry.note_dequeued(best_tenant)
        for _ in range(newly_deferred):
            # Queued work held back by an in-flight cap: count the
            # deferral (once per message) so operators can see the cap
            # — not the engine — is that tenant's bottleneck.
            self.registry.note_rejection("inflight")
        return handle

    def discard(self, qname: str, handle: int) -> None:
        """A pending handle left the queue outside the pop path (admin
        removal): drop it from the fair index."""
        with self._mu:
            tenant = self._tenant_of.get(handle)
            if tenant is None:
                return
            per_tenant = self._qs.get(qname) or {}
            dq = per_tenant.get(tenant)
            if dq is not None:
                try:
                    dq.remove(handle)
                except ValueError:
                    return   # already selected by a concurrent pop
                if not dq:
                    del per_tenant[tenant]
            self._forget_locked(tenant, handle)
        self.registry.note_dequeued(tenant)

    def _trim_tenants_locked(self) -> None:
        """Evict idle UNCONFIGURED tenants' fair state past the
        registry's LRU bound — same id-spray defense as the registry's
        buckets. Backlogged and named tenants are never evicted (their
        virtual time is load-bearing for selection)."""
        limit = self.registry.MAX_TRACKED
        for lru in (self._vt, self.served_tokens):
            while len(lru) > limit:
                victim = None
                for t in lru:
                    if (self._backlog.get(t, 0) == 0
                            and not self.registry.is_configured(t)):
                        victim = t
                        break
                if victim is None:
                    break
                del lru[victim]

    def _forget_locked(self, tenant: str, handle: int) -> None:
        self._tenant_of.pop(handle, None)
        self._deferred_counted.discard(handle)
        n = self._backlog.get(tenant, 0) - 1
        if n > 0:
            self._backlog[tenant] = n
        else:
            self._backlog.pop(tenant, None)

    # -- manager-side hooks (delivery / finish) ------------------------------

    def note_pop(self, msg: Any) -> None:
        """A selected message was DELIVERED to a consumer: charge the
        tenant's virtual time with the admission-time token estimate
        and take an in-flight slot. (Tombstoned entries never get here
        — their handles die inside the pop loop uncharged.)"""
        tenant = sanitize_tenant(getattr(msg, "tenant_id", ""))
        est = estimate_tokens(msg)
        self.registry.acquire_inflight(tenant)
        with self._mu:
            self._vt[tenant] = (self._vt.get(tenant, self._vfloor)
                                + est / self.registry.weight_for(tenant))
            self._est[msg.id] = (tenant, est)
            while len(self._est) > self.MAX_PENDING_EST:
                self._est.popitem(last=False)

    def note_finish(self, msg: Any, ok: bool = True) -> None:
        """The message reached a terminal state: release the in-flight
        slot and TRUE UP the virtual-time charge from measured tokens
        (``metadata.usage`` — the usage ledger's per-request counts
        ride there) where the pop-time estimate was wrong."""
        tenant = sanitize_tenant(getattr(msg, "tenant_id", ""))
        self.registry.release_inflight(tenant)
        with self._mu:
            rec = self._est.pop(msg.id, None)
        est = rec[1] if rec is not None else 0
        usage = (getattr(msg, "metadata", None) or {}).get("usage") or {}
        try:
            actual = (int(usage.get("prompt_tokens", 0) or 0)
                      + int(usage.get("completion_tokens", 0) or 0))
        except (TypeError, ValueError):
            actual = 0
        if actual <= 0:
            actual = est
        with self._mu:
            if rec is not None and actual != est:
                self._vt[tenant] = (self._vt.get(tenant, self._vfloor)
                                    + (actual - est)
                                    / self.registry.weight_for(tenant))
            if ok and actual > 0:
                self._served.append((self._now(), tenant, actual))
                self.served_tokens[tenant] = (
                    self.served_tokens.get(tenant, 0) + actual)
                self.served_tokens.move_to_end(tenant)
                self._trim_tenants_locked()

    def note_requeue(self, msg: Any) -> None:
        """The message left PROCESSING without finishing (retry stash /
        requeue): free its in-flight slot. The pop-time charge stays —
        the attempt consumed service capacity, and the re-pop will be
        charged again (measured feedback, not double billing: each
        dispatch is real work the tenant caused)."""
        tenant = sanitize_tenant(getattr(msg, "tenant_id", ""))
        self.registry.release_inflight(tenant)
        with self._mu:
            self._est.pop(msg.id, None)

    # -- reads / metrics ------------------------------------------------------

    def virtual_times(self) -> Dict[str, float]:
        with self._mu:
            return dict(self._vt)

    def window_tokens(self) -> Dict[str, int]:
        """Tokens served per tenant within the registry's rolling
        share window (expired entries dropped). The metric flush merges
        these across ALL schedulers before computing share ratios, so
        one tenant active on several queue managers reads one coherent
        global ratio rather than whichever manager flushed last."""
        horizon = self._now() - float(
            getattr(self.registry, "share_window_s", 60.0) or 60.0)
        with self._mu:
            while self._served and self._served[0][0] < horizon:
                self._served.popleft()
            window: Dict[str, int] = {}
            for _, tenant, tokens in self._served:
                window[tenant] = window.get(tenant, 0) + tokens
        return window

    def share_ratios(self) -> Dict[str, float]:
        """Achieved token share ÷ configured weight share over the
        registry's rolling window, per tenant active in the window.
        1.0 = serving exactly the configured share; < 1 under-served;
        only meaningful under contention (an uncontended tenant can
        take the whole machine and legitimately read > 1)."""
        return share_ratios_from_window(self.registry,
                                        self.window_tokens())

    def snapshot(self) -> Dict[str, object]:
        with self._mu:
            backlog = dict(self._backlog)
            vts = dict(self._vt)
            served = dict(self.served_tokens)
        return {
            "virtual_times": {t: round(v, 3) for t, v in vts.items()},
            "virtual_floor": round(self._vfloor, 3),
            "backlog": backlog,
            "served_tokens": served,
            "share_ratios": self.share_ratios(),
        }
