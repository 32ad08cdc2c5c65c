"""Resource scheduler over the card's chips and memory (the port's copy
of ``llmq_tpu/scheduling/resource_scheduler.py``).

- ``Resource``: model type, capabilities, per-type capacity and use,
  load, endpoint and heartbeat; ``ResourceType`` counts CPU, GPU,
  memory and tokens, and the chips (``CHIP``), their memory
  (``HBM_GB``) and tokens per second.
- ``request_resource`` → ``_try_allocate``: filter by status, model
  type, capabilities and capacity, pick the least loaded, allocate with
  an expiry and a token; otherwise queue the request, sorted by
  priority. ``metadata {"pinned": True}`` allocations never expire (a
  serving engine's chips).
- ``register_topology_resources`` carves a :class:`GpuTopology` into
  resources: one per ``chips_per_resource`` chips, capability tags the
  chips' platform (``"cuda"``, or ``"cpu"`` for the host chip of a CPU
  run) and their kind.
- Background loops: heartbeat timeout → offline, allocation expiry, and
  the pending-request processor. (The JAX package's scale-up/down
  callbacks and their ``scale_*`` thresholds are left out: no caller in
  either package passes one. The endpoint autoscaler is
  ``scheduling/autoscaler.py``.)
- Cache-aware admission: ``set_prefill_estimator`` (the engine's
  ``prefill_estimate``) makes a TOKENS request pay only for its expected
  new prefill tokens; ``observe_prefill`` (fed by the engine's
  ``on_prefill_observed``) learns the prefill rate behind
  ``prefill_eta_ms``, which the overload shedder adds to its deadline
  check.
"""

from __future__ import annotations

import enum
import logging
import threading
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import ResourceSchedulerConfig
from llmq_tpu_torch.core.errors import AllocationNotFoundError, NoResourceError
from llmq_tpu_torch.core.types import Priority
from llmq_tpu_torch.scheduling.topology import GpuTopology

log = logging.getLogger("llmq_tpu_torch.resource_scheduler")


class ResourceType(str, enum.Enum):
    CPU = "cpu"
    GPU = "gpu"
    MEMORY = "memory"
    TOKENS = "tokens"
    # A topology's chips and their memory:
    CHIP = "chip"
    HBM_GB = "hbm_gb"
    TOKENS_PER_S = "tokens_per_s"


class ResourceStatus(str, enum.Enum):
    ONLINE = "online"
    BUSY = "busy"
    OFFLINE = "offline"


@dataclass
class Resource:
    id: str
    model_type: str = "llm"
    capabilities: Set[str] = field(default_factory=set)
    capacity: Dict[ResourceType, float] = field(default_factory=dict)
    used: Dict[ResourceType, float] = field(default_factory=dict)
    endpoint: str = ""
    status: ResourceStatus = ResourceStatus.ONLINE
    last_heartbeat: float = 0.0
    metadata: Dict = field(default_factory=dict)

    @property
    def load(self) -> float:
        """Mean used/capacity over resource types."""
        if not self.capacity:
            return 0.0
        fracs = [
            self.used.get(t, 0.0) / cap
            for t, cap in self.capacity.items() if cap > 0
        ]
        return sum(fracs) / len(fracs) if fracs else 0.0

    def available(self, rtype: ResourceType) -> float:
        return self.capacity.get(rtype, 0.0) - self.used.get(rtype, 0.0)

    def to_dict(self) -> Dict:
        return {
            "id": self.id,
            "model_type": self.model_type,
            "capabilities": sorted(self.capabilities),
            "capacity": {t.value: v for t, v in self.capacity.items()},
            "used": {t.value: v for t, v in self.used.items()},
            "load": self.load,
            "endpoint": self.endpoint,
            "status": self.status.value,
            "last_heartbeat": self.last_heartbeat,
        }


@dataclass
class ResourceRequest:
    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    model_type: str = "llm"
    capabilities: Set[str] = field(default_factory=set)
    amounts: Dict[ResourceType, float] = field(default_factory=dict)
    priority: Priority = Priority.NORMAL
    timeout: float = 0.0          # 0 = wait forever in pending
    created_at: float = 0.0
    metadata: Dict = field(default_factory=dict)


@dataclass
class ResourceAllocation:
    id: str
    resource_id: str
    request: ResourceRequest
    token: str
    allocated_at: float
    expires_at: float             # 0 = no expiry
    #: What was actually charged to the resource — differs from
    #: ``request.amounts`` when the cache-aware prefill estimator
    #: discounted the TOKENS amount; release must refund exactly this.
    charged: Optional[Dict[ResourceType, float]] = None

    def to_dict(self) -> Dict:
        return {
            "id": self.id,
            "resource_id": self.resource_id,
            "request_id": self.request.id,
            "allocated_at": self.allocated_at,
            "expires_at": self.expires_at,
        }


class ResourceScheduler:
    def __init__(
        self,
        config: Optional[ResourceSchedulerConfig] = None,
        clock: Optional[Clock] = None,
        topology: Optional[GpuTopology] = None,
    ) -> None:
        self.config = config or ResourceSchedulerConfig()
        self._clock = clock or SYSTEM_CLOCK
        self.topology = topology
        self._resources: Dict[str, Resource] = {}
        self._allocations: Dict[str, ResourceAllocation] = {}
        self._pending: List[ResourceRequest] = []  # kept priority-sorted
        self._waiters: Dict[str, ResourceAllocation] = {}
        self._mu = threading.RLock()
        self._drain_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._on_allocate: List[Callable[[ResourceAllocation], None]] = []
        #: Cache-aware admission seam (docs/prefix_cache.md): maps a
        #: request's metadata to (expected_cached, expected_new) prefill
        #: tokens — typically InferenceEngine.prefill_estimate bound by
        #: the serving entrypoint. See :meth:`set_prefill_estimator`.
        self._prefill_estimator: Optional[
            Callable[[Dict], "tuple[int, int]"]] = None
        #: Learned prefill throughput (tokens/s EWMA). With mixed
        #: batching the effective rate is the BUDGETED one — prefill
        #: tokens ride the decode chunk at mixed_batch.
        #: prefill_token_budget per iteration, not the dedicated
        #: program's burst rate — so the scheduler learns it from
        #: observations (InferenceEngine.on_prefill_observed feeds
        #: :meth:`observe_prefill`) instead of assuming a static figure.
        self._prefill_tps: Optional[float] = None
        self._prefill_observations = 0

    # -- cache-aware admission (prefix cache) --------------------------------

    def set_prefill_estimator(
            self, fn: Optional[Callable[[Dict], "tuple[int, int]"]]) -> None:
        """Register ``fn(metadata) -> (expected_cached, expected_new)``.

        When a :class:`ResourceRequest` sizes itself in TOKENS, the raw
        amount assumes the whole context must be prefilled; with a
        prefix cache serving part of it from resident KV, that
        overstates the work and under-admits. ``_try_allocate`` charges
        only the expected NEW tokens (never more than requested, never
        below 1) so realtime chunk sizing reflects actual compute."""
        with self._mu:
            self._prefill_estimator = fn

    def _effective_amounts(
            self, request: ResourceRequest) -> Dict[ResourceType, float]:
        amounts = dict(request.amounts)
        tok = amounts.get(ResourceType.TOKENS)
        if tok is None or self._prefill_estimator is None:
            return amounts
        try:
            cached, new = self._prefill_estimator(request.metadata)
        except Exception:  # noqa: BLE001 — estimator is advisory
            log.exception("prefill estimator failed; charging raw tokens")
            return amounts
        if cached <= 0 or new <= 0:
            # No reuse expected, or no usable estimate (e.g. the request
            # metadata carried no prompt size → new == 0): charge the
            # raw amount. Discounting on a zero-information estimate
            # would collapse the charge to ~nothing and disable token
            # admission control entirely.
            return amounts
        total = cached + new
        # Charge the uncached share of the REQUESTED amount (the caller
        # knows its own token count better than the estimator does).
        amounts[ResourceType.TOKENS] = max(1.0, tok * (new / total))
        return amounts

    def observe_prefill(self, tokens: int, seconds: float) -> None:
        """Record one completed prefill (``tokens`` run in ``seconds``)
        into the learned-rate EWMA. Bind this to
        ``InferenceEngine.on_prefill_observed`` so admission sizing
        tracks the rate the serving geometry ACTUALLY sustains —
        budgeted mixed-batch slices included."""
        if tokens <= 0 or seconds <= 0:
            return
        rate = tokens / seconds
        with self._mu:
            if self._prefill_tps is None:
                self._prefill_tps = rate
            else:
                self._prefill_tps = 0.8 * self._prefill_tps + 0.2 * rate
            self._prefill_observations += 1

    def prefill_eta_ms(self, new_tokens: int) -> Optional[float]:
        """Expected prefill milliseconds for ``new_tokens`` uncached
        tokens at the learned rate. Zero tokens cost 0.0 regardless of
        observations (a fully-cached prompt's cost is known, not
        unknown); a positive amount returns None until the first
        observation lands."""
        if new_tokens <= 0:
            return 0.0
        with self._mu:
            tps = self._prefill_tps
        if not tps:
            return None
        return new_tokens / tps * 1e3

    # -- registry ------------------------------------------------------------

    def register_resource(self, resource: Resource) -> None:
        resource.last_heartbeat = self._clock.now()
        with self._mu:
            self._resources[resource.id] = resource
        log.info("resource registered: %s (%s, caps=%s)",
                 resource.id, resource.endpoint, sorted(resource.capabilities))
        self.process_pending_once()

    def register_topology_resources(self, topology: GpuTopology,
                                    chips_per_resource: int = 8,
                                    model_type: str = "llm",
                                    tokens_per_s: float = 0.0) -> List[Resource]:
        """Carve a topology into schedulable resources: one per
        ``chips_per_resource`` chips, tagged with the chips' platform
        and kind."""
        self.topology = topology
        out = []
        chips = topology.chips
        for start in range(0, len(chips), chips_per_resource):
            group = chips[start:start + chips_per_resource]
            r = Resource(
                id=f"{topology.slice_name}-r{start // chips_per_resource}",
                model_type=model_type,
                capabilities={group[0].platform, group[0].kind},
                capacity={
                    ResourceType.CHIP: float(len(group)),
                    ResourceType.HBM_GB: sum(c.hbm_gb for c in group),
                    **({ResourceType.TOKENS_PER_S: tokens_per_s}
                       if tokens_per_s else {}),
                },
                endpoint=f"local://{topology.slice_name}/{start}",
                metadata={"chip_ids": [c.id for c in group],
                          "hosts": sorted({c.process_index for c in group})},
            )
            self.register_resource(r)
            out.append(r)
        return out

    def unregister_resource(self, resource_id: str) -> bool:
        with self._mu:
            return self._resources.pop(resource_id, None) is not None

    def get_resource(self, resource_id: str) -> Optional[Resource]:
        with self._mu:
            return self._resources.get(resource_id)

    def resources(self) -> List[Resource]:
        with self._mu:
            return list(self._resources.values())

    def heartbeat(self, resource_id: str) -> bool:
        with self._mu:
            r = self._resources.get(resource_id)
            if r is None:
                return False
            r.last_heartbeat = self._clock.now()
            if r.status == ResourceStatus.OFFLINE:
                r.status = ResourceStatus.ONLINE
                log.info("resource %s back online", resource_id)
            return True

    # -- allocation ----------------------------------------------------------

    def request_resource(self, request: ResourceRequest) -> Optional[ResourceAllocation]:
        """Try to allocate now; on failure enqueue as pending and return
        None (the caller polls ``get_allocation_for_request`` or registers
        an ``on_allocate`` callback)."""
        if request.created_at == 0.0:
            request.created_at = self._clock.now()
        alloc = self._try_allocate(request)
        if alloc is not None:
            return alloc
        with self._mu:
            self._pending.append(request)
            self._pending.sort(key=lambda r: (int(r.priority), r.created_at))
        log.info("request %s queued (priority=%s, pending=%d)",
                 request.id, request.priority.tier_name, len(self._pending))
        return None

    def request_resource_now(self, request: ResourceRequest) -> ResourceAllocation:
        """Allocate or raise NoResourceError (no pending queue)."""
        if request.created_at == 0.0:
            request.created_at = self._clock.now()
        alloc = self._try_allocate(request)
        if alloc is None:
            raise NoResourceError(
                f"no resource for model={request.model_type} "
                f"caps={sorted(request.capabilities)} amounts={request.amounts}")
        return alloc

    def _try_allocate(self, request: ResourceRequest) -> Optional[ResourceAllocation]:
        with self._mu:
            amounts = self._effective_amounts(request)
            candidates = [
                r for r in self._resources.values()
                if r.status == ResourceStatus.ONLINE
                and r.model_type == request.model_type
                and request.capabilities.issubset(r.capabilities)
                and all(r.available(t) >= amt
                        for t, amt in amounts.items())
            ]
            if not candidates:
                return None
            chosen = min(candidates, key=lambda r: r.load)
            for t, amt in amounts.items():
                chosen.used[t] = chosen.used.get(t, 0.0) + amt
            now = self._clock.now()
            # request.timeout bounds PENDING wait only; the allocation's
            # lifetime is always the configured allocation_timeout (reusing
            # the former for the latter would reclaim a resource out from
            # under a live caller). metadata {"pinned": True} opts out of
            # expiry entirely — the holder is a long-lived occupant (a
            # serving engine's chips) released only explicitly.
            timeout = self.config.allocation_timeout
            if request.metadata.get("pinned"):
                timeout = 0.0
            alloc = ResourceAllocation(
                id=str(uuid.uuid4()),
                resource_id=chosen.id,
                request=request,
                token=str(uuid.uuid4()),
                allocated_at=now,
                expires_at=now + timeout if timeout > 0 else 0.0,
                charged=amounts,
            )
            self._allocations[alloc.id] = alloc
            callbacks = list(self._on_allocate)
        for cb in callbacks:
            try:
                cb(alloc)
            except Exception:  # noqa: BLE001
                log.exception("on_allocate callback failed")
        return alloc

    def on_allocate(self, cb: Callable[[ResourceAllocation], None]) -> None:
        with self._mu:
            self._on_allocate.append(cb)

    def release_allocation(self, allocation_id: str, token: str) -> None:
        with self._mu:
            alloc = self._allocations.get(allocation_id)
            if alloc is None:
                raise AllocationNotFoundError(allocation_id)
            if alloc.token != token:
                raise PermissionError(
                    f"bad token for allocation {allocation_id}")
            self._release_locked(alloc)
        self.process_pending_once()

    def _release_locked(self, alloc: ResourceAllocation) -> None:
        self._allocations.pop(alloc.id, None)
        r = self._resources.get(alloc.resource_id)
        if r is not None:
            for t, amt in (alloc.charged or alloc.request.amounts).items():
                r.used[t] = max(0.0, r.used.get(t, 0.0) - amt)

    def get_allocation(self, allocation_id: str) -> Optional[ResourceAllocation]:
        with self._mu:
            return self._allocations.get(allocation_id)

    def get_allocation_for_request(self, request_id: str) -> Optional[ResourceAllocation]:
        with self._mu:
            for a in self._allocations.values():
                if a.request.id == request_id:
                    return a
            return None

    def allocations(self) -> List[ResourceAllocation]:
        with self._mu:
            return list(self._allocations.values())

    def pending_count(self) -> int:
        with self._mu:
            return len(self._pending)

    # -- pending processor ---------------------------------------------------

    def process_pending_once(self) -> int:
        """Drain what can now be satisfied; expire requests pending past
        their timeout (from ``created_at``). Returns the number
        allocated."""
        now = self._clock.now()
        allocated = 0
        # Serialise drains: concurrent callers (res-pending loop, release,
        # register) must not snapshot the same request and allocate it twice.
        with self._drain_lock:
            with self._mu:
                pending, self._pending = self._pending, []
            survivors: List[ResourceRequest] = []
            for req in pending:
                if req.timeout > 0 and now - req.created_at > req.timeout:
                    log.warning("pending request %s timed out after %.1fs",
                                req.id, now - req.created_at)
                    continue
                alloc = self._try_allocate(req)
                if alloc is None:
                    survivors.append(req)
                else:
                    allocated += 1
            with self._mu:
                # _pending now holds only requests that arrived meanwhile.
                self._pending = survivors + self._pending
                self._pending.sort(key=lambda r: (int(r.priority), r.created_at))
        return allocated

    # -- monitor -------------------------------------------------------------

    def run_monitor_once(self) -> Dict[str, int]:
        now = self._clock.now()
        offline = expired = 0
        with self._mu:
            for r in self._resources.values():
                if (r.status != ResourceStatus.OFFLINE
                        and self.config.heartbeat_timeout > 0
                        and now - r.last_heartbeat > self.config.heartbeat_timeout):
                    r.status = ResourceStatus.OFFLINE
                    offline += 1
                    log.warning("resource %s offline (heartbeat timeout)", r.id)
            for alloc in list(self._allocations.values()):
                if alloc.expires_at and alloc.expires_at <= now:
                    self._release_locked(alloc)
                    expired += 1
                    log.warning("allocation %s expired; reclaimed", alloc.id)
        if expired:
            self.process_pending_once()
        return {"offline": offline, "expired_allocations": expired}

    # -- background threads --------------------------------------------------

    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        for name, target, interval in (
                ("res-monitor", self.run_monitor_once, self.config.monitor_interval),
                ("res-pending", self.process_pending_once,
                 self.config.pending_process_interval)):
            t = threading.Thread(
                target=self._loop, args=(target, interval), name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []

    def _loop(self, fn, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                fn()
            except Exception:  # noqa: BLE001
                log.exception("scheduler loop %s failed", fn.__name__)

    # -- stats ---------------------------------------------------------------

    def get_stats(self) -> Dict:
        with self._mu:
            return {
                "resources": len(self._resources),
                "online": sum(1 for r in self._resources.values()
                              if r.status == ResourceStatus.ONLINE),
                "allocations": len(self._allocations),
                "pending_requests": len(self._pending),
                "avg_load": (
                    sum(r.load for r in self._resources.values())
                    / len(self._resources) if self._resources else 0.0),
                "prefill_tokens_per_s": (
                    round(self._prefill_tps, 1)
                    if self._prefill_tps else None),
                "prefill_observations": self._prefill_observations,
                # Operator-facing ETA at a canonical size (1k tokens):
                # what one full-bucket prompt costs at the learned
                # (budgeted, under mixed batching) rate. _mu is an
                # RLock, so the helper's own acquire is reentrant.
                "prefill_eta_ms_per_1k": (
                    round(self.prefill_eta_ms(1000), 1)
                    if self._prefill_tps else None),
                "topology": self.topology.to_dict() if self.topology else None,
            }
