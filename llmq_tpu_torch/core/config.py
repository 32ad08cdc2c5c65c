"""Typed configuration for the port: dataclass defaults, then a YAML
file, then ``LLMQ_*`` environment overrides, then CLI flags.

A copy of ``llmq_tpu/core/config.py`` holding what the port's planes
read, with the JAX package's defaults. :func:`load_config` reads the same
files as the JAX package's (``configs/config.yaml`` among them). A key of
a plane the port does not have yet, or one that nothing here reads (the
server's read and write timeouts, the model's dtype, a tier's
``max_concurrent``, the metrics port and path, the load balancer's
``max_retries``, the resource scheduler's ``scale_*`` thresholds, XLA's
``tpu.platform`` and ``tpu.compilation_cache_dir``) is
accepted only at the JAX package's default, or inside a block whose
``enabled`` is false; any other value raises, naming the key. An unknown key raises too: nothing
in a file is silently ignored.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from llmq_tpu_torch.core.types import Priority

#: The port's executor backends: "torch" serves the model; "echo" (host
#: only, no model) echoes the prompt. The JAX package's default is
#: "echo"; the port's is "torch", and a file found by the config search
#: may not select "echo" (:func:`load_config`).
VALID_BACKENDS = ("torch", "echo")
VALID_LB_STRATEGIES = ("round_robin", "least_connections", "weighted_random",
                       "adaptive_load")
VALID_SCHEDULER_STRATEGIES = ("static", "dynamic", "adaptive", "hybrid")
VALID_DISAGG_ROLES = ("prefill", "decode", "unified")
VALID_POOL_KINDS = ("none", "subprocess", "exec")


@dataclass
class ServerConfig:
    """Bind address plus SSE admission control (the streaming path
    bypasses the queue plane, so it needs its own backpressure)."""
    host: str = "0.0.0.0"
    port: int = 8080
    #: Concurrent SSE streams accepted before new ones get 429; <= 0
    #: disables the cap.
    max_concurrent_streams: int = 32
    #: Engine pending depth above which new streams get 503; <= 0
    #: disables.
    stream_pending_limit: int = 256


@dataclass
class PersistenceConfig:
    """Conversation store: "memory" | "sqlite" | "redis" (redis needs
    the ``redis`` client package)."""
    backend: str = "memory"
    sqlite_path: str = "llmq_state.db"
    redis_url: str = "redis://localhost:6379/0"
    key_prefix: str = "llmq:"
    cache_ttl: float = 24 * 3600.0


@dataclass
class QueueLevelConfig:
    """One priority tier: its SLA bound feeds the engine's tier promotion."""
    priority: int = int(Priority.NORMAL)
    max_wait_time: float = 30.0

    @property
    def name(self) -> str:
        return Priority(self.priority).tier_name


def default_queue_levels() -> List[QueueLevelConfig]:
    """The canonical 4 tiers."""
    return [
        QueueLevelConfig(priority=int(Priority.REALTIME), max_wait_time=1.0),
        QueueLevelConfig(priority=int(Priority.HIGH), max_wait_time=5.0),
        QueueLevelConfig(priority=int(Priority.NORMAL), max_wait_time=30.0),
        QueueLevelConfig(priority=int(Priority.LOW), max_wait_time=300.0),
    ]


#: A tier's ``max_concurrent``, which nothing reads: a level may give it
#: only as the JAX package's default tiers do, or at its class default.
_LEVEL_MAX_CONCURRENT = {int(Priority.REALTIME): 100, int(Priority.HIGH): 200,
                         int(Priority.NORMAL): 500, int(Priority.LOW): 1000}
_LEVEL_MAX_CONCURRENT_DEFAULT = 500


@dataclass
class WorkerConfig:
    count: int = 4
    max_batch_size: int = 10
    process_interval: float = 0.05
    max_concurrent: int = 50
    #: Hard per-message deadline: a process function still running at
    #: ``message.timeout * hard_deadline_grace`` is abandoned by the
    #: watchdog (its slot freed, the message sent down the timeout and
    #: retry path). The call itself cannot be killed and may still
    #: finish its side effects: at-least-once, so the grace keeps that
    #: to calls that are really wedged.
    hard_deadline: bool = True
    hard_deadline_grace: float = 2.0


@dataclass
class RetryConfig:
    max_retries: int = 3
    initial_backoff: float = 1.0
    max_backoff: float = 60.0
    backoff_multiplier: float = 2.0
    strategy: str = "exponential"  # "exponential" | "fixed"


@dataclass
class QueueConfig:
    max_queue_size: int = 10000
    levels: List[QueueLevelConfig] = field(
        default_factory=default_queue_levels)
    worker: WorkerConfig = field(default_factory=WorkerConfig)
    retry: RetryConfig = field(default_factory=RetryConfig)
    #: Prometheus families fed by the queue plane, the supervisor and
    #: the shedder (``metrics/registry.py``; the engine's follow
    #: ``metrics.enabled``); served at ``GET /metrics``.
    enable_metrics: bool = True
    #: Messages whose retries are exhausted go to the dead-letter queue.
    dead_letter_enabled: bool = True
    dead_letter_max_size: int = 1000
    #: Pending messages older than this are expired by the manager's
    #: monitor (seconds; <= 0 disables).
    stale_message_age: float = 3600.0
    #: Directory of the managers' write-ahead logs (``<name>.wal``); ""
    #: keeps the queues in memory only. With it, pending and in-flight
    #: messages survive a restart (at-least-once redelivery).
    wal_dir: str = ""
    #: Directory shared by a split deployment: the ``gateway`` relays its
    #: drained messages into it, the ``queue-manager`` claims, processes
    #: and acknowledges them (``queueing/spool.py``). "" = one process.
    spool_dir: str = ""


@dataclass
class SchedulerConfig:
    """The endpoint autoscaler (``scheduling/autoscaler.py``); the queue
    managers' monitor reads ``monitor_interval`` too."""
    strategy: str = "dynamic"
    monitor_interval: float = 10.0
    scale_up_threshold: int = 100
    scale_down_threshold: int = 10
    min_endpoints: int = 1
    max_endpoints: int = 10
    cooldown: float = 60.0

    def __post_init__(self) -> None:
        if self.strategy not in VALID_SCHEDULER_STRATEGIES:
            raise ValueError(
                f"scheduler.strategy: unknown scheduler strategy "
                f"{self.strategy!r}; valid: {VALID_SCHEDULER_STRATEGIES}")


@dataclass
class ResourceSchedulerConfig:
    """The resource scheduler over the card's topology
    (``scheduling/resource_scheduler.py``). The JAX package's scale
    thresholds stay in ``_UNPORTED``: its scale check calls actuators
    that no caller passes."""
    allocation_timeout: float = 300.0
    heartbeat_timeout: float = 30.0
    pending_process_interval: float = 1.0
    monitor_interval: float = 5.0


@dataclass
class LoadBalancerConfig:
    """Endpoint selection, session affinity and the health checks
    (``loadbalancer/load_balancer.py``)."""
    strategy: str = "round_robin"
    health_check_interval: float = 30.0
    session_affinity: bool = True
    session_ttl: float = 1800.0

    def __post_init__(self) -> None:
        if self.strategy not in VALID_LB_STRATEGIES:
            raise ValueError(
                f"loadbalancer.strategy: unknown load balancer strategy "
                f"{self.strategy!r}; valid: {VALID_LB_STRATEGIES}")


VALID_CLUSTER_AFFINITY = ("prefix", "session", "none")


@dataclass
class BreakerConfig:
    """A circuit breaker (``loadbalancer/circuit_breaker.py``): trips on
    consecutive faults (deadline misses never count), holds the guarded
    resource out for a jittered exponential backoff, then admits one
    half-open probe."""
    enabled: bool = True
    #: Consecutive failures that trip CLOSED → OPEN.
    failure_threshold: int = 3
    #: First OPEN window in seconds; doubles per consecutive trip.
    base_backoff: float = 1.0
    max_backoff: float = 30.0
    #: ± fraction of the backoff randomized (seeded, so scenarios replay).
    jitter: float = 0.2


@dataclass
class StoreResilienceConfig:
    """The store fault domain (``conversation/resilience.py``): bounded
    deadlines, seeded retry and a store-scoped breaker around the
    conversation store that the state manager and the tiering plane
    share. Off by default: the raw backend is used as it is."""
    enabled: bool = False
    #: Wall deadline of one store operation, in seconds.
    op_timeout_s: float = 0.25
    #: Bounded retries of retryable errors only (sqlite ``database is
    #: locked``, connection resets).
    retries: int = 2
    #: Jittered exponential retry backoff, in seconds, seeded.
    retry_base_backoff_s: float = 0.01
    retry_max_backoff_s: float = 0.2
    retry_jitter: float = 0.2
    #: Consecutive deadline misses that make the store timeout-degraded
    #: (the breaker ignores timeouts, so a slow store needs its own rung).
    timeout_threshold: int = 3
    #: While timeout-degraded, one probe operation per interval; the rest
    #: shed at once.
    probe_interval_s: float = 1.0
    #: Conversation writes the state manager journals while the store is
    #: degraded, replayed on recovery.
    replay_buffer: int = 256
    #: Seed of the retry jitter and of the breaker's backoff jitter.
    seed: int = 0
    breaker: BreakerConfig = field(default_factory=BreakerConfig)


@dataclass
class StoreConfig:
    """The store tier's fault domain."""
    resilience: StoreResilienceConfig = field(
        default_factory=StoreResilienceConfig)

    @property
    def enabled(self) -> bool:
        """The plane is the resilience wrapper."""
        return self.resilience.enabled


@dataclass
class ChaosConfig:
    """Deterministic fault injection (``llmq_tpu_torch/chaos/``).
    ``enabled: false`` (the default) builds no injector: every fault
    point is one attribute check."""
    enabled: bool = False
    #: Seeds every rule's random stream: the same seed, rules and call
    #: sequence fire the same faults.
    seed: int = 0
    #: Rules ``{point, kind, probability, times, after, latency_ms,
    #: match}`` (``chaos/injector.py`` ``FaultRule``). The port's points:
    #: engine.step, engine.hbm_alloc, wal.append, wal.fsync and, with
    #: ``store.resilience`` on, store.get, store.put, store.delete and
    #: store.kv (fnmatch patterns accepted).
    faults: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class ClusterConfig:
    """The replica-set plane (``llmq_tpu_torch/cluster/``): a non-empty
    ``peers`` makes ``serve`` and ``gateway`` route through a
    :class:`~llmq_tpu_torch.cluster.ClusterRouter` over the listed
    replicas (and, in ``serve``, the local engine)."""
    #: Replica base URLs (``http://host:port``): a YAML list, or a
    #: comma-separated string (``LLMQ_CLUSTER_PEERS=http://a:8080,http://b:8080``).
    peers: List[str] = field(default_factory=list)
    #: ``serve``: register this process's engine as an endpoint too.
    include_local: bool = True
    #: Other replicas tried within one dispatch after a replica error
    #: (a deadline miss never fails over: the work may have run).
    failover_retries: int = 2
    #: Endpoint load above which conversation affinity spills.
    spill_load: float = 0.9
    #: "prefix" (placement records, spill by the LB's strategy),
    #: "session" (the LB's session map), or "none".
    affinity: str = "prefix"
    #: Graceful-drain bound for SIGTERM and the admin drain: stop new
    #: work, then wait up to this many seconds for in-flight work.
    drain_timeout: float = 30.0
    #: The HTTP transport's budget for one dispatch to a peer, seconds.
    peer_timeout: float = 120.0
    #: The per-endpoint circuit breaker of the dispatch path.
    breaker: BreakerConfig = field(default_factory=BreakerConfig)

    def __post_init__(self) -> None:
        if isinstance(self.peers, str):
            self.peers = [p for p in
                          (s.strip() for s in self.peers.split(","))
                          if p]
        self.peers = [p.rstrip("/") for p in self.peers]
        if self.affinity not in VALID_CLUSTER_AFFINITY:
            raise ValueError(
                f"cluster.affinity: unknown cluster affinity "
                f"{self.affinity!r}; valid: {VALID_CLUSTER_AFFINITY}")

    @property
    def enabled(self) -> bool:
        return bool(self.peers)


@dataclass
class DisaggConfig:
    """Prefill/decode disaggregation (``llmq_tpu_torch/disagg/``): replicas
    specialise by role and hand conversation KV over through the
    conversation store, used as a cluster-wide KV exchange. ``enabled:
    false`` (the default) builds nothing."""
    enabled: bool = False
    #: "prefill" serves long first turns and publishes each finished
    #: turn's KV; "decode" claims published KV and serves follow-ups;
    #: "unified" does both (and uses the exchange for drain migration).
    role: str = "unified"
    #: A first turn of at least this many (estimated) prompt tokens
    #: routes to a prefill replica, until the resource scheduler has
    #: learned a prefill rate.
    long_prompt_tokens: int = 512
    #: With a learned rate: a first turn whose expected prefill takes at
    #: least this many milliseconds is "long".
    long_prompt_ms: float = 250.0
    #: An exchange entry older than this at claim time is deleted and
    #: the claimer recomputes.
    claim_ttl_s: float = 120.0
    #: Prefill replicas publish each finished turn's KV and release the
    #: local pin.
    publish_on_finish: bool = True
    #: At start, adopt the spilled blobs this replica owns in the store.
    rehydrate_on_start: bool = True
    #: A missed exchange lookup is not repeated for this many seconds.
    miss_ttl_s: float = 5.0

    def __post_init__(self) -> None:
        if self.role not in VALID_DISAGG_ROLES:
            raise ValueError(
                f"unknown disagg role {self.role!r}; "
                f"valid: {VALID_DISAGG_ROLES}")


@dataclass
class LoggingConfig:
    """``utils/logging.py``: "json" or "console" lines on stdout or
    stderr."""
    level: str = "info"
    format: str = "json"
    output: str = "stdout"


@dataclass
class MetricsConfig:
    """``enabled`` turns the engine's families on or off, as the JAX
    package's builder reads it. ``GET /metrics`` on the API port serves
    every family."""
    enabled: bool = True


@dataclass
class ConversationConfig:
    """The conversation service (``conversation/state_manager.py``)."""
    max_conversations: int = 1000
    max_context_length: int = 4096
    max_conversations_per_user: int = 100
    ttl: float = 7 * 24 * 3600.0
    max_idle_time: float = 1800.0
    cleanup_interval: float = 300.0
    persist: bool = True


@dataclass
class OverloadConfig:
    """Overload shedding at the API edge (``api/overload.py``): 503 while
    the engine is down, 429 past the queue backlog limit or when the
    request cannot meet its own deadline, each with ``Retry-After``.
    ``enabled: false`` builds no shedder at all."""
    enabled: bool = True
    #: Total queued messages above which submissions get 429; 0 → 90%
    #: of ``queue.max_queue_size``.
    queue_depth_limit: int = 0
    #: Shed when the estimated wait exceeds the request's timeout × this
    #: factor; <= 0 disables the check.
    deadline_headroom: float = 1.0
    #: Baseline Retry-After seconds.
    retry_after: float = 1.0


@dataclass
class SupervisorConfig:
    """Engine crash supervisor (``engine/supervisor.py``): detects a dead
    engine thread, fails its in-flight requests over to the worker
    retry path and restarts the loop; more than ``max_restarts`` within
    ``restart_window`` seconds and it gives up."""
    enabled: bool = True
    check_interval: float = 0.5
    max_restarts: int = 5
    restart_window: float = 60.0


@dataclass
class ReplicaPoolConfig:
    """The control plane's provision seam (``controlplane/pool.py``):
    where new replicas come from and how they are torn down."""
    #: "none" (never provisions: healing and the ladder only),
    #: "subprocess" (``python -m llmq_tpu_torch serve`` replicas on this
    #: host), "exec" (``provision_cmd`` / ``decommission_cmd``).
    kind: str = "none"
    #: subprocess: replica N listens on ``base_port + N``.
    base_port: int = 8200
    #: subprocess: extra CLI arguments of the replica (a YAML list, or
    #: ``LLMQ_CONTROLPLANE_POOL_ARGS='[--device, cpu]'``).
    args: List[str] = field(default_factory=list)
    #: exec: brings replica N up (``LLMQ_REPLICA_SEQ`` set); its last
    #: stdout line is the replica's URL unless ``url_template`` is set.
    provision_cmd: str = ""
    #: exec: tears replica N down (``LLMQ_REPLICA_SEQ``,
    #: ``LLMQ_REPLICA_ID``, ``LLMQ_REPLICA_URL`` set).
    decommission_cmd: str = ""
    #: exec: the replica URL pattern, e.g. ``http://replica-{seq}:8080``.
    url_template: str = ""
    #: Seconds a provisioned replica's /health has to answer.
    ready_timeout: float = 20.0

    def __post_init__(self) -> None:
        if isinstance(self.args, str):
            self.args = self.args.split()
        if self.kind not in VALID_POOL_KINDS:
            raise ValueError(
                f"unknown replica pool kind {self.kind!r}; "
                f"valid: {VALID_POOL_KINDS}")


def default_rungs() -> List[Dict[str, Any]]:
    """The degradation ladder, mildest rung first. ``headroom_factor``
    scales ``overload.deadline_headroom``, ``backlog_factor`` the backlog
    limit; ``shed_priorities`` rejects those tiers outright,
    ``shed_tenant_weight_below`` tenants whose weight is under it."""
    return [
        {"name": "tighten", "headroom_factor": 0.7,
         "backlog_factor": 0.7},
        {"name": "shed_batch", "headroom_factor": 0.5,
         "backlog_factor": 0.5, "shed_priorities": ["low"]},
        {"name": "shed_low_weight", "headroom_factor": 0.4,
         "backlog_factor": 0.4, "shed_priorities": ["low", "normal"],
         "shed_tenant_weight_below": 1.0},
    ]


@dataclass
class ControlPlaneConfig:
    """The self-healing control plane (``llmq_tpu_torch/controlplane/``):
    a reconcile controller that scales replicas through the pool on SLO
    burn and backlog, replaces dead replicas, and climbs a degradation
    ladder. ``enabled: false`` (the default) builds no controller."""
    enabled: bool = False
    #: Tick period, seconds; <= 0 starts no loop (ticks driven by hand).
    interval: float = 2.0
    min_replicas: int = 1
    max_replicas: int = 8
    #: Scale up when the fast-window burn rate reaches this.
    fast_burn_threshold: float = 14.4
    #: Scale up when the slow-window burn rate reaches this.
    slow_burn_threshold: float = 6.0
    #: Scale up when the backlog exceeds this × the healthy replicas.
    backlog_per_replica: int = 64
    #: Seconds between deliberate scale decisions (healing is exempt).
    cooldown: float = 10.0
    #: Scale and replace actions allowed in any 60 s; <= 0: no limit.
    max_actions_per_minute: int = 6
    #: A recovery slower than this logs an error.
    recovery_budget_s: float = 30.0
    #: Scale down only while (replicas - 1) × the per-replica peak
    #: tokens/s covers the measured load × this.
    scale_down_headroom: float = 1.5
    #: The ladder climbs a rung when the fast burn reaches this, ...
    escalate_burn: float = 1.0
    #: ... and relaxes one after ``relax_after_ticks`` ticks at or below
    #: this.
    relax_burn: float = 0.5
    relax_after_ticks: int = 3
    rungs: List[Dict[str, Any]] = field(default_factory=default_rungs)
    pool: ReplicaPoolConfig = field(default_factory=ReplicaPoolConfig)

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("controlplane.min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                "controlplane.max_replicas must be >= min_replicas")


@dataclass
class SloConfig:
    """SLO targets + error-budget burn rates (``observability/slo.py``).
    Burn rate 1.0 = spending exactly the allowed error budget. FED by the
    flight recorder's metrics flush: with ``observability.enabled`` or
    ``emit_metrics`` off the tracker is force-disabled (and a warning
    logged) rather than reporting 0 burn with no feed."""
    enabled: bool = True
    #: TTFT target (ms) every request is held to; <= 0 disables.
    ttft_p99_ms: float = 2000.0
    #: End-to-end target (ms) for REALTIME-tier requests; <= 0 disables.
    realtime_p99_ms: float = 500.0
    #: Promised success fraction (0.99 → 1 % error budget).
    objective: float = 0.99
    #: Rolling burn-rate windows in seconds (short = fast burn,
    #: long = slow burn).
    windows_s: List[float] = field(default_factory=lambda: [300.0,
                                                            3600.0])


@dataclass
class UsageConfig:
    """Usage plane: per-request resource attribution, goodput and waste
    decomposition (``observability/usage.py``). ``enabled: false`` is a
    hard off-switch: the engine's charge points reduce to one attribute
    check and the ledger records nothing."""
    enabled: bool = True
    #: Distinct tenant ids that get their own metric label before
    #: overflow collapses to "other" (JSON rollups keep exact ids).
    max_tenants: int = 64
    #: Per-conversation rollups kept (LRU).
    max_conversations: int = 1024
    #: Rolling window for the goodput gauge (seconds).
    goodput_window_s: float = 300.0


@dataclass
class CriticalPathConfig:
    """Critical-path plane: per-request latency attribution and boot
    decomposition (``observability/critical_path.py``). ``enabled:
    false`` is a hard off-switch: no extra marks are stamped and the
    scrape-time join is skipped. FED by the flight recorder's metrics
    flush: force-disabled (with a warning) when the recorder or
    ``emit_metrics`` is off."""
    enabled: bool = True
    #: Finished per-request decompositions kept for the
    #: ``GET /api/v1/analysis/critical-path`` recent list.
    recent_capacity: int = 256
    #: Boot records kept in the boot registry (LRU by id).
    boot_capacity: int = 64


@dataclass
class ObservabilityConfig:
    """Request-lifecycle trace plane (``observability/``). ``enabled:
    false`` is a hard off-switch: no events are recorded anywhere and
    every ``record`` call returns after one attribute check."""
    enabled: bool = True
    #: Most recent request timelines kept in the flight-recorder ring.
    recorder_capacity: int = 1024
    #: Finished timelines retained separately because they breached the
    #: SLA or failed (survive ring eviction).
    slow_capacity: int = 256
    #: End-to-end latency above which a finished request counts as an
    #: SLA breach and is retained in the slow buffer; <= 0 disables
    #: breach tracking (failures are still retained).
    sla_ms: float = 5000.0
    #: Feed the stage histograms on each terminal event.
    emit_metrics: bool = True
    #: Include this host's recorded events for the request in the
    #: ``POST /api/v1/generate`` response.
    propagate_trace: bool = True
    slo: SloConfig = field(default_factory=SloConfig)
    usage: UsageConfig = field(default_factory=UsageConfig)
    critical_path: CriticalPathConfig = field(
        default_factory=CriticalPathConfig)


@dataclass
class TenantClassConfig:
    """One tenant class: fairness weight and quota envelope (the
    ``tenancy`` plane). Used for the named entries of ``tenancy.tenants``
    and as the default class of every unlisted tenant."""
    #: Weighted-fair-queueing weight: under contention a tenant's token
    #: share within each priority level converges to
    #: ``weight / sum(weights of active tenants)``.
    weight: float = 1.0
    #: Sustained token admission rate (prompt + expected completion
    #: tokens per second) at the API edge; <= 0: unlimited.
    token_rate: float = 0.0
    #: Token-bucket burst capacity; <= 0: one second of ``token_rate``.
    burst_tokens: float = 0.0
    #: Concurrent dispatched (popped, unfinished) messages; <= 0:
    #: unlimited. The fair dequeue defers a capped tenant's queued work
    #: rather than rejecting it.
    max_inflight: int = 0
    #: Queued messages across the manager's tier queues; <= 0:
    #: unlimited. Past it the overload seam answers 429.
    max_queue_depth: int = 0

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError(
                f"tenancy weight must be > 0 (got {self.weight})")


@dataclass
class TenancyConfig:
    """Tenancy plane (``llmq_tpu_torch/tenancy/``): weighted fair
    dequeue, per-tenant quotas and burst isolation over
    ``Message.tenant_id``. ``enabled: false`` (the default) builds no
    fair scheduler, and the dequeue order is FIFO within priority."""
    enabled: bool = False
    #: tenant id → TenantClassConfig fields; unlisted tenants use
    #: ``default``. Each entry is validated as those fields.
    tenants: Dict[str, Any] = field(default_factory=dict)
    #: The class of every tenant not listed in ``tenants``.
    default: TenantClassConfig = field(default_factory=TenantClassConfig)
    #: Rolling window (seconds) of the achieved-share gauge.
    share_window_s: float = 60.0

    def __post_init__(self) -> None:
        if not isinstance(self.tenants, dict):
            raise ValueError("config key tenancy.tenants must be a mapping")
        for tid, raw in self.tenants.items():
            if isinstance(raw, TenantClassConfig):
                continue
            if not isinstance(raw, dict):
                raise ValueError(
                    f"config key tenancy.tenants.{tid} must be a mapping")
            names = {f.name for f in dataclasses.fields(TenantClassConfig)}
            for key in raw:
                if str(key).replace("-", "_") not in names:
                    raise ValueError(
                        f"unknown config key: tenancy.tenants.{tid}.{key}")
            TenantClassConfig(**{str(k).replace("-", "_"): v
                                 for k, v in raw.items()})


@dataclass
class ScenariosConfig:
    """The scenario engine (``llmq_tpu_torch/scenarios/``): compiles the
    declarative workload specs (YAML files under ``dir``) into
    closed-loop traffic against the engine and scores each run with the
    usage plane's goodput. ``enabled: false`` (the default) is the
    off-switch of a bare ``scenarios`` command; the package is a tool,
    never imported by the serving path."""
    enabled: bool = False
    #: Directory of the named scenario specs (the shipped seven live in
    #: configs/scenarios/); a relative one missing from the working
    #: directory anchors at the repository root.
    dir: str = "configs/scenarios"
    #: Scenario names a ``scenarios`` command runs when it is given none
    #: ([] with ``enabled``: every shipped one).
    run: List[str] = field(default_factory=list)
    #: Multiplier of arrival rates and conversation caps: the same named
    #: spec serves as a smoke run (0.05) and a full soak (1.0).
    scale: float = 1.0
    #: Where ``SCENARIO_<name>.json`` reports are written.
    out_dir: str = "."
    #: Write the per-run JSON report (the report dict is returned
    #: either way).
    emit_json: bool = True
    #: Seed of the specs that do not pin one.
    default_seed: int = 0

    def __post_init__(self) -> None:
        if isinstance(self.run, str):
            # ``LLMQ_SCENARIOS_RUN=a,b``: the comma-separated form.
            self.run = [n.strip() for n in self.run.split(",") if n.strip()]


@dataclass
class ModelConfig:
    name: str = "llama3-8b"      # llama3-tiny | llama3-1b | llama3-8b | llama3-70b
    #: "": random weights from seed 0. A directory ending in
    #: ``.safetensors.d``: a Hugging Face Llama checkpoint (its
    #: ``*.safetensors`` files), imported by ``models/checkpoint.py``.
    #: Any other path: a checkpoint written by ``save_checkpoint``.
    checkpoint_path: str = ""
    #: "": the byte tokenizer. A local Hugging Face tokenizer directory
    #: needs the ``transformers`` package.
    tokenizer_path: str = ""
    #: Safetensors re-exports of Meta-original (interleaved rotary)
    #: checkpoints need the q/k permutation; HF-native ones must not.
    meta_rope_layout: bool = False
    max_seq_len: int = 2048
    vocab_size: int = 0          # 0 → model default
    #: "" | "int8": w8a8 weights (per-channel int8, per-row activations).
    quantization: str = ""
    #: "" | "int8": int8 KV pools with per-(token, KV head) bf16 scales.
    kv_quantization: str = ""


@dataclass
class MixedBatchConfig:
    """Token-budget mixed prefill+decode batching. While decode rows are
    active, the engine fuses up to ``prefill_token_budget`` tokens of
    pending prefill slices into the first step of the decode chunk, so
    a decode row waits for at most that many prefill tokens instead of
    a whole prefill bucket. ``enabled: false`` keeps the unfused
    scheduling (a prefill bucket, then a decode chunk)."""
    enabled: bool = True
    #: Max prefill tokens fused into one mixed step, across all slices.
    prefill_token_budget: int = 128
    #: Prefill sequences whose next slice can ride one mixed step; each
    #: slice is ``prefill_token_budget // max_slices`` tokens wide.
    max_slices: int = 2

    def __post_init__(self) -> None:
        if self.prefill_token_budget < 8:
            raise ValueError(
                "mixed_batch.prefill_token_budget must be >= 8 "
                f"(got {self.prefill_token_budget})")
        if not 1 <= self.max_slices <= 16:
            raise ValueError(
                f"mixed_batch.max_slices must be in [1, 16] "
                f"(got {self.max_slices})")

    @property
    def slice_tokens(self) -> int:
        """Width of one slice in bucket mode."""
        return max(1, self.prefill_token_budget // self.max_slices)


@dataclass
class RaggedAttentionConfig:
    """Ragged mixed attention. When enabled, the mixed step packs its
    prefill slices into ONE token buffer with per-slice (offset,
    length, start) descriptors, and each layer's attention for the
    decode rows and every packed slice token is one kernel launch. All
    prefill then runs through that ragged step (no bucket program
    runs), and slices pack against the token budget alone. ``enabled:
    false`` keeps the bucket path."""
    enabled: bool = False
    #: Packed prefill-token capacity of one ragged step (one slice may
    #: take all of it). 0 → ``mixed_batch.prefill_token_budget``.
    prefill_token_capacity: int = 0
    #: Max slices per ragged step. 0 → ``mixed_batch.max_slices``.
    max_slices: int = 0

    def __post_init__(self) -> None:
        if self.prefill_token_capacity < 0:
            raise ValueError(
                "ragged_attention.prefill_token_capacity must be >= 0")
        if not 0 <= self.max_slices <= 16:
            raise ValueError(
                f"ragged_attention.max_slices must be in [0, 16] "
                f"(got {self.max_slices})")


@dataclass
class AsyncPipelineConfig:
    """The async decode pipeline: the engine keeps up to ``depth``
    dispatched decode/mixed chunks in flight, each dispatched from the
    previous chunk's device-carried end state before that chunk's tokens
    are fetched; the fetches run on dedicated lanes and the request-facing
    completions on a small pool. ``enabled: false`` keeps one chunk in
    flight plus at most one carried dispatch a step (depth 2) with every
    completion inline on the engine thread, as the JAX package's
    off-switch does."""
    enabled: bool = True
    #: Dispatched-but-unreconciled chunks the engine may keep in flight.
    #: 2 = double buffering; 1 reconciles every chunk before the next.
    depth: int = 2
    #: Completion threads. Jobs for one request always land on the same
    #: thread, so its tokens always precede its finish.
    completion_workers: int = 1

    def __post_init__(self) -> None:
        if not 1 <= self.depth <= 4:
            raise ValueError(
                f"async_pipeline.depth must be in [1, 4] "
                f"(got {self.depth})")
        if not 1 <= self.completion_workers <= 8:
            raise ValueError(
                f"async_pipeline.completion_workers must be in [1, 8] "
                f"(got {self.completion_workers})")


VALID_PREFIX_EVICTION = ("lru", "fifo")


@dataclass
class PrefixCacheConfig:
    """Radix-tree prefix KV cache (``prefixcache/radix.py``): finished
    sequences publish their page-aligned KV prefix, and an admission
    that shares one (a shared system prompt, a conversation's earlier
    turn) adopts the cached pages by reference count instead of
    prefilling them. ``enabled: false`` is a hard off-switch."""
    enabled: bool = True
    #: Cap on pages the tree may hold; 0 = bounded only by the KV pool
    #: (pool pressure evicts zero-ref leaves on demand).
    max_cached_pages: int = 0
    #: "lru" (default) or "fifo": which zero-ref leaf goes first.
    eviction: str = "lru"

    def __post_init__(self) -> None:
        if self.eviction not in VALID_PREFIX_EVICTION:
            raise ValueError(
                f"unknown prefix-cache eviction policy {self.eviction!r}; "
                f"valid: {VALID_PREFIX_EVICTION}")


@dataclass
class SpeculationConfig:
    """Speculative decoding (``speculation/``, the JAX package's
    ``SpeculationConfig``): the n-gram drafter proposes up to
    ``draft_k`` tokens a row out of the request's own history, the
    executor verifies the whole window in one device program
    (teacher-forced decode steps), and the engine commits the accepted
    run plus the correction per fetch. ``enabled: false`` (the default)
    is a hard off-switch: no drafter, no verify program, and scheduling
    and outputs exactly as without the plane."""
    enabled: bool = False
    #: Draft tokens a row a window at most; the verify window's static
    #: width is draft_k + 1 (the drafts and the correction).
    draft_k: int = 4
    #: Longest suffix n-gram the drafter matches (it backs off to shorter
    #: ones down to 1).
    ngram_max: int = 3
    #: Device accept: sampling, the draft comparison, the EOS freeze and
    #: n_commit stay in the device program. ``false`` runs every window
    #: step and computes the accept rule on the host from the fetched
    #: tokens; the committed streams are the same either way.
    device_sampling: bool = True

    def __post_init__(self) -> None:
        if not 1 <= self.draft_k <= 16:
            raise ValueError(
                f"executor.speculation.draft_k must be in [1, 16] "
                f"(got {self.draft_k})")
        if self.ngram_max < 1:
            raise ValueError(
                f"executor.speculation.ngram_max must be >= 1 "
                f"(got {self.ngram_max})")


@dataclass
class KVTieringConfig:
    """Tiered KV plane (``tiering/``, the JAX package's
    ``KVTieringConfig``): HBM → pinned host memory → conversation store
    under the conversation pins. A reclaimed pin's pages are copied to
    preallocated host buffers instead of dying with the pin, promoted
    back at the conversation's re-arrival, and the coldest host entries
    spill to the store; recompute from the remembered token stream is
    the last fallback. ``enabled: false`` (the default) is a hard
    off-switch: no plane, no worker thread, HBM-only behaviour."""
    enabled: bool = False
    #: Host-memory budget for demoted page payloads (MiB): one arena,
    #: pinned on the card, cut into page-sized buffers once.
    host_capacity_mb: int = 256
    #: Cap on conversations resident in the host tier; the coldest
    #: spill to the store past it.
    host_max_conversations: int = 4096
    #: Spill the coldest host entries to the conversation store (its
    #: KV-payload seam). Off: past capacity an entry keeps its token
    #: stream only, and its next turn recomputes.
    store_spill: bool = True
    #: Seconds a promotion may wait on an in-flight extract or store
    #: load before admission falls back to recompute.
    promote_timeout_s: float = 5.0
    #: "saved_rate" ranks every eviction (pin reclaim, host→store spill)
    #: by the usage ledger's saved-prefill rate of the conversation, with
    #: recency as the tiebreak (and the whole key while the ledger has
    #: no signal); "lru" is recency alone.
    eviction_policy: str = "saved_rate"

    def __post_init__(self) -> None:
        if self.host_capacity_mb < 0:
            raise ValueError("kv_tiering.host_capacity_mb must be >= 0")
        if self.host_max_conversations < 1:
            raise ValueError(
                "kv_tiering.host_max_conversations must be >= 1")
        if self.promote_timeout_s <= 0:
            raise ValueError("kv_tiering.promote_timeout_s must be > 0")
        if self.eviction_policy not in ("lru", "saved_rate"):
            raise ValueError(
                f"kv_tiering.eviction_policy must be 'lru' or "
                f"'saved_rate' (got {self.eviction_policy!r})")


@dataclass
class MeshConfig:
    """Intra-replica mesh serving (``llmq_tpu/core/config.py``
    ``MeshConfig``): one replica serves the model over ``dp × tp`` ranks,
    one process per rank (``parallel/``, ``TorchExecutor(mesh=...)``).
    ``enabled: false`` (the default) is the hard off-switch: no process
    group is read and the executor is the single-card one. The legacy
    ``tpu.mesh_shape`` builds a mesh when this block is off."""
    enabled: bool = False
    #: Named axis sizes, e.g. {"tp": 2}. They multiply to the world size;
    #: one axis may be -1 (inferred).
    shape: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for ax, n in (self.shape or {}).items():
            if ax not in ("dp", "tp"):
                raise ValueError(
                    f"executor.mesh.shape axis must be 'dp' or 'tp' "
                    f"(got {ax!r})")
            if not isinstance(n, int) or (n < 1 and n != -1):
                raise ValueError(
                    f"executor.mesh.shape[{ax!r}] must be a positive "
                    f"int or -1 (got {n!r})")
        if self.enabled and not self.shape:
            raise ValueError("executor.mesh.enabled requires a shape")


@dataclass
class TPUConfig:
    """The JAX package's topology block: ``mesh_shape`` is the legacy
    alias of ``executor.mesh`` (read when that block is off). Its
    ``platform`` and ``compilation_cache_dir`` (XLA's cache: the port
    captures its CUDA graphs in each process) stay at their defaults."""
    mesh_shape: Dict[str, int] = field(default_factory=dict)


@dataclass
class ExecutorConfig:
    #: "torch", the port's executor, or "echo", the host-only executor
    #: that echoes the prompt (no model, no tensor); the JAX package's
    #: "jax" raises.
    backend: str = "torch"
    max_batch_size: int = 8             # decode slots
    page_size: int = 16                 # tokens per KV page
    kv_pages: int = 512
    prefill_buckets: List[int] = field(
        default_factory=lambda: [128, 512, 2048])
    decode_chunk: int = 16
    #: Prompts' chunks per admission-wave prefill program (the JAX
    #: package's default); at most ``max_batch_size``.
    prefill_batch: int = 4
    max_decode_steps: int = 256
    preemption: bool = True
    kv_pin_ttl: float = 600.0           # per-conversation KV pin TTL
    mixed_batch: MixedBatchConfig = field(default_factory=MixedBatchConfig)
    ragged_attention: RaggedAttentionConfig = field(
        default_factory=RaggedAttentionConfig)
    async_pipeline: AsyncPipelineConfig = field(
        default_factory=AsyncPipelineConfig)
    prefix_cache: PrefixCacheConfig = field(
        default_factory=PrefixCacheConfig)
    speculation: SpeculationConfig = field(
        default_factory=SpeculationConfig)
    kv_tiering: KVTieringConfig = field(default_factory=KVTieringConfig)
    supervisor: SupervisorConfig = field(default_factory=SupervisorConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def __post_init__(self) -> None:
        if self.backend not in VALID_BACKENDS:
            raise ValueError(
                f"config key executor.backend={self.backend!r} is not ported "
                f"yet: this package's executors are 'torch' and 'echo'")


@dataclass
class Config:
    server: ServerConfig = field(default_factory=ServerConfig)
    persistence: PersistenceConfig = field(default_factory=PersistenceConfig)
    queue: QueueConfig = field(default_factory=QueueConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    resource_scheduler: ResourceSchedulerConfig = field(
        default_factory=ResourceSchedulerConfig)
    loadbalancer: LoadBalancerConfig = field(
        default_factory=LoadBalancerConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    disagg: DisaggConfig = field(default_factory=DisaggConfig)
    conversation: ConversationConfig = field(
        default_factory=ConversationConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    tenancy: TenancyConfig = field(default_factory=TenancyConfig)
    scenarios: ScenariosConfig = field(default_factory=ScenariosConfig)
    controlplane: ControlPlaneConfig = field(
        default_factory=ControlPlaneConfig)
    executor: ExecutorConfig = field(default_factory=ExecutorConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)
    #: Where the model runs. "cuda" raises without a GPU; only an
    #: explicit "cpu" runs on the host (tests).
    device: str = "cuda"


def resolve_device(device: str = "cuda"):
    """``torch.device`` for an entry point. A CUDA device without a GPU
    raises: nothing falls back to the CPU unless the caller asked for
    ``"cpu"``."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the host")
    return dev




#: The JAX package's keys of the planes the port does not have yet, at
#: the JAX package's defaults. A non-empty dict is a block; every other
#: value (lists and the empty dicts too) is one key's default.
#: A tuple holds every value accepted: the JAX package's default and its
#: canonical file's, where the two differ.
_UNPORTED: Dict[str, Any] = {
    "server": {"read_timeout": 30.0, "write_timeout": 30.0},
    "metrics": {"port": 9090, "path": "/metrics"},
    # Nothing reads it, in either package.
    "loadbalancer": {"max_retries": 3},
    # Read only by the JAX resource scheduler's scale check, whose
    # actuators no caller passes.
    "resource_scheduler": {"scale_up_load": 0.8, "scale_down_load": 0.2,
                           "scale_cooldown": 120.0},
    # Neither package's builder reads it: the model serves bf16.
    "model": {"dtype": "bfloat16"},
    # Every executor key is ported (the mesh since the mesh executor).
    "executor": {},
    # XLA's: the port has no compilation cache and no platform choice.
    "tpu": {"platform": "", "compilation_cache_dir": ""},
}


def _is_block(spec: Any) -> bool:
    return isinstance(spec, dict) and bool(spec)


def _accepts(spec: Any, value: Any) -> bool:
    """Whether ``value`` is the unported key's default (or one of them)."""
    return value in spec if isinstance(spec, tuple) else value == spec


def _not_ported(path: str, value: Any, spec: Any) -> ValueError:
    return ValueError(
        f"config key {path}={value!r} is not ported yet: this package "
        f"accepts only the JAX package's default "
        f"{' or '.join(map(repr, spec)) if isinstance(spec, tuple) else repr(spec)}")


def _check_unported(path: str, value: Any, spec: Any) -> None:
    """Accept ``value`` for the unported key or block ``path`` only at
    the JAX package's default, or anywhere inside a block whose
    ``enabled`` is false; raise otherwise."""
    if not _is_block(spec):
        if not _accepts(spec, value):
            raise _not_ported(path, value, spec)
        return
    if not isinstance(value, dict):
        raise ValueError(f"config key {path} must be a mapping")
    for key in value:
        if key.replace("-", "_") not in spec:
            raise ValueError(f"unknown config key: {path}.{key}")
    off = value.get("enabled", spec.get("enabled")) is False
    for key, v in value.items():
        sub = spec[key.replace("-", "_")]
        if off and not _is_block(sub):
            continue
        _check_unported(f"{path}.{key}", v, sub)


def _merge(obj: Any, data: Any, path: str = "",
           unported: Optional[Dict[str, Any]] = None) -> Any:
    """Apply a mapping onto a dataclass tree, block by block, and
    validate each block again after its keys are set."""
    if not isinstance(data, dict):
        raise ValueError(f"config block {path.rstrip('.') or '(root)'} "
                         f"must be a mapping, got {data!r}")
    unported = _UNPORTED if unported is None else unported
    fields = {f.name for f in dataclasses.fields(obj)}
    for key, value in data.items():
        k = key.replace("-", "_")
        if k not in fields:
            if k not in unported:
                raise ValueError(f"unknown config key: {path}{key}")
            _check_unported(path + key, value, unported[k])
            continue
        current = getattr(obj, k)
        if dataclasses.is_dataclass(current):
            _merge(current, value, path + key + ".",
                   unported.get(k) if _is_block(unported.get(k)) else {})
        elif k == "levels" and isinstance(value, list):
            obj.levels = [_merge_level(lv, path + "levels.") for lv in value]
        else:
            setattr(obj, k, value)
    # __post_init__ does not rerun on setattr, and a file must not
    # bypass it.
    post = getattr(obj, "__post_init__", None)
    if post is not None:
        post()
    return obj


def _merge_level(data: Any, path: str) -> QueueLevelConfig:
    """One tier of ``queue.levels``; its ``max_concurrent`` is accepted
    only at the JAX package's default for that tier."""
    if isinstance(data, dict) and "max_concurrent" in data:
        data = dict(data)
        got = data.pop("max_concurrent")
        prio = int(data.get("priority", Priority.NORMAL))
        spec = (_LEVEL_MAX_CONCURRENT_DEFAULT,
                _LEVEL_MAX_CONCURRENT.get(prio, _LEVEL_MAX_CONCURRENT_DEFAULT))
        if not _accepts(spec, got):
            raise _not_ported(path + "max_concurrent", got, spec)
    return _merge(QueueLevelConfig(), data, path, {})


def _unported_env_keys(spec: Dict[str, Any], pre: str = ""
                       ) -> Dict[str, Tuple[str, Any]]:
    """``LLMQ_*`` suffix → (dotted key, default) of every unported key."""
    out: Dict[str, Tuple[str, Any]] = {}
    for k, v in spec.items():
        path = pre + k
        if v == {} and not pre:
            continue        # a block with no unported key left
        if _is_block(v):
            out.update(_unported_env_keys(v, path + "."))
        else:
            out[path.replace(".", "_").upper()] = (path, v)
    return out


def _coerce(raw: str, current: Any, strings: bool = False,
            structured: bool = False) -> Any:
    if isinstance(current, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, dict):
        # A YAML mapping: ``LLMQ_EXECUTOR_MESH_SHAPE='{tp: 2}'``.
        return read_yaml_text(raw) or {}
    if isinstance(current, list):
        if structured or (strings and raw.strip().startswith("[")):
            # A YAML list: ``[--device, cpu]``, or rungs as mappings.
            return read_yaml_text(raw)
        if strings:
            # A list of strings (``LLMQ_CLUSTER_PEERS``): its block's
            # __post_init__ splits the comma-separated form.
            return raw
        conv = (float if current and all(isinstance(x, float)
                                          for x in current) else int)
        return [conv(x) for x in raw.replace(",", " ").split()]
    return raw


def apply_env(cfg: Config, environ: Optional[Mapping[str, str]] = None
              ) -> None:
    """``LLMQ_EXECUTOR_KV_PAGES=256`` overrides ``executor.kv_pages``:
    the name after ``LLMQ_`` is walked greedily, longest field name
    first, and the block it lands in is validated again. A variable that
    names an unported key raises unless it holds that key's default;
    other unknown names are ignored (they may belong to other tools)."""
    env = os.environ if environ is None else environ
    unported = _unported_env_keys(_UNPORTED)
    touched: List[Any] = []
    for key, raw in env.items():
        if not key.startswith("LLMQ_"):
            continue
        name = key[len("LLMQ_"):]
        if name in unported:
            path, default = unported[name]
            if isinstance(default, (list, dict)):
                # The unported list and mapping keys default to empty.
                value = default if raw.strip() in ("", "[]", "{}") else raw
            else:
                value = _coerce(raw, default[0] if isinstance(default, tuple)
                                else default)
            if not _accepts(default, value):
                raise ValueError(f"{key}={raw!r}: "
                                 f"{_not_ported(path, value, default)}")
            continue
        parts = [p.lower() for p in name.split("_")]
        obj: Any = cfg
        i = 0
        while i < len(parts) and dataclasses.is_dataclass(obj):
            names = {f.name for f in dataclasses.fields(obj)}
            for j in range(len(parts), i, -1):
                cand = "_".join(parts[i:j])
                if cand in names:
                    if j == len(parts):
                        hint = typing.get_type_hints(type(obj)).get(cand)
                        setattr(obj, cand,
                                _coerce(raw, getattr(obj, cand),
                                        hint == List[str],
                                        hint == List[Dict[str, Any]]))
                        # Re-validate once every variable is applied
                        # (a block may take two: a switch and its shape):
                        # __post_init__ does not rerun on setattr, and an
                        # override must not bypass it.
                        if all(o is not obj for o in touched):
                            touched.append(obj)
                    else:
                        obj = getattr(obj, cand)
                    i = j
                    break
            else:
                break
    for obj in touched:
        post = getattr(obj, "__post_init__", None)
        if post is not None:
            post()


def read_yaml_text(text: str) -> Any:
    """``yaml.safe_load`` of a string (PyYAML imported here)."""
    import yaml

    return yaml.safe_load(text)


def read_yaml(path: str) -> Any:
    """The parsed YAML document at ``path`` (``yaml.safe_load``; PyYAML
    is imported here, so only a file load needs it)."""
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def _refuse_a_jax_config(found: str, data: Any) -> None:
    """A file the search found may not choose a backend other than
    "torch": "echo" would serve no model on a machine with a card (the
    JAX package's own ``configs/config.yaml`` selects it), so it runs only
    when the caller names it (``--config``, ``LLMQ_CONFIG``,
    ``LLMQ_EXECUTOR_BACKEND``, or the dataclass)."""
    ex = data.get("executor") if isinstance(data, dict) else None
    backend = ex.get("backend") if isinstance(ex, dict) else None
    if backend is not None and backend != "torch":
        raise ValueError(
            f"{found}, found by the config search, configures the JAX "
            f"package (executor.backend: {backend}); pass --config with a "
            f"file for this package (executor.backend: torch), or set "
            f"LLMQ_CONFIG to one (a named file, or "
            f"LLMQ_EXECUTOR_BACKEND=echo, selects the echo backend)")


#: Files :func:`load_config` reads when neither ``path`` nor
#: ``LLMQ_CONFIG`` names one: the first that exists.
SEARCH_PATHS = ("config.yaml", os.path.join("configs", "config.yaml"))


def load_config(path: Optional[str] = None, env: bool = True,
                environ: Optional[Mapping[str, str]] = None) -> Config:
    """Defaults, then a YAML file, then ``LLMQ_*`` environment overrides
    (``environ`` in place of ``os.environ``). The file is ``path``, else
    ``LLMQ_CONFIG``, else the first of :data:`SEARCH_PATHS` that exists
    (none: defaults only). A file named by ``path`` or ``LLMQ_CONFIG``
    that does not exist raises; so does a file found by the search that
    selects a backend other than "torch" (the JAX package's own
    ``configs/config.yaml`` in the repository's root selects "echo"),
    with the remedy. A named file may select "echo"."""
    cfg = Config()
    envmap = os.environ if environ is None else environ
    if not path:
        path = envmap.get("LLMQ_CONFIG") or None
    candidates = [path] if path else list(SEARCH_PATHS)
    for cand in candidates:
        if os.path.exists(cand):
            data = read_yaml(cand) or {}
            if not path:
                _refuse_a_jax_config(cand, data)
            _merge(cfg, data)
            break
    else:
        if path:
            raise FileNotFoundError(f"config file not found: {path}")
    if env:
        apply_env(cfg, envmap)
    return cfg
