"""Typed configuration for the port: dataclass defaults, then a YAML
file, then ``LLMQ_*`` environment overrides, then CLI flags.

A copy of ``llmq_tpu/core/config.py`` holding what the port's planes
read, with the JAX package's defaults. :func:`load_config` reads the same
files as the JAX package's (``configs/config.yaml`` among them). A key of
a plane the port does not have yet (the WAL and spool directories, the
cluster, disaggregation, store, chaos, control-plane, tenancy and
scenario planes, KV tiering, speculation, the mesh, the TPU
block), or one that nothing here reads (the autoscaler's and the resource
scheduler's scale thresholds, endpoint selection and session affinity,
the server's read and write timeouts, a tier's ``max_concurrent``, the
metrics port and path) is accepted only at the JAX package's default, or inside a block
whose ``enabled`` is false; any other value raises, naming the key. An
unknown key raises too: nothing in a file is silently ignored.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from llmq_tpu_torch.core.types import Priority

#: The port's one executor backend (the JAX package's are "echo" and
#: "jax").
VALID_BACKENDS = ("torch",)


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


@dataclass
class SchedulerConfig:
    """Only the queue monitor's period is read in the port: the
    autoscaler's keys wait for the slice that gives it an actuator."""
    monitor_interval: float = 10.0


@dataclass
class ResourceSchedulerConfig:
    """The resource scheduler over the card's topology
    (``scheduling/resource_scheduler.py``); its scale thresholds wait
    with the autoscaler."""
    allocation_timeout: float = 300.0
    heartbeat_timeout: float = 30.0
    pending_process_interval: float = 1.0
    monitor_interval: float = 5.0


@dataclass
class LoadBalancerConfig:
    """The endpoint registry's health checks
    (``loadbalancer/load_balancer.py``); endpoint selection and session
    affinity wait for the router that calls them."""
    health_check_interval: float = 30.0


@dataclass
class ClusterConfig:
    """Of the JAX package's cluster block only the drain bound, which
    ``App.drain`` reads; the replica-set plane itself is not ported."""
    #: Graceful-drain bound for SIGTERM and the admin drain: stop new
    #: work, then wait up to this many seconds for in-flight work.
    drain_timeout: float = 30.0


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
class ModelConfig:
    name: str = "llama3-8b"      # llama3-tiny | llama3-1b | llama3-8b | llama3-70b
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
class ExecutorConfig:
    #: "torch", the port's executor (the JAX package's "echo" and "jax"
    #: raise).
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
    supervisor: SupervisorConfig = field(default_factory=SupervisorConfig)

    def __post_init__(self) -> None:
        if self.backend not in VALID_BACKENDS:
            raise ValueError(
                f"config key executor.backend={self.backend!r} is not ported "
                f"yet: this package's executor is 'torch'")


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
    conversation: ConversationConfig = field(
        default_factory=ConversationConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    executor: ExecutorConfig = field(default_factory=ExecutorConfig)
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
    "queue": {"wal_dir": "", "spool_dir": ""},
    "scheduler": {"strategy": "dynamic", "scale_up_threshold": 100,
                  "scale_down_threshold": 10, "min_endpoints": 1,
                  "max_endpoints": 10, "cooldown": 60.0},
    "resource_scheduler": {"scale_up_load": 0.8, "scale_down_load": 0.2,
                           "scale_cooldown": 120.0},
    "loadbalancer": {"strategy": ("round_robin", "adaptive_load"),
                     "max_retries": 3, "session_affinity": True,
                     "session_ttl": 1800.0},
    "metrics": {"port": 9090, "path": "/metrics"},
    "cluster": {
        "peers": [], "include_local": True, "failover_retries": 2,
        "spill_load": 0.9, "affinity": "prefix", "peer_timeout": 120.0,
        "breaker": {"enabled": True, "failure_threshold": 3,
                    "base_backoff": 1.0, "max_backoff": 30.0,
                    "jitter": 0.2}},
    "disagg": {
        "enabled": False, "role": "unified", "long_prompt_tokens": 512,
        "long_prompt_ms": 250.0, "claim_ttl_s": 120.0,
        "publish_on_finish": True, "rehydrate_on_start": True,
        "miss_ttl_s": 5.0},
    "store": {"resilience": {
        "enabled": False, "op_timeout_s": 0.25, "retries": 2,
        "retry_base_backoff_s": 0.01, "retry_max_backoff_s": 0.2,
        "retry_jitter": 0.2, "timeout_threshold": 3,
        "probe_interval_s": 1.0, "replay_buffer": 256, "seed": 0,
        "breaker": {"enabled": True, "failure_threshold": 3,
                    "base_backoff": 1.0, "max_backoff": 30.0,
                    "jitter": 0.2}}},
    "chaos": {"enabled": False, "seed": 0, "faults": []},
    "controlplane": {
        "enabled": False, "interval": 2.0, "min_replicas": 1,
        "max_replicas": 8, "fast_burn_threshold": 14.4,
        "slow_burn_threshold": 6.0, "backlog_per_replica": 64,
        "cooldown": 10.0, "max_actions_per_minute": 6,
        "recovery_budget_s": 30.0, "scale_down_headroom": 1.5,
        "escalate_burn": 1.0, "relax_burn": 0.5, "relax_after_ticks": 3,
        "rungs": [
            {"name": "tighten", "headroom_factor": 0.7,
             "backlog_factor": 0.7},
            {"name": "shed_batch", "headroom_factor": 0.5,
             "backlog_factor": 0.5, "shed_priorities": ["low"]},
            {"name": "shed_low_weight", "headroom_factor": 0.4,
             "backlog_factor": 0.4, "shed_priorities": ["low", "normal"],
             "shed_tenant_weight_below": 1.0}],
        "pool": {"kind": "none", "base_port": 8200, "args": [],
                 "provision_cmd": "", "decommission_cmd": "",
                 "url_template": "", "ready_timeout": 20.0}},
    "tenancy": {
        "enabled": False, "tenants": {},
        "default": {"weight": 1.0, "token_rate": 0.0, "burst_tokens": 0.0,
                    "max_inflight": 0, "max_queue_depth": 0},
        "share_window_s": 60.0},
    "scenarios": {
        "enabled": False, "dir": "configs/scenarios", "run": [],
        "scale": 1.0, "out_dir": ".", "emit_json": True,
        "default_seed": 0},
    "model": {"checkpoint_path": "", "tokenizer_path": "",
              "meta_rope_layout": False, "dtype": "bfloat16"},
    "executor": {
        "kv_tiering": {"enabled": False, "host_capacity_mb": 256,
                       "host_max_conversations": 4096,
                       "store_spill": True, "promote_timeout_s": 5.0,
                       "eviction_policy": "saved_rate"},
        "speculation": {"enabled": False, "draft_k": 4, "ngram_max": 3,
                        "device_sampling": True},
        "mesh": {"enabled": False, "shape": {}}},
    "tpu": {"mesh_shape": {}, "platform": "", "compilation_cache_dir": ""},
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
        if _is_block(v):
            out.update(_unported_env_keys(v, path + "."))
        else:
            out[path.replace(".", "_").upper()] = (path, v)
    return out


def _coerce(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, list):
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
                        setattr(obj, cand, _coerce(raw, getattr(obj, cand)))
                        # Re-validate: __post_init__ does not rerun on
                        # setattr, and an override must not bypass it.
                        post = getattr(obj, "__post_init__", None)
                        if post is not None:
                            post()
                    else:
                        obj = getattr(obj, cand)
                    i = j
                    break
            else:
                break


def read_yaml(path: str) -> Any:
    """The parsed YAML document at ``path`` (``yaml.safe_load``; PyYAML
    is imported here, so only a file load needs it)."""
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def _refuse_a_jax_config(found: str, data: Any) -> None:
    ex = data.get("executor") if isinstance(data, dict) else None
    backend = ex.get("backend") if isinstance(ex, dict) else None
    if backend is not None and backend not in VALID_BACKENDS:
        raise ValueError(
            f"{found}, found by the config search, configures the JAX "
            f"package (executor.backend: {backend}); pass --config with a "
            f"file for this package (executor.backend: torch), or set "
            f"LLMQ_CONFIG to one")


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
    configures one of the JAX package's backends (the JAX package's own
    ``configs/config.yaml`` in the repository's root), with the remedy."""
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
