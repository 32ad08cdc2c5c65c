"""Typed configuration for the port: dataclass defaults, then ``LLMQ_*``
environment overrides, then CLI flags.

Trimmed copy of ``llmq_tpu/core/config.py`` holding only what the serving
path reads. There is no config file, so the package needs nothing beyond
``torch`` and ``numpy``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, List, Mapping, Optional

from llmq_tpu_torch.core.types import Priority


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 8080


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


@dataclass
class WorkerConfig:
    count: int = 4
    max_batch_size: int = 10
    process_interval: float = 0.05
    max_concurrent: int = 50


@dataclass
class QueueConfig:
    max_queue_size: int = 10000
    levels: List[QueueLevelConfig] = field(
        default_factory=default_queue_levels)
    worker: WorkerConfig = field(default_factory=WorkerConfig)


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


@dataclass
class Config:
    server: ServerConfig = field(default_factory=ServerConfig)
    queue: QueueConfig = field(default_factory=QueueConfig)
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


def _coerce(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, list):
        return [int(x) for x in raw.replace(",", " ").split()]
    return raw


def apply_env(cfg: Config, environ: Optional[Mapping[str, str]] = None
              ) -> None:
    """``LLMQ_EXECUTOR_KV_PAGES=256`` overrides ``executor.kv_pages``:
    the name after ``LLMQ_`` is walked greedily, longest field name
    first, and the block it lands in is validated again. Unknown keys
    are ignored (they may belong to other tools)."""
    env = os.environ if environ is None else environ
    for key, raw in env.items():
        if not key.startswith("LLMQ_"):
            continue
        parts = [p.lower() for p in key[len("LLMQ_"):].split("_")]
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


def load_config(env: bool = True,
                environ: Optional[Mapping[str, str]] = None) -> Config:
    """Defaults, then ``LLMQ_*`` environment overrides."""
    cfg = Config()
    if env:
        apply_env(cfg, environ)
    return cfg
