"""The PyTorch/CUDA port stands alone: every module of ``llmq_tpu_torch``
and ``chip_smoke.py`` imports with ``jax``, ``llmq_tpu`` and
``prometheus_client`` blocked (the port carries its own metrics
registry), and its entry points refuse to fall back to the CPU without
being asked."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT_SCRIPT = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "llmq_tpu", "prometheus_client")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import: {name}")
            return None

    for mod in [m for m in sys.modules if blocked(m)]:
        del sys.modules[mod]
    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[1])

    import llmq_tpu_torch
    names = ["llmq_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(llmq_tpu_torch.__path__,
                                              "llmq_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    # The slices' entry points: every kernel with its twin, their
    # sources, the mixed forwards, the int8 ops and routes, and the
    # config blocks and switches.
    from llmq_tpu_torch.ops import kernels
    for fn in ("fused_decode", "kv_prefill_write", "prefill_attention",
               "kv_cache_write", "fused_decode_q8", "ragged_mixed_attention",
               "ragged_mixed_attention_q8", "paged_decode_attention"):
        assert callable(getattr(kernels, fn))
        assert callable(getattr(kernels, fn + "_plain"))
        assert fn in kernels.LAUNCHES
    assert all((kernels.CSRC_DIR / src).is_file()
               for src in kernels.SOURCES.values())
    assert (kernels.CSRC_DIR / "decode_attention.cuh").is_file()
    from llmq_tpu_torch.models.llama import (forward_mixed,
                                             forward_mixed_ragged)
    from llmq_tpu_torch.ops.attention import ragged_mixed_step
    from llmq_tpu_torch.core.config import (MixedBatchConfig,
                                            RaggedAttentionConfig)
    from llmq_tpu_torch.engine.executor import TorchExecutor
    assert hasattr(TorchExecutor, "mixed_chunk")
    from llmq_tpu_torch.ops import quant
    for fn in ("is_quantized", "quantize_weight", "dequantize_weight",
               "quantize_act", "qdot", "linear", "layer_slice",
               "quantize_embedding", "embed_lookup", "tied_head_logits",
               "quantize_params", "params_bytes", "quantize_kv_rows",
               "dequantize_kv"):
        assert callable(getattr(quant, fn)), fn
    from llmq_tpu_torch.ops.attention import (paged_decode_step_q8,
                                              ragged_mixed_step_q8)
    from llmq_tpu_torch.models.llama import init_params_quantized
    from llmq_tpu_torch.core.config import ModelConfig
    assert ModelConfig().quantization == ModelConfig().kv_quantization == ""
    # The async pipeline and the prefix cache.
    from llmq_tpu_torch.prefixcache.radix import PrefixCache, PrefixMatch
    from llmq_tpu_torch.core.config import (AsyncPipelineConfig,
                                            PrefixCacheConfig)
    assert AsyncPipelineConfig().enabled and PrefixCacheConfig().enabled
    from llmq_tpu_torch.engine.executor import (ChunkHandle, HostStaging,
                                                MixedChunkHandle)
    assert hasattr(TorchExecutor, "decode_chunk_start")
    assert hasattr(TorchExecutor, "mixed_chunk_start")
    # The serving process: queue plane, supervisor, conversation
    # service, preprocessor, overload shedder, message store, REST.
    from llmq_tpu_torch.core.clock import FakeClock, SystemClock
    from llmq_tpu_torch.core.errors import (ConversationNotFoundError,
                                            MessageNotFoundError)
    from llmq_tpu_torch.queueing.delayed_queue import DelayedQueue
    from llmq_tpu_torch.queueing.dead_letter_queue import DeadLetterQueue
    from llmq_tpu_torch.queueing.queue_manager import (PriorityAdjustRule,
                                                       QueueManager)
    from llmq_tpu_torch.queueing.worker import (ExponentialBackoff,
                                                FixedBackoff, Worker)
    from llmq_tpu_torch.queueing.factory import QueueFactory, QueueType
    from llmq_tpu_torch.engine.supervisor import EngineSupervisor
    from llmq_tpu_torch.conversation.persistence import (InMemoryStore,
                                                         RedisStore,
                                                         SqliteStore,
                                                         make_store)
    from llmq_tpu_torch.conversation.state_manager import StateManager
    from llmq_tpu_torch.preprocessor.preprocessor import Preprocessor
    from llmq_tpu_torch.api.overload import (OverloadShedder,
                                             build_shedder,
                                             estimate_prompt_tokens)
    from llmq_tpu_torch.observability.usage import sanitize_tenant
    from llmq_tpu_torch.api.message_store import MessageStore
    from llmq_tpu_torch.api.server import ApiServer
    from llmq_tpu_torch.engine.engine import InferenceEngine
    for fn in ("recover_after_crash", "healthy",
               "attach_conversation_manager", "touch_conversation",
               "_release_sequence_pages", "_reclaim_pending_pages"):
        assert callable(getattr(InferenceEngine, fn)), fn
    from llmq_tpu_torch.core.config import (ConversationConfig,
                                            OverloadConfig,
                                            PersistenceConfig, RetryConfig,
                                            SupervisorConfig)
    assert SupervisorConfig().enabled and OverloadConfig().enabled
    assert RetryConfig().max_retries == 3
    # The config file, metrics, logging, the scheduling plane, the load
    # balancer, and the entry points' subcommands.
    import os
    from llmq_tpu_torch.core.config import load_config
    cfg = load_config(os.devnull)
    assert cfg.queue.enable_metrics and cfg.executor.backend == "torch"
    from llmq_tpu_torch.metrics.registry import (LABEL_CONTRACT,
                                                 exposition, get_metrics)
    assert b"llm_queue_messages_pending" in exposition()
    from llmq_tpu_torch.utils.logging import (bind_log_context,
                                              configure_logging)
    from llmq_tpu_torch.scheduling.topology import GpuTopology
    from llmq_tpu_torch.scheduling.resource_scheduler import (
        ResourceScheduler, ResourceType)
    from llmq_tpu_torch.loadbalancer.load_balancer import LoadBalancer
    from llmq_tpu_torch.__main__ import App, cmd_check, cmd_serve
    assert GpuTopology.discover("cpu").num_chips == 1
    # The observability plane: traces, flight recorder, SLO, usage,
    # critical path, device telemetry and on-demand profiling.
    from llmq_tpu_torch import observability
    for fn in ("record", "configure", "get_recorder", "make_traceparent",
               "parse_traceparent", "trace_id_for", "chrome_trace",
               "configure_slo", "configure_usage", "configure_critical_path",
               "decompose", "boot_begin", "get_device_telemetry",
               "measure_rtt", "decode_mfu"):
        assert callable(getattr(observability, fn)), fn
    from llmq_tpu_torch.observability.device import (profile_status,
                                                     start_profile)
    from llmq_tpu_torch.utils.profiling import SpanRecorder, annotate, trace
    from llmq_tpu_torch.core.config import ObservabilityConfig
    assert ObservabilityConfig().enabled and cfg.observability.usage.enabled
    for fn in ("prefill_estimate", "_admission_cap",
               "_observe_prefill_rate"):
        assert callable(getattr(InferenceEngine, fn)), fn
    # The durable queue plane and the split deployment: the WAL, the
    # spool, the native core's binding (built at first use, never at
    # import) and the queue-manager and gateway subcommands.
    from llmq_tpu_torch.core.errors import WALError
    assert issubclass(WALError, OSError)
    from llmq_tpu_torch.queueing.wal import QueueWAL
    from llmq_tpu_torch.queueing.spool import (SpoolCollector,
                                               SpoolConsumer,
                                               SpoolProducer)
    from llmq_tpu_torch.native import loader
    assert loader._lib is None and not loader._load_failed
    assert loader.SRC.is_file()
    from llmq_tpu_torch.queueing.priority_queue import _make_backend
    from llmq_tpu_torch.__main__ import cmd_gateway, cmd_queue_manager
    assert cfg.queue.wal_dir == cfg.queue.spool_dir == ""
    assert hasattr(get_metrics(), "wal_errors")
    # Speculation: the drafter, the keyed sampler, the verify forward and
    # programs, the config block and the metric families.
    from llmq_tpu_torch.speculation import NgramDrafter, propose_ngram
    from llmq_tpu_torch.ops.sampling import (keyed_uniform,
                                             sample_token_keyed)
    from llmq_tpu_torch.models.llama import forward_verify
    from llmq_tpu_torch.engine.executor import (VerifyHandle,
                                                verify_host_ncommit)
    for fn in ("verify_chunk", "verify_chunk_start"):
        assert callable(getattr(TorchExecutor, fn)), fn
    for fn in ("_spec_once", "_spec_trim", "_note_spec_window"):
        assert callable(getattr(InferenceEngine, fn)), fn
    from llmq_tpu_torch.core.config import SpeculationConfig
    assert not SpeculationConfig().enabled
    assert not cfg.executor.speculation.enabled
    for fam in ("spec_acceptance", "spec_tokens_proposed",
                "spec_tokens_accepted", "spec_readback_cadence"):
        assert hasattr(get_metrics(), fam), fam
    # The tiered KV plane: the plane and its codec, the executor's page
    # seam, the engine's branches, the radix demotion seam, the stores'
    # KV-payload seam, the config block and the metric families.
    from llmq_tpu_torch.tiering import (HostTierPool, KVTieringPlane,
                                        PagePayload, blob_meta,
                                        decode_blob, encode_blob)
    for fn in ("kv_page_spec", "export_kv_pages", "import_kv_pages"):
        assert callable(getattr(TorchExecutor, fn)), fn
    for fn in ("demote_conversation", "rehydrate_tiered_conversations",
               "_try_promote", "_stamp_promote"):
        assert callable(getattr(InferenceEngine, fn)), fn
    assert callable(PrefixCache.set_demotion_callback)
    for store_cls in (InMemoryStore, SqliteStore, RedisStore):
        for fn in ("save_kv", "load_kv", "delete_kv", "list_kv"):
            assert callable(getattr(store_cls, fn)), (store_cls, fn)
    from llmq_tpu_torch.core.config import KVTieringConfig
    assert not KVTieringConfig().enabled
    assert not cfg.executor.kv_tiering.enabled
    for fam in ("kv_tier_pages", "kv_tier_bytes", "kv_tier_hits",
                "kv_tier_round_trips", "kv_promote_ms", "kv_demote_ms"):
        assert hasattr(get_metrics(), fam), fam
    assert "llmq_tpu_torch.tiering.plane" in sys.modules
    # The fault domain: the echo executor, the chaos plane, the circuit
    # breaker, the resilient store, their config blocks and families.
    from llmq_tpu_torch.engine.executor import (EchoChunkHandle,
                                                EchoExecutor, _EchoOutProbe)
    assert EchoExecutor.kv_content_free
    from llmq_tpu_torch import chaos
    from llmq_tpu_torch.chaos import (ChaosFault, EngineCrash,
                                      FaultInjector, InvariantChecker)
    assert chaos.get_injector() is None
    from llmq_tpu_torch.loadbalancer.circuit_breaker import (
        BreakerState, CircuitBreaker, CircuitOpenError)
    from llmq_tpu_torch.conversation.resilience import (
        CONSUMERS, ResilientKVStore, ResilientStore, StoreDegradedError,
        StoreOpTimeout, wrap_store)
    from llmq_tpu_torch.core.config import (BreakerConfig, ChaosConfig,
                                            StoreResilienceConfig)
    assert not cfg.chaos.enabled and not cfg.store.resilience.enabled
    for fam in ("chaos_injected", "store_op_ms", "store_retries",
                "store_breaker_state", "store_degraded"):
        assert hasattr(get_metrics(), fam), fam
    # The tenancy plane: the registry, the fair scheduler, the quota
    # gate, the engine's fairness, the config block, the route and the
    # metric families; real weights: the safetensors reader, the HF
    # import, the port's checkpoints and the HF tokenizer (transformers
    # imported only when a path is configured).
    from llmq_tpu_torch import tenancy
    from llmq_tpu_torch.tenancy import (FairScheduler, TenantRegistry,
                                        configure_tenancy, flush_metrics,
                                        register_scheduler, reset_tenancy,
                                        share_ratios_from_window,
                                        weighted_token_caps)
    from llmq_tpu_torch.tenancy import registry
    assert estimate_prompt_tokens is registry.estimate_prompt_tokens
    assert registry.QUOTA_REASONS == ("rate", "queue_depth", "inflight")
    from llmq_tpu_torch.core.config import TenancyConfig, TenantClassConfig
    assert not cfg.tenancy.enabled
    assert callable(QueueManager.fair_snapshot)
    for fn in ("_apply_decode_fairness", "_budget_chunk_rows"):
        assert callable(getattr(InferenceEngine, fn)), fn
    from llmq_tpu_torch.engine.engine import _pack_prefill_slices
    assert callable(ApiServer.get_tenancy)
    for fam in ("tenant_virtual_time", "tenant_share_ratio",
                "tenant_quota_rejections", "tenant_inflight",
                "tenant_registry_evictions"):
        assert hasattr(get_metrics(), fam), fam
    from llmq_tpu_torch.models.checkpoint import (SafetensorsFile,
                                                  import_hf_llama,
                                                  load_checkpoint,
                                                  save_checkpoint,
                                                  write_safetensors)
    from llmq_tpu_torch.engine.tokenizer import (ByteTokenizer, HFTokenizer,
                                                 get_tokenizer)
    assert isinstance(get_tokenizer(""), ByteTokenizer)
    for mod in ("transformers", "safetensors", "ml_dtypes"):
        assert mod not in sys.modules, mod
    # The replica set: endpoint selection, the breaker board, the HTTP
    # transport, the routers, the cluster plane, the autoscaler, their
    # config blocks, routes and metric families.
    from llmq_tpu_torch.core.errors import NoEndpointError
    from llmq_tpu_torch.loadbalancer.circuit_breaker import BreakerBoard
    from llmq_tpu_torch.loadbalancer.transport import HttpEngineClient
    from llmq_tpu_torch.loadbalancer.router import EngineRouter
    from llmq_tpu_torch.cluster import ClusterRouter, build_cluster_router
    from llmq_tpu_torch.scheduling.autoscaler import (Autoscaler,
                                                      ScalingStrategy)
    from llmq_tpu_torch.core.config import ClusterConfig, SchedulerConfig
    assert not ClusterConfig().enabled and not cfg.cluster.enabled
    for fn in ("get_endpoint", "acquire_endpoint", "release_endpoint",
               "cleanup_sessions"):
        assert callable(getattr(LoadBalancer, fn)), fn
    for fn in ("get_cluster_stats", "get_cluster_overview"):
        assert callable(getattr(ApiServer, fn)), fn
    assert callable(InferenceEngine.hint_arrival)
    for fam in ("cluster_dispatch", "cluster_affinity_hit_rate",
                "cluster_failovers", "cluster_drains", "cluster_endpoints",
                "circuit_breaker_state", "circuit_breaker_trips"):
        assert hasattr(get_metrics(), fam), fam
    for mod in ("llmq_tpu_torch.loadbalancer.transport",
                "llmq_tpu_torch.loadbalancer.router",
                "llmq_tpu_torch.cluster",
                "llmq_tpu_torch.scheduling.autoscaler"):
        assert mod in sys.modules, mod
    # The control plane and the disaggregation plane: the controller, the
    # ladder, the pools, the exchange and the coordinator, their config
    # blocks (off by default), the shedder's ladder seam, the plane's and
    # engine's hooks, the REST routes and the metric families.
    from llmq_tpu_torch.controlplane import (DegradationLadder,
                                             ExecReplicaPool,
                                             LocalEnginePool,
                                             ReplicaController,
                                             SubprocessReplicaPool,
                                             build_controller, build_pool)
    from llmq_tpu_torch.disagg import (EXCHANGE_PREFIX, DisaggCoordinator,
                                       KVExchange, build_disagg)
    from llmq_tpu_torch.core.config import (ControlPlaneConfig,
                                            DisaggConfig,
                                            ReplicaPoolConfig)
    assert not cfg.controlplane.enabled and not cfg.disagg.enabled
    assert build_controller(cfg, object()) is None
    assert callable(OverloadShedder.set_degradation)
    for fn in ("export_to_exchange", "_exchange_fetch", "_exchange_publish"):
        assert callable(getattr(KVTieringPlane, fn)), fn
    for fn in ("get_controller_state", "set_controller_state"):
        assert callable(getattr(ApiServer, fn)), fn
    for fam in ("controller_actions", "controller_rung",
                "controller_target_replicas", "controller_live_replicas",
                "controller_recovery_seconds", "controller_paused",
                "kv_exchange_published", "kv_exchange_claimed",
                "kv_exchange_expired", "kv_exchange_fallback",
                "kv_handoff_ms"):
        assert hasattr(get_metrics(), fam), fam
    # The scenario engine (the shipped specs read from the repository's
    # configs/scenarios/), its config block and subcommand, and the
    # lockdep instrument, which patches nothing until install().
    from llmq_tpu_torch.scenarios import (SHIPPED, EngineTarget,
                                          GatewayTarget, PoolTarget,
                                          RunStats, ScenarioDriver,
                                          build_report, compile_scenario,
                                          list_scenarios, load_named,
                                          make_echo_engine, run_scenario,
                                          scenario_dir,
                                          steady_state_deviation,
                                          spec_from_dict, write_report)
    from llmq_tpu_torch.scenarios.library import _store_target, store_tiering
    assert set(SHIPPED) <= set(list_scenarios())
    from llmq_tpu_torch.core.config import ScenariosConfig
    assert not cfg.scenarios.enabled and cfg.scenarios.scale == 1.0
    from llmq_tpu_torch.__main__ import cmd_scenarios
    import threading
    from llmq_tpu_torch.analysis import lockdep
    assert not lockdep.is_installed()
    assert not isinstance(threading.Lock(), lockdep._TrackedLock)
    for fn in ("install", "uninstall", "check", "report", "reset",
               "violations", "enabled_by_env"):
        assert callable(getattr(lockdep, fn)), fn
    # The parallel layer (JAX's exports but XLA's compilation cache), the
    # mesh config blocks, the mesh executor's follower side and the
    # cluster bring-up of the entry points.
    import llmq_tpu_torch.parallel as par
    for fn in ("make_mesh", "single_device_mesh", "distributed_init",
               "batch_sharding", "kv_cache_shardings",
               "match_partition_rules", "param_shardings", "replicated",
               "resolve_rules", "shard_params"):
        assert callable(getattr(par, fn)), fn
    assert len(par.LLAMA_PARTITION_RULES) == 8
    assert not hasattr(par, "enable_compilation_cache")
    from llmq_tpu_torch.core.config import Config, MeshConfig, TPUConfig
    assert not Config().executor.mesh.enabled
    assert Config().tpu.mesh_shape == {}
    from llmq_tpu_torch.models.llama import TensorParallel
    assert callable(TorchExecutor.follow)
    assert callable(TorchExecutor.release_mesh)
    from llmq_tpu_torch.engine.builder import build_executor, mesh_shape
    from llmq_tpu_torch.__main__ import _maybe_join_cluster, cmd_follow
    from llmq_tpu_torch.engine.kv_allocator import PageAllocator
    assert PageAllocator(8, 16, dp_shards=2).available_by_shard() == [3, 4]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", sys.argv[1] + "/chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("IMPORTED", len(names))
""")


def test_port_imports_without_jax_or_reference_package():
    """Tolerance: none — every module must import, the mixed and ragged
    entry points and the serving process's modules included."""
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT_SCRIPT,
                          REPO], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    n = int(res.stdout.split("IMPORTED")[1])
    # core, engine, ops, models, queueing, api, conversation,
    # preprocessor and their modules.
    assert n >= 30, res.stdout


def test_serving_path_imports_no_scenario_or_lockdep_module():
    """The scenario engine is a tool and lockdep an instrument: the
    serving process's modules (the CLI's ``App`` and its subcommands
    included) import neither, as in the JAX package."""
    script = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        import llmq_tpu_torch.__main__
        import llmq_tpu_torch.engine.engine
        import llmq_tpu_torch.api.server
        import llmq_tpu_torch.controlplane
        loaded = sorted(m for m in sys.modules if m.startswith(
            ("llmq_tpu_torch.scenarios", "llmq_tpu_torch.analysis")))
        assert not loaded, loaded
        print("CLEAN")
    """)
    res = subprocess.run([sys.executable, "-c", script, REPO],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert res.returncode == 0 and "CLEAN" in res.stdout, \
        res.stdout + res.stderr


def test_block_really_blocks():
    """The blocker itself works: importing the JAX package fails."""
    script = _BLOCKED_IMPORT_SCRIPT.split("import llmq_tpu_torch")[0] + \
        "import llmq_tpu.core.types\n"
    res = subprocess.run([sys.executable, "-c", script, REPO],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert res.returncode != 0
    assert "blocked import: llmq_tpu" in res.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    """Without a GPU, the CUDA default raises; only device='cpu' runs."""
    from llmq_tpu_torch.core.config import Config, resolve_device
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.models.llama import get_config, init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    cfg = Config()
    cfg.model.name = "llama3-tiny"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(cfg)
    mcfg = get_config("llama3-tiny")
    params = init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchExecutor(mcfg, params)
    ex = TorchExecutor(mcfg, params, device="cpu", num_pages=8)
    assert ex.cache["k"].device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    """chip_smoke.py exits non-zero and prints no result without CUDA."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() != 0


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the
    repository the script fails and prints no result line."""
    src = os.path.join(REPO, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, str(dst)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_kernel_wrappers_refuse_non_cpu_non_cuda_devices():
    """A wrapper takes its plain twin only for CPU tensors; mixed
    devices raise instead of silently moving data."""
    from llmq_tpu_torch.ops import kernels

    pool = torch.zeros((1, 4, 16, 128), dtype=torch.bfloat16)
    rows = torch.zeros((2, 128), dtype=torch.bfloat16, device="meta")
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="mixed devices"):
        kernels.kv_cache_write(pool, pool, rows, rows, idx, idx, 0)
