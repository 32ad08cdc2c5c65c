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
