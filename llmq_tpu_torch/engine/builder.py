"""Build an engine from the config: model, parameters, tokenizer,
``TorchExecutor`` and ``InferenceEngine`` (counterpart of the ``jax``
branch of ``llmq_tpu/engine/builder.py``), in bf16 or with int8 weights
(``model.quantization``) and/or int8 KV pools (``model.kv_quantization``),
the two switches independent as in the JAX package; the async decode
pipeline (``executor.async_pipeline``) and the radix prefix cache
(``executor.prefix_cache``) on by default, as in the JAX package. The
build stamps its boot stages (``weights``, and with ``warmup`` the
``artifact``, ``compile`` and ``warmup`` stages) onto this process's boot
record (observability/critical_path.py), opened here when no entry point
opened one first."""

from __future__ import annotations

import logging
import time
from typing import Optional

import torch

from llmq_tpu_torch.core.config import Config, resolve_device
from llmq_tpu_torch.core.types import Priority
from llmq_tpu_torch.engine.engine import InferenceEngine
from llmq_tpu_torch.engine.executor import TorchExecutor
from llmq_tpu_torch.engine.tokenizer import get_tokenizer
from llmq_tpu_torch.models.llama import (get_config, init_params,
                                         init_params_quantized)
from llmq_tpu_torch.observability import critical_path as _cp
from llmq_tpu_torch.ops.quant import params_bytes, quantize_params

log = logging.getLogger("llmq_tpu_torch.builder")


def build_engine(cfg: Config, *, name: str = "engine0",
                 params=None, device: Optional[str] = None,
                 model_dtype: Optional[torch.dtype] = None,
                 warmup: bool = False) -> InferenceEngine:
    """Engine for ``cfg.model`` / ``cfg.executor`` on ``device`` (default
    ``cfg.device``). ``params`` (a parameter tree in the JAX layout) is
    used as given (quantized first if ``model.quantization`` asks for it
    and it is not already); otherwise weights are random-initialised on
    the device from seed 0 (the JAX package's ``PRNGKey(0)``
    counterpart), leaf by leaf straight into int8 when quantized.
    ``model_dtype`` overrides the model's bf16 (tests run f32).
    ``warmup`` runs :meth:`TorchExecutor.warmup` before the engine is
    made: every program once, the decode step's graph captured on the
    card, ``step_ms`` calibrated. The engine's metric families follow
    ``metrics.enabled``, as in the JAX package's builder."""
    ex = cfg.executor
    dev = resolve_device(device or cfg.device)
    boot_id = _cp.current_boot_id()
    if boot_id is None and _cp.cp_enabled():
        _cp.boot_begin(name, "engine", process=True)
        boot_id = _cp.current_boot_id()
    tokenizer = get_tokenizer()
    kw = {"max_seq_len": cfg.model.max_seq_len}
    if cfg.model.vocab_size:
        kw["vocab_size"] = cfg.model.vocab_size
    if model_dtype is not None:
        kw["dtype"] = model_dtype
    mcfg = get_config(cfg.model.name, **kw)
    if tokenizer.vocab_size > mcfg.vocab_size:
        raise ValueError(
            f"tokenizer vocab ({tokenizer.vocab_size}) exceeds model "
            f"vocab ({mcfg.vocab_size}): ids would be out of range and "
            f"EOS could never be sampled; set model.vocab_size")
    quant = cfg.model.quantization
    if quant not in ("", "int8"):
        raise ValueError(f"unknown model.quantization {quant!r} "
                         f"(supported: 'int8')")
    kv_quant = cfg.model.kv_quantization
    if kv_quant not in ("", "int8"):
        raise ValueError(f"unknown model.kv_quantization {kv_quant!r} "
                         f"(supported: 'int8')")
    mixed, ragged = ex.mixed_batch, ex.ragged_attention
    pipe, prefix = ex.async_pipeline, ex.prefix_cache
    t0 = time.perf_counter()
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        init = init_params_quantized if quant == "int8" else init_params
        params = init(mcfg, gen, dev)
    if quant == "int8":
        params = quantize_params(params)      # idempotent
    if boot_id is not None:
        # Random init (or the given tree) and quantization; on the card
        # the stage ends when the queued init has run.
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _cp.boot_stage(boot_id, "weights", time.perf_counter() - t0)
    executor = TorchExecutor(
        mcfg, params,
        batch_size=ex.max_batch_size,
        page_size=ex.page_size,
        num_pages=ex.kv_pages,
        prefill_buckets=list(ex.prefill_buckets),
        eos_id=tokenizer.eos_id,
        chunk_size=ex.decode_chunk,
        prefill_batch=ex.prefill_batch,
        # Mixed geometry: bucket mode S slices of budget // S tokens; the
        # executor turns it into S slices sharing one packed capacity
        # when ragged attention is on.
        mixed_prefill_slices=mixed.max_slices if mixed.enabled else 0,
        mixed_slice_tokens=mixed.slice_tokens if mixed.enabled else 0,
        ragged_attention=ragged.enabled,
        ragged_token_capacity=(ragged.prefill_token_capacity
                               or mixed.prefill_token_budget),
        ragged_max_slices=ragged.max_slices,
        cache_dtype=torch.int8 if kv_quant == "int8" else None,
        device=str(dev), telemetry_name=name,
        # Warmup runs before the engine can set the flag.
        telemetry_metrics=cfg.metrics.enabled)
    if warmup:
        executor.warmup()
        if boot_id is not None:
            # No export cache: the artifact stage is 0. compile = the
            # nvcc builds; warmup = the eager runs and graph captures.
            _cp.boot_stage(boot_id, "artifact", 0.0)
            _cp.boot_stage(boot_id, "compile", executor.compile_s)
            _cp.boot_stage(boot_id, "warmup", sum(
                executor.warmup_split.values()) - executor.compile_s)
    tier_max_wait = {Priority(lvl.priority): lvl.max_wait_time
                     for lvl in cfg.queue.levels}
    engine = InferenceEngine(
        executor, tokenizer, name=name,
        max_decode_steps=ex.max_decode_steps,
        preemption=ex.preemption,
        kv_pin_ttl=ex.kv_pin_ttl,
        tier_max_wait=tier_max_wait,
        mixed_batch=mixed,
        prefix_cache=prefix,
        async_pipeline=pipe,
        enable_metrics=cfg.metrics.enabled)
    log.info("built %s engine %s on %s in %.1fs (slots=%d pages=%d "
             "page_size=%d chunk=%d prefill_batch=%d quantization=%s "
             "kv_quantization=%s "
             "weights=%.2f GB mixed_batch=%s ragged_attention=%s "
             "async_pipeline=%s prefix_cache=%s warmup=%s)",
             mcfg.name, name, dev, time.perf_counter() - t0,
             ex.max_batch_size, ex.kv_pages, ex.page_size, ex.decode_chunk,
             executor.prefill_batch, quant or "bf16", kv_quant or "bf16",
             params_bytes(params) / 1e9,
             (f"on(budget={mixed.prefill_token_budget}"
              f"x{executor.mixed_prefill_slices})" if mixed.enabled
              else "off"),
             (f"on(cap={executor.mixed_slice_tokens}"
              f"x{executor.mixed_prefill_slices})" if ragged.enabled
              else "off"),
             (f"on(depth={pipe.depth} completion_workers="
              f"{pipe.completion_workers})" if pipe.enabled else "off"),
             (f"on({prefix.eviction} max_cached_pages="
              f"{prefix.max_cached_pages})" if prefix.enabled else "off"),
             (" ".join(f"{k}={v:.2f}s" for k, v in
                       executor.warmup_split.items()) if warmup else "off"))
    return engine
