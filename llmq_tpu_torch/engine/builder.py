"""Build an engine from the config: model, parameters, tokenizer,
``TorchExecutor`` and ``InferenceEngine`` (counterpart of the ``jax``
branch of ``llmq_tpu/engine/builder.py``; ``executor.backend: echo``
builds the host-only ``EchoExecutor`` instead, as its ``echo`` branch
does), in bf16 or with int8 weights
(``model.quantization``) and/or int8 KV pools (``model.kv_quantization``),
the two switches independent as in the JAX package; the async decode
pipeline (``executor.async_pipeline``) and the radix prefix cache
(``executor.prefix_cache``) on by default, as in the JAX package;
speculative decoding (``executor.speculation``) and the tiered KV plane
(``executor.kv_tiering``) off by default. Weights come from
``model.checkpoint_path`` when it is set (a directory ending in
``.safetensors.d``: a Hugging Face Llama checkpoint; any other path: the
port's own checkpoint file, ``models/checkpoint.py``), else random from
seed 0; a configured checkpoint that fails to load aborts the build, and
nothing serves random weights in its place. ``model.tokenizer_path``
selects a local Hugging Face tokenizer (``transformers`` needed), else
the byte tokenizer. With ``executor.mesh`` enabled (or, when that block
is off, the legacy ``tpu.mesh_shape``) the engine serves over a rank mesh
(``parallel/``): the builder makes the mesh over the world this process
joined (``LLMQ_COORDINATOR``) and the executor takes this rank's shard
(it turns ragged attention off with JAX's warning; a ``dp`` axis splits
the batch and the pool into replicas, and speculation and the tiered KV
plane run on it as on one device); a follower rank builds only the
executor (:func:`build_executor`) and follows rank 0's. The
build stamps its boot stages (``weights``, and with ``warmup`` the
``artifact``, ``compile`` and ``warmup`` stages) onto this process's boot
record (observability/critical_path.py), opened here when no entry point
opened one first."""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import torch

from llmq_tpu_torch.core.config import Config, resolve_device
from llmq_tpu_torch.core.types import Priority
from llmq_tpu_torch.engine.engine import InferenceEngine
from llmq_tpu_torch.engine.executor import EchoExecutor, TorchExecutor
from llmq_tpu_torch.engine.tokenizer import get_tokenizer
from llmq_tpu_torch.models.checkpoint import import_hf_llama, load_checkpoint
from llmq_tpu_torch.models.llama import (LlamaConfig, Params, get_config,
                                         init_params, init_params_quantized)
from llmq_tpu_torch.observability import critical_path as _cp
from llmq_tpu_torch.ops.quant import (is_quantized, params_bytes,
                                     quantize_params)

log = logging.getLogger("llmq_tpu_torch.builder")


def mesh_shape(cfg: Config) -> Optional[Dict[str, int]]:
    """The configured mesh: ``executor.mesh.shape`` when its block is on,
    else the legacy ``tpu.mesh_shape`` when set, else None. The echo
    backend has none."""
    if cfg.executor.backend != "torch":
        return None
    if cfg.executor.mesh.enabled:
        return dict(cfg.executor.mesh.shape)
    if cfg.tpu.mesh_shape:
        return dict(cfg.tpu.mesh_shape)
    return None


def build_engine(cfg: Config, *, name: str = "engine0",
                 params=None, device: Optional[str] = None,
                 model_dtype: Optional[torch.dtype] = None,
                 warmup: bool = False,
                 n_layers: Optional[int] = None,
                 executor: Optional[TorchExecutor] = None
                 ) -> InferenceEngine:
    """Engine for ``cfg.model`` / ``cfg.executor`` on ``device`` (default
    ``cfg.device``). ``params`` (a parameter tree in the JAX layout) is
    used as given (quantized first if ``model.quantization`` asks for it
    and it is not already); otherwise ``model.checkpoint_path`` is loaded
    onto the device, or without one weights are random-initialised on
    the device from seed 0 (the JAX package's ``PRNGKey(0)``
    counterpart), leaf by leaf straight into int8 when quantized.
    ``model_dtype`` overrides the model's bf16 (tests run f32);
    ``n_layers`` the model's depth (a shallower model at its widths).
    ``warmup`` runs :meth:`TorchExecutor.warmup` before the engine is
    made: every program once, the decode step's graph captured on the
    card, ``step_ms`` calibrated (on a mesh, on every rank). The engine's
    metric families follow ``metrics.enabled``, as in the JAX package's
    builder. ``executor``, one this builder made before, serves the new
    engine in place of a new one: a mesh's, made once over its world
    (the model and device arguments are then its own)."""
    ex = cfg.executor
    if ex.backend == "echo":
        return _build_echo(cfg, name)
    if executor is None:
        executor, tokenizer, mcfg, t0 = _build_torch(
            cfg, name=name, params=params, device=device,
            model_dtype=model_dtype, n_layers=n_layers)
    else:
        tokenizer = get_tokenizer(cfg.model.tokenizer_path)
        mcfg, t0 = executor.model_cfg, time.perf_counter()
    boot_id = _cp.current_boot_id()
    quant, kv_quant = cfg.model.quantization, cfg.model.kv_quantization
    mixed, ragged = ex.mixed_batch, ex.ragged_attention
    pipe, prefix, spec = ex.async_pipeline, ex.prefix_cache, ex.speculation
    tier = ex.kv_tiering
    dev = executor.device
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
        speculation=spec,
        kv_tiering=tier,
        enable_metrics=cfg.metrics.enabled)
    log.info("built %s engine %s on %s in %.1fs (slots=%d pages=%d "
             "page_size=%d chunk=%d prefill_batch=%d quantization=%s "
             "kv_quantization=%s "
             "weights=%.2f GB mixed_batch=%s ragged_attention=%s "
             "async_pipeline=%s prefix_cache=%s speculation=%s "
             "kv_tiering=%s mesh=%s warmup=%s)",
             mcfg.name, name, dev, time.perf_counter() - t0,
             ex.max_batch_size, ex.kv_pages, ex.page_size, ex.decode_chunk,
             executor.prefill_batch, quant or "bf16", kv_quant or "bf16",
             params_bytes(executor.model.params) / 1e9,
             (f"on(budget={mixed.prefill_token_budget}"
              f"x{executor.mixed_prefill_slices})" if mixed.enabled
              else "off"),
             (f"on(cap={executor.mixed_slice_tokens}"
              f"x{executor.mixed_prefill_slices})"
              if executor.ragged_attention else "off"),
             (f"on(depth={pipe.depth} completion_workers="
              f"{pipe.completion_workers})" if pipe.enabled else "off"),
             (f"on({prefix.eviction} max_cached_pages="
              f"{prefix.max_cached_pages})" if prefix.enabled else "off"),
             (f"on(k={spec.draft_k} device_sampling="
              f"{spec.device_sampling})" if spec.enabled else "off"),
             (f"on(host={tier.host_capacity_mb}MiB)" if tier.enabled
              else "off"),
             (f"{executor.mesh.shape}@{executor.mesh.backend or 'none'}"
              if executor.mesh is not None else "off"),
             (" ".join(f"{k}={v:.2f}s" for k, v in
                       executor.warmup_split.items()) if warmup else "off"))
    return engine


def build_executor(cfg: Config, *, name: str = "engine0", params=None,
                   device: Optional[str] = None,
                   model_dtype: Optional[torch.dtype] = None,
                   n_layers: Optional[int] = None) -> TorchExecutor:
    """The ``TorchExecutor`` :func:`build_engine` would build, alone and
    without warmup: what a follower rank of a mesh serves (its driver's
    warmup reaches it as a call)."""
    return _build_torch(cfg, name=name, params=params, device=device,
                        model_dtype=model_dtype, n_layers=n_layers)[0]


def _build_torch(cfg: Config, *, name: str, params, device: Optional[str],
                 model_dtype: Optional[torch.dtype],
                 n_layers: Optional[int]
                 ) -> Tuple[TorchExecutor, object, LlamaConfig, float]:
    """(executor, tokenizer, model config, start time) of the torch
    backend, the mesh made and the weights loaded or drawn."""
    ex = cfg.executor
    dev = resolve_device(device or cfg.device)
    boot_id = _cp.current_boot_id()
    if boot_id is None and _cp.cp_enabled():
        _cp.boot_begin(name, "engine", process=True)
        boot_id = _cp.current_boot_id()
    tokenizer = get_tokenizer(cfg.model.tokenizer_path)
    kw = {"max_seq_len": cfg.model.max_seq_len}
    if cfg.model.vocab_size:
        kw["vocab_size"] = cfg.model.vocab_size
    if model_dtype is not None:
        kw["dtype"] = model_dtype
    if n_layers is not None:
        kw["n_layers"] = n_layers
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
    spec, tier = ex.speculation, ex.kv_tiering
    mesh = None
    shape = mesh_shape(cfg)
    if shape:
        from llmq_tpu_torch.parallel import make_mesh
        mesh = make_mesh(shape)
    t0 = time.perf_counter()
    if params is None and cfg.model.checkpoint_path:
        params = _load_weights(cfg, mcfg, dev)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        init = init_params_quantized if quant == "int8" else init_params
        params = init(mcfg, gen, dev)
    if quant == "int8":
        params = quantize_params(params)      # idempotent
    if dev.type == "cuda":
        # The draw's and the load's transients go back to the card, which
        # the other ranks of a mesh may share.
        torch.cuda.empty_cache()
    if boot_id is not None:
        # The load, random init (or the given tree) and quantization; on
        # the card the stage ends when the queued work has run.
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
        # Speculation: draft_k > 0 builds the verify window; 0 hides
        # verify_chunk, so the off-switch keeps the plain decode path.
        speculation_draft_k=spec.draft_k if spec.enabled else 0,
        speculation_device_sampling=spec.device_sampling,
        device=str(dev), telemetry_name=name,
        # Warmup runs before the engine can set the flag.
        telemetry_metrics=cfg.metrics.enabled,
        mesh=mesh)
    return executor, tokenizer, mcfg, t0


def _check_shapes(params: Params, mcfg: LlamaConfig, path: str,
                  quant: str) -> None:
    """A loaded tree must have every leaf of ``mcfg`` (its random-init
    tree's, made on the meta device) at its shape and the model's dtype.
    A quantized leaf (int8 values, f32 scales) is taken only when
    ``model.quantization`` is ``int8``. An ``lm_head`` may be absent:
    the head is tied."""
    def bad(name, what, need):
        return ValueError(f"checkpoint {path}: leaf {name} {what}, model "
                          f"{mcfg.name} needs {need}")

    def walk(node, want, pre):
        for k, ref in want.items():
            got = node.get(k) if isinstance(node, dict) else None
            if got is None and k == "lm_head":
                continue
            if isinstance(ref, dict):
                walk(got, ref, pre + k + ".")
                continue
            name = pre + k
            if is_quantized(got):
                if quant != "int8":
                    raise bad(name, "is quantized (int8)",
                              f"{mcfg.dtype} with model.quantization "
                              f"{quant!r}")
                leaf, dtypes = got["q"], (got["q"].dtype, got["s"].dtype)
                if dtypes != (torch.int8, torch.float32):
                    raise bad(name, f"has values and scales of {dtypes}",
                              "(torch.int8, torch.float32)")
            else:
                leaf = got
            if not isinstance(leaf, torch.Tensor) or leaf.shape != ref.shape:
                raise bad(name, "has shape "
                          f"{None if leaf is None else tuple(leaf.shape)}",
                          tuple(ref.shape))
            if leaf is got and leaf.dtype != ref.dtype:
                raise bad(name, f"is {leaf.dtype}", ref.dtype)
    walk(params, init_params(mcfg, None, "meta"), "")


def _load_weights(cfg: Config, mcfg: LlamaConfig, dev) -> Params:
    """``model.checkpoint_path`` onto ``dev``; any failure raises."""
    path = cfg.model.checkpoint_path
    t0 = time.perf_counter()
    if path.rstrip("/").endswith(".safetensors.d"):
        params = import_hf_llama(path, mcfg,
                                 meta_rope_layout=cfg.model.meta_rope_layout,
                                 device=dev)
    else:
        params = load_checkpoint(path, device=dev)
    _check_shapes(params, mcfg, path, cfg.model.quantization)
    log.info("loaded weights of %s from %s in %.2fs", mcfg.name, path,
             time.perf_counter() - t0)
    return params


def _build_echo(cfg: Config, name: str) -> InferenceEngine:
    """The ``echo`` backend's engine (``llmq_tpu/engine/builder.py``'s
    echo branch, same geometry): no model, no device, no tensor; the
    futures API only with the async pipeline on. ``device`` plays no
    part."""
    ex = cfg.executor
    tokenizer = get_tokenizer(cfg.model.tokenizer_path)
    mixed, ragged = ex.mixed_batch, ex.ragged_attention
    pipe, spec, tier = ex.async_pipeline, ex.speculation, ex.kv_tiering
    # The engine-visible mixed geometry, as the JAX builder computes it:
    # S slices of T tokens, or with ragged attention S slices sharing
    # one packed capacity.
    slices = int(mixed.max_slices) if mixed.enabled else 0
    slice_tokens = int(mixed.slice_tokens) if mixed.enabled else 0
    if ragged.enabled:
        slices = int(ragged.max_slices) or (slices or 2)
        slice_tokens = (int(ragged.prefill_token_capacity)
                        or int(mixed.prefill_token_budget or 0) or 128)
    executor = EchoExecutor(
        batch_size=ex.max_batch_size,
        page_size=ex.page_size,
        num_pages=ex.kv_pages,
        max_pages_per_seq=max(1, cfg.model.max_seq_len // ex.page_size),
        eos_id=tokenizer.eos_id,
        chunk_size=ex.decode_chunk,
        mixed_prefill_slices=slices,
        mixed_slice_tokens=slice_tokens,
        async_chunks=pipe.enabled)
    # The engine's ragged budget clamp reads this: the echo packs the
    # shapes the ragged step accepts.
    executor.ragged_attention = ragged.enabled
    tier_max_wait = {Priority(lvl.priority): lvl.max_wait_time
                     for lvl in cfg.queue.levels}
    engine = InferenceEngine(
        executor, tokenizer, name=name,
        max_decode_steps=ex.max_decode_steps,
        preemption=ex.preemption,
        kv_pin_ttl=ex.kv_pin_ttl,
        tier_max_wait=tier_max_wait,
        mixed_batch=mixed,
        prefix_cache=ex.prefix_cache,
        async_pipeline=pipe,
        speculation=spec,
        kv_tiering=tier,
        enable_metrics=cfg.metrics.enabled)
    log.info("built echo engine %s (backend=echo slots=%d pages=%d "
             "page_size=%d chunk=%d mixed_batch=%s ragged_attention=%s "
             "async_pipeline=%s prefix_cache=%s speculation=%s "
             "kv_tiering=%s)",
             name, ex.max_batch_size, ex.kv_pages, ex.page_size,
             ex.decode_chunk,
             (f"on(budget={mixed.prefill_token_budget}x{slices})"
              if mixed.enabled else "off"),
             (f"on(cap={slice_tokens}x{slices})" if ragged.enabled
              else "off"),
             f"on(depth={pipe.depth})" if pipe.enabled else "off",
             "on" if ex.prefix_cache.enabled else "off",
             (f"on(k={spec.draft_k})" if spec.enabled else "off"),
             (f"on(host={tier.host_capacity_mb}MiB)" if tier.enabled
              else "off"))
    return engine
