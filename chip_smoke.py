#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``llmq_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order (each ends in ``torch.cuda.synchronize()`` so a fault
shows where it happened):

1. env      — torch/CUDA versions, ``nvcc --version``, compute capability,
               the card's name and power limit (repeated beside every number).
2. build    — compiles the kernels from ``llmq_tpu_torch/csrc`` with nvcc
               (one process per source, all at once) and prints the seconds.
3. kernels  — each of the four kernels against its plain PyTorch twin on the
               card at llama3-8b's per-layer shapes (H=32, H_kv=8, D=128,
               page_size=16, B=8, max_pages=128): attention within
               ``ATOL``, pools bit-exact; kernel, plain, library times and
               the bound.
4. split    — one decode step through ``paged_decode_step(fused=False)``
               against ``fused=True``: same attention within ``ATOL``,
               identical pools.
5. model    — a small bf16 model with the same head geometry: logits of
               prefill (incl. a continuation chunk) and decode on the card
               against the same model on the CPU (plain twins).
6. serve    — llama3-8b bf16 at full width and depth, random weights from a
               seed, served by the port's REST server: messages across all
               four priorities and a two-turn conversation; every request
               completes, turn 2 reports cached tokens, and the kernels'
               launch counts grow during the phase. Then TTFT and decode
               tok/s, and one request through the split decode route.

Exits non-zero on any failure. On success the last lines are the kernel
table as JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
import urllib.request

# Attention outputs are bf16 on unit-scale inputs: the kernels keep the
# softmax weights in f32 where the plain twins round them to bf16 before
# P @ V (the JAX package's order), and bf16 rounds at 2**-8 near 1.
ATOL = 2e-2
# Tiny-model logits after several bf16 layers (f32 logits, unit scale).
MODEL_ATOL = 1e-1
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak

H, HKV, D, PS, B, MP = 32, 8, 128, 16, 8, 128
GD = HKV * D
L_POOL, P_POOL = 32, 512        # the served pool: 32 layers x 512 pages

CARD = ""


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn(i)``: the summed durations of the
    kernels it launched over ``iters`` calls (torch.profiler, device
    events only), divided by ``iters``. Gaps while the host prepares the
    next launch are not counted — at these sizes a CUDA-event loop would
    measure the Python wrapper, not the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return _device_us(prof) / 1e3 / iters


def _device_us(prof) -> float:
    import torch

    total = 0.0
    for e in prof.key_averages():
        # Device-side events only (the kernels); the ops that launch
        # them carry the same time and would count it twice.
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.self_device_time_total
    return total


# -- phases -------------------------------------------------------------------

def phase_env(state) -> None:
    import torch

    global CARD
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    from llmq_tpu_torch.ops.kernels import _nvcc
    nv = subprocess.run([_nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60, check=True)
    log("[env] " + nv.stdout.strip().splitlines()[-1])
    log(f"[env] capability {torch.cuda.get_device_capability(0)} "
        f"devices {torch.cuda.device_count()}")
    CARD = nvidia_smi_line()
    log(f"[env] card {CARD}")


def phase_build(state) -> None:
    from llmq_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build()
    dt = time.perf_counter() - t0
    for name, text in sorted(kernels.BUILD_LOGS.items()):
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(kernels.SOURCES)} sources built in {dt:.1f} s "
        f"({CARD})")


def _pools(gen, dev):
    import torch

    k = torch.randn((L_POOL, P_POOL, PS, GD), generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    v = torch.randn((L_POOL, P_POOL, PS, GD), generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    return k, v


def _decode_inputs(gen, dev, zero_row: bool):
    """B=8 decode rows: six live rows whose seq_lens cross page
    boundaries, one inactive row (write_page 0), and either a zero-length
    row or a second inactive row."""
    import torch

    live_lens = [1, 16, 17, 100, 333, 480]
    bt = torch.zeros((B, MP), dtype=torch.int32)
    seq_lens = torch.zeros(B, dtype=torch.int32)
    write_page = torch.zeros(B, dtype=torch.int32)
    perm = torch.randperm(P_POOL - 1, generator=torch.Generator().manual_seed(1)) + 1
    nxt = 0
    for b, sl in enumerate(live_lens):
        n = -(-sl // PS)
        bt[b, :n] = perm[nxt:nxt + n].to(torch.int32)
        nxt += n
        seq_lens[b] = sl
        write_page[b] = bt[b, (sl - 1) // PS]
    seq_lens[6] = 5                      # inactive: writes page 0, slot 4
    seq_lens[7] = 0 if zero_row else 9   # zero-length, or inactive slot 8
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((B, HKV, D), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((B, HKV, D), generator=gen, device=dev).to(torch.bfloat16)
    return (q, kn, vn, bt.to(dev), seq_lens.to(dev), write_page.to(dev),
            live_lens)


def _record(state, name, source, replaces, err, ms, plain_ms, bound_ms,
            bound_by, library_ms):
    from llmq_tpu_torch.ops import kernels

    state["kernels"][name] = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms}
    log(f"[kernels] {name}: max_abs_err {err:.3g} kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms library "
        f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'} "
        f"bound {bound_ms:.4f} ms ({bound_by}); {kernels.LAUNCHES[name]} "
        f"launches in this phase ({CARD})")


def phase_kernels(state) -> None:
    import torch
    import torch.nn.functional as F

    from llmq_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k_pool, v_pool = _pools(gen, dev)
    kernels.reset_launches()

    # -- kernel 1: fused decode ----------------------------------------------
    q, kn, vn, bt, sl, wp, live_lens = _decode_inputs(gen, dev, True)
    layer = 3
    kp1, vp1 = k_pool.clone(), v_pool.clone()
    kp2, vp2 = k_pool.clone(), v_pool.clone()
    out_k = kernels.fused_decode(q, kn, vn, kp1, vp1, bt, sl, wp, layer)
    torch.cuda.synchronize()
    out_p = kernels.fused_decode_plain(q, kn, vn, kp2, vp2, bt, sl, wp,
                                       layer)
    nl = len(live_lens)
    err = (out_k[:nl].float() - out_p[:nl].float()).abs().max().item()
    if not torch.isfinite(out_k).all():
        raise AssertionError("fused_decode: non-finite output")
    if err > ATOL:
        raise AssertionError(f"fused_decode: max err {err} > {ATOL}")
    if out_k[7].abs().max().item() != 0.0:
        raise AssertionError("fused_decode: zero-length row is not 0")
    if not (torch.equal(kp1, kp2) and torch.equal(vp1, vp2)):
        raise AssertionError("fused_decode: pools differ from the twin")
    del kp2, vp2
    ms = device_ms(lambda i: kernels.fused_decode(
        q, kn, vn, kp1, vp1, bt, sl, wp, i % L_POOL))
    plain_ms = device_ms(lambda i: kernels.fused_decode_plain(
        q, kn, vn, kp1, vp1, bt, sl, wp, i % L_POOL), iters=5, warmup=1)
    # Library yardstick: SDPA over dense K/V of the H_kv heads the kernel
    # reads. A group's n_rep query heads share its keys and mask, so they
    # ride as n_rep query rows of one KV head: no K/V is expanded to H
    # heads. A dense call still pads every row to the longest seq_len.
    S = max(live_lens)
    n_rep = H // HKV
    kv_len = torch.arange(S, device=dev)
    kd = torch.randn((B, HKV, S, D), generator=gen, device=dev).to(torch.bfloat16)
    vd = torch.randn((B, HKV, S, D), generator=gen, device=dev).to(torch.bfloat16)
    mask = (kv_len[None, :] < sl[:, None].to(torch.long))[:, None, None, :]
    mask[7] = True                       # SDPA needs a visible key per row
    q4 = q.reshape(B, HKV, n_rep, D)
    lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask))
    n_pos = sum(live_lens) + 5
    bytes_moved = (2 * B * H * D * 2 + 2 * B * GD * 2 + B * MP * 4 + 2 * B * 4
                   + (n_pos - 7) * GD * 2 * 2 + 7 * GD * 2 * 2)
    flops = n_pos * H * 4 * D
    bms, by = bound(bytes_moved, flops)
    _record(state, "fused_decode", "llmq_tpu_torch/csrc/fused_decode.cu",
            "llmq_tpu/ops/pallas/fused_decode.py:370", err, ms, plain_ms,
            bms, by, lib_ms)
    del kd, vd

    # -- kernel 3: prefill attention, kernel 2: prefill write ----------------
    for T, start in ((128, 0), (128, 37), (512, 0), (512, 37)):
        n_pages = -(-(start + T) // PS)
        perm = torch.randperm(P_POOL - 1, generator=torch.Generator()
                              .manual_seed(T + start)) + 1
        btab = torch.zeros(MP, dtype=torch.int32)
        btab[:n_pages] = perm[:n_pages].to(torch.int32)
        btab = btab.to(dev)
        layer = 5
        qp = torch.randn((T, H, D), generator=gen, device=dev).to(torch.bfloat16)
        rows_k = torch.randn((T, GD), generator=gen, device=dev).to(torch.bfloat16)
        rows_v = torch.randn((T, GD), generator=gen, device=dev).to(torch.bfloat16)
        n_tok = T - 5                     # the last 5 rows are padding
        kp1, vp1 = k_pool.clone(), v_pool.clone()
        kp2, vp2 = k_pool.clone(), v_pool.clone()
        kernels.kv_prefill_write(kp1, vp1, rows_k, rows_v, btab, start,
                                 n_tok, layer)
        kernels.kv_prefill_write_plain(kp2, vp2, rows_k, rows_v, btab,
                                       start, n_tok, layer)
        torch.cuda.synchronize()
        if not (torch.equal(kp1, kp2) and torch.equal(vp1, vp2)):
            raise AssertionError(f"kv_prefill_write T={T} start={start}: "
                                 f"pools differ from the twin")
        w_err = max((kp1.float() - kp2.float()).abs().max().item(),
                    (vp1.float() - vp2.float()).abs().max().item())
        del kp2, vp2
        o_k = kernels.prefill_attention(qp, kp1, vp1, btab, start, layer)
        o_p = kernels.prefill_attention_plain(qp, kp1, vp1, btab, start,
                                              layer)
        valid = n_tok
        a_err = (o_k[:valid].float() - o_p[:valid].float()).abs().max().item()
        if not torch.isfinite(o_k).all():
            raise AssertionError("prefill_attention: non-finite output")
        if a_err > ATOL:
            raise AssertionError(f"prefill_attention T={T} start={start}: "
                                 f"max err {a_err} > {ATOL}")
        log(f"[kernels] T={T} start={start}: prefill_attention max_abs_err "
            f"{a_err:.3g}, kv_prefill_write pools bit-exact")
        if (T, start) != (512, 37):
            continue
        # Timings and bounds at the largest chunk with history.
        ms_a = device_ms(lambda i: kernels.prefill_attention(
            qp, kp1, vp1, btab, start, i % L_POOL))
        plain_a = device_ms(lambda i: kernels.prefill_attention_plain(
            qp, kp1, vp1, btab, start, i % L_POOL), iters=5, warmup=1)
        # Library yardstick over the H_kv heads the kernel reads: query
        # head h = g * n_rep + r becomes row t * n_rep + r of KV head g.
        S = start + T
        n_rep = H // HKV
        kh = torch.randn((1, HKV, S, D), generator=gen, device=dev).to(torch.bfloat16)
        vh = torch.randn((1, HKV, S, D), generator=gen, device=dev).to(torch.bfloat16)
        qpos = (start + torch.arange(T, device=dev)).repeat_interleave(n_rep)
        amask = (torch.arange(S, device=dev)[None, :] <= qpos[:, None])
        qh = (qp.reshape(T, HKV, n_rep, D).permute(1, 0, 2, 3)
              .reshape(1, HKV, T * n_rep, D).contiguous())
        lib_a = device_ms(lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=amask))
        pairs = sum(start + t + 1 for t in range(T))
        bms, by = bound(2 * T * H * D * 2 + S * GD * 2 * 2 + MP * 4,
                        pairs * H * 4 * D)
        _record(state, "prefill_attention",
                "llmq_tpu_torch/csrc/prefill_attention.cu",
                "llmq_tpu/ops/pallas/prefill_attention.py:167", a_err, ms_a,
                plain_a, bms, by, lib_a)
        del kh, vh
        ms_w = device_ms(lambda i: kernels.kv_prefill_write(
            kp1, vp1, rows_k, rows_v, btab, start, n_tok, i % L_POOL))
        plain_w = device_ms(lambda i: kernels.kv_prefill_write_plain(
            kp1, vp1, rows_k, rows_v, btab, start, n_tok, i % L_POOL),
            iters=10, warmup=2)
        pos = start + torch.arange(n_tok, device=dev)
        flat_rows = (btab.long()[pos // PS] * PS + pos % PS)

        def lib_write(i):
            base = (i % L_POOL) * P_POOL * PS
            kp1.view(-1, GD).index_copy_(0, base + flat_rows, rows_k[:n_tok])
            vp1.view(-1, GD).index_copy_(0, base + flat_rows, rows_v[:n_tok])
        lib_w = device_ms(lib_write)
        bms, by = bound(n_tok * GD * 2 * 2 * 2 + MP * 4, 0)
        _record(state, "kv_prefill_write", "llmq_tpu_torch/csrc/kv_write.cu",
                "llmq_tpu/ops/pallas/kv_write.py:294", w_err, ms_w, plain_w,
                bms, by, lib_w)

    # -- kernel 4: decode row write -------------------------------------------
    page_of = wp.clone()
    slot_of = ((sl - 1).clamp(min=0) % PS).to(torch.int32)
    kn2, vn2 = kn.reshape(B, GD)[:6], vn.reshape(B, GD)[:6]
    kp1, vp1 = k_pool.clone(), v_pool.clone()
    kp2, vp2 = k_pool.clone(), v_pool.clone()
    kernels.kv_cache_write(kp1, vp1, kn2, vn2, page_of[:6], slot_of[:6], 2)
    kernels.kv_cache_write_plain(kp2, vp2, kn2, vn2, page_of[:6],
                                 slot_of[:6], 2)
    torch.cuda.synchronize()
    if not (torch.equal(kp1, kp2) and torch.equal(vp1, vp2)):
        raise AssertionError("kv_cache_write: pools differ from the twin")
    del kp2, vp2
    ms4 = device_ms(lambda i: kernels.kv_cache_write(
        kp1, vp1, kn2, vn2, page_of[:6], slot_of[:6], i % L_POOL))
    plain4 = device_ms(lambda i: kernels.kv_cache_write_plain(
        kp1, vp1, kn2, vn2, page_of[:6], slot_of[:6], i % L_POOL))
    flat4 = page_of[:6].long() * PS + slot_of[:6].long()

    def lib4(i):
        base = (i % L_POOL) * P_POOL * PS
        kp1.view(-1, GD).index_copy_(0, base + flat4, kn2)
        vp1.view(-1, GD).index_copy_(0, base + flat4, vn2)
    lib4_ms = device_ms(lib4)
    bms, by = bound(6 * GD * 2 * 2 * 2 + 2 * 6 * 4, 0)
    _record(state, "kv_cache_write", "llmq_tpu_torch/csrc/kv_write.cu",
            "llmq_tpu/ops/pallas/kv_write.py:126", 0.0, ms4, plain4, bms, by,
            lib4_ms)
    del kp1, vp1, k_pool, v_pool
    torch.cuda.empty_cache()
    _long_context_timings()


def _long_context_timings() -> None:
    """The two attention kernels at the longest shapes the served
    geometry allows: decode with every row at 2000 cached positions, and
    a full 2048-token prefill chunk. Timing only (correctness is held
    above); a 4-layer pool with room for 8 full block tables."""
    import torch

    from llmq_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    L, P = 4, B * MP + 1
    kp = torch.randn((L, P, PS, GD), generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn((L, P, PS, GD), generator=gen, device=dev).to(torch.bfloat16)
    bt = (1 + torch.arange(B * MP, device=dev, dtype=torch.int32)).reshape(B, MP)
    n = 2000
    sl = torch.full((B,), n, dtype=torch.int32, device=dev)
    wp = bt[:, (n - 1) // PS].contiguous()
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((B, HKV, D), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((B, HKV, D), generator=gen, device=dev).to(torch.bfloat16)
    ms = device_ms(lambda i: kernels.fused_decode(q, kn, vn, kp, vp, bt, sl,
                                                wp, i % L))
    bms, by = bound(B * n * GD * 2 * 2 + 2 * B * H * D * 2, B * n * H * 4 * D)
    log(f"[kernels] fused_decode B={B} seq_len={n}: kernel {ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by}) ({CARD})")
    T = 2048
    qp = torch.randn((T, H, D), generator=gen, device=dev).to(torch.bfloat16)
    ms = device_ms(lambda i: kernels.prefill_attention(qp, kp, vp, bt[0], 0,
                                                     i % L), iters=5)
    bms, by = bound(2 * T * H * D * 2 + T * GD * 2 * 2,
                    T * (T + 1) // 2 * H * 4 * D)
    log(f"[kernels] prefill_attention T={T} start=0: kernel {ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by}) ({CARD})")


def phase_split(state) -> None:
    import torch

    from llmq_tpu_torch.ops.attention import paged_decode_step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    k_pool, v_pool = _pools(gen, dev)
    q, kn, vn, bt, sl, wp, live_lens = _decode_inputs(gen, dev, False)
    slot_of = ((sl - 1) % PS).to(torch.int32)
    kp2, vp2 = k_pool.clone(), v_pool.clone()
    a_f = paged_decode_step(q, kn, vn, k_pool, v_pool, bt, sl, wp, slot_of,
                            4, fused=True)
    a_s = paged_decode_step(q, kn, vn, kp2, vp2, bt, sl, wp, slot_of, 4,
                            fused=False)
    torch.cuda.synchronize()
    nl = len(live_lens)
    err = (a_f[:nl].float() - a_s[:nl].float()).abs().max().item()
    if err > ATOL:
        raise AssertionError(f"split route: max err {err} > {ATOL}")
    if not (torch.equal(k_pool, kp2) and torch.equal(v_pool, vp2)):
        raise AssertionError("split route: pools differ from fused route")
    log(f"[split] fused vs split: attention max_abs_err {err:.3g}, pools "
        f"identical")
    del k_pool, v_pool, kp2, vp2
    torch.cuda.empty_cache()


def phase_model(state) -> None:
    import numpy as np
    import torch

    from llmq_tpu_torch.models.llama import (forward_decode,
                                             forward_prefill, get_config,
                                             init_kv_pages, init_params)

    cfg = get_config("llama3-tiny", dim=512, n_heads=4, n_kv_heads=2,
                     n_layers=2, vocab_size=512, max_seq_len=256)
    params_c = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_g = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.cuda())
                for k, v in params_c.items()}
    rng = np.random.default_rng(0)
    worst = 0.0
    caches = {d: init_kv_pages(cfg, 24, PS, d) for d in ("cpu", "cuda")}
    bt = np.zeros((1, 16), np.int32)
    bt[0, :6] = [3, 7, 1, 9, 4, 12]

    toks = rng.integers(3, 500, (1, 40)).astype(np.int32)
    for start, n, T in ((0, 40, 64), (40, 23, 32)):
        chunk = np.zeros((1, T), np.int32)
        chunk[0, :n] = toks[0, :n] if start == 0 else rng.integers(3, 500, n)
        pos = np.minimum(np.arange(T) + start, start + n - 1)[None].astype(np.int32)
        out = {}
        for dev, params in (("cpu", params_c), ("cuda", params_g)):
            out[dev] = forward_prefill(
                params, cfg, torch.as_tensor(chunk, device=dev),
                torch.as_tensor(pos, device=dev),
                torch.as_tensor([n], dtype=torch.int32, device=dev),
                caches[dev], torch.as_tensor(bt, device=dev)).float().cpu()
        if not torch.isfinite(out["cuda"]).all():
            raise AssertionError("model: non-finite prefill logits")
        e = (out["cuda"][0, :n] - out["cpu"][0, :n]).abs().max().item()
        worst = max(worst, e)
    pos = 63
    tok = int(out["cpu"][0, n - 1].argmax())
    for step in range(4):
        res = {}
        for dev, params in (("cpu", params_c), ("cuda", params_g)):
            res[dev] = forward_decode(
                params, cfg, torch.tensor([tok], dtype=torch.int32,
                                          device=dev),
                torch.tensor([pos], dtype=torch.int32, device=dev),
                caches[dev], torch.as_tensor(bt, device=dev)).float().cpu()
        if res["cuda"].shape != (1, cfg.vocab_size) or \
                not torch.isfinite(res["cuda"]).all():
            raise AssertionError("model: bad decode logits")
        worst = max(worst, (res["cuda"] - res["cpu"]).abs().max().item())
        tok = int(res["cpu"][0].argmax())
        pos += 1
    if worst > MODEL_ATOL:
        raise AssertionError(f"model: card vs CPU logits differ by {worst}")
    log(f"[model] bf16 tiny model (D=128, n_rep=2): card vs CPU logits "
        f"max_abs_err {worst:.3g} (tolerance {MODEL_ATOL})")


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _poll(base, mid, timeout=600.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, m = _http("GET", f"{base}/api/v1/messages/{mid}")
        if m["status"] in ("completed", "failed", "timeout"):
            return m
        time.sleep(0.02)
    raise AssertionError(f"message {mid} did not finish in {timeout} s")


def phase_serve(state) -> None:
    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.engine.engine import (GenRequest,
                                              realtime_admission_cap)
    from llmq_tpu_torch.ops import kernels

    cfg = Config()
    cfg.model.name = "llama3-8b"
    cfg.model.max_seq_len = 2048
    cfg.executor.max_decode_steps = 32
    cfg.device = "cuda"
    t0 = time.perf_counter()
    engine = build_engine(cfg)
    torch.cuda.synchronize()
    mc = engine.executor.model_cfg
    log(f"[serve] built {mc.name} L={mc.n_layers} dim={mc.dim} "
        f"H={mc.n_heads}/{mc.n_kv_heads} ffn={mc.ffn_dim} vocab="
        f"{mc.vocab_size} in {time.perf_counter() - t0:.1f} s; "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB ({CARD})")
    app = App(cfg, engine=engine)
    port = app.start(host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        engine.generate("warm up the card", max_new_tokens=4)
        torch.cuda.synchronize()
        status, health = _http("GET", f"{base}/health")
        assert status == 200 and health["engine"] == "running", health

        # -- the main path: REST → queue → worker → engine → kernels -----
        kernels.reset_launches()
        t_rest = time.perf_counter()
        mids = []
        for i, prio in enumerate(["realtime", "high", "normal", "low",
                                  "normal", "high"]):
            status, r = _http("POST", f"{base}/api/v1/messages", {
                "content": f"Request {i} at {prio} priority: summarise the "
                           f"state of the queue in one line.",
                "priority": prio, "metadata": {"max_new_tokens": 32}})
            assert status == 202, r
            mids.append(r["message_id"])
        turns = []
        for text in ("Hello! Tell me about paged attention, please.",
                     " And now say it again, but shorter."):
            status, r = _http("POST", f"{base}/api/v1/messages", {
                "content": text, "conversation_id": "smoke-conv",
                "priority": "high", "metadata": {"max_new_tokens": 32}})
            assert status == 202, r
            turns.append(_poll(base, r["message_id"]))
        results = [_poll(base, m) for m in mids] + turns
        torch.cuda.synchronize()
        rest_s = time.perf_counter() - t_rest
        launches = dict(kernels.LAUNCHES)
        for m in results:
            u = m["metadata"].get("usage", {})
            if m["status"] != "completed" or \
                    u.get("finish_reason") not in ("eos", "length"):
                raise AssertionError(f"request did not complete: {m}")
        cached = turns[1]["metadata"]["usage"]["cached_tokens"]
        if cached <= 0:
            raise AssertionError(f"turn 2 reports cached_tokens={cached}")
        for name in ("fused_decode", "kv_prefill_write", "prefill_attention"):
            if launches[name] <= 0:
                raise AssertionError(f"serving never launched {name}")
            state["kernels"][name]["launches"] = launches[name]
        tokens = sum(m["metadata"]["usage"]["completion_tokens"]
                     for m in results)
        log(f"[serve] {len(results)} REST requests completed in "
            f"{rest_s:.2f} s, {tokens} tokens; turn 2 cached_tokens "
            f"{cached}; launches {launches} ({CARD})")

        # -- latency and rate, straight through the engine -----------------
        prompt = "The quick brown fox jumps over the lazy dog. " * 2
        h = engine.submit(GenRequest(id="ttft", prompt=prompt,
                                     max_new_tokens=32))
        assert h.wait(120), "ttft request timed out"
        ttft = h.marks["first_token"] - h.submitted_at
        n = len(h.result.tokens)
        rate1 = (n - 1) / (h.finished_at - h.marks["first_token"])
        hs = [engine.submit(GenRequest(id=f"b{i}", prompt=f"{i}: " + prompt,
                                       max_new_tokens=32)) for i in range(8)]
        for x in hs:
            assert x.wait(300), "batch request timed out"
        t_first = min(x.submitted_at for x in hs)
        t_last = max(x.finished_at for x in hs)
        ntok = sum(len(x.result.tokens) for x in hs)
        per_req = [(len(x.result.tokens) - 1)
                   / (x.finished_at - x.marks["first_token"]) for x in hs]
        # The realtime admission cap comes from the executor's measured
        # step time: show both, as a waiting REALTIME request sees them.
        step_ms = engine.executor.step_ms
        if not step_ms or step_ms <= 0:
            raise AssertionError(f"executor step time not measured: {step_ms}")
        cap = realtime_admission_cap(step_ms)
        log(f"[serve] executor step time {step_ms:.2f} ms (moving average); "
            f"realtime admission cap {cap} steps ({CARD})")
        state["serve"] = {"ttft_ms_b1": ttft * 1e3, "decode_tok_s_b1": rate1,
                          "tok_s_b8_e2e": ntok / (t_last - t_first),
                          "decode_tok_s_per_req_b8":
                              sum(per_req) / len(per_req),
                          "prompt_tokens_b1": h.result.prompt_tokens,
                          "executor_step_ms": step_ms,
                          "realtime_admission_cap_steps": cap}
        log(f"[serve] llama3-8b bf16: TTFT {ttft * 1e3:.1f} ms (B=1, "
            f"{h.result.prompt_tokens}-token prompt); decode {rate1:.1f} "
            f"tok/s (B=1); 8 concurrent: {ntok / (t_last - t_first):.1f} "
            f"tok/s end to end, {sum(per_req) / len(per_req):.1f} tok/s per "
            f"request after its first token ({CARD})")

        # -- the split decode route, driven through REST -------------------
        engine.executor.fused_decode = False
        kernels.reset_launches()
        status, r = _http("POST", f"{base}/api/v1/messages", {
            "content": "Split route check.", "priority": "normal",
            "metadata": {"max_new_tokens": 16}})
        m = _poll(base, r["message_id"])
        torch.cuda.synchronize()
        engine.executor.fused_decode = True
        split = dict(kernels.LAUNCHES)
        if m["status"] != "completed" or split["kv_cache_write"] <= 0 \
                or split["fused_decode"] != 0:
            raise AssertionError(f"split route not taken: {m} {split}")
        state["kernels"]["kv_cache_write"]["launches"] = \
            split["kv_cache_write"]
        log(f"[serve] split decode route request completed; launches "
            f"{split}")
        _decode_breakdown(engine, state)
        log(f"[serve] peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({CARD})")
    finally:
        app.stop()


def _decode_breakdown(engine, state) -> None:
    """Where one B=8, 16-step decode chunk of the served model spends its
    time: host wall per step, device busy per step (sum of the kernels'
    device time in a torch.profiler trace) and the top kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    ex = engine.executor
    B, K = ex.spec.batch_size, ex.chunk_size
    pages_per_row = 8
    pages = engine.allocator.alloc(B * pages_per_row)   # idle engine
    bt = np.zeros((B, ex.spec.max_pages_per_seq), np.int32)
    bt[:, :pages_per_row] = np.asarray(pages).reshape(B, pages_per_row)
    args = (np.full(B, 100, np.int32), np.full(B, 64, np.int32), bt,
            np.zeros(B, np.float32), np.full(B, K, np.int32))
    ex.decode_chunk(*args)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.decode_chunk(*args)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / K
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ex.decode_chunk(*args)
        torch.cuda.synchronize()
    engine.allocator.free(pages)
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy_ms = _device_us(prof) / 1e3 / K
    state["serve"].update({"decode_step_wall_ms_b8": wall_ms,
                           "decode_step_device_busy_ms_b8": busy_ms})
    log(f"[serve] decode chunk B={B} K={K}: {wall_ms:.2f} ms/step wall, "
        f"{busy_ms:.2f} ms/step device busy "
        f"({100 * busy_ms / wall_ms:.0f}% busy) ({CARD})")
    for dev_us, key, count in rows[:10]:
        log(f"[serve]   {dev_us / 1e3 / K:8.3f} ms/step  {count // K:5d} "
            f"calls/step  {key[:90]}")


PHASES = [("env", phase_env), ("build", phase_build),
          ("kernels", phase_kernels), ("split", phase_split),
          ("model", phase_model), ("serve", phase_serve)]


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import llmq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    state = {"kernels": {}}
    t_all = time.perf_counter()
    for name, fn in PHASES:
        t0 = time.perf_counter()
        try:
            fn(state)
            torch.cuda.synchronize()
        except Exception:  # noqa: BLE001 — report the phase, then fail
            traceback.print_exc()
            print(f"chip_smoke: phase {name} FAILED", file=sys.stderr)
            return 1
        log(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
    log(f"[all] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": list(state["kernels"].values()),
                      "serve": state["serve"]}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
