#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``llmq_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--phases env,build,kernels]

(``--phases`` runs a subset, e.g. the kernel checks and timings alone.)

Phases, in order (each ends in ``torch.cuda.synchronize()`` so a fault
shows where it happened):

1. env        — torch/CUDA versions, ``nvcc --version``, compute
                 capability, the card's name and power limit (repeated
                 beside every number).
2. build      — compiles the kernels from ``llmq_tpu_torch/csrc`` with nvcc
                 (one process per source, all at once) and prints the
                 seconds.
3. kernels    — each of the eight kernels against its plain PyTorch twin on
                 the card at llama3-8b's per-layer shapes (H=32, H_kv=8,
                 D=128, page_size=16, B=8, max_pages=128; kernels 6 and 7
                 with slices of 100 and 37 tokens, the second over history,
                 packed into N=144): attention within ``ATOL`` (``Q8_ATOL``
                 over int8 pools), pools and scale pools bit-exact; kernel,
                 plain, library times and the bound; kernel 1 also at each
                 candidate split size; kernels 1, 5 and 7 relaunched on
                 their cached workspaces must repeat their output. Then
                 cuBLAS's int8 GEMM with the weight row and column major.
                 Kernels 6 and 7 are also timed by range (their decode
                 rows alone, their slices alone). Then kernels 1, 3, 8,
                 6, 5 and 7 at their longest served shapes (B=8 rows of
                 2000 positions; a 2048-token chunk; the 2000-position
                 rows plus a 128-token slice from 1920; 5 and 7 over
                 int8 pools), held against their twins (also within
                 ``REL_TOL`` of the twin's RMS, which a control with one
                 page of keys wrong must fail) and timed beside decode
                 and causal SDPA (two calls each over int8 pools).
                 Beside kernel 4, the device time of an empty kernel
                 (``torch.cuda._sleep(0)``): the launch floor. Kernels 2
                 and 3 run batched, as the prefill programs launch them:
                 one launch for N=4 rows of T=512 and of T=2048 (live
                 lengths 600, 90 from position 37, 2048 and an unused
                 row of one token; at T=512 clipped to 512), against
                 their twins (at T=2048 also ``REL_TOL``, with the
                 one-wrong-page control), timed beside the bound and
                 one causal SDPA per row; kernel 3 also at T=2048 with
                 600 tokens live (its dead-tile skip).
4. split      — one decode step through ``paged_decode_step(fused=False)``
                 (row-write kernel + decode-attention kernel) against
                 ``fused=True``: same attention within ``ATOL``, identical
                 pools.
5. model      — a small model with the same head geometry, bf16 and then
                 int8 weights with int8 KV: logits of prefill (incl. a
                 continuation chunk), decode, ``forward_mixed`` and
                 ``forward_mixed_ragged`` on the card against the same
                 model on the CPU (plain twins).
6. graphs     — the decode step as a CUDA graph on five llama3-8b
                 engines built with ``warmup=True`` (bf16 default, the
                 same on the split route, bf16 ragged, int8 weights +
                 int8 KV default and ragged): a B=8, 16-step chunk run
                 eagerly and replayed, per step wall and device busy,
                 device kernels and the host's kernel and graph
                 launches, the graph pool's bytes; greedy streams must
                 agree token for token (also with budgets 0..16), and
                 each step must be one replay. Then, on the same
                 engines, every prefill program (each bucket with one
                 row and with ``prefill_batch`` rows; ragged: the ragged
                 step) and the mixed step 0 of each route, replayed
                 against eager: greedy first tokens and streams equal,
                 one replay a program call (and, profiled, one graph
                 launch), the wall of a call, each graph's capture
                 seconds and the bytes it added to the shared pool.
7. serve      — llama3-8b bf16 at full width and depth, random weights
                 from a seed, served by the port's REST server with mixed
                 batching on (the default): messages across all four
                 priorities, a two-turn conversation, and four ~600-token
                 prompts posted while two requests decode (mixed steps
                 must run); every request completes, turn 2 reports cached
                 tokens, and the kernels' launch counts grow during the
                 phase. Then TTFT and decode tok/s, one request through
                 the split decode route, and a mixed chunk timed against a
                 prefill plus a decode chunk. Then a second engine on the
                 same weights with ragged attention on serves the same
                 mix: the ragged kernel and the prefill write launch, the
                 bucket prefill attention does not. Each engine is built
                 with ``warmup=True``; its calibrated step time and the
                 realtime admission cap it sets are printed, and TTFT and
                 the B=1 rate are medians of three requests (TTFT also
                 with the prefill programs run eagerly). Four ~600-token
                 prompts with no decode row are admitted as one wave
                 (``prefill_multi_async``) and as four single programs.
8. serve-int8 — llama3-8b with int8 weights and int8 KV at full width and
                 depth (``LLMQ_MODEL_QUANTIZATION=int8
                 LLMQ_MODEL_KV_QUANTIZATION=int8``), the same REST mix:
                 kernel 5 launches and no bf16-pool kernel does; then a
                 second engine on the same weights with ragged attention
                 on: kernel 7 launches. Rates, the decode breakdown,
                 the plain int8 prefill attention's share of the int8
                 TTFT program, the wave admission, weight bytes and
                 peak memory.

No ``*_plain`` twin may be called while serving. On the card every
decode step, prefill program and mixed step 0 is a replay of one of the
executor's captured graphs; the launch counts add each replay's
kernels. Each engine's graphs are released before the next is built.

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
# Over a long history an output element is small (about sqrt(e / n) over
# n keys of unit-normal q, K and V: 0.037 at 2000), so at the long shapes
# ATOL alone would pass a kernel that loses a page of keys; there each
# (row, head) is also held to REL_TOL of its twin's RMS.
REL_TOL = 0.1
# int8 K/V (kernels 5 and 7): the kernels scale the logits and the
# probabilities in f32 where the twins round the dequantized K/V to bf16;
# the JAX package's own int8 kernel-vs-plain tolerance.
Q8_ATOL = 3e-2
# Tiny-model logits after several bf16 layers (f32 logits, unit scale).
MODEL_ATOL = 1e-1
# The same with int8 weights and int8 KV: a value one bf16 rounding apart
# between card and CPU can quantize to the neighbouring int8 value, and
# int8 activations pass that on (the CPU tests see 0.04 on f32 logits
# between the two packages for one such flip).
MODEL_Q8_ATOL = 3e-1
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak

H, HKV, D, PS, B, MP = 32, 8, 128, 16, 8, 128
GD = HKV * D
L_POOL, P_POOL = 32, 512        # the served pool: 32 layers x 512 pages

CARD = ""
T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line, prefixed with the seconds since the script started."""
    print(f"{time.perf_counter() - T0:7.1f}s {msg}", flush=True)


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


def scaled_err(out, ref) -> float:
    """Largest max |out - ref| / RMS(ref) over the (row, head) vectors
    whose reference is not all zero."""
    d = (out.float() - ref.float()).abs().amax(-1)
    rms = ref.float().pow(2).mean(-1).sqrt()
    live = rms > 0
    return (d[live] / rms[live]).max().item()


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn(i)``: the summed durations of the
    kernels it launched over ``iters`` calls (torch.profiler, device
    events only), divided by ``iters``. Gaps while the host prepares the
    next launch are not counted — at these sizes a CUDA-event loop would
    measure the Python wrapper, not the kernel. Every call launches a
    kernel at least, so a trace with fewer kernels than calls lost
    events: it is taken again, twice at most, then the script fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        n = _kernel_events(prof)
        if n >= iters:
            return _device_us(prof) / 1e3 / iters
        log(f"[trace] {n} kernels recorded for {iters} calls: tracing "
            f"again")
    raise AssertionError(f"the profiler recorded {n} kernels for {iters} "
                         f"calls, three times")


def _kernel_events(prof) -> int:
    """Kernels in a trace (device events that are not copies or sets)."""
    import torch

    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


def _device_trace(fn):
    """Run ``fn()`` once under torch.profiler recording device activity
    only (host-op events of whole served steps would cost the trace more
    than the steps) and return the profile; raises if it holds no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if _device_us(prof) <= 0:
        raise AssertionError("the profiler recorded no device time")
    return prof


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
            if any(w in line for w in ("registers", "spill", "Compiling "
                                       "entry", "Performance", "arning")) \
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


def _sdpa_decode(gen, dev, q, sl, S):
    """Library yardstick for decode attention: SDPA over dense K/V of the
    H_kv heads the kernel reads, each group's n_rep query heads riding as
    n_rep query rows of one KV head (no K/V expanded to H heads). A dense
    call pads every row to the longest seq_len S. Returns a callable."""
    import torch
    import torch.nn.functional as F

    Bq = q.shape[0]
    kd = torch.randn((Bq, HKV, S, D), generator=gen, device=dev).to(torch.bfloat16)
    vd = torch.randn((Bq, HKV, S, D), generator=gen, device=dev).to(torch.bfloat16)
    mask = (torch.arange(S, device=dev)[None, :]
            < sl[:, None].to(torch.long))[:, None, None, :]
    mask[sl == 0] = True                 # SDPA needs a visible key per row
    q4 = q.reshape(Bq, HKV, H // HKV, D)
    return lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)


def _sdpa_prefill(gen, dev, qp, start):
    """Library yardstick for causal prefill attention with history: SDPA
    over dense K/V of the H_kv heads; query head h = g * n_rep + r of
    token t becomes row t * n_rep + r of KV head g. Returns a callable."""
    import torch
    import torch.nn.functional as F

    T = qp.shape[0]
    S = start + T
    n_rep = H // HKV
    kh = torch.randn((1, HKV, S, D), generator=gen, device=dev).to(torch.bfloat16)
    vh = torch.randn((1, HKV, S, D), generator=gen, device=dev).to(torch.bfloat16)
    qpos = (start + torch.arange(T, device=dev)).repeat_interleave(n_rep)
    amask = torch.arange(S, device=dev)[None, :] <= qpos[:, None]
    qh = (qp.reshape(T, HKV, n_rep, D).permute(1, 0, 2, 3)
          .reshape(1, HKV, T * n_rep, D).contiguous())
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=amask)


def _desc(dev, *cols):
    """Per-row int32 descriptors of kernels 2 and 3 on the card."""
    import torch

    return [torch.tensor(c, dtype=torch.int32, device=dev) for c in cols]


def _write1(fn, kp, vp, rk, rv, btab, desc, layer):
    """Kernel 2 (or its twin) for one chunk: the batched call, N=1, with
    ``desc`` = ``_desc(dev, [0], [n_tok], [start])`` made once outside
    any timed call (its uploads would be timed with the kernel)."""
    fn(kp, vp, rk, rv, btab[None], *desc, rk.shape[0], layer)


def _attn1(fn, qp, kp, vp, btab, desc, layer):
    """Kernel 3 (or its twin) for one chunk qp (T, H, D): the batched
    call, N=1, with ``desc`` = ``_desc(dev, [start], [live tokens])``."""
    return fn(qp[None], kp, vp, btab[None], *desc, layer)[0]


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
    # Many launches on the same split workspace later, the arrival
    # counters are back at 0: the same inputs give the same output.
    again = kernels.fused_decode(q, kn, vn, kp1, vp1, bt, sl, wp, layer)
    torch.cuda.synchronize()
    if not torch.equal(again[:nl], out_k[:nl]):
        raise AssertionError("fused_decode: a later launch on the cached "
                             "workspace differs from the first")
    plain_ms = device_ms(lambda i: kernels.fused_decode_plain(
        q, kn, vn, kp1, vp1, bt, sl, wp, i % L_POOL), iters=5, warmup=1)
    sdpa_dec = _sdpa_decode(gen, dev, q, sl, max(live_lens))
    lib_ms = device_ms(lambda i: sdpa_dec())
    n_pos = sum(live_lens) + 5
    bytes_moved = (2 * B * H * D * 2 + 2 * B * GD * 2 + B * MP * 4 + 2 * B * 4
                   + (n_pos - 7) * GD * 2 * 2 + 7 * GD * 2 * 2)
    flops = n_pos * H * 4 * D
    bms, by = bound(bytes_moved, flops)
    _record(state, "fused_decode", "llmq_tpu_torch/csrc/fused_decode.cu",
            "llmq_tpu/ops/pallas/fused_decode.py:370", err, ms, plain_ms,
            bms, by, lib_ms)
    chunk_ms = _chunk_sweep(lambda i: kernels.fused_decode(
        q, kn, vn, kp1, vp1, bt, sl, wp, i % L_POOL))
    state["kernels"]["fused_decode"]["ms_by_chunk"] = chunk_ms
    log("[kernels] fused_decode by chunk, ms: "
        + ", ".join(f"{c}: {t:.4f}" for c, t in chunk_ms.items())
        + f" ({CARD})")

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
        wdesc = _desc(dev, [0], [n_tok], [start])
        adesc = _desc(dev, [start], [T])
        _write1(kernels.kv_prefill_write, kp1, vp1, rows_k, rows_v, btab,
                wdesc, layer)
        _write1(kernels.kv_prefill_write_plain, kp2, vp2, rows_k, rows_v,
                btab, wdesc, layer)
        torch.cuda.synchronize()
        if not (torch.equal(kp1, kp2) and torch.equal(vp1, vp2)):
            raise AssertionError(f"kv_prefill_write T={T} start={start}: "
                                 f"pools differ from the twin")
        w_err = max((kp1.float() - kp2.float()).abs().max().item(),
                    (vp1.float() - vp2.float()).abs().max().item())
        del kp2, vp2
        o_k = _attn1(kernels.prefill_attention, qp, kp1, vp1, btab, adesc,
                     layer)
        o_p = _attn1(kernels.prefill_attention_plain, qp, kp1, vp1, btab,
                     adesc, layer)
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
        ms_a = device_ms(lambda i: _attn1(
            kernels.prefill_attention, qp, kp1, vp1, btab, adesc, i % L_POOL))
        plain_a = device_ms(lambda i: _attn1(
            kernels.prefill_attention_plain, qp, kp1, vp1, btab, adesc,
            i % L_POOL), iters=5, warmup=1)
        S = start + T
        sdpa_pf = _sdpa_prefill(gen, dev, qp, start)
        lib_a = device_ms(lambda i: sdpa_pf())
        del sdpa_pf
        pairs = sum(start + t + 1 for t in range(T))
        bms, by = bound(2 * T * H * D * 2 + S * GD * 2 * 2 + MP * 4,
                        pairs * H * 4 * D)
        _record(state, "prefill_attention",
                "llmq_tpu_torch/csrc/prefill_attention.cu",
                "llmq_tpu/ops/pallas/prefill_attention.py:167", a_err, ms_a,
                plain_a, bms, by, lib_a)
        ms_w = device_ms(lambda i: _write1(
            kernels.kv_prefill_write, kp1, vp1, rows_k, rows_v, btab, wdesc,
            i % L_POOL))
        plain_w = device_ms(lambda i: _write1(
            kernels.kv_prefill_write_plain, kp1, vp1, rows_k, rows_v, btab,
            wdesc, i % L_POOL), iters=10, warmup=2)
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
    # The launch floor: the device time of a kernel that does nothing.
    floor = device_ms(lambda i: torch.cuda._sleep(0))
    state["launch_floor_ms"] = floor
    log(f"[kernels] launch floor: an empty kernel (torch.cuda._sleep(0)) "
        f"takes {floor:.4f} ms of device time, kv_cache_write {ms4:.4f} ms "
        f"({CARD})")
    del kp1, vp1
    _kernel_batched_prefill(state, gen, k_pool, v_pool)
    _kernel_paged_decode(state, gen, k_pool, v_pool)
    _kernel_ragged(state, gen, k_pool, v_pool)
    del k_pool, v_pool
    torch.cuda.empty_cache()
    pools = _q8_pools(gen, dev)
    _kernel_fused_decode_q8(state, gen, pools)
    _kernel_ragged_q8(state, gen, pools)
    del pools
    torch.cuda.empty_cache()
    _int_mm_layouts(state)
    _long_shapes(state)


#: The batched checks of kernels 2 and 3: N=4 rows of T tokens, live
#: lengths (a 600-token prompt, a 90-token continuation from 37, a full
#: row, an unused row of one token on the null page) and starts.
BATCHED = ((512, (512, 90, 512, 1), (0, 37, 0, 0)),
           (2048, (600, 90, 2048, 1), (0, 37, 0, 0)))


def _kernel_batched_prefill(state, gen, k_pool, v_pool) -> None:
    """Kernels 2 and 3 as the prefill programs launch them: one launch
    for the N=4 rows of a batch (``BATCHED``), descriptors on the card.
    The pools against the scatter twin bit-exact; the live rows within
    ``ATOL`` (and, at T=2048, ``REL_TOL`` of the twin's RMS, which a
    twin reading one wrong page must fail), the rest zero. Times beside
    the bound (live work only), the twins, and the library: one causal
    SDPA per row, summed (kernel 3), one ``index_copy_`` of the live rows
    (kernel 2). Recorded as ``batched`` in the kernels' entries."""
    import torch

    from llmq_tpu_torch.ops import kernels

    dev = k_pool.device
    layer = 6
    for T, lengths, starts in BATCHED:
        N = len(lengths)
        need = [-(-(s + n) // PS) for s, n in zip(starts, lengths)]
        perm = (torch.randperm(P_POOL - 1, generator=torch.Generator()
                               .manual_seed(T)) + 1).to(torch.int32)
        bt = torch.zeros((N, MP), dtype=torch.int32)
        nxt = 0
        for i, (n, k) in enumerate(zip(lengths, need)):
            if n > 1:                      # the unused row: all page 0
                bt[i, :k] = perm[nxt:nxt + k]
                nxt += k
        bt = bt.to(dev)
        off, ln, st = _desc(dev, [i * T for i in range(N)], lengths, starts)
        q = torch.randn((N, T, H, D), generator=gen, device=dev).to(torch.bfloat16)
        rk = torch.randn((N * T, GD), generator=gen, device=dev).to(torch.bfloat16)
        rv = torch.randn((N * T, GD), generator=gen, device=dev).to(torch.bfloat16)
        kp1, vp1 = k_pool.clone(), v_pool.clone()
        kp2, vp2 = k_pool.clone(), v_pool.clone()
        kernels.kv_prefill_write(kp1, vp1, rk, rv, bt, off, ln, st, T, layer)
        kernels.kv_prefill_write_plain(kp2, vp2, rk, rv, bt, off, ln, st, T,
                                       layer)
        torch.cuda.synchronize()
        if not (torch.equal(kp1, kp2) and torch.equal(vp1, vp2)):
            raise AssertionError(f"kv_prefill_write N={N} T={T}: pools "
                                 f"differ from the twin")
        del kp2, vp2
        o_k = kernels.prefill_attention(q, kp1, vp1, bt, st, ln, layer)
        o_p = kernels.prefill_attention_plain(q, kp1, vp1, bt, st, ln, layer)
        torch.cuda.synchronize()
        if not torch.isfinite(o_k).all():
            raise AssertionError(f"prefill_attention N={N} T={T}: "
                                 f"non-finite output")
        err = rel = 0.0
        for n, live in enumerate(lengths):
            err = max(err, (o_k[n, :live].float() - o_p[n, :live].float())
                      .abs().max().item())
            rel = max(rel, scaled_err(o_k[n, :live], o_p[n, :live]))
            if live < T and o_k[n, live:].abs().max().item() != 0.0:
                raise AssertionError(f"prefill_attention N={N} T={T}: row "
                                     f"{n} is not zero past its length")
        if err > ATOL or (T == 2048 and rel > REL_TOL):
            raise AssertionError(f"prefill_attention N={N} T={T}: max err "
                                 f"{err} > {ATOL} or scaled err {rel} > "
                                 f"{REL_TOL}")
        entry = {"shape": f"N={N} T={T} lengths={list(lengths)} "
                          f"starts={list(starts)}",
                 "max_abs_err": err, "scaled_err": rel}
        if T == 2048:
            bad = _wrong_page(bt)
            ctl = kernels.prefill_attention_plain(q, kp1, vp1, bad, st, ln,
                                                  layer)
            ctl_rel = scaled_err(ctl[2], o_p[2])
            if ctl_rel <= REL_TOL:
                raise AssertionError(f"prefill_attention N={N} T={T}: the "
                                     f"scaled check passes a wrong page "
                                     f"({ctl_rel})")
            entry["control_scaled_err"] = ctl_rel
            del ctl, bad
        del o_p
        ms = device_ms(lambda i: kernels.prefill_attention(
            q, kp1, vp1, bt, st, ln, i % L_POOL), iters=10)
        plain_ms = device_ms(lambda i: kernels.prefill_attention_plain(
            q, kp1, vp1, bt, st, ln, i % L_POOL), iters=3, warmup=1)
        lib_ms = 0.0
        for n, (live, start) in enumerate(zip(lengths, starts)):
            sdpa = _sdpa_prefill(gen, dev, q[n, :live], start)
            lib_ms += device_ms(lambda i: sdpa(), iters=10)
            del sdpa
        live_rows = sum(lengths)
        pairs = sum(s + t + 1 for s, n in zip(starts, lengths)
                    for t in range(n))
        bms, by = bound(live_rows * H * D * 2 + N * T * H * D * 2
                        + sum(s + n for s, n in zip(starts, lengths))
                        * GD * 2 * 2 + N * (MP + 2) * 4,
                        pairs * H * 4 * D)
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=lib_ms, library="causal SDPA per row, summed")
        state["kernels"]["prefill_attention"].setdefault(
            "batched", {})[f"N{N}xT{T}"] = entry
        log(f"[kernels] prefill_attention batched N={N} T={T} lengths "
            f"{list(lengths)} starts {list(starts)}: max_abs_err {err:.3g} "
            f"scaled {rel:.3g}"
            + (f" (control, one wrong page: scaled "
               f"{entry['control_scaled_err']:.3g})" if T == 2048 else "")
            + f"; one launch {ms:.4f} ms, plain {plain_ms:.4f} ms, causal "
            f"SDPA per row summed {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}) "
            f"({CARD})")
        ms_w = device_ms(lambda i: kernels.kv_prefill_write(
            kp1, vp1, rk, rv, bt, off, ln, st, T, i % L_POOL))
        plain_w = device_ms(lambda i: kernels.kv_prefill_write_plain(
            kp1, vp1, rk, rv, bt, off, ln, st, T, i % L_POOL),
            iters=5, warmup=1)
        src = torch.cat([n * T + torch.arange(live, device=dev)
                         for n, live in enumerate(lengths)])
        pos = torch.cat([s + torch.arange(live, device=dev)
                         for s, live in zip(starts, lengths)])
        owner = torch.cat([torch.full((live,), n, device=dev)
                           for n, live in enumerate(lengths)])
        flat = bt.long()[owner, pos // PS] * PS + pos % PS
        rks, rvs = rk[src], rv[src]

        def lib_write(i):
            base = (i % L_POOL) * P_POOL * PS
            kp1.view(-1, GD).index_copy_(0, base + flat, rks)
            vp1.view(-1, GD).index_copy_(0, base + flat, rvs)
        lib_w = device_ms(lib_write)
        bms_w, by_w = bound(live_rows * GD * 2 * 2 * 2 + N * (MP + 3) * 4, 0)
        state["kernels"]["kv_prefill_write"].setdefault(
            "batched", {})[f"N{N}xT{T}"] = {
                "shape": entry["shape"], "max_abs_err": 0.0, "ms": ms_w,
                "plain_ms": plain_w, "bound_ms": bms_w, "bound_by": by_w,
                "library_ms": lib_w}
        log(f"[kernels] kv_prefill_write batched N={N} T={T}: pools "
            f"bit-exact; one launch {ms_w:.4f} ms, plain {plain_w:.4f} ms, "
            f"index_copy_ {lib_w:.4f} ms, bound {bms_w:.4f} ms ({by_w}) "
            f"({CARD})")
        del kp1, vp1, q, rk, rv
        torch.cuda.empty_cache()


def _kernel_paged_decode(state, gen, k_pool, v_pool) -> None:
    """Kernel 8 on kernel 1's decode rows (layer 4 of the served pool):
    every position, the newest included, is read from the pool."""
    import torch

    from llmq_tpu_torch.ops import kernels

    dev = k_pool.device
    q, _kn, _vn, bt, sl, _wp, live_lens = _decode_inputs(gen, dev, True)
    layer = 4
    out_k = kernels.paged_decode_attention(q, k_pool, v_pool, bt, sl, layer)
    out_p = kernels.paged_decode_attention_plain(q, k_pool, v_pool, bt, sl,
                                                 layer)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k).all():
        raise AssertionError("paged_decode_attention: non-finite output")
    err = (out_k[:7].float() - out_p[:7].float()).abs().max().item()
    if err > ATOL:
        raise AssertionError(f"paged_decode_attention: max err {err} > {ATOL}")
    if out_k[7].abs().max().item() != 0.0:
        raise AssertionError("paged_decode_attention: empty row is not 0")
    ms = device_ms(lambda i: kernels.paged_decode_attention(
        q, k_pool, v_pool, bt, sl, i % L_POOL))
    plain_ms = device_ms(lambda i: kernels.paged_decode_attention_plain(
        q, k_pool, v_pool, bt, sl, i % L_POOL), iters=5, warmup=1)
    sdpa_dec = _sdpa_decode(gen, dev, q, sl, max(live_lens))
    lib_ms = device_ms(lambda i: sdpa_dec())
    n_pos = sum(live_lens) + 5           # + the inactive row's 5 positions
    bms, by = bound(2 * B * H * D * 2 + n_pos * GD * 2 * 2 + B * MP * 4
                    + B * 4, n_pos * H * 4 * D)
    _record(state, "paged_decode_attention",
            "llmq_tpu_torch/csrc/paged_decode.cu",
            "llmq_tpu/ops/pallas/paged_attention.py:193", err, ms, plain_ms,
            bms, by, lib_ms)


#: The smoke's ragged slices (qstart, qlen, qoff): 100 fresh tokens, 37
#: tokens over 300 positions of history, an unused slice row; packed
#: into RAGGED_N rows on q-blocks of 8.
RAGGED_SLICES = [(0, 100, 0), (300, 37, 104), (0, 0, 0)]
RAGGED_N = 144


def _ragged_inputs(gen, dev):
    """Kernel 1's decode rows and the RAGGED_SLICES on pages of their own:
    (q, k_new, v_new, q_pf, (block_tables, seq_lens, write_page, qoff,
    qlen, qstart), live packed rows, live decode lengths)."""
    import torch

    q, kn, vn, bt, sl, wp, live_lens = _decode_inputs(gen, dev, True)
    perm = torch.randperm(P_POOL - 1,
                          generator=torch.Generator().manual_seed(1)) + 1
    nxt = sum(-(-n // PS) for n in live_lens)     # after the decode rows
    pf_bt = torch.zeros((len(RAGGED_SLICES), MP), dtype=torch.int32)
    live = torch.zeros(RAGGED_N, dtype=torch.bool, device=dev)
    for s, (st, n, off) in enumerate(RAGGED_SLICES):
        pages = -(-(st + n) // PS)
        pf_bt[s, :pages] = perm[nxt:nxt + pages].to(torch.int32)
        nxt += pages
        live[off:off + n] = True
    bt_all = torch.cat([bt, pf_bt.to(dev)]).contiguous()
    sl_all = torch.cat([sl, torch.tensor([st + n for st, n, _ in RAGGED_SLICES],
                                         dtype=torch.int32, device=dev)])
    qoff, qlen, qstart = (torch.tensor(v, dtype=torch.int32, device=dev)
                          for v in zip(*((o, n, st)
                                         for st, n, o in RAGGED_SLICES)))
    q_pf = torch.randn((RAGGED_N, H, D), generator=gen,
                       device=dev).to(torch.bfloat16)
    return (q, kn, vn, q_pf, (bt_all, sl_all, wp, qoff, qlen, qstart), live,
            live_lens)


def _kernel_ragged(state, gen, k_pool, v_pool) -> None:
    """Kernel 6 at a served mixed step's shapes: kernel 1's 8 decode rows
    (one inactive, one empty) and slices of 100 and 37 tokens starting at
    positions 0 and 300 (the second over history in the pool), plus one
    unused slice row, packed into N=144 (segments on q-blocks of 8);
    layer 4 of the served pool."""
    import torch

    from llmq_tpu_torch.ops import kernels

    dev = k_pool.device
    q, kn, vn, q_pf, args, live, live_lens = _ragged_inputs(gen, dev)
    layer = 4
    kp1, vp1 = k_pool.clone(), v_pool.clone()
    kp2, vp2 = k_pool.clone(), v_pool.clone()
    d_k, p_k = kernels.ragged_mixed_attention(q, kn, vn, q_pf, kp1, vp1,
                                              *args, layer)
    torch.cuda.synchronize()
    d_p, p_p = kernels.ragged_mixed_attention_plain(q, kn, vn, q_pf, kp2,
                                                    vp2, *args, layer)
    if not (torch.isfinite(d_k).all() and torch.isfinite(p_k).all()):
        raise AssertionError("ragged_mixed_attention: non-finite output")
    err = max((d_k[:7].float() - d_p[:7].float()).abs().max().item(),
              (p_k[live].float() - p_p[live].float()).abs().max().item())
    if err > ATOL:
        raise AssertionError(f"ragged_mixed_attention: max err {err} > {ATOL}")
    if d_k[7].abs().max().item() != 0.0 or \
            p_k[~live].abs().max().item() != 0.0:
        raise AssertionError("ragged_mixed_attention: empty decode row or "
                             "rows outside the slices are not 0")
    if not (torch.equal(kp1, kp2) and torch.equal(vp1, vp2)):
        raise AssertionError("ragged_mixed_attention: pools differ from "
                             "the twin")
    del kp2, vp2
    ms = device_ms(lambda i: kernels.ragged_mixed_attention(
        q, kn, vn, q_pf, kp1, vp1, *args, i % L_POOL))
    plain_ms = device_ms(lambda i: kernels.ragged_mixed_attention_plain(
        q, kn, vn, q_pf, kp1, vp1, *args, i % L_POOL), iters=5, warmup=1)
    # Library yardstick: the decode call of kernels 1 and 8 plus one
    # causal SDPA call per slice on that slice's dense K/V of the 8 KV
    # heads, summed.
    calls = [_sdpa_decode(gen, dev, q, args[1][:B], max(live_lens))] + [
        _sdpa_prefill(gen, dev, q_pf[off:off + n], st)
        for st, n, off in RAGGED_SLICES if n]
    lib_ms = device_ms(lambda i: [c() for c in calls])
    del calls
    dec_ms, slice_ms = _ragged_ranges(kernels.ragged_mixed_attention, q,
                                      (kn, vn), q_pf, (kp1, vp1), args)
    del kp1, vp1
    n_pos = sum(live_lens) + 5
    N = RAGGED_N
    pf_pos = sum(st + n for st, n, _ in RAGGED_SLICES)
    pairs = sum(st + t + 1 for st, n, _ in RAGGED_SLICES for t in range(n))
    bytes_moved = (2 * B * H * D * 2 + 2 * B * GD * 2 + (n_pos - 7) * GD * 4
                   + 7 * GD * 4 + 2 * N * H * D * 2 + pf_pos * GD * 2 * 2
                   + (B + 3) * MP * 4 + (2 * B + 3 * 4) * 4)
    bms, by = bound(bytes_moved, (n_pos + pairs) * H * 4 * D)
    _record(state, "ragged_mixed_attention",
            "llmq_tpu_torch/csrc/ragged_attention.cu",
            "llmq_tpu/ops/pallas/ragged_paged_attention.py:474", err, ms,
            plain_ms, bms, by, lib_ms)
    state["kernels"]["ragged_mixed_attention"].update(
        {"ms_decode_range": dec_ms, "ms_slice_range": slice_ms})
    log(f"[kernels] ragged_mixed_attention by range: decode rows alone "
        f"{dec_ms:.4f} ms, slices alone {slice_ms:.4f} ms ({CARD})")


def _ragged_ranges(fn, q, new, q_pf, pools, args):
    """Device ms of ``fn`` (kernel 6's or kernel 7's wrapper, called as
    ``fn(q, *new, q_pf, *pools, *args, layer)``) for each range of its
    grid alone: the same decode rows with every slice at qlen 0 (each
    slice block then only writes its zeros), and the same slices with no
    decode row (B=0)."""
    import torch

    bt, sl, wp, qoff, qlen, qstart = args
    B, L = q.shape[0], pools[0].shape[0]
    no_slices = (bt, sl, wp, qoff, torch.zeros_like(qlen), qstart)
    dec_ms = device_ms(lambda i: fn(q, *new, q_pf, *pools, *no_slices, i % L))
    no_rows = (bt[B:], sl[B:], wp[:0], qoff, qlen, qstart)
    none = [t[:0] for t in new]
    slice_ms = device_ms(lambda i: fn(q[:0], *none, q_pf, *pools, *no_rows,
                                      i % L))
    return dec_ms, slice_ms


def _q8_pools(gen, dev, L=L_POOL, P=P_POOL):
    """int8 pools (L, P, ps, GD), by default the served 32 layers x 512
    pages, and their (L, P, H_kv, ps) bf16 scale pools, filled with
    unit-scale values quantized per (row, head) by the port's own
    quantize_kv_rows; in the wrappers' order (k, v, k scales, v
    scales)."""
    import torch

    from llmq_tpu_torch.ops.quant import quantize_kv_rows

    out = []
    for _ in range(2):
        x = torch.randn((L, P, PS, HKV, D), generator=gen, device=dev)
        q, sc = quantize_kv_rows(x)
        del x
        out.append((q.reshape(L, P, PS, GD), sc.transpose(2, 3).contiguous()))
    (kq, ks), (vq, vs) = out
    return [kq, vq, ks, vs]


def _q8_rows(x):
    """bf16 rows (B, H_kv, D) → int8 rows and (B, H_kv) bf16 scales."""
    from llmq_tpu_torch.ops.quant import quantize_kv_rows

    q, sc = quantize_kv_rows(x)
    return q.contiguous(), sc.contiguous()


def _sdpa_q8(gen, dev, q_rows, S, mask):
    """Library yardstick over int8 K/V: two calls, one elementwise
    dequantize of the gathered dense K and V window (int8 times its bf16
    scales, K and V stacked) and the SDPA call of rows 1 and 3 on the
    result; ``q_rows`` (Bq, H_kv, rows, D), the window (Bq, H_kv, S, D).
    Returns a callable."""
    import torch
    import torch.nn.functional as F

    Bq = q_rows.shape[0]
    kv = torch.randint(-127, 128, (2, Bq, HKV, S, D), generator=gen,
                       device=dev, dtype=torch.int8)
    sc = (torch.rand((2, Bq, HKV, S, 1), generator=gen, device=dev)
          * 0.02).to(torch.bfloat16)

    def call():
        d = kv * sc                                   # int8 x bf16 → bf16
        return F.scaled_dot_product_attention(q_rows, d[0], d[1],
                                              attn_mask=mask)
    return call


def _q8_library(gen, dev, q, sl, S, q_pf=None, slices=()):
    """The yardstick of kernels 5 and 7: ``_sdpa_q8``'s two calls for the
    decode rows q (B, H, D) of seq_lens ``sl`` over an S-position window,
    plus two (dequantize, causal SDPA) per live slice (qstart, qlen,
    qoff) of ``q_pf``. Returns one callable."""
    import torch

    mask = (torch.arange(S, device=dev)[None, :]
            < sl[:, None].to(torch.long))[:, None, None, :]
    mask[sl == 0] = True                 # SDPA needs a visible key per row
    n_rep = H // HKV
    calls = [_sdpa_q8(gen, dev, q.reshape(q.shape[0], HKV, n_rep, D), S,
                      mask)]
    for st, n, off in slices:
        if not n:
            continue
        qpos = (st + torch.arange(n, device=dev)).repeat_interleave(n_rep)
        amask = torch.arange(st + n, device=dev)[None, :] <= qpos[:, None]
        qh = (q_pf[off:off + n].reshape(n, HKV, n_rep, D).permute(1, 0, 2, 3)
              .reshape(1, HKV, n * n_rep, D).contiguous())
        calls.append(_sdpa_q8(gen, dev, qh, st + n, amask))
    return lambda: [c() for c in calls]


def _q8_decode_bytes(n_pos: int, n_new: int) -> int:
    """Bytes of a decode step over int8 pools: q and the output, the new
    rows and scales read and written, ``n_pos - n_new`` cached positions
    of int8 K/V and their scales, the tables."""
    per_pos = 2 * GD + 2 * HKV * 2
    return (2 * B * H * D * 2 + 2 * (2 * B * GD + 2 * B * HKV * 2)
            + (n_pos - n_new) * per_pos + B * MP * 4 + 2 * B * 4)


def _same_pools(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def _kernel_fused_decode_q8(state, gen, pools) -> None:
    """Kernel 5 on kernel 1's decode rows (six live across page edges,
    one inactive, one empty) over the served int8 pools, layer 3; the
    new rows quantized by the port's quantize_kv_rows as the route
    does."""
    import torch

    from llmq_tpu_torch.ops import kernels

    dev = pools[0].device
    q, kn, vn, bt, sl, wp, live_lens = _decode_inputs(gen, dev, True)
    new = (*_q8_rows(kn), *_q8_rows(vn))
    layer = 3
    p1 = [t.clone() for t in pools]
    p2 = [t.clone() for t in pools]
    out_k = kernels.fused_decode_q8(q, *new, *p1, bt, sl, wp, layer)
    torch.cuda.synchronize()
    out_p = kernels.fused_decode_q8_plain(q, *new, *p2, bt, sl, wp, layer)
    nl = len(live_lens)
    if not torch.isfinite(out_k).all():
        raise AssertionError("fused_decode_q8: non-finite output")
    err = (out_k[:nl].float() - out_p[:nl].float()).abs().max().item()
    if err > Q8_ATOL:
        raise AssertionError(f"fused_decode_q8: max err {err} > {Q8_ATOL}")
    if out_k[7].abs().max().item() != 0.0:
        raise AssertionError("fused_decode_q8: zero-length row is not 0")
    if not _same_pools(p1, p2):
        raise AssertionError("fused_decode_q8: pools or scale pools differ "
                             "from the twin")
    del p2
    ms = device_ms(lambda i: kernels.fused_decode_q8(
        q, *new, *p1, bt, sl, wp, i % L_POOL))
    # Many launches on the same split workspace later, the arrival
    # counters are back at 0: the same inputs give the same output.
    again = kernels.fused_decode_q8(q, *new, *p1, bt, sl, wp, layer)
    torch.cuda.synchronize()
    if not torch.equal(again[:nl], out_k[:nl]):
        raise AssertionError("fused_decode_q8: a later launch on the cached "
                             "workspace differs from the first")
    plain_ms = device_ms(lambda i: kernels.fused_decode_q8_plain(
        q, *new, *p1, bt, sl, wp, i % L_POOL), iters=5, warmup=1)
    lib = _q8_library(gen, dev, q, sl, max(live_lens))
    lib_ms = device_ms(lambda i: lib())
    del p1, lib
    n_pos = sum(live_lens) + 5
    bms, by = bound(_q8_decode_bytes(n_pos, 7), n_pos * H * 4 * D)
    _record(state, "fused_decode_q8", "llmq_tpu_torch/csrc/fused_decode.cu",
            "llmq_tpu/ops/pallas/fused_decode.py:774", err, ms, plain_ms,
            bms, by, lib_ms)


def _kernel_ragged_q8(state, gen, pools) -> None:
    """Kernel 7 at kernel 6's mixed shapes (the 8 decode rows, slices of
    100 and 37 tokens at positions 0 and 300, an unused slice row, N=144)
    over the served int8 pools, layer 4; the slices' int8 K/V and scales
    are the pool's own. Also timed by range, as kernel 6 is."""
    import torch

    from llmq_tpu_torch.ops import kernels

    dev = pools[0].device
    q, kn, vn, q_pf, args, live, live_lens = _ragged_inputs(gen, dev)
    new = (*_q8_rows(kn), *_q8_rows(vn))
    layer = 4
    p1 = [t.clone() for t in pools]
    p2 = [t.clone() for t in pools]
    d_k, p_k = kernels.ragged_mixed_attention_q8(q, *new, q_pf, *p1, *args,
                                                 layer)
    torch.cuda.synchronize()
    d_p, p_p = kernels.ragged_mixed_attention_q8_plain(q, *new, q_pf, *p2,
                                                       *args, layer)
    if not (torch.isfinite(d_k).all() and torch.isfinite(p_k).all()):
        raise AssertionError("ragged_mixed_attention_q8: non-finite output")
    err = max((d_k[:7].float() - d_p[:7].float()).abs().max().item(),
              (p_k[live].float() - p_p[live].float()).abs().max().item())
    if err > Q8_ATOL:
        raise AssertionError(f"ragged_mixed_attention_q8: max err {err} > "
                             f"{Q8_ATOL}")
    if d_k[7].abs().max().item() != 0.0 or \
            p_k[~live].abs().max().item() != 0.0:
        raise AssertionError("ragged_mixed_attention_q8: empty decode row "
                             "or rows outside the slices are not 0")
    if not _same_pools(p1, p2):
        raise AssertionError("ragged_mixed_attention_q8: pools or scale "
                             "pools differ from the twin")
    del p2
    ms = device_ms(lambda i: kernels.ragged_mixed_attention_q8(
        q, *new, q_pf, *p1, *args, i % L_POOL))
    again_d, again_p = kernels.ragged_mixed_attention_q8(q, *new, q_pf, *p1,
                                                         *args, layer)
    torch.cuda.synchronize()
    if not (torch.equal(again_d[:7], d_k[:7]) and torch.equal(again_p, p_k)):
        raise AssertionError("ragged_mixed_attention_q8: a later launch on "
                             "the cached workspace differs from the first")
    plain_ms = device_ms(lambda i: kernels.ragged_mixed_attention_q8_plain(
        q, *new, q_pf, *p1, *args, i % L_POOL), iters=5, warmup=1)
    # Library yardstick: kernel 5's two calls for the decode rows, plus
    # the two calls (dequantize, causal SDPA) per live slice.
    lib = _q8_library(gen, dev, q, args[1][:B], max(live_lens), q_pf,
                      RAGGED_SLICES)
    lib_ms = device_ms(lambda i: lib())
    del lib
    dec_ms, slice_ms = _ragged_ranges(kernels.ragged_mixed_attention_q8, q,
                                      new, q_pf, p1, args)
    del p1
    n_pos = sum(live_lens) + 5
    pf_pos = sum(st + n for st, n, _ in RAGGED_SLICES)
    pairs = sum(st + t + 1 for st, n, _ in RAGGED_SLICES for t in range(n))
    bytes_moved = (_q8_decode_bytes(n_pos, 7) + 2 * RAGGED_N * H * D * 2
                   + pf_pos * (2 * GD + 2 * HKV * 2)
                   + 3 * MP * 4 + 3 * 4 * 4)
    bms, by = bound(bytes_moved, (n_pos + pairs) * H * 4 * D)
    _record(state, "ragged_mixed_attention_q8",
            "llmq_tpu_torch/csrc/ragged_attention.cu",
            "llmq_tpu/ops/pallas/ragged_paged_attention.py:1042", err, ms,
            plain_ms, bms, by, lib_ms)
    state["kernels"]["ragged_mixed_attention_q8"].update(
        {"ms_decode_range": dec_ms, "ms_slice_range": slice_ms})
    log(f"[kernels] ragged_mixed_attention_q8 by range: decode rows alone "
        f"{dec_ms:.4f} ms, slices alone {slice_ms:.4f} ms ({CARD})")


def _int_mm_layouts(state) -> None:
    """The int8 GEMM behind ``qdot``: cuBLAS (``torch._int_mm``) at
    decode's rows (8, padded to 32 by ``ops/quant._int_mm``) and a
    mixed step's (144), llama3-8b's wq (4096 x 4096) and w_up (4096 x
    14336), with the weight row major and column major (the layout
    ``quantize_weight`` stores). Device time per call (CUDA events over
    50 calls)."""
    import torch

    from llmq_tpu_torch.ops.quant import _int_mm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    res = {}
    for n_out in (4096, 14336):
        w = torch.randint(-127, 128, (4096, n_out), generator=gen,
                          device=dev, dtype=torch.int8)
        layouts = {"row": w, "col": w.t().contiguous().t()}
        for m in (8, 144):
            a = torch.randint(-127, 128, (m, 4096), generator=gen,
                              device=dev, dtype=torch.int8)
            for name, wl in layouts.items():
                for _ in range(3):
                    _int_mm(a, wl)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(50):
                    _int_mm(a, wl)
                e1.record()
                torch.cuda.synchronize()
                res[f"m{m}_n{n_out}_{name}_ms"] = e0.elapsed_time(e1) / 50
        del w, layouts
    state["int_mm"] = res
    log("[kernels] _int_mm (rows x 4096) x (4096 x N), ms per call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in res.items()) + f" ({CARD})")


def _chunk_sweep(fn) -> dict:
    """Device ms of ``fn(i)``, a kernel 1 launch, with
    ``kernels.FUSED_DECODE_CHUNK`` set to each candidate in turn (the
    wrapper's split count follows it); the committed value is restored."""
    from llmq_tpu_torch.ops import kernels

    chunk = kernels.FUSED_DECODE_CHUNK
    res = {}
    try:
        for c in (64, 128, 256, 512):
            kernels.FUSED_DECODE_CHUNK = c
            res[c] = device_ms(fn)
    finally:
        kernels.FUSED_DECODE_CHUNK = chunk
    return res


def _long_shapes(state) -> None:
    """Kernels 1, 3, 8, 6, 5 and 7 at the longest shapes the served
    geometry allows: decode with every row at 2000 cached positions (B=8;
    kernels 1 and 8; 5 over int8 pools), a full 2048-token prefill chunk
    from position 0 (kernel 3), and those decode rows plus one 128-token
    slice from position 1920 (kernel 6; 7 over int8 pools). Each is held
    against its twin (attention within ``ATOL``, ``Q8_ATOL`` over int8
    pools, and within ``REL_TOL`` of the twin's RMS per (row, head), which a
    control with one page of keys wrong must fail; pools bit-exact where
    the kernel writes) and timed beside its bound, its twin and an SDPA
    yardstick, kernel 1 also at each candidate split size and kernels 6
    and 7 also by range; the numbers go into the kernel's table entry as
    ``long``. A 4-layer pool with room for 9 full block tables."""
    import torch
    import torch.nn.functional as F

    from llmq_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    L, P = 4, (B + 1) * MP + 1
    kp = torch.randn((L, P, PS, GD), generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn((L, P, PS, GD), generator=gen, device=dev).to(torch.bfloat16)
    bt = (1 + torch.arange(B * MP, device=dev, dtype=torch.int32)).reshape(B, MP)
    n = 2000
    sl = torch.full((B,), n, dtype=torch.int32, device=dev)
    wp = bt[:, (n - 1) // PS].contiguous()
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((B, HKV, D), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((B, HKV, D), generator=gen, device=dev).to(torch.bfloat16)
    kp2, vp2 = kp.clone(), vp.clone()
    out_k = kernels.fused_decode(q, kn, vn, kp, vp, bt, sl, wp, 1)
    out_p = kernels.fused_decode_plain(q, kn, vn, kp2, vp2, bt, sl, wp, 1)
    torch.cuda.synchronize()
    err = (out_k.float() - out_p.float()).abs().max().item()
    rel = scaled_err(out_k, out_p)
    if not torch.isfinite(out_k).all() or err > ATOL or rel > REL_TOL:
        raise AssertionError(f"fused_decode seq_len={n}: max err {err} > "
                             f"{ATOL}, scaled err {rel} > {REL_TOL} or "
                             f"non-finite")
    if not (torch.equal(kp, kp2) and torch.equal(vp, vp2)):
        raise AssertionError(f"fused_decode seq_len={n}: pools differ from "
                             f"the twin")
    # Control: the twin reading positions 1024..1039 from the first page
    # (16 of 2000 keys wrong) must fail the scaled check.
    bt_bad = bt.clone()
    bt_bad[:, 1024 // PS] = bt[:, 0]
    ctl = kernels.fused_decode_plain(q, kn, vn, kp2, vp2, bt_bad, sl, wp, 1)
    ctl_err = (ctl.float() - out_p.float()).abs().max().item()
    ctl_rel = scaled_err(ctl, out_p)
    if ctl_rel <= REL_TOL:
        raise AssertionError(f"fused_decode seq_len={n}: the scaled check "
                             f"passes a wrong page ({ctl_rel})")
    del kp2, vp2, ctl, bt_bad
    ms = device_ms(lambda i: kernels.fused_decode(q, kn, vn, kp, vp, bt, sl,
                                                wp, i % L))
    plain_ms = device_ms(lambda i: kernels.fused_decode_plain(
        q, kn, vn, kp, vp, bt, sl, wp, i % L), iters=3, warmup=1)
    sdpa_dec = _sdpa_decode(gen, dev, q, sl, n)
    lib_ms = device_ms(lambda i: sdpa_dec())
    del sdpa_dec
    chunk_ms = _chunk_sweep(lambda i: kernels.fused_decode(
        q, kn, vn, kp, vp, bt, sl, wp, i % L))
    chunk = kernels.FUSED_DECODE_CHUNK
    bms, by = bound(B * n * GD * 2 * 2 + 2 * B * H * D * 2, B * n * H * 4 * D)
    state["kernels"]["fused_decode"]["long"] = {
        "shape": f"B={B} seq_len={n}", "chunk": chunk,
        "max_abs_err": err, "scaled_err": rel, "control_max_abs_err": ctl_err,
        "control_scaled_err": ctl_rel, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
        "ms_by_chunk": chunk_ms}
    log(f"[kernels] fused_decode B={B} seq_len={n} (chunk {chunk}): "
        f"max_abs_err {err:.3g} scaled {rel:.3g} (control, one wrong page: "
        f"{ctl_err:.3g} scaled {ctl_rel:.3g}), pools bit-exact; kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms library {lib_ms:.4f} ms bound "
        f"{bms:.4f} ms ({by}); by chunk "
        + ", ".join(f"{c}: {t:.4f}" for c, t in chunk_ms.items())
        + f" ms ({CARD})")

    T = 2048
    qp = torch.randn((T, H, D), generator=gen, device=dev).to(torch.bfloat16)
    full, live600 = _desc(dev, [0], [T]), _desc(dev, [0], [600])
    o_k = _attn1(kernels.prefill_attention, qp, kp, vp, bt[0], full, 1)
    o_p = _attn1(kernels.prefill_attention_plain, qp, kp, vp, bt[0], full, 1)
    torch.cuda.synchronize()
    err = (o_k.float() - o_p.float()).abs().max().item()
    rel = scaled_err(o_k, o_p)
    if not torch.isfinite(o_k).all() or err > ATOL or rel > REL_TOL:
        raise AssertionError(f"prefill_attention T={T}: max err {err} > "
                             f"{ATOL}, scaled err {rel} > {REL_TOL} or "
                             f"non-finite")
    # Control as for kernel 1: keys 1024..1039 read from the first page.
    bt_bad = bt[0].clone()
    bt_bad[1024 // PS] = bt[0, 0]
    ctl = _attn1(kernels.prefill_attention_plain, qp, kp, vp, bt_bad, full, 1)
    ctl_err = (ctl.float() - o_p.float()).abs().max().item()
    ctl_rel = scaled_err(ctl, o_p)
    if ctl_rel <= REL_TOL:
        raise AssertionError(f"prefill_attention T={T}: the scaled check "
                             f"passes a wrong page ({ctl_rel})")
    del o_p, ctl, bt_bad
    ms = device_ms(lambda i: _attn1(kernels.prefill_attention, qp, kp, vp,
                                    bt[0], full, i % L), iters=10)
    plain_ms = device_ms(lambda i: _attn1(
        kernels.prefill_attention_plain, qp, kp, vp, bt[0], full, i % L),
        iters=3, warmup=1)
    # The dead-tile skip: the same 2048-row chunk with 600 tokens live
    # (where ~600-token prompts land in the 2048 bucket).
    ms_600 = device_ms(lambda i: _attn1(kernels.prefill_attention, qp, kp,
                                        vp, bt[0], live600, i % L),
                       iters=10)
    # The same function in one call: causal SDPA over dense K/V, the
    # H_kv heads repeated for the n_rep query heads of each group.
    qh = qp.transpose(0, 1)[None].contiguous()
    kh = torch.randn((1, HKV, T, D), generator=gen, device=dev).to(
        torch.bfloat16).repeat_interleave(H // HKV, dim=1)
    vh = torch.randn((1, HKV, T, D), generator=gen, device=dev).to(
        torch.bfloat16).repeat_interleave(H // HKV, dim=1)
    lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), iters=10)
    bms, by = bound(2 * T * H * D * 2 + T * GD * 2 * 2,
                    T * (T + 1) // 2 * H * 4 * D)
    state["kernels"]["prefill_attention"]["long"] = {
        "shape": f"T={T} start=0", "max_abs_err": err, "scaled_err": rel,
        "control_max_abs_err": ctl_err, "control_scaled_err": ctl_rel,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "ms_600_live": ms_600}
    log(f"[kernels] prefill_attention T={T} start=0: max_abs_err "
        f"{err:.3g} scaled {rel:.3g} (control, one wrong page: {ctl_err:.3g} "
        f"scaled {ctl_rel:.3g}); kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"library {lib_ms:.4f} ms bound {bms:.4f} ms ({by}); with 600 of "
        f"2048 tokens live {ms_600:.4f} ms ({CARD})")
    del qh, kh, vh, qp
    _long_paged_decode(state, gen, kp, vp, bt, sl, q)
    _long_ragged(state, gen, kp, vp, bt, sl, wp, q, kn, vn)
    del kp, vp
    torch.cuda.empty_cache()
    _long_q8(state, gen, bt, sl, wp, q)


def _wrong_page(bt):
    """The block table(s) with the page of positions 1024..1039 replaced
    by the first page: the one-wrong-page control of the long shapes."""
    bad = bt.clone()
    bad[..., 1024 // PS] = bad[..., 0]
    return bad


def _long_paged_decode(state, gen, kp, vp, bt, sl, q) -> None:
    """Kernel 8 on the long decode rows (B=8 × 2000 positions, layer 1)."""
    import torch

    from llmq_tpu_torch.ops import kernels

    dev = kp.device
    L = kp.shape[0]
    n = int(sl[0])
    out_k = kernels.paged_decode_attention(q, kp, vp, bt, sl, 1)
    out_p = kernels.paged_decode_attention_plain(q, kp, vp, bt, sl, 1)
    torch.cuda.synchronize()
    err = (out_k.float() - out_p.float()).abs().max().item()
    rel = scaled_err(out_k, out_p)
    if not torch.isfinite(out_k).all() or err > ATOL or rel > REL_TOL:
        raise AssertionError(f"paged_decode_attention seq_len={n}: max err "
                             f"{err} > {ATOL}, scaled err {rel} > {REL_TOL} "
                             f"or non-finite")
    ctl = kernels.paged_decode_attention_plain(q, kp, vp, _wrong_page(bt), sl,
                                               1)
    ctl_err = (ctl.float() - out_p.float()).abs().max().item()
    ctl_rel = scaled_err(ctl, out_p)
    if ctl_rel <= REL_TOL:
        raise AssertionError(f"paged_decode_attention seq_len={n}: the "
                             f"scaled check passes a wrong page ({ctl_rel})")
    del ctl, out_p
    ms = device_ms(lambda i: kernels.paged_decode_attention(
        q, kp, vp, bt, sl, i % L))
    plain_ms = device_ms(lambda i: kernels.paged_decode_attention_plain(
        q, kp, vp, bt, sl, i % L), iters=3, warmup=1)
    sdpa_dec = _sdpa_decode(gen, dev, q, sl, n)
    lib_ms = device_ms(lambda i: sdpa_dec())
    del sdpa_dec
    bms, by = bound(B * n * GD * 2 * 2 + 2 * B * H * D * 2 + B * MP * 4
                    + B * 4, B * n * H * 4 * D)
    state["kernels"]["paged_decode_attention"]["long"] = {
        "shape": f"B={B} seq_len={n}", "max_abs_err": err,
        "scaled_err": rel, "control_max_abs_err": ctl_err,
        "control_scaled_err": ctl_rel, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
    log(f"[kernels] paged_decode_attention B={B} seq_len={n}: max_abs_err "
        f"{err:.3g} scaled {rel:.3g} (control, one wrong page: {ctl_err:.3g} "
        f"scaled {ctl_rel:.3g}); kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"library {lib_ms:.4f} ms bound {bms:.4f} ms ({by}) ({CARD})")


def _long_ragged(state, gen, kp, vp, bt, sl, wp, q, kn, vn) -> None:
    """Kernel 6 on the long decode rows plus one 128-token slice from
    position 1920 on the pool's ninth block table (layer 2)."""
    import torch

    from llmq_tpu_torch.ops import kernels

    dev = kp.device
    L = kp.shape[0]
    n = int(sl[0])
    T, start = 128, 1920
    bt_s = (1 + B * MP + torch.arange(MP, device=dev,
                                      dtype=torch.int32))[None]
    args = (torch.cat([bt, bt_s]).contiguous(),
            torch.cat([sl, torch.tensor([start + T], dtype=torch.int32,
                                        device=dev)]),
            wp, *(torch.tensor([v], dtype=torch.int32, device=dev)
                  for v in (0, T, start)))
    q_pf = torch.randn((T, H, D), generator=gen, device=dev).to(torch.bfloat16)
    kp2, vp2 = kp.clone(), vp.clone()
    d_k, p_k = kernels.ragged_mixed_attention(q, kn, vn, q_pf, kp, vp, *args, 2)
    d_p, p_p = kernels.ragged_mixed_attention_plain(q, kn, vn, q_pf, kp2, vp2,
                                                    *args, 2)
    torch.cuda.synchronize()
    err = max((d_k.float() - d_p.float()).abs().max().item(),
              (p_k.float() - p_p.float()).abs().max().item())
    rel = max(scaled_err(d_k, d_p), scaled_err(p_k, p_p))
    if not (torch.isfinite(d_k).all() and torch.isfinite(p_k).all()) \
            or err > ATOL or rel > REL_TOL:
        raise AssertionError(f"ragged_mixed_attention long: max err {err} > "
                             f"{ATOL}, scaled err {rel} > {REL_TOL} or "
                             f"non-finite")
    if not (torch.equal(kp, kp2) and torch.equal(vp, vp2)):
        raise AssertionError("ragged_mixed_attention long: pools differ from "
                             "the twin")
    c_d, c_p = kernels.ragged_mixed_attention_plain(
        q, kn, vn, q_pf, kp2, vp2, _wrong_page(args[0]), *args[1:], 2)
    ctl_err = max((c_d.float() - d_p.float()).abs().max().item(),
                  (c_p.float() - p_p.float()).abs().max().item())
    ctl_rel = min(scaled_err(c_d, d_p), scaled_err(c_p, p_p))
    if ctl_rel <= REL_TOL:
        raise AssertionError(f"ragged_mixed_attention long: the scaled check "
                             f"passes a wrong page ({ctl_rel})")
    del kp2, vp2, c_d, c_p, d_p, p_p
    ms = device_ms(lambda i: kernels.ragged_mixed_attention(
        q, kn, vn, q_pf, kp, vp, *args, i % L))
    plain_ms = device_ms(lambda i: kernels.ragged_mixed_attention_plain(
        q, kn, vn, q_pf, kp, vp, *args, i % L), iters=3, warmup=1)
    calls = [_sdpa_decode(gen, dev, q, sl, n), _sdpa_prefill(gen, dev, q_pf,
                                                             start)]
    lib_ms = device_ms(lambda i: [c() for c in calls])
    del calls
    dec_ms, slice_ms = _ragged_ranges(kernels.ragged_mixed_attention, q,
                                      (kn, vn), q_pf, (kp, vp), args)
    pairs = sum(start + t + 1 for t in range(T))
    bms, by = bound(2 * B * H * D * 2 + 2 * B * GD * 2 + B * n * GD * 2 * 2
                    + 2 * T * H * D * 2 + (start + T) * GD * 2 * 2
                    + (B + 1) * MP * 4 + (2 * B + 4) * 4,
                    (B * n + pairs) * H * 4 * D)
    state["kernels"]["ragged_mixed_attention"]["long"] = {
        "shape": f"B={B} seq_len={n} + slice T={T} from {start}",
        "max_abs_err": err, "scaled_err": rel,
        "control_max_abs_err": ctl_err, "control_scaled_err": ctl_rel,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "ms_decode_range": dec_ms,
        "ms_slice_range": slice_ms}
    log(f"[kernels] ragged_mixed_attention B={B} seq_len={n} + slice T={T} "
        f"from {start}: max_abs_err {err:.3g} scaled {rel:.3g} (control, one "
        f"wrong page: {ctl_err:.3g} scaled {ctl_rel:.3g}), pools bit-exact; "
        f"kernel {ms:.4f} ms (decode rows alone {dec_ms:.4f}, slice alone "
        f"{slice_ms:.4f}) plain {plain_ms:.4f} ms library {lib_ms:.4f} ms "
        f"bound {bms:.4f} ms ({by}) ({CARD})")


def _long_q8(state, gen, bt, sl, wp, q) -> None:
    """Kernels 5 and 7 on the long decode rows (B=8 × 2000 positions,
    layer 2) over int8 pools the size of the long bf16 ones; kernel 7
    adds one 128-token slice from position 1920 on the ninth block table.
    Each is held within ``Q8_ATOL`` of its twin and within ``REL_TOL`` of
    the twin's RMS per (row, head), which the twin with one page of keys
    wrong must fail; the four pools bit-exact; a relaunch on the cached
    workspace repeats the output. Timed beside its bound, its twin and
    its two-call library yardstick, kernel 7 also by range."""
    import torch

    from llmq_tpu_torch.ops import kernels

    dev = q.device
    pools = _q8_pools(gen, dev, L=4, P=(B + 1) * MP + 1)
    L = pools[0].shape[0]
    n, layer = int(sl[0]), 2
    new = (*_q8_rows(torch.randn((B, HKV, D), generator=gen, device=dev)),
           *_q8_rows(torch.randn((B, HKV, D), generator=gen, device=dev)))
    T, start = 128, 1920
    bt_s = (1 + B * MP + torch.arange(MP, device=dev,
                                      dtype=torch.int32))[None]
    args = (torch.cat([bt, bt_s]).contiguous(),
            torch.cat([sl, torch.tensor([start + T], dtype=torch.int32,
                                        device=dev)]),
            wp, *(torch.tensor([v], dtype=torch.int32, device=dev)
                  for v in (0, T, start)))
    q_pf = torch.randn((T, H, D), generator=gen, device=dev).to(torch.bfloat16)
    pf_bytes = 2 * T * H * D * 2 + (start + T) * (2 * GD + 2 * HKV * 2)
    pairs = sum(start + t + 1 for t in range(T))
    cases = [
        ("fused_decode_q8", f"B={B} seq_len={n}",
         lambda p, a, i: (kernels.fused_decode_q8(q, *new, *p, *a[:3], i),),
         lambda p, a: (kernels.fused_decode_q8_plain(q, *new, *p, *a[:3],
                                                     layer),),
         (bt, sl, wp), _q8_library(gen, dev, q, sl, n),
         bound(_q8_decode_bytes(B * n, B), B * n * H * 4 * D)),
        ("ragged_mixed_attention_q8",
         f"B={B} seq_len={n} + slice T={T} from {start}",
         lambda p, a, i: kernels.ragged_mixed_attention_q8(q, *new, q_pf, *p,
                                                           *a, i),
         lambda p, a: kernels.ragged_mixed_attention_q8_plain(
             q, *new, q_pf, *p, *a, layer),
         args, _q8_library(gen, dev, q, sl, n, q_pf, [(start, T, 0)]),
         bound(_q8_decode_bytes(B * n, B) + pf_bytes + MP * 4 + 3 * 4,
               (B * n + pairs) * H * 4 * D)),
    ]
    for name, shape, run, twin, a, lib, (bms, by) in cases:
        p1 = [t.clone() for t in pools]
        p2 = [t.clone() for t in pools]
        outs = run(p1, a, layer)
        refs = twin(p2, a)
        torch.cuda.synchronize()
        err = max((o.float() - r.float()).abs().max().item()
                  for o, r in zip(outs, refs))
        rel = max(scaled_err(o, r) for o, r in zip(outs, refs))
        if not all(torch.isfinite(o).all() for o in outs) or err > Q8_ATOL \
                or rel > REL_TOL:
            raise AssertionError(f"{name} {shape}: max err {err} > "
                                 f"{Q8_ATOL}, scaled err {rel} > {REL_TOL} "
                                 f"or non-finite")
        if not _same_pools(p1, p2):
            raise AssertionError(f"{name} {shape}: pools or scale pools "
                                 f"differ from the twin")
        bad = (_wrong_page(a[0]), *a[1:])
        ctl = twin(p2, bad)
        ctl_err = max((c.float() - r.float()).abs().max().item()
                      for c, r in zip(ctl, refs))
        ctl_rel = min(scaled_err(c, r) for c, r in zip(ctl, refs))
        if ctl_rel <= REL_TOL:
            raise AssertionError(f"{name} {shape}: the scaled check passes "
                                 f"a wrong page ({ctl_rel})")
        del p2, ctl, refs
        ms = device_ms(lambda i: run(p1, a, i % L))
        again = run(p1, a, layer)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(again, outs)):
            raise AssertionError(f"{name} {shape}: a later launch on the "
                                 f"cached workspace differs from the first")
        plain_ms = device_ms(lambda i: twin(p1, a), iters=3, warmup=1)
        lib_ms = device_ms(lambda i: lib())
        entry = {"shape": shape, "max_abs_err": err, "scaled_err": rel,
                 "control_max_abs_err": ctl_err,
                 "control_scaled_err": ctl_rel, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                 "library_ms": lib_ms}
        ranges = ""
        if name == "ragged_mixed_attention_q8":
            dec_ms, slice_ms = _ragged_ranges(
                kernels.ragged_mixed_attention_q8, q, new, q_pf, p1, a)
            entry.update({"ms_decode_range": dec_ms,
                          "ms_slice_range": slice_ms})
            ranges = (f" (decode rows alone {dec_ms:.4f}, slice alone "
                      f"{slice_ms:.4f})")
        del p1, lib
        state["kernels"][name]["long"] = entry
        log(f"[kernels] {name} {shape}: max_abs_err {err:.3g} scaled "
            f"{rel:.3g} (control, one wrong page: {ctl_err:.3g} scaled "
            f"{ctl_rel:.3g}), pools bit-exact, relaunch repeats; kernel "
            f"{ms:.4f} ms{ranges} plain {plain_ms:.4f} ms library "
            f"{lib_ms:.4f} ms bound {bms:.4f} ms ({by}) ({CARD})")


def phase_split(state) -> None:
    import torch

    from llmq_tpu_torch.ops import kernels
    from llmq_tpu_torch.ops.attention import paged_decode_step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    k_pool, v_pool = _pools(gen, dev)
    q, kn, vn, bt, sl, wp, live_lens = _decode_inputs(gen, dev, False)
    slot_of = ((sl - 1) % PS).to(torch.int32)
    kp2, vp2 = k_pool.clone(), v_pool.clone()
    before = dict(kernels.LAUNCHES)
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
    for name in ("kv_cache_write", "paged_decode_attention"):
        if kernels.LAUNCHES[name] <= before[name]:
            raise AssertionError(f"split route did not launch {name}")
    log(f"[split] fused vs split (kv_cache_write + paged_decode_attention): "
        f"attention max_abs_err {err:.3g}, pools identical")
    del k_pool, v_pool, kp2, vp2
    torch.cuda.empty_cache()


def phase_model(state) -> None:
    from llmq_tpu_torch.ops import kernels

    for q8, tol in ((False, MODEL_ATOL), (True, MODEL_Q8_ATOL)):
        kernels.reset_launches()
        worst = _model_card_vs_cpu(q8)
        if worst > tol:
            raise AssertionError(f"model ({'int8' if q8 else 'bf16'}): card "
                                 f"vs CPU logits differ by {worst}")
        want = ("fused_decode_q8", "ragged_mixed_attention_q8") if q8 else (
            "fused_decode", "prefill_attention", "ragged_mixed_attention")
        for name in want:
            if kernels.LAUNCHES[name] <= 0:
                raise AssertionError(f"model: {name} did not launch")
        log(f"[model] {'int8 weights + int8 KV' if q8 else 'bf16'} tiny "
            f"model (D=128, n_rep=2): prefill, decode, forward_mixed and "
            f"forward_mixed_ragged card vs CPU logits max_abs_err "
            f"{worst:.3g} (tolerance {tol})")


def _to_cuda(tree):
    """A parameter tree on the card, each leaf's strides kept."""
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.cuda()


def _model_card_vs_cpu(q8: bool) -> float:
    """A 2-layer model with the card's head geometry (D=128, n_rep=2),
    random weights from seed 0, run on the card and on the CPU (plain
    twins): prefill with a continuation chunk, four decode steps, a
    bucket mixed step and a ragged mixed step. ``q8``: int8 weights and
    int8 KV pools. Returns the largest logit difference."""
    import numpy as np
    import torch

    from llmq_tpu_torch.models.llama import (forward_decode,
                                             forward_mixed,
                                             forward_mixed_ragged,
                                             forward_prefill, get_config,
                                             init_kv_pages, init_params,
                                             init_params_quantized)

    cfg = get_config("llama3-tiny", dim=512, n_heads=4, n_kv_heads=2,
                     n_layers=2, vocab_size=512, max_seq_len=256)
    init = init_params_quantized if q8 else init_params
    params_c = init(cfg, torch.Generator().manual_seed(0), "cpu")
    params_g = _to_cuda(params_c)
    rng = np.random.default_rng(0)
    worst = 0.0
    caches = {d: init_kv_pages(cfg, 24, PS, d,
                               dtype=torch.int8 if q8 else None)
              for d in ("cpu", "cuda")}
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
    # Mixed steps: the decoding row plus two prompts on their own pages,
    # first bucket-style (forward_mixed: slices of 20 and 9 fresh
    # tokens), then ragged (forward_mixed_ragged: both prompts continue,
    # packed at q-block offsets 0 and 16, with an unused slice row).
    pf_bt = np.zeros((3, 16), np.int32)
    pf_bt[0, :2], pf_bt[1, :1] = [2, 5], [6]
    steps = (
        ("mixed", [(0, rng.integers(3, 500, 20)), (0, rng.integers(3, 500, 9))]),
        ("ragged", [(20, rng.integers(3, 500, 11)),
                    (9, rng.integers(3, 500, 5))]))
    for kind, slices in steps:
        res = {}
        for dev, params in (("cpu", params_c), ("cuda", params_g)):
            t = lambda a, dt=torch.int32: torch.as_tensor(  # noqa: E731
                np.asarray(a), dtype=dt, device=dev)
            dec = (t([tok]), t([pos]), caches[dev], t(bt))
            if kind == "mixed":
                W = max(len(x) for _, x in slices)
                toks = np.zeros((2, W), np.int32)
                poss = np.zeros((2, W), np.int32)
                for i, (st, x) in enumerate(slices):
                    toks[i, :len(x)] = x
                    poss[i] = np.minimum(np.arange(W) + st, st + len(x) - 1)
                d, p = forward_mixed(params, cfg, *dec, t(toks), t(poss),
                                     t([len(x) for _, x in slices]),
                                     t(pf_bt[:2]))
                p = torch.stack([p[i, len(x) - 1]
                                 for i, (_, x) in enumerate(slices)])
            else:
                toks = np.zeros(32, np.int32)
                poss = np.zeros(32, np.int32)
                for off, (st, x) in zip((0, 16), slices):
                    toks[off:off + len(x)] = x
                    poss[off:off + len(x)] = st + np.arange(len(x))
                d, p = forward_mixed_ragged(
                    params, cfg, *dec, t(toks), t(poss), t([0, 16, 0]),
                    t([len(x) for _, x in slices] + [0]), t(pf_bt))
                p = p[:2]
            res[dev] = (d.float().cpu(), p.float().cpu())
        for a, b in zip(res["cuda"], res["cpu"]):
            if not torch.isfinite(a).all():
                raise AssertionError(f"model: non-finite {kind} logits")
            worst = max(worst, (a - b).abs().max().item())
        tok = int(res["cpu"][0][0].argmax())
        pos += 1
    return worst


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


#: Deadline of every smoke message: the smoke checks that requests
#: complete; latency is measured separately (the 30 s default is a
#: latency bound, which an eager int8 step on a slow host can miss).
MESSAGE_TIMEOUT_S = 600.0


def _post(base, body) -> str:
    """POST one message (with MESSAGE_TIMEOUT_S); returns its id."""
    status, r = _http("POST", f"{base}/api/v1/messages",
                      {**body, "timeout": MESSAGE_TIMEOUT_S})
    assert status == 202, r
    return r["message_id"]


def _poll(base, mid, timeout=600.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, m = _http("GET", f"{base}/api/v1/messages/{mid}")
        if m["status"] in ("completed", "failed", "timeout"):
            return m
        time.sleep(0.02)
    raise AssertionError(f"message {mid} did not finish in {timeout} s")


def _count_plain_calls():
    """Wrap every ``*_plain`` twin of ``ops/kernels.py`` in a call
    counter (the wrappers look their twins up by name, so a twin reached
    from a wrapper counts too). Returns (counts, restore)."""
    from llmq_tpu_torch.ops import kernels

    counts = {}
    originals = {n: getattr(kernels, n) for n in dir(kernels)
                 if n.endswith("_plain")}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in originals.items():
        setattr(kernels, name, wrap(name, fn))

    def restore():
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    return counts, restore


def _decoding_rows(engine) -> int:
    return sum(1 for s in engine._slots if s is not None and s.prefilled)


def _coexisting_mix(base, engine, tag: str) -> list:
    """Two requests decoding 64 tokens, then four ~600-token prompts
    posted while they decode, so prefill and decode coexist. Returns the
    finished messages."""
    mids = []
    for i in range(2):
        mids.append(_post(base, {
            "content": f"{tag} decoder {i}: write a long story.",
            "priority": "normal", "metadata": {"max_new_tokens": 64}}))
    deadline = time.time() + 120
    while _decoding_rows(engine) < 2 and time.time() < deadline:
        time.sleep(0.005)
    if _decoding_rows(engine) < 2:
        raise AssertionError(f"{tag}: the two decoders never decoded")
    for i in range(4):
        text = (f"{tag} long prompt {i}. " + "The queue holds requests of "
                "four priorities and serves them in order. " * 12)[:600]
        mids.append(_post(base, {
            "content": text, "priority": ("low", "high")[i % 2],
            "metadata": {"max_new_tokens": 16}}))
    return [_poll(base, m) for m in mids]


def _check_completed(results, what: str) -> int:
    for m in results:
        u = m["metadata"].get("usage", {})
        if m["status"] != "completed" or \
                u.get("finish_reason") not in ("eos", "length"):
            raise AssertionError(f"{what}: request did not complete: {m}")
    return sum(m["metadata"]["usage"]["completion_tokens"] for m in results)


def _b1_rates(engine, tag: str):
    """TTFT and decode rate of one request alone (90-token prompt, 32
    new tokens): the medians of three requests, one after another."""
    from llmq_tpu_torch.engine.engine import GenRequest

    prompt = "The quick brown fox jumps over the lazy dog. " * 2
    ttfts, rates = [], []
    for i in range(3):
        h = engine.submit(GenRequest(id=f"ttft-{i}-{time.time()}",
                                     prompt=prompt, max_new_tokens=32))
        assert h.wait(120), "ttft request timed out"
        ttfts.append(h.marks["first_token"] - h.submitted_at)
        rates.append((len(h.result.tokens) - 1)
                     / (h.finished_at - h.marks["first_token"]))
    log(f"[{tag}] B=1: TTFT {', '.join(f'{t * 1e3:.1f}' for t in ttfts)} ms; "
        f"decode {', '.join(f'{r:.1f}' for r in rates)} tok/s")
    return sorted(ttfts)[1], sorted(rates)[1], h.result.prompt_tokens


#: Host-side CUDA runtime calls that launch work, as torch.profiler names
#: them: kernel launches, and graph launches.
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx")
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def _chunk_profile(fn, steps: int, host: bool) -> dict:
    """One chunk under torch.profiler: per step, the device busy ms
    (summed kernel time) and the device kernels; with ``host`` also the
    host's kernel and graph launch calls (host activity is traced too,
    which over an eager chunk's thousands of ops costs more than the
    chunk); and the chunk's device span per step from CUDA events around
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    launches = graphs = 0
    for e in prof.key_averages():
        if e.key in KERNEL_LAUNCH_CALLS:
            launches += e.count
        elif e.key in GRAPH_LAUNCH_CALLS:
            graphs += e.count
    out = {"busy_ms": _device_us(prof) / 1e3 / steps,
           "device_kernels": _kernel_events(prof) / steps,
           "span_ms": start.elapsed_time(end) / steps}
    if host:
        out.update(host_kernel_launches=launches / steps,
                   host_graph_launches=graphs / steps)
    return out


def _graph_vs_eager(engine, tag: str, state) -> None:
    """One engine's decode step as a graph replay against the same step
    run eagerly, on an idle engine: B=8 rows of 64 positions over fresh
    pages, K=16 steps, every budget K: the wall per step (host clock
    around a chunk that ends in a synchronize; the graph twice), then one
    profiled chunk each (the eager one traces device activity only: every
    eager kernel is a host launch). Then a chunk with budgets 0..K each;
    greedy streams must agree token for token, and the graph must take
    one replay (the host's one graph launch) per step."""
    import numpy as np
    import torch

    ex = engine.executor
    B, K = ex.spec.batch_size, ex.chunk_size
    pages = engine.allocator.alloc(B * 8)
    bt = np.zeros((B, ex.spec.max_pages_per_seq), np.int32)
    bt[:, :8] = np.asarray(pages).reshape(B, 8)
    args = (np.arange(100, 100 + B, dtype=np.int32), np.full(B, 64, np.int32),
            bt, np.zeros(B, np.float32))
    full = np.full(B, K, np.int32)
    budgets = np.array([K, K, 5, 0, K, 3, K, 1], np.int32)[:B]
    # A route not yet replayed is captured here, outside the timed chunks.
    ex.decode_chunk(*args, full)
    res = {}
    for mode, rounds in (("eager", 1), ("graph", 2)):
        def chunk(b):
            if mode == "eager":
                return ex._decode_chunk(*args, b, eager=True)
            return ex.decode_chunk(*args, b)

        walls = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            replays = ex.graph_replays
            t0 = time.perf_counter()
            out = chunk(full)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / K)
        r = res[mode] = {"wall_ms": walls, "out": out,
                         "replays": ex.graph_replays - replays}
        r.update(_chunk_profile(lambda: chunk(full), K, host=mode == "graph"))
        r["out_budgets"] = chunk(budgets)
    engine.allocator.free(pages)
    eager, graph = res["eager"], res["graph"]
    for key in ("out", "out_budgets"):
        if not np.array_equal(eager[key], graph[key]):
            raise AssertionError(f"[graphs] {tag}: replayed stream differs "
                                 f"from the eager step's ({key})\n"
                                 f"{eager[key]}\n{graph[key]}")
    if graph["replays"] != K:
        raise AssertionError(f"[graphs] {tag}: {graph['replays']} replays "
                             f"for a {K}-step chunk (one a step expected)")
    # Kernels inside a replay must show in the trace for its busy time to
    # hold; otherwise the device span from CUDA events stands in for it.
    seen = graph["device_kernels"] >= 0.5 * eager["device_kernels"]
    row = {"steps": K, "streams_equal": True, "step_ms": ex.step_ms,
           "profiler_sees_replayed_kernels": seen,
           "pool_bytes": sum(g.pool_bytes for g in ex.step_graphs.values()),
           "captured_launches": {("fused" if r else "split"): g.launches
                                 for r, g in ex.step_graphs.items()}}
    for mode, r in res.items():
        row.update({f"{mode}_{k}": v for k, v in r.items()
                    if k not in ("out", "out_budgets", "replays")})
    state["graphs"][tag] = row
    busy = graph["busy_ms"] if seen else graph["span_ms"]
    log(f"[graphs] {tag}: per step eager {eager['wall_ms'][0]:.2f} ms wall, "
        f"{eager['busy_ms']:.2f} ms busy, {eager['device_kernels']:.0f} "
        f"device kernels (each a host launch); graph "
        f"{', '.join(f'{w:.2f}' for w in graph['wall_ms'])} ms wall, "
        f"{busy:.2f} ms busy{'' if seen else ' (CUDA-event span: the '
                                     'profiler shows no replayed kernels)'}, "
        f"{graph['device_kernels']:.0f} device kernels, "
        f"{graph['host_kernel_launches']:.2f} host kernel launches + "
        f"{graph['host_graph_launches']:.2f} graph launches "
        f"({graph['replays']} replays for {K} steps); graph pool "
        f"{row['pool_bytes'] / 2**20:.1f} MiB; greedy streams equal "
        f"({CARD})")


def _eager_programs(ex):
    """Context: the executor's prefill programs and mixed step 0 run
    eagerly (their graphs untouched); the decode step still replays.
    Returns a restore function."""
    launch = ex._launch
    ex._launch = lambda name, p, body, eager: launch(name, p, body, True)

    def restore():
        ex._launch = launch
    return restore


def _program_requests(engine, lengths, rng):
    """One request per length: random tokens from ``rng`` over fresh
    pages of the engine's (idle) allocator. Returns (reqs, pages)."""
    import numpy as np

    ex = engine.executor
    reqs, pages = [], []
    for n in lengths:
        pg = engine.allocator.alloc(-(-n // ex.spec.page_size))
        bt = np.zeros(ex.spec.max_pages_per_seq, np.int32)
        bt[:len(pg)] = pg
        reqs.append(([int(x) for x in rng.integers(
            3, min(20000, ex.model_cfg.vocab_size), n)], 0, bt, 0.0))
        pages += pg
    return reqs, pages


def _programs_vs_eager(engine, tag: str, state, prefill: bool = True
                       ) -> None:
    """Every prefill program of one engine and its mixed step 0, each
    replayed from its graph against the same program run eagerly, on the
    same inputs over fresh pages: bucket mode each bucket with one row
    and with ``prefill_batch`` rows (lengths up to the bucket), ragged
    mode a wave of four prompts through the ragged step; then a mixed
    chunk (B=8 rows at 64 positions, two 64-token slices; ragged: one
    128-token slice). Greedy first tokens and the chunk's streams must be
    equal, each program call one replay (the host's one graph launch,
    from a profiled call of the largest program). Per program the wall
    of one call (host clock to the fetched tokens) eager and replayed,
    and each graph's capture seconds and the bytes it added to the
    shared pool. ``prefill=False``: the mixed chunk alone (another
    decode route of an engine already checked)."""
    import numpy as np
    import torch

    ex = engine.executor
    rng = np.random.default_rng(7)
    rows = {}
    if not prefill:
        plan = []
    elif ex.ragged_attention:
        plan = [("ragged_step0", [600, 90, 300, 17])]
    else:
        plan = []
        for T in ex.prefill_buckets:
            plan.append((f"prefill_b{T}", [T - 3]))
            plan.append((f"prefill_multi_b{T}",
                         [T, T // 2 + 1, min(T, 1200), 90][:ex.prefill_batch]))
    for name, lengths in plan:
        res = {}
        for eager in (True, False):
            reqs, pages = _program_requests(engine, lengths,
                                            np.random.default_rng(len(rows)))
            before = dict(ex.program_replays)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if ex.ragged_attention:
                hs = ex._ragged_prefill_start(reqs, eager=eager)
            else:
                hs = ex._prefill_wave(reqs, len(reqs), eager=eager)
            toks = ex.gather_scalars(hs)
            wall = (time.perf_counter() - t0) * 1e3
            replays = {k: v - before.get(k, 0)
                       for k, v in ex.program_replays.items()
                       if v != before.get(k, 0)}
            res[eager] = (toks, wall, replays)
            engine.allocator.free(pages)
        (t_e, w_e, r_e), (t_g, w_g, r_g) = res[True], res[False]
        if not np.array_equal(t_e, t_g):
            raise AssertionError(f"[graphs] {tag} {name}: replayed first "
                                 f"tokens {t_g} differ from eager {t_e}")
        if r_e or (not ex.ragged_attention and r_g != {name: 1}):
            raise AssertionError(f"[graphs] {tag} {name}: replays eager "
                                 f"{r_e}, graph {r_g} (one expected)")
        g = ex.program_graphs[name]
        rows[name] = {"lengths": lengths, "first_tokens_equal": True,
                      "eager_wall_ms": w_e, "graph_wall_ms": w_g,
                      "replays": r_g.get(name, 0),
                      "capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
                      "captured_launches": sum(g.launches.values())}
        log(f"[graphs] {tag} {name} (lengths {lengths}): first tokens equal; "
            f"one call {w_e:.2f} ms eager, {w_g:.2f} ms replayed "
            f"({r_g.get(name, 0)} replays, {sum(g.launches.values())} "
            f"kernels each); captured in {g.capture_s:.2f} s, "
            f"{g.pool_bytes / 2**20:.1f} MiB added to the shared pool "
            f"({CARD})")
    if plan:
        # The largest program once under the profiler: the host launches
        # graphs and no kernel of the model.
        name, lengths = plan[-1]
        reqs, pages = _program_requests(engine, lengths, rng)
        if ex.ragged_attention:
            prof = _chunk_profile(lambda: ex.gather_scalars(
                ex._ragged_prefill_start(reqs)), 1, host=True)
        else:
            prof = _chunk_profile(lambda: ex.gather_scalars(
                ex._prefill_wave(reqs, len(reqs))), 1, host=True)
        engine.allocator.free(pages)
        rows[name]["profiled"] = prof
        log(f"[graphs] {tag} {name} profiled: "
            f"{prof['host_graph_launches']:.0f} graph launches, "
            f"{prof['host_kernel_launches']:.0f} host kernel launches, "
            f"{prof['device_kernels']:.0f} device kernels, "
            f"{prof['busy_ms']:.2f} ms busy ({CARD})")
    # The mixed step 0: a mixed chunk eager against replayed.
    B, K, MPs = ex.spec.batch_size, ex.chunk_size, ex.spec.max_pages_per_seq
    slices = ([128] if ex.ragged_attention else [64, 64])
    outs = {}
    # The same pages for both runs (the rows' history is whatever they
    # hold; each run rewrites what it writes with the same values).
    pages = engine.allocator.alloc(B * 8)
    bt = np.zeros((B, MPs), np.int32)
    bt[:, :8] = np.asarray(pages).reshape(B, 8)
    preqs, ppages = _program_requests(engine, slices,
                                      np.random.default_rng(3))
    pf = [(0, t, sp, pbt, temp) for t, sp, pbt, temp in preqs]
    args = (np.full(B, 100, np.int32), np.full(B, 64, np.int32), bt,
            np.zeros(B, np.float32), np.full(B, K, np.int32))
    for eager in (True, False):
        before = dict(ex.program_replays)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, pf_first = ex._mixed_chunk(*args, pf, eager=eager)
        wall = (time.perf_counter() - t0) * 1e3 / K
        outs[eager] = (out, pf_first, wall, {
            k: v - before.get(k, 0) for k, v in ex.program_replays.items()
            if v != before.get(k, 0)})
    engine.allocator.free(pages + ppages)
    (o_e, f_e, w_e, _), (o_g, f_g, w_g, r_g) = outs[True], outs[False]
    if not (np.array_equal(o_e, o_g) and np.array_equal(f_e, f_g)):
        raise AssertionError(f"[graphs] {tag} mixed chunk: replayed step 0 "
                             f"streams differ from eager\n{o_e}\n{o_g}\n"
                             f"{f_e} {f_g}")
    step0 = ("ragged_step0" if ex.ragged_attention else
             f"mixed_step0_{'fused' if ex.fused_decode else 'split'}")
    if r_g != {step0: 1}:
        raise AssertionError(f"[graphs] {tag} mixed chunk: step 0 replays "
                             f"{r_g} (one expected)")
    g = ex.program_graphs[step0]
    rows[step0] = {"streams_equal": True, "eager_wall_ms_per_step": w_e,
                   "graph_wall_ms_per_step": w_g, "capture_s": g.capture_s,
                   "pool_bytes": g.pool_bytes,
                   "captured_launches": sum(g.launches.values())}
    pools = [x.pool_bytes for x in ex.program_graphs.values()]
    total = {"graphs": sorted(ex.program_graphs),
             "pool_bytes_total": sum(pools),
             "pool_bytes_largest": max(pools),
             "capture_s_total": sum(x.capture_s for x in
                                    ex.program_graphs.values()),
             "memory_reserved_bytes": torch.cuda.memory_reserved()}
    state["graphs"].setdefault("programs", {})[tag] = {"programs": rows,
                                                       **total}
    log(f"[graphs] {tag} {step0}: mixed chunk streams equal; "
        f"{w_e:.2f} ms/step eager step 0, {w_g:.2f} ms/step replayed; "
        f"captured in {g.capture_s:.2f} s, {g.pool_bytes / 2**20:.1f} MiB "
        f"({CARD})")
    log(f"[graphs] {tag}: {len(pools)} program graphs share one pool of "
        f"{total['pool_bytes_total'] / 2**20:.1f} MiB (largest single "
        f"capture {total['pool_bytes_largest'] / 2**20:.1f} MiB), captured "
        f"in {total['capture_s_total']:.2f} s; {torch.cuda.memory_reserved() / 2**30:.2f} "
        f"GiB reserved ({CARD})")


def phase_graphs(state) -> None:
    """The decode step captured into a CUDA graph on the five engines of
    the serve phases, each built with ``warmup=True`` (the step captured
    at build): llama3-8b bf16 default (fused route), the same engine on
    the split route (captured at its first replay), bf16 ragged, int8
    weights + int8 KV default and ragged (weights from seed 0, shared by
    the two engines of a type). Each: eager against graph (wall and
    device busy per step, host launches against device kernels per
    step), the graph pool's bytes, greedy streams equal."""
    import gc

    import torch

    from llmq_tpu_torch.engine.builder import build_engine

    state["graphs"] = {}
    for q8 in (False, True):
        cfg = _serve_cfg()
        if q8:
            cfg.model.quantization = cfg.model.kv_quantization = "int8"
        kind = "int8" if q8 else "bf16"
        engine = build_engine(cfg, warmup=True)
        ex = engine.executor
        _log_warmup(engine, f"graphs {kind} default")
        _graph_vs_eager(engine, f"{kind} default", state)
        _programs_vs_eager(engine, f"{kind} default", state)
        if not q8:
            ex.fused_decode = False
            _graph_vs_eager(engine, "bf16 split", state)
            _programs_vs_eager(engine, "bf16 split", state, prefill=False)
            ex.fused_decode = True
        params = ex.model.params
        ex.release_graphs()
        del engine, ex
        cfg.executor.ragged_attention.enabled = True
        engine = build_engine(cfg, params=params, warmup=True)
        _log_warmup(engine, f"graphs {kind} ragged")
        _graph_vs_eager(engine, f"{kind} ragged", state)
        _programs_vs_eager(engine, f"{kind} ragged", state)
        engine.executor.release_graphs()
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()


def phase_serve(state) -> None:
    counts, restore = _count_plain_calls()
    try:
        _serve_ragged(state, _serve_default(state))
    finally:
        restore()
    if counts:
        raise AssertionError(f"serving called plain twins: {counts}")
    log("[serve] no *_plain twin was called while serving")


def _log_warmup(engine, tag: str) -> None:
    """The engine's warmup: its split, the calibrated step time and the
    realtime admission cap that step time sets."""
    from llmq_tpu_torch.engine.engine import realtime_admission_cap

    ex = engine.executor
    if not ex.step_ms or set(ex.warmup_split) != {"capture", "warmup"}:
        raise AssertionError(f"{tag}: warmup did not run: step_ms "
                             f"{ex.step_ms}, split {ex.warmup_split}")
    log(f"[{tag}] warmup {ex.warmup_split['warmup']:.2f} s + capture "
        f"{ex.warmup_split['capture']:.2f} s; calibrated step "
        f"{ex.step_ms:.3f} ms, realtime admission cap "
        f"{realtime_admission_cap(ex.step_ms)} steps ({CARD})")


def _serve_default(state):
    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.ops import kernels

    cfg = _serve_cfg()
    t0 = time.perf_counter()
    engine = build_engine(cfg, warmup=True)
    torch.cuda.synchronize()
    mc = engine.executor.model_cfg
    log(f"[serve] built {mc.name} L={mc.n_layers} dim={mc.dim} "
        f"H={mc.n_heads}/{mc.n_kv_heads} ffn={mc.ffn_dim} vocab="
        f"{mc.vocab_size} in {time.perf_counter() - t0:.1f} s; "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB ({CARD})")
    _log_warmup(engine, "serve")
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
            mids.append(_post(base, {
                "content": f"Request {i} at {prio} priority: summarise the "
                           f"state of the queue in one line.",
                "priority": prio, "metadata": {"max_new_tokens": 32}}))
        turns = []
        for text in ("Hello! Tell me about paged attention, please.",
                     " And now say it again, but shorter."):
            turns.append(_poll(base, _post(base, {
                "content": text, "conversation_id": "smoke-conv",
                "priority": "high", "metadata": {"max_new_tokens": 32}})))
        results = [_poll(base, m) for m in mids] + turns
        mixed0 = engine.mixed_steps
        results += _coexisting_mix(base, engine, "bucket")
        torch.cuda.synchronize()
        rest_s = time.perf_counter() - t_rest
        launches = dict(kernels.LAUNCHES)
        tokens = _check_completed(results, "REST")
        cached = turns[1]["metadata"]["usage"]["cached_tokens"]
        if cached <= 0:
            raise AssertionError(f"turn 2 reports cached_tokens={cached}")
        if engine.mixed_steps <= mixed0:
            raise AssertionError("prefill and decode coexisted but no mixed "
                                 "step ran")
        for name in ("fused_decode", "kv_prefill_write", "prefill_attention"):
            if launches[name] <= 0:
                raise AssertionError(f"serving never launched {name}")
            state["kernels"][name]["launches"] = launches[name]
        log(f"[serve] {len(results)} REST requests completed in "
            f"{rest_s:.2f} s, {tokens} tokens; turn 2 cached_tokens "
            f"{cached}; mixed steps {engine.mixed_steps} "
            f"({engine.mixed_prefill_tokens_total} prefill tokens); "
            f"launches {launches} ({CARD})")

        # -- latency and rate, straight through the engine -----------------
        state["serve"] = _rates(engine, "serve", "bf16")

        # -- the split decode route, driven through REST -------------------
        engine.executor.fused_decode = False
        kernels.reset_launches()
        m = _poll(base, _post(base, {
            "content": "Split route check.", "priority": "normal",
            "metadata": {"max_new_tokens": 16}}))
        torch.cuda.synchronize()
        engine.executor.fused_decode = True
        split = dict(kernels.LAUNCHES)
        if m["status"] != "completed" or split["kv_cache_write"] <= 0 \
                or split["paged_decode_attention"] <= 0 \
                or split["fused_decode"] != 0:
            raise AssertionError(f"split route not taken: {m} {split}")
        for name in ("kv_cache_write", "paged_decode_attention"):
            state["kernels"][name]["launches"] = split[name]
        log(f"[serve] split decode route request completed; launches "
            f"{split}")
        _decode_breakdown(engine, state["serve"])
        _mixed_timing(engine, state["serve"], "bucket")
        _wave_timing(engine, state["serve"], "serve")
        log(f"[serve] peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({CARD})")
    finally:
        app.stop()
        engine.executor.release_graphs()
    return engine.executor.model.params


def _rates(engine, tag: str, what: str) -> dict:
    """TTFT and decode rate at B=1, the rate of 8 concurrent requests (90
    prompt tokens, 32 new each), and the executor's measured step time
    with the realtime admission cap it sets."""
    from llmq_tpu_torch.engine.engine import GenRequest, realtime_admission_cap

    ttft, rate1, prompt_tokens = _b1_rates(engine, tag)
    # The same requests with the prefill programs run eagerly.
    restore = _eager_programs(engine.executor)
    try:
        ttft_eager, _rate, _n = _b1_rates(engine, f"{tag} eager prefill")
    finally:
        restore()
    prompt = "The quick brown fox jumps over the lazy dog. " * 2
    hs = [engine.submit(GenRequest(id=f"{tag}-b{i}", prompt=f"{i}: " + prompt,
                                   max_new_tokens=32)) for i in range(8)]
    for x in hs:
        assert x.wait(300), "batch request timed out"
    t_first = min(x.submitted_at for x in hs)
    t_last = max(x.finished_at for x in hs)
    ntok = sum(len(x.result.tokens) for x in hs)
    per_req = [(len(x.result.tokens) - 1)
               / (x.finished_at - x.marks["first_token"]) for x in hs]
    # The realtime admission cap comes from the executor's measured step
    # time: show both, as a waiting REALTIME request sees them.
    step_ms = engine.executor.step_ms
    if not step_ms or step_ms <= 0:
        raise AssertionError(f"executor step time not measured: {step_ms}")
    cap = realtime_admission_cap(step_ms)
    log(f"[{tag}] executor step time {step_ms:.2f} ms (moving average); "
        f"realtime admission cap {cap} steps ({CARD})")
    log(f"[{tag}] llama3-8b {what}: TTFT {ttft * 1e3:.1f} ms (median; B=1, "
        f"{prompt_tokens}-token prompt; {ttft_eager * 1e3:.1f} ms with the "
        f"prefill program eager); decode {rate1:.1f} tok/s (B=1); 8 "
        f"concurrent: {ntok / (t_last - t_first):.1f} tok/s end to end, "
        f"{sum(per_req) / len(per_req):.1f} tok/s per request after its "
        f"first token ({CARD})")
    return {"ttft_ms_b1": ttft * 1e3,
            "ttft_ms_b1_eager_prefill": ttft_eager * 1e3,
            "decode_tok_s_b1": rate1,
            "tok_s_b8_e2e": ntok / (t_last - t_first),
            "decode_tok_s_per_req_b8": sum(per_req) / len(per_req),
            "prompt_tokens_b1": prompt_tokens, "executor_step_ms": step_ms,
            "realtime_admission_cap_steps": cap}


def _serve_cfg():
    from llmq_tpu_torch.core.config import Config

    cfg = Config()
    cfg.model.name = "llama3-8b"
    cfg.model.max_seq_len = 2048
    cfg.executor.max_decode_steps = 32
    cfg.device = "cuda"
    return cfg


def _serve_ragged(state, params) -> None:
    """The slice's path: a second engine on the same weights (its own
    pool) with ragged attention on, serving the same REST mix. Every
    prefill, continuation included, runs through the ragged step."""
    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.ops import kernels

    cfg = _serve_cfg()
    cfg.executor.ragged_attention.enabled = True
    engine = build_engine(cfg, params=params, warmup=True)
    ex = engine.executor
    _log_warmup(engine, "serve-ragged")
    log(f"[serve-ragged] engine on the same weights: ragged capacity "
        f"{ex.mixed_slice_tokens} tokens x {ex.mixed_prefill_slices} slices, "
        f"packed buffer {ex.ragged_buffer} rows")
    app = App(cfg, engine=engine)
    port = app.start(host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        engine.generate("warm up the ragged path", max_new_tokens=4)
        torch.cuda.synchronize()
        # -- this slice's path: REST -> engine -> ragged mixed steps -------
        kernels.reset_launches()
        t_rest = time.perf_counter()
        mids = []
        for i, prio in enumerate(["realtime", "high", "normal", "low"]):
            mids.append(_post(base, {
                "content": f"Ragged request {i} at {prio} priority: summarise "
                           f"the state of the queue in one line.",
                "priority": prio, "metadata": {"max_new_tokens": 32}}))
        results = _coexisting_mix(base, engine, "ragged")
        turns = []
        for text in ("Hello! Tell me about ragged attention, please.",
                     " And now say it again, but shorter."):
            turns.append(_poll(base, _post(base, {
                "content": text, "conversation_id": "ragged-conv",
                "priority": "high", "metadata": {"max_new_tokens": 32}})))
        results += [_poll(base, m) for m in mids] + turns
        torch.cuda.synchronize()
        rest_s = time.perf_counter() - t_rest
        launches = dict(kernels.LAUNCHES)
        tokens = _check_completed(results, "ragged REST")
        cached = turns[1]["metadata"]["usage"]["cached_tokens"]
        if cached <= 0:
            raise AssertionError(f"ragged turn 2 reports cached_tokens="
                                 f"{cached}")
        if engine.mixed_steps <= 0:
            raise AssertionError("ragged serving took no mixed step")
        for name in ("ragged_mixed_attention", "kv_prefill_write",
                     "fused_decode"):
            if launches[name] <= 0:
                raise AssertionError(f"ragged serving never launched {name}")
        if launches["prefill_attention"] != 0:
            raise AssertionError("ragged serving ran the bucket prefill "
                                 "attention kernel")
        state["kernels"]["ragged_mixed_attention"]["launches"] = \
            launches["ragged_mixed_attention"]
        log(f"[serve-ragged] {len(results)} REST requests completed in "
            f"{rest_s:.2f} s, {tokens} tokens; turn 2 cached_tokens "
            f"{cached}; mixed steps {engine.mixed_steps} "
            f"({engine.mixed_prefill_tokens_total} prefill tokens); "
            f"launches {launches} ({CARD})")
        ttft, rate1, n_prompt = _b1_rates(engine, "serve-ragged")
        state["serve"].update({"ragged_ttft_ms_b1": ttft * 1e3,
                               "ragged_decode_tok_s_b1": rate1,
                               "ragged_mixed_steps": engine.mixed_steps})
        log(f"[serve-ragged] llama3-8b bf16: TTFT {ttft * 1e3:.1f} ms "
            f"(median; B=1, "
            f"{n_prompt}-token prompt, ragged prefill); decode {rate1:.1f} "
            f"tok/s (B=1) ({CARD})")
        _mixed_timing(engine, state["serve"], "ragged")
        _wave_timing(engine, state["serve"], "serve-ragged")
    finally:
        app.stop()
        engine.executor.release_graphs()


def _mixed_timing(engine, out: dict, tag: str) -> None:
    """Wall and device-busy time per step of one mixed chunk (B=8 decode
    rows at 64 positions, K=16 steps, two 64-token prompt slices in step
    0), against the unfused order the engine used before mixed batching:
    the same 128 prompt tokens as one prefill call, then a plain decode
    chunk."""
    import numpy as np
    import torch

    ex = engine.executor
    B, K, MPs = ex.spec.batch_size, ex.chunk_size, ex.spec.max_pages_per_seq
    pages = engine.allocator.alloc(B * 8 + 8 + 4)      # idle engine
    bt = np.zeros((B, MPs), np.int32)
    bt[:, :8] = np.asarray(pages[:B * 8]).reshape(B, 8)
    args = (np.full(B, 100, np.int32), np.full(B, 64, np.int32), bt,
            np.zeros(B, np.float32), np.full(B, K, np.int32))
    # Slice 0's table also backs the unfused 128-token prefill.
    pf_bt = np.zeros((2, MPs), np.int32)
    pf_bt[0, :8] = pages[B * 8:B * 8 + 8]
    pf_bt[1, :4] = pages[B * 8 + 8:]
    rng = np.random.default_rng(0)
    pf = [(0, list(rng.integers(3, 250, 64)), 0, pf_bt[i], 0.0)
          for i in range(2)]

    def timed(fn):
        fn()                                          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return wall, _device_us(_device_trace(fn)) / 1e3

    mixed_wall, mixed_busy = timed(lambda: ex.mixed_chunk(*args, pf))
    unfused_wall, unfused_busy = timed(lambda: (
        ex.prefill(pf[0][1] + pf[1][1], 0, pf_bt[0], 0.0, 0),
        ex.decode_chunk(*args)))
    engine.allocator.free(pages)
    out.update({
        f"{tag}_mixed_chunk_wall_ms_per_step": mixed_wall / K,
        f"{tag}_mixed_chunk_device_ms_per_step": mixed_busy / K,
        f"{tag}_prefill128_then_decode_chunk_wall_ms": unfused_wall,
        f"{tag}_prefill128_then_decode_chunk_device_ms": unfused_busy})
    log(f"[serve-{tag}] mixed chunk (B={B}, K={K}, 2 x 64 prompt tokens): "
        f"{mixed_wall / K:.2f} ms/step wall, {mixed_busy / K:.2f} ms/step "
        f"device busy, {mixed_wall:.1f} ms in all; unfused (prefill of the "
        f"128 tokens, then a decode chunk): {unfused_wall:.1f} ms wall, "
        f"{unfused_busy:.1f} ms device busy ({CARD})")


def _wave_timing(engine, out: dict, tag: str) -> None:
    """Admission of four ~600-token prompts with no decode row active:
    the wall to all four first tokens as one wave
    (``prefill_multi_async``, one fetch) against four single programs
    (``prefill_async`` each, one fetch), in turns (single, wave, wave,
    single; host clock to the fetched tokens), and each one's device
    busy time from a trace."""
    import numpy as np
    import torch

    ex = engine.executor
    reqs, pages = _program_requests(engine, [600, 601, 599, 600],
                                    np.random.default_rng(11))

    def wave():
        return ex.gather_scalars(ex.prefill_multi_async(reqs))

    def singles():
        return ex.gather_scalars([ex.prefill_async(*r) for r in reqs])

    walls = {"wave": [], "singles": []}
    firsts = {}
    for name in ("singles", "wave", "wave", "singles"):
        fn = wave if name == "wave" else singles
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        firsts[name] = fn()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    if not np.array_equal(firsts["wave"], firsts["singles"]):
        raise AssertionError(f"[{tag}] wave first tokens {firsts['wave']} "
                             f"differ from single programs' "
                             f"{firsts['singles']}")
    busy = {n: _device_us(_device_trace(f)) / 1e3
            for n, f in (("wave", wave), ("singles", singles))}
    engine.allocator.free(pages)
    out.update({f"{tag}_wave4x600_wall_ms": walls["wave"],
                f"{tag}_single4x600_wall_ms": walls["singles"],
                f"{tag}_wave4x600_device_ms": busy["wave"],
                f"{tag}_single4x600_device_ms": busy["singles"]})
    log(f"[{tag}] four ~600-token prompts, no decode row: one wave "
        f"{', '.join(f'{w:.1f}' for w in walls['wave'])} ms wall "
        f"({busy['wave']:.1f} ms device busy); four single programs "
        f"{', '.join(f'{w:.1f}' for w in walls['singles'])} ms wall "
        f"({busy['singles']:.1f} ms device busy); first tokens equal "
        f"({CARD})")


def _q8_prefill_share(engine, out: dict, tag: str) -> None:
    """The plain int8 prefill attention's share of the int8 TTFT program:
    the device time of one replay of ``prefill_b128`` (the B=1 TTFT
    prompt's program) against 32 layers of
    ``dispatch_prefill_attention_q8`` (gather, dequantize, blockwise
    attention) timed alone at that program's shapes."""
    import numpy as np
    import torch

    from llmq_tpu_torch.ops.attention import dispatch_prefill_attention_q8

    ex = engine.executor
    T = ex.prefill_buckets[0]
    reqs, pages = _program_requests(engine, [90], np.random.default_rng(5))
    prog_ms = _device_us(_device_trace(lambda: ex.gather_scalars(
        ex._prefill_wave(reqs, 1)))) / 1e3
    mc = ex.model_cfg
    p = ex._programs[f"prefill_b{T}"].bufs
    q = torch.randn((1, T, mc.n_heads, mc.head_dim), device=ex.device).to(
        ex.cache["k_scale"].dtype)
    pools = (ex.cache["k"], ex.cache["v"], ex.cache["k_scale"],
             ex.cache["v_scale"])
    valid = torch.arange(T, device=ex.device)[None] < p["len"][:, None]
    seq_lens = torch.where(valid, p["pos"], -1).amax(1) + 1
    attn_ms = device_ms(lambda i: dispatch_prefill_attention_q8(
        q, pools, p["bt"], p["pos"], seq_lens, i % mc.n_layers), iters=8)
    engine.allocator.free(pages)
    share = mc.n_layers * attn_ms / prog_ms
    out.update({f"{tag}_prefill_b{T}_device_ms": prog_ms,
                f"{tag}_q8_prefill_attention_ms_per_layer": attn_ms,
                f"{tag}_q8_prefill_attention_share": share})
    log(f"[{tag}] int8 prefill_b{T} (90 tokens): {prog_ms:.2f} ms device "
        f"time a replay; the plain int8 prefill attention takes "
        f"{attn_ms:.3f} ms a layer alone, {mc.n_layers} layers "
        f"{mc.n_layers * attn_ms:.2f} ms = {100 * share:.0f}% of it "
        f"({CARD})")


def _decode_breakdown(engine, out: dict, tag: str = "serve") -> None:
    """Where one B=8, 16-step decode chunk of the served model spends its
    time: host wall per step, device busy per step (sum of the kernels'
    device time in a torch.profiler trace), the top kernels and the
    port's own (``PORT_KERNELS``)."""
    import numpy as np
    import torch

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
    prof = _device_trace(lambda: ex.decode_chunk(*args))
    engine.allocator.free(pages)
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy_ms = _device_us(prof) / 1e3 / K
    n_kernels = sum(count for _us, _key, count in rows) / K
    out.update({"decode_step_wall_ms_b8": wall_ms,
                "decode_step_device_busy_ms_b8": busy_ms,
                "decode_step_kernel_launches_b8": n_kernels})
    log(f"[{tag}] decode chunk B={B} K={K}: {wall_ms:.2f} ms/step wall, "
        f"{busy_ms:.2f} ms/step device busy "
        f"({100 * busy_ms / wall_ms:.0f}% busy), {n_kernels:.0f} kernel "
        f"launches a step ({CARD})")
    for dev_us, key, count in rows[:10]:
        log(f"[{tag}]   {dev_us / 1e3 / K:8.3f} ms/step  {count // K:5d} "
            f"calls/step  {key[:90]}")
    own = {}
    for dev_us, key, count in rows:
        for name in PORT_KERNELS:
            if name in key:
                ms, n = own.get(name, (0.0, 0))
                own[name] = (ms + dev_us / 1e3 / K, n + count // K)
    out["decode_step_port_kernels_b8"] = {
        k: {"ms_per_step": ms, "calls_per_step": n}
        for k, (ms, n) in own.items()}
    for name, (ms, n) in own.items():
        log(f"[{tag}]   {ms:8.3f} ms/step  {n:5d} calls/step  {name} "
            f"(the port's)")


#: The port's kernel functions (csrc/*.cu), as the profiler names them.
PORT_KERNELS = ("fused_decode_split_kernel", "paged_decode_kernel",
                "ragged_split_kernel", "prefill_attention_kernel",
                "kv_cache_write_kernel", "kv_prefill_write_kernel")


#: Kernels that must not launch in an int8-KV engine: the bf16 pools'
#: kernels. The int8 prefill write and attention are plain scatters and
#: dequantize-and-attend, as in the JAX package.
BF16_ONLY = ("fused_decode", "kv_prefill_write", "prefill_attention",
             "kv_cache_write", "ragged_mixed_attention",
             "paged_decode_attention")


def phase_serve_int8(state) -> None:
    """llama3-8b with int8 weights (random, from seed 0, quantized leaf by
    leaf) and int8 KV pools at full width and depth: the default engine
    (mixed batching, bucket steps) and then a second engine on the same
    weights with ragged attention on, each serving the REST mix of the
    bf16 engines. No ``*_plain`` twin may be called."""
    import gc

    import torch

    gc.collect()                      # the bf16 engines are gone: free
    torch.cuda.empty_cache()          # their weights before the int8 ones
    torch.cuda.reset_peak_memory_stats()
    state["serve_int8"] = {}
    counts, restore = _count_plain_calls()
    try:
        params = _serve_int8(state, ragged=False, params=None)
        _serve_int8(state, ragged=True, params=params)
    finally:
        restore()
    state["serve_int8"]["plain_twin_calls"] = sum(counts.values())
    if counts:
        raise AssertionError(f"int8 serving called plain twins: {counts}")
    peak = torch.cuda.max_memory_allocated()
    state["serve_int8"]["peak_memory_gib"] = peak / 2**30
    log(f"[serve-int8] no *_plain twin was called; peak memory "
        f"{peak / 2**30:.2f} GiB over both int8 engines ({CARD})")


def _serve_int8(state, *, ragged: bool, params):
    """One int8 engine through REST: build, warm up, then (launch counts
    zeroed) the six-message mix, a two-turn conversation and the
    coexisting-prompt mix; every request must complete, turn 2 report
    cached tokens and mixed steps run; kernel 5 (and with ragged on,
    kernel 7) must launch and no bf16 kernel may. Then rates and (bucket
    engine) the decode breakdown. Returns the weights."""
    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.ops import kernels
    from llmq_tpu_torch.ops.quant import params_bytes

    tag = "serve-int8-ragged" if ragged else "serve-int8"
    out = state["serve_int8"]
    pre = "ragged_" if ragged else ""
    cfg = _serve_cfg()
    cfg.model.quantization = "int8"
    cfg.model.kv_quantization = "int8"
    cfg.executor.ragged_attention.enabled = ragged
    t0 = time.perf_counter()
    engine = build_engine(cfg, params=params, warmup=True)
    torch.cuda.synchronize()
    ex = engine.executor
    _log_warmup(engine, tag)
    weights = params_bytes(ex.model.params)
    pool = sum(t.numel() * t.element_size() for t in ex.cache.values())
    out[pre + "build_s"] = time.perf_counter() - t0
    out["weight_bytes"] = weights
    out["kv_pool_bytes"] = pool
    log(f"[{tag}] built llama3-8b int8 weights + int8 KV in "
        f"{time.perf_counter() - t0:.1f} s: weights {weights / 1e9:.3f} GB, "
        f"pools {pool / 1e9:.3f} GB (int8 K/V + bf16 scales); memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({CARD})")
    app = App(cfg, engine=engine)
    port = app.start(host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        engine.generate("warm up the int8 path", max_new_tokens=4)
        torch.cuda.synchronize()
        # -- the int8 path: REST -> queue -> worker -> engine -> kernels ---
        kernels.reset_launches()
        t_rest = time.perf_counter()
        mids = []
        for i, prio in enumerate(["realtime", "high", "normal", "low",
                                  "normal", "high"]):
            mids.append(_post(base, {
                "content": f"int8 request {i} at {prio} priority: summarise "
                           f"the state of the queue in one line.",
                "priority": prio, "metadata": {"max_new_tokens": 32}}))
        turns = []
        for text in ("Hello! Tell me about int8 caches, please.",
                     " And now say it again, but shorter."):
            turns.append(_poll(base, _post(base, {
                "content": text, "conversation_id": f"{tag}-conv",
                "priority": "high", "metadata": {"max_new_tokens": 32}})))
        results = [_poll(base, m) for m in mids] + turns
        mixed0 = engine.mixed_steps
        results += _coexisting_mix(base, engine, tag)
        torch.cuda.synchronize()
        rest_s = time.perf_counter() - t_rest
        launches = dict(kernels.LAUNCHES)
        tokens = _check_completed(results, tag)
        cached = turns[1]["metadata"]["usage"]["cached_tokens"]
        if cached <= 0:
            raise AssertionError(f"{tag}: turn 2 reports cached_tokens="
                                 f"{cached}")
        if engine.mixed_steps <= mixed0:
            raise AssertionError(f"{tag}: prefill and decode coexisted but "
                                 f"no mixed step ran")
        want = ["fused_decode_q8"] + (["ragged_mixed_attention_q8"]
                                      if ragged else [])
        for name in want:
            if launches[name] <= 0:
                raise AssertionError(f"{tag}: serving never launched {name}")
        wrong = {n: launches[n] for n in BF16_ONLY if launches[n]}
        if not ragged and launches["ragged_mixed_attention_q8"]:
            wrong["ragged_mixed_attention_q8"] = \
                launches["ragged_mixed_attention_q8"]
        if wrong:
            raise AssertionError(f"{tag}: bf16-pool kernels launched: {wrong}")
        name = "ragged_mixed_attention_q8" if ragged else "fused_decode_q8"
        state["kernels"][name]["launches"] = launches[name]
        out[pre + "rest_requests"] = len(results)
        out[pre + "rest_s"] = rest_s
        out[pre + "mixed_steps"] = engine.mixed_steps
        out[pre + "launches"] = {k: v for k, v in launches.items() if v}
        log(f"[{tag}] {len(results)} REST requests completed in "
            f"{rest_s:.2f} s, {tokens} tokens; turn 2 cached_tokens "
            f"{cached}; mixed steps {engine.mixed_steps} "
            f"({engine.mixed_prefill_tokens_total} prefill tokens); "
            f"launches {out[pre + 'launches']} ({CARD})")
        rates = _rates(engine, tag, "int8 weights + int8 KV"
                       + (", ragged" if ragged else ""))
        out.update({pre + k: v for k, v in rates.items()})
        if not ragged:
            _decode_breakdown(engine, out, tag)
            _q8_prefill_share(engine, out, tag)
        _wave_timing(engine, out, tag)
    finally:
        app.stop()
        ex.release_graphs()
    return ex.model.params


PHASES = [("env", phase_env), ("build", phase_build),
          ("kernels", phase_kernels), ("split", phase_split),
          ("model", phase_model), ("graphs", phase_graphs),
          ("serve", phase_serve),
          ("serve-int8", phase_serve_int8)]


def main(argv=()) -> int:
    """Runs the phases; ``argv`` holds the command-line arguments (none:
    every phase)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(n for n, _ in PHASES),
                    help="comma-separated phases to run, in the script's "
                         "order (default: all); a partial run prints its "
                         "tables but no ok line")
    args = ap.parse_args(list(argv))
    chosen = args.phases.split(",")
    unknown = set(chosen) - {n for n, _ in PHASES}
    if unknown:
        ap.error(f"unknown phases: {sorted(unknown)}")
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
        if name not in chosen:
            continue
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
                      "serve": state.get("serve"),
                      "serve_int8": state.get("serve_int8"),
                      "int_mm": state.get("int_mm"),
                      "launch_floor_ms": state.get("launch_floor_ms"),
                      "graphs": state.get("graphs")}, default=str))
    print(CARD)
    if len(chosen) < len(PHASES):
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
