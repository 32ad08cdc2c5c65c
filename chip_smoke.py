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
8. serve-plane — the serving process around the serve phase's bf16
                 default engine (same weights, same pool: 8 slots, 512
                 pages of 16), over REST with retry backoff shortened to
                 0.05 s: pool pressure (six 1200-token LOW requests
                 arriving together and decoding, then two REALTIME
                 ones: a preemption must release the pages of a LOW
                 that has generated tokens, which rebuilds and resumes;
                 every request completes its tokens, the REALTIME ones
                 before the LOWs they preempted, and once idle the pool
                 holds only the radix tree's pages and the pins);
                 at-least-once delivery through an
                 engine loop killed by a BaseException with four
                 requests decoding (the supervisor restarts it once,
                 each message retries through the delayed queue and
                 completes once, the graphs are replayed and none is
                 captured again); a message that fails on every attempt
                 in the process function and one the engine finishes
                 "error" reach the dead-letter queue, and the second is
                 requeued by the admin route; a conversation of three turns (turns 2
                 and 3 cached), its state update, and its eviction
                 freeing its pinned pages; "urgent" served at HIGH; an
                 SSE stream equal to the queued response; 429 past a
                 low queue-depth limit and 503 with the engine stopped,
                 both with Retry-After. The configuration is
                 ``configs/config.yaml`` with the phase's overrides,
                 written to a file and read by ``load_config``; the
                 process is the full ``App`` (load balancer, resource
                 scheduler). ``/api/v1/resources`` lists the
                 card by its name and memory with the engine's chip
                 allocated, and it stays online past twice a 3 s
                 heartbeat timeout; ``/metrics`` (parsed) holds the
                 queue's completed and failed counts by priority, the
                 supervisor's restart, the dead-letter depth, the
                 engine's preemptions and pages in use, and the
                 shedder's counts, each equal to its owner's; the
                 learned prefill ETA agrees with the prefills the engine
                 reported; a drain with four requests decoding ends
                 idle, /health reading "draining" meanwhile, and each
                 completes once. Printed: a scrape's ms while 8 rows
                 decode, and B=1 and 8-concurrent tok/s with the engine's
                 metrics on and off. Then the observability plane, at the
                 JAX package's defaults (on): a mix of four priorities,
                 a two-turn conversation and an SSE stream, whose traces
                 list their stages in the recorder's order and whose
                 critical-path segments sum to their end to end (no
                 conservation failure); the SSE ``traceparent`` carries
                 the request's trace id; every request carries the ten
                 usage fields, page-seconds and a goodput; the ledger's
                 attributed device seconds stay within the summed
                 ``step_device_ms``; the pool pressure once more with a
                 REALTIME row decoding throughout, whose rebuilds
                 re-prefill in mixed slices, billed as "preempt"
                 waste; both SLO burn windows and the flight recorder
                 answer; the serve boot's weights, compile, warmup and
                 first-token stages are on ``/health`` and in
                 ``replica_ready_seconds``. While 8 rows decode: one step
                 sample per chunk fetched, overlap ratio > 0, the
                 telemetry's tok/s within 10% of the phase's own count,
                 MFU from the rate, HBM weight and pool bytes equal to
                 the model's and the pools', free memory as
                 ``torch.cuda.mem_get_info`` reads it, a 1 s on-demand
                 profile (202, then 409, then done) whose trace holds
                 kernels 1-3 by name, written after the engine's hold:
                 the engine's longest wait for a chunk stays within the
                 profiler's longest hold (its stop holds the interpreter
                 ~8-10 s) plus 1 s, and the card's heartbeat gap under
                 the serving default timeout (30 s); five carried
                 chunks through the engine, each boundary idle under
                 0.1 ms by the chunks' CUDA events. Decode at B=1 and 8
                 concurrent with observability on and off in turns (on,
                 off, off, on), after one uncounted 8-concurrent batch,
                 each turn's rate the median of three: the "on" turns
                 within 3% of the "off" ones.
9. serve-int8 — llama3-8b with int8 weights and int8 KV at full width and
                 depth (``LLMQ_MODEL_QUANTIZATION=int8
                 LLMQ_MODEL_KV_QUANTIZATION=int8``), the same REST mix:
                 kernel 5 launches and no bf16-pool kernel does; then a
                 second engine on the same weights with ragged attention
                 on: kernel 7 launches. Rates, the decode breakdown,
                 the plain int8 prefill attention's share of the int8
                 TTFT program, the wave admission, weight bytes and
                 peak memory; and serve-plane's pool-pressure traffic
                 once more over the int8 pool and its scale pools.

No ``*_plain`` twin may be called while serving. On the card every
decode step, prefill program and mixed step 0 is a replay of one of the
executor's captured graphs; the launch counts add each replay's
kernels. Each engine's graphs are released before the next is built.

Exits non-zero on any failure. On success the last lines are the kernel
table as JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
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


def clocks() -> str:
    """The card's SM clock, power draw and temperature now, as
    ``nvidia-smi`` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return "SM clock, power, temperature: " + out.stdout.strip()


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


def _profiled(fn, activities, complete, what: str):
    """``fn()`` under torch.profiler, then a device synchronize, taken
    again until ``complete(prof)`` holds, ten times at most, the n-th
    retake after n x 50 ms. The profiler now and then drops the device
    events of a trace, all of them or a few (runs of this script on the
    H100 saw 9 kernels recorded for 10 calls, and 0 for 20, and once 19
    for 20 in five traces taken within 0.2 s), at no fixed place in the
    script: an incomplete trace is taken again, not used."""
    import torch
    from torch.profiler import profile

    for attempt in range(10):
        time.sleep(0.05 * attempt)
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        if complete(prof):
            return prof
        log(f"[trace] {what}: the profiler lost device events, tracing "
            f"again")
    raise AssertionError(f"the profiler lost device events of {what} in "
                         f"ten traces running")


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn(i)``: the summed durations of the
    device events it caused over ``iters`` calls (torch.profiler),
    divided by ``iters``. Gaps while the host prepares the next launch
    are not counted — at these sizes a CUDA-event loop would measure the
    Python wrapper, not the kernel. A trace is complete when it holds a
    kernel for each call at least, and a kernel for each kernel launch
    the host made (:func:`_host_launches`) or the same kernels and
    launches as an earlier trace of this call (some calls launch more
    than the profiler shows kernels for, every time: the int8 prefill
    attention's 8 calls made 1064 launches and showed 1041 to 1046
    kernels in every trace on the H100); else it is taken again."""
    import torch
    from torch.profiler import ProfilerActivity

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()

    def calls():
        for i in range(iters):
            fn(i)

    seen = set()

    def complete(prof):
        n, launched = _kernel_events(prof), _host_launches(prof)
        if n >= iters and _device_us(prof) > 0 and (
                n >= launched or (n, launched) in seen):
            return True
        seen.add((n, launched))
        log(f"[trace] {n} kernels recorded for {iters} calls and "
            f"{launched} host launches")
        return False
    prof = _profiled(calls, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     complete, f"{iters} timed calls")
    return _device_us(prof) / 1e3 / iters


def _host_launches(prof) -> int:
    """Kernel launches the host made in a trace: the runtime API's
    (``cuda*``) or the low-level API's (``cu*``) launch calls, whichever
    counted more (a runtime launch may also show as the ``cu*`` call it
    makes)."""
    runtime = low_level = 0
    for e in prof.key_averages():
        if e.key in KERNEL_LAUNCH_CALLS:
            if e.key.startswith("cuda"):
                runtime += e.count
            else:
                low_level += e.count
    return max(runtime, low_level)


def _kernel_events(prof) -> int:
    """Kernels in a trace (device events that are not copies or sets)."""
    import torch

    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


def _device_trace(fn):
    """Run ``fn()`` under torch.profiler recording device activity only
    (host-op events of whole served steps would cost the trace more
    than the steps) and return the profile; ``fn`` runs again while the
    trace holds no device time (:func:`_profiled`)."""
    from torch.profiler import ProfilerActivity

    return _profiled(fn, [ProfilerActivity.CUDA],
                     lambda p: _device_us(p) > 0, "a device trace")


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
    try:
        import yaml
        log(f"[env] yaml {yaml.__version__} (the config file's reader)")
    except ImportError as e:
        log(f"[env] yaml does not import: {e}")
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


#: Numbers the B=1 prompts: each starts with its own two digits, so that
#: no prompt's first page is in an engine's prefix cache.
B1_PROMPTS = itertools.count()


def _b1_rates(engine, tag: str):
    """TTFT and decode rate of one request alone (90-token prompt, 32
    new tokens): the medians of three requests, one after another, each
    prompt's first page its own (no prefix-cache hit)."""
    from llmq_tpu_torch.engine.engine import GenRequest

    base = "The quick brown fox jumps over the lazy dog. " * 2
    ttfts, rates = [], []
    for i in range(3):
        prompt = f"{next(B1_PROMPTS) % 100:02d}" + base[2:]
        h = engine.submit(GenRequest(id=f"ttft-{i}-{time.time()}",
                                     prompt=prompt, max_new_tokens=32))
        assert h.wait(120), "ttft request timed out"
        ttfts.append(h.marks["first_token"] - h.submitted_at)
        rates.append((len(h.result.tokens) - 1)
                     / (h.finished_at - h.marks["first_token"]))
    log(f"[{tag}] B=1: TTFT {', '.join(f'{t * 1e3:.1f}' for t in ttfts)} ms; "
        f"decode {', '.join(f'{r:.1f}' for r in rates)} tok/s; step "
        f"{engine.executor.step_ms:.2f} ms (moving average); {clocks()}")
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
    from torch.profiler import ProfilerActivity

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    def run():
        start.record()
        fn()
        end.record()
    prof = _profiled(run, acts, lambda p: _device_us(p) > 0, "a chunk")
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


def _device_events(prof):
    """(start µs, end µs, name) of every device event of a trace (kernels
    and copies), by start."""
    import torch

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def _chunk_gaps(events, n_chunks: int):
    """Device idle between the chunks of a trace. Every chunk opens with
    the host-to-device copies of its staged inputs, and no step copies
    from the host, so each run of such copies marks a chunk's start. For
    each boundary: the time from the last kernel before those copies to
    the first kernel after them, in ms (the copies' own microseconds
    included). Also the run's idle ms in all: its span from first to last
    event less the union of its events. The boundaries are None when the
    trace does not show ``n_chunks`` starts."""
    busy, end = 0.0, None
    for a, b, _n in events:
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    idle_ms = ((events[-1][1] - events[0][0]) - busy) / 1e3
    starts = [i for i, e in enumerate(events) if "HtoD" in e[2]
              and (i == 0 or "HtoD" not in events[i - 1][2])]
    if len(starts) != n_chunks:
        return None, idle_ms

    def kernel(e):
        return not e[2].startswith(("Memcpy", "Memset"))

    gaps = []
    for i in starts[1:]:
        last = max(e[1] for e in events[:i] if kernel(e))
        first = next(e[0] for e in events[i:] if kernel(e))
        gaps.append((first - last) / 1e3)
    return gaps, idle_ms


def _pipeline_vs_blocking(engine, tag: str, state) -> None:
    """The async pipeline's dispatch against the blocking chunk, on an
    idle engine: four 16-step chunks of B=8 rows from 64 positions over
    fresh pages, every budget K. Blocking: ``decode_chunk`` four times,
    each next chunk assembled on the host from the last one's tokens.
    Carried at depth 2: ``decode_chunk_start`` from the previous handle's
    device-carried end state, the next chunk dispatched before the
    previous one is fetched. Each path once timed (wall per chunk, host
    clock to the last fetched token) and once under the profiler (device
    activity only): the device idle time between chunks, from one chunk's
    last kernel to the next one's first, and the steps that ran with no
    live row. Tokens must be equal."""
    from collections import deque

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    ex = engine.executor
    B, K, N = ex.spec.batch_size, ex.chunk_size, 4
    eos = ex.spec.eos_id
    pages = engine.allocator.alloc(B * 8)
    bt = np.zeros((B, ex.spec.max_pages_per_seq), np.int32)
    bt[:, :8] = np.asarray(pages).reshape(B, 8)
    tok0 = np.arange(100, 100 + B, dtype=np.int32)
    pos0 = np.full(B, 64, np.int32)
    temps = np.zeros(B, np.float32)

    def blocking():
        tok, pos, latched, outs = tok0.copy(), pos0.copy(), \
            np.zeros(B, bool), []
        for _ in range(N):
            budgets = np.where(latched, 0, K).astype(np.int32)
            out = ex.decode_chunk(tok, pos, bt, temps, budgets)
            outs.append(out)
            for b in range(B):
                for t in out[b, :budgets[b]]:
                    tok[b], pos[b] = t, pos[b] + 1
                    if t == eos:
                        latched[b] = True
                        break
        return outs

    def carried():
        outs, inflight, h = [], deque(), None
        full = np.full(B, K, np.int32)
        for _ in range(N):
            h = (ex.decode_chunk_start(tok0, pos0, bt, temps, full)
                 if h is None else
                 ex.decode_chunk_start(None, None, bt, temps, full, carry=h))
            inflight.append(h)
            if len(inflight) == 2:
                outs.append(inflight.popleft().fetch())
        outs += [x.fetch() for x in inflight]
        return outs

    ex.decode_chunk(tok0, pos0, bt, temps, np.ones(B, np.int32))   # warm
    res = {}
    for name, fn in (("blocking", blocking), ("carried", carried)):
        torch.cuda.synchronize()
        idle0 = ex.idle_steps
        t0 = time.perf_counter()
        outs = fn()
        wall = (time.perf_counter() - t0) * 1e3 / N
        idle_steps = ex.idle_steps - idle0
        traced = {}

        def run(fn=fn):
            traced["outs"] = fn()
        prof = _profiled(run, [ProfilerActivity.CUDA],
                         lambda p: _device_us(p) > 0, f"{name} chunks")
        outs2 = traced["outs"]
        gaps, idle_ms = _chunk_gaps(_device_events(prof), N)
        res[name] = {"outs": outs + outs2, "wall_ms_per_chunk": wall,
                     "gaps_ms": gaps, "idle_ms": idle_ms,
                     "no_live_row_steps": idle_steps}
    engine.allocator.free(pages)
    b_outs, c_outs = res["blocking"].pop("outs"), res["carried"].pop("outs")
    if not all(np.array_equal(b_outs[0], o) for o in b_outs[N::N]) or \
            not all(np.array_equal(a, b) for a, b in zip(b_outs, c_outs)):
        raise AssertionError(f"[graphs] {tag}: carried chunks' tokens differ "
                             f"from the blocking chunks'")
    state["graphs"].setdefault("pipeline", {})[tag] = {
        "chunks": N, "steps": K, "rows": B, "tokens_equal": True, **res}

    def gaps(r):
        if r["gaps_ms"] is None:
            return "chunk starts not found in the trace"
        return ", ".join(f"{g:.3f}" for g in r["gaps_ms"]) + " ms"

    blk, car = res["blocking"], res["carried"]
    log(f"[graphs] {tag} pipeline: {N} chunks of {K} steps, B={B}, tokens "
        f"equal; wall per chunk blocking {blk['wall_ms_per_chunk']:.2f} ms, "
        f"carried at depth 2 {car['wall_ms_per_chunk']:.2f} ms; device idle "
        f"between chunks blocking {gaps(blk)} ({blk['idle_ms']:.3f} ms idle "
        f"in the profiled run), carried {gaps(car)} ({car['idle_ms']:.3f} "
        f"ms); "
        f"steps with no live row blocking {blk['no_live_row_steps']}, "
        f"carried {car['no_live_row_steps']} ({CARD})")


def phase_graphs(state) -> None:
    """The decode step captured into a CUDA graph on the five engines of
    the serve phases, each built with ``warmup=True`` (the step captured
    at build): llama3-8b bf16 default (fused route), the same engine on
    the split route (captured at its first replay), bf16 ragged, int8
    weights + int8 KV default and ragged (weights from seed 0, shared by
    the two engines of a type). Each: eager against graph (wall and
    device busy per step, host launches against device kernels per
    step), the graph pool's bytes, greedy streams equal. The bf16
    default engine also runs four chunks carried at depth 2 against the
    same four blocking (the async pipeline's dispatch)."""
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
            _pipeline_vs_blocking(engine, f"{kind} default", state)
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
    import gc

    counts, restore = _count_plain_calls()
    try:
        _serve_ragged(state, _serve_default(state))
    finally:
        restore()
    # The ragged engine is gone: collect it now, not inside a later
    # phase's timed window.
    gc.collect()
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

    from llmq_tpu_torch.observability import critical_path as cp

    cfg = _serve_cfg()
    t0 = time.perf_counter()
    # The serve boot, as ``python -m llmq_tpu_torch serve`` records it:
    # the build stamps its stages here, the first token closes it.
    cp.boot_begin(SERVE_BOOT_ID, "serve", process=True)
    engine = build_engine(cfg, warmup=True)
    torch.cuda.synchronize()
    mc = engine.executor.model_cfg
    log(f"[serve] built {mc.name} L={mc.n_layers} dim={mc.dim} "
        f"H={mc.n_heads}/{mc.n_kv_heads} ffn={mc.ffn_dim} vocab="
        f"{mc.vocab_size} in {time.perf_counter() - t0:.1f} s; "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB ({CARD})")
    _log_warmup(engine, "serve")
    _check_defaults(engine, "serve")
    app = App(cfg, engine=engine)
    port = app.start(host="127.0.0.1", port=0)
    cp.boot_ready(SERVE_BOOT_ID, time.perf_counter() - t0)
    base = f"http://127.0.0.1:{port}"
    try:
        engine.generate("warm up the card", max_new_tokens=4)
        torch.cuda.synchronize()
        status, health = _http("GET", f"{base}/health")
        assert status == 200 and health["engine"] == "running", health
        # The first token closed the serve boot (later builds in this
        # process add their stages to the same record).
        boot = health.get("boot") or {}
        if boot.get("replica_id") != SERVE_BOOT_ID or "first_token" not in \
                boot.get("stages_s", {}):
            raise AssertionError(f"serve boot on /health: {health}")
        state["serve_boot"] = boot
        log(f"[serve] boot {boot['stages_s']} s, ready after "
            f"{boot['total_s']} s ({CARD})")

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
            f"launches {launches}; {_engine_stats(engine)} ({CARD})")

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
        if "serve-plane" in state.get("chosen", ()):
            # The serve-plane phase serves on this engine: its graphs
            # stay captured.
            state["serve_engine"] = engine
        else:
            engine.executor.release_graphs()
    return engine.executor.model.params


def _rates(engine, tag: str, what: str) -> dict:
    """TTFT and decode rate at B=1, the rate of 8 concurrent requests (90
    prompt tokens, 32 new each), and the executor's measured step time
    with the realtime admission cap it sets."""
    from llmq_tpu_torch.engine.engine import realtime_admission_cap

    ttft, rate1, prompt_tokens = _b1_rates(engine, tag)
    # The same requests with the prefill programs run eagerly.
    restore = _eager_programs(engine.executor)
    try:
        ttft_eager, _rate, _n = _b1_rates(engine, f"{tag} eager prefill")
    finally:
        restore()
    b8, per_req = _b8_rate(engine, tag)
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
        f"concurrent: {b8:.1f} tok/s end to end, {per_req:.1f} tok/s per "
        f"request after its first token; {_switches(engine)} ({CARD})")
    out = {"ttft_ms_b1": ttft * 1e3,
           "ttft_ms_b1_eager_prefill": ttft_eager * 1e3,
           "decode_tok_s_b1": rate1,
           "tok_s_b8_e2e": b8,
           "decode_tok_s_per_req_b8": per_req,
           "prompt_tokens_b1": prompt_tokens, "executor_step_ms": step_ms,
           "realtime_admission_cap_steps": cap,
           "shared_prefix": _shared_prefix(engine, tag)}
    out["switches_off"] = _rates_switches_off(engine, tag, what)
    return out


def _b8_rate(engine, tag: str):
    """8 concurrent requests (90 prompt tokens, 32 new each): tok/s end to
    end, and the mean per request after its first token."""
    from llmq_tpu_torch.engine.engine import GenRequest

    prompt = "The quick brown fox jumps over the lazy dog. " * 2
    hs = [engine.submit(GenRequest(id=f"{tag}-b{i}", prompt=f"{i}: " + prompt,
                                   max_new_tokens=32)) for i in range(8)]
    for x in hs:
        assert x.wait(300), "batch request timed out"
    e2e = (sum(len(x.result.tokens) for x in hs)
           / (max(x.finished_at for x in hs)
              - min(x.submitted_at for x in hs)))
    per_req = [(len(x.result.tokens) - 1)
               / (x.finished_at - x.marks["first_token"]) for x in hs]
    return e2e, sum(per_req) / len(per_req)


def _engine_stats(engine) -> str:
    """The engine's switches, the chunks it dispatched at each pipeline
    depth and its prefix-cache admissions, as a log phrase."""
    st = engine.get_stats()
    pc = st.get("prefix_cache", {})
    return (f"{_switches(engine)}; chunks by pipeline depth "
            f"{st.get('pipeline', {}).get('depth_hist')}; prefix cache "
            f"hits {pc.get('admission_hits')} misses "
            f"{pc.get('admission_misses')}, {pc.get('pages')} pages; "
            f"steps with no live row {engine.executor.idle_steps}")


def _switches(engine) -> str:
    """The engine's async pipeline and prefix cache, as a log phrase."""
    pipe = (f"async pipeline depth {engine._pipe_depth}"
            if engine._pipe_cfg is not None else
            "async pipeline off (depth 2, completions inline)")
    return (f"{pipe}, prefix cache "
            f"{'on' if engine._prefix_cache is not None else 'off'}")


def _check_defaults(engine, tag: str) -> None:
    """A serve engine runs the JAX package's defaults: the async pipeline
    at depth 2 with one completion thread, and the prefix cache on."""
    if (engine._pipe_cfg is None or engine._pipe_depth != 2
            or engine._completion_workers != 1
            or engine._prefix_cache is None):
        raise AssertionError(f"[{tag}] engine is not on the defaults: "
                             f"{_switches(engine)}")


#: The shared-prefix traffic: a 512-token system prompt and 40-token
#: tails that differ in their first character.
SYSTEM_PROMPT = ("You are the support assistant of a message queue that "
                 "serves LLM requests on four priority tiers. " * 8)[:512]
TAILS = [f"{c} tail: which tier suits a nightly batch job?"[:40]
         for c in "ABCD"]


def _shared_prefix(engine, tag: str, want_cached: bool = True) -> dict:
    """Four requests that share SYSTEM_PROMPT, each sent after the previous
    one completes: with the prefix cache on, requests 2-4 must report 512
    cached tokens (the first, none); their TTFTs print beside the
    first's. The system prompt starts with '#' and the tag, which no
    other traffic of the engine starts with, so none of it was cached."""
    from llmq_tpu_torch.engine.engine import GenRequest

    system = (f"#{tag}# " + SYSTEM_PROMPT)[:512]
    ttfts, cached = [], []
    for i, tail in enumerate(TAILS):
        assert len(system) == 512 and len(tail) == 40
        h = engine.submit(GenRequest(id=f"{tag}-shared-{i}-{time.time()}",
                                     prompt=system + tail, max_new_tokens=8))
        assert h.wait(300), "shared-prefix request timed out"
        if h.result.finish_reason not in ("eos", "length"):
            raise AssertionError(f"[{tag}] shared-prefix request failed: "
                                 f"{h.result}")
        ttfts.append((h.marks["first_token"] - h.submitted_at) * 1e3)
        cached.append(h.result.cached_tokens)
    want = [0, 512, 512, 512] if want_cached else [0, 0, 0, 0]
    if cached != want:
        raise AssertionError(f"[{tag}] shared-prefix cached_tokens {cached}, "
                             f"expected {want}")
    log(f"[{tag}] shared 512-token system prompt, 552-token requests one "
        f"after another: cached_tokens {cached}; TTFT "
        f"{', '.join(f'{t:.1f}' for t in ttfts)} ms; {_switches(engine)} "
        f"({CARD})")
    return {"cached_tokens": cached, "ttft_ms": ttfts}


def _rates_switches_off(engine, tag: str, what: str) -> dict:
    """TTFT and decode rate at B=1, 8 concurrent tok/s and the
    shared-prefix traffic once more with the async pipeline and the
    prefix cache off (the JAX package's off-switches), in the same call:
    the serving engine's thread is stopped, a second engine drives the
    same executor over the same allocator (the first engine's pinned and
    cached pages stay allocated), then the first engine resumes."""
    from llmq_tpu_torch.engine.engine import InferenceEngine

    engine.stop()
    off = InferenceEngine(engine.executor, engine.tokenizer,
                          name=f"{engine.name}-off",
                          max_decode_steps=engine.max_decode_steps,
                          tier_max_wait=engine.tier_max_wait,
                          mixed_batch=engine._mixed_cfg)
    off.allocator = engine.allocator
    off.start()
    try:
        ttft, rate1, _n = _b1_rates(off, f"{tag} switches off")
        b8, _per_req = _b8_rate(off, f"{tag}-off")
        shared = _shared_prefix(off, f"{tag} switches off",
                                want_cached=False)
    finally:
        off.stop()
        engine.start()
    log(f"[{tag}] llama3-8b {what}, {_switches(off)}: TTFT "
        f"{ttft * 1e3:.1f} ms (median; B=1); decode {rate1:.1f} tok/s "
        f"(B=1); 8 concurrent {b8:.1f} tok/s end to end ({CARD})")
    return {"ttft_ms_b1": ttft * 1e3, "decode_tok_s_b1": rate1,
            "tok_s_b8_e2e": b8, "shared_prefix": shared}


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
    _check_defaults(engine, "serve-ragged")
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
            f"launches {launches}; {_engine_stats(engine)} ({CARD})")
        ttft, rate1, n_prompt = _b1_rates(engine, "serve-ragged")
        state["serve"].update({"ragged_ttft_ms_b1": ttft * 1e3,
                               "ragged_decode_tok_s_b1": rate1,
                               "ragged_mixed_steps": engine.mixed_steps,
                               "ragged_shared_prefix": _shared_prefix(
                                   engine, "serve-ragged")})
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
    _check_defaults(engine, tag)
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
            f"launches {out[pre + 'launches']}; {_engine_stats(engine)} "
            f"({CARD})")
        rates = _rates(engine, tag, "int8 weights + int8 KV"
                       + (", ragged" if ragged else ""))
        out.update({pre + k: v for k, v in rates.items()})
        if not ragged:
            _decode_breakdown(engine, out, tag)
            _q8_prefill_share(engine, out, tag)
        _wave_timing(engine, out, tag)
        if not ragged:
            # serve-plane's pool pressure over the int8 pool and its
            # scale pools.
            kernels.reset_launches()
            state.setdefault("serve_plane", {})["int8_pressure"] = \
                _pool_pressure(engine, base, "serve-plane-int8")
            launches = dict(kernels.LAUNCHES)
            wrong = {n: launches[n] for n in BF16_ONLY if launches[n]}
            if launches["fused_decode_q8"] <= 0 or wrong:
                raise AssertionError(f"serve-plane-int8: launches {launches}")
            log(f"[serve-plane-int8] launches "
                f"{ {k: v for k, v in launches.items() if v} }")
    finally:
        app.stop()
        ex.release_graphs()
    return ex.model.params


# -- serve-plane: the serving process around the default engine ----------------

#: Retry backoff of the serve-plane phase (seconds; the default 1 s
#: doubles per retry, which would only make the phase sleep).
PLANE_BACKOFF_S = 0.05
#: The pressure traffic: six LOW prompts of PRESSURE_PROMPT tokens
#: decoding PRESSURE_LOW_NEW each, then, once all six decode, two
#: REALTIME ones of the same length decoding PRESSURE_RT_NEW. The six
#: grow to 6 x 83 of the 511 pages, so each REALTIME admission (77
#: pages) has to shed past the radix tree's leaves and the idle pins
#: into a LOW runner that has generated tokens. 128 new tokens keep the
#: LOWs decoding through the two 32-step chunks that can be in flight
#: when the REALTIMEs arrive (preemption waits for them to drain).
PRESSURE_PROMPT = 1200
PRESSURE_LOW_NEW = 128
PRESSURE_RT_NEW = 32
PRESSURE_FILLER = ("The queue serves four priority tiers, and every request "
                   "carries its own deadline and budget. ")
#: The anchored pressure run (``_pool_pressure(anchor=True)``, read by
#: the observability gates alone): a short REALTIME request admitted
#: with the six LOWs keeps decoding through the traffic
#: (PRESSURE_ANCHOR_NEW tokens). With a decode row live, a victim's
#: rebuild re-prefills in mixed slices, whose device time the usage plane
#: charges as "preempt" waste (a re-prefill by prefill programs alone is
#: not charged, as in the JAX package).
PRESSURE_ANCHOR_NEW = 800


#: The resource scheduler's heartbeat timeout in the serve-plane phase
#: (seconds): the card's resource must stay online past twice it.
PLANE_HEARTBEAT_S = 3.0
#: While a 1 s on-demand profile is taken, the engine may go without
#: finishing a chunk no longer than the profiler's longest hold (its
#: stop holds the interpreter 7.8-10.1 s over the ~186k kernels of that
#: second, as fast as the host is) plus this (seconds; a chunk is
#: ~150 ms). Writing the trace must not stall it: Kineto's own export
#: held the interpreter ~4 s more.
PROFILE_STALL_S = 1.0


def _plane_cfg():
    """The serve config with the phase's settings: retry backoff
    PLANE_BACKOFF_S, a 5 ms worker poll, a 50 ms supervisor check, and a
    PLANE_HEARTBEAT_S heartbeat timeout checked every 0.5 s."""
    cfg = _serve_cfg()
    cfg.queue.retry.initial_backoff = PLANE_BACKOFF_S
    cfg.queue.worker.process_interval = 0.005
    cfg.executor.supervisor.check_interval = 0.05
    cfg.resource_scheduler.heartbeat_timeout = PLANE_HEARTBEAT_S
    cfg.resource_scheduler.monitor_interval = 0.5
    return cfg


def _plane_config_file():
    """``configs/config.yaml`` with the phase's overrides (the settings of
    ``_plane_cfg``, the port's ``torch`` backend for the JAX package's
    ``echo``), written into the port's gitignored build directory; the
    config ``load_config`` reads from it, which must be
    ``_plane_cfg()``."""
    import dataclasses

    import yaml

    from llmq_tpu_torch.core.config import load_config
    from llmq_tpu_torch.ops.kernels import BUILD_DIR

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", "config.yaml")) as f:
        data = yaml.safe_load(f)
    want = _plane_cfg()
    over = {"device": want.device,
            "model": {"name": want.model.name,
                      "max_seq_len": want.model.max_seq_len},
            "executor": {"backend": "torch",
                         "max_decode_steps": want.executor.max_decode_steps,
                         "supervisor": {"check_interval":
                                        want.executor.supervisor.check_interval}},
            "queue": {"retry": {"initial_backoff":
                                want.queue.retry.initial_backoff},
                      "worker": {"process_interval":
                                 want.queue.worker.process_interval}},
            "resource_scheduler": {
                "heartbeat_timeout": want.resource_scheduler.heartbeat_timeout,
                "monitor_interval": want.resource_scheduler.monitor_interval}}

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                merge(dst.setdefault(k, {}), v)
            else:
                dst[k] = v

    merge(data, over)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = str(BUILD_DIR / "serve_plane_config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    cfg = load_config(path)
    if dataclasses.asdict(cfg) != dataclasses.asdict(want):
        raise AssertionError("the config file did not load to the phase's "
                             "settings")
    return cfg, path


def _scrape(base):
    """``GET /metrics`` parsed: {(name, sorted label pairs): value}, and
    the ms the request took."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(f"{base}/metrics", timeout=60) as resp:
        ctype = resp.headers["Content-Type"]
        text = resp.read().decode()
    ms = (time.perf_counter() - t0) * 1e3
    if not ctype.startswith("text/plain"):
        raise AssertionError(f"/metrics content type {ctype}")
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.fullmatch(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)",
                         line)
        if m is None:
            raise AssertionError(f"/metrics line not parsed: {line!r}")
        labels = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                         m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out, ms


def _msum(samples, name, **match) -> float:
    """The sum of a family's samples whose labels include ``match``."""
    return sum(v for (n, labels), v in samples.items() if n == name
               and all(dict(labels).get(k) == str(w)
                       for k, w in match.items()))


def _http_status(method, url, body=None):
    """(status, payload, Retry-After header), error statuses included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return (resp.status, json.loads(resp.read()),
                    resp.headers.get("Retry-After"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _until(pred, timeout: float, what: str, poll: float = 0.001) -> None:
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(poll)


class _PlaneTracker:
    """The smoke's instrumentation of an engine (removed by ``close``):
    its handles by request id, its preemptions (``(id, release_pages)``,
    as the JAX package's tests record them) with the tokens each
    page-releasing victim had generated, and each rebuild's re-prefilled
    tokens with the seconds from its admission to its completed
    prefill."""

    NAMES = ("submit", "_preempt", "_start_sequence", "_complete_prefill")

    def __init__(self, engine) -> None:
        self.engine = engine
        self.handles = {}
        self.victims = []
        self.generated_at_release = []      # (id, tokens generated)
        self.rebuilds = []          # [id, tokens, t_admit, t_done]
        orig = {n: getattr(engine, n) for n in self.NAMES}

        def submit(req, **kw):
            h = orig["submit"](req, **kw)
            self.handles[req.id] = h
            return h

        def preempt(victim, release_pages):
            self.victims.append((victim.req.id, release_pages))
            if release_pages:
                self.generated_at_release.append(
                    (victim.req.id, len(victim.generated)))
            return orig["_preempt"](victim, release_pages)

        def start_sequence(seq, slot):
            was = seq.rebuild
            ok = orig["_start_sequence"](seq, slot)
            if was and ok and seq.todo_rebuild:
                self.rebuilds.append([seq.req.id, len(seq.todo_ids),
                                      time.perf_counter(), None])
            return ok

        def complete_prefill(seq, first):
            rebuilt = seq.todo_rebuild
            orig["_complete_prefill"](seq, first)
            if rebuilt:
                for r in reversed(self.rebuilds):
                    if r[0] == seq.req.id and r[3] is None:
                        r[3] = time.perf_counter()
                        break

        for n, fn in zip(self.NAMES, (submit, preempt, start_sequence,
                                      complete_prefill)):
            setattr(engine, n, fn)

    def close(self) -> None:
        for n in self.NAMES:
            self.engine.__dict__.pop(n, None)


def _idle(engine) -> bool:
    st = engine.get_stats()
    return st["active"] == 0 and st["pending"] == 0 and not engine._inflight


def _pool_accounting(engine):
    """(pages in use, pages of the radix tree and the pins together)."""
    tree = set()
    stack = list(engine._prefix_cache._root.children.values())
    while stack:
        node = stack.pop()
        tree.add(node.page)
        stack.extend(node.children.values())
    pins = {p for ps in engine.allocator._pins.values() for p in ps}
    return engine.allocator.used(), len(tree | pins), len(tree), len(pins)


def _pool_pressure(engine, base, tag: str, anchor: bool = False) -> dict:
    """Six LOW requests of PRESSURE_PROMPT tokens, arriving together;
    once all six have emitted a first token (none finished), two REALTIME ones of the same
    length. Every request must complete its tokens (none finishes
    "error"), a preemption must release the pages of a LOW that had
    generated tokens (its rebuild resumes from its newest token), the
    REALTIME requests must finish before the LOWs they stripped, and
    once idle the pool must hold only the radix tree's pages and the
    pins. Prints the REALTIME TTFT, each rebuild's tokens and ms, and
    (no gate: bf16 re-prefill logits are not decode logits) how many
    leading tokens of the decoded victim equal the same prompt served
    alone. ``anchor`` adds a short REALTIME row, admitted with the six,
    that keeps decoding through the traffic: the rebuilds then
    re-prefill in mixed slices (their device time is "preempt" waste)
    instead of by prefill programs."""
    from llmq_tpu_torch.core.types import Priority
    from llmq_tpu_torch.engine.engine import GenRequest

    _until(lambda: _idle(engine), 120, f"{tag}: idle engine before")
    tr = _PlaneTracker(engine)
    try:
        t0 = time.perf_counter()
        prompts = {}
        lows = []
        # The six arrive together: the engine loop holds its next step
        # until all six are submitted, so they are admitted as one
        # prefill wave and decode side by side (posted one by one, the
        # first would decode its tokens while the others still prefill
        # in 128-token mixed slices).
        gate = threading.Event()
        real_step = engine.step

        def held_step():
            gate.wait(60)
            return real_step()

        engine.step = held_step
        try:
            for i in range(6):
                text = (f"{i:02d} {tag} low job: "
                        + PRESSURE_FILLER * 20)[:PRESSURE_PROMPT]
                mid = _post(base, {"content": text, "priority": "low",
                                   "metadata": {
                                       "max_new_tokens": PRESSURE_LOW_NEW}})
                prompts[mid] = text
                lows.append(mid)
            row = engine.submit(GenRequest(
                id=f"{tag}-anchor-{time.time()}", prompt=f"{tag} anchor row",
                priority=Priority.REALTIME,
                max_new_tokens=PRESSURE_ANCHOR_NEW)) if anchor else None
            _until(lambda: all(m in tr.handles for m in lows), 30,
                   f"{tag}: six LOW requests submitted")
        finally:
            engine.__dict__.pop("step", None)
            gate.set()
        _until(lambda: all(m in tr.handles and "first_token" in
                           tr.handles[m].marks for m in lows), 120,
               f"{tag}: six LOW requests decoding")
        early = [m for m in lows if tr.handles[m].result is not None]
        if early:
            raise AssertionError(f"{tag}: LOW requests {early} finished "
                                 f"before the REALTIME ones were sent")
        rts = []
        for i in range(2):
            text = (f"{i:02d} {tag} realtime job: "
                    + PRESSURE_FILLER * 20)[:PRESSURE_PROMPT]
            rts.append(_post(base, {"content": text,
                                    "priority": "realtime",
                                    "metadata": {
                                        "max_new_tokens": PRESSURE_RT_NEW}}))
        done = {m: _poll(base, m) for m in lows + rts}
        wall = time.perf_counter() - t0
        if row is not None and row.result is not None:
            raise AssertionError(f"{tag}: the anchor row finished before "
                                 f"the traffic did: {row.result}")
        _until(lambda: _idle(engine), 120, f"{tag}: idle engine after")
        if row is not None and (not row.wait(60) or row.result.finish_reason
                                not in ("eos", "length")):
            raise AssertionError(f"{tag}: anchor row {row.result}")
        for m, r in done.items():
            u = r["metadata"].get("usage", {})
            want = PRESSURE_LOW_NEW if m in lows else PRESSURE_RT_NEW
            if r["status"] != "completed" or u.get("finish_reason") not in \
                    ("eos", "length") or (u["completion_tokens"] != want
                                          and u["finish_reason"] != "eos"):
                raise AssertionError(f"{tag}: request under pressure did "
                                     f"not complete its tokens: {r}")
        released = [v for v, rel in tr.victims if rel]
        if not released:
            raise AssertionError(f"{tag}: no preemption released pages: "
                                 f"{tr.victims}")
        decoded = [(v, n) for v, n in tr.generated_at_release
                   if v in lows and n > 0]
        if not decoded:
            raise AssertionError(f"{tag}: no released LOW had generated "
                                 f"tokens: {tr.generated_at_release}")
        stripped = [v for v in dict.fromkeys(released) if v in lows]
        for rt in rts:
            for v in stripped:
                if tr.handles[rt].finished_at >= tr.handles[v].finished_at:
                    raise AssertionError(f"{tag}: REALTIME {rt} finished "
                                         f"after the LOW {v} it preempted")
        used, accounted, tree, pins = _pool_accounting(engine)
        if used != accounted:
            raise AssertionError(f"{tag}: {used} pages in use but the radix "
                                 f"tree and the pins hold {accounted}")
        ttft = [(tr.handles[m].marks["first_token"]
                 - tr.handles[m].submitted_at) * 1e3 for m in rts]
        rebuilds = [(v, n, (t1 - t0_) * 1e3) for v, n, t0_, t1 in
                    tr.rebuilds if t1 is not None]
        victim, victim_generated = decoded[0]
        victim_rebuilds = [(n, ms) for v, n, ms in rebuilds if v == victim]
        if not victim_rebuilds:
            raise AssertionError(f"{tag}: the decoded victim {victim} was "
                                 f"not rebuilt: {tr.rebuilds}")
    finally:
        tr.close()
    alone = engine.submit(GenRequest(id=f"{tag}-alone-{time.time()}",
                                     prompt=prompts[victim],
                                     priority=Priority.LOW,
                                     max_new_tokens=PRESSURE_LOW_NEW))
    if not alone.wait(300):
        raise AssertionError(f"{tag}: the alone run timed out")
    served = tr.handles[victim].result.tokens
    lead = next((i for i, (a, b) in enumerate(zip(served,
                                                   alone.result.tokens))
                 if a != b), min(len(served), len(alone.result.tokens)))
    log(f"[{tag}] 6 LOW ({PRESSURE_LOW_NEW} new) + 2 REALTIME "
        f"({PRESSURE_RT_NEW} new) requests of {PRESSURE_PROMPT} tokens, "
        f"all completed in {wall:.2f} s; preemptions {tr.victims}; tokens "
        f"generated at each release {tr.generated_at_release}; REALTIME "
        f"TTFT under pressure {', '.join(f'{t:.1f}' for t in ttft)} ms; "
        f"rebuilds (id, re-prefilled tokens, admission to prefill done "
        f"ms) {rebuilds}; idle pool {used} pages = radix {tree} | pins "
        f"{pins} ({CARD})")
    log(f"[{tag}] decoded victim {victim}: released after "
        f"{victim_generated} generated tokens, rebuilt by re-prefilling "
        f"{', '.join(f'{n} tokens in {ms:.1f} ms' for n, ms in victim_rebuilds)}"
        f", resumed from its newest token; {lead} of {len(served)} leading "
        f"tokens equal to the same prompt served alone (not gated) ({CARD})")
    waste = {m: (r["metadata"]["usage"].get("waste_seconds"),
                 r["metadata"]["usage"].get("waste_reason"))
             for m, r in done.items()}
    return {"wall_s": wall, "preemptions": tr.victims,
            "released": len(released), "realtime_ttft_ms": ttft,
            "waste": waste,
            "rebuilds": [{"tokens": n, "ms": ms} for _, n, ms in rebuilds],
            "victim_generated": victim_generated,
            "idle_pages": used, "radix_pages": tree, "pin_pages": pins,
            "leading_equal_alone": lead}


def _crash_recovery(app, engine, base) -> dict:
    """Four REST requests decoding, then the engine loop dies once (its
    next ``step`` raises a BaseException). The supervisor must restart
    it once; each message must fail over, retry through the delayed
    queue and complete exactly once; the dead-letter queue stays as it
    was; the restarted loop replays the captured graphs (replays grow)
    and captures none."""
    ex = engine.executor
    captures = []
    orig_capture = ex._capture
    ex._capture = lambda *a, **k: (captures.append(a), orig_capture(*a, **k))[1]
    graphs = {**{("step", k): id(g) for k, g in ex.step_graphs.items()},
              **{k: id(g) for k, g in ex.program_graphs.items()}}
    sup = app.supervisor
    restarts0 = sup.restarts
    dlq = app.factory.get_dead_letter_queue("standard")
    dlq0 = dlq.size()

    def worker_sum(key):
        return sum(w.stats.to_dict()[key] for w in app.workers)

    ok0, retried0 = worker_sum("succeeded"), worker_sum("retried")
    try:
        _until(lambda: _idle(engine), 120, "idle engine before the crash")
        # 128 tokens each: the four decode together long enough for the
        # crash to land while all of them are in flight.
        mids = [_post(base, {"content": f"{i} crash check: describe a "
                                        f"queue in a few words.",
                             "priority": "normal",
                             "metadata": {"max_new_tokens": 128}})
                for i in range(4)]
        _until(lambda: _decoding_rows(engine) >= 4, 120,
               "four requests decoding")
        replays0 = ex.graph_replays

        def crashing():
            engine.__dict__.pop("step", None)
            raise _LoopCrash("injected by chip_smoke")

        t_crash = time.perf_counter()
        engine.step = crashing
        done = [_poll(base, m) for m in mids]
        recover_s = time.perf_counter() - t_crash
        _until(lambda: worker_sum("succeeded") - ok0 >= 4, 60,
               "the workers' completions")
        time.sleep(0.2)        # a duplicate completion would land here
    finally:
        engine.__dict__.pop("step", None)
        ex.__dict__.pop("_capture", None)
    bad = [m for m in done if m["status"] != "completed"
           or m["retry_count"] < 1]
    if sup.restarts != restarts0 + 1 or bad:
        raise AssertionError(f"crash: restarts {sup.restarts - restarts0}, "
                             f"messages {bad or done}")
    if worker_sum("succeeded") - ok0 != 4 or dlq.size() != dlq0:
        raise AssertionError(f"crash: {worker_sum('succeeded') - ok0} "
                             f"completions for 4 messages, dead letters "
                             f"{dlq0} -> {dlq.size()}")
    now = {**{("step", k): id(g) for k, g in ex.step_graphs.items()},
           **{k: id(g) for k, g in ex.program_graphs.items()}}
    if captures or now != graphs or ex.graph_replays <= replays0:
        raise AssertionError(f"crash: {len(captures)} captures after the "
                             f"restart, graphs {len(graphs)} -> {len(now)}, "
                             f"replays {replays0} -> {ex.graph_replays}")
    log(f"[serve-plane] engine loop killed with 4 requests decoding: "
        f"supervisor restarts {sup.restarts - restarts0}, recovered "
        f"{sup.recovered_total}; all 4 completed once after "
        f"{[m['retry_count'] for m in done]} retries, crash to all "
        f"completed {recover_s:.2f} s; graph replays {replays0} -> "
        f"{ex.graph_replays}, captures 0 ({len(now)} graphs kept); retries "
        f"{worker_sum('retried') - retried0}; dead letters {dlq.size()} "
        f"({CARD})")
    return {"crash_to_completed_s": recover_s,
            "restarts": sup.restarts - restarts0,
            "retry_counts": [m["retry_count"] for m in done],
            "graph_replays_after": ex.graph_replays - replays0}


class _LoopCrash(BaseException):
    """Kills the engine loop (an Exception from a step is only logged)."""


#: Prompt prefix of the serve-plane message the engine refuses at
#: admission on every attempt.
ENGINE_REFUSES = "dead-letter check: the engine refuses this prompt"


def _dead_letters(app, engine, base) -> dict:
    """Two messages that fail on every attempt go to the dead-letter
    queue after their retries: one whose ``max_new_tokens`` is not a
    number (the process function raises before the engine sees it), and
    one the engine finishes "error" at admission. At llama3-8b's
    geometry no REST request fails the engine by itself (a prompt over
    ``max_seq_len`` slides its window and completes, here as in the JAX
    package), so the smoke makes ``_start_sequence`` take its own
    admission-error exit for prompts starting with ENGINE_REFUSES. The
    admin route puts the engine-refused one back on its queue, where it
    fails into the dead-letter queue again."""
    dlq = app.factory.get_dead_letter_queue("standard")
    n0 = dlq.size()
    orig = engine._start_sequence
    refused = []

    def start_sequence(seq, slot):
        if not seq.req.prompt.startswith(ENGINE_REFUSES):
            return orig(seq, slot)
        refused.append(seq.req.id)
        engine._finish(seq, "error", "refused at admission by chip_smoke")
        return True

    engine._start_sequence = start_sequence
    try:
        t0 = time.perf_counter()
        bad_md = _post(base, {"content": "this message fails on every "
                                         "attempt",
                              "priority": "low",
                              "metadata": {"max_new_tokens": "many"}})
        by_engine = _post(base, {"content": f"{ENGINE_REFUSES}, every time",
                                 "priority": "low",
                                 "metadata": {"max_new_tokens": 8}})
        msgs = {m: _poll(base, m) for m in (bad_md, by_engine)}
        _until(lambda: dlq.size() == n0 + 2, 30, "the two dead letters")
        dead_s = time.perf_counter() - t0
        for m in msgs.values():
            if m["status"] != "failed" or \
                    m["retry_count"] != m["max_retries"]:
                raise AssertionError(f"dead letter: {m}")
        attempts = len(refused)
        if attempts != msgs[by_engine]["retry_count"]:
            raise AssertionError(f"dead letter: the engine refused "
                                 f"{attempts} attempts of {by_engine}: "
                                 f"{msgs[by_engine]}")
        status, r, _ = _http_status(
            "POST", f"{base}/api/v1/admin/dead-letter/requeue/{by_engine}")
        if status != 200 or r != {"status": "requeued",
                                  "message_id": by_engine}:
            raise AssertionError(f"dead-letter requeue: {status} {r}")
        _until(lambda: dlq.size() == n0 + 2 and len(refused) > attempts,
               30, "the requeued message's second dead letter")
    finally:
        engine.__dict__.pop("_start_sequence", None)
    log(f"[serve-plane] two messages failing every attempt reached the "
        f"dead-letter queue after {msgs[bad_md]['retry_count']} and "
        f"{msgs[by_engine]['retry_count']} retries in {dead_s:.2f} s "
        f"(backoff {PLANE_BACKOFF_S} s doubling): one in the process "
        f"function, one finished \"error\" by the engine on each of its "
        f"{attempts} attempts; the admin requeue put the engine-refused "
        f"one back and it failed into the queue again")
    return {"retries": msgs[by_engine]["retry_count"],
            "engine_attempts": attempts, "to_dead_letter_s": dead_s}


def _conversation_plane(app, engine, base) -> dict:
    """A conversation over REST: three turns (turns 2 and 3 cached), the
    conversation holding its messages with their responses, a state
    update that keeps the KV pin, then the service's eviction
    (``delete``), which unpins it and returns its pages."""
    status, c = _http("POST", f"{base}/api/v1/conversations",
                      {"user_id": "smoke-user"})
    assert status == 201, (status, c)
    cid = c["conversation_id"]
    turns = []
    for text in ("Tell me about paged attention, briefly.",
                 " Now the same for the queue tiers.", " And a summary."):
        status, r = _http("POST", f"{base}/api/v1/conversations/{cid}/"
                                  f"messages",
                          {"content": text, "priority": "high",
                           "timeout": MESSAGE_TIMEOUT_S,
                           "metadata": {"max_new_tokens": 16}})
        assert status == 202, (status, r)
        turns.append(_poll(base, r["message_id"]))
    _check_completed(turns, "conversation")
    cached = [t["metadata"]["usage"]["cached_tokens"] for t in turns]
    if cached[1] <= 0 or cached[2] <= 0:
        raise AssertionError(f"conversation turns cached {cached}")
    _, conv = _http("GET", f"{base}/api/v1/conversations/{cid}")
    if conv["message_count"] != 3 or [m["response"] for m in
                                      conv["messages"]] != \
            [t["response"] for t in turns]:
        raise AssertionError(f"conversation holds {conv}")
    status, r = _http("PUT", f"{base}/api/v1/conversations/{cid}/state",
                      {"state": "completed"})
    _, conv = _http("GET", f"{base}/api/v1/conversations/{cid}")
    if status != 200 or conv["state"] != "completed" or \
            cid not in engine.cached_conversations():
        raise AssertionError(f"state update: {status} {r} {conv['state']}")
    _until(lambda: _idle(engine), 60, "idle engine")
    used0 = engine.allocator.used()
    pinned = len(engine.allocator._pins.get(cid, []))
    if not app.state_manager.delete(cid):
        raise AssertionError("the state manager did not know the "
                             "conversation")
    used1 = engine.allocator.used()
    if cid in engine.cached_conversations() or used1 >= used0:
        raise AssertionError(f"eviction kept the KV: pages {used0} -> "
                             f"{used1}")
    log(f"[serve-plane] conversation of 3 turns over REST: cached_tokens "
        f"{cached}; state 'completed' kept the pin; eviction unpinned "
        f"{pinned} pages, pool {used0} -> {used1} pages in use")
    return {"cached_tokens": cached, "pinned_pages": pinned,
            "pages_freed": used0 - used1}


def _priority_inference(base) -> dict:
    """"urgent: ..." with no priority is served at HIGH."""
    status, r = _http("POST", f"{base}/api/v1/messages", {
        "content": "urgent: summarise the queue's state in one line.",
        "timeout": MESSAGE_TIMEOUT_S, "metadata": {"max_new_tokens": 8}})
    m = _poll(base, r["message_id"])
    if status != 202 or r["priority"] != 2 or m["priority"] != 2 or \
            m["status"] != "completed":
        raise AssertionError(f"priority inference: {r} {m}")
    log("[serve-plane] 'urgent: ...' without a priority was served at "
        "HIGH (2)")
    return {"priority": m["priority"]}


def _sse_check(engine, base) -> dict:
    """A ``"stream": true`` request yields ``data:`` events and one
    ``event: done`` with ``first_token_ms``; its text is the same
    prompt's queued greedy response, and its tokens the queued run's.
    The byte tokenizer renders only ids below 259, which random weights
    over 128256 ids practically never sample (12 prompts x 256 tokens
    gave none), so during this check the engine decodes every id as a
    letter (``_LetterDecode``; prompts encode as before). The prompt is
    shorter than a page: neither run reuses the other's KV."""
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    class _LetterDecode(ByteTokenizer):
        def decode(self, ids) -> str:
            return "".join(chr(97 + i % 26) for i in ids if i >= 3)

    prompt = "SSE check, go."
    tr = _PlaneTracker(engine)
    tokenizer, engine.tokenizer = engine.tokenizer, _LetterDecode()
    try:
        queued = _poll(base, _post(base, {
            "content": prompt, "priority": "high",
            "metadata": {"max_new_tokens": 16}}))
        n0 = len(tr.handles)
        req = urllib.request.Request(
            f"{base}/api/v1/messages", method="POST",
            data=json.dumps({"content": prompt, "priority": "high",
                             "stream": True,
                             "metadata": {"max_new_tokens": 16}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            ctype = resp.headers["Content-Type"]
            body = resp.read().decode()
        streamed_id, streamed_handle = list(tr.handles.items())[n0]
        streamed = streamed_handle.result.tokens
        queued_tokens = tr.handles[queued["id"]].result.tokens
    finally:
        engine.tokenizer = tokenizer
        tr.close()
    events = [e for e in body.split("\n\n") if e]
    datas = events[1:-1]
    done = json.loads(events[-1].split("data: ", 1)[1])
    text = "".join(json.loads(e[len("data: "):])["token"] for e in datas)
    if (not ctype.startswith("text/event-stream")
            or not events[0].startswith("event: start")
            or not events[-1].startswith("event: done")
            or not all(e.startswith("data: ") for e in datas) or not datas
            or done.get("first_token_ms") is None
            or text != queued["response"] or streamed != queued_tokens):
        raise AssertionError(f"SSE: {body!r} vs queued "
                             f"{queued['response']!r}")
    log(f"[serve-plane] SSE: {len(datas)} data events, done with "
        f"first_token_ms {done['first_token_ms']}; text equal to the queued "
        f"greedy response ({len(text)} chars, every id rendered as a "
        f"letter), tokens equal ({len(streamed)}) ({CARD})")
    return {"data_events": len(datas),
            "first_token_ms": done["first_token_ms"],
            "streamed_id": streamed_id}


def _overload(app, engine, base) -> dict:
    """With the workers stopped and the queue-depth limit at 1, the
    second message gets 429; with the engine stopped, 503; both carry
    Retry-After."""
    for w in app.workers:
        w.stop()
    app.api.shedder.queue_depth_limit = 1
    first = _http_status("POST", f"{base}/api/v1/messages",
                         {"content": "fills the queue"})
    backlog = _http_status("POST", f"{base}/api/v1/messages",
                           {"content": "one too many"})
    app.supervisor.stop()
    engine.stop()
    down = _http_status("POST", f"{base}/api/v1/messages",
                        {"content": "engine is down"})
    _, health = _http("GET", f"{base}/health")
    if first[0] != 202 or backlog[0] != 429 or not backlog[2] or \
            down[0] != 503 or not down[2] or health["engine"] != "stopped":
        raise AssertionError(f"overload: {first} {backlog} {down} {health}")
    log(f"[serve-plane] shedding: queue-depth limit 1 → {backlog[0]} "
        f"(Retry-After {backlog[2]}), engine stopped → {down[0]} "
        f"(Retry-After {down[2]})")
    return {"backlog": backlog[0], "engine_down": down[0]}


def _topology_check(app, base) -> dict:
    """``GET /api/v1/resources`` lists every card by the name
    ``torch.cuda.get_device_name`` gives and its memory in GB (2**30
    bytes) from ``total_memory``; the engine's allocation holds one
    chip."""
    import torch

    from llmq_tpu_torch.scheduling.resource_scheduler import ResourceType

    status, r = _http("GET", f"{base}/api/v1/resources")
    name = torch.cuda.get_device_name(0)
    gb = torch.cuda.get_device_properties(0).total_memory / 2**30
    cards = [x for x in r["resources"] if name in x["capabilities"]]
    alloc = app.engine_allocation
    held = [x for x in cards if x["id"] == alloc.resource_id]
    if (status != 200 or len(cards) != torch.cuda.device_count()
            or any("cuda" not in x["capabilities"] for x in cards)
            or any(abs(x["capacity"]["hbm_gb"] - gb) > 1e-6 for x in cards)
            or alloc.request.amounts != {ResourceType.CHIP: 1.0}
            or len(held) != 1 or held[0]["used"] != {"chip": 1.0}):
        raise AssertionError(f"topology: {status} {r} {alloc}")
    log(f"[serve-plane] /api/v1/resources: {len(cards)} card(s) "
        f"{name!r}, {gb:.2f} GB each; the engine holds 1 chip of "
        f"{alloc.resource_id} (pinned)")
    return {"resource": alloc.resource_id, "hbm_gb": gb, "kind": name,
            "registered_at": time.time()}


def _heartbeat_check(app, topo) -> None:
    """The card's resource is still online after twice the heartbeat
    timeout, and the heartbeat moved."""
    from llmq_tpu_torch.core.config import ResourceSchedulerConfig
    from llmq_tpu_torch.scheduling.resource_scheduler import ResourceStatus

    left = topo["registered_at"] + 2 * PLANE_HEARTBEAT_S + 0.5 - time.time()
    if left > 0:
        time.sleep(left)
    r = app.resource_scheduler.get_resource(topo["resource"])
    if r.status != ResourceStatus.ONLINE or \
            r.last_heartbeat <= topo["registered_at"]:
        raise AssertionError(f"heartbeat: {r.to_dict()}")
    log(f"[serve-plane] resource {r.id} online "
        f"{time.time() - topo['registered_at']:.1f} s after registering "
        f"(heartbeat timeout {PLANE_HEARTBEAT_S} s)")


def _metrics_gates(app, engine, base, before, start, streamed_id,
                   requeued) -> dict:
    """The parsed ``/metrics`` against each counter's owner, as deltas
    over the phase (the families are per process; earlier phases' engines
    share the engine's name): the completed and failed messages by
    priority (what the message store saw, the one engine-refused message
    requeued once more, and the queue's own stats), the supervisor's
    restart, the dead-letter depth, the engine's preemptions and decode
    steps, and its pages in use once idle."""
    from llmq_tpu_torch.core.types import PRIORITY_TIERS

    _until(lambda: _idle(engine), 120, "idle engine before the scrape")
    time.sleep(0.05)          # the idle loop refreshes the pool gauges
    s, scrape_ms = _scrape(base)
    mgr = app.factory.get_queue_manager("standard")
    stats = mgr.get_all_stats()
    msgs = [m for m in app.message_store.list(limit=10**6)
            if m.id != streamed_id]
    bad = []
    for tier in PRIORITY_TIERS:
        for fam, status, stat in (
                ("llm_queue_messages_completed_total", "completed",
                 "completed_count"),
                ("llm_queue_messages_failed_total", "failed",
                 "failed_count")):
            got = (_msum(s, fam, manager="standard", priority=tier)
                   - _msum(before, fam, manager="standard", priority=tier))
            seen = sum(1 for m in msgs if m.status.value == status
                       and m.priority.tier_name == tier)
            if status == "failed" and tier == "low":
                seen += requeued
            if not got == seen == getattr(stats[tier], stat):
                bad.append((fam, tier, got, seen, getattr(stats[tier], stat)))
    name = engine.name
    restarts = (_msum(s, "llm_queue_engine_restarts_total", engine=name)
                - _msum(before, "llm_queue_engine_restarts_total",
                        engine=name))
    dlq = app.factory.get_dead_letter_queue("standard")
    depth = _msum(s, "llm_queue_dead_letter_depth", queue=dlq.name)
    preempt = (_msum(s, "llm_queue_preemptions_total", engine=name)
               - _msum(before, "llm_queue_preemptions_total", engine=name))
    steps = (_msum(s, "llm_queue_decode_steps_total", engine=name)
             - _msum(before, "llm_queue_decode_steps_total", engine=name))
    pages = _msum(s, "llm_queue_kv_pages_in_use", engine=name)
    if (bad or restarts != 1 or depth != dlq.size()
            or preempt != engine.preemptions - start["preemptions"]
            or steps != engine.steps - start["steps"]
            or pages != engine.allocator.used()):
        raise AssertionError(
            f"/metrics: counts {bad}, restarts {restarts}, dead letters "
            f"{depth} vs {dlq.size()}, preemptions {preempt} vs "
            f"{engine.preemptions - start['preemptions']}, steps {steps} vs "
            f"{engine.steps - start['steps']}, pages {pages} vs "
            f"{engine.allocator.used()}")
    done = {t: stats[t].completed_count for t in PRIORITY_TIERS}
    failed = {t: stats[t].failed_count for t in PRIORITY_TIERS}
    log(f"[serve-plane] /metrics ({scrape_ms:.1f} ms, {len(s)} samples) "
        f"equals the owners' counts: completed {done}, failed {failed}, "
        f"restarts {restarts:.0f}, dead letters {depth:.0f}, preemptions "
        f"{preempt:.0f}, decode steps {steps:.0f}, pages in use "
        f"{pages:.0f}")
    return {"completed": done, "failed": failed, "preemptions": preempt,
            "decode_steps": steps, "pages_in_use": pages}


def _learned_prefill(app, pairs) -> dict:
    """The resource scheduler's learned prefill ETA for 1200 tokens is
    positive and is the EWMA of the (tokens, seconds) pairs the engine
    reported to ``on_prefill_observed``."""
    if not pairs:
        raise AssertionError("the engine reported no prefill")
    tps = None
    for tokens, secs in pairs:
        rate = tokens / secs
        tps = rate if tps is None else 0.8 * tps + 0.2 * rate
    want = 1200 / tps * 1e3
    got = app.resource_scheduler.prefill_eta_ms(1200)
    if not got or got <= 0 or abs(got - want) > 1e-9 * want:
        raise AssertionError(f"learned prefill: {got} vs {want}")
    log(f"[serve-plane] learned prefill rate {tps:.1f} tok/s from "
        f"{len(pairs)} prefills: ETA {got:.1f} ms for 1200 tokens "
        f"({CARD})")
    return {"prefill_tok_s": tps, "eta_ms_1200": got,
            "observations": len(pairs)}


def _drain_check(app, engine, base) -> dict:
    """Four 128-token requests decoding, then ``app.drain()``: /health
    reads "draining" while it runs, it returns idle, and each message
    completes once."""
    mids = [_post(base, {"content": f"{i} drain check: describe the "
                                    f"queue in a few words.",
                         "priority": "normal",
                         "metadata": {"max_new_tokens": 128}})
            for i in range(4)]
    _until(lambda: _decoding_rows(engine) >= 4, 120, "four rows decoding")
    ok0 = sum(w.stats.succeeded for w in app.workers)
    result = []
    t = threading.Thread(target=lambda: result.append(app.drain()))
    t0 = time.perf_counter()
    t.start()
    draining = 0
    while t.is_alive():
        _, h = _http("GET", f"{base}/health")
        draining += h["status"] == "draining"
        time.sleep(0.01)
    t.join()
    drain_s = time.perf_counter() - t0
    done = [_poll(base, m) for m in mids]
    once = sum(w.stats.succeeded for w in app.workers) - ok0
    if (result != [True] or not draining or once != 4
            or any(m["status"] != "completed" or m["retry_count"]
                   for m in done)):
        raise AssertionError(f"drain: {result} draining={draining} "
                             f"completions {once} {done}")
    log(f"[serve-plane] drain with 4 requests decoding: idle after "
        f"{drain_s:.2f} s, /health 'draining' on {draining} reads, each "
        f"completed once ({CARD})")
    return {"drain_s": drain_s}


def _metrics_cost(engine, base) -> dict:
    """Printed, not gated: B=1 and 8-concurrent decode tok/s with the
    engine's metrics on and off (turns on, off, off, on), and the ms of a
    scrape while 8 rows decode."""
    from llmq_tpu_torch.engine.engine import GenRequest

    m = engine._m
    rates = {"on": [], "off": []}
    try:
        for turn, on in enumerate((True, False, False, True)):
            engine._m = m if on else None
            key = "on" if on else "off"
            _ttft, r1, _n = _b1_rates(engine, f"serve-plane metrics {key}")
            b8, _ = _b8_rate(engine, f"serve-plane-metrics-{turn}")
            rates[key].append((r1, b8))
    finally:
        engine._m = m
    prompt = "The quick brown fox jumps over the lazy dog. " * 2
    hs = [engine.submit(GenRequest(id=f"scrape-{i}-{time.time()}",
                                   prompt=f"{i}: {prompt}",
                                   max_new_tokens=256)) for i in range(8)]
    _until(lambda: _decoding_rows(engine) >= 8, 120, "eight rows decoding")
    ms = []
    for _ in range(5):
        ms.append(_scrape(base)[1])
    rows = _decoding_rows(engine)
    for h in hs:
        assert h.wait(300), "scrape-load request timed out"
    ms.sort()
    log(f"[serve-plane] /metrics scrape {ms[2]:.2f} ms (median of 5; "
        f"{', '.join(f'{x:.2f}' for x in ms)}) while {rows} rows decode; "
        f"metrics on: B=1 {[round(r, 1) for r, _ in rates['on']]} tok/s, "
        f"8 concurrent {[round(b, 1) for _, b in rates['on']]} tok/s; "
        f"off: B=1 {[round(r, 1) for r, _ in rates['off']]}, 8 concurrent "
        f"{[round(b, 1) for _, b in rates['off']]} ({CARD})")
    return {"scrape_ms_b8": ms[2], "rates_on": rates["on"],
            "rates_off": rates["off"]}


#: The serve phase's boot record (``python -m llmq_tpu_torch serve``
#: names it by its address).
SERVE_BOOT_ID = "serve:chip-smoke"
#: The kernels of the bf16 default engine's path, as the card names them.
PATH_KERNELS = {"fused_decode": "fused_decode_split_kernel",
                "kv_prefill_write": "kv_prefill_write_kernel",
                "prefill_attention": "prefill_attention_kernel"}
#: The usage fields of a finished request (the JAX package's ten).
USAGE_FIELDS = {"prompt_tokens", "cached_tokens", "completion_tokens",
                "finish_reason", "tenant", "device_seconds", "waste_seconds",
                "waste_reason", "kv_page_seconds",
                "saved_prefill_device_seconds"}
#: Stages every served request's trace holds (the queue path adds
#: ``scheduled``, the SSE path ``dispatched``: a queued message goes from
#: the worker straight to the engine, as in the JAX package's serve).
ENGINE_STAGES = ("enqueued", "admitted", "prefill_start", "prefill_done",
                 "first_token", "decode_done", "completed")


def _obs_mix(engine, base) -> list:
    """Four priorities, a two-turn conversation and one SSE stream over
    REST; returns [(id, kind, usage)] once all completed."""
    out = []
    for prio in ("realtime", "high", "normal", "low"):
        mid = _post(base, {"content": f"Observability check at {prio}: "
                                      f"how busy is the queue?",
                           "priority": prio,
                           "metadata": {"max_new_tokens": 16}})
        out.append([mid, "queued"])
    status, c = _http("POST", f"{base}/api/v1/conversations",
                      {"user_id": "obs-user"})
    assert status == 201, (status, c)
    for text in ("Trace this conversation, please.", " And its second turn."):
        status, r = _http("POST", f"{base}/api/v1/conversations/"
                                  f"{c['conversation_id']}/messages",
                          {"content": text, "priority": "high",
                           "timeout": MESSAGE_TIMEOUT_S,
                           "metadata": {"max_new_tokens": 12}})
        assert status == 202, (status, r)
        out.append([r["message_id"], "queued"])
        out[-1].append(_poll(base, r["message_id"])["metadata"].get("usage"))
    for row in out[:4]:
        row.append(_poll(base, row[0])["metadata"].get("usage"))
    req = urllib.request.Request(
        f"{base}/api/v1/messages", method="POST",
        data=json.dumps({"content": "Stream the observability check.",
                         "priority": "high", "stream": True,
                         "metadata": {"max_new_tokens": 16}}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        traceparent = resp.headers.get("traceparent")
        events = [e for e in resp.read().decode().split("\n\n") if e]
    start = json.loads(events[0].split("data: ", 1)[1])
    done = json.loads(events[-1].split("data: ", 1)[1])
    out.append([start["message_id"], "sse", done.get("usage"),
                traceparent])
    _until(lambda: _idle(engine), 120, "idle engine after the mix")
    return out


def _obs_traces(base, mix) -> dict:
    """Each request's trace: its stages in the recorder's order, the
    path's stages present, its critical-path segments summing to its end
    to end (2 %, or 0.05 ms); the SSE ``traceparent`` parses to the
    request's trace id; every queued request's usage has the ten fields
    (the SSE one JAX's eight) and page-seconds. Then the rollup, the flight recorder and the routes'
    view of the mix."""
    from llmq_tpu_torch.observability import (parse_traceparent,
                                              trace_id_for)
    from llmq_tpu_torch.observability.recorder import STAGE_ORDER

    rank = {s: i for i, s in enumerate(STAGE_ORDER)}
    segs = {}
    for row in mix:
        mid, kind, usage = row[:3]
        status, tr = _http("GET", f"{base}/api/v1/requests/{mid}/trace")
        stages = [e["stage"] for e in tr["events"]]
        need = ENGINE_STAGES + (("scheduled",) if kind == "queued"
                                else ("dispatched",))
        ranks = [rank[s] for s in stages]
        cp = tr.get("critical_path") or {}
        seg_ms = sum(cp.get("segments", {}).values()) * 1e3
        if (status != 200 or ranks != sorted(ranks)
                or not set(need) <= set(stages)
                or abs(seg_ms - tr["duration_ms"])
                > max(0.02 * tr["duration_ms"], 0.05)):
            raise AssertionError(f"trace of {kind} {mid}: {status} stages "
                                 f"{stages}, segments {seg_ms} ms vs "
                                 f"{tr.get('duration_ms')} ms")
        # The SSE ``done`` event's usage is JAX's: the token counts and
        # the ledger's six fields (no cached_tokens or finish_reason).
        want = USAGE_FIELDS if kind == "queued" else \
            USAGE_FIELDS - {"cached_tokens", "finish_reason"}
        if usage is None or set(usage) != want or \
                usage["kv_page_seconds"] <= 0:
            raise AssertionError(f"usage of {kind} {mid}: {usage}")
        segs[mid] = {k: round(v * 1e3, 3)
                     for k, v in cp["segments"].items()}
        if kind == "sse":
            tp = parse_traceparent(row[3])
            if tp is None or tp.trace_id != trace_id_for(mid):
                raise AssertionError(f"SSE traceparent {row[3]!r} for {mid}")
    status, rollup = _http("GET", f"{base}/api/v1/analysis/critical-path"
                                  f"?recent=256")
    recent = {r["request_id"] for r in rollup["recent"]}
    status2, fr = _http("GET", f"{base}/api/v1/admin/flightrecorder"
                               f"?limit=1024")
    held = {t["request_id"] for t in fr["recent"]}
    ids = {row[0] for row in mix}
    if (status != 200 or rollup["conservation_failures"] != 0
            or not ids <= recent or status2 != 200 or not ids <= held):
        raise AssertionError(f"critical path {rollup['conservation_failures']}"
                             f" failures, mix in rollup "
                             f"{len(ids & recent)}/{len(ids)}, in the "
                             f"recorder {len(ids & held)}/{len(ids)}")
    return {"segments_ms": segs, "dominant": rollup["dominant"],
            "requests": rollup["requests"]}


def _obs_boot(base, scrape) -> dict:
    """The serve boot on /health and in ``replica_ready_seconds``."""
    _, health = _http("GET", f"{base}/health")
    boot = health.get("boot") or {}
    stages = boot.get("stages_s", {})
    need = ("weights", "compile", "warmup", "first_token")
    observed = {s: _msum(scrape, "llm_queue_replica_ready_seconds_count",
                         stage=s) for s in need}
    if (boot.get("replica_id") != SERVE_BOOT_ID
            or not set(need) <= set(stages)
            or not all(v >= 1 for v in observed.values())):
        raise AssertionError(f"boot: {boot}; replica_ready_seconds counts "
                             f"{observed}")
    return {"stages_s": stages, "total_s": boot.get("total_s")}


def _event_chunk_gaps(engine, n: int):
    """Device idle at the ``n`` boundaries between the next ``n + 1``
    decode chunks the engine dispatches, in ms, from the chunks' own CUDA
    events: from one chunk's completion event (recorded behind the copy
    of its tokens) to the next one's start event (recorded behind the
    copies of its inputs, before its first step). No profiler and no
    device-wide wait: only the last chunk's own event is waited on."""
    ex = engine.executor
    handles = []
    real = ex.decode_chunk_start

    def recording(*args, **kwargs):
        h = real(*args, **kwargs)
        handles.append(h)
        return h

    ex.decode_chunk_start = recording
    try:
        _until(lambda: len(handles) > n, 60, f"{n + 1} chunks")
    finally:
        ex.__dict__.pop("decode_chunk_start", None)
    hs = handles[:n + 1]
    hs[-1].wait_ready()
    return [a._done.elapsed_time(b._start) for a, b in zip(hs, hs[1:])]


def _watch_heartbeat(app):
    """Note the card's heartbeats from now on: a list of their times
    (``time.perf_counter``), appended to as they happen. The monitor
    takes the card offline once the newest is older than the heartbeat
    timeout."""
    sched = app.resource_scheduler
    beats = []
    beat = sched.heartbeat

    def heartbeat(rid):
        beats.append(time.perf_counter())
        return beat(rid)

    sched.heartbeat = heartbeat
    return beats


def _obs_b8(app, engine, base) -> dict:
    """Eight long requests decoding: the telemetry's rate against the
    phase's own count over the same seconds, MFU from the rate, the HBM
    gauges against the model, the pools and ``torch.cuda.mem_get_info``,
    each chunk's device ms (per step) for the bimodality question; the
    device idle between five carried chunks through the engine; then the
    on-demand profile, started while the 8 rows decode, two of which are
    cancelled for two prompts whose prefill the capture must show."""
    import torch

    from llmq_tpu_torch.engine.engine import GenRequest
    from llmq_tpu_torch.ops.quant import param_count, params_bytes
    from llmq_tpu_torch.core.config import ResourceSchedulerConfig
    from llmq_tpu_torch.scheduling.resource_scheduler import ResourceStatus

    tel = engine._telemetry
    chunks = []
    noted_at = []
    note = tel.note_step

    def noting(dispatch_s, device_s, readback_s, tokens, overlapped_s=0.0):
        chunks.append((dispatch_s, device_s, readback_s, overlapped_s,
                       tokens))
        noted_at.append(time.perf_counter())
        return note(dispatch_s, device_s, readback_s, tokens,
                    overlapped_s=overlapped_s)

    def free_pool():
        # The radix tree and the idle pins hold the pool after the
        # earlier traffic; a carried dispatch takes only free pages (it
        # never sheds), so the run starts from an empty pool.
        pc = engine._prefix_cache
        pc.evict_pages(pc.pages)
        while engine._reclaim_idle_conversation():
            pass

    _until(lambda: _idle(engine), 120, "idle engine before 8 rows")
    with engine.paused():
        free_pool()
    free0 = engine.allocator.available()
    log(f"[serve-plane] pool emptied: {free0} free pages")
    prompt = "The quick brown fox jumps over the lazy dog. " * 2
    # 900 new tokens: eight rows of ~1000 positions fill 504 of the 511
    # pages, so no row is shed while they decode.
    hs = [engine.submit(GenRequest(id=f"obs-b8-{i}-{time.time()}",
                                   prompt=f"{i}: {prompt}",
                                   max_new_tokens=900)) for i in range(8)]
    _until(lambda: _decoding_rows(engine) >= 8, 120, "eight rows decoding")
    tel.note_step = noting
    try:
        time.sleep(0.3)
        with tel._mu:
            tel._tok_window.clear()     # the window holds this run only
        t_a, n_a = time.time(), engine.tokens_generated_total
        time.sleep(3.0)
        rate_tel = tel.tokens_per_s()
        t_b, n_b = time.time(), engine.tokens_generated_total
        rate_me = (n_b - n_a) / (t_b - t_a)
        scrape, scrape_ms = _scrape(base)
        name = engine.name
        rate_g = _msum(scrape, "llm_queue_decode_tokens_per_s", engine=name)
        mfu_g = _msum(scrape, "llm_queue_mfu_pct", engine=name)
        n_params = param_count(engine.executor.model.params)
        free, total = torch.cuda.mem_get_info()
        w = _msum(scrape, "llm_queue_hbm_weights_bytes", engine=name)
        kv = _msum(scrape, "llm_queue_hbm_kv_pool_bytes", engine=name)
        free_g = _msum(scrape, "llm_queue_hbm_free_bytes", engine=name)
        limit_g = _msum(scrape, "llm_queue_hbm_limit_bytes", engine=name)
        w_want = params_bytes(engine.executor.model.params)
        kv_want = sum(x.numel() * x.element_size()
                      for x in engine.executor.cache.values())
        overlap = tel.overlap_ratio()
        if (abs(rate_tel - rate_me) > 0.1 * rate_me
                or tel.n_params != n_params
                or abs(mfu_g - rate_g * 2 * n_params / BF16_FLOPS_PER_S
                       * 100)
                > 1e-9 * max(1.0, mfu_g)
                or w != w_want or kv != kv_want or limit_g != total
                or abs(free_g - free) > 256 * 2**20 or not overlap > 0):
            raise AssertionError(
                f"telemetry under 8 rows: rate {rate_tel} vs {rate_me}, "
                f"mfu {mfu_g} from {rate_g} x {n_params}, weights {w} vs "
                f"{w_want}, pools {kv} vs {kv_want}, free {free_g} vs "
                f"{free}, limit {limit_g} vs {total}, overlap {overlap}")
        # Four boundaries between five carried chunks through the engine,
        # timed by the chunks' own CUDA events (a CUDA-only torch.profiler
        # capture taken on this thread while the engine dispatched
        # carried chunks never returned, twice on the H100).
        log(f"[serve-plane] timing the engine's chunk boundaries, "
            f"{_decoding_rows(engine)} rows decoding")
        s0 = engine.steps
        depth0 = dict(engine.pipeline_depth_hist)
        gaps = _event_chunk_gaps(engine, 4)
        depth = {d: n - depth0[d] for d, n in
                 engine.pipeline_depth_hist.items() if n != depth0[d]}
        if max(gaps) >= 0.1 or not depth.get(2):
            raise AssertionError(f"engine chunk boundaries idle {gaps} ms "
                                 f"(want each < 0.1 ms), dispatches by "
                                 f"depth {depth}")
        # The on-demand profile, started while the 8 rows decode; two of
        # them are cancelled for two prompts arriving during the capture
        # (their prefill launches kernels 2 and 3).
        prof = None
        beats = _watch_heartbeat(app)
        for attempt in range(3):
            if _decoding_rows(engine) < 8:
                raise AssertionError("fewer than 8 rows decode at the "
                                     "profile's start")
            log(f"[serve-plane] on-demand profile {attempt} starting, "
                f"{_decoding_rows(engine)} rows decoding")
            t_post = time.perf_counter()
            beats.append(t_post)
            st, info, _ra = _http_status("POST", f"{base}/api/v1/admin/"
                                                 f"profile",
                                         {"duration_ms": 1000,
                                          "label": f"serve-{attempt}"})
            again = _http_status("POST", f"{base}/api/v1/admin/profile", {})
            for h in hs[2 * attempt:2 * attempt + 2]:
                h.cancel()
            extra = [engine.submit(GenRequest(
                id=f"obs-prof-{attempt}-{i}-{time.time()}",
                prompt=f"{i} " + "profile this prefill " * (5 + 15 * i),
                max_new_tokens=900)) for i in range(2)]
            try:
                _until(lambda: not _http("GET", f"{base}/api/v1/admin/"
                                                f"profile")[1]["active"],
                       90, "the profile to finish", poll=0.1)
            except AssertionError:
                import faulthandler

                faulthandler.dump_traceback(all_threads=True)
                raise
            t_done = time.perf_counter()
            _, status = _http("GET", f"{base}/api/v1/admin/profile")
            hs += extra
            if st != 202 or again[0] != 409 or \
                    status["last"]["label"] != f"serve-{attempt}":
                raise AssertionError(f"profile route: {st} {info}, then "
                                     f"{again[0]}, status {status}")
            last = status["last"]
            # The engine's stall: the longest wait between two chunks it
            # finished from the POST to the capture's end (the trace
            # written), next to the chunk's own ~150 ms.
            seen = [t_post] + [t for t in noted_at if t_post < t < t_done]
            stall = max(b - a for a, b in zip(seen, seen[1:] + [t_done]))
            path = os.path.join(last["path"], "trace.json")
            names = []
            with open(path) as f:          # one event a line
                for line in f:
                    if '"cat": "kernel"' in line:
                        names.append(json.loads(line.lstrip(","))["name"])
            beats.append(time.perf_counter())
            hb_gap = max(b - a for a, b in zip(beats, beats[1:]))
            found = {k: sum(1 for n in names if sym in n)
                     for k, sym in PATH_KERNELS.items()}
            held = {k: round(last[k], 3) for k in ("start_s", "stop_s",
                                                   "write_s")}
            serving_hb = ResourceSchedulerConfig().heartbeat_timeout
            log(f"[serve-plane] on-demand profile {attempt}: {len(names)} "
                f"card kernels of {last['events']} events in "
                f"{os.path.getsize(path) / 2**20:.1f} MiB of trace; kernels "
                f"1-3 {found}; engine held {held['start_s']} s at the start "
                f"and {held['stop_s']} s at the stop, trace written in "
                f"{held['write_s']} s (engine serving); from the POST to "
                f"done {t_done - t_post:.3f} s, engine stall {stall:.3f} s, "
                f"longest heartbeat gap {hb_gap:.3f} s (the phase's timeout "
                f"{PLANE_HEARTBEAT_S} s, the serving default {serving_hb} s) "
                f"({CARD})")
            r = app.resource_scheduler.get_resource(
                app._own_resource_ids[0])
            bound = max(last["start_s"], last["stop_s"]) + PROFILE_STALL_S
            if stall >= bound or hb_gap >= serving_hb \
                    or r.status != ResourceStatus.ONLINE:
                raise AssertionError(
                    f"the on-demand profile stalled serving: engine "
                    f"{stall} s (want < {bound}: the profiler's longest "
                    f"hold + {PROFILE_STALL_S}), heartbeat gap {hb_gap} s "
                    f"(want < {serving_hb}), card {r.to_dict()}")
            if all(found.values()):
                prof = {"path": path, "kernels": len(names), "found": found,
                        "attempts": attempt + 1, "stall_s": stall,
                        "heartbeat_gap_s": hb_gap, **held,
                        "events": last["events"]}
                break
        if prof is None:
            raise AssertionError("the on-demand profile never showed "
                                 "kernels 1-3")
    finally:
        tel.note_step = note
        app.resource_scheduler.__dict__.pop("heartbeat", None)
    for h in hs:
        h.cancel()
    _until(lambda: _idle(engine), 120, "idle engine after the 8 rows")
    full = [c for c in chunks if c[4] == 128]      # 8 rows x 16 steps
    per_step = sorted(round(d * 1e3 / 16, 3) for _dp, d, _r, _o, _t in full)
    legs = {name: round(sum(c[i] for c in full) * 1e3 / max(1, len(full)), 3)
            for i, name in enumerate(("dispatch_ms", "device_ms",
                                      "readback_ms", "overlapped_ms"))}
    window_overlap = (legs["overlapped_ms"]
                      / max(1e-9, legs["overlapped_ms"] + legs["device_ms"]))
    log(f"[serve-plane] 8 rows decoding: telemetry {rate_tel:.1f} tok/s vs "
        f"counted {rate_me:.1f} tok/s over the same {t_b - t_a:.2f} s; MFU "
        f"{mfu_g:.3f}% ({rate_g:.1f} tok/s x 2 x {n_params} / 989e12); "
        f"overlap ratio {overlap:.4f}; HBM weights {w / 1e9:.3f} GB, pools "
        f"{kv / 1e9:.3f} GB, free {free_g / 2**30:.2f} GiB of "
        f"{limit_g / 2**30:.2f} GiB; RTT {tel.rtt_ms:.3f} ms; scrape "
        f"{scrape_ms:.2f} ms; over its {len(full)} full chunks (the "
        f"profile's included) the legs a chunk: dispatch "
        f"{legs['dispatch_ms']} ms, device {legs['device_ms']} ms, "
        f"readback {legs['readback_ms']} ms, overlapped "
        f"{legs['overlapped_ms']} ms (overlap {window_overlap:.4f}; the "
        f"engine's whole life {overlap:.4f}) ({CARD})")
    log(f"[serve-plane] per-chunk device ms / 16 steps, full B=8 chunks "
        f"({len(per_step)}): {per_step} ({CARD})")
    log(f"[serve-plane] engine chunk boundaries (observability on, 8 rows "
        f"from a pool of {free0} free pages, {s0} steps before, chunks "
        f"dispatched by pipeline depth {depth}): idle "
        f"{', '.join(f'{g:.4f}' for g in gaps)} ms between five carried "
        f"chunks, by their CUDA events ({CARD})")
    return {"rate_telemetry": rate_tel, "rate_counted": rate_me,
            "mfu_pct": mfu_g, "overlap_ratio": overlap,
            "hbm_weights_bytes": w, "hbm_kv_pool_bytes": kv,
            "hbm_free_bytes": free_g, "hbm_limit_bytes": limit_g,
            "rtt_ms": tel.rtt_ms, "scrape_ms": scrape_ms,
            "step_legs": legs, "window_overlap_ratio": window_overlap,
            "per_step_device_ms": per_step,
            "profile": prof, "chunk_gaps_ms": gaps, "depth": depth}


def _obs_cost(cfg, engine) -> dict:
    """B=1 and 8-concurrent decode tok/s with observability on and off in
    turns (on, off, off, on); the "on" means within 3 % of the "off"
    ones (the JAX package's step-path budget). One 8-concurrent batch
    runs first and is not counted, so every counted batch meets the same
    prefix cache; a turn's 8-concurrent rate is the median of three
    batches, as its B=1 rate is the median of three requests (one batch
    lasts ~0.3 s, so a single host stall of 0.1 s moves it by a third).
    Every batch's rate is printed, with the collector's pauses in each
    turn."""
    import gc

    from llmq_tpu_torch import observability
    from llmq_tpu_torch.core.config import ObservabilityConfig, UsageConfig

    off = ObservabilityConfig(enabled=False, usage=UsageConfig(enabled=False))
    rates = {"on": [], "off": []}
    batches = {"on": [], "off": []}
    pauses, started = [], []

    def on_gc(phase, _info):
        if phase == "start":
            started[:] = [time.perf_counter()]
        elif started:
            pauses.append(time.perf_counter() - started.pop())

    gc_turns = []
    gc.callbacks.append(on_gc)
    try:
        settle, _ = _b8_rate(engine, "serve-plane-obs-settle")
        for turn, on in enumerate((True, False, False, True)):
            observability.configure(cfg.observability if on else off)
            key = "on" if on else "off"
            del pauses[:]
            _ttft, r1, _n = _b1_rates(engine, f"serve-plane observability "
                                              f"{key}")
            b8 = [_b8_rate(engine, f"serve-plane-obs-{turn}-{i}")[0]
                  for i in range(3)]
            rates[key].append((r1, sorted(b8)[1]))
            batches[key].append([round(b, 1) for b in b8])
            gc_turns.append((key, len(pauses),
                             round(max(pauses, default=0.0) * 1e3, 3)))
    finally:
        gc.callbacks.remove(on_gc)
        observability.configure(cfg.observability)

    def mean(key, i):
        return sum(r[i] for r in rates[key]) / len(rates[key])

    ratio = [mean("on", i) / mean("off", i) for i in (0, 1)]
    log(f"[serve-plane] observability on: B=1 "
        f"{[round(r, 1) for r, _ in rates['on']]} tok/s, 8 concurrent "
        f"{[round(b, 1) for _, b in rates['on']]} tok/s (batches "
        f"{batches['on']}); off: B=1 "
        f"{[round(r, 1) for r, _ in rates['off']]}, 8 concurrent "
        f"{[round(b, 1) for _, b in rates['off']]} (batches "
        f"{batches['off']}); uncounted first batch {settle:.1f} tok/s; "
        f"collector pauses by turn (mode, count, longest ms) {gc_turns}; "
        f"on/off B=1 {ratio[0]:.4f}, 8 concurrent {ratio[1]:.4f} ({CARD})")
    if min(ratio) < 0.97:
        raise AssertionError(f"observability costs more than 3%: on/off "
                             f"{ratio}")
    return {"rates_on": rates["on"], "rates_off": rates["off"],
            "batches_on": batches["on"], "batches_off": batches["off"],
            "gc_turns": gc_turns, "on_over_off": ratio}


def _observability_gates(app, engine, base) -> dict:
    """The observability plane on the serve engine (module doc, phase 8)."""
    from llmq_tpu_torch.observability import get_usage_ledger

    # The pool pressure again, anchored: its rebuilds re-prefill in mixed
    # slices, which the usage plane bills as "preempt" waste.
    pressure = _pool_pressure(engine, base, "serve-plane-waste", anchor=True)
    _until(lambda: _idle(engine), 120, "idle engine before the mix")
    before, _ms = _scrape(base)
    led = get_usage_ledger()
    a0 = led.attributed_device_s
    n0 = engine._telemetry.snapshot()["steps"]["count"]
    s0 = engine.steps
    mix = _obs_mix(engine, base)
    after, _ms = _scrape(base)
    name = engine.name
    a1 = led.attributed_device_s
    n1 = engine._telemetry.snapshot()["steps"]["count"]
    hist = {leg: _msum(after, f"llm_queue_step_{leg}_ms_count", engine=name)
            - _msum(before, f"llm_queue_step_{leg}_ms_count", engine=name)
            for leg in ("dispatch", "device", "readback")}
    dev_s = (_msum(after, "llm_queue_step_device_ms_sum", engine=name)
             - _msum(before, "llm_queue_step_device_ms_sum",
                     engine=name)) / 1e3
    attributed = a1 - a0
    goodput = _msum(after, "llm_queue_goodput_tokens_per_device_second")
    burn = {(s, w): (("llm_queue_slo_burn_rate",
                      (("slo", s), ("window", w))) in after)
            for s in ("ttft", "realtime") for w in ("5m", "1h")}
    waste = pressure["waste"]
    wasted = {m: r for m, (s, r) in waste.items() if s and s > 0}
    if (set(hist.values()) != {n1 - n0} or n1 - n0 != engine.steps - s0
            or n1 == n0 or attributed > dev_s + 1e-6 or not goodput > 0
            or not all(burn.values()) or not wasted
            or set(wasted.values()) != {"preempt"}):
        raise AssertionError(
            f"observability: step samples {hist} for {n1 - n0} chunks "
            f"noted, {engine.steps - s0} dispatched; attributed "
            f"{attributed} s vs {dev_s} s of step_device_ms; goodput "
            f"{goodput}; burn gauges {burn}; pressure waste {waste}")
    out = {"traces": _obs_traces(base, mix), "boot": _obs_boot(base, after),
           "chunks": n1 - n0, "attributed_s": attributed,
           "step_device_s": dev_s, "goodput": goodput,
           "pressure_waste": wasted, "waste_run": pressure}
    log(f"[serve-plane] observability: {len(mix)} requests (4 priorities, "
        f"2 turns, SSE) traced in the recorder's stage order, segments "
        f"conserved; {n1 - n0} chunks = {n1 - n0} samples per step leg; "
        f"attributed {attributed:.6f} s of {dev_s:.6f} s step device "
        f"time; goodput {goodput:.3f} tok/device-s; pressure waste "
        f"{wasted}; serve boot {out['boot']} ({CARD})")
    out["b8"] = _obs_b8(app, engine, base)
    out["cost"] = _obs_cost(app.cfg, engine)
    return out


def phase_serve_plane(state) -> None:
    """The serving process (queue factory with delayed and dead-letter
    queues, workers with retry backoff, crash supervisor, conversation
    service, preprocessor, overload shedder, load balancer, resource
    scheduler) around the serve phase's bf16 default engine,
    configured from a YAML file, through REST. No ``*_plain`` twin may be
    called; the pressure traffic must launch the bucket route's
    kernels."""
    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.ops import kernels

    engine = state.pop("serve_engine", None)
    if engine is None:
        raise AssertionError("serve-plane serves on the serve phase's "
                             "engine: run both phases")
    cfg, path = _plane_config_file()
    out = state.setdefault("serve_plane", {})
    counts, restore = _count_plain_calls()
    app = App(cfg, engine=engine)
    pairs = []
    observe = engine.on_prefill_observed

    def observed(tokens, seconds):
        pairs.append((tokens, seconds))
        observe(tokens, seconds)

    engine.on_prefill_observed = observed
    base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
    log(f"[serve-plane] serving process on the serve phase's engine, "
        f"configured from {os.path.relpath(path)}: retry "
        f"backoff initial {cfg.queue.retry.initial_backoff} s x "
        f"{cfg.queue.retry.backoff_multiplier} (max_retries "
        f"{cfg.queue.retry.max_retries}), worker poll "
        f"{cfg.queue.worker.process_interval} s, supervisor check "
        f"{cfg.executor.supervisor.check_interval} s, overload shedding "
        f"{'on' if app.api.shedder is not None else 'off'}")
    try:
        before, _ms = _scrape(base)
        start = {"preemptions": engine.preemptions, "steps": engine.steps}
        topo = _topology_check(app, base)
        kernels.reset_launches()
        out["pressure"] = _pool_pressure(engine, base, "serve-plane")
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        for name in ("fused_decode", "kv_prefill_write", "prefill_attention"):
            if launches[name] <= 0:
                raise AssertionError(f"serve-plane pressure never launched "
                                     f"{name}: {launches}")
        out["pressure_launches"] = {k: v for k, v in launches.items() if v}
        log(f"[serve-plane] pressure launches {out['pressure_launches']}")
        out["crash"] = _crash_recovery(app, engine, base)
        out["dead_letter"] = _dead_letters(app, engine, base)
        out["conversation"] = _conversation_plane(app, engine, base)
        out["priority"] = _priority_inference(base)
        out["sse"] = _sse_check(engine, base)
        out["metrics"] = _metrics_gates(app, engine, base, before, start,
                                        out["sse"]["streamed_id"],
                                        requeued=1)
        _heartbeat_check(app, topo)
        out["topology"] = {k: v for k, v in topo.items()
                           if k != "registered_at"}
        out["prefill"] = _learned_prefill(app, pairs)
        # The observability gates need the workers, which the drain stops.
        out["observability"] = _observability_gates(app, engine, base)
        out["drain"] = _drain_check(app, engine, base)
        out["metrics_cost"] = _metrics_cost(engine, base)
        out["overload"] = _overload(app, engine, base)
        shed, _ms = _scrape(base)
        got = {r: _msum(shed, "llm_queue_requests_shed_total", reason=r)
               - _msum(before, "llm_queue_requests_shed_total", reason=r)
               for r in app.api.shedder.shed_counts}
        if got != {r: float(n) for r, n in
                   app.api.shedder.shed_counts.items()} or not any(
                       got.values()):
            raise AssertionError(f"/metrics sheds {got} vs "
                                 f"{app.api.shedder.shed_counts}")
        log(f"[serve-plane] /metrics requests_shed_total by reason {got} "
            f"equals the shedder's counts")
    finally:
        engine.on_prefill_observed = observe
        app.stop()
        restore()
        engine.executor.release_graphs()
    if counts:
        raise AssertionError(f"serve-plane called plain twins: {counts}")

PHASES = [("env", phase_env), ("build", phase_build),
          ("kernels", phase_kernels), ("split", phase_split),
          ("model", phase_model), ("graphs", phase_graphs),
          ("serve", phase_serve), ("serve-plane", phase_serve_plane),
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
    state = {"kernels": {}, "chosen": chosen}
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
                      "serve_plane": state.get("serve_plane"),
                      "serve_boot": state.get("serve_boot"),
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
