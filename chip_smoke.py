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
6. graphs     — the decode step as a CUDA graph on five engines of
                 llama3-8b's widths at GRAPHS_LAYERS (12) of its 32
                 layers, built with ``warmup=True`` (bf16 default, the
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
8. serve-spec — speculative decoding on the serve phase's weights
                 (llama3-8b at full width and depth; the serve engine
                 geometry: 8 slots, 512 pages of 16, buckets [128, 512,
                 2048], pipeline depth 2) with ``executor.speculation:
                 {enabled: true, draft_k: 4, ngram_max: 3}``. From a B=8
                 cache state of rows of 1-480 positions, a plain decode
                 chunk of W = 5 steps, the pools restored, then one
                 verify window whose drafts are the chunk's first four
                 tokens: every row commits 5, the window's tokens are the
                 chunk's and every pool is bitwise the chunk's; so on the
                 fused route (kernel 1) and the split route (kernels 4 +
                 8) with device accept, with host accept, and over int8
                 pools (kernel 5, full depth). Rollback: windows of
                 garbage drafts commit 1 token each and give plain
                 decode's stream and committed KV bitwise (host accept at
                 the executor; device accept through the engine, where
                 every reconcile leaves a row the pages of its committed
                 positions). Then the engine serves over REST: B=1 and 8
                 concurrent requests of 128 new tokens over repetitive
                 prompts, a two-turn conversation (turn 2 cached), and
                 eight LOW rows with a REALTIME arrival that preempts;
                 every request completes through kernels 1-3, no page
                 leaks, and ``get_stats()["speculation"]`` and the four
                 ``spec_*`` families of ``/metrics`` equal the engine's
                 counters. Printed, not gated: windows, acceptance and
                 readback cadence, the device idle at window boundaries,
                 a window's device ms at B=8 (all drafts accepted, all
                 rejected) against W plain steps, B=1 and 8-concurrent
                 tok/s with speculation off and on in turns on the same
                 engine, and how many B=1 greedy tokens agree. Last, the
                 chaos plane's ``engine.step`` crash lands while a verify
                 window is in flight: the supervisor restarts the loop
                 and drops the window, the failed request's stream is a
                 prefix of its committed tokens (no token of the dead
                 window), and its retry completes (the invariant checker
                 holds both streams).
9. serve-tiering — the tiered KV plane on the serve phase's weights
                 (llama3-8b bf16 at full width and depth): two engines
                 with ``executor.kv_tiering`` enabled, bf16 KV then int8
                 KV, each behind the full ``App`` with its conversation
                 store in SQLite under the phase's directory and a host
                 tier of 1.5 conversations (pinned). Conversations of a
                 1536-token history over REST, turn 2 at B=1 on an idle
                 engine: with the pin resident (the reference), demoted
                 to the host tier, spilled to the store by a second
                 conversation's demotion, and recomputed (no host room,
                 no spill), twice. Gates: each turn 2 is served from its
                 tier (``kv_tier``), every promoted page holds bit for bit
                 the bytes of its pin before demotion (every leaf: int8
                 values and bf16 scales too), host and store turns 2 give
                 the resident pin's greedy tokens and the two recomputes
                 each other's, hits are {hbm 1, host 2, store 1,
                 recompute 2}, no inject, transfer or store failure, the
                 host arena is pinned, the slice's kernels launch (bf16:
                 1, 2, 3; int8 KV: 5 and no bf16-pool kernel) and no
                 twin is called. Printed: turn-2 TTFT by tier, the export
                 dispatch ms and the gather, D2H, H2D and inject device
                 ms with their GB/s, and (bf16) the step ms and
                 chunk-boundary idle of 8 decoding rows before and while
                 a 1536-token history demotes. Then (bf16) the store fault
                 domain: the conversation store behind
                 ``wrap_store(..., op_timeout_s=0.25)``, turn 2 of a
                 240-token history by recompute, from the healthy store,
                 and from the store while a chaos ``store.kv`` rule stalls
                 it 2 s: that turn completes by recompute (kernels 2 and
                 3) within the recompute turn's TTFT + 0.25 x 3 + 1 s,
                 ``/health``'s ``store`` block counts the deadline miss,
                 and after the rule the replay buffer drains to 0.
10. serve-disagg — prefill/decode disaggregation on the serve phase's
                 weights: two engines with ``executor.kv_tiering`` on, a
                 prefill one and a decode one, each behind its ``App``
                 (the disaggregation plane built from ``disagg``) over one
                 SQLite conversation store, as in-process endpoints of
                 one cluster router steering by role with the prefill
                 engine's learned prefill ETA (``long_prompt_ms``
                 DISAGG_LONG_PROMPT_MS: JAX's 250 ms would call no
                 prompt on this card long). a. a 1536-token first turn
                 runs on the prefill engine and is published; b. turn 2
                 leaves that affinity (reason ``handoff``) for the
                 decode engine, which claims the KV from the exchange:
                 its cached tokens are the whole published stream, 0
                 recomputed (store hit), ``handoff_claim`` in its trace,
                 the imported pages bit for bit the exported ones, and
                 its tokens equal those of the same two turns with the
                 pin resident; c. turn-2 TTFT by claim, by recompute
                 after the claim's TTL (``kv_exchange_expired``), and
                 resident (printed); d. the decode engine's
                 conversations demote (one spills to the store), and a
                 fresh decode engine on the same store adopts exactly
                 its owned blobs at start (``rehydrate_on_start``); e.
                 kernels 1-3 launch on both engines; no twin is called.
11. serve-tenancy — the tenancy plane (gold at weight 4, bronze at 1, a
                 metered tenant at 200 tok/s with a 400-token burst, a
                 capped one at 1 in flight and 2 queued) around the serve
                 phase's bf16 engine, through the full ``App`` with
                 ``X-Tenant-Id``: a. 4 gold and 4 bronze requests of 128
                 tokens, every contended chunk's budgets equal to the
                 rule's (``weighted_token_caps`` and JAX's scaling), no
                 row below 1, every request complete; b. 40 + 40 messages
                 queued before the workers start, the first half's
                 served tokens gold:bronze in [2.4, 6.4]; d. the metered
                 tenant's 429 ``tenant_quota`` with Retry-After, gold
                 admitted meanwhile, the count equal to ``/metrics``; the
                 capped tenant's 429 ``queue_depth`` and deferred
                 completions; e. one tenant's 8 requests: budgets
                 unchanged, tok/s on and off in turns (printed); f.
                 ``/api/v1/tenancy`` with JAX's keys and the five
                 families. c'. a bucket-mode plan (64 + 64, printed); c.
                 on a ragged engine on the same weights, two 1500-token
                 prompts admitted together while six rows decode: a step
                 packs 102 + 26 tokens, both ending mid-page, a later one
                 continues them mid-page, and each prompt's final-slice
                 logits replayed with that schedule through
                 ``forward_mixed_ragged`` lie within ``MODEL_ATOL`` of the
                 prompt in uncapped 128-token pieces. No twin is called.
12. serve-weights — llama3-1b at full width and depth (16 layers, D=64,
                 n_rep 4, tied head), random weights on the card written
                 as a two-shard bf16 Hugging Face directory by the port's
                 own writer, then served from ``model.checkpoint_path``:
                 every leaf bitwise the written one, a greedy B=1 REST
                 stream equal to an engine's on the in-memory tree; the
                 same directory into int8 weights, served; their
                 checkpoint saved and loaded bitwise; an orbax-shaped
                 directory refused; with ``transformers`` importable, one
                 request through an ``HFTokenizer`` written there. Write
                 and load seconds, GB/s and host RSS peaks printed.
13. serve-plane — the serving process around the serve phase's bf16
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
                 engine loop killed by the chaos plane's ``engine.step``
                 crash with eight requests decoding at depth 2 (the
                 supervisor restarts it once, each message retries
                 through the delayed queue and completes once, the
                 graphs are replayed and none is captured again, and the
                 invariant checker finds none lost, none duplicated and
                 every attempt's stream a prefix of its result), then
                 eight under an ``engine.hbm_alloc`` fault of probability
                 0.3 (all complete; ``chaos_injected_total`` counts the
                 faults); a message that fails on every attempt
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
14. serve-control — the control plane: the serve phase's bf16 engine
                 behind the full ``App`` in serve mode with
                 ``controlplane.enabled`` (tick 0.5 s, 1-2 replicas,
                 backlog 4 a replica, a subprocess pool whose children
                 are ``python -m llmq_tpu_torch serve`` on the same card,
                 llama3-8b at full width and depth, SPLIT_PRELUDE's
                 counts), the breakers off and the workers queueing a
                 burst. a. a queued burst drives ``scale_up`` (reason
                 ``backlog``); the child serves the parent's model
                 (same parameter count and pool), its boot stages are
                 adopted (printed), and it takes dispatches; b. with 8
                 rows decoding on it the child is SIGKILLed: the
                 controller replaces it (``replace``, ``replica_dead``),
                 every message completes once (the invariant checker;
                 kill to completed and ``controller_recovery_seconds``
                 printed, the recovery observed in ``/metrics``); c. with a
                 TTFT objective of 1 ms the ladder climbs one rung per
                 hot tick; at ``shed_batch`` a LOW submission is shed
                 429 ``degraded`` with Retry-After (``/metrics`` +1)
                 while a HIGH one completes; ``POST
                 /api/v1/admin/controller`` pauses (``/health`` says
                 paused, the tick holds the rung) and resumes; loosened,
                 the ladder relaxes to 0; d. idle, ``scale_down`` drains
                 and decommissions the replica, whose process exits,
                 and the local endpoint stays; e. kernels 1-3 launch in
                 the parent and in the child, and no twin runs in any of
                 the three processes.
15. serve-cluster — the replica set: the serve phase's bf16 engine behind
                 the full ``App`` in serve mode (the autoscaler running)
                 with ``cluster.peers: [peer]`` and ``include_local``,
                 the peer a ``python -m llmq_tpu_torch serve`` child on
                 the same card (llama3-8b at full width and depth,
                 random weights from seed 0, SPLIT_PRELUDE's counts).
                 Config: ``configs/config.yaml`` with serve-plane's
                 overrides, ``scheduler.min_endpoints: 2`` (at the
                 default 1 the autoscaler drops one of the two endpoints
                 at its first tick, as the JAX package's does) and
                 ``loadbalancer.strategy: round_robin``. a. 16 requests
                 over four tiers complete, dispatched to both replicas;
                 f. a peer-served request's local trace holds the peer's
                 engine stages under its trace id; b. a conversation's
                 turn 2 returns to turn 1's replica with cached tokens,
                 then that replica is drained through ``POST
                 /api/v1/endpoints/:id/drain``, turn 3 spills and
                 completes, and an undrain readmits it; g. a ``gateway
                 --peers`` child in front of both completes 8 requests
                 without initialising CUDA; d. the cluster overview
                 lists both replicas with device blocks; c. with the
                 local replica drained, 8 requests decode on the peer,
                 the local one is readmitted and the peer SIGKILLed:
                 all 8 complete locally (failover within the dispatch or
                 the worker's retry), the invariant checker finds none
                 lost or duplicated, the peer's breaker is open; d. the
                 overview then lists it as an error entry within the
                 probe timeout + 1 s; e. ``/metrics``' five
                 ``cluster_*`` and two ``circuit_breaker_*`` families
                 equal the router's counts; h. kernels 1-3 launch in
                 both serving processes and no twin is called in
                 either. Printed: the peer's boot seconds, turn-2 TTFT
                 on the affine replica against the spilled turn 3's, a
                 generate hop's added ms, 8 concurrent requests' tok/s
                 on two replicas against one, and the kill to the last
                 completion.
16. serve-split — the durable queue plane and the split deployment. First,
                 on the serve phases' bf16 engine, decode of 8 concurrent
                 REST requests (64 new tokens) through the serving
                 process with ``queue.wal_dir`` set and unset, in turns,
                 and the journal's bytes a message (printed, not gated);
                 then that engine is released. Push+pop operations per
                 second of the native and the Python queue core at a
                 backlog of 10,000 over the four tiers; the native
                 library must be the one built from ``native/src/mlq.cpp``
                 into ``llmq_tpu_torch/_build/``. Then ``python -m
                 llmq_tpu_torch gateway`` and ``queue-manager`` (llama3-8b
                 at full width and depth on the card, random weights from
                 seed 0) as child processes, configured from
                 ``configs/config.yaml`` with the phase's overrides and a
                 shared ``queue.spool_dir``, each with its own
                 ``queue.wal_dir``; a prelude counts the plain twins and
                 writes ``kernels.LAUNCHES`` (zeroed when the engine
                 starts serving) to a status file. Every queue in both
                 runs the native core. 16 requests (four tiers, prompts of
                 40-600 tokens, 64 new tokens) complete on the gateway's
                 ``GET /api/v1/messages/:id`` with response and usage
                 (spool publish-to-claim and end-to-end times by tier
                 printed). 16 more (256 new tokens): with 8 rows decoding
                 the queue-manager is SIGKILLed; one message published
                 meanwhile is held as a dead consumer's claim older than
                 the claim TTL; the queue-manager restarts on the same
                 directories, its WAL redelivers what it had popped, the
                 stale claim is reclaimed, every message completes
                 (duplicates counted), none is left pending or
                 processing, and the spool is empty. Then the gateway is
                 stopped with 8 messages in flight and restarted on its
                 WAL: they are relayed again and complete (traces from
                 the spool). Kernels 1-3 launch in each queue-manager, no
                 twin is called, and no gateway initialises CUDA.
17. serve-int8 — llama3-8b with int8 weights and int8 KV at full width and
                 depth (``LLMQ_MODEL_QUANTIZATION=int8
                 LLMQ_MODEL_KV_QUANTIZATION=int8``), the same REST mix:
                 kernel 5 launches and no bf16-pool kernel does; then a
                 second engine on the same weights with ragged attention
                 on: kernel 7 launches. Rates, the decode breakdown,
                 the plain int8 prefill attention's share of the int8
                 TTFT program, the wave admission, weight bytes and
                 peak memory; and serve-plane's pool-pressure traffic
                 once more over the int8 pool and its scale pools.

18. serve-scenarios — (run after serve-disagg) the scenario engine: a bf16
                 llama3-8b engine over the serve phase's weights (full
                 width and depth) at the JAX package's defaults, warmed,
                 plays three shipped scenarios (``configs/scenarios/``)
                 through the port's ``run_scenario`` on an
                 ``EngineTarget``, each at scale 0.05 on the compressed
                 ``FakeClock``: a. ``agentic_tool_loops`` (13
                 conversations, 78 turns whose histories grow): every
                 turn completes, none fails or is shed, later turns are
                 admitted from cached KV; b.
                 ``diurnal_tenant_mix_with_flash_crowd`` (30
                 conversations, 65 turns, tenants gold:silver:bronze at
                 3:2:1, one ``engine.step`` crash with no match, so only
                 this engine runs): the crash fires once, the target's
                 supervisor recovers the engine, every failed attempt is
                 retried and every turn completes; c.
                 ``rag_long_prompt_flood`` (8 conversations, 14 turns,
                 prompts of up to 4656 bytes, past the 2048-token window:
                 the engine keeps their tail): every turn completes. In
                 each, the schedule digest is the JAX package's, the
                 invariant checker finds nothing lost or duplicated and
                 saw every submission, kernels 1-3 launch and no twin
                 is called. Printed: goodput by the usage ledger and by
                 the driver, SLO attainment, wall seconds and
                 compression, TTFT p50 and max, each tenant's share
                 error, graph replays against captures, the turns cut.
                 Afterwards chaos is disarmed and tenancy reset.

19. serve-mesh — (runs last) the mesh executor. What earlier phases
                 kept on the card (the serve phase's engine and weights)
                 is dropped first: c. holds two whole llama3-8b ranks
                 beside this process. a. A
                 ``python -m llmq_tpu_torch serve`` child with
                 ``LLMQ_COORDINATOR`` at world size 1 and
                 ``executor.mesh: {enabled: true, shape: {tp: 1}}``
                 (llama3-8b bf16, random weights from seed 0) joins its
                 NCCL group, captures its graphs (the collectives inside
                 them) and answers four REST requests, one at a time;
                 then a child without the mesh answers the same. Gates:
                 the NCCL join in the child's log, graph replays > 0,
                 every request's tokens equal to the no-mesh child's,
                 kernels 1-3 launched as many times, ``n_chips`` 1 and
                 one ``hbm_info`` entry. b. Two ranks on the one card
                 over gloo (NCCL refuses two ranks on one device),
                 ``tp = 2`` of llama3-8b at full width and depth: each
                 rank holds 16 query heads, 4 KV heads, half the SwiGLU
                 and half the vocab, and runs ``forward_prefill`` over 8
                 rows x 512 tokens, a decode step on the fused route
                 (kernel 1), one on the split route (kernels 4 and 8),
                 then an int8-KV prefill and decode step (kernel 5);
                 rank 0 first runs the same on the whole model. Gate:
                 every logit within 0.05 x max |logit| of the one-rank
                 forward's, and argmax equal on every row whose top-2
                 margin exceeds that bound; the launches of each rank
                 are counted, its peak memory printed. c. ``executor.mesh:
                 {dp: 2}`` over two gloo ranks on the one card, llama3-8b
                 bf16 at full width and depth at the serve phase's
                 geometry, speculation and the tiered KV plane on: rank 1
                 is ``python -m llmq_tpu_torch serve`` (the CLI's
                 follower), rank 0 the CLI's bring-up and the ``App`` that
                 ``serve`` runs (MESH_DP_DRIVER), each with its graphs.
                 Gates: 8 concurrent REST requests complete through
                 kernels 1-3 on both ranks and no twin; every live row's
                 pages in its replica's universe; with universe 0 held
                 full a slot-0 row takes universe 1's pages (moved in as
                 guests, the pages it writes home) and completes; on the
                 executor itself a prompt in universe 1's pages decoded
                 by slot 0 (guests) gives the stream of the same prompt
                 in universe 0's pages, and that row's first-step logits
                 (rank 0's eager forward on its pool) lie within 0.05 x
                 max |logit| of one device's forward of the same weights
                 over a pool of the prompt's pages; one verify window commits
                 plain decode's tokens; a conversation demoted to the
                 host tier is promoted bit-exact and its turn 2
                 completes; two ``hbm_info`` entries. Printed beside the
                 card: each rank's boot, the step ms at 4 rows against one
                 device's at 8, the page moves' seconds and bytes, each
                 rank's ``hbm_info``.

With ``LLMQ_LOCKDEP=1`` the port's lockdep (``analysis/lockdep.py``) is
installed after ``torch`` is imported and before the port's modules are;
at the end its counts are printed on a line of their own
(``{"lockdep": {...}}``), and any violation fails the run. Without the
variable nothing is patched.

No ``*_plain`` twin may be called while serving. On the card every
decode step, prefill program and mixed step 0 is a replay of one of the
executor's captured graphs; the launch counts add each replay's
kernels. Each engine's graphs are released before the next is built.

Exits non-zero on any failure. On success the last lines are the kernel
table as JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
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


#: Traces the profiler lost in every take, each as (what was traced,
#: what stood in for it); in the summary JSON as ``profiler_lost``.
PROFILER_LOST: list = []
_PROFILER_DOWN = [False]


def _profiled(fn, activities, complete, what: str):
    """``fn()`` under torch.profiler, then a device synchronize, taken
    again until ``complete(prof)`` holds, ten times at most (three while
    the last trace before was lost for good), the n-th retake after n x
    50 ms. The profiler now and then drops the device events of a trace,
    all of them or a few (runs of this script on the H100 saw 9 kernels
    recorded for 10 calls, and 0 for 20, and once 19 for 20 in five
    traces taken within 0.2 s, and once none in ten traces running), at
    no fixed place in the script: an incomplete trace is taken again,
    not used. Returns None when every take was incomplete; the caller
    then times ``fn`` by CUDA events (it has run at least once) and
    notes what stood in for the trace in :data:`PROFILER_LOST`."""
    import torch
    from torch.profiler import profile

    for attempt in range(3 if _PROFILER_DOWN[0] else 10):
        time.sleep(0.05 * attempt)
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        if complete(prof):
            _PROFILER_DOWN[0] = False
            return prof
        log(f"[trace] {what}: the profiler lost device events, tracing "
            f"again")
    _PROFILER_DOWN[0] = True
    log(f"[trace] {what}: the profiler lost device events in every trace; "
        f"CUDA events stand in")
    return None


def _lost(what: str, instead: str) -> None:
    PROFILER_LOST.append((what, instead))
    log(f"[trace] {what}: timed by {instead} (the profiler lost its trace)")


def _event_ms(fn, iters: int, what: str) -> float:
    """Device ms per call of ``fn(i)`` from CUDA events, where the
    profiler lost every trace of the calls: the ``iters`` calls captured
    into one CUDA graph and its replay timed (the kernels back to back,
    as in the profiler's sum, launch gaps of a graph included), or,
    where a call cannot be captured (it waits for the device: a read
    from the host, a copy from pageable memory), the eager calls timed
    (host launch gaps included). A call is tried once under
    ``set_sync_debug_mode("error")`` before any capture: a capture that
    fails part way keeps its memory pool for the rest of the process (a
    run that tried the plain twins held ~50 GB so)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(0)
        capturable = True
    except RuntimeError:
        capturable = False
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()

    def eager():
        for i in range(iters):
            fn(i)
    run, how = eager, "CUDA events over eager calls"
    if capturable:
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                eager()
            run, how = graph.replay, "CUDA events over a graph replay"
        except RuntimeError as e:
            torch.cuda.synchronize()
            how += f" (the capture failed: {str(e).splitlines()[0]})"
    run()
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    end.synchronize()
    _lost(what, how)
    return start.elapsed_time(end) / iters


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
    kernels in every trace on the H100); else it is taken again. Where
    every take was lost, :func:`_event_ms` times the calls instead."""
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
    caller = sys._getframe(1)
    what = (f"{iters} timed calls at chip_smoke.py:{caller.f_lineno} "
            f"({caller.f_code.co_name})")
    prof = _profiled(calls, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     complete, what)
    if prof is None:
        return _event_ms(fn, iters, what)
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


def _device_trace(fn, what: str = "a device trace"):
    """Run ``fn()`` under torch.profiler recording device activity only
    (host-op events of whole served steps would cost the trace more
    than the steps) and return ``(profile, span ms)``: the span from CUDA
    events around the last run. ``fn`` runs again while the trace holds
    no device time (:func:`_profiled`); the profile is None where every
    take was lost."""
    import torch
    from torch.profiler import ProfilerActivity

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run():
        start.record()
        fn()
        end.record()
    prof = _profiled(run, [ProfilerActivity.CUDA],
                     lambda p: _device_us(p) > 0, what)
    return prof, start.elapsed_time(end)


def _busy_ms(fn, what: str) -> float:
    """Device busy ms of ``fn()``: its device events' summed time from a
    device trace, or, where the profiler lost every take, the CUDA-event
    span around the last run (idle gaps inside it included)."""
    prof, span = _device_trace(fn, what)
    if prof is None:
        _lost(what, "the CUDA-event span")
        return span
    return _device_us(prof) / 1e3


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
    try:
        import transformers
        log(f"[env] transformers {transformers.__version__} imports: "
            f"serve-weights serves one request through an HFTokenizer")
    except ImportError as e:
        log(f"[env] transformers does not import ({e}): no phase uses "
            f"HFTokenizer")
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


def _count(x, digits: int = 0) -> str:
    """A count from a trace, or "not measured" where the trace was lost."""
    return "not measured" if x is None else f"{x:.{digits}f}"


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
    span_ms = start.elapsed_time(end) / steps
    if prof is None:
        # Counts the trace alone gives are not measured (None).
        _lost("a chunk", "the CUDA-event span")
        out = {"busy_ms": span_ms, "device_kernels": None,
               "span_ms": span_ms}
        if host:
            out.update(host_kernel_launches=None, host_graph_launches=None)
        return out
    launches = graphs = 0
    for e in prof.key_averages():
        if e.key in KERNEL_LAUNCH_CALLS:
            launches += e.count
        elif e.key in GRAPH_LAUNCH_CALLS:
            graphs += e.count
    out = {"busy_ms": _device_us(prof) / 1e3 / steps,
           "device_kernels": _kernel_events(prof) / steps,
           "span_ms": span_ms}
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
    seen = (graph["device_kernels"] is not None
            and eager["device_kernels"] is not None
            and graph["device_kernels"] >= 0.5 * eager["device_kernels"])
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
        f"{eager['busy_ms']:.2f} ms busy, {_count(eager['device_kernels'])} "
        f"device kernels (each a host launch); graph "
        f"{', '.join(f'{w:.2f}' for w in graph['wall_ms'])} ms wall, "
        f"{busy:.2f} ms busy{'' if seen else ' (CUDA-event span: the '
                                     'profiler shows no replayed kernels)'}, "
        f"{_count(graph['device_kernels'])} device kernels, "
        f"{_count(graph['host_kernel_launches'], 2)} host kernel launches + "
        f"{_count(graph['host_graph_launches'], 2)} graph launches "
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
            f"{_count(prof['host_graph_launches'])} graph launches, "
            f"{_count(prof['host_kernel_launches'])} host kernel launches, "
            f"{_count(prof['device_kernels'])} device kernels, "
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
    idle engine: three 16-step chunks of B=8 rows from 64 positions over
    fresh pages, every budget K. Blocking: ``decode_chunk`` three times,
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
    B, K, N = ex.spec.batch_size, ex.chunk_size, 3
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
        if prof is None:
            # Not measured: the gaps need the trace's events.
            _lost(f"{tag} {name} chunks", "nothing (gaps not measured)")
            gaps, idle_ms = None, None
        else:
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
        if r["idle_ms"] is None:
            return "not measured (the profiler lost the trace)"
        if r["gaps_ms"] is None:
            text = "chunk starts not found in the trace"
        else:
            text = ", ".join(f"{g:.3f}" for g in r["gaps_ms"]) + " ms"
        return f"{text} ({r['idle_ms']:.3f} ms idle in the profiled run)"

    blk, car = res["blocking"], res["carried"]
    log(f"[graphs] {tag} pipeline: {N} chunks of {K} steps, B={B}, tokens "
        f"equal; wall per chunk blocking {blk['wall_ms_per_chunk']:.2f} ms, "
        f"carried at depth 2 {car['wall_ms_per_chunk']:.2f} ms; device idle "
        f"between chunks blocking {gaps(blk)}, carried {gaps(car)}; "
        f"steps with no live row blocking {blk['no_live_row_steps']}, "
        f"carried {car['no_live_row_steps']} ({CARD})")


#: The graphs phase's depth: llama3-8b's widths with 12 of its 32
#: layers. The checks are the same at any depth (each layer is the same
#: kernels); the cut keeps the whole script inside its time while the
#: serve phases, which serve full depth, grow (24 until the control and
#: disaggregation phases came: a whole run then took 1027 s on a slow
#: host; 16 until serve-mesh came).
GRAPHS_LAYERS = 12


def phase_graphs(state) -> None:
    """The decode step captured into a CUDA graph on the five engines of
    the serve phases, each built with ``warmup=True`` (the step captured
    at build), at llama3-8b's widths and GRAPHS_LAYERS layers (the
    builder's ``n_layers``): llama3-8b bf16 default (fused route), the
    same engine on the split route (captured at its first replay), bf16
    ragged, int8 weights + int8 KV default and ragged (weights from seed
    0, shared by the two engines of a type). Each: eager against graph (wall and
    device busy per step, host launches against device kernels per
    step), the graph pool's bytes, greedy streams equal. The bf16
    default engine also runs three chunks carried at depth 2 against the
    same three blocking (the async pipeline's dispatch)."""
    import functools
    import gc

    import torch

    from llmq_tpu_torch.engine.builder import build_engine

    build = functools.partial(build_engine, n_layers=GRAPHS_LAYERS)
    state["graphs"] = {"layers": GRAPHS_LAYERS}
    for q8 in (False, True):
        cfg = _serve_cfg()
        if q8:
            cfg.model.quantization = cfg.model.kv_quantization = "int8"
        kind = "int8" if q8 else "bf16"
        engine = build(cfg, warmup=True)
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
        engine = build(cfg, params=params, warmup=True)
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
        params = _serve_default(state)
        if {"serve-spec", "serve-tiering", "serve-disagg",
                "serve-scenarios"} & set(state.get("chosen", ())):
            # The serve-spec, serve-tiering, serve-disagg and
            # serve-scenarios phases build their engines on these weights
            # (the last of them releases them).
            state["serve_params"] = params
        _serve_ragged(state, params)
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
        if {"serve-tenancy", "serve-plane", "serve-control",
                "serve-cluster"} & set(state.get("chosen", ())):
            # The serve-tenancy, serve-plane, serve-control and
            # serve-cluster phases serve on this engine: its graphs stay
            # captured.
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
        return wall, _busy_ms(fn, f"{tag} mixed against unfused")

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
    busy = {n: _busy_ms(f, f"{tag} {n} of four prompts")
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
    prog_ms = _busy_ms(lambda: ex.gather_scalars(ex._prefill_wave(reqs, 1)),
                       f"{tag} int8 prefill_b{T}")
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
    prof, span_ms = _device_trace(lambda: ex.decode_chunk(*args),
                                  f"{tag} decode chunk")
    engine.allocator.free(pages)
    if prof is None:
        # The kernel breakdown is not measured; the span stands in for
        # the busy time.
        _lost(f"{tag} decode chunk", "the CUDA-event span")
        rows, busy_ms, n_kernels = [], span_ms / K, None
    else:
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
        f"({100 * busy_ms / wall_ms:.0f}% busy), {_count(n_kernels)} kernel "
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
    PLANE_HEARTBEAT_S heartbeat timeout checked every 0.5 s; and
    ``configs/config.yaml``'s load-balancer strategy (``adaptive_load``,
    not the dataclass's ``round_robin``)."""
    cfg = _serve_cfg()
    cfg.loadbalancer.strategy = "adaptive_load"
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
    """Eight REST requests decoding at async depth 2, then the chaos
    plane's ``engine.step`` rule (kind crash, times 1), armed once a chunk
    is in flight, kills the engine loop with that chunk unreconciled (the
    recovery must find at least one). The supervisor must restart it once; each message must fail
    over, retry through the delayed queue and complete exactly once; the
    dead-letter queue stays as it was; the restarted loop replays the
    captured graphs (replays grow) and captures none. The invariant
    checker watches the eight messages (none lost, none completed twice)
    and every attempt's token stream (a prefix of that attempt's result:
    no token of the dead chunks reaches a stream). Then a batch of eight
    under an ``engine.hbm_alloc`` rule (kind error, probability 0.3):
    every message completes and the chaos counter shows the faults."""
    from llmq_tpu_torch import chaos
    from llmq_tpu_torch.core.config import ChaosConfig

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
    mgr = app.factory.get_queue_manager("standard")
    checker = chaos.InvariantChecker()
    attempts = {}       # message id -> [(stream key, handle)]
    submit = engine.submit

    def watched_submit(req, *, on_token=None):
        runs = attempts.get(req.id)
        if runs is None or on_token is not None:
            return submit(req, on_token=on_token)
        key = f"{req.id}#{len(runs)}"
        h = submit(req, on_token=checker.on_token(key))
        runs.append((key, h))
        return h

    complete = mgr.complete_message
    at_crash = []          # chunks in flight when the loop died
    recover = engine.recover_after_crash

    def watched_recover():
        at_crash.append(len(engine._inflight))
        return recover()

    def watched_complete(m, *a, **kw):
        if m.id in attempts:
            checker.completed(m.id)
        return complete(m, *a, **kw)

    def worker_sum(key):
        return sum(w.stats.to_dict()[key] for w in app.workers)

    def batch(tag, new_tokens):
        # The ids are the smoke's own, registered before the posts: a
        # worker may submit a message before its post returns.
        ids = [f"{tag.split()[0]}-{i}-{time.time_ns()}" for i in range(8)]
        for m in ids:
            attempts[m] = []
            checker.submitted(m)
        mids = [_post(base, {"id": m, "content": f"{i} {tag}: describe a "
                                                f"queue in a few words.",
                             "priority": "normal",
                             "metadata": {"max_new_tokens": new_tokens}})
                for i, m in enumerate(ids)]
        if mids != ids:
            raise AssertionError(f"posted ids {mids} != {ids}")
        return mids

    ok0, retried0 = worker_sum("succeeded"), worker_sum("retried")
    engine.submit = watched_submit
    engine.recover_after_crash = watched_recover
    mgr.complete_message = watched_complete
    try:
        _until(lambda: _idle(engine), 120, "idle engine before the crash")
        # 128 tokens each: the eight decode together long enough for the
        # crash to land while all of them are in flight.
        mids = batch("crash check", 128)
        # Armed once a chunk is in flight: every step of a decoding batch
        # ends with one dispatched, so the crash at the next step's top
        # lands with it unreconciled (gated below).
        _until(lambda: _decoding_rows(engine) >= 8
               and len(engine._inflight) >= 1, 120,
               "eight requests decoding with a chunk in flight")
        replays0 = ex.graph_replays
        inj = chaos.configure(ChaosConfig(enabled=True, seed=16))
        t_crash = time.perf_counter()
        inj.add_rule("engine.step", kind="crash", times=1)
        done = [_poll(base, m) for m in mids]
        recover_s = time.perf_counter() - t_crash
        _until(lambda: worker_sum("succeeded") - ok0 >= 8, 60,
               "the workers' completions")
        time.sleep(0.2)        # a duplicate completion would land here
        fired = dict(inj.get_stats()["injected"])
        # The allocation faults: a batch of eight while each page
        # allocation fails with probability 0.3, as an exhausted pool
        # would.
        before, _ms = _scrape(base)
        inj = chaos.configure(ChaosConfig(enabled=True, seed=17))
        inj.add_rule("engine.hbm_alloc", kind="error", probability=0.3)
        t_alloc = time.perf_counter()
        alloc_mids = batch("allocation check", 64)
        alloc_done = [_poll(base, m) for m in alloc_mids]
        alloc_s = time.perf_counter() - t_alloc
        alloc_fired = dict(inj.get_stats()["injected"])
        chaos.configure(None)
        after, _ms = _scrape(base)
        _until(lambda: worker_sum("succeeded") - ok0 >= 16, 60,
               "the allocation batch's completions")
        time.sleep(0.2)
    finally:
        chaos.configure(None)
        engine.__dict__.pop("submit", None)
        engine.__dict__.pop("recover_after_crash", None)
        mgr.__dict__.pop("complete_message", None)
        ex.__dict__.pop("_capture", None)
    bad = [m for m in done if m["status"] != "completed"
           or m["retry_count"] < 1]
    if (sup.restarts != restarts0 + 1 or bad
            or fired != {"engine.step:crash": 1}):
        raise AssertionError(f"crash: restarts {sup.restarts - restarts0}, "
                             f"injected {fired}, messages {bad or done}")
    if len(at_crash) != 1 or at_crash[0] < 1:
        raise AssertionError(f"crash: chunks in flight when the loop died "
                             f"{at_crash}, want one recovery with at least "
                             f"one")
    if worker_sum("succeeded") - ok0 != 16 or dlq.size() != dlq0:
        raise AssertionError(f"crash: {worker_sum('succeeded') - ok0} "
                             f"completions for 16 messages, dead letters "
                             f"{dlq0} -> {dlq.size()}")
    now = {**{("step", k): id(g) for k, g in ex.step_graphs.items()},
           **{k: id(g) for k, g in ex.program_graphs.items()}}
    if captures or now != graphs or ex.graph_replays <= replays0:
        raise AssertionError(f"crash: {len(captures)} captures after the "
                             f"restart, graphs {len(graphs)} -> {len(now)}, "
                             f"replays {replays0} -> {ex.graph_replays}")
    streamed = 0
    for runs in attempts.values():
        for key, h in runs:
            h.wait(60)
            checker.completed(key, tokens=h.result.tokens)
            streamed += len(checker._streams.get(key, ()))
    failed_runs = sum(1 for m in mids for _k, h in attempts[m]
                      if h.result.finish_reason == "error")
    # The attempts' records (keys "<id>#<n>") carry their results for
    # the stream check only: loss and duplicates are checked on the
    # submitted message ids, whose terminals are the manager's.
    violations = checker.violations()
    if violations or failed_runs != 8 or streamed <= 0:
        raise AssertionError(f"crash invariants: {violations}, "
                             f"{failed_runs} failed first attempts, "
                             f"{streamed} tokens streamed")
    bad = [m for m in alloc_done if m["status"] != "completed"]
    inc = (_msum(after, "llm_queue_chaos_injected_total",
                 point="engine.hbm_alloc", kind="error")
           - _msum(before, "llm_queue_chaos_injected_total",
                   point="engine.hbm_alloc", kind="error"))
    n_alloc = alloc_fired.get("engine.hbm_alloc:error", 0)
    if bad or n_alloc <= 0 or inc != n_alloc:
        raise AssertionError(f"hbm_alloc: {len(bad)} not completed, "
                             f"{n_alloc} faults, /metrics +{inc}")
    samples = {dict(lb)["point"] + ":" + dict(lb)["kind"]: v
               for (n, lb), v in after.items()
               if n == "llm_queue_chaos_injected_total"}
    log(f"[serve-plane] chaos engine.step crash with 8 requests decoding "
        f"({at_crash} chunks in flight when the loop died): supervisor "
        f"restarts "
        f"{sup.restarts - restarts0}, recovered {sup.recovered_total}; all "
        f"8 completed once after {[m['retry_count'] for m in done]} "
        f"retries, crash to all completed {recover_s:.2f} s; invariants: 0 "
        f"lost, 0 duplicated, {streamed} streamed tokens over "
        f"{sum(len(r) for r in attempts.values())} attempts all prefixes "
        f"of their results; graph replays {replays0} -> "
        f"{ex.graph_replays}, captures 0 ({len(now)} graphs kept); retries "
        f"{worker_sum('retried') - retried0}; dead letters {dlq.size()} "
        f"({CARD})")
    log(f"[serve-plane] chaos engine.hbm_alloc p=0.3: {n_alloc} faults, 8 "
        f"of 8 completed in {alloc_s:.2f} s; chaos_injected_total "
        f"samples {samples}")
    return {"crash_to_completed_s": recover_s,
            "restarts": sup.restarts - restarts0,
            "retry_counts": [m["retry_count"] for m in done],
            "chunks_in_flight_at_crash": at_crash,
            "streamed_tokens": streamed,
            "graph_replays_after": ex.graph_replays - replays0,
            "hbm_alloc_faults": n_alloc, "hbm_alloc_batch_s": alloc_s,
            "chaos_injected_total": samples}


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
    device-wide wait: only the last chunk's own event is waited on.
    Returns ``(gaps, late)``: ``late[i]`` is whether the chunk before
    boundary ``i`` had already ended on the card when the host finished
    dispatching the next one (the host, not the card, left it idle)."""
    ex = engine.executor
    handles, late = [], []
    real = ex.decode_chunk_start

    def recording(*args, **kwargs):
        h = real(*args, **kwargs)
        if handles:
            late.append(handles[-1]._done.query())
        handles.append(h)
        return h

    ex.decode_chunk_start = recording
    try:
        _until(lambda: len(handles) > n, 60, f"{n + 1} chunks")
    finally:
        ex.__dict__.pop("decode_chunk_start", None)
    hs = handles[:n + 1]
    hs[-1].wait_ready()
    return ([a._done.elapsed_time(b._start) for a, b in zip(hs, hs[1:])],
            late[:n])


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
        gaps, late = _event_chunk_gaps(engine, 4)
        depth = {d: n - depth0[d] for d, n in
                 engine.pipeline_depth_hist.items() if n != depth0[d]}
        if max(gaps) >= 0.1 or not depth.get(2):
            raise AssertionError(f"engine chunk boundaries idle {gaps} ms "
                                 f"(want each < 0.1 ms), dispatches by "
                                 f"depth {depth}, the chunk before already "
                                 f"ended at the dispatch's end {late}")
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
        f"chunks, by their CUDA events; dispatched after the chunk before "
        f"had ended: {sum(late)} of {len(late)} ({CARD})")
    return {"rate_telemetry": rate_tel, "rate_counted": rate_me,
            "mfu_pct": mfu_g, "overlap_ratio": overlap,
            "hbm_weights_bytes": w, "hbm_kv_pool_bytes": kv,
            "hbm_free_bytes": free_g, "hbm_limit_bytes": limit_g,
            "rtt_ms": tel.rtt_ms, "scrape_ms": scrape_ms,
            "step_legs": legs, "window_overlap_ratio": window_overlap,
            "per_step_device_ms": per_step,
            "profile": prof, "chunk_gaps_ms": gaps, "chunk_gaps_late": late,
            "depth": depth}


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
        if {"serve-control", "serve-cluster", "serve-split"} & set(
                state.get("chosen", ())):
            # The serve-control and serve-cluster phases serve on this
            # engine, and the serve-split phase measures the WAL's cost on
            # it: its graphs stay captured.
            state["serve_engine"] = engine
        else:
            engine.executor.release_graphs()
    if counts:
        raise AssertionError(f"serve-plane called plain twins: {counts}")

# -- serve-cluster: the replica set -------------------------------------------

#: The serve-cluster phase: requests of gate a, their new tokens; the
#: requests held on the peer at its kill and theirs (long enough that all
#: eight decode there when it dies); requests through the gateway child.
CLUSTER_REQUESTS = 16
CLUSTER_NEW_TOKENS = 32
CLUSTER_KILL_ROWS = 8
CLUSTER_KILL_NEW = 256
CLUSTER_GATEWAY_REQUESTS = 8
#: The rate lines' batch: 8 concurrent requests of 64 new tokens.
CLUSTER_RATE_ROWS = 8
CLUSTER_RATE_NEW = 64
#: Seconds the peer may take to answer /health with its engine running.
CLUSTER_BOOT_S = 600.0
#: The transport's probe timeout (``HttpEngineClient``'s default): the
#: overview with a dead replica must answer within it plus this margin.
CLUSTER_PROBE_S = 2.0
CLUSTER_OVERVIEW_MARGIN_S = 1.0


def _cluster_config_files(work: str, peer_url: str):
    """Two files: the peer's (``configs/config.yaml`` with serve-plane's
    overrides) and the parent's (the same with ``cluster.peers: [peer]``).
    Both carry the phase's own overrides: ``scheduler.min_endpoints: 2``,
    since at the JAX package's defaults the autoscaler removes one of two
    endpoints on its first tick (about 10 s after start), and
    ``loadbalancer.strategy: round_robin``, since the file's
    ``adaptive_load`` scores the in-process replica's response time
    against the HTTP hop's and sends the peer only its exploration share
    (one pick in ten), which a 16-request gate could miss. Returns the
    parent's config (as ``load_config`` reads it) and both paths."""
    import yaml

    from llmq_tpu_torch.core.config import load_config

    cfg0, plane_path = _plane_config_file()
    with open(plane_path) as f:
        data = yaml.safe_load(f)
    data["scheduler"]["min_endpoints"] = 2
    data["loadbalancer"]["strategy"] = "round_robin"
    data["cluster"]["peers"] = []
    peer_path = os.path.join(work, "cluster_peer.yaml")
    with open(peer_path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    data["cluster"]["peers"] = [peer_url]
    data["cluster"]["include_local"] = True
    path = os.path.join(work, "cluster_parent.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    cfg = load_config(path, env=False)
    if (cfg.cluster.peers != [peer_url] or cfg.scheduler.min_endpoints != 2
            or cfg.loadbalancer.strategy != "round_robin"
            or cfg.model != cfg0.model or cfg.executor != cfg0.executor):
        raise AssertionError("the cluster config file did not load to the "
                             "phase's settings")
    return cfg, path, peer_path


def _free_tcp_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cluster_child(work: str, role: str, args, port: int) -> _Child:
    """``python -m llmq_tpu_torch <role>`` after SPLIT_PRELUDE, on
    127.0.0.1:``port``."""
    env = {k: v for k, v in os.environ.items() if k != "LLMQ_CONFIG"}
    return _Child(work, role, 1, [*args, "--host", "127.0.0.1", "--port",
                                  str(port)], env)


def _wait_engine(url: str, child: _Child, timeout: float) -> float:
    """Seconds from the child's start until its /health reads its engine
    running (a gateway: until /health answers)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if child.p.poll() is not None:
            break
        try:
            _, h = _http("GET", f"{url}/health")
            if child.role == "gateway" or h.get("engine") == "running":
                return time.time() - child.started
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"{child.role} never came up (exit "
                         f"{child.p.poll()}):\n" + "\n".join(
                             child.lines()[-40:]))


def _cluster_post(base, n: int, new: int, tag: str, tiers=None):
    """POST ``n`` messages (the four tiers in turn, or ``tiers``), each
    with an id known before its POST; returns the ids."""
    tiers = tiers or SPLIT_TIERS
    ids = []
    for i in range(n):
        mid = f"{tag}-{i}"
        _post(base, {"id": mid, "content": f"{tag} {i}: route this message "
                     f"to a replica and answer it.",
                     "priority": tiers[i % len(tiers)],
                     "metadata": {"max_new_tokens": new}})
        ids.append(mid)
    return ids


def _ttft(base, mid):
    """A request's TTFT by its trace (enqueued → first_token), ms, or
    "not measured"."""
    _, tl = _http("GET", f"{base}/api/v1/requests/{mid}/trace")
    return tl["stage_latencies_ms"].get("ttft", "not measured")


def _cluster_rate(base, tag: str) -> float:
    """Tokens per second of CLUSTER_RATE_ROWS concurrent requests through
    the router, first post to last completion."""
    t0 = time.perf_counter()
    ids = _cluster_post(base, CLUSTER_RATE_ROWS, CLUSTER_RATE_NEW, tag,
                        tiers=("high",))
    done = [_poll(base, mid) for mid in ids]
    wall = time.perf_counter() - t0
    return _check_completed(done, tag) / wall


def _cluster_traffic(app, engine, base, peer_id, local_id, out) -> None:
    """Gates a, f and b; the hop and the rate lines."""
    from llmq_tpu_torch.core.types import Message
    from llmq_tpu_torch.loadbalancer.transport import HttpEngineClient
    from llmq_tpu_torch.observability import trace_id_for

    # a. 16 requests across the four tiers complete, on both replicas.
    ids = _cluster_post(base, CLUSTER_REQUESTS, CLUSTER_NEW_TOKENS, "ca")
    done = [_poll(base, mid) for mid in ids]
    _check_completed(done, "serve-cluster a")
    by_ep = {}
    for m in done:
        eid = m["metadata"].get("endpoint_id")
        by_ep[eid] = by_ep.get(eid, 0) + 1
    if set(by_ep) != {local_id, peer_id}:
        raise AssertionError(f"a. dispatches by endpoint {by_ep}")
    out["a_dispatch_by_endpoint"] = by_ep
    log(f"[serve-cluster] a. {CLUSTER_REQUESTS} requests over four tiers "
        f"completed; dispatched by endpoint {by_ep}")

    # f. A peer-served request's trace here holds the peer's engine
    # stages under the same trace id.
    mid = next(m["id"] for m in done
               if m["metadata"]["endpoint_id"] == peer_id)
    _, tl = _http("GET", f"{base}/api/v1/requests/{mid}/trace")
    here = next(e["host"] for e in tl["events"] if e["stage"] == "enqueued")
    remote = {e["stage"] for e in tl["events"] if e["host"] != here}
    tp = [e["meta"].get("traceparent", "") for e in tl["events"]
          if e["host"] != here and e["stage"] == "dispatched"]
    if (not {"admitted", "prefill_start", "first_token"} <= remote
            or tl["trace_id"] != trace_id_for(mid) or len(tl["hosts"]) < 2
            or not tp or not tp[0].startswith(f"00-{tl['trace_id']}-")):
        raise AssertionError(f"f. the peer's stages were not stitched in: "
                             f"{tl}")
    out["f_remote_stages"] = sorted(remote)
    log(f"[serve-cluster] f. {mid} (served by the peer): the local trace "
        f"{tl['trace_id']} holds the peer's stages {sorted(remote)} from "
        f"{len(tl['hosts'])} hosts")

    # b. Affinity, drain and spill.
    status, c = _http("POST", f"{base}/api/v1/conversations",
                      {"user_id": "cluster"})
    cid = c["conversation_id"]
    turns = []
    for i, text in enumerate(("Tell me how a replica set routes turns.",
                              " And when the replica drains?",
                              " And after it comes back?")):
        if i == 2:
            home = turns[0]["metadata"]["endpoint_id"]
            status, r = _http("POST", f"{base}/api/v1/endpoints/{home}/drain")
            if status != 200 or r["status"] != "draining":
                raise AssertionError(f"b. drain of {home}: {status} {r}")
        status, r = _http("POST", f"{base}/api/v1/conversations/{cid}/"
                                  f"messages",
                          {"content": text, "priority": "high",
                           "timeout": MESSAGE_TIMEOUT_S,
                           "metadata": {"max_new_tokens": 16}})
        turns.append(_poll(base, r["message_id"]))
    _check_completed(turns, "serve-cluster b")
    eps = [t["metadata"]["endpoint_id"] for t in turns]
    cached = [t["metadata"]["usage"]["cached_tokens"] for t in turns]
    stats = app.cluster_router.get_stats()
    if eps[1] != eps[0] or cached[1] <= 0 or eps[2] == eps[0] \
            or stats["affinity_hit_rate"] <= 0 or stats["spills"] < 1:
        raise AssertionError(f"b. turns on {eps}, cached {cached}, stats "
                             f"{stats}")
    status, r = _http("POST", f"{base}/api/v1/endpoints/{eps[0]}/drain",
                      {"drain": False})
    readmitted = app.load_balancer.get_endpoint_by_id(eps[0]).status.value
    if status != 200 or readmitted not in ("degraded", "healthy"):
        raise AssertionError(f"b. undrain: {status} {r} {readmitted}")
    ttfts = [_ttft(base, t["id"]) for t in turns]
    out["b"] = {"endpoints": eps, "cached_tokens": cached,
                "ttft_ms": ttfts, "affinity_hit_rate":
                stats["affinity_hit_rate"], "spills": stats["spills"]}
    log(f"[serve-cluster] b. turns on {eps} (cached {cached}); affinity "
        f"hit rate {stats['affinity_hit_rate']}; turn 3 spilled from the "
        f"drained {eps[0]}; undrain readmits it ({readmitted}). Turn-2 TTFT "
        f"on the affine replica {ttfts[1]} ms, the spilled turn 3's "
        f"{ttfts[2]} ms ({CARD})")

    # Printed: a generate hop's added ms, in turns (local, peer, ...).
    peer_client = HttpEngineClient(app.load_balancer.get_endpoint_by_id(
        peer_id).url)
    local_ms, peer_ms = [], []
    for i in range(3):
        for where, fn, acc in (("local", engine.process_fn, local_ms),
                               ("peer", peer_client.process_fn, peer_ms)):
            msg = Message(id=f"hop-{where}-{i}", content="Route this: one "
                          "hop or none?", metadata={"max_new_tokens": 8})
            t0 = time.perf_counter()
            fn(None, msg)
            acc.append((time.perf_counter() - t0) * 1e3)
    hop = {"local_ms": sorted(local_ms)[1], "peer_ms": sorted(peer_ms)[1]}
    hop["added_ms"] = hop["peer_ms"] - hop["local_ms"]
    out["hop"] = hop
    log(f"[serve-cluster] a generate of 8 tokens in process "
        f"{hop['local_ms']:.2f} ms, through the peer over HTTP "
        f"{hop['peer_ms']:.2f} ms (median of 3): the hop adds "
        f"{hop['added_ms']:.2f} ms ({CARD})")

    # Printed: 8 concurrent requests' tok/s on two replicas, then one
    # (the peer drained), then two again.
    two = _cluster_rate(base, "rate2")
    app.cluster_router.drain_endpoint(peer_id)
    one = _cluster_rate(base, "rate1")
    app.cluster_router.undrain_endpoint(peer_id)
    two_b = _cluster_rate(base, "rate2b")
    out["rate_tok_s"] = {"two": [two, two_b], "one": one}
    log(f"[serve-cluster] {CLUSTER_RATE_ROWS} concurrent requests of "
        f"{CLUSTER_RATE_NEW} tokens through the router: {two:.1f} and "
        f"{two_b:.1f} tok/s on two replicas, {one:.1f} on one (the two "
        f"replicas share the card's SMs) ({CARD})")


def _cluster_gateway(work, base, peer_url, out) -> _Child:
    """g. A ``gateway --peers <parent>,<peer>`` child completes
    CLUSTER_GATEWAY_REQUESTS; returned for its status at the end."""
    port = _free_tcp_port()
    gw = _cluster_child(work, "gateway", [
        "--config", os.path.join(work, "cluster_peer.yaml"),
        "--peers", f"{base},{peer_url}"], port)
    gw_url = f"http://127.0.0.1:{port}"
    boot = _wait_engine(gw_url, gw, 120)
    ids = _cluster_post(gw_url, CLUSTER_GATEWAY_REQUESTS,
                        CLUSTER_NEW_TOKENS, "cg")
    done = [_poll(gw_url, mid) for mid in ids]
    _check_completed(done, "serve-cluster g")
    eps = sorted({m["metadata"]["endpoint_id"] for m in done})
    _, st = _http("GET", f"{gw_url}/api/v1/cluster/stats")
    if len(eps) != 2 or st["dispatches"] != CLUSTER_GATEWAY_REQUESTS:
        raise AssertionError(f"g. the gateway dispatched to {eps}: {st}")
    out["g"] = {"endpoints": eps, "boot_s": boot}
    log(f"[serve-cluster] g. a gateway --peers (up in {boot:.1f} s) "
        f"completed {CLUSTER_GATEWAY_REQUESTS} requests on {eps}")
    return gw


def _cluster_kill(app, engine, base, peer, peer_id, local_id, out):
    """c. and d.: the overview, then the peer SIGKILLed with
    CLUSTER_KILL_ROWS requests decoding there."""
    import signal

    from llmq_tpu_torch.chaos import InvariantChecker

    # d. The overview lists both replicas with a device block.
    _, ov = _http("GET", f"{base}/api/v1/cluster/overview")
    if ov["aggregate"]["reporting"] != 2 or {r["id"] for r in
                                            ov["replicas"]} != {local_id,
                                                                peer_id}:
        raise AssertionError(f"d. the overview before the kill: {ov}")
    checker = InvariantChecker()
    mgr = app.factory.get_queue_manager("standard")
    orig = mgr.complete_message

    def complete(m, *a, **kw):
        checker.completed(m.id)
        return orig(m, *a, **kw)

    mgr.complete_message = complete
    try:
        # The local replica drains, so every new dispatch goes to the peer.
        status, _r = _http("POST", f"{base}/api/v1/endpoints/{local_id}/"
                                   f"drain")
        ids = []
        for i in range(CLUSTER_KILL_ROWS):
            mid = f"ck-{i}"
            checker.submitted(mid)
            _post(base, {"id": mid, "content": f"kill {i}: decode on the "
                         f"peer until it dies.",
                         "metadata": {"max_new_tokens": CLUSTER_KILL_NEW}})
            ids.append(mid)
        _until(lambda: (peer.status() or {}).get("decoding", 0)
               >= CLUSTER_KILL_ROWS, 300,
               f"{CLUSTER_KILL_ROWS} rows decoding on the peer", poll=0.01)
        _http("POST", f"{base}/api/v1/endpoints/{local_id}/drain",
              {"drain": False})
        peer_status = peer.status()
        t_kill = time.perf_counter()
        peer.stop(signal.SIGKILL)
        done = [_poll(base, mid) for mid in ids]
        kill_to_last = time.perf_counter() - t_kill
    finally:
        mgr.complete_message = orig
    _check_completed(done, "serve-cluster c")
    on = {m["metadata"]["endpoint_id"] for m in done}
    checker.check()
    s = checker.summary()
    stats = app.cluster_router.get_stats()
    breaker = stats["breakers"].get(peer_id, {})
    if on != {local_id} or s["terminal"].get("completed") != \
            CLUSTER_KILL_ROWS or breaker.get("state") != "open" \
            or stats["failovers"] < 1:
        raise AssertionError(f"c. after the kill: on {on}, {s}, {stats}")
    out["c"] = {"kill_to_last_s": kill_to_last,
                "failovers": stats["failovers"],
                "breaker": breaker}
    log(f"[serve-cluster] c. the peer SIGKILLed with "
        f"{peer_status['decoding']} rows decoding: all "
        f"{CLUSTER_KILL_ROWS} completed on {local_id} "
        f"{kill_to_last:.2f} s after the kill, none lost or duplicated; "
        f"{stats['failovers']} failovers; the peer's breaker "
        f"{breaker.get('state')} after {breaker.get('trips')} trip(s) "
        f"({CARD})")

    # d. After the kill: the dead replica is an error entry, in time.
    t0 = time.perf_counter()
    _, ov = _http("GET", f"{base}/api/v1/cluster/overview")
    took = time.perf_counter() - t0
    dead = next(r for r in ov["replicas"] if r["id"] == peer_id)
    if "error" not in dead or took > CLUSTER_PROBE_S + \
            CLUSTER_OVERVIEW_MARGIN_S or ov["aggregate"]["reporting"] != 1:
        raise AssertionError(f"d. the overview after the kill ({took:.2f} "
                             f"s): {ov}")
    out["d"] = {"overview_after_kill_s": took, "error": dead["error"]}
    log(f"[serve-cluster] d. the overview listed both replicas with a "
        f"device block before the kill; after it the dead one is "
        f"{dead['error']!r}, answered in {took:.3f} s")
    return peer_status


def _cluster_metrics(app, base, before, out) -> None:
    """e. ``/metrics``' cluster and breaker families against the router's
    counts (deltas over the phase: the registry is the process's)."""
    def scrape_deltas():
        now, _ms = _scrape(base)
        return {k: v - before.get(k, 0.0) for k, v in now.items()}, now

    stats = app.cluster_router.get_stats()
    d, now = scrape_deltas()
    lb_counts = {}
    for e in app.load_balancer.endpoints():
        lb_counts[e.status.value] = lb_counts.get(e.status.value, 0) + 1
    ends = {s: _msum(now, "llm_queue_cluster_endpoints", status=s)
            for s in ("healthy", "degraded", "unhealthy", "draining")}
    if {k: v for k, v in ends.items() if v} != {
            k: float(v) for k, v in lb_counts.items()}:
        # A health tick may have moved a status after the last dispatch,
        # which is when the gauge is set: one more dispatch sets it.
        _check_completed([_poll(base, mid) for mid in _cluster_post(
            base, 1, 4, "ce")], "serve-cluster e")
        stats = app.cluster_router.get_stats()
        d, now = scrape_deltas()
        lb_counts = {}
        for e in app.load_balancer.endpoints():
            lb_counts[e.status.value] = lb_counts.get(e.status.value, 0) + 1
        ends = {s: _msum(now, "llm_queue_cluster_endpoints", status=s)
                for s in ("healthy", "degraded", "unhealthy", "draining")}
    got = {
        "dispatch": _msum(d, "llm_queue_cluster_dispatch_total"),
        "failovers": _msum(d, "llm_queue_cluster_failovers_total"),
        "hit_rate": _msum(now, "llm_queue_cluster_affinity_hit_rate"),
        "endpoints": {k: v for k, v in ends.items() if v}}
    want = {"dispatch": float(stats["dispatches"]),
            "failovers": float(stats["failovers"]),
            "hit_rate": stats["affinity_hit_rate"],
            "endpoints": {k: float(v) for k, v in lb_counts.items()}}
    if abs(got["hit_rate"] - want["hit_rate"]) < 1e-4:
        got["hit_rate"] = want["hit_rate"]      # get_stats rounds to 4
    drains = _msum(d, "llm_queue_cluster_drains_total")
    for eid, br in stats["breakers"].items():
        from llmq_tpu_torch.loadbalancer.circuit_breaker import (
            STATE_VALUE, BreakerState)
        got[f"state {eid}"] = _msum(now, "llm_queue_circuit_breaker_state",
                                    endpoint=eid)
        want[f"state {eid}"] = float(STATE_VALUE[BreakerState(br["state"])])
        got[f"trips {eid}"] = _msum(d, "llm_queue_circuit_breaker_trips_total",
                                    endpoint=eid)
        want[f"trips {eid}"] = float(br["trips"])
    if got != want or drains != out["drains"]:
        raise AssertionError(f"e. /metrics {got} (drains {drains}) vs the "
                             f"router's {want} (drains {out['drains']})")
    out["e"] = got
    log(f"[serve-cluster] e. /metrics cluster_* and circuit_breaker_* equal "
        f"the router's counts: {got}, drains {drains:.0f}")


def _cluster_kernels(engine_launches, peer_status, gw) -> dict:
    """h. Kernels 1-3 launched in both serving processes, no twin in
    either; the gateway never initialised CUDA."""
    import signal

    launches = {"parent": {k: v for k, v in engine_launches.items() if v},
                "peer": {k: v for k, v in peer_status["launches"].items()
                         if v}}
    for who, got in launches.items():
        for name in ("fused_decode", "kv_prefill_write", "prefill_attention"):
            if got.get(name, 0) <= 0:
                raise AssertionError(f"h. the {who} never launched {name}: "
                                     f"{got}")
    if peer_status["plain"]:
        raise AssertionError(f"h. the peer called plain twins: "
                             f"{peer_status['plain']}")
    gw.stop(signal.SIGTERM)
    st = gw.status()
    if st is None or st["plain"] or st["cuda_initialized"] or any(
            st["launches"].values()):
        raise AssertionError(f"g. the gateway touched the card: {st}")
    log(f"[serve-cluster] h. launches while serving: parent "
        f"{launches['parent']}, peer {launches['peer']}; no twin called in "
        f"either; g. the gateway never initialised CUDA")
    return launches


def phase_serve_cluster(state) -> None:
    """The replica set on the card: the serve phase's bf16 engine behind
    the full ``App`` in serve mode with ``cluster.peers: [peer]``, the
    peer a ``python -m llmq_tpu_torch serve`` child on the same card
    (llama3-8b at full width and depth, random weights from seed 0)."""
    import gc
    import shutil

    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.ops import kernels
    from llmq_tpu_torch.ops.kernels import BUILD_DIR

    engine = state.pop("serve_engine", None)
    if engine is None:
        raise AssertionError("serve-cluster serves on the serve phase's "
                             "engine: run serve before it")

    work = str(BUILD_DIR / "serve_cluster")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = state.setdefault("serve_cluster", {"drains": 0.0})
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[serve-cluster] {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated here, {free / 2**30:.1f} GiB free of "
        f"{total / 2**30:.1f} GiB before the peer builds its engine")
    peer_port = _free_tcp_port()
    peer_url = f"http://127.0.0.1:{peer_port}"
    cfg, path, peer_path = _cluster_config_files(work, peer_url)
    peer = _cluster_child(work, "serve", ["--config", peer_path], peer_port)
    counts, restore = _count_plain_calls()
    app = gw = None
    failed = True
    try:
        boot = _wait_engine(peer_url, peer, CLUSTER_BOOT_S)
        _, h = _http("GET", f"{peer_url}/health")
        out["peer_boot_s"] = boot
        log(f"[serve-cluster] the peer serve process is up in {boot:.1f} s "
            f"(boot stages {(h.get('boot') or {}).get('stages_s')}) "
            f"({CARD})")
        app = App(cfg, engine=engine, with_scheduler=True)
        router = app.cluster_router
        local_id = router.get_stats()["local_endpoint_id"]
        peer_id = f"127.0.0.1:{peer_port}"
        if {e.id for e in app.load_balancer.endpoints()} != {local_id,
                                                            peer_id}:
            raise AssertionError(f"the router holds "
                                 f"{app.load_balancer.get_stats()}")
        base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
        before, _ms = _scrape(base)
        kernels.reset_launches()
        _cluster_traffic(app, engine, base, peer_id, local_id, out)
        # Drains so far: b's drain and undrain (the route), the rate
        # lines' (the router): each drain counts one.
        out["drains"] = 2.0
        gw = _cluster_gateway(work, base, peer_url, out)
        peer_status = _cluster_kill(app, engine, base, peer, peer_id,
                                    local_id, out)
        out["drains"] += 1.0
        torch.cuda.synchronize()
        engine_launches = dict(kernels.LAUNCHES)
        _cluster_metrics(app, base, before, out)
        out["launches"] = _cluster_kernels(engine_launches, peer_status, gw)
        gw = None
        if counts:
            raise AssertionError(f"h. the parent called plain twins: "
                                 f"{counts}")
        failed = False
    finally:
        restore()
        if app is not None:
            app.stop()
        for child in (peer, gw):
            if child is not None and child.p.poll() is None:
                child.p.kill()
                child.p.wait(30)
        if failed:
            for child in (peer, gw):
                if child is not None:
                    print(f"--- {child.role} log (last 40 lines) ---\n"
                          + "\n".join(child.lines()[-40:]), file=sys.stderr)
        if "serve-split" in state.get("chosen", ()):
            # serve-split measures the WAL's cost on this engine.
            state["serve_engine"] = engine
        else:
            engine.executor.release_graphs()
    log(f"[serve-cluster] {time.perf_counter() - t0:.1f} s ({CARD})")


#: The serve-split phase: requests a batch, their new tokens, the
#: range of their prompt lengths (tokens), and the queue cores' backlog
#: (configs/config.yaml's max_queue_size over the four tiers).
SPLIT_REQUESTS = 16
SPLIT_NEW_TOKENS = 64
#: New tokens of the requests in flight at a kill or a stop: long enough
#: that eight rows decode at once and are still decoding then.
SPLIT_HELD_NEW_TOKENS = 256
SPLIT_PROMPT_RANGE = (40, 600)
SPLIT_BACKLOG = 10_000
SPLIT_PAIRS = 20_000
#: Seconds a child may take to say it serves (the queue-manager builds and
#: warms up an 8B engine).
SPLIT_BOOT_S = 600.0
#: The spool consumer's claim TTL (the JAX package's SpoolConsumer
#: default, which its queue-manager uses).
SPOOL_CLAIM_TTL_S = 120.0
SPLIT_TIERS = ("realtime", "high", "normal", "low")

#: Run before ``python -m llmq_tpu_torch`` in each serve-split child: it
#: counts the plain twins' calls, zeroes ``kernels.LAUNCHES`` when the
#: engine starts serving (warmup's launches left out), and writes the
#: counts, the rows decoding and whether CUDA was initialised to a status
#: file every 50 ms and at exit.
SPLIT_PRELUDE = r'''
import atexit, json, os, runpy, sys, threading, time
status_path = sys.argv.pop(1)
sys.path.insert(0, os.getcwd())
import torch
from llmq_tpu_torch.ops import kernels
from llmq_tpu_torch.engine import engine as engine_mod
plain = {}
for name in [n for n in dir(kernels) if n.endswith("_plain")]:
    def counted(*a, _name=name, _fn=getattr(kernels, name), **kw):
        plain[_name] = plain.get(_name, 0) + 1
        return _fn(*a, **kw)
    setattr(kernels, name, counted)
held = {}
from llmq_tpu_torch.engine import executor as executor_mod
follow = executor_mod.TorchExecutor.follow
def holding_follow(self):
    held["executor"] = self
    held["follow_t"] = time.time()
    return follow(self)
executor_mod.TorchExecutor.follow = holding_follow
marks = {}
start = engine_mod.InferenceEngine.start
def counting_start(self):
    if "engine" not in held:
        kernels.reset_launches()
        held["engine"] = self
    return start(self)
engine_mod.InferenceEngine.start = counting_start
submit = engine_mod.InferenceEngine.submit
def recording_submit(self, req, **kw):
    h = submit(self, req, **kw)
    hs = held.setdefault("handles", [])
    hs.append(h)
    del hs[:-256]
    return h
engine_mod.InferenceEngine.submit = recording_submit
# The loop below and the exit hook both dump: one at a time, or two
# writers share the temporary file and leave a torn status file.
dump_mu = threading.Lock()
def dump():
    eng = held.get("engine")
    rows = 0 if eng is None else sum(
        1 for s in eng._slots if s is not None and s.prefilled)
    ex = held.get("executor") if eng is None else eng.executor
    for name in ("start", "end"):
        if name not in marks and os.path.exists(status_path + "." + name):
            marks[name] = dict(kernels.LAUNCHES)
    dp = getattr(ex, "_dp", None)
    rec = {"t": time.time(), "pid": os.getpid(), "marks": marks,
           "engine_held": eng is not None,
           "follow_t": held.get("follow_t"),
           "dp_moves": None if dp is None else dict(dp.moves),
           "launches": dict(kernels.LAUNCHES), "plain": dict(plain),
           "decoding": rows,
           "cuda_initialized": torch.cuda.is_initialized(),
           "results": {h.request.id: list(h.result.tokens)
                       for h in list(held.get("handles", ()))
                       if h.result is not None},
           "graphs": sum(len(getattr(ex, n, ())) for n in (
               "step_graphs", "program_graphs", "verify_graphs")),
           "replays": (getattr(ex, "graph_replays", 0) + sum(
               getattr(ex, "program_replays", {}).values()))}
    with dump_mu:
        with open(status_path + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(status_path + ".tmp", status_path)
def loop():
    while True:
        try:
            dump()
        except Exception:
            pass
        time.sleep(0.05)
threading.Thread(target=loop, daemon=True).start()
atexit.register(dump)
sys.argv[0] = "llmq_tpu_torch"
runpy.run_module("llmq_tpu_torch", run_name="__main__", alter_sys=True)
'''


def _split_config_file(work: str):
    """``configs/config.yaml`` with the serve-plane phase's overrides and
    ``queue.spool_dir`` set, written into ``work``; each process's
    ``queue.wal_dir`` comes from its own ``LLMQ_QUEUE_WAL_DIR``. Returns
    the config and the file's path."""
    import dataclasses

    import yaml

    from llmq_tpu_torch.core.config import load_config

    cfg, plane_path = _plane_config_file()
    with open(plane_path) as f:
        data = yaml.safe_load(f)
    spool = os.path.join(work, "spool")
    data["queue"]["spool_dir"] = spool
    path = os.path.join(work, "split_config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    cfg.queue.spool_dir = spool
    got = load_config(path, env=False)
    if dataclasses.asdict(got) != dataclasses.asdict(cfg):
        raise AssertionError("the split config file did not load to the "
                             "phase's settings")
    return got, path


class _Child:
    """One ``python -m llmq_tpu_torch <role>`` process (after
    SPLIT_PRELUDE), its log file and its status file."""

    def __init__(self, work: str, role: str, n: int, args, env) -> None:
        import subprocess

        self.role = role
        self.log_path = os.path.join(work, f"{role}-{n}.log")
        self.status_path = os.path.join(work, f"status-{role}-{n}.json")
        self._log = open(self.log_path, "w")
        self.started = time.time()
        self.p = subprocess.Popen(
            [sys.executable, "-c", SPLIT_PRELUDE, self.status_path, *args,
             role], cwd=os.path.dirname(os.path.abspath(__file__)),
            env=env, stdout=self._log, stderr=subprocess.STDOUT)

    def lines(self):
        with open(self.log_path) as f:
            return f.read().splitlines()

    def records(self, prefix: str):
        """The JSON log records whose message starts with ``prefix``."""
        out = []
        for line in self.lines():
            if line.startswith("{"):
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if str(rec.get("msg", "")).startswith(prefix):
                    out.append(rec)
        return out

    def wait_record(self, prefix: str, timeout: float):
        deadline = time.time() + timeout
        while time.time() < deadline:
            found = self.records(prefix)
            if found:
                return found[-1]
            if self.p.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"{self.role}: no {prefix!r} log line "
                             f"(exit {self.p.poll()}):\n"
                             + "\n".join(self.lines()[-40:]))

    def status(self):
        try:
            with open(self.status_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def stop(self, sig, timeout: float = 120.0) -> int:
        import signal as _signal

        if self.p.poll() is None:
            self.p.send_signal(sig)
        try:
            rc = self.p.wait(timeout)
        except Exception:  # noqa: BLE001 — never leave a child behind
            self.p.kill()
            rc = self.p.wait(30)
        self._log.close()
        if sig != _signal.SIGKILL and rc != 0:
            raise AssertionError(f"{self.role} exited {rc}:\n"
                                 + "\n".join(self.lines()[-40:]))
        return rc


class _SpoolWatch:
    """Polls the spool directory every 2 ms on a thread: when each message
    file appeared and when it left (its claim); the publish time is in
    the file's name."""

    def __init__(self, spool: str) -> None:
        self.spool = spool
        self.seen = {}        # name → (publish ts, first seen)
        self.claimed = {}     # name → time it left
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            now = time.time()
            try:
                names = {n for n in os.listdir(self.spool)
                         if n.endswith(".msg")}
            except FileNotFoundError:
                names = set()
            for n in names - set(self.seen):
                self.seen[n] = (float(n.split("-")[1]), now)
            for n in set(self.seen) - names - set(self.claimed):
                self.claimed[n] = now
            time.sleep(0.002)

    def publish_to_claim_ms(self, ids):
        out = []
        for n, t in self.claimed.items():
            if any(n.endswith(f"-{mid}.msg") for mid in ids):
                out.append((t - self.seen[n][0]) * 1e3)
        return sorted(out)

    def close(self) -> None:
        self._stop.set()
        self._t.join(5)


def _split_prompts(rng, n: int):
    """``n`` prompts of SPLIT_PROMPT_RANGE tokens (one token a byte), each
    opening with its own index, with priorities cycling over the tiers."""
    import numpy as np

    lo, hi = SPLIT_PROMPT_RANGE
    lengths = rng.permutation(np.linspace(lo, hi, n).astype(int))
    filler = PRESSURE_FILLER * (hi // len(PRESSURE_FILLER) + 2)
    return [(SPLIT_TIERS[i % 4], f"{i:03d} {filler}"[:int(L) - 1])
            for i, L in enumerate(lengths)]


def _split_post(base, prompts, new_tokens: int = SPLIT_NEW_TOKENS):
    """POST each prompt to the gateway; returns [(id, tier, post time)]."""
    out = []
    for tier, text in prompts:
        t = time.time()
        mid = _post(base, {"content": text, "priority": tier,
                           "user_id": "serve-split",
                           "metadata": {"max_new_tokens": new_tokens}})
        out.append((mid, tier, t))
    return out


def _split_wait(base, posted, timeout: float, what: str):
    """Polls the gateway until every posted message completes; returns
    {id: (message, time seen completed)}. A failed message fails."""
    done = {}
    deadline = time.time() + timeout
    while len(done) < len(posted):
        if time.time() > deadline:
            raise AssertionError(f"{what}: {len(posted) - len(done)} of "
                                 f"{len(posted)} messages unfinished")
        for mid, _tier, _t in posted:
            if mid in done:
                continue
            _, m = _http("GET", f"{base}/api/v1/messages/{mid}")
            if m["status"] == "completed":
                done[mid] = (m, time.time())
            elif m["status"] in ("failed", "timeout"):
                raise AssertionError(f"{what}: {mid} {m['status']}: "
                                     f"{m.get('error')}")
        time.sleep(0.02)
    for mid, (m, _t) in done.items():
        usage = m["metadata"].get("usage") or {}
        if not m["response"] and usage.get("completion_tokens", 0) <= 0:
            raise AssertionError(f"{what}: {mid} completed without tokens: "
                                 f"{m}")
        if not USAGE_FIELDS <= set(usage):
            raise AssertionError(f"{what}: {mid} usage {sorted(usage)}")
    return done


def _tier_e2e(posted, done):
    import numpy as np

    by = {}
    for mid, tier, t in posted:
        by.setdefault(tier, []).append(done[mid][1] - t)
    return {tier: {"median_s": float(np.median(v)), "max_s": max(v),
                   "n": len(v)} for tier, v in by.items()}


def _spool_completions(base, ids):
    """{id: completed records from the spool} in the gateway's traces."""
    out = {}
    for mid in ids:
        status, tl, _ = _http_status("GET",
                                     f"{base}/api/v1/requests/{mid}/trace")
        out[mid] = 0 if status != 200 else sum(
            1 for e in tl["events"] if e["stage"] == "completed"
            and (e.get("meta") or {}).get("source") == "spool")
    return out


def _backlog(base) -> int:
    """Messages pending or processing in the gateway's standard manager."""
    _, stats = _http("GET", f"{base}/api/v1/queues/stats")
    return sum(stats["standard"][t]["processing_count"]
               + stats["standard"][t]["pending_count"] for t in SPLIT_TIERS)


def _quiet(dep) -> bool:
    """Nothing left anywhere: no message pending or processing in the
    gateway, none live in the queue-manager's WAL, no file in the spool
    or its ``done/``."""
    from llmq_tpu_torch.queueing.wal import QueueWAL

    return (_backlog(dep.base) == 0
            and not QueueWAL.replay(dep.wal("queue-manager"))
            and os.listdir(dep.spool) == ["done"]
            and not os.listdir(os.path.join(dep.spool, "done")))


def _queue_core_rates() -> dict:
    """Push+pop operations per second of the native and the Python queue
    core at a backlog of SPLIT_BACKLOG messages over the four tiers, in
    turns (native, python, python, native): through ``MultiLevelQueue``
    (what a queue manager calls) and on the bare core (handles only)."""
    import numpy as np

    from llmq_tpu_torch.core.types import Message, Priority
    from llmq_tpu_torch.native import loader
    from llmq_tpu_torch.queueing.priority_queue import MultiLevelQueue

    rates = {"NativeMLQ": {"queue": [], "core": []},
             "_PyBackend": {"queue": [], "core": []}}
    msgs = [Message(id=f"b{i}", content="x", priority=Priority(1 + i % 4))
            for i in range(SPLIT_BACKLOG + SPLIT_PAIRS)]
    for backend in ("native", "python", "python", "native"):
        q = MultiLevelQueue(backend=backend)
        for tier in SPLIT_TIERS:
            q.create_queue(tier, SPLIT_BACKLOG)
        for i in range(SPLIT_BACKLOG):
            q.push(SPLIT_TIERS[i % 4], msgs[i])
        t0 = time.perf_counter()
        for i in range(SPLIT_PAIRS):
            tier = SPLIT_TIERS[i % 4]
            q.push(tier, msgs[SPLIT_BACKLOG + i])
            q.pop(tier)
        rates[q.backend_name]["queue"].append(
            2 * SPLIT_PAIRS / (time.perf_counter() - t0))
        core = type(q._core)()
        for tier in SPLIT_TIERS:
            core.create_queue(tier, 2 * SPLIT_BACKLOG)
        for i in range(SPLIT_BACKLOG):
            core.push(SPLIT_TIERS[i % 4], i, i % 4 + 1, float(i))
        t0 = time.perf_counter()
        for i in range(SPLIT_PAIRS):
            tier = SPLIT_TIERS[i % 4]
            core.push(tier, SPLIT_BACKLOG + i, i % 4 + 1, float(i))
            core.pop(tier, float(i))
        rates[q.backend_name]["core"].append(
            2 * SPLIT_PAIRS / (time.perf_counter() - t0))
    lib = loader.loaded_path()
    if not lib or os.path.dirname(lib) != str(loader.BUILD_DIR) or \
            os.path.basename(lib) != loader.library_path().name:
        raise AssertionError(f"the native core loaded {lib}, not the "
                             f"library built from {loader.SRC} into "
                             f"{loader.BUILD_DIR}")
    out = {k: {m: float(np.median(v)) for m, v in r.items()}
           for k, r in rates.items()}
    log(f"[serve-split] queue cores at a backlog of {SPLIT_BACKLOG} over "
        f"4 tiers, push+pop ops/s (median of 2 turns): native "
        f"{out['NativeMLQ']['queue']:.0f} through MultiLevelQueue, "
        f"{out['NativeMLQ']['core']:.0f} on the bare core; Python "
        f"{out['_PyBackend']['queue']:.0f} and "
        f"{out['_PyBackend']['core']:.0f}; native library "
        f"{os.path.relpath(lib)} built from {os.path.relpath(loader.SRC)} "
        f"(host CPU; {CARD})")
    out["native_lib"] = os.path.relpath(lib)
    return out


def _wal_cost(engine, work: str) -> dict:
    """Printed, not gated: decode tok/s of 8 concurrent REST requests (90
    prompt tokens, SPLIT_NEW_TOKENS new) through the serving process
    (``App``) on the serve phase's engine with ``queue.wal_dir`` set and
    without it, in turns (on, off, off, on), each turn one uncounted
    batch and the median of three; and the journal's bytes per message
    in the "on" turns."""
    import numpy as np

    from llmq_tpu_torch.__main__ import App

    prompt = "The quick brown fox jumps over the lazy dog. " * 2
    wal_dir = os.path.join(work, "wal-cost")
    rates = {"on": [], "off": []}
    wal_bytes = []

    def journal_bytes():
        if not os.path.isdir(wal_dir):
            return 0
        return sum(os.path.getsize(os.path.join(wal_dir, n))
                   for n in os.listdir(wal_dir) if n.endswith(".wal"))

    for turn, on in enumerate((True, False, False, True)):
        cfg = _plane_cfg()
        cfg.queue.wal_dir = wal_dir if on else ""
        app = App(cfg, engine=engine)
        base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
        try:
            got = []
            for batch in range(4):
                b0 = journal_bytes()
                posted = []
                for i in range(8):
                    posted.append((_post(base, {
                        "content": f"{turn}{batch}{i} {prompt}",
                        "metadata": {"max_new_tokens": SPLIT_NEW_TOKENS}}),
                        "normal", time.time()))
                done = _split_wait(base, posted, 300, "wal-cost")
                toks = sum(m["metadata"]["usage"]["completion_tokens"]
                           for m, _t in done.values())
                span = (max(t for _m, t in done.values())
                        - min(t for _i, _tier, t in posted))
                if batch:
                    got.append(toks / span)
                if on:
                    wal_bytes.append((journal_bytes() - b0) / len(posted))
        finally:
            app.stop()
        rates["on" if on else "off"].append(float(np.median(got)))
    per_msg = float(np.median(wal_bytes))
    log(f"[serve-split] WAL cost: 8 concurrent x {SPLIT_NEW_TOKENS} new "
        f"tokens through REST, tok/s with queue.wal_dir set "
        f"{[round(r, 1) for r in rates['on']]} and unset "
        f"{[round(r, 1) for r in rates['off']]} (turns on, off, off, on; "
        f"medians of 3 batches); journal {per_msg:.0f} bytes a message "
        f"(push, pop and complete records); {clocks()} ({CARD})")
    return {"tok_s_wal_on": rates["on"], "tok_s_wal_off": rates["off"],
            "wal_bytes_per_message": per_msg}


class _Deployment:
    """The split deployment's processes: a gateway on a fixed port and a
    queue-manager on the card, each with its own WAL directory, sharing
    the spool."""

    def __init__(self, work: str, path: str, spool: str) -> None:
        self.work, self.path, self.spool = work, path, spool
        self.port = _free_tcp_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.children = []
        self.n = 0

    def start(self, role: str) -> _Child:
        env = {k: v for k, v in os.environ.items() if k != "LLMQ_CONFIG"}
        env["LLMQ_QUEUE_WAL_DIR"] = os.path.join(self.work, f"wal-{role}")
        args = ["--config", self.path]
        if role == "gateway":
            args += ["--host", "127.0.0.1", "--port", str(self.port)]
        self.n += 1
        child = _Child(self.work, role, self.n, args, env)
        self.children.append(child)
        return child

    def wal(self, role: str) -> str:
        return os.path.join(self.work, f"wal-{role}", "standard.wal")

    def close(self, failed: bool) -> None:
        for child in self.children:
            if child.p.poll() is None:
                child.p.kill()
                child.p.wait(30)
            child._log.close()
            if failed:
                print(f"--- {child.role} log (last 40 lines) ---\n"
                      + "\n".join(child.lines()[-40:]), file=sys.stderr)


def _boot(child: _Child, what: str) -> dict:
    if child.role == "gateway":
        rec = child.wait_record("gateway serving at", 120)
    else:
        rec = child.wait_record("queue-manager consuming", SPLIT_BOOT_S)
    cores = rec["queue_cores"]
    if set(cores.values()) != {"NativeMLQ"} or len(cores) != 3:
        raise AssertionError(f"{what}: queue cores {cores}")
    return rec


def _split_deploy(dep: _Deployment, lib: str, out: dict, rng) -> None:
    """Start both processes, serve SPLIT_REQUESTS through the gateway,
    then the queue-manager's crash and restart and the gateway's
    restart."""
    import signal

    import numpy as np

    from llmq_tpu_torch.queueing.wal import QueueWAL

    watch = _SpoolWatch(dep.spool)
    try:
        gateway = dep.start("gateway")
        qm = dep.start("queue-manager")
        gw_rec, qm_rec = _boot(gateway, "gateway"), _boot(qm, "queue-manager")
        for rec in (gw_rec, qm_rec):
            if os.path.relpath(rec["native_lib"]) != lib:
                raise AssertionError(f"a child loaded {rec['native_lib']}, "
                                     f"not {lib}")
        log(f"[serve-split] gateway up in {gw_rec['ts'] - gateway.started:.1f}"
            f" s, queue-manager in {qm_rec['ts'] - qm.started:.1f} s (boot "
            f"{qm_rec['boot_s']}); queue cores {gw_rec['queue_cores']} and "
            f"{qm_rec['queue_cores']}, library {lib}")

        # 1. The split deployment serves.
        posted = _split_post(dep.base, _split_prompts(rng, SPLIT_REQUESTS))
        done = _split_wait(dep.base, posted, 600, "split")
        ids = [mid for mid, _t, _p in posted]
        p2c = watch.publish_to_claim_ms(ids)
        out["split"] = {"e2e_by_tier": _tier_e2e(posted, done),
                        "publish_to_claim_ms": {
                            "median": float(np.median(p2c)), "max": max(p2c),
                            "seen": len(p2c)}}
        log(f"[serve-split] {len(done)} requests (prompts "
            f"{SPLIT_PROMPT_RANGE[0]}-{SPLIT_PROMPT_RANGE[1]} tokens, "
            f"{SPLIT_NEW_TOKENS} new) completed through the gateway with "
            f"responses and usage; spool publish-to-claim "
            f"{out['split']['publish_to_claim_ms']['median']:.1f} ms median, "
            f"{max(p2c):.1f} ms max ({len(p2c)} of {len(ids)} files seen "
            f"between polls of 2 ms); end to end by tier "
            f"{ {t: round(v['median_s'], 3) for t, v in out['split']['e2e_by_tier'].items()} }"
            f" s median ({CARD})")

        # 2. SIGKILL the queue-manager with 8 rows decoding; restart it.
        posted = _split_post(dep.base, _split_prompts(rng, SPLIT_REQUESTS),
                             new_tokens=SPLIT_HELD_NEW_TOKENS)
        deadline = time.time() + 300
        while (qm.status() or {}).get("decoding", 0) < 8:
            if time.time() > deadline or qm.p.poll() is not None:
                raise AssertionError(f"never 8 rows decoding: {qm.status()}")
            time.sleep(0.01)
        qm_status = qm.status()
        qm.stop(signal.SIGKILL)
        t_kill = time.time()
        done_at_kill = {mid for mid, _t, _p in posted
                        if _http("GET", f"{dep.base}/api/v1/messages/{mid}"
                                 )[1]["status"] == "completed"}
        in_spool = {mid for mid, _t, _p in posted
                    if any(n.endswith(f"-{mid}.msg")
                           for n in os.listdir(dep.spool))}
        journaled = {m.id for _q, m in QueueWAL.replay(dep.wal(
            "queue-manager"))}
        left_claims = [n for n in os.listdir(dep.spool)
                       if n.endswith(".claim")]
        # One more message while no consumer runs; its file is then held
        # as a consumer that died mid-delivery leaves it: renamed to a
        # claim of the killed process, claimed more than the TTL ago.
        extra = _split_post(dep.base, [("normal", "a message published "
                                        "while the queue-manager is down")])
        _until(lambda: any(n.endswith(f"-{extra[0][0]}.msg")
                           for n in os.listdir(dep.spool)), 30,
               "the extra message's spool file")
        name = next(n for n in os.listdir(dep.spool)
                    if n.endswith(f"-{extra[0][0]}.msg"))
        claim = os.path.join(dep.spool, f"{name}.c{qm.p.pid}.claim")
        os.rename(os.path.join(dep.spool, name), claim)
        stale = time.time() - SPOOL_CLAIM_TTL_S - 1.0
        os.utime(claim, (stale, stale))
        t_restart = time.time()
        qm2 = dep.start("queue-manager")
        qm2_rec = _boot(qm2, "restarted queue-manager")
        restored = qm2.records("wal: restored")
        all_posted = posted + extra
        done = _split_wait(dep.base, all_posted, 600, "crash")
        last = max(t for _m, t in done.values())
        reclaimed = qm2.records("reclaimed stale spool claim")
        if not reclaimed or os.path.exists(claim):
            raise AssertionError(f"the stale claim was not reclaimed: "
                                 f"{reclaimed}")
        # Unfinished and claimed before the kill: the queue-manager's WAL
        # must redeliver them (the rest were still in the spool).
        unfinished = {mid for mid, _t, _p in posted} - done_at_kill - in_spool
        redelivered = sum(r.get("restored", 0) for r in restored
                          if r.get("manager") == "standard")
        if not unfinished <= journaled or redelivered < len(unfinished):
            raise AssertionError(
                f"the WAL held {len(journaled)} messages, "
                f"{len(unfinished)} were unfinished at the kill, "
                f"{redelivered} redelivered")
        # None lost, none left pending or processing anywhere; then the
        # duplicates (at-least-once) in the gateway's traces.
        _until(lambda: _quiet(dep), 60, "the deployment idle", poll=0.05)
        completions = _spool_completions(dep.base,
                                         [m for m, _t, _p in all_posted])
        dups = sum(max(0, n - 1) for n in completions.values())
        if min(completions.values()) < 1:
            raise AssertionError(f"a message completed without a spool "
                                 f"record: {completions}")
        out["crash"] = {
            "decoding_at_kill": qm_status["decoding"],
            "completed_before_kill": len(done_at_kill),
            "in_spool_at_kill": len(in_spool),
            "journaled_at_kill": len(journaled),
            "redelivered": redelivered,
            "claims_left_by_kill": len(left_claims),
            "stale_claim_reclaimed": len(reclaimed),
            "duplicate_completions": dups,
            "restart_to_last_completion_s": last - t_restart,
            "kill_to_restart_s": t_restart - t_kill,
            "restart_boot_s": qm2_rec["boot_s"],
            "restart_boot_total_s": qm2_rec["boot_total_s"]}
        log(f"[serve-split] SIGKILL with {qm_status['decoding']} rows "
            f"decoding: {len(done_at_kill)} of {len(posted)} done, the WAL "
            f"held {len(journaled)}, the kill left {len(left_claims)} claims; "
            f"the restart redelivered {redelivered} from its WAL and "
            f"reclaimed the stale claim; all {len(all_posted)} completed "
            f"{last - t_restart:.1f} s after the restart (boot "
            f"{qm2_rec['boot_s']}, {qm2_rec['boot_total_s']} s); "
            f"{dups} duplicate completions (at-least-once); none lost, "
            f"none processing ({CARD})")

        # 3. Stop the gateway with messages in flight (long ones, so they
        # are still decoding when it stops); restart it.
        posted = _split_post(dep.base, _split_prompts(rng, 8),
                             new_tokens=SPLIT_HELD_NEW_TOKENS)
        ids = {mid for mid, _t, _p in posted}
        _until(lambda: ids <= {m.id for _q, m in QueueWAL.replay(
            dep.wal("queue-manager"))}, 60, "the queue-manager holding them")
        gateway.stop(signal.SIGTERM)
        t_gw = time.time()
        held = {m.id for _q, m in QueueWAL.replay(dep.wal("gateway"))}
        gateway2 = dep.start("gateway")
        _boot(gateway2, "restarted gateway")
        restored = sum(r.get("restored", 0) for r in gateway2.records(
            "wal: restored") if r.get("manager") == "standard")
        if not (ids & held) or restored < len(ids & held):
            raise AssertionError(f"the gateway's WAL held {len(held)} of "
                                 f"the {len(ids)}, {restored} restored")

        def all_completed():
            c = _spool_completions(dep.base, sorted(ids & held))
            return min(c.values()) >= 1

        _until(all_completed, 600, "the restored messages' completions",
               poll=0.05)
        t_done = time.time()
        # The relay published the restored messages again: wait until the
        # queue-manager has finished that work too and the gateway has
        # applied every acknowledgement, then count the duplicates.
        _until(lambda: _quiet(dep), 600, "the deployment idle", poll=0.05)
        completions = _spool_completions(dep.base, sorted(ids & held))
        out["gateway_restart"] = {
            "held_in_wal": len(ids & held), "restored": restored,
            "duplicate_completions": sum(max(0, n - 1)
                                         for n in completions.values()),
            "restart_to_all_completed_s": t_done - t_gw}
        log(f"[serve-split] gateway stopped with {len(ids & held)} of 8 "
            f"messages in its WAL; the restart restored {restored}, relayed "
            f"them again and each completed ("
            f"{out['gateway_restart']['duplicate_completions']} duplicate "
            f"completions) in {out['gateway_restart']['restart_to_all_completed_s']:.1f}"
            f" s ({CARD})")
        gateway2.stop(signal.SIGTERM)
        qm2.stop(signal.SIGTERM)
        out["kernels"] = _split_kernels(qm, qm2, gateway, gateway2)
    finally:
        watch.close()


def _split_kernels(qm, qm2, gateway, gateway2) -> dict:
    """The children's status files at exit: kernels 1-3 launched in each
    queue-manager, no plain twin called anywhere, CUDA never initialised
    in a gateway."""
    launches = {}
    for child in (qm, qm2, gateway, gateway2):
        st = child.status()
        if st is None:
            raise AssertionError(f"{child.role}: no status file")
        if st["plain"]:
            raise AssertionError(f"{child.role} called plain twins: "
                                 f"{st['plain']}")
        if child.role == "gateway":
            if st["cuda_initialized"] or any(st["launches"].values()):
                raise AssertionError(f"a gateway touched the card: {st}")
            continue
        for name in ("fused_decode", "kv_prefill_write",
                     "prefill_attention"):
            if st["launches"].get(name, 0) <= 0:
                raise AssertionError(f"{child.role} (pid {st['pid']}) never "
                                     f"launched {name}: {st['launches']}")
        launches[f"queue-manager pid {st['pid']}"] = {
            k: v for k, v in st["launches"].items() if v}
    log(f"[serve-split] launches in the queue-managers (serving only) "
        f"{launches}; no plain twin called; the gateways never initialised "
        f"CUDA")
    return launches


def phase_serve_split(state) -> None:
    """The split deployment on the card: the WAL's cost on the serving
    process first (the serve phases' engine), then that engine released
    and the gateway and queue-manager started as processes."""
    import gc
    import shutil

    import numpy as np
    import torch

    from llmq_tpu_torch.native import loader
    from llmq_tpu_torch.ops.kernels import BUILD_DIR

    engine = state.pop("serve_engine", None)
    if engine is None:
        raise AssertionError("serve-split starts on the serve phases' engine:"
                             " run serve and serve-plane before it")
    work = str(BUILD_DIR / "serve_split")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = state.setdefault("serve_split", {})
    counts, restore = _count_plain_calls()
    try:
        out["wal_cost"] = _wal_cost(engine, work)
    finally:
        restore()
        engine.executor.release_graphs()
    if counts:
        raise AssertionError(f"serve-split called plain twins: {counts}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[serve-split] the parent's engines are released: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{free / 2**30:.1f} GiB free of {total / 2**30:.1f} GiB before the "
        f"queue-manager builds its engine")
    out["queue_cores"] = _queue_core_rates()
    lib = os.path.relpath(loader.loaded_path())
    cfg, path = _split_config_file(work)
    dep = _Deployment(work, path, cfg.queue.spool_dir)
    failed = True
    try:
        _split_deploy(dep, lib, out, np.random.default_rng(0))
        failed = False
    finally:
        dep.close(failed)


# -- serve-spec: speculative decoding ----------------------------------------

#: The speculation plane's setting on the card: JAX's default drafter
#: (draft_k 4, so a window of W = 5 steps; n-grams up to 3).
SPEC_DRAFT_K = 4
SPEC_NGRAM_MAX = 3
#: New tokens of every served request of the phase.
SPEC_NEW_TOKENS = 128
#: Lengths of the B=8 cache state the program-identity gates start
#: from (1 to 480 positions).
SPEC_LENGTHS = (1, 17, 60, 128, 200, 333, 479, 480)


def _spec_prompt(i: int) -> str:
    """A repetitive prompt (its own first words, then one sentence over
    and over), so that the drafter finds n-grams in it."""
    return (f"{i:02d} spec. " + "The queue serves four priority tiers: "
            "realtime, high, normal and low. " * 6)


def _spec_cfg():
    cfg = _serve_cfg()
    sp = cfg.executor.speculation
    sp.enabled, sp.draft_k, sp.ngram_max = True, SPEC_DRAFT_K, SPEC_NGRAM_MAX
    return cfg


def _spec_executor(params, *, device_sampling=True, cache_dtype=None):
    """A bare executor of the serve geometry with speculation on, over
    the given weights, its decode step and verify program captured (the
    prefill programs are captured at first use)."""
    import torch

    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.models.llama import get_config

    cfg = _serve_cfg()
    ex = cfg.executor
    out = TorchExecutor(
        get_config(cfg.model.name, max_seq_len=cfg.model.max_seq_len), params,
        batch_size=ex.max_batch_size, page_size=ex.page_size,
        num_pages=ex.kv_pages, prefill_buckets=list(ex.prefill_buckets),
        eos_id=-1, chunk_size=ex.decode_chunk, prefill_batch=ex.prefill_batch,
        cache_dtype=cache_dtype, speculation_draft_k=SPEC_DRAFT_K,
        speculation_device_sampling=device_sampling, device=cfg.device,
        telemetry_name="spec-probe", telemetry_metrics=False)
    if out._graphs_on:
        # Captured now, so that a gate's launch counts hold replays
        # only (a capture runs its body once eagerly first).
        with torch.inference_mode():
            out._step_graph()
            out._verify_graph()
    return out


def _spec_rows(ex, rng):
    """A B=8 cache state: rows of SPEC_LENGTHS positions of random tokens,
    prefilled in waves through the executor's prefill programs, each row
    with pages for 64 positions more. Returns (first tokens, positions,
    block tables)."""
    import numpy as np

    from llmq_tpu_torch.engine.kv_allocator import PageAllocator

    B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
    bt = np.zeros((B, MP), np.int32)
    page = 1
    reqs = []
    for b, n in enumerate(SPEC_LENGTHS):
        k = PageAllocator.pages_for(n + 64, ex.spec.page_size)
        bt[b, :k] = np.arange(page, page + k)
        page += k
        reqs.append(([int(x) for x in rng.integers(
            3, ex.model_cfg.vocab_size, n)], 0, bt[b], 0.0))
    hs = []
    for i in range(0, B, ex.prefill_batch):
        hs += ex.prefill_multi_async(reqs[i:i + ex.prefill_batch])
    tok = ex.gather_scalars(hs).astype(np.int32)
    return tok, np.asarray(SPEC_LENGTHS, np.int32), bt


def _kv_rows(cache, bt, starts, ends):
    """Every pool's entries (K and V, and an int8 cache's scale pools) at
    positions [starts[b], ends[b]) of each row b, gathered through its
    block table: {pool: tensor}."""
    import numpy as np
    import torch

    ps = cache["k"].shape[2]
    pages, slots = [], []
    for b in range(len(starts)):
        p = np.arange(int(starts[b]), int(ends[b]))
        pages.append(bt[b, p // ps])
        slots.append(p % ps)
    dev = cache["k"].device
    pg = torch.as_tensor(np.concatenate(pages), device=dev).long()
    sl = torch.as_tensor(np.concatenate(slots), device=dev).long()
    return {name: (pool[:, pg, :, sl] if name.endswith("scale")
                   else pool[:, pg, sl]) for name, pool in cache.items()}


def _spec_identity(ex, rows, tag: str) -> dict:
    """Gate 1 (and 2, 4 on other executors or routes): from the rows'
    cache state, a plain decode chunk of W steps, then the pools restored
    and one verify window whose drafts are the chunk's first W-1 tokens:
    every row commits W tokens, the window's tokens are the chunk's, and
    every pool is bitwise the chunk's (page 0 aside). Returns the
    kernels each program launched and their replays."""
    import numpy as np
    import torch

    from llmq_tpu_torch.ops import kernels

    tok, pos, bt = rows
    B, W = len(tok), ex.verify_draft_k + 1
    temps = np.zeros(B, np.float32)
    saved = {k: v.clone() for k, v in ex.cache.items()}
    kernels.reset_launches()
    chunk = ex.decode_chunk(tok, pos, bt, temps,
                            np.full(B, W, np.int32))[:, :W]
    torch.cuda.synchronize()
    plain = {k: v for k, v in kernels.LAUNCHES.items() if v}
    after = {k: v.clone() for k, v in ex.cache.items()}
    for k, v in ex.cache.items():
        v.copy_(saved[k])
    kernels.reset_launches()
    replays = ex.verify_replays
    out, nc = ex.verify_chunk(tok, pos, bt, temps, chunk[:, :W - 1],
                              np.full(B, W, np.int32))
    torch.cuda.synchronize()
    window = {k: v for k, v in kernels.LAUNCHES.items() if v}
    replays = ex.verify_replays - replays
    if not (nc == W).all():
        raise AssertionError(f"[{tag}] n_commit {nc.tolist()}, want {W} "
                             f"on every row")
    if not (out == chunk).all():
        raise AssertionError(f"[{tag}] window tokens differ from the plain "
                             f"chunk's:\n{out}\n{chunk}")
    same = {k: torch.equal(v[:, 1:], after[k][:, 1:])
            for k, v in ex.cache.items()}
    got = _kv_rows(ex.cache, bt, pos, pos + W)
    want = _kv_rows(after, bt, pos, pos + W)
    if not all(same.values()) or not all(torch.equal(got[k], want[k])
                                         for k in got):
        raise AssertionError(f"[{tag}] pools differ from the plain chunk's: "
                             f"{same}")
    want_replays = W if ex._spec_device_sampling else 1
    if replays != want_replays:
        raise AssertionError(f"[{tag}] {replays} verify replays, want "
                             f"{want_replays}")
    del saved, after
    log(f"[serve-spec] {tag}: verify window (W={W}, B={B}, rows of "
        f"{min(SPEC_LENGTHS)}-{max(SPEC_LENGTHS)} positions) commits "
        f"{W} on every row, tokens equal the plain chunk's, pools bitwise "
        f"equal ({', '.join(sorted(same))}); window launches {window} in "
        f"{replays} replay(s), plain chunk {plain}")
    return {"window_launches": window, "plain_launches": plain,
            "replays": replays}


def _spec_rollback(ex, rows) -> dict:
    """Gate 3 at the executor (``TestJaxKVIntegrity`` on the card): from
    the rows' cache state, 8 plain single steps, then the pools restored
    and 8 windows a row of garbage drafts (an id the plain stream never
    takes) re-dispatched from the committed position: every window
    commits exactly 1 token, the stream is the plain one, and the
    committed KV is bitwise the plain one's (host accept writes the
    rejected tail too)."""
    import numpy as np
    import torch

    tok, pos, bt = rows
    B, K, n = len(tok), ex.verify_draft_k, 8
    temps = np.zeros(B, np.float32)
    saved = {k: v.clone() for k, v in ex.cache.items()}
    ctl = ex.decode_chunk(tok, pos, bt, temps,
                          np.full(B, n, np.int32))[:, :n]
    after = {k: v.clone() for k, v in ex.cache.items()}
    for k, v in ex.cache.items():
        v.copy_(saved[k])
    vocab = ex.model_cfg.vocab_size
    garbage = next(g for g in range(vocab - 1, 0, -1) if g not in ctl)
    t, p = tok.copy(), pos.copy()
    stream = np.zeros((B, n), np.int32)
    for i in range(n):
        out, nc = ex.verify_chunk(t, p, bt, temps,
                                  np.full((B, K), garbage, np.int32),
                                  np.full(B, K + 1, np.int32))
        if not (nc == 1).all():
            raise AssertionError(f"[serve-spec] garbage drafts committed "
                                 f"{nc.tolist()} tokens, want 1 a row")
        stream[:, i] = out[:, 0]
        t, p = out[:, 0].copy(), p + 1
    torch.cuda.synchronize()
    if not (stream == ctl).all():
        raise AssertionError(f"[serve-spec] rollback stream differs:\n"
                             f"{stream}\n{ctl}")
    got = _kv_rows(ex.cache, bt, np.zeros(B, np.int32), pos + n)
    want = _kv_rows(after, bt, np.zeros(B, np.int32), pos + n)
    if not all(torch.equal(got[k], want[k]) for k in got):
        raise AssertionError("[serve-spec] committed KV differs after "
                             "rolled-back windows")
    del saved, after
    log(f"[serve-spec] rollback (host accept): {n} windows a row of "
        f"garbage drafts (id {garbage}) committed 1 token each, the plain "
        f"stream, and the committed KV of positions [0, pos + {n}) bitwise "
        f"the plain one's")
    return {"windows": n, "garbage_id": garbage}


@contextlib.contextmanager
def _spec_off(engine):
    """The engine with speculation off while the block runs (it must be
    idle): the same executor, pool and graphs on the plain decode path,
    with mixed batching as configured."""
    engine._spec_on = False
    try:
        yield
    finally:
        engine._spec_on = True


def _spec_rollback_engine(spec) -> dict:
    """Gate 3 through the engine: one request with a conversation id
    with speculation off, then again with it on and a drafter that
    proposes only garbage (an id the plain stream never takes). Every
    window commits 1 token, after every reconcile the row holds exactly
    the pages of its committed positions (``_spec_trim``), the stream is
    the plain one, and the finished turns' pinned KV is bitwise equal."""
    import torch

    from llmq_tpu_torch.engine.engine import GenRequest
    from llmq_tpu_torch.engine.kv_allocator import PageAllocator

    conv, prompt = "spec-rollback", _spec_prompt(99)

    def turn(rid):
        h = spec.submit(GenRequest(id=rid, prompt=prompt,
                                   conversation_id=conv, max_new_tokens=32))
        spec.run_until_idle()
        c = spec._conv_cache[conv]
        kv = {k: v.clone() for k, v in _kv_rows(
            spec.executor.cache, c.block_table[None], [0],
            [c.length]).items()}
        spec.drop_conversation(conv)
        # The radix tree holds the turn's pages too: the next turn must
        # compute its KV, not adopt it.
        spec._prefix_cache.evict_pages(spec._prefix_cache.pages)
        return h.result.tokens, kv

    with _spec_off(spec):
        stream, kv_off = turn("rb-off")
    garbage = next(g for g in range(spec.executor.model_cfg.vocab_size - 1,
                                    0, -1) if g not in stream)
    drafter = spec._drafter
    propose, trim = drafter.propose, spec._spec_trim
    trims = []

    def checked_trim(seq):
        trim(seq)
        if seq.slot is not None:
            want = PageAllocator.pages_for(seq.pos, spec.spec.page_size)
            trims.append(len(seq.pages) == want)

    drafter.propose = lambda ctx, k=None: [garbage] * (
        drafter.draft_k if k is None else min(k, drafter.draft_k))
    spec._spec_trim = checked_trim
    w0, c0 = spec.spec_windows, spec.spec_commits_total
    a0 = spec.spec_tokens_accepted
    try:
        tokens, kv_on = turn("rb-spec")
    finally:
        drafter.__dict__.pop("propose", None)
        spec.__dict__.pop("_spec_trim", None)
    assert drafter.propose == propose
    windows = spec.spec_windows - w0
    commits = spec.spec_commits_total - c0
    if tokens != stream:
        raise AssertionError(f"[serve-spec] rollback stream {tokens} vs "
                             f"speculation off {stream}")
    if spec.spec_tokens_accepted != a0 or commits != windows or not trims \
            or not all(trims):
        raise AssertionError(f"[serve-spec] rollback: {windows} windows "
                             f"committed {commits}; trims {trims}")
    torch.cuda.synchronize()
    if not all(torch.equal(kv_off[k], kv_on[k]) for k in kv_off):
        raise AssertionError("[serve-spec] pinned KV after rolled-back "
                             "windows differs from speculation off")
    log(f"[serve-spec] rollback through the engine: {windows} windows of "
        f"garbage drafts (id {garbage}) committed 1 token each, every "
        f"reconcile left pages_for(pos) pages ({len(trims)} trims), the "
        f"stream is speculation off's ({len(stream)} tokens), and the "
        f"pinned KV of the turn ({kv_on['k'].shape[1]} positions) is "
        f"bitwise speculation off's")
    return {"windows": windows, "tokens": len(stream)}


def _spec_window_ms(ex, rows) -> dict:
    """The verify window's device time at B=8 against W plain steps, from
    the dispatches' own CUDA events (start behind the inputs' copies,
    done behind the tokens' copy to the host), five each in turns: a
    window that accepts every draft, one that rejects every draft at
    step 0 (early exit), and a W-step decode chunk."""
    import numpy as np

    tok, pos, bt = rows
    B, W = len(tok), ex.verify_draft_k + 1
    temps = np.zeros(B, np.float32)
    full = np.full(B, W, np.int32)
    chunk = ex.decode_chunk(tok, pos, bt, temps, full)
    ms = {"accept_all": [], "reject_all": [], "plain": []}
    for _ in range(5):
        for kind in ms:
            if kind == "plain":
                h = ex.decode_chunk_start(tok, pos, bt, temps, full)
            else:
                d = (chunk[:, :W - 1] if kind == "accept_all"
                     else np.full((B, W - 1), ex.model_cfg.vocab_size - 1,
                                  np.int32))
                h = ex.verify_chunk_start(tok, pos, bt, temps, d, full)
            h.wait_ready()
            ms[kind].append(h._start.elapsed_time(h._done))
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    log(f"[serve-spec] B={B} device ms (start to done events, median of 5; "
        f"W={W}): verify window accepting all {med['accept_all']:.3f}, "
        f"rejecting all at step 0 {med['reject_all']:.3f}, plain {W}-step "
        f"chunk {med['plain']:.3f} ({ms}) ({CARD}; {clocks()})")
    return med


def _spec_rates(spec, tag: str) -> dict:
    """B=1 and 8 concurrent requests of SPEC_NEW_TOKENS over repetitive
    prompts through the engine directly, with speculation off and on in
    turns (off, on, on, off; the same executor, pool and graphs): decode
    tok/s after the first token at B=1 and end to end with 8; and how
    many of the B=1 greedy tokens with speculation on equal those with it
    off."""
    from llmq_tpu_torch.engine.engine import GenRequest

    def b1(i):
        h = spec.submit(GenRequest(id=f"{tag}-b1-{i}-{time.time()}",
                                   prompt=_spec_prompt(50),
                                   max_new_tokens=SPEC_NEW_TOKENS))
        assert h.wait(300), "B=1 request timed out"
        rate = ((len(h.result.tokens) - 1)
                / (h.finished_at - h.marks["first_token"]))
        return rate, h.result.tokens

    def b8(i):
        hs = [spec.submit(GenRequest(id=f"{tag}-b8-{i}-{j}-{time.time()}",
                                     prompt=_spec_prompt(60 + j),
                                     max_new_tokens=SPEC_NEW_TOKENS))
              for j in range(8)]
        for h in hs:
            assert h.wait(300), "8-concurrent request timed out"
        return (sum(len(h.result.tokens) for h in hs)
                / (max(h.finished_at for h in hs)
                   - min(h.submitted_at for h in hs)))

    res = {"off_b1": [], "on_b1": [], "off_b8": [], "on_b8": []}
    streams = {}
    pc = spec._prefix_cache
    for i, side in enumerate(("off", "on", "on", "off")):
        # Every turn prefills its prompts whole: a turn that found the
        # last one's pages in the radix tree would prefill only a tail,
        # in another program, and a near-tie could then flip.
        pc.evict_pages(pc.pages)
        with (_spec_off(spec) if side == "off" else contextlib.nullcontext()):
            spec.start()
            try:
                rate, toks = b1(i)
                res[f"{side}_b1"].append(rate)
                streams.setdefault(side, toks)
                res[f"{side}_b8"].append(b8(i))
            finally:
                spec.stop()
    same = 0
    for a, b in zip(streams["on"], streams["off"]):
        if a != b:
            break
        same += 1
    out = {k: sum(v) / len(v) for k, v in res.items()}
    out["b1_greedy_tokens_equal"] = same
    out["b1_greedy_tokens"] = len(streams["off"])
    log(f"[serve-spec] {SPEC_NEW_TOKENS}-token requests over repetitive "
        f"prompts, one engine with speculation off and on in turns "
        f"(off/on/on/off): B=1 decode {res['off_b1']} / {res['on_b1']} "
        f"tok/s (off / on), 8 concurrent end to end {res['off_b8']} / "
        f"{res['on_b8']} tok/s; the B=1 greedy stream with speculation on "
        f"equals off's for its first {same} of {len(streams['off'])} tokens "
        f"({CARD}; {clocks()})")
    return out


def _spec_chaos(spec) -> dict:
    """The chaos plane's ``engine.step`` crash lands while a verify window
    is in flight (the fused route, device accept): the supervisor
    restarts the loop and drops the window; the request fails with what
    it had streamed, a prefix of its committed tokens (no token of the
    dead window leaks), and its retry completes on the restarted engine.
    The invariant checker holds both streams."""
    from llmq_tpu_torch import chaos
    from llmq_tpu_torch.core.config import ChaosConfig, SupervisorConfig
    from llmq_tpu_torch.engine.engine import GenRequest
    from llmq_tpu_torch.engine.supervisor import EngineSupervisor

    checker = chaos.InvariantChecker()
    prompt = _spec_prompt(70)
    pc = spec._prefix_cache
    pc.evict_pages(pc.pages)
    h = spec.submit(GenRequest(id="spec-chaos-0", prompt=prompt,
                               max_new_tokens=SPEC_NEW_TOKENS),
                    on_token=checker.on_token("spec-chaos-0"))
    checker.submitted("spec-chaos-0")
    for _ in range(2000):
        spec.step()
        if (spec._inflight
                and len(checker._streams.get("spec-chaos-0", ())) >= 8):
            break
    if not spec._inflight or not spec._inflight[0].spec:
        raise AssertionError("serve-spec chaos: no verify window in flight")
    windows0 = spec.spec_windows
    inj = chaos.configure(ChaosConfig(enabled=True, seed=16))
    sup = EngineSupervisor(spec, config=SupervisorConfig(),
                           enable_metrics=False)
    try:
        inj.add_rule("engine.step", kind="crash", times=1)
        t0 = time.perf_counter()
        spec.start()
        _until(lambda: not spec.running, 30, "the crashed engine loop",
               poll=0.01)
        if not sup.check_once():
            raise AssertionError("serve-spec chaos: no restart")
        fired = dict(inj.get_stats()["injected"])
    finally:
        chaos.configure(None)
    if spec._inflight or not h.wait(10) \
            or h.result.finish_reason != "error":
        raise AssertionError(f"serve-spec chaos: in flight "
                             f"{len(spec._inflight)}, first attempt "
                             f"{h.result and h.result.finish_reason}")
    checker.failed("spec-chaos-0")
    checker.completed("spec-chaos-0", tokens=h.result.tokens)
    checker._terminal["spec-chaos-0"].remove("completed")  # streams only
    pc.evict_pages(pc.pages)
    h2 = spec.submit(GenRequest(id="spec-chaos-1", prompt=prompt,
                                max_new_tokens=SPEC_NEW_TOKENS),
                     on_token=checker.on_token("spec-chaos-1"))
    checker.submitted("spec-chaos-1")
    if not h2.wait(300) or h2.result.finish_reason not in ("eos", "length"):
        raise AssertionError(f"serve-spec chaos: retry "
                             f"{h2.result and h2.result.finish_reason}")
    retry_s = time.perf_counter() - t0
    spec._drain_completions()
    checker.completed("spec-chaos-1", tokens=h2.result.tokens)
    spec.stop()
    sup.stop()
    checker.check()
    streamed = checker._streams.get("spec-chaos-0", [])
    same = streamed == h2.result.tokens[:len(streamed)]
    if fired != {"engine.step:crash": 1} or sup.restarts != 1:
        raise AssertionError(f"serve-spec chaos: injected {fired}, "
                             f"restarts {sup.restarts}")
    log(f"[serve-spec] chaos engine.step crash with a verify window in "
        f"flight (after {windows0} windows): restarts {sup.restarts}, "
        f"recovered {sup.recovered_total}; the failed request streamed "
        f"{len(streamed)} tokens, a prefix of its {len(h.result.tokens)} "
        f"committed; its retry completed {len(h2.result.tokens)} tokens "
        f"({h2.result.finish_reason}) {retry_s:.2f} s after the crash; the "
        f"failed stream {'is' if same else 'is NOT'} a prefix of the "
        f"retry's greedy stream; invariants hold ({CARD})")
    return {"streamed_before_crash": len(streamed),
            "committed_before_crash": len(h.result.tokens),
            "restarts": sup.restarts, "crash_to_retry_done_s": retry_s,
            "failed_stream_prefix_of_retry": same}


def _spec_window_gaps(engine, n: int):
    """Device idle at the boundaries of the next ``n + 1`` verify windows
    the engine dispatches (while it serves), from the windows' own CUDA
    events (``_event_chunk_gaps`` for verify windows)."""
    ex = engine.executor
    handles = []
    real = ex.verify_chunk_start

    def recording(*args, **kwargs):
        h = real(*args, **kwargs)
        handles.append(h)
        return h

    ex.verify_chunk_start = recording
    try:
        _until(lambda: len(handles) > n, 120, f"{n + 1} verify windows")
    finally:
        ex.__dict__.pop("verify_chunk_start", None)
    hs = handles[:n + 1]
    hs[-1].wait_ready()
    return [a._done.elapsed_time(b._start) for a, b in zip(hs, hs[1:])]


def _spec_rest(engine, base, tally) -> dict:
    """Gate 5 over REST: B=1 and 8 concurrent requests of
    SPEC_NEW_TOKENS (repetitive prompts), a two-turn conversation (turn 2
    cached), and eight LOW requests filling the slots with one REALTIME
    arrival that preempts. Every request completes, the pool holds only
    the radix tree's pages and the pins once idle, and the window
    boundaries' device idle is measured while the 8 decode; printed,
    the steps a window ran and the tokens a row committed a window."""
    ex = engine.executor
    steps0, windows0 = ex.verify_replays, engine.spec_windows
    rows0, commits0 = tally["row_windows"], engine.spec_commits_total
    mids = [_post(base, {"content": _spec_prompt(0), "priority": "normal",
                         "metadata": {"max_new_tokens": SPEC_NEW_TOKENS}})]
    results = [_poll(base, mids[0])]
    b8 = [_post(base, {"content": _spec_prompt(20 + i), "priority": "high",
                       "metadata": {"max_new_tokens": SPEC_NEW_TOKENS}})
          for i in range(8)]
    gaps = _spec_window_gaps(engine, 10)
    results += [_poll(base, m) for m in b8]
    turns = []
    for text in (_spec_prompt(30), " Now repeat the tiers, please."):
        turns.append(_poll(base, _post(base, {
            "content": text, "conversation_id": "spec-conv",
            "priority": "high", "metadata": {"max_new_tokens": 32}})))
    cached = turns[1]["metadata"]["usage"]["cached_tokens"]
    if cached <= 0:
        raise AssertionError(f"[serve-spec] turn 2 cached_tokens={cached}")
    results += turns
    pre0 = engine.preemptions
    lows = [_post(base, {"content": _spec_prompt(40 + i), "priority": "low",
                         "metadata": {"max_new_tokens": SPEC_NEW_TOKENS}})
            for i in range(8)]
    _until(lambda: _decoding_rows(engine) == 8, 120, "8 LOW rows decoding")
    rt = _post(base, {"content": "Urgent: the realtime tier first.",
                      "priority": "realtime",
                      "metadata": {"max_new_tokens": 32}})
    results += [_poll(base, rt)] + [_poll(base, m) for m in lows]
    if engine.preemptions <= pre0:
        raise AssertionError("[serve-spec] the REALTIME arrival preempted "
                             "no LOW row")
    tokens = _check_completed(results, "serve-spec REST")
    _until(lambda: _idle(engine), 60, "the spec engine idle")
    used, held, tree, pins = _pool_accounting(engine)
    if used != held:
        raise AssertionError(f"[serve-spec] {used} pages in use once idle, "
                             f"the tree and pins hold {held}")
    windows = engine.spec_windows - windows0
    steps = (ex.verify_replays - steps0) / windows
    per_row = ((engine.spec_commits_total - commits0)
               / (tally["row_windows"] - rows0))
    log(f"[serve-spec] {windows} windows ran {steps:.2f} steps each on "
        f"average and committed {per_row:.2f} tokens a row each")
    log(f"[serve-spec] {len(results)} REST requests completed ({tokens} "
        f"tokens): B=1, 8 concurrent, a two-turn conversation (turn 2 "
        f"cached_tokens {cached}), 8 LOW + a REALTIME that preempted "
        f"({engine.preemptions - pre0} preemption(s)); pages in use once "
        f"idle {used} = tree {tree} + pins {pins}; window boundaries while "
        f"8 decode: idle {', '.join(f'{g:.3f}' for g in gaps)} ms "
        f"({CARD})")
    return {"requests": len(results), "tokens": tokens,
            "turn2_cached_tokens": cached,
            "preemptions": engine.preemptions - pre0,
            "window_gap_ms": gaps, "windows": windows,
            "steps_per_window": steps, "tokens_per_row_window": per_row}


def _spec_tally(engine) -> dict:
    """Count, from the engine's own reconciles on, the drafted rows that
    each window observes into the acceptance histogram and the sum of
    their acceptances, and every committed row of a window."""
    tally = {"rows": 0, "sum": 0.0, "row_windows": 0}
    note = engine._note_spec_window

    def noting(pairs):
        tally["row_windows"] += len(pairs)
        for w, n in pairs:
            if w > 1:
                tally["rows"] += 1
                tally["sum"] += max(0, n - 1) / (w - 1)
        return note(pairs)

    engine._note_spec_window = noting
    return tally


def _spec_metrics(engine, base, tally) -> dict:
    """``get_stats()["speculation"]`` and the four ``/metrics`` families
    against the engine's own counters (the acceptance histogram against
    the drafted rows of every window since the engine was built)."""
    st = engine.get_stats()["speculation"]
    want = {"draft_k": SPEC_DRAFT_K, "windows": engine.spec_windows,
            "tokens_proposed": engine.spec_tokens_proposed,
            "tokens_accepted": engine.spec_tokens_accepted,
            "tokens_committed": engine.spec_commits_total,
            "fetches": engine.spec_fetches_total}
    if {k: st[k] for k in want} != want:
        raise AssertionError(f"[serve-spec] stats {st} vs counters {want}")
    samples, _ms = _scrape(base)
    name = engine.name
    got = {
        "proposed": _msum(samples, "llm_queue_spec_tokens_proposed_total",
                          engine=name),
        "accepted": _msum(samples, "llm_queue_spec_tokens_accepted_total",
                          engine=name),
        "cadence": _msum(samples, "llm_queue_spec_readback_cadence",
                         engine=name),
        "observed": _msum(samples, "llm_queue_spec_acceptance_rate_count",
                          engine=name),
        "observed_sum": _msum(samples, "llm_queue_spec_acceptance_rate_sum",
                              engine=name)}
    if (got["proposed"] != engine.spec_tokens_proposed
            or got["accepted"] != engine.spec_tokens_accepted
            or abs(got["cadence"] - engine.spec_commits_total
                   / engine.spec_fetches_total) > 1e-9
            or got["observed"] != tally["rows"] or not tally["rows"] > 0
            or abs(got["observed_sum"] - tally["sum"]) > 1e-6):
        raise AssertionError(f"[serve-spec] /metrics {got} vs the engine's "
                             f"{want}, drafted rows {tally}")
    log(f"[serve-spec] speculation stats {st}; /metrics spec families "
        f"{got} equal the engine's counters ({CARD})")
    return st


def phase_serve_spec(state) -> None:
    """Speculative decoding on the serve phase's weights (llama3-8b at
    full width and depth; the serve phase's ragged engine is released,
    its default engine kept for serve-plane when that phase runs):
    program identity of the verify window against plain decode (device
    accept on the fused and split routes, host accept, int8 KV), KV
    rollback, then an engine with speculation on serving over REST, and
    its rates with speculation off and on in turns."""
    import gc

    import numpy as np
    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.ops import kernels

    params = (state.get if {"serve-tiering", "serve-disagg",
                            "serve-scenarios"} & set(
        state.get("chosen", ())) else state.pop)("serve_params", None)
    if params is None:
        raise AssertionError("serve-spec runs on the serve phase's weights: "
                             "run serve before it")
    out = state.setdefault("serve_spec", {})
    launches = out.setdefault("launches", {})
    counts, restore = _count_plain_calls()
    spec = host = q8 = app = None
    try:
        cfg = _spec_cfg()
        t0 = time.perf_counter()
        spec = build_engine(cfg, params=params, name="engine-spec",
                            warmup=True)
        ex = spec.executor
        tally = _spec_tally(spec)
        _log_warmup(spec, "serve-spec")
        log(f"[serve-spec] engine with speculation on (draft_k "
            f"{SPEC_DRAFT_K}, ngram_max {SPEC_NGRAM_MAX}, device accept) on "
            f"the serve phase's weights, built in "
            f"{time.perf_counter() - t0:.1f} s; verify graphs "
            f"{sorted(ex.verify_graphs)}; {_switches(spec)}")
        rng = np.random.default_rng(0)
        rows = _spec_rows(ex, rng)
        # Gate 1: device accept, fused route (kernel 1).
        out["fused"] = _spec_identity(ex, rows, "device accept, fused")
        launches["fused_decode"] = out["fused"]["window_launches"].get(
            "fused_decode", 0)
        # Gate 2: the split route (kernels 4 + 8) and host accept.
        ex.fused_decode = False
        try:
            out["split"] = _spec_identity(ex, rows, "device accept, split")
        finally:
            ex.fused_decode = True
        w = out["split"]["window_launches"]
        if w.get("fused_decode") or not w.get("kv_cache_write") \
                or not w.get("paged_decode_attention"):
            raise AssertionError(f"split verify window launched {w}")
        for name in ("kv_cache_write", "paged_decode_attention"):
            launches[name] = w[name]
        out["window_ms"] = _spec_window_ms(ex, rows)
        host = _spec_executor(params, device_sampling=False)
        host_rows = _spec_rows(host, np.random.default_rng(0))
        out["host"] = _spec_identity(host, host_rows, "host accept, fused")
        # Gate 3: rollback at the executor (host accept) and through the
        # engines.
        out["rollback"] = _spec_rollback(host, host_rows)
        host.release_graphs()
        del host, host_rows
        host = None
        out["rollback_engine"] = _spec_rollback_engine(spec)
        # Gate 4: int8 KV (kernel 5), full depth, the same bf16 weights.
        q8 = _spec_executor(params, cache_dtype=torch.int8)
        out["int8_kv"] = _spec_identity(q8, _spec_rows(
            q8, np.random.default_rng(0)), f"device accept, int8 KV, full "
            f"depth ({q8.model_cfg.n_layers} layers)")
        w = out["int8_kv"]["window_launches"]
        if not w.get("fused_decode_q8") or w.get("fused_decode"):
            raise AssertionError(f"int8-KV verify window launched {w}")
        launches["fused_decode_q8"] = w["fused_decode_q8"]
        q8.release_graphs()
        del q8
        q8 = None
        gc.collect()
        torch.cuda.empty_cache()
        # Gate 5: serving over REST with speculation on.
        app = App(cfg, engine=spec)
        base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
        spec.generate("warm up the speculation path", max_new_tokens=4)
        kernels.reset_launches()
        out["rest"] = _spec_rest(spec, base, tally)
        torch.cuda.synchronize()
        served = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for name in ("fused_decode", "kv_prefill_write", "prefill_attention"):
            if not served.get(name):
                raise AssertionError(f"serve-spec REST never launched {name}:"
                                     f" {served}")
        for name in ("kv_prefill_write", "prefill_attention"):
            launches[name] = served[name]
        launches["fused_decode"] += served["fused_decode"]
        out["rest_launches"] = served
        out["speculation"] = _spec_metrics(spec, base, tally)
        app.stop()
        app = None
        out["rates"] = _spec_rates(spec, "serve-spec")
        # Gate 6: a chaos crash with a verify window in flight.
        kernels.reset_launches()
        out["chaos"] = _spec_chaos(spec)
        torch.cuda.synchronize()
        out["chaos_launches"] = {k: v for k, v in kernels.LAUNCHES.items()
                                 if v}
        if not out["chaos_launches"].get("fused_decode"):
            raise AssertionError(f"serve-spec chaos launched "
                                 f"{out['chaos_launches']}")
        log(f"[serve-spec] kernel launches of the chaos gate "
            f"{out['chaos_launches']}")
        serve = state.get("serve") or {}
        log(f"[serve-spec] for reference, the serve phase's engine "
            f"(speculation off, 32-token requests): B=1 "
            f"{serve.get('decode_tok_s_b1')} tok/s, 8 concurrent "
            f"{serve.get('tok_s_b8_e2e')} tok/s ({CARD})")
        log(f"[serve-spec] kernel launches in the phase {launches}; "
            f"speculation {spec.get_stats()['speculation']} ({CARD})")
    finally:
        if app is not None:
            app.stop()
        restore()
        for ex in (host, q8, spec.executor if spec is not None else None):
            if ex is not None:
                ex.release_graphs()
        del spec, host, q8, params
        gc.collect()
        torch.cuda.empty_cache()
    if counts:
        raise AssertionError(f"serve-spec called plain twins: {counts}")

# -- serve-tiering: the tiered KV plane -----------------------------------------

#: Turn 1's prompt tokens (one byte each): a history of 1536 tokens, 97
#: pages of 16 with turn 1's sampled tokens.
TIER_HISTORY = 1536
TIER_T1_NEW = 16
TIER_T2_NEW = 32
TIER_T2_PROMPT = " Now answer the question above in one short line, please."
#: Host capacity in conversations of that history: one fits, two do not
#: (the second demotion spills the first to the store).
TIER_HOST_CONVS = 1.5
#: Decode rows and their new tokens while a conversation demotes.
TIER_DECODE_ROWS = 8
TIER_DECODE_NEW = 160


def _tier_history() -> str:
    """The history every conversation of the phase starts with: TIER_HISTORY
    bytes of words drawn from seed 0 (the same text for each, so turn 2's
    tokens compare across tiers)."""
    import numpy as np

    words = ("queue tier page cache token prefill decode host store card "
             "pinned memory conversation request latency budget").split()
    rng = np.random.default_rng(0)
    text = ""
    while len(text) < TIER_HISTORY:
        text += words[int(rng.integers(len(words)))] + " "
    return text[:TIER_HISTORY]


def _tier_page_bytes(mc, int8_kv: bool) -> int:
    """Bytes of one page's payload over every cache leaf."""
    gd = mc.n_kv_heads * mc.head_dim
    if int8_kv:
        return mc.n_layers * PS * gd * 2 + 2 * mc.n_layers * mc.n_kv_heads \
            * PS * 2
    return mc.n_layers * PS * gd * 2 * 2


def _tier_cfg(work: str, tag: str, int8_kv: bool):
    """The serve config with ``executor.kv_tiering`` on, a host tier of
    TIER_HOST_CONVS conversations and the conversation store in SQLite
    under the phase's directory."""
    from llmq_tpu_torch.models.llama import get_config

    cfg = _serve_cfg()
    if int8_kv:
        cfg.model.kv_quantization = "int8"
    mc = get_config(cfg.model.name, max_seq_len=cfg.model.max_seq_len)
    pages = -(-(TIER_HISTORY + TIER_T1_NEW) // PS)
    kt = cfg.executor.kv_tiering
    kt.enabled = True
    kt.host_capacity_mb = int(-(-TIER_HOST_CONVS * pages
                                 * _tier_page_bytes(mc, int8_kv) // 2**20))
    cfg.persistence.backend = "sqlite"
    cfg.persistence.sqlite_path = os.path.join(work, f"{tag}.db")
    return cfg


class _TierProbe:
    """The phase's instrumentation of a tiered engine (removed by
    ``close``): every handle the engine's submit made, by request id; the
    pages each ``import_kv_pages`` wrote; the host seconds of each
    ``export_kv_pages`` dispatch."""

    def __init__(self, engine) -> None:
        self.engine, self.ex = engine, engine.executor
        self.handles, self.imports, self.export_s = {}, [], []
        submit, imp, exp = (engine.submit, self.ex.import_kv_pages,
                            engine._tiering._export)

        def submitting(req, **kw):
            h = submit(req, **kw)
            self.handles[req.id] = h
            return h

        def importing(pages, leaves):
            self.imports.append(list(pages))
            return imp(pages, leaves)

        def exporting(pages):
            t0 = time.perf_counter()
            out = exp(pages)
            self.export_s.append(time.perf_counter() - t0)
            return out

        engine.submit = submitting
        self.ex.import_kv_pages = importing
        # The plane took the executor's export seam at construction.
        self._plane_export = engine._tiering._export
        engine._tiering._export = exporting

    def close(self) -> None:
        self.engine.__dict__.pop("submit", None)
        self.ex.__dict__.pop("import_kv_pages", None)
        self.engine._tiering._export = self._plane_export

    def turn(self, base, conv: str, text: str, new: int):
        """One REST turn of ``conv``; returns the engine's handle."""
        eng = self.engine
        if eng._prefix_cache is not None:
            # Only the tier under test may serve the history: the radix
            # tree would otherwise hand the same blocks over.
            eng._prefix_cache.invalidate_all()
        mid = _post(base, {"content": text, "conversation_id": conv,
                           "priority": "high",
                           "metadata": {"max_new_tokens": new}})
        m = _poll(base, mid)
        if m["status"] != "completed":
            raise AssertionError(f"{conv}: turn not completed: {m}")
        h = self.handles[mid]
        if h.result.finish_reason not in ("eos", "length"):
            raise AssertionError(f"{conv}: finished {h.result}")
        return h

    def pin(self, conv: str):
        """The conversation's pinned pages, written length and a device
        copy of those pages of every leaf (the bytes a demotion gathers)."""
        import torch

        with self.engine._mu:
            kv = self.engine._conv_cache[conv]
            pages, length = list(kv.pages), kv.length
        idx = torch.tensor(pages, device=self.ex.device)
        return pages, length, {k: t.index_select(1, idx)
                               for k, t in self.ex.cache.items()}

    def same_bytes(self, pages, length: int, snap) -> None:
        """The history slots [0, length) of ``pages`` hold, bit for bit,
        the bytes of ``snap`` (every leaf: values and scale pools)."""
        import torch

        idx = torch.tensor(pages, device=self.ex.device)
        full, rem = divmod(length, PS)
        for k, t in self.ex.cache.items():
            now, ref = t.index_select(1, idx), snap[k]
            if k.endswith("_scale"):   # (L, N, H_kv, page_size)
                parts = [(now[:, :full], ref[:, :full]),
                         (now[:, full, :, :rem], ref[:, full, :, :rem])]
            else:                      # (L, N, page_size, H_kv * D)
                parts = [(now[:, :full], ref[:, :full]),
                         (now[:, full, :rem], ref[:, full, :rem])]
            for a, b in parts:
                if not torch.equal(a.contiguous().view(torch.uint8),
                                   b.contiguous().view(torch.uint8)):
                    raise AssertionError(f"promoted {k} pages differ from "
                                         f"the demoted bytes")


def _tier_settled(plane, conv: str, tier: str) -> bool:
    with plane._mu:
        e = plane._entries.get(conv)
        return (e is not None and e.ready.is_set() and not e.spilling
                and e.tier == tier)


def _ttft_ms(h) -> float:
    return (h.marks["first_token"] - h.submitted_at) * 1e3


def _tier_transfer(probe, name: str):
    """(device ms, bytes) of the executor's last ``name`` transfer."""
    start, end, nbytes = probe.ex.kv_last_transfer[name]
    end.synchronize()
    return start.elapsed_time(end), nbytes


def _tier_routes(probe, base, plane, tag: str) -> dict:
    """Turn 2 of one history through each tier, at B=1 on an idle engine:
    HBM (pin resident), host, store (spilled by a second conversation's
    demotion into the SQLite store) and recompute (no host room, no
    spill), each gated as the phase says."""
    eng = probe.engine
    hist = _tier_history()
    out: dict = {"ttft_ms": {}}

    def first(conv):
        probe.turn(base, conv, hist, TIER_T1_NEW)
        return probe.pin(conv)

    def second(conv, tier):
        n_imp = len(probe.imports)
        h = probe.turn(base, conv, TIER_T2_PROMPT, TIER_T2_NEW)
        if h.result.kv_tier != tier:
            raise AssertionError(f"{tag} {conv}: served from "
                                 f"{h.result.kv_tier!r}, not {tier!r}")
        out["ttft_ms"].setdefault(tier, []).append(_ttft_ms(h))
        return h, probe.imports[n_imp:]

    def demote(conv, tier):
        d0 = plane.stats()
        eng.demote_conversation(conv)
        _until(lambda: _tier_settled(plane, conv, tier), 120,
               f"{conv} demoted to {tier}")
        d1 = plane.stats()
        return d1["d2h_ms"] - d0["d2h_ms"], d1["d2h_bytes"] - d0["d2h_bytes"]

    # HBM: the pin stays resident; its turn 2 is every tier's reference.
    first("tier-hbm")
    ref, _ = second("tier-hbm", "hbm")
    eng.drop_conversation("tier-hbm")
    want = ref.result.tokens
    # Host.
    pages, length, snap = first("tier-host")
    d2h_ms, d2h_bytes = demote("tier-host", "host")
    gather_ms, gather_bytes = _tier_transfer(probe, "gather")
    h, imps = second("tier-host", "host")
    if len(imps) != 1:
        raise AssertionError(f"{tag}: host promotion injected {imps}")
    probe.same_bytes(imps[0], length, snap)
    h2d_ms, h2d_bytes = _tier_transfer(probe, "h2d")
    inject_ms, _ = _tier_transfer(probe, "inject")
    if h.result.tokens != want:
        raise AssertionError(f"{tag}: host-tier turn 2 {h.result.tokens} != "
                             f"the resident pin's {want}")
    eng.drop_conversation("tier-host")
    out["transfer"] = {
        "pages": len(pages), "bytes": d2h_bytes,
        "export_dispatch_ms": probe.export_s[-1] * 1e3,
        "gather_ms": gather_ms, "d2h_ms": d2h_ms, "h2d_ms": h2d_ms,
        "inject_ms": inject_ms,
        "d2h_gb_s": d2h_bytes / d2h_ms / 1e6 if d2h_ms else None,
        "h2d_gb_s": h2d_bytes / h2d_ms / 1e6 if h2d_ms else None,
        "gather_gb_s": 2 * gather_bytes / gather_ms / 1e6}
    del snap
    # Store: the second demotion spills the first (the colder) to SQLite.
    pages_s, length_s, snap_s = first("tier-store")
    demote("tier-store", "host")
    pages_d, length_d, snap_d = first("tier-host2")
    demote("tier-host2", "host")
    _until(lambda: _tier_settled(plane, "tier-store", "store"), 120,
           "the first conversation spilled to the store")
    if plane.store.load_kv("tier-store") is None:
        raise AssertionError(f"{tag}: no blob in the SQLite store")
    h, imps = second("tier-store", "store")
    probe.same_bytes(imps[-1], length_s, snap_s)
    if h.result.tokens != want:
        raise AssertionError(f"{tag}: store-tier turn 2 != the resident "
                             f"pin's")
    eng.drop_conversation("tier-store")
    del snap_s
    # Recompute: no spill, and the host tier full with tier-host2.
    plane.store_spill = False
    rec = []
    try:
        for conv in ("tier-recompute", "tier-recompute2"):
            first(conv)
            demote(conv, "recompute")
            h, imps = second(conv, "recompute")
            if imps:
                raise AssertionError(f"{tag}: recompute injected {imps}")
            rec.append(h.result.tokens)
            eng.drop_conversation(conv)
    finally:
        plane.store_spill = True
    if rec[0] != rec[1]:
        raise AssertionError(f"{tag}: two recomputes of one history "
                             f"differ: {rec}")
    out["recompute_agrees"] = next(
        (i for i, (a, b) in enumerate(zip(rec[0], want)) if a != b),
        len(want))
    # The second host entry, promoted after all that.
    h, imps = second("tier-host2", "host")
    probe.same_bytes(imps[-1], length_d, snap_d)
    if h.result.tokens != want:
        raise AssertionError(f"{tag}: second host-tier turn 2 != the "
                             f"resident pin's")
    eng.drop_conversation("tier-host2")
    st = plane.stats()
    want_hits = {"hbm": 1, "host": 2, "store": 1, "recompute": 2}
    if st["hits"] != want_hits:
        raise AssertionError(f"{tag}: hits {st['hits']} != {want_hits}")
    for k in ("inject_failures", "transfer_errors", "store_errors"):
        if st[k]:
            raise AssertionError(f"{tag}: {k} = {st[k]}: {st}")
    out["stats"] = st
    return out


def _tier_decode(probe, base, plane, tag: str) -> dict:
    """Eight rows decoding TIER_DECODE_NEW tokens while a pinned history
    demotes: each chunk's device ms a step and the device idle at each
    chunk boundary (the chunks' own CUDA events), for the chunks before
    the demotion and from it on."""
    from llmq_tpu_torch.engine.engine import GenRequest

    eng, ex = probe.engine, probe.ex
    probe.turn(base, "tier-decode", _tier_history(), TIER_T1_NEW)
    chunks, marks = [], {}
    real = ex.decode_chunk_start

    def recording(*args, **kwargs):
        h = real(*args, **kwargs)
        chunks.append(h)
        return h

    ex.decode_chunk_start = recording
    try:
        hs = [eng.submit(GenRequest(
            id=f"tier-row-{i}-{time.time()}",
            prompt=f"{i:02d} row. " + PRESSURE_FILLER,
            max_new_tokens=TIER_DECODE_NEW)) for i in range(TIER_DECODE_ROWS)]
        _until(lambda: _decoding_rows(eng) == TIER_DECODE_ROWS
               and len(chunks) >= 4, 120, "8 rows decoding")
        marks["demote"] = len(chunks)
        eng.demote_conversation("tier-decode")
        _until(lambda: _tier_settled(plane, "tier-decode", "host"), 120,
               "the demotion while decoding")
        marks["settled"] = len(chunks)
        _until(lambda: len(chunks) >= marks["settled"] + 3, 120,
               "chunks after the demotion")
        for h in hs:
            if not h.wait(300):
                raise AssertionError("a decode row did not finish")
    finally:
        ex.__dict__.pop("decode_chunk_start", None)
    eng.drop_conversation("tier-decode")
    chunks[-1].wait_ready()
    step = [c._start.elapsed_time(c._done) / c.steps for c in chunks]
    gaps = [a._done.elapsed_time(b._start) for a, b in zip(chunks,
                                                          chunks[1:])]
    k0, k1 = marks["demote"], marks["settled"]
    return {"chunks": len(chunks), "demote_at_chunk": k0,
            "settled_at_chunk": k1,
            "export_dispatch_ms": probe.export_s[-1] * 1e3,
            "step_ms_before": step[1:k0 - 1],
            "step_ms_during": step[k0 - 1:k1 + 1],
            "gap_ms_before": gaps[1:k0 - 1],
            "gap_ms_during": gaps[k0 - 1:k1 + 1]}


#: The fault-domain conversations' history (bytes = tokens) with turn 1's
#: tokens: 16 pages, a 32 MiB blob in bf16, which SQLite writes and reads
#: well inside the store's 0.25 s deadline.
TIER_FAULT_HISTORY = 240
#: The store fault domain of the phase: the deadline, the store.kv stall
#: (past the deadline) and the breaker's quick backoff.
TIER_OP_TIMEOUT_S = 0.25
TIER_STALL_MS = 2000.0


def _tier_fault_domain(probe, base, app, plane, tag: str) -> dict:
    """The store tier's promotions behind ``wrap_store(...,
    op_timeout_s=0.25)`` over the phase's SQLite store (the state manager
    and the plane re-wired to it, as ``App`` wires ``store.resilience``):
    turn 2 of a 240-token history by recompute (demoted without its
    payload), from the healthy store, and from the store while a chaos
    ``store.kv`` rule stalls it 2 s. The two store conversations spill
    (no host room) before the wrap: a 32 MiB SQLite write with its sync
    can outlast the deadline (it did on the H100 machine), and what the
    deadline guards here is the promotion path.
    Gates: the stalled turn completes by recompute on kernels 2 and 3
    within the recompute turn's TTFT + op_timeout_s x (retries + 1) +
    1 s; ``/health``'s ``store`` block counts the stall's deadline
    misses; once the rule is gone and a probe succeeds, the replay
    buffer drains to 0. The stall is armed on a healthy store: the
    healthy turn's clean-up (the delete of its 32 MiB blob, through the
    wrapper) can itself miss the deadline, and then the probe recovers
    the store first; those misses are printed apart. Then, with no
    chaos, one more conversation spills through the wrapper itself at
    op_timeout_s: its SQLite write is timed, and a deadline miss must
    show as one timeout in ``/health``, one store error in the plane and
    turn 2 by recompute (a write within the deadline, as the store
    tier)."""
    import torch

    from llmq_tpu_torch import chaos
    from llmq_tpu_torch.conversation.resilience import wrap_store
    from llmq_tpu_torch.conversation.state_manager import StateManager
    from llmq_tpu_torch.core.config import (BreakerConfig, ChaosConfig,
                                            StoreResilienceConfig)
    from llmq_tpu_torch.ops import kernels

    eng = probe.engine
    rcfg = StoreResilienceConfig(
        enabled=True, op_timeout_s=TIER_OP_TIMEOUT_S, timeout_threshold=1,
        probe_interval_s=0.05, seed=16,
        breaker=BreakerConfig(base_backoff=0.15, max_backoff=0.6,
                              jitter=0.0))
    hist = _tier_history()[:TIER_FAULT_HISTORY]
    host_max = plane.host_max_conversations
    export = plane._export
    ttft, tiers, spill_ms = {}, {}, []
    inner_ms = {"save_kv": [], "delete_kv": []}
    store = None

    def demoted(conv, tier):
        probe.turn(base, conv, hist, TIER_T1_NEW)
        t0 = time.perf_counter()
        eng.demote_conversation(conv)
        _until(lambda: _tier_settled(plane, conv, tier), 120,
               f"{conv} demoted to {tier}")
        return (time.perf_counter() - t0) * 1e3

    def turn2(conv, case):
        h = probe.turn(base, conv, TIER_T2_PROMPT, TIER_T2_NEW)
        ttft[case] = _ttft_ms(h)
        tiers[case] = h.result.kv_tier
        eng.drop_conversation(conv)
        return h

    def timed(name):
        """The inner SQLite op ``name``, timed on the wrapper's worker."""
        real = getattr(store.inner, name)

        def op(*args):
            t = time.perf_counter()
            try:
                return real(*args)
            finally:
                inner_ms[name].append((time.perf_counter() - t) * 1e3)
        setattr(store.inner, name, op)

    def recovered(what):
        """Every plane job queued so far has run (a blob delete among
        them); then probe until the store is healthy and the state
        manager's journal has drained."""
        if not plane.flush_jobs(30):
            raise AssertionError(f"{tag}: the plane's jobs did not run "
                                 f"({what})")

        def healthy():
            if store.degraded:
                try:
                    store.list_kv()      # the probe: its success recovers
                except Exception:  # noqa: BLE001 — shed until it is due
                    pass
            return not store.degraded and sm.replay_pending() == 0
        _until(healthy, 10, f"the store recovered ({what})", poll=0.01)

    try:
        # Recompute: a demotion without its payload (no export) keeps the
        # token stream only.
        plane._export = None
        try:
            demoted("fault-recompute", "recompute")
        finally:
            plane._export = export
        want = turn2("fault-recompute", "recompute").result.tokens
        # With no host room each demotion spills at once, to the raw
        # store.
        plane.host_max_conversations = 0
        for conv in ("fault-healthy", "fault-stall"):
            spill_ms.append(demoted(conv, "store"))
        store = wrap_store(app.state_manager.store, rcfg)
        for name in inner_ms:
            timed(name)
        sm = StateManager(app.cfg.conversation, store=store)
        eng.attach_conversation_manager(sm)
        app.state_manager = app.api.state_manager = sm
        plane.store = store
        turn2("fault-healthy", "healthy store")
        if tiers != {"recompute": "recompute", "healthy store": "store"}:
            raise AssertionError(f"{tag}: turn 2 tiers {tiers}")
        recovered("before the stall")
        timeouts0 = store.resilience_stats()["timeouts"]
        # The stalled store: every store.kv op sleeps past the deadline.
        inj = chaos.configure(ChaosConfig(enabled=True, seed=16))
        inj.add_rule("store.kv", kind="latency", latency_ms=TIER_STALL_MS)
        kernels.reset_launches()
        h = turn2("fault-stall", "stalled store")
        torch.cuda.synchronize()
        stall_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        # A write while the store is degraded journals.
        probe.turn(base, "fault-journal", "One more line.", 4)
        status, health, _ra = _http_status("GET", f"{base}/health")
        fired = dict(inj.get_stats()["injected"])
        chaos.configure(None)
        journaled = sm.replay_pending()
        recovered("after the stall")
        after = store.resilience_stats()
        # A spill behind the deadline, with no chaos: the SQLite write
        # itself against op_timeout_s, timed on the wrapper's worker.
        n_saves = len(inner_ms["save_kv"])
        spill = {"timeouts0": after["timeouts"],
                 "errors0": plane.store_errors}
        probe.turn(base, "fault-spill", hist, TIER_T1_NEW)
        t0 = time.perf_counter()
        eng.demote_conversation("fault-spill")
        _until(lambda: _tier_settled(plane, "fault-spill", "store")
               or _tier_settled(plane, "fault-spill", "recompute"), 120,
               "fault-spill demoted")
        spill["settled_ms"] = (time.perf_counter() - t0) * 1e3
        _until(lambda: len(inner_ms["save_kv"]) > n_saves, 30,
               "the inner SQLite write")
        spill["inner_ms"] = inner_ms["save_kv"][n_saves:]
        spill["timeouts"] = (store.resilience_stats()["timeouts"]
                             - spill["timeouts0"])
        spill["store_errors"] = plane.store_errors - spill["errors0"]
        _st, spill["health"], _ra = _http_status("GET", f"{base}/health")
        spill_h = turn2("fault-spill", "spill behind the deadline")
        recovered("after the spill")
    finally:
        chaos.configure(None)
        plane.host_max_conversations = host_max
        plane._export = export
        if store is not None:
            for name in inner_ms:
                store.inner.__dict__.pop(name, None)
    bound = (ttft["recompute"]
             + rcfg.op_timeout_s * (rcfg.retries + 1) * 1e3 + 1e3)
    blk = health.get("store") or {}
    if (tiers["stalled store"] != "recompute"
            or ttft["stalled store"] > bound
            or h.result.tokens != want):
        raise AssertionError(f"{tag}: stalled store turn 2 from "
                             f"{tiers['stalled store']} in "
                             f"{ttft['stalled store']:.1f} ms (bound "
                             f"{bound:.1f})")
    for name in ("kv_prefill_write", "prefill_attention"):
        if not stall_launches.get(name):
            raise AssertionError(f"{tag}: the stalled turn never launched "
                                 f"{name}: {stall_launches}")
    if (status != 200 or blk.get("timeouts", 0) - timeouts0 < 1
            or not fired or journaled < 1 or after["degraded"]):
        raise AssertionError(f"{tag}: /health store block {blk} (timeouts "
                             f"before the stall {timeouts0}), fired "
                             f"{fired}, journaled {journaled}, after "
                             f"{after}")
    # The spill's outcome must follow the wrapper's deadline: a miss is
    # one timeout in /health, one store error in the plane and turn 2 by
    # recompute; a write within it (under op_timeout_s by its own clock)
    # leaves turn 2 to the store tier.
    sblk = spill["health"].get("store") or {}
    spill_tier = tiers["spill behind the deadline"]
    if spill["timeouts"]:
        ok = (spill["timeouts"] == 1 and spill["store_errors"] == 1
              and sblk.get("timeouts") == spill["timeouts0"] + 1
              and spill_tier == "recompute")
    else:
        ok = (spill["store_errors"] == 0 and spill_tier == "store"
              and spill["inner_ms"][0] <= rcfg.op_timeout_s * 1e3)
    ok = ok and spill_h.result.tokens == want
    if not ok:
        raise AssertionError(f"{tag}: spill behind the deadline: write "
                             f"{spill['inner_ms']} ms, timeouts "
                             f"{spill['timeouts']}, store_errors "
                             f"{spill['store_errors']}, /health store "
                             f"{sblk}, turn 2 from {spill_tier}")
    log(f"[serve-tiering] {tag}: store fault domain (op_timeout_s "
        f"{rcfg.op_timeout_s}, a {TIER_FAULT_HISTORY}-token history): "
        f"turn-2 TTFT ms healthy store {ttft['healthy store']:.2f}, "
        f"stalled store ({TIER_STALL_MS:.0f} ms store.kv latency) "
        f"{ttft['stalled store']:.2f} by recompute (bound {bound:.1f}), "
        f"recompute {ttft['recompute']:.2f}; /health store block "
        f"timeouts {blk.get('timeouts')}, timeout_degraded "
        f"{blk.get('timeout_degraded')}, replay_pending "
        f"{blk.get('replay_pending')}; {journaled} journaled write(s) "
        f"drained after the probe; chaos {fired}; the stalled turn's "
        f"launches {stall_launches}; the two spills to the raw store "
        f"settled in {', '.join(f'{x:.1f}' for x in spill_ms)} ms; before "
        f"the stall the store missed the deadline {timeouts0} time(s) and "
        f"recovered; the blob deletes through the wrapper took "
        f"{[round(x, 1) for x in inner_ms['delete_kv']]} ms in SQLite "
        f"({CARD})")
    log(f"[serve-tiering] {tag}: a spill behind the wrapper at op_timeout_s "
        f"{rcfg.op_timeout_s}: the SQLite write took "
        f"{spill['inner_ms'][0]:.1f} ms, the demotion settled in "
        f"{spill['settled_ms']:.1f} ms as {spill_tier}; deadline misses "
        f"+{spill['timeouts']}, plane store_errors +{spill['store_errors']}, "
        f"/health store timeouts {sblk.get('timeouts')}; turn 2 TTFT "
        f"{ttft['spill behind the deadline']:.2f} ms from {spill_tier} "
        f"({CARD})")
    return {"ttft_ms": ttft, "bound_ms": bound, "health_store": blk,
            "spill_settled_ms": spill_ms,
            "spill_behind_deadline": {k: v for k, v in spill.items()
                                      if k != "health"},
            "journaled": journaled, "injected": fired,
            "timeouts_before_stall": timeouts0, "sqlite_ms": inner_ms,
            "stall_launches": stall_launches}


def _tier_engine(params, work, tag: str, int8_kv: bool) -> dict:
    """One tiered engine (bf16 weights; bf16 or int8 KV) through REST."""
    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.ops import kernels

    cfg = _tier_cfg(work, tag, int8_kv)
    t0 = time.perf_counter()
    engine = build_engine(cfg, params=params, name=f"engine-{tag}",
                          warmup=True)
    plane = engine._tiering
    app = probe = None
    try:
        if plane is None or not plane.pool.pinned:
            raise AssertionError(f"{tag}: no plane, or its host arena is not "
                                 f"pinned")
        log(f"[serve-tiering] {tag}: engine built in "
            f"{time.perf_counter() - t0:.1f} s; host tier "
            f"{cfg.executor.kv_tiering.host_capacity_mb} MiB pinned, "
            f"{plane.pool.total_buffers} buffers of "
            f"{plane.pool.page_nbytes} bytes; leaves "
            f"{engine.executor.kv_page_spec()}")
        app = App(cfg, engine=engine)
        base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
        if plane.store is not app.state_manager.store:
            raise AssertionError(f"{tag}: the plane spills elsewhere than "
                                 f"the conversation store")
        engine.generate("warm up the tiering engine", max_new_tokens=4)
        probe = _TierProbe(engine)
        kernels.reset_launches()
        out = _tier_routes(probe, base, plane, tag)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        need = (("fused_decode_q8",) if int8_kv else
                ("fused_decode", "kv_prefill_write", "prefill_attention"))
        for name in need:
            if not launches.get(name):
                raise AssertionError(f"{tag}: the tiers never launched "
                                     f"{name}: {launches}")
        if int8_kv and launches.get("fused_decode"):
            raise AssertionError(f"{tag}: a bf16-pool kernel launched")
        out["launches"] = launches
        t = out["transfer"]
        tt = {k: [round(x, 3) for x in v] for k, v in out["ttft_ms"].items()}
        log(f"[serve-tiering] {tag}: turn-2 TTFT from engine submit, ms: "
            f"{tt}; recompute agrees with the resident pin for "
            f"{out['recompute_agrees']} of {TIER_T2_NEW} tokens ({CARD})")
        log(f"[serve-tiering] {tag}: {t['pages']} pages, {t['bytes']} "
            f"bytes: export dispatch {t['export_dispatch_ms']:.3f} ms on "
            f"the calling thread, gather {t['gather_ms']:.3f} ms on the "
            f"device ({t['gather_gb_s']:.1f} GB/s read+write), D2H "
            f"{t['d2h_ms']:.3f} ms ({_count(t['d2h_gb_s'], 1)} GB/s), H2D "
            f"{t['h2d_ms']:.3f} ms ({_count(t['h2d_gb_s'], 1)} GB/s), inject "
            f"{t['inject_ms']:.3f} ms ({CARD})")
        log(f"[serve-tiering] {tag}: hits {out['stats']['hits']}, spills "
            f"{out['stats']['spills']}, launches {launches}; no inject, "
            f"transfer or store failure")
        if not int8_kv:
            dec = _tier_decode(probe, base, plane, tag)
            out["decode_under_demotion"] = dec
            log(f"[serve-tiering] {tag}: {TIER_DECODE_ROWS} rows decoding "
                f"while a {TIER_HISTORY}-token history demotes: step ms "
                f"before {[round(x, 3) for x in dec['step_ms_before']]}, "
                f"during {[round(x, 3) for x in dec['step_ms_during']]}; "
                f"chunk-boundary idle ms before "
                f"{[round(x, 4) for x in dec['gap_ms_before']]}, during "
                f"{[round(x, 4) for x in dec['gap_ms_during']]}; its export "
                f"dispatched in {dec['export_dispatch_ms']:.3f} ms ({CARD})")
            out["fault_domain"] = _tier_fault_domain(probe, base, app,
                                                     plane, tag)
        return out
    finally:
        if probe is not None:
            probe.close()
        if app is not None:
            app.stop()
        engine.executor.release_graphs()


def phase_serve_tiering(state) -> None:
    """The tiered KV plane on the serve phase's weights (llama3-8b bf16 at
    full width and depth), two engines with ``executor.kv_tiering``
    enabled, bf16 KV then int8 KV, driven over REST."""
    import gc
    import shutil

    import torch

    from llmq_tpu_torch.ops.kernels import BUILD_DIR

    params = (state.get if {"serve-disagg", "serve-scenarios"} & set(
        state.get("chosen", ())) else state.pop)("serve_params", None)
    if params is None:
        raise AssertionError("serve-tiering runs on the serve phase's "
                             "weights: run serve before it")
    work = str(BUILD_DIR / "serve_tiering")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = state.setdefault("serve_tiering", {})
    counts, restore = _count_plain_calls()
    try:
        for tag, int8_kv in (("tier-bf16", False), ("tier-int8kv", True)):
            out[tag] = _tier_engine(params, work, tag, int8_kv)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        restore()
        del params
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(work, ignore_errors=True)
    if counts:
        raise AssertionError(f"serve-tiering called plain twins: {counts}")



# -- serve-tenancy: the tenancy plane on the card ------------------------------

#: The phase's tenant classes: gold and bronze at 4:1, metered by a token
#: bucket, capped at one message in flight and two queued.
TENANTS = {"gold": {"weight": 4.0}, "bronze": {"weight": 1.0},
           "metered": {"token_rate": 200.0, "burst_tokens": 400.0},
           "capped": {"max_inflight": 1, "max_queue_depth": 2}}
TENANT_DECODE_NEW = 128         # a. four gold and four bronze rows
TENANT_BACKLOG = 40             # b. messages per tenant, queued first
TENANT_BACKLOG_NEW = 32
TENANT_BAND = (4 * 0.6, 4 * 1.6)  # b. JAX's convergence band
TENANT_PROMPT = 1500            # c. the capped prompts' tokens
TENANT_RAGGED_ROWS = 6          # c. rows decoding meanwhile
TENANT_RAGGED_NEW = 384
#: The keys of JAX's ``GET /api/v1/tenancy`` (llmq_tpu/api/server.py
#: get_tenancy, registry.snapshot, FairScheduler.snapshot).
TENANCY_KEYS = {"enabled", "tenants", "rejections", "fair"}
TENANCY_TENANT_KEYS = {"weight", "queued", "inflight"}
TENANCY_FAIR_KEYS = {"virtual_times", "virtual_floor", "backlog",
                     "served_tokens", "share_ratios"}
TENANCY_FAMILIES = ("llm_queue_tenant_virtual_time",
                    "llm_queue_tenant_share_ratio",
                    "llm_queue_tenant_quota_rejections_total",
                    "llm_queue_tenant_inflight",
                    "llm_queue_tenant_registry_evictions_total")


def _tenancy_cfg(ragged: bool = False):
    from llmq_tpu_torch.core.config import TenancyConfig

    cfg = _serve_cfg()
    cfg.executor.ragged_attention.enabled = ragged
    cfg.tenancy = TenancyConfig(enabled=True, tenants={
        k: dict(v) for k, v in TENANTS.items()})
    return cfg


def _post_tenant(base, tenant, body):
    """POST one message as ``tenant`` (``X-Tenant-Id``): (status,
    payload, Retry-After header)."""
    req = urllib.request.Request(
        f"{base}/api/v1/messages", method="POST",
        data=json.dumps({**body, "timeout": MESSAGE_TIMEOUT_S}).encode(),
        headers={"Content-Type": "application/json", "X-Tenant-Id": tenant})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _tenant_prompt(tenant: str, i: int, n: int) -> str:
    """A prompt of ``n`` bytes that starts with its own tenant and number,
    so no two share a cached page."""
    head = f"{i:03d} {tenant}: "
    body = ("The queue serves tenants by weight; summarise its state, "
            "then list each tier with its backlog and deadline. ")
    return (head + body * (n // len(body) + 1))[:n]


def _fair_expect(budgets, tenant_of, weights):
    """Per-tenant budget sums the fairness rule gives for ``budgets``
    (order → budget): the port's ``weighted_token_caps`` and the JAX
    engine's scaling (a tenant over its cap scaled by cap / sum, floor,
    every row of budget > 1 kept at least 1)."""
    from llmq_tpu_torch.tenancy import weighted_token_caps

    by = {}
    for o, b in budgets.items():
        by.setdefault(tenant_of[o], []).append(b)
    if len(by) < 2 or sum(budgets.values()) <= 0:
        return {t: sum(bs) for t, bs in by.items()}
    caps = weighted_token_caps({t: weights[t] for t in by},
                               sum(budgets.values()))
    out = {}
    for t, bs in by.items():
        s = sum(bs)
        if s <= caps[t]:
            out[t] = s
        else:
            out[t] = sum(max(1, int(b * caps[t] / s)) if b > 1 else b
                         for b in bs)
    return out


class _FairnessProbe:
    """Records every call of the engine's ``_apply_decode_fairness``: the
    budgets before and after, and each row's tenant."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.calls = []
        orig = engine._apply_decode_fairness

        def record(rows, budgets):
            before = dict(budgets)
            tenant_of = {s.order: s.req.tenant_id for s in rows}
            orig(rows, budgets)
            self.calls.append((before, dict(budgets), tenant_of))
        engine._apply_decode_fairness = record

    def close(self) -> None:
        self.engine.__dict__.pop("_apply_decode_fairness", None)


class _PackProbe:
    """Records every prefill pack of the engine module: the tenant caps
    and each slice's (request id, tenant, first position, token ids), and
    each packed prompt's whole remaining ids the first time it is seen."""

    def __init__(self) -> None:
        from llmq_tpu_torch.engine import engine as engmod

        self.mod = engmod
        self.orig = engmod._pack_prefill_slices
        self.plans = []
        self.prompts = {}

        def pack(cands, S, T, budget, caps):
            for s in cands:
                self.prompts.setdefault(s.req.id, (s.todo_pos,
                                                   list(s.todo_ids)))
            plan = self.orig(cands, S, T, budget, caps)
            self.plans.append((caps, [(s.req.id, s.req.tenant_id,
                                       s.todo_pos, list(sl))
                                      for s, sl in plan]))
            return plan
        engmod._pack_prefill_slices = pack

    def close(self) -> None:
        self.mod._pack_prefill_slices = self.orig


def _decode_fairness(engine, base) -> dict:
    """a. Four gold and four bronze requests admitted together: every
    contended chunk's budgets follow the rule, every request completes;
    each tenant's tok/s while both decode (sampled every 5 ms)."""
    weights = {t: v.get("weight", 1.0) for t, v in TENANTS.items()}
    probe = _FairnessProbe(engine)
    seen = {}
    both = []               # (t, {tenant: tokens}) while both decode
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            now, rows = time.perf_counter(), {}
            for s in list(engine._slots):
                if s is not None and s.prefilled:
                    rows.setdefault(s.req.tenant_id, 0)
                    seen[s.req.id] = (s.req.tenant_id, len(s.generated))
                    rows[s.req.tenant_id] += 1
            if len(rows) >= 2:
                tot = {}
                for t, n in seen.values():
                    tot[t] = tot.get(t, 0) + n
                both.append((now, tot))
            time.sleep(0.005)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        mids = []
        # Admitted together, so every run decodes the same batch.
        with engine.paused():
            for i in range(4):
                for t in ("gold", "bronze"):
                    s, r, _ = _post_tenant(base, t, {
                        "content": _tenant_prompt(t, i, 200),
                        "metadata": {"max_new_tokens": TENANT_DECODE_NEW}})
                    if s != 202:
                        raise AssertionError(f"a: {t} request refused: "
                                             f"{s} {r}")
                    mids.append(r["message_id"])
            _until(lambda: len(engine._inbox) >= 8, 60, "8 admissions")
        results = [_poll(base, m) for m in mids]
    finally:
        stop.set()
        th.join()
        probe.close()
    for m in results:
        u = m["metadata"].get("usage", {})
        n = u.get("completion_tokens")
        if m["status"] != "completed" or not (
                (u.get("finish_reason") == "length"
                 and n == TENANT_DECODE_NEW)
                or (u.get("finish_reason") == "eos"
                    and n < TENANT_DECODE_NEW)):
            raise AssertionError(f"a: request lost or duplicated tokens: "
                                 f"{m}")
    contended = [c for c in probe.calls if len(set(c[2].values())) >= 2]
    if not contended:
        raise AssertionError("a: no chunk held rows of both tenants")
    bound = 0
    for before, after, tenant_of in contended:
        got = {}
        for o, b in after.items():
            got[tenant_of[o]] = got.get(tenant_of[o], 0) + b
        want = _fair_expect(before, tenant_of, weights)
        if got != want:
            raise AssertionError(f"a: chunk budgets {after} from {before} "
                                 f"sum to {got}, the rule gives {want}")
        if any(after[o] < 1 for o in after if before[o] >= 1):
            raise AssertionError(f"a: a row's budget fell to 0: {after}")
        bound += after != before
    rates = {}
    if len(both) >= 2:
        (t0, a), (t1, b) = both[0], both[-1]
        rates = {t: (b.get(t, 0) - a.get(t, 0)) / max(t1 - t0, 1e-9)
                 for t in ("gold", "bronze")}
    sample_chunk = next(c for c in contended if c[1] != c[0]) \
        if bound else contended[0]
    log(f"[serve-tenancy] a. decode fairness: {len(contended)} contended "
        f"chunks of {len(probe.calls)} held both tenants, the caps bound in "
        f"{bound}; e.g. budgets {sorted(sample_chunk[0].values())} -> "
        f"{sorted(sample_chunk[1].values())} by tenant "
        f"{sorted(set(sample_chunk[2].values()))}; while both decoded: "
        + ", ".join(f"{t} {r:.1f} tok/s" for t, r in rates.items())
        + f"; all 8 complete ({CARD})")
    if not bound:
        raise AssertionError("a: the caps never bound in a contended chunk")
    return {"contended_chunks": len(contended), "caps_bound": bound,
            "tok_s_while_both": rates}


def _queue_backlog(app, tag: str):
    """b. A backlog pushed into the serving process's queue before its
    workers start. Returns the messages and the list their completions
    append (tenant, served tokens) to, in order, and its restore."""
    from llmq_tpu_torch.core.types import Message, Priority

    mgr = app.factory.get_queue_manager("standard")
    order = []
    orig = mgr.complete_message

    def complete(message, *a, **kw):
        orig(message, *a, **kw)
        u = message.metadata.get("usage") or {}
        order.append((message.tenant_id,
                      int(u.get("prompt_tokens", 0))
                      + int(u.get("completion_tokens", 0))))
    mgr.complete_message = complete
    msgs = []
    for i in range(TENANT_BACKLOG):
        for t in ("gold", "bronze"):
            m = Message(id=f"{tag}-{t}-{i}", tenant_id=t,
                        content=_tenant_prompt(t, 100 + i, 120),
                        priority=Priority.NORMAL, timeout=MESSAGE_TIMEOUT_S)
            m.metadata["max_new_tokens"] = TENANT_BACKLOG_NEW
            mgr.push_message(m)
            msgs.append(m)
    return msgs, order, lambda: mgr.__dict__.pop("complete_message", None)


def _fair_dequeue(msgs, order, elapsed_s: float) -> dict:
    """b. Over the first half of the backlog's completions, gold's served
    tokens to bronze's lie in JAX's convergence band."""
    half = order[:len(msgs) // 2]
    served = {}
    for t, n in half:
        served[t] = served.get(t, 0) + n
    ratio = served.get("gold", 0) / max(1, served.get("bronze", 0))
    log(f"[serve-tenancy] b. fair dequeue: {len(msgs)} messages queued "
        f"before the workers started; first {len(half)} completions served "
        f"{served} tokens, gold:bronze {ratio:.3f} (band "
        f"{TENANT_BAND[0]:.1f}-{TENANT_BAND[1]:.1f}); all served in "
        f"{elapsed_s:.2f} s ({CARD})")
    if not TENANT_BAND[0] <= ratio <= TENANT_BAND[1]:
        raise AssertionError(f"b: gold:bronze served {ratio:.3f} outside "
                             f"{TENANT_BAND}")
    return {"served_first_half": served, "ratio": ratio,
            "seconds": elapsed_s}


def _quotas(app, engine, base) -> dict:
    """d. The token bucket, the queue-depth cap and the in-flight cap over
    REST, against ``/metrics``."""
    from llmq_tpu_torch.tenancy import get_tenant_registry

    reg = get_tenant_registry()
    before, _ = _scrape(base)
    got = {"metered": [], "gold": []}
    for i in range(8):
        for t in ("metered", "gold"):
            s, r, retry = _post_tenant(base, t, {
                "content": _tenant_prompt(t, 200 + i, 200),
                "metadata": {"max_new_tokens": 8}})
            got[t].append((s, r, retry))
    n429 = sum(1 for s, *_ in got["metered"] if s == 429)
    for s, r, retry in got["metered"]:
        if s == 429 and ("tenant_quota" not in r.get("error", "")
                         or retry is None):
            raise AssertionError(f"d: a metered 429 without tenant_quota "
                                 f"or Retry-After: {r}")
    if n429 == 0 or any(s != 202 for s, *_ in got["gold"]):
        raise AssertionError(f"d: metered {[s for s, *_ in got['metered']]}"
                             f", gold {[s for s, *_ in got['gold']]}")
    # The in-flight cap defers, the depth cap refuses: one message in
    # flight, two queued behind it, the fourth refused.
    s, r, _ = _post_tenant(base, "capped", {
        "content": _tenant_prompt("capped", 0, 100),
        "metadata": {"max_new_tokens": 96}})
    capped = [r["message_id"]]
    _until(lambda: reg.inflight("capped") == 1, 60, "capped's first "
           "message in flight", poll=0.002)
    for i in (1, 2):
        s, r, _ = _post_tenant(base, "capped", {
            "content": _tenant_prompt("capped", i, 100),
            "metadata": {"max_new_tokens": 8}})
        if s != 202:
            raise AssertionError(f"d: capped message {i} refused: {r}")
        capped.append(r["message_id"])
    depth = reg.queue_depth("capped")
    s4, r4, retry4 = _post_tenant(base, "capped", {
        "content": _tenant_prompt("capped", 3, 100),
        "metadata": {"max_new_tokens": 8}})
    if s4 != 429 or "queue depth" not in r4.get("error", "") \
            or retry4 is None:
        raise AssertionError(f"d: the depth cap did not refuse: {s4} {r4}")
    peak = [0]
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            peak[0] = max(peak[0], reg.inflight("capped"))
            time.sleep(0.001)
    th = threading.Thread(target=watch, daemon=True)
    th.start()
    try:
        done = [_poll(base, m) for m in capped]
    finally:
        stop.set()
        th.join()
    if any(m["status"] != "completed" for m in done) or peak[0] > 1:
        raise AssertionError(f"d: capped messages {[m['status'] for m in done]}"
                             f", in flight at most {peak[0]}")
    for _, r, _ in got["metered"] + got["gold"]:
        if "message_id" in r:
            _poll(base, r["message_id"])
    after, _ = _scrape(base)
    rej = {why: _msum(after, "llm_queue_tenant_quota_rejections_total",
                      reason=why)
           - _msum(before, "llm_queue_tenant_quota_rejections_total",
                   reason=why) for why in ("rate", "queue_depth", "inflight")}
    if rej["rate"] != n429 or rej["queue_depth"] != 1 or rej["inflight"] < 1:
        raise AssertionError(f"d: /metrics rejections {rej}, metered 429s "
                             f"{n429}")
    log(f"[serve-tenancy] d. quotas: metered {[s for s, *_ in got['metered']]}"
        f" with Retry-After {[x for *_, x in got['metered'] if x]}, gold "
        f"all 202; capped: depth {depth} then 429 queue_depth, the two "
        f"deferred complete one at a time (in flight at most {peak[0]}); "
        f"/metrics rejections {rej}")
    return {"metered_429": n429, "rejections": rej}


def _single_tenant(engine, base) -> dict:
    """e. One tenant, 8 concurrent requests admitted together, with
    tenancy on and off in turns (on, off, off, on): with it on, the
    fairness pass leaves every chunk's budgets as they were; tok/s from
    the admission to the last completion (printed, not gated)."""
    from llmq_tpu_torch.tenancy import get_tenant_registry

    reg = get_tenant_registry()
    out = {"on": [], "off": [], "fairness_calls": 0}
    for turn, on in enumerate((True, False, False, True)):
        reg.enabled = on
        probe = _FairnessProbe(engine)
        try:
            mids = []
            with engine.paused():
                for i in range(8):
                    s, r, _ = _post_tenant(base, "gold", {
                        "content": _tenant_prompt("solo", 300 + 10 * turn + i,
                                                  90),
                        "metadata": {"max_new_tokens": 64}})
                    if s != 202:
                        raise AssertionError(f"e: refused: {s} {r}")
                    mids.append(r["message_id"])
                _until(lambda: len(engine._inbox) >= 8, 60, "8 admissions")
                t0 = time.perf_counter()
            res = [_poll(base, m) for m in mids]
            dt = time.perf_counter() - t0
        finally:
            probe.close()
            reg.enabled = True
        out["on" if on else "off"].append(_check_completed(res, "e") / dt)
        if on:
            if not probe.calls or any(a != b for b, a, _ in probe.calls):
                raise AssertionError(f"e: one tenant's budgets changed "
                                     f"({len(probe.calls)} calls)")
            out["fairness_calls"] += len(probe.calls)
        elif probe.calls:
            raise AssertionError("e: the fairness pass ran with tenancy off")
    log(f"[serve-tenancy] e. one tenant, 8 concurrent admitted together: "
        f"the fairness pass ran on {out['fairness_calls']} chunks and "
        f"changed no budget; tok/s in turns on, off, off, on: "
        f"{out['on'][0]:.1f}, {out['off'][0]:.1f}, {out['off'][1]:.1f}, "
        f"{out['on'][1]:.1f} (not gated) ({CARD})")
    return out


def _tenancy_surfaces(base) -> dict:
    """f. ``/api/v1/tenancy`` has JAX's keys; ``/metrics`` the five
    families with live values."""
    s, snap = _http("GET", f"{base}/api/v1/tenancy")
    if s != 200 or set(snap) != TENANCY_KEYS:
        raise AssertionError(f"f: /api/v1/tenancy {s} {sorted(snap)}")
    for t, v in snap["tenants"].items():
        if set(v) != TENANCY_TENANT_KEYS:
            raise AssertionError(f"f: tenant {t} keys {sorted(v)}")
    fair = snap["fair"].get("standard")
    if fair is None or set(fair) != TENANCY_FAIR_KEYS:
        raise AssertionError(f"f: fair block {snap['fair']}")
    samples, _ = _scrape(base)
    fams = {n for n, _ in samples}
    missing = [f for f in TENANCY_FAMILIES if f not in fams]
    live = {f: _msum(samples, f) for f in TENANCY_FAMILIES}
    if missing or live["llm_queue_tenant_virtual_time"] <= 0 or \
            live["llm_queue_tenant_quota_rejections_total"] <= 0 or \
            not any(n == "llm_queue_tenant_share_ratio" and v > 0
                    for (n, _), v in samples.items()):
        raise AssertionError(f"f: families missing {missing}, values {live}")
    log(f"[serve-tenancy] f. /api/v1/tenancy keys {sorted(snap)} (fair "
        f"{sorted(fair)}); rejections {snap['rejections']}; /metrics "
        f"families summed {live}")
    return {"rejections": snap["rejections"],
            "virtual_times": fair["virtual_times"],
            "share_ratios": fair["share_ratios"]}


def _bucket_plan(engine, base) -> dict:
    """c'. The bucket engine (S=2, T=64): a gold and a bronze prompt
    admitted together while two rows decode. Pass 1 cuts them at their
    caps (102, 26), pass 2 widens both to 64."""
    probe = _PackProbe()
    try:
        mids = [_post_tenant(base, "gold", {
            "content": _tenant_prompt("rows", i, 60),
            "metadata": {"max_new_tokens": 96}})[1]["message_id"]
            for i in range(2)]
        _until(lambda: _decoding_rows(engine) >= 2, 120, "two rows decoding")
        with engine.paused():
            for t in ("gold", "bronze"):
                mids.append(_post_tenant(base, t, {
                    "content": _tenant_prompt(t, 400, 300),
                    "metadata": {"max_new_tokens": 4}})[1]["message_id"])
            _until(lambda: len(engine._inbox) >= 2, 60, "both prompts")
        res = [_poll(base, m) for m in mids]
    finally:
        probe.close()
    _check_completed(res, "c'")
    capped = [p for p in probe.plans if p[0] is not None]
    if not capped:
        raise AssertionError(f"c': no capped bucket pack: {probe.plans}")
    caps, plan = capped[0]
    shown = [(t, st, len(ids)) for _, t, st, ids in plan]
    log(f"[serve-tenancy] c'. bucket mode (S=2, T=64): caps {caps}, plan "
        f"(tenant, start, tokens) {shown}: pass 2 widens both slices to "
        f"the slice width, so the caps seldom bind here (JAX's behaviour)")
    return {"caps": caps, "plan": shown}


def _ragged_replay(params, mc, schedule, prompts) -> dict:
    """The final-slice logits of each prompt through
    ``forward_mixed_ragged`` on the card (kernels 2 and 6) with
    ``schedule`` (steps of (prompt, start, ids)), beside six decode rows.
    Returns {prompt: (S-row logits of its final slice)}."""
    import numpy as np
    import torch

    from llmq_tpu_torch.models.llama import forward_mixed_ragged, init_kv_pages

    N, MP = 144, mc.max_seq_len // PS
    names = sorted(prompts)
    need = {p: -(-len(prompts[p]) // PS) for p in names}
    n_pages = 1 + sum(need.values()) + TENANT_RAGGED_ROWS * 8
    cache = init_kv_pages(mc, n_pages, PS, "cuda")
    nxt = 1
    bt = {}
    for p in names:
        bt[p] = np.zeros(MP, np.int32)
        bt[p][:need[p]] = np.arange(nxt, nxt + need[p])
        nxt += need[p]
    dec_bt = np.zeros((TENANT_RAGGED_ROWS, MP), np.int32)
    for r in range(TENANT_RAGGED_ROWS):
        dec_bt[r, :8] = np.arange(nxt, nxt + 8)
        nxt += 8
    rng = np.random.default_rng(0)
    dec_tok = rng.integers(3, 250, TENANT_RAGGED_ROWS).astype(np.int32)
    dev = lambda a: torch.as_tensor(np.asarray(a), device="cuda")  # noqa: E731
    last = {}
    for i, step in enumerate(schedule):
        toks = np.zeros(N, np.int32)
        poss = np.zeros(N, np.int32)
        qoff, qlen, pbt = [], [], []
        off = 0
        for p, st, ids in step:
            toks[off:off + len(ids)] = ids
            poss[off:off + len(ids)] = st + np.arange(len(ids))
            qoff.append(off)
            qlen.append(len(ids))
            pbt.append(bt[p])
            off += -(-len(ids) // 8) * 8
        while len(qoff) < 2:
            qoff.append(0)
            qlen.append(0)
            pbt.append(np.zeros(MP, np.int32))
        if off > N:
            raise AssertionError(f"replay step packs {off} > {N} rows")
        _, pf = forward_mixed_ragged(
            params, mc, dev(dec_tok), dev(np.full(TENANT_RAGGED_ROWS, 40 + i,
                                                  np.int32)),
            cache, dev(dec_bt), dev(toks), dev(poss), dev(np.int32(qoff)),
            dev(np.int32(qlen)), dev(np.stack(pbt)))
        for s, (p, st, ids) in enumerate(step):
            if st + len(ids) == len(prompts[p]):
                last[p] = pf[s].float().cpu()
    torch.cuda.synchronize()
    del cache
    return last


def _capped_prefill(params) -> dict:
    """c. A ragged engine on the same weights: two 1500-token prompts, gold
    and bronze, admitted together while six rows decode. A step packs 102
    + 26 tokens (both ending mid-page), the next continues them mid-page;
    each prompt's final-slice logits, replayed with the engine's schedule,
    against the prompt in uncapped 128-token pieces."""
    from llmq_tpu_torch.engine.builder import build_engine

    cfg = _tenancy_cfg(ragged=True)
    t0 = time.perf_counter()
    eng = build_engine(cfg, params=params, name="engine-tenancy-ragged")
    try:
        return _capped_on(eng, cfg, params, t0)
    finally:
        eng.executor.release_graphs()


def _capped_on(eng, cfg, params, t0) -> dict:
    import math

    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.ops import kernels

    app = App(cfg, engine=eng)
    base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
    probe = _PackProbe()
    try:
        eng.generate("warm up the ragged tenancy engine", max_new_tokens=4)
        kernels.reset_launches()
        rows = [_post_tenant(base, ("gold", "bronze")[i % 2], {
            "content": _tenant_prompt("row", 500 + i, 40),
            "metadata": {"max_new_tokens": TENANT_RAGGED_NEW}})[1][
                "message_id"] for i in range(TENANT_RAGGED_ROWS)]
        _until(lambda: _decoding_rows(eng) >= TENANT_RAGGED_ROWS, 120,
               "six rows decoding")
        with eng.paused():
            longs = {}
            for t in ("gold", "bronze"):
                s, r, _ = _post_tenant(base, t, {
                    "content": _tenant_prompt(t, 600, TENANT_PROMPT),
                    "metadata": {"max_new_tokens": 8}})
                if s != 202:
                    raise AssertionError(f"c: {t} prompt refused: {r}")
                longs[t] = r["message_id"]
            _until(lambda: len(eng._inbox) >= 2, 60, "both long prompts")
        res = [_poll(base, m) for m in list(longs.values()) + rows]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        wall = time.perf_counter() - t0
    finally:
        probe.close()
        app.stop()
    _check_completed(res, "c")
    if launches["ragged_mixed_attention"] <= 0 or \
            launches["kv_prefill_write"] <= 0 or \
            launches["prefill_attention"]:
        raise AssertionError(f"c: ragged launches {launches}")
    ids_of = {}
    for rid, (st, ids) in probe.prompts.items():
        ids_of[rid] = (st, ids)
    long_ids = {t: next(r for r in ids_of if r.startswith(m))
                for t, m in longs.items()
                if any(r.startswith(m) for r in ids_of)}
    if set(long_ids) != {"gold", "bronze"} or \
            any(ids_of[r][0] != 0 for r in long_ids.values()):
        raise AssertionError(f"c: the long prompts were not packed from 0: "
                             f"{ {r: ids_of[r][0] for r in long_ids.values()} }")
    rid_t = {r: t for t, r in long_ids.items()}
    steps = []
    for caps, plan in probe.plans:
        step = [(rid_t[r], st, ids) for r, _, st, ids in plan if r in rid_t]
        if step:
            steps.append((caps, step))
    capped = [(c, s) for c, s in steps
              if c is not None and sorted(len(x[2]) for x in s) == [26, 102]
              and all((st + len(ids)) % PS for _, st, ids in s)]
    if not capped:
        raise AssertionError(f"c: no step packed 102 + 26 ending mid-page: "
                             f"{[(c, [(t, st, len(i)) for t, st, i in s]) for c, s in steps[:6]]}")
    i0 = steps.index(capped[0])
    cont = [s for _, s in steps[i0 + 1:] if any(st % PS for _, st, _ in s)]
    if not cont:
        raise AssertionError("c: no step continued a slice mid-page")
    prompts = {t: ids_of[r][1] for t, r in long_ids.items()}
    schedule = [s for _, s in steps]
    done = {t: 0 for t in prompts}
    for s in schedule:
        for t, st, ids in s:
            if st != done[t]:
                raise AssertionError(f"c: {t} slice at {st}, expected "
                                     f"{done[t]}")
            done[t] = st + len(ids)
    for t in prompts:
        while done[t] < len(prompts[t]):
            n = min(128, len(prompts[t]) - done[t])
            schedule.append([(t, done[t], prompts[t][done[t]:done[t] + n])])
            done[t] += n
    alone = [[(t, st, prompts[t][st:st + 128])]
             for t in sorted(prompts)
             for st in range(0, len(prompts[t]), 128)]
    mc = eng.executor.model_cfg
    sliced = _ragged_replay(params, mc, schedule, prompts)
    ref = _ragged_replay(params, mc, alone, prompts)
    err = {t: (sliced[t] - ref[t]).abs().max().item() for t in prompts}
    shown = [(t, st, len(ids)) for t, st, ids in capped[0][1]]
    log(f"[serve-tenancy] c. ragged engine (capacity "
        f"{eng.executor.mixed_slice_tokens} x "
        f"{eng.executor.mixed_prefill_slices}): {len(steps)} steps packed "
        f"the two {TENANT_PROMPT}-token prompts; caps {capped[0][0]}, plan "
        f"(tenant, start, tokens) {shown}, then {len(cont)} steps continue "
        f"mid-page, e.g. {[(t, st, len(i)) for t, st, i in cont[0]]}; "
        f"final-slice logits vs the prompt alone in 128-token pieces: "
        f"max abs diff {err} (tolerance {MODEL_ATOL}); launches "
        f"{ {k: v for k, v in launches.items() if v} }; {wall:.1f} s "
        f"({CARD})")
    if any(not math.isfinite(e) or e > MODEL_ATOL for e in err.values()):
        raise AssertionError(f"c: final-slice logits differ by {err}")
    return {"capped_plan": shown, "mid_page_continuations": len(cont),
            "logits_max_abs_diff": err, "launches": {
                k: v for k, v in launches.items() if v}}


def phase_serve_tenancy(state) -> None:
    """The tenancy plane (llama3-8b bf16 at full width and depth, the serve
    phase's default engine and a ragged engine on its weights) behind the
    full ``App``, tenants named by ``X-Tenant-Id``."""
    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.core.types import MessageStatus
    from llmq_tpu_torch.ops import kernels
    from llmq_tpu_torch.tenancy import reset_tenancy

    engine = state.get("serve_engine")
    if engine is None:
        raise AssertionError("serve-tenancy serves on the serve phase's "
                             "engine: run serve before it")
    out = state.setdefault("serve_tenancy", {})
    counts, restore = _count_plain_calls()
    cfg = _tenancy_cfg()
    t0 = time.perf_counter()
    app = App(cfg, engine=engine)
    msgs, order, unwrap = _queue_backlog(app, "b")
    try:
        kernels.reset_launches()
        tb = time.perf_counter()
        base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
        try:
            _until(lambda: all(m.status == MessageStatus.COMPLETED
                               for m in msgs), 600,
                   "the backlog to complete", poll=0.02)
        finally:
            unwrap()
        out["fair_dequeue"] = _fair_dequeue(msgs, order,
                                            time.perf_counter() - tb)
        out["decode_fairness"] = _decode_fairness(engine, base)
        out["quotas"] = _quotas(app, engine, base)
        out["single_tenant"] = _single_tenant(engine, base)
        out["surfaces"] = _tenancy_surfaces(base)
        out["bucket_plan"] = _bucket_plan(engine, base)
        torch.cuda.synchronize()
        out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for name in ("fused_decode", "kv_prefill_write", "prefill_attention"):
            if not out["launches"].get(name):
                raise AssertionError(f"serve-tenancy never launched {name}")
        app.stop()
        app = None
        out["capped_prefill"] = _capped_prefill(engine.executor.model.params)
        for k, v in out["capped_prefill"]["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    finally:
        restore()
        if app is not None:
            app.stop()
        reset_tenancy()
        if not {"serve-plane", "serve-control", "serve-cluster"} & set(
                state.get("chosen", ())):
            # The serve-plane, serve-control and serve-cluster phases
            # serve on this engine after this one.
            state.pop("serve_engine", None)
            engine.executor.release_graphs()
    if counts:
        raise AssertionError(f"serve-tenancy called plain twins: {counts}")
    log(f"[serve-tenancy] launches {out['launches']}; no twin called; "
        f"{time.perf_counter() - t0:.1f} s ({CARD})")


# -- serve-weights: real weights from disk on the card --------------------------

#: Hugging Face names of the stacked leaves (the layout ``import_hf_llama``
#: reads).
HF_LAYER = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
            "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
            "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
            "w_down": "mlp.down_proj"}
WEIGHTS_PROMPT = "Real weights from disk: describe the queue's four tiers."
WEIGHTS_NEW = 32


def _tokenizer_dir(path: str) -> str:
    """A local Hugging Face tokenizer (a word-level vocabulary of the
    prompt's words), written with ``tokenizers`` alone: tokenizer.json
    and tokenizer_config.json, as ``save_pretrained`` writes them."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    pre = pre_tokenizers.Whitespace()
    for w, _ in pre.pre_tokenize_str(WEIGHTS_PROMPT):
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre
    os.makedirs(path)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<s>", "eos_token": "</s>",
                   "pad_token": "<pad>", "unk_token": "<unk>"}, f)
    return path


def _hf_tokenizer_leg(hf_dir: str, work: str, engines) -> str:
    """With ``transformers`` importable, an engine on the same checkpoint
    with ``model.tokenizer_path`` serves one REST request; its prompt's
    tokens are the tokenizer's. Without it, nothing here uses one."""
    import importlib.util

    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.engine.tokenizer import HFTokenizer

    if importlib.util.find_spec("transformers") is None:
        return "transformers does not import: no HFTokenizer on the card"
    cfg = _weights_cfg(hf_dir)
    cfg.model.tokenizer_path = _tokenizer_dir(os.path.join(work, "tok"))
    eng = build_engine(cfg, name="engine-weights-tok")
    engines.append(eng)
    tok = eng.tokenizer
    ids = tok.encode(WEIGHTS_PROMPT)
    if not isinstance(tok, HFTokenizer) or 3 in ids or \
            (tok.bos_id, tok.eos_id, tok.pad_id) != (1, 2, 0):
        raise AssertionError(f"weights: tokenizer {type(tok).__name__} "
                             f"ids {ids}")
    from llmq_tpu_torch.__main__ import App
    app = App(cfg, engine=eng)
    base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
    try:
        m = _poll(base, _post(base, {
            "content": WEIGHTS_PROMPT,
            "metadata": {"max_new_tokens": WEIGHTS_NEW}}))
    finally:
        app.stop()
        eng.executor.release_graphs()
    _check_completed([m], "weights (HF tokenizer)")
    n = m["metadata"]["usage"]["prompt_tokens"]
    if n != len(ids):
        raise AssertionError(f"weights: {n} prompt tokens, the tokenizer "
                             f"gives {len(ids)}")
    return (f"HFTokenizer (vocab {tok.vocab_size}) served a REST request: "
            f"{n} prompt tokens, {m['metadata']['usage']['completion_tokens']}"
            f" new")


def _hf_layout(params, mc) -> dict:
    """The parameter tree as Hugging Face names and (out, in) views, on
    the card (the writer copies one at a time to the host)."""
    lp = params["layers"]
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"]}
    for i in range(mc.n_layers):
        p = f"model.layers.{i}."
        for k, n in HF_LAYER.items():
            out[f"{p}{n}.weight"] = lp[k][i].T
        out[p + "input_layernorm.weight"] = lp["attn_norm"][i]
        out[p + "post_attention_layernorm.weight"] = lp["mlp_norm"][i]
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].T
    return out


def _leaves(tree, pre=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, pre + k + ".")
        else:
            yield pre + k, v


def _rss_kib() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


def _peak_rss(fn):
    """``fn()``'s result, its seconds and the peak host RSS above the
    start (MiB), sampled every 2 ms."""
    base, peak = _rss_kib(), [0]
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            peak[0] = max(peak[0], _rss_kib())
            time.sleep(0.002)
    th = threading.Thread(target=watch, daemon=True)
    th.start()
    t0 = time.perf_counter()
    try:
        res = fn()
        import torch
        torch.cuda.synchronize()
    finally:
        dt = time.perf_counter() - t0
        stop.set()
        th.join()
    return res, dt, max(0, peak[0] - base) / 1024


def _weights_cfg(path: str = "", quant: str = ""):
    from llmq_tpu_torch.core.config import Config

    cfg = Config()
    cfg.model.name = "llama3-1b"
    cfg.model.max_seq_len = 2048
    cfg.model.checkpoint_path = path
    cfg.model.quantization = quant
    cfg.executor.max_decode_steps = 32
    cfg.device = "cuda"
    return cfg


def _weights_stream(engine, cfg, tag: str) -> list:
    """One greedy B=1 request over REST; returns its token ids."""
    from llmq_tpu_torch.__main__ import App

    seen = []
    orig = engine._finish_active

    def finish(seq, *a, **kw):
        seen.append(list(seq.generated))
        return orig(seq, *a, **kw)
    engine._finish_active = finish
    app = App(cfg, engine=engine)
    base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
    try:
        m = _poll(base, _post(base, {
            "content": WEIGHTS_PROMPT,
            "metadata": {"max_new_tokens": WEIGHTS_NEW}}))
    finally:
        app.stop()
        engine.__dict__.pop("_finish_active", None)
    _check_completed([m], tag)
    if len(seen) != 1:
        raise AssertionError(f"{tag}: {len(seen)} finished rows")
    return seen[0]


def phase_serve_weights(state) -> None:
    """llama3-1b at full width and depth (16 layers, D=64, n_rep 4): random
    weights written as a two-shard bf16 Hugging Face directory with a tied
    head, served through ``model.checkpoint_path`` (bf16 and int8
    weights), the port's own checkpoint of the int8 tree, an orbax
    directory refused."""
    import gc
    import shutil

    import torch

    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.models import checkpoint as ck
    from llmq_tpu_torch.models.llama import get_config, init_params
    from llmq_tpu_torch.ops import kernels
    from llmq_tpu_torch.ops.kernels import BUILD_DIR

    work = str(BUILD_DIR / "serve_weights")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = state.setdefault("serve_weights", {})
    counts, restore = _count_plain_calls()
    engines = []
    t_phase = time.perf_counter()
    try:
        mc = get_config("llama3-1b", max_seq_len=2048)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        tree = init_params(mc, gen, "cuda")
        nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(tree))
        hf_dir = os.path.join(work, "llama3-1b.safetensors.d")
        os.makedirs(hf_dir)
        hf = _hf_layout(tree, mc)
        names = sorted(hf)
        half = len(names) // 2

        def write():
            for i, part in enumerate((names[:half], names[half:])):
                ck.write_safetensors(
                    os.path.join(hf_dir,
                                 f"model-{i + 1:05d}-of-00002.safetensors"),
                    {n: hf[n] for n in part}, {"format": "pt"})
        _, w_s, w_rss = _peak_rss(write)
        del hf
        if "lm_head.weight" in names or not mc.tie_embeddings:
            raise AssertionError("weights: llama3-1b's head is not tied")
        # The load the builder runs, timed alone, then through the builder.
        loaded, l_s, l_rss = _peak_rss(
            lambda: ck.import_hf_llama(hf_dir, mc, device="cuda"))
        for (k, a), (k2, b) in zip(_leaves(loaded), _leaves(tree)):
            if k != k2 or a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"weights: leaf {k} differs from the "
                                     f"written one")
        del loaded
        kernels.reset_launches()
        cfg = _weights_cfg(hf_dir)
        t0 = time.perf_counter()
        eng = build_engine(cfg, name="engine-weights")
        engines.append(eng)
        b_s = time.perf_counter() - t0
        for (k, a), (_, b) in zip(_leaves(eng.executor.model.params),
                                  _leaves(tree)):
            if not torch.equal(a, b):
                raise AssertionError(f"weights: engine leaf {k} differs")
        from_disk = _weights_stream(eng, cfg, "weights (disk)")
        eng.executor.release_graphs()
        ref_eng = build_engine(_weights_cfg(), params=tree,
                               name="engine-weights-ref")
        engines.append(ref_eng)
        from_mem = _weights_stream(ref_eng, _weights_cfg(), "weights (tree)")
        ref_eng.executor.release_graphs()
        if from_disk != from_mem:
            raise AssertionError(f"weights: streams differ: {from_disk} vs "
                                 f"{from_mem}")
        # The same directory into int8 weights; their checkpoint round trip.
        q8_cfg = _weights_cfg(hf_dir, "int8")
        q8 = build_engine(q8_cfg, name="engine-weights-int8")
        engines.append(q8)
        q8_stream = _weights_stream(q8, q8_cfg, "weights (int8)")
        q8.executor.release_graphs()
        q8_path = os.path.join(work, "llama3-1b-int8.ckpt")
        q8_tree = q8.executor.model.params
        _, s_s, _ = _peak_rss(lambda: ck.save_checkpoint(q8_path, q8_tree))
        back, r_s, r_rss = _peak_rss(
            lambda: ck.load_checkpoint(q8_path, device="cuda"))
        q8_bytes = os.path.getsize(q8_path)
        for (k, a), (k2, b) in zip(_leaves(back), _leaves(q8_tree)):
            if k != k2 or a.dtype != b.dtype or not torch.equal(a, b) or \
                    a.stride() != b.stride():
                raise AssertionError(f"weights: int8 leaf {k} did not round "
                                     f"trip bitwise")
        del back
        orbax = os.path.join(work, "orbax-step-0")
        os.makedirs(os.path.join(orbax, "d"))
        for f in ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt"):
            open(os.path.join(orbax, f), "w").close()
        try:
            build_engine(_weights_cfg(orbax), name="engine-orbax")
        except ValueError as e:
            if "orbax" not in str(e):
                raise
            refused = str(e).split(":")[0]
        else:
            raise AssertionError("weights: an orbax directory was served")
        tok_line = _hf_tokenizer_leg(hf_dir, work, engines)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for name in ("fused_decode", "kv_prefill_write", "prefill_attention"):
            if not launches.get(name):
                raise AssertionError(f"weights: {name} never launched: "
                                     f"{launches}")
        out.update({
            "bytes": nbytes, "write_s": w_s, "write_gb_s": nbytes / w_s / 1e9,
            "load_s": l_s, "load_gb_s": nbytes / l_s / 1e9,
            "load_peak_rss_mib": l_rss, "write_peak_rss_mib": w_rss,
            "build_s": b_s, "int8_bytes": q8_bytes, "int8_save_s": s_s,
            "int8_load_s": r_s, "int8_load_gb_s": q8_bytes / r_s / 1e9,
            "int8_load_peak_rss_mib": r_rss, "stream": from_disk,
            "int8_stream_len": len(q8_stream), "tokenizer": tok_line,
            "launches": launches})
        log(f"[serve-weights] llama3-1b L={mc.n_layers} D={mc.head_dim} "
            f"n_rep={mc.n_heads // mc.n_kv_heads}, tied head: "
            f"{nbytes / 1e9:.3f} GB bf16 written as two shards in "
            f"{w_s:.2f} s ({nbytes / w_s / 1e9:.2f} GB/s); imported onto the "
            f"card in {l_s:.2f} s ({nbytes / l_s / 1e9:.2f} GB/s, page cache "
            f"warm), host RSS peak +{l_rss:.0f} MiB; every leaf bitwise the "
            f"written one; the engine built from it in {b_s:.2f} s ({CARD})")
        log(f"[serve-weights] greedy B=1 over REST: {len(from_disk)} tokens, "
            f"equal to the in-memory tree's engine; int8 weights from the "
            f"same directory served {len(q8_stream)} tokens; their "
            f"checkpoint ({q8_bytes / 1e9:.3f} GB) saved in {s_s:.2f} s and "
            f"loaded in {r_s:.2f} s ({q8_bytes / r_s / 1e9:.2f} GB/s, RSS "
            f"+{r_rss:.0f} MiB), bitwise, int8 leaves column major; an "
            f"orbax directory refused ({refused!r}); {tok_line}; launches "
            f"{launches}; {time.perf_counter() - t_phase:.1f} s ({CARD})")
    finally:
        restore()
        for e in engines:
            e.executor.release_graphs()
        del engines
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(work, ignore_errors=True)
    if counts:
        raise AssertionError(f"serve-weights called plain twins: {counts}")

# -- serve-control: the control plane on the card --------------------------------

#: The serve-control phase. The controller's tick and its scale-up
#: trigger (backlog per healthy replica); the scale cooldown, which runs
#: from the tick that raised the target (the child's boot included) and
#: must outlast gates a and b: an idle tick past it drains a replica; and
#: how long a provisioned child may take to answer /health.
CONTROL_TICK_S = 0.5
CONTROL_BACKLOG_PER_REPLICA = 4
CONTROL_COOLDOWN_S = 60.0
CONTROL_READY_S = 600.0
#: The workers dispatch at most CONTROL_WORKERS x CONTROL_CONCURRENT
#: messages at once, one popped at a time, so a burst queues (the
#: default 4 x 50 would drain any burst into the workers at once). A
#: worker at its limit still holds the one message it popped next, so
#: gate b's CONTROL_KILL_ROWS concurrent dispatches need room to spare
#: (at 4 x 2, 7 of 8 ran at once).
CONTROL_WORKERS = 4
CONTROL_CONCURRENT = 3
#: a. the burst that queues, and the batch that follows the scale-up.
CONTROL_BURST = 40
CONTROL_BURST_NEW = 16
CONTROL_SPREAD = 8
#: b. rows held on the child at its kill, and their new tokens (long
#: enough that dispatches trickling in from a busy parent still overlap:
#: at 256 all 8 were once never seen together; 8 x 43 pages fit the pool);
#: past CONTROL_KILL_WAIT_S the kill waits for one row only.
CONTROL_KILL_ROWS = 8
CONTROL_KILL_NEW = 640
CONTROL_KILL_WAIT_S = 4.0
#: c. TTFT objectives (ms): one nothing breaches, one the card cannot
#: meet; the requests that feed the burn.
CONTROL_LOOSE_TTFT_MS = 600000.0
CONTROL_TIGHT_TTFT_MS = 1.0
CONTROL_BURN_REQUESTS = 2


def _control_ports() -> int:
    """A base port whose next three ports are free (the pool's replica
    N listens on base + N)."""
    import socket

    for _ in range(50):
        base = _free_tcp_port()
        socks = []
        try:
            for n in (1, 2, 3):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + n))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError("no free port range for the replica pool")


def _control_config_files(work: str):
    """The child's file (serve-plane's ``configs/config.yaml`` with its
    overrides) and the parent's: the same with the control plane on (a
    subprocess pool of 1-2 replicas whose children get ``--config`` of
    the child's file), the load balancer's probe left to the controller
    (interval 0) and round robin, the breakers off (a replica's death is
    found by the probes), the burst-queueing workers, and a TTFT
    objective nothing breaches (the realtime one off)."""
    import yaml

    from llmq_tpu_torch.core.config import load_config

    _cfg0, plane_path = _plane_config_file()
    with open(plane_path) as f:
        data = yaml.safe_load(f)
    child_path = os.path.join(work, "control_child.yaml")
    with open(child_path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    base_port = _control_ports()
    data["loadbalancer"].update(strategy="round_robin",
                                health_check_interval=0.0)
    data["cluster"]["breaker"] = {"enabled": False}
    data["queue"]["worker"].update(count=CONTROL_WORKERS,
                                   max_concurrent=CONTROL_CONCURRENT,
                                   max_batch_size=1)
    data["observability"]["slo"].update(
        ttft_p99_ms=CONTROL_LOOSE_TTFT_MS, realtime_p99_ms=0.0)
    data["controlplane"].update(
        enabled=True, interval=CONTROL_TICK_S, min_replicas=1,
        max_replicas=2, backlog_per_replica=CONTROL_BACKLOG_PER_REPLICA,
        cooldown=CONTROL_COOLDOWN_S, scale_down_headroom=1.0,
        pool={"kind": "subprocess", "base_port": base_port,
              "args": ["--config", child_path],
              "ready_timeout": CONTROL_READY_S})
    path = os.path.join(work, "control_parent.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    cfg = load_config(path, env=False)
    cp = cfg.controlplane
    if (not cp.enabled or cp.pool.kind != "subprocess"
            or cp.pool.args != ["--config", child_path]
            or cfg.cluster.breaker.enabled
            or cfg.queue.worker.max_concurrent != CONTROL_CONCURRENT):
        raise AssertionError("the control config file did not load to the "
                             "phase's settings")
    return cfg, path, child_path


def _hold_loop(ctl) -> None:
    """Stop the controller's loop thread (its pool and replicas stay):
    the ladder's ticks of gate c are taken by hand."""
    ctl._stop.set()
    if ctl._thread is not None:
        ctl._thread.join(timeout=CONTROL_READY_S)
        ctl._thread = None
    ctl._stop.clear()


def _child_status(work: str, seq: int):
    try:
        with open(os.path.join(work, f"status-replica-{seq}.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _control_scale_up(app, engine, ctl, base, work, out) -> str:
    """a. A queued burst drives ``scale_up`` (reason ``backlog``); the
    child serves the parent's model and takes dispatches."""
    from llmq_tpu_torch.observability.critical_path import get_boot_registry

    t0 = time.perf_counter()
    ids = _cluster_post(base, CONTROL_BURST, CONTROL_BURST_NEW, "xa",
                        tiers=("high",))
    _until(lambda: ctl.action_counts.get("scale_up:backlog"),
           CONTROL_READY_S, "scale_up for the backlog", poll=0.01)
    took = time.perf_counter() - t0
    kids = [e for e in app.load_balancer.endpoints()
            if e.metadata.get("pool")]
    if len(kids) != 1 or ctl.target != 2:
        raise AssertionError(f"a. after the scale-up: {kids}, target "
                             f"{ctl.target}")
    child = kids[0]
    _check_completed([_poll(base, mid) for mid in ids], "serve-control a")
    _, h = _http("GET", f"{child.url}/health")
    _, st = _http("GET", f"{child.url}/api/v1/engine/stats")
    mine = engine.get_stats()
    if (h.get("engine") != "running"
            or st["device"]["model"] != mine["device"]["model"]
            or st["kv_pages_total"] != mine["kv_pages_total"]
            or st["slots"] != mine["slots"]):
        raise AssertionError(f"a. the child serves another model: {h}, "
                             f"{st['device']['model']} vs "
                             f"{mine['device']['model']}")
    log_path = os.path.join(work, f"replica-{child.url.rsplit(':', 1)[1]}"
                                  f".log")
    with open(log_path) as f:
        served = [ln for ln in f if ln.startswith("serving ")]
    boot = get_boot_registry().get(child.id) or {}
    spread = _cluster_post(base, CONTROL_SPREAD, CONTROL_BURST_NEW, "xs",
                           tiers=("high",))
    done = [_poll(base, mid) for mid in spread]
    _check_completed(done, "serve-control a (spread)")
    on = {}
    for m in done:
        eid = m["metadata"]["endpoint_id"]
        on[eid] = on.get(eid, 0) + 1
    if (not on.get(child.id) or not served
            or f"serving {app.cfg.model.name} on " not in served[0]):
        raise AssertionError(f"a. the child took {on}; its log says "
                             f"{served}")
    out["a"] = {"scale_up_after_s": took, "child": child.id,
                "child_boot_s": boot.get("total_s"),
                "child_stages_s": boot.get("stages_s"),
                "dispatch_by_endpoint": on}
    log(f"[serve-control] a. a burst of {CONTROL_BURST} queued messages: "
        f"scale_up (backlog) {took:.1f} s after the first post; the child "
        f"{child.id} ({served[0].strip()}) booted in "
        f"{boot.get('total_s')} s, stages adopted {boot.get('stages_s')}; "
        f"{_params_b(st)} params like the parent's; the next "
        f"{CONTROL_SPREAD} dispatched {on} ({CARD})")
    return child.id


def _params_b(stats) -> str:
    return f"{stats['device']['model']['n_params'] / 1e9:.2f} B"


def _kill_moment(app, router, base, work, seq, child_id, ids) -> dict:
    """Wait until the child decodes all the kill rows, or, past
    CONTROL_KILL_WAIT_S, until it decodes at least one of them (the
    card has shown 7 of 8 at most, and with 256-token rows none of the
    8 together), and return its status then. A timeout raises with what the wait saw."""
    seen = []
    t0 = time.time()

    def ready():
        st = _child_status(work, seq) or {}
        n = st.get("decoding", 0)
        seen.append(n)
        return n >= CONTROL_KILL_ROWS or (
            n >= 1 and time.time() - t0 > CONTROL_KILL_WAIT_S)

    try:
        _until(ready, 120, "kill rows decoding on the child", poll=0.01)
    except AssertionError:
        msgs = {mid: _http("GET", f"{base}/api/v1/messages/{mid}")[1].get(
            "status") for mid in ids}
        eps = [(e.id, e.status.value, e.connections)
               for e in app.load_balancer.endpoints()]
        raise AssertionError(
            f"b. no kill row decoded on the child {child_id}: most at once "
            f"{max(seen or [0])}; its status {_child_status(work, seq)}; "
            f"endpoints {eps}; router {router.get_stats()['dispatches']} "
            f"dispatches; messages {msgs}") from None
    return _child_status(work, seq)


def _control_kill(app, ctl, router, base, work, child_id, out) -> dict:
    """b. The child SIGKILLed with CONTROL_KILL_ROWS rows decoding on it:
    the controller replaces it (``replace``, ``replica_dead``), every
    message completes once."""
    import signal

    from llmq_tpu_torch.chaos import InvariantChecker

    pool = ctl.pool
    pid = pool.pids()[child_id]
    seq = int(child_id.rsplit(":", 1)[1]) - int(
        app.cfg.controlplane.pool.base_port)
    local_id = router.get_stats()["local_endpoint_id"]
    checker = InvariantChecker()
    mgr = app.factory.get_queue_manager("standard")
    orig = mgr.complete_message

    def complete(m, *a, **kw):
        checker.completed(m.id)
        return orig(m, *a, **kw)

    mgr.complete_message = complete
    replaced0 = ctl.action_counts.get("replace:replica_dead", 0)
    try:
        # The loop holds while the local replica drains: a tick would read
        # the drain as a missing replica and provision one.
        _hold_loop(ctl)
        router.drain_endpoint(local_id)
        ids = []
        for i in range(CONTROL_KILL_ROWS):
            mid = f"xk-{i}"
            checker.submitted(mid)
            _post(base, {"id": mid, "priority": "high",
                         "content": f"kill {i}: decode on the child until "
                                    f"it dies.",
                         "metadata": {"max_new_tokens": CONTROL_KILL_NEW}})
            ids.append(mid)
        child_status = _kill_moment(app, router, base, work, seq, child_id,
                                    ids)
        router.undrain_endpoint(local_id)
        ctl.start()
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        done = [_poll(base, mid) for mid in ids]
        kill_to_last = time.perf_counter() - t_kill
        _until(lambda: ctl.action_counts.get("replace:replica_dead", 0)
               > replaced0 and ctl.last_recovery_s is not None,
               CONTROL_READY_S, "the replacement and its recovery",
               poll=0.05)
        kill_to_recovered = time.perf_counter() - t_kill
    finally:
        mgr.complete_message = orig
    _check_completed(done, "serve-control b")
    checker.check()
    s = checker.summary()
    # The replacement may already be draining: the cooldown counts from
    # the scale-up's tick.
    kids = [e.id for e in app.load_balancer.endpoints()
            if e.metadata.get("pool")]
    if (s["terminal"].get("completed") != CONTROL_KILL_ROWS
            or ctl.pool.get_stats()["provisioned"] != 2
            or child_id in kids or _pid_alive(pid)):
        raise AssertionError(f"b. after the kill: {s}, pool endpoints "
                             f"{kids}, pool {ctl.pool.get_stats()}")
    # Service goes on over the set as it is now (the cooldown may have
    # passed: an idle tick can already be draining the replacement).
    after = _cluster_post(base, CONTROL_SPREAD, CONTROL_BURST_NEW, "xr",
                          tiers=("high",))
    done2 = [_poll(base, mid) for mid in after]
    _check_completed(done2, "serve-control b (after)")
    on = {}
    for m in done2:
        eid = m["metadata"]["endpoint_id"]
        on[eid] = on.get(eid, 0) + 1
    out["b"] = {"kill_to_all_completed_s": kill_to_last,
                "kill_to_recovered_s": kill_to_recovered,
                "rows_decoding_at_kill": child_status["decoding"],
                "controller_recovery_seconds": ctl.last_recovery_s,
                "replacement": kids, "after_by_endpoint": on,
                "actions": dict(ctl.action_counts)}
    log(f"[serve-control] b. the child SIGKILLed with "
        f"{child_status['decoding']} of {CONTROL_KILL_ROWS} rows decoding "
        f"there: all "
        f"{CONTROL_KILL_ROWS} completed once (none lost or duplicated) "
        f"{kill_to_last:.2f} s after the kill; replace (replica_dead) -> "
        f"{kids}, controller_recovery_seconds {ctl.last_recovery_s} "
        f"(kill to recovered {kill_to_recovered:.1f} s); the next "
        f"{CONTROL_SPREAD} dispatched {on} ({CARD})")
    return child_status


def _control_ladder(app, ctl, base, out) -> None:
    """c. A TTFT objective the card cannot meet: one rung per hot tick;
    at ``shed_batch`` a LOW submission is shed 429 ``degraded`` with
    Retry-After and a HIGH one completes; the REST pause and resume show
    on /health. Then the objective is loosened and the ladder relaxes."""
    from llmq_tpu_torch.observability.slo import get_slo_tracker

    tracker = get_slo_tracker()
    shedder = app.api.shedder
    _until(lambda: ctl.ladder.level == 0, 60, "the ladder back at rung 0",
           poll=0.05)
    _hold_loop(ctl)
    before, _ms = _scrape(base)
    tracker.reconfigure(targets={"ttft": CONTROL_TIGHT_TTFT_MS})
    burn_ids = _cluster_post(base, CONTROL_BURN_REQUESTS, 8, "xb",
                             tiers=("high",))
    _check_completed([_poll(base, mid) for mid in burn_ids],
                     "serve-control c (burn)")
    climbs = []
    for want in (1, 2):
        rec = ctl.run_once()
        climbs.append((rec["rung"], rec["actions"],
                       rec["obs"]["fast_burn"]))
        if rec["rung"] != want or ("escalate", "burn_fast") not in \
                rec["actions"]:
            raise AssertionError(f"c. tick {want}: {rec}")
    if ctl.ladder.rung_name() != "shed_batch":
        raise AssertionError(f"c. at {ctl.ladder.rung_name()}")
    low = _http_status("POST", f"{base}/api/v1/messages",
                       {"content": "a batch job", "priority": "low",
                        "timeout": MESSAGE_TIMEOUT_S,
                        "metadata": {"max_new_tokens": 8}})
    high_id = _post(base, {"content": "an interactive question",
                           "priority": "high",
                           "metadata": {"max_new_tokens": 8}})
    high = _poll(base, high_id)
    after, _ms = _scrape(base)
    shed = _msum(after, "llm_queue_requests_shed_total", reason="degraded",
                 code="429") - _msum(before, "llm_queue_requests_shed_total",
                                     reason="degraded", code="429")
    if (low[0] != 429 or not low[2] or "degraded" not in low[1]["error"]
            or high["status"] != "completed" or shed != 1.0
            or shedder.shed_counts["degraded"] < 1):
        raise AssertionError(f"c. LOW {low}, HIGH {high['status']}, "
                             f"/metrics degraded {shed}")
    pause = _http_status("POST", f"{base}/api/v1/admin/controller",
                         {"action": "pause"})
    _, h_paused = _http("GET", f"{base}/health")
    held = rec = ctl.run_once()
    resume = _http_status("POST", f"{base}/api/v1/admin/controller",
                          {"action": "resume"})
    _, h_running = _http("GET", f"{base}/health")
    if (pause[:2] != (200, {"status": "paused"})
            or h_paused.get("controller") != "paused"
            or not rec["paused"] or rec["rung"] != 2
            or resume[:2] != (200, {"status": "running"})
            or h_running.get("controller") != "running"):
        raise AssertionError(f"c. pause {pause}, /health {h_paused}, tick "
                             f"{rec}, resume {resume}, /health {h_running}")
    tracker.reconfigure(targets={})
    tracker.reconfigure(targets={"ttft": CONTROL_LOOSE_TTFT_MS})
    relax = []
    for _ in range(3 * 2 + 2):
        rec = ctl.run_once()
        relax.append(rec["rung"])
        if rec["rung"] == 0:
            break
    if relax[-1] != 0 or ctl.action_counts.get("relax:recovered", 0) < 2:
        raise AssertionError(f"c. the ladder relaxed {relax}: "
                             f"{ctl.action_counts}")
    ctl.start()
    out["c"] = {"climb": climbs, "low": [low[0], low[2]],
                "high": high["status"], "relax_rungs": relax}
    log(f"[serve-control] c. TTFT objective {CONTROL_TIGHT_TTFT_MS} ms: "
        f"rungs {[c[0] for c in climbs]} in two hot ticks (fast burn "
        f"{climbs[-1][2]}); at shed_batch LOW -> {low[0]} degraded with "
        f"Retry-After {low[2]}, HIGH completed; /metrics degraded +1; "
        f"pause -> /health paused, the tick held rung {held['rung']}; "
        f"resume -> running; relaxed through {relax}")


def _control_scale_down(app, ctl, pid: int, out) -> None:
    """d. Idle: ``scale_down`` drains, then decommissions the pool replica
    (``pid``), whose process exits; the local endpoint stays. (The idle
    conditions may already hold during gate c's relaxing ticks.)"""
    local = app.cluster_router.get_stats()["local_endpoint_id"]
    t0 = time.perf_counter()
    _until(lambda: ctl.action_counts.get("scale_down:idle", 0) >= 1
           and [e.id for e in app.load_balancer.endpoints()] == [local]
           and not _pid_alive(pid), 180,
           "the idle scale-down and the child's exit", poll=0.05)
    took = time.perf_counter() - t0
    if ctl.pool.get_stats()["live"] != 0 or ctl.target != 1:
        raise AssertionError(f"d. {ctl.pool.get_stats()}, target "
                             f"{ctl.target}")
    out["d"] = {"idle_to_gone_s": took}
    log(f"[serve-control] d. idle: scale_down drained and decommissioned "
        f"the replacement (pid {pid}) {took:.1f} s after gate c (its "
        f"process exited); {local} stays")


def phase_serve_control(state) -> None:
    """The control plane on the card: the serve phase's bf16 engine behind
    the full ``App`` in serve mode with ``controlplane.enabled`` and a
    subprocess pool of real ``python -m llmq_tpu_torch serve`` replicas
    (llama3-8b at full width and depth, random weights from seed 0, on
    the same card, SPLIT_PRELUDE's counts)."""
    import shutil

    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.controlplane import SubprocessReplicaPool
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.observability.slo import configure_slo
    from llmq_tpu_torch.ops import kernels
    from llmq_tpu_torch.ops.kernels import BUILD_DIR

    engine = state.pop("serve_engine", None)
    if engine is None:
        raise AssertionError("serve-control serves on the serve phase's "
                             "engine: run serve before it")
    work = str(BUILD_DIR / "serve_control")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = state.setdefault("serve_control", {})
    t0 = time.perf_counter()
    cfg, path, child_path = _control_config_files(work)
    root = os.path.dirname(os.path.abspath(__file__))
    old_pp = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = root + (os.pathsep + old_pp if old_pp else "")
    # Earlier phases' requests, judged by the default objective, leave the
    # tracker's window: the phase starts from no burn.
    tracker = configure_slo(cfg.observability.slo)
    tracker.reconfigure(targets={})
    configure_slo(cfg.observability.slo)
    counts, restore = _count_plain_calls()
    app = None
    procs = {}
    failed = True
    try:
        app = App(cfg, engine=engine, with_scheduler=True)
        ctl = app.controller
        pool = ctl.pool
        if (not isinstance(pool, SubprocessReplicaPool)
                or app.autoscaler is not None
                or app.api.controller is not ctl
                or ctl.ladder.shedder is not app.api.shedder
                or len(app.load_balancer.endpoints()) != 1):
            raise AssertionError("the App did not wire the control plane")
        pool.log_dir = work
        pool.launcher = lambda seq: [
            sys.executable, "-c", SPLIT_PRELUDE,
            os.path.join(work, f"status-replica-{seq}.json")]
        _track = pool.provision

        def provision(seq):
            ep = _track(seq)
            if ep is not None:
                procs[seq] = ep.metadata["pid"]
            return ep

        pool.provision = provision
        base = f"http://127.0.0.1:{app.start(host='127.0.0.1', port=0)}"
        _, h = _http("GET", f"{base}/health")
        if h.get("controller") != "running" or "role" in h:
            raise AssertionError(f"/health {h}")
        kernels.reset_launches()
        child_id = _control_scale_up(app, engine, ctl, base, work, out)
        first = _control_kill(app, ctl, app.cluster_router, base, work,
                              child_id, out)
        _control_ladder(app, ctl, base, out)
        replacement = max(procs)
        second = _child_status(work, replacement)
        _control_scale_down(app, ctl, procs[replacement], out)
        second = (_child_status(work, replacement) or second
                  or {"launches": {}, "plain": {}})
        torch.cuda.synchronize()
        launches = {"parent": {k: v for k, v in kernels.LAUNCHES.items()
                               if v},
                    "child": {k: v for k, v in first["launches"].items()
                              if v},
                    "replacement": {k: v for k, v in
                                    second["launches"].items() if v}}
        for who in ("parent", "child"):
            got = launches[who]
            for name in ("fused_decode", "kv_prefill_write",
                         "prefill_attention"):
                if not got.get(name):
                    raise AssertionError(f"e. the {who} never launched "
                                         f"{name}: {got}")
        if first["plain"] or second["plain"] or counts:
            raise AssertionError(f"e. twins called: parent {counts}, "
                                 f"children {first['plain']} "
                                 f"{second['plain']}")
        out["launches"] = launches
        scrape, _ms = _scrape(base)
        out["recovery_seconds_count"] = _msum(
            scrape, "llm_queue_controller_recovery_seconds_count")
        out["actions"] = dict(ctl.action_counts)
        if out["recovery_seconds_count"] < 1:
            raise AssertionError("b. /metrics has no recovery observation")
        log(f"[serve-control] e. launches while serving: {launches}; no "
            f"twin called; controller actions {ctl.action_counts}; "
            f"/metrics controller_recovery_seconds_count "
            f"{out['recovery_seconds_count']:.0f}")
        failed = False
    finally:
        restore()
        if app is not None:
            app.stop()
        for pid in procs.values():
            if _pid_alive(pid):
                import signal
                os.kill(pid, signal.SIGKILL)
        if failed:
            for name in sorted(os.listdir(work)):
                if name.endswith(".log"):
                    with open(os.path.join(work, name)) as f:
                        lines = f.read().splitlines()
                    print(f"--- {name} (last 40 lines) ---\n"
                          + "\n".join(lines[-40:]), file=sys.stderr)
        if old_pp is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old_pp
        tracker.reconfigure(targets={})
        configure_slo(Config().observability.slo)
        if {"serve-cluster", "serve-split"} & set(state.get("chosen", ())):
            state["serve_engine"] = engine
        else:
            engine.executor.release_graphs()
    log(f"[serve-control] {time.perf_counter() - t0:.1f} s ({CARD})")


# -- serve-disagg: prefill/decode disaggregation on the card ---------------------

#: The serve-disagg phase: the first turn's history (TIER_HISTORY bytes:
#: as many tokens) and its new tokens, turn 2's; the routing thresholds
#: (the phase's own: JAX's 250 ms would call no prompt on this card
#: long), and the promote timeout (a claim's store seconds).
DISAGG_T1_NEW = 16
DISAGG_T2_NEW = 32
DISAGG_LONG_PROMPT_MS = 4.0
DISAGG_LONG_PROMPT_TOKENS = 256
DISAGG_PROMOTE_TIMEOUT_S = 60.0


def _disagg_cfg(work: str, role: str):
    """The serve config with ``executor.kv_tiering`` on (a host tier of
    TIER_HOST_CONVS conversations of the phase's history), the
    conversation store in one SQLite file of the phase, and the
    disaggregation plane on in ``role``."""
    from llmq_tpu_torch.models.llama import get_config

    cfg = _serve_cfg()
    mc = get_config(cfg.model.name, max_seq_len=cfg.model.max_seq_len)
    pages = -(-(TIER_HISTORY + DISAGG_T1_NEW + DISAGG_T2_NEW + 64) // PS)
    kt = cfg.executor.kv_tiering
    kt.enabled = True
    kt.host_capacity_mb = int(-(-TIER_HOST_CONVS * pages
                                 * _tier_page_bytes(mc, False) // 2**20))
    # A claim reads and deletes a 203 MB SQLite entry: 3.7 s and more on
    # the card's hosts, past the default 5 s promote timeout in some runs
    # (the admission then gives up the placeholder, and its history).
    kt.promote_timeout_s = DISAGG_PROMOTE_TIMEOUT_S
    cfg.persistence.backend = "sqlite"
    cfg.persistence.sqlite_path = os.path.join(work, "disagg.db")
    d = cfg.disagg
    d.enabled, d.role = True, role
    d.long_prompt_ms = DISAGG_LONG_PROMPT_MS
    d.long_prompt_tokens = DISAGG_LONG_PROMPT_TOKENS
    return cfg


class _Exported:
    """Records, at each ``export_kv_pages`` of a plane, the pages and a
    device copy of their bytes (every leaf), before the engine frees
    them; and each exchange publication's meta."""

    def __init__(self, engine, exchange) -> None:
        import torch

        self.plane, self.ex = engine._tiering, engine.executor
        self.exchange = exchange
        self.snaps, self.metas = [], []
        exp, pub = self.plane._export, exchange.publish

        def exporting(pages):
            idx = torch.tensor(pages, device=self.ex.device)
            self.snaps.append((list(pages), {
                k: t.index_select(1, idx) for k, t in self.ex.cache.items()}))
            return exp(pages)

        def publishing(conv_id, bufs, specs, meta=None):
            self.metas.append((conv_id, dict(meta or {})))
            return pub(conv_id, bufs, specs, meta)

        self._exp = exp
        self.plane._export = exporting
        exchange.publish = publishing

    def close(self) -> None:
        self.plane._export = self._exp
        self.exchange.__dict__.pop("publish", None)


def _disagg_turn(router, engine_ids, conv, text, new, tag, history=""):
    """One turn through the router (its first pick steered by role);
    returns (endpoint id, message)."""
    from llmq_tpu_torch.core.types import Message

    md = {"max_new_tokens": new}
    if history:
        md["history_text"] = history
    msg = Message(id=tag, content=text, user_id="u", conversation_id=conv,
                  timeout=MESSAGE_TIMEOUT_S, metadata=md)
    router.process_fn(None, msg)
    eid = msg.metadata.get("endpoint_id")
    if eid not in engine_ids:
        raise AssertionError(f"{tag}: dispatched to {eid}")
    return eid, msg


def _launch_delta(before) -> dict:
    from llmq_tpu_torch.ops import kernels

    return {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
            if v - before.get(k, 0)}


def _owned_blobs(store, owner: str) -> list:
    from llmq_tpu_torch.tiering import blob_meta

    out = []
    for cid in store.list_kv():
        if cid.startswith("xchg:"):
            continue
        meta = blob_meta(store.load_kv(cid) or b"")
        if meta is not None and meta.get("owner") == owner:
            out.append(cid)
    return sorted(out)


def _disagg_handoff(apps, router, probes, out) -> None:
    """a. b. c. and e. over the two engines."""
    import torch

    from llmq_tpu_torch import observability
    from llmq_tpu_torch.engine.engine import GenRequest
    from llmq_tpu_torch.ops import kernels

    ap, ad = apps
    pe, de = ap.engine, ad.engine
    pprobe, dprobe = probes
    exported = _Exported(pe, ap.disagg.exchange)
    ids = {pe.name, de.name}
    history = _tier_history()
    try:
        for eng in (pe, de):
            eng.generate("warm up the disaggregated engine",
                         max_new_tokens=4)
        eta = router.prefill_eta(len(history) // 4)
        for eng in (pe, de):
            eng._prefix_cache.invalidate_all()
        # a. The long first turn goes to the prefill engine and is
        # published.
        ap.state_manager.get_or_create("dg-1", "u")
        before = dict(kernels.LAUNCHES)
        eid1, m1 = _disagg_turn(router, ids, "dg-1", history, DISAGG_T1_NEW,
                                "dg-1.t1")
        torch.cuda.synchronize()
        launches_p = _launch_delta(before)
        px = ap.disagg.exchange
        # The count moves after the store's write: wait on it, not on the
        # key.
        _until(lambda: px.totals["published"] >= 1, 60,
               "dg-1's publication", poll=0.005)
        meta = dict(exported.metas[-1][1])
        pages, snap = exported.snaps[-1]
        stats = router.get_stats()["disagg"]
        if (eid1 != pe.name or stats["role_routes"] < 1
                or px.totals["published"] != 1
                or "xchg:dg-1" not in ap.state_manager.store.list_kv()
                or pe.cached_conversations()):
            raise AssertionError(f"a. turn 1 on {eid1}, {stats}, "
                                 f"{ap.disagg.exchange.stats()}")
        h1 = pprobe.handles["dg-1.t1"]
        # b. Turn 2 hands off to the decode engine and claims the KV.
        for eng in (pe, de):
            eng._prefix_cache.invalidate_all()
        before = dict(kernels.LAUNCHES)
        eid2, m2 = _disagg_turn(router, ids, "dg-1", TIER_T2_PROMPT,
                                DISAGG_T2_NEW, "dg-1.t2")
        torch.cuda.synchronize()
        launches_d = _launch_delta(before)
        h2 = dprobe.handles["dg-1.t2"]
        tl = observability.get_recorder().get("dg-1.t2")
        stages = [e.stage for e in tl.events] if tl else []
        st = de.get_stats()["kv_tiering"]
        stats = router.get_stats()["disagg"]
        if (eid2 != de.name or stats["handoffs"] != 1
                or h2.result.kv_tier != "store"
                or h2.result.cached_tokens != meta["length"]
                or meta["length"] != len(meta["tokens"])
                or st["hits"].get("store") != 1
                or st["hits"].get("recompute", 0) != 0
                or ad.disagg.exchange.totals["claimed"] != 1
                or "handoff_claim_done" not in stages
                or "kv_promote_done" in stages):
            raise AssertionError(f"b. turn 2 on {eid2}: {h2.result}, "
                                 f"{st['hits']}, {stats}, stages {stages}")
        dprobe.same_bytes(dprobe.imports[-1], meta["length"], snap)
        # The resident reference: the same two turns on the prefill
        # engine with its pin kept (no publication).
        hook, pe.on_conversation_cached = pe.on_conversation_cached, None
        try:
            for eng in (pe, de):
                eng._prefix_cache.invalidate_all()
            r1 = pe.submit(GenRequest(id="dg-ref.t1", prompt=history,
                                      conversation_id="dg-ref",
                                      max_new_tokens=DISAGG_T1_NEW))
            r1.wait(MESSAGE_TIMEOUT_S)
            pe._prefix_cache.invalidate_all()
            r2 = pe.submit(GenRequest(id="dg-ref.t2", prompt=TIER_T2_PROMPT,
                                      conversation_id="dg-ref",
                                      max_new_tokens=DISAGG_T2_NEW))
            r2.wait(MESSAGE_TIMEOUT_S)
        finally:
            pe.on_conversation_cached = hook
        if (r1.result.tokens != h1.result.tokens
                or r2.result.tokens != h2.result.tokens
                or r2.result.cached_tokens != h2.result.cached_tokens):
            raise AssertionError(
                f"b. the handoff's tokens differ from the resident pin's: "
                f"t1 {r1.result.tokens[:8]} vs {h1.result.tokens[:8]}, t2 "
                f"{r2.result.tokens[:8]} vs {h2.result.tokens[:8]}")
        # c. By recompute: the claim finds the entry past its TTL.
        for eng in (pe, de):
            eng._prefix_cache.invalidate_all()
        ap.state_manager.get_or_create("dg-2", "u")
        _disagg_turn(router, ids, "dg-2", history, DISAGG_T1_NEW, "dg-2.t1")
        _until(lambda: px.totals["published"] >= 2, 60,
               "dg-2's publication", poll=0.005)
        dx = ad.disagg.exchange
        # The decode side's clock reads past the entry's TTL (a shorter
        # TTL would be overtaken by the claim's own seconds in the store,
        # which the exchange counts as a fallback, not an expiry).
        now0 = dx._now
        dx._now = lambda: now0() + dx.claim_ttl_s + 1.0
        try:
            de._prefix_cache.invalidate_all()
            eid3, _m3 = _disagg_turn(router, ids, "dg-2", TIER_T2_PROMPT,
                                     DISAGG_T2_NEW, "dg-2.t2",
                                     history=history)
        finally:
            dx._now = now0
        h3 = dprobe.handles["dg-2.t2"]
        if (eid3 != de.name or dx.totals["expired"] != 1
                or h3.result.cached_tokens != 0
                or h3.result.prompt_tokens < len(history)):
            raise AssertionError(f"c. the expired claim: {eid3}, "
                                 f"{dx.stats()}, {h3.result}")
        need = ("fused_decode", "kv_prefill_write", "prefill_attention")
        for who, got in (("prefill", launches_p), ("decode", launches_d)):
            for name in need:
                if not got.get(name):
                    raise AssertionError(f"e. the {who} engine never "
                                         f"launched {name}: {got}")
        ttft = {"claim": _ttft_ms(h2), "recompute": _ttft_ms(h3),
                "resident": _ttft_ms(r2)}
        out.update(
            eta_ms_for_history=eta, ttft_ms=ttft,
            history_tokens=meta["length"], pages=len(pages),
            claim_store_ms=h2.marks.get("_store_wait_ms"),
            launches={"prefill": launches_p, "decode": launches_d},
            exchange={"prefill": ap.disagg.exchange.stats(),
                      "decode": dx.stats()},
            router=router.get_stats()["disagg"])
        log(f"[serve-disagg] a. a {len(history)}-token first turn (learned "
            f"ETA {eta} ms for its {len(history) // 4} estimated tokens, "
            f"long from {DISAGG_LONG_PROMPT_MS} ms) ran on {eid1} and was "
            f"published ({len(pages)} pages)")
        log(f"[serve-disagg] b. turn 2 handed off to {eid2} (reason "
            f"handoff) and claimed {h2.result.cached_tokens} cached tokens "
            f"from the exchange, 0 recomputed; the imported pages are the "
            f"exported bytes; its {len(h2.result.tokens)} tokens equal the "
            f"resident pin's; handoff_claim recorded")
        log(f"[serve-disagg] c. turn-2 TTFT, ms: by claim "
            f"{ttft['claim']:.1f} (store wait "
            f"{h2.marks.get('_store_wait_ms')} ms), by recompute after the "
            f"claim's TTL {ttft['recompute']:.1f} (kv_exchange_expired "
            f"{dx.totals['expired']}), resident {ttft['resident']:.1f} "
            f"({CARD})")
        log(f"[serve-disagg] e. launches: prefill engine {launches_p}, "
            f"decode engine {launches_d}")
    finally:
        exported.close()


def _disagg_rehydrate(params, work, ad, out):
    """d. The decode engine's conversations demote (the second spills the
    first to the store); a fresh decode engine on the same store adopts
    its owned blobs at start and nothing else."""
    import gc

    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.engine.builder import build_engine

    de = ad.engine
    plane = de._tiering
    for cid in ("dg-1", "dg-2"):
        de.demote_conversation(cid)
        _until(lambda: _tier_settled(plane, cid, "host")
               or _tier_settled(plane, cid, "store"), 120,
               f"{cid} demoted", poll=0.005)
    _until(lambda: plane.counts()["store"] >= 1, 120,
           "a spill to the store", poll=0.005)
    store = ad.state_manager.store
    owned = _owned_blobs(store, de.name)
    if not owned or any(k.startswith("xchg:") for k in owned):
        raise AssertionError(f"d. owned blobs {owned}")
    name = de.name
    ad.stop()
    de.executor.release_graphs()
    del de, plane
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _disagg_cfg(work, "decode")
    fresh = build_engine(cfg, params=params, name=name, warmup=False)
    app = App(cfg, engine=fresh, with_api=False, with_workers=False)
    try:
        counts = fresh._tiering.counts()
        with fresh._tiering._mu:
            held = sorted(fresh._tiering._entries)
        handles = {cid: (app.state_manager.prefix_handle(cid) or {}).get(
            "tier") for cid in owned}
        cached = {cid: fresh.prefill_estimate(cid, 8)[0] for cid in owned}
        if (held != owned or counts["store"] != len(owned)
                or set(handles.values()) != {"store"}
                or min(cached.values()) <= 0
                or fresh.disagg_role != "decode"):
            raise AssertionError(f"d. the fresh engine holds {held} "
                                 f"({counts}), handles {handles}, cached "
                                 f"{cached}; owned {owned}")
        out["rehydrated"] = owned
        log(f"[serve-disagg] d. a fresh decode engine on the same store "
            f"adopted its owned spilled blobs {owned} at start (store tier, "
            f"prefix handles at 'store', {cached} tokens promotable); no "
            f"exchange entry or other owner's blob")
    finally:
        app.stop()
        fresh.executor.release_graphs()


def phase_serve_disagg(state) -> None:
    """Prefill/decode disaggregation on the card: two bf16 engines over the
    serve phase's weights (llama3-8b at full width and depth) with
    ``executor.kv_tiering`` on, a prefill one and a decode one over one
    SQLite conversation store, each behind its ``App`` (the
    disaggregation plane built from the config), as in-process endpoints
    of one cluster router that steers by role with the prefill engine's
    learned prefill ETA."""
    import gc
    import shutil

    import torch

    from llmq_tpu_torch.__main__ import App
    from llmq_tpu_torch.cluster.router import ClusterRouter
    from llmq_tpu_torch.core.config import ClusterConfig, LoadBalancerConfig
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.loadbalancer.load_balancer import LoadBalancer
    from llmq_tpu_torch.ops.kernels import BUILD_DIR

    params = (state.get if "serve-scenarios" in state.get("chosen", ())
              else state.pop)("serve_params", None)
    if params is None:
        raise AssertionError("serve-disagg runs on the serve phase's "
                             "weights: run serve before it")
    work = str(BUILD_DIR / "serve_disagg")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = state.setdefault("serve_disagg", {})
    t0 = time.perf_counter()
    counts, restore = _count_plain_calls()
    apps, probes = [], []
    try:
        for role in ("prefill", "decode"):
            cfg = _disagg_cfg(work, role)
            t_b = time.perf_counter()
            eng = build_engine(cfg, params=params, name=f"disagg-{role}",
                               warmup=True)
            app = App(cfg, engine=eng, with_api=False, with_workers=False)
            app.start()
            apps.append(app)
            if (app.disagg is None or app.disagg.exchange is None
                    or eng._tiering.exchange is not app.disagg.exchange
                    or eng.disagg_role != role
                    or not eng._tiering.pool.pinned):
                raise AssertionError(f"{role}: the App did not wire the "
                                     f"disaggregation plane")
            log(f"[serve-disagg] the {role} engine built and wired in "
                f"{time.perf_counter() - t_b:.1f} s")
        ap, ad = apps
        lb = LoadBalancer(LoadBalancerConfig(strategy="round_robin",
                                             health_check_interval=0.0))
        router = ClusterRouter(lb, config=ClusterConfig(),
                               state_manager=ap.state_manager)
        for app in apps:
            router.register_engine(app.engine)
        router.disagg = ap.cfg.disagg
        router.prefill_eta = ap.resource_scheduler.prefill_eta_ms
        probes = [_TierProbe(app.engine) for app in apps]
        _disagg_handoff(apps, router, probes, out)
        for p in probes:
            p.close()
        probes = []
        _disagg_rehydrate(params, work, ad, out)
        if counts:
            raise AssertionError(f"serve-disagg called plain twins: {counts}")
    finally:
        restore()
        for p in probes:
            p.close()
        for app in apps:
            app.stop()
            app.engine.executor.release_graphs()
        apps = None
        del params
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(work, ignore_errors=True)
    log(f"[serve-disagg] no twin called; {time.perf_counter() - t0:.1f} s "
        f"({CARD})")


# -- serve-scenarios: the scenario engine's shipped workloads on the card -------

#: The shipped scenarios the phase plays (``configs/scenarios/``), each at
#: its scale, with the schedule digest the JAX package's compiler gives it
#: there (``tests/test_torch_scenarios.py`` holds these equal to it).
SCENARIO_RUNS = (
    ("agentic_tool_loops", 0.05,
     "8c8d941cbb05e4fc367bac500b3902435e009f6e6f1d03cbcc8a08c303ca1df7"),
    ("diurnal_tenant_mix_with_flash_crowd", 0.05,
     "7eaa686acd1a85bb1980a40929d11f7339e5589705bf18d14f4e14769371819c"),
    ("rag_long_prompt_flood", 0.05,
     "c1033c3c5090be5306422e1a1cad9042ed0b19204a4e4fff954bed0204a7cf58"),
)

#: The kernels every scenario run must launch.
SCENARIO_KERNELS = ("fused_decode", "kv_prefill_write", "prefill_attention")


def _scenario_run(engine, name: str, scale: float, digest: str) -> dict:
    """One shipped scenario through the port's ``run_scenario`` on an
    ``EngineTarget`` over ``engine`` (a compressed ``FakeClock``): the
    schedule is JAX's, every turn completes, the invariant checker finds
    nothing and saw every submission, and kernels 1-3 launch. Returns the
    run's numbers: goodput (the usage ledger's and the driver's), SLO
    attainment, wall and compression, each attempt's TTFT, the turns
    whose prompt with its history passed the engine's window (their tail
    kept), cached-prefix admissions, graph replays against captures."""
    import statistics

    import torch

    from llmq_tpu_torch.ops import kernels
    from llmq_tpu_torch.scenarios import (EngineTarget, load_named,
                                          run_scenario)

    ex = engine.executor
    # An engine.step rule with no match lands on any engine that steps:
    # only this one may run while a scenario plays.
    others = sorted(t.name for t in threading.enumerate()
                    if t.name.startswith("engine-")
                    and t.name != f"engine-{engine.name}")
    if others:
        raise AssertionError(f"{name}: other engines run in this process "
                             f"({others})")
    target = EngineTarget(engine)
    sent, done = {}, {}
    submit, poll = target.submit, target.poll

    def watched_submit(req, on_token):
        sent[req.id] = len(engine.tokenizer.encode(req.history_text
                                                   + req.prompt))
        return submit(req, on_token)

    def watched_poll(handle):
        res = poll(handle)
        if res is not None:
            done[handle.request.id] = res
        return res

    target.submit, target.poll = watched_submit, watched_poll
    captures = []
    capture = ex._capture
    ex._capture = lambda *a, **k: (captures.append(a), capture(*a, **k))[1]
    n_graphs = len(ex.step_graphs) + len(ex.program_graphs)
    replays0 = ex.graph_replays + sum(ex.program_replays.values())
    hits0 = engine.prefix_hits
    cached0 = engine.cached_prefill_tokens_total
    kernels.reset_launches()
    try:
        rep = run_scenario(load_named(name), target=target, scale=scale)
        torch.cuda.synchronize()
    finally:
        ex.__dict__.pop("_capture", None)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    req, inv = rep["requests"], rep["invariants"]
    if rep["schedule_digest"] != digest:
        raise AssertionError(f"{name}: schedule {rep['schedule_digest']} "
                             f"is not JAX's {digest}")
    if inv["violations"] or inv["submitted"] != req["submitted"]:
        raise AssertionError(f"{name}: invariants {inv}, requests {req}")
    if req["completed"] != req["turns_planned"]:
        raise AssertionError(f"{name}: {req['completed']} of "
                             f"{req['turns_planned']} turns completed: {req}")
    missing = [k for k in SCENARIO_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"{name}: never launched {missing}: {launches}")
    window = ex.spec.max_pages_per_seq * ex.spec.page_size
    ttft = [r["ttft_ms"] for r in done.values() if r["ttft_ms"] is not None]
    dur = rep["duration"]
    return {"schedule_digest": rep["schedule_digest"], "requests": req,
            "tokens": rep["tokens"],
            "goodput_tps": rep["goodput"].get("tokens_per_device_second"),
            "driver_goodput_tps": rep["driver_goodput_tps"],
            "slo_attainment": rep["slo"]["attainment"],
            "wall_s": dur["wall_s"], "virtual_s": dur["virtual_s"],
            "compression": dur["compression"],
            "tier_hits": rep["tier_hits"]["requests_by_tier"],
            "prefix_hits": engine.prefix_hits - hits0,
            "cached_tokens": engine.cached_prefill_tokens_total - cached0,
            "share_error": rep["share_error"],
            "longest_prompt_tokens": max(sent.values()),
            "cut_turns": sum(1 for n in sent.values() if n + 1 > window),
            "window": window,
            "ttft_ms_p50": statistics.median(ttft),
            "ttft_ms_max": max(ttft) if ttft else None,
            "graph_replays": (ex.graph_replays
                              + sum(ex.program_replays.values()) - replays0),
            "captures": len(captures), "graphs": n_graphs,
            "launches": launches}


def phase_serve_scenarios(state) -> None:
    """The scenario engine on the card: a bf16 llama3-8b engine over the
    serve phase's weights at JAX's defaults (mixed batching, the async
    pipeline at depth 2, the radix prefix cache, CUDA graphs), warmed
    before any scenario starts, plays three shipped scenarios through
    the port's ``run_scenario``: a. ``agentic_tool_loops`` (histories
    growing turn by turn: later turns admitted from cached KV), b.
    ``diurnal_tenant_mix_with_flash_crowd`` (three tenants and one
    ``engine.step`` crash: the target's supervisor recovers the engine
    and the driver retries), c. ``rag_long_prompt_flood`` (prompts past
    the engine's 2048-token window, whose tail it keeps)."""
    import gc

    import torch

    from llmq_tpu_torch import chaos, tenancy
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.observability.recorder import get_recorder
    from llmq_tpu_torch.observability.usage import get_usage_ledger

    params = state.pop("serve_params", None)
    if params is None:
        raise AssertionError("serve-scenarios runs on the serve phase's "
                             "weights: run serve before it")
    out = state.setdefault("serve_scenarios", {})
    t0 = time.perf_counter()
    ledger = get_usage_ledger()
    ledger_was = ledger.enabled
    counts, restore = _count_plain_calls()
    engine = None
    try:
        engine = build_engine(_serve_cfg(), params=params, name="scenarios",
                              warmup=True)
        _log_warmup(engine, "serve-scenarios")
        _check_defaults(engine, "serve-scenarios")
        engine.start()
        engine.generate("warm up the scenario engine", max_new_tokens=4)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        log(f"[serve-scenarios] engine built, warmed and started in "
            f"{out['build_s']:.1f} s ({CARD})")
        for name, scale, digest in SCENARIO_RUNS:
            out[name] = r = _scenario_run(engine, name, scale, digest)
            req = r["requests"]
            log(f"[serve-scenarios] {name} x{scale}: "
                f"{req['conversations']} conversations, {req['completed']} "
                f"of {req['turns_planned']} turns, submitted "
                f"{req['submitted']}, failed {req['failed']}, retried "
                f"{req['retried']}, shed {req['shed']}; tokens "
                f"{r['tokens']}; goodput {r['goodput_tps']} tok per device-s "
                f"(usage ledger), driver {r['driver_goodput_tps']}; SLO "
                f"attainment {r['slo_attainment']}; wall {r['wall_s']} s "
                f"for {r['virtual_s']} virtual s (compression "
                f"{r['compression']}); TTFT p50 {r['ttft_ms_p50']:.1f} ms, "
                f"max {r['ttft_ms_max']:.1f} ms; cached-prefix admissions "
                f"{r['prefix_hits']} ({r['cached_tokens']} tokens); "
                f"launches {r['launches']}; schedule {r['schedule_digest']} "
                f"({CARD})")
        a, b, c = (out[n] for n, _s, _d in SCENARIO_RUNS)
        ra, rb, rc = a["requests"], b["requests"], c["requests"]
        if ra["failed"] or ra["shed"] or a["prefix_hits"] <= 0 \
                or a["cached_tokens"] <= 0:
            raise AssertionError(f"agentic_tool_loops: {ra}, later turns "
                                 f"from cached KV {a['prefix_hits']}")
        if (rb["chaos_events_fired"] != 1 or rb["engine_recoveries"] < 1
                or rb["submitted"] != rb["completed"] + rb["failed"]
                or rb["retried"] != rb["failed"]):
            raise AssertionError(f"diurnal_tenant_mix_with_flash_crowd: {rb}")
        shares = {t: v["error"] for t, v in b["share_error"]["tenants"].items()}
        log(f"[serve-scenarios] flash crowd: engine.step crash fired "
            f"{rb['chaos_events_fired']}, recoveries "
            f"{rb['engine_recoveries']}, {rb['failed']} attempts failed "
            f"and retried; tenant share errors {shares}; graph replays "
            f"{b['graph_replays']}, captures {b['captures']} ({b['graphs']} "
            f"graphs kept) ({CARD})")
        log(f"[serve-scenarios] rag flood: {rc['completed']} of "
            f"{rc['turns_planned']} turns; {c['cut_turns']} turns past the "
            f"{c['window']}-token window (longest {c['longest_prompt_tokens']}"
            f" tokens, its tail kept); TTFT p50 {c['ttft_ms_p50']:.1f} ms, "
            f"max {c['ttft_ms_max']:.1f} ms ({CARD})")
        if counts:
            raise AssertionError(f"serve-scenarios called plain twins: "
                                 f"{counts}")
    finally:
        restore()
        # Later phases find the process as before: chaos disarmed, no
        # tenancy, the ledger as it was and empty.
        chaos.configure(None)
        tenancy.reset_tenancy()
        ledger.reconfigure(enabled=ledger_was)
        ledger.clear()
        get_recorder().clear()
        if engine is not None:
            engine.stop()
            engine.executor.release_graphs()
        engine = None
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if chaos.get_injector() is not None or \
            tenancy.get_tenant_registry().enabled:
        raise AssertionError("serve-scenarios left chaos or tenancy on")
    out["phase_s"] = time.perf_counter() - t0
    log(f"[serve-scenarios] no twin called; {out['phase_s']:.1f} s ({CARD})")


#: serve-mesh a: new tokens of each request, and its prompts (posted one
#: at a time to each child).
MESH_NEW_TOKENS = 24
MESH_PROMPTS = ("Mesh serving: rank zero drives, the others follow.",
                "Two all-reduces a layer, after wo and after w_down.",
                "The embedding is vocab-sharded; the head gathers its "
                "columns into full logits. " * 8,
                "short")
MESH_BOOT_S = 600.0
#: The process group a CUDA executor's mesh must join.
MESH_BACKEND = "nccl"
#: serve-mesh b: rows x tokens of the prefill, and the bf16 gate: every
#: logit within this share of the largest |logit| of the one-rank forward.
MESH_ROWS, MESH_T = 8, 512
MESH_BOUND = 0.05
MESH_TP = 2
MESH_RANK_S = 600.0

#: One rank of serve-mesh b (``python -c MESH_RANK spec.json``, from the
#: repository's root): joins a gloo world of MESH_TP ranks on the one
#: card, takes its tp shard of llama3-8b (random weights from seed 0,
#: made whole on this rank and cut, one rank after the other), runs the
#: forwards and writes its launches, peak memory and (rank 0, which ran
#: the one-rank forward first) the comparison to ``spec["out"]``.
MESH_RANK = r"""
import json, os, sys, time
spec = json.load(open(sys.argv[1]))
sys.path.insert(0, os.getcwd())
import torch
import torch.distributed as dist
from llmq_tpu_torch.models import llama as M
from llmq_tpu_torch.ops import kernels
from llmq_tpu_torch.parallel import (distributed_init, make_mesh,
                                     kv_cache_shardings, param_shardings,
                                     shard_params, tensor_parallel)
rank, world = spec["rank"], spec["world"]
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
t0 = time.perf_counter()
distributed_init(spec["coord"], world, rank, 600, device="cpu")
mesh = make_mesh({"tp": world})
cfg = M.llama3_8b(max_seq_len=2048)
B, T, ps = spec["rows"], spec["t"], 16
MP = T // ps + 1
npages = B * MP + 1
g = torch.Generator(device=dev)
g.manual_seed(1234)
tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev)
positions = torch.arange(T, device=dev).expand(B, T).contiguous()
lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
bt = (1 + torch.arange(B, device=dev)[:, None] * MP
      + torch.arange(MP, device=dev)[None, :]).to(torch.int32)
dec_tok = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=dev)
dec_pos = torch.full((B,), T, dtype=torch.int32, device=dev)

def forwards(params, tp, kv_heads):
    out = {}
    cache = M.init_kv_pages(cfg, npages, ps, dev, kv_heads=kv_heads)
    out["prefill"] = M.forward_prefill(params, cfg, tokens, positions,
                                       lengths, cache, bt, tp=tp)
    out["decode_fused"] = M.forward_decode(params, cfg, dec_tok, dec_pos,
                                           cache, bt, fused=True, tp=tp)
    out["decode_split"] = M.forward_decode(params, cfg, dec_tok, dec_pos,
                                           cache, bt, fused=False, tp=tp)
    del cache
    q8 = M.init_kv_pages(cfg, npages, ps, dev, dtype=torch.int8,
                         kv_heads=kv_heads)
    out["prefill_q8_last"] = M.forward_prefill_last(
        params, cfg, tokens, positions, lengths, q8, bt, tp=tp)
    out["decode_q8"] = M.forward_decode(params, cfg, dec_tok, dec_pos, q8,
                                        bt, tp=tp)
    del q8
    torch.cuda.synchronize()
    return out

def whole():
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return M.init_params(cfg, gen, dev)

res = {"rank": rank}
ref = None
sh = param_shardings(cfg, mesh)
kv_heads = cfg.n_kv_heads // (world if kv_cache_shardings(cfg, mesh)["k"][3]
                              else 1)
for turn in range(world):
    if turn == rank:
        full = whole()
        if rank == 0:
            kernels.reset_launches()
            t1 = time.perf_counter()
            ref = forwards(full, None, None)
            res["reference_s"] = time.perf_counter() - t1
            res["reference_launches"] = dict(kernels.LAUNCHES)
        local = shard_params(full, sh, mesh)
        del full
        torch.cuda.empty_cache()
    dist.barrier()
tp = tensor_parallel(mesh, sh)
res["weights_bytes"] = sum(t.numel() * t.element_size() for t in
                           [x for v in local.values() for x in
                            (v.values() if isinstance(v, dict) else [v])])
res["kv_heads"] = kv_heads
res["heads"] = local["layers"]["wq"].shape[-1] // cfg.head_dim
res["ffn"] = local["layers"]["w_up"].shape[-1]
res["vocab"] = local["embed"].shape[0]
dist.barrier()
kernels.reset_launches()
t1 = time.perf_counter()
got = forwards(local, tp, kv_heads)
res["tp_s"] = time.perf_counter() - t1
res["launches"] = dict(kernels.LAUNCHES)
res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
if rank == 0:
    cmp = {}
    for k, r in ref.items():
        o = got[k]
        err = float((o - r).abs().max())
        scale = float(r.abs().max())
        lim = spec["bound"] * scale
        top2 = r.reshape(-1, r.shape[-1]).topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > lim
        same = (o.reshape(-1, o.shape[-1]).argmax(-1)
                == r.reshape(-1, r.shape[-1]).argmax(-1))
        cmp[k] = {"max_abs_err": err, "max_abs_logit": scale,
                  "bound": lim, "rows": int(sure.numel()),
                  "confident_rows": int(sure.sum()),
                  "confident_argmax_equal": int((same & sure).sum()),
                  "argmax_equal": int(same.sum())}
    res["compare"] = cmp
res["wall_s"] = time.perf_counter() - t0
with open(spec["out"] + f".{rank}", "w") as f:
    json.dump(res, f)
dist.barrier()
dist.destroy_process_group()
"""


def _mesh_config(work: str, mesh: bool) -> str:
    """A serve config file for serve-mesh a: llama3-8b bf16 at the serve
    phase's window, with or without ``executor.mesh: {tp: 1}``."""
    import yaml

    data = {"model": {"name": "llama3-8b", "max_seq_len": 2048},
            "executor": {"max_decode_steps": 32,
                         "mesh": {"enabled": mesh,
                                  "shape": {"tp": 1} if mesh else {}}}}
    path = os.path.join(work, f"mesh_{'tp1' if mesh else 'off'}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    return path


def _mesh_child(work: str, mesh: bool) -> dict:
    """One serve child of serve-mesh a: boot, the prompts one at a time,
    its status (tokens, launches, replays), engine stats and the hbm
    series of its ``/metrics``; stopped before returning."""
    import signal as _signal

    port = _free_tcp_port()
    env = {k: v for k, v in os.environ.items() if k != "LLMQ_CONFIG"}
    if mesh:
        env.update(LLMQ_COORDINATOR=f"127.0.0.1:{_free_tcp_port()}",
                   LLMQ_NUM_PROCESSES="1", LLMQ_PROCESS_ID="0",
                   LLMQ_CLUSTER_TIMEOUT="300")
    tag = "tp1" if mesh else "off"
    child = _Child(work, "serve", 0 if mesh else 1,
                   ["--config", _mesh_config(work, mesh), "--host",
                    "127.0.0.1", "--port", str(port)], env)
    base = f"http://127.0.0.1:{port}"
    out = {"tag": tag}
    try:
        out["boot_s"] = _wait_engine(base, child, MESH_BOOT_S)
        if mesh:
            joined = child.records("torch.distributed initialised")
            if not joined or f"({MESH_BACKEND})" not in joined[-1]["msg"]:
                raise AssertionError(f"serve-mesh a: the child did not join "
                                     f"a {MESH_BACKEND} group: {joined}")
            out["joined"] = joined[-1]["msg"]
        # The launch counters restart when the engine starts, which can
        # come a moment after /health answers: count from there.
        _until(lambda: (child.status() or {}).get("engine_held"), 60.0,
               "the child's engine start", poll=0.05)
        before = child.status() or {}
        ids, walls = [], []
        for i, prompt in enumerate(MESH_PROMPTS):
            mid = f"mesh-{tag}-{i}"
            t0 = time.perf_counter()
            _post(base, {"id": mid, "content": prompt, "priority": "normal",
                         "metadata": {"max_new_tokens": MESH_NEW_TOKENS}})
            m = _poll(base, mid)
            walls.append(time.perf_counter() - t0)
            if m["status"] != "completed":
                raise AssertionError(f"serve-mesh a: {mid} {m['status']}")
            ids.append(mid)
        _until(lambda: all(i in (child.status() or {}).get("results", {})
                           for i in ids), 30.0, "the child's status file",
               poll=0.05)
        st = child.status()
        out["tokens"] = [st["results"][i] for i in ids]
        out["walls_s"] = walls
        out["launches"] = {k: st["launches"].get(k, 0)
                           - before.get("launches", {}).get(k, 0)
                           for k in st["launches"]}
        out["replays"] = st["replays"] - before.get("replays", 0)
        out["graphs"] = st["graphs"]
        out["plain"] = st["plain"]
        _, stats = _http("GET", f"{base}/api/v1/engine/stats")
        dev = stats.get("device", {})
        out["n_chips"] = dev.get("model", {}).get("n_chips")
        out["hbm_chips"] = [c.get("chip") for c in
                            dev.get("hbm", {}).get("chips", [])]
        out["step_ms"] = dev.get("steps", {}).get("device_ms", {})
    finally:
        out["rc"] = child.stop(_signal.SIGTERM)
    return out


def _mesh_ranks(work: str) -> list:
    """serve-mesh b: MESH_TP rank processes on the one card; their
    results."""
    import subprocess as _sp

    coord = f"127.0.0.1:{_free_tcp_port()}"
    out_path = os.path.join(work, "mesh_ranks.json")
    procs, logs = [], []
    for r in range(MESH_TP):
        spec = {"coord": coord, "world": MESH_TP, "rank": r,
                "rows": MESH_ROWS, "t": MESH_T, "bound": MESH_BOUND,
                "out": out_path}
        path = os.path.join(work, f"mesh_rank{r}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        logs.append(open(os.path.join(work, f"mesh_rank{r}.log"), "w"))
        procs.append(_sp.Popen(
            [sys.executable, "-c", MESH_RANK, path],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=logs[-1], stderr=_sp.STDOUT))
    try:
        rcs = [p.wait(MESH_RANK_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        tails = []
        for r in range(MESH_TP):
            with open(os.path.join(work, f"mesh_rank{r}.log")) as f:
                tails.append(f"rank {r}:\n" + "".join(f.readlines()[-30:]))
        raise AssertionError(f"serve-mesh b: ranks exited {rcs}\n"
                             + "\n".join(tails))
    res = []
    for r in range(MESH_TP):
        with open(f"{out_path}.{r}") as f:
            res.append(json.load(f))
    return res


#: serve-mesh c: the dp mesh (two gloo ranks on the one card), its
#: prompts (8 concurrent REST requests), new tokens each, and the gates'
#: shapes: the forced-fallback prompt, the tiered history's length, the
#: logit bound against one device.
MESH_DP = 2
MESH_C_PROMPTS = tuple(
    f"Replica {i % MESH_DP} of the dp mesh serves row {i}: "
    + "every page of a row lies in its replica's universe. " * (1 + i % 4)
    for i in range(8))
MESH_C_NEW = 32
MESH_C_FALLBACK = ("A row seated in replica zero whose pages all lie in "
                   "universe one reads them as guests. " * 4)
MESH_C_HISTORY = 320
MESH_C_S = 900.0

#: serve-mesh c's rank 0 (``python -c MESH_DP_DRIVER spec.json``, from
#: the repository's root): the CLI's bring-up (``_load``, which joins the
#: world) and the ``App`` that ``serve`` runs, over ``executor.mesh: {dp:
#: 2}``; then REST traffic, and the forced fallback, first-step logits,
#: the speculation window and the tiering round trip on a second engine
#: over the same executor. Rank 1 is ``python -m llmq_tpu_torch serve``
#: (the CLI's follower). Writes its record to ``spec["out"]``.
MESH_DP_DRIVER = r"""
import argparse, json, os, sys, threading, time, urllib.request
spec = json.load(open(sys.argv[1]))
sys.path.insert(0, os.getcwd())
t_start = time.perf_counter()
import numpy as np
import torch
from llmq_tpu_torch.ops import kernels
plain = {}
for name in [n for n in dir(kernels) if n.endswith("_plain")]:
    def counted(*a, _name=name, _fn=getattr(kernels, name), **kw):
        plain[_name] = plain.get(_name, 0) + 1
        return _fn(*a, **kw)
    setattr(kernels, name, counted)
from llmq_tpu_torch import __main__ as cli
from llmq_tpu_torch.engine.builder import build_engine
from llmq_tpu_torch.engine.engine import GenRequest
from llmq_tpu_torch.engine.tokenizer import get_tokenizer

cfg = cli._load(argparse.Namespace(
    config=spec["config"], host="127.0.0.1", port=spec["port"], model=None,
    device=None, backend=None, log_format=None, peers=None))
app = cli.App(cfg)
port = app.start()
eng, ex = app.engine, app.engine.executor
dp = ex._dp
res = {"boot_s": time.perf_counter() - t_start, "mesh": ex.mesh.shape,
       "backend": ex.mesh.backend, "dp_shards": ex.dp_shards,
       "rows": ex._rows, "pool_pages": int(ex.cache["k"].shape[1]),
       "guests": dp.guests, "warmup_s": dict(ex.warmup_split),
       "mesh_step_ms": ex.step_ms, "graphs": sum(len(getattr(ex, n)) for n
                                                in ("step_graphs",
                                                    "program_graphs",
                                                    "verify_graphs"))}
base = f"http://127.0.0.1:{port}"
sync = lambda: torch.cuda.synchronize() if ex.device.type == "cuda" else None


def http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def mark(name):
    open(spec["mark"] + "." + name, "w").close()
    time.sleep(0.3)


# 1. Load: 8 concurrent REST requests; every live row's pages checked
# against its slot's universe meanwhile.
bad, sampled, stop = [], [0], threading.Event()


def watch():
    while not stop.is_set():
        for slot, s in enumerate(list(eng._slots)):
            if s is None or not s.pages:
                continue
            pages = list(s.pages)
            sampled[0] += 1
            if {eng.allocator.shard_of(p) for p in pages} != {
                    eng._slot_shard(slot)}:
                bad.append((slot, pages))
        time.sleep(0.001)


watcher = threading.Thread(target=watch, daemon=True)
mark("start")
kernels.reset_launches()
def replays():
    return (ex.graph_replays + ex.verify_replays
            + sum(ex.program_replays.values()))


replays0 = replays()
watcher.start()
walls, done = {}, {}


def one(i, prompt):
    t0 = time.perf_counter()
    mid = http("POST", f"{base}/api/v1/messages",
               {"id": f"dp-{i}", "content": prompt, "priority": "normal",
                "timeout": 600.0,
                "metadata": {"max_new_tokens": spec["new"]}})["message_id"]
    while True:
        m = http("GET", f"{base}/api/v1/messages/{mid}")
        if m["status"] in ("completed", "failed", "timeout"):
            break
        time.sleep(0.01)
    walls[i], done[i] = time.perf_counter() - t0, m["status"]


t_load = time.perf_counter()
threads = [threading.Thread(target=one, args=(i, p))
           for i, p in enumerate(spec["prompts"])]
for t in threads:
    t.start()
for t in threads:
    t.join()
res["load_s"] = time.perf_counter() - t_load
stop.set()
watcher.join()
sync()
mark("end")
res["load"] = {"status": done, "walls_s": walls,
               "launches": dict(kernels.LAUNCHES),
               "replays": replays() - replays0, "plain": dict(plain),
               "locality_samples": sampled[0], "locality_bad": bad[:8],
               "spec": eng.get_stats().get("speculation", {})}
eng.stop()

# 2. A second engine over the same executor (speculation and tiering as
# configured); the checks below drive it directly.
e2 = build_engine(cfg, executor=ex, name="meshdp")
alloc, tok = e2.allocator, get_tokenizer(cfg.model.tokenizer_path)
B, MP, ps = ex.spec.batch_size, ex.spec.max_pages_per_seq, ex.spec.page_size


def seat(rid, limit=2000):
    for _ in range(limit):
        for slot, s in enumerate(e2._slots):
            if s is not None and s.req.id == rid and s.pages:
                return slot, list(s.pages)
        e2.step()
    raise AssertionError(f"{rid} never seated")


# Forced fallback: universe 0 held full, a slot-0 row takes universe 1.
held = alloc.alloc(alloc.available(shard=0), shard=0)
m0 = dict(dp.moves)
h = e2.submit(GenRequest(id="fallback", prompt=spec["fallback"],
                         max_new_tokens=16))
slot, pages = seat("fallback")
e2.run_until_idle()
alloc.free(held)
m1 = dict(dp.moves)
res["fallback"] = {
    "slot": slot, "slot_universe": e2._slot_shard(slot),
    "page_universes": sorted({alloc.shard_of(p) for p in pages}),
    "finish": h.result.finish_reason, "tokens": len(h.result.tokens),
    "moves": {k: m1[k] - m0[k] for k in m1}}

# The guest path against the home path on this executor: the prompt
# prefilled into universe 1's pages (replica 1 runs it) and decoded by
# slot 0 (replica 0, which reads them as guests), then the same prompt in
# universe 0's pages. Both decode through the same programs on the same
# values, so the streams are equal.
ids = tok.encode(spec["fallback"])
n, steps = len(ids), ex.chunk_size
zeros = np.zeros(B, np.int32)
budgets = zeros.copy()
budgets[0] = steps
streams, m0 = {}, dict(dp.moves)
res["logits"] = None
for u in (1, 0):
    upages = alloc.alloc(-(-(n + steps) // ps), shard=u)
    bt = np.zeros((B, MP), np.int32)
    bt[0, :len(upages)] = upages
    first = ex.prefill(ids, 0, bt[0], 0.0, 0)
    toks, pos = zeros.copy(), zeros.copy()
    toks[0], pos[0] = first, n
    if u == 0 and ex.mesh.tp == 1:
        # First-step logits of the home row, on this rank's pool (its
        # universe), against one device's forward of the same weights
        # over a pool of the prompt's own pages: the model's eager
        # forwards (tp is 1: no collective), no second executor.
        from llmq_tpu_torch.models.llama import init_kv_pages
        dev = ex.device
        t1 = lambda a: torch.as_tensor(np.asarray(a, np.int32),
                                       device=dev)[None]
        home = t1([dp.home_slot(p) for p in bt[0]])
        mesh_lg = ex.model.forward_decode(t1([first])[0], t1([n])[0],
                                          ex.cache, home)[0].float()
        one = init_kv_pages(ex.model_cfg, 1 + len(upages), ps, dev)
        obt = t1(np.arange(1, MP + 1) * (np.arange(MP) < len(upages)))
        tpad = -(-n // 128) * 128     # padded to a bucket, as served
        pf = ex.model.forward_prefill(t1(ids + [0] * (tpad - n)),
                                      t1(np.arange(tpad)), t1([n])[0], one,
                                      obt)
        one_first = int(pf[0, n - 1].argmax())
        one_lg = ex.model.forward_decode(t1([first])[0], t1([n])[0], one,
                                         obt)[0].float()
        res["logits"] = {
            "first": [int(first), one_first],
            "max_abs_err": float((mesh_lg - one_lg).abs().max()),
            "max_abs_logit": float(one_lg.abs().max()),
            "argmax": [int(mesh_lg.argmax()), int(one_lg.argmax())]}
        del one, pf, mesh_lg, one_lg
    out = ex.decode_chunk(toks, pos, bt, np.zeros(B, np.float32), budgets)
    streams[u] = [int(first)] + out[0].tolist()
    alloc.free(upages)
m1 = dict(dp.moves)
res["guest_vs_home"] = {"guest": streams[1], "home": streams[0],
                        "equal": streams[1] == streams[0],
                        "moves": {k: m1[k] - m0[k] for k in m1}}

# Speculation: one verify window commits what plain decode gives.
W = ex.verify_draft_k + 1
rows = [alloc.alloc(8, shard=r * 2 // B) for r in range(B)]
bts = np.zeros((B, MP), np.int32)
for r, pg in enumerate(rows):
    bts[r, :8] = pg
prompts = [tok.encode(f"speculation row {r}: " + "verify " * (3 + r))
           for r in range(B)]


def prefill_all():
    hs = []
    for i in range(0, B, ex.prefill_batch):
        hs += ex.prefill_multi_async([(prompts[r], 0, bts[r], 0.0) for r in
                                      range(i, min(B, i + ex.prefill_batch))])
    return np.array(ex.gather_scalars(hs), np.int32)


first = prefill_all()
pos = np.array([len(p) for p in prompts], np.int32)
plainout = ex.decode_chunk(first, pos, bts, np.zeros(B, np.float32),
                           np.full(B, W, np.int32))
prefill_all()
out, nc = ex.verify_chunk(first, pos, bts, np.zeros(B, np.float32),
                          plainout[:, :W - 1], np.full(B, W, np.int32))
for pg in rows:
    alloc.free(pg)
res["spec"] = {"W": W, "n_commit": nc.tolist(),
               "equal": all(out[r, :k].tolist() == plainout[r, :k].tolist()
                            for r in range(B)
                            for k in [min(int(nc[r]), plainout.shape[1])]),
               "eos_in_window": [int(ex.spec.eos_id in plainout[r, :W - 1])
                                 for r in range(B)]}

# Tiering: a conversation demoted to the host tier and promoted back.
plane = e2._tiering
hist = ("tiered history of the dp mesh " * 40)[:spec["history"]]
h1 = e2.submit(GenRequest(id="tier1", prompt=hist, conversation_id="tier",
                          max_new_tokens=8))
e2.run_until_idle()
kv = e2._conv_cache["tier"]
t0 = time.perf_counter()
snap = ex.export_kv_pages(list(kv.pages)).packed.numpy().copy()
export_s = time.perf_counter() - t0
imports = []
orig_import = ex.import_kv_pages


def spy(pages, leaves):
    t0 = time.perf_counter()
    payload = ex._full_pages(leaves).numpy().copy()
    r = orig_import(pages, leaves)
    back = ex.export_kv_pages(list(pages)).packed.numpy().copy()
    imports.append((time.perf_counter() - t0, payload, back))
    return r


ex.import_kv_pages = spy
e2.demote_conversation("tier")
deadline = time.time() + 120
while True:
    with plane._mu:
        e = plane._entries.get("tier")
        if e is not None and e.ready.is_set() and e.tier == "host":
            break
    if time.time() > deadline:
        raise AssertionError("the conversation never reached the host tier")
    time.sleep(0.01)
h2 = e2.submit(GenRequest(id="tier2", prompt=" and then", conversation_id="tier",
                          max_new_tokens=8))
e2.run_until_idle()
ex.import_kv_pages = orig_import
npg = snap.shape[0]
res["tiering"] = {
    "pages": npg, "bytes": int(snap.nbytes), "export_s": export_s,
    "imports": len(imports),
    "import_s": imports[0][0] if imports else None,
    "payload_exact": bool(imports) and np.array_equal(imports[0][1][:npg],
                                                       snap),
    "pool_exact": bool(imports) and np.array_equal(imports[0][2][:npg], snap),
    "turn2": h2.result.finish_reason, "cached": h2.result.cached_tokens,
    "tier": h2.result.kv_tier, "hits": plane.stats()["hits"]}
res["hbm"] = ex.hbm_info()
res["moves"] = dict(dp.moves)
res["plain_total"] = dict(plain)
e2.stop()
app.stop()
res["wall_s"] = time.perf_counter() - t_start
if ex.device.type == "cuda":
    res["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
with open(spec["out"], "w") as f:
    json.dump(res, f, default=str)
"""


def _mesh_dp_config(work: str, shape: dict) -> str:
    """serve-mesh c's config: llama3-8b bf16 at the serve phase's
    geometry over ``executor.mesh`` of ``shape``, speculation and the
    tiered KV plane on."""
    import yaml

    data = {"model": {"name": "llama3-8b", "max_seq_len": 2048},
            "executor": {"max_decode_steps": 32,
                         "mesh": {"enabled": True, "shape": shape},
                         "speculation": {"enabled": True},
                         "kv_tiering": {"enabled": True}}}
    path = os.path.join(work, "mesh_dp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    return path


def _mesh_dp(work: str, shape=None) -> dict:
    """serve-mesh c: the followers (``serve`` children, ranks 1..) and
    the driver (rank 0, MESH_DP_DRIVER) over a mesh of ``shape`` (default
    ``{dp: MESH_DP}``: gloo ranks on one card; with ``tp`` > 1 an NCCL
    world, a card a rank); the driver's record with rank 1's launches
    over the REST load, its dp moves and every follower's exit."""
    import signal as _signal
    import subprocess as _sp

    shape = shape or {"dp": MESH_DP}
    world = 1
    for n in shape.values():
        world *= n
    config = _mesh_dp_config(work, shape)
    env = {k: v for k, v in os.environ.items() if k != "LLMQ_CONFIG"}
    env.update(LLMQ_COORDINATOR=f"127.0.0.1:{_free_tcp_port()}",
               LLMQ_NUM_PROCESSES=str(world), LLMQ_CLUSTER_TIMEOUT="600")
    followers = [_Child(work, "serve", 6 + r, ["--config", config],
                        dict(env, LLMQ_PROCESS_ID=str(r)))
                 for r in range(1, world)]
    follower = followers[0]
    out_path = os.path.join(work, "mesh_dp.json")
    spec = {"config": config, "port": _free_tcp_port(), "out": out_path,
            "mark": follower.status_path, "prompts": list(MESH_C_PROMPTS),
            "new": MESH_C_NEW, "fallback": MESH_C_FALLBACK,
            "history": MESH_C_HISTORY}
    path = os.path.join(work, "mesh_dp_spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(work, "mesh_dp_driver.log")
    with open(log_path, "w") as logf:
        driver = _sp.Popen([sys.executable, "-c", MESH_DP_DRIVER, path],
                           cwd=os.path.dirname(os.path.abspath(__file__)),
                           env=dict(env, LLMQ_PROCESS_ID="0"), stdout=logf,
                           stderr=_sp.STDOUT)
        try:
            rc = driver.wait(MESH_C_S)
        finally:
            if driver.poll() is None:
                driver.kill()
                driver.wait()
    rcs = []
    for f in followers:
        if not rc:
            try:
                # The driver's stop ends a follower's loop: it exits by
                # itself.
                f.p.wait(120.0)
            except _sp.TimeoutExpired:
                pass
        try:
            rcs.append(f.stop(_signal.SIGTERM, timeout=60.0 if not rc
                              else 10.0))
        except AssertionError as e:
            rcs.append(f.p.poll())
            if not rc:
                raise
            log(f"[serve-mesh] c. {e}")
    frc = max(rcs, key=abs)
    if rc:
        with open(log_path) as f:
            tail = "".join(f.readlines()[-40:])
        raise AssertionError(f"serve-mesh c: the driver exited {rc}:\n{tail}"
                             f"\nfollower:\n"
                             + "\n".join(follower.lines()[-20:]))
    with open(out_path) as f:
        res = json.load(f)
    st = follower.status() or {}
    marks = st.get("marks", {})
    res["world"] = world
    res["follower"] = {
        "rc": frc, "boot_s": (st["follow_t"] - follower.started
                              if st.get("follow_t") else None),
        "moves": st.get("dp_moves"),
        "plain": st.get("plain"),
        "launches": {k: marks.get("end", {}).get(k, 0)
                     - marks.get("start", {}).get(k, 0)
                     for k in marks.get("end", {})}}
    return res


def _cuda_holders(limit: int = 4, depth: int = 8) -> dict:
    """A diagnostic of what keeps this process's device memory: the bytes
    of the CUDA tensors the garbage collector can reach, and for the
    largest ``limit`` of them the chain of their first referrers (type,
    and a dict's first keys), ``depth`` links up."""
    import types

    import torch

    found = [o for o in gc.get_objects()
             if isinstance(o, torch.Tensor) and o.is_cuda]
    found.sort(key=lambda t: -t.untyped_storage().nbytes())
    skip = {id(found)}
    out = {"tensors_gb": sum(t.untyped_storage().nbytes()
                             for t in found) / 1e9, "chains": []}
    for t in found[:limit]:
        chain, cur, refs = [], t, None
        for _ in range(depth):
            refs = [r for r in gc.get_referrers(cur)
                    if id(r) not in skip and r is not chain
                    and r is not refs and not isinstance(r, types.FrameType)]
            if not refs:
                break
            cur = refs[0]
            skip.add(id(cur))
            chain.append(type(cur).__name__ + (
                str(list(cur)[:6]) if isinstance(cur, dict) else ""))
        out["chains"].append([f"{tuple(t.shape)} {t.dtype}"] + chain)
    del found
    return out


def phase_serve_mesh(state) -> None:
    """The mesh executor on the card (see the module docstring, 19)."""
    import torch

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "llmq_tpu_torch", "_build", "serve_mesh")
    os.makedirs(work, exist_ok=True)
    out = state.setdefault("serve_mesh", {})
    t0 = time.perf_counter()
    engine = state.pop("serve_engine", None)
    if engine is not None:
        engine.executor.release_graphs()
    del engine
    state.pop("serve_params", None)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    out["parent_gb"] = torch.cuda.memory_allocated() / 1e9
    out["parent_reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    log(f"[serve-mesh] this process holds {out['parent_gb']:.2f} GB "
        f"({out['parent_reserved_gb']:.2f} GB reserved); "
        f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free ({CARD})")
    if out["parent_gb"] > 1.0:
        out["parent_holders"] = _cuda_holders()
        log(f"[serve-mesh] what holds it: {out['parent_holders']}")
    a_mesh = _mesh_child(work, mesh=True)
    a_off = _mesh_child(work, mesh=False)
    out["a"] = {"tp1": a_mesh, "off": a_off}
    path_kernels = ("fused_decode", "kv_prefill_write", "prefill_attention")
    log(f"[serve-mesh] a. {a_mesh.get('joined')}; tp=1 child up in "
        f"{a_mesh['boot_s']:.1f} s, no-mesh child in {a_off['boot_s']:.1f} "
        f"s; graphs {a_mesh['graphs']} vs {a_off['graphs']}, replays over "
        f"the traffic {a_mesh['replays']} vs {a_off['replays']}; launches "
        f"{ {k: a_mesh['launches'][k] for k in path_kernels} } vs "
        f"{ {k: a_off['launches'][k] for k in path_kernels} }; n_chips "
        f"{a_mesh['n_chips']}, hbm chips {a_mesh['hbm_chips']}; request "
        f"walls tp=1 {[round(w, 3) for w in a_mesh['walls_s']]} s, no mesh "
        f"{[round(w, 3) for w in a_off['walls_s']]} s; device ms a step "
        f"tp=1 {a_mesh['step_ms']}, no mesh {a_off['step_ms']}; exits "
        f"{a_mesh['rc']}, {a_off['rc']} ({CARD})")
    if a_mesh["tokens"] != a_off["tokens"]:
        raise AssertionError(f"serve-mesh a: tp=1 tokens "
                             f"{a_mesh['tokens']} != no mesh "
                             f"{a_off['tokens']}")
    if a_mesh["graphs"] <= 0 or a_mesh["replays"] <= 0:
        raise AssertionError(f"serve-mesh a: graphs {a_mesh['graphs']}, "
                             f"replays {a_mesh['replays']}")
    for k in path_kernels:
        if a_mesh["launches"][k] != a_off["launches"][k] or \
                a_mesh["launches"][k] <= 0:
            raise AssertionError(f"serve-mesh a: {k} launched "
                                 f"{a_mesh['launches'][k]} times on tp=1, "
                                 f"{a_off['launches'][k]} without the mesh")
    if a_mesh["n_chips"] != 1 or len(a_mesh["hbm_chips"]) != 1:
        raise AssertionError(f"serve-mesh a: n_chips {a_mesh['n_chips']}, "
                             f"hbm entries {a_mesh['hbm_chips']}")
    if a_mesh["plain"] or a_off["plain"]:
        raise AssertionError(f"serve-mesh a: twins called "
                             f"{a_mesh['plain']} {a_off['plain']}")
    ranks = _mesh_ranks(work)
    out["b"] = ranks
    cmp = ranks[0]["compare"]
    for r in ranks:
        log(f"[serve-mesh] b. rank {r['rank']}: {r['heads']} query heads, "
            f"{r['kv_heads']} KV heads, ffn {r['ffn']}, vocab rows "
            f"{r['vocab']}, weights {r['weights_bytes'] / 1e9:.2f} GB, peak "
            f"{r['peak_gb']:.2f} GB; tp forwards {r['tp_s']:.1f} s, wall "
            f"{r['wall_s']:.1f} s; launches {r['launches']} ({CARD})")
    log(f"[serve-mesh] b. one-rank reference {ranks[0]['reference_s']:.1f} "
        f"s, launches {ranks[0]['reference_launches']}; comparison {cmp} "
        f"({CARD})")
    for k, c in cmp.items():
        if c["max_abs_err"] > c["bound"] or \
                c["confident_argmax_equal"] != c["confident_rows"]:
            raise AssertionError(f"serve-mesh b: {k} {c}")
    for r in ranks:
        if (r["kv_heads"], r["heads"]) != (4, 16):
            raise AssertionError(f"serve-mesh b: rank {r['rank']} holds "
                                 f"{r['heads']} / {r['kv_heads']} heads")
        for k in ("fused_decode", "kv_prefill_write", "prefill_attention",
                  "kv_cache_write", "fused_decode_q8",
                  "paged_decode_attention"):
            if r["launches"].get(k, 0) <= 0:
                raise AssertionError(f"serve-mesh b: rank {r['rank']} did "
                                     f"not launch {k}: {r['launches']}")
    t_c = time.perf_counter()
    c = _mesh_dp(work)
    # One device's step at 8 rows, the serve phase's (this call's card).
    c["ref_step_ms"] = (state.get("serve") or {}).get("executor_step_ms")
    out["c"] = c
    _mesh_dp_gates(c)
    out["c_s"] = time.perf_counter() - t_c
    for name, rec in state["kernels"].items():
        rec["mesh_launches"] = {
            "a_tp1": a_mesh["launches"].get(name, 0),
            **{f"b_rank{r['rank']}": r["launches"].get(name, 0)
               for r in ranks},
            "c_rank0": c["load"]["launches"].get(name, 0),
            "c_rank1": c["follower"]["launches"].get(name, 0)}
    out["phase_s"] = time.perf_counter() - t0
    log(f"[serve-mesh] c. {out['c_s']:.1f} s; the phase {out['phase_s']:.1f}"
        f" s ({CARD})")


def _mesh_dp_gates(c: dict) -> None:
    """serve-mesh c's report and gates (see the module docstring, 19)."""
    load, fol = c["load"], c["follower"]
    path_kernels = ("fused_decode", "kv_prefill_write", "prefill_attention")
    log(f"[serve-mesh] c. mesh {c['mesh']} over {c['backend']}, dp_shards "
        f"{c['dp_shards']}, {c['rows']} rows and {c['pool_pages']} local "
        f"pages ({c['guests']} guests) a replica, {c['graphs']} graphs on "
        f"rank 0; boot rank 0 {c['boot_s']:.1f} s (warmup {c['warmup_s']}), "
        f"rank 1 {fol['boot_s']} s; step ms at {c['rows']} rows "
        f"{c['mesh_step_ms']} against one device at 8 rows "
        f"{c['ref_step_ms']} ({CARD})")
    log(f"[serve-mesh] c. load: 8 concurrent REST requests in "
        f"{c['load_s']:.2f} s, {load['status']}, walls "
        f"{ {k: round(v, 3) for k, v in load['walls_s'].items()} } s; "
        f"replays {load['replays']}; launches rank 0 "
        f"{ {k: load['launches'].get(k, 0) for k in path_kernels} }, rank 1 "
        f"{ {k: fol['launches'].get(k, 0) for k in path_kernels} }; "
        f"locality samples {load['locality_samples']}, off-universe "
        f"{load['locality_bad']}; speculation {load['spec']} ({CARD})")
    log(f"[serve-mesh] c. fallback {c['fallback']}; guest vs home "
        f"{c['guest_vs_home']}; first-step logits against one device "
        f"{c['logits']}; speculation {c['spec']}; tiering {c['tiering']}; "
        f"dp moves rank 0 {c['moves']}, rank 1 {fol['moves']}; follower "
        f"exit {fol['rc']} ({CARD})")
    for chip in c["hbm"]:
        log(f"[serve-mesh] c. hbm {chip} ({CARD})")
    log(f"[serve-mesh] c. rank 0 peak reserved "
        f"{c.get('peak_reserved_gb')} GB ({CARD})")
    if set(load["status"].values()) != {"completed"} or \
            len(load["status"]) != len(MESH_C_PROMPTS):
        raise AssertionError(f"serve-mesh c: load {load['status']}")
    if load["plain"] or fol["plain"] or c["plain_total"]:
        raise AssertionError(f"serve-mesh c: twins called {load['plain']} "
                             f"{fol['plain']} {c['plain_total']}")
    for k in path_kernels:
        if load["launches"].get(k, 0) <= 0 or fol["launches"].get(k, 0) <= 0:
            raise AssertionError(f"serve-mesh c: {k} launched "
                                 f"{load['launches'].get(k, 0)} / "
                                 f"{fol['launches'].get(k, 0)} times")
    if c["dp_shards"] != c["mesh"].get("dp") or load["replays"] <= 0:
        raise AssertionError(f"serve-mesh c: dp_shards {c['dp_shards']}, "
                             f"replays {load['replays']}")
    if load["locality_bad"] or load["locality_samples"] <= 0:
        raise AssertionError(f"serve-mesh c: rows off their universe "
                             f"{load['locality_bad']} "
                             f"({load['locality_samples']} samples)")
    fb = c["fallback"]
    if (fb["slot_universe"], fb["page_universes"]) != (0, [1]) or \
            fb["finish"] not in ("eos", "length") or \
            fb["moves"]["pages_in"] <= 0 or fb["moves"]["pages_out"] <= 0:
        raise AssertionError(f"serve-mesh c: fallback {fb}")
    gh = c["guest_vs_home"]
    if not gh["equal"] or gh["moves"]["pages_in"] <= 0:
        raise AssertionError(f"serve-mesh c: guest vs home {gh}")
    lg = c["logits"]
    if c["mesh"].get("tp", 1) == 1 and (
            lg is None or lg["max_abs_err"] > MESH_BOUND * lg["max_abs_logit"]):
        raise AssertionError(f"serve-mesh c: first-step logits {lg}")
    sp = c["spec"]
    if not sp["equal"] or any(n != sp["W"] and not e for n, e in zip(
            sp["n_commit"], sp["eos_in_window"])):
        raise AssertionError(f"serve-mesh c: speculation {sp}")
    tr = c["tiering"]
    if not (tr["imports"] == 1 and tr["payload_exact"] and tr["pool_exact"]
            and tr["turn2"] in ("eos", "length") and tr["tier"] == "host"):
        raise AssertionError(f"serve-mesh c: tiering {tr}")
    if len(c["hbm"]) != c["world"] or fol["rc"] != 0:
        raise AssertionError(f"serve-mesh c: hbm entries {len(c['hbm'])}, "
                             f"follower exit {fol['rc']}")


PHASES = [("env", phase_env), ("build", phase_build),
          ("kernels", phase_kernels), ("split", phase_split),
          ("model", phase_model), ("graphs", phase_graphs),
          ("serve", phase_serve), ("serve-spec", phase_serve_spec),
          ("serve-tiering", phase_serve_tiering),
          ("serve-disagg", phase_serve_disagg),
          ("serve-scenarios", phase_serve_scenarios),
          ("serve-tenancy", phase_serve_tenancy),
          ("serve-weights", phase_serve_weights),
          ("serve-plane", phase_serve_plane),
          ("serve-control", phase_serve_control),
          ("serve-cluster", phase_serve_cluster),
          ("serve-split", phase_serve_split),
          ("serve-int8", phase_serve_int8),
          ("serve-mesh", phase_serve_mesh)]


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
    lockdep = None
    if os.environ.get("LLMQ_LOCKDEP") == "1":
        # The port's lock-order instrument, installed after torch and
        # before the port's modules create their module-level locks.
        try:
            from llmq_tpu_torch.analysis import lockdep
        except ImportError as e:
            print(f"chip_smoke: the port is not importable here: {e}",
                  file=sys.stderr)
            return 2
        lockdep.install()
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
    if lockdep is not None:
        rep = lockdep.report()
        print(json.dumps({"lockdep": {
            "sites": rep["sites"], "edges": rep["edges"],
            "self_sites": len(rep["self_sites"]),
            "violations": len(rep["violations"])}}))
        if rep["violations"]:
            print("chip_smoke: lockdep violations:\n\n"
                  + "\n\n".join(rep["violations"]), file=sys.stderr)
            return 1
    print(json.dumps({"kernels": list(state["kernels"].values()),
                      "serve": state.get("serve"),
                      "serve_int8": state.get("serve_int8"),
                      "serve_plane": state.get("serve_plane"),
                      "serve_split": state.get("serve_split"),
                      "serve_cluster": state.get("serve_cluster"),
                      "serve_control": state.get("serve_control"),
                      "serve_disagg": state.get("serve_disagg"),
                      "serve_scenarios": state.get("serve_scenarios"),
                      "serve_mesh": state.get("serve_mesh"),
                      "serve_spec": state.get("serve_spec"),
                      "serve_tiering": state.get("serve_tiering"),
                      "serve_tenancy": state.get("serve_tenancy"),
                      "serve_weights": state.get("serve_weights"),
                      "serve_boot": state.get("serve_boot"),
                      "int_mm": state.get("int_mm"),
                      "launch_floor_ms": state.get("launch_floor_ms"),
                      "graphs": state.get("graphs"),
                      "profiler_lost": PROFILER_LOST}, default=str))
    print(CARD)
    if len(chosen) < len(PHASES):
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
