"""One rank of a port mesh on the CPU, started by the port's mesh tests
as its own process: ``python tests/torch_mesh_rank.py SPEC.json``. It
joins a gloo world of ``spec["world"]`` ranks, makes the mesh
``spec["mesh"]`` (default ``{"tp": world}``), and runs
``spec["variants"]`` in order, each on weights the test saved (a flat
``.npz`` of the JAX tree). Rank 0 writes the results, one per variant,
as JSON to ``spec["out"]``; with ``spec["every_rank"]`` every other
rank writes its own (its executor's dp moves and the universe pages its
pool holds) to ``spec["out"] + ".rank{r}"``. It imports neither ``jax``
nor ``llmq_tpu``.

Variants (``kind``):

- ``forward``: every rank shards the tree (``parallel.shard_params``)
  and runs ``forward_prefill``, ``forward_decode`` and ``forward_mixed``
  on ``inputs`` (on ``device``, the CPU by default: on the card the gloo
  ranks share it); the logits and the kernels' launch counts.
- ``engine``: a ``TorchExecutor`` over the mesh; rank 0's
  ``InferenceEngine`` serves ``reqs`` then ``turn2`` while the other
  ranks follow (``TorchExecutor.follow``); per request its tokens, text,
  finish reason and cached tokens, and the executor's ``n_chips`` and
  ``dp_shards``. ``v["engine"]`` turns on the engine's planes
  (``pipeline``, ``mixed``, ``prefix_cache``, ``speculation``),
  ``v["preempt"]`` then runs the preemption phase
  (``tests/test_mesh_executor.py``'s ``run_preemption_phase``).
- ``locality``: the engine seats one request a slot; each live row's
  slot and pages (JAX's ``test_dp_page_locality``), then they finish.
- ``ladder``: universe 0 held full, a request seated in slot 0 takes
  universe 1's pages; then a conversation adopted across universes
  (its turn 2 seated off its pages' universe); each seat's slot and
  pages, the tokens, and the driver's dp moves.
- ``tiering``: a resident pin, then the tiered KV plane's demote and
  promote on a fake clock (``test_mesh_executor.py``'s tiering case);
  then ``v["payload"]`` imported into ``v["pages"]`` and exported back.
- ``verify``: the executor alone: ``v["prefill"]`` rows prefilled, then
  verify windows over ``v["drafts"]``; the windows' tokens and
  ``n_commit``.
- ``builder``: ``build_engine`` over ``executor.mesh`` (random weights
  from seed 0, planes from ``v["executor"]``) serves ``reqs``.
- ``hbm``: the same executor; ``hbm_info()`` on rank 0, the total bytes
  of the tree and the pool as one device holds them, and the ``hbm_*``
  series of the port's ``/metrics`` registry after one request.
- ``idle``: the executor; rank 0 writes ``{"ready": true}`` to
  ``spec["out"]`` and sleeps (the test kills it; a follower must exit
  non-zero, with code 3).
- ``refused``: the executor; rank 0 makes a call whose arguments every
  rank refuses (a chunk wider than the largest bucket), then serves
  ``reqs``: the mesh goes on.
- ``broken``: the executor; on rank ``v["broken_rank"]`` every decode
  step raises. Rank 0 serves ``reqs``; its result holds whether its
  engine reported a failure, the error, and the seconds it took. A
  follower whose call failed exits with code 3.

On a dp mesh the driver's record of each variant gains ``mailbox``, read
after the mesh's release: the calls whose results it still holds, the
calls that live handles may still take, and the count of dropped
handles' results still to come.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

torch.set_num_threads(1)


def _tree(path: str) -> dict:
    npz = np.load(path)
    tree: dict = {}
    for key in npz.files:
        *keys, leaf = key.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = npz[key]
    return tree


def _setup(v):
    """(model config, the whole tree) on ``v["device"]`` (default the
    CPU) in ``v["dtype"]`` (default float32; int8 leaves kept)."""
    from llmq_tpu_torch.models.llama import llama3_tiny, params_from_jax

    dtype = getattr(torch, v.get("dtype", "float32"))
    dev = v.get("device", "cpu")
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev).index or 0)
    cfg = llama3_tiny(dtype=dtype, **v["cfg"])

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(x) for k, x in t.items()}
        return t.to(dtype) if t.is_floating_point() else t
    return cfg, cast(params_from_jax(_tree(v["weights"]), dev))


def _builder_cfg(v):
    from llmq_tpu_torch.core.config import Config

    cfg = Config()
    cfg.device = "cpu"
    cfg.model.name = "llama3-tiny"
    cfg.model.max_seq_len = 128
    for k, val in v["executor"].items():
        if isinstance(val, dict):
            for kk, vv in val.items():
                setattr(getattr(cfg.executor, k), kk, vv)
        else:
            setattr(cfg.executor, k, val)
    return cfg


def _executor(v, mesh, timeout):
    from llmq_tpu_torch.engine.executor import TorchExecutor

    if v["kind"] == "builder":
        from llmq_tpu_torch.engine.builder import build_executor

        return build_executor(_builder_cfg(v), model_dtype=torch.float32)
    cfg, params = _setup(v)
    kw = dict(v.get("geometry", {}))
    if v.get("kv_int8"):
        kw["cache_dtype"] = torch.int8
    ex = TorchExecutor(cfg, params, device="cpu", mesh=mesh,
                       telemetry_name=v.get("name", "engine0"), **kw)
    if v.get("broken_rank") == mesh.rank:
        def broken(eager):
            raise RuntimeError("injected failure of this rank's step")
        ex._run_step = broken
    return ex


def _engine(v, ex, **kw):
    from llmq_tpu_torch.core import config as C
    from llmq_tpu_torch.engine.engine import InferenceEngine
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    planes = v.get("engine", {})
    blocks = {"pipeline": ("async_pipeline", C.AsyncPipelineConfig),
              "mixed": ("mixed_batch", C.MixedBatchConfig),
              "prefix_cache": ("prefix_cache", C.PrefixCacheConfig),
              "speculation": ("speculation", C.SpeculationConfig),
              "tiering": ("kv_tiering", C.KVTieringConfig)}
    for key, (arg, cls) in blocks.items():
        if key in planes:
            kw[arg] = cls(**planes[key])
    return InferenceEngine(ex, ByteTokenizer(), name=v.get("name", "tp"),
                           max_decode_steps=v.get("max_decode_steps", 8),
                           **kw)


def _run(engine, reqs):
    from llmq_tpu_torch.core.types import Priority
    from llmq_tpu_torch.engine.engine import GenRequest

    handles = []
    for r in reqs:
        r = dict(r)
        if "priority" in r:
            r["priority"] = Priority(r["priority"])
        handles.append(engine.submit(GenRequest(**r)))
    engine.run_until_idle()
    return [{"id": r["id"], "tokens": list(h.result.tokens),
             "text": h.result.text,
             "finish_reason": h.result.finish_reason,
             "cached_tokens": h.result.cached_tokens}
            for r, h in zip(reqs, handles)]


def forward(v, mesh) -> dict:
    from llmq_tpu_torch.models import llama as M
    from llmq_tpu_torch.parallel import (kv_cache_shardings,
                                         param_shardings, shard_params,
                                         tensor_parallel)

    cfg, params = _setup(v)
    sh = param_shardings(cfg, mesh, params=params)
    local = shard_params(params, sh, mesh)
    tp = tensor_parallel(mesh, sh)
    split = kv_cache_shardings(cfg, mesh)["k"][3] is not None
    kv_heads = cfg.n_kv_heads // (mesh.tp if split else 1)
    dev = v.get("device", "cpu")
    t = {k: torch.from_numpy(np.asarray(x, np.int32)).to(dev)
         for k, x in v["inputs"].items()}
    cache = M.init_kv_pages(cfg, v["pages"], v["page_size"], dev,
                            kv_heads=kv_heads)
    pre = M.forward_prefill(local, cfg, t["tokens"], t["positions"],
                            t["lengths"], cache, t["bt"], tp=tp)
    dec = M.forward_decode(local, cfg, t["dec_tokens"], t["dec_positions"],
                           cache, t["bt"], tp=tp)
    md, mp = M.forward_mixed(local, cfg, t["mix_tokens"], t["mix_positions"],
                             cache, t["bt"], t["pf_tokens"],
                             t["pf_positions"], t["pf_lengths"], t["pf_bt"],
                             tp=tp)
    from llmq_tpu_torch.ops import kernels

    return {"prefill": pre.float().tolist(), "decode": dec.float().tolist(),
            "mixed_dec": md.float().tolist(), "mixed_pf": mp.float().tolist(),
            "kv_heads": kv_heads, "launches": dict(kernels.LAUNCHES)}


def _preemption(engine) -> dict:
    """``tests/test_mesh_executor.py``'s ``run_preemption_phase``: every
    slot filled with LOW decoders, one step, then REALTIME arrivals."""
    from llmq_tpu_torch.core.types import Priority
    from llmq_tpu_torch.engine.engine import GenRequest

    preempts = []
    orig = engine._preempt

    def spy(victim, release_pages):
        preempts.append(victim.req.id)
        return orig(victim, release_pages)
    engine._preempt = spy
    lows = [engine.submit(GenRequest(
        id=f"L{i}", prompt=f"steady background work {i}",
        priority=Priority.LOW, max_new_tokens=12)) for i in range(4)]
    engine.step()
    rts = [engine.submit(GenRequest(
        id=f"R{i}", prompt=f"urgent {i}", priority=Priority.REALTIME,
        max_new_tokens=6)) for i in range(2)]
    engine.run_until_idle()
    engine._preempt = orig
    return {"tokens": [list(h.result.tokens) for h in lows + rts],
            "preempts": preempts}


def _moves(ex) -> dict:
    dp = getattr(ex, "_dp", None)
    return dict(dp.moves) if dp is not None else {}


def engine(v, ex) -> dict:
    eng = _engine(v, ex, enable_metrics=False)
    out = {"reqs": _run(eng, v["reqs"])}
    if v.get("turn2"):
        out["turn2"] = _run(eng, v["turn2"])
    if v.get("preempt"):
        out["preempt"] = _preemption(eng)
    spec = eng.get_stats().get("speculation")
    if spec:
        out["spec_windows"] = spec.get("windows", 0)
    out["n_chips"] = ex.telemetry_info()["n_chips"]
    out["dp_shards"] = ex.dp_shards
    out["pool_pages"] = int(ex.cache["k"].shape[1])
    out["moves"] = _moves(ex)
    eng.stop()
    return out


def _seat(eng, ids, limit=400):
    """Step until every request of ``ids`` holds a slot and pages; each
    one's (slot, pages)."""
    for _ in range(limit):
        seats = {s.req.id: (slot, list(s.pages))
                 for slot, s in enumerate(eng._slots)
                 if s is not None and s.pages}
        if all(i in seats for i in ids):
            return {i: seats[i] for i in ids}
        eng.step()
    raise RuntimeError(f"not all of {ids} seated")


def locality(v, ex) -> dict:
    from llmq_tpu_torch.engine.engine import GenRequest

    eng = _engine(v, ex, enable_metrics=False)
    ids = [f"s{i}" for i in range(ex.spec.batch_size)]
    hs = [eng.submit(GenRequest(id=i, prompt=f"slot filler {i[1:]}",
                                max_new_tokens=48)) for i in ids]
    seats = _seat(eng, ids)
    shards = {i: [eng.allocator.shard_of(p) for p in pages]
              for i, (_slot, pages) in seats.items()}
    want = {i: eng._slot_shard(slot) for i, (slot, _p) in seats.items()}
    eng.run_until_idle()
    out = {"seats": seats, "shards": shards, "want": want,
           "done": all(h.result is not None for h in hs),
           "tokens": [list(h.result.tokens) for h in hs],
           "moves": _moves(ex)}
    eng.stop()
    return out


def ladder(v, ex) -> dict:
    from llmq_tpu_torch.engine.engine import GenRequest

    eng = _engine(v, ex, enable_metrics=False)
    alloc = eng.allocator
    held = alloc.alloc(alloc.available(shard=0), shard=0)
    h = eng.submit(GenRequest(**v["fallback"]))
    fallback = _seat(eng, [v["fallback"]["id"]])[v["fallback"]["id"]]
    eng.run_until_idle()
    alloc.free(held)
    t1 = eng.submit(GenRequest(**v["turn1"]))
    eng.run_until_idle()
    longs = [eng.submit(GenRequest(**r)) for r in v["longs"]]
    _seat(eng, [r["id"] for r in v["longs"]])
    t2 = eng.submit(GenRequest(**v["turn2"]))
    adopted = _seat(eng, [v["turn2"]["id"]])[v["turn2"]["id"]]
    eng.run_until_idle()
    out = {"fallback": fallback, "adopted": adopted,
           "fallback_shards": [alloc.shard_of(p) for p in fallback[1]],
           "adopted_shards": [alloc.shard_of(p) for p in adopted[1]],
           "slot_shard": [eng._slot_shard(fallback[0]),
                          eng._slot_shard(adopted[0])],
           "tokens": {r["id"]: list(x.result.tokens) for r, x in zip(
               [v["fallback"], v["turn1"]] + v["longs"] + [v["turn2"]],
               [h, t1] + longs + [t2])},
           "cached": t2.result.cached_tokens,
           "moves": _moves(ex)}
    eng.stop()
    return out


def tiering(v, ex) -> dict:
    from llmq_tpu_torch.core.clock import FakeClock
    from llmq_tpu_torch.engine.engine import GenRequest

    outs = []
    for tier in (None, {"enabled": True}):
        clock = FakeClock()
        planes = dict(v.get("engine", {}))
        if tier is not None:
            planes["tiering"] = tier
        eng = _engine(dict(v, engine=planes), ex, enable_metrics=False,
                      clock=clock, kv_pin_ttl=5.0 if tier else 600.0)
        h1 = eng.submit(GenRequest(id="t1", prompt="the quick brown fox",
                                   conversation_id="c", max_new_tokens=8))
        eng.run_until_idle()
        hits = None
        if tier is not None:
            clock.advance(6.0)
            eng.step()
            deadline = time.monotonic() + 30
            while (sum(eng._tiering.counts().values()) != 1
                   or not all(e.ready.is_set()
                              for e in eng._tiering._entries.values())):
                if time.monotonic() > deadline:
                    raise RuntimeError("the demotion did not land")
                time.sleep(0.01)
        h2 = eng.submit(GenRequest(id="t2", prompt=" jumps over",
                                   conversation_id="c", max_new_tokens=8))
        eng.run_until_idle()
        if tier is not None:
            hits = eng.get_stats()["kv_tiering"]["hits"]
        outs.append({"t1": list(h1.result.tokens),
                     "t2": list(h2.result.tokens),
                     "cached": h2.result.cached_tokens, "hits": hits})
        eng.stop()
    payload = np.frombuffer(bytes.fromhex(v["payload"]), np.uint8)
    n = len(v["pages"])
    ex.import_kv_pages(v["pages"], _PagesPayload(payload, n))
    got = ex.export_kv_pages(v["pages"])
    return {"runs": outs, "spec": [[list(s), d] for s, d in
                                   ex.kv_page_spec()],
            "export": got.packed.numpy().tobytes().hex()}


class _PagesPayload:
    """Per-page host buffers as the tiering plane hands them over."""

    def __init__(self, flat: np.ndarray, n: int) -> None:
        self._t = torch.from_numpy(flat.copy()).view(n, -1)

    def tensors(self):
        return [self._t[j] for j in range(self._t.shape[0])]


def verify(v, ex) -> dict:
    B = ex.spec.batch_size
    hs = ex.prefill_multi_async([(t, 0, np.asarray(bt, np.int32), 0.0)
                                 for t, bt in v["prefill"]])
    first = [int(x) for x in ex.gather_scalars(hs)]
    pos = np.array([len(t) for t, _bt in v["prefill"]], np.int32)
    bts = np.array([bt for _t, bt in v["prefill"]], np.int32)
    out = []
    tok = np.array(first, np.int32)
    for drafts in v["drafts"]:
        d = np.asarray(drafts, np.int32)
        qlens = np.full(B, d.shape[1] + 1, np.int32)
        toks, nc = ex.verify_chunk_start(tok, pos, bts, np.zeros(B, np.float32),
                                         d, qlens).fetch()
        out.append({"out": toks.tolist(), "n_commit": nc.tolist()})
        for i in range(B):
            tok[i] = toks[i, nc[i] - 1]
            pos[i] += nc[i]
    return {"first": first, "windows": out, "moves": _moves(ex)}


def builder(v, ex) -> dict:
    from llmq_tpu_torch.engine.builder import build_engine

    eng = build_engine(_builder_cfg(v), executor=ex,
                       model_dtype=torch.float32)
    out = {"reqs": _run(eng, v["reqs"]), "dp_shards": ex.dp_shards,
           "draft_k": ex.verify_draft_k,
           "tiering": eng._tiering is not None}
    eng.stop()
    return out


def indivisible(v, ex) -> dict:
    out = engine(v, ex)
    out["warning"] = _WARNINGS[:]
    return out


#: WARNING records of the executor's logger (the indivisible dp case).
_WARNINGS: list = []


def _capture_warnings():
    import logging

    class H(logging.Handler):
        def emit(self, record):
            _WARNINGS.append(record.getMessage())
    logging.getLogger("llmq_tpu_torch.executor").addHandler(H(logging.WARNING))


def refused(v, ex) -> dict:
    from llmq_tpu_torch.engine.executor import MeshArgumentError

    too_long = [1] * (ex.prefill_buckets[-1] + 1)
    try:
        ex.prefill_async(too_long, 0, np.zeros(ex.spec.max_pages_per_seq,
                                               np.int32), 0.0)
    except MeshArgumentError as e:
        error = str(e)
    else:
        error = None
    out = engine(v, ex)
    out["refused"] = error
    return out


def broken(v, ex) -> dict:
    eng = _engine(v, ex, enable_metrics=False)
    t0 = time.monotonic()
    try:
        res = _run(eng, v["reqs"])
        error = None
    except Exception as e:  # noqa: BLE001 — reported to the test
        res, error = None, f"{type(e).__name__}: {e}"
    return {"reqs": res, "error": error,
            "seconds": time.monotonic() - t0}


def hbm(v, ex) -> dict:
    from llmq_tpu_torch.metrics.registry import exposition
    from llmq_tpu_torch.models.llama import init_kv_pages
    from llmq_tpu_torch.observability.device import get_device_telemetry
    from llmq_tpu_torch.ops.quant import params_bytes

    cfg, params = _setup(v)
    chips = ex.hbm_info()
    eng = _engine(v, ex, enable_metrics=True)
    _run(eng, [dict(id="x", prompt="hello")])
    get_device_telemetry(v["name"]).flush()
    text = exposition().decode()
    series = {}
    for fam in ("hbm_weights_bytes", "hbm_kv_pool_bytes"):
        series[fam] = sorted(
            line.split("{", 1)[1].split("}", 1)[0]
            for line in text.splitlines()
            if line.startswith(f"llm_queue_{fam}{{")
            and f'engine="{v["name"]}"' in line)
    g = v["geometry"]
    whole = init_kv_pages(cfg, g["num_pages"], g["page_size"], "meta")
    return {"chips": chips, "series": series,
            "total_weights": params_bytes(params),
            "total_kv": sum(t.numel() * t.element_size()
                            for t in whole.values())}


def _follower(ex) -> dict:
    """A follower's own record: its dp moves, and the global ids of the
    universe pages its pool holds written (nonzero K)."""
    dp = getattr(ex, "_dp", None)
    if dp is None:
        return {}
    k = ex.cache["k"]
    written = (k.reshape(k.shape[0], k.shape[1], -1) != 0).any(
        dim=2).any(dim=0)
    pages = [dp.d * dp.per + s - 1 for s in range(1, 1 + dp.per)
             if bool(written[s])]
    return {"moves": dict(dp.moves), "universe_written": pages,
            "dp_rank": dp.d, "tp_rank": dp.t}


def main() -> int:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank, world = int(spec["rank"]), int(spec["world"])
    timeout = spec.get("timeout", 60)
    import torch.distributed as dist

    from llmq_tpu_torch.parallel import distributed_init, make_mesh

    distributed_init(spec["coord"], world, rank, timeout, device="cpu")
    mesh = make_mesh(spec.get("mesh") or {"tp": world})
    _capture_warnings()
    results = []
    for v in spec["variants"]:
        if v["kind"] == "builder":
            v["executor"] = dict(v["executor"], mesh={
                "enabled": True, "shape": dict(mesh.shape)})
        if v["kind"] == "forward":
            results.append(forward(v, mesh))
            continue
        ex = _executor(v, mesh, timeout)
        if rank != 0:
            try:
                ex.follow()
            except Exception as e:  # noqa: BLE001 — the mesh is broken
                print(f"rank {rank}: left the mesh: {e}", flush=True)
                # At once: the world's gloo threads may still be talking to
                # a peer, and tearing them down at interpreter exit aborts
                # the process (SIGABRT) instead of exiting 3.
                sys.stdout.flush()
                os._exit(3)
            results.append(_follower(ex))
            continue
        if v["kind"] == "idle":
            with open(spec["out"], "w") as f:
                json.dump({"ready": True}, f)
            time.sleep(600)
            return 0
        results.append({"engine": engine, "hbm": hbm, "refused": refused,
                        "broken": broken, "locality": locality,
                        "ladder": ladder, "tiering": tiering,
                        "verify": verify, "builder": builder,
                        "indivisible": indivisible}[v["kind"]](v, ex))
        if v["kind"] == "broken":
            # The mesh is gone: write the result and leave without the
            # closing barrier.
            with open(spec["out"], "w") as f:
                json.dump(results, f)
            # At once, as a follower leaves: tearing the broken world's
            # gloo threads down at interpreter exit can abort the process.
            sys.stdout.flush()
            os._exit(0)
        # The variant's handles are gone: its results were taken or are
        # discarded as they arrive (every publisher's last one is in by
        # the release).
        gc.collect()
        ex.release_mesh()
        dp = getattr(ex, "_dp", None)
        if dp is not None:
            results[-1]["mailbox"] = {
                "box": sorted({s for s, _e in dp._box}),
                "open": sorted(dp._open), "gone": len(dp._gone)}
    if rank == 0 or spec.get("every_rank"):
        out = spec["out"] + (f".rank{rank}" if rank else "")
        with open(out + ".tmp", "w") as f:
            json.dump(results, f)
        os.replace(out + ".tmp", out)
    dist.barrier()      # leave together: no rank tears down mid-exchange
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
