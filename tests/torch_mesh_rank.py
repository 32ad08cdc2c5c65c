"""One rank of a port mesh on the CPU, started by the port's mesh tests
as its own process: ``python tests/torch_mesh_rank.py SPEC.json``. It
joins a gloo world of ``spec["world"]`` ranks, makes the ``tp`` mesh,
and runs ``spec["variants"]`` in order, each on weights the test saved
(a flat ``.npz`` of the JAX tree). Rank 0 writes the results, one per
variant, as JSON to ``spec["out"]``. It imports neither ``jax`` nor
``llmq_tpu``.

Variants (``kind``):

- ``forward``: every rank shards the tree (``parallel.shard_params``)
  and runs ``forward_prefill``, ``forward_decode`` and ``forward_mixed``
  on ``inputs`` (on ``device``, the CPU by default: on the card the gloo
  ranks share it); the logits and the kernels' launch counts.
- ``engine``: a ``TorchExecutor`` over the mesh; rank 0's
  ``InferenceEngine`` serves ``reqs`` then ``turn2`` while the other
  ranks follow (``TorchExecutor.follow``); per request its tokens, text,
  finish reason and cached tokens, and the executor's ``n_chips``.
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
"""

from __future__ import annotations

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


def _executor(v, mesh, timeout):
    from llmq_tpu_torch.engine.executor import TorchExecutor

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
    from llmq_tpu_torch.engine.engine import InferenceEngine
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

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


def engine(v, ex) -> dict:
    eng = _engine(v, ex, enable_metrics=False)
    out = {"reqs": _run(eng, v["reqs"])}
    if v.get("turn2"):
        out["turn2"] = _run(eng, v["turn2"])
    out["n_chips"] = ex.telemetry_info()["n_chips"]
    return out


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


def main() -> int:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank, world = int(spec["rank"]), int(spec["world"])
    timeout = spec.get("timeout", 60)
    import torch.distributed as dist

    from llmq_tpu_torch.parallel import distributed_init, make_mesh

    distributed_init(spec["coord"], world, rank, timeout, device="cpu")
    mesh = make_mesh({"tp": world})
    results = []
    for v in spec["variants"]:
        if v["kind"] == "forward":
            results.append(forward(v, mesh))
            continue
        ex = _executor(v, mesh, timeout)
        if rank != 0:
            try:
                ex.follow()
            except Exception as e:  # noqa: BLE001 — the mesh is broken
                print(f"rank {rank}: left the mesh: {e}", flush=True)
                return 3
            continue
        if v["kind"] == "idle":
            with open(spec["out"], "w") as f:
                json.dump({"ready": True}, f)
            time.sleep(600)
            return 0
        results.append({"engine": engine, "hbm": hbm, "refused": refused,
                        "broken": broken}[v["kind"]](v, ex))
        if v["kind"] == "broken":
            # The mesh is gone: write the result and leave without the
            # closing barrier.
            with open(spec["out"], "w") as f:
                json.dump(results, f)
            return 0
        ex.release_mesh()
    if rank == 0:
        with open(spec["out"] + ".tmp", "w") as f:
            json.dump(results, f)
        os.replace(spec["out"] + ".tmp", spec["out"])
    dist.barrier()      # leave together: no rank tears down mid-exchange
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
