"""The port's mesh executor on the CPU: ``tp`` ranks as gloo processes
(``tests/torch_mesh_rank.py``, which imports neither ``jax`` nor
``llmq_tpu``) against the JAX package in this process, on the same
weights (JAX's ``init_params``, carried across by ``params_from_jax``
and cut by ``shard_params``).

- model-level forwards at tp ∈ {2, 4} (``forward_prefill``,
  ``forward_decode``, ``forward_mixed``), float32, against JAX's single
  device and JAX's ``{"tp": 8}`` mesh: ``rtol=atol=1e-4`` (JAX's
  ``TestTPCorrectness`` tolerance);
- engines at tp ∈ {2, 4} over a driver and its followers serving
  ``tests/test_engine_tp.py``'s requests and the turn 2 on ``c1``, with
  plain f32 weights, int8 weights and int8 KV, against JAX's ``{"tp":
  8}`` engine: tokens, text, finish reasons and cached tokens equal
  (exact);
- per-rank HBM at tp=4 (JAX's ``TestPerChipHbm``): each rank's pool bytes
  are the pool over 4 and sum to it, its weights within JAX's 0.9-1.2 x
  total/4 band, and rank 0's scrape has one ``hbm_*`` series per rank;
- at tp=2, a call whose arguments every rank refuses leaves the mesh
  serving: the requests after it are JAX's ``{"tp": 8}`` engine's.

One spawn per tp runs every variant in order (a new executor each).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.core.types import Priority  # noqa: E402
from llmq_tpu.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.ops.quant import quantize_params  # noqa: E402
from llmq_tpu.parallel import make_mesh  # noqa: E402
from llmq_tpu.parallel.sharding import (  # noqa: E402
    kv_cache_shardings, param_shardings, shard_params)

HERE = os.path.dirname(os.path.abspath(__file__))
RANK = os.path.join(HERE, "torch_mesh_rank.py")
SPAWN_TIMEOUT_S = 120

#: tests/test_engine_tp.py's tp_cfg and engine geometry, float32.
TP_KW = dict(dim=256, n_heads=8, n_kv_heads=8, ffn_dim=512, vocab_size=512,
             max_seq_len=256)
GEOMETRY = dict(batch_size=4, page_size=16, num_pages=65, chunk_size=4,
                prefill_buckets=[32], eos_id=2)
REQS = [
    dict(id="a", prompt="hello tensor parallel", conversation_id="c1"),
    dict(id="b", prompt="second request", priority=int(Priority.REALTIME)),
    dict(id="c", prompt="third one", conversation_id="c2"),
]
TURN2 = [dict(id="a2", prompt=" more", conversation_id="c1")]
ENGINES = ("f32", "int8_weights", "int8_kv")

#: tests/test_parallel.py's TestTPCorrectness model (8 heads, 8 KV heads).
FWD_KW = dict(n_heads=8, n_kv_heads=8, dim=64, ffn_dim=128, vocab_size=256)
PAGE, NPAGES = 4, 32
HBM_NAME = "meshhbm"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _save(tree, path):
    flat = {}

    def walk(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + k + "/")
            else:
                flat[pre + k] = np.asarray(v)
    walk(tree)
    np.savez(path, **flat)
    return str(path)


def _forward_inputs():
    rng = np.random.default_rng(7)
    i32 = np.int32
    return {
        "tokens": rng.integers(0, 256, (2, 8)).astype(i32),
        "positions": np.broadcast_to(np.arange(8, dtype=i32),
                                     (2, 8)).copy(),
        "lengths": np.array([8, 5], i32),
        "bt": np.array([[1, 2, 0, 0], [3, 4, 0, 0]], i32),
        "dec_tokens": np.array([7, 9], i32),
        "dec_positions": np.array([8, 5], i32),
        "mix_tokens": np.array([11, 13], i32),
        "mix_positions": np.array([9, 6], i32),
        "pf_tokens": rng.integers(0, 256, (1, 4)).astype(i32),
        "pf_positions": np.arange(4, dtype=i32)[None],
        "pf_lengths": np.array([4], i32),
        "pf_bt": np.array([[5, 0, 0, 0]], i32),
    }


def _jax_forwards(params, cfg, inp, mesh=None):
    """JAX's prefill, decode and mixed logits on one device or, sharded,
    on ``mesh``, threading the cache."""
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    cache = J.init_kv_pages(cfg, NPAGES, PAGE, jnp.float32)
    if mesh is not None:
        params = shard_params(params, param_shardings(cfg, mesh))
        cache = jax.device_put(cache, kv_cache_shardings(cfg, mesh))
    pre, cache = J.forward_prefill(params, cfg, a["tokens"], a["positions"],
                                   a["lengths"], cache, a["bt"])
    dec, cache = J.forward_decode(params, cfg, a["dec_tokens"],
                                  a["dec_positions"], cache, a["bt"])
    md, mp, cache = J.forward_mixed(params, cfg, a["mix_tokens"],
                                    a["mix_positions"], cache, a["bt"],
                                    a["pf_tokens"], a["pf_positions"],
                                    a["pf_lengths"], a["pf_bt"])
    return {"prefill": pre, "decode": dec, "mixed_dec": md, "mixed_pf": mp}


def _jax_engine(params, cfg, kv_int8: bool):
    tok = ByteTokenizer()
    kw = dict(GEOMETRY, eos_id=tok.eos_id)
    if kv_int8:
        kw["cache_dtype"] = jnp.int8
    ex = JaxExecutor(cfg, params, mesh=make_mesh({"tp": 8}), **kw)
    eng = InferenceEngine(ex, tok, name="tp", enable_metrics=False,
                          max_decode_steps=8)

    def run(reqs):
        hs = [eng.submit(GenRequest(**{**r, **(
            {"priority": Priority(r["priority"])} if "priority" in r
            else {})})) for r in reqs]
        eng.run_until_idle()
        return [{"id": r["id"], "tokens": list(h.result.tokens),
                 "text": h.result.text,
                 "finish_reason": h.result.finish_reason,
                 "cached_tokens": h.result.cached_tokens}
                for r, h in zip(reqs, hs)]
    out = {"reqs": run(REQS), "turn2": run(TURN2)}
    eng.stop()
    return out


def _spawn(world: int, variants, tmp) -> list:
    """``world`` rank processes over one gloo world; rank 0's results."""
    coord = f"127.0.0.1:{_free_port()}"
    out = os.path.join(tmp, f"tp{world}.json")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = []
    for r in range(world):
        spec = os.path.join(tmp, f"tp{world}-rank{r}.json")
        with open(spec, "w") as f:
            json.dump({"coord": coord, "world": world, "rank": r,
                       "out": out, "timeout": SPAWN_TIMEOUT_S,
                       "variants": variants}, f)
        procs.append(subprocess.Popen(
            [sys.executable, RANK, spec], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    tp_cfg = J.llama3_tiny(dtype=jnp.float32, **TP_KW)
    tp_params = J.init_params(jax.random.PRNGKey(0), tp_cfg)
    fwd_cfg = J.llama3_tiny(dtype=jnp.float32, **FWD_KW)
    fwd_params = J.init_params(jax.random.PRNGKey(0), fwd_cfg)
    return {
        "tmp": str(tmp), "tp_cfg": tp_cfg, "tp_params": tp_params,
        "fwd_cfg": fwd_cfg, "fwd_params": fwd_params,
        "f32": _save(tp_params, tmp / "f32.npz"),
        "int8": _save(quantize_params(tp_params), tmp / "int8.npz"),
        "fwd": _save(fwd_params, tmp / "fwd.npz"),
    }


def _variants(weights, world):
    eng = dict(kind="engine", cfg=TP_KW, geometry=GEOMETRY, reqs=REQS,
               turn2=TURN2)
    inputs = {k: v.tolist() for k, v in _forward_inputs().items()}
    vs = [dict(kind="forward", cfg=FWD_KW, weights=weights["fwd"],
               inputs=inputs, pages=NPAGES, page_size=PAGE),
          dict(eng, weights=weights["f32"]),
          dict(eng, weights=weights["int8"]),
          dict(eng, weights=weights["f32"], kv_int8=True)]
    if world == 4:
        vs.append(dict(kind="hbm", cfg=TP_KW, geometry=GEOMETRY,
                       weights=weights["f32"], name=HBM_NAME))
    else:
        vs.append(dict(eng, kind="refused", weights=weights["f32"]))
    return vs


_RUNS = {}


def _port(weights, world):
    if world not in _RUNS:
        _RUNS[world] = _spawn(world, _variants(weights, world),
                              weights["tmp"])
    return _RUNS[world]


_JAX = {}


def _jax(weights, what):
    if what not in _JAX:
        if what == "forward_one":
            _JAX[what] = _jax_forwards(weights["fwd_params"],
                                       weights["fwd_cfg"], _forward_inputs())
        elif what == "forward_tp8":
            _JAX[what] = _jax_forwards(weights["fwd_params"],
                                       weights["fwd_cfg"], _forward_inputs(),
                                       make_mesh({"tp": 8}))
        else:
            params = weights["tp_params"]
            if what == "int8_weights":
                params = quantize_params(params)
            _JAX[what] = _jax_engine(params, weights["tp_cfg"],
                                     kv_int8=what == "int8_kv")
    return _JAX[what]


@pytest.mark.parametrize("ref", ["forward_one", "forward_tp8"])
@pytest.mark.parametrize("world", [2, 4])
def test_tp_forwards_match_jax(weights, world, ref):
    """Prefill, decode and the mixed step of the port's tp ranks against
    JAX's single device and its tp=8 mesh (f32, 1e-4)."""
    got = _port(weights, world)[0]
    want = _jax(weights, ref)
    assert got["kv_heads"] == 8 // world
    lengths = _forward_inputs()["lengths"]
    for k in ("prefill", "decode", "mixed_dec", "mixed_pf"):
        g, w = np.asarray(got[k], np.float32), np.asarray(want[k])
        if k == "prefill":
            # A row's logits past its length are padding in both packages.
            live = np.arange(g.shape[1])[None, :] < lengths[:, None]
            g, w = g[live], w[live]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


#: The int8-weight engine's tie allowance: an activation one f32 ulp
#: apart rounds to the next int8 step, which moves a logit by ~0.01 on
#: this model, so where the port's one-device int8 engine and JAX's
#: choose differently, JAX's own top-2 gap there must be below this.
INT8_TIE = 0.05


def _port_one(weights, variant):
    """The port's one-device engine (no mesh) on the same weights."""
    key = ("port_one", variant)
    if key in _JAX:
        return _JAX[key]
    import torch

    from llmq_tpu_torch.core.types import Priority as TPrio
    from llmq_tpu_torch.engine.engine import GenRequest as TReq
    from llmq_tpu_torch.engine.engine import InferenceEngine as TEngine
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
    from llmq_tpu_torch.models import llama as T

    params = weights["tp_params"]
    if variant == "int8_weights":
        params = quantize_params(params)
    kw = dict(GEOMETRY)
    if variant == "int8_kv":
        kw["cache_dtype"] = torch.int8
    ex = TorchExecutor(T.llama3_tiny(dtype=torch.float32, **TP_KW),
                       T.params_from_jax(params, "cpu"), device="cpu", **kw)
    eng = TEngine(ex, TTok(), name="one", enable_metrics=False,
                  max_decode_steps=8)

    def run(reqs):
        hs = [eng.submit(TReq(**{**r, **(
            {"priority": TPrio(r["priority"])} if "priority" in r
            else {})})) for r in reqs]
        eng.run_until_idle()
        return [{"id": r["id"], "tokens": list(h.result.tokens),
                 "text": h.result.text,
                 "finish_reason": h.result.finish_reason,
                 "cached_tokens": h.result.cached_tokens}
                for r, h in zip(reqs, hs)]
    _JAX[key] = {"reqs": run(REQS), "turn2": run(TURN2)}
    eng.stop()
    return _JAX[key]


def _jax_gap(weights, prompt: str, tokens, k: int, other: int) -> float:
    """JAX's one-device int8 logit of its own choice ``tokens[k]`` minus
    that of ``other``, teacher-forced over ``prompt`` and ``tokens[:k]``."""
    cfg = weights["tp_cfg"]
    params = quantize_params(weights["tp_params"])
    ids = ByteTokenizer().encode(prompt) + list(tokens[:k])
    n, T = len(ids), 64
    toks = np.zeros((1, T), np.int32)
    toks[0, :n] = ids
    pos = np.minimum(np.arange(T), n - 1)[None].astype(np.int32)
    logits, _ = J.forward_prefill(
        params, cfg, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray([n], jnp.int32),
        J.init_kv_pages(cfg, 16, GEOMETRY["page_size"], jnp.float32),
        jnp.asarray([[1, 2, 3, 4]], jnp.int32))
    row = np.asarray(logits)[0, n - 1]
    assert int(row.argmax()) == tokens[k]
    return float(row[tokens[k]] - row[other])


@pytest.mark.parametrize("variant", ENGINES)
@pytest.mark.parametrize("world", [2, 4])
def test_tp_engine_serves_like_jax_tp8(weights, world, variant):
    """``test_engine_tp.py``'s requests through a port engine over a tp
    mesh (rank 0 drives, the others follow) serve token for token and
    text for text like JAX's ``{"tp": 8}`` engine; turn 2 on ``c1``
    reports JAX's cached tokens (> 0) and its tokens. With int8 weights
    the mesh serves exactly what the port's one-device engine serves,
    and that engine holds JAX's tokens except at a tie (``INT8_TIE``) of
    JAX's own logits, where it may take the other token; its turn 2 then
    continues another history."""
    got = _port(weights, world)[1 + ENGINES.index(variant)]
    want = _jax(weights, variant)
    assert got["n_chips"] == world
    if variant == "int8_weights":
        one = _port_one(weights, variant)
        assert got["reqs"] == one["reqs"]
        assert got["turn2"] == one["turn2"]
        for g, w, r in zip(got["reqs"], want["reqs"], REQS):
            assert g["finish_reason"] in ("eos", "length")
            if g["tokens"] == w["tokens"]:
                continue
            k = next(i for i, (a, b) in enumerate(zip(g["tokens"],
                                                      w["tokens"]))
                     if a != b)
            gap = _jax_gap(weights, r["prompt"], w["tokens"], k,
                           g["tokens"][k])
            assert 0.0 <= gap < INT8_TIE, (r["id"], k, gap)
        assert got["turn2"][0]["cached_tokens"] == \
            want["turn2"][0]["cached_tokens"] > 0
        return
    for g, w in zip(got["reqs"], want["reqs"]):
        assert g["finish_reason"] in ("eos", "length")
        assert g == w, g["id"]
    (g2,), (w2,) = got["turn2"], want["turn2"]
    assert g2["cached_tokens"] > 0
    assert g2 == w2


def test_per_rank_hbm_at_tp4(weights):
    got = _port(weights, 4)[-1]
    chips = got["chips"]
    assert [c["chip"] for c in chips] == ["0", "1", "2", "3"]
    total_kv, total_w = got["total_kv"], got["total_weights"]
    assert all(c["kv_pool_bytes"] == total_kv // 4 for c in chips)
    assert sum(c["kv_pool_bytes"] for c in chips) == total_kv
    w = {c["weights_bytes"] for c in chips}
    assert len(w) == 1
    per_rank = w.pop()
    assert total_w / 4 * 0.9 < per_rank < total_w / 4 * 1.2
    for fam, series in got["series"].items():
        assert series == sorted(f'chip="{r}",engine="{HBM_NAME}"'
                                for r in range(4)) or series == sorted(
            f'engine="{HBM_NAME}",chip="{r}"' for r in range(4)), (fam,
                                                                  series)


def test_refused_arguments_leave_the_mesh_serving(weights):
    """Rank 0 calls ``prefill_async`` with a chunk wider than the largest
    bucket: every rank refuses it alike (``MeshArgumentError``, before
    any device work), the follower stays, and the engine served after it
    answers exactly as JAX's ``{"tp": 8}`` engine (f32)."""
    got = _port(weights, 2)[-1]
    assert "bucket-sized" in got["refused"]
    want = _jax(weights, "f32")
    assert got["reqs"] == want["reqs"]
    assert got["turn2"] == want["turn2"]
