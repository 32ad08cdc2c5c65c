"""The port's dp page universes on the device, on the CPU: dp=2 × tp=1 (2
gloo ranks) and dp=2 × tp=2 (4 ranks) through ``tests/torch_mesh_rank.py``
(which imports neither ``jax`` nor ``llmq_tpu``), one spawn a geometry
running every variant, against the JAX package in this process on the
same f32 weights (``tests/test_engine_tp.py``'s ``tp_cfg``, JAX's
``init_params``, carried across by ``params_from_jax``) and the
geometry of ``tests/test_mesh_executor.py``'s ``build_engine`` (4 slots,
64 pages of 16, the prefix cache on).

- serving: ``test_engine_tp.py``'s ``REQS`` and turn 2; ``WAVE`` through
  pipeline depth 2 and mixed batching, both conversations' turn 2 and
  the preemption phase; the same with speculation on: tokens, text,
  finish reasons and cached tokens equal JAX's one-device f32 engine's,
  and JAX's ``{"dp": 2, "tp": 4}`` f32 engine's where JAX's mesh serves
  its own one device's (exact);
- page locality (JAX's ``test_dp_page_locality``), with each replica's
  pool holding its rows' pages and no page moved;
- the cross-universe fallback on the real model (``TestDpAllocLadder``):
  universe 0 held full, a slot-0 row served from universe 1's pages, and
  a conversation adopted into the other universe's slot; tokens equal
  JAX's one-device engine's, and the guests really moved;
- indivisible dp (batch 3, 65 pages) degrades to one universe with JAX's
  warning and still serves;
- per-rank HBM (JAX's ``TestPerChipHbm``): each rank's universe bytes are
  the pool over the mesh and sum to it; the guests are stated apart;
- the tiered KV plane: demote and promote equal the resident pin
  (``test_mesh_executor.py``'s tiering case); a payload imported and
  exported through the mesh is bitwise itself, in JAX's page format;
- verify windows with device and host accept: the one-device executor's
  tokens and ``n_commit``;
- the builder: ``executor.mesh`` with speculation and tiering on serves
  the one-device builder engine's tokens.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.core.config import PrefixCacheConfig  # noqa: E402
from llmq_tpu.core.types import Priority  # noqa: E402
from llmq_tpu.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.parallel import make_mesh  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
RANK = os.path.join(HERE, "torch_mesh_rank.py")
SPAWN_TIMEOUT_S = 240

TP_KW = dict(dim=256, n_heads=8, n_kv_heads=8, ffn_dim=512, vocab_size=512,
             max_seq_len=256)
#: ``test_mesh_executor.py``'s ``build_engine`` geometry.
GEOMETRY = dict(batch_size=4, page_size=16, num_pages=64, chunk_size=4,
                prefill_buckets=[32], eos_id=2)
PREFIX = {"prefix_cache": {"enabled": True}}
REQS = [
    dict(id="a", prompt="hello tensor parallel", conversation_id="c1"),
    dict(id="b", prompt="second request", priority=int(Priority.REALTIME)),
    dict(id="c", prompt="third one", conversation_id="c2"),
]
TURN2 = [dict(id="a2", prompt=" more", conversation_id="c1")]
WAVE = [
    dict(id="a", prompt="hello tensor parallel mesh", conversation_id="c1"),
    dict(id="b", prompt="second request", priority=int(Priority.REALTIME)),
    dict(id="c", prompt="third one", conversation_id="c2"),
    dict(id="d", prompt="a rather longer prompt that streams through "
                        "more than one prefill chunk easily",
         priority=int(Priority.LOW)),
    dict(id="e", prompt="fifth", priority=int(Priority.REALTIME)),
    dict(id="f", prompt="sixth request runs too"),
]
WAVE_T2 = [dict(id="a2", prompt=" more", conversation_id="c1"),
           dict(id="c2t", prompt=" again", conversation_id="c2")]
#: The ladder: a fallback row, then a conversation adopted across
#: universes while two long rows hold its universe's slots.
LADDER = dict(
    fallback=dict(id="fb", prompt="fallback row reads universe one",
                  max_new_tokens=10),
    turn1=dict(id="x1", prompt="alpha beta gamma delta", conversation_id="x",
               max_new_tokens=6),
    longs=[dict(id=f"L{i}", prompt=f"long holder {i}", max_new_tokens=24)
           for i in range(2)],
    turn2=dict(id="x2", prompt=" epsilon", conversation_id="x",
               max_new_tokens=6))
#: Pages of the transport round trip: each universe, the null page's
#: universe included.
TIER_PAGES = [1, 5, 33, 60]
DRAFT_K = 3
MESHES = {"dp2tp1": {"dp": 2, "tp": 1}, "dp2tp2": {"dp": 2, "tp": 2}}


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


def _spawn(name: str, shape, variants, tmp) -> list:
    """The mesh's rank processes over one gloo world; every rank's
    results (rank 0's first)."""
    world = int(np.prod(list(shape.values())))
    coord = f"127.0.0.1:{_free_port()}"
    out = os.path.join(tmp, f"{name}.json")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = []
    for r in range(world):
        spec = os.path.join(tmp, f"{name}-rank{r}.json")
        with open(spec, "w") as f:
            json.dump({"coord": coord, "world": world, "rank": r,
                       "out": out, "timeout": SPAWN_TIMEOUT_S, "mesh": shape,
                       "every_rank": True, "variants": variants}, f)
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
    results = []
    for r in range(world):
        with open(out + (f".rank{r}" if r else "")) as f:
            results.append(json.load(f))
    return results


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    cfg = J.llama3_tiny(dtype=jnp.float32, **TP_KW)
    params = J.init_params(jax.random.PRNGKey(0), cfg)
    return {"tmp": str(tmp), "cfg": cfg, "params": params,
            "f32": _save(params, tmp / "f32.npz")}


def _payload(weights) -> bytes:
    """Random bytes of ``TIER_PAGES`` full pages, from a seed."""
    ex = _port_executor(weights)
    n = sum(int(np.prod(s)) * np.dtype(d).itemsize
            for s, d in ex.kv_page_spec())
    rng = np.random.default_rng(22)
    return rng.integers(0, 256, len(TIER_PAGES) * n, np.uint8).tobytes()


def _verify_inputs():
    """Four rows' prompts, rows 1 and 2 over the other replica's universe
    (guests), and each window's drafts."""
    rng = np.random.default_rng(5)
    prefill = []
    for i, start in enumerate([1, 33, 3, 35]):
        bt = np.zeros(TP_KW["max_seq_len"] // GEOMETRY["page_size"], int)
        bt[:2] = [start, start + 1]
        prefill.append((rng.integers(3, 500, 12 + i).tolist(), bt.tolist()))
    drafts = [rng.integers(3, 500, (4, DRAFT_K)).tolist() for _ in range(2)]
    return prefill, drafts


def _variants(weights):
    w = weights["f32"]
    eng = dict(kind="engine", cfg=TP_KW, geometry=GEOMETRY, weights=w,
               engine=PREFIX)
    spec_geo = dict(GEOMETRY, speculation_draft_k=4)
    prefill, drafts = _verify_inputs()
    return [
        dict(eng, reqs=REQS, turn2=TURN2),
        dict(eng, reqs=WAVE, turn2=WAVE_T2, preempt=True,
             engine=dict(PREFIX, pipeline={"enabled": True, "depth": 2},
                         mixed={"enabled": True,
                                "prefill_token_budget": 32,
                                "max_slices": 2}),
             geometry=dict(GEOMETRY, mixed_prefill_slices=2,
                           mixed_slice_tokens=32)),
        dict(eng, reqs=REQS, turn2=TURN2, geometry=spec_geo,
             engine=dict(PREFIX, speculation={"enabled": True,
                                              "draft_k": 4})),
        dict(eng, kind="locality", max_decode_steps=64),
        dict(eng, kind="ladder", **LADDER),
        dict(eng, kind="tiering", max_decode_steps=10, pages=TIER_PAGES,
             payload=_payload(weights).hex()),
        dict(kind="verify", cfg=TP_KW, weights=w, prefill=prefill,
             drafts=drafts, geometry=dict(GEOMETRY,
                                          speculation_draft_k=DRAFT_K)),
        dict(kind="verify", cfg=TP_KW, weights=w, prefill=prefill,
             drafts=drafts, geometry=dict(
                 GEOMETRY, speculation_draft_k=DRAFT_K,
                 speculation_device_sampling=False)),
        dict(kind="hbm", cfg=TP_KW, geometry=GEOMETRY, weights=w,
             name="dphbm"),
        dict(eng, kind="indivisible", reqs=REQS[:2],
             geometry=dict(GEOMETRY, batch_size=3, num_pages=65)),
        dict(kind="builder", reqs=[dict(id="x", prompt="hi there",
                                        max_new_tokens=8)],
             executor=_BUILDER),
    ]


#: The builder's executor block (besides the mesh): speculation and the
#: tiered KV plane on.
_BUILDER = dict(max_batch_size=4, kv_pages=32, decode_chunk=2,
                prefill_buckets=[32],
                speculation={"enabled": True, "draft_k": 3},
                kv_tiering={"enabled": True})
VARIANTS = ("engine", "wave", "spec", "locality", "ladder", "tiering",
            "verify_device", "verify_host", "hbm", "indivisible", "builder")

_RUNS = {}


def _port(weights, mesh: str, variant: str):
    """Every rank's result of ``variant`` on ``mesh`` (one spawn a
    mesh)."""
    if mesh not in _RUNS:
        _RUNS[mesh] = _spawn(mesh, MESHES[mesh], _variants(weights),
                             weights["tmp"])
    i = VARIANTS.index(variant)
    return [r[i] for r in _RUNS[mesh]]


# -- references ----------------------------------------------------------------

_REF = {}


def _jax_engine(weights, mesh=None, **kw):
    tok = ByteTokenizer()
    ex = JaxExecutor(weights["cfg"], weights["params"], mesh=mesh,
                     **dict(GEOMETRY, eos_id=tok.eos_id))
    return InferenceEngine(ex, tok, name="dpref", enable_metrics=False,
                           max_decode_steps=kw.get("max_decode_steps", 8),
                           prefix_cache=PrefixCacheConfig(enabled=True))


def _run(eng, reqs):
    hs = [eng.submit(GenRequest(**{**r, **(
        {"priority": Priority(r["priority"])} if "priority" in r else {})}))
          for r in reqs]
    eng.run_until_idle()
    return [{"id": r["id"], "tokens": list(h.result.tokens),
             "text": h.result.text, "finish_reason": h.result.finish_reason,
             "cached_tokens": h.result.cached_tokens}
            for r, h in zip(reqs, hs)]


def _preemption(eng):
    lows = [eng.submit(GenRequest(
        id=f"L{i}", prompt=f"steady background work {i}",
        priority=Priority.LOW, max_new_tokens=12)) for i in range(4)]
    eng.step()
    rts = [eng.submit(GenRequest(
        id=f"R{i}", prompt=f"urgent {i}", priority=Priority.REALTIME,
        max_new_tokens=6)) for i in range(2)]
    eng.run_until_idle()
    return [list(h.result.tokens) for h in lows + rts]


def _ref(weights, what):
    if what in _REF:
        return _REF[what]
    if what in ("one", "mesh"):
        mesh = make_mesh({"dp": 2, "tp": 4}) if what == "mesh" else None
        eng = _jax_engine(weights, mesh)
        out = {"reqs": _run(eng, REQS), "turn2": _run(eng, TURN2)}
        eng.stop()
    elif what == "wave":
        eng = _jax_engine(weights)
        out = {"reqs": _run(eng, WAVE), "turn2": _run(eng, WAVE_T2),
               "preempt": _preemption(eng)}
        eng.stop()
    elif what == "ladder":
        eng = _jax_engine(weights)
        reqs = ([LADDER["fallback"], LADDER["turn1"]] + LADDER["longs"]
                + [LADDER["turn2"]])
        out = {r["id"]: _run(eng, [r])[0] for r in reqs}
        eng.stop()
    _REF[what] = out
    return out


def _port_executor(weights, **kw):
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.models import llama as T

    return TorchExecutor(T.llama3_tiny(dtype=torch.float32, **TP_KW),
                         T.params_from_jax(weights["params"], "cpu"),
                         device="cpu", **dict(GEOMETRY, **kw))


# -- serving -------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_engine_serves_jax_one_device_tokens(weights, mesh):
    """REQS and turn 2 over a dp mesh equal JAX's one-device f32 engine
    token for token (cached tokens too), and JAX's dp2×tp4 engine's where
    that equals its own one device (``test_dp_tp_mesh_also_serves``)."""
    got = _port(weights, mesh, "engine")[0]
    one = _ref(weights, "one")
    assert got["dp_shards"] == 2
    assert got["n_chips"] == sum(1 for _ in _RUNS[mesh])
    assert got["reqs"] == one["reqs"]
    assert got["turn2"] == one["turn2"] and one["turn2"][0][
        "cached_tokens"] > 0
    jmesh = _ref(weights, "mesh")
    if jmesh == one:
        assert got["reqs"] == jmesh["reqs"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_wave_with_pipeline_mixed_and_preemption(weights, mesh):
    """``WAVE`` through pipeline depth 2 and mixed batching, both turn 2s
    and the preemption phase (which really preempts) equal JAX's plain
    one-device engine."""
    got = _port(weights, mesh, "wave")[0]
    want = _ref(weights, "wave")
    assert got["reqs"] == want["reqs"]
    assert got["turn2"] == want["turn2"]
    assert all(t["cached_tokens"] > 0 for t in got["turn2"])
    assert got["preempt"]["preempts"], "no preemption on the mesh"
    assert got["preempt"]["tokens"] == want["preempt"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_speculation_serves_plain_greedy_tokens(weights, mesh):
    """Speculation on over a dp mesh: verify windows ran and the greedy
    streams are JAX's plain one-device engine's."""
    got = _port(weights, mesh, "spec")[0]
    one = _ref(weights, "one")
    assert got["spec_windows"] > 0
    assert [r["tokens"] for r in got["reqs"]] == [
        r["tokens"] for r in one["reqs"]]
    assert got["turn2"][0]["tokens"] == one["turn2"][0]["tokens"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_page_locality(weights, mesh):
    """Every live row's pages lie in its slot's universe; each replica's
    pool holds its rows' pages written, and no page moved."""
    ranks = _port(weights, mesh, "locality")
    got = ranks[0]
    assert got["done"] and len(got["seats"]) == 4
    for rid, shards in got["shards"].items():
        assert shards and set(shards) == {got["want"][rid]}, rid
    one_pages = {p for rid, (slot, pages) in got["seats"].items()
                 for p in pages if got["want"][rid] == 1}
    for r in ranks[1:]:
        assert r["moves"]["pages_in"] == r["moves"]["pages_out"] == 0
        if r["dp_rank"] == 1:
            assert one_pages <= set(r["universe_written"])
    assert got["moves"]["pages_in"] == 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_cross_universe_fallback_and_adoption(weights, mesh):
    """Universe 0 held full: the slot-0 row takes universe 1's pages and
    is served (guests moved in and home); the conversation's turn 2 is
    seated off its pages' universe and adopts them. Every stream equals
    JAX's one-device engine's."""
    got = _port(weights, mesh, "ladder")[0]
    want = _ref(weights, "ladder")
    slot_shards = got["slot_shard"]
    assert slot_shards[0] == 0 and set(got["fallback_shards"]) == {1}
    assert slot_shards[1] == 1 and 0 in set(got["adopted_shards"])
    assert got["moves"]["pages_in"] > 0 and got["moves"]["pages_out"] > 0
    for rid, toks in got["tokens"].items():
        assert toks == want[rid]["tokens"], rid
    assert got["cached"] == want["x2"]["cached_tokens"] > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_guests_go_home_only_where_written(weights, mesh):
    """The fallback row reads its whole prompt as guests every program,
    but only the pages from its position on (what a program can write)
    go home after it: fewer pages out than in."""
    moves = _port(weights, mesh, "ladder")[0]["moves"]
    assert 0 < moves["pages_out"] < moves["pages_in"], moves


@pytest.mark.parametrize("variant", ["wave", "ladder", "spec"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_results_are_taken_or_discarded(weights, mesh, variant):
    """After a variant (pipelined, mixed and preempted; the fallback;
    verify windows) the driver holds no other replica's results but those
    a live handle may still take, and expects none of a dropped handle:
    a replica sends only what the driver takes."""
    box = _port(weights, mesh, variant)[0]["mailbox"]
    assert set(box["box"]) <= set(box["open"]), box
    assert box["gone"] == 0, box


def test_indivisible_dp_degrades_to_one_universe(weights):
    """Batch 3 over 65 pages: dp degrades to replication with JAX's
    warning, the pool is whole, and the engine serves JAX's tokens."""
    got = _port(weights, "dp2tp1", "indivisible")[0]
    assert got["dp_shards"] == 1 and got["pool_pages"] == 65
    assert any("dp degrades to replication" in w for w in got["warning"])
    one = _ref(weights, "one")
    assert [r["tokens"] for r in got["reqs"]] == [
        r["tokens"] for r in one["reqs"][:2]]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_per_rank_hbm_at_dp2(weights, mesh):
    """JAX's ``TestPerChipHbm`` at dp2: each rank's universe is the pool
    over the mesh and they sum to it; weights are the tp shard, alike on
    every rank; every rank states its guest slots apart; one ``hbm_*``
    series a rank."""
    got = _port(weights, mesh, "hbm")[0]
    chips = got["chips"]
    n = len(chips)
    assert [c["chip"] for c in chips] == [str(r) for r in range(n)]
    total_kv, total_w = got["total_kv"], got["total_weights"]
    assert all(c["kv_pool_bytes"] == total_kv // n for c in chips)
    assert sum(c["kv_pool_bytes"] for c in chips) == total_kv
    per_page = total_kv // n // (GEOMETRY["num_pages"] // 2)
    for c in chips:
        assert c["guest_pages"] == GEOMETRY["num_pages"] // 2
        assert c["guest_pool_bytes"] == per_page * (1 + c["guest_pages"])
    w = {c["weights_bytes"] for c in chips}
    assert len(w) == 1
    tp = MESHES[mesh]["tp"]
    assert total_w / tp * 0.9 < w.pop() < total_w / tp * 1.2
    for series in got["series"].values():
        assert len(series) == n


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_tiering_round_trip(weights, mesh):
    """Demote and promote through the host tier give the resident pin's
    tokens (a host hit, cached tokens); a payload imported into pages of
    both universes and exported back through the mesh is bitwise itself,
    in the one-device port's page format (JAX's)."""
    got = _port(weights, mesh, "tiering")[0]
    base, tiered = got["runs"]
    assert tiered["hits"]["host"] == 1
    assert tiered["cached"] > 0
    assert (base["t1"], base["t2"]) == (tiered["t1"], tiered["t2"])
    one = _port_executor(weights)
    assert [(tuple(s), d) for s, d in got["spec"]] == one.kv_page_spec()
    assert got["export"] == _payload(weights).hex()


@pytest.mark.parametrize("accept", ["device", "host"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_verify_windows_equal_one_device(weights, mesh, accept):
    """Two verify windows over rows of both universes commit the
    one-device executor's tokens and ``n_commit``, with device and host
    accept."""
    got = _port(weights, mesh, f"verify_{accept}")[0]
    ex = _port_executor(weights, speculation_draft_k=DRAFT_K,
                        speculation_device_sampling=accept == "device")
    prefill, drafts = _verify_inputs()
    hs = ex.prefill_multi_async([(t, 0, np.asarray(bt, np.int32), 0.0)
                                 for t, bt in prefill])
    first = [int(x) for x in ex.gather_scalars(hs)]
    assert got["first"] == first
    B = GEOMETRY["batch_size"]
    tok = np.array(first, np.int32)
    pos = np.array([len(t) for t, _bt in prefill], np.int32)
    bts = np.array([bt for _t, bt in prefill], np.int32)
    for window, d in zip(got["windows"], drafts):
        d = np.asarray(d, np.int32)
        toks, nc = ex.verify_chunk(tok, pos, bts, np.zeros(B, np.float32),
                                   d, np.full(B, d.shape[1] + 1, np.int32))
        assert window["out"] == toks.tolist()
        assert window["n_commit"] == nc.tolist()
        for i in range(B):
            tok[i] = toks[i, nc[i] - 1]
            pos[i] += nc[i]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_builder_serves_dp_with_speculation_and_tiering(weights, mesh):
    """``build_engine`` over ``executor.mesh`` at dp2 with speculation and
    the tiered KV plane on serves the one-device builder engine's
    tokens."""
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.engine.builder import build_engine
    from llmq_tpu_torch.engine.engine import GenRequest as TReq

    got = _port(weights, mesh, "builder")[0]
    assert got["dp_shards"] == 2 and got["draft_k"] == 3 and got["tiering"]
    cfg = Config()
    cfg.device = "cpu"
    cfg.model.name = "llama3-tiny"
    cfg.model.max_seq_len = 128
    for k, v in _BUILDER.items():
        if not isinstance(v, dict):
            setattr(cfg.executor, k, v)
    eng = build_engine(cfg, model_dtype=torch.float32)
    h = eng.submit(TReq(id="x", prompt="hi there", max_new_tokens=8))
    eng.run_until_idle()
    eng.stop()
    assert got["reqs"][0]["tokens"] == list(h.result.tokens)
