"""The port's parallel layer on the host, against the JAX package's:
the rank mesh (``make_mesh`` shapes, ``-1`` inference, bad shapes), the
partition-rule table (leaf for leaf equal to JAX's ``PartitionSpec`` from
``param_shardings`` for the tp test config, llama3-8b and llama3-70b,
bf16 and quantized, over ``{"tp": 8}`` and ``{"dp": 2, "tp": 4}``; JAX's
side by ``jax.eval_shape``, nothing materialised), the pool's placements,
each rank's shard against JAX's device shards, and the one deliberate
deviation: the attention block is sharded in whole heads or replicated.
Then the dp page universes on the host (allocator scripts and the
engine's cross-universe fallback through the echo executor, each against
JAX's), the mesh config, the builder's mesh branch on one rank, and the
refusals. Tolerance: none (placements and page ids are exact)."""

import logging

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from llmq_tpu.core.config import MeshConfig as JMeshConfig  # noqa: E402
from llmq_tpu.engine.kv_allocator import PageAllocator as JAlloc  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from llmq_tpu.parallel import single_device_mesh as jsingle  # noqa: E402
from llmq_tpu.parallel.sharding import (  # noqa: E402
    kv_cache_shardings as jkv_shardings)
from llmq_tpu.parallel.sharding import (  # noqa: E402
    param_shardings as jparam_shardings)
from llmq_tpu.parallel.sharding import shard_params as jshard  # noqa: E402

from llmq_tpu_torch.core.config import Config, MeshConfig  # noqa: E402
from llmq_tpu_torch.engine.kv_allocator import PageAllocator  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.parallel import (  # noqa: E402
    LLAMA_PARTITION_RULES, P, abstract_params, describe,
    kv_cache_shardings, make_mesh, match_partition_rules, param_shardings,
    resolve_rules, shard_params, single_device_mesh)
from llmq_tpu_torch.parallel.mesh import Mesh  # noqa: E402

torch.set_num_threads(1)

#: tests/test_engine_tp.py's ``tp_cfg``: heads, KV heads, ffn and vocab
#: all divisible by 8.
TP_KW = dict(dim=256, n_heads=8, n_kv_heads=8, ffn_dim=512, vocab_size=512,
             max_seq_len=256)

CONFIGS = {
    "tp_cfg": (lambda: J.llama3_tiny(**TP_KW), lambda: T.llama3_tiny(**TP_KW)),
    "llama3-8b": (lambda: J.get_config("llama3-8b"),
                  lambda: T.get_config("llama3-8b")),
    "llama3-70b": (lambda: J.get_config("llama3-70b"),
                   lambda: T.get_config("llama3-70b")),
}
MESHES = [{"tp": 8}, {"dp": 2, "tp": 4}]


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def _jax_specs(cfg, mesh, quantized):
    return {k: tuple(v.spec) for k, v in
            _flat(jparam_shardings(cfg, mesh, quantized=quantized)).items()}


# -- the mesh ------------------------------------------------------------------


class TestMesh:
    def test_make_mesh_shapes(self):
        shape = {"dp": 2, "tp": 4}
        assert make_mesh(shape, ranks=range(8)).shape == dict(
            jmake_mesh(shape).shape)

    def test_infer_axis(self):
        shape = {"dp": 2, "tp": -1}
        assert make_mesh(shape, ranks=range(8)).shape == dict(
            jmake_mesh(shape).shape) == {"dp": 2, "tp": 4}

    @pytest.mark.parametrize("shape", [{"dp": 3, "tp": 3}, {"dp": -1, "tp": -1},
                                       {"dp": 3, "tp": -1}, {"tp": 16}])
    def test_bad_shape_raises(self, shape):
        with pytest.raises(ValueError):
            jmake_mesh(shape)
        with pytest.raises(ValueError):
            make_mesh(shape, ranks=range(8))

    def test_single_device_mesh(self):
        assert single_device_mesh().shape == dict(jsingle().shape) == {
            "dp": 1, "tp": 1}

    def test_rank_coordinates_follow_jax_device_order(self):
        """Rank r sits where JAX's mesh puts device r (row-major)."""
        jm = jmake_mesh({"dp": 2, "tp": 4})
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(8):
            c = Mesh({"dp": 2, "tp": 4}, rank=r).coords
            assert ids[c["dp"], c["tp"]] == r

    def test_one_rank_without_a_world_has_no_group(self):
        m = make_mesh({"tp": 1})
        assert (m.size, m.rank, m.group, m.control) == (1, 0, None, None)


# -- the partition rules -------------------------------------------------------


class TestPartitionRules:
    @pytest.mark.parametrize("mesh_shape", MESHES, ids=["tp8", "dp2tp4"])
    @pytest.mark.parametrize("quantized", [False, True],
                             ids=["bf16", "int8"])
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_placements_equal_jax_leaf_for_leaf(self, name, quantized,
                                                mesh_shape):
        jcfg, tcfg = (f() for f in CONFIGS[name])
        want = _jax_specs(jcfg, jmake_mesh(mesh_shape), quantized)
        got = _flat(param_shardings(tcfg, make_mesh(mesh_shape,
                                                    ranks=range(8)),
                                    quantized=quantized))
        assert set(got) == set(want)
        for leaf, spec in want.items():
            assert tuple(got[leaf]) == spec, leaf

    @pytest.mark.parametrize("quantized", [False, True])
    def test_abstract_tree_matches_jax_eval_shape(self, quantized):
        """The meta tree the rules resolve over has JAX's leaves, shapes
        and dtypes (JAX's ``jax.eval_shape`` of its initializer)."""
        init = J.init_params_quantized if quantized else J.init_params
        cfg = J.get_config("llama3-8b")
        want = _flat(jax.eval_shape(lambda: init(jax.random.PRNGKey(0),
                                                 cfg)))
        got = _flat(abstract_params(T.get_config("llama3-8b"), quantized))
        assert set(got) == set(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), k
            assert got[k].device.type == "meta"

    def test_whole_head_deviation_on_llama3_tiny(self):
        """The kept deviation: llama3-tiny (4 heads, 2 KV heads) at tp=8.
        JAX splits ``wq``'s 128 flat columns 8 ways (half heads) and
        replicates the pool; GSPMD reshards around it. A port rank runs
        its own kernels on whole heads, so the attention block and the
        pool replicate; every other leaf keeps JAX's placement."""
        jm, tm = jmake_mesh({"tp": 8}), make_mesh({"tp": 8}, ranks=range(8))
        want = _jax_specs(J.llama3_tiny(), jm, False)
        got = _flat(param_shardings(T.llama3_tiny(), tm))
        attn = {f"layers/{n}" for n in ("wq", "wk", "wv", "wo")}
        assert want["layers/wq"] == (None, None, "tp")
        for leaf, spec in want.items():
            if leaf in attn:
                assert tuple(got[leaf]) == (None,) * len(spec), leaf
            else:
                assert tuple(got[leaf]) == spec, leaf
        assert tuple(kv_cache_shardings(T.llama3_tiny(), tm)["k"]) == tuple(
            jkv_shardings(J.llama3_tiny(), jm)["k"].spec) == (None,) * 4
        # At tp=2 the heads split whole: no deviation.
        j2, t2 = jmake_mesh({"tp": 2}, jax.devices()[:2]), make_mesh(
            {"tp": 2}, ranks=range(2))
        want2 = _jax_specs(J.llama3_tiny(), j2, False)
        got2 = _flat(param_shardings(T.llama3_tiny(), t2))
        assert {k: tuple(v) for k, v in got2.items()} == want2

    def test_indivisible_ffn_clamps_to_replication(self):
        jm, tm = jmake_mesh({"tp": 8}), make_mesh({"tp": 8}, ranks=range(8))
        want = _jax_specs(J.llama3_tiny(ffn_dim=84, **{
            k: TP_KW[k] for k in ("dim", "n_heads", "n_kv_heads")}), jm,
            False)
        got = _flat(param_shardings(T.llama3_tiny(ffn_dim=84, **{
            k: TP_KW[k] for k in ("dim", "n_heads", "n_kv_heads")}), tm))
        assert tuple(got["layers/w_gate"]) == want["layers/w_gate"] == (
            None, None, None)
        assert tuple(got["layers/w_down"]) == want["layers/w_down"]
        assert tuple(got["layers/wq"]) == want["layers/wq"] == (
            None, None, "tp")

    @pytest.mark.parametrize("num_pages", [0, 64, 65])
    @pytest.mark.parametrize("quantized", [False, True])
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_kv_cache_shardings_equal_jax(self, name, quantized, num_pages):
        jcfg, tcfg = (f() for f in CONFIGS[name])
        shape = {"dp": 2, "tp": 4}
        want = jkv_shardings(jcfg, jmake_mesh(shape), quantized=quantized,
                             num_pages=num_pages)
        got = kv_cache_shardings(tcfg, make_mesh(shape, ranks=range(8)),
                                 quantized=quantized, num_pages=num_pages)
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k]) == tuple(want[k].spec), k

    def test_unmatched_param_raises(self):
        with pytest.raises(ValueError, match="no partition rule"):
            match_partition_rules([(r"^only_this$", P())],
                                  {"mystery": torch.zeros(4, 4)})

    def test_rules_table_is_jaxs(self):
        from llmq_tpu.parallel.sharding import LLAMA_PARTITION_RULES as JR

        assert [(pat, tuple(spec)) for pat, spec in LLAMA_PARTITION_RULES] \
            == [(pat, tuple(spec)) for pat, spec in JR]

    def test_resolve_rules_generic_tree(self):
        mesh = make_mesh({"dp": 2, "tp": 4}, ranks=range(8))
        tree = {"a": torch.zeros(8, 16), "scalar": torch.zeros(())}
        out = resolve_rules([(r".", P("tp", None))], tree, mesh)
        assert tuple(out["a"]) == ("tp", None)
        assert tuple(out["scalar"]) == ()

    @pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
    def test_rank_shards_equal_jax_device_shards(self, quantized):
        """Each rank's local tree is JAX's shard on the device at the same
        mesh coordinates, byte for byte (int8 leaves and scales too)."""
        from llmq_tpu.ops.quant import quantize_params as jquant

        cfg = J.llama3_tiny(dtype=jnp.float32, **TP_KW)
        params = J.init_params(jax.random.PRNGKey(0), cfg)
        if quantized:
            params = jquant(params)
        jm = jmake_mesh({"tp": 8})
        placed = jshard(params, jparam_shardings(cfg, jm,
                                                 quantized=quantized,
                                                 params=params))
        tcfg = T.llama3_tiny(dtype=torch.float32, **TP_KW)
        tparams = T.params_from_jax(params, "cpu")
        sh = param_shardings(tcfg, make_mesh({"tp": 8}, ranks=range(8)),
                             quantized=quantized, params=tparams)
        jflat = _flat(placed)
        for r in (0, 3, 7):
            local = _flat(shard_params(tparams, sh, Mesh({"tp": 8}, rank=r)))
            for leaf, arr in jflat.items():
                shard = next(s for s in arr.addressable_shards
                             if s.device.id == r)
                assert np.array_equal(np.asarray(shard.data),
                                      local[leaf].numpy()), (r, leaf)

    def test_int8_shard_keeps_column_major_layout(self):
        from llmq_tpu_torch.ops.quant import quantize_params

        cfg = T.llama3_tiny(dtype=torch.float32, **TP_KW)
        gen = torch.Generator().manual_seed(0)
        params = quantize_params(T.init_params(cfg, gen, "cpu"))
        mesh = Mesh({"tp": 4}, rank=1)
        local = shard_params(params, param_shardings(
            cfg, mesh, quantized=True, params=params), mesh)
        for name in ("wq", "wo", "w_up", "w_down"):
            q = local["layers"][name]["q"]
            assert q.stride(-2) == 1, name

    def test_describe_names_every_leaf(self):
        cfg = T.llama3_tiny(**TP_KW)
        mesh = make_mesh({"tp": 8}, ranks=range(8))
        params = abstract_params(cfg)
        d = describe(params, param_shardings(cfg, mesh))
        assert set(d) == set(_flat(params))
        assert "'tp'" in d["layers/wq"]


# -- dp page universes on the host ---------------------------------------------


def _alloc_script(seed: int, dp: int, n_pages: int = 64, steps: int = 300):
    """A seeded script of allocs (pinned to a universe or not) and frees,
    run on both allocators; every result and every free count."""
    rng = np.random.default_rng(seed)
    outs = []
    for cls in (JAlloc, PageAllocator):
        al = cls(n_pages, 16, dp_shards=dp)
        held, log_ = [], []
        r = np.random.default_rng(seed)
        for _ in range(steps):
            if held and r.random() < 0.4:
                pages = held.pop(int(r.integers(len(held))))
                al.free(pages)
                log_.append(("free", list(pages)))
            else:
                n = int(r.integers(1, 6))
                shard = (None if r.random() < 0.3
                         else int(r.integers(dp)))
                got = al.alloc(n, shard=shard)
                if got is not None:
                    held.append(got)
                log_.append(("alloc", n, shard, got))
            log_.append(("avail", al.available_by_shard(), al.available(),
                         al.fragmentation()))
        outs.append(log_)
    del rng
    return outs


class TestDpUniverses:
    @pytest.mark.parametrize("dp", [1, 2, 4])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_alloc_free_sequences_equal_jax(self, dp, seed):
        want, got = _alloc_script(seed, dp)
        assert got == want

    def test_dp1_is_byte_identical_to_one_free_list(self):
        """``dp_shards=1`` hands out exactly the single LIFO list's
        sequence (the allocator before universes: pages P-1..1 popped from
        the end, freed pages reused first)."""
        al = PageAllocator(16, 16, dp_shards=1)
        free = list(range(15, 0, -1))
        for n in (3, 4, 2):
            assert al.alloc(n) == [free.pop() for _ in range(n)]
        al.free([2, 1])
        free += [2, 1]
        assert al.alloc(3) == [free.pop() for _ in range(3)]
        assert al.available() == len(free) == al.available_by_shard()[0]

    def test_universe_ranges(self):
        for cls in (JAlloc, PageAllocator):
            al = cls(64, 16, dp_shards=2)
            a, b = al.alloc(3, shard=0), al.alloc(3, shard=1)
            assert all(1 <= p < 32 for p in a)
            assert all(32 <= p < 64 for p in b)
            assert [al.shard_of(p) for p in a + b] == [0, 0, 0, 1, 1, 1]

    def test_page0_reserved_only_in_shard0(self):
        al = PageAllocator(8, 16, dp_shards=2)
        assert (al.available(shard=0), al.available(shard=1),
                al.available(), al.total) == (3, 4, 7, 7)

    def test_all_or_nothing_per_universe(self):
        al = PageAllocator(8, 16, dp_shards=2)
        assert al.alloc(4, shard=1) is not None
        assert al.alloc(1, shard=1) is None
        assert al.alloc(1, shard=0) is not None

    def test_free_returns_to_owning_universe(self):
        al = PageAllocator(16, 16, dp_shards=2)
        pages = al.alloc(8, shard=1)
        al.free(pages)
        assert al.available_by_shard() == [7, 8]

    def test_freed_window_page_returns_to_its_dp_universe(self):
        alloc = PageAllocator(32, 8, dp_shards=2)
        before = alloc.available_by_shard()
        window = alloc.alloc(3, shard=1)
        assert window and all(alloc.shard_of(p) == 1 for p in window)
        alloc.free(window)
        assert alloc.available_by_shard() == before

    @pytest.mark.parametrize("args,match", [((65, 16, 2), "dp shards"),
                                            ((1, 16, 1), "at least 2")])
    def test_bad_geometry_raises_like_jax(self, args, match):
        for cls in (JAlloc, PageAllocator):
            with pytest.raises(ValueError, match=match):
                cls(*args[:2], dp_shards=args[2])

    def test_bad_shard_raises(self):
        al = PageAllocator(16, 16, dp_shards=2)
        with pytest.raises(ValueError, match="bad dp shard"):
            al.alloc(1, shard=2)


def _echo_engine(pkg: str, dp: int, name: str):
    if pkg == "jax":
        from llmq_tpu.engine.engine import InferenceEngine
        from llmq_tpu.engine.executor import EchoExecutor
        from llmq_tpu.engine.tokenizer import ByteTokenizer
    else:
        from llmq_tpu_torch.engine.engine import InferenceEngine
        from llmq_tpu_torch.engine.executor import EchoExecutor
        from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    ex = EchoExecutor(batch_size=4, page_size=8, num_pages=32,
                      max_pages_per_seq=8, eos_id=tok.eos_id)
    ex.dp_shards = dp
    eng = InferenceEngine(ex, tok, enable_metrics=False, name=name,
                          max_decode_steps=12)
    calls = []
    alloc = eng.allocator.alloc

    def recording(n, shard=None):
        got = alloc(n, shard=shard)
        calls.append((n, shard, got))
        return got

    eng.allocator.alloc = recording
    return eng, calls


class TestDpEngine:
    def test_cross_universe_fallback_beats_shedding(self):
        """JAX's ladder pin: a full universe with room elsewhere takes the
        other universe's pages before any pinned KV is shed, in both
        packages, with the same pages."""
        got = {}
        for pkg in ("jax", "torch"):
            if pkg == "jax":
                from llmq_tpu.engine.engine import (GenHandle, GenRequest,
                                                    _ConvKV, _Sequence)
            else:
                from llmq_tpu_torch.engine.engine import (GenHandle,
                                                          GenRequest,
                                                          _ConvKV,
                                                          _Sequence)
            eng, _calls = _echo_engine(pkg, 2, f"ladder-{pkg}")
            assert eng.allocator.dp_shards == 2
            pin = eng.allocator.alloc(2, shard=1)
            bt = np.zeros(eng.spec.max_pages_per_seq, np.int32)
            bt[:2] = pin
            eng._conv_cache["pinme"] = _ConvKV(
                pages=pin, block_table=bt, length=8, last_used=0.0,
                tokens=list(range(8)))
            eng.allocator.pin("pinme", pin)
            assert eng.allocator.alloc(eng.allocator.available(shard=0),
                                       shard=0) is not None
            req = GenRequest(id="x", prompt="hi")
            seq = _Sequence(req, GenHandle(req), 0,
                            eng.spec.max_pages_per_seq)
            pages = eng._alloc_pages(2, seq, shard=0)
            assert pages is not None
            assert all(eng.allocator.shard_of(p) == 1 for p in pages)
            assert "pinme" in eng._conv_cache
            got[pkg] = pages
            eng.stop()
        assert got["torch"] == got["jax"]

    @pytest.mark.parametrize("dp", [1, 2])
    def test_workload_alloc_sequence_equals_jax(self, dp):
        """More requests than slots, two two-turn conversations: every
        allocation the engine makes (size, universe asked, pages given)
        and every stream equal JAX's engine's over the echo executor."""
        from llmq_tpu.engine.engine import GenRequest as JReq

        from llmq_tpu_torch.engine.engine import GenRequest as TReq

        reqs = [dict(id=f"r{i}", prompt=p, conversation_id=c)
                for i, (p, c) in enumerate([
                    ("hello universe one", "c1"), ("second", None),
                    ("a longer prompt that takes a few pages here", "c2"),
                    ("four", None), ("five five", None), ("six", None)])]
        turn2 = [dict(id="t2a", prompt=" and more", conversation_id="c1"),
                 dict(id="t2b", prompt=" again", conversation_id="c2")]
        out = {}
        for pkg, Req in (("jax", JReq), ("torch", TReq)):
            eng, calls = _echo_engine(pkg, dp, f"dp-{pkg}-{dp}")
            streams = []
            for wave in (reqs, turn2):
                hs = [eng.submit(Req(**r)) for r in wave]
                eng.run_until_idle()
                streams += [(h.result.tokens, h.result.cached_tokens)
                            for h in hs]
            out[pkg] = (calls, streams, eng.allocator.available_by_shard())
            eng.stop()
        assert out["torch"] == out["jax"]
        if dp == 2:
            assert {s for _n, s, _g in out["torch"][0]} >= {0, 1}


# -- config, builder and refusals ----------------------------------------------


class TestMeshConfig:
    def test_defaults_equal_jax(self):
        from llmq_tpu.core.config import default_config

        j = default_config()
        t = Config()
        assert (t.executor.mesh.enabled, t.executor.mesh.shape,
                t.tpu.mesh_shape) == (j.executor.mesh.enabled,
                                      j.executor.mesh.shape,
                                      j.tpu.mesh_shape) == (False, {}, {})

    @pytest.mark.parametrize("kw,match", [
        (dict(shape={"zz": 2}), "dp' or 'tp"),
        (dict(shape={"dp": 0}), "positive int"),
        (dict(enabled=True), "requires a shape")])
    def test_validation_equals_jax(self, kw, match):
        with pytest.raises(ValueError, match=match):
            JMeshConfig(**kw)
        with pytest.raises(ValueError, match=match):
            MeshConfig(**kw)
        MeshConfig(enabled=True, shape={"dp": 2, "tp": -1})

    @pytest.mark.parametrize("snippet", [
        "executor: {mesh: {enabled: true, shape: {dp: 1, tp: 2}}}\n",
        "tpu: {mesh_shape: {tp: 8}}\n"])
    def test_file_loads_like_jax(self, tmp_path, snippet):
        from llmq_tpu.core.config import load_config as jload

        from llmq_tpu_torch.core.config import load_config

        path = tmp_path / "c.yaml"
        path.write_text(snippet)
        j, t = jload(str(path), env=False), load_config(str(path), env=False)
        assert (t.executor.mesh.enabled, t.executor.mesh.shape,
                t.tpu.mesh_shape) == (j.executor.mesh.enabled,
                                      j.executor.mesh.shape,
                                      j.tpu.mesh_shape)

    def test_env_overrides(self):
        from llmq_tpu_torch.core.config import apply_env

        cfg = Config()
        apply_env(cfg, {"LLMQ_EXECUTOR_MESH_ENABLED": "true",
                        "LLMQ_EXECUTOR_MESH_SHAPE": "{tp: 2}",
                        "LLMQ_TPU_MESH_SHAPE": "{tp: 1}"})
        assert (cfg.executor.mesh.enabled, cfg.executor.mesh.shape,
                cfg.tpu.mesh_shape) == (True, {"tp": 2}, {"tp": 1})

    @pytest.mark.parametrize("key", ["platform", "compilation_cache_dir"])
    def test_xla_keys_stay_unported(self, tmp_path, key):
        from llmq_tpu_torch.core.config import _UNPORTED, load_config

        assert "mesh" not in _UNPORTED.get("executor", {})
        assert "mesh_shape" not in _UNPORTED["tpu"]
        path = tmp_path / "c.yaml"
        path.write_text(f"tpu: {{{key}: /x}}\n")
        with pytest.raises(ValueError, match=f"tpu.{key}"):
            load_config(str(path), env=False)


def _tiny_cfg(**executor):
    cfg = Config()
    cfg.device = "cpu"
    cfg.model.name = "llama3-tiny"
    cfg.model.max_seq_len = 128
    cfg.executor.max_batch_size = 2
    cfg.executor.kv_pages = 33
    cfg.executor.decode_chunk = 2
    cfg.executor.prefill_buckets = [32]
    for k, v in executor.items():
        setattr(cfg.executor, k, v)
    return cfg


def _serve_one(engine):
    from llmq_tpu_torch.engine.engine import GenRequest

    h = engine.submit(GenRequest(id="x", prompt="hi", max_new_tokens=6))
    engine.run_until_idle()
    return h.result


class TestBuilderMesh:
    @pytest.mark.parametrize("how", ["executor_mesh", "legacy_tpu_mesh_shape"])
    def test_builder_mesh_shape_wiring(self, how):
        """Both knobs build a meshed engine (one rank, no world: the tp=1
        mesh without collectives), serving what the unmeshed one does."""
        from llmq_tpu_torch.engine.builder import build_engine

        cfg = _tiny_cfg()
        if how == "executor_mesh":
            cfg.executor.mesh.enabled = True
            cfg.executor.mesh.shape = {"tp": 1}
        else:
            cfg.tpu.mesh_shape = {"tp": 1}
        eng = build_engine(cfg, model_dtype=torch.float32)
        plain = build_engine(_tiny_cfg(), model_dtype=torch.float32)
        assert eng.executor.mesh is not None
        assert eng.executor.mesh.shape == {"tp": 1}
        assert plain.executor.mesh is None
        assert eng.executor.dp_shards == eng.allocator.dp_shards == 1
        assert eng.executor.telemetry_info()["n_chips"] == 1
        a, b = _serve_one(eng), _serve_one(plain)
        assert a.finish_reason in ("eos", "length")
        assert a.tokens == b.tokens
        eng.stop()
        plain.stop()

    def test_executor_mesh_block_wins_over_legacy(self):
        from llmq_tpu_torch.engine.builder import mesh_shape

        cfg = _tiny_cfg()
        cfg.tpu.mesh_shape = {"tp": 8}
        assert mesh_shape(cfg) == {"tp": 8}
        cfg.executor.mesh.enabled = True
        cfg.executor.mesh.shape = {"tp": 1}
        assert mesh_shape(cfg) == {"tp": 1}
        cfg.executor.backend = "echo"
        assert mesh_shape(cfg) is None

    def test_ragged_attention_turned_off_with_jaxs_warning(self, caplog):
        from llmq_tpu_torch.engine.builder import build_engine

        cfg = _tiny_cfg()
        cfg.executor.ragged_attention.enabled = True
        cfg.executor.mesh.enabled = True
        cfg.executor.mesh.shape = {"tp": 1}
        with caplog.at_level(logging.WARNING):
            eng = build_engine(cfg, model_dtype=torch.float32)
        assert not eng.executor.ragged_attention
        assert any("ragged_attention requested but mesh sharding is "
                   "configured" in r.getMessage() for r in caplog.records)
        eng.stop()

    @pytest.mark.parametrize("plane", ["speculation", "kv_tiering"])
    def test_builder_mesh_serves_with_the_plane_on(self, plane):
        """Speculation and the tiered KV plane build and serve on a mesh
        (one rank, no world), as without it."""
        from llmq_tpu_torch.engine.builder import build_engine

        cfg = _tiny_cfg()
        cfg.executor.mesh.enabled = True
        cfg.executor.mesh.shape = {"tp": 1}
        getattr(cfg.executor, plane).enabled = True
        eng = build_engine(cfg, model_dtype=torch.float32)
        plain = build_engine(_tiny_cfg(), model_dtype=torch.float32)
        if plane == "speculation":
            assert eng.executor.verify_draft_k == cfg.executor.speculation.\
                draft_k
        else:
            assert eng._tiering is not None
            assert eng.executor.kv_page_spec() == \
                plain.executor.kv_page_spec()
        assert _serve_one(eng).tokens == _serve_one(plain).tokens
        eng.stop()
        plain.stop()


def _tiny_params():
    cfg = T.llama3_tiny(dtype=torch.float32, **TP_KW)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


class TestExecutorRefusals:
    def test_a_mesh_of_several_ranks_needs_its_world(self):
        """A dp mesh described without a joined world has no groups to
        serve over: refused with the remedy."""
        from llmq_tpu_torch.engine.executor import TorchExecutor

        cfg, params = _tiny_params()
        with pytest.raises(ValueError, match="needs its world"):
            TorchExecutor(cfg, params, device="cpu",
                          mesh=Mesh({"dp": 2, "tp": 1}))

    @pytest.mark.parametrize("backend,group,shape,match", [
        ("gloo", object(), {"tp": 2}, "must be NCCL"),
        ("", None, {"tp": 1}, "needs its NCCL process group")])
    def test_cuda_executor_needs_an_nccl_group(self, monkeypatch, backend,
                                               group, shape, match):
        """The check runs before anything touches the card, so the CPU
        can hold it: a CUDA executor whose tp group (tp > 1) is gloo, or
        with no group at all, raises (no quiet fall to eager or to one
        device)."""
        from llmq_tpu_torch.engine import executor as E

        monkeypatch.setattr(E, "resolve_device",
                            lambda d: torch.device("cuda"))
        cfg, params = _tiny_params()
        mesh = Mesh(shape, group=group, backend=backend)
        with pytest.raises(ValueError, match=match):
            E.TorchExecutor(cfg, params, device="cuda", mesh=mesh)

    def test_cuda_dp_mesh_on_a_gloo_world_is_accepted(self, monkeypatch):
        """``{dp: 2}`` on a gloo world: tp is 1, so no collective is
        captured and gloo (which lets two ranks share one card) passes
        the checks; the executor gets past them to its device work."""
        from llmq_tpu_torch.engine import executor as E

        monkeypatch.setattr(E, "resolve_device",
                            lambda d: torch.device("cuda"))
        cfg, params = _tiny_params()
        mesh = Mesh({"dp": 2}, group=object(), control=object(),
                    backend="gloo")
        reached = []

        def shard(*a, **kw):
            reached.append(True)
            raise RuntimeError("past the checks")
        from llmq_tpu_torch.parallel import sharding

        monkeypatch.setattr(sharding, "shard_params", shard)
        with pytest.raises(RuntimeError, match="past the checks"):
            E.TorchExecutor(cfg, params, device="cuda", mesh=mesh)
        assert reached

    def test_tiering_transport_on_a_mesh_of_one_is_the_pool(self):
        """A mesh of one rank exports and imports through its own pool,
        in the one-device format, byte for byte."""
        from llmq_tpu_torch.engine.executor import TorchExecutor

        cfg, params = _tiny_params()
        ex = TorchExecutor(cfg, params, device="cpu", mesh=Mesh({"tp": 1}),
                           batch_size=2, num_pages=9, prefill_buckets=[16])
        one = TorchExecutor(cfg, params, device="cpu", batch_size=2,
                            num_pages=9, prefill_buckets=[16])
        assert ex.kv_page_spec() == one.kv_page_spec()
        gen = torch.Generator().manual_seed(3)
        for pool in ex.cache.values():
            pool.copy_(torch.randn(pool.shape, generator=gen))
        out = ex.export_kv_pages([1, 4])
        ex.import_kv_pages([6, 7], [t.clone() for t in out])
        for name, pool in ex.cache.items():
            assert torch.equal(pool[:, [6, 7]], pool[:, [1, 4]]), name

    def test_follow_only_on_a_follower(self):
        from llmq_tpu_torch.engine.executor import TorchExecutor

        cfg, params = _tiny_params()
        ex = TorchExecutor(cfg, params, device="cpu", mesh=Mesh({"tp": 1}),
                           batch_size=2, num_pages=9, prefill_buckets=[16])
        with pytest.raises(RuntimeError, match="rank other than 0"):
            ex.follow()
        ex.release_mesh()      # one rank: nothing to stop

    def test_no_mesh_executor_is_unchanged(self):
        """Without a mesh nothing is sharded, no relay exists, and the
        pool holds every KV head."""
        from llmq_tpu_torch.engine.executor import TorchExecutor

        cfg, params = _tiny_params()
        ex = TorchExecutor(cfg, params, device="cpu", batch_size=2,
                           num_pages=9, prefill_buckets=[16])
        assert ex.mesh is None and ex._relay is None
        assert ex.model.tp is None
        assert ex.cache["k"].shape[-1] == cfg.n_kv_heads * cfg.head_dim
        assert [e["chip"] for e in ex.hbm_info()] == ["0"]


def test_jax_named_sharding_type_is_what_the_rules_compare():
    """The comparisons above read ``NamedSharding.spec``: the JAX side of
    every placement test is a real sharding."""
    sh = jparam_shardings(J.llama3_tiny(**TP_KW), jmake_mesh({"tp": 8}))
    assert isinstance(sh["layers"]["wq"], NamedSharding)
