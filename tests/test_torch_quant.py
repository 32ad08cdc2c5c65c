"""The port's int8 quantization (``llmq_tpu_torch/ops/quant.py``) against
the JAX package's (``llmq_tpu/ops/quant.py``), on the same numpy inputs.

int8 tensors and scales compare bit-exact (the same order of f32
operations and round-half-to-even on both sides); ``qdot`` and
``tied_head_logits`` within 1e-5 relative at f32 (the int32 products are
exact, the scale multiplies may round differently). Also the parameter
tree transform, the leaf-by-leaf quantized init, and the two config
switches with their validation.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.ops import quant as jq  # noqa: E402

from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.ops import quant as tq  # noqa: E402

# The suite runs in several xdist workers on shared cores: one intra-op
# thread per worker avoids oversubscribing them.
torch.set_num_threads(1)
KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _same(t, j):
    np.testing.assert_array_equal(_np(t), _np(j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_weight_matches_jax(dtype, axis):
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((3, 64, 40)), getattr(jnp, dtype))
    j = jq.quantize_weight(w, axis=axis)
    t = tq.quantize_weight(_t(w), axis=axis)
    assert t["q"].dtype == torch.int8 and t["s"].dtype == torch.float32
    assert tuple(t["s"].shape) == j["s"].shape
    _same(t["q"], j["q"])
    _same(t["s"], j["s"])
    _same(tq.dequantize_weight(t), jq.dequantize_weight(j))


def test_quantize_act_matches_jax_including_zero_rows():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 7, 64)).astype(np.float32) * 3
    x[2, 3] = 0.0                              # amax 0 → the 1e-8 floor
    jx, js = jq.quantize_act(jnp.asarray(x))
    tx, ts = tq.quantize_act(_t(x))
    _same(tx, jx)
    _same(ts, js)


@pytest.mark.parametrize("shape", [(1, 64), (8, 64), (3, 9, 64)])
def test_qdot_linear_and_layer_slice_match_jax(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((2, 64, 48)).astype(np.float32)
    jw, tw = jq.quantize_weight(jnp.asarray(w)), tq.quantize_weight(_t(w))
    for layer in range(2):
        j = jq.linear(jnp.asarray(x), jq.layer_slice(jw, layer))
        t = tq.linear(_t(x), tq.layer_slice(tw, layer))
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-6)
    # An unquantized leaf is a plain matmul / index in both.
    np.testing.assert_allclose(
        _np(tq.linear(_t(x), tq.layer_slice(_t(w), 1))),
        _np(jq.linear(jnp.asarray(x), jq.layer_slice(jnp.asarray(w), 1))),
        rtol=1e-5, atol=1e-5)


def test_linears_share_one_activation_quantization():
    """``linears`` (one activation quantization for several weights on
    one input, as the q/k/v and gate/up projections use it) gives each
    weight's ``linear`` bit for bit, quantized and bf16 leaves alike, and
    JAX's separate ``linear`` calls within 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    ws = [rng.standard_normal((64, n)).astype(np.float32) for n in (48, 16)]
    tws = [tq.quantize_weight(_t(w)) for w in ws] + [_t(ws[0])]
    outs = tq.linears(_t(x), *tws)
    assert len(outs) == 3
    for out, w in zip(outs, tws):
        assert torch.equal(out, tq.linear(_t(x), w))
    for out, w in zip(outs, ws):
        j = jq.linear(jnp.asarray(x), jq.quantize_weight(jnp.asarray(w)))
        np.testing.assert_allclose(_np(out), _np(j), rtol=1e-5, atol=1e-6)


def test_embedding_lookup_and_tied_head_match_jax():
    rng = np.random.default_rng(3)
    e = rng.standard_normal((50, 64)).astype(np.float32)
    je, te = jq.quantize_embedding(jnp.asarray(e)), tq.quantize_embedding(_t(e))
    _same(te["q"], je["q"])
    _same(te["s"], je["s"])
    tok = rng.integers(0, 50, (3, 5)).astype(np.int32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        _same(tq.embed_lookup(te, _t(tok), dt),
              jq.embed_lookup(je, jnp.asarray(tok), jdt))
        _same(tq.embed_lookup(_t(e), _t(tok), dt),
              jq.embed_lookup(jnp.asarray(e), jnp.asarray(tok), jdt))
    h = rng.standard_normal((2, 4, 64)).astype(np.float32)
    j = jq.tied_head_logits(je, jnp.asarray(h))
    t = tq.tied_head_logits(te, _t(h))
    assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-6)


def test_kv_row_quantization_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 6, 2, 32)) * 2).astype(np.float32)
    x[1, 2, 0] = 0.0
    for xin in (jnp.asarray(x), jnp.asarray(x, jnp.bfloat16)):
        jqv, jsv = jq.quantize_kv_rows(xin)
        tqv, tsv = tq.quantize_kv_rows(_t(xin))
        assert tqv.dtype == torch.int8 and tsv.dtype == torch.bfloat16
        _same(tqv, jqv)
        _same(tsv, jsv)
        _same(tq.dequantize_kv(tqv, tsv), jq.dequantize_kv(jqv, jsv))
        _same(tq.dequantize_kv(tqv, tsv, torch.float32),
              jq.dequantize_kv(jqv, jsv, jnp.float32))


@pytest.mark.parametrize("tied", [False, True])
def test_quantize_params_matches_jax_and_is_idempotent(tied):
    jcfg = J.get_config("llama3-tiny", tie_embeddings=tied, **KW)
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jqp, tqp = jq.quantize_params(jp), tq.quantize_params(tp)
    assert set(tqp) == set(jqp) and set(tqp["layers"]) == set(jqp["layers"])
    for name in ("embed", "lm_head"):
        if name in jqp:
            assert tq.is_quantized(tqp[name])
            _same(tqp[name]["q"], jqp[name]["q"])
            _same(tqp[name]["s"], jqp[name]["s"])
    for name, leaf in jqp["layers"].items():
        if name in tq.LAYER_MATMULS:
            assert tq.is_quantized(tqp["layers"][name])
            _same(tqp["layers"][name]["q"], leaf["q"])
            _same(tqp["layers"][name]["s"], leaf["s"])
        else:
            assert not tq.is_quantized(tqp["layers"][name])
            _same(tqp["layers"][name], leaf)
    again = tq.quantize_params(tqp)
    assert again["layers"]["wq"]["q"] is tqp["layers"]["wq"]["q"]
    assert again["embed"] is tqp["embed"]
    assert tq.params_bytes(tqp) == jq.params_bytes(jqp)
    assert tq.params_bytes(tp) == jq.params_bytes(jp)


def test_init_params_quantized_equals_quantize_of_init():
    """Leaf by leaf, the quantized init draws the same numbers as the
    bf16 init from the same generator state (the port's own draws)."""
    cfg = T.get_config("llama3-tiny", **KW)
    a = T.init_params_quantized(cfg, torch.Generator().manual_seed(7), "cpu")
    b = tq.quantize_params(T.init_params(cfg, torch.Generator().manual_seed(7),
                                         "cpu"))
    fa, fb = T._flatten(a), T._flatten(b)
    assert set(fa) == set(fb)
    for name in fa:
        assert fa[name].dtype == fb[name].dtype, name
        assert torch.equal(fa[name], fb[name]), name
    assert fa["layers__wq__q"].dtype == torch.int8


def test_quantization_config_switches_and_validation(monkeypatch, tmp_path):
    """LLMQ_MODEL_QUANTIZATION / LLMQ_MODEL_KV_QUANTIZATION reach the
    model block; any value but "" or "int8" raises in the builder with
    the JAX builder's message; the two switches are independent."""
    from llmq_tpu_torch.core.config import Config, load_config
    from llmq_tpu_torch.engine.builder import build_engine

    # No config file in the working directory: defaults and env only.
    monkeypatch.chdir(tmp_path)
    d = Config().model
    assert (d.quantization, d.kv_quantization) == ("", "")
    cfg = load_config(environ={"LLMQ_MODEL_QUANTIZATION": "int8",
                               "LLMQ_MODEL_KV_QUANTIZATION": "int8"})
    assert (cfg.model.quantization, cfg.model.kv_quantization) == (
        "int8", "int8")
    for field, msg in (("quantization", "unknown model.quantization"),
                       ("kv_quantization", "unknown model.kv_quantization")):
        bad = Config()
        bad.model.name, bad.device = "llama3-tiny", "cpu"
        setattr(bad.model, field, "int4")
        with pytest.raises(ValueError, match=msg):
            build_engine(bad)
    for wq, kvq in (("int8", ""), ("", "int8")):
        c = Config()
        c.model.name, c.device = "llama3-tiny", "cpu"
        c.executor.kv_pages = 16
        c.model.quantization, c.model.kv_quantization = wq, kvq
        ex = build_engine(c).executor
        assert tq.is_quantized(ex.model.params["layers"]["wq"]) == bool(wq)
        assert ("k_scale" in ex.cache) == bool(kvq)
        assert ex.cache["k"].dtype == (torch.int8 if kvq else torch.bfloat16)
