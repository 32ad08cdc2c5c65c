"""The port's Llama forwards against the JAX package's, on the same
weights carried across by ``params_from_jax``.

f32 ``llama3-tiny`` at dim=256, 4 query / 2 KV heads: prefill logits
(including a continuation chunk over cached history), a decode
sequence, and the bucket and ragged mixed steps (decode rows plus
prompt slices) agree within atol 1e-4, their pools within 1e-5. bf16:
within 0.15 on the f32 logits (two bf16 layers, activations rounded at
2**-8 relative, different matmul reduction orders).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.ops import quant as jquant  # noqa: E402

from llmq_tpu_torch.models import llama as T  # noqa: E402

KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512)

# The suite runs in several xdist workers on shared cores: one intra-op
# thread per worker avoids oversubscribing them (and runs faster here).
torch.set_num_threads(1)
PS, P, MP = 16, 32, 8


def _models(jdtype, tdtype, quant=False):
    """Both packages' models on the same weights; ``quant``: the JAX tree
    is quantized (w8a8) first and carried across as int8 and f32
    leaves."""
    jcfg = J.get_config("llama3-tiny", dtype=jdtype, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    if quant:
        jparams = jquant.quantize_params(jparams)
    tcfg = T.get_config("llama3-tiny", dtype=tdtype, **KW)
    tparams = T.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _caches(jcfg, tcfg, kv=False):
    """Empty pools in both packages; ``kv``: int8 pools with scales."""
    return (J.init_kv_pages(jcfg, P, PS, dtype=jnp.int8 if kv else None),
            T.init_kv_pages(tcfg, P, PS, "cpu",
                            dtype=torch.int8 if kv else None))


def _run_both(jdtype, tdtype, quant=False, kv=False):
    """Prefill (B=2, ragged lengths), a continuation chunk, then 5 greedy
    decode steps, in both packages. Returns lists of paired logits."""
    jcfg, jparams, tcfg, tparams = _models(jdtype, tdtype, quant)
    jc, tc = _caches(jcfg, tcfg, kv)
    rng = np.random.default_rng(0)
    B, Tn = 2, 24
    bt = np.zeros((B, MP), np.int32)
    bt[0, :5] = [3, 9, 1, 14, 6]
    bt[1, :5] = [2, 11, 7, 20, 5]
    pairs = []

    def prefill(toks, pos, lens):
        nonlocal jc
        jl, jc = J.forward_prefill(jparams, jcfg, jnp.asarray(toks),
                                   jnp.asarray(pos), jnp.asarray(lens), jc,
                                   jnp.asarray(bt))
        tl = T.forward_prefill(tparams, tcfg, torch.tensor(toks),
                               torch.tensor(pos), torch.tensor(lens), tc,
                               torch.tensor(bt))
        for b in range(B):
            pairs.append((np.asarray(jl, np.float32)[b, :lens[b]],
                          tl[b, :lens[b]].float().numpy()))

    lens = np.array([24, 13], np.int32)
    toks = rng.integers(3, 500, (B, Tn)).astype(np.int32)
    pos = np.minimum(np.arange(Tn)[None], lens[:, None] - 1).astype(np.int32)
    prefill(toks, pos, lens)
    # Continuation: starts mid-page on top of the cached history.
    lens2 = np.array([16, 9], np.int32)
    toks2 = rng.integers(3, 500, (B, 16)).astype(np.int32)
    pos2 = np.minimum(lens[:, None] + np.arange(16)[None],
                      lens[:, None] + lens2[:, None] - 1).astype(np.int32)
    prefill(toks2, pos2, lens2)
    p = lens + lens2
    tok = pairs[-1][0][-1:].argmax(-1).repeat(B).astype(np.int32)
    for _ in range(5):
        jd, jc = J.forward_decode(jparams, jcfg, jnp.asarray(tok),
                                  jnp.asarray(p), jc, jnp.asarray(bt))
        td = T.forward_decode(tparams, tcfg, torch.tensor(tok),
                              torch.tensor(p), tc, torch.tensor(bt))
        pairs.append((np.asarray(jd, np.float32), td.float().numpy()))
        tok = np.asarray(jd).argmax(-1).astype(np.int32)
        p = p + 1
    return pairs


def test_f32_forwards_match_jax():
    for j, t in _run_both(jnp.float32, torch.float32):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=1e-4)


def test_bf16_forwards_match_jax():
    for j, t in _run_both(jnp.bfloat16, torch.bfloat16):
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, atol=0.15)


def test_bridge_carries_bf16_leaves_bit_for_bit():
    jcfg = J.get_config("llama3-tiny", **KW)          # bf16 by default
    jparams = J.init_params(jax.random.PRNGKey(1), jcfg)
    host = jax.tree_util.tree_map(np.asarray, jparams)
    assert host["embed"].dtype.name == "bfloat16"
    tparams = T.params_from_jax(host, device="cpu")
    assert tparams["layers"]["wq"].dtype == torch.bfloat16
    assert tuple(tparams["layers"]["wq"].shape) == host["layers"]["wq"].shape
    np.testing.assert_array_equal(
        tparams["layers"]["wq"].view(torch.int16).numpy(),
        host["layers"]["wq"].view(np.int16))
    assert set(tparams) == set(host)
    assert set(tparams["layers"]) == set(host["layers"])


def test_tied_head_and_module_wrapper():
    """A tied-embedding config (no lm_head) runs through the Llama
    module; the module's forwards equal the functional ones."""
    cfg = T.get_config("llama3-tiny", dtype=torch.float32,
                       tie_embeddings=True, **KW)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert "lm_head" not in params
    model = T.Llama(cfg, params)
    assert not any(p.requires_grad for p in model.parameters())
    bt = torch.zeros((1, MP), dtype=torch.int32)
    bt[0, :2] = torch.tensor([4, 7])
    toks = torch.arange(3, 13, dtype=torch.int32)[None]
    pos = torch.arange(10, dtype=torch.int32)[None]
    c1 = T.init_kv_pages(cfg, P, PS, "cpu")
    c2 = T.init_kv_pages(cfg, P, PS, "cpu")
    a = model.forward_prefill(toks, pos, torch.tensor([10]), c1, bt)
    b = T.forward_prefill(params, cfg, toks, pos, torch.tensor([10]), c2, bt)
    assert torch.equal(a, b) and a.shape == (1, 10, cfg.vocab_size)
    d1 = model(torch.tensor([5], dtype=torch.int32),
               torch.tensor([10], dtype=torch.int32), c1, bt)
    d2 = T.forward_decode(params, cfg, torch.tensor([5], dtype=torch.int32),
                          torch.tensor([10], dtype=torch.int32), c2, bt)
    assert torch.equal(d1, d2)


def test_init_matches_preset_shapes_and_pool_layout():
    cfg = T.get_config("llama3-tiny", **KW)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = J.get_config("llama3-tiny", **KW)
    jshapes = jax.eval_shape(lambda: J.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    flat_t = {k: tuple(v.shape) for k, v in params["layers"].items()}
    flat_j = {k: tuple(v.shape) for k, v in jshapes["layers"].items()}
    assert flat_t == flat_j
    assert tuple(params["embed"].shape) == tuple(jshapes["embed"].shape)
    cache = T.init_kv_pages(cfg, P, PS, "cpu")
    assert tuple(cache["k"].shape) == (cfg.n_layers, P, PS,
                                       cfg.n_kv_heads * cfg.head_dim)
    for name in ("llama3-1b", "llama3-8b", "llama3-70b"):
        a, b = T.get_config(name), J.get_config(name)
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "ffn_dim", "max_seq_len", "rope_theta", "tie_embeddings"):
            assert getattr(a, f) == getattr(b, f), (name, f)
    with pytest.raises(ValueError, match="unknown model"):
        T.get_config("llama3-404b")


def _mixed_setup(quant=False, kv=False):
    """History for two decode rows and one continuing prompt, written by
    forward_prefill in both packages. Returns the models, both caches and
    the block tables: rows 0-1 decode (row 1 inactive in the mixed
    step), slice 0 continues its prompt at position 13, slice 1 is a
    fresh 7-token prompt."""
    jcfg, jparams, tcfg, tparams = _models(jnp.float32, torch.float32, quant)
    jc, tc = _caches(jcfg, tcfg, kv)
    rng = np.random.default_rng(3)
    bt = np.zeros((3, MP), np.int32)
    bt[0, :3], bt[1, :2], bt[2, :3] = [3, 9, 1], [2, 11], [7, 20, 5]
    lens = np.array([21, 17, 13], np.int32)
    toks = rng.integers(3, 500, (3, 24)).astype(np.int32)
    pos = np.minimum(np.arange(24)[None], lens[:, None] - 1).astype(np.int32)
    _, jc = J.forward_prefill(jparams, jcfg, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(lens), jc,
                              jnp.asarray(bt))
    T.forward_prefill(tparams, tcfg, torch.tensor(toks), torch.tensor(pos),
                      torch.tensor(lens), tc, torch.tensor(bt))
    pf_bt = np.zeros((2, MP), np.int32)
    pf_bt[0], pf_bt[1, :1] = bt[2], [14]
    dec = dict(tokens=np.array([17, 42], np.int32),
               positions=np.array([21, 17], np.int32), bt=bt[:2],
               active=np.array([True, False]))
    slices = dict(start=[13, 0], toks=[rng.integers(3, 500, 10),
                                       rng.integers(3, 500, 7)],
                  bt=pf_bt)
    return jcfg, jparams, tcfg, tparams, jc, tc, dec, slices


def _pools_match(jc, tc):
    # Page 0 is the null page: JAX's plain routes write padding there.
    assert set(jc) == set(tc)
    if "k_scale" in jc:
        _q8_pools_match(jc, tc)
        return
    for key in jc:
        np.testing.assert_allclose(tc[key].float().numpy()[:, 1:],
                                   np.asarray(jc[key], np.float32)[:, 1:],
                                   atol=1e-5)


def _q8_pools_match(jc, tc):
    """int8 pools: a K/V value one f32 ulp apart before quantization may
    round to the neighbouring integer (and move its row's bf16 scale by
    an ulp), so at most 0.1% of the elements may differ, ints by 1 and
    scales by one bf16 step."""
    for key in jc:
        t = tc[key].float().numpy()[:, 1:]
        j = np.asarray(jc[key], np.float32)[:, 1:]
        diff = np.abs(t - j)
        assert np.mean(diff > 0) <= 1e-3, (key, np.mean(diff > 0))
        if tc[key].dtype == torch.int8:
            assert diff.max() <= 1, key
        else:
            np.testing.assert_allclose(t, j, rtol=2 ** -7, err_msg=key)


def test_forward_mixed_matches_jax():
    """Bucket mixed step (f32): decode logits of the active row, slice
    logits at every valid position, and the pools within 1e-4."""
    _check_forward_mixed(*_mixed_setup())


def _check_forward_mixed(jcfg, jparams, tcfg, tparams, jc, tc, dec, sl,
                         atol=1e-4):
    Tw = 10
    toks = np.zeros((2, Tw), np.int32)
    pos = np.zeros((2, Tw), np.int32)
    lens = np.array([len(t) for t in sl["toks"]], np.int32)
    for i, (st, t) in enumerate(zip(sl["start"], sl["toks"])):
        toks[i, :len(t)] = t
        pos[i] = np.minimum(np.arange(Tw) + st, st + len(t) - 1)
    jd, jp, jc = J.forward_mixed(
        jparams, jcfg, jnp.asarray(dec["tokens"]),
        jnp.asarray(dec["positions"]), jc, jnp.asarray(dec["bt"]),
        jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(lens),
        jnp.asarray(sl["bt"]), dec_active=jnp.asarray(dec["active"]))
    td, tp = T.forward_mixed(
        tparams, tcfg, torch.tensor(dec["tokens"]),
        torch.tensor(dec["positions"]), tc, torch.tensor(dec["bt"]),
        torch.tensor(toks), torch.tensor(pos), torch.tensor(lens),
        torch.tensor(sl["bt"]), torch.tensor(dec["active"]))
    np.testing.assert_allclose(td.numpy()[:1], np.asarray(jd)[:1], atol=atol)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(tp.numpy()[i, :n], np.asarray(jp)[i, :n],
                                   atol=atol)
    _pools_match(jc, tc)


def test_forward_mixed_ragged_matches_jax():
    """Ragged mixed step (f32), the same work packed at q-block offsets
    plus an unused slice row: decode logits, the slices' last-token
    logits and the pools within 1e-4; the module method gives the
    functional result."""
    _check_forward_mixed_ragged(*_mixed_setup())


def _check_forward_mixed_ragged(jcfg, jparams, tcfg, tparams, jc, tc, dec,
                                sl, atol=1e-4):
    N = 32
    toks = np.zeros(N, np.int32)
    pos = np.zeros(N, np.int32)
    qoff = np.array([0, 16, 0], np.int32)
    qlen = np.array([10, 7, 0], np.int32)
    pf_bt = np.concatenate([sl["bt"], np.zeros((1, MP), np.int32)])
    for off, st, t in zip(qoff, sl["start"], sl["toks"]):
        toks[off:off + len(t)] = t
        pos[off:off + len(t)] = st + np.arange(len(t))
    jd, jp, jc = J.forward_mixed_ragged(
        jparams, jcfg, jnp.asarray(dec["tokens"]),
        jnp.asarray(dec["positions"]), jc, jnp.asarray(dec["bt"]),
        jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(qoff),
        jnp.asarray(qlen), jnp.asarray(pf_bt),
        dec_active=jnp.asarray(dec["active"]))
    args = (torch.tensor(dec["tokens"]), torch.tensor(dec["positions"]), tc,
            torch.tensor(dec["bt"]), torch.tensor(toks), torch.tensor(pos),
            torch.tensor(qoff), torch.tensor(qlen), torch.tensor(pf_bt),
            torch.tensor(dec["active"]))
    td, tp = T.forward_mixed_ragged(tparams, tcfg, *args)
    np.testing.assert_allclose(td.numpy()[:1], np.asarray(jd)[:1], atol=atol)
    np.testing.assert_allclose(tp.numpy()[:2], np.asarray(jp)[:2], atol=atol)
    _pools_match(jc, tc)
    md, mp = T.Llama(tcfg, tparams).forward_mixed_ragged(*args)
    assert torch.equal(md, td) and torch.equal(mp, tp)


# -- int8: w8a8 weights, int8 KV pools, and both -------------------------------

INT8_MODES = {"weights": (True, False), "kv": (False, True),
              "both": (True, True)}

# int8 weights alone keep the 1e-4 of the f32 forwards: the int32
# products are exact. With int8 KV a value one f32 ulp apart before
# quantization can round to the neighbouring integer (measured: one
# element of layer 1's K pool), and int8 activations downstream amplify
# that: the largest logit difference measured is 0.040 on logits of
# magnitude ~4, so int8-KV modes are held to 0.1.
INT8_KV_ATOL = 0.1


def _int8_atol(mode):
    return INT8_KV_ATOL if INT8_MODES[mode][1] else 1e-4


def test_bridge_carries_a_quantized_tree_unchanged():
    """A quantized JAX tree crosses ``params_from_jax`` leaf for leaf:
    int8 weights and f32 scales, same shapes, same values; the module
    holds them and gives the tree back."""
    jcfg = J.get_config("llama3-tiny", **KW)
    jp = jquant.quantize_params(J.init_params(jax.random.PRNGKey(2), jcfg))
    host = jax.tree_util.tree_map(np.asarray, jp)
    tp = T.params_from_jax(host, device="cpu")
    for name in ("wq", "w_down"):
        q, s = tp["layers"][name]["q"], tp["layers"][name]["s"]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), host["layers"][name]["q"])
        np.testing.assert_array_equal(s.numpy(), host["layers"][name]["s"])
    assert tp["embed"]["q"].dtype == torch.int8
    assert tp["layers"]["attn_norm"].dtype == torch.bfloat16
    model = T.Llama(T.get_config("llama3-tiny", **KW), tp)
    assert not any(p.requires_grad for p in model.parameters())
    back = model.params
    assert back["layers"]["wq"]["q"] is not None
    assert torch.equal(back["layers"]["wq"]["q"], tp["layers"]["wq"]["q"])
    assert set(back) == set(tp) and set(back["layers"]) == set(tp["layers"])


@pytest.mark.parametrize("mode", sorted(INT8_MODES))
def test_int8_forwards_match_jax(mode):
    """Prefill with a continuation chunk, then 5 greedy decode steps
    (f32 tiny), int8 weights and/or int8 KV: logits within 1e-4 (int8
    weights) or ``INT8_KV_ATOL``, and greedy tokens equal."""
    quant, kv = INT8_MODES[mode]
    for j, t in _run_both(jnp.float32, torch.float32, quant, kv):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=_int8_atol(mode))
        np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))


@pytest.mark.parametrize("mode", sorted(INT8_MODES))
def test_int8_forward_mixed_matches_jax(mode):
    """The bucket mixed step on int8 weights and/or int8 pools: decode
    and slice logits within 1e-4 (int8 weights) or ``INT8_KV_ATOL``;
    pools within 1e-5, int8 pools as ``_q8_pools_match`` states."""
    _check_forward_mixed(*_mixed_setup(*INT8_MODES[mode]),
                         atol=_int8_atol(mode))


@pytest.mark.parametrize("mode", sorted(INT8_MODES))
def test_int8_forward_mixed_ragged_matches_jax(mode):
    """The ragged mixed step on int8 weights and/or int8 pools (the int8
    slice rows scattered straight from the packed buffer, then the
    kernel-7 route): logits within 1e-4 (int8 weights) or
    ``INT8_KV_ATOL``, pools as in the bucket step."""
    _check_forward_mixed_ragged(*_mixed_setup(*INT8_MODES[mode]),
                                atol=_int8_atol(mode))
