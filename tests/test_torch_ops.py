"""The port's ops against the JAX package's, on the same numpy inputs.

Plain routes are held to the JAX functions (f32: atol 1e-5; bf16 stated
per test). Each kernel's plain twin (``llmq_tpu_torch.ops.kernels``) is
held to the Pallas kernel it replaces, run as ``tests/test_pallas.py``
runs it (``interpret=True``) at small kernel-legal shapes: H=4, H_kv=2,
D=64 (GD=128), page_size=16, a few pages. KV writes compare bit-exact
over the whole pool.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.ops import attention as jattn  # noqa: E402
from llmq_tpu.ops.norms import rms_norm as j_rms_norm  # noqa: E402
from llmq_tpu.ops.rope import apply_rope as j_apply_rope  # noqa: E402
from llmq_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin  # noqa: E402
from llmq_tpu.ops.sampling import _filter_logits as j_filter  # noqa: E402
from llmq_tpu.ops.sampling import greedy as j_greedy  # noqa: E402

from llmq_tpu_torch.ops import attention as tattn  # noqa: E402
from llmq_tpu_torch.ops import kernels  # noqa: E402
from llmq_tpu_torch.ops.norms import rms_norm  # noqa: E402
from llmq_tpu_torch.ops.rope import apply_rope, rope_cos_sin  # noqa: E402
from llmq_tpu_torch.ops.sampling import (_filter_logits, greedy,  # noqa: E402
                                         sample_token)

F32_ATOL = 1e-5

# The suite runs in several xdist workers on shared cores: one intra-op
# thread per worker avoids oversubscribing them (and runs faster here).
torch.set_num_threads(1)
H, HKV, D, PS = 4, 2, 64, 16
GD = HKV * D


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _pools(rng, L=2, P=24):
    k = rng.standard_normal((L, P, PS, GD)).astype(np.float32)
    v = rng.standard_normal((L, P, PS, GD)).astype(np.float32)
    return k, v


# -- plain routes --------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(_np(rms_norm(_t(x), _t(w))),
                               _np(j_rms_norm(jnp.asarray(x),
                                              jnp.asarray(w))),
                               atol=F32_ATOL)


def test_rms_norm_bf16_matches_jax():
    """bf16 in and out: one bf16 rounding step apart at most (2**-7
    relative at unit scale → atol 2e-2)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    t = rms_norm(_t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16))
    j = j_rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32), atol=2e-2)


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    cos, sin = rope_cos_sin(_t(pos), 64)
    jc, js = j_rope_cos_sin(jnp.asarray(pos), 64)
    np.testing.assert_allclose(_np(cos), _np(jc), atol=F32_ATOL)
    np.testing.assert_allclose(_np(sin), _np(js), atol=F32_ATOL)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(apply_rope(_t(x), cos, sin)),
        _np(j_apply_rope(jnp.asarray(x), jc, js)), atol=F32_ATOL)


def test_greedy_and_filter_logits_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    np.testing.assert_array_equal(greedy(_t(logits)).numpy(),
                                  np.asarray(j_greedy(jnp.asarray(logits))))
    temps = np.array([0.0, 0.7, 1.0, 1.3], np.float32)
    for top_k, top_p in ((0, 1.0), (5, 1.0), (0, 0.8), (7, 0.9)):
        t, lf, scaled = _filter_logits(_t(logits), _t(temps), top_k, top_p)
        jt, jlf, jsc = j_filter(jnp.asarray(logits), jnp.asarray(temps),
                                top_k, top_p)
        np.testing.assert_allclose(_np(t), _np(jt), atol=F32_ATOL)
        np.testing.assert_allclose(_np(lf), _np(jlf), atol=F32_ATOL)
        sc, jsc = _np(scaled), _np(jsc)
        np.testing.assert_array_equal(np.isinf(sc), np.isinf(jsc))
        fin = np.isfinite(sc)
        np.testing.assert_allclose(sc[fin], jsc[fin], rtol=1e-5)


def test_sample_token_greedy_rows_and_filtered_support():
    """Temperature <= 0 rows are greedy; sampled rows only draw tokens
    that survived top-k (draws are the port's own Generator stream)."""
    rng = np.random.default_rng(4)
    logits = _t(rng.standard_normal((3, 40)).astype(np.float32))
    temps = _t(np.array([0.0, 1.0, 1.0], np.float32))
    gen = torch.Generator().manual_seed(0)
    allowed = set(torch.topk(logits[1], 4).indices.tolist())
    for _ in range(30):
        tok = sample_token(logits, gen, temperature=temps, top_k=4)
        assert tok.dtype == torch.int32
        assert int(tok[0]) == int(logits[0].argmax())
        assert int(tok[1]) in allowed


def test_causal_prefill_attention_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 6, H, D)).astype(np.float32)
    k = rng.standard_normal((2, 10, HKV, D)).astype(np.float32)
    v = rng.standard_normal((2, 10, HKV, D)).astype(np.float32)
    off = np.array([4, 2], np.int32)
    np.testing.assert_allclose(
        _np(tattn.causal_prefill_attention(_t(q), _t(k), _t(v),
                                           q_offset=_t(off))),
        _np(jattn.causal_prefill_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_offset=jnp.asarray(off))), atol=F32_ATOL)


def test_gqa_attend_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, H, D)).astype(np.float32)
    k = rng.standard_normal((3, 20, HKV, D)).astype(np.float32)
    v = rng.standard_normal((3, 20, HKV, D)).astype(np.float32)
    sl = np.array([1, 11, 20], np.int32)
    np.testing.assert_allclose(
        _np(tattn._gqa_attend(_t(q), _t(k), _t(v), _t(sl))),
        _np(jattn._gqa_attend(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(sl))),
        atol=F32_ATOL)


def test_gqa_attend_bf16_matches_jax():
    """bf16 operands, f32 softmax, probabilities rounded to bf16 before
    P @ V in both: atol 2e-2 on unit-scale values."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, H, D)).astype(np.float32)
    k = rng.standard_normal((2, 33, HKV, D)).astype(np.float32)
    v = rng.standard_normal((2, 33, HKV, D)).astype(np.float32)
    sl = np.array([17, 33], np.int32)
    bf = torch.bfloat16
    t = tattn._gqa_attend(_t(q).to(bf), _t(k).to(bf), _t(v).to(bf), _t(sl))
    j = jattn._gqa_attend(jnp.asarray(q, jnp.bfloat16),
                          jnp.asarray(k, jnp.bfloat16),
                          jnp.asarray(v, jnp.bfloat16), jnp.asarray(sl))
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32), atol=2e-2)


def test_paged_decode_attention_pooled_matches_jax():
    rng = np.random.default_rng(8)
    kp, vp = _pools(rng)
    q = rng.standard_normal((3, H, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, 24))[:12].reshape(3, 4).astype(np.int32)
    sl = np.array([5, 16, 64], np.int32)
    np.testing.assert_allclose(
        _np(tattn.paged_decode_attention_pooled(_t(q), _t(kp), _t(vp),
                                                _t(bt), _t(sl), 1)),
        _np(jattn.paged_decode_attention_pooled(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(sl), 1)), atol=F32_ATOL)


@pytest.mark.parametrize("block_size", [512, 16])
def test_blockwise_prefill_attention_matches_jax(block_size):
    rng = np.random.default_rng(9)
    B, T, S = 2, 8, 48
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    pos = np.stack([np.arange(T) + 3, np.minimum(np.arange(T) + 30, 34)]
                   ).astype(np.int32)
    sl = np.array([11, 35], np.int32)
    np.testing.assert_allclose(
        _np(tattn.blockwise_prefill_attention(_t(q), _t(k), _t(v), _t(pos),
                                              _t(sl),
                                              block_size=block_size)),
        _np(jattn.blockwise_prefill_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pos), jnp.asarray(sl), block_size=block_size)),
        atol=F32_ATOL)


def test_paged_kv_write_matches_jax_scatter():
    rng = np.random.default_rng(10)
    kp, vp = _pools(rng)
    kn = rng.standard_normal((5, HKV, D)).astype(np.float32)
    vn = rng.standard_normal((5, HKV, D)).astype(np.float32)
    page = np.array([3, 9, 4, 11, 2], np.int32)
    slot = np.array([0, 15, 7, 3, 9], np.int32)
    tk, tv = _t(kp), _t(vp)
    tattn.paged_kv_write(tk, tv, _t(kn), _t(vn), _t(page), _t(slot), 1)
    jk, jv = jattn.paged_kv_write(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(page), jnp.asarray(slot), 1,
                                  enabled=False)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- kernel twins against the Pallas kernels (interpret mode) -----------------

def _decode_case(rng, seq_lens, P=40, mp=6, inactive=()):
    B = len(seq_lens)
    bt = rng.permutation(np.arange(1, P))[:B * mp].reshape(B, mp)
    bt = bt.astype(np.int32)
    sl = np.asarray(seq_lens, np.int32)
    wp = np.where(sl > 0, bt[np.arange(B), np.maximum(sl - 1, 0) // PS], 0)
    wp = wp.astype(np.int32)
    for b in inactive:
        wp[b] = 0
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, HKV, D)).astype(np.float32)
    vn = rng.standard_normal((B, HKV, D)).astype(np.float32)
    return q, kn, vn, bt, sl, wp


# seq_lens, inactive rows, block-table width, Pallas pages per chunk
_DECODE_CASES = {
    "page_edges": ([1, 16, 17, 33, 96], (), 6, 2),
    "inactive_and_empty": ([9, 0, 48, 5, 31], (3,), 6, 2),
    # where the kernel's 64-position tiles and its splits begin and end
    "tile_edges": ([63, 64, 65], (), 9, 3),
    "split_edges": ([127, 128, 129], (), 9, 3),
}


@pytest.mark.parametrize("case", list(_DECODE_CASES))
def test_fused_decode_twin_matches_pallas(case):
    """Kernel 1. Live rows' attention within 1e-4 (f32, the kernel's
    online softmax vs the twin's one-pass softmax); a zero-length row
    returns exactly 0 in both. Pools: bit-exact everywhere for live
    rows; with inactive rows, page 0 (their garbage target) is skipped."""
    from llmq_tpu.ops.pallas.fused_decode import fused_decode_attention_pallas

    rng = np.random.default_rng(11)
    seq_lens, inactive, mp, ppc = _DECODE_CASES[case]
    kp, vp = _pools(rng, P=40)
    q, kn, vn, bt, sl, wp = _decode_case(rng, seq_lens, mp=mp,
                                         inactive=inactive)
    j_out, (jk, jv) = fused_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(sl), jnp.asarray(wp),
        1, pages_per_chunk=ppc, interpret=True)
    tk, tv = _t(kp), _t(vp)
    t_out = kernels.fused_decode(_t(q), _t(kn), _t(vn), tk, tv, _t(bt),
                                 _t(sl), _t(wp), 1)
    live = [b for b in range(len(seq_lens))
            if seq_lens[b] > 0 and b not in inactive]
    np.testing.assert_allclose(_np(t_out)[live], np.asarray(j_out)[live],
                               atol=1e-4)
    for b in range(len(seq_lens)):
        if seq_lens[b] == 0:
            assert np.all(np.asarray(j_out)[b] == 0)
            assert torch.all(t_out[b] == 0)
    first = 1 if inactive else 0
    np.testing.assert_array_equal(tk.numpy()[:, first:],
                                  np.asarray(jk)[:, first:])
    np.testing.assert_array_equal(tv.numpy()[:, first:],
                                  np.asarray(jv)[:, first:])


def _desc(*cols):
    """Per-row int32 descriptor tensors (kernels 2 and 3) from lists."""
    return [torch.tensor(c, dtype=torch.int32) for c in cols]


@pytest.mark.parametrize("start,n_tok", [(0, 32), (5, 20), (13, 32),
                                         (19, 1), (37, 27)])
def test_kv_prefill_write_twin_matches_pallas(start, n_tok):
    """Kernel 2, whole pools bit-exact; rows past n_tok are padding."""
    from llmq_tpu.ops.pallas.kv_write import kv_prefill_write_pallas

    rng = np.random.default_rng(start * 100 + n_tok)
    kp, vp = _pools(rng, P=16)
    mp = 8
    bt = rng.permutation(np.arange(1, 16))[:mp].astype(np.int32)
    T = 32
    rows_k = rng.standard_normal((T, GD)).astype(np.float32)
    rows_v = rng.standard_normal((T, GD)).astype(np.float32)
    n_wp = T // PS + 1
    ak = np.zeros((n_wp * PS, GD), np.float32)
    av = np.zeros((n_wp * PS, GD), np.float32)
    off = start % PS
    ak[off:off + n_tok] = rows_k[:n_tok]
    av[off:off + n_tok] = rows_v[:n_tok]
    jk, jv = kv_prefill_write_pallas(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ak), jnp.asarray(av),
        jnp.asarray(bt), jnp.int32(start), jnp.int32(n_tok), 1,
        interpret=True)
    tk, tv = _t(kp), _t(vp)
    kernels.kv_prefill_write(tk, tv, _t(rows_k), _t(rows_v), _t(bt[None]),
                             *_desc([0], [n_tok], [start]), T, 1)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("start", [0, 24, 37, 64])
def test_prefill_attention_twin_matches_pallas(start):
    """Kernel 3: a fresh chunk and continuation chunks (37 is not page
    aligned; 64 starts on the card kernel's key-tile edge) over cached
    history; f32 atol 1e-4."""
    from llmq_tpu.ops.pallas.prefill_attention import (
        paged_prefill_attention_pallas)

    rng = np.random.default_rng(start + 1)
    kp, vp = _pools(rng, P=24)
    T, mp = 16, 8
    bt = rng.permutation(np.arange(1, 24))[:mp].astype(np.int32)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    j = paged_prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.int32(start), 1, pages_per_chunk=2, q_block=8, interpret=True)
    t = kernels.prefill_attention(_t(q[None]), _t(kp), _t(vp), _t(bt[None]),
                                  *_desc([start], [T]), 1)[0]
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-4)


def test_prefill_attention_twin_bf16_matches_pallas():
    """Kernel 3 on bf16 pools: atol 2e-2 (bf16 outputs, probabilities
    rounded to bf16 before P @ V in the twin)."""
    from llmq_tpu.ops.pallas.prefill_attention import (
        paged_prefill_attention_pallas)

    rng = np.random.default_rng(21)
    kp, vp = _pools(rng, P=24)
    T, mp, start = 16, 8, 21
    bt = rng.permutation(np.arange(1, 24))[:mp].astype(np.int32)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    bf = jnp.bfloat16
    j = paged_prefill_attention_pallas(
        jnp.asarray(q, bf), jnp.asarray(kp, bf), jnp.asarray(vp, bf),
        jnp.asarray(bt), jnp.int32(start), 1, pages_per_chunk=2,
        q_block=8, interpret=True)
    tb = torch.bfloat16
    t = kernels.prefill_attention(_t(q[None]).to(tb), _t(kp).to(tb),
                                  _t(vp).to(tb), _t(bt[None]),
                                  *_desc([start], [T]), 1)[0]
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32), atol=2e-2)


def test_kv_cache_write_twin_matches_pallas():
    """Kernel 4: N rows to distinct pages, whole pools bit-exact."""
    from llmq_tpu.ops.pallas.kv_write import kv_cache_write_pallas

    rng = np.random.default_rng(12)
    kp, vp = _pools(rng, P=40)
    N = 12
    kn = rng.standard_normal((N, GD)).astype(np.float32)
    vn = rng.standard_normal((N, GD)).astype(np.float32)
    page = np.arange(1, N + 1).astype(np.int32)
    slot = (np.arange(N) * 5 % PS).astype(np.int32)
    jk, jv = kv_cache_write_pallas(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(page), jnp.asarray(slot), 1,
                                   interpret=True)
    tk, tv = _t(kp), _t(vp)
    kernels.kv_cache_write(tk, tv, _t(kn), _t(vn), _t(page), _t(slot), 1)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_decode_routes_agree_on_cpu():
    """paged_decode_step: fused and split routes give the same live-row
    attention (f32 atol 1e-5) and identical pools."""
    rng = np.random.default_rng(13)
    kp, vp = _pools(rng, P=40)
    q, kn, vn, bt, sl, wp = _decode_case(rng, [3, 17, 40, 64])
    slot = ((sl - 1) % PS).astype(np.int32)
    k1, v1, k2, v2 = _t(kp), _t(vp), _t(kp), _t(vp)
    a = tattn.paged_decode_step(_t(q), _t(kn), _t(vn), k1, v1, _t(bt),
                                _t(sl), _t(wp), _t(slot), 0, fused=True)
    b = tattn.paged_decode_step(_t(q), _t(kn), _t(vn), k2, v2, _t(bt),
                                _t(sl), _t(wp), _t(slot), 0, fused=False)
    np.testing.assert_allclose(_np(a), _np(b), atol=F32_ATOL)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_wrappers_count_no_launch_on_cpu():
    """CPU tensors take the plain twins: no kernel launch is counted
    (kernel 4, and kernels 6 and 8 on a mixed geometry)."""
    rng = np.random.default_rng(14)
    kp, vp = _pools(rng, P=8)
    before = dict(kernels.LAUNCHES)
    rows = _t(rng.standard_normal((4, GD)).astype(np.float32))
    kernels.kv_cache_write(_t(kp), _t(vp), rows, rows,
                           _t(np.array([1, 2, 3, 4], np.int32)),
                           _t(np.array([0, 1, 2, 3], np.int32)), 0)
    g = _Ragged(**RAGGED_GEOMETRIES["mixed_decode_and_slices"])
    g.port(torch.float32)
    kernels.paged_decode_attention(_t(g.q_dec), _t(g.kp), _t(g.vp),
                                   _t(g.bt[:g.B]), _t(g.dec_lens), 0)
    assert kernels.LAUNCHES == before


# -- kernel 1's split-K host side ----------------------------------------------

@pytest.mark.parametrize("max_pages,page_size", [
    (128, 16), (64, 16), (6, 16), (5, 16), (9, 16), (1, 1), (8, 48),
    (16, 8), (3, 100), (512, 16), (32, 32), (7, 1), (2, 64), (100, 16)])
def test_fused_decode_split_count(max_pages, page_size):
    """Split blocks per (row, KV head): the fewest chunks of
    FUSED_DECODE_CHUNK positions (a multiple of the kernel's 64-position
    tile) that cover a full block table, from shapes alone (no read of
    seq_lens)."""
    chunk = kernels.FUSED_DECODE_CHUNK
    assert chunk > 0 and chunk % 64 == 0
    splits = kernels.fused_decode_splits(max_pages, page_size)
    assert splits >= 1
    assert (splits - 1) * chunk < max_pages * page_size <= splits * chunk


@pytest.mark.parametrize("B,hkv,n_rep,d,splits", [
    (8, 8, 4, 128, 16), (3, 2, 2, 64, 1), (1, 1, 8, 64, 5)])
def test_split_workspace_shape(B, hkv, n_rep, d, splits):
    """f32 partials (B, H_kv, S, n_rep * (D + 2)): acc, then the max and
    the sum per head; int32 counters (B, H_kv); all zeros when made."""
    ws, counters = kernels.split_workspace("fused_decode", torch.device("cpu"),
                                           B, hkv, n_rep, d, splits)
    assert tuple(ws.shape) == (B, hkv, splits, n_rep * (d + 2))
    assert ws.dtype == torch.float32 and not ws.any()
    assert tuple(counters.shape) == (B, hkv)
    assert counters.dtype == torch.int32 and not counters.any()


GEOMETRY = (4, 2, 2, 64, 3)       # B, H_kv, n_rep, D, splits


@pytest.mark.parametrize("changed", range(len(GEOMETRY)))
def test_split_workspace_is_made_once_per_geometry(changed):
    """The same geometry gets the same tensors back (no per-call
    allocation); a change in any of B, H_kv, n_rep, D or the split count
    gets new ones."""
    a = kernels.split_workspace("fused_decode", "cpu", *GEOMETRY)
    b = kernels.split_workspace("fused_decode", torch.device("cpu"),
                                *GEOMETRY)
    assert a[0] is b[0] and a[1] is b[1]
    other = list(GEOMETRY)
    other[changed] += 1
    c = kernels.split_workspace("fused_decode", "cpu", *other)
    assert c[0] is not a[0] and c[1] is not a[1]
    assert kernels.split_workspace("fused_decode", "cpu", *other)[0] is c[0]


@pytest.mark.parametrize("geometry", [GEOMETRY, (8, 8, 4, 128, 16)])
def test_split_workspace_is_one_per_kernel(geometry):
    """Kernels 1, 8, 6, 5 and 7 get five distinct workspaces and counter
    arrays for one geometry, each reused by its own kernel's later
    calls; a name that is no split kernel's is refused."""
    names = kernels.SPLIT_KERNELS
    assert names == ("fused_decode", "paged_decode_attention",
                     "ragged_mixed_attention", "fused_decode_q8",
                     "ragged_mixed_attention_q8")
    made = [kernels.split_workspace(k, "cpu", *geometry) for k in names]
    assert len({id(ws) for ws, _ in made}) == len(names)
    assert len({id(c) for _, c in made}) == len(names)
    assert len({c.data_ptr() for _, c in made}) == len(names)
    for k, (ws, counters) in zip(names, made):
        again = kernels.split_workspace(k, "cpu", *geometry)
        assert again[0] is ws and again[1] is counters
    for name in ("decode", "paged_decode_attention_q8"):
        with pytest.raises(ValueError, match="no split workspace"):
            kernels.split_workspace(name, "cpu", *geometry)


@pytest.mark.parametrize("q8", ["fused_decode_q8",
                                "ragged_mixed_attention_q8"])
@pytest.mark.parametrize("geometry", [GEOMETRY, (8, 8, 4, 128, 16)])
def test_split_workspace_of_int8_kernels_is_their_own(q8, geometry):
    """Kernels 5 and 7 each get a workspace and counters of their own,
    apart from the bf16 kernels' (and each other's) at the same
    geometry, shaped as kernel 1's; a name with a typo is refused."""
    ws, counters = kernels.split_workspace(q8, "cpu", *geometry)
    B, hkv, n_rep, d, splits = geometry
    assert tuple(ws.shape) == (B, hkv, splits, n_rep * (d + 2))
    assert tuple(counters.shape) == (B, hkv) and not counters.any()
    for other in kernels.SPLIT_KERNELS:
        if other == q8:
            continue
        o_ws, o_counters = kernels.split_workspace(other, "cpu", *geometry)
        assert o_ws.data_ptr() != ws.data_ptr()
        assert o_counters.data_ptr() != counters.data_ptr()
    with pytest.raises(ValueError, match="no split workspace"):
        kernels.split_workspace(q8.upper(), "cpu", *geometry)


@pytest.mark.parametrize("N,hkv,max_pages,page_size,slice_blocks,splits", [
    (144, 8, 128, 16, 144, 16),   # llama3-8b: 1168 blocks at B=8
    (48, 2, 16, 16, 12, 2), (0, 8, 128, 16, 0, 16), (8, 1, 1, 1, 1, 1),
    (128, 4, 8, 48, 64, 3), (2048, 8, 128, 16, 2048, 16)])
def test_ragged_grid(N, hkv, max_pages, page_size, slice_blocks, splits):
    """Kernel 6's grid: one slice block per (8-row q-block, KV head),
    first; then kernel 1's split count of decode blocks per (row, KV
    head). A packed buffer that is not a multiple of 8 rows is
    refused."""
    assert kernels.ragged_grid(N, hkv, max_pages, page_size) == \
        (slice_blocks, splits)
    assert splits == kernels.fused_decode_splits(max_pages, page_size)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.ragged_grid(N + 4, hkv, max_pages, page_size)


def test_fused_decode_on_cpu_makes_no_workspace():
    """CPU tensors take the twin: no workspace is made, no launch
    counted."""
    rng = np.random.default_rng(15)
    kp, vp = _pools(rng, P=40)
    q, kn, vn, bt, sl, wp = _decode_case(rng, [3, 70])
    made = dict(kernels._SPLIT_WORKSPACES)
    before = dict(kernels.LAUNCHES)
    kernels.fused_decode(_t(q), _t(kn), _t(vn), _t(kp), _t(vp), _t(bt),
                         _t(sl), _t(wp), 0)
    assert kernels._SPLIT_WORKSPACES == made
    assert kernels.LAUNCHES == before


# -- kernel 6 (ragged mixed attention) and kernel 8 (decode attention) --------

class _Ragged:
    """One mixed geometry, as ``tests/test_ragged_attention.py`` builds
    it: decode rows of the given lengths (an empty row writes nothing)
    and slices ``(qstart, qlen)`` packed at q-block-aligned offsets, every
    row and slice on its own pages of a random pool."""

    def __init__(self, dec_lens, slices, *, h=H, hkv=HKV, mp=4, layers=1,
                 layer=0, seed=0, P=64):
        rng = np.random.default_rng(seed)
        qblk = tattn.RAGGED_Q_BLOCK
        self.h, self.gd, self.layer = h, hkv * D, layer
        self.kp = rng.standard_normal((layers, P, PS, self.gd)).astype(np.float32)
        self.vp = rng.standard_normal((layers, P, PS, self.gd)).astype(np.float32)
        B, S = len(dec_lens), len(slices)
        self.B = B
        self.dec_lens = np.asarray(dec_lens, np.int32)
        bt = np.zeros((B + S, mp), np.int32)
        used = 1
        for b in range(B):
            n = -(-max(1, dec_lens[b]) // PS)
            bt[b, :n] = np.arange(used, used + n)
            used += n
        for s, (st, n) in enumerate(slices):
            k = -(-(st + n) // PS)
            bt[B + s, :k] = np.arange(used, used + k)
            used += k
        assert used <= P
        self.bt = bt
        self.wp = np.array([bt[b, (l - 1) // PS] if l > 0 else 0
                            for b, l in enumerate(dec_lens)], np.int32)
        self.qstart = np.array([st for st, _ in slices], np.int32)
        self.qlen = np.array([n for _, n in slices], np.int32)
        self.qoff = np.zeros(S, np.int32)
        off = 0
        for s, (_st, n) in enumerate(slices):
            self.qoff[s] = off
            off += -(-n // qblk) * qblk
        self.N = max(qblk, off)
        self.seq = np.concatenate([self.dec_lens, self.qstart + self.qlen])
        self.q_dec = rng.standard_normal((B, h, D)).astype(np.float32)
        self.kn = rng.standard_normal((B, hkv, D)).astype(np.float32)
        self.vn = rng.standard_normal((B, hkv, D)).astype(np.float32)
        self.q_pf = rng.standard_normal((self.N, h, D)).astype(np.float32)

    def pallas(self, dtype):
        from llmq_tpu.ops.pallas.ragged_paged_attention import (
            ragged_mixed_attention_pallas)

        c = lambda a: jnp.asarray(a, dtype)                 # noqa: E731
        return ragged_mixed_attention_pallas(
            c(self.q_dec), c(self.kn), c(self.vn), c(self.q_pf), c(self.kp),
            c(self.vp), jnp.asarray(self.bt), jnp.asarray(self.seq),
            jnp.asarray(self.wp), jnp.asarray(self.qoff),
            jnp.asarray(self.qlen), jnp.asarray(self.qstart), self.layer,
            interpret=True)

    def port(self, dtype):
        c = lambda a: _t(a).to(dtype)                       # noqa: E731
        kp, vp = c(self.kp), c(self.vp)
        d, p = kernels.ragged_mixed_attention(
            c(self.q_dec), c(self.kn), c(self.vn), c(self.q_pf), kp, vp,
            _t(self.bt), _t(self.seq), _t(self.wp), _t(self.qoff),
            _t(self.qlen), _t(self.qstart), self.layer)
        return d, p, kp, vp


RAGGED_GEOMETRIES = {
    # tests/test_ragged_attention.py:214-262, at page size 16.
    "mixed_decode_and_slices": dict(dec_lens=[1, 7, 13, 25],
                                    slices=[(5, 10), (0, 3)]),
    "decode_only": dict(dec_lens=[1, 2, 3, 8, 9, 16, 17, 31],
                        slices=[(0, 0)]),
    "prefill_only_frozen_rows": dict(dec_lens=[0, 0, 0, 0],
                                     slices=[(0, 12), (0, 7), (3, 5)]),
    "slice_crossing_pages_with_history": dict(dec_lens=[5, 1, 9, 2],
                                              slices=[(11, 30), (0, 1)],
                                              mp=6),
    "gqa_groups": dict(dec_lens=[3, 30, 12, 1], slices=[(2, 9)], h=16),
    "nonzero_layer": dict(dec_lens=[4, 6, 2, 10], slices=[(0, 5)], mp=2,
                          layers=3, layer=2),
}


@pytest.mark.parametrize("name", sorted(RAGGED_GEOMETRIES))
def test_ragged_mixed_attention_twin_matches_pallas(name):
    """Kernel 6, f32: decode rows and packed slice rows within 1e-5 of
    the Pallas kernel; empty decode rows and packed rows outside every
    slice are zero in both; whole pools bit-exact (empty rows write
    nothing)."""
    g = _Ragged(seed=len(name), **RAGGED_GEOMETRIES[name])
    j_d, j_p, (jk, jv) = g.pallas(jnp.float32)
    t_d, t_p, tk, tv = g.port(torch.float32)
    np.testing.assert_allclose(_np(t_d), np.asarray(j_d), atol=F32_ATOL)
    np.testing.assert_allclose(_np(t_p), np.asarray(j_p), atol=F32_ATOL)
    live = np.zeros(g.N, bool)
    for off, n in zip(g.qoff, g.qlen):
        live[off:off + n] = True
    assert np.all(_np(t_p)[~live] == 0)
    assert np.all(_np(t_d)[g.dec_lens == 0] == 0)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_ragged_mixed_attention_twin_bf16_matches_pallas():
    """Kernel 6 on bf16: attention within 2e-2 (probabilities rounded to
    bf16 before P @ V in the twin), pools bit-exact."""
    g = _Ragged(seed=99, **RAGGED_GEOMETRIES["mixed_decode_and_slices"])
    j_d, j_p, (jk, jv) = g.pallas(jnp.bfloat16)
    t_d, t_p, tk, tv = g.port(torch.bfloat16)
    np.testing.assert_allclose(_np(t_d), np.asarray(j_d, np.float32),
                               atol=2e-2)
    np.testing.assert_allclose(_np(t_p), np.asarray(j_p, np.float32),
                               atol=2e-2)
    np.testing.assert_array_equal(tk.view(torch.int16).numpy(),
                                  np.asarray(jk).view(np.int16))
    np.testing.assert_array_equal(tv.view(torch.int16).numpy(),
                                  np.asarray(jv).view(np.int16))


def test_split_wrappers_of_kernels_6_and_8_on_cpu_make_no_workspace():
    """CPU tensors take the twins of kernels 6 and 8: no split workspace
    is made and no launch is counted."""
    g = _Ragged(seed=3, **RAGGED_GEOMETRIES["mixed_decode_and_slices"])
    made = dict(kernels._SPLIT_WORKSPACES)
    before = dict(kernels.LAUNCHES)
    g.port(torch.float32)
    kernels.paged_decode_attention(_t(g.q_dec), _t(g.kp), _t(g.vp),
                                   _t(g.bt[:g.B]), _t(g.dec_lens), 0)
    assert kernels._SPLIT_WORKSPACES == made
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("single_layer", [False, True])
def test_paged_decode_attention_twin_matches_pallas(single_layer):
    """Kernel 8, f32 within 1e-5 of the Pallas kernel, on the stacked
    pool (layer 1) and on the one-layer (P, ps, GD) form; an empty row
    is zero in both."""
    from llmq_tpu.ops.pallas.paged_attention import (
        paged_decode_attention_pallas)

    rng = np.random.default_rng(15)
    kp, vp = _pools(rng, P=40)
    q, _kn, _vn, bt, sl, _wp = _decode_case(rng, [1, 16, 17, 0, 96])
    layer = 1
    if single_layer:
        kp, vp, layer = kp[1], vp[1], 0
    j = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(sl), layer, pages_per_chunk=2, interpret=True)
    t = kernels.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                       _t(sl), layer)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=F32_ATOL)
    assert np.all(np.asarray(j)[3] == 0) and torch.all(t[3] == 0)


def test_ragged_mixed_step_matches_jax():
    """ops/attention.ragged_mixed_step against the JAX package's on the
    CPU (f32): the slices' K/V written from the packed rows, then decode
    and slice attention. Live rows within 1e-5; pools equal except page
    0 (JAX's plain route writes one token of an unused slice row there,
    the port writes nothing)."""
    rng = np.random.default_rng(16)
    kp, vp = _pools(rng, L=2, P=40)
    B, MP, N = 3, 6, 48
    dec_bt = np.zeros((B, MP), np.int32)
    dec_bt[0, :2], dec_bt[1, :3], dec_bt[2, :1] = [1, 2], [3, 4, 5], [6]
    pos = np.array([20, 33, 4], np.int32)
    page_of = dec_bt[np.arange(B), pos // PS].copy()
    page_of[2] = 0                                   # an inactive row
    slot_of = (pos % PS).astype(np.int32)
    # Slice 0 fresh (13 tokens), slice 1 over 37 positions of history
    # (20 tokens, crossing pages), slice 2 unused.
    pf_bt = np.zeros((3, MP), np.int32)
    pf_bt[0, :1], pf_bt[1, :4] = [7], [8, 9, 10, 11]
    qoff = np.array([0, 16, 0], np.int32)
    qlen = np.array([13, 20, 0], np.int32)
    qstart = np.array([0, 37, 0], np.int32)
    pf_pos = np.zeros(N, np.int32)
    pf_pos[0:13] = np.arange(13)
    pf_pos[16:36] = 37 + np.arange(20)
    q_dec = rng.standard_normal((B, H, D)).astype(np.float32)
    kd, vd = (rng.standard_normal((B, HKV, D)).astype(np.float32)
              for _ in range(2))
    q_pf = rng.standard_normal((N, H, D)).astype(np.float32)
    kpf, vpf = (rng.standard_normal((N, HKV, D)).astype(np.float32)
                for _ in range(2))
    j_d, j_p, jk, jv = jattn.ragged_mixed_step(
        *(jnp.asarray(a) for a in (q_dec, kd, vd, q_pf, kpf, vpf, kp, vp,
                                   dec_bt, pos + 1, page_of, slot_of, pf_bt,
                                   pf_pos, qoff, qlen)), 1)
    tk, tv = _t(kp), _t(vp)
    slices = tattn.ragged_slices(_t(dec_bt), _t(pos + 1), _t(pf_bt),
                                 *_desc(qoff, qlen, qstart))
    t_d, t_p = tattn.ragged_mixed_step(_t(q_dec), _t(kd), _t(vd), _t(q_pf),
                                       _t(kpf), _t(vpf), tk, tv,
                                       _t(page_of), slices, 1)
    np.testing.assert_allclose(_np(t_d)[:2], np.asarray(j_d)[:2],
                               atol=F32_ATOL)
    live = np.r_[0:13, 16:36]
    np.testing.assert_allclose(_np(t_p)[live], np.asarray(j_p)[live],
                               atol=F32_ATOL)
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])


def test_ragged_step_two_pieces_of_one_prompt():
    """Two consecutive pieces of one prompt in ONE ragged step (same
    block table, piece 2 starting where piece 1 ends): every write of
    the step precedes its attention, so piece 2 sees piece 1's fresh
    K/V, and the step equals one slice holding both pieces."""
    rng = np.random.default_rng(17)
    kp, vp = _pools(rng, L=1, P=16)
    B, MP = 1, 4
    dec_bt = np.array([[1, 0, 0, 0]], np.int32)
    pos = np.array([3], np.int32)
    bt = np.array([5, 6, 0, 0], np.int32)
    q_dec = rng.standard_normal((B, H, D)).astype(np.float32)
    kd, vd = (rng.standard_normal((B, HKV, D)).astype(np.float32)
              for _ in range(2))
    q, k, v = (rng.standard_normal((22, h, D)).astype(np.float32)
               for h in (H, HKV, HKV))

    def run(qoff, qlen, qstart, rows):
        N = 32
        qp, kpk, vpk = (np.zeros((N,) + a.shape[1:], np.float32)
                        for a in (q, k, v))
        for off, (a, b) in zip(qoff, rows):
            qp[off:off + b - a], kpk[off:off + b - a] = q[a:b], k[a:b]
            vpk[off:off + b - a] = v[a:b]
        tk, tv = _t(kp), _t(vp)
        slices = tattn.ragged_slices(_t(dec_bt), _t(pos + 1),
                                     _t(np.stack([bt] * len(qoff))),
                                     *_desc(qoff, qlen, qstart))
        _d, p = tattn.ragged_mixed_step(
            _t(q_dec), _t(kd), _t(vd), _t(qp), _t(kpk), _t(vpk), tk, tv,
            _t(dec_bt[:, 0]), slices, 0)
        return _np(p), tk

    two, k2 = run([0, 16], [12, 10], [0, 12], [(0, 12), (12, 22)])
    one, k1 = run([0], [22], [0], [(0, 22)])
    np.testing.assert_allclose(two[16:26], one[12:22], atol=F32_ATOL)
    np.testing.assert_allclose(two[0:12], one[0:12], atol=F32_ATOL)
    assert torch.equal(k1, k2)



# -- int8 KV: kernels 5 and 7, and the int8 routes ------------------------------
#
# Pools hold int8 rows drawn through quantize_kv_rows from unit-scale
# values (raw ±127 integers would let the softmax amplify the two sides'
# different bf16 rounding points). Kernel twins are held to the Pallas
# kernels within 3e-2 (the JAX package's own int8 kernel-vs-plain
# tolerance: the kernels scale logits in f32 where the plain routes
# round the dequantized K/V to bf16), pools and scale pools bit-exact.
# The routes are held to the JAX package's plain routes at f32 queries
# within 1e-5.

Q8_ATOL = 3e-2


def _tt(a):
    """A JAX or numpy array → torch, bf16 carried bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _q8_pools(rng, L, P, ps, hkv, d):
    """Random int8 pools and (L, P, H_kv, ps) bf16 scale pools, as JAX
    arrays, through the JAX package's row quantization."""
    from llmq_tpu.ops.quant import quantize_kv_rows

    out = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((L, P, ps, hkv, d)), jnp.float32)
        q, s = quantize_kv_rows(x)
        out.append((q.reshape(L, P, ps, hkv * d), jnp.moveaxis(s, 3, 2)))
    (kq, ks), (vq, vs) = out
    return kq, vq, ks, vs


def _same_pools(t_pools, j_pools, first_page=0):
    for t, j in zip(t_pools, j_pools):
        np.testing.assert_array_equal(
            t.float().numpy()[:, first_page:],
            np.asarray(j, np.float32)[:, first_page:])


#: Kernel 5's twin against Pallas: "history" is tests/test_pallas.py's
#: int8 geometry with history written by the JAX plain route; the other
#: rows cross a page edge (page size 8) and the split body's 64-position
#: tile, 16 pages a row, over random int8 pools.
_Q8_DECODE_CASES = {
    "history": None,
    "page_and_tile_edges": [1, 8, 9, 63, 64, 65, 128],
}


@pytest.mark.parametrize("case", list(_Q8_DECODE_CASES))
def test_fused_decode_q8_twin_matches_pallas(case):
    """Kernel 5 at H=16, H_kv=8, D=16, page size 8: the Pallas kernel
    (interpret mode) and the port's twin from the same pools; attention
    within 3e-2, the four pools bit-exact."""
    from llmq_tpu.ops.pallas.fused_decode import (
        fused_decode_attention_q8_pallas)
    from llmq_tpu.ops.quant import quantize_kv_rows

    rng = np.random.default_rng(7)
    Hkv, d, h, ps, L = 8, 16, 16, 8, 2
    gd = Hkv * d
    lens = _Q8_DECODE_CASES[case]
    if lens is None:
        # Two history tokens a row written by the JAX plain route.
        B, mp, P, ppc = 8, 4, 33, 2
        pools = (jnp.zeros((L, P, ps, gd), jnp.int8),
                 jnp.zeros((L, P, ps, gd), jnp.int8),
                 jnp.zeros((L, P, Hkv, ps), jnp.bfloat16),
                 jnp.zeros((L, P, Hkv, ps), jnp.bfloat16))
        hist = [jnp.asarray(rng.standard_normal((B, 3, Hkv, d)), jnp.float32)
                for _ in range(2)]
        bt = jnp.asarray(rng.permutation(np.arange(1, P))[:B * mp]
                         .reshape(B, mp), jnp.int32)
        positions = jnp.asarray([0, 3, 7, 8, 15, 20, 25, 29], jnp.int32)
        q = jnp.asarray(rng.standard_normal((B, h, d)), jnp.bfloat16)
        for step in range(2):
            pos = positions + step
            _, pools = jattn.paged_decode_step_q8(
                q, hist[0][:, step], hist[1][:, step], pools, bt, pos + 1,
                bt[jnp.arange(B), pos // ps], pos % ps, 1)
        new = [hist[0][:, 2], hist[1][:, 2]]
        seq_lens = positions + 3
    else:
        B, mp, ppc = len(lens), 16, 4
        P = B * mp + 1
        pools = _q8_pools(rng, L, P, ps, Hkv, d)
        bt = jnp.asarray(rng.permutation(np.arange(1, P))[:B * mp]
                         .reshape(B, mp), jnp.int32)
        q = jnp.asarray(rng.standard_normal((B, h, d)), jnp.bfloat16)
        new = [jnp.asarray(rng.standard_normal((B, Hkv, d)), jnp.float32)
               for _ in range(2)]
        seq_lens = jnp.asarray(lens, jnp.int32)
    page_of = bt[jnp.arange(B), (seq_lens - 1) // ps]
    kq, ksc = quantize_kv_rows(new[0])
    vq, vsc = quantize_kv_rows(new[1])
    t_pools = [_tt(p) for p in pools]
    j_attn, j_pools = fused_decode_attention_q8_pallas(
        q, kq, ksc, vq, vsc, pools, bt, seq_lens, page_of, 1,
        pages_per_chunk=ppc, interpret=True)
    t_attn = kernels.fused_decode_q8(
        _tt(q), _tt(kq), _tt(ksc), _tt(vq), _tt(vsc), *t_pools, _tt(bt),
        _tt(seq_lens), _tt(page_of), 1)
    np.testing.assert_allclose(_np(t_attn), np.asarray(j_attn, np.float32),
                               atol=Q8_ATOL, rtol=Q8_ATOL)
    _same_pools(t_pools, j_pools)


def test_paged_decode_step_q8_matches_jax():
    """ops/attention.paged_decode_step_q8 (plain quantize, then the
    kernel-5 route) against the JAX package's plain route, f32 queries:
    active rows within 1e-5; pools bit-exact, the inactive row's write to
    the null page included."""
    rng = np.random.default_rng(18)
    L, P, hkv = 2, 40, HKV
    pools = _q8_pools(rng, L, P, PS, hkv, D)
    q, kn, vn, bt, sl, wp = _decode_case(rng, [3, 17, 40, 64, 9],
                                         inactive=(4,))
    slot = ((sl - 1) % PS).astype(np.int32)
    j_attn, j_pools = jattn.paged_decode_step_q8(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), pools,
        jnp.asarray(bt), jnp.asarray(sl), jnp.asarray(wp), jnp.asarray(slot),
        1)
    t_pools = [_tt(p) for p in pools]
    t_attn = tattn.paged_decode_step_q8(_t(q), _t(kn), _t(vn), t_pools,
                                        _t(bt), _t(sl), _t(wp), 1)
    np.testing.assert_allclose(_np(t_attn)[:4], np.asarray(j_attn)[:4],
                               atol=F32_ATOL)
    _same_pools(t_pools, j_pools)


# tests/test_ragged_attention.py:262-280's two int8 geometries.
RAGGED_Q8_GEOMETRIES = {
    "int8_scales_mixed": dict(dec_lens=[3, 140], h=16, slices=[(2, 9),
                                                               (0, 4)]),
    "int8_long_slice_multiblock": dict(dec_lens=[1, 2], h=8,
                                       slices=[(0, 20), (5, 3)]),
}


@pytest.mark.parametrize("name", sorted(RAGGED_Q8_GEOMETRIES))
def test_ragged_mixed_attention_q8_twin_matches_pallas(name):
    """Kernel 7 at H_kv=8, D=16, page size 128, 2 pages a row: decode
    rows and live packed slice rows within 3e-2 of the Pallas kernel
    (interpret mode), rows outside every slice zero in the twin, the
    four pools bit-exact."""
    from llmq_tpu.ops.pallas.ragged_paged_attention import (
        ragged_mixed_attention_q8_pallas)
    from llmq_tpu.ops.quant import quantize_kv_rows

    g = RAGGED_Q8_GEOMETRIES[name]
    rng = np.random.default_rng(len(name))
    hkv, d, ps, mp, P = 8, 16, 128, 2, 16
    dec_lens, slices, h = g["dec_lens"], g["slices"], g["h"]
    B, S = len(dec_lens), len(slices)
    pools = _q8_pools(rng, 1, P, ps, hkv, d)
    bt = np.zeros((B + S, mp), np.int32)
    used = 1
    for b, n in enumerate(dec_lens):
        k = -(-max(1, n) // ps)
        bt[b, :k] = np.arange(used, used + k)
        used += k
    for s, (st, n) in enumerate(slices):
        k = -(-(st + n) // ps)
        bt[B + s, :k] = np.arange(used, used + k)
        used += k
    wp = np.array([bt[b, (n - 1) // ps] for b, n in enumerate(dec_lens)],
                  np.int32)
    qoff = np.zeros(S, np.int32)
    off = 0
    for s, (_st, n) in enumerate(slices):
        qoff[s] = off
        off += -(-n // tattn.RAGGED_Q_BLOCK) * tattn.RAGGED_Q_BLOCK
    N = off
    qlen = np.array([n for _, n in slices], np.int32)
    qstart = np.array([st for st, _ in slices], np.int32)
    seq = np.concatenate([np.asarray(dec_lens, np.int32), qstart + qlen])
    bf = jnp.bfloat16
    q_dec = jnp.asarray(rng.standard_normal((B, h, d)), bf)
    q_pf = jnp.asarray(rng.standard_normal((N, h, d)), bf)
    kq, ks = quantize_kv_rows(jnp.asarray(rng.standard_normal((B, hkv, d)),
                                          jnp.float32))
    vq, vs = quantize_kv_rows(jnp.asarray(rng.standard_normal((B, hkv, d)),
                                          jnp.float32))
    t_pools = [_tt(p) for p in pools]
    j_d, j_p, j_pools = ragged_mixed_attention_q8_pallas(
        q_dec, kq, ks, vq, vs, q_pf, pools, jnp.asarray(bt),
        jnp.asarray(seq), jnp.asarray(wp), jnp.asarray(qoff),
        jnp.asarray(qlen), jnp.asarray(qstart), 0, interpret=True)
    t_d, t_p = kernels.ragged_mixed_attention_q8(
        _tt(q_dec), _tt(kq), _tt(ks), _tt(vq), _tt(vs), _tt(q_pf), *t_pools,
        _t(bt), _t(seq), _t(wp), _t(qoff), _t(qlen), _t(qstart), 0)
    np.testing.assert_allclose(_np(t_d), np.asarray(j_d, np.float32),
                               atol=Q8_ATOL, rtol=Q8_ATOL)
    live = np.zeros(N, bool)
    for o, n in zip(qoff, qlen):
        live[o:o + n] = True
    np.testing.assert_allclose(_np(t_p)[live],
                               np.asarray(j_p, np.float32)[live],
                               atol=Q8_ATOL, rtol=Q8_ATOL)
    assert np.all(_np(t_p)[~live] == 0)
    _same_pools(t_pools, j_pools)


def test_prefill_q8_write_and_attention_match_jax():
    """The int8 prefill chunk (plain on both devices, as in JAX): a fresh
    row and a continuation row over history, right-padded. Valid rows'
    attention within 1e-5 (f32 queries); pools bit-exact except the null
    page, where both sides scatter every padding row to slot 0."""
    rng = np.random.default_rng(19)
    L, P, T, mp = 2, 40, 16, 6
    pools = _q8_pools(rng, L, P, PS, HKV, D)
    bt = rng.permutation(np.arange(1, P))[:2 * mp].reshape(2, mp)
    bt = bt.astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    starts = np.array([0, 21], np.int32)
    pos = np.minimum(np.arange(T)[None] + starts[:, None],
                     (starts + lengths - 1)[:, None]).astype(np.int32)
    seq = (starts + lengths).astype(np.int32)
    q = rng.standard_normal((2, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, T, HKV, D)).astype(np.float32)
            for _ in range(2))
    j_pools = jattn.paged_kv_write_prefill_q8(
        pools, jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(pos), jnp.asarray(lengths), 1)
    j_out = jattn.dispatch_prefill_attention_q8(
        jnp.asarray(q), j_pools, jnp.asarray(bt), jnp.asarray(pos),
        jnp.asarray(seq), 1)
    t_pools = [_tt(p) for p in pools]
    tattn.paged_kv_write_prefill_q8(t_pools, _t(k), _t(v), _t(bt), _t(pos),
                                    _t(lengths), 1)
    t_out = tattn.dispatch_prefill_attention_q8(_t(q), t_pools, _t(bt),
                                                _t(pos), _t(seq), 1)
    _same_pools(t_pools, j_pools, first_page=1)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(_np(t_out)[b, :n], np.asarray(j_out)[b, :n],
                                   atol=F32_ATOL)


def test_ragged_mixed_step_q8_matches_jax():
    """ops/attention.ragged_mixed_step_q8 against the JAX package's plain
    route (f32 queries): the live slice rows quantized and scattered
    straight from the packed buffer, then one kernel-7 launch (its twin
    here). Active decode rows and live slice rows within 1e-5; the four
    pools bit-exact except the null page (JAX writes one token of the
    unused slice row there, the port nothing)."""
    rng = np.random.default_rng(20)
    pools = _q8_pools(rng, 2, 40, PS, HKV, D)
    B, MP, N = 3, 6, 48
    dec_bt = np.zeros((B, MP), np.int32)
    dec_bt[0, :2], dec_bt[1, :3], dec_bt[2, :1] = [1, 2], [3, 4, 5], [6]
    pos = np.array([20, 33, 4], np.int32)
    page_of = dec_bt[np.arange(B), pos // PS].copy()
    page_of[2] = 0                                   # an inactive row
    slot_of = (pos % PS).astype(np.int32)
    pf_bt = np.zeros((3, MP), np.int32)
    pf_bt[0, :1], pf_bt[1, :4] = [7], [8, 9, 10, 11]
    qoff = np.array([0, 16, 0], np.int32)
    qlen = np.array([13, 20, 0], np.int32)
    qstart = np.array([0, 37, 0], np.int32)
    pf_pos = np.zeros(N, np.int32)
    pf_pos[0:13] = np.arange(13)
    pf_pos[16:36] = 37 + np.arange(20)
    q_dec = rng.standard_normal((B, H, D)).astype(np.float32)
    kd, vd = (rng.standard_normal((B, HKV, D)).astype(np.float32)
              for _ in range(2))
    q_pf = rng.standard_normal((N, H, D)).astype(np.float32)
    kpf, vpf = (rng.standard_normal((N, HKV, D)).astype(np.float32)
                for _ in range(2))
    j = jnp.asarray
    j_d, j_p, j_pools = jattn.ragged_mixed_step_q8(
        j(q_dec), j(kd), j(vd), j(q_pf), j(kpf), j(vpf), pools, j(dec_bt),
        j(pos + 1), j(page_of), j(slot_of), j(pf_bt), j(pf_pos), j(qoff),
        j(qlen), 1)
    t_pools = [_tt(p) for p in pools]
    slices = tattn.ragged_slices(_t(dec_bt), _t(pos + 1), _t(pf_bt),
                                 *_desc(qoff, qlen, qstart))
    rows = tattn.ragged_slice_rows(slices, N, PS)
    # One (page, slot) per packed row: the 33 live rows on their slices'
    # pages, every other row on the null page's slot 0.
    assert rows[0].shape == (N,)
    live_rows = np.r_[0:13, 16:36]
    assert (rows[0][live_rows] > 0).all()
    dead = np.setdiff1d(np.arange(N), live_rows)
    assert (rows[0][dead] == 0).all() and (rows[1][dead] == 0).all()
    t_d, t_p = tattn.ragged_mixed_step_q8(
        _t(q_dec), _t(kd), _t(vd), _t(q_pf), _t(kpf), _t(vpf), t_pools,
        _t(page_of), slices, rows, 1)
    np.testing.assert_allclose(_np(t_d)[:2], np.asarray(j_d)[:2],
                               atol=F32_ATOL)
    live = np.r_[0:13, 16:36]
    np.testing.assert_allclose(_np(t_p)[live], np.asarray(j_p)[live],
                               atol=F32_ATOL)
    _same_pools(t_pools, j_pools, first_page=1)


def test_q8_wrappers_count_no_launch_on_cpu():
    """CPU tensors take the int8 twins: kernels 5 and 7 count nothing."""
    rng = np.random.default_rng(21)
    t_pools = [_tt(p) for p in _q8_pools(rng, 1, 8, PS, HKV, D)]
    q, kn, vn, bt, sl, wp = _decode_case(rng, [3, 17], P=8, mp=2)
    from llmq_tpu_torch.ops.quant import quantize_kv_rows
    (kq, ks), (vq, vs) = quantize_kv_rows(_t(kn)), quantize_kv_rows(_t(vn))
    before = dict(kernels.LAUNCHES)
    kernels.fused_decode_q8(_t(q).bfloat16(), kq, ks, vq, vs, *t_pools,
                            _t(bt), _t(sl), _t(wp), 0)
    assert kernels.LAUNCHES == before


def test_q8_wrappers_on_cpu_make_no_workspace():
    """CPU tensors take the int8 twins of kernels 5 and 7: no split
    workspace is made and no launch is counted."""
    from llmq_tpu_torch.ops.quant import quantize_kv_rows

    rng = np.random.default_rng(22)
    t_pools = [_tt(p) for p in _q8_pools(rng, 1, 12, PS, HKV, D)]
    # Two decode rows, then one 5-token slice from position 0.
    q, kn, vn, bt, sl, wp = _decode_case(rng, [3, 17, 5], P=12, mp=2)
    (kq, ks), (vq, vs) = (quantize_kv_rows(_t(x[:2])) for x in (kn, vn))
    q_dec = _t(q[:2]).bfloat16()
    q_pf = torch.zeros((8, H, D), dtype=torch.bfloat16)
    q_pf[:5] = _t(rng.standard_normal((5, H, D)).astype(np.float32))
    descr = [torch.tensor([v], dtype=torch.int32) for v in (0, 5, 0)]
    made = dict(kernels._SPLIT_WORKSPACES)
    before = dict(kernels.LAUNCHES)
    kernels.fused_decode_q8(q_dec, kq, ks, vq, vs, *t_pools, _t(bt[:2]),
                            _t(sl[:2]), _t(wp[:2]), 0)
    kernels.ragged_mixed_attention_q8(q_dec, kq, ks, vq, vs, q_pf, *t_pools,
                                      _t(bt), _t(sl), _t(wp[:2]), *descr, 0)
    assert kernels._SPLIT_WORKSPACES == made
    assert kernels.LAUNCHES == before


def _c_interfaces():
    """(library, C function, kinds of its parameters) for every
    ``extern "C"`` function in the port's CUDA sources: 'p' a pointer
    (the stream included), 'i' an int, 'f' a float."""
    import re

    out = []
    for lib, src in kernels.SOURCES.items():
        text = (kernels.CSRC_DIR / src).read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            kinds = ["p" if "*" in p else "f" if "float" in p else "i"
                     for p in params.split(",")]
            out.append((lib, name, kinds))
    return out


@pytest.mark.parametrize("lib,name,kinds", _c_interfaces(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_ctypes_signatures_match_the_c_interfaces(lib, name, kinds):
    """Each wrapper's ctypes argtypes name the C function's parameters
    one for one (a pointer as c_void_p, so it is not cut to 32 bits)."""
    import ctypes

    code = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    assert [code[t] for t in kernels._SIGNATURES[lib][name]] == kinds
