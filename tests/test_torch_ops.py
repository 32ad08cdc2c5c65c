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


@pytest.mark.parametrize("case", ["page_edges", "inactive_and_empty"])
def test_fused_decode_twin_matches_pallas(case):
    """Kernel 1. Live rows' attention within 1e-4 (f32, the kernel's
    online softmax vs the twin's one-pass softmax); a zero-length row
    returns exactly 0 in both. Pools: bit-exact everywhere for live
    rows; with inactive rows, page 0 (their garbage target) is skipped."""
    from llmq_tpu.ops.pallas.fused_decode import fused_decode_attention_pallas

    rng = np.random.default_rng(11)
    if case == "page_edges":
        seq_lens, inactive = [1, 16, 17, 33, 96], ()
    else:
        seq_lens, inactive = [9, 0, 48, 5, 31], (3,)
    kp, vp = _pools(rng, P=40)
    q, kn, vn, bt, sl, wp = _decode_case(rng, seq_lens, inactive=inactive)
    j_out, (jk, jv) = fused_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(sl), jnp.asarray(wp),
        1, pages_per_chunk=2, interpret=True)
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
    kernels.kv_prefill_write(tk, tv, _t(rows_k), _t(rows_v), _t(bt), start,
                             n_tok, 1)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("start", [0, 24, 37])
def test_prefill_attention_twin_matches_pallas(start):
    """Kernel 3: a fresh chunk and continuation chunks (37 is not page
    aligned) over cached history; f32 atol 1e-4."""
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
    t = kernels.prefill_attention(_t(q), _t(kp), _t(vp), _t(bt), start, 1)
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
    t = kernels.prefill_attention(_t(q).to(tb), _t(kp).to(tb),
                                  _t(vp).to(tb), _t(bt), start, 1)
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
    """CPU tensors take the plain twins: no kernel launch is counted."""
    rng = np.random.default_rng(14)
    kp, vp = _pools(rng, P=8)
    before = dict(kernels.LAUNCHES)
    rows = _t(rng.standard_normal((4, GD)).astype(np.float32))
    kernels.kv_cache_write(_t(kp), _t(vp), rows, rows,
                           _t(np.array([1, 2, 3, 4], np.int32)),
                           _t(np.array([0, 1, 2, 3], np.int32)), 0)
    assert kernels.LAUNCHES == before
