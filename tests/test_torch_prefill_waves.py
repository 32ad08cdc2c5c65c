"""The port's prefill waves against the JAX package on the CPU (f32
weights, tiny model: H=4, H_kv=2, D=64, 2 layers; inputs from numpy
seeds).

- ``TorchExecutor.prefill_multi_async`` against
  ``JaxExecutor.prefill_multi_async``: waves of 4, 2 and 1 prompts that
  cross the bucket edge, with continuation chunks over cached history,
  on the bucket and the ragged route, over f32 and int8 pools. Greedy
  first tokens equal; pools within 1e-5, the null page aside; int8 pools
  and their scales bit-exact in layer 0, and deeper within one int8 step
  (one bf16 step for a scale) at under one value in 10^4.
- The batched twins of kernels 2 and 3 (one call for every row, starts
  and lengths as tensors) against the per-row Pallas kernels run in
  interpret mode: pools bit-exact, attention within 1e-4, rows past a
  length zero.
- The port's engine with ``prefill_batch`` 1 and 4 against the JAX
  engine (``prefill_batch`` 4): a burst of five prompts on an idle
  engine (a wave of four and a trailing single one), arrivals while
  others decode and a two-turn conversation, with mixed batching off,
  on (bucket) and ragged. Greedy streams, finish reasons and cached
  counts equal.
- ``_resolve_prefills`` completes a wave with one ``gather_scalars``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.core.config import MixedBatchConfig as JMixed  # noqa: E402
from llmq_tpu.core.types import Priority as JPriority  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402

from llmq_tpu_torch.core.config import MixedBatchConfig  # noqa: E402
from llmq_tpu_torch.core.types import Priority  # noqa: E402
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.ops import kernels  # noqa: E402

torch.set_num_threads(1)
KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512)
GEOM = dict(batch_size=4, page_size=16, num_pages=64, prefill_buckets=[16, 32],
            eos_id=2, chunk_size=4, mixed_prefill_slices=2,
            mixed_slice_tokens=8, ragged_token_capacity=16,
            ragged_max_slices=2)
F32_ATOL = 1e-5
MAX_STEPS = 10


@pytest.fixture(scope="module")
def models():
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _waves(MP):
    """Three waves (4, 2 and 1 prompts): lengths 5, 16, 17 and 31 across
    the 16-token bucket edge; then prompt 0 continued at 5 with a fresh
    12-token prompt; then prompt 3 continued at 31 across a page edge.
    Each: (tokens, start, block table row, temperature)."""
    rng = np.random.default_rng(3)
    bt = np.zeros((5, MP), np.int32)
    for b in range(5):
        bt[b, :3] = [1 + 3 * b, 2 + 3 * b, 3 + 3 * b]

    def toks(n):
        return [int(x) for x in rng.integers(3, 500, n)]

    return [[(toks(n), 0, bt[i], 0.0) for i, n in enumerate((5, 16, 17, 31))],
            [(toks(9), 5, bt[0], 0.0), (toks(12), 0, bt[4], 0.0)],
            [(toks(3), 31, bt[3], 0.0)]]


def _pool_arrays(cache):
    out = {}
    for k, v in cache.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.float().numpy() if v.dtype != torch.int8 else v.numpy()
        else:
            a = np.asarray(v)
            out[k] = a if a.dtype == np.int8 else a.astype(np.float32)
    return out


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["bucket", "ragged"])
def test_prefill_multi_async_matches_jax(models, mode, kv):
    """Greedy first tokens of each wave equal the JAX executor's; the
    pools agree page for page (int8: see the module docstring)."""
    jcfg, jparams, tcfg, tparams = models
    ragged = mode == "ragged"
    jex = JaxExecutor(jcfg, jparams, ragged_attention=ragged,
                      cache_dtype=jnp.int8 if kv == "int8" else None, **GEOM)
    tex = TorchExecutor(tcfg, tparams, device="cpu", ragged_attention=ragged,
                        cache_dtype=torch.int8 if kv == "int8" else None,
                        **GEOM)
    assert tex.prefill_batch == jex.prefill_batch == 4
    for wave in _waves(tex.spec.max_pages_per_seq):
        j = jex.gather_scalars(jex.prefill_multi_async(wave))
        t = tex.gather_scalars(tex.prefill_multi_async(wave))
        np.testing.assert_array_equal(t, j)
    jp, tp = _pool_arrays(jex.cache), _pool_arrays(tex.cache)
    assert set(jp) == set(tp)
    for k in jp:
        if kv == "f32":
            np.testing.assert_allclose(tp[k][:, 1:], jp[k][:, 1:],
                                       atol=F32_ATOL, err_msg=k)
            continue
        # Layer 0 quantizes the same inputs: bit-exact. Deeper layers
        # quantize f32 activations that the two packages sum in other
        # orders, so a value one ulp apart may round to the neighbouring
        # int8 step (a scale to the neighbouring bf16 value).
        np.testing.assert_array_equal(tp[k][0, 1:], jp[k][0, 1:], k)
        diff = np.abs(tp[k][1:, 1:].astype(np.float32)
                      - jp[k][1:, 1:].astype(np.float32))
        if k in ("k", "v"):
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-4, k
        else:
            np.testing.assert_allclose(tp[k][1:, 1:], jp[k][1:, 1:],
                                       rtol=2 ** -7, err_msg=k)


def test_prefill_async_and_sync_prefill_agree(models):
    """``prefill`` (the async path plus one fetch) and ``prefill_async``
    per chunk give the same tokens as one wave of the same prompts."""
    _, _, tcfg, tparams = models
    wave = _waves(128)[0]
    a = TorchExecutor(tcfg, tparams, device="cpu", **GEOM)
    b = TorchExecutor(tcfg, tparams, device="cpu", **GEOM)
    c = TorchExecutor(tcfg, tparams, device="cpu", **GEOM)
    multi = a.gather_scalars(a.prefill_multi_async(wave))
    single = b.gather_scalars([b.prefill_async(*r) for r in wave])
    sync = [c.prefill(t, sp, bt, temp, 0) for t, sp, bt, temp in wave]
    np.testing.assert_array_equal(multi, single)
    np.testing.assert_array_equal(multi, sync)


# -- batched kernel twins against the per-row Pallas kernels ------------------

H, HKV, D, PS = 4, 2, 64, 16
GD = HKV * D


def _desc(*cols):
    return [torch.tensor(c, dtype=torch.int32) for c in cols]


@pytest.mark.parametrize("starts,lengths", [([0, 5, 19, 0], [32, 20, 1, 1]),
                                            ([13, 37, 0, 2], [7, 27, 32, 30])])
def test_batched_write_twin_matches_pallas_rows(starts, lengths):
    """Kernel 2's twin writes every row of a (4, 32) batch in one call:
    the pools equal the per-row Pallas kernel's, page 0 aside (the last
    row of the first case is an unused row, one token on the null
    page)."""
    from llmq_tpu.ops.pallas.kv_write import kv_prefill_write_pallas

    rng = np.random.default_rng(sum(starts) + sum(lengths))
    kp = rng.standard_normal((2, 24, PS, GD)).astype(np.float32)
    vp = rng.standard_normal((2, 24, PS, GD)).astype(np.float32)
    N, Tb, mp = 4, 32, 5
    perm = rng.permutation(np.arange(1, 24)).astype(np.int32)
    bt = np.zeros((N, mp), np.int32)
    for i in range(N):
        if not (lengths[i] == 1 and starts[i] == 0 and i == N - 1):
            bt[i] = perm[i * mp % 20:i * mp % 20 + mp]
    rows_k = rng.standard_normal((N * Tb, GD)).astype(np.float32)
    rows_v = rng.standard_normal((N * Tb, GD)).astype(np.float32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    for i in range(N):
        if not bt[i].any():
            continue
        n_wp = Tb // PS + 1
        ak = np.zeros((n_wp * PS, GD), np.float32)
        av = np.zeros((n_wp * PS, GD), np.float32)
        off = starts[i] % PS
        ak[off:off + lengths[i]] = rows_k[i * Tb:i * Tb + lengths[i]]
        av[off:off + lengths[i]] = rows_v[i * Tb:i * Tb + lengths[i]]
        jk, jv = kv_prefill_write_pallas(
            jk, jv, jnp.asarray(ak), jnp.asarray(av), jnp.asarray(bt[i]),
            jnp.int32(starts[i]), jnp.int32(lengths[i]), 1, interpret=True)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    before = dict(kernels.LAUNCHES)
    kernels.kv_prefill_write(tk, tv, torch.from_numpy(rows_k),
                             torch.from_numpy(rows_v), torch.from_numpy(bt),
                             *_desc([i * Tb for i in range(N)], lengths,
                                    starts), Tb, 1)
    assert kernels.LAUNCHES == before          # the CPU takes the twin
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])


@pytest.mark.parametrize("starts,lengths", [([0, 24, 37, 0], [16, 9, 16, 1]),
                                            ([64, 0, 5, 11], [3, 16, 12, 16])])
def test_batched_attention_twin_matches_pallas_rows(starts, lengths):
    """Kernel 3's twin over a (4, 16) batch in one call against the
    per-row Pallas kernel (fresh rows and rows over history): live rows
    within 1e-4, rows past each length zero."""
    from llmq_tpu.ops.pallas.prefill_attention import (
        paged_prefill_attention_pallas)

    rng = np.random.default_rng(sum(starts) * 3 + sum(lengths))
    kp = rng.standard_normal((2, 32, PS, GD)).astype(np.float32)
    vp = rng.standard_normal((2, 32, PS, GD)).astype(np.float32)
    N, Tb, mp = 4, 16, 6
    bt = np.stack([rng.permutation(np.arange(1, 32))[:mp]
                   for _ in range(N)]).astype(np.int32)
    q = rng.standard_normal((N, Tb, H, D)).astype(np.float32)
    t = kernels.prefill_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                  torch.from_numpy(vp), torch.from_numpy(bt),
                                  *_desc(starts, lengths), 1).numpy()
    for i in range(N):
        j = paged_prefill_attention_pallas(
            jnp.asarray(q[i]), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt[i]), jnp.int32(starts[i]), 1, pages_per_chunk=2,
            q_block=8, interpret=True)
        n = lengths[i]
        np.testing.assert_allclose(t[i, :n], np.asarray(j)[:n], atol=1e-4)
        assert np.all(t[i, n:] == 0)


# -- engine streams: prefill_batch 1 and 4 against the JAX engine --------------

BURST = ["burst one", "burst two is a little longer than the first",
         "burst three: " + "x" * 40, "four", "five, the trailing single one"]
LATER = [("arrives while the burst decodes", "high"),
         ("another arrival, somewhat longer than that one", "low")]


def _workload(submit, step, run_until_idle, make_req):
    """Five prompts at once on an idle engine (one longer than the
    largest bucket), arrivals two steps apart while they decode, then a
    two-turn conversation."""
    hs = {}
    for i, text in enumerate(BURST):
        hs[f"b{i}"] = submit(make_req(f"b{i}", text, "normal", ""))
    step()
    step()
    for i, (text, prio) in enumerate(LATER):
        hs[f"a{i}"] = submit(make_req(f"a{i}", text, prio, ""))
        step()
        step()
    run_until_idle()
    for turn, text in enumerate(("Hello there, conversation.",
                                 " And a second turn.")):
        hs[f"t{turn}"] = submit(make_req(f"t{turn}", text, "high", "c1"))
        run_until_idle()
    return {rid: h.result for rid, h in hs.items()}


def _mixed_settings(mode):
    return dict(enabled=mode != "unfused", prefill_token_budget=16,
                max_slices=2)


@pytest.fixture(scope="module")
def jax_runs(models):
    jcfg, jparams, _, _ = models
    runs = {}
    for mode in ("unfused", "bucket", "ragged"):
        jeng = JEngine(JaxExecutor(jcfg, jparams, prefill_batch=4,
                                   ragged_attention=mode == "ragged",
                                   **GEOM),
                       JTok(), enable_metrics=False,
                       max_decode_steps=MAX_STEPS,
                       mixed_batch=JMixed(**_mixed_settings(mode)))
        runs[mode] = _workload(
            jeng.submit, jeng.step, jeng.run_until_idle,
            lambda rid, text, prio, conv: JGenRequest(
                id=rid, prompt=text, priority=JPriority.from_name(prio),
                conversation_id=conv, max_new_tokens=8))
    return runs


@pytest.mark.parametrize("prefill_batch", [1, 4])
@pytest.mark.parametrize("mode", ["unfused", "bucket", "ragged"])
def test_engine_streams_match_jax_waves(models, jax_runs, mode,
                                        prefill_batch):
    """The port's engine with waves of ``prefill_batch`` gives the JAX
    engine's (waves of 4) greedy streams, finish reasons and cached
    counts; with waves of 4 and no ragged route the burst ran as one
    ``prefill_multi_async`` wave of four and a single chunk."""
    _, _, tcfg, tparams = models
    tex = TorchExecutor(tcfg, tparams, device="cpu",
                        ragged_attention=mode == "ragged",
                        prefill_batch=prefill_batch, **GEOM)
    waves = []
    multi = tex.prefill_multi_async
    tex.prefill_multi_async = lambda reqs: (waves.append(len(reqs)),
                                            multi(reqs))[1]
    teng = InferenceEngine(tex, ByteTokenizer(), max_decode_steps=MAX_STEPS,
                           mixed_batch=MixedBatchConfig(
                               **_mixed_settings(mode)))
    tres = _workload(
        teng.submit, teng.step, teng.run_until_idle,
        lambda rid, text, prio, conv: GenRequest(
            id=rid, prompt=text, priority=Priority.from_name(prio),
            conversation_id=conv, max_new_tokens=8))
    jres = jax_runs[mode]
    assert set(tres) == set(jres)
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert tres[rid].finish_reason == jres[rid].finish_reason, rid
        assert tres[rid].cached_tokens == jres[rid].cached_tokens, rid
    assert tres["t1"].cached_tokens > 0
    if prefill_batch == 1:
        assert not waves
    elif mode != "ragged":
        assert waves[0] == 4
    assert teng.allocator.used() == teng.allocator.pinned_pages()


def test_resolve_completes_a_wave_in_one_gather(models):
    """Four prompts on an idle engine: one step dispatches them as one
    wave program, runs its decode chunk (none decodes yet), then fetches
    the four first tokens with ONE ``gather_scalars`` and completes the
    four admissions."""
    _, _, tcfg, tparams = models
    tex = TorchExecutor(tcfg, tparams, device="cpu", **GEOM)
    calls = {"multi": [], "gather": []}
    multi, gather = tex.prefill_multi_async, tex.gather_scalars
    tex.prefill_multi_async = lambda reqs: (calls["multi"].append(len(reqs)),
                                            multi(reqs))[1]
    tex.gather_scalars = lambda hs: (calls["gather"].append(len(hs)),
                                     gather(hs))[1]
    teng = InferenceEngine(tex, ByteTokenizer(), max_decode_steps=MAX_STEPS)
    hs = [teng.submit(GenRequest(id=f"r{i}", prompt=f"prompt number {i}",
                                 max_new_tokens=4)) for i in range(4)]
    assert teng.step()
    assert calls == {"multi": [4], "gather": [4]}
    assert all("prefill_done" in h.marks for h in hs)
    assert all(s is not None and s.prefilled and s.first_handle is None
               for s in teng._slots)
    teng.run_until_idle()
    assert all(h.result.finish_reason in ("eos", "length") for h in hs)
