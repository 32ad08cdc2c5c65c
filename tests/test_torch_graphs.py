"""The executor's static-buffer decode step (the body that the card
captures into a CUDA graph), its warmup and the capture-safe sampler, on
the CPU, where the same body runs eagerly.

- The step body called K times equals the pre-graph decode loop (kept
  below as the reference: fresh tensors a chunk, a Python slice for
  ``out``), ``decode_chunk`` and the JAX package's ``decode_chunk``,
  token for token on greedy rows (f32 weights, exact), over two chunks
  with an EOS latch and budgets 0..K.
- The body makes no host read and copies no host value to the device:
  ``item``, ``__bool__``, ``tolist``, ``cpu``, ``numpy``,
  ``torch.tensor`` and ``torch.as_tensor`` raise while it runs, on
  every decode route.
- ``warmup()`` leaves every pool page but page 0 bit-identical, sets
  ``step_ms`` within JAX's clamp and fills ``warmup_split``.
- The sampler without host scalars filters and draws exactly as the
  version with them did, from the same generator state.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402

from llmq_tpu_torch.engine.executor import (STEP_MS_RANGE,  # noqa: E402
                                            TorchExecutor)
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.ops import sampling  # noqa: E402
from llmq_tpu_torch.ops.sampling import sample_token  # noqa: E402

torch.set_num_threads(1)
KW = dict(dim=256, n_heads=4, n_kv_heads=2, vocab_size=512)
K = 4
GEOM = dict(batch_size=5, page_size=16, num_pages=64, prefill_buckets=[16, 32],
            chunk_size=K)
PROMPTS = [[5, 9, 13, 17, 21], [40, 41, 42], [7] * 9, [300, 200, 100, 50],
           [11, 12]]
HOST_READS = ("item", "__bool__", "tolist", "cpu", "numpy")


@pytest.fixture(scope="module")
def models():
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tables(B, MP):
    bt = np.zeros((B, MP), np.int32)
    for b in range(B):
        bt[b, :2] = [1 + 2 * b, 2 + 2 * b]
    return bt


def _prefilled(ex, bt):
    """Prefill PROMPTS row by row; returns (first tokens, positions)."""
    toks = [ex.prefill(p, 0, bt[b], 0.0, b) for b, p in enumerate(PROMPTS)]
    return (np.asarray(toks, np.int32),
            np.asarray([len(p) for p in PROMPTS], np.int32))


def _old_decode_chunk(ex, tokens, positions, bt, temps, budgets):
    """The executor's decode loop before the static buffers: fresh
    tensors a chunk, ``out[:, j]`` by a Python slice, the exit flag read
    with ``bool()`` one step behind."""
    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt)

    eos = ex.spec.eos_id
    B = len(tokens)
    st = {"tok": t(tokens, torch.int32), "pos": t(positions, torch.int32),
          "bt": t(bt, torch.int32), "temps": t(temps, torch.float32),
          "budgets": t(budgets, torch.int32),
          "out": torch.full((B, ex.chunk_size), eos, dtype=torch.int32),
          "frozen": torch.zeros(B, dtype=torch.bool)}
    steps = min(ex.chunk_size, int(np.max(budgets)))
    left_prev = None
    with torch.inference_mode():
        for j in range(steps):
            active = (~st["frozen"]) & (j < st["budgets"])
            logits = ex.model.forward_decode(st["tok"], st["pos"], ex.cache,
                                             st["bt"], active,
                                             fused=ex.fused_decode)
            nxt = sample_token(logits, ex._gen, temperature=st["temps"])
            st["out"][:, j] = torch.where(active, nxt,
                                          torch.full_like(nxt, eos))
            st["tok"] = torch.where(active, nxt, st["tok"])
            st["pos"] = st["pos"] + active.to(torch.int32)
            st["frozen"] = st["frozen"] | (active & (nxt == eos))
            left = ((~st["frozen"]) & (j + 1 < st["budgets"])).any()
            if left_prev is not None and not bool(left_prev):
                break
            left_prev = left
    return st["out"].numpy().copy()


def _body_chunk(ex, tokens, positions, bt, temps, budgets):
    """The static-buffer step body called K times, no exit test."""
    with torch.inference_mode():
        ex._fill(tokens, positions, bt, temps, budgets)
        for _ in range(ex.chunk_size):
            ex._step()
        return ex._out()


def _carry(out, tok, pos, budgets, eos):
    """The next chunk's inputs: a row that emitted EOS is done (budget
    0); a paused row goes on from its last real token."""
    tok, pos = tok.copy(), pos.copy()
    done = np.zeros(len(tok), bool)
    for b in range(len(tok)):
        real = out[b, :budgets[b]]
        if len(real):
            tok[b] = real[-1]
            pos[b] += len(real)
            done[b] = eos in real
    return tok, pos, done


@pytest.fixture(scope="module")
def eos(models):
    """An EOS id that row 0 emits at step 1 of a chunk from the prefilled
    state, so the latch fires mid-chunk (the greedy streams of an
    executor whose EOS is never sampled)."""
    _, _, tcfg, tparams = models
    ex = TorchExecutor(tcfg, tparams, device="cpu", eos_id=-1, **GEOM)
    bt = _tables(ex.spec.batch_size, ex.spec.max_pages_per_seq)
    tok, pos = _prefilled(ex, bt)
    out = ex.decode_chunk(tok, pos, bt, np.zeros(len(tok), np.float32),
                          np.full(len(tok), K, np.int32))
    assert out[0, 0] != out[0, 1]
    return int(out[0, 1])


@pytest.mark.parametrize("budgets", [[4, 0, 2, 3, 1], [1, 1, 1, 1, 1],
                                     [0, 4, 4, 4, 4], [0, 0, 0, 0, 0]])
def test_step_body_equals_old_loop_decode_chunk_and_jax(models, eos,
                                                        budgets):
    """Two chunks, the second carrying on from the first (rows that hit
    EOS get budget 0, the others K): the body K times, ``decode_chunk``
    and the pre-graph loop give JAX's tokens. Row 0 meets EOS in one of
    the two chunks whatever its first budget."""
    jcfg, jparams, tcfg, tparams = models
    jex = JaxExecutor(jcfg, jparams, prefill_batch=1, mixed_prefill_slices=0,
                      eos_id=eos, **GEOM)
    tex = {kind: TorchExecutor(tcfg, tparams, device="cpu", eos_id=eos,
                               **GEOM) for kind in ("body", "chunk", "old")}
    run = {"body": _body_chunk,
           "chunk": lambda ex, *a: ex.decode_chunk(*a),
           "old": _old_decode_chunk}
    B, MP = tex["body"].spec.batch_size, tex["body"].spec.max_pages_per_seq
    bt = _tables(B, MP)
    temps = np.zeros(B, np.float32)
    firsts = {kind: _prefilled(ex, bt) for kind, ex in tex.items()}
    tok, pos = _prefilled(jex, bt)
    for kind in tex:
        np.testing.assert_array_equal(firsts[kind][0], tok)
    budgets = np.asarray(budgets, np.int32)
    latched = np.zeros(B, bool)
    for chunk in range(2):
        want = np.asarray(jex.decode_chunk(tok, pos, bt, temps, budgets))
        for kind, ex in tex.items():
            got = run[kind](ex, tok, pos, bt, temps, budgets)
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} "
                                          f"chunk {chunk}")
        tok, pos, done = _carry(want, tok, pos, budgets, eos)
        latched |= done
        budgets = np.where(latched, 0, K).astype(np.int32)
    assert latched[0]


def test_decode_is_the_step_with_budget_one(models):
    """``decode`` (the step with a budget of 1) gives the first column of
    a one-step chunk and of the pre-graph loop."""
    _, _, tcfg, tparams = models
    B = GEOM["batch_size"]
    ones = np.ones(B, np.int32)
    calls = [lambda ex, *a: ex.decode(*a),
             lambda ex, *a: ex.decode_chunk(*a, ones)[:, 0],
             lambda ex, *a: _old_decode_chunk(ex, *a, ones)[:, 0]]
    outs = []
    for call in calls:
        ex = TorchExecutor(tcfg, tparams, device="cpu", **GEOM)
        bt = _tables(B, ex.spec.max_pages_per_seq)
        tok, pos = _prefilled(ex, bt)
        outs.append(call(ex, tok, pos, bt, np.zeros(B, np.float32)))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_exit_test_reads_each_flag_one_step_behind(models, eos, monkeypatch):
    """Step j-1's flag is read only after step j is queued. Row 0 (budget
    4) meets EOS at step 1, the others have budget 1: steps 0 and 1 are
    real, step 2 is queued before the host learns that no row is left,
    and it writes nothing outside page 0 and emits only EOS."""
    _, _, tcfg, tparams = models
    ex = TorchExecutor(tcfg, tparams, device="cpu", eos_id=eos, **GEOM)
    B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
    bt = _tables(B, MP)
    tok, pos = _prefilled(ex, bt)
    order = []
    run_step, left_after = ex._run_step, ex._left_after
    monkeypatch.setattr(ex, "_run_step",
                        lambda eager: (order.append("step"),
                                       run_step(eager))[1])
    monkeypatch.setattr(ex, "_left_after",
                        lambda j: (order.append(f"read {j}"),
                                   left_after(j))[1])
    temps = np.zeros(B, np.float32)
    budgets = np.array([4, 1, 1, 1, 1], np.int32)
    out = ex.decode_chunk(tok, pos, bt, temps, budgets)
    assert order == ["step", "step", "read 0", "step", "read 1"]
    assert out[0, 1] == eos and (out[:, 2:] == eos).all()
    # The same two real steps without the extra one: budgets of 2 and 1.
    ref = TorchExecutor(tcfg, tparams, device="cpu", eos_id=eos, **GEOM)
    _prefilled(ref, bt)
    ref_out = ref.decode_chunk(tok, pos, bt, temps,
                               np.array([2, 1, 1, 1, 1], np.int32))
    np.testing.assert_array_equal(out, ref_out)
    for k, v in ex.cache.items():
        assert torch.equal(ref.cache[k][:, 1:], v[:, 1:]), k


@pytest.mark.parametrize("route", ["fused", "split", "int8_kv",
                                   "int8_weights_int8_kv"])
def test_step_body_makes_no_host_read(models, route, monkeypatch):
    """The body the card captures reads nothing back to the host and
    makes no tensor from host data (a copy to the device, which capture
    refuses): each such call raises while it runs, and it still
    decodes."""
    from llmq_tpu_torch.ops.quant import quantize_params

    _, _, tcfg, tparams = models
    kw = dict(GEOM)
    if route == "split":
        kw["fused_decode"] = False
    if route.endswith("int8_kv"):
        kw["cache_dtype"] = torch.int8
    if route.startswith("int8_weights"):
        tparams = quantize_params(tparams)
    ex = TorchExecutor(tcfg, tparams, device="cpu", **kw)
    B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
    bt = _tables(B, MP)
    tok, pos = _prefilled(ex, bt)
    with torch.inference_mode():
        ex._fill(tok, pos, bt, np.full(B, 0.7, np.float32),
                 np.full(B, K, np.int32))

    def host_read(*_a, **_k):
        raise AssertionError("host read inside the decode step")

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, host_read)
    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, host_read)
    with torch.inference_mode():
        for _ in range(K):
            ex._step()
    monkeypatch.undo()
    out = ex._out()
    assert out.shape == (B, K) and (out >= 0).all()
    assert int(ex._buf.j[0]) == K


def _warm_executor(tcfg, tparams, mode):
    kw = dict(GEOM, mixed_prefill_slices=2, mixed_slice_tokens=8)
    if mode == "ragged":
        kw.update(ragged_attention=True, ragged_token_capacity=16,
                  ragged_max_slices=2)
    if mode == "int8_kv":
        kw["cache_dtype"] = torch.int8
    return TorchExecutor(tcfg, tparams, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["bucket", "ragged", "int8_kv"])
def test_warmup_writes_page_zero_only(models, mode):
    _, _, tcfg, tparams = models
    ex = _warm_executor(tcfg, tparams, mode)
    B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
    _prefilled(ex, _tables(B, MP))
    before = {k: v.clone() for k, v in ex.cache.items()}
    ex.warmup()
    for k, v in ex.cache.items():
        assert torch.equal(v[:, 1:], before[k][:, 1:]), k
    assert any(not torch.equal(v[:, 0], before[k][:, 0])
               for k, v in ex.cache.items())


@pytest.mark.parametrize("mode", ["bucket", "ragged", "int8_kv"])
def test_warmup_calibrates_step_ms_and_splits_its_time(models, mode):
    _, _, tcfg, tparams = models
    ex = _warm_executor(tcfg, tparams, mode)
    ex.warmup()
    lo, hi = STEP_MS_RANGE
    assert ex.step_ms is not None and lo <= ex.step_ms <= hi
    assert set(ex.warmup_split) == {"capture", "warmup"}
    assert ex.warmup_split["warmup"] > 0
    assert ex.warmup_split["capture"] >= 0     # no graph on the CPU
    assert ex.step_graphs == {} and ex.graph_replays == 0
    # The moving average carries on from the calibrated value.
    cal = ex.step_ms
    B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
    z = np.zeros(B, np.int32)
    ex.decode_chunk(z, z, np.zeros((B, MP), np.int32),
                    np.zeros(B, np.float32), np.full(B, 2, np.int32))
    assert ex.step_ms != cal


def test_build_engine_with_warmup_serves():
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.engine.builder import build_engine

    cfg = Config()
    cfg.model.name = "llama3-tiny"
    cfg.device = "cpu"
    cfg.executor.kv_pages = 64
    cfg.executor.prefill_buckets = [16, 64]
    cfg.executor.decode_chunk = 4
    eng = build_engine(cfg, warmup=True, device="cpu")
    ex = eng.executor
    assert set(ex.warmup_split) == {"capture", "warmup"}
    assert ex.step_ms is not None
    eng.start()
    try:
        res = eng.generate("warmed up and serving", max_new_tokens=6,
                           timeout=60)
    finally:
        eng.stop()
    assert res.finish_reason in ("eos", "length")
    assert 1 <= len(res.tokens) <= 6


def test_fill_rejects_another_geometry(models):
    _, _, tcfg, tparams = models
    ex = TorchExecutor(tcfg, tparams, device="cpu", **GEOM)
    z = np.zeros(3, np.int32)
    with pytest.raises(ValueError, match="tok"):
        ex.decode_chunk(z, z, np.zeros((3, ex.spec.max_pages_per_seq),
                                       np.int32), np.zeros(3, np.float32), z)


# -- the sampler without host scalars -----------------------------------------

def _old_filter(logits, temperature, top_k, top_p):
    """``_filter_logits`` before the change: the temperature through
    ``as_tensor`` and -inf as a device scalar made per call."""
    B, V = logits.shape
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device).expand(B)
    lf = logits.float()
    scaled = lf / torch.clamp(t[:, None], min=1e-6)
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k and top_k < V:
        kth = torch.sort(scaled, dim=-1).values[:, V - top_k][:, None]
        scaled = torch.where(scaled < kth, neg_inf, scaled)
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1)
        cutoff_logit = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        scaled = torch.where(scaled < cutoff_logit, neg_inf, scaled)
    return t, lf, scaled


def _old_sample(logits, gen, temperature, top_k, top_p):
    t, lf, scaled = _old_filter(logits, temperature, top_k, top_p)
    probs = torch.softmax(scaled, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.where(t <= 0.0, torch.argmax(lf, dim=-1).to(torch.int32),
                       sampled.to(torch.int32))


FILTERS = [(0, 1.0), (5, 1.0), (0, 0.8), (7, 0.9)]


@pytest.mark.parametrize("top_k,top_p", FILTERS)
def test_sampler_filters_as_before(top_k, top_p):
    rng = np.random.default_rng(top_k + int(10 * top_p))
    logits = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    temps = torch.tensor([0.0, 0.5, 1.0, 1.7])
    for temperature in (temps, 0.8, 0.0):
        old = _old_filter(logits, temperature, top_k, top_p)
        new = sampling._filter_logits(logits, temperature, top_k, top_p)
        for a, b in zip(old, new):
            assert torch.equal(a, b)


@pytest.mark.parametrize("top_k,top_p", FILTERS)
def test_sampler_draws_as_before(top_k, top_p):
    """From the same generator state the sampler draws the tokens the
    host-scalar version drew; T=0 rows stay greedy."""
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    temps = torch.tensor([0.0, 0.5, 1.0, 1.7])
    g_old = torch.Generator().manual_seed(3)
    g_new = torch.Generator().manual_seed(3)
    for _ in range(20):
        old = _old_sample(logits, g_old, temps, top_k, top_p)
        new = sample_token(logits, g_new, temperature=temps, top_k=top_k,
                           top_p=top_p)
        assert torch.equal(old, new)
        assert int(new[0]) == int(logits[0].argmax())


def test_sampler_float_temperature_is_a_device_fill():
    """A Python float temperature gives what the same value as a tensor
    gives, and no tensor is made from host data on the way."""
    logits = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    a = sample_token(logits, torch.Generator().manual_seed(5),
                     temperature=0.9, top_k=8)
    b = sample_token(logits, torch.Generator().manual_seed(5),
                     temperature=torch.full((3,), 0.9), top_k=8)
    assert torch.equal(a, b)


# -- prefill programs and the mixed step 0 -------------------------------------

PF_GEOM = dict(GEOM, mixed_prefill_slices=2, mixed_slice_tokens=8,
               ragged_token_capacity=16, ragged_max_slices=2)


def _pf_executor(tcfg, tparams, kv, ragged=False):
    return TorchExecutor(tcfg, tparams, device="cpu", ragged_attention=ragged,
                         cache_dtype=torch.int8 if kv == "int8" else None,
                         **PF_GEOM)


def _trap(monkeypatch):
    def host_read(*_a, **_k):
        raise AssertionError("host read inside a captured program")

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, host_read)
    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, host_read)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("program", ["prefill_n1", "prefill_n4",
                                     "mixed_step0", "ragged_step0"])
def test_prefill_bodies_make_no_host_read(models, program, kv, monkeypatch):
    """The bodies the card captures as the prefill programs (one row and
    a wave of four), the bucket mixed step 0 and the ragged step 0 read
    nothing back to the host and make no tensor from host data, over the
    model-dtype pools and over int8 pools: each such call raises while
    they run, and they still sample a token per row."""
    _, _, tcfg, tparams = models
    ex = _pf_executor(tcfg, tparams, kv, ragged=program == "ragged_step0")
    B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
    bt = _tables(B, MP)
    reqs = [(p[:5], 0, bt[b], 0.0) for b, p in enumerate(PROMPTS[:4])]
    with torch.inference_mode():
        if program.startswith("prefill"):
            rows = 1 if program == "prefill_n1" else 4
            p = ex._program("prefill_b16", ex._rows_shapes(rows, 16))
            ex._stage_inputs(p, lambda v: ex._fill_rows(v, reqs[:rows]))
            body = ex._prefill_body
        else:
            tok, pos = _prefilled(ex, bt)
            ex._fill(tok, pos, bt, np.zeros(B, np.float32),
                     np.full(B, K, np.int32))
            _name, p = ex._step0_program()
            ex._stage_step0(p, [([3, 4, 5], 0, bt[4], 0.0)])
            body = ex._step0_body
    _trap(monkeypatch)
    with torch.inference_mode():
        out = body(p)
    monkeypatch.undo()
    assert out.dtype == torch.int32 and (out >= 0).all()
    if program == "prefill_n4":
        assert out.shape == (4,)


def test_later_waves_do_not_overwrite_unresolved_handles(models):
    """More waves than the result ring has slots, none fetched until the
    end: every handle still reads its own wave's token (the slot a wave
    comes round to is fetched first), equal to a synchronous prefill of
    the same chunk."""
    from llmq_tpu_torch.engine.executor import RESULT_RING

    _, _, tcfg, tparams = models
    ex = _pf_executor(tcfg, tparams, "bf16")
    ref = _pf_executor(tcfg, tparams, "bf16")
    MP = ex.spec.max_pages_per_seq
    bt = np.zeros(MP, np.int32)
    bt[:2] = [1, 2]
    rng = np.random.default_rng(5)
    chunks = [[int(x) for x in rng.integers(3, 500, 1 + i % 7)]
              for i in range(RESULT_RING + 3)]
    handles = [ex.prefill_async(c, 0, bt, 0.0) for c in chunks]
    want = [ref.prefill(c, 0, bt, 0.0, 0) for c in chunks]
    assert list(ex.gather_scalars(handles)) == want
    assert len(set(want)) > 1


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: a replay runs
    the captured body again and writes its result into the captured
    output, as a replay rewrites the graph's static output."""

    def __init__(self):
        self.body = self.out = None

    def register_generator_state(self, _gen):
        pass

    def replay(self):
        res = self.body()
        if self.out is not None:
            self.out.copy_(res)


class _FakeEvent:
    def __init__(self, *_a, **_k):
        pass

    def record(self, *_a):
        pass

    def synchronize(self):
        pass


class _FakeStream(_FakeEvent):
    def wait_stream(self, _s):
        pass


@pytest.mark.parametrize("mode", ["bucket", "ragged"])
def test_program_graph_control_flow_with_fake_graphs(models, mode,
                                                     monkeypatch):
    """The card's capture-and-replay control flow of the prefill
    programs and the mixed step 0, rehearsed on the CPU with fakes for
    the CUDA graph, stream and event calls (a fake replay reruns the
    body into the captured output): warmup, a wave, a single chunk, a
    continuation and a mixed chunk give the eager executor's tokens and
    pools, each call one replay of its program, and the capture's launch
    accounting and input save/restore leave nothing behind."""
    import contextlib

    from llmq_tpu_torch.engine import executor as E

    _, _, tcfg, tparams = models

    @contextlib.contextmanager
    def ctx(*_a, **_k):
        yield

    real = E.TorchExecutor._capture

    def capture(self, body, pool):
        g = real(self, body, pool)
        g.graph.body, g.graph.out = body, g.out
        return g

    zeros = torch.zeros
    for name, val in (("CUDAGraph", _FakeGraph), ("graph", ctx),
                      ("Stream", _FakeStream), ("stream", ctx),
                      ("current_stream", lambda *_a: _FakeStream()),
                      ("synchronize", lambda *_a: None),
                      ("empty_cache", lambda: None),
                      ("memory_reserved", lambda *_a: 0),
                      ("graph_pool_handle", lambda: object()),
                      ("Event", _FakeEvent)):
        monkeypatch.setattr(torch.cuda, name, val)
    monkeypatch.setattr(E.TorchExecutor, "_capture", capture)
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, pin_memory=False, **k: zeros(*a, **k))
    runs = []
    for graphs in (False, True):
        ex = _pf_executor(tcfg, tparams, "bf16", ragged=mode == "ragged")
        if graphs:
            ex._graphs_on = True
            ex._left_events = [_FakeEvent() for _ in range(ex.chunk_size)]
        ex.warmup()
        B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
        bt = _tables(B, MP)
        reqs = [(p, 0, bt[b], 0.0) for b, p in enumerate(PROMPTS[:3])]
        hs = ex.prefill_multi_async(reqs)
        hs.append(ex.prefill_async(PROMPTS[3], 0, bt[3], 0.0))
        first = ex.gather_scalars(hs)
        pos = np.array([len(p) for p in PROMPTS[:4]] + [0], np.int32)
        tok = np.append(first, 0).astype(np.int32)
        replays = dict(ex.program_replays)
        out, pf_first = ex.mixed_chunk(
            tok, pos, bt, np.zeros(B, np.float32),
            np.array([K, K, 2, 0, 0], np.int32),
            [(4, [11, 12, 13, 14, 15], 0, bt[4], 0.0)])
        cont = ex.gather_scalars([ex.prefill_async([16, 17], 5, bt[4], 0.0)])
        runs.append((first, out, pf_first, cont, ex, replays))
    (*eager, e_ex, _), (*graph, g_ex, replays) = runs
    for a, b in zip(eager, graph):
        np.testing.assert_array_equal(a, b)
    for k in e_ex.cache:
        assert torch.equal(e_ex.cache[k][:, 1:], g_ex.cache[k][:, 1:]), k
    assert g_ex.program_graphs and g_ex.step_graphs
    assert set(g_ex.program_replays) == set(g_ex.program_graphs)
    if mode == "bucket":
        # Warmup replays each program once; the wave and the single chunk
        # are one replay each, and the mixed step 0 one.
        assert replays["prefill_multi_b16"] == 2
        assert replays["prefill_b16"] == 2
        assert g_ex.program_replays["mixed_step0_fused"] == 2
    assert all(n > 0 for n in g_ex.program_replays.values())
