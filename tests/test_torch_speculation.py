"""The port's speculation plane against the JAX package's, on the CPU
(llama3-tiny in f32, both packages on the same weights through
``params_from_jax``; the port's bodies run eagerly, as its plain twins).

- The n-gram drafter and the host accept rule against JAX's, on seeded
  random and repetitive contexts and arrays (exact).
- ``forward_verify`` against JAX's: logits within 1e-5, pools within
  1e-5.
- Verify windows in both accept modes against ``JaxExecutor.verify_chunk``
  (greedy: tokens and ``n_commit`` exact), and against the port's own
  plain decode chunk: the window that feeds the chunk's tokens as drafts
  commits all of them, and its KV equals the chunk's bit for bit.
- The KV rollback probe of ``tests/test_speculation.py``
  (``TestJaxKVIntegrity``): garbage drafts commit one token a window,
  the stream equals sequential decode, and the committed KV is bitwise
  intact; after every reconcile a row holds exactly the pages of its
  committed positions.
- The engine: greedy streams with speculation on equal those with it off
  (and JAX's), in both accept modes, with the async pipeline and without
  it, over a wave with a REALTIME preemption and a two-turn
  conversation; the speculation stats equal the JAX engine's on the same
  wave. At temperature 0.8 the port's streams are the same across
  ``draft_k`` 1 and 3 and both accept modes. With mixed batching on (the
  serving default) prefill runs between windows.
- The keyed sampler draws a small vocabulary in proportion to softmax
  (chi-squared), and its bodies read nothing back to the host.
- Usage-ledger and critical-path conservation through verify windows
  within 2%.
- The off-switch: no verify entry point, no stats block.
"""

import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from llmq_tpu.core.config import AsyncPipelineConfig as JPipe  # noqa: E402
from llmq_tpu.core.config import SpeculationConfig as JSpec  # noqa: E402
from llmq_tpu.core.types import Priority as JPriority  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.executor import \
    verify_host_ncommit as j_ncommit  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu.speculation import NgramDrafter as JDrafter  # noqa: E402
from llmq_tpu.speculation import propose_ngram as j_propose  # noqa: E402

from llmq_tpu_torch.core.config import (AsyncPipelineConfig,  # noqa: E402
                                        MixedBatchConfig, SpeculationConfig)
from llmq_tpu_torch.core.types import Priority  # noqa: E402
from llmq_tpu_torch.engine import executor as E  # noqa: E402
from llmq_tpu_torch.engine.engine import (GenRequest,  # noqa: E402
                                          InferenceEngine)
from llmq_tpu_torch.engine.executor import (TorchExecutor,  # noqa: E402
                                            verify_host_ncommit)
from llmq_tpu_torch.engine.kv_allocator import PageAllocator  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.ops.sampling import sample_token_keyed  # noqa: E402
from llmq_tpu_torch.speculation import NgramDrafter, propose_ngram  # noqa: E402

pytestmark = [pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")]

torch.set_num_threads(1)
KW = dict(max_seq_len=256, vocab_size=512)
EOS = ByteTokenizer().eos_id


@pytest.fixture(scope="module")
def models():
    jcfg = J.get_config("llama3-tiny", dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.get_config("llama3-tiny", dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


# -- the drafter and the accept rule -----------------------------------------

def _contexts():
    rng = np.random.default_rng(0)
    out = []
    for i in range(40):
        n = int(rng.integers(0, 40))
        vocab = 4 if i % 2 else 50          # repetitive, then sparse
        out.append([int(x) for x in rng.integers(0, vocab, n)])
    out.append([1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3])
    out.append([8, 9, 5, 2, 9, 7, 1, 2, 9])
    return out


@pytest.mark.parametrize("k", [0, 1, 3, 8])
@pytest.mark.parametrize("ngram_max", [1, 2, 3, 5])
def test_drafter_proposes_as_jaxs(k, ngram_max):
    """Tolerance: none. ``propose_ngram`` and the drafter facade (caps,
    counters, a failure degrading to no proposal) are JAX's."""
    td, jd = NgramDrafter(max(1, k), ngram_max), JDrafter(max(1, k),
                                                          ngram_max)
    for ctx in _contexts():
        assert propose_ngram(ctx, k, ngram_max) == j_propose(ctx, k,
                                                             ngram_max)
        assert td.propose(ctx) == jd.propose(ctx)
        assert td.propose(ctx, 2) == jd.propose(ctx, 2)
    assert td.propose(None) == jd.propose(None) == []
    assert (td.windows_drafted, td.windows_empty) == (jd.windows_drafted,
                                                      jd.windows_empty)


@pytest.mark.parametrize("seed", range(4))
def test_host_accept_rule_is_jaxs(seed):
    """Tolerance: none. Seeded windows whose samples follow their drafts
    for a random run, with EOS and inactive rows among them."""
    rng = np.random.default_rng(seed)
    B, W = 16, 5
    drafts = rng.integers(0, 6, (B, W - 1)).astype(np.int32)
    out = rng.integers(0, 6, (B, W)).astype(np.int32)
    for i in range(B):
        run = int(rng.integers(0, W))
        out[i, :run] = drafts[i, :run]
    qlens = rng.integers(0, W + 1, B).astype(np.int32)
    for eos in (-1, 2):
        np.testing.assert_array_equal(
            verify_host_ncommit(out, drafts, qlens, eos),
            j_ncommit(out, drafts, qlens, eos))


# -- the model's verify forward -----------------------------------------------

def _pools_close(tcache, jcache, atol=1e-5):
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=atol,
                                   rtol=0)


def test_forward_verify_is_jaxs(models):
    """Logits (B, W, V) and the pools after W teacher-forced steps,
    within 1e-5 (f32), over rows of window sizes 0..W."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(1)
    B, W, P, PS = 4, 4, 16, 8
    MP = tcfg.max_seq_len // PS
    bt = np.zeros((B, MP), np.int32)
    for b in range(B):
        bt[b, :3] = [1 + 3 * b, 2 + 3 * b, 3 + 3 * b]
    kv = rng.normal(size=(tcfg.n_layers, P, PS,
                          tcfg.n_kv_heads * tcfg.head_dim)).astype(np.float32)
    toks = rng.integers(3, 500, (B, W)).astype(np.int32)
    pos = np.array([0, 5, 7, 12], np.int32)
    qlens = np.array([4, 2, 0, 3], np.int32)
    tcache = {"k": torch.tensor(kv), "v": torch.tensor(kv * 0.5)}
    jcache = {"k": jnp.asarray(kv), "v": jnp.asarray(kv * 0.5)}
    tl = T.forward_verify(tparams, tcfg, torch.tensor(toks), torch.tensor(pos),
                          torch.tensor(qlens), tcache, torch.tensor(bt))
    jl, jcache = J.forward_verify(jparams, jcfg, jnp.asarray(toks),
                                  jnp.asarray(pos), jnp.asarray(qlens),
                                  jcache, jnp.asarray(bt))
    live = np.arange(W)[None, :] < qlens[:, None]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=1e-5, rtol=0)
    # Page 0 takes the inactive steps' writes, in another order.
    tcache = {k: v[:, 1:] for k, v in tcache.items()}
    jcache = {k: v[:, 1:] for k, v in jcache.items()}
    _pools_close(tcache, jcache)


# -- verify windows -------------------------------------------------------------

GEOM = dict(batch_size=4, page_size=8, num_pages=48, prefill_buckets=[16],
            chunk_size=4)
PROMPTS = [[11, 12, 13, 14, 15, 16, 17], [40, 41, 42], [7] * 9, [300, 3, 99]]


def _tables(ex):
    B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
    bt = np.zeros((B, MP), np.int32)
    for b in range(B):
        bt[b, :4] = [1 + 4 * b, 2 + 4 * b, 3 + 4 * b, 4 + 4 * b]
    return bt


def _prefill(ex, bt):
    toks = [ex.prefill(p, 0, bt[b], 0.0, b) for b, p in enumerate(PROMPTS)]
    return (np.asarray([int(t) for t in toks], np.int32),
            np.asarray([len(p) for p in PROMPTS], np.int32))


def _torch_ex(tcfg, tparams, k, device_sampling=True, **kw):
    return TorchExecutor(tcfg, tparams, device="cpu", eos_id=kw.pop("eos", -1),
                         speculation_draft_k=k,
                         speculation_device_sampling=device_sampling,
                         **dict(GEOM, **kw))


@pytest.mark.parametrize("device_sampling", [True, False],
                         ids=["device_accept", "host_accept"])
def test_windows_are_jaxs_and_plain_decodes(models, device_sampling):
    """Greedy, tolerance none. Drafts: the plain chunk's own tokens for
    rows 0 and 2 (all accepted), one wrong draft at step 2 for row 1, and
    garbage for row 3 (rejected at step 0); window sizes 4, 4, 3, 2.
    Tokens and n_commit equal ``JaxExecutor.verify_chunk``'s, the
    committed tokens are the plain chunk's, and the committed KV is the
    plain chunk's bit for bit."""
    jcfg, jparams, tcfg, tparams = models
    K = 3
    W = K + 1
    plain = _torch_ex(tcfg, tparams, 0)
    bt = _tables(plain)
    tok, pos = _prefill(plain, bt)
    B = len(tok)
    temps = np.zeros(B, np.float32)
    chunk = plain.decode_chunk(tok, pos, bt, temps, np.full(B, W, np.int32))
    drafts = chunk[:, :K].copy()
    drafts[1, 2] = 500
    drafts[3] = 500
    qlens = np.array([4, 4, 3, 2], np.int32)
    tex = _torch_ex(tcfg, tparams, K, device_sampling)
    jex = JaxExecutor(jcfg, jparams, eos_id=-1, mixed_prefill_slices=0,
                      speculation_draft_k=K,
                      speculation_device_sampling=device_sampling, **GEOM)
    assert (_prefill(tex, bt)[0] == tok).all()
    assert [int(jex.prefill(p, 0, bt[b], 0.0, b))
            for b, p in enumerate(PROMPTS)] == list(tok)
    out, nc = tex.verify_chunk(tok, pos, bt, temps, drafts, qlens)
    jout, jnc = (np.asarray(x) for x in jex.verify_chunk(
        tok, pos, bt, temps, drafts, qlens))
    assert list(nc) == list(jnc) == [4, 3, 3, 1]
    for b in range(B):
        n = int(nc[b])
        np.testing.assert_array_equal(out[b, :n], jout[b, :n])
        np.testing.assert_array_equal(out[b, :n], chunk[b, :n])
    if device_sampling:
        np.testing.assert_array_equal(out, jout)    # EOS past n_commit
    # The committed KV: positions [pos, pos + n_commit) of each row.
    ps = GEOM["page_size"]
    for b in range(B):
        for p in range(int(pos[b]), int(pos[b]) + int(nc[b])):
            page, slot = bt[b, p // ps], p % ps
            for name in ("k", "v"):
                assert torch.equal(tex.cache[name][:, page, slot],
                                   plain.cache[name][:, page, slot]), (b, p)


def test_device_accept_stops_early(models, monkeypatch):
    """Every row rejects at step 0: the window queues two steps, not W,
    and reads each exit flag one step behind."""
    _, _, tcfg, tparams = models
    ex = _torch_ex(tcfg, tparams, 6)
    bt = _tables(ex)
    tok, pos = _prefill(ex, bt)
    B = len(tok)
    calls = []
    run = ex._run_verify
    monkeypatch.setattr(ex, "_run_verify",
                        lambda eager: (calls.append(eager), run(eager))[1])
    out, nc = ex.verify_chunk(tok, pos, bt, np.zeros(B, np.float32),
                              np.full((B, 6), 500, np.int32),
                              np.full(B, 7, np.int32))
    assert list(nc) == [1] * B and len(calls) == 2
    assert (out[:, 1:] == -1).all()


def test_rollback_leaves_committed_kv_bitwise_intact(models):
    """``TestJaxKVIntegrity`` on the port: windows of garbage drafts
    (every one rejected at step 0, host accept writing its stale tail)
    re-dispatched from the committed position give sequential decode's
    stream (also JAX's), and the committed KV region is sequential
    decode's bit for bit."""
    jcfg, jparams, tcfg, tparams = models
    K, prompt = 3, [11, 12, 13, 14, 15, 16, 17, 18]
    kw = dict(batch_size=1, page_size=8, num_pages=16, prefill_buckets=[16],
              chunk_size=1)

    def mk(k, device_sampling=False):
        return TorchExecutor(tcfg, tparams, device="cpu", eos_id=-1,
                             speculation_draft_k=k,
                             speculation_device_sampling=device_sampling,
                             **kw)

    ctl = mk(0)
    bt = np.zeros(ctl.spec.max_pages_per_seq, np.int32)
    bt[:4] = [1, 2, 3, 4]
    tok = int(ctl.prefill(prompt, 0, bt, 0.0, 0))
    ctl_stream, pos = [], len(prompt)
    for _ in range(8):
        tok = int(ctl.decode(np.array([tok], np.int32),
                             np.array([pos], np.int32), bt[None, :],
                             np.zeros(1, np.float32))[0])
        ctl_stream.append(tok)
        pos += 1
    jex = JaxExecutor(jcfg, jparams, eos_id=-1, mixed_prefill_slices=0,
                      **kw)
    jtok, jstream, jpos = int(jex.prefill(prompt, 0, bt, 0.0, 0)), [], \
        len(prompt)
    for _ in range(8):
        jtok = int(np.asarray(jex.decode(
            np.array([jtok], np.int32), np.array([jpos], np.int32),
            bt[None, :], np.zeros(1, np.float32)))[0])
        jstream.append(jtok)
        jpos += 1
    assert ctl_stream == jstream
    for device_sampling in (False, True):
        ex = mk(K, device_sampling)
        tok = int(ex.prefill(prompt, 0, bt, 0.0, 0))
        stream, pos = [], len(prompt)
        while len(stream) < 8:
            out, nc = ex.verify_chunk(
                np.array([tok], np.int32), np.array([pos], np.int32),
                bt[None, :], np.zeros(1, np.float32),
                np.full((1, K), 500, np.int32), np.full(1, K + 1, np.int32))
            n = int(nc[0])
            assert n == 1
            stream.extend(int(t) for t in out[0, :n])
            tok, pos = int(out[0, n - 1]), pos + n
        assert stream == ctl_stream
        end = len(prompt) + 8
        for name in ("k", "v"):
            got = ex.cache[name][:, 1:5].reshape(ex.cache[name].shape[0], -1,
                                                 ex.cache[name].shape[-1])
            want = ctl.cache[name][:, 1:5].reshape(got.shape)
            assert torch.equal(got[:, :end], want[:, :end]), name


# -- the keyed sampler ------------------------------------------------------------

def test_keyed_sampler_draws_in_proportion_to_softmax():
    """Chi-squared over 8 categories and 40,000 positions: below 24.32,
    the 0.999 quantile at 7 degrees of freedom (the draws are a fixed
    function of their keys, so this is not flaky). Greedy rows take the
    argmax, and the same keys draw the same tokens."""
    V, N = 8, 40_000
    logits = torch.tensor(np.random.default_rng(3).normal(size=V),
                          dtype=torch.float32)
    rows = torch.zeros(N, dtype=torch.int64)
    pos = torch.arange(N)
    out = sample_token_keyed(logits[None].expand(N, V), 7, rows, pos,
                             temperature=1.0)
    counts = np.bincount(out.numpy(), minlength=V)
    expect = N * torch.softmax(logits, 0).numpy()
    assert ((counts - expect) ** 2 / expect).sum() < 24.32
    again = sample_token_keyed(logits[None].expand(N, V), 7, rows, pos,
                               temperature=1.0)
    assert torch.equal(out, again)
    other = sample_token_keyed(logits[None].expand(N, V), 8, rows, pos,
                               temperature=1.0)
    assert not torch.equal(out, other)
    greedy = sample_token_keyed(logits[None].expand(4, V), 7, rows[:4],
                                pos[:4], temperature=0.0)
    assert (greedy == int(torch.argmax(logits))).all()


HOST_READS = ("item", "__bool__", "tolist", "cpu", "numpy")


@pytest.mark.parametrize("route", ["fused", "split", "int8_kv"])
@pytest.mark.parametrize("device_sampling", [True, False],
                         ids=["device_accept", "host_accept"])
def test_verify_bodies_make_no_host_read(models, route, device_sampling,
                                         monkeypatch):
    """The bodies the card captures (the device-accept step, the
    host-accept window) read nothing back to the host and make no tensor
    from host data, at a temperature: each such call raises while they
    run, and they still sample."""
    _, _, tcfg, tparams = models
    kw = {}
    if route == "split":
        kw["fused_decode"] = False
    if route == "int8_kv":
        kw["cache_dtype"] = torch.int8
    ex = _torch_ex(tcfg, tparams, 3, device_sampling, **kw)
    bt = _tables(ex)
    tok, pos = _prefill(ex, bt)
    B = len(tok)
    with torch.inference_mode():
        ex._fill(tok, pos, bt, np.full(B, 0.7, np.float32),
                 np.full(B, 4, np.int32))
        ex._vbuf.drafts.fill_(5)

    def host_read(*_a, **_k):
        raise AssertionError("host read inside a verify body")

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, host_read)
    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, host_read)
    with torch.inference_mode():
        if device_sampling:
            for _ in range(4):
                ex._verify_step()
        else:
            ex._verify_window()
    monkeypatch.undo()
    out = ex._vbuf.out.numpy()
    assert out.shape == (B, 4) and (out[:, 0] >= 0).all()


class _FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: a replay reruns the captured
    body and writes its result into the captured output (a prefill
    program's tokens), as a replay rewrites the graph's static output."""

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


@pytest.mark.parametrize("device_sampling", [True, False],
                         ids=["device_accept", "host_accept"])
def test_verify_graph_control_flow_with_fake_graphs(models, device_sampling,
                                                    monkeypatch):
    """The card's capture and replay of the verify programs, rehearsed on
    the CPU with fakes for the CUDA graph, stream and event calls:
    warmup captures one verify program a decode route; a window gives the
    eager executor's tokens, n_commit and pools; a device-accept window
    is one replay a step (a host-accept window one replay), and the
    capture's save and restore leave the buffers as they were."""
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
        ex = _torch_ex(tcfg, tparams, 3, device_sampling)
        if graphs:
            ex._graphs_on = True
            ex._left_events = [_FakeEvent() for _ in range(4)]
        ex.warmup()
        bt = _tables(ex)
        tok, pos = _prefill(ex, bt)
        B = len(tok)
        chunk = ex.decode_chunk(tok, pos, bt, np.zeros(B, np.float32),
                                np.full(B, 4, np.int32))
        replays = ex.verify_replays
        drafts = chunk[:, :3].copy()
        drafts[2, 1] = 500
        out, nc = ex.verify_chunk(chunk[:, 3], pos + 4, bt,
                                  np.full(B, 0.8, np.float32), drafts,
                                  np.array([4, 3, 4, 0], np.int32))
        runs.append((out, nc, ex, ex.verify_replays - replays))
    (e_out, e_nc, e_ex, _), (g_out, g_nc, g_ex, n_replays) = runs
    np.testing.assert_array_equal(e_out, g_out)
    np.testing.assert_array_equal(e_nc, g_nc)
    for k in e_ex.cache:
        assert torch.equal(e_ex.cache[k][:, 1:], g_ex.cache[k][:, 1:]), k
    kind = "step" if device_sampling else "window"
    assert set(g_ex.verify_graphs) == {f"verify_{kind}_fused",
                                       f"verify_{kind}_split"}
    assert not e_ex.verify_graphs
    assert n_replays == (min(4, int(g_nc.max()) + 1) if device_sampling
                         else 1)


# -- the engine ---------------------------------------------------------------------

EGEOM = dict(batch_size=2, page_size=8, num_pages=96, prefill_buckets=[16, 64],
             chunk_size=4)
WAVE = [("a long prompt that needs slicing into chunks", "low"),
        ("second prompt arrives", "normal"), ("urgent!", "realtime")]
TURNS = ["Hello there, conversation.", " And a second turn."]


def _drive(eng, make_req, prio, temps=None):
    """The wave (slots 2: the REALTIME arrival preempts), then a
    two-turn conversation. Returns (streams, turn-2 cached tokens, the
    speculation stats)."""
    hs = []
    for i, (p, tier) in enumerate(WAVE):
        hs.append(eng.submit(make_req(
            id=f"j{i}", prompt=p, priority=prio(tier), max_new_tokens=12,
            temperature=(temps[i] if temps else 0.0))))
        eng.step()
        eng.step()
    eng.run_until_idle()
    for i, text in enumerate(TURNS):
        hs.append(eng.submit(make_req(
            id=f"t{i}", prompt=text, priority=prio("high"),
            conversation_id="conv", max_new_tokens=10,
            temperature=(temps[0] if temps else 0.0))))
        eng.run_until_idle()
    stats = eng.get_stats()
    eng.stop()
    assert all(h.result.finish_reason in ("eos", "length") for h in hs)
    return ([h.result.tokens for h in hs], hs[-1].result.cached_tokens,
            stats.get("speculation"), eng)


def _port_engine(models, k, device_sampling=True, pipe=False, mixed=False,
                 **kw):
    _, _, tcfg, tparams = models
    geom = dict(EGEOM, prefill_batch=1)
    if mixed:
        geom.update(mixed_prefill_slices=2, mixed_slice_tokens=8)
    ex = TorchExecutor(tcfg, tparams, device="cpu", eos_id=EOS,
                       speculation_draft_k=k,
                       speculation_device_sampling=device_sampling, **geom)
    return InferenceEngine(
        ex, ByteTokenizer(), max_decode_steps=16, enable_metrics=False,
        speculation=(SpeculationConfig(enabled=True, draft_k=k,
                                       device_sampling=device_sampling)
                     if k else None),
        async_pipeline=AsyncPipelineConfig(enabled=True) if pipe else None,
        mixed_batch=(MixedBatchConfig(enabled=True, prefill_token_budget=16,
                                      max_slices=2) if mixed else None), **kw)


def _jax_engine(models, k, device_sampling=True, pipe=False):
    jcfg, jparams, _, _ = models
    ex = JaxExecutor(jcfg, jparams, eos_id=EOS, mixed_prefill_slices=0,
                     prefill_batch=1, speculation_draft_k=k,
                     speculation_device_sampling=device_sampling, **EGEOM)
    return JEngine(ex, JTok(), enable_metrics=False, max_decode_steps=16,
                   speculation=(JSpec(enabled=True, draft_k=k,
                                      device_sampling=device_sampling)
                                if k else None),
                   async_pipeline=JPipe(enabled=True) if pipe else None)


def _port(models, *a, temps=None, **kw):
    return _drive(_port_engine(models, *a, **kw), GenRequest,
                  Priority.from_name, temps)


def _jax(models, *a, **kw):
    return _drive(_jax_engine(models, *a, **kw), JGenRequest,
                  JPriority.from_name)


@pytest.fixture(scope="module")
def plain_runs(models):
    return {"jax": _jax(models, 0), "port": _port(models, 0)}


@pytest.mark.parametrize("pipe", [False, True], ids=["pipeline_off",
                                                     "pipeline_on"])
@pytest.mark.parametrize("device_sampling", [True, False],
                         ids=["device_accept", "host_accept"])
def test_engine_greedy_streams_equal_off_and_jaxs(models, plain_runs,
                                                  device_sampling, pipe):
    """Tolerance: none (f32, greedy). The port with speculation on
    commits the streams of the port with it off and of JAX (a REALTIME
    preemption and a cached second turn included), and its speculation
    stats (windows, proposed, accepted, committed, fetches) are the JAX
    engine's on the same wave."""
    on, cached, stats, eng = _port(models, 3, device_sampling, pipe)
    j_on, j_cached, j_stats, _ = _jax(models, 3, device_sampling, pipe)
    off, off_cached, off_stats, off_eng = plain_runs["port"]
    j_off = plain_runs["jax"][0]
    assert on == off == j_off == j_on
    assert cached == off_cached == j_cached > 0
    assert stats == j_stats
    assert stats["windows"] > 0 and stats["tokens_committed"] > 0
    assert off_stats is None and "speculation" not in off_eng.get_stats()
    assert eng.preemptions >= 1
    assert eng.allocator.used() == eng.allocator.pinned_pages()


def test_engine_temperature_streams_equal_across_windows(models):
    """At temperature 0.8 the committed stream is a function of (row,
    position, prefix): draft_k 1 and 3, device and host accept, commit
    the same tokens."""
    temps = [0.8, 0.9, 0.7]
    runs = [_port(models, k, ds, temps=temps)[0]
            for k in (1, 3) for ds in (True, False)]
    assert all(r == runs[0] for r in runs[1:])
    assert len({t for s in runs[0] for t in s}) > 5


def test_engine_with_mixed_batching_prefills_between_windows(models):
    """Mixed batching on (the serving default) takes no mixed step under
    speculation, and a prompt that arrives while a row decodes is
    prefilled by the bucket programs before that row finishes (JAX's
    engine leaves it waiting until no row decodes); the streams are
    those of speculation off, which fuses the arrival into mixed
    steps."""
    def run(k):
        eng = _port_engine(models, k, mixed=True)
        first = eng.submit(GenRequest(id="a", prompt="a row that decodes",
                                      max_new_tokens=16))
        while not first.marks.get("first_token"):
            eng.step()
        second = eng.submit(GenRequest(id="b", prompt="arrives meanwhile",
                                       max_new_tokens=6))
        eng.run_until_idle()
        eng.stop()
        return eng, first, second

    on, a, b = run(3)
    assert on.mixed_steps == 0 and on.spec_windows > 0
    assert b.marks["prefill_done"] < a.finished_at
    off, a_off, b_off = run(0)
    assert off.mixed_steps > 0      # the same arrival, fused without it
    assert (a.result.tokens, b.result.tokens) == (a_off.result.tokens,
                                                  b_off.result.tokens)


def test_rows_hold_exactly_their_committed_pages(models):
    """After every reconcile a row holds pages_for(pos) pages (the
    rejected tail's pages, page-boundary ones included, go back), and the
    pool drains to the pins."""
    eng = _port_engine(models, 6)
    freed = []
    free = eng.allocator.free
    eng.allocator.free = lambda pages: (freed.extend(pages), free(pages))[1]
    h = eng.submit(GenRequest(id="pb", prompt="qr qr qr qr qr qr qr qr",
                              max_new_tokens=40))
    for _ in range(200):
        eng.step()
        for seq in eng._slots:
            if seq is not None and seq.prefilled and not eng._inflight:
                assert len(seq.pages) == PageAllocator.pages_for(
                    seq.pos, eng.spec.page_size), (seq.pos, seq.pages)
        if h.result is not None:
            break
    eng.run_until_idle()
    eng.stop()
    assert h.result.finish_reason in ("eos", "length")
    assert freed and eng.spec_windows > 0
    assert eng.allocator.used() == eng.allocator.pinned_pages()


def test_off_switch_builds_no_verify_program(models):
    """draft_k 0: no verify entry point, no verify buffers; an engine
    given an enabled config over such an executor keeps plain decode and
    reports no speculation block."""
    _, _, tcfg, tparams = models
    ex = TorchExecutor(tcfg, tparams, device="cpu", **EGEOM)
    assert ex.verify_chunk is None and ex.verify_chunk_start is None
    assert ex._vbuf is None and ex.verify_draft_k == 0
    eng = InferenceEngine(ex, ByteTokenizer(), enable_metrics=False,
                          speculation=SpeculationConfig(enabled=True))
    assert not eng._spec_on
    eng.submit(GenRequest(id="x", prompt="plain", max_new_tokens=4))
    eng.run_until_idle()
    assert "speculation" not in eng.get_stats()
    eng.stop()


# -- attribution through verify windows --------------------------------------------

def _slow_handles(eng):
    """Give each window's fetch a device leg on the CPU: its wait sleeps
    1 ms (the CPU dispatch runs the work, so the wait is ~0)."""
    import time

    class Slow:
        def __init__(self, h):
            self.fetch = h.fetch

        def wait_ready(self):
            time.sleep(0.001)

    start = eng.executor.verify_chunk_start
    eng.executor.verify_chunk_start = lambda *a: Slow(start(*a))


def test_usage_conserved_with_multi_token_commits(models):
    from llmq_tpu_torch.observability.usage import (get_usage_ledger,
                                                    reset_usage)
    reset_usage()
    led = get_usage_ledger()
    led.reconfigure(enabled=True, max_tenants=64)
    try:
        eng = _port_engine(models, 4, name="spec-usage")
        _slow_handles(eng)
        hs = [eng.submit(GenRequest(
                  id=f"u{i}", prompt="usage usage usage usage " * 2,
                  max_new_tokens=16, tenant_id=f"tenant-{i % 2}"))
              for i in range(4)]
        eng.run_until_idle()
        eng.stop()
        assert all(h.result.finish_reason in ("eos", "length") for h in hs)
        assert eng.spec_tokens_accepted > 0
        assert eng.spec_commits_total > eng.spec_windows
        measured = eng._telemetry._device.total_ms / 1e3
        accounted = led.attributed_device_s + led.unattributed_device_s
        assert measured > 0
        assert accounted == pytest.approx(measured, rel=0.02)
    finally:
        reset_usage()


def test_critical_path_segments_conserve(models):
    from llmq_tpu_torch.observability.critical_path import get_critical_path
    from llmq_tpu_torch.observability.recorder import get_recorder
    rec = get_recorder()
    rec.flush_metrics()
    ana = get_critical_path()
    ana.clear()
    ana.reconfigure(enabled=True, recent_capacity=256)
    try:
        eng = _port_engine(models, 4, name="spec-cp")
        _slow_handles(eng)
        hs = [eng.submit(GenRequest(id=f"cp{i}",
                                    prompt="usage usage usage usage " * 2,
                                    max_new_tokens=16))
              for i in range(4)]
        eng.run_until_idle()
        eng.stop()
        assert all(h.result.finish_reason in ("eos", "length") for h in hs)
        assert eng.spec_tokens_accepted > 0
        rec.flush_metrics()
        snap = ana.snapshot(recent=256)
        mine = [r for r in snap["recent"]
                if r["request_id"].startswith("cp")]
        assert len(mine) == 4 and snap["conservation_failures"] == 0
        for r in mine:
            seg_sum = sum(r["segments_ms"].values())
            assert abs(seg_sum - r["total_ms"]) <= max(
                0.02 * r["total_ms"], 0.06), r
    finally:
        rec.flush_metrics()
        ana.clear()


def test_config_file_builds_a_speculating_engine(tmp_path):
    """``executor.speculation`` from a file reaches the builder: the
    executor gets the window's width and accept mode, the engine its
    drafter, and it serves; the default config builds neither."""
    from llmq_tpu_torch.core.config import Config, load_config
    from llmq_tpu_torch.engine.builder import build_engine

    path = tmp_path / "c.yaml"
    path.write_text("device: cpu\nmodel: {name: llama3-tiny}\n"
                    "executor: {speculation: {enabled: true, draft_k: 3, "
                    "device_sampling: false}}\n")
    eng = build_engine(load_config(str(path), env=False),
                       model_dtype=torch.float32)
    ex = eng.executor
    assert eng._spec_on and eng._drafter.draft_k == 3
    assert ex.verify_draft_k == 3 and not ex._spec_device_sampling
    h = eng.submit(GenRequest(id="c", prompt="ab ab ab ab", max_new_tokens=8))
    eng.run_until_idle()
    eng.stop()
    assert h.result.finish_reason in ("eos", "length")
    assert eng.get_stats()["speculation"]["windows"] > 0
    cfg = Config()
    cfg.device, cfg.model.name = "cpu", "llama3-tiny"
    plain = build_engine(cfg, model_dtype=torch.float32)
    assert not plain._spec_on and plain.executor.verify_chunk is None
