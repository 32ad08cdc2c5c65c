"""The port's tiered KV plane (``llmq_tpu_torch/tiering/``) against the
JAX package's (``llmq_tpu/tiering/``), on the CPU.

- The host pool's lifecycle, and its fenced give (a buffer a device copy
  may still read returns to the freelist only once its fence completed).
- The codec: ``pack_pages`` fills the same bytes as JAX's, and a store
  blob encoded by either package decodes in the other to identical
  bytes, for a bf16 pool and an int8 pool with its bf16 scale pools
  (bf16 leaves travel as raw 2-byte words; the header names them
  ``bfloat16``). Tolerance: none.
- The plane's state machine on a fake executor (JAX's
  ``TestPlaneStateMachine``): demote → host claim, spill → load back,
  recompute fallbacks, promote timeout, forget, restash, the host bound,
  round trips, the spill/timeout race, tier-change callbacks,
  content-free entries; and the same script through both planes gives
  the same counters.
- The radix demotion seam, the SQLite KV seam (migration of a database
  made before it, WAL and busy timeout, four threads), and the Redis one.
- Prefix-handle tiers through the port's engine.
- The executor seam: ``kv_page_spec`` equals ``JaxExecutor``'s (leaf
  order k, k_scale, v, v_scale), and ``export_kv_pages`` /
  ``import_kv_pages`` carry a JAX executor's pool pages into the port's
  pool byte for byte.
- Both engines on JAX's two-turn scenario (``tests/test_kv_tiering.py``
  ``run_jax_two_turns``: f32 tiny model, pin TTL expiry between turns)
  through the host, store and recompute tiers, with bf16 and int8 KV:
  turn 2's greedy tokens equal across packages and equal to the
  pin-resident baseline's (exact). A blob the JAX engine spilled serves
  the port's engine as a store hit.
- The off-switch builds no plane and starts no thread; the metric
  families show in ``/metrics``.
"""

import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from llmq_tpu.conversation import persistence as jpersist  # noqa: E402
from llmq_tpu.core.clock import FakeClock as JFakeClock  # noqa: E402
from llmq_tpu.core.config import KVTieringConfig as JTierCfg  # noqa: E402
from llmq_tpu.engine.engine import GenRequest as JGenRequest  # noqa: E402
from llmq_tpu.engine.engine import InferenceEngine as JEngine  # noqa: E402
from llmq_tpu.engine.executor import JaxExecutor  # noqa: E402
from llmq_tpu.engine.tokenizer import ByteTokenizer as JTok  # noqa: E402
from llmq_tpu.models import llama as J  # noqa: E402
from llmq_tpu import tiering as jtier  # noqa: E402

from llmq_tpu_torch.conversation import persistence as tpersist  # noqa: E402
from llmq_tpu_torch.conversation.state_manager import StateManager  # noqa: E402
from llmq_tpu_torch.core.clock import FakeClock  # noqa: E402
from llmq_tpu_torch.core.config import (AsyncPipelineConfig,  # noqa: E402
                                        ConversationConfig, KVTieringConfig,
                                        PrefixCacheConfig)
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine  # noqa: E402
from llmq_tpu_torch.engine.executor import TorchExecutor  # noqa: E402
from llmq_tpu_torch.engine.kv_allocator import PageAllocator  # noqa: E402
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from llmq_tpu_torch.models import llama as T  # noqa: E402
from llmq_tpu_torch.observability.usage import get_usage_ledger  # noqa: E402
from llmq_tpu_torch.prefixcache import PrefixCache  # noqa: E402
from llmq_tpu_torch import tiering  # noqa: E402
from llmq_tpu_torch.tiering import (HostTierPool, KVTieringPlane,  # noqa: E402
                                    TierEntry, decode_blob, encode_blob,
                                    page_payload_nbytes, unpack_pages)

pytestmark = [pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning"),
    # JAX's scatter of f32 rows into a bf16 pool warns; the values are
    # what the port writes (round to nearest even).
    pytest.mark.filterwarnings("ignore::FutureWarning")]

torch.set_num_threads(1)

#: JAX's ``tiny_model`` (tests/test_kv_tiering.py) in f32.
KW = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
          vocab_size=512, max_seq_len=256)
#: Its executor geometry (``run_jax_two_turns``).
GEOM = dict(batch_size=2, page_size=8, num_pages=64,
            prefill_buckets=[16, 64], chunk_size=4)
KV_DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
             "int8": (jnp.int8, torch.int8)}


@pytest.fixture(autouse=True)
def _usage_off():
    """The port's usage ledger off for each test, and put back as it was
    after: a later file in the same process (the split deployment's
    usage parity) reads it on."""
    led = get_usage_ledger()
    was = led.enabled
    led.reconfigure(enabled=False)
    led.clear()
    yield
    led.reconfigure(enabled=was)
    led.clear()


def wait_until(fn, timeout=30.0, step=0.002):
    """Poll ``fn`` until true (the worker thread's jobs are short; the
    bound is generous so a loaded host cannot fail a correct run)."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if fn():
            return True
        time.sleep(step)
    return False


# -- host pool -----------------------------------------------------------------


class _Fence:
    """An event double: completes when ``done`` is set (or on wait)."""

    def __init__(self):
        self.done = False
        self.waited = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True


class TestHostTierPool:
    def test_take_give_lifecycle(self):
        pool = HostTierPool(capacity_bytes=1024, page_nbytes=256)
        assert pool.total_buffers == 4 and not pool.pinned
        bufs = pool.take(3)
        assert bufs is not None and len(bufs) == 3
        assert pool.free_buffers() == 1
        assert pool.used_bytes() == 3 * 256
        pool.give(bufs)
        assert pool.free_buffers() == 4

    def test_all_or_nothing(self):
        pool = HostTierPool(1024, 256)
        held = pool.take(3)
        assert pool.take(2) is None
        assert pool.free_buffers() == 1
        pool.give(held)

    def test_double_give_is_noop(self):
        pool = HostTierPool(512, 256)
        bufs = pool.take(1)
        pool.give(bufs)
        pool.give(bufs)
        assert pool.free_buffers() == 2
        a = pool.take(2)
        assert a is not None and pool.take(1) is None
        pool.give(a)

    def test_foreign_arrays_ignored(self):
        pool = HostTierPool(512, 256)
        pool.give([np.zeros(256, np.uint8)])
        assert pool.free_buffers() == 2

    def test_buffers_are_one_arena_and_its_tensors(self):
        pool = HostTierPool(1024, 128)
        bufs = pool.take(2)
        for b in bufs:
            assert b.base is pool._arena       # one allocation in all
            t = pool.tensor(b)
            t.fill_(7)                         # the same bytes
            assert (b == 7).all()
        foreign = np.zeros(128, np.uint8)
        pool.tensor(foreign).fill_(3)
        assert (foreign == 3).all()
        pool.give(bufs)

    def test_zero_page_bytes(self):
        pool = HostTierPool(1 << 20, 0)
        assert pool.total_buffers == 0 and pool.total_bytes == 0

    def test_fenced_give_waits_for_its_fence(self):
        """A buffer given behind an incomplete fence is not handed out
        until the fence completes; a take that needs it waits on it."""
        pool = HostTierPool(512, 256)
        a = pool.take(2)
        fence = _Fence()
        pool.give(a, fence)
        assert pool.free_buffers() == 0        # still read by the copy
        fence.done = True
        assert pool.free_buffers() == 2
        b = pool.take(2)
        fence2 = _Fence()
        pool.give(b, fence2)
        assert pool.take(1) is not None        # waited on the fence
        assert fence2.waited == 1


# -- codec ---------------------------------------------------------------------


def _leaves(kind, n_pages, seed=0):
    """Per-leaf page gathers shaped like a tiny cache tree, in JAX's leaf
    order: an int8 pool with its bf16 scale pools, or a bf16 pool."""
    rng = np.random.default_rng(seed)
    if kind == "int8":
        return [
            rng.integers(-128, 128, (2, n_pages, 8, 16)).astype(np.int8),
            rng.standard_normal((2, n_pages, 2, 8)).astype(
                ml_dtypes.bfloat16),
            rng.integers(-128, 128, (2, n_pages, 8, 16)).astype(np.int8),
            rng.standard_normal((2, n_pages, 2, 8)).astype(
                ml_dtypes.bfloat16)]
    return [rng.standard_normal((2, n_pages, 8, 16)).astype(
        ml_dtypes.bfloat16) for _ in range(2)]


def _specs(leaves):
    return [((lf.shape[0],) + lf.shape[2:], np.dtype(lf.dtype))
            for lf in leaves]


def _packed(mod, leaves):
    specs = _specs(leaves)
    per = mod.page_payload_nbytes(specs)
    bufs = [np.empty(per, np.uint8) for _ in range(leaves[0].shape[1])]
    mod.pack_pages(leaves, bufs)
    return bufs, specs


class TestCodec:
    @pytest.mark.parametrize("kind", ["bf16", "int8"])
    def test_pack_fills_jaxs_bytes_and_unpacks(self, kind):
        """Tolerance: none. The port packs the same bytes as JAX from the
        same leaves (bf16 as 2-byte words), and unpacks them back."""
        leaves = _leaves(kind, 3)
        tbufs, specs = _packed(tiering.plane, leaves)
        jbufs, _ = _packed(jtier, leaves)
        for a, b in zip(tbufs, jbufs):
            assert np.array_equal(a, b)
        assert page_payload_nbytes(specs) == jtier.page_payload_nbytes(specs)
        for a, b in zip(leaves, unpack_pages(tbufs, specs)):
            assert b.shape == a.shape
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8))

    @pytest.mark.parametrize("kind", ["bf16", "int8"])
    @pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
    def test_blob_decodes_in_the_other_package(self, kind, direction):
        """Tolerance: none. A blob encoded by either package (with its
        meta sidecar) is byte-identical to the other's and decodes there
        to the same page bytes, specs and meta."""
        leaves = _leaves(kind, 4, seed=7)
        bufs, specs = _packed(jtier, leaves)
        meta = {"conv_id": "c", "tokens": [1, 2, 3], "length": 3,
                "pending": None, "n_pages": 4, "owner": "e0",
                "content_free": False}
        enc, dec = ((jtier.encode_blob, decode_blob)
                    if direction == "jax_to_torch"
                    else (encode_blob, jtier.decode_blob))
        blob = enc(bufs, specs, meta=meta)
        assert blob == (encode_blob if enc is jtier.encode_blob
                        else jtier.encode_blob)(bufs, specs, meta=meta)
        bufs2, specs2 = dec(blob)
        assert [tuple(s) for s, _ in specs2] == [tuple(s) for s, _ in specs]
        assert [np.dtype(d).name if not isinstance(d, str) else d
                for _, d in specs2] == [np.dtype(d).name for _, d in specs]
        for a, b in zip(bufs, bufs2):
            assert np.array_equal(a, b)
        assert tiering.blob_meta(blob) == jtier.plane.blob_meta(blob) == meta

    def test_torn_and_foreign_blobs_raise_in_both(self):
        bufs, specs = _packed(tiering.plane, _leaves("int8", 1))
        blob = encode_blob(bufs, specs)
        for dec in (decode_blob, jtier.decode_blob):
            with pytest.raises(ValueError):
                dec(b"garbage" + blob)
            with pytest.raises(ValueError):
                dec(blob[:-10])
        assert tiering.blob_meta(b"garbage") is None
        assert tiering.blob_meta(blob) is None          # no meta sidecar


# -- plane state machine (fake executor) ---------------------------------------


class FakeKVExec:
    """A numpy 'device': page p's payload is all p, so the tests can check
    content end to end."""

    def __init__(self):
        self.injected = {}

    def kv_page_spec(self):
        return [((2, 4, 8), np.dtype(np.float32))]

    def export_kv_pages(self, pages):
        return [np.stack([np.full((2, 4, 8), float(p), np.float32)
                          for p in pages], axis=1)]

    def import_kv_pages(self, pages, leaves):
        for i, p in enumerate(pages):
            self.injected[p] = np.asarray(leaves[0][:, i]).copy()


def mk_plane(cfg=None, execu=None, clock=None, store=None, mod=None):
    if mod is jtier:
        plane = jtier.KVTieringPlane(cfg or JTierCfg(enabled=True), "test",
                                     execu or FakeKVExec(), clock=clock)
    else:
        plane = KVTieringPlane(cfg or KVTieringConfig(enabled=True),
                               "test", execu or FakeKVExec(), clock=clock)
    if store is not None:
        plane.store = store
    return plane


def _claim_ready(plane, conv, timeout=30.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        status, entry = plane.claim(conv)
        if status == "ready":
            return entry
        time.sleep(0.002)
    raise AssertionError(f"{conv} never became ready")


def _host_ready(plane, conv):
    """``conv``'s extract has landed in the host tier (its tier reads
    "host" from the demote on, before the copy is done)."""
    with plane._mu:
        e = plane._entries.get(conv)
        return e is not None and e.tier == "host" and e.ready.is_set()


class TestPlaneStateMachine:
    def test_demote_then_host_claim(self):
        plane = mk_plane()
        assert plane.demote("c", [3, 5], list(range(16)), 16, None) == "host"
        assert wait_until(lambda: _host_ready(plane, "c"))
        status, entry = plane.claim("c")
        assert status == "ready" and entry.tier == "host"
        leaves = plane.unpack(entry).leaves()
        assert np.all(leaves[0][:, 0] == 3.0)
        assert np.all(leaves[0][:, 1] == 5.0)
        plane.release(entry)
        assert plane.pool.free_buffers() == plane.pool.total_buffers
        assert plane.claim("c") == ("none", None)
        plane.stop()

    def test_spill_to_store_and_load_back(self):
        plane = mk_plane(KVTieringConfig(enabled=True, host_capacity_mb=0),
                         store=tpersist.InMemoryStore())
        plane.demote("c", [7], list(range(8)), 8, 42)
        assert wait_until(lambda: plane.counts()["store"] == 1)
        assert plane.stats()["spills"] == 1
        assert plane.prepare("c")
        entry = _claim_ready(plane, "c")
        assert entry.source_tier == "store" and entry.pending == 42
        assert np.all(plane.unpack(entry).leaves()[0][:, 0] == 7.0)
        plane.release(entry)
        plane.stop()

    def test_claim_triggers_load_without_prepare(self):
        plane = mk_plane(KVTieringConfig(enabled=True, host_capacity_mb=0),
                         store=tpersist.InMemoryStore())
        plane.demote("c", [2], list(range(8)), 8, None)
        assert wait_until(lambda: plane.counts()["store"] == 1)
        entry = _claim_ready(plane, "c")
        assert entry.payload is not None
        plane.release(entry)
        plane.stop()

    def test_no_store_degrades_to_recompute(self):
        plane = mk_plane(KVTieringConfig(enabled=True, host_capacity_mb=0,
                                         store_spill=False))
        plane.demote("c", [2], [1, 2, 3], 3, None)
        assert wait_until(lambda: plane.counts()["recompute"] == 1)
        status, entry = plane.claim("c")
        assert status == "ready" and entry.payload is None
        assert entry.tokens == [1, 2, 3]
        plane.release(entry)
        plane.stop()

    def test_promote_timeout_falls_back_to_recompute(self):
        plane = mk_plane(KVTieringConfig(enabled=True,
                                         promote_timeout_s=0.02))
        entry = TierEntry("c", [1, 2], 2, None, 1, 0.0)
        with plane._mu:
            plane._entries["c"] = entry
        assert plane.claim("c")[0] == "wait"
        time.sleep(0.03)
        status, got = plane.claim("c")
        assert status == "ready" and got.payload is None
        assert got.tokens == [1, 2]
        plane.stop()

    def test_forget_drops_all_tiers(self):
        store = tpersist.InMemoryStore()
        plane = mk_plane(KVTieringConfig(enabled=True, host_capacity_mb=0),
                         store=store)
        plane.demote("c", [4], list(range(8)), 8, None)
        assert wait_until(lambda: store.load_kv("c") is not None)
        plane.forget("c")
        assert wait_until(lambda: store.load_kv("c") is None)
        assert plane.claim("c") == ("none", None)
        plane.stop()

    def test_restash_puts_entry_back(self):
        plane = mk_plane()
        plane.demote("c", [3], list(range(8)), 8, None)
        assert wait_until(lambda: _host_ready(plane, "c"))
        status, entry = plane.claim("c")
        assert status == "ready"
        plane.restash("c", entry)
        status2, entry2 = plane.claim("c")
        assert status2 == "ready" and entry2 is entry
        plane.release(entry2)
        plane.stop()

    def test_host_bound_spills_coldest(self):
        clock = FakeClock()
        plane = mk_plane(KVTieringConfig(enabled=True,
                                         host_max_conversations=2),
                         clock=clock, store=tpersist.InMemoryStore())
        for i in range(3):
            plane.demote(f"c{i}", [i + 1], list(range(8)), 8, None)
            assert wait_until(
                lambda i=i: plane._entries[f"c{i}"].ready.is_set()
                or plane._entries[f"c{i}"].spilling)
            clock.advance(1.0)
        assert wait_until(lambda: plane.counts()["store"] == 1
                          and plane.counts()["host"] == 2)
        with plane._mu:
            assert plane._entries["c0"].tier == "store"
        plane.stop()

    def test_round_trip_counted_inside_window(self):
        clock = FakeClock()
        plane = mk_plane(clock=clock)
        plane.demote("c", [3], list(range(8)), 8, None)
        assert wait_until(lambda: _host_ready(plane, "c"))
        status, entry = plane.claim("c")
        plane.note_promoted(entry, "host", 0.1)
        plane.release(entry)
        assert plane.stats()["round_trips"] == 1
        plane.demote("c", [4], list(range(8)), 8, None)
        assert wait_until(lambda: _host_ready(plane, "c"))
        clock.advance(3600.0)
        status, entry = plane.claim("c")
        plane.note_promoted(entry, "host", 0.1)
        plane.release(entry)
        assert plane.stats()["round_trips"] == 1
        plane.stop()

    def test_timeout_claim_racing_spill_leaks_no_buffers(self):
        """A promote-timeout claim racing a queued spill leaks no host
        buffer: the spill owns its buffers and gives them back itself."""
        gate = threading.Event()

        class SlowStore(tpersist.InMemoryStore):
            def save_kv(self, cid, blob):
                gate.wait(30.0)
                super().save_kv(cid, blob)

        spec_bytes = page_payload_nbytes(FakeKVExec().kv_page_spec())
        cfg = KVTieringConfig(enabled=True, host_max_conversations=1,
                              promote_timeout_s=0.01)
        plane = KVTieringPlane(cfg, "leak", FakeKVExec())
        plane.pool = HostTierPool(2 * spec_bytes, spec_bytes)
        plane.store = SlowStore()
        plane.demote("c0", [1], list(range(8)), 8, None)
        assert wait_until(lambda: _host_ready(plane, "c0"))
        plane.demote("c1", [2], list(range(8)), 8, None)
        assert wait_until(
            lambda: plane._entries["c0"].spilling
            or plane._entries["c0"].tier == "store")
        deadline = time.perf_counter() + 30.0
        status = "wait"
        while time.perf_counter() < deadline:
            status, entry = plane.claim("c0")
            if status != "wait":
                break
            time.sleep(0.005)
        assert status == "ready" and entry.payload is None
        plane.release(entry)
        gate.set()
        assert wait_until(lambda: plane.pool.free_buffers() + 1
                          == plane.pool.total_buffers)
        plane.stop()

    def test_wait_since_resets_on_publish_and_restash(self):
        plane = mk_plane()
        gate = threading.Event()
        plane._submit(lambda: gate.wait(30.0))   # park the worker
        plane.demote("c", [3], list(range(8)), 8, None)
        assert plane.claim("c")[0] == "wait"
        with plane._mu:
            entry = plane._entries["c"]
        assert entry.wait_since is not None
        gate.set()
        assert wait_until(lambda: entry.ready.is_set())
        assert entry.wait_since is None
        status, got = plane.claim("c")
        assert status == "ready"
        got.wait_since = 123.0
        plane.restash("c", got)
        assert got.wait_since is None
        plane.stop()

    def test_async_degradation_fires_tier_change(self):
        class BrokenStore(tpersist.InMemoryStore):
            def save_kv(self, cid, blob):
                raise RuntimeError("store down")

        changes = []
        plane = mk_plane(KVTieringConfig(enabled=True, host_capacity_mb=0),
                         store=BrokenStore())
        plane.on_tier_change = lambda cid, tier: changes.append((cid, tier))
        plane.demote("c", [2], list(range(8)), 8, None)
        assert wait_until(lambda: plane.counts()["recompute"] == 1)
        assert ("c", "dropped") in changes
        assert plane.stats()["store_errors"] == 1
        plane.stop()

    def test_content_free_metadata_entry(self):
        class Echoish:
            kv_content_free = True

        plane = mk_plane(execu=Echoish())
        plane.demote("c", [1, 2], [9, 8, 7], 3, None)
        status, entry = plane.claim("c")
        assert status == "ready"
        assert entry.tier == "host" and entry.payload is None
        assert plane.content_free and plane.unpack(entry) is None
        plane.release(entry)
        plane.stop()

    @pytest.mark.parametrize("where", ["export", "copy"])
    def test_a_failed_transfer_is_counted_and_keeps_the_tokens(self, where):
        """No silent fallback: an export or a host copy that raises is
        counted in ``transfer_errors``, and the entry degrades to its
        token stream at once (no promote-timeout wait)."""

        class Lost:
            def detach(self):
                raise RuntimeError("device lost")

        class Broken(FakeKVExec):
            def export_kv_pages(self, pages):
                if where == "export":
                    raise RuntimeError("gather failed")
                return [Lost()]              # the host copy raises

        plane = mk_plane(execu=Broken())
        plane.demote("c", [3], [4, 5, 6], 3, None)
        assert wait_until(lambda: plane.counts()["recompute"] == 1)
        st = plane.stats()
        assert st["transfer_errors"] == 1
        assert plane.pool.free_buffers() == plane.pool.total_buffers
        status, entry = plane.claim("c")
        assert status == "ready" and entry.tokens == [4, 5, 6]
        plane.stop()

    def test_saved_rate_ranks_spills_before_recency(self):
        """Under ``saved_rate`` the conversation that saved the most
        prefill keeps its host residency, however cold; ``lru`` spills
        by recency alone."""
        led = get_usage_ledger()
        led.reconfigure(enabled=True)
        led._by_conversation["hot"] = type(
            "A", (), {"saved_prefill_device_s": 5.0,
                      "first_s": time.monotonic()})()
        assert led.conversation_saved_rate("hot") > 0
        assert led.conversation_saved_rate("cold") == 0.0
        for policy, spilled in (("saved_rate", "cold"), ("lru", "hot")):
            clock = FakeClock()
            plane = mk_plane(KVTieringConfig(enabled=True,
                                             host_max_conversations=2,
                                             eviction_policy=policy),
                             clock=clock, store=tpersist.InMemoryStore())
            for i, cid in enumerate(("hot", "cold", "new")):
                plane.demote(cid, [i + 1], list(range(8)), 8, None)
                assert wait_until(
                    lambda cid=cid: plane._entries[cid].ready.is_set()
                    or plane._entries[cid].spilling)
                clock.advance(1.0)
            assert wait_until(lambda: plane.counts()["store"] == 1)
            with plane._mu:
                assert plane._entries[spilled].tier == "store", policy
            plane.stop()

    def test_rehydrate_adopts_own_spilled_blobs(self):
        store = tpersist.InMemoryStore()
        plane = mk_plane(KVTieringConfig(enabled=True, host_capacity_mb=0),
                         store=store)
        plane.demote("c", [6], [1, 2, 3, 4], 4, 9)
        assert wait_until(lambda: store.load_kv("c") is not None)
        plane.stop()
        store.save_kv("xchg:c", b"ignored")
        fresh = mk_plane(store=store)
        assert fresh.rehydrate(owner="other") == []
        adopted = fresh.rehydrate(owner="test")
        assert [cid for cid, _ in adopted] == ["c"]
        assert adopted[0][1]["tokens"] == [1, 2, 3, 4]
        entry = _claim_ready(fresh, "c")
        assert entry.source_tier == "store" and entry.pending == 9
        assert np.all(fresh.unpack(entry).leaves()[0][:, 0] == 6.0)
        fresh.release(entry)
        fresh.stop()

    def test_same_script_same_counters_as_jaxs_plane(self):
        """Tolerance: none. One demote/spill/claim/forget script through
        both planes: the same counts, stats and hits at every step."""
        keys = ("entries", "host_entries", "store_entries",
                "recompute_entries", "demotions", "promotions", "spills",
                "round_trips", "store_errors", "hits", "page_payload_bytes")
        snaps = []
        for mod in (tiering, jtier):
            cfg = (KVTieringConfig if mod is tiering else JTierCfg)(
                enabled=True, host_max_conversations=2)
            store = (tpersist if mod is tiering
                     else jpersist).InMemoryStore()
            clock = (FakeClock if mod is tiering else JFakeClock)()
            plane = mk_plane(cfg, clock=clock, store=store, mod=mod)
            snap = []
            for i in range(4):
                plane.demote(f"c{i}", [i + 1, i + 9], list(range(16)), 16,
                             None)
                assert wait_until(
                    lambda i=i: plane._entries[f"c{i}"].ready.is_set())
                assert wait_until(lambda: plane.flush_jobs(1.0))
                clock.advance(1.0)
                snap.append({k: plane.stats()[k] for k in keys})
            for cid in ("c0", "c3"):
                entry = _claim_ready(plane, cid)
                plane.note_promoted(entry, entry.source_tier, 0.0)
                plane.release(entry)
            plane.forget("c1")
            assert wait_until(lambda: plane.flush_jobs(1.0))
            snap.append({k: plane.stats()[k] for k in keys})
            snap.append(sorted(store.list_kv()))
            plane.stop()
            snaps.append(snap)
        assert snaps[0] == snaps[1]


# -- prefix-cache demotion seam ------------------------------------------------


class TestPrefixCacheDemotionSeam:
    def _cache(self, pages=32, page_size=4):
        alloc = PageAllocator(pages, page_size)
        return alloc, PrefixCache(alloc, page_size)

    def test_default_is_plain_free(self):
        alloc, pc = self._cache()
        pages = alloc.alloc(2)
        pc.insert(list(range(8)), pages)
        alloc.free(pages)
        assert pc.evict_pages(2) == 2
        assert alloc.available() == alloc.total

    def test_callback_sees_token_path_and_page(self):
        alloc, pc = self._cache()
        pages = alloc.alloc(3)
        ids = list(range(12))
        pc.insert(ids, pages)
        alloc.free(pages)
        seen = []
        pc.set_demotion_callback(lambda path, page: seen.append(
            (list(path), page)))
        assert pc.evict_pages(3) == 3
        paths = sorted(seen, key=lambda s: len(s[0]))
        assert [p for p, _ in paths] == [ids[:4], ids[:8], ids[:12]]
        assert {pg for _, pg in seen} == set(pages)

    def test_callback_skipped_for_shared_pages(self):
        alloc, pc = self._cache()
        pages = alloc.alloc(1)
        pc.insert(list(range(4)), pages)
        seen = []
        pc.set_demotion_callback(lambda path, page: seen.append(page))
        assert pc._evict_locked(target_nodes=1) == 0
        assert seen == []
        alloc.free(pages)

    def test_invalidate_never_fires_callback(self):
        alloc, pc = self._cache()
        pages = alloc.alloc(2)
        ids = list(range(8))
        pc.insert(ids, pages)
        alloc.free(pages)
        seen = []
        pc.set_demotion_callback(lambda path, page: seen.append(page))
        assert pc.invalidate(ids) == 2
        assert seen == []

    def test_callback_failure_does_not_break_eviction(self):
        alloc, pc = self._cache()
        pages = alloc.alloc(2)
        pc.insert(list(range(8)), pages)
        alloc.free(pages)

        def boom(path, page):
            raise RuntimeError("demoter broke")

        pc.set_demotion_callback(boom)
        assert pc.evict_pages(2) == 2
        assert alloc.available() == alloc.total


# -- the stores' KV-payload seam -----------------------------------------------


class TestSqliteSpillStore:
    def test_kv_blob_roundtrip_and_delete_with_conversation(self, tmp_path):
        from llmq_tpu_torch.core.types import Conversation

        store = tpersist.SqliteStore(str(tmp_path / "kv.db"))
        blob = bytes(range(256)) * 17
        store.save_kv("c1", blob)
        assert store.load_kv("c1") == blob
        store.save_kv("c1", b"v2")
        assert store.load_kv("c1") == b"v2"
        assert store.list_kv() == ["c1"]
        store.delete_kv("c1")
        assert store.load_kv("c1") is None
        store.save(Conversation(id="c2", user_id="u", created_at=1.0,
                                updated_at=1.0, last_active_at=1.0))
        store.save_kv("c2", b"x")
        store.delete("c2")                   # the blob goes with it
        assert store.load_kv("c2") is None
        store.close()

    def test_migration_on_pre_tiering_db(self, tmp_path):
        import sqlite3

        path = str(tmp_path / "old.db")
        conn = sqlite3.connect(path)
        conn.execute(
            """CREATE TABLE conversations (
                id TEXT PRIMARY KEY, user_id TEXT NOT NULL,
                state TEXT NOT NULL, context TEXT NOT NULL DEFAULT '',
                messages TEXT NOT NULL DEFAULT '[]',
                metadata TEXT NOT NULL DEFAULT '{}',
                created_at REAL NOT NULL, updated_at REAL NOT NULL,
                last_active_at REAL NOT NULL)""")
        conn.commit()
        conn.close()
        store = tpersist.SqliteStore(path)
        store.save_kv("c", b"payload")
        assert store.load_kv("c") == b"payload"
        store.close()
        # The JAX package's store reads the same file, and vice versa.
        jstore = jpersist.SqliteStore(path)
        assert jstore.load_kv("c") == b"payload"
        jstore.save_kv("d", b"from jax")
        jstore.close()
        store = tpersist.SqliteStore(path)
        assert sorted(store.list_kv()) == ["c", "d"]
        assert store.load_kv("d") == b"from jax"
        store.close()

    def test_busy_timeout_and_wal_set(self, tmp_path):
        store = tpersist.SqliteStore(str(tmp_path / "t.db"))
        conn = store._conn()
        assert conn.execute("PRAGMA busy_timeout").fetchone()[0] == 10000
        assert conn.execute(
            "PRAGMA journal_mode").fetchone()[0].lower() == "wal"
        store.close()

    def test_concurrent_save_load_never_locks(self, tmp_path):
        from llmq_tpu_torch.core.types import Conversation

        store = tpersist.SqliteStore(str(tmp_path / "conc.db"))
        errors = []
        stop = threading.Event()

        def worker(wid):
            try:
                for i in range(120):
                    cid = f"c{wid}-{i % 7}"
                    store.save_kv(cid, bytes([wid]) * 2048)
                    store.load_kv(cid)
                    store.save(Conversation(
                        id=cid, user_id=f"u{wid}", created_at=1.0,
                        updated_at=1.0, last_active_at=1.0))
                    store.load(cid)
                    if i % 11 == 0:
                        store.delete_kv(cid)
                    if stop.is_set():
                        return
            except Exception as e:  # noqa: BLE001 — collected for assert
                errors.append(e)
                stop.set()

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        store.close()


class _KVRedis:
    """The redis calls RedisStore's KV-payload seam makes."""

    def __init__(self):
        self.kv = {}

    def set(self, k, v, ex=None):
        self.kv[k] = v

    def get(self, k):
        return self.kv.get(k)

    def delete(self, k):
        self.kv.pop(k, None)

    def keys(self, pattern):
        pre = pattern.rstrip("*")
        return [k.encode() for k in self.kv if k.startswith(pre)]


def test_memory_and_redis_kv_seams_match_jaxs():
    """Tolerance: none. The same operations on the port's and JAX's
    memory and redis stores leave the same blobs and listings."""
    for make in (lambda m: m.InMemoryStore(),
                 lambda m: m.RedisStore(prefix="t:", client=_KVRedis())):
        t, j = make(tpersist), make(jpersist)
        for s in (t, j):
            s.save_kv("a", b"\x00\x01")
            s.save_kv("b", b"\xff" * 9)
            s.save_kv("a", b"\x02")
            s.delete_kv("b")
        assert sorted(t.list_kv()) == sorted(j.list_kv()) == ["a"]
        assert t.load_kv("a") == j.load_kv("a") == b"\x02"
        assert t.load_kv("b") is j.load_kv("b") is None


# -- engines on the tiny model -------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = J.llama3_tiny(dtype=jnp.float32, **KW)
    jparams = J.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = T.llama3_tiny(dtype=torch.float32, **KW)
    tparams = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _torch_engine(models, tiering_cfg=None, *, kv="bf16", expire=True,
                  clock=None, prefix=False, pipeline=False, name="tiertest",
                  metrics=False, num_pages=64):
    _jcfg, _jp, tcfg, tparams = models
    tok = ByteTokenizer()
    geom = dict(GEOM, num_pages=num_pages)
    ex = TorchExecutor(tcfg, tparams, eos_id=tok.eos_id, device="cpu",
                       cache_dtype=KV_DTYPES[kv][1], **geom)
    return InferenceEngine(
        ex, tok, name=name, enable_metrics=metrics, max_decode_steps=12,
        clock=clock or FakeClock(), kv_pin_ttl=5.0 if expire else 600.0,
        kv_tiering=tiering_cfg,
        prefix_cache=PrefixCacheConfig(enabled=True) if prefix else None,
        async_pipeline=(AsyncPipelineConfig(enabled=True, depth=2)
                        if pipeline else None))


def run_torch_two_turns(models, tiering_cfg, store=None, expire=True,
                        kv="bf16", **kw):
    """The port's counterpart of JAX's ``run_jax_two_turns``."""
    clock = FakeClock()
    eng = _torch_engine(models, tiering_cfg, kv=kv, expire=expire,
                        clock=clock, **kw)
    if store is not None and eng._tiering is not None:
        eng._tiering.store = store
    h1 = eng.submit(GenRequest(id="t1", prompt="the quick brown fox",
                               conversation_id="c", max_new_tokens=10))
    eng.run_until_idle()
    if expire:
        clock.advance(6.0)
        eng.step()
        assert "c" not in eng.cached_conversations()
        if eng._tiering is not None:
            assert wait_until(lambda: sum(
                eng._tiering.counts().values()) == 1)
    h2 = eng.submit(GenRequest(id="t2", prompt=" jumps over",
                               conversation_id="c", max_new_tokens=10))
    eng.run_until_idle()
    eng.stop()
    return eng, (h1, h2)


def run_jax_two_turns(models, tiering_cfg, store=None, expire=True,
                      kv="bf16"):
    """``tests/test_kv_tiering.py``'s scenario, on the f32 model."""
    jcfg, jparams, _tcfg, _tp = models
    tok = JTok()
    ex = JaxExecutor(jcfg, jparams, eos_id=tok.eos_id,
                     cache_dtype=KV_DTYPES[kv][0], **GEOM)
    clock = JFakeClock()
    eng = JEngine(ex, tok, enable_metrics=False, max_decode_steps=12,
                  clock=clock, kv_pin_ttl=5.0 if expire else 600.0,
                  kv_tiering=tiering_cfg)
    if store is not None and eng._tiering is not None:
        eng._tiering.store = store
    h1 = eng.submit(JGenRequest(id="t1", prompt="the quick brown fox",
                                conversation_id="c", max_new_tokens=10))
    eng.run_until_idle()
    if expire:
        clock.advance(6.0)
        eng.step()
        assert "c" not in eng.cached_conversations()
        if eng._tiering is not None:
            assert wait_until(lambda: sum(
                eng._tiering.counts().values()) == 1)
    h2 = eng.submit(JGenRequest(id="t2", prompt=" jumps over",
                                conversation_id="c", max_new_tokens=10))
    eng.run_until_idle()
    eng.stop()
    return eng, (h1, h2)


@pytest.fixture(scope="module")
def baselines(models):
    """Per KV dtype: the pin-resident streams of both packages (equal)."""
    out = {}
    for kv in KV_DTYPES:
        _, jb = run_jax_two_turns(models, None, expire=False, kv=kv)
        _, tb = run_torch_two_turns(models, None, expire=False, kv=kv)
        jt = [h.result.tokens for h in jb]
        assert all(jt) and jt == [h.result.tokens for h in tb], kv
        out[kv] = jt
    return out


def _tier_cfgs(tier, mod_cfg):
    return {"host": mod_cfg(enabled=True),
            "store": mod_cfg(enabled=True, host_capacity_mb=0),
            "recompute": mod_cfg(enabled=True, host_capacity_mb=0,
                                 store_spill=False)}[tier]


class TestEnginesTokenForToken:
    @pytest.mark.parametrize("kv", list(KV_DTYPES))
    @pytest.mark.parametrize("tier", ["host", "store", "recompute"])
    def test_every_tier_matches_jax_and_the_resident_pin(self, models,
                                                         baselines, tmp_path,
                                                         tier, kv):
        """Tolerance: none. Turn 2 after a host, store (SQLite) or
        recompute promotion decodes exactly as the pin-resident baseline
        and as the JAX engine through the same tier; the tier's hit (and
        the spill) is counted alike in both."""
        stores = {}
        if tier == "store":
            stores = {"t": tpersist.SqliteStore(str(tmp_path / "t.db")),
                      "j": jpersist.SqliteStore(str(tmp_path / "j.db"))}
        teng, tout = run_torch_two_turns(
            models, _tier_cfgs(tier, KVTieringConfig), store=stores.get("t"),
            kv=kv)
        jeng, jout = run_jax_two_turns(
            models, _tier_cfgs(tier, JTierCfg), store=stores.get("j"), kv=kv)
        ts, js = teng.get_stats()["kv_tiering"], \
            jeng.get_stats()["kv_tiering"]
        assert ts["hits"] == js["hits"] and ts["hits"][tier] == 1, (ts, js)
        assert ts["spills"] == js["spills"] == (1 if tier == "store" else 0)
        assert ts["transfer_errors"] == ts["inject_failures"] == 0
        assert [h.result.tokens for h in tout] == baselines[kv]
        assert [h.result.tokens for h in jout] == baselines[kv]
        assert tout[1].result.kv_tier == jout[1].result.kv_tier == tier
        assert (tout[1].result.cached_tokens
                == jout[1].result.cached_tokens)
        if tier != "recompute":
            assert tout[1].result.cached_tokens > 0
        if kv == "int8":
            assert len(teng.executor.kv_page_spec()) == 4
        for s in stores.values():
            s.close()

    def test_a_blob_the_jax_engine_spilled_serves_the_port(self, models,
                                                           baselines,
                                                           tmp_path):
        """Tolerance: none on the tokens. The JAX engine spills turn 1 of
        a bf16-KV conversation to a SQLite store; the port's engine over
        the same file rehydrates it (its owner renamed) and serves turn 2
        as a store hit, with the pin-resident baseline's tokens."""
        path = str(tmp_path / "shared.db")
        jstore = jpersist.SqliteStore(path)
        run_jax_two_turns(models, JTierCfg(enabled=True, host_capacity_mb=0),
                          store=jstore)
        blob = jstore.load_kv("c")
        jstore.close()
        assert blob is not None
        bufs, specs = decode_blob(blob)
        meta = tiering.blob_meta(blob)
        meta["owner"] = "porttest"
        store = tpersist.SqliteStore(path)
        store.save_kv("c", encode_blob(bufs, specs, meta=meta))
        eng = _torch_engine(models, KVTieringConfig(enabled=True),
                            name="porttest")
        eng._tiering.store = store
        assert eng.rehydrate_tiered_conversations() == 1
        h = eng.submit(GenRequest(id="t2", prompt=" jumps over",
                                  conversation_id="c", max_new_tokens=10))
        eng.run_until_idle()
        eng.stop()
        assert h.result.kv_tier == "store"
        assert eng.get_stats()["kv_tiering"]["hits"]["store"] == 1
        assert h.result.tokens == baselines["bf16"][1]
        store.close()

    def test_async_pipeline_and_prefix_cache_interplay(self, models,
                                                       baselines):
        """The serving defaults (async pipeline at depth 2, prefix cache
        on) with the loop running on its own thread: the pin demoted by
        TTL is promoted as a host hit, and the streams are the
        baseline's."""
        clock = FakeClock()
        eng = _torch_engine(models, KVTieringConfig(enabled=True),
                            clock=clock, prefix=True, pipeline=True)
        eng.start()
        h1 = eng.submit(GenRequest(id="t1", prompt="the quick brown fox",
                                   conversation_id="c", max_new_tokens=10))
        assert h1.wait(60.0)
        clock.advance(6.0)
        assert wait_until(lambda: "c" not in eng.cached_conversations())
        assert wait_until(lambda: eng.get_stats()["kv_tiering"]
                          ["host_entries"] == 1)
        h2 = eng.submit(GenRequest(id="t2", prompt=" jumps over",
                                   conversation_id="c", max_new_tokens=10))
        assert h2.wait(60.0)
        st = eng.get_stats()["kv_tiering"]
        eng.stop()
        assert st["hits"]["host"] == 1, st
        assert [h1.result.tokens, h2.result.tokens] == baselines["bf16"]

    def test_pool_pressure_demotes_instead_of_killing(self, models):
        """A fat request that reclaims an idle pin under pool pressure
        demotes it: the conversation's return is a host hit."""
        eng = _torch_engine(models, KVTieringConfig(enabled=True),
                            expire=False, num_pages=17)
        for rid, prompt, conv in (("t1", "x" * 40, "alpha"),
                                  ("big", "y" * 100, "")):
            h = eng.submit(GenRequest(id=rid, prompt=prompt,
                                      conversation_id=conv,
                                      max_new_tokens=4))
            eng.run_until_idle()
            assert h.result.finish_reason in ("eos", "length")
        assert "alpha" not in eng.cached_conversations()
        assert eng.get_stats()["kv_tiering"]["demotions"] == 1
        h = eng.submit(GenRequest(id="t2", prompt="more text",
                                  conversation_id="alpha",
                                  max_new_tokens=4))
        eng.run_until_idle()
        assert h.result.cached_tokens > 0 and h.result.kv_tier == "host"
        assert eng.get_stats()["kv_tiering"]["hits"]["host"] == 1
        eng.stop()

    def test_off_switch_builds_nothing_and_matches(self, models, baselines):
        """``enabled: false``: no plane, no ``kv-tiering`` thread, no stats
        block, and the resident streams unchanged."""
        before = {t.name for t in threading.enumerate()}
        eng, out = run_torch_two_turns(
            models, KVTieringConfig(enabled=False), expire=False)
        assert eng._tiering is None and "kv_tiering" not in eng.get_stats()
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("kv-tiering")
                    and t.name not in before]
        assert [h.result.tokens for h in out] == baselines["bf16"]
        assert out[1].result.kv_tier == ""


# -- prefix-handle tiers -------------------------------------------------------


def _run_turn(eng, rid, prompt, conv, tokens=8):
    h = eng.submit(GenRequest(id=rid, prompt=prompt, conversation_id=conv,
                              max_new_tokens=tokens))
    eng.run_until_idle()
    assert h.result is not None and h.result.finish_reason in ("eos",
                                                               "length")
    return h


class TestPrefixHandleTier:
    def test_handle_outlives_residency_estimate_per_tier(self, models):
        """After the pin is reclaimed the handle survives and its tier
        decides the estimate: demoted (tiering on) stays cached; tiering
        off with the radix tree emptied is dropped, all new."""
        for tcfg, expect_cached in ((KVTieringConfig(enabled=True), True),
                                    (None, False)):
            clock = FakeClock()
            eng = _torch_engine(models, tcfg, clock=clock, prefix=True)
            sm = StateManager(ConversationConfig(), clock=clock)
            eng.attach_conversation_manager(sm)
            sm.get_or_create("c", "u")
            _run_turn(eng, "t1", "hello world conversation", "c")
            h = sm.prefix_handle("c")
            assert h is not None and h["tier"] == "hbm"
            assert eng.prefill_estimate("c", 10)[0] > 0
            if tcfg is None:
                eng._prefix_cache.invalidate_all()
            clock.advance(6.0)
            eng.step()
            assert "c" not in eng.cached_conversations()
            h = sm.prefix_handle("c")
            assert h is not None
            assert h["tier"] == ("host" if tcfg else "dropped")
            cached, new = eng.prefill_estimate("c", 10)
            assert (cached > 0) == expect_cached and new == 10
            eng.stop()
            sm.stop()

    def test_estimate_stays_optimistic_with_radix_fallback(self, models):
        clock = FakeClock()
        eng = _torch_engine(models, None, clock=clock, prefix=True)
        sm = StateManager(ConversationConfig(), clock=clock)
        eng.attach_conversation_manager(sm)
        sm.get_or_create("c", "u")
        _run_turn(eng, "t1", "hello world conversation", "c")
        clock.advance(6.0)
        eng.step()
        assert sm.prefix_handle("c")["tier"] == "hbm"
        assert eng.prefill_estimate("c", 10)[0] > 0
        eng.stop()
        sm.stop()

    def test_promotion_moves_handle_back_to_hbm_and_store_follows(
            self, models):
        """The handle goes host → hbm on promotion; a spill on the worker
        moves it to "store" through ``on_tier_change``; the state
        manager's store is the spill store."""
        clock = FakeClock()
        eng = _torch_engine(models, KVTieringConfig(enabled=True),
                            clock=clock, prefix=True)
        sm = StateManager(ConversationConfig(), clock=clock,
                          store=tpersist.InMemoryStore())
        eng.attach_conversation_manager(sm)
        assert eng._tiering.store is sm.store
        sm.get_or_create("c", "u")
        _run_turn(eng, "t1", "hello world", "c")
        clock.advance(6.0)
        eng.step()
        assert sm.prefix_handle("c")["tier"] == "host"
        _run_turn(eng, "t2", " again", "c")
        assert sm.prefix_handle("c")["tier"] == "hbm"
        eng._tiering.host_max_conversations = 1
        sm.get_or_create("d", "u")
        _run_turn(eng, "d1", "another conversation", "d")
        clock.advance(6.0)
        eng.step()                            # c and d demote; c spills
        assert wait_until(lambda: sm.prefix_handle("c")["tier"] == "store")
        assert sm.store.load_kv("c") is not None
        eng.stop()
        sm.stop()

    def test_update_prefix_handle_tier_contract(self):
        sm = StateManager(ConversationConfig())
        assert not sm.update_prefix_handle_tier("nope", "host")
        sm.get_or_create("c", "u")
        assert not sm.update_prefix_handle_tier("c", "host")
        sm.record_prefix_handle("c", {"length": 32, "pages": 4,
                                      "tier": "hbm"})
        assert sm.update_prefix_handle_tier("c", "store")
        assert sm.prefix_handle("c")["tier"] == "store"
        assert sm.prefix_handle("c")["length"] == 32

    def test_delete_forgets_every_tier(self, models):
        clock = FakeClock()
        eng = _torch_engine(models, KVTieringConfig(enabled=True),
                            clock=clock)
        sm = StateManager(ConversationConfig(), clock=clock)
        eng.attach_conversation_manager(sm)
        sm.get_or_create("c", "u")
        _run_turn(eng, "t1", "private content", "c")
        clock.advance(6.0)
        eng.step()
        assert eng.get_stats()["kv_tiering"]["entries"] == 1
        sm.delete("c")
        assert eng.get_stats()["kv_tiering"]["entries"] == 0
        _run_turn(eng, "t2", "fresh start", "c")
        assert eng.get_stats()["kv_tiering"]["promotions"] == 0
        eng.stop()
        sm.stop()

    def test_unpin_at_demotion_bills_tenant(self, models):
        """The HBM pin's page-second meter closes at demotion, on the
        pinning tenant."""
        led = get_usage_ledger()
        led.reconfigure(enabled=True)
        led.clear()
        eng = _torch_engine(models, KVTieringConfig(enabled=True),
                            clock=None)
        eng._now = time.monotonic
        eng.kv_pin_ttl = 0.05
        h = eng.submit(GenRequest(id="t1", prompt="hello world billing",
                                  conversation_id="c", max_new_tokens=8,
                                  tenant_id="acme"))
        eng.run_until_idle()
        assert h.result.finish_reason in ("eos", "length")
        time.sleep(0.08)
        eng.step()
        assert "c" not in eng.cached_conversations()
        snap = led.snapshot()
        assert snap["totals"]["pinned_kv_page_seconds"] > 0
        assert snap["tenants"]["acme"]["kv_page_seconds"] > 0
        eng.stop()


# -- the executor seam ---------------------------------------------------------


def _filled_executors(models, kv):
    """A JAX and a port executor whose pools hold the same random bytes
    (JAX's carried across), plus a second port executor with empty
    pools."""
    jcfg, jparams, tcfg, tparams = models
    jd, td = KV_DTYPES[kv]
    jex = JaxExecutor(jcfg, jparams, eos_id=2, cache_dtype=jd, **GEOM)
    rng = np.random.default_rng(3)
    filled = {}
    for name, leaf in jex.cache.items():
        shape, dt = leaf.shape, np.dtype(leaf.dtype)
        if dt == np.int8:
            a = rng.integers(-128, 128, shape).astype(np.int8)
        else:
            a = rng.standard_normal(shape).astype(dt)
        filled[name] = jnp.asarray(a)
    jex.cache = filled
    tex = TorchExecutor(tcfg, tparams, eos_id=2, device="cpu",
                        cache_dtype=td, **GEOM)
    dst = TorchExecutor(tcfg, tparams, eos_id=2, device="cpu",
                        cache_dtype=td, **GEOM)
    for name, pool in tex.cache.items():
        a = np.array(filled[name])
        pool.copy_(torch.from_numpy(a.view(f"i{a.dtype.itemsize}")).view(
            pool.dtype))
    return jex, tex, dst


def _bytes(t):
    t = t.detach().contiguous()
    return t.view(torch.uint8).numpy() if t.dtype != torch.bfloat16 \
        else t.view(torch.int16).numpy().view(np.uint8)


class TestExecutorSeam:
    @pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
    def test_kv_page_spec_is_jaxs(self, models, kv):
        """Tolerance: none. Leaf order (k, k_scale, v, v_scale: JAX's
        tree order, not the pool dict's insertion order), shapes and dtype
        names; the per-page payload size too."""
        jcfg, jparams, tcfg, tparams = models
        jd, td = KV_DTYPES.get(kv, (None, None))
        jspec = JaxExecutor(jcfg, jparams, eos_id=2, cache_dtype=jd,
                            **GEOM).kv_page_spec()
        tex = TorchExecutor(tcfg, tparams, eos_id=2, device="cpu",
                            cache_dtype=td, **GEOM)
        tspec = tex.kv_page_spec()
        assert [s for s, _ in tspec] == [tuple(s) for s, _ in jspec]
        assert [d for _, d in tspec] == [np.dtype(d).name for _, d in jspec]
        assert page_payload_nbytes(tspec) == jtier.page_payload_nbytes(jspec)
        if kv == "int8":
            assert list(tex.cache) == ["k", "v", "k_scale", "v_scale"]

    @pytest.mark.parametrize("kv", list(KV_DTYPES))
    def test_jax_pages_carry_into_the_ports_pool_byte_for_byte(self, models,
                                                              kv):
        """Tolerance: none. The port's export of the same pool bytes
        equals JAX's per leaf; JAX's exported leaves imported into a fresh
        port pool, and the port's own export imported through the plane's
        page-major payload, land byte for byte at the new pages."""
        jex, tex, dst = _filled_executors(models, kv)
        pages, fresh = [5, 2, 9], [11, 3, 7]
        jleaves = [np.asarray(a) for a in jex.export_kv_pages(pages)]
        tleaves = tex.export_kv_pages(pages)
        assert len(tleaves) == len(jleaves)
        for j, t in zip(jleaves, tleaves):
            assert np.array_equal(j.view(np.uint8), _bytes(t))
        names = tex._kv_leaves()
        dst.import_kv_pages(fresh, jleaves)
        for name in names:
            for p_src, p_dst in zip(pages, fresh):
                assert np.array_equal(_bytes(dst.cache[name][:, p_dst]),
                                      _bytes(tex.cache[name][:, p_src]))
        # Through the plane: packed export → host buffers → payload.
        plane = KVTieringPlane(KVTieringConfig(enabled=True), "seam", tex)
        bufs = plane.pool.take(len(pages))
        assert plane._copy_out(tleaves, bufs)
        ref, _ = _packed(jtier, jleaves)
        for a, b in zip(bufs, ref):
            assert np.array_equal(a, b)
        payload = tiering.PagePayload(bufs, tex.kv_page_spec(), plane.pool)
        other = [13, 14, 15]
        assert dst.import_kv_pages(other, payload) is None   # CPU: no fence
        for name in names:
            for p_src, p_dst in zip(pages, other):
                assert np.array_equal(_bytes(dst.cache[name][:, p_dst]),
                                      _bytes(tex.cache[name][:, p_src]))
        plane.stop()


# -- metrics -------------------------------------------------------------------


def test_metric_families_exposed_and_hits_counted(models):
    from llmq_tpu_torch.metrics.registry import exposition

    clock = FakeClock()
    eng = _torch_engine(models, KVTieringConfig(enabled=True), clock=clock,
                        metrics=True, name="tiermetrics")
    _run_turn(eng, "t1", "metric text", "c")
    clock.advance(6.0)
    eng.step()
    assert wait_until(lambda: eng.get_stats()["kv_tiering"]
                      ["host_entries"] == 1)
    _run_turn(eng, "t2", " more", "c")
    exp = exposition().decode()
    for fam in ("llm_queue_kv_tier_pages", "llm_queue_kv_tier_bytes",
                "llm_queue_kv_tier_hits_total",
                "llm_queue_kv_tier_round_trips_total",
                "llm_queue_kv_promote_ms", "llm_queue_kv_demote_ms"):
        assert fam in exp, fam
    assert ('llm_queue_kv_tier_hits_total{engine="tiermetrics",'
            'tier="host"}') in exp
    assert 'llm_queue_kv_demote_ms_count{engine="tiermetrics"}' in exp
    assert ('llm_queue_kv_tier_pages{engine="tiermetrics",tier="hbm"}'
            in exp)
    eng.stop()
