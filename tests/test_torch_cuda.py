"""CUDA-only checks of the port's kernels: each kernel against its plain
twin on the card, at small shapes. They skip on a host without CUDA;
on the card run them with the JAX-free command

    python -m pytest --noconftest tests/test_torch_cuda.py

(``tests/conftest.py`` imports JAX, which the card's machine need not
have). Tolerances: attention atol 2e-2 (bf16 outputs on unit-scale
inputs; the twins round probabilities to bf16 before P @ V), writes
bit-exact over the whole pool. Over long histories an output element is
small (about sqrt(e / n) over n keys: 0.037 at 2000), so there 2e-2
alone would pass a kernel that loses a 64-key tile: the split-K and
flash kernels' tests also hold each (row, head) to REL_TOL of the
twin's RMS.
"""

import pytest
import torch

from llmq_tpu_torch.ops import kernels

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

H, HKV, D, PS, L, P, MP = 8, 2, 128, 16, 2, 64, 16
GD = HKV * D
ATOL = 2e-2
REL_TOL = 0.1


def _scaled_err(out, ref):
    """Largest max |out - ref| / RMS(ref) over the (row, head) vectors
    whose reference is not all zero."""
    d = (out.float() - ref.float()).abs().amax(-1)
    rms = ref.float().pow(2).mean(-1).sqrt()
    live = rms > 0
    return (d[live] / rms[live]).max().item()


def _rand(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _pools(gen):
    return _rand((L, P, PS, GD), gen), _rand((L, P, PS, GD), gen)


def _desc(*cols):
    """Per-row int32 descriptors (kernels 2 and 3) on the card."""
    return [torch.tensor(c, dtype=torch.int32, device="cuda") for c in cols]


def _attn1(fn, q, kp, vp, bt, start, layer):
    """Kernel 3 (or its twin) for one chunk q (T, H, D) at ``start``, all
    T tokens live: the batched call with N = 1."""
    return fn(q[None], kp, vp, bt[None], *_desc([start], [q.shape[0]]),
              layer)[0]


@needs_cuda
def test_fused_decode_matches_twin():
    gen = torch.Generator(device="cuda").manual_seed(0)
    kp, vp = _pools(gen)
    lens = [1, 16, 17, 70, 0]
    B = len(lens)
    bt = torch.zeros((B, MP), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lens):
        pages = -(-n // PS)
        bt[b, :pages] = torch.arange(nxt, nxt + pages, dtype=torch.int32)
        nxt += pages
    sl = torch.tensor(lens, dtype=torch.int32)
    wp = torch.where(sl > 0, bt[torch.arange(B), (sl - 1).clamp(min=0) // PS],
                     torch.zeros_like(sl))
    bt, sl, wp = bt.cuda(), sl.cuda(), wp.cuda()
    q, kn, vn = _rand((B, H, D), gen), _rand((B, HKV, D), gen), \
        _rand((B, HKV, D), gen)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = kernels.LAUNCHES["fused_decode"]
    a = kernels.fused_decode(q, kn, vn, k1, v1, bt, sl, wp, 1)
    b = kernels.fused_decode_plain(q, kn, vn, k2, v2, bt, sl, wp, 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_decode"] == before + 1
    assert (a[:4].float() - b[:4].float()).abs().max().item() <= ATOL
    assert torch.all(a[4] == 0)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@needs_cuda
@pytest.mark.parametrize("T,start,n_tok", [(64, 0, 64), (64, 37, 60)])
def test_prefill_write_and_attention_match_twins(T, start, n_tok):
    gen = torch.Generator(device="cuda").manual_seed(T + start)
    kp, vp = _pools(gen)
    bt = torch.randperm(P - 1, generator=torch.Generator().manual_seed(1))
    bt = (bt[:MP] + 1).to(torch.int32).cuda()
    rk, rv = _rand((T, GD), gen), _rand((T, GD), gen)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    desc = _desc([0], [n_tok], [start])
    kernels.kv_prefill_write(k1, v1, rk, rv, bt[None], *desc, T, 0)
    kernels.kv_prefill_write_plain(k2, v2, rk, rv, bt[None], *desc, T, 0)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    q = _rand((T, H, D), gen)
    a = _attn1(kernels.prefill_attention, q, k1, v1, bt, start, 0)
    b = _attn1(kernels.prefill_attention_plain, q, k1, v1, bt, start, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    assert (a[:n_tok].float() - b[:n_tok].float()).abs().max().item() <= ATOL


def _kernel3_case(gen, D_, n_rep, T, start, hkv=HKV):
    """A one-layer pool with room for positions [0, start + T), its pages
    in shuffled order, and a chunk q (T, hkv * n_rep, D_)."""
    n_pages = -(-(start + T) // PS)
    kp = _rand((1, n_pages + 4, PS, hkv * D_), gen)
    vp = _rand((1, n_pages + 4, PS, hkv * D_), gen)
    perm = torch.randperm(n_pages + 3, generator=torch.Generator()
                          .manual_seed(T + start))
    bt = (perm[:n_pages] + 1).to(torch.int32).cuda()
    return _rand((T, hkv * n_rep, D_), gen), kp, vp, bt


@needs_cuda
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("D_", [64, 128])
@pytest.mark.parametrize("start", [0, 37, 1000])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 512])
def test_prefill_attention_tiles_match_twin(T, start, D_, n_rep):
    """Kernel 3 (wgmma flash) against its twin across the 64-row and
    64-key tile edges, fresh and over history, at every instantiated
    head geometry; within 2e-2 and REL_TOL of the twin's scale."""
    gen = torch.Generator(device="cuda").manual_seed(T * 7 + start + D_ + n_rep)
    q, kp, vp, bt = _kernel3_case(gen, D_, n_rep, T, start)
    before = kernels.LAUNCHES["prefill_attention"]
    a = _attn1(kernels.prefill_attention, q, kp, vp, bt, start, 0)
    b = _attn1(kernels.prefill_attention_plain, q, kp, vp, bt, start, 0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["prefill_attention"] == before + 1
    assert torch.isfinite(a).all()
    assert (a.float() - b.float()).abs().max().item() <= ATOL
    assert _scaled_err(a, b) <= REL_TOL


@needs_cuda
@pytest.mark.parametrize("T,start", [(2048, 0), (2047, 37)])
def test_prefill_attention_two_warpgroups_match_twin(T, start):
    """A long chunk at llama3-8b's heads (H=32, H_kv=8, D=128): enough
    CTAs that two warpgroups share each K/V tile; within 2e-2 and
    REL_TOL of the twin's scale."""
    gen = torch.Generator(device="cuda").manual_seed(T + start)
    q, kp, vp, bt = _kernel3_case(gen, 128, 4, T, start, hkv=8)
    a = _attn1(kernels.prefill_attention, q, kp, vp, bt, start, 0)
    b = _attn1(kernels.prefill_attention_plain, q, kp, vp, bt, start, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    assert (a.float() - b.float()).abs().max().item() <= ATOL
    assert _scaled_err(a, b) <= REL_TOL


@needs_cuda
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("D_", [64, 128])
def test_fused_decode_splits_match_twin_twice(D_, n_rep):
    """Kernel 1 (split-K) with seq_lens 0, 1, the 64-position tile's
    edges, CHUNK - 1, CHUNK, CHUNK + 1 and 2000, plus an inactive row:
    two launches on the same cached workspace give the same output (the
    arrival counters are back at 0), within 2e-2 and REL_TOL of the
    twin's scale; pools bit-exact; the empty row exactly 0."""
    chunk = kernels.FUSED_DECODE_CHUNK
    lens = [0, 1, 63, 64, 65, chunk - 1, chunk, chunk + 1, 2000, 5]
    B, mp = len(lens), 128
    gen = torch.Generator(device="cuda").manual_seed(D_ * 10 + n_rep)
    n_pages = sum(-(-n // PS) for n in lens[:-1])
    kp = _rand((2, n_pages + 2, PS, HKV * D_), gen)
    vp = _rand((2, n_pages + 2, PS, HKV * D_), gen)
    bt = torch.zeros((B, mp), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lens[:-1]):
        pages = -(-n // PS)
        bt[b, :pages] = torch.arange(nxt, nxt + pages, dtype=torch.int32)
        nxt += pages
    sl = torch.tensor(lens, dtype=torch.int32)
    wp = torch.where(sl > 0, bt[torch.arange(B), (sl - 1).clamp(min=0) // PS],
                     torch.zeros_like(sl))
    wp[-1] = 0                                   # inactive: null page
    bt, sl, wp = bt.cuda(), sl.cuda(), wp.cuda()
    H_ = HKV * n_rep
    q = _rand((B, H_, D_), gen)
    kn, vn = _rand((B, HKV, D_), gen), _rand((B, HKV, D_), gen)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = kernels.LAUNCHES["fused_decode"]
    a1 = kernels.fused_decode(q, kn, vn, k1, v1, bt, sl, wp, 1)
    a2 = kernels.fused_decode(q, kn, vn, k1, v1, bt, sl, wp, 1)
    b = kernels.fused_decode_plain(q, kn, vn, k2, v2, bt, sl, wp, 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_decode"] == before + 2
    live = slice(1, B - 1)
    assert (a1[live].float() - b[live].float()).abs().max().item() <= ATOL
    assert _scaled_err(a1[live], b[live]) <= REL_TOL
    assert torch.equal(a1[:B - 1], a2[:B - 1])
    assert torch.all(a1[0] == 0) and torch.all(a2[0] == 0)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    n_splits = kernels.fused_decode_splits(mp, PS)
    _, counters = kernels.split_workspace("fused_decode", q.device, B, HKV,
                                          n_rep, D_, n_splits)
    assert not counters.any()


#: Decode lengths across the split body's 64-position tile and the
#: default 128-position chunk, empty and long, and an inactive row (5,
#: writing the null page) last.
SPLIT_LENS = [0, 1, 63, 64, 65, 127, 128, 129, 2000]


def _split_rows(gen, D_, lens, mp, extra_pages=0):
    """Pools with room for ``lens`` on consecutive pages from page 1 (and
    ``extra_pages`` more), the rows' block tables, seq_lens, and the
    pages their newest token lands in (0 for an empty row)."""
    n_pages = sum(-(-n // PS) for n in lens) + extra_pages
    kp = _rand((2, n_pages + 2, PS, HKV * D_), gen)
    vp = _rand((2, n_pages + 2, PS, HKV * D_), gen)
    B = len(lens)
    bt = torch.zeros((B, mp), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lens):
        pages = -(-n // PS)
        bt[b, :pages] = torch.arange(nxt, nxt + pages, dtype=torch.int32)
        nxt += pages
    sl = torch.tensor(lens, dtype=torch.int32)
    wp = torch.where(sl > 0, bt[torch.arange(B), (sl - 1).clamp(min=0) // PS],
                     torch.zeros_like(sl))
    return kp, vp, bt, sl, wp, nxt


@needs_cuda
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("D_", [64, 128])
def test_paged_decode_splits_match_twin_twice(D_, n_rep):
    """Kernel 8 (kernel 1's split-K body, no new token: every position
    read from the pool) at seq_lens 0, 1, the 64-position tile's and the
    128-position chunk's edges and 2000: two launches on the same cached
    workspace give the same output, within 2e-2 and REL_TOL of the
    twin's scale; the empty row exactly 0; its counters back at 0 and
    apart from kernel 1's."""
    gen = torch.Generator(device="cuda").manual_seed(D_ * 20 + n_rep)
    mp = 128
    kp, vp, bt, sl, _wp, _ = _split_rows(gen, D_, SPLIT_LENS, mp)
    bt, sl = bt.cuda(), sl.cuda()
    B, H_ = len(SPLIT_LENS), HKV * n_rep
    q = _rand((B, H_, D_), gen)
    before = kernels.LAUNCHES["paged_decode_attention"]
    a1 = kernels.paged_decode_attention(q, kp, vp, bt, sl, 1)
    a2 = kernels.paged_decode_attention(q, kp, vp, bt, sl, 1)
    b = kernels.paged_decode_attention_plain(q, kp, vp, bt, sl, 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode_attention"] == before + 2
    assert torch.isfinite(a1).all()
    live = slice(1, B)
    assert (a1[live].float() - b[live].float()).abs().max().item() <= ATOL
    assert _scaled_err(a1[live], b[live]) <= REL_TOL
    assert torch.equal(a1, a2)
    assert torch.all(a1[0] == 0)
    n_splits = kernels.fused_decode_splits(mp, PS)
    ws, counters = kernels.split_workspace("paged_decode_attention", q.device,
                                           B, HKV, n_rep, D_, n_splits)
    assert not counters.any()
    ws1, _ = kernels.split_workspace("fused_decode", q.device, B, HKV, n_rep,
                                     D_, n_splits)
    assert ws.data_ptr() != ws1.data_ptr()


@needs_cuda
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("D_", [64, 128])
def test_ragged_split_and_tensor_core_blocks_match_twin_twice(D_, n_rep):
    """Kernel 6: decode rows of different lengths (0 and 2000 among them)
    and an inactive row as split blocks; a fresh slice, a slice at
    position 300 (not page-aligned; q-blocks straddle pages) and a
    128-token slice at 1920 as tensor-core slice blocks, plus an unused
    slice row; launched twice on one workspace. Outputs within 2e-2 and
    REL_TOL of the twin, equal across the two launches; rows outside
    the slices and the empty decode row exactly 0; pools bit-exact."""
    gen = torch.Generator(device="cuda").manual_seed(D_ * 30 + n_rep)
    mp = 128
    dec_lens = [0, 1, 63, 65, 129, 2000]
    slices = [(0, 13), (300, 37), (1920, 128), (0, 0)]    # (qstart, qlen)
    kp, vp, bt_d, sl_d, wp, nxt = _split_rows(
        gen, D_, dec_lens, mp,
        extra_pages=sum(-(-(st + n) // PS) for st, n in slices))
    bt_s = torch.zeros((len(slices), mp), dtype=torch.int32)
    for s, (st, n) in enumerate(slices):
        pages = -(-(st + n) // PS)
        bt_s[s, :pages] = torch.arange(nxt, nxt + pages, dtype=torch.int32)
        nxt += pages
    # An inactive row: 5 positions on the null page, writing slot 4.
    bt = torch.cat([bt_d, torch.zeros((1, mp), dtype=torch.int32), bt_s])
    sl = torch.cat([sl_d, torch.tensor([5], dtype=torch.int32),
                    torch.tensor([st + n for st, n in slices],
                                 dtype=torch.int32)])
    wp = torch.cat([wp, torch.zeros(1, dtype=torch.int32)])
    B = len(dec_lens) + 1
    qoff = torch.tensor([0, 16, 56, 0], dtype=torch.int32)
    qlen = torch.tensor([n for _, n in slices], dtype=torch.int32)
    qstart = torch.tensor([st for st, _ in slices], dtype=torch.int32)
    N = 192
    H_ = HKV * n_rep
    q_dec, q_pf = _rand((B, H_, D_), gen), _rand((N, H_, D_), gen)
    kn, vn = _rand((B, HKV, D_), gen), _rand((B, HKV, D_), gen)
    args = [t.cuda() for t in (bt, sl, wp, qoff, qlen, qstart)]
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = kernels.LAUNCHES["ragged_mixed_attention"]
    a_d, a_p = kernels.ragged_mixed_attention(q_dec, kn, vn, q_pf, k1, v1,
                                              *args, 1)
    a_d2, a_p2 = kernels.ragged_mixed_attention(q_dec, kn, vn, q_pf, k1, v1,
                                                *args, 1)
    b_d, b_p = kernels.ragged_mixed_attention_plain(q_dec, kn, vn, q_pf, k2,
                                                    v2, *args, 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ragged_mixed_attention"] == before + 2
    assert torch.isfinite(a_d).all() and torch.isfinite(a_p).all()
    dec = slice(1, len(dec_lens))
    assert (a_d[dec].float() - b_d[dec].float()).abs().max().item() <= ATOL
    assert _scaled_err(a_d[dec], b_d[dec]) <= REL_TOL
    assert torch.all(a_d[0] == 0)
    live = torch.zeros(N, dtype=torch.bool, device="cuda")
    for off, n in ((0, 13), (16, 37), (56, 128)):
        live[off:off + n] = True
    assert (a_p[live].float() - b_p[live].float()).abs().max().item() <= ATOL
    assert _scaled_err(a_p[live], b_p[live]) <= REL_TOL
    assert torch.all(a_p[~live] == 0)
    assert torch.equal(a_d[:B - 1], a_d2[:B - 1]) and torch.equal(a_p, a_p2)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    _, splits = kernels.ragged_grid(N, HKV, mp, PS)
    _, counters = kernels.split_workspace("ragged_mixed_attention", q_dec.device,
                                          B, HKV, n_rep, D_, splits)
    assert not counters.any()


@needs_cuda
def test_kv_cache_write_matches_twin():
    gen = torch.Generator(device="cuda").manual_seed(3)
    kp, vp = _pools(gen)
    N = 6
    rows_k, rows_v = _rand((N, GD), gen), _rand((N, GD), gen)
    page = torch.arange(1, N + 1, dtype=torch.int32, device="cuda")
    slot = torch.arange(N, dtype=torch.int32, device="cuda") * 2
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    kernels.kv_cache_write(k1, v1, rows_k, rows_v, page, slot, 1)
    kernels.kv_cache_write_plain(k2, v2, rows_k, rows_v, page, slot, 1)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@needs_cuda
def test_wrappers_reject_bad_inputs_on_cuda():
    gen = torch.Generator(device="cuda").manual_seed(4)
    kp, vp = _pools(gen)
    rows = _rand((2, GD), gen)
    idx = torch.zeros(2, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        kernels.kv_cache_write(kp, vp, rows, rows, idx, idx, 0)
    with pytest.raises(ValueError, match="layer"):
        kernels.kv_cache_write(kp, vp, rows, rows, idx.int(), idx.int(), L)
    q = _rand((4, 6, 64), gen)                       # n_rep 3: no kernel
    with pytest.raises(ValueError):
        kernels.prefill_attention(q[None], kp, vp, idx.int()[None],
                                  idx.int()[:1], idx.int()[:1], 0)


def _ragged_case(gen, H_=H, D_=D):
    """Decode rows (live across page edges, one inactive writing page 0,
    one empty) and three slices: a fresh one, one over 37 positions of
    history that crosses pages, and an unused row; packed into N=48."""
    hkv = HKV
    gd = hkv * D_
    kp, vp = _rand((L, P, PS, gd), gen), _rand((L, P, PS, gd), gen)
    dec_lens = [1, 17, 40, 5, 0]
    B = len(dec_lens)
    slices = [(0, 13), (37, 20), (0, 0)]          # (qstart, qlen)
    bt = torch.zeros((B + len(slices), MP), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(dec_lens[:3]):
        pages = -(-n // PS)
        bt[b, :pages] = torch.arange(nxt, nxt + pages, dtype=torch.int32)
        nxt += pages
    for s, (st, n) in enumerate(slices):
        pages = -(-(st + n) // PS)
        bt[B + s, :pages] = torch.arange(nxt, nxt + pages, dtype=torch.int32)
        nxt += pages
    sl = torch.tensor(dec_lens + [st + n for st, n in slices],
                      dtype=torch.int32)
    wp = torch.zeros(B, dtype=torch.int32)
    for b in range(3):
        wp[b] = bt[b, (dec_lens[b] - 1) // PS]
    qoff = torch.tensor([0, 16, 0], dtype=torch.int32)
    qlen = torch.tensor([n for _, n in slices], dtype=torch.int32)
    qstart = torch.tensor([st for st, _ in slices], dtype=torch.int32)
    N = 48
    q_dec = _rand((B, H_, D_), gen)
    kn, vn = _rand((B, hkv, D_), gen), _rand((B, hkv, D_), gen)
    q_pf = _rand((N, H_, D_), gen)
    dev = [t.cuda() for t in (bt, sl, wp, qoff, qlen, qstart)]
    return (q_dec, kn, vn, q_pf, kp, vp, *dev), B


@needs_cuda
def test_ragged_mixed_attention_matches_twin():
    """Kernel 6: decode rows and packed slices in one launch against the
    twin; pools bit-exact, rows outside the slices zero."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    (q_dec, kn, vn, q_pf, kp, vp, bt, sl, wp, qoff, qlen,
     qstart), B = _ragged_case(gen)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = kernels.LAUNCHES["ragged_mixed_attention"]
    a_d, a_p = kernels.ragged_mixed_attention(
        q_dec, kn, vn, q_pf, k1, v1, bt, sl, wp, qoff, qlen, qstart, 1)
    b_d, b_p = kernels.ragged_mixed_attention_plain(
        q_dec, kn, vn, q_pf, k2, v2, bt, sl, wp, qoff, qlen, qstart, 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ragged_mixed_attention"] == before + 1
    assert torch.isfinite(a_d).all() and torch.isfinite(a_p).all()
    assert (a_d[:4].float() - b_d[:4].float()).abs().max().item() <= ATOL
    assert torch.all(a_d[4] == 0)
    live = torch.zeros(q_pf.shape[0], dtype=torch.bool, device="cuda")
    live[0:13] = True
    live[16:36] = True
    assert (a_p[live].float() - b_p[live].float()).abs().max().item() <= ATOL
    assert torch.all(a_p[~live] == 0)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@needs_cuda
def test_paged_decode_attention_matches_twin():
    """Kernel 8 on the stacked pool and on the one-layer form; an empty
    row returns zeros."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    (q_dec, _kn, _vn, _q, kp, vp, bt, sl, _wp, *_), B = _ragged_case(gen)
    bt, sl = bt[:B].contiguous(), sl[:B].contiguous()
    before = kernels.LAUNCHES["paged_decode_attention"]
    a = kernels.paged_decode_attention(q_dec, kp, vp, bt, sl, 1)
    b = kernels.paged_decode_attention_plain(q_dec, kp, vp, bt, sl, 1)
    c = kernels.paged_decode_attention(q_dec, kp[1], vp[1], bt, sl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode_attention"] == before + 2
    assert (a[:4].float() - b[:4].float()).abs().max().item() <= ATOL
    assert torch.all(a[4] == 0) and torch.equal(a, c)


@needs_cuda
def test_split_route_runs_both_kernels():
    """paged_decode_step(fused=False) on the card: the row-write kernel
    and the decode-attention kernel, agreeing with the fused route."""
    from llmq_tpu_torch.ops.attention import paged_decode_step

    gen = torch.Generator(device="cuda").manual_seed(7)
    (q_dec, kn, vn, _q, kp, vp, bt, sl, wp, *_), B = _ragged_case(gen)
    bt, sl = bt[:B].contiguous(), sl[:B].contiguous()
    slot = ((sl - 1).clamp(min=0) % PS).to(torch.int32)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = dict(kernels.LAUNCHES)
    a = paged_decode_step(q_dec[:4], kn[:4], vn[:4], k1, v1, bt[:4], sl[:4],
                          wp[:4], slot[:4], 0, fused=True)
    b = paged_decode_step(q_dec[:4], kn[:4], vn[:4], k2, v2, bt[:4], sl[:4],
                          wp[:4], slot[:4], 0, fused=False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode_attention"] == \
        before["paged_decode_attention"] + 1
    assert kernels.LAUNCHES["kv_cache_write"] == before["kv_cache_write"] + 1
    assert (a[:3].float() - b[:3].float()).abs().max().item() <= ATOL
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@needs_cuda
def test_one_query_head_per_kv_head():
    """n_rep = 1 (H == H_kv) is instantiated: kernel 6 against its twin."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    (q_dec, kn, vn, q_pf, kp, vp, bt, sl, wp, qoff, qlen,
     qstart), B = _ragged_case(gen, H_=HKV)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    a_d, a_p = kernels.ragged_mixed_attention(
        q_dec, kn, vn, q_pf, k1, v1, bt, sl, wp, qoff, qlen, qstart, 0)
    b_d, b_p = kernels.ragged_mixed_attention_plain(
        q_dec, kn, vn, q_pf, k2, v2, bt, sl, wp, qoff, qlen, qstart, 0)
    torch.cuda.synchronize()
    assert (a_d[:4].float() - b_d[:4].float()).abs().max().item() <= ATOL
    assert (a_p.float() - b_p.float()).abs().max().item() <= ATOL
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@needs_cuda
def test_new_wrappers_raise_on_uninstantiated_geometry():
    """D=32 has no instantiation: both new wrappers raise on the card
    (nothing falls back to a twin) and count no launch."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    (q_dec, kn, vn, q_pf, kp, vp, bt, sl, wp, qoff, qlen,
     qstart), B = _ragged_case(gen, H_=2 * HKV * 4, D_=32)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="no kernel instantiation"):
        kernels.ragged_mixed_attention(q_dec, kn, vn, q_pf, kp, vp, bt, sl,
                                       wp, qoff, qlen, qstart, 0)
    with pytest.raises(ValueError, match="no kernel instantiation"):
        kernels.paged_decode_attention(q_dec, kp, vp, bt[:B].contiguous(),
                                       sl[:B].contiguous(), 0)
    assert kernels.LAUNCHES == before


# -- int8 serving: kernels 5 and 7, and the int8 GEMM -------------------------

Q8_ATOL = 3e-2   # the JAX package's int8 kernel-vs-plain tolerance


def _q8(x, d=D):
    """bf16 (..., GD) rows → int8 rows (..., GD) and per-head bf16 scales
    (..., H_kv), through the port's own row quantization."""
    from llmq_tpu_torch.ops.quant import quantize_kv_rows

    q, s = quantize_kv_rows(x.reshape(*x.shape[:-1], -1, d))
    return q.reshape(x.shape).contiguous(), s.contiguous()


def _q8_pools(kp, vp, d=D):
    """bf16 pools (L, P, ps, GD) → int8 pools and (L, P, H_kv, ps) scale
    pools."""
    (kq, ks), (vq, vs) = _q8(kp, d), _q8(vp, d)
    return (kq, vq, ks.transpose(2, 3).contiguous(),
            vs.transpose(2, 3).contiguous())


@needs_cuda
def test_fused_decode_q8_matches_twin():
    """Kernel 5: live rows within 3e-2 of the twin, the empty row zero,
    int8 pools and scale pools bit-exact."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    (q_dec, kn, vn, _q, kp, vp, bt, sl, wp, *_), B = _ragged_case(gen)
    bt, sl = bt[:B].contiguous(), sl[:B].contiguous()
    pools = _q8_pools(kp, vp)
    (kq, ks), (vq, vs) = _q8(kn.reshape(B, -1)), _q8(vn.reshape(B, -1))
    p1 = [t.clone() for t in pools]
    p2 = [t.clone() for t in pools]
    before = kernels.LAUNCHES["fused_decode_q8"]
    a = kernels.fused_decode_q8(q_dec, kq, ks, vq, vs, *p1, bt, sl, wp, 1)
    b = kernels.fused_decode_q8_plain(q_dec, kq, ks, vq, vs, *p2, bt, sl, wp,
                                      1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_decode_q8"] == before + 1
    assert torch.isfinite(a).all()
    assert (a[:4].float() - b[:4].float()).abs().max().item() <= Q8_ATOL
    assert torch.all(a[4] == 0)
    for x, y in zip(p1, p2):
        assert torch.equal(x, y)


@needs_cuda
@pytest.mark.parametrize("h", [H, HKV])
def test_ragged_mixed_attention_q8_matches_twin(h):
    """Kernel 7 (n_rep 4 and 1): decode rows and packed slices within
    3e-2 of the twin, rows outside the slices zero, the four pools
    bit-exact."""
    gen = torch.Generator(device="cuda").manual_seed(11 + h)
    (q_dec, kn, vn, q_pf, kp, vp, bt, sl, wp, qoff, qlen,
     qstart), B = _ragged_case(gen, H_=h)
    pools = _q8_pools(kp, vp)
    (kq, ks), (vq, vs) = _q8(kn.reshape(B, -1)), _q8(vn.reshape(B, -1))
    p1 = [t.clone() for t in pools]
    p2 = [t.clone() for t in pools]
    args = (bt, sl, wp, qoff, qlen, qstart, 1)
    before = kernels.LAUNCHES["ragged_mixed_attention_q8"]
    a_d, a_p = kernels.ragged_mixed_attention_q8(q_dec, kq, ks, vq, vs, q_pf,
                                                 *p1, *args)
    b_d, b_p = kernels.ragged_mixed_attention_q8_plain(q_dec, kq, ks, vq, vs,
                                                       q_pf, *p2, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ragged_mixed_attention_q8"] == before + 1
    assert torch.isfinite(a_d).all() and torch.isfinite(a_p).all()
    assert (a_d[:4].float() - b_d[:4].float()).abs().max().item() <= Q8_ATOL
    assert torch.all(a_d[4] == 0)
    live = torch.zeros(q_pf.shape[0], dtype=torch.bool, device="cuda")
    live[0:13] = True
    live[16:36] = True
    assert (a_p[live].float() - b_p[live].float()).abs().max().item() \
        <= Q8_ATOL
    assert torch.all(a_p[~live] == 0)
    for x, y in zip(p1, p2):
        assert torch.equal(x, y)


@needs_cuda
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("D_", [64, 128])
def test_fused_decode_q8_splits_match_twin_twice(D_, n_rep):
    """Kernel 5 (kernel 1's split-K body over int8 pools) at seq_lens 0,
    1, the 64-position tile's and the 128-position chunk's edges and
    2000, plus an inactive row writing the null page: two launches on the
    same cached workspace give the same output, within 3e-2 and REL_TOL
    of the twin's scale; int8 pools and scale pools bit-exact; the empty
    row exactly 0; its counters back at 0 and apart from kernel 1's."""
    gen = torch.Generator(device="cuda").manual_seed(D_ * 40 + n_rep)
    mp = 128
    lens = SPLIT_LENS + [5]
    kp, vp, bt, sl, wp, _ = _split_rows(gen, D_, lens, mp)
    wp[-1] = 0                                   # inactive: null page
    bt, sl, wp = bt.cuda(), sl.cuda(), wp.cuda()
    pools = _q8_pools(kp, vp, D_)
    B, H_ = len(lens), HKV * n_rep
    q = _rand((B, H_, D_), gen)
    (kq, ks), (vq, vs) = (_q8(_rand((B, HKV * D_), gen), D_)
                          for _ in range(2))
    p1 = [t.clone() for t in pools]
    p2 = [t.clone() for t in pools]
    before = kernels.LAUNCHES["fused_decode_q8"]
    a1 = kernels.fused_decode_q8(q, kq, ks, vq, vs, *p1, bt, sl, wp, 1)
    a2 = kernels.fused_decode_q8(q, kq, ks, vq, vs, *p1, bt, sl, wp, 1)
    b = kernels.fused_decode_q8_plain(q, kq, ks, vq, vs, *p2, bt, sl, wp, 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_decode_q8"] == before + 2
    assert torch.isfinite(a1).all()
    live = slice(1, B - 1)
    assert (a1[live].float() - b[live].float()).abs().max().item() <= Q8_ATOL
    assert _scaled_err(a1[live], b[live]) <= REL_TOL
    assert torch.equal(a1[:B - 1], a2[:B - 1])
    assert torch.all(a1[0] == 0) and torch.all(a2[0] == 0)
    for x, y in zip(p1, p2):
        assert torch.equal(x, y)
    n_splits = kernels.fused_decode_splits(mp, PS)
    ws, counters = kernels.split_workspace("fused_decode_q8", q.device, B,
                                           HKV, n_rep, D_, n_splits)
    assert not counters.any()
    ws1, _ = kernels.split_workspace("fused_decode", q.device, B, HKV, n_rep,
                                     D_, n_splits)
    assert ws.data_ptr() != ws1.data_ptr()


@needs_cuda
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("D_", [64, 128])
def test_ragged_q8_split_and_tensor_core_blocks_match_twin_twice(D_, n_rep):
    """Kernel 7 (kernel 6's design over int8 pools): decode rows of
    lengths 0 to 2000 and an inactive row as split blocks; a fresh slice,
    a slice at position 300 and a 128-token slice at 1920 as tensor-core
    slice blocks, plus an unused slice row; launched twice on one
    workspace. Outputs within 3e-2 and REL_TOL of the twin, equal across
    the two launches; rows outside the slices and the empty decode row
    exactly 0; the four pools bit-exact; counters back at 0."""
    gen = torch.Generator(device="cuda").manual_seed(D_ * 50 + n_rep)
    mp = 128
    dec_lens = [0, 1, 63, 65, 129, 2000]
    slices = [(0, 13), (300, 37), (1920, 128), (0, 0)]    # (qstart, qlen)
    kp, vp, bt_d, sl_d, wp, nxt = _split_rows(
        gen, D_, dec_lens, mp,
        extra_pages=sum(-(-(st + n) // PS) for st, n in slices))
    bt_s = torch.zeros((len(slices), mp), dtype=torch.int32)
    for s, (st, n) in enumerate(slices):
        pages = -(-(st + n) // PS)
        bt_s[s, :pages] = torch.arange(nxt, nxt + pages, dtype=torch.int32)
        nxt += pages
    # An inactive row: 5 positions on the null page, writing slot 4.
    bt = torch.cat([bt_d, torch.zeros((1, mp), dtype=torch.int32), bt_s])
    sl = torch.cat([sl_d, torch.tensor([5], dtype=torch.int32),
                    torch.tensor([st + n for st, n in slices],
                                 dtype=torch.int32)])
    wp = torch.cat([wp, torch.zeros(1, dtype=torch.int32)])
    B = len(dec_lens) + 1
    qoff = torch.tensor([0, 16, 56, 0], dtype=torch.int32)
    qlen = torch.tensor([n for _, n in slices], dtype=torch.int32)
    qstart = torch.tensor([st for st, _ in slices], dtype=torch.int32)
    N = 192
    H_ = HKV * n_rep
    q_dec, q_pf = _rand((B, H_, D_), gen), _rand((N, H_, D_), gen)
    (kq, ks), (vq, vs) = (_q8(_rand((B, HKV * D_), gen), D_)
                          for _ in range(2))
    pools = _q8_pools(kp, vp, D_)
    args = [t.cuda() for t in (bt, sl, wp, qoff, qlen, qstart)]
    p1 = [t.clone() for t in pools]
    p2 = [t.clone() for t in pools]
    before = kernels.LAUNCHES["ragged_mixed_attention_q8"]
    a_d, a_p = kernels.ragged_mixed_attention_q8(q_dec, kq, ks, vq, vs, q_pf,
                                                 *p1, *args, 1)
    a_d2, a_p2 = kernels.ragged_mixed_attention_q8(q_dec, kq, ks, vq, vs,
                                                   q_pf, *p1, *args, 1)
    b_d, b_p = kernels.ragged_mixed_attention_q8_plain(q_dec, kq, ks, vq, vs,
                                                       q_pf, *p2, *args, 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ragged_mixed_attention_q8"] == before + 2
    assert torch.isfinite(a_d).all() and torch.isfinite(a_p).all()
    dec = slice(1, len(dec_lens))
    assert (a_d[dec].float() - b_d[dec].float()).abs().max().item() \
        <= Q8_ATOL
    assert _scaled_err(a_d[dec], b_d[dec]) <= REL_TOL
    assert torch.all(a_d[0] == 0)
    live = torch.zeros(N, dtype=torch.bool, device="cuda")
    for off, n in ((0, 13), (16, 37), (56, 128)):
        live[off:off + n] = True
    assert (a_p[live].float() - b_p[live].float()).abs().max().item() \
        <= Q8_ATOL
    assert _scaled_err(a_p[live], b_p[live]) <= REL_TOL
    assert torch.all(a_p[~live] == 0)
    assert torch.equal(a_d[:B - 1], a_d2[:B - 1]) and torch.equal(a_p, a_p2)
    for x, y in zip(p1, p2):
        assert torch.equal(x, y)
    _, splits = kernels.ragged_grid(N, HKV, mp, PS)
    _, counters = kernels.split_workspace("ragged_mixed_attention_q8",
                                          q_dec.device, B, HKV, n_rep, D_,
                                          splits)
    assert not counters.any()


@needs_cuda
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 40])
def test_qdot_and_tied_head_on_the_card(rows):
    """The int8 GEMM at decode's row counts (cuBLAS refuses 16 rows or
    fewer unpadded): ``qdot`` and ``tied_head_logits`` on the card equal
    the CPU's within 1e-5 relative (f32 activations; the int32 product is
    exact on both)."""
    from llmq_tpu_torch.ops.quant import (qdot, quantize_embedding,
                                          quantize_weight, tied_head_logits)

    gen = torch.Generator().manual_seed(rows)
    x = torch.randn((rows, 256), generator=gen)
    w = quantize_weight(torch.randn((256, 512), generator=gen))
    e = quantize_embedding(torch.randn((384, 256), generator=gen))
    for fn, arg in ((qdot, w), (lambda h, t: tied_head_logits(t, h), e)):
        cpu = fn(x, arg)
        dev = fn(x.cuda(), {k: v.cuda() for k, v in arg.items()}).cpu()
        torch.testing.assert_close(dev, cpu, rtol=1e-5, atol=1e-5)


# -- the decode step as a CUDA graph ------------------------------------------
#
# A 2-layer model with llama3-1b's head geometry cut down (D=64, n_rep
# 4), random weights from seed 0, on each decode route: the captured step
# replayed against the same step body run eagerly. Greedy rows compare
# token for token (the same kernels on the same inputs), pools bit-exact.

GRAPH_K = 4
GRAPH_PROMPTS = [[5, 9, 13, 17, 21], [40, 41, 42], [7] * 9, [300, 200, 100]]
GRAPH_ROUTES = ["fused", "split", "int8_kv", "int8_weights_int8_kv"]


def _graph_executor(route, eos=-1, seed=0):
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.models import llama as T
    from llmq_tpu_torch.ops.quant import quantize_params

    cfg = T.get_config("llama3-tiny", dim=512, n_heads=8, n_kv_heads=2,
                       n_layers=2, vocab_size=512, max_seq_len=256)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    kw = dict(batch_size=len(GRAPH_PROMPTS), page_size=16, num_pages=64,
              prefill_buckets=[16, 32], chunk_size=GRAPH_K, eos_id=eos,
              seed=seed, device="cuda")
    if route == "split":
        kw["fused_decode"] = False
    if route.endswith("int8_kv"):
        kw["cache_dtype"] = torch.int8
    if route.startswith("int8_weights"):
        params = quantize_params(params)
    return TorchExecutor(cfg, params, **kw)


def _graph_prefill(ex):
    import numpy as np

    B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
    bt = np.zeros((B, MP), np.int32)
    for b in range(B):
        bt[b, :2] = [1 + 2 * b, 2 + 2 * b]
    tok = np.asarray([ex.prefill(p, 0, bt[b], 0.0, b)
                      for b, p in enumerate(GRAPH_PROMPTS)], np.int32)
    return tok, np.asarray([len(p) for p in GRAPH_PROMPTS], np.int32), bt


def _graph_eos(route):
    """A token row 0 emits at step 1 from the prefilled state: used as
    EOS, it latches row 0 mid-chunk."""
    import numpy as np

    ex = _graph_executor(route)
    tok, pos, bt = _graph_prefill(ex)
    B = len(tok)
    out = ex._decode_chunk(tok, pos, bt, np.zeros(B, np.float32),
                           np.full(B, GRAPH_K, np.int32), eager=True)
    return int(out[0, 1])


@needs_cuda
@pytest.mark.parametrize("route", GRAPH_ROUTES)
def test_graph_replay_equals_eager_step_over_two_chunks(route):
    """Two chunks (budgets 0..K, the second carrying on from the first,
    row 0 latching on EOS): the replayed step gives the eager body's
    tokens and pools; each step of the graph executor is one replay."""
    import numpy as np

    eos = _graph_eos(route)
    g_ex, e_ex = _graph_executor(route, eos), _graph_executor(route, eos)
    tok, pos, bt = _graph_prefill(g_ex)
    tok_e, _, _ = _graph_prefill(e_ex)
    assert (tok == tok_e).all()
    B = len(tok)
    temps = np.zeros(B, np.float32)
    budgets = np.array([4, 0, 2, 3], np.int32)
    latched = np.zeros(B, bool)
    for _chunk in range(2):
        replays = g_ex.graph_replays
        got = g_ex.decode_chunk(tok, pos, bt, temps, budgets)
        want = e_ex._decode_chunk(tok, pos, bt, temps, budgets, eager=True)
        assert (got == want).all(), (got, want)
        assert g_ex.graph_replays > replays
        for b in range(B):
            real = want[b, :budgets[b]]
            if len(real):
                tok[b], pos[b] = real[-1], pos[b] + len(real)
                latched[b] |= eos in real
        budgets = np.where(latched, 0, GRAPH_K).astype(np.int32)
    assert latched[0]
    torch.cuda.synchronize()
    assert set(g_ex.step_graphs) == {route != "split"}
    for name, pool in g_ex.cache.items():
        assert torch.equal(pool[:, 1:], e_ex.cache[name][:, 1:]), name


@needs_cuda
@pytest.mark.parametrize("route", GRAPH_ROUTES)
def test_each_replay_adds_its_captured_launches(route):
    """Capture launches nothing; every replay adds the capture's launch
    counts, which name the route's kernels once a layer."""
    import numpy as np

    ex = _graph_executor(route)
    ex.warmup()
    g = ex.step_graphs[route != "split"]
    want = {"fused": {"fused_decode": 2},
            "split": {"kv_cache_write": 2, "paged_decode_attention": 2},
            "int8_kv": {"fused_decode_q8": 2},
            "int8_weights_int8_kv": {"fused_decode_q8": 2}}[route]
    assert g.launches == want
    assert g.pool_bytes >= 0
    lo, hi = 0.05, 250.0
    assert ex.step_ms is not None and lo <= ex.step_ms <= hi
    assert ex.warmup_split["capture"] > 0
    tok, pos, bt = _graph_prefill(ex)
    B = len(tok)
    before = dict(kernels.LAUNCHES)
    replays = ex.graph_replays
    ex.decode(tok, pos, bt, np.zeros(B, np.float32))
    assert ex.graph_replays == replays + 1
    delta = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
             if v != before[k]}
    assert delta == want


@needs_cuda
def test_graph_draws_repeat_from_the_seed():
    """At temperature > 0 two executors with one seed replay the same
    draws; another seed draws others."""
    import numpy as np

    outs = []
    for seed in (5, 5, 6):
        ex = _graph_executor("fused", seed=seed)
        tok, pos, bt = _graph_prefill(ex)
        B = len(tok)
        outs.append(ex.decode_chunk(tok, pos, bt, np.ones(B, np.float32),
                                    np.full(B, GRAPH_K, np.int32)))
    assert (outs[0] == outs[1]).all()
    assert not (outs[0] == outs[2]).all()


@needs_cuda
@pytest.mark.parametrize("route", ["fused", "split", "int8_kv"])
def test_replay_reads_the_pages_as_they_are_now(route):
    """After a replay, new K/V in a row's pages and a block table that
    moves it to other pages: the next replay attends to what is there
    now, as the eager body does (no stale pointers or values)."""
    import numpy as np

    g_ex, e_ex = _graph_executor(route), _graph_executor(route)
    tok, pos, bt = _graph_prefill(g_ex)
    _graph_prefill(e_ex)
    B = len(tok)
    temps = np.zeros(B, np.float32)
    ones = np.ones(B, np.int32)
    first = g_ex.decode(tok, pos, bt, temps)
    assert (first == e_ex._decode_chunk(tok, pos, bt, temps, ones,
                                        eager=True)[:, 0]).all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for ex in (g_ex, e_ex):
        gen.manual_seed(1)
        for name, pool in ex.cache.items():
            # Row 0's history to pages 30-31, fresh values in row 1's.
            pool[:, 30:32] = pool[:, 1:3]
            noise = torch.randn(pool[:, 3:5].shape, generator=gen,
                                device="cuda")
            pool[:, 3:5] = (noise * 20).to(pool.dtype) if pool.dtype == \
                torch.int8 else noise.to(pool.dtype)
    bt2 = bt.copy()
    bt2[0, :2] = [30, 31]
    got = g_ex.decode(tok, pos, bt2, temps)
    want = e_ex._decode_chunk(tok, pos, bt2, temps, ones, eager=True)[:, 0]
    assert (got == want).all(), (got, want)
    assert got[0] == first[0]
    torch.cuda.synchronize()
    for name, pool in g_ex.cache.items():
        assert torch.equal(pool[:, 1:], e_ex.cache[name][:, 1:]), name


# -- batched kernels 2 and 3, and the prefill programs' graphs -----------------

def _batched_case(gen, T, lengths, starts):
    """N = len(lengths) rows of a T-token batch at llama3-8b's heads: row
    n's live tokens at ``starts[n]..`` over its own shuffled pages (its
    history included); a row of length 1 with an all-zero block table
    stands for an unused row (null page). Returns q (N, T, 32, 128), the
    (N·T, GD) K/V rows, one-layer pools, block tables (N, MP) and the
    descriptors."""
    hkv, d = 8, 128
    mp = -(-max(s + n for s, n in zip(starts, lengths)) // PS)
    need = [-(-(s + n) // PS) for s, n in zip(starts, lengths)]
    kp = _rand((1, sum(need) + 2, PS, hkv * d), gen)
    vp = _rand((1, sum(need) + 2, PS, hkv * d), gen)
    perm = (torch.randperm(sum(need), generator=torch.Generator()
                           .manual_seed(T)) + 1).to(torch.int32)
    bt = torch.zeros((len(lengths), mp), dtype=torch.int32)
    nxt = 0
    for i, (n, k) in enumerate(zip(lengths, need)):
        if n > 1:
            bt[i, :k] = perm[nxt:nxt + k]
            nxt += k
    N = len(lengths)
    rows_k, rows_v = _rand((N * T, hkv * d), gen), _rand((N * T, hkv * d), gen)
    q = _rand((N, T, 4 * hkv, d), gen)
    desc = _desc([i * T for i in range(N)], lengths, starts)
    return q, rows_k, rows_v, kp, vp, bt.cuda(), desc


@needs_cuda
@pytest.mark.parametrize("T,lengths,starts", [
    (512, [512, 90, 377, 1], [0, 37, 0, 0]),
    (2048, [600, 90, 2048, 1], [0, 37, 0, 0])])
def test_batched_prefill_kernels_match_twins(T, lengths, starts):
    """Kernels 2 and 3 over a whole batch in one launch each (N=4 rows,
    mixed live lengths, a continuation row, an unused row): pools
    bit-exact against the scatter twin, live rows within 2e-2 and
    REL_TOL of the attention twin, rows past each length zero; at
    T=2048 a twin reading one wrong page must fail REL_TOL."""
    gen = torch.Generator(device="cuda").manual_seed(T)
    q, rk, rv, kp, vp, bt, (off, ln, st) = _batched_case(gen, T, lengths,
                                                         starts)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = dict(kernels.LAUNCHES)
    kernels.kv_prefill_write(k1, v1, rk, rv, bt, off, ln, st, T, 0)
    kernels.kv_prefill_write_plain(k2, v2, rk, rv, bt, off, ln, st, T, 0)
    a = kernels.prefill_attention(q, k1, v1, bt, st, ln, 0)
    b = kernels.prefill_attention_plain(q, k1, v1, bt, st, ln, 0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["kv_prefill_write"] == before["kv_prefill_write"] + 1
    assert (kernels.LAUNCHES["prefill_attention"]
            == before["prefill_attention"] + 1)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert torch.isfinite(a).all()
    for n, live in enumerate(lengths):
        assert (a[n, :live].float() - b[n, :live].float()).abs().max() <= ATOL
        assert _scaled_err(a[n, :live], b[n, :live]) <= REL_TOL
        assert torch.all(a[n, live:] == 0)
    if T == 2048:
        bad = bt.clone()
        bad[2, 1024 // PS] = bt[2, 0]
        ctl = kernels.prefill_attention_plain(q, k1, v1, bad, st, ln, 0)
        assert _scaled_err(ctl[2], b[2]) > REL_TOL


PROGRAM_ROUTES = ["fused", "split", "int8_kv", "ragged", "ragged_int8_kv"]


def _program_executor(route):
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.models import llama as T

    cfg = T.get_config("llama3-tiny", dim=512, n_heads=8, n_kv_heads=2,
                       n_layers=2, vocab_size=512, max_seq_len=256)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    kw = dict(batch_size=4, page_size=16, num_pages=96,
              prefill_buckets=[16, 32], chunk_size=GRAPH_K, eos_id=-1,
              mixed_prefill_slices=2, mixed_slice_tokens=16,
              ragged_attention=route.startswith("ragged"),
              ragged_token_capacity=32, device="cuda")
    if route == "split":
        kw["fused_decode"] = False
    if route.endswith("int8_kv"):
        kw["cache_dtype"] = torch.int8
    return TorchExecutor(cfg, params, **kw)


def _program_run(ex, eager):
    """A wave of four prompts across both buckets, a one-row
    continuation over cached history, then a mixed chunk (two decode
    rows, one slice); eager or through the programs' graphs. Returns the
    first tokens, the chunk's tokens and the slice's token."""
    import numpy as np

    B, MP = ex.spec.batch_size, ex.spec.max_pages_per_seq
    bt = np.zeros((B, MP), np.int32)
    for b in range(B):
        bt[b, :3] = [1 + 3 * b, 2 + 3 * b, 3 + 3 * b]
    prompts = [list(range(3, 3 + n)) for n in (5, 16, 17, 30)]
    reqs = [(p, 0, bt[i], 0.0) for i, p in enumerate(prompts)]
    if ex.ragged_attention:
        hs = ex._ragged_prefill_start(reqs, eager=eager)
    else:
        hs = ex._prefill_wave(reqs, ex.prefill_batch, eager=eager)
        hs += ex._prefill_wave([([9, 8, 7], 30, bt[3], 0.0)], 1, eager=eager)
    first = ex.gather_scalars(hs)
    pos = np.array([len(p) for p in prompts], np.int32)
    sbt = np.zeros(MP, np.int32)
    sbt[:2] = [40, 41]
    out, pf_first = ex._mixed_chunk(
        first[:B].astype(np.int32), pos, bt, np.zeros(B, np.float32),
        np.array([GRAPH_K, GRAPH_K, 0, 0], np.int32),
        [(3, list(range(50, 62)), 0, sbt, 0.0)], eager=eager)
    return first, out, pf_first


@needs_cuda
@pytest.mark.parametrize("route", PROGRAM_ROUTES)
def test_replayed_prefill_programs_equal_eager(route):
    """Every prefill program and the mixed step 0 replayed from their
    graphs give the eager run's greedy tokens and pools, and each
    program is one replay a call."""
    runs = []
    for eager in (True, False):
        ex = _program_executor(route)
        res = _program_run(ex, eager)
        torch.cuda.synchronize()
        runs.append((res, {k: v.clone() for k, v in ex.cache.items()}, ex))
    (r_e, c_e, _), (r_g, c_g, ex) = runs
    for a, b in zip(r_e, r_g):
        assert (a == b).all(), route
    for k in c_e:
        assert torch.equal(c_e[k][:, 1:], c_g[k][:, 1:]), k
    assert ex.program_graphs and all(
        n == 1 or name.startswith("ragged") for name, n in
        ex.program_replays.items())
