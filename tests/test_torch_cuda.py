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


def _graph_executor(route, eos=-1, seed=0, **extra):
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.models import llama as T
    from llmq_tpu_torch.ops.quant import quantize_params

    cfg = T.get_config("llama3-tiny", dim=512, n_heads=8, n_kv_heads=2,
                       n_layers=2, vocab_size=512, max_seq_len=256)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    kw = dict(batch_size=len(GRAPH_PROMPTS), page_size=16, num_pages=64,
              prefill_buckets=[16, 32], chunk_size=GRAPH_K, eos_id=eos,
              seed=seed, device="cuda", **extra)
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
@pytest.mark.parametrize("device_sampling", [True, False],
                         ids=["device_accept", "host_accept"])
@pytest.mark.parametrize("route", GRAPH_ROUTES)
def test_verify_window_is_plain_decode_on_the_card(route, device_sampling):
    """Program identity of a speculation verify window (greedy): from
    the same cache state, a window whose drafts are a plain chunk's own
    first W-1 tokens commits W tokens on every row, emits the chunk's
    tokens, and leaves the pools bitwise equal to the chunk's; the
    window is replays of its own captured program (one a step with
    device accept, one in all with host accept)."""
    import numpy as np

    W = GRAPH_K
    ex = _graph_executor(route, speculation_draft_k=W - 1,
                         speculation_device_sampling=device_sampling)
    tok, pos, bt = _graph_prefill(ex)
    B = len(tok)
    temps = np.zeros(B, np.float32)
    saved = {k: v.clone() for k, v in ex.cache.items()}
    chunk = ex.decode_chunk(tok, pos, bt, temps, np.full(B, W, np.int32))
    after = {k: v.clone() for k, v in ex.cache.items()}
    for k, v in ex.cache.items():
        v.copy_(saved[k])
    replays = ex.verify_replays
    out, nc = ex.verify_chunk(tok, pos, bt, temps, chunk[:, :W - 1],
                              np.full(B, W, np.int32))
    torch.cuda.synchronize()
    assert (nc == W).all(), nc
    assert (out == chunk).all(), (out, chunk)
    for k, v in ex.cache.items():
        assert torch.equal(v[:, 1:], after[k][:, 1:]), k
    assert ex.verify_replays - replays == (W if device_sampling else 1)


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


# -- the async decode pipeline and the prefix cache on the card ---------------
# Dispatched chunks (no host read, every step a replay, the carry and the
# joins on the device) against the blocking path of a twin executor on the
# same weights: greedy tokens bit for bit, pools bit-exact past page 0.


def _host_carry(out, tok, pos, latched, budgets, eos):
    """The end state of a chunk from its tokens: a live row moves a
    position a step until its budget ends or it emits EOS (which latches
    it)."""
    for b in range(len(tok)):
        if latched[b]:
            continue
        for t in out[b, :budgets[b]]:
            tok[b], pos[b] = t, pos[b] + 1
            if t == eos:
                latched[b] = True
                break


@needs_cuda
@pytest.mark.parametrize("route", GRAPH_ROUTES)
def test_carried_and_joined_chunks_equal_blocking(route):
    """Three chunks dispatched back to back before any fetch: the second
    carried from the first on the device and joined on lane 3 by a new
    prompt's prefill (its token copied device to device), the third
    carried from the second. They give the blocking chunks' tokens bit
    for bit, with the carry and the join assembled on the host; row 0
    latches on EOS in the first."""
    import numpy as np

    eos = _graph_eos(route)
    ex, ref = _graph_executor(route, eos), _graph_executor(route, eos)
    tok, pos, bt = _graph_prefill(ex)
    _graph_prefill(ref)
    B = len(tok)
    temps = np.zeros(B, np.float32)
    b1 = np.array([GRAPH_K, 2, 3, 0], np.int32)
    full = np.full(B, GRAPH_K, np.int32)
    new_bt = bt.copy()
    new_bt[3, :2] = [30, 31]
    prompt = [60, 61, 62, 63, 64, 65, 66]
    h1 = ex.decode_chunk_start(tok, pos, bt, temps, b1)
    hp = ex.prefill_async(prompt, 0, new_bt[3], 0.0)
    h2 = ex.decode_chunk_start(None, None, new_bt, temps, full, carry=h1,
                               overrides=[(3, hp, len(prompt))])
    h3 = ex.decode_chunk_start(None, None, new_bt, temps, full, carry=h2)
    latched = np.zeros(B, bool)
    out1 = ref.decode_chunk(tok, pos, bt, temps, b1)
    _host_carry(out1, tok, pos, latched, b1, eos)
    first = ref.prefill(prompt, 0, new_bt[3], 0.0, 3)
    tok[3], pos[3] = first, len(prompt)
    want = [out1]
    for _ in range(2):
        b = np.where(latched, 0, GRAPH_K).astype(np.int32)
        out = ref.decode_chunk(tok, pos, new_bt, temps, b)
        _host_carry(out, tok, pos, latched, b, eos)
        want.append(out)
    assert latched[0]
    for h, w in zip((h1, h2, h3), want):
        got = h.fetch()
        assert (got == w).all(), (got, w)
    assert int(ex.gather_scalars([hp])[0]) == first
    torch.cuda.synchronize()
    for name, p in ex.cache.items():
        assert torch.equal(p[:, 1:], ref.cache[name][:, 1:]), name


@needs_cuda
def test_queued_dispatches_read_their_own_inputs():
    """The staging race: with the stream held busy, four dispatches with
    different block tables, budgets and tokens are all queued before
    any fetch, so their inputs' copies run long after the host has
    staged the next ones. Each fetches what a blocking chunk of the same
    inputs gives: no dispatch read another's staging."""
    import numpy as np

    ex, ref = _graph_executor("fused"), _graph_executor("fused")
    tok, pos, bt = _graph_prefill(ex)
    _graph_prefill(ref)
    B = len(tok)
    temps = np.zeros(B, np.float32)
    ex.decode_chunk(tok, pos, bt, temps, np.ones(B, np.int32))
    ref.decode_chunk(tok, pos, bt, temps, np.ones(B, np.int32))
    inputs = []
    for i in range(4):
        b = np.zeros(B, np.int32)
        b[i] = GRAPH_K - (i % 2)
        t = np.zeros_like(bt)
        t[i] = bt[i]
        inputs.append((tok + 7 * i, pos + 1, t, temps, b))
    torch.cuda._sleep(200_000_000)
    handles = [ex.decode_chunk_start(*args) for args in inputs]
    for h, args in zip(handles, inputs):
        assert (h.fetch() == ref.decode_chunk(*args)).all()
    torch.cuda.synchronize()
    for name, p in ex.cache.items():
        assert torch.equal(p[:, 1:], ref.cache[name][:, 1:]), name


@needs_cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_shared_pages_unchanged_by_a_prefix_hit_wave(kv):
    """A 48-token system prompt published by a finished request; a wave
    of three requests sharing it adopts its three pages (reference count
    4 while they run) and writes only pages of its own: the shared
    pages (K, V and, int8, their scales) are unchanged byte for byte,
    and each request reports 48 cached tokens."""
    from llmq_tpu_torch.core.config import (AsyncPipelineConfig,
                                            PrefixCacheConfig)
    from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.models import llama as T

    cfg = T.get_config("llama3-tiny", dim=512, n_heads=8, n_kv_heads=2,
                       n_layers=2, vocab_size=512, max_seq_len=256)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    ex = TorchExecutor(cfg, params, batch_size=4, page_size=16, num_pages=96,
                       prefill_buckets=[16, 64], chunk_size=GRAPH_K,
                       eos_id=ByteTokenizer.eos_id,
                       cache_dtype=torch.int8 if kv == "int8" else None,
                       device="cuda")
    eng = InferenceEngine(ex, ByteTokenizer(), max_decode_steps=8,
                          prefix_cache=PrefixCacheConfig(),
                          async_pipeline=AsyncPipelineConfig())
    system = "The shared system prompt, three pages of it, is here."[:48]
    assert len(system) == 48
    h = eng.submit(GenRequest(id="first", prompt=system + " One.",
                              max_new_tokens=4))
    eng.run_until_idle()
    assert h.result.finish_reason in ("eos", "length")
    shared = [p for p in range(1, 96) if eng.allocator.refcount(p) > 0]
    assert len(shared) == 3
    before = {k: v[:, shared].clone() for k, v in ex.cache.items()}
    hs = [eng.submit(GenRequest(id=f"w{i}", prompt=system + tail,
                                max_new_tokens=6))
          for i, tail in enumerate([" Two!", " Three?", " Four, then."])]
    peak = 0
    while not all(x.done for x in hs):
        eng.step()
        peak = max(peak, max(eng.allocator.refcount(p) for p in shared))
    eng.run_until_idle()
    assert peak == 4
    assert [x.result.cached_tokens for x in hs] == [48, 48, 48]
    torch.cuda.synchronize()
    for k, v in ex.cache.items():
        assert torch.equal(v[:, shared], before[k]), k
    eng.stop()


# -- the tiered KV transport ---------------------------------------------------
#
# The executor's page seam and the tiering plane on the card: the gather
# on the programs' stream, the copy into the pinned host arena on the
# plane's stream, the copy back on the executor's own stream and the
# in-place scatter. Bit-exact: the bytes only move.


@needs_cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_tier_export_import_roundtrip_is_bit_exact(kv):
    """Random pool bytes on pages 3, 9, 4 go to pinned host buffers and
    back into pages 20, 21, 30 of every leaf (int8 values and bf16
    scales included), byte for byte; the host buffers come back to the
    freelist only behind the inject's fence."""
    from llmq_tpu_torch.core.config import KVTieringConfig
    from llmq_tpu_torch.tiering import KVTieringPlane, TierEntry

    ex = _graph_executor("int8_kv" if kv == "int8" else "fused")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for pool in ex.cache.values():
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-128, 128, pool.shape, generator=gen,
                                     device="cuda", dtype=torch.int8))
        else:
            pool.copy_(torch.randn(pool.shape, generator=gen,
                                   device="cuda").to(pool.dtype))
    plane = KVTieringPlane(KVTieringConfig(enabled=True, host_capacity_mb=8),
                           "cuda-seam", ex)
    assert plane.pool.pinned
    src, dst = [3, 9, 4], [20, 21, 30]
    before = {k: v[:, src].clone() for k, v in ex.cache.items()}
    dev = ex.export_kv_pages(src)
    for k in ex.cache:
        ex.cache[k][:, src] = 0           # the pages are reused at once
    entry = TierEntry("c", [1] * 24, 24, None, len(src), 0.0)
    bufs = plane.pool.take(len(src))
    assert plane._copy_out(dev, bufs)
    entry.payload, entry.pooled = bufs, True
    fence = ex.import_kv_pages(dst, plane.unpack(entry))
    assert fence is not None
    plane.release(entry, fence)
    torch.cuda.synchronize()
    assert plane.pool.free_buffers() == plane.pool.total_buffers
    for k, v in ex.cache.items():
        assert torch.equal(v[:, dst], before[k]), k
    assert plane.stats()["d2h_copies"] == 1
    plane.stop()


@needs_cuda
@pytest.mark.parametrize("route", ["fused", "int8_kv"])
def test_inject_under_a_captured_graph_is_read_by_its_replay(route):
    """With the decode step captured, the rows' pages are exported,
    overwritten, and injected into other pages; a replay over block
    tables naming the new pages decodes exactly what an identical
    executor decodes over the original pages (the graph reads the same
    pool tensors: the inject wrote in place)."""
    import numpy as np

    from llmq_tpu_torch.tiering import HostTierPool, PagePayload

    g_ex, ref = _graph_executor(route), _graph_executor(route)
    g_ex.warmup()
    tok, pos, bt = _graph_prefill(g_ex)
    tok_r, _, bt_r = _graph_prefill(ref)
    assert (tok == tok_r).all()
    B = len(tok)
    src = sorted({int(p) for p in bt[:, :2].ravel()})
    dst = [p + 32 for p in src]
    dev = g_ex.export_kv_pages(src)
    torch.cuda.synchronize()
    nbytes = dev.packed.shape[1]
    pool = HostTierPool(nbytes * len(src), nbytes, pin=True)
    bufs = pool.take(len(src))
    for j, b in enumerate(bufs):
        pool.tensor(b).copy_(dev.packed[j])
    for k in g_ex.cache:
        g_ex.cache[k][:, src] = 0
    g_ex.import_kv_pages(dst, PagePayload(bufs, g_ex.kv_page_spec(), pool))
    remap = dict(zip(src, dst))
    bt2 = np.vectorize(lambda p: remap.get(int(p), int(p)))(bt).astype(
        np.int32)
    temps = np.zeros(B, np.float32)
    budgets = np.full(B, GRAPH_K, np.int32)
    replays = g_ex.graph_replays
    got = g_ex.decode_chunk(tok, pos, bt2, temps, budgets)
    want = ref.decode_chunk(tok_r, pos, bt_r, temps, budgets)
    assert g_ex.graph_replays > replays
    assert (got == want).all(), (got, want)


# -- the fault domain on the card ------------------------------------------------


@needs_cuda
def test_chaos_crash_with_a_graph_chunk_in_flight_then_replays_alike():
    """A chaos ``engine.step`` crash while a carried chunk of replayed
    graphs is in flight: the supervisor fails the rows over and restarts
    the loop; the restarted engine captures nothing new, replays its
    graphs, and gives the same greedy streams on the same batch as a run
    without the crash."""
    import time

    from llmq_tpu_torch import chaos
    from llmq_tpu_torch.core.config import (AsyncPipelineConfig,
                                            ChaosConfig, SupervisorConfig)
    from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.engine.supervisor import EngineSupervisor
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.models import llama as T

    cfg = T.get_config("llama3-tiny", dim=512, n_heads=8, n_kv_heads=2,
                       n_layers=2, vocab_size=512, max_seq_len=256)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    ex = TorchExecutor(cfg, params, batch_size=4, page_size=16, num_pages=96,
                       prefill_buckets=[16, 64], chunk_size=GRAPH_K,
                       eos_id=-1, device="cuda")
    eng = InferenceEngine(ex, ByteTokenizer(), max_decode_steps=24,
                          async_pipeline=AsyncPipelineConfig())
    prompts = ["chaos on the card", "a graph chunk in flight",
               "the supervisor restarts", "same streams after"]

    def batch(tag):
        return [eng.submit(GenRequest(id=f"{tag}{i}", prompt=p,
                                      max_new_tokens=24))
                for i, p in enumerate(prompts)]

    hs = batch("base")
    eng.run_until_idle()
    base = [h.result.tokens for h in hs]
    assert all(len(t) == 24 for t in base)
    graphs = ex._n_graphs()
    try:
        hs = batch("crash")
        tok0 = eng.tokens_generated_total
        for _ in range(200):
            eng.step()
            if eng._inflight and eng.tokens_generated_total - tok0 >= 8:
                break
        assert eng._inflight
        inj = chaos.configure(ChaosConfig(enabled=True, seed=5))
        inj.add_rule("engine.step", kind="crash", times=1)
        eng.start()
        deadline = time.time() + 10.0
        while eng.running and time.time() < deadline:
            time.sleep(0.01)
        assert not eng.running
        sup = EngineSupervisor(eng, config=SupervisorConfig(),
                               enable_metrics=False)
        assert sup.check_once()
        assert not eng._inflight
        for h in hs:
            assert h.wait(10.0)
            assert h.result.finish_reason == "error"
        assert inj.get_stats()["injected"] == {"engine.step:crash": 1}
        replays = ex.graph_replays
        hs = batch("after")
        for h in hs:
            assert h.wait(60.0)
        assert [h.result.tokens for h in hs] == base
        assert ex._n_graphs() == graphs
        assert ex.graph_replays > replays
        sup.stop()
    finally:
        chaos.configure(None)
        eng.stop()
        ex.release_graphs()


@needs_cuda
def test_tenant_capped_ragged_slices_end_mid_page_match_twins():
    """The tenancy plane's capped pack on the ragged path: a 4:1 split of
    a 128-token budget gives slices of 102 and 26 tokens, both ending
    mid-page (page size 16), and the next step continues each from its
    mid-page position. Two steps of kernel 2 (the slices' writes) and
    kernel 6 (six decode rows and the two slices) against their twins:
    pools bit-exact, attention within ATOL and REL_TOL, rows outside the
    slices zero."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    kp, vp = _pools(gen)
    dec_lens = [40, 17, 129, 64, 5, 200]
    B, N = len(dec_lens), 144
    prompt = (1500, 1500)
    bt = torch.zeros((B + 2, MP), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(dec_lens):
        pages = -(-(n + 8) // PS)
        bt[b, :pages] = torch.arange(nxt, nxt + pages, dtype=torch.int32)
        nxt += pages
    for s in range(2):
        pages = -(-208 // PS)
        bt[B + s, :pages] = torch.arange(nxt, nxt + pages, dtype=torch.int32)
        nxt += pages
    assert nxt <= P
    bt = bt.cuda()
    ka, va, kb, vb = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    done = [0, 0]
    for step in range(2):
        qlen = [102, 26]
        qstart = list(done)
        assert all((st + n) % PS for st, n in zip(qstart, qlen))  # mid-page
        qoff = [0, 104]
        lens = [n + step + 1 for n in dec_lens]
        sl = torch.tensor(lens + [st + n for st, n in zip(qstart, qlen)],
                          dtype=torch.int32, device="cuda")
        wp = torch.tensor([int(bt[b, (lens[b] - 1) // PS])
                           for b in range(B)], dtype=torch.int32,
                          device="cuda")
        meta = [torch.tensor(c, dtype=torch.int32, device="cuda")
                for c in (qoff, qlen, qstart)]
        k_pf, v_pf = _rand((N, GD), gen), _rand((N, GD), gen)
        q_dec, q_pf = _rand((B, H, D), gen), _rand((N, H, D), gen)
        kn, vn = _rand((B, HKV, D), gen), _rand((B, HKV, D), gen)
        before = dict(kernels.LAUNCHES)
        kernels.kv_prefill_write(ka, va, k_pf, v_pf, bt[B:], *meta, N, 1)
        a_d, a_p = kernels.ragged_mixed_attention(
            q_dec, kn, vn, q_pf, ka, va, bt, sl, wp, *meta, 1)
        kernels.kv_prefill_write_plain(kb, vb, k_pf, v_pf, bt[B:], *meta,
                                       N, 1)
        b_d, b_p = kernels.ragged_mixed_attention_plain(
            q_dec, kn, vn, q_pf, kb, vb, bt, sl, wp, *meta, 1)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["kv_prefill_write"] == \
            before["kv_prefill_write"] + 1
        assert kernels.LAUNCHES["ragged_mixed_attention"] == \
            before["ragged_mixed_attention"] + 1
        assert torch.equal(ka, kb) and torch.equal(va, vb), step
        assert (a_d.float() - b_d.float()).abs().max().item() <= ATOL
        assert _scaled_err(a_d, b_d) <= REL_TOL
        live = torch.zeros(N, dtype=torch.bool, device="cuda")
        live[0:102] = True
        live[104:130] = True
        assert (a_p[live].float() - b_p[live].float()).abs().max().item() \
            <= ATOL
        assert _scaled_err(a_p[live], b_p[live]) <= REL_TOL
        assert torch.all(a_p[~live] == 0)
        done = [st + n for st, n in zip(qstart, qlen)]
    assert done == [204, 52] and all(d < p for d, p in zip(done, prompt))


@needs_cuda
def test_bf16_checkpoints_load_onto_the_card(tmp_path):
    """A bf16 Hugging Face directory written by the port's own writer (two
    shards, tied head) imports onto the card bitwise equal to the CPU
    import; the port's checkpoint of an int8 tree loads onto the card
    bitwise, its int8 leaves column major."""
    from llmq_tpu_torch.models import checkpoint as ck
    from llmq_tpu_torch.models import llama as TL
    from llmq_tpu_torch.ops import quant

    cfg = TL.get_config("llama3-tiny", dim=256, n_heads=2, n_kv_heads=1,
                        tie_embeddings=True)
    params = TL.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        3), "cuda")
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    hf = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["final_norm"]}
    for i in range(cfg.n_layers):
        lp = params["layers"]
        for k, n in names.items():
            hf[f"model.layers.{i}.{n}.weight"] = lp[k][i].T
        hf[f"model.layers.{i}.input_layernorm.weight"] = lp["attn_norm"][i]
        hf[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            lp["mlp_norm"][i]
    d = tmp_path / "tiny.safetensors.d"
    d.mkdir()
    keys = sorted(hf)
    for s in range(2):
        ck.write_safetensors(str(d / f"model-{s}.safetensors"),
                             {k: hf[k] for k in keys[s::2]})
    card = ck.import_hf_llama(str(d), cfg, device="cuda")
    host = ck.import_hf_llama(str(d), cfg, device="cpu")

    def leaves(t, pre=""):
        for k, v in sorted(t.items()):
            if isinstance(v, dict):
                yield from leaves(v, pre + k + ".")
            else:
                yield pre + k, v
    for (k, a), (_, b), (_, c) in zip(leaves(card), leaves(host),
                                      leaves(params)):
        assert a.is_cuda and a.dtype == torch.bfloat16, k
        assert torch.equal(a.cpu().view(torch.int16),
                           b.view(torch.int16)), k
        assert torch.equal(a, c), k
    q8 = quant.quantize_params(params)
    path = str(tmp_path / "q8.ckpt")
    ck.save_checkpoint(path, q8)
    back = ck.load_checkpoint(path, device="cuda")
    for (k, a), (_, b) in zip(leaves(back), leaves(q8)):
        assert a.is_cuda and torch.equal(a, b) and a.stride() == b.stride(), k


# -- the disaggregation and control planes on the card ---------------------------


@needs_cuda
def test_exchange_handoff_between_two_executors_is_bit_exact():
    """Pages 3, 9, 4 of one bf16 executor's pools go through its tiering
    plane into the KV exchange (a demote, then a publish), and another
    executor's plane claims them (``prepare(remote=True)``) and injects
    them into pages 20, 21, 30 of its own pools, byte for byte."""
    import time

    from llmq_tpu_torch.conversation.persistence import InMemoryStore
    from llmq_tpu_torch.core.config import KVTieringConfig
    from llmq_tpu_torch.disagg import KVExchange
    from llmq_tpu_torch.tiering import KVTieringPlane

    src_ex, dst_ex = _graph_executor("fused"), _graph_executor("fused")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for pool in src_ex.cache.values():
        pool.copy_(torch.randn(pool.shape, generator=gen,
                               device="cuda").to(pool.dtype))
    store = InMemoryStore()
    planes = []
    for ex, name, role in ((src_ex, "prefill-card", "prefill"),
                           (dst_ex, "decode-card", "decode")):
        plane = KVTieringPlane(KVTieringConfig(enabled=True,
                                               host_capacity_mb=8),
                               name, ex)
        plane.store = store
        plane.exchange = KVExchange(store, role=role, metrics=False)
        planes.append(plane)
    pub, sub = planes
    src, dst = [3, 9, 4], [20, 21, 30]
    before = {k: v[:, src].clone() for k, v in src_ex.cache.items()}
    try:
        assert pub.demote("c", src, [1] * 40, 40, None) == "host"
        assert pub.flush_jobs(30.0)
        assert pub.export_to_exchange("c")
        assert pub.flush_jobs(30.0)
        assert sub.prepare("c", remote=True)
        deadline = time.time() + 30.0
        status, entry = "wait", None
        while status != "ready" and time.time() < deadline:
            status, entry = sub.claim("c")
        assert status == "ready" and entry.from_exchange
        assert entry.source_tier == "store" and entry.tokens == [1] * 40
        fence = dst_ex.import_kv_pages(dst, sub.unpack(entry))
        sub.release(entry, fence)
        torch.cuda.synchronize()
        for k, v in dst_ex.cache.items():
            assert torch.equal(v[:, dst], before[k]), k
        assert (pub.exchange.totals["published"],
                sub.exchange.totals["claimed"]) == (1, 1)
    finally:
        for p in planes:
            p.stop()


@needs_cuda
def test_local_pool_replica_on_the_card_launches_kernels_1_to_3():
    """A ``LocalEnginePool`` replica whose factory builds a bf16 engine
    on the card: provisioned, supervised and served through the cluster
    router, its prefill writes (kernel 2), prefill attention (kernel 3)
    and fused decode (kernel 1) launch; decommission stops it."""
    import time as _time

    from llmq_tpu_torch.cluster.router import ClusterRouter
    from llmq_tpu_torch.controlplane import LocalEnginePool
    from llmq_tpu_torch.core.config import (ClusterConfig,
                                            LoadBalancerConfig,
                                            SupervisorConfig)
    from llmq_tpu_torch.core.types import Message
    from llmq_tpu_torch.engine.engine import InferenceEngine
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.loadbalancer.load_balancer import LoadBalancer
    from llmq_tpu_torch.models import llama as T

    cfg = T.get_config("llama3-tiny", dim=512, n_heads=8, n_kv_heads=2,
                       n_layers=2, vocab_size=512, max_seq_len=256)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")

    def factory(seq):
        ex = TorchExecutor(cfg, params, batch_size=2, page_size=16,
                           num_pages=64, prefill_buckets=[16, 64],
                           chunk_size=4, eos_id=-1, device="cuda")
        return InferenceEngine(ex, ByteTokenizer(), name=f"card-{seq}",
                               enable_metrics=False, max_decode_steps=8)

    pool = LocalEnginePool(factory, supervisor_config=SupervisorConfig(
        check_interval=0.05))
    router = ClusterRouter(LoadBalancer(LoadBalancerConfig(
        health_check_interval=0.0)), config=ClusterConfig(),
        enable_metrics=False)
    names = ("kv_prefill_write", "prefill_attention", "fused_decode")
    before = {n: kernels.LAUNCHES[n] for n in names}
    ep = pool.provision(1)
    eng = ep.metadata["engine"]
    try:
        router.lb.add_endpoint(ep)
        msg = Message(id="card0", content="a replica on the card",
                      user_id="u", timeout=120.0,
                      metadata={"max_new_tokens": 8})
        t0 = _time.time()
        router.process_fn(None, msg)
        assert msg.metadata["endpoint_id"] == "card-1"
        assert msg.metadata["usage"]["completion_tokens"] == 8
        assert _time.time() - t0 < 120.0
        for n in names:
            assert kernels.LAUNCHES[n] > before[n], n
    finally:
        pool.decommission(ep)
        eng.executor.release_graphs()
    assert not eng.running
    assert pool.get_stats()["live"] == 0


# -- the scenario engine and lockdep on the card ---------------------------------

#: An inline scenario: 3 conversations of 3 turns, an ``engine.step`` crash
#: armed before the first turn lands (no match: it takes the one engine).
CRASH_SPEC = {
    "name": "card_crash", "seed": 21, "tick_s": 0.25, "retries": 2,
    "max_conversations": 3,
    "phases": [{"name": "p", "duration_s": 2.0,
                "arrival": {"kind": "poisson", "rate": 200.0}}],
    "populations": [{"name": "chat", "tenants": {"a": 2.0, "b": 1.0},
                     "turns_min": 3, "turns_max": 3, "think_time_s": 0.2,
                     "prompt_tokens_min": 8, "prompt_tokens_max": 24,
                     "followup_tokens_min": 4, "followup_tokens_max": 8,
                     "output_tokens_min": 6, "output_tokens_max": 12}],
    "chaos_events": [{"at_s": 0.0, "point": "engine.step", "kind": "crash",
                      "times": 1}],
}


def _card_engine(name, device="cuda"):
    """A bf16 two-layer engine at head_dim 64 with the JAX defaults'
    pipeline and prefix cache, random weights from seed 0."""
    from llmq_tpu_torch.core.config import (AsyncPipelineConfig,
                                            PrefixCacheConfig)
    from llmq_tpu_torch.engine.engine import InferenceEngine
    from llmq_tpu_torch.engine.executor import TorchExecutor
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.models import llama as T

    cfg = T.get_config("llama3-tiny", dim=512, n_heads=8, n_kv_heads=2,
                       n_layers=2, vocab_size=512, max_seq_len=256)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    ex = TorchExecutor(cfg, params, batch_size=4, page_size=16, num_pages=96,
                       prefill_buckets=[16, 64, 256], chunk_size=4,
                       eos_id=-1, device=device)
    return InferenceEngine(ex, ByteTokenizer(), name=name,
                           enable_metrics=False, max_decode_steps=16,
                           async_pipeline=AsyncPipelineConfig(),
                           prefix_cache=PrefixCacheConfig())


def _crash_scenario(device="cuda"):
    """CRASH_SPEC through the port's ``run_scenario`` on an
    ``EngineTarget`` over a card engine: (report, launches, replays)."""
    from llmq_tpu_torch import chaos
    from llmq_tpu_torch.observability.usage import get_usage_ledger
    from llmq_tpu_torch.scenarios import EngineTarget, run_scenario

    eng = _card_engine("card-scenario", device)
    led = get_usage_ledger()
    was = led.enabled
    names = ("kv_prefill_write", "prefill_attention", "fused_decode")
    before = {n: kernels.LAUNCHES[n] for n in names}
    target = EngineTarget(eng, own=True)
    try:
        rep = run_scenario(CRASH_SPEC, target=target)
    finally:
        target.stop()
        chaos.configure(None)
        led.reconfigure(enabled=was)
        led.clear()
        if device == "cuda":
            eng.executor.release_graphs()
    return rep, {n: kernels.LAUNCHES[n] - before[n] for n in names}


@needs_cuda
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_engine_target_plays_a_crash_scenario_on_the_card():
    """An inline 3-conversation spec with one ``engine.step`` crash on a
    bf16 card engine: the crash fires once, the target's supervisor
    recovers the engine, every turn completes, the invariant checker
    finds nothing, and kernels 1-3 launch."""
    rep, launches = _crash_scenario()
    req = rep["requests"]
    assert req["chaos_events_fired"] == 1 and req["engine_recoveries"] >= 1
    assert req["completed"] == req["turns_planned"] == 9
    assert req["submitted"] == req["completed"] + req["failed"]
    assert req["retried"] == req["failed"]
    assert rep["invariants"]["violations"] == 0
    assert all(v > 0 for v in launches.values()), launches


@needs_cuda
def test_lockdep_around_a_card_engine_reports_counts():
    """The port's lockdep installed around a card engine's build and a
    short run of four requests: it tracks the engine's locks (sites and
    edges counted) and records no violation."""
    from llmq_tpu_torch.analysis import lockdep
    from llmq_tpu_torch.engine.engine import GenRequest

    was = lockdep.is_installed()
    lockdep.install()
    lockdep.reset()
    try:
        eng = _card_engine("card-lockdep")
        eng.start()
        try:
            hs = [eng.submit(GenRequest(id=f"l{i}", prompt=f"lockdep {i}",
                                        max_new_tokens=12))
                  for i in range(4)]
            for h in hs:
                assert h.wait(120.0)
                assert len(h.result.tokens) == 12
        finally:
            eng.stop()
            eng.executor.release_graphs()
        rep = lockdep.report()
    finally:
        lockdep.reset()
        if not was:
            lockdep.uninstall()
    print(f"lockdep: {rep['sites']} sites, {rep['edges']} edges, "
          f"{len(rep['self_sites'])} self sites, "
          f"{len(rep['violations'])} violations", flush=True)
    assert rep["sites"] > 0 and rep["violations"] == [], rep


# -- the mesh executor (serve-mesh's checks at small shapes) --------------------

#: A kernel-eligible model (D=128; at tp=2 a rank holds 4 query heads over
#: 1 KV head, n_rep 4) and serve-mesh b's bf16 gate.
MESH_CFG = dict(dim=1024, n_heads=8, n_kv_heads=2, ffn_dim=512,
                vocab_size=512, n_layers=2, max_seq_len=256)
MESH_BOUND = 0.05

_TP1_SCRIPT = r"""
import json, socket, sys
sys.path.insert(0, sys.argv[1])
import torch
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine
from llmq_tpu_torch.engine.executor import TorchExecutor
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.models.llama import init_params, llama3_tiny
from llmq_tpu_torch.parallel import distributed_init, make_mesh
s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]
s.close()
distributed_init(f"127.0.0.1:{port}", 1, 0, 120, device="cuda")
cfg = llama3_tiny(**json.loads(sys.argv[2]))
out = {}
for name, mesh in (("tp1", make_mesh({"tp": 1})), ("off", None)):
    gen = torch.Generator(device="cuda").manual_seed(0)
    ex = TorchExecutor(cfg, init_params(cfg, gen, "cuda"), batch_size=2,
                       page_size=16, num_pages=33, prefill_buckets=[32],
                       chunk_size=4, eos_id=2, device="cuda", mesh=mesh)
    ex.warmup()
    eng = InferenceEngine(ex, ByteTokenizer(), name=name,
                          enable_metrics=False, max_decode_steps=12)
    hs = [eng.submit(GenRequest(id=f"r{i}", prompt=p)) for i, p in
          enumerate(["mesh of one rank", "a second prompt", "third"])]
    eng.run_until_idle()
    out[name] = {"tokens": [h.result.tokens for h in hs],
                 "replays": ex.graph_replays
                 + sum(ex.program_replays.values()),
                 "collectives": ex.model.tp is not None,
                 "backend": None if mesh is None else mesh.backend,
                 "chips": [c["chip"] for c in ex.hbm_info()],
                 "n_chips": ex.telemetry_info()["n_chips"]}
    eng.stop()
    ex.release_graphs()
print("RESULT", json.dumps(out))
import torch.distributed as dist
dist.destroy_process_group()
"""


@needs_cuda
def test_tp1_nccl_mesh_executor_serves_like_no_mesh():
    """serve-mesh a at small shapes: a ``{tp: 1}`` mesh over an NCCL
    world of one captures its collectives in its graphs and serves the
    same greedy tokens as the executor without a mesh."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", _TP1_SCRIPT, repo,
                        json.dumps(MESH_CFG)], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    out = json.loads(p.stdout.split("RESULT", 1)[1])
    tp1, off = out["tp1"], out["off"]
    assert tp1["backend"] == "nccl" and tp1["collectives"]
    assert tp1["replays"] > 0 and off["replays"] > 0
    assert tp1["tokens"] == off["tokens"]
    assert tp1["chips"] == ["0"] and tp1["n_chips"] == 1


@needs_cuda
def test_two_rank_gloo_tp2_forward_on_the_card_matches_one_rank(tmp_path):
    """serve-mesh b at small shapes: two gloo ranks on the one card, each
    with half the heads, run the forwards through the kernels; their
    logits are the one-rank forward's within MESH_BOUND x max |logit|."""
    import json
    import os
    import socket
    import subprocess
    import sys

    import numpy as np

    from llmq_tpu_torch.models import llama as M

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg32 = M.llama3_tiny(dtype=torch.float32, **MESH_CFG)
    params = M.init_params(cfg32, torch.Generator().manual_seed(0), "cpu")
    flat = {}

    def walk(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + k + "/")
            else:
                flat[pre + k] = v.numpy()
    walk(params)
    weights = str(tmp_path / "w.npz")
    np.savez(weights, **flat)
    rng = np.random.default_rng(3)
    i32 = np.int32
    inputs = {"tokens": rng.integers(0, 512, (2, 32)).astype(i32),
              "positions": np.broadcast_to(np.arange(32, dtype=i32),
                                           (2, 32)).copy(),
              "lengths": np.array([32, 20], i32),
              "bt": np.array([[1, 2, 3], [4, 5, 6]], i32),
              "dec_tokens": np.array([7, 9], i32),
              "dec_positions": np.array([32, 20], i32),
              "mix_tokens": np.array([11, 13], i32),
              "mix_positions": np.array([33, 21], i32),
              "pf_tokens": rng.integers(0, 512, (1, 16)).astype(i32),
              "pf_positions": np.arange(16, dtype=i32)[None],
              "pf_lengths": np.array([16], i32),
              "pf_bt": np.array([[7, 0, 0]], i32)}
    variant = {"kind": "forward", "cfg": MESH_CFG, "weights": weights,
               "inputs": {k: v.tolist() for k, v in inputs.items()},
               "pages": 9, "page_size": 16, "device": "cuda",
               "dtype": "bfloat16"}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    out = str(tmp_path / "out.json")
    procs = []
    for r in range(2):
        spec = tmp_path / f"rank{r}.json"
        spec.write_text(json.dumps({"coord": coord, "world": 2, "rank": r,
                                    "out": out, "timeout": 120,
                                    "variants": [variant]}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(repo, "tests",
                                          "torch_mesh_rank.py"), str(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    with open(out) as f:
        got = json.load(f)[0]
    assert got["kv_heads"] == 1
    for k in ("fused_decode", "kv_prefill_write", "prefill_attention"):
        assert got["launches"][k] > 0, got["launches"]
    cfg = M.llama3_tiny(dtype=torch.bfloat16, **MESH_CFG)
    whole = {k: (v.to("cuda", torch.bfloat16) if not isinstance(v, dict)
                 else {n: x.to("cuda", torch.bfloat16)
                       for n, x in v.items()}) for k, v in params.items()}
    t = {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}
    cache = M.init_kv_pages(cfg, 9, 16, "cuda")
    ref = {"prefill": M.forward_prefill(whole, cfg, t["tokens"],
                                        t["positions"], t["lengths"], cache,
                                        t["bt"])}
    ref["decode"] = M.forward_decode(whole, cfg, t["dec_tokens"],
                                     t["dec_positions"], cache, t["bt"])
    ref["mixed_dec"], ref["mixed_pf"] = M.forward_mixed(
        whole, cfg, t["mix_tokens"], t["mix_positions"], cache, t["bt"],
        t["pf_tokens"], t["pf_positions"], t["pf_lengths"], t["pf_bt"])
    live = (torch.arange(32, device="cuda")[None, :]
            < t["lengths"][:, None])
    for k, r in ref.items():
        g = torch.tensor(got[k], device="cuda")
        r = r.float()
        if k == "prefill":
            g, r = g[live], r[live]
        err = (g - r).abs().max().item()
        assert err <= MESH_BOUND * r.abs().max().item(), (k, err)


# -- dp replicas: a replica's local pool and its guest pages -------------------


def _dp_local(plane, pools, guests):
    """A replica's local pool made from the one-device ``pools`` (every
    leaf ``(L, P, ...)``): its null slot zero, its universe's pages at
    their home slots, ``guests`` (page → slot) copied in."""
    out = []
    for pool in pools:
        loc = torch.zeros((pool.shape[0], plane.local_pages)
                          + tuple(pool.shape[2:]), dtype=pool.dtype,
                          device=pool.device)
        u0 = plane.d * plane.per
        loc[:, 1:1 + plane.per] = pool[:, u0:u0 + plane.per]
        for page, slot in guests.items():
            loc[:, slot] = pool[:, page]
        out.append(loc)
    return out


@needs_cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_dp_local_pool_kernels_match_one_device_twins(kv):
    """Replica 1 of a dp=2 mesh: its rows' block tables translated to its
    local pool (its universe, a guest page of universe 0, the null slot)
    drive kernels 1, 2 and 3 (bf16) or 5 (int8 KV) on that pool; the
    twins run on the one-device pool with the global tables. Outputs
    within the kernels' tolerances, every written page bit-exact at its
    home."""
    from llmq_tpu_torch.parallel.dp import DpPlane
    from llmq_tpu_torch.parallel.mesh import Mesh

    gen = torch.Generator(device="cuda").manual_seed(22)
    plane = DpPlane(Mesh({"dp": 2, "tp": 1}, rank=1), num_pages=P,
                    batch_size=4, max_pages_per_seq=MP, guest_rows=2)
    per = plane.per
    # Row 2 lives in universe 1; row 3 reads two pages of universe 0.
    bt = torch.zeros((2, MP), dtype=torch.int32)
    bt[0, :3] = torch.tensor([per + 3, per + 9, per + 4])
    bt[1, :4] = torch.tensor([per + 20, 5, per + 21, 7])
    lens = torch.tensor([40, 60], dtype=torch.int32)
    guests = plane.plan([[], [bt.numpy()]])[1]
    assert sorted(guests) == [5, 7]
    lbt = torch.from_numpy(plane.translate(bt.numpy(), guests)).cuda()
    gbt = bt.cuda()
    sl = lens.cuda()
    wp_g = gbt[torch.arange(2), ((sl - 1) // PS).long()]
    wp_l = lbt[torch.arange(2), ((sl - 1) // PS).long()]
    kp, vp = _pools(gen)
    kn, vn = _rand((2, HKV, D), gen), _rand((2, HKV, D), gen)
    q = _rand((2, H, D), gen)

    def home(loc, pool):
        """Every page of ``loc`` back at its global id."""
        out = pool.clone()
        u0 = plane.d * plane.per
        out[:, u0:u0 + plane.per] = loc[:, 1:1 + plane.per]
        for page, slot in guests.items():
            out[:, page] = loc[:, slot]
        return out

    if kv == "int8":
        pools = list(_q8_pools(kp, vp))
        local = _dp_local(plane, pools, guests)
        (kq, ks), (vq, vs) = _q8(kn.reshape(2, -1)), _q8(vn.reshape(2, -1))
        a = kernels.fused_decode_q8(q, kq, ks, vq, vs, *local, lbt, sl, wp_l,
                                    1)
        b = kernels.fused_decode_q8_plain(q, kq, ks, vq, vs, *pools, gbt, sl,
                                          wp_g, 1)
        torch.cuda.synchronize()
        assert (a.float() - b.float()).abs().max().item() <= Q8_ATOL
        for x, y in zip(local, pools):
            assert torch.equal(home(x, y), y)
        return
    lk, lv = _dp_local(plane, [kp, vp], guests)
    a = kernels.fused_decode(q, kn, vn, lk, lv, lbt, sl, wp_l, 1)
    b = kernels.fused_decode_plain(q, kn, vn, kp, vp, gbt, sl, wp_g, 1)
    torch.cuda.synchronize()
    assert (a.float() - b.float()).abs().max().item() <= ATOL
    assert torch.equal(home(lk, kp), kp) and torch.equal(home(lv, vp), vp)
    # Kernels 2 and 3: row 3's chunk of 30 tokens from position 30, over
    # its own and its guest pages.
    T, start = 32, 30
    rk, rv = _rand((T, GD), gen), _rand((T, GD), gen)
    desc = _desc([0], [T], [start])
    kernels.kv_prefill_write(lk, lv, rk, rv, lbt[1:], *desc, T, 0)
    kernels.kv_prefill_write_plain(kp, vp, rk, rv, gbt[1:], *desc, T, 0)
    torch.cuda.synchronize()
    assert torch.equal(home(lk, kp), kp) and torch.equal(home(lv, vp), vp)
    qc = _rand((T, H, D), gen)
    a = _attn1(kernels.prefill_attention, qc, lk, lv, lbt[1], start, 0)
    b = _attn1(kernels.prefill_attention_plain, qc, kp, vp, gbt[1], start, 0)
    torch.cuda.synchronize()
    assert (a.float() - b.float()).abs().max().item() <= ATOL


@needs_cuda
def test_dp_guest_page_round_trip_is_bit_exact():
    """A page of every leaf (int8 values, bf16 scales) gathered from its
    home slot to host memory, scattered into a guest slot of another
    pool, and back home again: byte for byte."""
    from llmq_tpu_torch.parallel.dp import gather, scatter

    gen = torch.Generator(device="cuda").manual_seed(23)
    kp, vp = _pools(gen)
    home = dict(zip(("k", "v", "k_scale", "v_scale"), _q8_pools(kp, vp)))
    other = {k: torch.zeros_like(v) for k, v in home.items()}
    src, guest = [3, 17, 40], [60, 61, 62]
    before = {k: v[:, src].clone() for k, v in home.items()}
    buf = gather(home, src)
    assert buf.device.type == "cpu"
    scatter(other, guest, buf)
    for k in home:
        home[k][:, src] = 0
    scatter(home, src, gather(other, guest))
    torch.cuda.synchronize()
    for k, v in home.items():
        assert torch.equal(v[:, src], before[k]), k
        assert torch.equal(other[k][:, guest], before[k]), k
