"""CUDA-only checks of the port's kernels: each kernel against its plain
twin on the card, at small shapes. They skip on a host without CUDA;
on the card run them with the JAX-free command

    python -m pytest --noconftest tests/test_torch_cuda.py

(``tests/conftest.py`` imports JAX, which the card's machine need not
have). Tolerances: attention atol 2e-2 (bf16 outputs on unit-scale
inputs; the twins round probabilities to bf16 before P @ V), writes
bit-exact over the whole pool.
"""

import pytest
import torch

from llmq_tpu_torch.ops import kernels

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

H, HKV, D, PS, L, P, MP = 8, 2, 128, 16, 2, 64, 16
GD = HKV * D
ATOL = 2e-2


def _rand(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _pools(gen):
    return _rand((L, P, PS, GD), gen), _rand((L, P, PS, GD), gen)


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
    kernels.kv_prefill_write(k1, v1, rk, rv, bt, start, n_tok, 0)
    kernels.kv_prefill_write_plain(k2, v2, rk, rv, bt, start, n_tok, 0)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    q = _rand((T, H, D), gen)
    a = kernels.prefill_attention(q, k1, v1, bt, start, 0)
    b = kernels.prefill_attention_plain(q, k1, v1, bt, start, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    assert (a[:n_tok].float() - b[:n_tok].float()).abs().max().item() <= ATOL


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
        kernels.prefill_attention(q, kp, vp, idx.int(), 0, 0)
