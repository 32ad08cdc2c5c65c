"""Attention ops over the paged KV pool (counterpart of
``llmq_tpu/ops/attention.py``), in the JAX package's layouts.

Plain routes (the semantics the kernels are held to):
:func:`causal_prefill_attention`, :func:`_gqa_attend`,
:func:`paged_decode_attention_pooled`, the scatter write
:func:`paged_kv_write` and the online-softmax
:func:`blockwise_prefill_attention`.

Routes that choose a kernel or its plain twin:
:func:`paged_kv_write_prefill`, :func:`dispatch_prefill_attention`,
:func:`paged_decode_step` and :func:`ragged_mixed_step`, and over the
int8 pools :func:`paged_decode_step_q8` and :func:`ragged_mixed_step_q8`.
The choice is the tensors' device and nothing else: a CUDA tensor
launches the hand-written kernel (``ops/kernels.py``), a CPU tensor
takes the kernel's plain twin. The int8 prefill write and attention
(:func:`paged_kv_write_prefill_q8`, :func:`dispatch_prefill_attention_q8`)
are plain ops on both devices, as in the JAX package, where they are
pure JAX.

Pools are flat ``(L, P, page_size, H_kv·D)``; page 0 is the null page.
Writes update the pools in place — the port's counterpart of JAX's
buffer donation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from llmq_tpu_torch.ops import kernels
from llmq_tpu_torch.ops.quant import quantize_kv_rows

NEG_INF = -1e30


def causal_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             q_offset=0) -> torch.Tensor:
    """Causal self-attention for prefill. q (B, T, H, D); k, v
    (B, S, H_kv, D) with S ≥ T; ``q_offset`` is the absolute position of
    q's first token (int or (B,)). GQA by grouping query heads, softmax
    in f32. Returns (B, T, H, D)."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, T, Hkv, n_rep, D)
    logits = torch.einsum("btgrd,bsgd->bgrts", qg.float(), k.float()) * scale
    offset = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1, 1)
    q_pos = torch.arange(T, device=q.device)[:, None] + offset  # (B|1,T,1)
    kv_pos = torch.arange(S, device=q.device)[None, None, :]
    mask = (kv_pos <= q_pos)[:, None, None, :, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrts,bsgd->btgrd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def _gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                seq_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention: q (B, H, D) against gathered history k/v
    (B, S, H_kv, D), masked at and beyond ``seq_lens``. Returns
    (B, H, D)."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Hkv, n_rep, D)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg.float(), k.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] < seq_lens[:, None]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention_pooled(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  seq_lens: torch.Tensor,
                                  layer: int) -> torch.Tensor:
    """Decode attention reading layer ``layer`` of the flat pool through
    ``block_tables`` (B, max_pages). Returns (B, H, D)."""
    B, H, D = q.shape
    page_size = k_pool.shape[2]
    S = block_tables.shape[1] * page_size
    Hkv = k_pool.shape[3] // D
    bt = block_tables.long()
    k = k_pool[layer][bt].reshape(B, S, Hkv, D)
    v = v_pool[layer][bt].reshape(B, S, Hkv, D)
    return _gqa_attend(q, k, v, seq_lens)


def paged_kv_write(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   page_of: torch.Tensor, slot_of: torch.Tensor,
                   layer: int) -> None:
    """Scatter N token rows (k_new/v_new (N, H_kv, D) or (N, GD)) into
    layer ``layer`` of the pools, in place."""
    N = k_new.shape[0]
    page = page_of.long()
    slot = slot_of.long()
    GD = k_pool.shape[-1]
    k_pool[layer, page, slot] = k_new.reshape(N, GD).to(k_pool.dtype)
    v_pool[layer, page, slot] = v_new.reshape(N, GD).to(v_pool.dtype)


def blockwise_prefill_attention(q: torch.Tensor, k_hist: torch.Tensor,
                                v_hist: torch.Tensor,
                                positions: torch.Tensor,
                                seq_lens: torch.Tensor, *,
                                block_size: int = 512) -> torch.Tensor:
    """Prefill attention with an online softmax over KV chunks.

    q (B, T, H, D); k_hist, v_hist (B, S, H_kv, D); ``positions`` (B, T)
    absolute query positions; ``seq_lens`` (B,) visible history. Mask:
    kv_pos <= q_pos and kv_pos < seq_len. Peak memory is
    O(B·H·T·block_size) f32 instead of O(B·H·T·S)."""
    B, T, H, D = q.shape
    S, Hkv = k_hist.shape[1], k_hist.shape[2]
    n_rep = H // Hkv
    Sb = min(block_size, S)
    while S % Sb:
        Sb -= 1
    scale = D ** -0.5
    qg = q.reshape(B, T, Hkv, n_rep, D).float()
    dev = q.device
    m = torch.full((B, T, Hkv, n_rep, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l_sum = torch.zeros((B, T, Hkv, n_rep, 1), dtype=torch.float32,
                        device=dev)
    acc = torch.zeros((B, T, Hkv, n_rep, D), dtype=torch.float32,
                      device=dev)
    for i in range(S // Sb):
        k_b = k_hist[:, i * Sb:(i + 1) * Sb]
        v_b = v_hist[:, i * Sb:(i + 1) * Sb]
        logits = torch.einsum("btgrd,bsgd->btgrs", qg, k_b.float()) * scale
        kv_pos = i * Sb + torch.arange(Sb, device=dev)[None, :]     # (1, Sb)
        mask = ((kv_pos[:, None, :] <= positions[:, :, None])
                & (kv_pos[:, None, :] < seq_lens[:, None, None]))  # (B,T,Sb)
        mask = mask[:, :, None, None, :]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        # Explicit zero for masked entries: a fully masked chunk keeps
        # m_new at NEG_INF and exp(logits - m_new) would be exp(0) = 1.
        p = torch.where(mask, torch.exp(logits - m_new),
                        torch.zeros_like(logits))
        l_sum = alpha * l_sum + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "btgrs,bsgd->btgrd", p.to(v_b.dtype).float(), v_b.float())
        m = m_new
    out = acc / torch.clamp(l_sum, min=1e-30)
    return out.reshape(B, T, H, D).to(q.dtype)


# -- routes: kernel on CUDA, plain twin on CPU --------------------------------

def paged_kv_write_prefill(k_pool: torch.Tensor, v_pool: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           block_tables: torch.Tensor, offsets: torch.Tensor,
                           starts: torch.Tensor, lengths: torch.Tensor,
                           layer: int) -> None:
    """Write a prefill batch's K/V (k, v (B, T, H_kv, D)) into layer
    ``layer`` in place, in one prefill-write launch for every row: row
    b's first ``lengths[b]`` tokens land at positions ``starts[b] + t``;
    the rest are padding and are not written. ``offsets`` (``b·T``),
    ``starts`` and ``lengths`` are device int32 (B,), so nothing is read
    back to the host."""
    B, T = k.shape[0], k.shape[1]
    GD = k_pool.shape[3]
    kernels.kv_prefill_write(k_pool, v_pool, k.reshape(B * T, GD),
                             v.reshape(B * T, GD), block_tables, offsets,
                             lengths, starts, T, layer)


def dispatch_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               starts: torch.Tensor, lengths: torch.Tensor,
                               layer: int) -> torch.Tensor:
    """Prefill-chunk attention over the pool for every row in one launch;
    q (B, T, H, D). Row b's queries sit at positions ``starts[b] + t``
    (contiguous chunks); tokens at or past ``lengths[b]`` come out as
    zeros. ``starts`` and ``lengths`` are device int32 (B,). Returns
    (B, T, H, D)."""
    return kernels.prefill_attention(q, k_pool, v_pool, block_tables,
                                     starts, lengths, layer)


def paged_decode_step(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      seq_lens: torch.Tensor, page_of: torch.Tensor,
                      slot_of: torch.Tensor, layer: int, *,
                      fused: bool = True) -> torch.Tensor:
    """One decode layer's KV write + attention; pools update in place.

    ``fused=True``: the fused write+attention kernel. ``fused=False``:
    the split route, the row-write kernel then the decode-attention
    kernel. Both routes give the same attention for live rows (an
    inactive row has ``page_of == 0`` and its output is discarded).
    Returns (B, H, D).
    """
    if fused:
        return kernels.fused_decode(q, k_new, v_new, k_pool, v_pool,
                                    block_tables, seq_lens, page_of, layer)
    N = k_new.shape[0]
    kernels.kv_cache_write(k_pool, v_pool, k_new.reshape(N, -1),
                           v_new.reshape(N, -1), page_of, slot_of, layer)
    return kernels.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                          seq_lens, layer)


# -- ragged mixed prefill+decode ----------------------------------------------
#
# One attention launch per layer for a whole mixed step: B decode rows
# and up to S prefill slices of variable length packed into one token
# buffer, each slice's segment starting on a multiple of RAGGED_Q_BLOCK
# so that every q-block of the kernel has one owner.

#: Packed slice tokens per q-block of the ragged kernel; segments start
#: on multiples of it.
RAGGED_Q_BLOCK = 8


@dataclass(frozen=True)
class RaggedSlices:
    """The slice descriptors of one ragged dispatch, built once on the
    device and read by every layer."""

    block_tables: torch.Tensor   # (B+S, MP) int32: decode rows, slices
    seq_lens: torch.Tensor       # (B+S,) int32: pos+1, then qstart+qlen
    meta: torch.Tensor           # (3, S) int32: qoff, qlen, qstart

    @property
    def n_slices(self) -> int:
        return self.meta.shape[1]


def ragged_slices(dec_block_tables: torch.Tensor,
                  dec_seq_lens: torch.Tensor,
                  pf_block_tables: torch.Tensor, qoff: torch.Tensor,
                  qlen: torch.Tensor, qstart: torch.Tensor) -> RaggedSlices:
    """Descriptors for :func:`ragged_mixed_step` from device tensors
    (qoff, qlen, qstart (S,)): the (3, S) descriptors, and the decode
    rows' and slices' block tables and lengths concatenated, all on the
    device (nothing is read back or uploaded)."""
    meta = torch.stack([qoff, qlen, qstart]).to(torch.int32)
    bt = torch.cat([dec_block_tables.to(torch.int32),
                    pf_block_tables.to(torch.int32)])
    sl = torch.cat([dec_seq_lens.to(torch.int32), meta[2] + meta[1]])
    return RaggedSlices(bt.contiguous(), sl.contiguous(), meta.contiguous())


def ragged_mixed_step(q_dec: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, q_pf: torch.Tensor,
                      k_pf: torch.Tensor, v_pf: torch.Tensor,
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      page_of: torch.Tensor, slices: RaggedSlices,
                      layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One mixed layer, ragged: ONE prefill-write launch for every
    slice's K/V, straight from the packed rows (slice s is rows
    ``[qoff, qoff+qlen)`` of the (N, GD) buffer), then ONE ragged
    attention launch for the decode rows (their K/V written in place at
    ``page_of``) and every packed slice token. An unused slice row
    (qlen 0) writes nothing. The writes precede the attention on the
    stream, so a slice sees its own fresh K/V and that of an earlier
    piece of the same prompt in the same step. Returns ``(attn_dec (B,
    H, D), attn_pf (N, H, D))``; pools update in place."""
    B = q_dec.shape[0]
    N = q_pf.shape[0]
    GD = k_pool.shape[3]
    kernels.kv_prefill_write(k_pool, v_pool, k_pf.reshape(N, GD),
                             v_pf.reshape(N, GD), slices.block_tables[B:],
                             slices.meta[0], slices.meta[1], slices.meta[2],
                             N, layer)
    return kernels.ragged_mixed_attention(
        q_dec, k_new, v_new, q_pf, k_pool, v_pool, slices.block_tables,
        slices.seq_lens, page_of, slices.meta[0], slices.meta[1],
        slices.meta[2], layer)


# -- int8 KV cache ---------------------------------------------------------------
#
# Data pools stay flat (L, P, page_size, H_kv·D) in int8; scale pools are
# (L, P, H_kv, page_size) bf16, one scale per (token, KV head). ``pools``
# is the 4-tuple (k_pool, v_pool, k_scale, v_scale); every write is in
# place.

Q8Pools = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _scale_scatter(scale_pool: torch.Tensor, layer: int,
                   page_of: torch.Tensor, slot_of: torch.Tensor,
                   scales: torch.Tensor) -> None:
    """Write per-(row, head) scales (N, H_kv) at ``[layer, page_of[n], :,
    slot_of[n]]``, in place."""
    heads = torch.arange(scale_pool.shape[2], device=scale_pool.device)
    scale_pool[layer, page_of.long()[:, None], heads[None, :],
               slot_of.long()[:, None]] = scales.to(scale_pool.dtype)


def _dequant_window(pool: torch.Tensor, scale_pool: torch.Tensor,
                    layer: int, block_tables: torch.Tensor,
                    D: int) -> torch.Tensor:
    """Gather and dequantize one layer's pages for a batch of block
    tables (B, n_pages): returns (B, n_pages·page_size, H_kv, D) bf16."""
    B, n_pages = block_tables.shape
    ps = pool.shape[2]
    Hkv = pool.shape[3] // D
    bt = block_tables.long()
    qv = pool[layer][bt].reshape(B, n_pages, ps, Hkv, D)
    sc = scale_pool[layer][bt].transpose(2, 3)      # (B, n_pages, ps, Hkv)
    x = qv.float() * sc.float()[..., None]
    return x.reshape(B, n_pages * ps, Hkv, D).to(torch.bfloat16)


def paged_decode_step_q8(q: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, pools: Q8Pools,
                         block_tables: torch.Tensor, seq_lens: torch.Tensor,
                         page_of: torch.Tensor, layer: int) -> torch.Tensor:
    """One decode layer over the int8 pools: quantize the current token's
    K/V per (row, head) (plain, as the JAX package does outside its
    kernel), then the int8 fused write + attention kernel, which writes
    each row and its scales at slot ``(seq_len-1) % page_size`` of
    ``page_of`` and attends with in-kernel dequant. There is no split
    route. Returns (B, H, D); pools update in place."""
    kq, ks = quantize_kv_rows(k_new)
    vq, vs = quantize_kv_rows(v_new)
    return kernels.fused_decode_q8(q, kq, ks, vq, vs, *pools, block_tables,
                                   seq_lens, page_of, layer)


def paged_kv_write_prefill_q8(pools: Q8Pools, k: torch.Tensor,
                              v: torch.Tensor, block_tables: torch.Tensor,
                              positions: torch.Tensor, lengths: torch.Tensor,
                              layer: int) -> None:
    """A prefill chunk's write into the int8 pools (k, v (B, T, H_kv,
    D)): quantize every (token, head) row and scatter rows and scales,
    in place. Padding rows (past ``lengths``) go to the null page's slot
    0, as in the JAX package's scatter."""
    k_pool, v_pool, ks_pool, vs_pool = pools
    B, T = k.shape[0], k.shape[1]
    ps, GD = k_pool.shape[2], k_pool.shape[3]
    kq, kscale = quantize_kv_rows(k)
    vq, vscale = quantize_kv_rows(v)
    valid = (torch.arange(T, device=k.device)[None, :]
             < lengths[:, None]).reshape(-1)
    pos = positions.reshape(-1).long()
    rows = torch.arange(B, device=k.device).repeat_interleave(T)
    zero = torch.zeros_like(pos)
    page_of = torch.where(valid, block_tables.long()[rows, pos // ps], zero)
    slot_of = torch.where(valid, pos % ps, zero)
    k_pool[layer, page_of, slot_of] = kq.reshape(-1, GD)
    v_pool[layer, page_of, slot_of] = vq.reshape(-1, GD)
    _scale_scatter(ks_pool, layer, page_of, slot_of, kscale.reshape(B * T, -1))
    _scale_scatter(vs_pool, layer, page_of, slot_of, vscale.reshape(B * T, -1))


def dispatch_prefill_attention_q8(q: torch.Tensor, pools: Q8Pools,
                                  block_tables: torch.Tensor,
                                  positions: torch.Tensor,
                                  seq_lens: torch.Tensor,
                                  layer: int) -> torch.Tensor:
    """Prefill-chunk attention over the int8 pools, q (B, T, H, D):
    gather and dequantize the window, then the blockwise online-softmax
    attention. Returns (B, T, H, D)."""
    k_pool, v_pool, ks_pool, vs_pool = pools
    D = q.shape[3]
    k_hist = _dequant_window(k_pool, ks_pool, layer, block_tables, D)
    v_hist = _dequant_window(v_pool, vs_pool, layer, block_tables, D)
    return blockwise_prefill_attention(q, k_hist, v_hist, positions,
                                       seq_lens)


def ragged_slice_rows(slices: RaggedSlices, n_rows: int, page_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where each of the N packed rows of a ragged dispatch lands:
    ``(page_of, slot_of)`` (N,) int64 on the device, built once per
    forward for every layer's int8 slice write. A row outside every
    slice goes to the null page's slot 0, as in the JAX package's int8
    scatter; the set of rows is fixed, so nothing is read back."""
    B = slices.block_tables.shape[0] - slices.n_slices
    qoff, qlen, qstart = slices.meta.long()
    n = torch.arange(n_rows, device=qoff.device)
    inside = (n[:, None] >= qoff[None, :]) & (n[:, None] < (qoff + qlen)[None])
    owner = inside.long().argmax(dim=1)                 # (N,) slice index
    live = inside.any(dim=1)
    pos = (qstart[owner] + n - qoff[owner]).clamp(min=0)
    MP = slices.block_tables.shape[1]
    page = slices.block_tables.long()[B + owner,
                                      (pos // page_size).clamp(max=MP - 1)]
    zero = torch.zeros_like(page)
    return (torch.where(live, page, zero),
            torch.where(live, pos % page_size, zero))


def ragged_mixed_step_q8(q_dec: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, q_pf: torch.Tensor,
                         k_pf: torch.Tensor, v_pf: torch.Tensor,
                         pools: Q8Pools, page_of: torch.Tensor,
                         slices: RaggedSlices, rows, layer: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ragged_mixed_step` over the int8 pools: quantize the N
    packed rows and scatter them with their scales straight from the
    packed buffer (``rows`` from :func:`ragged_slice_rows`: rows outside
    every slice land on the null page; no dense view), then quantize the
    decode rows and make ONE int8 ragged attention launch, which writes
    the decode rows and their scales and dequantizes in the kernel.
    Returns ``(attn_dec (B, H, D), attn_pf (N, H, D))``; pools update in
    place."""
    k_pool, v_pool, ks_pool, vs_pool = pools
    N, H, D = q_pf.shape
    GD = k_pool.shape[3]
    pf_page, pf_slot = rows
    kq, ks = quantize_kv_rows(k_pf.reshape(N, GD // D, D))
    vq, vs = quantize_kv_rows(v_pf.reshape(N, GD // D, D))
    k_pool[layer, pf_page, pf_slot] = kq.reshape(-1, GD)
    v_pool[layer, pf_page, pf_slot] = vq.reshape(-1, GD)
    _scale_scatter(ks_pool, layer, pf_page, pf_slot, ks)
    _scale_scatter(vs_pool, layer, pf_page, pf_slot, vs)
    kq, ks = quantize_kv_rows(k_new)
    vq, vs = quantize_kv_rows(v_new)
    return kernels.ragged_mixed_attention_q8(
        q_dec, kq, ks, vq, vs, q_pf, *pools, slices.block_tables,
        slices.seq_lens, page_of, slices.meta[0], slices.meta[1],
        slices.meta[2], layer)
