"""Llama-3 family in PyTorch over the paged KV pool (counterpart of
``llmq_tpu/models/llama.py``).

The parameter tree keeps the JAX package's layout and shapes with no
transposes: stacked layers (leading dim L), weights ``(in, out)`` applied
as ``h @ W``. :func:`params_from_jax` carries a JAX tree across key for
key, so the two packages can be held against each other on the same
weights. Layers run unrolled; the pools are updated in place by the
attention routes (the port's counterpart of JAX's donation). Plain
large matmuls stay ``torch.matmul``, as the JAX package leaves them to
XLA; the paged attention and KV writes go through ``ops/attention.py``.

int8 serving: weights may be w8a8 leaves ``{"q", "s"}`` (``ops/quant.py``;
every matmul goes through ``linear``), and a cache made with
``dtype=torch.int8`` carries ``k_scale`` / ``v_scale`` pools, which send
every forward through the int8 attention routes.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from llmq_tpu_torch.ops.attention import (dispatch_prefill_attention,
                                          dispatch_prefill_attention_q8,
                                          paged_decode_step,
                                          paged_decode_step_q8,
                                          paged_kv_write_prefill,
                                          paged_kv_write_prefill_q8,
                                          ragged_mixed_step,
                                          ragged_mixed_step_q8,
                                          ragged_slice_rows, ragged_slices)
from llmq_tpu_torch.ops.norms import rms_norm
from llmq_tpu_torch.ops.quant import (embed_lookup, is_quantized,
                                      layer_slice, linear, linears,
                                      quantize_embedding, quantize_weight,
                                      tied_head_logits)
from llmq_tpu_torch.ops.rope import apply_rope, rope_cos_sin

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class LlamaConfig:
    name: str = "llama3-tiny"
    vocab_size: int = 512
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    ffn_dim: int = 256
    max_seq_len: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def llama3_tiny(**kw) -> LlamaConfig:
    return replace(LlamaConfig(), **kw)


def llama3_1b(**kw) -> LlamaConfig:
    # Public Llama-3.2-1B architecture constants.
    return replace(LlamaConfig(
        name="llama3-1b", vocab_size=128256, dim=2048, n_layers=16,
        n_heads=32, n_kv_heads=8, ffn_dim=8192, max_seq_len=8192,
        rope_theta=500000.0, tie_embeddings=True), **kw)


def llama3_8b(**kw) -> LlamaConfig:
    # Public Llama-3-8B architecture constants.
    return replace(LlamaConfig(
        name="llama3-8b", vocab_size=128256, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_dim=14336, max_seq_len=8192,
        rope_theta=500000.0), **kw)


def llama3_70b(**kw) -> LlamaConfig:
    # Public Llama-3-70B architecture constants.
    return replace(LlamaConfig(
        name="llama3-70b", vocab_size=128256, dim=8192, n_layers=80,
        n_heads=64, n_kv_heads=8, ffn_dim=28672, max_seq_len=8192,
        rope_theta=500000.0), **kw)


MODEL_CONFIGS = {
    "llama3-tiny": llama3_tiny,
    "llama3-1b": llama3_1b,
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
}


def get_config(name: str, **kw) -> LlamaConfig:
    try:
        return MODEL_CONFIGS[name](**kw)
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; known: {sorted(MODEL_CONFIGS)}"
        ) from None


# -- parameters ---------------------------------------------------------------

def _init_tree(cfg: LlamaConfig, generator: torch.Generator,
               device: torch.device | str, matmul, embedding) -> Params:
    """The random-init tree, each weight drawn from ``generator`` in a
    fixed order and handed to ``matmul`` (or ``embedding``) before the
    next is drawn."""
    L, D, H, HKV, Fd, V = (cfg.n_layers, cfg.dim, cfg.n_heads,
                           cfg.n_kv_heads, cfg.ffn_dim, cfg.vocab_size)
    hd = cfg.head_dim

    def norm_init(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    params: Params = {
        "embed": embedding(norm_init((V, D), D)),
        "layers": {
            "wq": matmul(norm_init((L, D, H * hd), D)),
            "wk": matmul(norm_init((L, D, HKV * hd), D)),
            "wv": matmul(norm_init((L, D, HKV * hd), D)),
            "wo": matmul(norm_init((L, H * hd, D), H * hd)),
            "w_gate": matmul(norm_init((L, D, Fd), D)),
            "w_up": matmul(norm_init((L, D, Fd), D)),
            "w_down": matmul(norm_init((L, Fd, D), Fd)),
            "attn_norm": ones((L, D)),
            "mlp_norm": ones((L, D)),
        },
        "final_norm": ones((D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = matmul(norm_init((D, V), D))
    return params


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random-init parameter tree (stacked layers: leading dim L), drawn
    from ``generator`` (which must live on ``device``) leaf by leaf, so
    the f32 transient never exceeds one leaf. Normal(0, 1/fan_in)
    weights, unit norm gains — the JAX package's init, not its numbers."""
    def same(w):
        return w
    return _init_tree(cfg, generator, device, same, same)


def init_params_quantized(cfg: LlamaConfig, generator: torch.Generator,
                          device: torch.device | str) -> Params:
    """:func:`init_params` quantized leaf by leaf (``ops/quant.py``
    layout): each weight is drawn and quantized before the next, so no
    full bf16 tree is ever resident (llama3-8b: 16 GB). Equals
    ``quantize_params(init_params(...))`` for the same generator state."""
    return _init_tree(cfg, generator, device,
                      lambda w: quantize_weight(w, axis=-2),
                      quantize_embedding)


def _leaf_to_torch(arr: Any, device) -> torch.Tensor:
    a = np.array(arr)      # a writable host copy (JAX exports read-only)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 arrays are rejected by torch.from_numpy:
        # carry the bits across as uint16 and reinterpret them.
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Any, device: torch.device | str = "cuda") -> Params:
    """The weight bridge: a JAX parameter tree (dicts of arrays; leaves
    anything ``np.asarray`` accepts) → the port's tensors, key for key,
    same shapes and dtypes (int8 and f32 leaves of a quantized tree too),
    no transposes."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _leaf_to_torch(tree, device)


def init_kv_pages(cfg: LlamaConfig, num_pages: int, page_size: int,
                  device: torch.device | str,
                  dtype: Optional[torch.dtype] = None) -> KVCache:
    """Paged KV pool: flat ``(L, P, page_size, H_kv·head_dim)`` per K/V.
    Page 0 is reserved as the null/padding page. ``dtype=torch.int8``
    adds per-(token, KV head) bf16 scale pools ``k_scale`` / ``v_scale``
    shaped ``(L, P, H_kv, page_size)``, the JAX package's layout."""
    shape = (cfg.n_layers, num_pages, page_size,
             cfg.n_kv_heads * cfg.head_dim)
    dt = dtype or cfg.dtype
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if dt == torch.int8:
        sshape = (cfg.n_layers, num_pages, cfg.n_kv_heads, page_size)
        cache["k_scale"] = torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=device)
        cache["v_scale"] = torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=device)
    return cache


def _q8_pools(kv_cache: KVCache):
    """The int8 cache's (k, v, k_scale, v_scale), or None for bf16."""
    if "k_scale" not in kv_cache:
        return None
    return (kv_cache["k"], kv_cache["v"], kv_cache["k_scale"],
            kv_cache["v_scale"])


# -- forward ------------------------------------------------------------------

def _mlp(h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU, the activation in f32; bf16 or int8 weights."""
    g, u = linears(h, w_gate, w_up)
    return linear(F.silu(g.float()).to(h.dtype) * u, w_down)


def _logits(params: Params, h: torch.Tensor) -> torch.Tensor:
    """Final projection → f32 logits (tied head: ``h @ embed.T``), for
    bf16 or int8 heads."""
    head = params.get("lm_head")
    if head is not None:
        return linear(h, head).float()
    embed = params["embed"]
    if is_quantized(embed):
        return tied_head_logits(embed, h)
    return (h @ embed.T).float()


def _qkv(h: torch.Tensor, lp: Params, layer: int, cfg: LlamaConfig,
         cos: torch.Tensor, sin: torch.Tensor):
    """Attention inputs of (B, T) token rows h (B, T, dim): q (B, T, H,
    D) and k (B, T, H_kv, D) with rope applied, v (B, T, H_kv, D)."""
    B, T = h.shape[0], h.shape[1]
    hn = rms_norm(h, lp["attn_norm"][layer], cfg.norm_eps)
    q, k, v = linears(hn, *(layer_slice(lp[n], layer)
                            for n in ("wq", "wk", "wv")))
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attn_out_mlp(h: torch.Tensor, attn: torch.Tensor, lp: Params,
                  layer: int, cfg: LlamaConfig) -> torch.Tensor:
    """Residual after attention (``attn`` flattened to h's shape) and
    after the MLP."""
    h = h + linear(attn.reshape(*h.shape[:-1], -1),
                   layer_slice(lp["wo"], layer))
    hn2 = rms_norm(h, lp["mlp_norm"][layer], cfg.norm_eps)
    return h + _mlp(hn2, layer_slice(lp["w_gate"], layer),
                    layer_slice(lp["w_up"], layer),
                    layer_slice(lp["w_down"], layer))


@dataclass(frozen=True)
class _Chunk:
    """Right-padded prefill rows (B, T), described on the device once
    per forward for every layer: each row's start position, live count
    and first row in the flattened (B·T) K/V buffer (int32, for the
    bf16 kernels' single launch over all rows), its positions and the
    visible history ``seq_lens`` (last valid position + 1, for the int8
    routes). Nothing is read back to the host."""

    starts: torch.Tensor
    lengths: torch.Tensor
    offsets: torch.Tensor
    positions: torch.Tensor
    seq_lens: torch.Tensor


def _chunk(positions: torch.Tensor, lengths: torch.Tensor) -> _Chunk:
    B, T = positions.shape
    dev = positions.device
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    last = torch.where(valid, positions,
                       torch.full_like(positions, -1)).amax(dim=1)
    return _Chunk(positions[:, 0].to(torch.int32).contiguous(),
                  lengths.to(torch.int32).contiguous(),
                  torch.arange(0, B * T, T, device=dev, dtype=torch.int32),
                  positions, last + 1)


def _prefill_layer(h: torch.Tensor, lp: Params, layer: int,
                   cfg: LlamaConfig, cos, sin, kv_cache: KVCache,
                   block_tables: torch.Tensor, chunk: _Chunk) -> torch.Tensor:
    """One layer for right-padded chunk rows h (B, T, dim): write their
    K/V, attend over each row's pages, MLP. Over the bf16 pools the
    write and the attention are one kernel launch each for all rows."""
    q, k, v = _qkv(h, lp, layer, cfg, cos, sin)
    pools = _q8_pools(kv_cache)
    if pools is not None:
        paged_kv_write_prefill_q8(pools, k, v, block_tables, chunk.positions,
                                  chunk.lengths, layer)
        attn = dispatch_prefill_attention_q8(q, pools, block_tables,
                                             chunk.positions, chunk.seq_lens,
                                             layer)
        return _attn_out_mlp(h, attn, lp, layer, cfg)
    k_pool, v_pool = kv_cache["k"], kv_cache["v"]
    paged_kv_write_prefill(k_pool, v_pool, k, v, block_tables, chunk.offsets,
                           chunk.starts, chunk.lengths, layer)
    attn = dispatch_prefill_attention(q, k_pool, v_pool, block_tables,
                                      chunk.starts, chunk.lengths, layer)
    return _attn_out_mlp(h, attn, lp, layer, cfg)


def _decode_rows(positions: torch.Tensor, block_tables: torch.Tensor,
                 page_size: int, active: Optional[torch.Tensor]):
    """Decode rows' write page, slot and seq_len; rows with ``active ==
    False`` write to reserved page 0."""
    B = positions.shape[0]
    rows = torch.arange(B, device=positions.device)
    page_idx = (positions // page_size).clamp(
        max=block_tables.shape[1] - 1).long()
    page_of = block_tables[rows, page_idx]
    if active is not None:
        page_of = torch.where(active, page_of, torch.zeros_like(page_of))
    return (page_of.to(torch.int32), (positions % page_size).to(torch.int32),
            (positions + 1).to(torch.int32))


def _decode_layer(h: torch.Tensor, lp: Params, layer: int, cfg: LlamaConfig,
                  cos, sin, kv_cache: KVCache, block_tables: torch.Tensor,
                  seq_lens, page_of, slot_of, fused: bool) -> torch.Tensor:
    """One decode layer for rows h (B, dim). The int8 cache has only the
    fused route, as in the JAX package."""
    q, k, v = _qkv(h[:, None], lp, layer, cfg, cos, sin)
    pools = _q8_pools(kv_cache)
    if pools is not None:
        if not fused:
            raise ValueError("the int8-KV decode step has no split route")
        attn = paged_decode_step_q8(q[:, 0], k[:, 0], v[:, 0], pools,
                                    block_tables, seq_lens, page_of, layer)
    else:
        attn = paged_decode_step(q[:, 0], k[:, 0], v[:, 0].contiguous(),
                                 kv_cache["k"], kv_cache["v"], block_tables,
                                 seq_lens, page_of, slot_of, layer,
                                 fused=fused)
    return _attn_out_mlp(h, attn, lp, layer, cfg)


def forward_prefill(params: Params, cfg: LlamaConfig,
                    tokens: torch.Tensor, positions: torch.Tensor,
                    lengths: torch.Tensor, kv_cache: KVCache,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Prefill up to T tokens per row, writing their K/V into the pool
    in place. tokens/positions (B, T) right-padded, lengths (B,),
    block_tables (B, max_pages) padded with page 0. Returns logits
    (B, T, V) f32.

    Each row of ``positions`` must be contiguous from ``positions[b, 0]``
    (the attention kernel derives every query position from it); rows
    past ``lengths`` are padding, not written, and their logits are
    meaningless. Continuation chunks (turn 2+) attend to earlier pages
    through the same block tables."""
    h = _prefill_hidden(params, cfg, tokens, positions, lengths, kv_cache,
                        block_tables)
    return _logits(params, rms_norm(h, params["final_norm"], cfg.norm_eps))


def forward_prefill_last(params: Params, cfg: LlamaConfig,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         lengths: torch.Tensor, kv_cache: KVCache,
                         block_tables: torch.Tensor) -> torch.Tensor:
    """:func:`forward_prefill` with the LM head applied to each row's
    last live token only (the hidden state at ``lengths - 1``, taken on
    the device): logits (B, V) f32, the row the sampler reads, as the
    JAX package's prefill programs read it. A batch's (B, T, V) logits
    are never made."""
    h = _prefill_hidden(params, cfg, tokens, positions, lengths, kv_cache,
                        block_tables)
    return _logits(params, _last_rows(params, cfg, h, lengths))


def _last_rows(params: Params, cfg: LlamaConfig, h: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden state (B, D) of each row's token
    ``lengths - 1`` of h (B, T, D)."""
    B, T = h.shape[0], h.shape[1]
    last = (lengths.long() - 1).clamp(0, T - 1)
    h_last = h[torch.arange(B, device=h.device), last]
    return rms_norm(h_last, params["final_norm"], cfg.norm_eps)


def _prefill_hidden(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                    positions: torch.Tensor, lengths: torch.Tensor,
                    kv_cache: KVCache,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """The layers of :func:`forward_prefill`: hidden states (B, T, D)
    before the final norm."""
    lp = params["layers"]
    h = embed_lookup(params["embed"], tokens, cfg.dtype)       # (B, T, D)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    chunk = _chunk(positions, lengths)
    for layer in range(cfg.n_layers):
        h = _prefill_layer(h, lp, layer, cfg, cos, sin, kv_cache,
                           block_tables, chunk)
    return h


def forward_decode(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, kv_cache: KVCache,
                   block_tables: torch.Tensor,
                   active: Optional[torch.Tensor] = None, *,
                   fused: bool = True) -> torch.Tensor:
    """One decode step for every row: tokens/positions (B,), the token's
    K/V written at its position in place. Rows with ``active == False``
    write to reserved page 0 instead; their logits are discarded by the
    caller. ``fused`` picks the decode route (ops/attention.py
    ``paged_decode_step``). Returns logits (B, V) f32."""
    lp = params["layers"]
    h = embed_lookup(params["embed"], tokens, cfg.dtype)       # (B, D)
    cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
    page_of, slot_of, seq_lens = _decode_rows(
        positions, block_tables, kv_cache["k"].shape[2], active)
    for layer in range(cfg.n_layers):
        h = _decode_layer(h, lp, layer, cfg, cos, sin, kv_cache,
                          block_tables, seq_lens, page_of, slot_of, fused)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h)


def forward_mixed(params: Params, cfg: LlamaConfig,
                  dec_tokens: torch.Tensor, dec_positions: torch.Tensor,
                  kv_cache: KVCache, dec_block_tables: torch.Tensor,
                  pf_tokens: torch.Tensor, pf_positions: torch.Tensor,
                  pf_lengths: torch.Tensor, pf_block_tables: torch.Tensor,
                  dec_active: Optional[torch.Tensor] = None, *,
                  fused: bool = True, last_only: bool = False):
    """Mixed step (token-budget mixed batching): advance B decode rows
    one token AND write S prefill slices (up to T tokens each, (S, T)
    right-padded, contiguous positions per row) into the shared pool,
    in one pass over the layers. Per layer the slice rows go first
    (:func:`forward_prefill`'s ops), then the decode rows
    (:func:`forward_decode`'s; ``dec_active`` sends inactive rows'
    writes to page 0), each with its own matmuls. A sequence is either
    decoding or mid-prefill, so their pages are disjoint. Returns
    ``(dec_logits (B, V), pf_logits (S, T, V))`` f32; with ``last_only``
    the slice logits are each slice's last live token's, (S, V)."""
    lp = params["layers"]
    h_d = embed_lookup(params["embed"], dec_tokens, cfg.dtype)  # (B, D)
    cos_d, sin_d = rope_cos_sin(dec_positions[:, None], cfg.head_dim,
                                cfg.rope_theta)
    page_of, slot_of, seq_lens = _decode_rows(
        dec_positions, dec_block_tables, kv_cache["k"].shape[2], dec_active)
    h_p = embed_lookup(params["embed"], pf_tokens, cfg.dtype)  # (S, T, D)
    cos_p, sin_p = rope_cos_sin(pf_positions, cfg.head_dim, cfg.rope_theta)
    chunk = _chunk(pf_positions, pf_lengths)
    for layer in range(cfg.n_layers):
        h_p = _prefill_layer(h_p, lp, layer, cfg, cos_p, sin_p, kv_cache,
                             pf_block_tables, chunk)
        h_d = _decode_layer(h_d, lp, layer, cfg, cos_d, sin_d, kv_cache,
                            dec_block_tables, seq_lens, page_of, slot_of,
                            fused)
    h_d = rms_norm(h_d, params["final_norm"], cfg.norm_eps)
    if last_only:
        h_p = _last_rows(params, cfg, h_p, pf_lengths)
    else:
        h_p = rms_norm(h_p, params["final_norm"], cfg.norm_eps)
    return _logits(params, h_d), _logits(params, h_p)


def forward_mixed_ragged(params: Params, cfg: LlamaConfig,
                         dec_tokens: torch.Tensor,
                         dec_positions: torch.Tensor, kv_cache: KVCache,
                         dec_block_tables: torch.Tensor,
                         pf_tokens: torch.Tensor, pf_positions: torch.Tensor,
                         pf_qoff: torch.Tensor, pf_qlen: torch.Tensor,
                         pf_block_tables: torch.Tensor,
                         dec_active: Optional[torch.Tensor] = None):
    """:func:`forward_mixed` with the slices PACKED: pf_tokens /
    pf_positions (N,) hold slice s at rows ``[pf_qoff[s], pf_qoff[s] +
    pf_qlen[s])`` (offsets multiples of ``RAGGED_Q_BLOCK``; rows between
    segments are padding; a slice with qlen 0 is unused), positions
    contiguous per segment. The dense math runs over the N packed rows
    as one sequence; per layer the attention of the decode rows and of
    every packed token is one :func:`ragged_mixed_step`. The descriptors
    are built on the device once per forward for all layers (with an
    int8 cache, also every packed row's page and slot,
    :func:`ragged_slice_rows`); nothing is read back to the host.
    Returns ``(dec_logits (B, V), pf_last_logits (S, V))``, the slice
    logits at each slice's last live token."""
    lp = params["layers"]
    N = pf_tokens.shape[0]
    pools = _q8_pools(kv_cache)
    h_d = embed_lookup(params["embed"], dec_tokens, cfg.dtype)  # (B, D)
    cos_d, sin_d = rope_cos_sin(dec_positions[:, None], cfg.head_dim,
                                cfg.rope_theta)
    page_of, _slot_of, seq_lens = _decode_rows(
        dec_positions, dec_block_tables, kv_cache["k"].shape[2], dec_active)
    first = pf_qoff.long().clamp(0, N - 1)
    slices = ragged_slices(dec_block_tables, seq_lens, pf_block_tables,
                           pf_qoff, pf_qlen, pf_positions[first])
    if pools is not None:
        rows = ragged_slice_rows(slices, N, kv_cache["k"].shape[2])
    h_p = embed_lookup(params["embed"], pf_tokens, cfg.dtype)[None]  # (1,N,D)
    cos_p, sin_p = rope_cos_sin(pf_positions[None], cfg.head_dim,
                                cfg.rope_theta)
    for layer in range(cfg.n_layers):
        q_p, k_p, v_p = _qkv(h_p, lp, layer, cfg, cos_p, sin_p)
        q_d, k_d, v_d = _qkv(h_d[:, None], lp, layer, cfg, cos_d, sin_d)
        if pools is not None:
            attn_d, attn_p = ragged_mixed_step_q8(
                q_d[:, 0], k_d[:, 0], v_d[:, 0], q_p[0], k_p[0], v_p[0],
                pools, page_of, slices, rows, layer)
        else:
            attn_d, attn_p = ragged_mixed_step(
                q_d[:, 0], k_d[:, 0], v_d[:, 0].contiguous(), q_p[0],
                k_p[0], v_p[0], kv_cache["k"], kv_cache["v"], page_of,
                slices, layer)
        h_p = _attn_out_mlp(h_p, attn_p, lp, layer, cfg)
        h_d = _attn_out_mlp(h_d, attn_d, lp, layer, cfg)
    last = (pf_qoff.long() + pf_qlen.long().clamp(min=1) - 1).clamp(0, N - 1)
    h_d = rms_norm(h_d, params["final_norm"], cfg.norm_eps)
    h_last = rms_norm(h_p[0, last], params["final_norm"], cfg.norm_eps)
    return _logits(params, h_d), _logits(params, h_last)


#: Joins a leaf's path in the parameter tree into one parameter name
#: (a name may not hold "."): ``layers__wq__q``.
_SEP = "__"


def _flatten(tree: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + _SEP))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat) -> Params:
    tree: Params = {}
    for name, v in flat.items():
        *path, leaf = name.split(_SEP)
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


class Llama(nn.Module):
    """The model as a module: holds every leaf of the parameter tree (JAX
    layout; int8 weights and their scales as leaves of their own) as a
    non-trainable parameter named by its path, and exposes the
    forwards."""

    def __init__(self, cfg: LlamaConfig, params: Params) -> None:
        super().__init__()
        self.cfg = cfg
        self.weights = nn.ParameterDict({
            name: nn.Parameter(t, requires_grad=False)
            for name, t in _flatten(params).items()})

    @property
    def params(self) -> Params:
        """The parameter tree in the JAX layout."""
        return _unflatten(dict(self.weights.items()))

    def forward_prefill(self, tokens, positions, lengths, kv_cache,
                        block_tables) -> torch.Tensor:
        return forward_prefill(self.params, self.cfg, tokens, positions,
                               lengths, kv_cache, block_tables)

    def forward_prefill_last(self, tokens, positions, lengths, kv_cache,
                             block_tables) -> torch.Tensor:
        return forward_prefill_last(self.params, self.cfg, tokens, positions,
                                    lengths, kv_cache, block_tables)

    def forward_decode(self, tokens, positions, kv_cache, block_tables,
                       active=None, *, fused: bool = True) -> torch.Tensor:
        return forward_decode(self.params, self.cfg, tokens, positions,
                              kv_cache, block_tables, active, fused=fused)

    def forward_mixed(self, dec_tokens, dec_positions, kv_cache,
                      dec_block_tables, pf_tokens, pf_positions, pf_lengths,
                      pf_block_tables, dec_active=None, *,
                      fused: bool = True, last_only: bool = False):
        return forward_mixed(self.params, self.cfg, dec_tokens,
                             dec_positions, kv_cache, dec_block_tables,
                             pf_tokens, pf_positions, pf_lengths,
                             pf_block_tables, dec_active, fused=fused,
                             last_only=last_only)

    def forward_mixed_ragged(self, dec_tokens, dec_positions, kv_cache,
                             dec_block_tables, pf_tokens, pf_positions,
                             pf_qoff, pf_qlen, pf_block_tables,
                             dec_active=None):
        return forward_mixed_ragged(self.params, self.cfg, dec_tokens,
                                    dec_positions, kv_cache,
                                    dec_block_tables, pf_tokens,
                                    pf_positions, pf_qoff, pf_qlen,
                                    pf_block_tables, dec_active)

    def forward(self, tokens, positions, kv_cache, block_tables,
                active=None) -> torch.Tensor:
        return self.forward_decode(tokens, positions, kv_cache,
                                   block_tables, active)

