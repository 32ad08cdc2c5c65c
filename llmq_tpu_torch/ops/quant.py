"""w8a8 weight quantization and the int8 KV cache's row quantization
(counterpart of ``llmq_tpu/ops/quant.py``, function for function).

- Matmul weights ``W (..., D_in, D_out)`` become ``{"q": int8, "s": f32
  (..., 1, D_out)}``: symmetric per-output-channel scales, the
  contraction axis kept as 1. The embedding table is scaled per row, so
  the tied head sees per-output-channel scales.
- Activations are quantized per row at run time and the product runs
  int8 x int8 -> int32 (``torch._int_mm``, a cuBLAS int8 GEMM on the
  card; the JAX package's ``qdot`` is an XLA dot, not a Pallas kernel).
  A matmul weight's int8 leaf keeps the JAX shape but is stored column
  major (its last two axes' strides swapped), made once when it is
  quantized: cuBLAS's int8 GEMM runs several times faster with that
  layout than row major at decode's row counts (chip_smoke.py times
  both; PERF.md).
- KV rows are quantized per (token, KV head) with bf16 scales, kept in
  scale pools shaped ``(L, P, H_kv, page_size)``.

The order of operations is the JAX package's: weights and activations
take ``max(amax, 1e-8) / 127``, KV rows ``max(amax / 127, 1e-8)``; the
output of a product is ``(y * sx) * sw``; ``torch.round`` rounds half to
even as ``jnp.round`` does. That is what keeps the CPU streams equal.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

Params = Dict[str, Any]

#: Quantized-weight leaf: {"q": int8 weights, "s": f32 scales}.
QuantW = Dict[str, torch.Tensor]

_QKEYS = frozenset({"q", "s"})

#: cuBLAS's int8 GEMM behind ``torch._int_mm`` refuses a left operand of
#: 16 rows or fewer; shorter inputs are zero-padded to this many rows.
_INT_MM_MIN_ROWS = 32


def is_quantized(w: Any) -> bool:
    """True if ``w`` is a quantized-weight leaf produced by this module."""
    return isinstance(w, dict) and _QKEYS.issubset(w.keys())


def _to_int8(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(xf / scale), -127, 127)`` as int8, in place on the
    quotient (one f32 transient)."""
    x = xf / scale
    x.round_().clamp_(-127, 127)
    return x.to(torch.int8)


def _column_major(q: torch.Tensor) -> torch.Tensor:
    """The same values and shape, the last two axes stored transposed."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_weight(w: torch.Tensor, axis: int = -2) -> QuantW:
    """Quantize one weight to int8 with symmetric per-channel scales.
    ``axis`` is the contraction axis; for a stacked-layer weight (L,
    D_in, D_out) with axis=-2 the scale is (L, 1, D_out), and the int8
    leaf is stored column major for the GEMM."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = _to_int8(wf, scale)
    del wf
    if axis in (-2, w.dim() - 2):
        q = _column_major(q)
    return {"q": q, "s": scale}


def dequantize_weight(w: QuantW, dtype=torch.bfloat16) -> torch.Tensor:
    return (w["q"].float() * w["s"]).to(dtype)


def quantize_act(x: torch.Tensor, reduce_max=None):
    """Dynamic symmetric per-row activation quantization: (x_q int8,
    scale f32 with trailing dim 1), f32 math. ``reduce_max`` (in place)
    makes each row's amax the max over the ranks that hold the row's
    other slices (a tensor-parallel contraction)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if reduce_max is not None:
        reduce_max(amax)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    return _to_int8(xf, scale), scale


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 (M, N). On the card an input
    of at most 16 rows is zero-padded to 32 and the result sliced."""
    m = a.shape[0]
    if a.is_cuda and m < _INT_MM_MIN_ROWS:
        pad = torch.zeros((_INT_MM_MIN_ROWS - m, a.shape[1]), dtype=a.dtype,
                          device=a.device)
        return torch._int_mm(torch.cat([a, pad]), b)[:m]
    return torch._int_mm(a, b)


def qdot(x: torch.Tensor, w: QuantW, xq=None,
         reduce_sum=None) -> torch.Tensor:
    """``x @ W`` with int8 weights and dynamically quantized activations:
    int8 x int8 -> int32, then the per-row and per-channel scales in f32;
    the output returns in ``x.dtype``. Layers are sliced away first.
    ``xq`` is ``quantize_act(x)`` when the caller has it already.
    ``reduce_sum`` (in place) sums the int32 products over the ranks that
    hold the contraction's other slices, before the scales apply, so a
    split product equals the whole one."""
    xq, sx = quantize_act(x) if xq is None else xq
    wq, sw = w["q"], w["s"]
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    if reduce_sum is not None:
        reduce_sum(y)
    y = y.reshape(*x.shape[:-1], wq.shape[-1])
    # int32 * f32 promotes to f32 in one kernel; (y * sx) * sw as in JAX.
    return (y * sx * sw.reshape(sw.shape[-1])).to(x.dtype)


def linear(x: torch.Tensor, w: Union[torch.Tensor, QuantW]) -> torch.Tensor:
    """Quantization-dispatching matmul: ``x @ w`` or int8 :func:`qdot`."""
    if is_quantized(w):
        return qdot(x, w)
    return x @ w


def linears(x: torch.Tensor, *ws: Union[torch.Tensor, QuantW]) -> tuple:
    """:func:`linear` of one input with each of ``ws``; quantized weights
    share one activation quantization, the values a separate
    ``quantize_act`` per weight would give."""
    xq = quantize_act(x) if any(is_quantized(w) for w in ws) else None
    return tuple(qdot(x, w, xq) if is_quantized(w) else x @ w for w in ws)


def layer_slice(w: Union[torch.Tensor, QuantW], layer: int
                ) -> Union[torch.Tensor, QuantW]:
    """``w[layer]`` of a stacked weight, elementwise for a quantized leaf."""
    if is_quantized(w):
        return {"q": w["q"][layer], "s": w["s"][layer]}
    return w[layer]


# -- embedding ----------------------------------------------------------------

def quantize_embedding(embed: torch.Tensor) -> QuantW:
    """Per-row (per token id) scales: the tied head (``embed.T``) then has
    per-output-channel scales."""
    return quantize_weight(embed, axis=-1)


def embed_lookup(embed: Union[torch.Tensor, QuantW], tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Row gather for bf16 or quantized embedding tables."""
    idx = tokens.long()
    if is_quantized(embed):
        return (embed["q"][idx].float() * embed["s"][idx]).to(dtype)
    return embed[idx].to(dtype)


def tied_head_logits(embed: QuantW, h: torch.Tensor) -> torch.Tensor:
    """``h @ embed.T`` for a per-row-quantized embedding; f32 logits.
    ``embed.T`` of the row-major table is already column major."""
    xq, sx = quantize_act(h)
    eq = embed["q"]
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), eq.t())
    y = y.reshape(*h.shape[:-1], eq.shape[0])
    return y * sx * embed["s"].reshape(embed["s"].shape[0])


# -- parameter tree ------------------------------------------------------------

#: Stacked-layer matmul weights of models/llama.py's parameter tree.
LAYER_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_params(params: Params) -> Params:
    """Quantize a models/llama.py parameter tree to w8 int8: matmul
    weights (projections, lm_head, embedding) become ``{"q", "s"}``
    leaves, norm gains stay as they are. Idempotent."""
    out: Params = {}
    out["embed"] = (params["embed"] if is_quantized(params["embed"])
                    else quantize_embedding(params["embed"]))
    out["layers"] = {
        name: (quantize_weight(w, axis=-2)
               if name in LAYER_MATMULS and not is_quantized(w) else w)
        for name, w in params["layers"].items()}
    out["final_norm"] = params["final_norm"]
    if "lm_head" in params:
        head = params["lm_head"]
        out["lm_head"] = (head if is_quantized(head)
                          else quantize_weight(head, axis=-2))
    return out


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_bytes(params: Params) -> int:
    """Device byte footprint of a (possibly quantized) parameter tree."""
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def param_count(params: Params) -> int:
    """Elements of every leaf of a (possibly quantized) parameter tree,
    scales included (the JAX package's ``param_count``)."""
    return sum(t.numel() for t in _leaves(params))


# -- int8 KV cache ------------------------------------------------------------

def quantize_kv_rows(x: torch.Tensor):
    """KV rows (..., H_kv, D) → (int8 (..., H_kv, D), bf16 scales
    (..., H_kv)): symmetric max-abs per (row, head)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    return _to_int8(xf, scale[..., None]), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows`: q (..., H_kv, D) int8 times
    scales (..., H_kv) → (..., H_kv, D) ``dtype``."""
    return (q.float() * scale.float()[..., None]).to(dtype)
