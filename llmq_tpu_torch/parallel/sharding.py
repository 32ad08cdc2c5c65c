"""The partition-rule table of the Llama tree and each rank's shard of it
(counterpart of ``llmq_tpu/parallel/sharding.py``).

The same regex table as JAX's, first match wins, mapping each leaf to a
placement: one mesh axis name (or None) per dimension.

- ``wq``/``wk``/``wv`` shard their head (output) dim, ``wo`` its head
  (input) dim: a rank computes its heads' attention, and the residual
  after ``wo`` needs one all-reduce;
- ``w_gate``/``w_up`` shard ``ffn_dim`` on the output, ``w_down`` on the
  input: one all-reduce after ``w_down``;
- ``embed`` shards vocab rows, ``lm_head`` vocab columns: the lookup is
  an all-reduce of masked rows, the logits an all-gather;
- the paged pool shards its flat KV-head·dim axis (H_kv-major, so
  contiguous chunks are whole KV heads); with a ``dp`` axis the page
  axis splits too (``kv_cache_shardings(num_pages=)``).

JAX's divisibility clamp replicates any axis the mesh cannot divide,
then GSPMD reshards around whatever that leaves. A rank here holds an
explicit shard and runs its own kernels on it, so the port adds one rule:
the attention block (``wq``, ``wk``, ``wv``, ``wo`` and the pool) is
sharded only where ``tp`` divides both ``n_heads`` and ``n_kv_heads``
(whole heads), and replicated otherwise. Where JAX's split is whole
heads the two tables agree leaf for leaf.

Quantized ``{"q", "s"}`` leaves match through their parent's name: a
scale keeps the weight's placement, and its size-1 contraction axis is
clamped to replication.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from llmq_tpu_torch.models.llama import LlamaConfig, Params, TensorParallel
from llmq_tpu_torch.parallel.mesh import Mesh


class P(tuple):
    """A placement: the mesh axis (or None) each dimension is split over
    (JAX's ``PartitionSpec``, as a plain tuple)."""

    def __new__(cls, *axes: Optional[str]) -> "P":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


#: (regex over the '/'-joined leaf path, placement); JAX's table.
LLAMA_PARTITION_RULES: List[Tuple[str, P]] = [
    (r"(^|/)embed(/|$)", P("tp", None)),          # vocab rows
    (r"(^|/)lm_head(/|$)", P(None, "tp")),        # vocab cols
    (r"(^|/)(wq|wk|wv)(/|$)", P(None, None, "tp")),   # head (out) dim
    (r"(^|/)wo(/|$)", P(None, "tp", None)),           # head (in) dim
    (r"(^|/)(w_gate|w_up)(/|$)", P(None, None, "tp")),  # ffn out
    (r"(^|/)w_down(/|$)", P(None, "tp", None)),         # ffn in
    (r"norm", P()),                                # tiny, replicate
    (r".", P()),                                   # default: replicate
]

#: The attention block's leaves: sharded in whole heads or not at all.
ATTENTION_LEAVES = ("wq", "wk", "wv", "wo")


def _leaves(tree: Any, prefix: str = ""):
    """('/'-joined path, leaf) of every leaf of a dict tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _map(tree: Any, fn, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def match_partition_rules(rules: Sequence[Tuple[str, P]], tree: Any) -> Any:
    """The placement tree of ``tree`` (any dict tree of leaves with a
    ``shape``): each leaf gets the placement of the first rule whose
    regex searches its path; scalar and one-element leaves replicate.
    Raises if no rule matches."""

    def spec_for(name: str, leaf: Any) -> P:
        shape = _shape(leaf)
        n = 1
        for d in shape:
            n *= d
        if len(shape) == 0 or n == 1:
            return P()
        for pat, spec in rules:
            if re.search(pat, name) is not None:
                return spec
        raise ValueError(f"no partition rule matches param {name!r}")

    return _map(tree, spec_for)


def resolve_rules(rules: Sequence[Tuple[str, P]], tree: Any,
                  mesh: Mesh) -> Any:
    """Rule table → placement tree, clamped to what ``mesh`` can split: a
    named axis stays only where the mesh has it and it divides the
    leaf's dimension (JAX's clamp); every placement has one entry per
    dimension."""
    specs = match_partition_rules(rules, tree)
    flat = dict(_leaves(specs))

    def clamp(name: str, leaf: Any) -> P:
        shape = _shape(leaf)
        spec = tuple(flat[name]) + (None,) * (len(shape) - len(flat[name]))
        ax = []
        for i, axis in enumerate(spec[:len(shape)]):
            if (axis is not None and axis in mesh.shape
                    and shape[i] % mesh.shape[axis] == 0):
                ax.append(axis)
            else:
                ax.append(None)
        return P(*ax)

    return _map(tree, clamp)


def _axis(mesh: Mesh, name: str, dim_size: int) -> Optional[str]:
    """``name`` iff the mesh has it and it divides ``dim_size``."""
    if name in mesh.shape and dim_size % mesh.shape[name] == 0:
        return name
    return None


def whole_heads(cfg: LlamaConfig, mesh: Mesh) -> bool:
    """Whether ``tp`` splits the attention into whole heads: it divides
    both the query and the KV head counts."""
    return (_axis(mesh, "tp", cfg.n_heads) is not None
            and _axis(mesh, "tp", cfg.n_kv_heads) is not None)


def param_shardings(cfg: LlamaConfig, mesh: Mesh, quantized: bool = False,
                    params: Optional[Params] = None) -> Params:
    """The placement tree congruent with ``init_params``' layout (or
    ``params``' own, a real or a meta tree), from
    :data:`LLAMA_PARTITION_RULES` with the whole-head rule: the
    attention leaves replicate where ``tp`` does not split whole heads.
    ``quantized``: the tree of ``ops/quant.quantize_params``, each matmul
    leaf ``{"q", "s"}``."""
    if params is None:
        params = abstract_params(cfg, quantized)
    placed = resolve_rules(LLAMA_PARTITION_RULES, params, mesh)
    if not whole_heads(cfg, mesh):
        layers = placed["layers"]
        for name in ATTENTION_LEAVES:
            layers[name] = _map(layers[name],
                                lambda _n, spec: P(*([None] * len(spec))))
    return placed


def abstract_params(cfg: LlamaConfig, quantized: bool = False) -> Params:
    """The parameter tree as meta tensors: every leaf's shape and dtype,
    no storage (JAX's ``jax.eval_shape`` of the initializer)."""
    from llmq_tpu_torch.models.llama import init_params, init_params_quantized

    init = init_params_quantized if quantized else init_params
    return init(cfg, None, "meta")


def kv_cache_shardings(cfg: LlamaConfig, mesh: Mesh, quantized: bool = False,
                       num_pages: int = 0) -> Dict[str, P]:
    """Placements of the pool ``(L, P, page_size, H_kv·D)``: the flat
    KV-head·dim axis over ``tp`` where ``tp`` splits whole heads, and with
    ``num_pages`` > 0 the page axis over ``dp`` where ``dp`` divides it
    (each dp replica's page universe). ``quantized`` adds the scale pools
    ``(L, P, H_kv, page_size)``, KV-head axis at dim 2."""
    tp_kv = "tp" if whole_heads(cfg, mesh) else None
    dp = _axis(mesh, "dp", num_pages) if num_pages > 0 else None
    ns = P(None, dp, None, tp_kv)
    out = {"k": ns, "v": ns}
    if quantized:
        s_ns = P(None, dp, tp_kv, None)
        out["k_scale"] = s_ns
        out["v_scale"] = s_ns
    return out


def replicated(mesh: Mesh) -> P:
    """The placement of a leaf every rank holds whole."""
    return P()


def batch_sharding(mesh: Mesh, ndim: int = 2) -> P:
    """Tokens, positions and the like: the batch dim over ``dp``."""
    return P("dp" if "dp" in mesh.shape else None, *([None] * (ndim - 1)))


def _slice(t: torch.Tensor, spec: Sequence[Optional[str]],
           mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a contiguous copy when
    anything is split, else ``t`` itself)."""
    out = t
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if n == 1:
            continue
        size = t.shape[dim] // n
        out = out.narrow(dim, mesh.coords[axis] * size, size)
    return out if out is t else out.contiguous()


def shard_params(params: Params, shardings: Params,
                 mesh: Mesh) -> Params:
    """This rank's local tree: each leaf's block under its placement
    (JAX's ``device_put`` onto the mesh, seen from one rank). A quantized
    matmul leaf keeps its column-major int8 layout."""
    from llmq_tpu_torch.ops.quant import _column_major

    flat = dict(_leaves(shardings))

    def one(name: str, leaf: torch.Tensor) -> torch.Tensor:
        out = _slice(leaf, flat[name], mesh)
        if (out is not leaf and name.endswith("/q") and leaf.dim() >= 2
                and leaf.stride(-2) == 1 and leaf.shape[-2] > 1):
            out = _column_major(out)
        return out

    return _map(params, one)


def describe(params: Params, shardings: Optional[Params] = None
             ) -> Dict[str, str]:
    """Leaf path → ``"shape placement"`` (a debug helper)."""
    flat = dict(_leaves(shardings)) if shardings is not None else {}
    return {name: f"{tuple(_shape(leaf))} {flat.get(name, P())!r}"
            for name, leaf in _leaves(params)}


def tensor_parallel(mesh: Optional[Mesh],
                    shardings: Params) -> Optional[TensorParallel]:
    """The model's :class:`~llmq_tpu_torch.models.llama.TensorParallel`
    for this rank of ``mesh`` under ``shardings`` (which parts of the tree
    its ``tp`` axis splits); None without a ``tp`` process group, and at
    ``tp`` 1 off NCCL (its collectives are the identity, and a gloo world
    launches none)."""
    if mesh is None or mesh.group is None or "tp" not in mesh.shape:
        return None
    if mesh.tp == 1 and mesh.backend != "nccl":
        return None

    def split(tree) -> bool:
        return any("tp" in spec for _n, spec in _leaves(tree))

    lay = shardings["layers"]
    return TensorParallel(
        mesh.group, mesh.tp, mesh.tp_rank,
        attention=split({k: lay[k] for k in ATTENTION_LEAVES}),
        mlp=split({k: lay[k] for k in ("w_gate", "w_up", "w_down")}),
        vocab=split(shardings["embed"]))
