"""Model weights from disk: Hugging Face Llama safetensors import and the
port's own checkpoints (the port's counterpart of
``llmq_tpu/models/checkpoint.py``).

The port reads and writes safetensors itself: an 8-byte little-endian
header length, the JSON header (name → dtype, shape, byte offsets), then
the raw little-endian bytes. It needs neither the ``safetensors`` nor
the ``ml_dtypes`` package: a BF16 tensor is read as uint16 words and
viewed as ``torch.bfloat16``. F32, F16, BF16 and I8 are read; any other
dtype is refused by name.

- :func:`import_hf_llama`: a Hugging Face Llama checkpoint directory
  (every ``*.safetensors`` file in it, in sorted order) into the JAX
  layout: ``(out, in)`` matrices transposed and stacked per layer,
  ``lm_head`` only when the checkpoint has one (tied heads), the q/k
  rotary permutation only for Meta-original re-exports. Leaves are built
  and moved to the device one at a time, each layer read from disk on
  its own, so host memory peaks near one layer's matrix.
- :func:`save_checkpoint` / :func:`load_checkpoint`: the port's own
  checkpoint, one safetensors file of the flattened parameter tree (a
  quantized tree's int8 and scale leaves too, the int8 leaves' column
  major layout restored at load). The JAX package writes orbax
  checkpoints, which need JAX: a directory given to
  :func:`load_checkpoint` is refused, with the remedy.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from llmq_tpu_torch.models.llama import LlamaConfig, Params

log = logging.getLogger("llmq_tpu_torch.checkpoint")

#: safetensors dtype → (numpy dtype of the stored words, torch dtype).
_DTYPES: Dict[str, Tuple[Any, torch.dtype]] = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I8": (np.int8, torch.int8),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}
#: The dtypes a Hugging Face weight may have here.
_HF_DTYPES = ("F32", "F16", "BF16")
#: Separator of the flattened tree's names (a tree key holds none).
_SEP = "."
#: ``__metadata__`` of the port's checkpoint.
FORMAT = "llmq_tpu_torch"


# -- safetensors --------------------------------------------------------------

class SafetensorsFile:
    """The header of one safetensors file; tensors are read on demand."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            raw = f.read(8)
            if len(raw) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", raw)
            header = json.loads(f.read(n))
        self.data_start = 8 + n
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self.entries: Dict[str, Dict[str, Any]] = header

    def keys(self) -> List[str]:
        return list(self.entries)

    def read(self, name: str, allowed: Iterable[str] = tuple(_DTYPES)
             ) -> torch.Tensor:
        """One tensor on the host, in its stored dtype."""
        e = self.entries[name]
        dt = e["dtype"]
        if dt not in allowed:
            raise ValueError(
                f"{self.path}: tensor {name!r} has dtype {dt}, which is not "
                f"read here (supported: {', '.join(allowed)})")
        words, tdt = _DTYPES[dt]
        begin, end = e["data_offsets"]
        shape = tuple(e["shape"])
        count = (end - begin) // np.dtype(words).itemsize
        if count != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{self.path}: tensor {name!r} holds "
                             f"{end - begin} bytes for shape {shape}")
        with open(self.path, "rb") as f:
            f.seek(self.data_start + begin)
            a = np.fromfile(f, dtype=words, count=count)
        if a.size != count:
            raise ValueError(f"{self.path}: tensor {name!r} is truncated")
        t = torch.from_numpy(a.reshape(shape))
        return t.view(torch.bfloat16) if tdt == torch.bfloat16 else t


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any device; each copied to the host on its own,
    in the order given) as one safetensors file. Returns the bytes of
    tensor data written."""
    header: Dict[str, Any] = {}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not "
                             f"written here")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            h = t.detach().contiguous().cpu()
            if h.dtype == torch.bfloat16:
                h = h.view(torch.int16)
            if h.numel():
                f.write(memoryview(h.numpy().reshape(-1)).cast("B"))
    os.replace(tmp, path)
    return offset


# -- Hugging Face import ------------------------------------------------------

def _permute_meta_rope(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Meta-original (interleaved rotary pairs) → split-half layout of a
    q/k projection, ``w`` in (out, in) orientation: the permutation HF's
    conversion script applies. HF safetensors checkpoints are split-half
    already and must be loaded verbatim."""
    head_dim = w.shape[0] // n_heads
    dim_in = w.shape[1]
    w = w.reshape(n_heads, head_dim // 2, 2, dim_in)
    return w.transpose(1, 2).reshape(n_heads * head_dim, dim_in)


def import_hf_llama(model_dir: str, cfg: LlamaConfig,
                    meta_rope_layout: bool = False,
                    device: torch.device | str = "cuda") -> Params:
    """A local Hugging Face Llama checkpoint directory (safetensors) as
    the port's stacked-layer parameter tree in ``cfg.dtype`` on
    ``device``. q/k projections are loaded verbatim (split-half rotary,
    as ``ops/rope.py`` applies it) unless ``meta_rope_layout``."""
    files = sorted(f for f in os.listdir(model_dir)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    where: Dict[str, SafetensorsFile] = {}
    for fname in files:
        st = SafetensorsFile(os.path.join(model_dir, fname))
        for key in st.keys():
            where[key] = st
    dev = torch.device(device)
    dt = cfg.dtype

    def get(name: str) -> torch.Tensor:
        try:
            st = where[name]
        except KeyError:
            raise KeyError(f"{model_dir}: no tensor {name!r}") from None
        return st.read(name, _HF_DTYPES)

    def leaf(name: str) -> torch.Tensor:
        return get(name).to(dev).to(dt)

    def stack(fmt: str, n_heads: int = 0) -> torch.Tensor:
        out = None
        for i in range(cfg.n_layers):
            w = get(fmt.format(i=i))
            if n_heads:
                w = _permute_meta_rope(w, n_heads)
            w = w.to(dev).T.to(dt)  # HF stores (out, in); we use (in, out)
            if out is None:
                out = torch.empty((cfg.n_layers, *w.shape), dtype=dt,
                                  device=dev)
            out[i].copy_(w)
            del w
        return out

    def norms(fmt: str) -> torch.Tensor:
        return torch.stack([leaf(fmt.format(i=i))
                            for i in range(cfg.n_layers)])

    q_heads = cfg.n_heads if meta_rope_layout else 0
    k_heads = cfg.n_kv_heads if meta_rope_layout else 0
    pre = "model.layers.{i}."
    params: Params = {
        "embed": leaf("model.embed_tokens.weight"),
        "layers": {
            "wq": stack(pre + "self_attn.q_proj.weight", q_heads),
            "wk": stack(pre + "self_attn.k_proj.weight", k_heads),
            "wv": stack(pre + "self_attn.v_proj.weight"),
            "wo": stack(pre + "self_attn.o_proj.weight"),
            "w_gate": stack(pre + "mlp.gate_proj.weight"),
            "w_up": stack(pre + "mlp.up_proj.weight"),
            "w_down": stack(pre + "mlp.down_proj.weight"),
            "attn_norm": norms(pre + "input_layernorm.weight"),
            "mlp_norm": norms(pre + "post_attention_layernorm.weight"),
        },
        "final_norm": leaf("model.norm.weight"),
    }
    if "lm_head.weight" in where:
        params["lm_head"] = get("lm_head.weight").to(dev).T.contiguous().to(dt)
    log.info("imported HF llama from %s (%d tensors in %d files)", model_dir,
             len(where), len(files))
    return params


# -- the port's own checkpoints ----------------------------------------------

def _flatten(tree: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + _SEP))
        else:
            out[prefix + k] = v
    return out


def _column_major(t: torch.Tensor) -> bool:
    """Stored with its last two axes transposed (an int8 matmul leaf)."""
    return (t.dim() >= 2 and not t.is_contiguous()
            and t.transpose(-1, -2).is_contiguous())


def save_checkpoint(path: str, params: Params) -> None:
    """Write ``params`` (bf16, f32 or a quantized tree) to the file
    ``path`` in the port's format, leaf by leaf."""
    flat = _flatten(params)
    col = [n for n, t in flat.items() if _column_major(t)]
    meta = {"format": FORMAT, "column_major": ",".join(col)}
    path = os.path.abspath(path)
    nbytes = write_safetensors(path, flat, meta)
    log.info("checkpoint saved to %s (%d leaves, %.2f GB)", path, len(flat),
             nbytes / 1e9)


def _refuse_directory(path: str) -> None:
    names = set(os.listdir(path))
    orbax = {"_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
             "_sharding", "checkpoint"} & names
    kind = (f"an orbax checkpoint (it holds {sorted(orbax)})" if orbax
            else "a directory")
    raise ValueError(
        f"{path} is {kind}, not a checkpoint of this package: orbax "
        f"checkpoints need JAX. Convert it on a host with JAX: load it with "
        f"llmq_tpu.models.checkpoint.load_checkpoint and write it with "
        f"llmq_tpu_torch.models.checkpoint.save_checkpoint(path, "
        f"params_from_jax(tree, 'cpu')); or give a Hugging Face "
        f"safetensors directory named '*.safetensors.d'")


def load_checkpoint(path: str, device: torch.device | str = "cuda"
                    ) -> Params:
    """The parameter tree :func:`save_checkpoint` wrote, leaf by leaf on
    ``device``."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        _refuse_directory(path)
    st = SafetensorsFile(path)
    if st.metadata.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package "
                         f"(format {st.metadata.get('format')!r}); a Hugging "
                         f"Face checkpoint is a directory named "
                         f"'*.safetensors.d'")
    col = set(filter(None, st.metadata.get("column_major", "").split(",")))
    dev = torch.device(device)
    tree: Params = {}
    for name in st.keys():
        t = st.read(name).to(dev)
        if name in col:
            t = t.transpose(-1, -2).contiguous().transpose(-1, -2)
        *keys, last = name.split(_SEP)
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = t
    log.info("checkpoint loaded from %s (%d leaves)", path, len(st.keys()))
    return tree
