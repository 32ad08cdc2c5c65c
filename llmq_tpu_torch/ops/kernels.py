"""The port's hand-written Hopper kernels: build, load, wrappers, twins.

Eight CUDA C++ kernels (``llmq_tpu_torch/csrc/*.cu``) replace the eight
Pallas kernels of ``llmq_tpu``:

================================  ==========================================
wrapper                           replaces (``llmq_tpu/ops/pallas/``)
================================  ==========================================
:func:`fused_decode`              ``fused_decode.py`` fused_decode_attention_pallas
:func:`kv_prefill_write`          ``kv_write.py`` kv_prefill_write_pallas
:func:`prefill_attention`         ``prefill_attention.py`` paged_prefill_attention_pallas
:func:`kv_cache_write`            ``kv_write.py`` kv_cache_write_pallas
:func:`fused_decode_q8`           ``fused_decode.py`` fused_decode_attention_q8_pallas
:func:`ragged_mixed_attention`    ``ragged_paged_attention.py`` ragged_mixed_attention_pallas
:func:`ragged_mixed_attention_q8` ``ragged_paged_attention.py`` ragged_mixed_attention_q8_pallas
:func:`paged_decode_attention`    ``paged_attention.py`` paged_decode_attention_pallas
================================  ==========================================

Each source compiles with its own ``nvcc`` (all started together) into a
shared library with a plain C interface, loaded with ``ctypes``, at the
first launch — nothing is built at import. Libraries go to
``llmq_tpu_torch/_build/``, named by a hash of source and flags.

Each wrapper takes its kernel's plain PyTorch twin (``*_plain``, beside
it) only when its tensors lie on the CPU. On a CUDA tensor it checks
device, dtype, shape and contiguity, launches on the current stream,
raises if the launch failed, and adds one to :data:`LAUNCHES`.
Pools are flat ``(L, P, page_size, GD)`` with ``GD = H_kv * head_dim``;
int8 pools come with bf16 scale pools ``(L, P, H_kv, page_size)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: Library name → source file; one nvcc process per source.
SOURCES = {
    "fused_decode": "fused_decode.cu",
    "kv_write": "kv_write.cu",
    "prefill_attention": "prefill_attention.cu",
    "paged_decode": "paged_decode.cu",
    "ragged_attention": "ragged_attention.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: Library → C function → argtypes (every pointer and the stream is a
#: c_void_p; each function returns cudaGetLastError() as an int).
_SIGNATURES = {
    "kv_write": {
        "llmq_kv_cache_write": [_P] * 6 + [_I] * 5 + [_P],
        "llmq_kv_prefill_write": [_P] * 8 + [_I] * 8 + [_P],
    },
    "fused_decode": {
        "llmq_fused_decode": [_P] * 11 + [_I] * 9 + [_F, _P],
        "llmq_fused_decode_q8": [_P] * 15 + [_I] * 9 + [_F, _P],
    },
    "prefill_attention": {
        "llmq_prefill_attention": [_P] * 7 + [_I] * 9 + [_F, _P],
    },
    "paged_decode": {
        "llmq_paged_decode": [_P] * 8 + [_I] * 9 + [_F, _P],
    },
    "ragged_attention": {
        "llmq_ragged_mixed_attention": [_P] * 16 + [_I] * 12 + [_F, _P],
        "llmq_ragged_mixed_attention_q8": [_P] * 20 + [_I] * 12 + [_F, _P],
    },
}

#: Launches per kernel, counted by the wrappers where they launch and
#: nowhere else. ``reset_launches()`` zeroes them.
LAUNCHES: Dict[str, int] = {"fused_decode": 0, "kv_prefill_write": 0,
                            "prefill_attention": 0, "kv_cache_write": 0,
                            "fused_decode_q8": 0,
                            "ragged_mixed_attention": 0,
                            "ragged_mixed_attention_q8": 0,
                            "paged_decode_attention": 0}

#: nvcc's stderr per library from the last build (ptxas register and
#: shared-memory report).
BUILD_LOGS: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()

#: Positions per split block of the split-K decode body (kernels 1, 5 and
#: 8 and the decode blocks of kernels 6 and 7) for a row that fills its
#: block table (a multiple of 64, the body's tile); a shorter row takes
#: fewer, shorter splits. Chosen on the card for kernel 1 (PERF.md).
FUSED_DECODE_CHUNK = 128

#: The kernels that launch the split-K decode body, each with workspaces
#: of its own.
SPLIT_KERNELS = ("fused_decode", "paged_decode_attention",
                 "ragged_mixed_attention", "fused_decode_q8",
                 "ragged_mixed_attention_q8")

#: (kernel, device, B, H_kv, n_rep, D, n_splits) → (workspace, counters)
#: of a split-K launch, made once with ``torch.zeros``.
_SPLIT_WORKSPACES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    # The shared headers count too: a header edit rebuilds every source.
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _load(name: str, path: Path) -> None:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIBS[name] = lib


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile (if not already built) and load the named libraries, all
    sources at once with one nvcc each. Raises with nvcc's output if any
    compile fails; every nvcc started has exited when this returns."""
    with _BUILD_LOCK:
        jobs = []
        for name in (list(names) if names is not None else list(SOURCES)):
            if name in _LIBS:
                continue
            out = _lib_path(name)
            if out.exists():
                _load(name, out)
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / SOURCES[name])]
            jobs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failures = []
        for name, out, tmp, proc in jobs:
            stdout, stderr = proc.communicate()
            BUILD_LOGS[name] = stdout + stderr
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {SOURCES[name]} "
                                f"(exit {proc.returncode}):\n{stderr}")
                continue
            os.replace(tmp, out)
            _load(name, out)
        if failures:
            raise RuntimeError("\n".join(failures))


def _fn(lib: str, fn_name: str):
    if lib not in _LIBS:
        build()
    return getattr(_LIBS[lib], fn_name)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (take the plain twin);
    False when every one lies on the current CUDA device (launch)."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on mixed devices: {dev} and "
                             f"{t.device}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Optional[tuple] = None, align: int = 0) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, need {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, need {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _check_pools(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 layer: int) -> None:
    if k_pool.dim() != 4:
        raise ValueError(f"pool must be (L, P, page_size, GD), got "
                         f"{tuple(k_pool.shape)}")
    _check(k_pool, "k_pool", torch.bfloat16, align=16)
    _check(v_pool, "v_pool", torch.bfloat16, tuple(k_pool.shape), align=16)
    if k_pool.shape[3] % 8:
        raise ValueError(f"GD={k_pool.shape[3]} must be a multiple of 8")
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} out of range [0, "
                         f"{k_pool.shape[0]})")


def _check_q8_pools(k_pool: torch.Tensor, v_pool: torch.Tensor,
                    ks_pool: torch.Tensor, vs_pool: torch.Tensor, layer: int,
                    D: int) -> None:
    """int8 data pools (L, P, ps, GD) and their bf16 scale pools
    (L, P, H_kv, ps)."""
    if k_pool.dim() != 4:
        raise ValueError(f"pool must be (L, P, page_size, GD), got "
                         f"{tuple(k_pool.shape)}")
    L, P, ps, GD = k_pool.shape
    _check(k_pool, "k_pool", torch.int8, align=16)
    _check(v_pool, "v_pool", torch.int8, tuple(k_pool.shape), align=16)
    if GD % D:
        raise ValueError(f"pool GD={GD} is not a multiple of D={D}")
    sshape = (L, P, GD // D, ps)
    _check(ks_pool, "k_scale_pool", torch.bfloat16, sshape)
    _check(vs_pool, "v_scale_pool", torch.bfloat16, sshape)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")


def _check_new_q8(B: int, Hkv: int, D: int, kq: torch.Tensor,
                  ks: torch.Tensor, vq: torch.Tensor,
                  vs: torch.Tensor) -> None:
    """Pre-quantized decode rows: int8 (B, H_kv, D), 8-byte aligned (the
    kernels copy a row in 8-byte pieces), bf16 scales (B, H_kv)."""
    for t, name in ((kq, "k_new_q"), (vq, "v_new_q")):
        _check(t, name, torch.int8, align=8)
        if t.numel() != B * Hkv * D:
            raise ValueError(f"{name} must hold (B, H_kv, D) = "
                             f"({B}, {Hkv}, {D})")
    for t, name in ((ks, "k_new_scale"), (vs, "v_new_scale")):
        _check(t, name, torch.bfloat16)
        if t.numel() != B * Hkv:
            raise ValueError(f"{name} must hold (B, H_kv) = ({B}, {Hkv})")


def _check_heads(H: int, Hkv: int, D: int) -> None:
    if D not in (64, 128) or H % Hkv or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"no kernel instantiation for H={H} H_kv={Hkv} "
                         f"D={D} (need D in 64/128, H/H_kv in 1/2/4/8)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


# -- kernel 1: fused decode write + attention --------------------------------

def fused_decode_splits(max_pages: int, page_size: int) -> int:
    """Split blocks per (row, KV head) of the split-K decode body
    (:func:`fused_decode`, :func:`fused_decode_q8`,
    :func:`paged_decode_attention` and the decode ranges of
    :func:`ragged_mixed_attention` and
    :func:`ragged_mixed_attention_q8`): enough chunks of
    :data:`FUSED_DECODE_CHUNK` positions to cover a full block table.
    From shapes only, so the launch never waits on ``seq_lens``; the
    kernel cuts each row into that many chunks or fewer, each a multiple
    of 64 positions."""
    return max(1, -(-max_pages * page_size // FUSED_DECODE_CHUNK))


def split_workspace(kernel: str, device: torch.device, batch: int,
                    n_kv_heads: int, n_rep: int, head_dim: int,
                    n_splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 partials ``(B, H_kv, n_splits, n_rep * (D + 2))`` and the
    int32 arrival counters ``(B, H_kv)`` of the split-K launches of
    ``kernel`` (one of :data:`SPLIT_KERNELS`), made once per kernel and
    geometry with ``torch.zeros`` and reused by every later call: the
    kernel leaves each counter at 0, so no call allocates or clears
    anything (and a captured graph may replay the launch). No two
    kernels share counters, so one kernel's fault cannot leave another's
    at non-zero."""
    if kernel not in SPLIT_KERNELS:
        raise ValueError(f"no split workspace for kernel {kernel!r}")
    key = (kernel, torch.device(device), batch, n_kv_heads, n_rep, head_dim,
           n_splits)
    if key not in _SPLIT_WORKSPACES:
        _SPLIT_WORKSPACES[key] = (
            torch.zeros((batch, n_kv_heads, n_splits,
                         n_rep * (head_dim + 2)), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, n_kv_heads), dtype=torch.int32,
                        device=device))
    return _SPLIT_WORKSPACES[key]


def fused_decode(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor, seq_lens: torch.Tensor,
                 write_page: torch.Tensor, layer: int) -> torch.Tensor:
    """One decode layer: write each row's current K/V into slot
    ``(seq_len-1) % page_size`` of ``write_page[b]`` (in place; 0 for an
    inactive row), then GQA attention of q (B, H, D) over positions
    ``[0, seq_len)`` through ``block_tables`` (B, MP), the new token
    included. A row with ``seq_len == 0`` returns zeros.

    Replaces ``fused_decode_attention_pallas``
    (llmq_tpu/ops/pallas/fused_decode.py). Bound on the H100 by bytes:
    each row's positions are split over up to
    :func:`fused_decode_splits` blocks that stream K/V by cp.async and
    score on the tensor cores, merged in the same launch
    (csrc/fused_decode.cu, csrc/decode_attention.cuh)."""
    if _on_cpu(q, k_new, v_new, k_pool, v_pool, block_tables, seq_lens,
               write_page):
        return fused_decode_plain(q, k_new, v_new, k_pool, v_pool,
                                  block_tables, seq_lens, write_page, layer)
    B, H, D = q.shape
    _check_pools(k_pool, v_pool, layer)
    L, P, ps, GD = k_pool.shape
    Hkv = GD // D
    _check_heads(H, Hkv, D)
    if Hkv * D != GD:
        raise ValueError(f"pool GD={GD} != H_kv*D for D={D}")
    MP = block_tables.shape[1] if block_tables.dim() == 2 else -1
    _check(q, "q", torch.bfloat16, (B, H, D), align=8)
    _check(k_new, "k_new", torch.bfloat16, align=8)
    _check(v_new, "v_new", torch.bfloat16, align=8)
    if k_new.numel() != B * GD or v_new.numel() != B * GD:
        raise ValueError(f"k_new/v_new must hold (B, GD) = ({B}, {GD})")
    _check(block_tables, "block_tables", torch.int32, (B, MP))
    _check(seq_lens, "seq_lens", torch.int32, (B,))
    _check(write_page, "write_page", torch.int32, (B,))
    n_splits = fused_decode_splits(MP, ps)
    ws, counters = split_workspace("fused_decode", q.device, B, Hkv, H // Hkv,
                                   D, n_splits)
    out = torch.empty_like(q)
    rc = _fn("fused_decode", "llmq_fused_decode")(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), write_page.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), B, H, Hkv, D, layer, P, ps, MP,
        n_splits, D ** -0.5, _stream(q))
    _raise_on(rc, "fused_decode")
    LAUNCHES["fused_decode"] += 1
    return out


def fused_decode_plain(q: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       seq_lens: torch.Tensor, write_page: torch.Tensor,
                       layer: int) -> torch.Tensor:
    """Plain twin of :func:`fused_decode`: scatter-write, gather the
    history, attend (the JAX package's fallback math); position
    ``seq_len-1`` is taken from k_new/v_new as the kernel does."""
    from llmq_tpu_torch.ops.attention import _gqa_attend, paged_kv_write

    B, H, D = q.shape
    ps, GD = k_pool.shape[2], k_pool.shape[3]
    Hkv = GD // D
    S = block_tables.shape[1] * ps
    live = seq_lens > 0
    last = (seq_lens.long() - 1).clamp(min=0)
    paged_kv_write(k_pool, v_pool, k_new.reshape(B, GD)[live],
                   v_new.reshape(B, GD)[live], write_page[live],
                   (last % ps)[live], layer)
    bt = block_tables.long()
    k = k_pool[layer][bt].reshape(B, S, Hkv, D)
    v = v_pool[layer][bt].reshape(B, S, Hkv, D)
    rows = torch.nonzero(live & (last < S)).flatten()
    k[rows, last[rows]] = k_new.reshape(B, Hkv, D)[rows].to(k.dtype)
    v[rows, last[rows]] = v_new.reshape(B, Hkv, D)[rows].to(v.dtype)
    out = _gqa_attend(q, k, v, seq_lens.clamp(max=S))
    return torch.where(live[:, None, None], out, torch.zeros_like(out))


# -- kernel 2: prefill chunk write --------------------------------------------

def _check_rows_desc(n_rows: int, max_pages: int, block_tables: torch.Tensor,
                     **desc: torch.Tensor) -> None:
    """Per-row device descriptors: int32 (n_rows,) each, and the int32
    block tables (n_rows, max_pages)."""
    _check(block_tables, "block_tables", torch.int32, (n_rows, max_pages))
    for name, t in desc.items():
        _check(t, name, torch.int32, (n_rows,))


def kv_prefill_write(k_pool: torch.Tensor, v_pool: torch.Tensor,
                     k_rows: torch.Tensor, v_rows: torch.Tensor,
                     block_tables: torch.Tensor, offsets: torch.Tensor,
                     counts: torch.Tensor, starts: torch.Tensor,
                     row_tokens: int, layer: int) -> None:
    """Write the prefill rows of a whole batch in one launch, in place:
    row r's token t (``t < counts[r]``) is buffer row ``offsets[r] + t``
    of k_rows/v_rows (M, GD) and lands at absolute position ``starts[r]
    + t`` through ``block_tables[r]`` (R, MP). Tokens at or past
    ``counts[r]`` are not written. ``row_tokens`` bounds every count and
    sets the grid with R, so nothing is read from the device: the bucket
    programs pass T with offsets ``r·T``, a ragged step its buffer's N
    with the slices' ``qoff/qlen/qstart``. A position past the block
    table or a page outside the pool is skipped.

    Replaces ``kv_prefill_write_pallas`` (llmq_tpu/ops/pallas/
    kv_write.py), vmapped there over a wave's rows, without its
    page-aligned pre-shifted buffer. Bound by bytes: each live row is
    read and written once (csrc/kv_write.cu)."""
    if _on_cpu(k_pool, v_pool, k_rows, v_rows, block_tables, offsets,
               counts, starts):
        kv_prefill_write_plain(k_pool, v_pool, k_rows, v_rows, block_tables,
                               offsets, counts, starts, row_tokens, layer)
        return
    _check_pools(k_pool, v_pool, layer)
    L, P, ps, GD = k_pool.shape
    M = k_rows.shape[0]
    _check(k_rows, "k_rows", torch.bfloat16, (M, GD), align=16)
    _check(v_rows, "v_rows", torch.bfloat16, (M, GD), align=16)
    R = offsets.shape[0]
    MP = block_tables.shape[1] if block_tables.dim() == 2 else -1
    _check_rows_desc(R, MP, block_tables, offsets=offsets, counts=counts,
                     starts=starts)
    if not 0 < row_tokens <= M:
        raise ValueError(f"row_tokens={row_tokens} outside (0, {M}]")
    rc = _fn("kv_write", "llmq_kv_prefill_write")(
        k_pool.data_ptr(), v_pool.data_ptr(), k_rows.data_ptr(),
        v_rows.data_ptr(), block_tables.data_ptr(), offsets.data_ptr(),
        counts.data_ptr(), starts.data_ptr(), R, row_tokens, M, MP, layer,
        P, ps, GD, _stream(k_pool))
    _raise_on(rc, "kv_prefill_write")
    LAUNCHES["kv_prefill_write"] += 1


def kv_prefill_write_plain(k_pool: torch.Tensor, v_pool: torch.Tensor,
                           k_rows: torch.Tensor, v_rows: torch.Tensor,
                           block_tables: torch.Tensor, offsets: torch.Tensor,
                           counts: torch.Tensor, starts: torch.Tensor,
                           row_tokens: int, layer: int) -> None:
    """Plain twin of :func:`kv_prefill_write`: one scatter of the live
    tokens of every row."""
    from llmq_tpu_torch.ops.attention import paged_kv_write

    ps = k_pool.shape[2]
    MP = block_tables.shape[1]
    t = torch.arange(row_tokens, device=k_pool.device)[None, :]
    src = offsets.long()[:, None] + t
    pos = starts.long()[:, None] + t
    live = ((t < counts.long()[:, None]) & (src >= 0)
            & (src < k_rows.shape[0]) & (pos >= 0) & (pos // ps < MP))
    page = block_tables.long().gather(1, (pos // ps).clamp(0, MP - 1))
    live &= (page >= 0) & (page < k_pool.shape[1])
    src = src[live]
    paged_kv_write(k_pool, v_pool, k_rows[src], v_rows[src], page[live],
                   pos[live] % ps, layer)


# -- kernel 3: paged causal prefill attention ---------------------------------

def prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      starts: torch.Tensor, lengths: torch.Tensor,
                      layer: int) -> torch.Tensor:
    """Causal attention for N sequences' chunks in one launch: q (N, T,
    H, D), row n's token t at absolute position ``starts[n] + t``, over
    that sequence's pages through ``block_tables[n]`` (its fresh K/V and
    any cached history); visibility is ``kv_pos <= q_pos``. Tokens at or
    past ``lengths[n]`` come out as zeros. ``starts`` and ``lengths``
    are device int32 (N,); the grid comes from the shapes. Returns (N,
    T, H, D).

    Replaces ``paged_prefill_attention_pallas`` (llmq_tpu/ops/pallas/
    prefill_attention.py), vmapped there over a wave's rows. Its bound
    moves between bytes (a fresh chunk) and operations (a long chunk or
    history); both products run on the tensor cores (wgmma), each
    cp.async-staged K/V tile serving 64 query rows; q tiles past a row's
    length only write zeros (csrc/prefill_attention.cu)."""
    if _on_cpu(q, k_pool, v_pool, block_tables, starts, lengths):
        return prefill_attention_plain(q, k_pool, v_pool, block_tables,
                                       starts, lengths, layer)
    N, T, H, D = q.shape
    _check_pools(k_pool, v_pool, layer)
    L, P, ps, GD = k_pool.shape
    Hkv = GD // D
    _check_heads(H, Hkv, D)
    if Hkv * D != GD:
        raise ValueError(f"pool GD={GD} != H_kv*D for D={D}")
    _check(q, "q", torch.bfloat16, (N, T, H, D), align=16)
    MP = block_tables.shape[1] if block_tables.dim() == 2 else -1
    _check_rows_desc(N, MP, block_tables, starts=starts, lengths=lengths)
    out = torch.empty_like(q)
    rc = _fn("prefill_attention", "llmq_prefill_attention")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), N, T, H, Hkv, D, layer, P, ps, MP, D ** -0.5,
        _stream(q))
    _raise_on(rc, "prefill_attention")
    LAUNCHES["prefill_attention"] += 1
    return out


def prefill_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            starts: torch.Tensor, lengths: torch.Tensor,
                            layer: int) -> torch.Tensor:
    """Plain twin of :func:`prefill_attention`: gather each row's pages,
    the blockwise online-softmax attention, zeros past each length."""
    from llmq_tpu_torch.ops.attention import blockwise_prefill_attention

    N, T, H, D = q.shape
    ps, GD = k_pool.shape[2], k_pool.shape[3]
    Hkv = GD // D
    S = block_tables.shape[1] * ps
    bt = block_tables.long()
    k_hist = k_pool[layer][bt].reshape(N, S, Hkv, D)
    v_hist = v_pool[layer][bt].reshape(N, S, Hkv, D)
    t = torch.arange(T, device=q.device)
    positions = starts.long()[:, None] + t[None, :]
    lens = lengths.long().clamp(0, T)
    seq_lens = (starts.long() + lens).clamp(max=S)
    out = blockwise_prefill_attention(q, k_hist, v_hist, positions, seq_lens)
    live = t[None, :] < lens[:, None]
    return torch.where(live[:, :, None, None], out, torch.zeros_like(out))


# -- kernel 4: decode row write -----------------------------------------------

def kv_cache_write(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   page_of: torch.Tensor, slot_of: torch.Tensor,
                   layer: int) -> None:
    """Write N token rows (N, GD) to ``(page_of[n], slot_of[n])`` of
    layer ``layer``, in place.

    Replaces ``kv_cache_write_pallas`` (llmq_tpu/ops/pallas/
    kv_write.py), the write half of the split decode route. Bound by
    bytes: each row is read and written once (csrc/kv_write.cu)."""
    if _on_cpu(k_pool, v_pool, k_new, v_new, page_of, slot_of):
        kv_cache_write_plain(k_pool, v_pool, k_new, v_new, page_of,
                             slot_of, layer)
        return
    _check_pools(k_pool, v_pool, layer)
    L, P, ps, GD = k_pool.shape
    N = k_new.shape[0]
    _check(k_new, "k_new", torch.bfloat16, (N, GD), align=16)
    _check(v_new, "v_new", torch.bfloat16, (N, GD), align=16)
    _check(page_of, "page_of", torch.int32, (N,))
    _check(slot_of, "slot_of", torch.int32, (N,))
    if N == 0:
        return
    rc = _fn("kv_write", "llmq_kv_cache_write")(
        k_pool.data_ptr(), v_pool.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), page_of.data_ptr(), slot_of.data_ptr(), N, layer,
        P, ps, GD, _stream(k_pool))
    _raise_on(rc, "kv_cache_write")
    LAUNCHES["kv_cache_write"] += 1


def kv_cache_write_plain(k_pool: torch.Tensor, v_pool: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         page_of: torch.Tensor, slot_of: torch.Tensor,
                         layer: int) -> None:
    """Plain twin of :func:`kv_cache_write`: a scatter."""
    from llmq_tpu_torch.ops.attention import paged_kv_write

    paged_kv_write(k_pool, v_pool, k_new, v_new, page_of, slot_of, layer)


# -- kernel 5: int8 fused decode write + attention ----------------------------

def fused_decode_q8(q: torch.Tensor, k_new_q: torch.Tensor,
                    k_new_scale: torch.Tensor, v_new_q: torch.Tensor,
                    v_new_scale: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, k_scale_pool: torch.Tensor,
                    v_scale_pool: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, write_page: torch.Tensor,
                    layer: int) -> torch.Tensor:
    """:func:`fused_decode` over int8 pools: write each row's
    pre-quantized K/V (B, H_kv, D) int8 and its per-head bf16 scales
    (B, H_kv) at slot ``(seq_len-1) % page_size`` of ``write_page[b]`` (in
    place, scales into the (L, P, H_kv, ps) scale pools), then GQA
    attention over ``[0, seq_len)`` with in-kernel dequant: K scales
    multiply the logits, V scales fold into the probabilities. A row
    with ``seq_len == 0`` returns zeros.

    Replaces ``fused_decode_attention_q8_pallas`` (llmq_tpu/ops/pallas/
    fused_decode.py). Bound by bytes: half kernel 1's K/V bytes plus 4
    bytes of scales per cached (position, head). Kernel 1's split-K body
    over int8 pools: each int8 tile is converted to bf16 in shared memory
    beside its scales and scored on the tensor cores, the splits merged
    in the launch through this kernel's own :func:`split_workspace`
    (csrc/fused_decode.cu, csrc/decode_attention.cuh)."""
    if _on_cpu(q, k_new_q, k_new_scale, v_new_q, v_new_scale, k_pool,
               v_pool, k_scale_pool, v_scale_pool, block_tables, seq_lens,
               write_page):
        return fused_decode_q8_plain(q, k_new_q, k_new_scale, v_new_q,
                                     v_new_scale, k_pool, v_pool,
                                     k_scale_pool, v_scale_pool,
                                     block_tables, seq_lens, write_page,
                                     layer)
    B, H, D = q.shape
    _check_q8_pools(k_pool, v_pool, k_scale_pool, v_scale_pool, layer, D)
    L, P, ps, GD = k_pool.shape
    Hkv = GD // D
    _check_heads(H, Hkv, D)
    MP = block_tables.shape[1] if block_tables.dim() == 2 else -1
    _check(q, "q", torch.bfloat16, (B, H, D), align=8)
    _check_new_q8(B, Hkv, D, k_new_q, k_new_scale, v_new_q, v_new_scale)
    _check(block_tables, "block_tables", torch.int32, (B, MP))
    _check(seq_lens, "seq_lens", torch.int32, (B,))
    _check(write_page, "write_page", torch.int32, (B,))
    n_splits = fused_decode_splits(MP, ps)
    ws, counters = split_workspace("fused_decode_q8", q.device, B, Hkv,
                                   H // Hkv, D, n_splits)
    out = torch.empty_like(q)
    rc = _fn("fused_decode", "llmq_fused_decode_q8")(
        q.data_ptr(), k_new_q.data_ptr(), k_new_scale.data_ptr(),
        v_new_q.data_ptr(), v_new_scale.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), k_scale_pool.data_ptr(), v_scale_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), write_page.data_ptr(),
        out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, H, Hkv, D,
        layer, P, ps, MP, n_splits, D ** -0.5, _stream(q))
    _raise_on(rc, "fused_decode_q8")
    LAUNCHES["fused_decode_q8"] += 1
    return out


def fused_decode_q8_plain(q: torch.Tensor, k_new_q: torch.Tensor,
                          k_new_scale: torch.Tensor, v_new_q: torch.Tensor,
                          v_new_scale: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, k_scale_pool: torch.Tensor,
                          v_scale_pool: torch.Tensor,
                          block_tables: torch.Tensor, seq_lens: torch.Tensor,
                          write_page: torch.Tensor,
                          layer: int) -> torch.Tensor:
    """Plain twin of :func:`fused_decode_q8`, the JAX package's plain
    route: scatter the rows and scales, gather and dequantize the window
    to bf16, attend; position ``seq_len-1`` is taken from the new row as
    the kernel does."""
    from llmq_tpu_torch.ops.attention import (_dequant_window, _gqa_attend,
                                              _scale_scatter)
    from llmq_tpu_torch.ops.quant import dequantize_kv

    B, H, D = q.shape
    ps, GD = k_pool.shape[2], k_pool.shape[3]
    Hkv = GD // D
    S = block_tables.shape[1] * ps
    live = seq_lens > 0
    last = (seq_lens.long() - 1).clamp(min=0)
    page, slot = write_page.long()[live], (last % ps)[live]
    k_pool[layer, page, slot] = k_new_q.reshape(B, GD)[live]
    v_pool[layer, page, slot] = v_new_q.reshape(B, GD)[live]
    _scale_scatter(k_scale_pool, layer, page, slot,
                   k_new_scale.reshape(B, Hkv)[live])
    _scale_scatter(v_scale_pool, layer, page, slot,
                   v_new_scale.reshape(B, Hkv)[live])
    k = _dequant_window(k_pool, k_scale_pool, layer, block_tables, D)
    v = _dequant_window(v_pool, v_scale_pool, layer, block_tables, D)
    rows = torch.nonzero(live & (last < S)).flatten()
    k[rows, last[rows]] = dequantize_kv(
        k_new_q.reshape(B, Hkv, D)[rows], k_new_scale.reshape(B, Hkv)[rows])
    v[rows, last[rows]] = dequantize_kv(
        v_new_q.reshape(B, Hkv, D)[rows], v_new_scale.reshape(B, Hkv)[rows])
    out = _gqa_attend(q, k, v, seq_lens.clamp(max=S))
    return torch.where(live[:, None, None], out, torch.zeros_like(out))


# -- kernel 6: ragged mixed attention -----------------------------------------

def ragged_grid(n_tokens: int, n_kv_heads: int, max_pages: int,
                page_size: int) -> Tuple[int, int]:
    """The 1-D grid of kernels 6 and 7: ``(slice blocks, decode
    splits)``. The slice range comes first, one block per (8-row q-block
    of the packed buffer, KV head); then ``decode splits`` blocks per
    (decode row, KV head), as many as :func:`fused_decode_splits` gives
    kernel 1. From shapes only; the launch has ``slice blocks + B * H_kv
    * decode splits`` blocks. The q-block is
    ``ops/attention.RAGGED_Q_BLOCK`` (``kQBlock`` in the source)."""
    from llmq_tpu_torch.ops.attention import RAGGED_Q_BLOCK

    if n_tokens % RAGGED_Q_BLOCK:
        raise ValueError(f"packed buffer N={n_tokens} must be a multiple "
                         f"of {RAGGED_Q_BLOCK}")
    return (n_tokens // RAGGED_Q_BLOCK * n_kv_heads,
            fused_decode_splits(max_pages, page_size))


def ragged_mixed_attention(q_dec: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, q_pf: torch.Tensor,
                           k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_tables: torch.Tensor, seq_lens: torch.Tensor,
                           write_page: torch.Tensor, pf_qoff: torch.Tensor,
                           pf_qlen: torch.Tensor, pf_qstart: torch.Tensor,
                           layer: int):
    """One launch for a mixed step's attention: the B decode rows as
    :func:`fused_decode` does them (their K/V written in place at
    ``write_page``), AND causal paged attention for every token of the
    S prefill slices packed into q_pf (N, H, D). Slice s occupies rows
    ``[pf_qoff[s], pf_qoff[s] + pf_qlen[s])`` (offsets multiples of 8,
    N a multiple of 8), its first token at absolute position
    ``pf_qstart[s]``; its K/V must already be in its pages.
    ``block_tables`` (B+S, MP) and ``seq_lens`` (B+S,) hold the decode
    rows, then the slices. Returns ``(out_dec (B, H, D), out_pf (N, H,
    D))``; packed rows outside every slice come out as zeros.

    Replaces ``ragged_mixed_attention_pallas`` (llmq_tpu/ops/pallas/
    ragged_paged_attention.py). Decode blocks are bound by bytes and run
    kernel 1's split-K body (:func:`fused_decode_splits` blocks per (row,
    KV head), merged in the launch through this kernel's own
    :func:`split_workspace`); slice blocks, bound by bytes or operations
    with the history's length, run both products on the tensor cores
    (csrc/ragged_attention.cu)."""
    if _on_cpu(q_dec, k_new, v_new, q_pf, k_pool, v_pool, block_tables,
               seq_lens, write_page, pf_qoff, pf_qlen, pf_qstart):
        return ragged_mixed_attention_plain(
            q_dec, k_new, v_new, q_pf, k_pool, v_pool, block_tables,
            seq_lens, write_page, pf_qoff, pf_qlen, pf_qstart, layer)
    B, H, D = q_dec.shape
    N = q_pf.shape[0]
    S = pf_qoff.shape[0]
    _check_pools(k_pool, v_pool, layer)
    L, P, ps, GD = k_pool.shape
    Hkv = GD // D
    _check_heads(H, Hkv, D)
    if Hkv * D != GD:
        raise ValueError(f"pool GD={GD} != H_kv*D for D={D}")
    MP = block_tables.shape[1] if block_tables.dim() == 2 else -1
    n_slice_blocks, n_splits = ragged_grid(N, Hkv, MP, ps)
    _check(q_dec, "q_dec", torch.bfloat16, (B, H, D), align=8)
    _check(q_pf, "q_pf", torch.bfloat16, (N, H, D), align=16)
    _check(k_new, "k_new", torch.bfloat16, align=8)
    _check(v_new, "v_new", torch.bfloat16, align=8)
    if k_new.numel() != B * GD or v_new.numel() != B * GD:
        raise ValueError(f"k_new/v_new must hold (B, GD) = ({B}, {GD})")
    _check(block_tables, "block_tables", torch.int32, (B + S, MP))
    _check(seq_lens, "seq_lens", torch.int32, (B + S,))
    _check(write_page, "write_page", torch.int32, (B,))
    for t, name in ((pf_qoff, "pf_qoff"), (pf_qlen, "pf_qlen"),
                    (pf_qstart, "pf_qstart")):
        _check(t, name, torch.int32, (S,))
    ws, counters = split_workspace("ragged_mixed_attention", q_dec.device, B,
                                   Hkv, H // Hkv, D, n_splits)
    out_dec = torch.empty_like(q_dec)
    out_pf = torch.empty_like(q_pf)
    rc = _fn("ragged_attention", "llmq_ragged_mixed_attention")(
        q_dec.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        q_pf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), write_page.data_ptr(),
        pf_qoff.data_ptr(), pf_qlen.data_ptr(), pf_qstart.data_ptr(),
        out_dec.data_ptr(), out_pf.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), B, S, N, H, Hkv, D, layer, P, ps, MP,
        n_slice_blocks, n_splits, D ** -0.5, _stream(q_dec))
    _raise_on(rc, "ragged_mixed_attention")
    LAUNCHES["ragged_mixed_attention"] += 1
    return out_dec, out_pf


def ragged_mixed_attention_plain(q_dec: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor, q_pf: torch.Tensor,
                                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 seq_lens: torch.Tensor,
                                 write_page: torch.Tensor,
                                 pf_qoff: torch.Tensor, pf_qlen: torch.Tensor,
                                 pf_qstart: torch.Tensor, layer: int):
    """Plain twin of :func:`ragged_mixed_attention`: the decode half as
    :func:`fused_decode_plain`, then each slice's causal attention over
    its gathered pages (:func:`prefill_attention_plain`) for the packed
    rows it owns (:func:`_slice_owner`); packed rows outside every slice
    are zeros. Descriptors stay on the device."""
    B = q_dec.shape[0]
    out_dec = fused_decode_plain(q_dec, k_new, v_new, k_pool, v_pool,
                                 block_tables[:B], seq_lens[:B], write_page,
                                 layer)
    N = q_pf.shape[0]
    own = _slice_owner(N, pf_qoff, pf_qlen)
    out_pf = torch.zeros_like(q_pf)
    for s in range(pf_qoff.shape[0]):
        # Every packed row as if slice s held it: row n at qstart + n -
        # qoff; the rows slice s owns are the ones kept.
        start = (pf_qstart[s:s + 1] - pf_qoff[s:s + 1]).to(torch.int32)
        o = prefill_attention_plain(
            q_pf[None], k_pool, v_pool, block_tables[B + s:B + s + 1],
            start, (pf_qoff[s:s + 1] + pf_qlen[s:s + 1]).to(torch.int32),
            layer)[0]
        out_pf = torch.where(own[s][:, None, None], o, out_pf)
    return out_dec, out_pf


def _slice_owner(n_rows: int, qoff: torch.Tensor,
                 qlen: torch.Tensor) -> torch.Tensor:
    """(S, n_rows) bool: packed row n lies in slice s, ``qoff[s] <= n <
    qoff[s] + qlen[s]``."""
    n = torch.arange(n_rows, device=qoff.device)[None, :]
    off = qoff.long()[:, None]
    return (n >= off) & (n < off + qlen.long()[:, None])


# -- kernel 7: int8 ragged mixed attention -----------------------------------

def ragged_mixed_attention_q8(q_dec: torch.Tensor, k_new_q: torch.Tensor,
                              k_new_scale: torch.Tensor,
                              v_new_q: torch.Tensor,
                              v_new_scale: torch.Tensor, q_pf: torch.Tensor,
                              k_pool: torch.Tensor, v_pool: torch.Tensor,
                              k_scale_pool: torch.Tensor,
                              v_scale_pool: torch.Tensor,
                              block_tables: torch.Tensor,
                              seq_lens: torch.Tensor,
                              write_page: torch.Tensor,
                              pf_qoff: torch.Tensor, pf_qlen: torch.Tensor,
                              pf_qstart: torch.Tensor, layer: int):
    """:func:`ragged_mixed_attention` over int8 pools: the B decode rows
    as :func:`fused_decode_q8` does them (pre-quantized rows and scales
    written in place), AND causal paged attention for every token of the
    S packed prefill slices, whose int8 K/V and scales must already be in
    their pages; slice blocks dequantize in the kernel. Descriptors and
    the packed layout are :func:`ragged_mixed_attention`'s. Returns
    ``(out_dec (B, H, D), out_pf (N, H, D))``; packed rows outside every
    slice are zeros.

    Replaces ``ragged_mixed_attention_q8_pallas`` (llmq_tpu/ops/pallas/
    ragged_paged_attention.py). Kernel 6's design over int8 pools (the
    grid of :func:`ragged_grid`, split decode blocks merged through this
    kernel's own :func:`split_workspace`, tensor-core slice blocks), each
    int8 tile converted to bf16 in shared memory beside its scales.
    Decode blocks are bound by bytes, slice blocks by bytes or operations
    with the history's length (csrc/ragged_attention.cu)."""
    if _on_cpu(q_dec, k_new_q, k_new_scale, v_new_q, v_new_scale, q_pf,
               k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables,
               seq_lens, write_page, pf_qoff, pf_qlen, pf_qstart):
        return ragged_mixed_attention_q8_plain(
            q_dec, k_new_q, k_new_scale, v_new_q, v_new_scale, q_pf, k_pool,
            v_pool, k_scale_pool, v_scale_pool, block_tables, seq_lens,
            write_page, pf_qoff, pf_qlen, pf_qstart, layer)
    B, H, D = q_dec.shape
    N = q_pf.shape[0]
    S = pf_qoff.shape[0]
    _check_q8_pools(k_pool, v_pool, k_scale_pool, v_scale_pool, layer, D)
    L, P, ps, GD = k_pool.shape
    Hkv = GD // D
    _check_heads(H, Hkv, D)
    MP = block_tables.shape[1] if block_tables.dim() == 2 else -1
    n_slice_blocks, n_splits = ragged_grid(N, Hkv, MP, ps)
    _check(q_dec, "q_dec", torch.bfloat16, (B, H, D), align=8)
    _check(q_pf, "q_pf", torch.bfloat16, (N, H, D), align=16)
    _check_new_q8(B, Hkv, D, k_new_q, k_new_scale, v_new_q, v_new_scale)
    _check(block_tables, "block_tables", torch.int32, (B + S, MP))
    _check(seq_lens, "seq_lens", torch.int32, (B + S,))
    _check(write_page, "write_page", torch.int32, (B,))
    for t, name in ((pf_qoff, "pf_qoff"), (pf_qlen, "pf_qlen"),
                    (pf_qstart, "pf_qstart")):
        _check(t, name, torch.int32, (S,))
    ws, counters = split_workspace("ragged_mixed_attention_q8",
                                   q_dec.device, B, Hkv, H // Hkv, D,
                                   n_splits)
    out_dec = torch.empty_like(q_dec)
    out_pf = torch.empty_like(q_pf)
    rc = _fn("ragged_attention", "llmq_ragged_mixed_attention_q8")(
        q_dec.data_ptr(), k_new_q.data_ptr(), k_new_scale.data_ptr(),
        v_new_q.data_ptr(), v_new_scale.data_ptr(), q_pf.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), k_scale_pool.data_ptr(),
        v_scale_pool.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), write_page.data_ptr(), pf_qoff.data_ptr(),
        pf_qlen.data_ptr(), pf_qstart.data_ptr(), out_dec.data_ptr(),
        out_pf.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, S, N, H,
        Hkv, D, layer, P, ps, MP, n_slice_blocks, n_splits, D ** -0.5,
        _stream(q_dec))
    _raise_on(rc, "ragged_mixed_attention_q8")
    LAUNCHES["ragged_mixed_attention_q8"] += 1
    return out_dec, out_pf


def ragged_mixed_attention_q8_plain(q_dec: torch.Tensor,
                                    k_new_q: torch.Tensor,
                                    k_new_scale: torch.Tensor,
                                    v_new_q: torch.Tensor,
                                    v_new_scale: torch.Tensor,
                                    q_pf: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor,
                                    k_scale_pool: torch.Tensor,
                                    v_scale_pool: torch.Tensor,
                                    block_tables: torch.Tensor,
                                    seq_lens: torch.Tensor,
                                    write_page: torch.Tensor,
                                    pf_qoff: torch.Tensor,
                                    pf_qlen: torch.Tensor,
                                    pf_qstart: torch.Tensor, layer: int):
    """Plain twin of :func:`ragged_mixed_attention_q8`, the JAX package's
    plain route: the decode half as :func:`fused_decode_q8_plain`, then
    each slice's causal attention over its dequantized window
    (``ops/attention.dispatch_prefill_attention_q8``) for the packed rows
    it owns; packed rows outside every slice are zeros."""
    from llmq_tpu_torch.ops.attention import dispatch_prefill_attention_q8

    B = q_dec.shape[0]
    pools = (k_pool, v_pool, k_scale_pool, v_scale_pool)
    out_dec = fused_decode_q8_plain(q_dec, k_new_q, k_new_scale, v_new_q,
                                    v_new_scale, *pools, block_tables[:B],
                                    seq_lens[:B], write_page, layer)
    N = q_pf.shape[0]
    own = _slice_owner(N, pf_qoff, pf_qlen)
    rows = torch.arange(N, device=q_pf.device)
    out_pf = torch.zeros_like(q_pf)
    for s in range(pf_qoff.shape[0]):
        # Every packed row as if slice s held it (see the bf16 twin).
        pos = (pf_qstart[s].long() - pf_qoff[s].long() + rows)[None]
        seq_len = (pf_qstart[s:s + 1] + pf_qlen[s:s + 1]).long()
        o = dispatch_prefill_attention_q8(
            q_pf[None], pools, block_tables[B + s:B + s + 1], pos, seq_len,
            layer)[0]
        out_pf = torch.where(own[s][:, None, None], o, out_pf)
    return out_dec, out_pf


# -- kernel 8: paged decode attention -----------------------------------------

def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor,
                           layer: int = 0) -> torch.Tensor:
    """Decode attention without a write: q (B, H, D) over positions
    ``[0, seq_lens[b])`` of layer ``layer`` read through ``block_tables``
    (B, MP). Pools are ``(L, P, ps, GD)``, or one layer ``(P, ps, GD)``.
    A row with ``seq_len == 0`` returns zeros. Returns (B, H, D).

    Replaces ``paged_decode_attention_pallas`` (llmq_tpu/ops/pallas/
    paged_attention.py), the attention half of the split decode route.
    Bound by bytes: kernel 1's split-K body without the write, each
    row's positions over up to :func:`fused_decode_splits` blocks that
    read each cached K/V byte once for all n_rep query heads of their
    group, merged in the launch through this kernel's own
    :func:`split_workspace` (csrc/paged_decode.cu)."""
    if k_pool.dim() == 3:
        k_pool, v_pool = k_pool[None], v_pool[None]
    if _on_cpu(q, k_pool, v_pool, block_tables, seq_lens):
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            seq_lens, layer)
    B, H, D = q.shape
    _check_pools(k_pool, v_pool, layer)
    L, P, ps, GD = k_pool.shape
    Hkv = GD // D
    _check_heads(H, Hkv, D)
    if Hkv * D != GD:
        raise ValueError(f"pool GD={GD} != H_kv*D for D={D}")
    MP = block_tables.shape[1] if block_tables.dim() == 2 else -1
    _check(q, "q", torch.bfloat16, (B, H, D), align=8)
    _check(block_tables, "block_tables", torch.int32, (B, MP))
    _check(seq_lens, "seq_lens", torch.int32, (B,))
    n_splits = fused_decode_splits(MP, ps)
    ws, counters = split_workspace("paged_decode_attention", q.device, B, Hkv,
                                   H // Hkv, D, n_splits)
    out = torch.empty_like(q)
    rc = _fn("paged_decode", "llmq_paged_decode")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), B, H, Hkv, D, layer, P, ps, MP,
        n_splits, D ** -0.5, _stream(q))
    _raise_on(rc, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 seq_lens: torch.Tensor,
                                 layer: int = 0) -> torch.Tensor:
    """Plain twin of :func:`paged_decode_attention`: the pooled gather
    and softmax (``ops/attention.paged_decode_attention_pooled``), with
    zeros for an empty row as the kernel gives."""
    from llmq_tpu_torch.ops.attention import paged_decode_attention_pooled

    if k_pool.dim() == 3:
        k_pool, v_pool = k_pool[None], v_pool[None]
    S = block_tables.shape[1] * k_pool.shape[2]
    out = paged_decode_attention_pooled(q, k_pool, v_pool, block_tables,
                                        seq_lens.clamp(max=S), layer)
    return torch.where((seq_lens > 0)[:, None, None], out,
                       torch.zeros_like(out))
