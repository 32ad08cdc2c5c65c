"""Paged continuous-batching executor over ``models/llama.py`` (the
port's counterpart of ``JaxExecutor`` in ``llmq_tpu/engine/executor.py``,
serving one device in bf16).

The engine schedules against :class:`ExecutorSpec` and calls the
:class:`Executor` protocol: ``prefill`` (bucketed chunks over one block
table), ``decode`` (one step for every slot), ``decode_chunk`` (up to
``chunk_size`` steps with sampling, EOS and budget latches kept on the
device), ``release_slot`` and ``resume``.

The KV pool is one ``(L, P, page_size, GD)`` tensor pair updated **in
place** by every program — the port's counterpart of JAX's buffer
donation: the working set stays one pool plus transient activations.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Protocol

import numpy as np
import torch

from llmq_tpu_torch.core.config import resolve_device
from llmq_tpu_torch.models.llama import Llama, LlamaConfig, init_kv_pages
from llmq_tpu_torch.ops.sampling import sample_token


@dataclass(frozen=True)
class ExecutorSpec:
    """Geometry the engine schedules against."""

    batch_size: int          # decode slots
    page_size: int           # tokens per KV page
    num_pages: int           # total pool pages (page 0 reserved)
    max_pages_per_seq: int   # block-table width
    eos_id: int


class Executor(Protocol):
    spec: ExecutorSpec
    #: Tokens produced per decode_chunk call (1 → engine single-steps).
    chunk_size: int
    #: Measured wall milliseconds per decode step (None until measured).
    step_ms: Optional[float]

    def prefill(self, tokens: List[int], start_pos: int,
                block_table: np.ndarray, temperature: float,
                slot: int) -> int:
        """Write ``tokens``' KV at absolute positions
        ``[start_pos, start_pos+len)`` through ``block_table`` and return
        the first sampled next token."""
        ...

    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               block_tables: np.ndarray,
               temperatures: np.ndarray) -> np.ndarray:
        """One batched decode step over full-batch arrays; returns (B,)
        next tokens (inactive slots' rows point at page 0 and their
        outputs are ignored)."""
        ...

    def decode_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: np.ndarray, temperatures: np.ndarray,
                     budgets: np.ndarray) -> np.ndarray:
        """Up to ``chunk_size`` decode steps; per row identical to that
        many ``decode`` calls. A row latches on EOS (for good) or when its
        ``budgets[b]`` steps are spent (this chunk only); latched rows
        emit EOS and write KV to page 0. Returns (B, chunk_size)."""
        ...

    def release_slot(self, slot: int) -> None:
        ...

    def resume(self, slot: int, tokens: List[int], start_pos: int) -> None:
        ...


class TorchExecutor:
    """Serves ``model_cfg`` with ``params`` (the JAX tree layout, see
    ``models/llama.py``, already on ``device``) on ``device``. One prefill program per length
    bucket: prompts longer than the largest bucket stream through it in
    chunks over the same block table. Decoding runs B slots of a fixed
    (B, max_pages) geometry."""

    def __init__(self, model_cfg: LlamaConfig, params, *,
                 batch_size: int = 8, page_size: int = 16,
                 num_pages: int = 512,
                 prefill_buckets: Optional[List[int]] = None,
                 top_k: int = 0, top_p: float = 1.0, eos_id: int = 2,
                 seed: int = 0, chunk_size: int = 16,
                 fused_decode: bool = True,
                 device: str = "cuda") -> None:
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.model = Llama(model_cfg, params)
        self.spec = ExecutorSpec(batch_size, page_size, num_pages,
                                 max(1, model_cfg.max_seq_len // page_size),
                                 eos_id)
        self.chunk_size = max(1, chunk_size)
        self.prefill_buckets = sorted(prefill_buckets or [32, 128, 512])
        self._top_k = top_k
        self._top_p = top_p
        #: Decode route: fused write+attention kernel, or the split
        #: write kernel + pooled attention (ops/attention.py).
        self.fused_decode = fused_decode
        self.cache = init_kv_pages(model_cfg, num_pages, page_size,
                                   self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        #: Wall milliseconds per decode step, host loop and readback
        #: included: a moving average over the decode calls after the
        #: first (which pays the kernels' build). None until measured; the
        #: engine sizes its realtime admission cap from it.
        self.step_ms: Optional[float] = None
        self._decode_calls = 0

    # -- helpers -------------------------------------------------------------

    def _t(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _time_steps(self, t0: float, steps: int) -> None:
        self._decode_calls += 1
        if self._decode_calls == 1 or steps <= 0:
            return
        ms = (time.perf_counter() - t0) * 1e3 / steps
        self.step_ms = (ms if self.step_ms is None
                        else 0.8 * self.step_ms + 0.2 * ms)

    def _sample(self, logits: torch.Tensor, temperatures) -> torch.Tensor:
        temps = self._t(temperatures, torch.float32)
        return sample_token(logits, self._gen, temperature=temps,
                            top_k=self._top_k, top_p=self._top_p)

    # -- Executor API --------------------------------------------------------

    @torch.inference_mode()
    def _prefill_chunk(self, chunk: List[int], start_pos: int,
                       bt: torch.Tensor, temperature: float) -> torch.Tensor:
        """Run ONE bucketed prefill chunk: pad to the bucket, clamp the
        padding positions, write KV in place. Returns the sampled next
        token as a (1,) device tensor (no host sync)."""
        T = self._bucket_for(len(chunk))
        n = len(chunk)
        padded = np.zeros((1, T), np.int32)
        padded[0, :n] = chunk
        positions = np.minimum(np.arange(T, dtype=np.int32) + start_pos,
                               start_pos + n - 1)[None, :]
        logits = self.model.forward_prefill(
            self._t(padded, torch.int32), self._t(positions, torch.int32),
            self._t([n], torch.int32), self.cache, bt)
        return self._sample(logits[:, n - 1], [temperature])

    def prefill(self, tokens: List[int], start_pos: int,
                block_table: np.ndarray, temperature: float,
                slot: int) -> int:
        bt = self._t(block_table, torch.int32).reshape(1, -1)
        pos = start_pos
        remaining = list(tokens)
        tok = None
        while remaining:
            chunk = remaining[: self.prefill_buckets[-1]]
            remaining = remaining[len(chunk):]
            tok = self._prefill_chunk(chunk, pos, bt, temperature)
            pos += len(chunk)
        if tok is None:
            return self.spec.eos_id
        return int(tok.item())

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               block_tables: np.ndarray,
               temperatures: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        logits = self.model.forward_decode(
            self._t(tokens, torch.int32), self._t(positions, torch.int32),
            self.cache, self._t(block_tables, torch.int32),
            fused=self.fused_decode)
        out = self._sample(logits, temperatures).cpu().numpy()
        self._time_steps(t0, 1)
        return out

    @torch.inference_mode()
    def decode_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: np.ndarray, temperatures: np.ndarray,
                     budgets: np.ndarray) -> np.ndarray:
        """Up to K decode steps with the JAX program's semantics: ``out``
        is EOS-padded (B, K); the EOS latch is persistent, the budget
        pause is this chunk's only; a paused row keeps its last real
        token; the loop ends once every row is latched or out of budget.

        The exit test reads the previous step's flag after the next step
        is queued, so the device never waits on the host; the one extra
        step that can run has every row inactive (writes go to page 0,
        outputs stay EOS)."""
        t0 = time.perf_counter()
        K = self.chunk_size
        eos = self.spec.eos_id
        B = len(tokens)
        tok = self._t(tokens, torch.int32)
        pos = self._t(positions, torch.int32)
        bt = self._t(block_tables, torch.int32)
        temps = self._t(temperatures, torch.float32)
        budgets_t = self._t(budgets, torch.int32)
        out = torch.full((B, K), eos, dtype=torch.int32, device=self.device)
        frozen = torch.zeros(B, dtype=torch.bool, device=self.device)
        steps = min(K, int(np.max(budgets)) if len(budgets) else 0)
        left_prev = None
        ran = 0
        for j in range(steps):
            active = (~frozen) & (j < budgets_t)
            logits = self.model.forward_decode(
                tok, pos, self.cache, bt, active, fused=self.fused_decode)
            nxt = sample_token(logits, self._gen, temperature=temps,
                               top_k=self._top_k, top_p=self._top_p)
            out[:, j] = torch.where(active, nxt, torch.full_like(nxt, eos))
            tok = torch.where(active, nxt, tok)
            pos = pos + active.to(torch.int32)
            frozen = frozen | (active & (nxt == eos))
            ran += 1
            left = ((~frozen) & (j + 1 < budgets_t)).any()
            if left_prev is not None and not bool(left_prev):
                break
            left_prev = left
        result = out.cpu().numpy()
        self._time_steps(t0, ran)
        return result

    def release_slot(self, slot: int) -> None:
        pass  # no per-slot state: block tables carry everything

    def resume(self, slot: int, tokens: List[int], start_pos: int) -> None:
        pass

