"""Paged continuous-batching executor over ``models/llama.py`` (the
port's counterpart of ``JaxExecutor`` in ``llmq_tpu/engine/executor.py``,
serving one device in bf16).

The engine schedules against :class:`ExecutorSpec` and calls the
:class:`Executor` protocol: ``prefill`` (bucketed chunks over one block
table), ``decode`` (one step for every slot), ``decode_chunk`` (up to
``chunk_size`` steps with sampling, EOS and budget latches kept on the
device), ``release_slot`` and ``resume``; with a mixed geometry also
``mixed_chunk`` (a decode chunk whose first step carries budgeted
prefill slices).

Mixed geometry: ``mixed_prefill_slices`` (S) slices of up to
``mixed_slice_tokens`` (T) tokens each. With ``ragged_attention`` the
slices pack into one token buffer instead (T is then the buffer's live
capacity, which one slice may take whole), and ALL prefill, ``prefill``
included, runs through that ragged step with the decode rows frozen.

The KV pool is one ``(L, P, page_size, GD)`` tensor pair updated **in
place** by every program — the port's counterpart of JAX's buffer
donation: the working set stays one pool plus transient activations.
With ``cache_dtype=torch.int8`` the pair is int8 and two bf16 scale
pools ``(L, P, H_kv, page_size)`` ride beside it through every program
(the int8 routes of ``ops/attention.py``); weights may be w8a8 leaves
(``ops/quant.py``) either way.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Protocol

import numpy as np
import torch

from llmq_tpu_torch.core.config import resolve_device
from llmq_tpu_torch.models.llama import Llama, LlamaConfig, init_kv_pages
from llmq_tpu_torch.ops.attention import RAGGED_Q_BLOCK
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
                 mixed_prefill_slices: int = 0, mixed_slice_tokens: int = 0,
                 ragged_attention: bool = False,
                 ragged_token_capacity: int = 0, ragged_max_slices: int = 0,
                 cache_dtype: Optional[torch.dtype] = None,
                 device: str = "cuda") -> None:
        if cache_dtype == torch.int8 and not fused_decode:
            # The JAX package's int8-KV decode step has no split route.
            raise ValueError("fused_decode=False has no int8-KV route: the "
                             "int8 decode step is the fused kernel only")
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
        #: row-write kernel + decode-attention kernel (ops/attention.py).
        self.fused_decode = fused_decode
        #: Mixed geometry: S slices × T tokens (0 → no mixed_chunk).
        self.mixed_prefill_slices = max(0, mixed_prefill_slices)
        self.mixed_slice_tokens = max(0, mixed_slice_tokens)
        if self.mixed_prefill_slices == 0 or self.mixed_slice_tokens == 0:
            self.mixed_prefill_slices = self.mixed_slice_tokens = 0
        #: Ragged mode: the engine packs against (S slices, T = capacity
        #: tokens in all); the packed buffer holds the capacity plus one
        #: partial q-block per slice, rounded up to the q-block.
        self.ragged_attention = bool(ragged_attention)
        self.ragged_buffer = 0
        if self.ragged_attention:
            S = max(1, ragged_max_slices or self.mixed_prefill_slices or 2)
            cap = max(RAGGED_Q_BLOCK, ragged_token_capacity
                      or self.mixed_prefill_slices * self.mixed_slice_tokens
                      or 128)
            self.mixed_prefill_slices = S
            self.mixed_slice_tokens = cap
            need = cap + S * (RAGGED_Q_BLOCK - 1)
            self.ragged_buffer = -(-need // RAGGED_Q_BLOCK) * RAGGED_Q_BLOCK
        self.cache = init_kv_pages(model_cfg, num_pages, page_size,
                                   self.device, dtype=cache_dtype)
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
        if self.ragged_attention:
            return self._ragged_prefill(tokens, start_pos, block_table,
                                        temperature)
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
        st = self._chunk_state(tokens, positions, block_tables,
                               temperatures, budgets)
        steps = min(self.chunk_size,
                    int(np.max(budgets)) if len(budgets) else 0)
        ran = self._decode_steps(st, 0, steps, None)
        result = st["out"].cpu().numpy()
        self._time_steps(t0, ran)
        return result

    @torch.inference_mode()
    def mixed_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                    block_tables: np.ndarray, temperatures: np.ndarray,
                    budgets: np.ndarray, pf: List) -> tuple:
        """A decode chunk whose step 0 also runs prefill slices: the
        mixed forward (bucket: ``forward_mixed``; ragged:
        ``forward_mixed_ragged``) advances the decode rows one token and
        writes each slice's K/V, then steps 1..K-1 are ``decode_chunk``'s
        body with its latch semantics. ``pf``: ``(slot, tokens,
        start_pos, block_table, temperature)`` per slice, at most
        ``mixed_prefill_slices`` of them, each at most
        ``mixed_slice_tokens`` tokens (ragged: all of them together).
        Returns ``(out (B, K), pf_first (len(pf),))``; ``pf_first[i]``
        is sampled at slice i's last token, the first generated token
        when the slice ends its prompt."""
        if self.mixed_prefill_slices <= 0:
            raise RuntimeError("mixed batching disabled for this executor")
        t0 = time.perf_counter()
        st = self._chunk_state(tokens, positions, block_tables,
                               temperatures, budgets)
        active = st["budgets"] > 0
        dec_logits, pf_logits = self._mixed_forward(
            st["tok"], st["pos"], st["bt"], active, pf)
        pf_first = self._sample(pf_logits, [p[4] for p in pf])
        self._advance(st, 0, active, dec_logits)
        steps = min(self.chunk_size,
                    int(np.max(budgets)) if len(budgets) else 0)
        left = ((~st["frozen"]) & (1 < st["budgets"])).any()
        ran = 1 + self._decode_steps(st, 1, steps, left)
        result = st["out"].cpu().numpy(), pf_first.cpu().numpy()
        self._time_steps(t0, ran)
        return result

    # -- chunk internals -----------------------------------------------------

    def _chunk_state(self, tokens, positions, block_tables, temperatures,
                     budgets) -> dict:
        """A chunk's device carry: the inputs, the EOS-padded output and
        the EOS latch."""
        B = len(tokens)
        return {"tok": self._t(tokens, torch.int32),
                "pos": self._t(positions, torch.int32),
                "bt": self._t(block_tables, torch.int32),
                "temps": self._t(temperatures, torch.float32),
                "budgets": self._t(budgets, torch.int32),
                "out": torch.full((B, self.chunk_size), self.spec.eos_id,
                                  dtype=torch.int32, device=self.device),
                "frozen": torch.zeros(B, dtype=torch.bool,
                                      device=self.device)}

    def _advance(self, st: dict, j: int, active: torch.Tensor,
                 logits: torch.Tensor) -> None:
        """Sample step j and update the carry: inactive rows emit EOS and
        keep their token; an EOS latches its row."""
        eos = self.spec.eos_id
        nxt = sample_token(logits, self._gen, temperature=st["temps"],
                           top_k=self._top_k, top_p=self._top_p)
        st["out"][:, j] = torch.where(active, nxt, torch.full_like(nxt, eos))
        st["tok"] = torch.where(active, nxt, st["tok"])
        st["pos"] = st["pos"] + active.to(torch.int32)
        st["frozen"] = st["frozen"] | (active & (nxt == eos))

    def _decode_steps(self, st: dict, first: int, steps: int,
                      left_prev) -> int:
        """Decode steps ``first..steps-1``; returns how many ran. The exit
        test reads the previous step's "any row left" flag after the
        next step is queued (``left_prev``: that flag for step
        ``first``, None to run it unconditionally)."""
        ran = 0
        for j in range(first, steps):
            active = (~st["frozen"]) & (j < st["budgets"])
            logits = self.model.forward_decode(
                st["tok"], st["pos"], self.cache, st["bt"], active,
                fused=self.fused_decode)
            self._advance(st, j, active, logits)
            ran += 1
            left = ((~st["frozen"]) & (j + 1 < st["budgets"])).any()
            if left_prev is not None and not bool(left_prev):
                break
            left_prev = left
        return ran

    def _mixed_forward(self, tok, pos, bt, active, pf: List):
        """Step 0 of a mixed chunk: (dec_logits (B, V), slice logits at
        each slice's last token (len(pf), V))."""
        S, T = self.mixed_prefill_slices, self.mixed_slice_tokens
        if not 0 < len(pf) <= S:
            raise ValueError(f"{len(pf)} slices for a geometry of {S}")
        if self.ragged_attention:
            if sum(len(p[1]) for p in pf) > T:
                raise ValueError(f"ragged pack exceeds the capacity {T}")
            return self._ragged_forward(tok, pos, bt, active, pf)
        if any(not 0 < len(p[1]) <= T for p in pf):
            raise ValueError(f"a slice is empty or wider than {T}")
        n = len(pf)
        width = max(len(p[1]) for p in pf)
        toks = np.zeros((n, width), np.int32)
        poss = np.zeros((n, width), np.int32)
        lens = np.zeros(n, np.int32)
        bts = np.zeros((n, self.spec.max_pages_per_seq), np.int32)
        for i, (_slot, t, sp, slice_bt, _temp) in enumerate(pf):
            toks[i, :len(t)] = t
            poss[i] = np.minimum(np.arange(width) + sp, sp + len(t) - 1)
            lens[i] = len(t)
            bts[i] = slice_bt
        dec_logits, pf_logits = self.model.forward_mixed(
            tok, pos, self.cache, bt, self._t(toks, torch.int32),
            self._t(poss, torch.int32), self._t(lens, torch.int32),
            self._t(bts, torch.int32), active, fused=self.fused_decode)
        last = self._t(lens - 1, torch.int64)
        return dec_logits, pf_logits[torch.arange(n, device=self.device),
                                     last]

    def _ragged_forward(self, tok, pos, bt, active, pf: List):
        """Pack the slices into the (N,) buffer, each segment starting on
        a q-block boundary, and run ``forward_mixed_ragged``."""
        N, qblk = self.ragged_buffer, RAGGED_Q_BLOCK
        n = len(pf)
        toks = np.zeros(N, np.int32)
        poss = np.zeros(N, np.int32)
        qoff = np.zeros(n, np.int32)
        qlen = np.zeros(n, np.int32)
        bts = np.zeros((n, self.spec.max_pages_per_seq), np.int32)
        off = 0
        for i, (_slot, t, sp, slice_bt, _temp) in enumerate(pf):
            L = len(t)
            if L == 0 or off + L > N:
                raise ValueError(f"slices do not pack into {N} rows")
            toks[off:off + L] = t
            poss[off:off + L] = np.arange(L) + sp
            qoff[i], qlen[i] = off, L
            bts[i] = slice_bt
            off += -(-L // qblk) * qblk
        return self.model.forward_mixed_ragged(
            tok, pos, self.cache, bt, self._t(toks, torch.int32),
            self._t(poss, torch.int32), self._t(qoff, torch.int32),
            self._t(qlen, torch.int32), self._t(bts, torch.int32), active)

    @torch.inference_mode()
    def _ragged_prefill(self, tokens: List[int], start_pos: int,
                        block_table: np.ndarray, temperature: float) -> int:
        """Prefill through the ragged step with every decode row frozen
        (no bucket program runs in ragged mode). The prompt is cut into
        pieces of at most the capacity; consecutive pieces share a step
        while they fit (all slice writes of a layer precede its attention
        launch, so a later piece sees an earlier one's K/V). Returns the
        token sampled after the last piece."""
        cap, S = self.mixed_slice_tokens, self.mixed_prefill_slices
        qblk, N = RAGGED_Q_BLOCK, self.ragged_buffer
        B, MP = self.spec.batch_size, self.spec.max_pages_per_seq
        pieces = [(list(tokens[o:o + cap]), start_pos + o)
                  for o in range(0, len(tokens), cap)]
        if not pieces:
            return self.spec.eos_id
        zeros = self._t(np.zeros(B, np.int32), torch.int32)
        zbt = self._t(np.zeros((B, MP), np.int32), torch.int32)
        frozen = torch.zeros(B, dtype=torch.bool, device=self.device)
        i = 0
        while i < len(pieces):
            group, live, padded = [], 0, 0
            while i < len(pieces) and len(group) < S:
                n = len(pieces[i][0])
                pad = -(-n // qblk) * qblk
                if group and (live + n > cap or padded + pad > N):
                    break
                group.append(pieces[i])
                live, padded, i = live + n, padded + pad, i + 1
            pf = [(0, chunk, sp, block_table, temperature)
                  for chunk, sp in group]
            _dec, pf_logits = self._ragged_forward(zeros, zeros, zbt, frozen,
                                                   pf)
        return int(self._sample(pf_logits[-1:], [temperature]).item())

    def release_slot(self, slot: int) -> None:
        pass  # no per-slot state: block tables carry everything

    def resume(self, slot: int, tokens: List[int], start_pos: int) -> None:
        pass

