"""Token sampling: greedy, temperature, top-k, top-p — batched and
static-shape (counterpart of ``llmq_tpu/ops/sampling.py``).

Draws come from an explicit ``torch.Generator`` on the logits' device;
they are not JAX's threefry stream, so only greedy rows compare across
the two packages. No value goes from the host to the device here (the
temperature comes as a device tensor or as a fill), so the executor's
decode step captures the sampler, ``torch.multinomial`` included, into
its CUDA graph; the generator is registered with that graph.

The speculation plane samples with :func:`sample_token_keyed` instead: a
row's draw is a function of (base seed, batch row, absolute position)
and the filtered logits only, through a counter-based hash computed on
the device (no generator, no host value), so the committed stream does
not depend on how steps were cut into windows."""

from __future__ import annotations

from typing import Tuple, Union

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) → (B,) argmax token ids (first index on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _filter_logits(logits: torch.Tensor,
                   temperature: Union[torch.Tensor, float],
                   top_k: int, top_p: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared temperature / top-k / top-p filtering. Returns
    (t (B,), lf (B, V) f32, scaled (B, V) filtered logits)."""
    B, V = logits.shape
    if isinstance(temperature, torch.Tensor):
        if temperature.device != logits.device:
            raise ValueError(f"temperature on {temperature.device}, logits "
                             f"on {logits.device}")
        t = temperature.to(torch.float32).expand(B)
    else:
        # A fill on the device: no host-to-device copy.
        t = torch.full((B,), float(temperature), dtype=torch.float32,
                       device=logits.device)
    lf = logits.float()
    scaled = lf / torch.clamp(t[:, None], min=1e-6)
    neg_inf = float("-inf")
    if top_k and top_k < V:
        kth = torch.sort(scaled, dim=-1).values[:, V - top_k][:, None]
        scaled = torch.where(scaled < kth, neg_inf, scaled)
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep tokens until cumulative prob exceeds top_p (always ≥ 1).
        cutoff_idx = torch.sum(cum < top_p, dim=-1)
        cutoff_logit = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        scaled = torch.where(scaled < cutoff_logit, neg_inf, scaled)
    return t, lf, scaled


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature: Union[torch.Tensor, float] = 1.0,
                 top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Temperature / top-k / top-p sampling; rows with
    ``temperature <= 0`` are greedy. Returns (B,) int32."""
    t, lf, scaled = _filter_logits(logits, temperature, top_k, top_p)
    probs = torch.softmax(scaled, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(t <= 0.0, greedy(lf), sampled.to(torch.int32))


#: Odd multipliers below 2**31 of the 32-bit hash below: every product
#: of a 32-bit value and one of them fits an int64 without overflow.
_MUL1 = 0x7FEB352D
_MUL2 = 0x5BD1E995
_MASK32 = 0xFFFFFFFF
#: The golden-ratio increment that spreads vocabulary indices apart.
_GOLDEN = 0x9E3779B9


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) of int64 ``x``
    holding values in [0, 2**32); returns the same range. Right shifts
    of non-negative values are logical, and every product stays below
    2**63, so the CPU and the card compute the same bits."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _MASK32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _MASK32
    return x ^ (x >> 16)


def keyed_uniform(seed: int, rows: torch.Tensor, positions: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """(N, vocab) f32 uniforms in (0, 1): entry (i, v) hashes (``seed``,
    ``rows[i]``, ``positions[i]``, v) and nothing else. The counterpart
    of the JAX package's ``position_keys`` (``fold_in(fold_in(base,
    row), position)``); its bits are not threefry's."""
    r = rows.to(torch.int64) & _MASK32
    p = positions.to(torch.int64) & _MASK32
    key = _mix32(_mix32(_mix32(torch.full_like(r, seed & _MASK32)) ^ r) ^ p)
    v = torch.arange(vocab, dtype=torch.int64, device=rows.device)
    vh = _mix32((v * _GOLDEN) & _MASK32)
    h = _mix32(_mix32(key[:, None] ^ vh[None, :]) ^ key[:, None])
    # The top 24 bits, centred in their cell: never 0, never 1.
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_token_keyed(logits: torch.Tensor, seed: int, rows: torch.Tensor,
                       positions: torch.Tensor,
                       temperature: Union[torch.Tensor, float] = 1.0,
                       top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """``sample_token`` with a draw keyed by (``seed``, row, position)
    (the JAX package's ``sample_token_keyed`` over ``position_keys``):
    the same temperature / top-k / top-p filtering, then the Gumbel-max
    draw ``argmax(scaled + gumbel)`` with the Gumbel noise from
    :func:`keyed_uniform`, a categorical draw from ``softmax(scaled)``.
    Rows with ``temperature <= 0`` are greedy. ``rows`` and
    ``positions``: (B,) integer tensors on the logits' device (the
    speculation plane passes the batch row and the absolute position of
    the sampled token, ``pos + 1``). Returns (B,) int32."""
    t, lf, scaled = _filter_logits(logits, temperature, top_k, top_p)
    u = keyed_uniform(seed, rows, positions, scaled.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(t <= 0.0, greedy(lf), sampled)
