"""Token sampling: greedy, temperature, top-k, top-p — batched and
static-shape (counterpart of ``llmq_tpu/ops/sampling.py``).

Draws come from an explicit ``torch.Generator`` on the logits' device;
they are not JAX's threefry stream, so only greedy rows compare across
the two packages. No value goes from the host to the device here (the
temperature comes as a device tensor or as a fill), so the executor's
decode step captures the sampler, ``torch.multinomial`` included, into
its CUDA graph; the generator is registered with that graph."""

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
