"""Rotary position embeddings, Llama-3 convention, split-half layout
(counterpart of ``llmq_tpu/ops/rope.py``): dimensions are rotated as
(x1, x2) pairs split at head_dim/2."""

from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 500000.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (..., T) → (..., T, head_dim//2),
    computed in f32."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = 1.0 / (theta ** exponents)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate q or k: x (..., T, H, D); cos/sin (..., T, D//2),
    broadcast over the head axis."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)
