"""Rotary position embeddings (``repro.models.rope``): pairs
``(x[2i], x[2i+1])`` rotate by float32 angles."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) float32 inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., T, n_heads, head_dim); positions: (..., T) or (T,).

    Rotates pairs (x[2i], x[2i+1]).  Returns the same shape and dtype.
    """
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)               # (hd/2,)
    angles = positions.float()[..., None] * freqs               # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    xf = x.float()
    x1 = xf[..., 0::2]
    x2 = xf[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)
