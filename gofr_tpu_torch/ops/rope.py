"""Rotary position embeddings (counterpart of gofr_tpu/ops/rope.py).

Position-indexed, so the same code serves prefill (positions = cursor +
arange) and decode (positions = per-sequence length).
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10_000.0, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(
    x: torch.Tensor,  # [batch, seq, heads, head_dim]
    positions: torch.Tensor,  # [batch, seq] int
    theta: float = 10_000.0,
) -> torch.Tensor:
    """Rotate (x[..., :d/2], x[..., d/2:]) by position * freq.

    The "split halves" convention (as the JAX package and Gemma use), not
    interleaved pairs; angles are float32."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # [b, s, d/2]
    angles = angles[:, :, None, :]  # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
