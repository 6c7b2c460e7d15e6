"""Normalization ops (counterpart of gofr_tpu/ops/norms.py).

RMSNorm in the Gemma convention: the learned scale is stored zero-centered
and applied as (1 + scale), and the variance is computed in float32 even
for bfloat16 activations; the result is cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x / rms(x) * (1 + scale), computed in f32, cast back to x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * (1.0 + scale.float())).to(x.dtype)
