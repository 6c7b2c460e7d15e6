"""gofr_tpu_torch.ops — counterpart of gofr_tpu.ops.

Plain PyTorch ops plus the two CUDA kernels that replace the JAX package's
Pallas kernels (``flash_attention`` and ``paged_decode_partials``; sources
in ``gofr_tpu_torch/csrc``, built by ``ops/_build.py`` at first use), and
the flash function with a gradient for training (``flash_attention_train``).
"""

from .attention import (
    NEG_INF,
    chunk_decode_attention,
    chunk_prefill_attention,
    flash_attention,
    flash_attention_backward,
    flash_attention_plain,
    flash_attention_train,
    mha_reference,
    paged_chunk_decode_attention,
    paged_decode_partials,
    paged_decode_partials_plain,
    paged_gather,
    ring_positions,
)
from .norms import rms_norm
from .rope import apply_rope, rope_frequencies

__all__ = [
    "NEG_INF",
    "mha_reference",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_backward",
    "flash_attention_train",
    "chunk_decode_attention",
    "chunk_prefill_attention",
    "paged_chunk_decode_attention",
    "paged_decode_partials",
    "paged_decode_partials_plain",
    "paged_gather",
    "ring_positions",
    "rms_norm",
    "apply_rope",
    "rope_frequencies",
]
