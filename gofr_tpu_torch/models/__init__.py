"""gofr_tpu_torch.models — counterpart of gofr_tpu.models (transformer only)."""

from .transformer import (
    KVCache,
    TransformerConfig,
    decode_chunk_paged,
    init_params,
    params_from_jax,
    prefill_append,
    transformer_forward,
)

__all__ = [
    "KVCache",
    "TransformerConfig",
    "decode_chunk_paged",
    "init_params",
    "params_from_jax",
    "prefill_append",
    "transformer_forward",
]
