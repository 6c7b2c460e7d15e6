"""gofr_tpu_torch.models — counterpart of gofr_tpu.models (transformer and
int8 weight quantization)."""

from .quant import QTensor, init_params_quantized, is_quantized, qmm, qmm_a8, quantize, quantize_params
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
    "QTensor",
    "TransformerConfig",
    "decode_chunk_paged",
    "init_params",
    "init_params_quantized",
    "is_quantized",
    "params_from_jax",
    "prefill_append",
    "qmm",
    "qmm_a8",
    "quantize",
    "quantize_params",
    "transformer_forward",
]
