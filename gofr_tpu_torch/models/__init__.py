"""gofr_tpu_torch.models — counterpart of gofr_tpu.models (transformer, the
MNIST-class MLP in ``mlp``, the mixture-of-experts FFN and its training
forward in ``moe``, int8 weight quantization; ``checkpoint`` and
``tokenizer`` load from disk, and ``checkpoint`` saves a training state)."""

from .mlp import MLPConfig, mlp_forward, mlp_init, mlp_params_from_jax
from .quant import QTensor, init_params_quantized, is_quantized, qmm, qmm_a8, quantize, quantize_params
from .transformer import (
    KVCache,
    TransformerConfig,
    decode_chunk,
    decode_chunk_paged,
    init_params,
    param_specs,
    params_from_jax,
    prefill,
    prefill_append,
    train_forward,
    transformer_forward,
    verify_chunk,
)

__all__ = [
    "KVCache",
    "MLPConfig",
    "QTensor",
    "TransformerConfig",
    "decode_chunk",
    "decode_chunk_paged",
    "init_params",
    "init_params_quantized",
    "is_quantized",
    "mlp_forward",
    "mlp_init",
    "mlp_params_from_jax",
    "param_specs",
    "params_from_jax",
    "prefill",
    "prefill_append",
    "qmm",
    "qmm_a8",
    "quantize",
    "quantize_params",
    "transformer_forward",
    "verify_chunk",
]
