"""MNIST-class MLP (counterpart of gofr_tpu/models/mlp.py): the plain-model
path's model, served through ``GPURuntime.register_model``.

``mlp_forward`` is two matrix products and a bias a layer with the tanh
GELU between layers: ``jax.nn.gelu`` defaults to the tanh approximation,
so the exact (erf) form would be a divergence, not rounding. The products
are plain ``torch.matmul``, as the JAX function's are XLA dots outside any
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: tuple[int, ...] = (512, 256)
    out_dim: int = 10
    dtype: torch.dtype = torch.bfloat16


def mlp_init(generator: torch.Generator, cfg: MLPConfig, device=None) -> dict:
    """Weights w{i} [d_in, d_out] drawn from ``generator`` (a CPU
    ``torch.Generator``) as float32 normals / sqrt(d_in), then cast to
    ``cfg.dtype``; biases b{i} zero. The same leaves and scales as JAX's
    ``mlp_init``, from another RNG stream."""
    dev = resolve_device(device)
    dims = (cfg.in_dim, *cfg.hidden, cfg.out_dim)
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32) / math.sqrt(d_in)
        params[f"w{i}"] = w.to(device=dev, dtype=cfg.dtype)
        params[f"b{i}"] = torch.zeros((d_out,), dtype=cfg.dtype, device=dev)
    return params


def mlp_params_from_jax(np_tree: dict, cfg: MLPConfig, device=None) -> dict:
    """The JAX ``mlp_init`` tree mapped to numpy (``jax.tree.map(np.asarray,
    params)``) as the port's parameters on ``device``, in ``cfg.dtype``
    (bfloat16 leaves pass through float32, which is exact), keys in the
    JAX order."""
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device=dev, dtype=cfg.dtype)
        for k, v in np_tree.items()
    }


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [batch, in_dim] -> logits [batch, out_dim] in float32. The input
    is cast to the first leaf's dtype and every layer runs in it."""
    n_layers = len(params) // 2
    h = x.to(next(iter(params.values())).dtype)
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = F.gelu(h, approximate="tanh")
    return h.float()
