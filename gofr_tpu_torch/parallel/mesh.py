"""Device meshes (counterpart of gofr_tpu/parallel/mesh.py).

Axis conventions, as in the JAX package: "data" (data parallelism: the
batch dimension; gradients are summed over it), "model" (tensor
parallelism), "seq" (sequence parallelism). The JAX package builds a
``jax.sharding.Mesh``; the port keeps its own small ``Mesh`` (axis names,
sizes and devices). Only a mesh whose every axis is 1 is run here: the
multi-card paths are ROADMAP ID 11.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["Mesh", "make_mesh", "mesh_shape_for"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over devices: ``axis_names`` and their ``sizes`` in order,
    ``devices`` (``torch.device`` s, row-major over the axes). ``shape`` is
    the {axis: size} dict of JAX's ``Mesh.shape``."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_shape_for(n_devices: int, tp: int | None = None) -> dict[str, int]:
    """Default (data, model) factorization: tensor parallelism across every
    device unless ``tp`` says otherwise (JAX ``mesh_shape_for``)."""
    tp = tp or n_devices
    if n_devices % tp:
        raise ValueError(f"tp={tp} does not divide device count {n_devices}")
    return {"data": n_devices // tp, "model": tp}


def make_mesh(shape: dict[str, int] | None = None, *, devices: list | None = None) -> Mesh:
    """A ``Mesh`` of ``shape`` over ``devices`` (default: one card, ``cuda:0``;
    raises when no GPU is visible). The product of the sizes must equal
    the number of devices (JAX ``make_mesh``)."""
    import torch

    from .. import resolve_device

    if devices is None:
        devices = [resolve_device(None)]
    devices = tuple(resolve_device(d) if not isinstance(d, torch.device) else d for d in devices)
    if shape is None:
        shape = mesh_shape_for(len(devices))
    if math.prod(shape.values()) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    return Mesh(tuple(shape), tuple(int(v) for v in shape.values()), devices)
