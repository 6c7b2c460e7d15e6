"""gofr_tpu_torch.parallel — meshes and the training step (counterpart of
gofr_tpu.parallel, the single-card part).

Ported: ``make_mesh`` / ``mesh_shape_for`` (``mesh``) and ``lm_loss``,
``make_train_step`` and ``place_batch`` (``train``), which run on a mesh
whose every axis is 1 and refuse a larger one. The JAX package's other
names (tensor-parallel specs and sharding, ring attention, the pipeline,
multi-host start-up) are ROADMAP ID 11.
"""

from .mesh import Mesh, make_mesh, mesh_shape_for
from .train import AdamW, lm_loss, make_train_step, next_token_loss, place_batch, value_and_grad

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "make_train_step",
    "place_batch",
    "lm_loss",
]
