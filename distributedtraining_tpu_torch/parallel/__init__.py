"""The mesh plane of the port: a ``(dp, fsdp, sp, tp)`` mesh over
``torch.distributed`` (one process per device), placements of the GPT-2
parameters and batches on it, and the differentiable collectives of the
training step. The port of the JAX package's ``parallel/``."""

from . import collectives, multihost, sharding
from .mesh import (AXES, Mesh, MeshConfig, best_mesh_shape,
                   resolve_mesh_config)
from .sharding import (DEFAULT_RULES, batch_rows, gather_params,
                       param_specs, shard_params)

__all__ = [
    "collectives", "multihost", "sharding",
    "AXES", "Mesh", "MeshConfig", "best_mesh_shape", "resolve_mesh_config",
    "DEFAULT_RULES", "batch_rows", "gather_params", "param_specs",
    "shard_params",
]
