"""Device meshes (JAX parallel/): data-parallel training and validation
over a torch.distributed group (`mesh.py`), a mesh over one process's
devices for row-sharded inference (`spatial.py`), serving
(`engine/server.py`) and val, and data x spatial training: the data axis
over the group's ranks, each rank's image rows as slabs over its own
devices (`spatial.py::spatial_train`)."""

from .mesh import (GROUP_TIMEOUT, Mesh, init_from_env, make_mesh, replicate,
                   shard_batch)
from .spatial import spatial_infer, spatial_pad_to, spatial_train

__all__ = ["GROUP_TIMEOUT", "Mesh", "init_from_env", "make_mesh",
           "replicate", "shard_batch", "spatial_infer", "spatial_pad_to",
           "spatial_train"]
