"""Device meshes (JAX parallel/): data-parallel training and validation
over a torch.distributed group (`mesh.py`), and a mesh over one process's
devices for row-sharded inference (`spatial.py`) and serving
(`engine/server.py`). Training over a spatial axis is ROADMAP A12i-c."""

from .mesh import (GROUP_TIMEOUT, Mesh, init_from_env, make_mesh, replicate,
                   shard_batch)
from .spatial import spatial_infer, spatial_pad_to

__all__ = ["GROUP_TIMEOUT", "Mesh", "init_from_env", "make_mesh",
           "replicate", "shard_batch", "spatial_infer", "spatial_pad_to"]
