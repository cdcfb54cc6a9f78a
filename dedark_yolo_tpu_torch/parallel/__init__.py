"""Data-parallel training and validation over a torch.distributed group
(JAX parallel/): `mesh.py`. The spatial axis (JAX parallel/spatial.py) is
ROADMAP A12i-b."""

from .mesh import (GROUP_TIMEOUT, Mesh, init_from_env, make_mesh, replicate,
                   shard_batch)

__all__ = ["GROUP_TIMEOUT", "Mesh", "init_from_env", "make_mesh",
           "replicate", "shard_batch"]
