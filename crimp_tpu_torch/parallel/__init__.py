"""The port's parallel layer: device meshes and the sharded twins
(``mesh``), the sharding registry (``registry``) and multi-process
bring-up on torch.distributed (``multihost``)."""

from crimp_tpu_torch.parallel.mesh import build_mesh, h_sharded, z2_sharded

__all__ = ["build_mesh", "z2_sharded", "h_sharded"]
