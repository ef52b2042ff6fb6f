"""Scaling over several cards: worlds of processes and their collectives
(``mesh``, ``multihost``), data-parallel batched 3D inference
(``data_parallel``) and the halo-sharded big slice (``spatial``)."""

from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
from empanada_tpu_torch.parallel.mesh import create_mesh, data_sharding, replicated
from empanada_tpu_torch.parallel.multihost import initialize_multihost, is_multihost
from empanada_tpu_torch.parallel.spatial import SpatialEngine2d, spatial_sharded_forward

__all__ = [
    "MultiChipEngine3d", "create_mesh", "data_sharding", "replicated",
    "initialize_multihost", "is_multihost", "SpatialEngine2d", "spatial_sharded_forward",
]
