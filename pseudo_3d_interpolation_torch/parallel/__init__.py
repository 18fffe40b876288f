"""Device-mesh parallelism for slice-parallel cube interpolation: the
single-device cube drivers and the 1-D and 2-D meshes of processes over
``torch.distributed``."""

from .mesh import (initialize_distributed, make_mesh, make_mesh_2d,
                   replicated_sharding, slice_sharding)
from .solver import interpolate_cube, pocs_interpolate_sharded

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "initialize_distributed",
    "slice_sharding",
    "replicated_sharding",
    "pocs_interpolate_sharded",
    "interpolate_cube",
]
