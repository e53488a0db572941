"""Distribution over ``torch.distributed`` (PyTorch counterpart of
``parallel/``): a (cells, tris) ``DeviceMesh`` of ranks, sharded
``generate_sdf`` (champion all-gather + summed parity), the x-slab-sharded
CPT grid with its halo exchange, and a sharded training step whose vertex
gradient is summed over the world. One process per rank (SPMD): every rank
calls an entry point with the same arguments and gets the whole result.
"""
from .mesh import (
    CELL_AXIS,
    TRI_AXIS,
    cell_sharding,
    initialize_distributed,
    make_sdf_mesh,
    pad_for_axis,
    replicated,
    tri_sharding,
)
from .sharding import (
    generate_grid_sdf_sharded,
    generate_sdf_sharded,
    sharded_fit_step_fn,
    sharded_sdf_fn,
)
from .grid_sharded import generate_grid_sdf_sharded_cpt

__all__ = [
    "CELL_AXIS", "TRI_AXIS", "cell_sharding", "initialize_distributed",
    "make_sdf_mesh", "pad_for_axis", "replicated", "tri_sharding",
    "generate_grid_sdf_sharded", "generate_sdf_sharded",
    "sharded_fit_step_fn", "sharded_sdf_fn", "generate_grid_sdf_sharded_cpt",
]
