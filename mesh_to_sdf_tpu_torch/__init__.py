"""mesh_to_sdf_tpu_torch — the PyTorch/CUDA port of ``mesh_to_sdf_tpu``.

Signed distance fields of triangle meshes, with the JAX package's API and
array layouts, running on NVIDIA Hopper through kernels written by hand in
CUDA C++ (``csrc/``). CPU tensors take each kernel's plain PyTorch version.
Ported so far: ``generate_sdf`` (PALLAS, XLA and CULLED strategies) and
``generate_grid_sdf`` (CPT, PALLAS, XLA and CULLED routes, ``exact=True``),
each with both sign methods (see README.md, "PyTorch/CUDA port"). The entry
points run on CUDA unless given CPU tensors or ``device="cpu"``.
"""
from .grid import Grid
from .gridgen import generate_grid_sdf
from .ops.keyed import compare_distances
from .query import generate_sdf
from .topology import Topology, as_points
from .types import F32_MAX, AccelerationMethod, SignMethod, Strategy

__version__ = "0.1.0"

__all__ = [
    "Grid",
    "Topology",
    "AccelerationMethod",
    "SignMethod",
    "Strategy",
    "F32_MAX",
    "generate_sdf",
    "generate_grid_sdf",
    "compare_distances",
    "as_points",
    "__version__",
]
