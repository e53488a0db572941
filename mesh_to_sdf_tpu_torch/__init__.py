"""mesh_to_sdf_tpu_torch — the PyTorch/CUDA port of ``mesh_to_sdf_tpu``.

Signed distance fields of triangle meshes on regular grids, with the JAX
package's API and array layouts, running on NVIDIA Hopper through kernels
written by hand in CUDA C++ (``csrc/``). CPU tensors take each kernel's plain
PyTorch version. Ported so far: ``generate_grid_sdf`` with the raycast sign
through the CPT route (see README.md, "PyTorch/CUDA port").
"""
from .grid import Grid
from .gridgen import generate_grid_sdf
from .topology import Topology
from .types import F32_MAX, AccelerationMethod, SignMethod, Strategy

__all__ = [
    "Grid",
    "Topology",
    "AccelerationMethod",
    "SignMethod",
    "Strategy",
    "F32_MAX",
    "generate_grid_sdf",
]
