"""Line-lattice helpers of the grid raycast sign (PyTorch counterpart of
``ops/raycast.py``).

One +axis ray starts at the center of each index-0 cell along ``axis``
(`mesh_to_sdf/src/generate/grid.rs:648-684`). The exact dense parity engine
(``grid_inside_mask``) is not ported yet; the grid path signs through the
binned line-parity kernel (``ops.kernels.parity``).
"""
from __future__ import annotations

import torch

from ..grid import Grid


def face_origins(grid: Grid, axis: int, device=None):
    """Ray origins ((L, 3), rows of the transverse lattice in C order) and
    the transverse layout shape: (ny, nz), (nx, nz) or (nx, ny)."""
    coords = [grid.axis_centers(k, device) for k in range(3)]
    coords[axis] = coords[axis][:1]
    pts = torch.stack(torch.meshgrid(*coords, indexing="ij"), dim=-1)
    lshape = tuple(n for k, n in enumerate(grid.cell_count) if k != axis)
    return pts.reshape(-1, 3), lshape


def unrotate_axis(arr: torch.Tensor, axis: int, lshape, n: int):
    """(L, n) per-line values back into (nx, ny, nz)."""
    a = arr.reshape(tuple(lshape) + (n,))
    if axis == 0:
        return a.permute(2, 0, 1)
    if axis == 1:
        return a.permute(0, 2, 1)
    return a
