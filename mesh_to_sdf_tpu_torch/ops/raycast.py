"""Grid raycast sign: per-axis line parity (PyTorch counterpart of
``ops/raycast.py``).

One +axis ray starts at the center of each index-0 cell along ``axis``
(`mesh_to_sdf/src/generate/grid.rs:648-684`). :func:`grid_inside_mask` is
the exact engine of the XLA and PALLAS grid routes. The JAX package sorts
hit buckets per line in XLA there; the port counts them with the dense
line-parity kernel (``ops.kernels.parity.line_parity_counts``), whose counts
are exact too.
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


def grid_inside_mask(grid: Grid, tri_a, tri_b, tri_c, tri_valid, *,
                     axes: int = 3) -> torch.Tensor:
    """Boolean (nx, ny, nz) mask, True where the cell is inside the mesh.

    tri_a/tri_b/tri_c: (T, 3) float32; ``tri_valid`` (T,) masks padding.
    ``axes=3``: best-of-3 voting (`grid.rs:622-639`); ``axes=1``: single +X
    parity (`default.rs:34-37`). The JAX engine's ``tri_block`` and
    ``line_chunk`` tile its XLA sort; the kernel tiles itself, so they have
    no counterpart here.
    """
    from .kernels import parity

    keep = tri_valid.to(torch.bool)
    ta, tb, tc = (t[keep].contiguous() for t in (tri_a, tri_b, tri_c))

    def axis_counts(axis, oy, oz, lshape):
        return parity.line_parity_counts(
            oy, oz, grid.first_cell[axis], grid.cell_size[axis],
            parity.rotate_planes(ta, tb, tc, axis),
            n_cells=grid.cell_count[axis])

    inside, _ = parity.vote(grid, axes, ta.device, axis_counts)
    return inside
