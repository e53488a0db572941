"""Isosurface extraction by ordered cell indices + voxel/point-cloud views.

PyTorch counterpart of the JAX package's ``render/isosurface.py`` (the
client's `Sdf` GPU wrapper, `mesh_to_sdf_client/src/sdf.rs`):
- `ordered_indices` (`sdf.rs:63-68`): cell indices sorted by distance, so any
  iso-band is a contiguous slice (a stable sort, as ``jnp.argsort``);
- the voxel pass slices `ordered_indices[from..to]` with a binary search
  around `iso ± cell_width` (`passes/voxel_render_pass.rs:280-310`);
- `iso_limits = (min, max)` over the data (`sdf.rs:123`), bounding the UI's
  iso slider (`ui.rs:501-650`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..grid import Grid
from .image import host_array


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x, np.float32))


def ordered_indices(distances) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort flat cell indices by distance (`sdf.rs:63-68`).

    Returns (order (N,) int32, sorted_distances (N,) f32), on the device of
    ``distances``.
    """
    flat = _tensor(distances).reshape(-1)
    order = torch.argsort(flat, stable=True)
    return order.to(torch.int32), flat[order]


def iso_limits(distances) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) distance — the UI's iso slider bounds (`sdf.rs:123`)."""
    flat = _tensor(distances).reshape(-1)
    return flat.amin(), flat.amax()


def voxel_band(sorted_distances, iso: float, cell_width: float):
    """(lo, hi) slice bounds of the iso band in the ordered list — the voxel
    pass's binary search (`voxel_render_pass.rs:280-310`): cells whose
    distance lies in [iso - cell_width, iso + cell_width]."""
    sd = _tensor(sorted_distances)

    def at(x):  # the bound rounded to float32, as JAX's weak-typed scalar
        return torch.tensor(x, dtype=sd.dtype, device=sd.device)

    lo = torch.searchsorted(sd, at(iso - cell_width), side="left")
    hi = torch.searchsorted(sd, at(iso + cell_width), side="right")
    return lo, hi


def surface_cells(grid: Grid, distances, iso: float = 0.0,
                  width_scale: float = 1.0) -> np.ndarray:
    """Integer coords (K, 3) int32 of cells within one cell-width of the iso
    level — what the voxel pass instances as cubes."""
    d = host_array(distances).reshape(-1)
    cell_width = float(np.max(np.abs(grid.cell_size.numpy()))) * width_scale
    order = np.argsort(d)
    sd = d[order]
    lo = np.searchsorted(sd, iso - cell_width, side="left")
    hi = np.searchsorted(sd, iso + cell_width, side="right")
    idx = order[lo:hi]
    return grid.cell_coordinates(torch.from_numpy(idx)).numpy().astype(
        np.int32)


def point_cloud(grid: Grid, distances, iso: float = 0.0,
                width_scale: float = 1.0) -> np.ndarray:
    """World-space centers (K, 3) of the iso-band cells — the point-cloud
    render mode's data (`sdf_render_pass.rs`)."""
    cells = surface_cells(grid, distances, iso, width_scale)
    return grid.cell_center(torch.from_numpy(cells)).numpy()
