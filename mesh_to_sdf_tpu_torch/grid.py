"""Regular 3-D grid of cell centers (PyTorch counterpart of ``grid.py``).

Same contract as the JAX package's ``Grid`` (reference ``Grid``,
`mesh_to_sdf/src/grid.rs:30-173`):
- ``cell_count`` is a static tuple of Python ints;
- ``first_cell`` / ``cell_size`` are float32 tensors of shape (3,). They are
  a handful of floats and live on the host; kernels receive them as
  scalars, and :meth:`all_cell_centers` builds centers on any device;
- the flat cell index is x-major / z-fastest (``idx = z + y*nz + x*ny*nz``,
  `grid.rs:122-124`), the C-order flattening of an ``(nx, ny, nz)`` tensor.

The float32 arithmetic is operation for operation the JAX package's, so the
two produce bit-identical cell centers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    """A float32 host tensor holding a copy of ``x`` (array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.array(x, dtype=np.float32))


@dataclass(frozen=True)
class Grid:
    """A regular grid of cell *centers*.

    ``cell_size`` may differ per axis and may be negative (`grid.rs:25`).
    """

    first_cell: torch.Tensor
    cell_size: torch.Tensor
    cell_count: Tuple[int, int, int] = (1, 1, 1)

    @staticmethod
    def new(first_cell, cell_size, cell_count) -> "Grid":
        """Mirror of ``Grid::new`` (`grid.rs:43-49`)."""
        return Grid(
            first_cell=_f32(first_cell),
            cell_size=_f32(cell_size),
            cell_count=tuple(int(c) for c in cell_count),
        )

    @staticmethod
    def from_bounding_box(bbox_min, bbox_max, cell_count) -> "Grid":
        """Mirror of ``Grid::from_bounding_box`` (`grid.rs:59-74`):
        ``cell_size = (max-min)/count``; first cell center offset half a cell.
        """
        bbox_min = _f32(bbox_min)
        bbox_max = _f32(bbox_max)
        counts = tuple(int(c) for c in cell_count)
        fcount = torch.tensor(counts, dtype=torch.float32)
        cell_size = (bbox_max - bbox_min) / fcount
        first_cell = bbox_min + cell_size * 0.5
        return Grid(first_cell=first_cell, cell_size=cell_size,
                    cell_count=counts)

    @property
    def total_cell_count(self) -> int:
        nx, ny, nz = self.cell_count
        return nx * ny * nz

    def last_cell(self) -> torch.Tensor:
        """Mirror of ``get_last_cell`` (`grid.rs:82-88`): the reference
        multiplies by ``cell_count`` (not ``cell_count - 1``); kept verbatim."""
        counts = torch.tensor(self.cell_count, dtype=torch.float32,
                              device=self.first_cell.device)
        return self.first_cell + counts * self.cell_size

    def bounding_box(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(min, max) corners (`grid.rs:110-119`)."""
        bmin = self.first_cell - self.cell_size * 0.5
        counts = torch.tensor(self.cell_count, dtype=torch.float32,
                              device=bmin.device)
        return bmin, bmin + counts * self.cell_size

    def cell_index(self, cell) -> torch.Tensor:
        """Flattened index, z-fastest (`grid.rs:122-124`)."""
        cell = torch.as_tensor(cell)
        _, ny, nz = self.cell_count
        return cell[..., 2] + cell[..., 1] * nz + cell[..., 0] * ny * nz

    def cell_coordinates(self, idx) -> torch.Tensor:
        """Inverse of :meth:`cell_index` (`grid.rs:127-132`)."""
        idx = torch.as_tensor(idx)
        _, ny, nz = self.cell_count
        z = idx % nz
        y = (idx // nz) % ny
        x = idx // (ny * nz)
        return torch.stack([x, y, z], dim=-1)

    def cell_center(self, cell) -> torch.Tensor:
        """Center of a cell given integer coords (..., 3) (`grid.rs:135-141`),
        on the device of ``cell``."""
        cell = torch.as_tensor(cell, dtype=torch.float32)
        return (self.first_cell.to(cell.device)
                + cell * self.cell_size.to(cell.device))

    def snap_point(self, point) -> Tuple[torch.Tensor, torch.Tensor]:
        """Snap a point to the grid (`grid.rs:145-170`).

        Returns ``(cell, inside)``: the clamped integer cell (..., 3) int32
        and a bool mask (the reference's ``SnapResult::Inside`` /
        ``Outside``), on the device of ``point``.
        """
        point = torch.as_tensor(point, dtype=torch.float32)
        bmin, _ = self.bounding_box()
        bmin = bmin.to(point.device)
        raw = torch.floor(
            (point - bmin) / self.cell_size.to(point.device)).to(torch.int32)
        hi = torch.tensor(self.cell_count, dtype=torch.int32,
                          device=point.device) - 1
        clamped = torch.clamp(raw, min=torch.zeros_like(hi), max=hi)
        inside = torch.all(raw == clamped, dim=-1)
        return clamped, inside

    def axis_centers(self, axis: int, device=None) -> torch.Tensor:
        """Cell-center coordinates along one axis, shape (n,)."""
        fc = self.first_cell.to(device)
        cs = self.cell_size.to(device)
        i = torch.arange(self.cell_count[axis], dtype=torch.float32,
                         device=fc.device)
        return fc[axis] + i * cs[axis]

    def all_cell_centers(self, device=None) -> torch.Tensor:
        """Cell centers as an ``(nx, ny, nz, 3)`` tensor (C order == the
        reference's flat layout)."""
        shape = self.cell_count
        x = self.axis_centers(0, device)[:, None, None]
        y = self.axis_centers(1, device)[None, :, None]
        z = self.axis_centers(2, device)[None, None, :]
        return torch.stack([x.expand(shape), y.expand(shape),
                            z.expand(shape)], dim=-1)


def grid_shape(grid: Grid) -> Tuple[int, int, int]:
    return grid.cell_count


def np_grid_cell_centers(first_cell, cell_size, cell_count) -> np.ndarray:
    """NumPy twin of :meth:`Grid.all_cell_centers` for host-side baselines."""
    nx, ny, nz = cell_count
    ix, iy, iz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    cells = np.stack([ix, iy, iz], axis=-1).astype(np.float32)
    return np.asarray(first_cell, np.float32) + cells * np.asarray(
        cell_size, np.float32
    )
