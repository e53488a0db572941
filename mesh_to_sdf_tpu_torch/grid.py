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
