"""Grid SDF samplers: snap / trilinear (dual grid) / tetrahedral.

PyTorch counterpart of the JAX package's ``render/sampler.py``, with the
same float32 operations in the same order. Behavioural parity with the
reference raymarch shader's samplers
(`mesh_to_sdf_client/shaders/draw_raymarching.wgsl:118-200,585-640`):

- ``snap``: nearest cell (floor on the primal grid, clamped);
- ``trilinear``: interpolation on the *dual* grid whose vertices are the cell
  centers (`draw_raymarching.wgsl:137-176`);
- ``tetrahedral``: the dual cell split into 6 tetrahedra keyed by the
  ordering of the fractional coordinates (`draw_raymarching.wgsl:177-195,
  585-640`).

Every index is clamped before it gathers (XLA clamps out-of-range gathers,
torch raises), so positions far outside the grid, or rays that never start,
are safe. Out-of-bounds positions return ``OUT_OF_BOUNDS_DISTANCE`` (the
shader's 100.0 sentinel, `draw_raymarching.wgsl:121-123`).

The grid's parameters live on the host; :func:`lattice` moves them to the
sampling device once, so a loop over samples copies nothing per step.
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import torch

from ..grid import Grid

#: `draw_raymarching.wgsl:122` — returned outside the grid bbox.
OUT_OF_BOUNDS_DISTANCE = 100.0


class RaymarchMode(enum.Enum):
    """Mirrors the client's raymarch mode enum (`sdf_program.rs:48-53`)."""

    SNAP = "snap"
    TRILINEAR = "trilinear"
    TETRAHEDRAL = "tetrahedral"
    SNAP_STYLIZED = "snap_stylized"


class Lattice(NamedTuple):
    """A grid's float32 parameters on one device."""

    first_cell: torch.Tensor  # (3,)
    cell_size: torch.Tensor  # (3,)
    bmin: torch.Tensor  # (3,) bounding-box min corner
    lo: torch.Tensor  # (3,) min / max of the first and last cell centers
    hi: torch.Tensor
    shape: Tuple[int, int, int]


def lattice(grid: Grid, device) -> Lattice:
    """:class:`Lattice` of ``grid`` on ``device`` (one host-to-device copy)."""
    fc, cs = grid.first_cell, grid.cell_size
    counts = torch.tensor(grid.cell_count, dtype=torch.float32)
    end = fc + (counts - 1.0) * cs
    bmin, _ = grid.bounding_box()
    packed = torch.stack([fc, cs, bmin, torch.minimum(fc, end),
                          torch.maximum(fc, end)]).to(device)
    return Lattice(*packed.unbind(0), tuple(grid.cell_count))


def _as_lattice(grid, device) -> Lattice:
    return grid if isinstance(grid, Lattice) else lattice(grid, device)


def _clamped_fetch(dist: torch.Tensor, cx, cy, cz) -> torch.Tensor:
    """``get_distance`` (`draw_raymarching.wgsl:92-98`): clamp integer cell
    coords to the grid then gather. dist: (nx,ny,nz); cx, cy, cz: int
    tensors of one shape."""
    nx, ny, nz = dist.shape
    cx = cx.clamp(0, nx - 1).long()
    cy = cy.clamp(0, ny - 1).long()
    cz = cz.clamp(0, nz - 1).long()
    return dist.reshape(-1)[(cx * ny + cy) * nz + cz]


def _dual_coords(lat: Lattice, position: torch.Tensor):
    """Continuous coords on the dual grid (origin = first cell center)."""
    rel = (position - lat.first_cell) / lat.cell_size
    fl = torch.floor(rel)
    return fl.to(torch.int32).unbind(-1), (rel - fl).unbind(-1)


def _in_bounds(lat: Lattice, position: torch.Tensor) -> torch.Tensor:
    """Inside [start, end] — `draw_raymarching.wgsl:121-123` (uniforms.start /
    end are the first/last cell centers)."""
    return torch.all((position >= lat.lo) & (position <= lat.hi), dim=-1)


def _oob(lat: Lattice, position, val):
    return torch.where(_in_bounds(lat, position), val, OUT_OF_BOUNDS_DISTANCE)


def sample_snap(dist: torch.Tensor, grid, position: torch.Tensor):
    """Nearest-cell sample (`draw_raymarching.wgsl:128-136`). ``grid``: a
    :class:`Grid`, or its :class:`Lattice` on the device of ``position``."""
    lat = _as_lattice(grid, position.device)
    cell = torch.floor((position - lat.bmin) / lat.cell_size).to(torch.int32)
    return _oob(lat, position, _clamped_fetch(dist, *cell.unbind(-1)))


def sample_trilinear(dist: torch.Tensor, grid, position: torch.Tensor):
    """Dual-grid trilinear sample (`draw_raymarching.wgsl:137-176`)."""
    lat = _as_lattice(grid, position.device)
    (ix, iy, iz), (fx, fy, fz) = _dual_coords(lat, position)

    def at(dx, dy, dz):
        return _clamped_fetch(dist, ix + dx, iy + dy, iz + dz)

    c_x00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c_x01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c_x10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c_x11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c_xy0 = c_x00 * (1 - fy) + c_x10 * fy
    c_xy1 = c_x01 * (1 - fy) + c_x11 * fy
    val = c_xy0 * (1 - fz) + c_xy1 * fz
    return _oob(lat, position, val)


def sample_tetrahedral(dist: torch.Tensor, grid, position: torch.Tensor):
    """Dual-grid tetrahedral barycentric sample
    (`draw_raymarching.wgsl:177-195` + `compute_tetrahedral_barycenter`
    `:585-640`). The dual cell splits into 6 tetrahedra selected by the sort
    order of the fractional coords (fx, fy, fz) ≙ (fR, fG, fB)."""
    lat = _as_lattice(grid, position.device)
    (ix, iy, iz), (fx, fy, fz) = _dual_coords(lat, position)

    # The 6 cases, exactly as the shader orders them (last-true-wins there is
    # irrelevant: cases are mutually exclusive and cover all orderings).
    #   case:   condition                 bary                    v2         v3
    #   1: fy >= fz >= fx   (1-fy, fy-fz, fz-fx, fx)   (0,1,0)  (0,1,1)
    #   2: fz >  fx >  fy   (1-fz, fz-fx, fx-fy, fy)   (0,0,1)  (1,0,1)
    #   3: fz >  fy >= fx   (1-fz, fz-fy, fy-fx, fx)   (0,0,1)  (0,1,1)
    #   4: fx >= fy >  fz   (1-fx, fx-fy, fy-fz, fz)   (1,0,0)  (1,1,0)
    #   5: fy >  fx >= fz   (1-fy, fy-fx, fx-fz, fz)   (0,1,0)  (1,1,0)
    #   6: fx >= fz >= fy   (1-fx, fx-fz, fz-fy, fy)   (1,0,0)  (1,0,1)
    conds = [
        (fy >= fz) & (fz >= fx),
        (fz > fx) & (fx > fy),
        (fz > fy) & (fy >= fx),
        (fx >= fy) & (fy > fz),
        (fy > fx) & (fx >= fz),
        (fx >= fz) & (fz >= fy),
    ]
    barys = [
        (1 - fy, fy - fz, fz - fx, fx),
        (1 - fz, fz - fx, fx - fy, fy),
        (1 - fz, fz - fy, fy - fx, fx),
        (1 - fx, fx - fy, fy - fz, fz),
        (1 - fy, fy - fx, fx - fz, fz),
        (1 - fx, fx - fz, fz - fy, fy),
    ]
    v2s = [(0, 1, 0), (0, 0, 1), (0, 0, 1), (1, 0, 0), (0, 1, 0), (1, 0, 0)]
    v3s = [(0, 1, 1), (1, 0, 1), (0, 1, 1), (1, 1, 0), (1, 1, 0), (1, 0, 1)]

    zero = torch.zeros_like(fx)
    b = [zero, zero, zero, zero]
    izero = torch.zeros_like(ix)
    v2 = [izero, izero, izero]
    v3 = [izero, izero, izero]
    for cond, bary, vv2, vv3 in zip(conds, barys, v2s, v3s):
        for k in range(4):
            b[k] = torch.where(cond, bary[k], b[k])
        for k in range(3):
            v2[k] = torch.where(cond, vv2[k], v2[k])
            v3[k] = torch.where(cond, vv3[k], v3[k])

    s0 = _clamped_fetch(dist, ix, iy, iz)
    s1 = _clamped_fetch(dist, ix + v2[0], iy + v2[1], iz + v2[2])
    s2 = _clamped_fetch(dist, ix + v3[0], iy + v3[1], iz + v3[2])
    s3 = _clamped_fetch(dist, ix + 1, iy + 1, iz + 1)
    val = b[0] * s0 + b[1] * s1 + b[2] * s2 + b[3] * s3
    return _oob(lat, position, val)


_SAMPLERS = {
    RaymarchMode.SNAP: sample_snap,
    RaymarchMode.SNAP_STYLIZED: sample_snap,
    RaymarchMode.TRILINEAR: sample_trilinear,
    RaymarchMode.TETRAHEDRAL: sample_tetrahedral,
}


def sample(dist, grid, position, mode: RaymarchMode = RaymarchMode.TRILINEAR):
    """Dispatch over :class:`RaymarchMode` (`draw_raymarching.wgsl:126-199`).
    ``dist``: (nx, ny, nz) tensor on the device of ``position``."""
    return _SAMPLERS[mode](dist, grid, position)
