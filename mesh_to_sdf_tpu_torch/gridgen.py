"""`generate_grid_sdf` — signed distance field on a regular grid.

PyTorch counterpart of the JAX package's ``gridgen.py``, through its CPT
route (the reference flagship, `mesh_to_sdf/src/generate/grid.rs:265-378`):

1. host prep (:func:`_cpt_prep`, cached by content): subdivision bound,
   seed bins (native C++ when built), per-axis line bins;
2. device work on the inputs' device: :func:`ops.cpt.seed_from_bins`, six
   directional sweeps per round through the sweep kernel, three axes of
   binned line parity through the parity kernel, ≥2-of-3 parity vote.

The parity kernel is exact (no bucket limit), so the JAX route's overflow
re-sign (``_exact_resign``) has nothing to do here. The other routes raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import zlib
from typing import Optional, Union

import numpy as np
import torch

from .grid import Grid
from .ops import cpt
from .ops.kernels import parity
from .topology import Topology, as_points, gather_triangle_vertices
from .types import F32_MAX, AccelerationMethod, SignMethod, Strategy

#: Content-hashed cache of CPT host prep (subdivision, seed bins, line
#: bins), held on the device: repeated calls on the same mesh/grid skip the
#: host rasterization and the upload. Keyed by (triangle bytes, grid,
#: device); tiny FIFO.
_CPT_PREP_CACHE: dict = {}
_CPT_PREP_CACHE_MAX = 4

_NOT_PORTED = {
    Strategy.XLA: "ROADMAP.md 'Modules still to port' item 3 (ops/brute.py)",
    Strategy.PALLAS: "ROADMAP.md 'Modules still to port' item 5 "
                     "(PALLAS route)",
    Strategy.CULLED: "ROADMAP.md 'Modules still to port' item 6 (CULLED)",
}


def _resolve(acceleration, sign_method):
    if isinstance(acceleration, AccelerationMethod):
        return acceleration.strategy, acceleration.sign_method
    if acceleration is None:
        acceleration = Strategy.AUTO
    if sign_method is None:
        sign_method = SignMethod.RAYCAST
    return acceleration, sign_method


def _cpt_prep(grid: Grid, ha, hb, hc, device):
    """(stacked soup (3,T,3), SeedBins, per-axis LineBins), all on
    ``device`` — cached by content. Line bins are built on the ORIGINAL
    soup: parity is subdivision-invariant."""
    cs = float(np.max(np.abs(grid.cell_size.detach().cpu().numpy())))
    max_edge = 8.0 * cs
    tris_np = np.ascontiguousarray(np.stack([ha, hb, hc], axis=1))  # (T,3,3)
    key = (
        zlib.adler32(tris_np.tobytes()),
        tris_np.shape[0],
        tuple(grid.first_cell.tolist()),
        tuple(grid.cell_size.tolist()),
        tuple(int(c) for c in grid.cell_count),
        str(device),
    )
    hit = _CPT_PREP_CACHE.get(key)
    if hit is not None:
        return hit
    edges = np.linalg.norm(tris_np - np.roll(tris_np, 1, axis=1), axis=2)
    if float(edges.max()) > max_edge:
        # Bound a giant triangle's rasterized seed volume (surface-identical
        # ⇒ distances/sign unchanged).
        ra, rb, rc = cpt.subdivide_to_span(
            tris_np.reshape(-1, 3),
            np.arange(3 * len(ha), dtype=np.int64).reshape(-1, 3),
            max_edge=max_edge,
        )
    else:
        ra, rb, rc = tris_np[:, 0], tris_np[:, 1], tris_np[:, 2]
    bins = cpt.build_seed_bins(grid, ra, rb, rc, pad=cpt.seed_pad_for(grid))
    line_bins = tuple(
        parity.build_line_bins(grid, axis, tris_np[:, 0], tris_np[:, 1],
                               tris_np[:, 2], device=device)
        for axis in range(3)
    )
    out = (
        torch.from_numpy(np.stack([ra, rb, rc])).to(device),
        cpt.SeedBins(
            torch.from_numpy(bins.entry_tri).to(device),
            torch.from_numpy(bins.rows_cell).to(device),
            torch.from_numpy(bins.cell_row).to(device),
            bins.n_shift_rounds,
        ),
        line_bins,
    )
    if len(_CPT_PREP_CACHE) >= _CPT_PREP_CACHE_MAX:
        _CPT_PREP_CACHE.pop(next(iter(_CPT_PREP_CACHE)))
    _CPT_PREP_CACHE[key] = out
    return out


def _cpt_grid_signed(grid: Grid, tris, bins, line_bins, *, raycast_axes: int,
                     flat: bool, sweep_rounds: int):
    """CPT distance + binned-parity raycast sign for one grid."""
    ra, rb, rc = tris[0], tris[1], tris[2]
    seed = cpt.seed_from_bins(grid, ra, rb, rc, bins)
    dist3, _ = cpt.closest_point_grid(grid, ra, rb, rc, seed=seed,
                                      rounds=sweep_rounds)
    inside, _ = parity.grid_inside_mask(grid, line_bins, axes=raycast_axes)
    dist3 = torch.where(inside, -dist3, dist3)
    return dist3.reshape(-1) if flat else dist3


def generate_grid_sdf(
    vertices,
    topology: Optional[Topology],
    grid: Grid,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    strategy: Union[Strategy, AccelerationMethod, None] = None,
    raycast_axes: int = 3,
    flat: bool = True,
    exact: bool = False,
) -> torch.Tensor:
    """SDF at every cell center of ``grid``.

    Returns float32 distances on the device of ``vertices`` (or of the
    grid's parameters when ``vertices`` is not a tensor), flattened in the
    reference's x-major/z-fastest layout (`grid.rs:122-124`) when
    ``flat=True``, else shaped (nx, ny, nz). Positive outside, negative
    inside (`grid.rs:199-232`).

    ``raycast_axes``: 3 (default) = best-of-3 axis parity voting
    (`grid.rs:622-639`); 1 = single +X parity.

    Ported routes: ``Strategy.AUTO`` and ``Strategy.CPT`` with
    ``SignMethod.RAYCAST`` (AUTO always resolves to CPT). The others raise
    ``NotImplementedError``.
    """
    strategy, sign = _resolve(
        strategy if strategy is not None else Strategy.AUTO, sign_method
    )
    if exact and strategy in (Strategy.AUTO, Strategy.CPT):
        raise NotImplementedError(
            "exact=True runs the tile-culled engine, not ported yet: "
            + _NOT_PORTED[Strategy.CULLED]
        )
    if strategy == Strategy.AUTO:
        # The JAX package's AUTO cost model has no "cuda" entry yet
        # (ROADMAP.md item 4); CPT is the only ported grid route.
        strategy = Strategy.CPT
    if strategy != Strategy.CPT:
        raise NotImplementedError(
            f"{strategy} is not ported yet: {_NOT_PORTED[strategy]}"
        )
    if sign != SignMethod.RAYCAST:
        raise NotImplementedError(
            "SignMethod.NORMAL on the CPT route (normal_sign_from_idx) is not "
            "ported yet: ROADMAP.md 'Modules still to port' item 4"
        )

    if isinstance(vertices, torch.Tensor):
        device = vertices.device
    else:
        device = grid.first_cell.device
    v_host = as_points(vertices)
    topo = topology if topology is not None else Topology.triangle_list(None)
    ha, hb, hc = gather_triangle_vertices(v_host, topo)
    if len(ha) == 0:
        out = torch.full(grid.cell_count, F32_MAX, dtype=torch.float32,
                         device=device)
        return out.reshape(-1) if flat else out

    tris, bins, line_bins = _cpt_prep(grid, ha, hb, hc, device)
    return _cpt_grid_signed(
        grid, tris, bins, line_bins,
        raycast_axes=raycast_axes,
        flat=flat,
        # Coarse grids stress far-field propagation; a second round costs
        # O(cells) and is negligible exactly where it is needed.
        sweep_rounds=2 if max(grid.cell_count) <= 128 else 1,
    )
