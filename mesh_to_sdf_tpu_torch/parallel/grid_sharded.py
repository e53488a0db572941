"""Multi-rank grid SDF: CPT over x-slabs of the grid (PyTorch counterpart
of ``parallel/grid_sharded.py``).

The grid's x axis is split into equal slabs over the mesh axis ``cells``;
triangles are replicated (every rank of a ``cells`` row computes the same
slab). Per rank:

1. **seed and local sweeps**: the slab's seed from its own
   ``cpt.slab_seed_bins`` (``cpt.seed_from_bins``), one round of six
   sweeps (``cpt.closest_point_grid``, the sweep kernel), and the runner-up
   reset: the state is (d1, i1, F32_MAX, -1);
2. **halo exchange**, ``halo_rounds`` times: the first and last rows of the
   state, id-only edges (d1, i1, d2, i2), go to the left and right
   neighbours (``mesh._exchange``; the end slabs send nothing outward and
   merge an empty edge there); both come from the previous round's state.
   The left neighbour's edge is merged into row 0, then the right one's
   into row -1, each slot's triangle re-evaluated by id with the exact
   projection (``gridgen_streamed._merge_edge``), then the ±x sweeps
   (``gridgen_streamed._x_sweeps``, two sweep launches);
3. **sign**: RAYCAST by three axes of binned line parity over the slab's
   own line bins (the hit pass counts the hits past the slab in its last
   cell, so each suffix count sees the whole mesh: exact and slab-local);
   NORMAL by the nearest triangle's normal side
   (``cpt.normal_sign_from_idx``).

The slabs are then gathered over ``cells``, so every rank returns the whole
field. The JAX package signs each slab with XLA and sweeps with XLA or the
Pallas kernel (``use_pallas``); here the kernels run on CUDA tensors and
their plain versions on CPU tensors (the TPU branch's computation).
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import numpy as np
import torch

from ..grid import Grid
from ..gridgen_streamed import (Edge, _edge, _empty_edge, _merge_edge,
                                _x_sweeps, slab_grids)
from ..ops import cpt
from ..ops.kernels import parity, sweep
from ..query import _cached
from ..topology import as_points
from ..types import F32_MAX, SignMethod
from .mesh import CELL_AXIS, _all_gather, _exchange, axis_index, axis_size
from .sharding import _host, _rank_device

#: Content-keyed per-rank prep (the soup, this slab's seeds and line
#: bins on the device); at most two entries.
_SHARDED_PREP_CACHE: dict = {}
_SHARDED_PREP_CACHE_MAX = 2


class _SlabPrep(NamedTuple):
    """One rank's device-resident prep: the subdivided soup (3, T, 3), its
    packed sweep records, the slab's Grid, its seed bins and (RAYCAST) its
    three line-bin tables."""

    tris: torch.Tensor
    sweep_tris: sweep.SweepTris
    slab: Grid
    seed: cpt.SeedBins
    line_bins: tuple


def _slab_prep(grid: Grid, n_dev: int, idx: int, v_np, f_np, raycast: bool,
               device) -> _SlabPrep:
    key = (zlib.adler32(v_np.tobytes()), v_np.shape,
           zlib.adler32(f_np.tobytes()), f_np.shape,
           tuple(grid.first_cell.tolist()), tuple(grid.cell_size.tolist()),
           tuple(grid.cell_count), n_dev, idx, raycast, str(device))

    def build():
        cs = float(np.max(np.abs(grid.cell_size.numpy())))
        # Binned seeds cover the AABB ±pad exactly for any triangle size;
        # the 8-cell cap only bounds the rasterized seed volume.
        ra, rb, rc = cpt.subdivide_to_span(v_np, f_np, max_edge=8.0 * cs)
        tris = torch.from_numpy(np.stack([ra, rb, rc])).to(device)
        bins = cpt.slab_seed_bins(grid, n_dev, idx, ra, rb, rc)
        seed = cpt.SeedBins(*(torch.from_numpy(a).to(device)
                              for a in bins[:3]), bins.n_shift_rounds)
        slab = slab_grids(grid, grid.cell_count[0] // n_dev)[idx]
        line_bins = ()
        if raycast:
            oa, ob, oc = (v_np[f_np[:, k]] for k in range(3))
            line_bins = tuple(parity.build_line_bins(slab, axis, oa, ob, oc,
                                                     device=device)
                              for axis in range(3))
        return _SlabPrep(tris, sweep.sweep_tris(*tris), slab, seed,
                         line_bins)

    return _cached(_SHARDED_PREP_CACHE, key, build,
                   max_size=_SHARDED_PREP_CACHE_MAX)


def _pack(edge: Edge) -> torch.Tensor:
    """(4, ny, nz) int32: the edge's four slices, distances bitcast."""
    return torch.stack([edge.d1.view(torch.int32), edge.i1,
                        edge.d2.view(torch.int32), edge.i2])


def _unpack(packed: torch.Tensor) -> Edge:
    return Edge(packed[0].view(torch.float32), packed[1],
                packed[2].view(torch.float32), packed[3])


def _seed_and_sweep(prep: _SlabPrep):
    """Step 1: the slab's state [d1, i1, d2, i2] after the seed, one round
    of six sweeps and the runner-up reset."""
    ta, tb, tc = prep.tris
    seed = cpt.seed_from_bins(prep.slab, ta, tb, tc, prep.seed)
    d1, i1 = cpt.closest_point_grid(prep.slab, ta, tb, tc, seed=seed,
                                     rounds=1)
    return [d1, i1, torch.full_like(d1, F32_MAX), torch.full_like(i1, -1)]


def _halo_round(prep: _SlabPrep, state, mesh, empty: Edge):
    """Step 2, once: exchange the edges, merge left then right, ±x sweeps."""
    from_left, from_right = _exchange(_pack(_edge(state, 0)),
                                      _pack(_edge(state, -1)), mesh)
    for packed, position in ((from_left, 0), (from_right, -1)):
        edge = empty if packed is None else _unpack(packed)
        _merge_edge(state, edge, position, prep.slab, prep.sweep_tris.tv)
    _x_sweeps(state, prep.sweep_tris, prep.slab)
    return state


def _sign(prep: _SlabPrep, state, sign_method: SignMethod) -> torch.Tensor:
    """Step 3: the signed (slab_nx, ny, nz) distances."""
    d1 = state[0]
    if sign_method == SignMethod.NORMAL:
        return cpt.normal_sign_from_idx(prep.slab, *prep.tris, d1, state[1])
    inside, _ = parity.grid_inside_mask(prep.slab, prep.line_bins, axes=3)
    return torch.where(inside, -d1, d1)


def generate_grid_sdf_sharded_cpt(
    vertices,
    faces,
    grid: Grid,
    mesh,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    halo_rounds: int = 2,
    device=None,
) -> torch.Tensor:
    """Multi-rank ``generate_grid_sdf`` (CPT engine), x-slab sharded.

    vertices (V, 3) / faces (M, 3): host arrays or tensors;
    ``grid.cell_count[0]`` must divide the mesh's ``cells`` size. Every rank
    of the mesh calls it with the same arguments and gets the whole flat
    (nx·ny·nz,) float32 field on its device (CUDA unless ``device=`` or the
    vertices say otherwise).
    """
    n_dev = axis_size(mesh, CELL_AXIS)
    nx, ny, nz = grid.cell_count
    if nx % n_dev:
        raise ValueError(f"nx={nx} must divide devices={n_dev}")
    device = _rank_device(device, vertices)
    v_np = as_points(vertices)
    f_np = np.asarray(_host(faces), np.int64).reshape(-1, 3)
    prep = _slab_prep(grid, n_dev, axis_index(mesh, CELL_AXIS), v_np, f_np,
                      sign_method == SignMethod.RAYCAST, device)

    state = _seed_and_sweep(prep)
    empty = _empty_edge(ny, nz, device)
    for _ in range(halo_rounds):
        state = _halo_round(prep, state, mesh, empty)
    signed = _sign(prep, state, sign_method).reshape(-1)
    del state
    return _all_gather(signed, mesh.get_group(CELL_AXIS)).reshape(-1)
