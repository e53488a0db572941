"""Closest-point-transform grid engine: seed + sweep, O(cells + tris).

PyTorch counterpart of the JAX package's ``ops/cpt.py`` route that the grid
path takes (the redesign of the reference grid generator's preheap and
heap-BFS propagation, `mesh_to_sdf/src/generate/grid.rs:234-264`):

- host prep (numpy, copied): :func:`subdivide_to_span` bounds each
  triangle's extent, :func:`build_seed_bins` rasterizes every triangle's
  grid-snapped AABB ±pad into per-cell gather lists;
- :func:`seed_from_bins`: exact per-cell best and runner-up distinct
  triangles from those lists (the seed kernel, ``ops.kernels.seed``);
- :func:`_seed`: the window-scatter seed that the differentiable CPT path
  (``ops.autodiff.make_cpt_grid_distance``) runs, as the JAX package's does;
- :func:`closest_point_grid`: six directional sweeps per round,
  Gauss-Seidel (x→y→z, forward then reverse), in place on x-first
  (distance, triangle id) volumes through the sweep kernel
  (``ops.kernels.sweep``);
- :func:`normal_sign_from_idx`: the normal sign from each cell's nearest
  triangle (``SignMethod.NORMAL`` on the CPT route).

Contract (tests of the JAX package, tests/test_cpt.py): never undershoots;
exact within the seed band; ≤2% relative deviation beyond.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..grid import Grid
from ..types import F32_MAX
from ..utils.profiling import spanned
from .geometry import _dot, point_triangle_distance, triangle_bounding_box
from .kernels import seed as seed_k
from .kernels import sweep

#: Per-triangle seed window of :func:`_seed` (cells per axis); triangles
#: spanning more cells should be pre-subdivided (:func:`subdivide_to_span`).
SEED_SPAN = 4


class SeedBins(NamedTuple):
    """Host-precomputed seed gather lists (see :func:`build_seed_bins`).

    entry_tri: (K, R) int32 — triangle ids per row (T = padding);
    rows_cell: (R,) int32 — flat cell index per row (N = padding rows);
    cell_row: (N,) int32 — each cell's FIRST row (-1 = unseeded);
    n_shift_rounds: int — log2 rounds needed to combine a cell's rows (rows
    of one cell are consecutive).
    """

    entry_tri: object
    rows_cell: object
    cell_row: object
    n_shift_rounds: int


def build_seed_bins(grid: Grid, ha, hb, hc, *, k: int = 8,
                    pad: int = 1) -> SeedBins:
    """Rasterize every triangle's grid-snapped AABB ±``pad`` into per-cell
    gather lists — the reference preheap's rasterization (`grid.rs:383-456`,
    windows `grid.rs:410-426`) done with host integer ops, so the device
    seed is a pure gather + min (no scatter, no fixed-size window, and
    therefore no coverage gap: the full AABB±pad is covered exactly).

    ``pad`` sets the EXACT band: every cell whose center lies within
    ``(pad - 0.5)·cell_size`` of a triangle is seeded by that triangle
    directly (distance to the triangle ≥ distance to its AABB).

    numpy in / numpy out. Row layout: a cell with c candidate triangles
    occupies ceil(c/k) consecutive rows; the device combines them with
    ``n_shift_rounds`` shifted merges (:func:`seed_from_bins`).
    """
    ha = np.asarray(ha, np.float32)
    hb = np.asarray(hb, np.float32)
    hc = np.asarray(hc, np.float32)
    T = len(ha)
    counts = np.asarray(grid.cell_count, np.int64)
    N = int(counts.prod())
    first = grid.first_cell.detach().cpu().numpy().astype(np.float32)
    cs = grid.cell_size.detach().cpu().numpy().astype(np.float32)
    bmin = first - 0.5 * cs

    lo = np.minimum(np.minimum(ha, hb), hc) - 1e-4  # AABB_EPSILON inflation
    hi = np.maximum(np.maximum(ha, hb), hc) + 1e-4
    lo_cell = np.floor((lo - bmin) / cs).astype(np.int32) - pad
    hi_cell = np.floor((hi - bmin) / cs).astype(np.int32) + pad
    counts32 = counts.astype(np.int32)
    lo_cell = np.clip(lo_cell, 0, counts32 - 1)
    hi_cell = np.clip(hi_cell, 0, counts32 - 1)
    w = np.maximum(hi_cell - lo_cell + 1, 0)  # (T, 3) window extents
    n_per = w.prod(axis=1, dtype=np.int64)
    E = int(n_per.sum())
    if E == 0:
        entry = np.full((k, 8), T, np.int32)
        rows_cell = np.full((8,), N, np.int32)
        return SeedBins(entry, rows_cell, np.full((N,), -1, np.int32), 0)

    if N >= 2**31 - 1:
        raise ValueError(
            f"build_seed_bins: grid has {N} cells (≥ 2^31-1); "
            "the flat int32 cell indices cannot represent it"
        )
    from .. import native

    if native.available():  # C++ fast path (same layout contract)
        entry, rows_cell, cell_row, n_rounds = native.seed_bins(
            lo_cell, hi_cell, np.asarray(grid.cell_count, np.uint32), k
        )
        return SeedBins(entry, rows_cell, cell_row, n_rounds)

    # Expand windows grouped by (wx, wy, wz): triangles sharing a window
    # shape rasterize with one broadcast add — no per-entry divisions.
    base = int(w.max()) + 1
    shape_key = (w[:, 0].astype(np.int64) * base + w[:, 1]) * base + w[:, 2]
    uniq, inv = np.unique(shape_key, return_inverse=True)
    flat_parts = []
    tri_parts = []
    tri_ids = np.arange(T, dtype=np.int32)
    for j, key in enumerate(uniq):
        wz = int(key % base)
        wy = int((key // base) % base)
        wx = int(key // (base * base))
        if wx * wy * wz == 0:
            continue
        sel = np.flatnonzero(inv == j).astype(np.int32)
        oz = np.arange(wz, dtype=np.int32)
        oy = np.arange(wy, dtype=np.int32) * counts32[2]
        ox = np.arange(wx, dtype=np.int32) * (counts32[1] * counts32[2])
        offs = (
            ox[:, None, None] + oy[None, :, None] + oz[None, None, :]
        ).reshape(-1)
        lc = lo_cell[sel]
        base_flat = (
            lc[:, 0] * counts32[1] + lc[:, 1]
        ) * counts32[2] + lc[:, 2]
        flat_parts.append(
            (base_flat[:, None] + offs[None, :]).reshape(-1)
        )
        tri_parts.append(np.repeat(tri_ids[sel], wx * wy * wz))
    flat = np.concatenate(flat_parts)  # x-major (`grid.rs:122`)
    tri_of = np.concatenate(tri_parts)
    E = flat.shape[0]

    order = np.argsort(flat, kind="stable")
    flat_s = flat[order]
    tri_s = tri_of[order]

    seg_start = np.empty(E, bool)
    seg_start[0] = True
    np.not_equal(flat_s[1:], flat_s[:-1], out=seg_start[1:])
    seg_id = np.cumsum(seg_start) - 1  # 0..U-1
    U = int(seg_id[-1]) + 1
    # Rank of each entry within its segment.
    seg_first = np.flatnonzero(seg_start)
    rank = np.arange(E, dtype=np.int64) - seg_first[seg_id]
    c = np.diff(np.append(seg_first, E))  # (U,) candidates per cell
    rows_per = (c + k - 1) // k
    row_start = np.zeros(U + 1, np.int64)
    np.cumsum(rows_per, out=row_start[1:])
    R = int(row_start[-1])

    row = row_start[seg_id] + rank // k
    col = rank % k
    # Pad the row count to a power of two (bounds the distinct shapes).
    R_pad = 1 << max(int(R - 1).bit_length(), 3)
    entry = np.full((k, R_pad), T, np.int32)
    entry[col, row] = tri_s
    rows_cell = np.full(R_pad, N, np.int32)
    rows_cell[row] = flat_s  # every row of a segment gets its cell id

    cell_row = np.full((N,), -1, np.int32)
    cell_row[flat_s[seg_first]] = row_start[:U].astype(np.int32)

    d_max = int(rows_per.max())
    n_rounds = max(int(np.ceil(np.log2(d_max))), 0) if d_max > 1 else 0
    return SeedBins(entry, rows_cell, cell_row, n_rounds)


def seed_pad_for(grid: Grid) -> int:
    """Adaptive seed-band half-width: coarse grids (≤48 cells per axis) get
    ±3, production grids ±1."""
    return 3 if max(grid.cell_count) <= 48 else 1


def slab_seed_bins(grid: Grid, n_slabs: int, i: int, ha, hb, hc, *,
                   k: int = 8) -> SeedBins:
    """:func:`build_seed_bins` of x-slab ``i`` of ``n_slabs``: the slab's
    first cell is ``fc + [i·slab_nx, 0, 0]·cs`` in numpy float32, and the
    seed band comes from the whole grid (:func:`seed_pad_for`). One rank of
    the x-slab-sharded grid (``parallel/grid_sharded.py``) builds only its
    own slab's; its seed equals the one from slab ``i`` of
    :func:`build_slab_seed_bins` (the padding rows and any shift rounds
    beyond the slab's own never touch a real cell).

    numpy in / numpy out. ``n_slabs`` must divide ``grid.cell_count[0]``.
    """
    nx, ny, nz = grid.cell_count
    if nx % n_slabs:
        raise ValueError(f"n_slabs={n_slabs} must divide nx={nx}")
    slab_nx = nx // n_slabs
    fc = grid.first_cell.detach().cpu().numpy().astype(np.float32)
    cs = grid.cell_size.detach().cpu().numpy().astype(np.float32)
    slab = Grid.new(fc + np.asarray([i * slab_nx, 0, 0], np.float32) * cs,
                    cs, (slab_nx, ny, nz))
    return build_seed_bins(slab, ha, hb, hc, k=k, pad=seed_pad_for(grid))


def build_slab_seed_bins(grid: Grid, n_slabs: int, ha, hb, hc, *,
                         k: int = 8) -> SeedBins:
    """Every x-slab's :func:`slab_seed_bins`, padded to common shapes and
    stacked on a leading (n_slabs,) axis, as the JAX package's one
    controller feeds every device.

    numpy in / numpy out. ``n_slabs`` must divide ``grid.cell_count[0]``.
    """
    nx, ny, nz = grid.cell_count
    bins = [slab_seed_bins(grid, n_slabs, i, ha, hb, hc, k=k)
            for i in range(n_slabs)]
    slab_nx = nx // n_slabs
    T = len(np.asarray(ha))
    N_slab = slab_nx * ny * nz
    R_max = max(b.entry_tri.shape[1] for b in bins)
    n_rounds = max(b.n_shift_rounds for b in bins)
    entry = np.full((n_slabs, k, R_max), T, np.int32)
    rows_cell = np.full((n_slabs, R_max), N_slab, np.int32)
    cell_row = np.empty((n_slabs, N_slab), np.int32)
    for i, b in enumerate(bins):
        r = b.entry_tri.shape[1]
        entry[i, :, :r] = b.entry_tri
        rows_cell[i, :r] = b.rows_cell
        cell_row[i] = b.cell_row
    return SeedBins(entry, rows_cell, cell_row, n_rounds)


def subdivide_to_span(vertices, faces, max_edge: float, max_tris: int = 4_000_000,
                      return_parents: bool = False):
    """Host-side longest-edge subdivision until every edge ≤ max_edge.

    Keeps the surface identical, so distances/signs are unchanged. Bounds
    each triangle's AABB (and hence its rasterized seed volume). numpy
    in/out. With ``return_parents`` also returns each output triangle's
    ORIGINAL face index.
    """
    v = np.asarray(vertices, np.float32)
    tris = v[np.asarray(faces, np.int64)]  # (T, 3, 3) standalone soup
    parents = np.arange(len(tris), dtype=np.int64)
    while len(tris) < max_tris:
        e0 = np.linalg.norm(tris[:, 1] - tris[:, 0], axis=1)
        e1 = np.linalg.norm(tris[:, 2] - tris[:, 1], axis=1)
        e2 = np.linalg.norm(tris[:, 0] - tris[:, 2], axis=1)
        longest = np.stack([e0, e1, e2], 1)
        which = longest.argmax(1)
        lmax = longest.max(1)
        split = lmax > max_edge
        if not split.any():
            break
        keep = tris[~split]
        keep_p = parents[~split]
        s = tris[split]
        sp = parents[split]
        w = which[split]
        a, b, c = s[:, 0], s[:, 1], s[:, 2]
        # rotate so the longest edge is (a, b)
        a2 = np.where(w[:, None] == 1, b, np.where(w[:, None] == 2, c, a))
        b2 = np.where(w[:, None] == 1, c, np.where(w[:, None] == 2, a, b))
        c2 = np.where(w[:, None] == 1, a, np.where(w[:, None] == 2, b, c))
        m = (a2 + b2) / 2
        t1 = np.stack([a2, m, c2], 1)
        t2 = np.stack([m, b2, c2], 1)
        tris = np.concatenate([keep, t1, t2])
        parents = np.concatenate([keep_p, sp, sp])
    if return_parents:
        return tris[:, 0], tris[:, 1], tris[:, 2], parents
    return tris[:, 0], tris[:, 1], tris[:, 2]


@spanned("grid.seed")
def seed_from_bins(grid: Grid, ta, tb, tc, bins: SeedBins, tris=None):
    """Exact per-cell seeds from host-precomputed gather lists.

    ta/tb/tc: (T, 3) f32 triangle vertices on the working device; the bins'
    arrays may be numpy or tensors. ``tris``: their ``sweep.sweep_tris``,
    which the caller may share with :func:`closest_point_grid` (packed
    here when not given and the device has a kernel). Per cell, the best
    and the runner-up distinct triangle of its rows (``ops.kernels.seed``:
    one launch of the seed kernel on CUDA tensors, its plain version on CPU
    tensors). Returns flat (N,) (d1, i1, d2, i2): distances f32, triangle
    ids int32 (-1 = none).
    """
    return seed_k.seed_from_bins(grid, ta, tb, tc, bins, tris)


def _seed(grid: Grid, ta, tb, tc, span: int):
    """Scatter exact per-cell seeds from triangle AABB windows.

    Returns flat (N,) (d1, i1, d2, i2), as :func:`seed_from_bins` does.

    Coverage (PER-AXIS only): the AABB±1 range can span up to ``span + 2``
    cells per axis at the subdivision bound (max_edge = (span-1.5)·cs), so
    TWO span-sized windows are rasterized per triangle — one anchored at the
    low corner, one ending at the high corner. Their union covers each AXIS
    range up to 2·span cells, but NOT the full 3-D product: a cell mixing
    the low window on one axis with the high window on another gets no
    direct seed and relies on the sweeps to repair its distance
    (:func:`build_seed_bins` covers the AABB±pad exactly).

    The min and the argmax scatters (``scatter_reduce_`` "amin", "amax")
    do not depend on the order of their updates, so the result is the same
    on every device and equal to the JAX package's.
    """
    nx, ny, nz = grid.cell_count
    N = nx * ny * nz
    T = ta.shape[0]
    dev = ta.device

    lo, hi = triangle_bounding_box(ta, tb, tc)
    bmin, _ = grid.bounding_box()
    bmin, cs = bmin.to(dev), grid.cell_size.to(dev)
    lo_cell = torch.floor((lo - bmin) / cs).to(torch.int32) - 1  # ±1 guard
    hi_cell = torch.floor((hi - bmin) / cs).to(torch.int32) + 1
    counts = torch.tensor(grid.cell_count, dtype=torch.int32, device=dev)
    top = torch.clamp_min(counts - span, 0)
    base_lo = torch.minimum(torch.clamp_min(lo_cell, 0), top)
    base_hi = torch.minimum(torch.clamp_min(hi_cell - (span - 1), 0), top)

    r = torch.arange(span, dtype=torch.int32, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(-1, 3)  # (S³, 3)
    cells = torch.cat([base_lo[:, None, :] + offs[None],
                       base_hi[:, None, :] + offs[None]], dim=1)  # (T, 2S³, 3)
    in_box = torch.all(
        (cells >= torch.clamp_min(lo_cell, 0)[:, None, :])
        & (cells <= torch.minimum(hi_cell, counts - 1)[:, None, :]), dim=-1)
    d = point_triangle_distance(grid.cell_center(cells), ta[:, None, :],
                                tb[:, None, :], tc[:, None, :])
    d = torch.where(in_box, d, F32_MAX).reshape(-1)
    flat = grid.cell_index(torch.minimum(torch.clamp_min(cells, 0),
                                         counts - 1)).reshape(-1).long()

    def scatter(values, fill, reduce):
        out = torch.full((N,), fill, dtype=values.dtype, device=dev)
        return out.scatter_reduce_(0, flat, values, reduce)

    dist = scatter(d, F32_MAX, "amin")
    # Argmin scatter (two-pass): any triangle achieving the min wins.
    tri_ids = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(
        2 * span ** 3)
    tri_idx = scatter(torch.where(d <= dist[flat], tri_ids, -1), -1, "amax")
    # Runner-up (distinct triangle): same scheme with the winner masked out.
    d_rest = torch.where(tri_ids == tri_idx[flat], F32_MAX, d)
    dist2 = scatter(d_rest, F32_MAX, "amin")
    tri_idx2 = scatter(torch.where(d_rest <= dist2[flat], tri_ids, -1), -1,
                       "amax")
    return dist, tri_idx, dist2, tri_idx2


def sweep_state(grid: Grid, seed):
    """The x-first sweep state ``[d1, i1, d2, i2]``, (nx, ny, nz) each: a
    copy of the flat seed (which is not modified)."""
    shape = tuple(int(n) for n in grid.cell_count)
    return [t.reshape(shape).clone() for t in seed]


@spanned("grid.sweep")
def closest_point_grid(grid: Grid, ta, tb, tc, *, seed, rounds: int = 1,
                       tris=None):
    """Unsigned distance + nearest-triangle index for every cell.

    ``seed``: flat (N,) (d1, i1, d2, i2) from :func:`seed_from_bins` (not
    modified). Runs ``rounds`` × 6 directional sweeps, Gauss-Seidel: x, y,
    z, each forward then reverse, every sweep seeing the previous one's
    result (the TPU orchestration ``closest_point_grid_pallas``). Every
    sweep updates the same x-first volumes in place (no relayout); the
    triangles' records (``sweep.sweep_tris``) are ``tris``, or packed once
    here when not given.

    Returns (dist (nx, ny, nz) f32, tri_idx (nx, ny, nz) int32).
    """
    fc, cs = grid.first_cell, grid.cell_size
    if tris is None:
        tris = sweep.sweep_tris(ta, tb, tc)
    state = sweep_state(grid, seed)
    for _ in range(rounds):
        for axis in (0, 1, 2):
            for rev in (False, True):
                sweep.sweep_axis(*state, tris, rev, fc, cs, axis=axis)
    return state[0], state[1]


def normal_sign_from_idx(grid: Grid, ta, tb, tc, dist, idx):
    """Sign unsigned CPT distances by the nearest triangle's normal side.

    The reference Rtree backend's semantics (`rtree.rs:96-126`): only the
    single nearest triangle decides the sign, which its own tests allow to
    disagree with the champion reduction on ~1% of cells near edges
    (`rtree.rs:171-242`). dot == 0 counts negative (`geo.rs:51-55`); a cell
    with no triangle (id -1) stays positive. Returns (nx, ny, nz).
    """
    centers = grid.all_cell_centers(dist.device).reshape(-1, 3)
    flat = idx.reshape(-1)
    safe = torch.clamp_min(flat, 0).long()
    a = ta[safe]
    b = tb[safe]
    c = tc[safe]
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    d = _dot(centers - a, n)
    sign = torch.where(d > 0.0, 1.0, -1.0)
    sign = torch.where(flat < 0, 1.0, sign)
    return (dist.reshape(-1) * sign).reshape(grid.cell_count)
