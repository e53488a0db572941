"""Closest-point-transform grid engine: seed + sweep, O(cells + tris).

PyTorch counterpart of the JAX package's ``ops/cpt.py`` route that the grid
path takes (the redesign of the reference grid generator's preheap and
heap-BFS propagation, `mesh_to_sdf/src/generate/grid.rs:234-264`):

- host prep (numpy, copied): :func:`subdivide_to_span` bounds each
  triangle's extent, :func:`build_seed_bins` rasterizes every triangle's
  grid-snapped AABB ±pad into per-cell gather lists;
- :func:`seed_from_bins`: exact per-cell best and runner-up distinct
  triangles from those lists (plain PyTorch on the tensors' device);
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
from .geometry import _dot
from .kernels import sweep
from .kernels.sweep import PAD_COORD, _pt_dist


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


def _combine_top2(d1a, i1a, d2a, i2a, d1b, i1b, d2b, i2b):
    """Merge two (best, runner-up-distinct) candidate pairs, branchless."""
    a_first = d1a <= d1b
    n_d1 = torch.where(a_first, d1a, d1b)
    n_i1 = torch.where(a_first, i1a, i1b)
    # Runner-up: best among {loser's d1, both d2} with a distinct id.
    cand_d = torch.stack([torch.where(a_first, d1b, d1a), d2a, d2b])
    cand_i = torch.stack([torch.where(a_first, i1b, i1a), i2a, i2b])
    cand_d = torch.where(cand_i == n_i1[None], F32_MAX, cand_d)
    b = torch.argmin(cand_d, dim=0, keepdim=True)
    n_d2 = torch.take_along_dim(cand_d, b, dim=0)[0]
    n_i2 = torch.take_along_dim(cand_i, b, dim=0)[0]
    return n_d1, n_i1, n_d2, n_i2


def seed_from_bins(grid: Grid, ta, tb, tc, bins: SeedBins):
    """Exact per-cell seeds from host-precomputed gather lists.

    ta/tb/tc: (T, 3) f32 triangle vertices on the working device; the bins'
    arrays may be numpy or tensors. One dense (K, R) distance evaluation +
    log2(D) shifted merges + one row gather through the inverse map.
    Returns flat (N,) (d1, i1, d2, i2): distances f32, triangle ids int32
    (-1 = none).
    """
    nx, ny, nz = grid.cell_count
    N = nx * ny * nz
    T = ta.shape[0]
    dev = ta.device
    entry = torch.as_tensor(bins.entry_tri, device=dev)  # (K, R)
    rows_cell = torch.as_tensor(bins.rows_cell, device=dev)  # (R,)

    tv = torch.cat([ta, tb, tc], dim=-1)  # (T, 9)
    tv = torch.cat([tv, torch.full((1, 9), PAD_COORD, dtype=torch.float32,
                                   device=dev)])
    v = tv[entry.long()].permute(2, 0, 1)  # (9, K, R)

    safe_cell = torch.clamp_max(rows_cell, N - 1)
    czi = safe_cell % nz
    cyi = torch.div(safe_cell, nz, rounding_mode="floor") % ny
    cxi = torch.div(safe_cell, ny * nz, rounding_mode="floor")
    fc = grid.first_cell.to(dev)
    cs = grid.cell_size.to(dev)
    cx = fc[0] + cxi.to(torch.float32) * cs[0]  # (R,) coordinate planes
    cy = fc[1] + cyi.to(torch.float32) * cs[1]
    cz = fc[2] + czi.to(torch.float32) * cs[2]

    d = _pt_dist(cx[None, :], cy[None, :], cz[None, :], v)  # (K, R)
    d = torch.where(entry == T, F32_MAX, d)

    # Per-row top-2 distinct (reduce over the K axis 0).
    b1 = torch.argmin(d, dim=0, keepdim=True)
    d1 = torch.take_along_dim(d, b1, dim=0)[0]
    i1 = torch.take_along_dim(entry, b1, dim=0)[0]
    masked = torch.where(entry == i1[None, :], F32_MAX, d)
    b2 = torch.argmin(masked, dim=0, keepdim=True)
    d2 = torch.take_along_dim(masked, b2, dim=0)[0]
    i2 = torch.take_along_dim(entry, b2, dim=0)[0]

    # Combine consecutive rows of the same cell (≤ 2^n_rounds rows/cell).
    for s_exp in range(bins.n_shift_rounds):
        s = 1 << s_exp
        same = torch.cat([rows_cell[s:] == rows_cell[:-s],
                          torch.zeros((s,), dtype=torch.bool, device=dev)])

        def sh(a, fill):
            return torch.cat([a[s:], torch.full((s,), fill, dtype=a.dtype,
                                                device=dev)])

        m_d1, m_i1, m_d2, m_i2 = _combine_top2(
            d1, i1, d2, i2, sh(d1, F32_MAX), sh(i1, T), sh(d2, F32_MAX),
            sh(i2, T),
        )
        d1 = torch.where(same, m_d1, d1)
        i1 = torch.where(same, m_i1, i1)
        d2 = torch.where(same, m_d2, d2)
        i2 = torch.where(same, m_i2, i2)

    # Empty slots: force the sentinel whenever the distance says "none".
    i1 = torch.where((i1 >= T) | (d1 >= F32_MAX), -1, i1)
    i2 = torch.where((i2 >= T) | (d2 >= F32_MAX), -1, i2)

    # Spread rows → cells as ONE row gather through the host-built inverse
    # map (each cell's first, fully combined, row). Ints ride along
    # bitcast to f32.
    cell_row = torch.as_tensor(bins.cell_row, device=dev)  # (N,)
    packed = torch.stack(
        [d1, i1.view(torch.float32), d2, i2.view(torch.float32)], dim=-1
    )  # (R, 4)
    hit = cell_row >= 0
    rows = packed[torch.clamp_min(cell_row, 0).long()]  # (N, 4)
    out_d1 = torch.where(hit, rows[:, 0], F32_MAX)
    out_i1 = torch.where(hit, rows[:, 1].contiguous().view(torch.int32), -1)
    out_d2 = torch.where(hit, rows[:, 2], F32_MAX)
    out_i2 = torch.where(hit, rows[:, 3].contiguous().view(torch.int32), -1)
    return out_d1, out_i1, out_d2, out_i2


def sweep_state(grid: Grid, seed):
    """The x-first sweep state ``[d1, i1, d2, i2]``, (nx, ny, nz) each: a
    copy of the flat seed (which is not modified)."""
    shape = tuple(int(n) for n in grid.cell_count)
    return [t.reshape(shape).clone() for t in seed]


def closest_point_grid(grid: Grid, ta, tb, tc, *, seed, rounds: int = 1):
    """Unsigned distance + nearest-triangle index for every cell.

    ``seed``: flat (N,) (d1, i1, d2, i2) from :func:`seed_from_bins` (not
    modified). Runs ``rounds`` × 6 directional sweeps, Gauss-Seidel: x, y,
    z, each forward then reverse, every sweep seeing the previous one's
    result (the TPU orchestration ``closest_point_grid_pallas``). Every
    sweep updates the same x-first volumes in place (no relayout); the
    triangles' records are packed once per call (``sweep.sweep_tris``).

    Returns (dist (nx, ny, nz) f32, tri_idx (nx, ny, nz) int32).
    """
    fc, cs = grid.first_cell, grid.cell_size
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
