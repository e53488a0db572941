"""Two-phase tile culling — the analog of R-tree/BVH pruning (PyTorch
counterpart of ``ops/culling.py``).

Phase A (coarse) bounds, per tile of Morton-sorted queries or grid cells,
which triangles or blocks can hold a nearest triangle; phase B evaluates
only those exactly. Every answer is certified per query against the bound
on what was left out, and flagged queries are recomputed densely, so the
routes are exact.

Three engines, as in the JAX package:

- the gather engine (the default with a block index and a sign grid,
  :func:`_culled_gather_signed_impl`): per ``st``-query sub-tile its ``kg``
  nearest blocks, through the block-culled kernel
  (``ops.kernels.culled.culled_blocks``), with the sign from the query's
  sign-grid anchor and the segment crossings to it;
- the union engine (``M2S_CULLED_ENGINE=union``,
  :func:`_culled_blocks_signed_impl`): per 1024-query tile the union of its
  sub-tiles' candidate blocks, through the same kernel;
- the per-tile dense path without a block index
  (:func:`_query_culled_dist`, :func:`grid_distance_culled`): top-k
  triangles per tile by exact distance, plain PyTorch.

A block index is built only for CUDA tensors (``query.generate_sdf``), as
the JAX package builds one only on the TPU, so CPU tensors take JAX-on-CPU's
routes. Signs come from the sign grid (:func:`build_sign_grid`, the dense
parity kernel), tile-binned parity (:func:`binned_parity_counts`) or a
dense parity sweep.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..grid import Grid
from ..types import F32_MAX, SignMethod
from ..utils.profiling import span, spanned, sync_span
from . import brute, geometry
from .geometry import sqrt_f32
from .keyed import combine_champions
from .kernels import culled, sdf

#: Default candidate budget per tile.
DEFAULT_K = 512
#: Candidate-block budget per sub-tile for the gather engine.
DEFAULT_KG = 32
#: Widened budget for the second gather round over flagged queries.
DEFAULT_KG_WIDE = 128
#: Least size of the in-pass dense fix-up (``culling.py:183-184``).
K_FIX_MIN = 4096
#: Below this many queries, binned parity on all queries replaces the
#: sign-grid transfer.
PARITY_ALL_MAX = 131_072
#: Tile edge (cells) for grid culling; 8³ = 512 cells per tile.
GRID_TILE = 8
#: Tiles per selection chunk.
SELECT_CHUNK = 512
#: Pair elements per chunk of the plain-PyTorch tile passes.
_PAIRS = 1 << 20

#: Telemetry from the most recent fused CULLED pass (certificate flag
#: count, culled-work fraction, config). Read-only for callers.
LAST_CULLED_STATS: dict = {}

#: Self-tuned routing: (n_blocks, tb, content key, log2-bucketed Q) → True
#: when a measured culled pass showed the fused brute kernel is cheaper.
_ROUTE_CACHE: dict = {}


def _route_key(bi, Q: int):
    return (bi.n_blocks, bi.tb, getattr(bi, "content_key", 0),
            max(int(Q) - 1, 1).bit_length())


def _route_to_brute(bi, Q: int) -> bool:
    return _ROUTE_CACHE.get(_route_key(bi, Q), False)


def _record_route(bi, Q: int, work_frac: float, *, st: int,
                  k_fix_frac: float) -> None:
    """Record whether culling paid on this workload shape: predicted
    culled/brute cost = kernel work fraction + the always-paid fix-up +
    ~5 % overhead; ≥ 0.85 routes this shape to the fused kernel."""
    predicted = work_frac + k_fix_frac + 0.05
    _ROUTE_CACHE[_route_key(bi, Q)] = bool(predicted >= 0.85)


# ----------------------------------------------------------------- helpers
def _norm3(v):
    """|v| over the last axis (``jnp.linalg.norm``), root in float64."""
    return sqrt_f32(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                    + v[..., 2] * v[..., 2])


def _inverse(order):
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv


def _edge_pad(x, pad: int):
    """Repeat the last row ``pad`` times (``jnp.pad(mode="edge")``)."""
    return torch.cat([x, x[-1:].expand(pad, x.shape[1])]) if pad else x


def _first_true(mask, size: int, fill: int):
    """The first ``size`` indices where ``mask`` holds, padded with
    ``fill`` (``jnp.nonzero(size=size, fill_value=fill)``)."""
    with sync_span("sync.query.first_true", mask):
        idx = torch.nonzero(mask)
    idx = idx.reshape(-1)[:size]
    if idx.numel() < size:
        idx = torch.cat([idx, torch.full((size - idx.numel(),), fill,
                                         dtype=idx.dtype, device=idx.device)])
    return idx


def _padded_subset(queries, mask):
    """(indices where ``mask`` holds, those queries padded with query 0 to
    a multiple of 1024)."""
    with sync_span("sync.query.subset", mask):
        bad_idx = torch.nonzero(mask)
    bad_idx = bad_idx.reshape(-1)
    pad = (-bad_idx.numel()) % 1024
    bad_pad = torch.cat([bad_idx, torch.zeros(pad, dtype=bad_idx.dtype,
                                              device=bad_idx.device)])
    return bad_idx, queries[bad_pad]


def _frac(num: int, den: int) -> float:
    """``num / den`` in float32, as JAX divides an int32 count."""
    return float(np.float32(num) / np.float32(den))


def _morton_order(points):
    """Sort order by 10-bit-per-axis Morton code (spatial coherence for
    tiles); stable, as ``jnp.argsort``."""
    lo = torch.amin(points, dim=0)
    hi = torch.amax(points, dim=0)
    scale = torch.where(hi > lo, 1024.0 / (hi - lo), 0.0)
    q = torch.clamp((points - lo) * scale, 0, 1023).to(torch.int64)

    def spread(x):  # interleave 10 bits with 2-bit gaps
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return torch.argsort(code, stable=True)


def _ceil_pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


# ----------------------------------------------------- per-tile dense path
def select_candidates(tile_centers, tile_radius, ta, tb, tc, valid, k):
    """Phase A: top-k nearest triangles per tile + exactness telemetry.
    Returns (idx (Nt, k) int32, overflow (Nt,) bool, n_within (Nt,) int32);
    ``overflow`` when more than k triangles lie inside the bound
    ``dmin + 2·radius``."""
    d = geometry.point_triangle_distance(
        tile_centers[:, None, :], ta[None, :, :], tb[None, :, :],
        tc[None, :, :])
    d = torch.where(valid[None, :], d, F32_MAX)
    vals, idx = culled._smallest(d, k)
    bound = vals[:, 0] + 2.0 * tile_radius
    n_within = torch.sum(d <= bound[:, None], dim=1, dtype=torch.int32)
    return idx.to(torch.int32), n_within > k, n_within


def _select_candidates_chunked(tile_centers, tile_radius, ta, tb, tc, valid,
                               k, chunk: int = SELECT_CHUNK):
    """:func:`select_candidates` over tile chunks (bounded memory)."""
    Nt = tile_centers.shape[0]
    r = torch.as_tensor(tile_radius, dtype=torch.float32,
                        device=tile_centers.device).expand(Nt)
    chunk = max(1, min(chunk, Nt, _PAIRS // max(ta.shape[0], 1)))
    outs = [select_candidates(tile_centers[s:s + chunk], r[s:s + chunk],
                              ta, tb, tc, valid, k)
            for s in range(0, Nt, chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _tile_min(points, cand, ta, tb, tc, valid, sign):
    """Min over each tile's candidates: points (n, P, 3), cand (n, k).
    NORMAL: the normal-signed champions combined; else unsigned."""
    a, b, c, v = ta[cand], tb[cand], tc[cand], valid[cand]
    p = points[:, :, None, :]
    a, b, c, v = a[:, None], b[:, None], c[:, None], v[:, None]
    if sign == SignMethod.NORMAL:
        sd = geometry.point_triangle_signed_distance(p, a, b, c)
        neg = torch.signbit(sd)
        minpos = torch.amin(torch.where(v & ~neg, sd, F32_MAX), dim=2)
        minneg = torch.amin(torch.where(v & neg, -sd, F32_MAX), dim=2)
        return combine_champions(minpos, minneg)
    d = geometry.point_triangle_distance(p, a, b, c)
    return torch.amin(torch.where(v, d, F32_MAX), dim=2)


def _tiles_min(tiles, idx, ta, tb, tc, valid, sign):
    """:func:`_tile_min` over all tiles, a few at a time: (n_tiles, P)."""
    n, P = tiles.shape[:2]
    step = max(1, _PAIRS // (P * idx.shape[1]))
    return torch.cat([
        _tile_min(tiles[s:s + step], idx[s:s + step].long(), ta, tb, tc,
                  valid, sign)
        for s in range(0, n, step)
    ])


def _query_culled_dist_impl(queries, ta, tb, tc, valid, *, sign_method, k,
                            tile):
    Q = queries.shape[0]
    order = _morton_order(queries)
    q_sorted = queries[order]
    pad = (-Q) % tile
    q_pad = torch.cat([q_sorted, q_sorted.new_zeros((pad, 3))])
    q_tiles = q_pad.reshape(-1, tile, 3)
    tmax = torch.amax(q_tiles, dim=1)
    tmin = torch.amin(q_tiles, dim=1)
    centers = (tmax + tmin) * 0.5
    radius = _norm3((tmax - tmin) * 0.5)
    idx, overflow, _ = _select_candidates_chunked(centers, radius, ta, tb,
                                                  tc, valid, k)
    dist = _tiles_min(q_tiles, idx, ta, tb, tc, valid,
                      sign_method).reshape(-1)[:Q]
    q_overflow = overflow.repeat_interleave(tile)[:Q]
    inv = _inverse(order)
    return dist[inv], q_overflow[inv]


def _query_culled_dist(queries, ta, tb, tc, valid, *, sign_method, k, tile):
    """Distance pass (no raycast sign). Returns (dist, q_overflow):
    ``q_overflow`` is None when certified exact everywhere, else a (Q,)
    bool mask of queries to recompute densely."""
    dist, q_overflow = _query_culled_dist_impl(
        queries, ta, tb, tc, valid, sign_method=sign_method, k=k, tile=tile)
    return dist, (q_overflow if bool(q_overflow.any()) else None)


# ------------------------------------------------------ block-index engines
def _culled_blocks_impl(queries, bi, *, qt, st, nb_sub, nb_table):
    Q = queries.shape[0]
    order = _morton_order(queries)
    q_sorted = queries[order]
    # Edge-pad: zero-padding would blow up the last sub-tile's extent.
    q_pad = _edge_pad(q_sorted, (-Q) % qt)
    tbl, lb_excl, centers = culled.select_blocks(
        q_pad, bi, nb_sub=nb_sub, st=st, qt=qt, nb_table=nb_table)
    dist = culled.culled_dist(q_pad, bi, tbl, qt=qt)[:Q]
    c_q = centers.repeat_interleave(st, dim=0)[:Q]
    cert = lb_excl.repeat_interleave(st)[:Q] - _norm3(q_sorted - c_q)
    q_overflow = dist > cert * (1.0 - 1e-6)
    inv = _inverse(order)
    return dist[inv], q_overflow[inv]


def query_dist_culled_blocks(queries, block_index, *, qt=None, st=None,
                             nb_sub=None, nb_table=None):
    """Unsigned min distances through the union engine's kernel call.
    Returns (dist, q_overflow|None)."""
    Q = queries.shape[0]
    qt = qt or culled.DEFAULT_QT
    if st is None:
        st = culled.DEFAULT_ST if Q >= 262_144 else 32
    dist, q_overflow = _culled_blocks_impl(
        queries, block_index, qt=qt, st=st,
        nb_sub=nb_sub or culled.DEFAULT_NB_SUB,
        nb_table=nb_table or culled.DEFAULT_NB_TABLE)
    return dist, (q_overflow if bool(q_overflow.any()) else None)


def _grid_params(grid: Grid, device):
    with sync_span("sync.query.anchors.counts", device):
        counts = torch.tensor(grid.cell_count, dtype=torch.int32,
                              device=device)
    with sync_span("sync.query.anchors.first_cell", device):
        fc = grid.first_cell.to(device)
    with sync_span("sync.query.anchors.cell_size", device):
        cs = grid.cell_size.to(device)
    bmin = fc - 0.5 * cs
    bmax = fc + (counts.to(torch.float32) - 0.5) * cs
    return counts, fc, cs, bmin, bmax


def _cells(q, counts, cs, bmin):
    raw = torch.floor((q - bmin) / cs).to(torch.int32)
    return torch.minimum(torch.clamp_min(raw, 0), counts - 1)


@spanned("query.culled.anchors")
def _anchor_cells(q, grid: Grid):
    """Sign-grid cell, cell center, and box bounds for each query."""
    counts, fc, cs, bmin, bmax = _grid_params(grid, q.device)
    cell = _cells(q, counts, cs, bmin)
    return cell, fc + cell.to(torch.float32) * cs, bmin, bmax


def _sign_epilogue(qs, cellq, anch, bmin, bmax, inside3, dist, cnt, cert):
    """Anchor-transfer sign + certificates (union and gather engines).
    Returns (inside, flag)."""
    out_of_box = torch.any((qs < bmin[None]) | (qs > bmax[None]), dim=-1)
    reach = _norm3(qs - anch)
    transferable = out_of_box | (dist > reach * (1.0 + 1e-5))
    center_inside = inside3[cellq[:, 0].long(), cellq[:, 1].long(),
                            cellq[:, 2].long()]
    parity_inside = center_inside ^ (cnt % 2 == 1)
    inside_q = ~out_of_box & torch.where(transferable, center_inside,
                                         parity_inside)
    dist_fail = dist > cert * (1.0 - 1e-6)
    seg_fail = ~transferable & (cert < reach * (1.0 + 1e-6))
    return inside_q, dist_fail | seg_fail


@spanned("query.culled.epilogue")
def _signed_from_kernel(q_sorted, order, centers, lb_excl, st, cell,
                        anchors, bmin, bmax, inside3, d2, cnt):
    """Sign, certificate and flags of a kernel pass over Morton-sorted
    queries; back in input order."""
    Q = q_sorted.shape[0]
    dist = sqrt_f32(d2[:Q])
    c_q = centers.repeat_interleave(st, dim=0)[:Q]
    cert = lb_excl.repeat_interleave(st)[:Q] - _norm3(q_sorted - c_q)
    inside_q, flag = _sign_epilogue(q_sorted, cell[:Q], anchors[:Q], bmin,
                                    bmax, inside3, dist, cnt[:Q], cert)
    signed = torch.where(inside_q, -dist, dist)
    inv = _inverse(order)
    return signed[inv], flag[inv]


def _culled_gather_signed_impl(queries, bi, inside3, grid, *, st, kg,
                               chunk=64):
    """Per-SUB-TILE gathered pass: distance + fused anchor sign. Each
    ``st``-query sub-tile evaluates only its ``kg`` nearest blocks (the
    kernel with groups of ``st``). Returns (signed, flags, work fraction)
    in input order; flagged queries are the caller's to recompute."""
    Q = queries.shape[0]
    B = bi.n_blocks
    with span("query.culled.order"):
        order = _morton_order(queries)
        q_sorted = queries[order]
        q_pad = _edge_pad(q_sorted, (-Q) % (st * chunk))
        centers, r_s = culled._sub_tiles(q_pad, st)
    idx_kg, lb_excl = culled._phase_a_topk(centers, r_s, bi, kg=kg)
    cell, anchors, bmin, bmax = _anchor_cells(q_pad, grid)
    d2, cnt = culled.culled_blocks(q_pad, bi.gather_rows, idx_kg, group=st,
                                   n_blocks=B, anchors=anchors)
    signed, flag = _signed_from_kernel(q_sorted, order, centers, lb_excl, st,
                                       cell, anchors, bmin, bmax, inside3,
                                       d2, cnt)
    n_work = torch.sum(idx_kg != B)
    with sync_span("sync.query.work_frac", n_work):
        n_work = int(n_work)
    work_frac = _frac(n_work, idx_kg.shape[0] * B)
    return signed, flag, work_frac


def _culled_blocks_signed_impl(queries, bi, inside3, grid, *, qt, st, nb_sub,
                               nb_table):
    """Fused union-engine pass: ONE kernel call yields distance AND the
    anchor-segment crossings. Returns (signed, flags, work fraction) in
    input order."""
    Q = queries.shape[0]
    with span("query.culled.order"):
        order = _morton_order(queries)
        q_sorted = queries[order]
        q_pad = _edge_pad(q_sorted, (-Q) % qt)
    tbl, lb_excl, centers = culled.select_blocks(
        q_pad, bi, nb_sub=nb_sub, st=st, qt=qt, nb_table=nb_table)
    cell, anchors, bmin, bmax = _anchor_cells(q_pad, grid)
    d2, cnt = culled.culled_blocks(q_pad, bi.rows, tbl, group=qt,
                                   n_blocks=bi.n_blocks, anchors=anchors)
    signed, flag = _signed_from_kernel(q_sorted, order, centers, lb_excl, st,
                                       cell, anchors, bmin, bmax, inside3,
                                       d2, cnt)
    n_work = torch.sum(tbl != bi.n_blocks)
    with sync_span("sync.query.work_frac", n_work):
        n_work = int(n_work)
    work_frac = _frac(n_work, tbl.shape[0] * bi.n_blocks)
    return signed, flag, work_frac


def _culled_signed_fixup_impl(queries, bi, inside3, grid, ra, rb, rc, *,
                              qt, st, nb_sub, nb_table, k_fix, raycast_axes,
                              engine: str = "union", kg: int = 0):
    """Fused pass + dense fix-up of up to ``k_fix`` flagged queries.

    ``engine="gather"`` first re-runs up to ``k_wide`` flagged queries
    through the gather engine at ``DEFAULT_KG_WIDE`` blocks (padded with
    query Q−1, static sizes as in the JAX package). The fix-up recomputes
    the first ``k_fix`` flagged queries with the fused raycast kernel.
    Returns (signed, n_flagged, work fraction); the caller falls back to
    the host path when n_flagged > k_fix."""
    Q = queries.shape[0]
    if engine == "gather":
        signed, flag, work_frac = _culled_gather_signed_impl(
            queries, bi, inside3, grid, st=st, kg=kg)
        with span("query.culled.widen"):
            k_wide = min(max(16_384, Q // 3), 393_216)
            idxw = _first_true(flag, k_wide, Q)
            s2, f2, _ = _culled_gather_signed_impl(
                queries[torch.clamp_max(idxw, Q - 1)], bi, inside3, grid,
                st=16, kg=DEFAULT_KG_WIDE)
            real = idxw < Q
            # signed[idxw[real]] = s2[real]: one host wait per mask index.
            with sync_span("sync.query.widen.signed_values", real):
                vals = s2[real]
            with sync_span("sync.query.widen.signed_index", real):
                rows = idxw[real]
            signed[rows] = vals
            widened = flag & (torch.cumsum(flag, 0) <= k_wide)
            newf = torch.zeros_like(flag)
            with sync_span("sync.query.widen.flag_values", real):
                vals = f2[real]
            with sync_span("sync.query.widen.flag_index", real):
                rows = idxw[real]
            newf[rows] = vals
            flag = torch.where(widened, newf, flag)
    else:
        signed, flag, work_frac = _culled_blocks_signed_impl(
            queries, bi, inside3, grid, qt=qt, st=st, nb_sub=nb_sub,
            nb_table=nb_table)
    n_flag = torch.sum(flag)
    with sync_span("sync.query.n_flag", n_flag):
        n_flag = int(n_flag)
    with span("query.culled.fixup"):
        idx = _first_true(flag, k_fix, Q)
        sub = sdf.sdf_raycast(queries[torch.clamp_max(idx, Q - 1)], ra, rb,
                              rc, raycast_axes=raycast_axes)
        real = idx < Q
        with sync_span("sync.query.fixup.values", real):
            vals = sub[real]
        with sync_span("sync.query.fixup.index", real):
            rows = idx[real]
        signed[rows] = vals
    return signed, n_flag, work_frac


# ----------------------------------------------------------- entry point
def query_sdf_culled(queries, ta, tb, tc, valid, *, sign_method,
                     raycast_axes=3, k: int = DEFAULT_K, tile: int = 1024,
                     parity_bins=None, n_valid_tris: Optional[int] = None,
                     sign_grid=None, block_index=None, st=None, nb_sub=None,
                     nb_table=None):
    """generate_sdf with Morton-ordered query tiling + candidate culling —
    the analog of the reference's Rtree/RtreeBvh backends
    (`rtree.rs:96-126`, `rtree_bvh.rs:123-173`). Exact: every route
    certifies each query and recomputes the flagged ones densely. Falls back
    to the brute engine when the triangle count is within 2·k.

    With ``block_index`` and ``sign_grid`` (raycast sign), one fused pass
    (gather engine, or ``M2S_CULLED_ENGINE=union``) gives distance and
    sign; without them, :func:`_query_culled_dist` gives distances and the
    sign comes from ``parity_bins`` or the sign grid (built if not given).
    queries: (Q, 3) f32 contiguous; ta/tb/tc (T, 3) padded, ``valid``
    masking the padding, all on one device.
    """
    T = int(ta.shape[0])
    if T <= 2 * k:
        return brute.sdf_brute(
            queries, ta, tb, tc, valid, sign_method=sign_method,
            raycast_axes=(raycast_axes if sign_method == SignMethod.RAYCAST
                          else 0))
    n_valid = valid.sum()
    with sync_span("sync.query.n_valid", n_valid):
        n_valid = int(n_valid)
    ra, rb, rc = ta[:n_valid], tb[:n_valid], tc[:n_valid]
    on_cuda = queries.device.type == "cuda"
    Q = queries.shape[0]
    default_cfg = st is None and nb_sub is None and nb_table is None
    fused = (block_index is not None and sign_method == SignMethod.RAYCAST
             and sign_grid is not None)
    if fused and default_cfg and _route_to_brute(block_index, Q):
        # A previous call on this mesh at this batch size measured the
        # culled work fraction high enough that the fused kernel is faster.
        return sdf.sdf_raycast(queries, ra, rb, rc,
                               raycast_axes=raycast_axes)
    if fused:
        engine = os.environ.get("M2S_CULLED_ENGINE", "gather")
        if st is None:
            st = (64 if Q >= 262_144 else 16) if engine == "union" else (
                32 if Q < 262_144 else 64)
        kg = DEFAULT_KG
        qt = culled.DEFAULT_QT
        nb_table = nb_table or culled.DEFAULT_NB_TABLE
        n_qt = -(-Q // qt)
        nb_table = max(min(nb_table, (2**20 // 4) // max(n_qt, 1) - 8), 16)
        # The fix-up always runs at k_fix queries: cap its pair budget.
        k_fix = min(max(K_FIX_MIN, Q // 32), 65_536,
                    max(K_FIX_MIN, int(6e9) // max(n_valid, 1)))
        nb_sub = nb_sub or culled.DEFAULT_NB_SUB
        signed, n_flag, work_frac = _culled_signed_fixup_impl(
            queries, block_index, sign_grid.inside, sign_grid.grid, ra, rb,
            rc, qt=qt, st=st, nb_sub=nb_sub, nb_table=nb_table, k_fix=k_fix,
            raycast_axes=raycast_axes, engine=engine, kg=kg)
        if default_cfg:
            _record_route(block_index, Q, work_frac, st=st,
                          k_fix_frac=k_fix / max(Q, 1))
        LAST_CULLED_STATS.update(
            queries=int(Q), tris=int(n_valid), engine=engine,
            n_flagged=n_flag, flag_frac=round(n_flag / max(Q, 1), 5),
            work_frac=round(work_frac, 5), k_fix=int(k_fix), st=int(st),
        )
        if n_flag > k_fix:
            # Budget blown: redo ALL flagged queries — exactness never
            # depends on k_fix.
            with span("query.culled.fallback"):
                if engine == "gather":
                    _, flag, _ = _culled_gather_signed_impl(
                        queries, block_index, sign_grid.inside,
                        sign_grid.grid, st=st, kg=kg)
                else:
                    _, flag, _ = _culled_blocks_signed_impl(
                        queries, block_index, sign_grid.inside,
                        sign_grid.grid, qt=qt, st=st, nb_sub=nb_sub,
                        nb_table=nb_table)
                bad_idx, subset = _padded_subset(queries, flag)
                if on_cuda:
                    sub = sdf.sdf_raycast(subset, ra, rb, rc,
                                          raycast_axes=raycast_axes)
                else:
                    sub = brute.sdf_brute(
                        subset, ta, tb, tc, valid, sign_method=sign_method,
                        raycast_axes=raycast_axes,
                        query_chunk=subset.shape[0])
                signed[bad_idx] = sub[:bad_idx.numel()]
        return signed

    if block_index is not None and sign_method == SignMethod.RAYCAST:
        dist, q_overflow = query_dist_culled_blocks(queries, block_index)
    else:
        dist, q_overflow = _query_culled_dist(
            queries, ta, tb, tc, valid, sign_method=sign_method, k=k,
            tile=tile)
    if q_overflow is not None:
        # Queries of tiles whose bound holds more than k triangles:
        # recompute just those densely. Stays exact.
        bad_idx, subset = _padded_subset(queries, q_overflow)
        if on_cuda and sign_method == SignMethod.NORMAL:
            sub = sdf.sdf_normal(subset, ra, rb, rc)
        elif on_cuda:
            sub = sdf.sdf_raycast(subset, ra, rb, rc, raycast_axes=0)
        else:
            sub = brute.sdf_brute(subset, ta, tb, tc, valid,
                                  sign_method=sign_method, raycast_axes=0,
                                  query_chunk=subset.shape[0])
        dist[bad_idx] = sub[:bad_idx.numel()]

    if sign_method == SignMethod.RAYCAST:
        if parity_bins is not None and (sign_grid is None
                                        or Q <= PARITY_ALL_MAX):
            inside = _binned_inside(queries, ta, tb, tc, parity_bins,
                                    raycast_axes, n_valid_tris)
        else:
            sg = sign_grid if sign_grid is not None else build_sign_grid(
                ta, tb, tc, valid)
            inside = signs_from_grid(queries, dist, sg, ta, tb, tc, valid,
                                     raycast_axes, parity_bins=parity_bins)
        dist = torch.where(inside, -dist, dist)
    return dist


# ------------------------------------------------------------------- signs
def _vote(odd, raycast_axes: int):
    if raycast_axes == 1:
        return odd[:, 0]
    return torch.sum(odd, dim=1) >= 2


def _binned_inside(queries, ta, tb, tc, parity_bins, raycast_axes, n_valid):
    counts = binned_parity_counts(queries, ta, tb, tc,
                                  parity_bins[:raycast_axes], n_valid=n_valid)
    return _vote(counts % 2 == 1, raycast_axes)


class ParityBins(NamedTuple):
    """Per-axis 2-D triangle bins for +axis rays (the analog of the
    reference's BVH ray traversal, `bvh.rs:62-144`).

    table: (G*G, K) int32 triangle ids (T = empty); lo2/inv_ts: (2,) f32
    grid transform; g: tiles per side. Numpy from
    :func:`build_parity_bins`, tensors once uploaded.
    """

    table: object
    lo2: object
    inv_ts: object
    g: int


def build_parity_bins(ta, tb, tc, axis: int, *, g: int = 64,
                      n_valid: Optional[int] = None) -> ParityBins:
    """Bin triangles by transverse 2-D AABB for +``axis`` rays (host
    numpy, a copy of ``culling.build_parity_bins``)."""
    ta = np.asarray(ta, np.float32)
    tb = np.asarray(tb, np.float32)
    tc = np.asarray(tc, np.float32)
    T = len(ta) if n_valid is None else int(n_valid)
    ta, tb, tc = ta[:T], tb[:T], tc[:T]
    iy, iz = (axis + 1) % 3, (axis + 2) % 3
    tv2 = np.stack(
        [ta[:, [iy, iz]], tb[:, [iy, iz]], tc[:, [iy, iz]]], axis=1
    )  # (T, 3, 2)
    eps = 1e-5
    lo = tv2.min(axis=1) - eps
    hi = tv2.max(axis=1) + eps
    if T == 0:
        return ParityBins(
            np.zeros((g * g, 1), np.int32), np.zeros(2, np.float32),
            np.ones(2, np.float32), g,
        )
    gl = lo.min(axis=0)
    gh = hi.max(axis=0)
    ts = np.maximum((gh - gl) / g, 1e-12)
    lo_t = np.clip(np.floor((lo - gl) / ts).astype(np.int64), 0, g - 1)
    hi_t = np.clip(np.floor((hi - gl) / ts).astype(np.int64), 0, g - 1)
    w = hi_t - lo_t + 1
    n_per = w[:, 0] * w[:, 1]
    starts = np.zeros(T + 1, np.int64)
    np.cumsum(n_per, out=starts[1:])
    E = int(starts[-1])
    tri_of = np.repeat(np.arange(T, dtype=np.int64), n_per)
    within = np.arange(E, dtype=np.int64) - starts[tri_of]
    dy = within // w[tri_of, 1]
    dz = within % w[tri_of, 1]
    tile = (lo_t[tri_of, 0] + dy) * g + (lo_t[tri_of, 1] + dz)

    order = np.argsort(tile, kind="stable")
    tile_s = tile[order]
    tri_s = tri_of[order].astype(np.int32)
    seg_start = np.empty(E, bool)
    seg_start[0] = True
    np.not_equal(tile_s[1:], tile_s[:-1], out=seg_start[1:])
    seg_first = np.flatnonzero(seg_start)
    seg_id = np.cumsum(seg_start) - 1
    rank = np.arange(E, dtype=np.int64) - seg_first[seg_id]
    counts = np.diff(np.append(seg_first, E))
    K = int(counts.max())
    table = np.full((g * g, K), T, np.int32)
    table[tile_s, rank] = tri_s
    return ParityBins(
        table, gl.astype(np.float32), (1.0 / ts).astype(np.float32), g
    )


def upload_parity_bins(bins: ParityBins, device) -> ParityBins:
    """The bins' arrays as tensors on ``device``."""
    return ParityBins(*(
        x.to(device) if isinstance(x, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(x)).to(device)
        for x in bins[:3]), bins.g)


def binned_parity_counts(queries, ta, tb, tc, bins3, *,
                         n_valid: Optional[int] = None, chunk: int = 2048):
    """Crossing counts (Q, axes) through per-axis 2-D tile bins: each query
    tests only its tile's triangles, with the float ops of
    ``geometry.ray_triangle_aligned``, so counts equal a full sweep's."""
    Q = queries.shape[0]
    T = int(ta.shape[0]) if n_valid is None else int(n_valid)
    dev = queries.device
    bins3 = [upload_parity_bins(b, dev) for b in bins3]
    planes = []
    for axis in range(len(bins3)):
        ix, iy, iz = axis, (axis + 1) % 3, (axis + 2) % 3
        p9 = torch.stack(
            [ta[:T, ix], ta[:T, iy], ta[:T, iz],
             tb[:T, ix], tb[:T, iy], tb[:T, iz],
             tc[:T, ix], tc[:T, iy], tc[:T, iz]], dim=-1)
        planes.append(torch.cat([p9, p9.new_zeros((1, 9))]))
    out = torch.zeros((Q, len(bins3)), dtype=torch.int32, device=dev)
    for s in range(0, Q, chunk):
        qc = queries[s:s + chunk]
        for axis, b in enumerate(bins3):
            iy, iz = (axis + 1) % 3, (axis + 2) % 3
            q2 = torch.stack([qc[:, iy], qc[:, iz]], dim=-1)
            t2 = torch.clamp(torch.floor((q2 - b.lo2) * b.inv_ts).to(
                torch.int32), 0, b.g - 1)
            lists = b.table[(t2[:, 0] * b.g + t2[:, 1]).long()]  # (c, K)
            v = lists < T
            g9 = planes[axis][torch.clamp_max(lists, T).long()].permute(
                2, 0, 1)
            axc, ayc, azc, bxc, byc, bzc, cxc, cyc, czc = g9
            ox = qc[:, axis, None]
            oy = qc[:, iy, None]
            oz = qc[:, iz, None]
            e12y, e12z = cyc - byc, czc - bzc
            e20y, e20z = ayc - cyc, azc - czc
            e01y, e01z = byc - ayc, bzc - azc
            p0y, p0z = oy - ayc, oz - azc
            p1y, p1z = oy - byc, oz - bzc
            p2y, p2z = oy - cyc, oz - czc
            w0 = p1z * e12y - p1y * e12z
            w1 = p2z * e20y - p2y * e20z
            w2 = p0z * e01y - p0y * e01z
            inside = ((w0 < 0.0) & (w1 < 0.0) & (w2 < 0.0)) | (
                (w0 > 0.0) & (w1 > 0.0) & (w2 > 0.0))
            wsum = w0 + w1 + w2
            num = w0 * (ox - axc) + w2 * (ox - cxc) + w1 * (ox - bxc)
            t = -num / torch.where(wsum == 0.0, 1.0, wsum)
            out[s:s + chunk, axis] = torch.sum(inside & (t > 0.0) & v, dim=1,
                                               dtype=torch.int32)
    return out


class SignGrid(NamedTuple):
    """Coarse exact inside/outside mask used to sign scattered queries: a
    query whose exact unsigned distance exceeds its distance to its cell
    center lies in that center's connected component, so the center's sign
    transfers. Assumes a watertight mesh (`lib.rs:204-216`)."""

    inside: object  # (res, res, res) bool
    grid: object  # Grid


def build_sign_grid(ta, tb, tc, valid, *, res: int = 128,
                    margin: float = 0.02) -> SignGrid:
    """Exact parity grid over the mesh bbox (+margin), on the triangles'
    device (dense line parity: the kernel on CUDA, its plain version on the
    CPU)."""
    from . import raycast

    vm = valid[:, None]
    inf = float("inf")
    lo = torch.amin(torch.minimum(torch.minimum(
        torch.where(vm, ta, inf), torch.where(vm, tb, inf)),
        torch.where(vm, tc, inf)), dim=0).cpu().numpy()
    hi = torch.amax(torch.maximum(torch.maximum(
        torch.where(vm, ta, -inf), torch.where(vm, tb, -inf)),
        torch.where(vm, tc, -inf)), dim=0).cpu().numpy()
    pad = (hi - lo) * margin + 1e-6
    grid = Grid.from_bounding_box(lo - pad, hi + pad, [res] * 3)
    inside = raycast.grid_inside_mask(grid, ta, tb, tc, valid)
    return SignGrid(inside=inside, grid=grid)


def _grid_transfer(queries, dist_unsigned, inside, grid: Grid):
    counts, fc, cs, bmin, bmax = _grid_params(grid, queries.device)
    # Beyond the sign grid's box a query is in the unbounded exterior.
    out_of_box = torch.any((queries < bmin[None]) | (queries > bmax[None]),
                           dim=-1)
    cell = _cells(queries, counts, cs, bmin).long()
    reach = _norm3(queries - (fc + cell.to(torch.float32) * cs))
    transferable = out_of_box | (dist_unsigned > reach * (1.0 + 1e-5))
    inside_q = ~out_of_box & inside[cell[:, 0], cell[:, 1], cell[:, 2]]
    return inside_q, transferable


def signs_from_grid(queries, dist_unsigned, sg: SignGrid, ta, tb, tc, valid,
                    raycast_axes: int = 3, parity_bins=None):
    """Inside mask for queries: sign-grid transfer + exact near-surface
    fallback (tile-binned parity with ``parity_bins``; else the fused
    raycast kernel on CUDA, a dense parity sweep on the CPU). (Q,) bool."""
    inside_q, transferable = _grid_transfer(queries, dist_unsigned,
                                            sg.inside, sg.grid)
    if bool(transferable.all()):
        return inside_q
    bad_idx, subset = _padded_subset(queries, ~transferable)
    n_valid = int(valid.sum())
    if parity_bins is not None:
        sub_inside = _binned_inside(subset, ta, tb, tc, parity_bins,
                                    raycast_axes, n_valid)
    else:
        if queries.device.type == "cuda":
            _, sub_counts = sdf.sdf_raycast_parts(
                subset, ta[:n_valid], tb[:n_valid], tc[:n_valid],
                raycast_axes=raycast_axes)
        else:
            sub_counts = _ray_parity_counts(subset, ta, tb, tc, valid,
                                            raycast_axes)
        sub_inside = _vote(sub_counts % 2 == 1, raycast_axes)
    inside_q = inside_q.clone()
    inside_q[bad_idx] = sub_inside[:bad_idx.numel()]
    return inside_q


def _ray_parity_counts(queries, ta, tb, tc, valid, raycast_axes,
                       tri_block=512, chunk=2048):
    """Dense +axis crossing counts (Q, axes) over every valid triangle."""
    ta, tb, tc, valid, tri_block = brute.pad_tri_blocks(ta, tb, tc, valid,
                                                        tri_block)
    out = []
    for s in range(0, queries.shape[0], chunk):
        qc = queries[s:s + chunk, None, :]
        counts = torch.zeros((qc.shape[0], raycast_axes), dtype=torch.int32,
                             device=queries.device)
        for j in range(0, ta.shape[0], tri_block):
            a, b, c, v = (x[j:j + tri_block] for x in (ta, tb, tc, valid))
            hits = torch.stack([
                geometry.ray_triangle_aligned(qc, a[None], b[None], c[None],
                                              axis)[0]
                for axis in range(raycast_axes)], dim=-1)
            counts += torch.sum(hits & v[None, :, None], dim=1,
                                dtype=torch.int32)
        out.append(counts)
    return torch.cat(out)


# -------------------------------------------------------------- grid route
def _grid_culled_impl(grid: Grid, ta, tb, tc, valid, *, sign, k, tile):
    """One culled pass over the grid. Returns (dist3, overflow (n_tiles,),
    n_within (n_tiles,))."""
    nx, ny, nz = grid.cell_count
    t = tile
    X, Y, Z = nx + (-nx) % t, ny + (-ny) % t, nz + (-nz) % t
    dev = ta.device
    # Edge-pad so every axis divides the tile edge (sliced away below).
    axes = [grid.axis_centers(k_, dev)[torch.clamp_max(
        torch.arange(n_p, device=dev), n - 1)]
        for k_, (n, n_p) in enumerate(((nx, X), (ny, Y), (nz, Z)))]
    shape = (X, Y, Z)
    centers = torch.stack([axes[0][:, None, None].expand(shape),
                           axes[1][None, :, None].expand(shape),
                           axes[2][None, None, :].expand(shape)], dim=-1)
    tiles = (centers.reshape(X // t, t, Y // t, t, Z // t, t, 3)
             .permute(0, 2, 4, 1, 3, 5, 6).reshape(-1, t * t * t, 3))
    tmin = torch.amin(tiles, dim=1)
    tmax = torch.amax(tiles, dim=1)
    idx, overflow, n_within = _select_candidates_chunked(
        (tmin + tmax) * 0.5, _norm3((tmax - tmin) * 0.5), ta, tb, tc, valid,
        k)
    dist = _tiles_min(tiles, idx, ta, tb, tc, valid, sign)
    dist3 = (dist.reshape(X // t, Y // t, Z // t, t, t, t)
             .permute(0, 3, 1, 4, 2, 5).reshape(X, Y, Z)[:nx, :ny, :nz])
    return dist3, overflow, n_within


def grid_distance_culled(grid: Grid, ta, tb, tc, valid, *, sign,
                         k: int = DEFAULT_K, tile: int = GRID_TILE):
    """Grid unsigned (or normal-signed) distances via per-tile candidate
    culling, exact by construction: a tile whose bound holds more than k
    triangles triggers one retry at the measured count; with k at or above
    the triangle count, a dense sweep. (The raycast sign is the caller's.)
    """
    T = int(ta.shape[0])
    n_valid = int(valid.sum()) if T else 0
    if k < n_valid:
        dist3, overflow, n_within = _grid_culled_impl(
            grid, ta, tb, tc, valid, sign=sign, k=k, tile=tile)
        if not bool(overflow.any()):
            return dist3
        k = _ceil_pow2(int(n_within.max()))
        if k < n_valid:
            dist3, overflow, _ = _grid_culled_impl(
                grid, ta, tb, tc, valid, sign=sign, k=k, tile=tile)
            assert not bool(overflow.any())
            return dist3
    centers = grid.all_cell_centers(ta.device).reshape(-1, 3)
    N = centers.shape[0]
    chunk = min(brute.DEFAULT_QUERY_CHUNK, N)
    centers = torch.cat([centers, centers.new_zeros(((-N) % chunk, 3))])
    dist = brute.sdf_brute(centers, ta, tb, tc, valid, sign_method=sign,
                           raycast_axes=0, query_chunk=chunk)[:N]
    return dist.reshape(grid.cell_count)
