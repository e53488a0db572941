"""Differentiable SDF: autograd through the closest-point projection
(PyTorch counterpart of ``ops/autodiff.py``).

Vertex gradients d(SDF)/d(vertices) and d(SDF)/d(queries) make SDF
generation a trainable layer (BASELINE.json north star).

Math (envelope theorem): the Embree region ladder (`geo.rs:70-138`) is a
piecewise-smooth projection; at the minimum over triangles, with barycentric
coordinates (u, v, w) of the closest point q = u·a + v·b + w·c,

    d = |p − q|,  n̂ = (p − q)/d
    ∂d/∂p = n̂,   ∂d/∂a = −u·n̂,  ∂d/∂b = −v·n̂,  ∂d/∂c = −w·n̂

with the region choice and the argmin triangle held fixed, and the sign
(raycast parity, or the normal-side test) also held fixed. The forward pass
saves only per-query argmin indices; the backward re-gathers one triangle per
query and adds into the vertex array with ``index_add_`` (atomic adds on
CUDA, so the order of the float additions, and the last bits of a
gradient, may change from run to run there).

- :func:`unsigned_min_distance` and :func:`signed_champion_distances` are
  the exact O(Q·T) reductions, blocked over triangles as the JAX package's
  ``lax.scan`` is (strict ``<`` across blocks, the first index within a
  block), in torch ops on any device: the JAX package runs them in XLA, so
  they reach no kernel there and have none here. Queries go in chunks, so
  the (chunk, block) temporaries stay bounded; the result does not depend
  on the chunk.
- :func:`make_cpt_grid_distance` runs the O(cells + tris) CPT engine
  forward: :func:`ops.cpt._seed` and :func:`ops.cpt.closest_point_grid`,
  whose six directional sweeps are the sweep kernel on CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..grid import Grid
from ..types import F32_MAX
from . import brute, geometry

_EPS = 1e-12

#: Query × triangle pairs per (chunk, block) evaluation of the dense
#: reductions: bounds their temporaries (a few dozen (chunk, block) float32
#: tensors) to about 1 GiB.
PAIRS_PER_CHUNK = 1 << 22


def _gather_tris(vertices, tri_idx):
    """(ta, tb, tc, valid) of (M, 3) int ``tri_idx`` with -1 sentinel rows
    (gathered as vertex 0, masked by ``valid``)."""
    ids = torch.clamp_min(tri_idx, 0).long()
    return (vertices[ids[:, 0]], vertices[ids[:, 1]], vertices[ids[:, 2]],
            tri_idx[:, 0] >= 0)


def _blocked(ta, tb, tc, valid, block):
    """Split the triangles into (nb, block) blocks, padding with invalid
    entries. Returns the blocked arrays and the effective block."""
    ta, tb, tc, valid, block = brute.pad_tri_blocks(ta, tb, tc, valid, block)
    nb = ta.shape[0] // block
    return [t.reshape((nb, block) + t.shape[1:])
            for t in (ta, tb, tc, valid)], block


def _query_chunks(n_queries: int, block: int):
    chunk = max(1, PAIRS_PER_CHUNK // block)
    return [slice(s, s + chunk) for s in range(0, n_queries, chunk)]


def _block_argmin(d):
    """(min, first index of the min) along axis 1."""
    arg = torch.argmin(d, dim=1, keepdim=True)
    return torch.take_along_dim(d, arg, dim=1)[:, 0], arg[:, 0].to(
        torch.int32)


# =====================================================================
# Unsigned min distance (raycast-mode distance)
# =====================================================================
def _min_forward(vertices, tri_idx, queries, block):
    ta, tb, tc, valid = _gather_tris(vertices, tri_idx)
    Q = queries.shape[0]
    (ba, bb, bc, bv), block = _blocked(ta, tb, tc, valid, block)
    mind = torch.full((Q,), F32_MAX, dtype=torch.float32,
                      device=queries.device)
    mini = torch.zeros((Q,), dtype=torch.int32, device=queries.device)
    for rows in _query_chunks(Q, block):
        q = queries[rows, None, :]
        md, mi = mind[rows], mini[rows]
        for blk in range(ba.shape[0]):
            d = geometry.point_triangle_distance(q, ba[blk][None],
                                                 bb[blk][None], bc[blk][None])
            d = torch.where(bv[blk][None, :], d, F32_MAX)
            dblk, arg = _block_argmin(d)
            better = dblk < md
            md = torch.where(better, dblk, md)
            mi = torch.where(better, blk * block + arg, mi)
        mind[rows], mini[rows] = md, mi
    mini = torch.clamp_max(mini, tri_idx.shape[0] - 1)  # out of the pad zone
    return mind, mini


def _envelope_grads(vertices, tri_idx, queries, d, argmin, g):
    """Shared backward: distribute g·n̂ to the query and (−bary)·g·n̂ to the
    argmin triangle's vertices."""
    ids = torch.clamp_min(tri_idx, 0)[argmin.long()].long()  # (Q, 3)
    a = vertices[ids[:, 0]]
    b = vertices[ids[:, 1]]
    c = vertices[ids[:, 2]]
    bary = geometry.closest_point_barycentric(queries, a, b, c)  # (Q, 3)
    q = bary[:, 0:1] * a + bary[:, 1:2] * b + bary[:, 2:3] * c
    # Guard d == 0 (on-surface) and d == F32_MAX (no triangle).
    ok = (d > 0.0) & (d < F32_MAX)
    inv = torch.where(ok, 1.0 / torch.clamp_min(d, _EPS), 0.0)
    gq = g[:, None] * ((queries - q) * inv[:, None])
    contrib = -gq[:, None, :] * bary[:, :, None]  # (Q, 3 verts, 3 coords)
    gv = torch.zeros_like(vertices).index_add_(0, ids.reshape(-1),
                                               contrib.reshape(-1, 3))
    return gv, gq


class _UnsignedMinDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vertices, tri_idx, queries, block):
        d, argmin = _min_forward(vertices, tri_idx, queries, block)
        ctx.save_for_backward(vertices, tri_idx, queries, d, argmin)
        return d

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        vertices, tri_idx, queries, d, argmin = ctx.saved_tensors
        gv, gq = _envelope_grads(vertices, tri_idx, queries, d, argmin, g)
        return gv, None, gq, None


def unsigned_min_distance(vertices, tri_idx, queries, block=512):
    """min over triangles of |p − closest_point(p, tri)|. (Q,) float32,
    differentiable in ``vertices`` and ``queries``.

    vertices: (V, 3); tri_idx: (M, 3) int32 with -1 sentinel rows (masked;
    see ``models.sdf_layer.pad_tri_idx``); queries: (Q, 3); all on one
    device.
    """
    return _UnsignedMinDistance.apply(vertices, tri_idx, queries, block)


# =====================================================================
# Normal-sign champions on the (min_pos, min_neg) pair
# =====================================================================
def _champ_forward(vertices, tri_idx, queries, block):
    ta, tb, tc, valid = _gather_tris(vertices, tri_idx)
    Q = queries.shape[0]
    (ba, bb, bc, bv), block = _blocked(ta, tb, tc, valid, block)
    dev = queries.device
    mp = torch.full((Q,), F32_MAX, dtype=torch.float32, device=dev)
    mn = torch.full((Q,), F32_MAX, dtype=torch.float32, device=dev)
    ip = torch.zeros((Q,), dtype=torch.int32, device=dev)
    im = torch.zeros((Q,), dtype=torch.int32, device=dev)
    for rows in _query_chunks(Q, block):
        q = queries[rows, None, :]
        cp, cip, cn, cim = mp[rows], ip[rows], mn[rows], im[rows]
        for blk in range(ba.shape[0]):
            sd = geometry.point_triangle_signed_distance(
                q, ba[blk][None], bb[blk][None], bc[blk][None])
            neg = torch.signbit(sd)
            v = bv[blk][None, :]
            bp, argp = _block_argmin(torch.where(v & ~neg, sd, F32_MAX))
            bn, argn = _block_argmin(torch.where(v & neg, -sd, F32_MAX))
            betterp = bp < cp
            bettern = bn < cn
            cp = torch.where(betterp, bp, cp)
            cip = torch.where(betterp, blk * block + argp, cip)
            cn = torch.where(bettern, bn, cn)
            cim = torch.where(bettern, blk * block + argn, cim)
        mp[rows], ip[rows], mn[rows], im[rows] = cp, cip, cn, cim
    last = tri_idx.shape[0] - 1
    return mp, mn, torch.clamp_max(ip, last), torch.clamp_max(im, last)


class _SignedChampionDistances(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vertices, tri_idx, queries, block):
        mp, mn, ip, im = _champ_forward(vertices, tri_idx, queries, block)
        ctx.save_for_backward(vertices, tri_idx, queries, mp, ip, mn, im)
        return mp, mn

    @staticmethod
    @once_differentiable
    def backward(ctx, gp, gn):
        vertices, tri_idx, queries, mp, ip, mn, im = ctx.saved_tensors
        gv1, gq1 = _envelope_grads(vertices, tri_idx, queries, mp, ip, gp)
        gv2, gq2 = _envelope_grads(vertices, tri_idx, queries, mn, im, gn)
        return gv1 + gv2, None, gq1 + gq2, None


def signed_champion_distances(vertices, tri_idx, queries, block=512):
    """Two champions per query (``ops.keyed`` semantics): smallest positive
    signed distance and smallest magnitude among negatives, both (Q,),
    differentiable. Combine with :func:`ops.keyed.combine_champions` (its
    ``where`` selection is itself differentiable)."""
    return _SignedChampionDistances.apply(vertices, tri_idx, queries, block)


# =====================================================================
# CPT-backed grid distance: O(cells + tris) forward, envelope backward
# =====================================================================
class _CptGridDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vertices, fn):
        dist, idx = fn.forward(vertices)
        ctx.fn = fn
        ctx.save_for_backward(vertices, dist, idx)
        return dist

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        vertices, dist, idx = ctx.saved_tensors
        return ctx.fn.vjp(vertices, dist, idx, g), None


class CptGridDistance:
    """``f(vertices) -> dist (nx, ny, nz)``, differentiable in ``vertices``:
    the CPT engine forward, the envelope backward
    (:func:`make_cpt_grid_distance`). :meth:`forward` and :meth:`vjp` are
    the two halves, also callable alone."""

    def __init__(self, grid: Grid, tri_idx, parents, wa, wb, wc):
        self.grid = grid
        self._host = dict(tri_idx=tri_idx, parents=parents, wa=wa, wb=wb,
                          wc=wc)
        self._on = {}

    def _consts(self, device):
        """The build-time arrays on ``device`` (moved once per device)."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = {k: v.to(device) for k, v in self._host.items()}
        return self._on[key]

    def sub_triangles(self, vertices):
        """The subdivided soup (ta, tb, tc), each vertex mixed from its
        parent's corners in the live ``vertices``."""
        k = self._consts(vertices.device)
        corners = k["tri_idx"][k["parents"]]  # (M', 3)
        pa = vertices[corners[:, 0]]
        pb = vertices[corners[:, 1]]
        pc = vertices[corners[:, 2]]

        def mix(w):
            return w[:, 0:1] * pa + w[:, 1:2] * pb + w[:, 2:3] * pc

        return mix(k["wa"]), mix(k["wb"]), mix(k["wc"])

    @torch.no_grad()
    def forward(self, vertices):
        """(dist (nx, ny, nz) f32, sub-triangle id (nx, ny, nz) int32):
        window-scatter seed, then one round of six directional sweeps."""
        from . import cpt

        ta, tb, tc = self.sub_triangles(vertices.detach())
        seed = cpt._seed(self.grid, ta, tb, tc, cpt.SEED_SPAN)
        return cpt.closest_point_grid(self.grid, ta, tb, tc, seed=seed)

    @torch.no_grad()
    def vjp(self, vertices, dist, idx, g):
        """d(<g, dist>)/d(vertices), (V, 3): barycentrics w.r.t. each
        cell's PARENT triangle (the closest point on a sub-triangle lies on
        its parent, and the sub-triangles move affinely with the parent's
        corners, so this is exact); a cell with no triangle (id -1) adds
        nothing."""
        k = self._consts(vertices.device)
        centers = self.grid.all_cell_centers(vertices.device).reshape(-1, 3)
        flat = idx.reshape(-1)
        par = k["parents"][torch.clamp_min(flat, 0).long()]
        ids = k["tri_idx"][par]  # (N, 3) original vertex indices
        a = vertices[ids[:, 0]]
        b = vertices[ids[:, 1]]
        c = vertices[ids[:, 2]]
        bary = geometry.closest_point_barycentric(centers, a, b, c)
        q = bary[:, 0:1] * a + bary[:, 1:2] * b + bary[:, 2:3] * c
        d = dist.reshape(-1)
        ok = (d > 0.0) & (d < F32_MAX) & (flat >= 0)
        inv = torch.where(ok, 1.0 / torch.clamp_min(d, _EPS), 0.0)
        gq = g.reshape(-1)[:, None] * ((centers - q) * inv[:, None])
        contrib = -gq[:, None, :] * bary[:, :, None]
        return torch.zeros_like(vertices).index_add_(0, ids.reshape(-1),
                                                     contrib.reshape(-1, 3))

    def __call__(self, vertices):
        return _CptGridDistance.apply(vertices, self)


def make_cpt_grid_distance(grid: Grid, tri_idx_np, vertices_example):
    """Build a differentiable ``f(vertices) -> dist (nx, ny, nz)`` that runs
    the CPT engine forward (O(cells + tris), see ops/cpt.py) and the
    envelope backward: the scalable path for DifferentiableSDF at big grids
    (the O(Q·T) :func:`unsigned_min_distance` is the small, exact one).

    tri_idx_np: (M, 3) int numpy vertex indices (static: the subdivision
    structure is fixed at build time from ``vertices_example``).

    The JAX package's ``use_pallas`` switch has no counterpart: the device
    of the vertices picks the sweep kernel (CUDA) or its plain version (CPU)
    at each call, as everywhere in the port. Either way the forward is the
    TPU route's orchestration (``closest_point_grid_pallas``: Gauss-Seidel
    sweeps, one round); the JAX package's CPU route runs batched Jacobi
    sweeps on cubic grids instead, whose distances may differ beyond the
    seed band.
    """
    from . import cpt

    tri_idx_np = np.asarray(tri_idx_np, np.int64)
    v0 = np.asarray(
        vertices_example.detach().cpu() if isinstance(vertices_example,
                                                      torch.Tensor)
        else vertices_example, np.float32)
    cs = float(np.max(np.abs(grid.cell_size.numpy())))
    max_edge = (cpt.SEED_SPAN - 1.5) * cs
    ra, rb, rc, parents = cpt.subdivide_to_span(
        v0, tri_idx_np, max_edge=max_edge, return_parents=True)
    # Per-subdivided-vertex barycentric weights w.r.t. the parent corners:
    # every subdivided vertex is an affine combination of its parent's
    # corners; solving the barycentric system per vertex at build time lets
    # the forward recompute sub-triangles from live vertices.
    pa = v0[tri_idx_np[parents, 0]]
    pb = v0[tri_idx_np[parents, 1]]
    pc = v0[tri_idx_np[parents, 2]]

    def bary_weights(p):
        # least-squares barycentrics of p in triangle (pa, pb, pc)
        e0 = pb - pa
        e1 = pc - pa
        d = p - pa
        d00 = (e0 * e0).sum(-1)
        d01 = (e0 * e1).sum(-1)
        d11 = (e1 * e1).sum(-1)
        d20 = (d * e0).sum(-1)
        d21 = (d * e1).sum(-1)
        den = np.maximum(d00 * d11 - d01 * d01, 1e-20)
        v = (d11 * d20 - d01 * d21) / den
        w = (d00 * d21 - d01 * d20) / den
        return torch.from_numpy(
            np.stack([1.0 - v - w, v, w], -1).astype(np.float32))

    return CptGridDistance(
        grid, torch.from_numpy(tri_idx_np), torch.from_numpy(parents),
        bary_weights(ra), bary_weights(rb), bary_weights(rc))
