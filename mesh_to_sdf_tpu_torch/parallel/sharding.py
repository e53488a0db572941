"""Sharded SDF generation and training over a (cells, tris) process mesh
(PyTorch counterpart of ``parallel/sharding.py``).

Layout, on every rank of the mesh (SPMD):

- query points and grid cells are split over ``cells`` (pure data
  parallelism);
- triangles are split over ``tris``; each rank's champions go through a
  tiny all_gather over ``tris`` and a local min (``mesh._gather_min``,
  differentiable, so the same code serves training); the raycast crossing
  counts are summed over ``tris`` (``mesh._psum``; the sign is constant
  piecewise and carries no gradient);
- vertices are replicated; in training each rank's vertex gradient is
  summed over the world (``mesh._all_reduce_``) before the optimizer's
  step, so the vertices stay identical on every rank.

Every entry point takes host arrays (or tensors), is called by every rank
of the mesh with the same arguments, and returns the whole result on every
rank. It runs on CUDA (the rank's card) unless ``device=`` or a tensor
input says otherwise. A shard's forward runs the fused kernels
(``ops.kernels.sdf``: ``sdf_normal_champions``, ``sdf_raycast_parts``);
when a gradient is wanted it runs the exact engines of ``ops.autodiff``
with their envelope backward instead, as the JAX package's ``custom_vjp``
does. The JAX package's ``use_pallas`` switch has no counterpart: the
kernels run on CUDA tensors and their plain versions on CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..grid import Grid
from ..intake import host_soup, resolve_device, upload_soup
from ..ops import autodiff, culling, geometry
from ..ops.keyed import combine_champions
from ..ops.kernels import culled, sdf
from ..query import _culled_structures
from ..topology import Topology, as_points
from ..types import SignMethod
from .mesh import (CELL_AXIS, TRI_AXIS, _all_gather, _all_reduce_,
                   _gather_min, _psum, axis_size, cell_sharding, local_rows,
                   pad_for_axis, tri_sharding)


def _rank_device(device, *inputs) -> torch.device:
    """The device this rank computes on: ``device``, else a tensor input's,
    else CUDA; an unindexed CUDA device is the rank's current card."""
    device = resolve_device(device, *inputs)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _shard_ray_counts(queries, vertices, tri_idx, raycast_axes):
    """Crossing counts (Q, axes) int32 over the local triangle shard (no
    gradient), by ``geometry.ray_triangle_aligned``; -1 rows never hit."""
    v = vertices.detach()
    q = queries.detach()
    ids = torch.clamp_min(tri_idx, 0).long()
    ta, tb, tc = v[ids[:, 0]], v[ids[:, 1]], v[ids[:, 2]]
    valid = tri_idx[:, 0] >= 0
    counts = []
    for axis in range(raycast_axes):
        hit, _ = geometry.ray_triangle_aligned(
            q[:, None, :], ta[None], tb[None], tc[None], axis)
        counts.append(torch.sum(hit & valid[None, :], dim=1,
                                dtype=torch.int32))
    return torch.stack(counts, dim=-1)


#: Vertex sentinel of padded (-1) triangle rows in the kernels: the pad
#: triangle collapses to the point (1e18, 1e18, 1e18), so its squared
#: distance is ~3e36 (finite, never a minimum next to a real triangle) and
#: its crossing test's edge functions are all 0 (never a crossing).
_FAR = 1.0e18


def _pallas_safe_tris(vertices, tri_idx):
    """(ta, tb, tc) (M, 3) of the shard, the pad rows moved to _FAR."""
    v = vertices.detach()
    valid = (tri_idx[:, 0] >= 0)[:, None]
    ids = torch.clamp_min(tri_idx, 0).long()
    return tuple(torch.where(valid, v[ids[:, k]], _FAR).contiguous()
                 for k in range(3))


def _make_champions_fn(block: int):
    """(vertices, tri_idx, queries) -> (minpos, minneg) of the shard: the
    normal kernel without a gradient; with one, the exact scan engine and
    its envelope backward (``autodiff.signed_champion_distances``, an
    autograd Function: the kernel keeps no argmin)."""

    def champs(vertices, tri_idx, queries):
        if _wants_grad(vertices, queries):
            return autodiff.signed_champion_distances(vertices, tri_idx,
                                                      queries, block)
        return sdf.sdf_normal_champions(
            queries, *_pallas_safe_tris(vertices, tri_idx))

    return champs


def _make_dist_counts_fn(block: int, raycast_axes: int):
    """(vertices, tri_idx, queries) -> (dist (Q,), counts (Q, axes)) of the
    shard: the raycast kernel's distance and crossing counts in one triangle
    pass without a gradient; with one, ``autodiff.unsigned_min_distance``
    (an autograd Function, envelope backward) and the counts without
    gradient."""

    def dist_counts(vertices, tri_idx, queries):
        if _wants_grad(vertices, queries):
            d = autodiff.unsigned_min_distance(vertices, tri_idx, queries,
                                               block)
            return d, _shard_ray_counts(queries, vertices, tri_idx,
                                        raycast_axes)
        return sdf.sdf_raycast_parts(
            queries, *_pallas_safe_tris(vertices, tri_idx),
            raycast_axes=raycast_axes)

    return dist_counts


def sharded_sdf_fn(mesh, sign_method: SignMethod, *, raycast_axes: int = 3,
                   block: int = 256):
    """A differentiable sharded SDF function of this rank's shards:
    ``f(vertices (V, 3) replicated, tri_idx (M / tris, 3) this rank's
    triangle rows, queries (Q / cells, 3) this rank's queries) -> (Q /
    cells,)`` signed distances of those queries (the same on every rank of
    a ``cells`` row). Take the shards with ``mesh.local_rows``; pad rows of
    ``tri_idx`` are -1. A loss over the outputs back-propagates into this
    rank's part of the vertex gradient: sum it over the world."""
    champs_fn = _make_champions_fn(block)
    dist_counts_fn = _make_dist_counts_fn(block, raycast_axes)
    tris = mesh.get_group(TRI_AXIS)

    def fn(vertices, tri_idx, queries):
        if sign_method == SignMethod.NORMAL:
            mp, mn = champs_fn(vertices, tri_idx, queries)
            return combine_champions(_gather_min(mp, tris),
                                     _gather_min(mn, tris))
        dist, counts = dist_counts_fn(vertices, tri_idx, queries)
        dist = _gather_min(dist, tris)
        odd = _psum(counts, tris) % 2 == 1
        if raycast_axes == 1:
            inside = odd[:, 0]
        else:
            inside = torch.sum(odd, dim=1) >= 2
        return torch.where(inside, -dist, dist)

    return fn


def _pad_tri_idx(tri_idx, mesh, block: int) -> np.ndarray:
    tri_np = np.asarray(tri_idx, np.int32).reshape(-1, 3)
    m_pad = pad_for_axis(max(tri_np.shape[0], 1), mesh, TRI_AXIS, block)
    return np.concatenate(
        [tri_np, np.full((m_pad - tri_np.shape[0], 3), -1, np.int32)])


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def generate_sdf_sharded(
    vertices,
    tri_idx,
    query_points,
    mesh,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    raycast_axes: int = 3,
    block: int = 256,
    device=None,
) -> torch.Tensor:
    """Multi-rank ``generate_sdf``: pads the inputs on the host, takes this
    rank's shards, computes, and gathers the (Q,) result over ``cells``.
    ``tri_idx`` is (M, 3) int (pad rows -1)."""
    device = _rank_device(device, query_points, vertices)
    v = torch.from_numpy(as_points(vertices)).to(device)
    tri_np = _pad_tri_idx(_host(tri_idx), mesh, block)
    q_np = as_points(query_points)
    Q = q_np.shape[0]
    q_pad = pad_for_axis(max(Q, 1), mesh, CELL_AXIS, 8)
    q_np = np.concatenate([q_np, np.zeros((q_pad - Q, 3), np.float32)])

    fn = sharded_sdf_fn(mesh, sign_method, raycast_axes=raycast_axes,
                        block=block)
    t = torch.from_numpy(local_rows(tri_np, mesh, tri_sharding(mesh)))
    q = torch.from_numpy(local_rows(q_np, mesh, cell_sharding(mesh)))
    with torch.no_grad():
        out = fn(v, t.to(device), q.to(device))
    return _all_gather(out, mesh.get_group(CELL_AXIS)).reshape(-1)[:Q]


def generate_sdf_sharded_culled(
    vertices,
    faces,
    query_points,
    mesh,
    *,
    raycast_axes: int = 3,
    st: Optional[int] = None,
    nb_sub: Optional[int] = None,
    nb_table: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Multi-rank CULLED ``generate_sdf`` (raycast sign): queries split over
    ``cells``; the block index and the sign grid are built once per mesh
    and device (``query._culled_structures``' caches) and held whole by
    every rank. Each rank runs the union engine's fused pass (the culled
    kernel: distance and anchor-segment sign) on its queries; the queries
    whose certificate failed go through :func:`generate_sdf_sharded`, so
    the result is exact everywhere."""
    device = _rank_device(device, query_points, vertices)
    f_np = np.asarray(_host(faces), np.int64).reshape(-1, 3)
    ha, hb, hc = host_soup(vertices, Topology.triangle_list(f_np.reshape(-1)))
    ta, tb, tc, valid, _ = upload_soup(ha, hb, hc, 1024, device)
    sign_grid, _, bi = _culled_structures(ha, hb, hc, ta, tb, tc, valid,
                                          device, block_index=True)

    q_np = as_points(query_points)
    Q = q_np.shape[0]
    qt = culled.DEFAULT_QT
    if st is None:
        n_dev = axis_size(mesh, CELL_AXIS)
        st = culled.DEFAULT_ST if Q >= 262_144 * n_dev else 32
    q_pad = pad_for_axis(max(Q, 1), mesh, CELL_AXIS, qt)
    # Repeat the last real query, not zeros: origin padding would join
    # Morton sub-tiles, widen their radii and loosen every certificate
    # sharing a sub-tile.
    fill = (np.repeat(q_np[-1:], q_pad - Q, axis=0) if Q > 0
            else np.zeros((q_pad, 3), np.float32))
    q_np = np.concatenate([q_np, fill])

    q = torch.from_numpy(local_rows(q_np, mesh, cell_sharding(mesh)))
    signed, flag, _ = culling._culled_blocks_signed_impl(
        q.to(device), bi, sign_grid.inside, sign_grid.grid, qt=qt, st=st,
        nb_sub=nb_sub or culled.DEFAULT_NB_SUB,
        nb_table=nb_table or culled.DEFAULT_NB_TABLE)
    cells = mesh.get_group(CELL_AXIS)
    signed = _all_gather(signed, cells).reshape(-1)[:Q]
    flag = _all_gather(flag.to(torch.uint8), cells).reshape(-1)[:Q]
    bad = torch.nonzero(flag).reshape(-1).cpu()
    if len(bad):
        signed[bad.to(device)] = generate_sdf_sharded(
            vertices, f_np.astype(np.int32), q_np[bad.numpy()], mesh,
            SignMethod.RAYCAST, raycast_axes=raycast_axes, device=device)
    return signed


def generate_grid_sdf_sharded(
    vertices,
    tri_idx,
    grid: Grid,
    mesh,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    block: int = 256,
    device=None,
) -> torch.Tensor:
    """Multi-rank grid SDF: the cells flattened and split over ``cells``.
    The raycast sign is per-cell 3-axis parity (the counts summed over
    ``tris``). Returns the flat (nx·ny·nz,) field."""
    centers = grid.all_cell_centers().reshape(-1, 3).numpy()
    return generate_sdf_sharded(vertices, tri_idx, centers, mesh,
                                sign_method, block=block, device=device)


def sharded_fit_step_fn(mesh, tri_idx, grid: Grid, optimizer,
                        sign_method: SignMethod = SignMethod.NORMAL,
                        block: int = 256):
    """A sharded training step for the DifferentiableSDF model.

    ``optimizer``: a ``torch.optim.Optimizer`` over one parameter, the (V,
    3) vertices, replicated (every rank starts from the same values, on its
    device). Cells (and the target) are split over ``cells``, triangles over
    ``tris``. Returns ``(step, pad_target)``: ``pad_target(target_flat)``
    gives this rank's padded target shard of a host (nx·ny·nz,) target;
    ``step(target_shard)`` computes the loss ``sum(err²) / N`` over the real
    cells, back-propagates, sums the vertex gradient over the world and
    steps the optimizer; it returns the loss before the step.
    """
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if len(params) != 1:
        raise ValueError("the optimizer must hold exactly the vertices")
    vertices = params[0]
    device = vertices.device
    centers = grid.all_cell_centers().reshape(-1, 3).numpy()
    N = centers.shape[0]
    n_pad = pad_for_axis(N, mesh, CELL_AXIS, 8)
    centers = np.concatenate([centers, np.zeros((n_pad - N, 3), np.float32)])
    centers = torch.from_numpy(
        local_rows(centers, mesh, cell_sharding(mesh))).to(device)
    tri = torch.from_numpy(local_rows(
        _pad_tri_idx(_host(tri_idx), mesh, block), mesh,
        tri_sharding(mesh))).to(device)
    valid = torch.from_numpy(local_rows(np.arange(n_pad) < N, mesh,
                                        cell_sharding(mesh))).to(device)
    sdf_fn = sharded_sdf_fn(mesh, sign_method, block=block)
    cells = mesh.get_group(CELL_AXIS)

    def step(target):
        optimizer.zero_grad()
        pred = sdf_fn(vertices, tri, centers)
        err = torch.where(valid, pred - target, 0.0)
        loss = torch.sum(err * err) / N
        loss.backward()
        _all_reduce_(vertices.grad)
        optimizer.step()
        return _psum(loss.detach(), cells)

    def pad_target(target_flat):
        t = np.asarray(_host(target_flat), np.float32).reshape(-1)
        t = np.concatenate([t, np.zeros(n_pad - N, np.float32)])
        return torch.from_numpy(local_rows(t, mesh,
                                           cell_sharding(mesh))).to(device)

    return step, pad_target
