"""`generate_sdf` — signed distances at arbitrary query points.

PyTorch counterpart of the JAX package's ``query.py`` (the reference entry
point, `mesh_to_sdf/src/lib.rs:291-311`): the acceleration choice becomes a
strategy — ``Strategy.PALLAS``, the fused distance kernels
(``ops.kernels.sdf``); ``Strategy.XLA``, the brute-force engine
(``ops.brute``); or ``Strategy.CULLED`` (``AccelerationMethod.rtree()`` and
``rtree_bvh()``), block culling (``ops.culling``) with per-mesh structures
cached by content.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .intake import (cached, content_key, dense_strategy, host_soup,
                     resolve_device, resolve_strategy, upload_soup)
from .ops import brute, culling
from .ops.kernels import culled, sdf
from .topology import Topology, as_points
from .types import AccelerationMethod, SignMethod, Strategy
from .utils.profiling import span, spanned, sync_span

#: Below this many queries the O(Q·T) parity sweep beats building a sign
#: grid, and AUTO keeps PALLAS.
SIGN_GRID_MIN_QUERIES = 4096
#: AUTO sends raycast batches on meshes of at least this many triangles to
#: CULLED (on a CUDA device, as the JAX package does on the TPU).
CULLED_MIN_TRIS = 32768

#: Caches of CULLED's per-mesh structures, on their device (sign grid, 2-D
#: parity bins, block index), keyed by ``intake.content_key`` of the soup
#: and the device; tiny FIFOs.
_SIGN_GRID_CACHE: dict = {}
_PARITY_BINS_CACHE: dict = {}
_BLOCK_INDEX_CACHE: dict = {}
_CACHE_MAX = 4


def _as_query_tensor(query_points, device) -> torch.Tensor:
    """(Q, 3) float32 contiguous tensor on ``device``."""
    if not isinstance(query_points, torch.Tensor):
        q = torch.from_numpy(as_points(query_points))
        with sync_span("sync.query.points", device):
            return q.to(device)
    with sync_span("sync.query.points", query_points, device):
        q = query_points.detach().to(device, torch.float32)
    if q.dim() == 1:
        if q.numel() % 3 != 0:
            raise ValueError(
                f"flat query buffer size {q.numel()} not divisible by 3")
        q = q.reshape(-1, 3)
    if q.dim() != 2 or q.shape[-1] != 3:
        raise ValueError(f"query points must be (N, 3), got "
                         f"{tuple(q.shape)}")
    return q.contiguous()


@spanned("query.structures")
def _culled_structures(ha, hb, hc, ta, tb, tc, valid, device, *,
                       block_index: bool):
    """(sign grid, parity bins or None, block index or None) of a mesh,
    cached by the full soup's content and the device, with a block index
    when ``block_index``: ``generate_sdf`` asks for one only on CUDA, where
    the JAX package builds one only on the TPU; the sharded CULLED path
    asks for one on every device, as the JAX package's does. With it the
    fused pass signs every query, so the parity bins are built only without
    it (where the sign comes from them)."""
    key = content_key(ha, hb, hc) + (str(device),)
    miss = "query.structures.build"
    sign_grid = cached(_SIGN_GRID_CACHE, key, lambda: (
        culling.build_sign_grid(ta, tb, tc, valid)), _CACHE_MAX, miss)
    if block_index:
        return sign_grid, None, cached(_BLOCK_INDEX_CACHE, key, lambda: (
            culled.build_block_index(ha, hb, hc, device=device)),
            _CACHE_MAX, miss)
    parity_bins = cached(_PARITY_BINS_CACHE, key, lambda: tuple(
        culling.upload_parity_bins(
            culling.build_parity_bins(ha, hb, hc, axis), device)
        for axis in range(3)), _CACHE_MAX, miss)
    return sign_grid, parity_bins, None


@spanned("query.entry")
def generate_sdf(
    vertices,
    topology: Optional[Topology],
    query_points,
    acceleration: Union[AccelerationMethod, Strategy, None] = None,
    *,
    sign_method: Optional[SignMethod] = None,
    raycast_axes: int = 3,
    tri_block: int = brute.DEFAULT_TRI_BLOCK,
    query_chunk: int = brute.DEFAULT_QUERY_CHUNK,
    device=None,
) -> torch.Tensor:
    """Signed distance at each query point (positive outside, negative
    inside), as a (Q,) float32 tensor in the order of ``query_points``.

    Mirrors `mesh_to_sdf/src/lib.rs:291-311`. Runs on ``device`` when given,
    else on the device of the queries (or the vertices) when they are a
    tensor, else on CUDA; a host without CUDA then raises.
    ``raycast_axes``: 3 (default) votes best-of-3 like the reference
    Bvh/RtreeBvh backends (`bvh.rs:133-139`); 1 casts only +X like the
    ``None`` backend (`default.rs:36`).

    Strategies: PALLAS (the fused kernels; their plain versions for CPU
    tensors), XLA (brute force in PyTorch), CULLED (block culling; on CUDA
    through the block-culled kernel), AUTO (on a CUDA device CULLED for
    raycast batches of at least 4096 queries on meshes of at least 32 768
    triangles, else PALLAS; XLA elsewhere).
    """
    strategy, sign = resolve_strategy(acceleration, sign_method)
    device = resolve_device(device, query_points, vertices)
    q = _as_query_tensor(query_points, device)
    Q = q.shape[0]
    if Q == 0:
        return torch.zeros((0,), dtype=torch.float32, device=device)

    with span("query.soup"):
        ha, hb, hc = host_soup(vertices, topology)
        ta, tb, tc, valid, n_tris = upload_soup(ha, hb, hc, tri_block,
                                                device)
    if strategy == Strategy.AUTO:
        strategy = dense_strategy(device)
        if (strategy == Strategy.PALLAS and sign == SignMethod.RAYCAST
                and Q >= SIGN_GRID_MIN_QUERIES and n_tris >= CULLED_MIN_TRIS):
            strategy = Strategy.CULLED

    if strategy == Strategy.PALLAS and n_tris > 0:
        ra, rb, rc = ta[:n_tris], tb[:n_tris], tc[:n_tris]
        if sign == SignMethod.NORMAL:
            return sdf.sdf_normal(q, ra, rb, rc)
        return sdf.sdf_raycast(q, ra, rb, rc, raycast_axes=raycast_axes)

    if strategy == Strategy.CULLED and n_tris > 0:
        structures = (None, None, None)
        if (sign == SignMethod.RAYCAST and n_tris > 2 * culling.DEFAULT_K
                and Q >= SIGN_GRID_MIN_QUERIES):
            structures = _culled_structures(
                ha, hb, hc, ta, tb, tc, valid, device,
                block_index=device.type == "cuda")
        sign_grid, parity_bins, block_index = structures
        return culling.query_sdf_culled(
            q, ta, tb, tc, valid, sign_method=sign,
            raycast_axes=raycast_axes, n_valid_tris=n_tris,
            sign_grid=sign_grid, block_index=block_index,
            parity_bins=parity_bins)[:Q]

    chunk = min(query_chunk, Q)
    qpad = (-Q) % chunk
    if qpad:
        q = torch.cat([q, torch.zeros((qpad, 3), dtype=torch.float32,
                                      device=device)])
    out = brute.sdf_brute(
        q, ta, tb, tc, valid,
        sign_method=sign,
        raycast_axes=raycast_axes if sign == SignMethod.RAYCAST else 0,
        tri_block=tri_block,
        query_chunk=chunk,
    )
    return out[:Q]
