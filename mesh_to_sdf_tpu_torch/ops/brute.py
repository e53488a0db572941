"""Brute-force SDF engine, query chunks × triangle blocks (``Strategy.XLA``).

PyTorch counterpart of the JAX package's ``ops/brute.py``, the dense trusted
path (the reference ``None`` backend, `generate/generic/default.rs`): every
(query, triangle) pair through :mod:`.geometry`, reduced per triangle block.
In JAX it is plain XLA, not a Pallas kernel; here it is plain PyTorch on
whatever device the tensors are on — a route a user selects, not the plain
version of a kernel.
"""
from __future__ import annotations

import torch

from ..types import F32_MAX, SignMethod
from . import geometry
from .keyed import combine_champions

DEFAULT_QUERY_CHUNK = 2048
DEFAULT_TRI_BLOCK = 512


def pad_tri_blocks(ta, tb, tc, valid, block: int):
    """Pad triangle tensors so their length divides ``block`` (pad =
    invalid). Returns (ta, tb, tc, valid, block) with block clamped to the
    padded size."""
    T = ta.shape[0]
    block = max(1, min(block, T)) if T > 0 else block
    rem = (-T) % block
    if rem:
        zero = torch.zeros((rem, 3), dtype=ta.dtype, device=ta.device)
        ta = torch.cat([ta, zero])
        tb = torch.cat([tb, zero])
        tc = torch.cat([tc, zero])
        valid = torch.cat([valid, torch.zeros((rem,), dtype=torch.bool,
                                              device=valid.device)])
    return ta, tb, tc, valid, block


def _pair_payload(queries, ta, tb, tc, sign_method: SignMethod,
                  raycast_axes: int):
    """Per-pair payload of one (chunk, block) tile: RAYCAST → (dist (C,B),
    crossings (C,B,axes) bool or None); NORMAL → (signed dist (C,B), None)."""
    q = queries[:, None, :]
    a = ta[None, :, :]
    b = tb[None, :, :]
    c = tc[None, :, :]
    if sign_method == SignMethod.NORMAL:
        return geometry.point_triangle_signed_distance(q, a, b, c), None
    dist = geometry.point_triangle_distance(q, a, b, c)
    if raycast_axes == 0:
        return dist, None
    hits = [geometry.ray_triangle_aligned(q, a, b, c, axis)[0]
            for axis in range(raycast_axes)]
    return dist, torch.stack(hits, dim=-1)


def sdf_chunk(queries, tri_a, tri_b, tri_c, tri_valid, *,
              sign_method: SignMethod, raycast_axes: int, tri_block: int):
    """Signed distances for one chunk of queries (C, 3) against all
    triangles (padded to a ``tri_block`` multiple, ``tri_valid`` masks the
    padding). ``raycast_axes=0`` gives the unsigned minimum (grid mode)."""
    C = queries.shape[0]
    dev = queries.device
    n_blocks = tri_a.shape[0] // tri_block
    blocks = [
        tuple(x[j * tri_block:(j + 1) * tri_block]
              for x in (tri_a, tri_b, tri_c, tri_valid))
        for j in range(n_blocks)
    ]

    if sign_method == SignMethod.NORMAL:
        minpos = torch.full((C,), F32_MAX, dtype=torch.float32, device=dev)
        minneg = torch.full((C,), F32_MAX, dtype=torch.float32, device=dev)
        for a, b, c, valid in blocks:
            sd, _ = _pair_payload(queries, a, b, c, sign_method, raycast_axes)
            neg = torch.signbit(sd)
            pos_vals = torch.where(valid[None, :] & ~neg, sd, F32_MAX)
            neg_vals = torch.where(valid[None, :] & neg, -sd, F32_MAX)
            minpos = torch.minimum(minpos, torch.amin(pos_vals, dim=1))
            minneg = torch.minimum(minneg, torch.amin(neg_vals, dim=1))
        return combine_champions(minpos, minneg)

    mind = torch.full((C,), F32_MAX, dtype=torch.float32, device=dev)
    counts = torch.zeros((C, max(raycast_axes, 1)), dtype=torch.int32,
                         device=dev)
    for a, b, c, valid in blocks:
        dist, hits = _pair_payload(queries, a, b, c, sign_method,
                                   raycast_axes)
        dist = torch.where(valid[None, :], dist, F32_MAX)
        mind = torch.minimum(mind, torch.amin(dist, dim=1))
        if raycast_axes > 0:
            counts = counts + torch.sum(hits & valid[None, :, None], dim=1,
                                        dtype=torch.int32)
    if raycast_axes == 0:
        return mind
    odd = counts % 2 == 1
    if raycast_axes == 1:
        # Single +X ray (`default.rs:34-37,65-72`).
        inside = odd[:, 0]
    else:
        # Best-of-3 voting (`bvh.rs:133-139`, `grid.rs:633-638`).
        inside = torch.sum(odd, dim=1) >= 2
    return torch.where(inside, -mind, mind)


def sdf_brute(queries, tri_a, tri_b, tri_c, tri_valid, *,
              sign_method: SignMethod, raycast_axes: int = 3,
              tri_block: int = DEFAULT_TRI_BLOCK,
              query_chunk: int = DEFAULT_QUERY_CHUNK):
    """Brute-force SDF over all (query, triangle) pairs, chunked 2-D.
    ``queries`` (Q, 3) must be padded to a multiple of the chunk."""
    Q = queries.shape[0]
    chunk = min(query_chunk, Q)
    if Q % chunk != 0:
        raise ValueError(
            f"queries ({Q}) must be padded to a multiple of {chunk}")
    return torch.cat([
        sdf_chunk(queries[s:s + chunk], tri_a, tri_b, tri_c, tri_valid,
                  sign_method=sign_method, raycast_axes=raycast_axes,
                  tri_block=tri_block)
        for s in range(0, Q, chunk)
    ])
