"""`generate_sdf` — signed distances at arbitrary query points.

PyTorch counterpart of the JAX package's ``query.py`` (the reference entry
point, `mesh_to_sdf/src/lib.rs:291-311`): the acceleration choice becomes a
strategy — ``Strategy.PALLAS``, the fused distance kernels
(``ops.kernels.sdf``), or ``Strategy.XLA``, the brute-force engine
(``ops.brute``). ``Strategy.CULLED`` (``AccelerationMethod.rtree()`` and
``rtree_bvh()``) is not ported yet and raises.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .ops import brute
from .ops.kernels import sdf
from .topology import Topology, as_points, gather_triangle_vertices
from .types import AccelerationMethod, SignMethod, Strategy

#: Where the routes that still raise will come from.
CULLED_NOT_PORTED = "ROADMAP.md 'Modules still to port' item 6 (CULLED)"


def _resolve(acceleration, sign_method):
    if isinstance(acceleration, AccelerationMethod):
        return acceleration.strategy, acceleration.sign_method
    if acceleration is None:
        acceleration = Strategy.AUTO
    if sign_method is None:
        sign_method = SignMethod.RAYCAST
    return acceleration, sign_method


def _auto_strategy(device: torch.device) -> Strategy:
    """AUTO → the fused kernels on a CUDA device (as on the TPU), the
    brute-force engine elsewhere."""
    return Strategy.PALLAS if device.type == "cuda" else Strategy.XLA


def _output_device(vertices, query_points=None) -> torch.device:
    """The queries' device when they are a tensor, else the vertices',
    else the CPU."""
    for x in (query_points, vertices):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _as_query_tensor(query_points, device) -> torch.Tensor:
    """(Q, 3) float32 contiguous tensor on ``device``; a tensor stays where
    it is (no host round trip), anything else goes through
    :func:`as_points`."""
    if not isinstance(query_points, torch.Tensor):
        return torch.from_numpy(as_points(query_points)).to(device)
    q = query_points.detach().to(torch.float32)
    if q.dim() == 1:
        if q.numel() % 3 != 0:
            raise ValueError(
                f"flat query buffer size {q.numel()} not divisible by 3")
        q = q.reshape(-1, 3)
    if q.dim() != 2 or q.shape[-1] != 3:
        raise ValueError(f"query points must be (N, 3), got "
                         f"{tuple(q.shape)}")
    return q.contiguous()


def prepare_triangles(vertices, topology: Optional[Topology],
                      tri_block: int, device=None):
    """Expand topology → (ta, tb, tc, valid, T): (T', 3) float32 triangle
    vertex tensors on ``device``, padded with zero triangles to a multiple
    of ``tri_block`` (``valid`` masks the padding), and the real count T."""
    v = as_points(vertices)
    if topology is None:
        topology = Topology.triangle_list(None)
    ta, tb, tc = gather_triangle_vertices(v, topology)
    T = ta.shape[0]
    pad = (-T) % tri_block if T > 0 else tri_block
    valid = np.ones((T,), bool)
    if pad:
        zeros = np.zeros((pad, 3), np.float32)
        ta = np.concatenate([ta, zeros])
        tb = np.concatenate([tb, zeros])
        tc = np.concatenate([tc, zeros])
        valid = np.concatenate([valid, np.zeros((pad,), bool)])
    return (
        *(torch.from_numpy(np.ascontiguousarray(x)).to(device)
          for x in (ta, tb, tc, valid)),
        T,
    )


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
) -> torch.Tensor:
    """Signed distance at each query point (positive outside, negative
    inside), as a (Q,) float32 tensor in the order of ``query_points``.

    Mirrors `mesh_to_sdf/src/lib.rs:291-311`. The output lies on the
    queries' device when they are a tensor, else on the vertices' device
    (the CPU for arrays). ``raycast_axes``: 3 (default) votes best-of-3 like
    the reference Bvh/RtreeBvh backends (`bvh.rs:133-139`); 1 casts only +X
    like the ``None`` backend (`default.rs:36`).

    Strategies: PALLAS (the fused kernels; their plain versions for CPU
    tensors), XLA (brute force in PyTorch), AUTO (PALLAS on a CUDA device,
    XLA elsewhere). CULLED raises ``NotImplementedError``.
    """
    strategy, sign = _resolve(acceleration, sign_method)
    if strategy == Strategy.CULLED:
        raise NotImplementedError(
            f"{strategy} is not ported yet: {CULLED_NOT_PORTED}")
    device = _output_device(vertices, query_points)
    q = _as_query_tensor(query_points, device)
    Q = q.shape[0]
    if Q == 0:
        return torch.zeros((0,), dtype=torch.float32, device=device)

    ta, tb, tc, valid, n_tris = prepare_triangles(vertices, topology,
                                                  tri_block, device)
    if strategy == Strategy.AUTO:
        # The JAX package sends large raycast batches on big meshes (≥4096
        # queries, ≥32768 triangles) to CULLED. CULLED is not ported yet
        # (ROADMAP.md 'Modules still to port' item 6), so they stay on
        # PALLAS, which is exact: the answer is the same, only slower.
        strategy = _auto_strategy(device)

    if strategy == Strategy.PALLAS and n_tris > 0:
        ra, rb, rc = ta[:n_tris], tb[:n_tris], tc[:n_tris]
        if sign == SignMethod.NORMAL:
            return sdf.sdf_normal(q, ra, rb, rc)
        return sdf.sdf_raycast(q, ra, rb, rc, raycast_axes=raycast_axes)

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
