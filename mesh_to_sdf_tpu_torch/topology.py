"""Mesh topology expansion and vertex-input adapters.

Mirrors the reference's ``Topology`` enum (`mesh_to_sdf/src/lib.rs:150-194`):
triangle lists or strips, with optional u16/u32 indices (``None`` means
``0..len(vertices)``). Expansion semantics match ``get_triangles``
(`lib.rs:183-192`): lists drop any remainder (itertools ``.tuples()``), strips
emit every consecutive window of 3 **without** alternating winding flips
(itertools ``.tuple_windows()``).

The reference's ``Point`` trait + five math-library impls
(`mesh_to_sdf/src/point.rs:21-142`) becomes :func:`as_points`: any array-like
of shape (N, 3) — numpy, JAX, torch tensors, nested lists — is accepted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class Topology:
    """How triangle indices are stored. Use :meth:`triangle_list` /
    :meth:`triangle_strip`."""

    kind: str  # "list" | "strip"
    indices: Optional[np.ndarray]

    @staticmethod
    def triangle_list(indices=None) -> "Topology":
        """Each consecutive group of 3 indices is a triangle (`lib.rs:157-161`)."""
        return Topology("list", _as_index_array(indices))

    @staticmethod
    def triangle_strip(indices=None) -> "Topology":
        """Each consecutive window of 3 indices is a triangle (`lib.rs:162-166`)."""
        return Topology("strip", _as_index_array(indices))


def _as_index_array(indices) -> Optional[np.ndarray]:
    if indices is None:
        return None
    arr = np.asarray(indices)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"indices must be integers, got {arr.dtype}")
    return arr.astype(np.uint32).reshape(-1)


def as_points(vertices) -> np.ndarray:
    """Adapt any (N, 3) array-like of vertex positions to float32 numpy.

    The TPU analog of the reference ``Point`` trait (`point.rs:21-142`): rather
    than per-math-library impls, we accept anything ``np.asarray`` understands
    plus torch tensors (via ``.numpy()``) and transparently reshape flat
    ``(3N,)`` buffers.
    """
    if hasattr(vertices, "detach"):  # torch tensor
        vertices = vertices.detach().cpu().numpy()
    arr = np.asarray(vertices, dtype=np.float32)
    if arr.ndim == 1:
        if arr.size % 3 != 0:
            raise ValueError(f"flat vertex buffer size {arr.size} not divisible by 3")
        arr = arr.reshape(-1, 3)
    if arr.ndim != 2 or arr.shape[-1] != 3:
        raise ValueError(f"vertices must be (N, 3), got {arr.shape}")
    return arr


def expand_triangles(n_vertices: int, topology: Topology) -> np.ndarray:
    """Expand a topology into an (M, 3) uint32 triangle-index array.

    Matches ``Topology::get_triangles`` (`lib.rs:175-193`) exactly, including
    list-remainder dropping and strip windowing.
    """
    if topology.indices is not None:
        idx = topology.indices
    else:
        idx = np.arange(n_vertices, dtype=np.uint32)

    if topology.kind == "list":
        m = (idx.size // 3) * 3
        return idx[:m].reshape(-1, 3).astype(np.uint32)
    if topology.kind == "strip":
        if idx.size < 3:
            return np.zeros((0, 3), np.uint32)
        return np.stack([idx[:-2], idx[1:-1], idx[2:]], axis=-1).astype(np.uint32)
    raise ValueError(f"unknown topology kind {topology.kind!r}")


def gather_triangle_vertices(vertices: np.ndarray, topology: Topology):
    """Return (tri_a, tri_b, tri_c) vertex arrays, each (M, 3) float32."""
    tris = expand_triangles(len(vertices), topology)
    v = np.asarray(vertices, np.float32)
    return v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
