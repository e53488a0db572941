"""Procedural test/bench meshes (the stand-in for the reference's .glb assets).

The reference ships binary fixtures (suzanne, knight, FlightHelmet —
`mesh_to_sdf/assets/`); we generate watertight meshes procedurally so fixtures
are reproducible and no binary blobs live in the repo.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def icosphere(subdiv: int = 2, radius: float = 1.0,
              center=(0.0, 0.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Watertight icosphere: (vertices (V,3) f32, faces (F,3) i64).

    20·4^subdiv triangles (subdiv=5 → 20480).
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        verts_list = list(verts)
        cache = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (verts_list[i] + verts_list[j]) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(verts_list)
                verts_list.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab = midpoint(a, b)
            bc = midpoint(b, c)
            ca = midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(verts_list)
        faces = np.array(new_faces, np.int64)

    verts = verts * radius + np.asarray(center, np.float64)
    return verts.astype(np.float32), faces


def torus(major: float = 1.0, minor: float = 0.4, n_major: int = 64,
          n_minor: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Watertight torus triangle mesh (non-convex; good raycast-sign test)."""
    u = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (major + minor * np.cos(vv)) * np.cos(uu)
    y = minor * np.sin(vv)
    z = (major + minor * np.cos(vv)) * np.sin(uu)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    faces = []
    for i in range(n_major):
        for j in range(n_minor):
            a = i * n_minor + j
            b = ((i + 1) % n_major) * n_minor + j
            c = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
            d = i * n_minor + (j + 1) % n_minor
            faces += [[a, b, c], [a, c, d]]
    return verts, np.asarray(faces, np.int64)


def box(half_extents=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)):
    """Axis-aligned box, 12 triangles, outward winding."""
    hx, hy, hz = half_extents
    cx, cy, cz = center
    corners = np.array(
        [
            [x, y, z]
            for x in (cx - hx, cx + hx)
            for y in (cy - hy, cy + hy)
            for z in (cz - hz, cz + hz)
        ],
        np.float32,
    )
    quads = [
        (0, 1, 3, 2),  # -x
        (6, 7, 5, 4),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return corners, np.asarray(faces, np.int64)
