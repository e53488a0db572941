"""Point-cloud and voxel debug renders (offline analogs of K7's
`sdf_render_pass` billboards and `voxel_render_pass` instanced cubes).

The JAX package's ``render/splat.py`` on the host in numpy; the port's
grids and renderers around it.

The client renders the SDF as instanced billboard spheres
(`passes/sdf_render_pass.rs:34-72`) or as cubes over the iso band
(`passes/voxel_render_pass.rs:280-310`). Offline:

- :func:`render_points` — painter's-algorithm splatting with the same
  distance colorization idea as `draw_sdf.wgsl:84-129` (positive/negative
  strength colors);
- voxel look = the raymarcher with the SNAP sampler (cell-constant distance
  is exactly what the cube render shows) — see
  :class:`..sampler.RaymarchMode.SNAP`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..grid import Grid
from .image import host_array
from .raymarch import Camera
from .isosurface import surface_cells


def _project(points: np.ndarray, camera: Camera):
    """World → pixel coords + view depth via the camera's look-at frame."""
    eye = np.asarray(camera.eye, np.float32)
    target = np.asarray(camera.target, np.float32)
    up = np.asarray(camera.up, np.float32)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    cup = np.cross(right, fwd)

    rel = points - eye
    x = rel @ right
    y = rel @ cup
    z = rel @ fwd  # view depth
    tan_half = np.tan(np.radians(camera.fov_y_deg) * 0.5)
    aspect = camera.width / camera.height
    zs = np.where(z > 1e-6, z, 1e-6)
    u = (x / (zs * tan_half * aspect) + 1.0) * 0.5 * camera.width
    v = (1.0 - y / (zs * tan_half)) * 0.5 * camera.height
    return u, v, z


def colorize_distances(d: np.ndarray,
                       positive=(0.1, 0.4, 1.0),
                       negative=(1.0, 0.3, 0.1),
                       surface=(1.0, 1.0, 1.0),
                       power: float = 0.5,
                       surface_width: float = 0.0) -> np.ndarray:
    """Distance → color, the `draw_sdf.wgsl:84-129` scheme: positive and
    negative strengths fade with |d|^power; near-zero shows the surface color."""
    d = np.asarray(d, np.float32)
    scale = max(float(np.abs(d).max()), 1e-9)
    s = np.clip(np.abs(d) / scale, 0.0, 1.0) ** power
    col = np.where(
        d[:, None] >= 0,
        np.asarray(positive)[None] * (1.0 - s[:, None]),
        np.asarray(negative)[None] * (1.0 - s[:, None]),
    )
    if surface_width > 0:
        col = np.where(
            (np.abs(d) <= surface_width)[:, None], np.asarray(surface)[None], col
        )
    return col.astype(np.float32)


def render_points(
    points: np.ndarray,  # (K, 3)
    colors: np.ndarray,  # (K, 3) float [0,1]
    camera: Camera,
    *,
    point_size: int = 2,
    background=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """Depth-sorted square splats → (H, W, 3) float image."""
    h, w = camera.height, camera.width
    img = np.broadcast_to(
        np.asarray(background, np.float32), (h, w, 3)
    ).copy()
    if len(points) == 0:
        return img
    u, v, z = _project(np.asarray(points, np.float32), camera)
    order = np.argsort(-z)  # far → near (painter's algorithm)
    u = u[order].astype(np.int64)
    v = v[order].astype(np.int64)
    z = z[order]
    c = np.asarray(colors, np.float32)[order]
    r = max(point_size // 2, 0)
    keep = (z > 0) & (u >= -r) & (u < w + r) & (v >= -r) & (v < h + r)
    u, v, c = u[keep], v[keep], c[keep]
    for du in range(-r, r + 1):
        for dv in range(-r, r + 1):
            uu = np.clip(u + du, 0, w - 1)
            vv = np.clip(v + dv, 0, h - 1)
            img[vv, uu] = c
    return img


def render_sdf_points(
    grid: Grid,
    distances,
    camera: Optional[Camera] = None,
    *,
    iso: float = 0.0,
    width_scale: float = 1.0,
    point_size: int = 2,
) -> np.ndarray:
    """Point-cloud view of the SDF iso band (the client's Sdf render mode)."""
    if camera is None:
        camera = Camera.orbit(grid)
    d = host_array(distances).reshape(-1)
    cells = torch.from_numpy(surface_cells(grid, d, iso, width_scale))
    pts = grid.cell_center(cells).numpy()
    flat = grid.cell_index(cells.long()).numpy()
    cols = colorize_distances(d[flat])
    return render_points(pts, cols, camera, point_size=point_size)
