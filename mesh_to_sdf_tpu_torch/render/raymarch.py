"""Offline raymarch renderer: sphere-trace an SDF grid to an image.

PyTorch counterpart of the JAX package's ``render/raymarch.py`` (the
client's raymarch pass + shading, `mesh_to_sdf_client/src/passes/
raymarch_pass.rs`, `shaders/draw_raymarching.wgsl:202-357`): every pixel is
an element of a fixed-iteration vectorised trace, torch operations on the
device of the distances. The loop runs its ``max_steps`` steps without
reading anything back to the host.

Behavioural parity, cited into the shader:
- AABB entry (`:245-253` intersectAABB, entry nudge `:268`);
- sphere trace, MAX_STEPS=100, stop at EPSILON·max(cell_size) (`:89-90,
  255-287`);
- central-difference normals at the same epsilon (`:202-209`);
- Blinn-Phong-ish shading: ambient 0.2 + diffuse + specular, exponential
  attenuation (`:312-357`);
- shadows: a second ray marched toward the light through the same grid.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..grid import Grid
from ..intake import resolve_device
from .sampler import (OUT_OF_BOUNDS_DISTANCE, Lattice, RaymarchMode, lattice,
                      sample)

#: `draw_raymarching.wgsl:90` — relative to max cell size.
EPSILON = 0.01
MAX_STEPS = 100


def _cross(a, b):
    """``jnp.cross`` of (..., 3) tensors, component by component."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _dot(a, b):
    """Sum over the last axis of a·b, in index order."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _norm(a, keepdim=True):
    n = torch.sqrt(_dot(a, a))
    return n[..., None] if keepdim else n


def _normalize(a):
    return a / _norm(a)


def _vec(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


@dataclass(frozen=True)
class Camera:
    """Perspective look-at camera (≙ `camera.rs:18-95`, minus reverse-z which
    only matters for rasterizer depth buffers)."""

    eye: Tuple[float, float, float]
    target: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y_deg: float = 45.0
    width: int = 512
    height: int = 512

    def rays(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (origins (H,W,3), directions (H,W,3)) on ``device``
        (default CUDA)."""
        device = resolve_device(device)
        eye = _vec(self.eye, device)
        target = _vec(self.target, device)
        up = _vec(self.up, device)
        fwd = _normalize(target - eye)
        right = _normalize(_cross(fwd, up))
        cup = _cross(right, fwd)

        aspect = self.width / self.height
        tan_half = float(np.float32(np.tan(np.radians(self.fov_y_deg) * 0.5)))
        ys = torch.linspace(1.0, -1.0, self.height, dtype=torch.float32,
                            device=device) * tan_half
        xs = torch.linspace(-1.0, 1.0, self.width, dtype=torch.float32,
                            device=device) * tan_half * aspect
        d = (
            fwd[None, None]
            + xs[None, :, None] * right[None, None]
            + ys[:, None, None] * cup[None, None]
        )
        d = d / _norm(d)
        o = eye.expand(d.shape)
        return o, d

    @staticmethod
    def orbit(grid: Grid, azimuth_deg=30.0, elevation_deg=25.0, distance=None,
              width=512, height=512) -> "Camera":
        """Frame the grid bbox like the client's camera auto-fit
        (`sdf_program.rs:651-658`)."""
        bmin, bmax = grid.bounding_box()
        bmin = bmin.numpy()
        bmax = bmax.numpy()
        center = (bmin + bmax) * 0.5
        radius = float(np.linalg.norm(bmax - bmin)) * 0.5
        if distance is None:
            distance = radius * 2.8
        az = np.radians(azimuth_deg)
        el = np.radians(elevation_deg)
        eye = center + distance * np.asarray(
            [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)]
        )
        return Camera(
            eye=tuple(eye.tolist()),
            target=tuple(center.tolist()),
            width=width,
            height=height,
        )


def _intersect_aabb(origin, direction, bmin, bmax):
    """Slab test (`draw_raymarching.wgsl:245-253`). Returns (t_near, t_far)."""
    inv = 1.0 / torch.where(direction == 0.0, 1e-12, direction)
    t_min = (bmin - origin) * inv
    t_max = (bmax - origin) * inv
    t1 = torch.minimum(t_min, t_max)
    t2 = torch.maximum(t_min, t_max)
    return t1.amax(dim=-1), t2.amin(dim=-1)


def _grid_epsilon(grid) -> torch.Tensor:
    """`get_grid_epsilon` (`draw_raymarching.wgsl:255-257`), a 0-d float32
    tensor on the device of ``grid`` (a :class:`Lattice`) or the host."""
    return EPSILON * grid.cell_size.abs().amax()


def _on(dist, grid: Grid, device):
    """(dist as an (nx, ny, nz) float32 tensor on ``device``, the grid's
    :class:`Lattice` there)."""
    if not isinstance(dist, torch.Tensor):
        dist = torch.from_numpy(np.asarray(dist, np.float32))
    lat = grid if isinstance(grid, Lattice) else lattice(grid, device)
    return dist.to(device, torch.float32).reshape(lat.shape), lat


def trace(dist, grid, origins, directions, iso=0.0,
          mode: RaymarchMode = RaymarchMode.TRILINEAR,
          max_steps: int = MAX_STEPS):
    """Sphere-trace rays against the SDF grid (`sdf_3d`, wgsl `:260-287`),
    on the device of ``origins``.

    Returns (position (...,3), last_distance (...,), hit (...,)).
    """
    device = origins.device
    dist, lat = _on(dist, grid, device)
    eps = _grid_epsilon(lat)
    bmin, bmax = lat.lo, lat.hi

    t_near, t_far = _intersect_aabb(origins, directions, bmin, bmax)
    outside_box = t_near > t_far
    inside_start = torch.all((origins >= bmin) & (origins <= bmax), dim=-1)
    t0 = torch.where(inside_start, 0.0, torch.clamp_min(t_near, 0.0) + eps)
    pos = origins + t0[..., None] * directions

    d = torch.full(pos.shape[:-1], OUT_OF_BOUNDS_DISTANCE,
                   dtype=torch.float32, device=device)
    done = outside_box  # rays missing the box never start
    for _ in range(max_steps):
        d_new = sample(dist, lat, pos, mode) - iso
        done_new = done | (d_new < eps)
        step = torch.where(done_new, 0.0, d_new)
        pos = pos + step[..., None] * directions
        d = torch.where(done, d, d_new)
        done = done_new
    hit = (d < eps) & ~outside_box
    return pos, d, hit


def estimate_normal(dist, grid, p, iso=0.0,
                    mode: RaymarchMode = RaymarchMode.TRILINEAR):
    """6-tap central differences (`draw_raymarching.wgsl:202-209`), on the
    device of ``p``."""
    dist, lat = _on(dist, grid, p.device)
    eps = _grid_epsilon(lat)

    def s(q):
        return sample(dist, lat, q, mode) - iso

    ex = _vec([1.0, 0, 0], p.device) * eps
    ey = _vec([0, 1.0, 0], p.device) * eps
    ez = _vec([0, 0, 1.0], p.device) * eps
    n = torch.stack(
        [s(p + ex) - s(p - ex), s(p + ey) - s(p - ey), s(p + ez) - s(p - ez)],
        dim=-1,
    )
    norm = _norm(n)
    return n / torch.where(norm == 0.0, 1.0, norm)


def _phong_stylized(dist, grid, pos, eye, iso,
                    k_d=0.8, k_s=0.5, alpha=50.0,
                    light_pos=(-5.0, 5.0, 5.0),
                    light_intensity=(0.4, 1.0, 0.4)):
    """`phong_lighting` (`draw_raymarching.wgsl:211-231`), branchless: the
    shader's early returns become a where-ladder (light-behind-surface →
    2% ambient; reflection away from viewer → diffuse only)."""
    li = _vec(light_intensity, pos.device)
    n = estimate_normal(dist, grid, pos, iso, RaymarchMode.SNAP_STYLIZED)
    l_dir = _normalize(_vec(light_pos, pos.device) - pos)
    v = _normalize(eye - pos)
    # reflect(-L, N) = -L - 2*dot(-L, N)*N = 2*dot(L,N)*N - L.
    dot_ln = _dot(l_dir, n)
    r = 2.0 * dot_ln[..., None] * n - l_dir
    rn = _norm(r)
    r = r / torch.where(rn == 0.0, 1.0, rn)
    dot_rv = _dot(r, v)
    full = k_d * dot_ln + k_s * torch.pow(torch.clamp_min(dot_rv, 0.0), alpha)
    strength = torch.where(
        dot_ln < 0.0, 0.02,
        torch.where(dot_rv < 0.0, k_d * dot_ln, full),
    )
    return li * strength[..., None]


def attenuate(color, brightness):
    """Per-channel exponential attenuation (`draw_raymarching.wgsl:353-356`),
    clipped to [0, 1]."""
    atten = torch.stack(
        [
            torch.exp(-1.8 * (1.0 - brightness)),
            torch.exp(-1.9 * (1.0 - brightness)),
            torch.exp(-1.9 * (1.0 - brightness)),
        ],
        dim=-1,
    )
    return torch.clamp(color * atten, 0.0, 1.0)


def default_light(grid: Grid, camera: Camera, device) -> torch.Tensor:
    """Above the eye by the grid's largest extent."""
    bmin, bmax = grid.bounding_box()
    ext = (bmax - bmin).amax().to(device)
    return _vec(camera.eye, device) + ext * _vec([0.0, 1.0, 0.0], device)


def blinn(normal, pos, light, eye):
    """(light_dir, diffuse, specular) of the Blinn-Phong model."""
    light_dir = _normalize(light - pos)
    diffuse = torch.clamp_min(_dot(normal, light_dir), 0.0)
    view_dir = _normalize(eye - pos)
    half = _normalize(light_dir + view_dir)
    specular = torch.clamp_min(_dot(normal, half), 0.0)
    return light_dir, diffuse, specular


def render(
    dist,
    grid: Grid,
    camera: Camera,
    iso: float = 0.0,
    *,
    mode: RaymarchMode = RaymarchMode.TRILINEAR,
    light_pos: Optional[Tuple[float, float, float]] = None,
    base_color: Tuple[float, float, float] = (0.5, 0.5, 0.5),
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    max_steps: int = MAX_STEPS,
    shadows: bool = True,
    material=None,
    device=None,
) -> torch.Tensor:
    """Render the SDF grid to an (H, W, 3) float image in [0, 1].

    Runs on ``device`` when given, else on the device of ``dist`` when it
    is a tensor, else on CUDA. Shading follows `sdf_scene`
    (`draw_raymarching.wgsl:289-357`): grey base color, ambient 0.2, diffuse
    + Blinn specular, per-channel exponential attenuation; hard shadows by
    re-tracing toward the light.

    ``material``: optional :class:`.cubemap.Cubemap` — surface albedo from
    6-direction visibility-weighted projection instead of ``base_color``
    (`draw_raymarching.wgsl:364-441`).
    """
    device = resolve_device(device, dist)
    dist, lat = _on(dist, grid, device)
    origins, directions = camera.rays(device)
    pos, d, hit = trace(dist, lat, origins, directions, iso, mode, max_steps)
    eye = _vec(camera.eye, device)
    bg = _vec(background, device).expand(pos.shape)

    if mode == RaymarchMode.SNAP_STYLIZED:
        # Stylized branch (`draw_raymarching.wgsl:302-306`): fixed-light
        # green Phong with NO material mapping, shadows, or attenuation.
        shaded = _phong_stylized(dist, lat, pos, eye, iso)
        return torch.where(hit[..., None], torch.clamp(shaded, 0.0, 1.0), bg)

    light = (default_light(grid, camera, device) if light_pos is None
             else _vec(light_pos, device))
    normal = estimate_normal(dist, lat, pos, iso, mode)
    light_dir, diffuse, specular = blinn(normal, pos, light, eye)

    if shadows:
        eps = _grid_epsilon(lat)
        shadow_origin = pos + normal * eps * 4.0
        _, _, shadow_hit = trace(dist, lat, shadow_origin, light_dir, iso,
                                 mode, max_steps)
        lit = torch.where(shadow_hit, 0.0, 1.0)
    else:
        lit = torch.ones_like(diffuse)

    ambient = 0.2
    brightness = ambient + (diffuse + specular) * lit
    if material is not None:
        from .cubemap import sample_cubemap

        color = sample_cubemap(material, pos, normal)
    else:
        color = _vec(base_color, device).expand(pos.shape)
    return torch.where(hit[..., None], attenuate(color, brightness), bg)
