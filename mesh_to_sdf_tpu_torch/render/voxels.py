"""True voxel rendering: exact ray-cast of the iso-band cell cubes.

PyTorch counterpart of the JAX package's ``render/voxels.py`` (the client's
instanced-cube voxel pass, `mesh_to_sdf_client/src/passes/
voxel_render_pass.rs:280-310`, `shaders/draw_voxels.wgsl:100-227`): every
pixel ray walks the grid with a fixed-iteration Amanatides–Woo DDA over the
band occupancy mask, ``nx+ny+nz+2`` steps (a straight line crosses at most
that many cells), torch operations on the device with no read-back per step.

Behavioural parity, cited into the shader:
- the cube set is the `ordered_indices[lo..hi]` slice around
  ``iso ± cell_width`` (`voxel_render_pass.rs:280-310`), here the equivalent
  membership test `|d - iso| ≤ cell_width`;
- cubes centered on cell centers with cell_size extents
  (`draw_voxels.wgsl:100-117`);
- ONE flat color per cell, sampled at the CELL CENTER (`draw_voxels.wgsl
  :178`): cubemap albedo when a material is given, else the 0.5 grey mix;
- lighting `ambient 0.2 + (diffuse + 0.5·specular)·shadow` with the
  per-channel exponential attenuation (`draw_voxels.wgsl:216-227`);
- shadows: the DDA re-walked toward the light through the same occupancy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..grid import Grid
from ..query import resolve_device
from .raymarch import Camera, _vec, attenuate, blinn, default_light
from .sampler import lattice


def band_occupancy(dist, grid: Grid, iso: float = 0.0,
                   width_scale: float = 1.0) -> torch.Tensor:
    """(nx, ny, nz) bool — cells the voxel pass instances as cubes: distance
    within ``iso ± cell_width`` (`voxel_render_pass.rs:280-310`)."""
    if not isinstance(dist, torch.Tensor):
        dist = torch.from_numpy(np.asarray(dist, np.float32))
    w = width_scale * grid.cell_size.abs().amax().to(dist.device)
    d = dist.reshape(grid.cell_count)
    return (d >= iso - w) & (d <= iso + w)


def dda_trace(occ: torch.Tensor, grid: Grid, origins, directions):
    """Walk rays cell-by-cell through ``occ`` until an occupied cube is hit,
    on the device of ``origins``.

    occ: (nx, ny, nz) bool. origins/directions: (..., 3) world space.
    Returns (hit (...,) bool, t_hit (...,) f32 — world ray parameter of the
    entering-face intersection, cell (..., 3) int32, normal (..., 3) f32 —
    the entered face's outward world normal).
    """
    device = origins.device
    nx, ny, nz = grid.cell_count
    counts = torch.tensor((nx, ny, nz), dtype=torch.int32, device=device)
    occ_flat = occ.to(device).reshape(-1)
    lat = lattice(grid, device)

    # u-space: cell i's cube spans u ∈ [i-0.5, i+0.5] on each axis — the
    # grid becomes a unit lattice regardless of per-axis (even negative)
    # cell sizes (`grid.rs:135-141` center convention).
    cs = lat.cell_size
    o_u = (origins - lat.first_cell) / cs
    d_u = directions / cs
    d_safe = torch.where(d_u == 0.0, 1e-12, d_u)

    lo = -0.5
    hi = counts.to(torch.float32) - 0.5
    t1 = (lo - o_u) / d_safe
    t2 = (hi - o_u) / d_safe
    t_lo = torch.minimum(t1, t2)
    t_hi = torch.maximum(t1, t2)
    t_near = t_lo.amax(dim=-1)
    t_far = t_hi.amin(dim=-1)
    miss = (t_near > t_far) | (t_far < 0.0)

    eps = 1e-4
    t0 = torch.clamp_min(t_near, 0.0) + eps
    inside = torch.all((o_u > lo) & (o_u < hi), dim=-1)
    t0 = torch.where(inside, 0.0, t0)
    p0 = o_u + t0[..., None] * d_u
    cell = torch.clamp(torch.floor(p0 + 0.5).to(torch.int32),
                       min=torch.zeros_like(counts), max=counts - 1)
    # Face by which the ray ENTERED its first cell: the slab that decided
    # t_near (for rays starting inside a cube the dominant direction axis).
    # argmax and argmin take the first index on ties, as in JAX.
    enter_axis = torch.argmax(t_lo, dim=-1).to(torch.int32)
    dom_axis = torch.argmax(d_u.abs(), dim=-1).to(torch.int32)
    enter_axis = torch.where(inside, dom_axis, enter_axis)

    step = torch.where(d_u >= 0.0, 1, -1).to(torch.int32)
    # Ray parameter at which the ray crosses the current cell's boundary
    # on each axis, and the per-axis crossing period.
    bound = cell.to(torch.float32) + 0.5 * step.to(torch.float32)
    tmax = t0[..., None] + (bound - p0) / d_safe
    tmax = torch.where(d_u == 0.0, float("inf"), tmax)
    tdelta = torch.abs(1.0 / d_safe)

    n_steps = nx + ny + nz + 2
    N = nx * ny * nz
    axes = torch.arange(3, device=device)
    shape = t0.shape
    t = t0
    done = miss
    hit = torch.zeros(shape, dtype=torch.bool, device=device)
    t_hit = torch.zeros(shape, dtype=torch.float32, device=device)
    hit_cell = torch.zeros(shape + (3,), dtype=torch.int32, device=device)
    hit_axis = torch.zeros(shape, dtype=torch.int32, device=device)
    for _ in range(n_steps):
        in_b = torch.all((cell >= 0) & (cell < counts), dim=-1)
        flat = (cell[..., 0] * (ny * nz) + cell[..., 1] * nz + cell[..., 2])
        occ_here = occ_flat[flat.clamp(0, N - 1).long()] & in_b
        new_hit = occ_here & ~done
        hit = hit | new_hit
        t_hit = torch.where(new_hit, t, t_hit)
        hit_cell = torch.where(new_hit[..., None], cell, hit_cell)
        hit_axis = torch.where(new_hit, enter_axis, hit_axis)
        done = done | new_hit

        t_new, axis = torch.min(tmax, dim=-1)
        onehot = axis[..., None] == axes
        cell_n = cell + torch.where(onehot, step, 0)
        tmax_n = tmax + torch.where(onehot, tdelta, 0.0)
        exited = t_new > t_far  # left the lattice — no more cubes ahead
        adv = ~done
        cell = torch.where(adv[..., None], cell_n, cell)
        tmax = torch.where(adv[..., None], tmax_n, tmax)
        t = torch.where(adv, t_new, t)
        enter_axis = torch.where(adv, axis.to(torch.int32), enter_axis)
        done = done | (exited & adv)

    # World-space outward normal of the entered face: -sign(direction)
    # along the hit axis (u-space step and cell-size sign cancel).
    onehot = hit_axis[..., None] == axes
    normal = torch.where(onehot, -torch.sign(directions), 0.0)
    return hit, t_hit, hit_cell, normal.to(torch.float32)


def render_voxels(
    dist,
    grid: Grid,
    camera: Camera,
    iso: float = 0.0,
    *,
    width_scale: float = 1.0,
    material=None,
    light_pos: Optional[Tuple[float, float, float]] = None,
    base_color: Tuple[float, float, float] = (0.5, 0.5, 0.5),
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    shadows: bool = True,
    device=None,
) -> torch.Tensor:
    """Render the iso-band cells as shaded cubes to an (H, W, 3) image, on
    ``device`` (default: the device of a tensor ``dist``, else CUDA).

    The offline equivalent of RenderMode::Voxels (`sdf_program.rs:38-45`,
    `draw_voxels.wgsl`): exact DDA cube intersection standing in for the
    instanced rasterizer, the same per-cell flat color, Blinn lighting and
    attenuation, and occlusion by the same voxel set instead of the PCF
    shadow map.
    """
    device = resolve_device(device, dist)
    if not isinstance(dist, torch.Tensor):
        dist = torch.from_numpy(np.asarray(dist, np.float32))
    occ = band_occupancy(dist.to(device), grid, iso, width_scale)
    origins, directions = camera.rays(device)
    hit, t_hit, hit_cell, normal = dda_trace(occ, grid, origins, directions)
    pos = origins + t_hit[..., None] * directions
    centers = grid.cell_center(hit_cell)

    light = (default_light(grid, camera, device) if light_pos is None
             else _vec(light_pos, device))
    light_dir, diffuse, specular = blinn(normal, pos, light,
                                         _vec(camera.eye, device))

    if shadows:
        # Start just off the lit face and re-walk the same occupancy toward
        # the light (`draw_voxels.wgsl:188-214`'s shadow map, hard).
        nudge = 0.6 * grid.cell_size.abs().amax().to(device)
        s_hit, _, _, _ = dda_trace(occ, grid, pos + normal * nudge, light_dir)
        lit = torch.where(s_hit, 0.0, 1.0)
    else:
        lit = torch.ones_like(diffuse)

    if material is not None:
        from .cubemap import sample_cubemap

        color = sample_cubemap(material, centers, normal)
    else:
        color = _vec(base_color, device).expand(pos.shape)
    brightness = 0.2 + (diffuse + 0.5 * specular) * lit
    bg = _vec(background, device).expand(pos.shape)
    return torch.where(hit[..., None], attenuate(color, brightness), bg)
