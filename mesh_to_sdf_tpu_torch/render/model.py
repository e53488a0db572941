"""Source-mesh rendering: ray-cast the triangle soup per pixel.

PyTorch counterpart of the JAX package's ``render/model.py`` (the client's
Model / ModelAndSdf render modes, `mesh_to_sdf_client/src/passes/
model_render_pass.rs:22-84`, mode enum `sdf_program.rs:38-45`): the original
geometry drawn with Blinn-Phong shading and shadows, alone or composited
with the raymarched SDF. Each pixel ray is tested against every triangle
(nearest hit), in chunks of pixels × blocks of triangles, torch operations
on the device: O(pixels × triangles), as the JAX scan. A second occlusion
ray toward the light stands in for the shadow map.

Compositing (ModelAndSdf): both surfaces are traced independently and the
nearer hit wins per pixel — the offline equivalent of sharing one depth
buffer across the model and SDF passes (`sdf_program.rs:471-591`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..grid import Grid
from ..intake import resolve_device
from .raymarch import (MAX_STEPS, Camera, _cross, _dot, _grid_epsilon, _norm,
                       _normalize, _on, _vec, attenuate, blinn,
                       estimate_normal, trace)
from .sampler import RaymarchMode

_INF = float(np.float32(3.0e38))
#: Pixels per chunk and triangles per block (bound the (chunk, block) pair
#: temporaries); the result does not depend on either.
PIXEL_CHUNK = 4096
TRI_BLOCK = 512


def _moller_trumbore(o, d, a, b, c):
    """General ray-triangle intersection. o/d: (..., 1, 3); a/b/c: (1, B, 3).

    Returns (t, u, v, hit). The aligned test (`geo.rs:156-216`) is a special
    case; the general form is needed for arbitrary camera rays.
    """
    e1 = b - a
    e2 = c - a
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv = torch.where(det.abs() < 1e-12, 0.0,
                      1.0 / torch.where(det == 0.0, 1.0, det))
    tvec = o - a
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    hit = (
        (det.abs() >= 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 1e-6)
    )
    return t, u, v, hit


def trace_mesh(origins, directions, ta, tb, tc, *,
               tri_block: int = TRI_BLOCK, chunk: int = PIXEL_CHUNK,
               any_hit: bool = False):
    """Nearest triangle hit per ray, on the device of ``origins``.
    origins/directions: (..., 3); ta/tb/tc: (T, 3). Returns (t (...,),
    tri (...,) int32, u, v, hit).

    ``any_hit=True`` answers occlusion only (shadow rays): ``hit`` and
    ``t`` (the nearest hit's parameter) are kept; ``tri``/u/v are not
    meaningful.
    """
    device = origins.device
    shape = origins.shape[:-1]
    o_flat = origins.reshape(-1, 3)
    d_flat = directions.reshape(-1, 3)
    Q = o_flat.shape[0]
    T = ta.shape[0]
    pad_t = (-T) % tri_block
    blocks = [torch.cat([x.to(device, torch.float32),
                         torch.full((pad_t, 3), 1e18, device=device)])
              .reshape(-1, tri_block, 3) for x in (ta, tb, tc)]
    n_blocks = blocks[0].shape[0]

    tmin = torch.full((Q,), _INF, dtype=torch.float32, device=device)
    imin = torch.full((Q,), -1, dtype=torch.int32, device=device)
    umin = torch.zeros((Q,), dtype=torch.float32, device=device)
    vmin = torch.zeros((Q,), dtype=torch.float32, device=device)
    for q0 in range(0, Q, chunk):
        o = o_flat[q0:q0 + chunk, None, :]
        d = d_flat[q0:q0 + chunk, None, :]
        tm, im = tmin[q0:q0 + chunk], imin[q0:q0 + chunk]
        um, vm = umin[q0:q0 + chunk], vmin[q0:q0 + chunk]
        for bidx in range(n_blocks):
            a, b, c = (x[bidx][None] for x in blocks)
            t, u, v, hit = _moller_trumbore(o, d, a, b, c)
            tt = torch.where(hit, t, _INF)
            tbest, arg = torch.min(tt, dim=1)  # first index on ties
            better = tbest < tm
            tm.copy_(torch.where(better, tbest, tm))
            if any_hit:
                continue
            arg = arg[:, None]
            im.copy_(torch.where(better, bidx * tri_block + arg[:, 0]
                                 .to(torch.int32), im))
            um.copy_(torch.where(better, u.gather(1, arg)[:, 0], um))
            vm.copy_(torch.where(better, v.gather(1, arg)[:, 0], vm))
    hit = tmin < _INF
    return (tmin.reshape(shape), imin.reshape(shape), umin.reshape(shape),
            vmin.reshape(shape), hit.reshape(shape))


def _shade(pos, normal, color, eye, light, occluded):
    """Blinn-Phong + exponential attenuation — identical formula to the SDF
    renderer so Model and Sdf modes match visually (wgsl `:312-357`)."""
    _, diffuse, specular = blinn(normal, pos, light, eye)
    lit = torch.where(occluded, 0.0, 1.0)
    brightness = 0.2 + (diffuse + specular) * lit
    return attenuate(color, brightness)


def _render_model_impl(ta, tb, tc, colors, camera: Camera, light, *,
                       shadows: bool):
    device = ta.device
    origins, directions = camera.rays(device)
    eye = _vec(camera.eye, device)
    t, tri, u, v, hit = trace_mesh(origins, directions, ta, tb, tc)
    pos = origins + t[..., None] * directions

    # Face normal, flipped toward the viewer (the client renders two-sided
    # unless backface culling is enabled, `model_render_pass.rs:60-66`).
    safe = tri.clamp_min(0).long()
    a = ta[safe]
    b = tb[safe]
    c = tc[safe]
    n = _cross(b - a, c - a)
    n = n / torch.clamp_min(_norm(n), 1e-20)
    n = torch.where(_dot(n, directions)[..., None] > 0.0, -n, n)

    if colors is None:
        color = _vec([0.6, 0.6, 0.6], device).expand(pos.shape)
    else:
        ca, cb, cc = colors
        w_a = (1.0 - u - v)[..., None]
        color = w_a * ca[safe] + u[..., None] * cb[safe] + v[..., None] * cc[safe]

    if shadows:
        scale = _norm(torch.stack([a, b, c]), keepdim=False).amax()
        shadow_o = pos + n * 1e-3 * scale
        ldir = _normalize(light - pos)
        _, _, _, _, occ = trace_mesh(shadow_o, ldir, ta, tb, tc, any_hit=True)
    else:
        occ = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=device)

    shaded = _shade(pos, n, color, eye, light, occ)
    return t, pos, shaded, hit


def _soup(vertices, faces, vertex_colors, device):
    """((ta, tb, tc), colors or None) as float32 tensors on ``device``."""
    v = np.asarray(vertices.detach().cpu() if isinstance(vertices,
                   torch.Tensor) else vertices, np.float32)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    tris = tuple(torch.from_numpy(np.ascontiguousarray(v[f[:, k]])).to(device)
                 for k in range(3))
    colors = None
    if vertex_colors is not None:
        col = np.asarray(vertex_colors, np.float32)
        colors = tuple(torch.from_numpy(np.ascontiguousarray(col[f[:, k]]))
                       .to(device) for k in range(3))
    return tris, colors


def _model_light(camera: Camera, ta, light_pos):
    if light_pos is not None:
        return _vec(light_pos, ta.device)
    ext = ta.amax(dim=0) - ta.amin(dim=0)
    return _vec(camera.eye, ta.device) + ext.amax() * _vec([0.0, 1.0, 0.0],
                                                           ta.device)


def render_model(
    vertices,
    faces,
    camera: Camera,
    *,
    vertex_colors=None,
    light_pos: Optional[Tuple[float, float, float]] = None,
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    shadows: bool = True,
    device=None,
) -> torch.Tensor:
    """Render the source mesh to an (H, W, 3) float image in [0, 1]
    (≙ RenderMode::Model, `model_render_pass.rs:22-84`), on ``device``
    (default: the device of a tensor ``vertices``, else CUDA)."""
    device = resolve_device(device, vertices)
    (ta, tb, tc), colors = _soup(vertices, faces, vertex_colors, device)
    light = _model_light(camera, ta, light_pos)
    _, _, shaded, hit = _render_model_impl(ta, tb, tc, colors, camera, light,
                                           shadows=shadows)
    bg = _vec(background, device).expand(shaded.shape)
    return torch.where(hit[..., None], shaded, bg)


def render_model_and_sdf(
    vertices,
    faces,
    dist,
    grid: Grid,
    camera: Camera,
    iso: float = 0.0,
    *,
    vertex_colors=None,
    mode: RaymarchMode = RaymarchMode.TRILINEAR,
    light_pos: Optional[Tuple[float, float, float]] = None,
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    sdf_color: Tuple[float, float, float] = (0.35, 0.45, 0.65),
    shadows: bool = True,
    max_steps: int = MAX_STEPS,
    device=None,
) -> torch.Tensor:
    """Composite the source mesh and the raymarched SDF surface
    (≙ RenderMode::ModelAndSdf, `sdf_program.rs:38-45`): both are traced
    and the nearer surface wins per pixel — the offline stand-in for the
    shared depth buffer. Runs on ``device`` (default: the device of a
    tensor ``dist`` or ``vertices``, else CUDA)."""
    device = resolve_device(device, dist, vertices)
    (ta, tb, tc), colors = _soup(vertices, faces, vertex_colors, device)
    light = _model_light(camera, ta, light_pos)
    t_model, _, model_px, model_hit = _render_model_impl(
        ta, tb, tc, colors, camera, light, shadows=shadows
    )

    dist, lat = _on(dist, grid, device)
    eye = _vec(camera.eye, device)
    origins, directions = camera.rays(device)
    pos_s, _, sdf_hit = trace(dist, lat, origins, directions, iso, mode,
                              max_steps)
    t_sdf = _norm(pos_s - eye, keepdim=False)
    n_s = estimate_normal(dist, lat, pos_s, iso, mode)
    if shadows:
        eps = _grid_epsilon(lat)
        ldir = _normalize(light - pos_s)
        _, _, occ_s = trace(dist, lat, pos_s + n_s * eps * 4.0, ldir, iso,
                            mode, max_steps)
    else:
        occ_s = torch.zeros(t_sdf.shape, dtype=torch.bool, device=device)
    sdf_px = _shade(pos_s, n_s, _vec(sdf_color, device).expand(pos_s.shape),
                    eye, light, occ_s)

    t_m = torch.where(model_hit, t_model, _INF)
    t_s = torch.where(sdf_hit, t_sdf, _INF)
    model_wins = t_m <= t_s
    px = torch.where(model_wins[..., None], model_px, sdf_px)
    any_hit = model_hit | sdf_hit
    bg = _vec(background, device).expand(px.shape)
    return torch.where(any_hit[..., None], px, bg)
