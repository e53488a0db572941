"""Cubemap material projection — the offline analog of the client's
6-face orthographic albedo capture + SDF surface texturing.

PyTorch counterpart of the JAX package's ``render/cubemap.py``. Reference:
`mesh_to_sdf_client/src/cubemap.rs:160-311` renders the source models into
six albedo+depth faces with per-face orthographic cameras fit to the model
bbox; the raymarcher then samples the six faces with direction-visibility
weights and a depth-based fallback (`shaders/draw_raymarching.wgsl:364-441`).

No rasterizer: each face is an axis-aligned ray-casting pass over its texel
grid (``ops.geometry.ray_triangle_aligned_2d``, the primitive of the sign
kernels), in chunks of texels × blocks of triangles on the device. One pass
per axis yields BOTH opposing faces (nearest hit = the face seen from the
negative side, farthest = the positive side). Albedo at a hit is the
barycentric blend of the mesh's per-vertex colors (``io.gltf.load_scene(
with_materials=True)``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops import geometry
from ..query import resolve_device

_INF = float(np.float32(3.0e38))
#: Texel chunk per step (bounds the (chunk, block) intermediates).
TEXEL_CHUNK = 4096
#: Default face resolution (the client uses 2048; 256 is plenty for the
#: vertex-resolution albedo this pipeline projects).
DEFAULT_RES = 256


@dataclass(frozen=True)
class Cubemap:
    """Six orthographic albedo+depth faces around a mesh.

    Face order: [-x, +x, -y, +y, -z, +z] (face ``2a`` views the mesh from
    the negative ``a`` side). ``depth`` stores the world coordinate along
    the face axis of the first visible surface (+/-inf where empty).
    """

    albedo: torch.Tensor  # (6, R, R, 3) f32
    depth: torch.Tensor  # (6, R, R) f32
    center: Tuple[float, float, float]
    half: Tuple[float, float, float]

    @property
    def resolution(self) -> int:
        return self.albedo.shape[1]


def _face_texels(center, half, axis: int, res: int):
    """(res*res, 3) ray origins on the negative side of `axis`."""
    iy, iz = (axis + 1) % 3, (axis + 2) % 3
    u = (torch.arange(res, dtype=torch.float32, device=center.device)
         + 0.5) / res * 2.0 - 1.0  # [-1, 1]
    uu, vv = torch.meshgrid(u, u, indexing="ij")
    o = torch.zeros((res, res, 3), dtype=torch.float32, device=center.device)
    o[..., iy] = center[iy] + uu * half[iy]
    o[..., iz] = center[iz] + vv * half[iz]
    o[..., axis] = center[axis] - half[axis] * 1.5
    return o.reshape(-1, 3)


def _axis_faces(center, half, ta, tb, tc, ca, cb, cc, *, axis: int, res: int,
                tri_block: int = 512):
    """Both faces along `axis`: (albedo-, depth-, albedo+, depth+)."""
    device = ta.device
    origins = _face_texels(center, half, axis, res)
    Q = origins.shape[0]
    T = ta.shape[0]
    pad = (-T) % tri_block

    def padded(x, value):
        return torch.cat([x, torch.full((pad, 3), value, dtype=torch.float32,
                                        device=device)])

    ta_p, tb_p, tc_p = (padded(x, 1e18) for x in (ta, tb, tc))
    ca_p, cb_p, cc_p = (padded(x, 0.0) for x in (ca, cb, cc))
    blocks = [x.reshape(-1, tri_block, 3) for x in (ta_p, tb_p, tc_p)]

    tmin = torch.full((Q,), _INF, dtype=torch.float32, device=device)
    imin = torch.zeros((Q,), dtype=torch.int64, device=device)
    tmax = torch.full((Q,), -_INF, dtype=torch.float32, device=device)
    imax = torch.zeros((Q,), dtype=torch.int64, device=device)
    for q0 in range(0, Q, TEXEL_CHUNK):
        o = origins[q0:q0 + TEXEL_CHUNK, None, :]
        tn, i_n = tmin[q0:q0 + TEXEL_CHUNK], imin[q0:q0 + TEXEL_CHUNK]
        tx, i_x = tmax[q0:q0 + TEXEL_CHUNK], imax[q0:q0 + TEXEL_CHUNK]
        for bidx in range(blocks[0].shape[0]):
            a, b, c = (x[bidx][None] for x in blocks)
            inside, t = geometry.ray_triangle_aligned_2d(o, a, b, c, axis)
            # First index on ties, as jnp.argmin / argmax.
            best, arg = torch.min(torch.where(inside, t, _INF), dim=1)
            better = best < tn
            tn.copy_(torch.where(better, best, tn))
            i_n.copy_(torch.where(better, bidx * tri_block + arg, i_n))
            best2, arg2 = torch.max(torch.where(inside, t, -_INF), dim=1)
            better2 = best2 > tx
            tx.copy_(torch.where(better2, best2, tx))
            i_x.copy_(torch.where(better2, bidx * tri_block + arg2, i_x))

    def shade(t, idx, hit):
        p = origins.clone()
        p[:, axis] += torch.where(hit, t, 0.0)
        bary = geometry.closest_point_barycentric(
            p, ta_p[idx], tb_p[idx], tc_p[idx]
        )
        col = (
            bary[:, 0:1] * ca_p[idx]
            + bary[:, 1:2] * cb_p[idx]
            + bary[:, 2:3] * cc_p[idx]
        )
        col = torch.where(hit[:, None], col, 0.0)
        depth = torch.where(hit, origins[:, axis] + t, _INF)
        return col.reshape(res, res, 3), depth.reshape(res, res)

    hit_min = tmin < _INF
    hit_max = tmax > -_INF
    alb_n, dep_n = shade(tmin, imin, hit_min)
    alb_p, dep_p = shade(tmax, imax, hit_max)
    dep_p = torch.where(hit_max.reshape(res, res), dep_p, -_INF)
    return alb_n, dep_n, alb_p, dep_p


def generate_cubemap(vertices, faces, vertex_colors, *, res: int = DEFAULT_RES,
                     pad: float = 1.05, device=None) -> Cubemap:
    """Project per-vertex albedo into six orthographic faces
    (≙ `cubemap.rs:160-311` + the generation pass), on ``device`` (default:
    the device of a tensor ``vertices``, else CUDA)."""
    device = resolve_device(device, vertices)
    if isinstance(vertices, torch.Tensor):
        vertices = vertices.detach().cpu().numpy()
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    col = np.asarray(vertex_colors, np.float32)
    lo = v.min(axis=0)
    hi = v.max(axis=0)
    center = (lo + hi) / 2
    half = np.maximum((hi - lo) / 2 * pad, 1e-6)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    ta, tb, tc = (up(v[f[:, k]]) for k in range(3))
    ca, cb, cc = (up(col[f[:, k]]) for k in range(3))
    c_t = up(center.astype(np.float32))
    h_t = up(half.astype(np.float32))

    albedo = []
    depth = []
    for axis in range(3):
        alb_n, dep_n, alb_p, dep_p = _axis_faces(
            c_t, h_t, ta, tb, tc, ca, cb, cc, axis=axis, res=res
        )
        albedo += [alb_n, alb_p]
        depth += [dep_n, dep_p]
    return Cubemap(
        albedo=torch.stack(albedo),
        depth=torch.stack(depth),
        center=tuple(float(x) for x in center),
        half=tuple(float(x) for x in half),
    )


def sample_cubemap(cm: Cubemap, pos, normal, *, depth_tolerance: float = None):
    """Albedo at surface points: 6-direction visibility-weighted blend with a
    depth-occlusion falloff (`draw_raymarching.wgsl:364-441` semantics).

    pos/normal: (..., 3) tensors on the cubemap's device. Returns (..., 3)
    linear albedo (grey 0.6 where no face sees the point).
    """
    res = cm.resolution
    device = cm.albedo.device
    center = torch.tensor(cm.center, dtype=torch.float32, device=device)
    half = torch.tensor(cm.half, dtype=torch.float32, device=device)
    if depth_tolerance is None:
        depth_tolerance = 4.0 * float(max(cm.half)) * 2.0 / res

    total_w = None
    total_c = None
    for axis in range(3):
        iy, iz = (axis + 1) % 3, (axis + 2) % 3
        u = (pos[..., iy] - (center[iy] - half[iy])) / (2 * half[iy])
        v = (pos[..., iz] - (center[iz] - half[iz])) / (2 * half[iz])
        ui = torch.clamp((u * res).to(torch.int32), 0, res - 1).long()
        vi = torch.clamp((v * res).to(torch.int32), 0, res - 1).long()
        for s, face in ((-1.0, 2 * axis), (1.0, 2 * axis + 1)):
            # A face captured from side s sees surfaces whose normal points
            # toward s (squared falloff like the shader's pow(dot, …)).
            w = torch.clamp_min(s * normal[..., axis], 0.0) ** 2
            alb = cm.albedo[face][ui, vi]
            dep = cm.depth[face][ui, vi]
            occ = torch.abs(pos[..., axis] - dep)
            vis = torch.where(occ < depth_tolerance, 1.0, 0.05)
            w = w * vis
            c = alb * w[..., None]
            total_w = w if total_w is None else total_w + w
            total_c = c if total_c is None else total_c + c
    grey = torch.full(pos.shape, 0.6, dtype=torch.float32, device=device)
    ok = total_w > 1e-6
    return torch.where(
        ok[..., None], total_c / torch.clamp_min(total_w, 1e-6)[..., None],
        grey
    )
