"""Plain reference for signed distances to a closed triangle mesh.

Straightforward PyTorch, written from the definitions and not from the
port: the distance from a point to a triangle is the distance to its plane
where the point projects inside it, else the least distance to its three
edges as segments; the sign is the mesh's generalised winding number
(the solid angles of Van Oosterom and Strackee, summed over 4π), which is
1 inside a closed, outward-wound mesh and 0 outside. Every point is held
against every triangle, in blocks of points, in ``dtype`` (float64 for the
reference; the control asks for a lower precision).

It imports nothing of ``mesh_to_sdf_tpu_torch`` and nothing of JAX, and
takes only the inputs the benchmark made: points and a triangle soup.
"""
from __future__ import annotations

import math

import torch

#: Points per block: a block holds this many x the triangles in each of a
#: few dozen temporaries.
BLOCK_ELEMS = 1 << 24


def _dot(u, w):
    return u[..., 0] * w[..., 0] + u[..., 1] * w[..., 1] + u[..., 2] * w[..., 2]


def _cross(u, w):
    return torch.stack([u[..., 1] * w[..., 2] - u[..., 2] * w[..., 1],
                        u[..., 2] * w[..., 0] - u[..., 0] * w[..., 2],
                        u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0]], -1)


def _seg_d2(ap, ab, lab):
    """Squared distance from points (offset ``ap`` from a) to segments
    a→b, (n, T)."""
    t = torch.clamp(_dot(ap, ab) / torch.where(lab > 0, lab, 1.0), 0.0, 1.0)
    d = ap - t[..., None] * ab
    return _dot(d, d)


def _block_d2(p, a, b, c, terms):
    """(n, T) squared distances from points ``p`` (n, 3) to triangles."""
    n, nn, eab, ebc, eca, ab, bc, ca, lab, lbc, lca = terms
    ap = p[:, None, :] - a[None]
    bp = p[:, None, :] - b[None]
    cp = p[:, None, :] - c[None]
    inside = ((_dot(ap, eab) >= 0) & (_dot(bp, ebc) >= 0)
              & (_dot(cp, eca) >= 0) & (nn > 0))
    h = _dot(ap, n)
    plane = h * h / torch.where(nn > 0, nn, 1.0)
    edges = torch.minimum(torch.minimum(_seg_d2(ap, ab, lab),
                                        _seg_d2(bp, bc, lbc)),
                          _seg_d2(cp, ca, lca))
    return torch.where(inside, plane, edges)


def _terms(a, b, c):
    ab, bc, ca = b - a, c - b, a - c
    n = _cross(ab, c - a)
    return (n[None], _dot(n, n)[None], _cross(n, ab)[None],
            _cross(n, bc)[None], _cross(n, ca)[None], ab[None], bc[None],
            ca[None], _dot(ab, ab)[None], _dot(bc, bc)[None],
            _dot(ca, ca)[None])


def _block_winding(p, a, b, c):
    """(n,) winding numbers of points ``p`` (n, 3)."""
    x, y, z = a[None] - p[:, None], b[None] - p[:, None], c[None] - p[:, None]
    lx = torch.sqrt(_dot(x, x))
    ly = torch.sqrt(_dot(y, y))
    lz = torch.sqrt(_dot(z, z))
    det = _dot(x, _cross(y, z))
    den = lx * ly * lz + _dot(x, y) * lz + _dot(y, z) * lx + _dot(z, x) * ly
    return torch.sum(2.0 * torch.atan2(det, den), dim=1) / (4.0 * math.pi)


def signed_distance(points, tris, *, dtype=torch.float64, device=None):
    """Signed distance (positive outside, negative inside) from each of
    ``points`` (n, 3) to the closed mesh ``tris`` (T, 3, 3), computed in
    ``dtype`` on ``device`` (default: the points' device). Returns
    (signed (n,) float64, unsigned (n,) float64) on that device."""
    points = torch.as_tensor(points)
    tris = torch.as_tensor(tris)
    device = torch.device(device) if device is not None else points.device
    p_all = points.to(device, dtype)
    t = tris.to(device, dtype)
    a, b, c = t[:, 0], t[:, 1], t[:, 2]
    terms = _terms(a, b, c)
    step = max(1, BLOCK_ELEMS // max(t.shape[0], 1))
    dist, wind = [], []
    for s in range(0, p_all.shape[0], step):
        p = p_all[s:s + step]
        d2 = torch.amin(_block_d2(p, a, b, c, terms), dim=1)
        dist.append(torch.sqrt(d2).to(torch.float64))
        wind.append(_block_winding(p, a, b, c).to(torch.float64))
    d = torch.cat(dist)
    inside = torch.abs(torch.cat(wind)) > 0.5
    return torch.where(inside, -d, d), d
