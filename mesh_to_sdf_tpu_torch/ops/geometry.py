"""Branchless triangle geometry (PyTorch counterpart of ``ops/geometry.py``).

The trusted per-pair math of the reference geometry layer
(`mesh_to_sdf/src/geo.rs`), ported operation for operation from the JAX
package: the reference's early-return ladders become ``torch.where``
selection ladders over broadcasting tensors, and every divisor is guarded.

- closest point on triangle: Embree case analysis + degenerate guards
  (`geo.rs:70-138`), segment projection (`geo.rs:141-151`);
- AABB epsilon inflation of 1e-4 (`geo.rs:5,20-21`);
- the normal sign test is *strictly greater* ⇒ positive (`geo.rs:51-55`);
- axis-aligned ray/triangle: 2-D edge cross products, same-strict-sign test,
  ``t > 0`` strictly (`geo.rs:165-216`), axis rotation (x, y, z) →
  (k, k+1, k+2) mod 3 (`geo.rs:181-195`).

Dot products are written out as ``x0·y0 + x1·y1 + x2·y2`` (the order XLA
reduces a length-3 axis in), and square roots are taken in float64 and
rounded once: torch's vectorised float32 root on the CPU is one ulp off in
about 13% of cases, the correctly rounded root is what XLA and CUDA give.
"""
from __future__ import annotations

import torch

#: AABB inflation epsilon (`geo.rs:5`).
AABB_EPSILON = 1e-4


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (taken in float64)."""
    return torch.sqrt(x.double()).to(torch.float32)


def _safe_div(num, den):
    """num/den with den==0 treated as 1 (branch never selected downstream)."""
    return num / torch.where(den == 0.0, 1.0, den)


def triangle_bounding_box(a, b, c):
    """Per-triangle AABB inflated by ``AABB_EPSILON`` (`geo.rs:4-22`)."""
    a, b, c = _f32(a), _f32(b), _f32(c)
    lo = torch.minimum(a, torch.minimum(b, c)) - AABB_EPSILON
    hi = torch.maximum(a, torch.maximum(b, c)) + AABB_EPSILON
    return lo, hi


def triangle_normal(a, b, c):
    """Unnormalized triangle normal ``(b-a)×(c-a)`` (`geo.rs:60-64`)."""
    ab, ac = _f32(b) - _f32(a), _f32(c) - _f32(a)
    ab, ac = torch.broadcast_tensors(ab, ac)
    return torch.linalg.cross(ab, ac, dim=-1)


def _bary(u, v, w):
    return torch.stack(torch.broadcast_tensors(_f32(u), _f32(v), _f32(w)),
                       dim=-1)


def closest_point_barycentric(p, a, b, c):
    """Barycentric coords (u, v, w) of the point of triangle abc closest to p.

    Branchless Embree region ladder (`geo.rs:70-138`) with the degenerate
    guards (`geo.rs:73-88`); the reference's sequential early returns are
    reproduced by applying ``where`` overrides in reverse priority order.
    Returned shape: (..., 3) with u+v+w == 1.
    """
    p, a, b, c = _f32(p), _f32(a), _f32(b), _f32(c)
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)

    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)

    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    in_b = (d3 >= 0.0) & (d4 <= d3)
    in_c = (d6 >= 0.0) & (d5 <= d6)
    on_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    on_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    on_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)

    t_ab = _safe_div(d1, d1 - d3)
    t_ac = _safe_div(d2, d2 - d6)
    t_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))

    denom_in = va + vb + vc
    v_in = _safe_div(vb, denom_in)
    w_in = _safe_div(vc, denom_in)

    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)

    out = _bary(1.0 - v_in - w_in, v_in, w_in)
    out = torch.where(on_bc[..., None], _bary(zero, 1.0 - t_bc, t_bc), out)
    out = torch.where(on_ac[..., None], _bary(1.0 - t_ac, zero, t_ac), out)
    out = torch.where(on_ab[..., None], _bary(1.0 - t_ab, t_ab, zero), out)
    out = torch.where(in_c[..., None], _bary(zero, zero, one), out)
    out = torch.where(in_b[..., None], _bary(zero, one, zero), out)
    out = torch.where(in_a[..., None], _bary(one, zero, zero), out)

    # Degenerate guards: a==b → segment [a,c]; b==c or a==c → segment
    # [a,b]; all equal → vertex a.
    eq_ab = torch.all(a == b, dim=-1)
    eq_bc = torch.all(b == c, dim=-1)
    eq_ac = torch.all(a == c, dim=-1)

    s_ac = _segment_param(p, a, c)
    s_ab = _segment_param(p, a, b)

    out = torch.where((eq_bc | eq_ac)[..., None],
                      _bary(1.0 - s_ab, s_ab, zero), out)
    out = torch.where(eq_ab[..., None], _bary(1.0 - s_ac, zero, s_ac), out)
    out = torch.where((eq_ab & eq_bc & eq_ac)[..., None],
                      _bary(one, zero, zero), out)
    return out


def _segment_param(p, a, b):
    """Clamped projection parameter of p onto segment [a,b]
    (`geo.rs:141-151`)."""
    ab = b - a
    m = _dot(ab, ab)
    s = _safe_div(_dot(ab, p - a), m)
    return torch.clamp(s, 0.0, 1.0)


def _closest(bc, a, b, c):
    return bc[..., 0:1] * a + bc[..., 1:2] * b + bc[..., 2:3] * c


def closest_point_on_triangle(p, a, b, c):
    """Closest point of triangle abc to p (`geo.rs:70-138`)."""
    bc = closest_point_barycentric(p, a, b, c)
    return _closest(bc, _f32(a), _f32(b), _f32(c))


def point_triangle_distance2(p, a, b, c):
    """Squared unsigned point→triangle distance (`geo.rs:33-37`)."""
    d = _f32(p) - closest_point_on_triangle(p, a, b, c)
    return _dot(d, d)


def point_triangle_distance(p, a, b, c):
    """Unsigned point→triangle distance (`geo.rs:26-30`)."""
    return sqrt_f32(point_triangle_distance2(p, a, b, c))


def point_triangle_sign(p, q, a, b, c):
    """+1 if p is on the outer (normal) side of the triangle, else -1; a zero
    dot product is negative (`geo.rs:51-55`)."""
    n = triangle_normal(a, b, c)
    d = _dot(_f32(p) - _f32(q), n)
    return torch.where(d > 0.0, 1.0, -1.0)


def point_triangle_signed_distance(p, a, b, c):
    """Normal-signed point→triangle distance (`geo.rs:43-56`)."""
    p, a, b, c = _f32(p), _f32(a), _f32(b), _f32(c)
    q = _closest(closest_point_barycentric(p, a, b, c), a, b, c)
    d = p - q
    dist = sqrt_f32(_dot(d, d))
    return dist * point_triangle_sign(p, q, a, b, c)


def ray_triangle_aligned(origin, a, b, c, axis: int):
    """Axis-aligned ray/triangle test along +``axis`` (`geo.rs:165-216`).
    Returns ``(hit, t)``; ``t`` is valid only where ``hit``."""
    hit2d, t = ray_triangle_aligned_2d(origin, a, b, c, axis)
    return hit2d & (t > 0.0), t


def ray_triangle_aligned_2d(origin, a, b, c, axis: int):
    """The projected point-in-triangle test (strict same-sign edge weights)
    and the *unclamped* line parameter ``t`` of :func:`ray_triangle_aligned`
    (`generate/grid.rs:601-618` counts cells along the line from it)."""
    origin, a, b, c = _f32(origin), _f32(a), _f32(b), _f32(c)
    ix = axis
    iy = (axis + 1) % 3
    iz = (axis + 2) % 3

    e01 = b - a
    e12 = c - b
    e20 = a - c

    p0 = origin - a
    p1 = origin - b
    p2 = origin - c

    w0 = p1[..., iz] * e12[..., iy] - p1[..., iy] * e12[..., iz]
    w1 = p2[..., iz] * e20[..., iy] - p2[..., iy] * e20[..., iz]
    w2 = p0[..., iz] * e01[..., iy] - p0[..., iy] * e01[..., iz]

    inside = ((w0 < 0.0) & (w1 < 0.0) & (w2 < 0.0)) | (
        (w0 > 0.0) & (w1 > 0.0) & (w2 > 0.0)
    )
    wsum = w0 + w1 + w2
    t = -_safe_div(
        w0 * p0[..., ix] + w2 * p2[..., ix] + w1 * p1[..., ix], wsum
    )
    return inside, t
