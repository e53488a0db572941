"""Fused point→mesh distance kernels: raycast sign and normal sign.

PyTorch counterpart of ``ops/kernels/pallas_sdf.py``. Three kernels, each
with a wrapper, a plain PyTorch version and a launch count:

- :func:`tri_records`: each triangle's per-triangle constants packed into
  one 80-byte record (:data:`RECORD_FIELDS`, ``csrc/tri_record.cuh``), read
  by the raycast kernel, by the CPT sweep and, cached per mesh, by the
  culled kernel; the normal kind (:data:`NORMAL_RECORD_FIELDS`) is read by
  the normal kernel;
- :func:`raycast_raw` (``_kernel_raycast``): per query the minimum squared
  distance over all triangles, and the number of +axis ray crossings for
  0, 1, 2 or 3 axes; on CUDA it packs the records and runs over them,
  splitting the triangles over several CTAs per query tile when the batch
  is too small to fill the card (:func:`raycast_chunks`);
- :func:`normal_raw` (``_kernel_normal``): per query the minimum squared
  distance over triangles on the positive normal side and on the negative
  one; on CUDA it runs over normal records with the raycast kernel's loop
  and the same split.

On a CUDA tensor a wrapper launches ``csrc/sdf.cu``; on a CPU tensor it runs
its plain version (:func:`tri_records_plain`, :func:`raycast_raw_plain`,
:func:`normal_raw_plain`). Any other device raises. The entry points
:func:`sdf_raycast`, :func:`sdf_raycast_parts`, :func:`sdf_normal` and
:func:`sdf_normal_champions` add the TPU wrappers' post-processing: the
square root, the odd-parity vote and the champion tie-break.

The pair math is the TPU kernel's division-free ladder
(``pallas_sdf.py:57-140``: per-triangle reciprocals, the ``_dist2``
expansion) and its ``num·den < 0`` crossing test (``:143-178``). It is not
``ops/geometry.py``'s ladder: the two differ by ulps, and kernel and plain
version agree exactly.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...types import F32_MAX
from ..geometry import sqrt_f32
from ..keyed import combine_champions
from . import _build

#: Kernel launches and plain-version calls of :func:`tri_records`.
RECORDS_COUNT = _build.LaunchCount()
#: Kernel launches and plain-version calls of :func:`raycast_raw`.
RAYCAST_COUNT = _build.LaunchCount()
#: Kernel launches and plain-version calls of :func:`normal_raw`.
NORMAL_COUNT = _build.LaunchCount()

#: Plain versions: triangles per block and queries per chunk, so that each
#: (chunk, block) pair temporary stays at 4M elements.
PLAIN_TRI_BLOCK = 256
PLAIN_QUERY_CHUNK = 16384
#: Most queries or triangles one call takes: the kernels pass Q and T as
#: int32 and round them up to a CTA's 128 rows.
MAX_ROWS = 2**31 - 1 - 128

#: A packed record's fields, in order (``csrc/tri_record.cuh``): the vertex
#: a, the edges ab and ac, A = |ab|², B = ab·ac, C = |ac|², the safe
#: reciprocals of A, C, A − 2B + C and AC − B², the crossing test's edge
#: ac − ab, and the degenerate flags (int32 bits: 1 segment [a, b], 2
#: segment [a, c], 4 vertex a).
RECORD_FIELDS = ("ax", "ay", "az", "A", "abx", "aby", "abz", "B",
                 "acx", "acy", "acz", "C", "inv_a", "inv_c", "inv_bc",
                 "inv_den", "e12x", "e12y", "e12z", "flags")
#: The normal kind's fields: the normal n = ab × ac (``normal_raw_plain``'s
#: operation order) in place of ac − ab.
NORMAL_RECORD_FIELDS = RECORD_FIELDS[:16] + ("nx", "ny", "nz", "flags")

#: The raycast kernel's shape (``csrc/sdf.cu``): queries per CTA (kThreads
#: × kRayR), triangles per staged tile, and the CTAs per SM its launch
#: bounds ask for. Held against the library's ``m2s_sdf_raycast_shape`` at
#: the first launch, as are the normal kernel's queries per CTA (kThreads
#: × kNormalR; its tiles and launch bounds are the raycast kernel's).
RAYCAST_CTA_QUERIES = 256
RAYCAST_TILE = 128
RAYCAST_CTAS_PER_SM = 4
NORMAL_CTA_QUERIES = 512
#: Split the triangles when the query tiles fill fewer than this many waves
#: of the card; every chunk keeps at least RAYCAST_MIN_CHUNK triangles.
RAYCAST_WAVES = 2
RAYCAST_MIN_CHUNK = 4 * RAYCAST_TILE
#: Most chunks one launch takes (gridDim.y).
RAYCAST_MAX_CHUNKS = 65535

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: m2s_tri_records: a b c, T, si sk, edges normal, out, stream.
_RECORDS_ARGTYPES = (_P, _P, _P, _L, _L, _L, _I, _I, _P, _P)
#: m2s_sdf_raycast: queries Q, records T, chunk, axes, d2 counts, stream.
_RAYCAST_ARGTYPES = (_P, _I, _P, _I, _I, _I, _P, _P, _P)
#: m2s_sdf_raycast_shape: out (4 int32).
_SHAPE_ARGTYPES = (_P,)
#: m2s_sdf_normal: queries Q, records T, chunk, pos2 neg2, stream.
_NORMAL_ARGTYPES = (_P, _I, _P, _I, _I, _P, _P, _P)


def _rcp(x):
    return torch.where(x == 0.0, 0.0, 1.0 / torch.where(x == 0.0, 1.0, x))


def closest_point_vw(apx, apy, apz, abx, aby, abz, acx, acy, acz):
    """Barycentric (v, w) of the closest point for every pair, with the
    terms :func:`dist2` reuses: (v, w, d1, d2, A, B, C). Operation for
    operation ``pallas_sdf._closest_point_vw``."""
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz

    A = abx * abx + aby * aby + abz * abz  # |ab|²
    B_ = abx * acx + aby * acy + abz * acz  # ab·ac
    C = acx * acx + acy * acy + acz * acz  # |ac|²

    d3 = d1 - A
    d4 = d2 - B_
    d5 = d1 - B_
    d6 = d2 - C

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    t_ab = d1 * _rcp(A)
    t_ac = d2 * _rcp(C)
    t_bc = (d4 - d3) * _rcp(A - 2.0 * B_ + C)  # 1/|b-c|²
    inv_den = _rcp(A * C - B_ * B_)  # 1/|ab×ac|²

    w = torch.where
    # Lowest priority: interior (`geo.rs:130-137`), then edges, vertices.
    v_ = vb * inv_den
    w_ = vc * inv_den
    on_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)
    v_ = w(on_bc, 1.0 - t_bc, v_)
    w_ = w(on_bc, t_bc, w_)
    on_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    v_ = w(on_ac, 0.0, v_)
    w_ = w(on_ac, t_ac, w_)
    on_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    v_ = w(on_ab, t_ab, v_)
    w_ = w(on_ab, 0.0, w_)
    in_c = (d6 >= 0.0) & (d5 <= d6)
    v_ = w(in_c, 0.0, v_)
    w_ = w(in_c, 1.0, w_)
    in_b = (d3 >= 0.0) & (d4 <= d3)
    v_ = w(in_b, 1.0, v_)
    w_ = w(in_b, 0.0, w_)
    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    v_ = w(in_a, 0.0, v_)
    w_ = w(in_a, 0.0, w_)

    # Degenerate guards (`geo.rs:73-88`): per-triangle, highest priority.
    eq_ab = (abx == 0.0) & (aby == 0.0) & (abz == 0.0)  # b == a
    eq_ac = (acx == 0.0) & (acy == 0.0) & (acz == 0.0)  # c == a
    eq_bc = (abx == acx) & (aby == acy) & (abz == acz)  # b == c
    s_ab = torch.clamp(t_ab, 0.0, 1.0)
    s_ac = torch.clamp(t_ac, 0.0, 1.0)
    seg_ab = eq_bc | eq_ac  # → segment [a, b]
    v_ = w(seg_ab, s_ab, v_)
    w_ = w(seg_ab, 0.0, w_)
    v_ = w(eq_ab, 0.0, v_)  # → segment [a, c]
    w_ = w(eq_ab, s_ac, w_)
    all_eq = eq_ab & eq_bc
    v_ = w(all_eq, 0.0, v_)
    w_ = w(all_eq, 0.0, w_)
    return v_, w_, d1, d2, A, B_, C


def dist2(apx, apy, apz, v, w, d1, d2, A, B_, C):
    """|ap − v·ab − w·ac|², expanded (``pallas_sdf._dist2``), clamped at 0."""
    ap2 = apx * apx + apy * apy + apz * apz
    dd = ap2 + v * (v * A - 2.0 * d1 + 2.0 * w * B_) + w * (w * C - 2.0 * d2)
    return torch.clamp_min(dd, 0.0)


def _axis_crossings(axis, ap, ab, ac):
    """Strict +axis crossing test (``pallas_sdf._axis_crossings``,
    `geo.rs:165-216`): bool per pair, t > 0 as ``num·den < 0``."""
    ix, iy, iz = axis, (axis + 1) % 3, (axis + 2) % 3
    apx, apy, apz = ap[ix], ap[iy], ap[iz]
    aby, abz = ab[iy], ab[iz]
    acy, acz = ac[iy], ac[iz]
    p1y = apy - aby
    p1z = apz - abz
    p2y = apy - acy
    p2z = apz - acz
    e12y = acy - aby
    e12z = acz - abz
    w0 = p1z * e12y - p1y * e12z
    w1 = p2z * (-acy) - p2y * (-acz)
    w2 = apz * aby - apy * abz
    inside = ((w0 < 0.0) & (w1 < 0.0) & (w2 < 0.0)) | (
        (w0 > 0.0) & (w1 > 0.0) & (w2 > 0.0)
    )
    p1x = apx - ab[ix]
    p2x = apx - ac[ix]
    num = w0 * apx + w1 * p1x + w2 * p2x
    den = w0 + w1 + w2
    return inside & (num * den < 0.0)


def _pair_blocks(queries, ta, tb, tc):
    """(query slice, ap, ab, ac) per (chunk, triangle block): ap planes
    (C, B), ab/ac planes (1, B), as ``pallas_sdf._load_sub`` gives them."""
    ab = tb - ta
    ac = tc - ta
    Q, T = queries.shape[0], ta.shape[0]
    for qs in range(0, Q, PLAIN_QUERY_CHUNK):
        q = queries[qs:qs + PLAIN_QUERY_CHUNK]
        for ts in range(0, T, PLAIN_TRI_BLOCK):
            sl = slice(ts, ts + PLAIN_TRI_BLOCK)
            ap = tuple(q[:, k:k + 1] - ta[None, sl, k] for k in range(3))
            yield (slice(qs, qs + q.shape[0]), ap,
                   tuple(ab[None, sl, k] for k in range(3)),
                   tuple(ac[None, sl, k] for k in range(3)))


def raycast_raw_plain(queries, ta, tb, tc, *, raycast_axes: int):
    """Plain PyTorch version of :func:`raycast_raw` (any device)."""
    RAYCAST_COUNT.plain += 1
    Q, dev = queries.shape[0], queries.device
    d2min = torch.full((Q,), F32_MAX, dtype=torch.float32, device=dev)
    counts = torch.zeros((raycast_axes, Q), dtype=torch.int32, device=dev)
    for rows, ap, ab, ac in _pair_blocks(queries, ta, tb, tc):
        d2 = dist2(*ap, *closest_point_vw(*ap, *ab, *ac))
        d2min[rows] = torch.minimum(d2min[rows], torch.amin(d2, dim=1))
        for k in range(raycast_axes):
            counts[k, rows] += torch.sum(_axis_crossings(k, ap, ab, ac),
                                         dim=1, dtype=torch.int32)
    return d2min, counts


def normal_raw_plain(queries, ta, tb, tc):
    """Plain PyTorch version of :func:`normal_raw` (any device)."""
    NORMAL_COUNT.plain += 1
    Q, dev = queries.shape[0], queries.device
    pos2 = torch.full((Q,), F32_MAX, dtype=torch.float32, device=dev)
    neg2 = torch.full((Q,), F32_MAX, dtype=torch.float32, device=dev)
    for rows, ap, ab, ac in _pair_blocks(queries, ta, tb, tc):
        d2 = dist2(*ap, *closest_point_vw(*ap, *ab, *ac))
        # Normal side (`geo.rs:51-55`): ap·(ab×ac) > 0 ⇒ positive.
        nx = ab[1] * ac[2] - ab[2] * ac[1]
        ny = ab[2] * ac[0] - ab[0] * ac[2]
        nz = ab[0] * ac[1] - ab[1] * ac[0]
        posmask = ap[0] * nx + ap[1] * ny + ap[2] * nz > 0.0
        pos2[rows] = torch.minimum(
            pos2[rows], torch.amin(torch.where(posmask, d2, F32_MAX), dim=1))
        neg2[rows] = torch.minimum(
            neg2[rows], torch.amin(torch.where(posmask, F32_MAX, d2), dim=1))
    return pos2, neg2


def tri_records_plain(a, b, c, *, edges: bool = False, normal: bool = False):
    """Plain PyTorch version of :func:`tri_records` (any device): the
    arithmetic of :func:`closest_point_vw`'s per-triangle terms (and of
    :func:`normal_raw_plain`'s normal)."""
    RECORDS_COUNT.plain += 1
    ab = b if edges else b - a
    ac = c if edges else c - a
    abx, aby, abz = ab.unbind(1)
    acx, acy, acz = ac.unbind(1)
    A = abx * abx + aby * aby + abz * abz
    B_ = abx * acx + aby * acy + abz * acz
    C = acx * acx + acy * acy + acz * acz
    eq_ab = (abx == 0.0) & (aby == 0.0) & (abz == 0.0)
    eq_ac = (acx == 0.0) & (acy == 0.0) & (acz == 0.0)
    eq_bc = (abx == acx) & (aby == acy) & (abz == acz)
    flags = ((eq_bc | eq_ac).to(torch.int32) + 2 * eq_ab.to(torch.int32)
             + 4 * (eq_ab & eq_bc).to(torch.int32))
    if normal:
        r4 = (aby * acz - abz * acy, abz * acx - abx * acz,
              abx * acy - aby * acx)
    else:
        r4 = (ac - ab).unbind(1)
    return torch.stack([
        *a.unbind(1), A, abx, aby, abz, B_, acx, acy, acz, C,
        _rcp(A), _rcp(C), _rcp(A - 2.0 * B_ + C), _rcp(A * C - B_ * B_),
        *r4, flags.view(torch.float32),
    ], dim=1)


def tri_records(a, b, c, *, edges: bool = False, normal: bool = False):
    """Packed records (T, 20) f32 of T triangles (:data:`RECORD_FIELDS`, or
    :data:`NORMAL_RECORD_FIELDS` with ``normal``). a, b, c: (T, 3) f32 on
    one device with the same strides (views of planes are fine); with
    ``edges`` b and c hold the edges ab and ac, else the vertices. CUDA
    tensors launch ``csrc/sdf.cu``'s m2s_tri_records; CPU tensors run
    :func:`tri_records_plain`."""
    T = a.shape[0] if a.dim() == 2 else -1
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.dtype != torch.float32 or tuple(t.shape) != (T, 3):
            raise ValueError(f"{name}: want float32 (T, 3) like a, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != a.device or t.stride() != a.stride():
            raise ValueError(f"{name}: want a's device and strides")
    if _device_of(a, "tri_records") == "cpu":
        return tri_records_plain(a, b, c, edges=edges, normal=normal)
    out = torch.empty((T, len(RECORD_FIELDS)), dtype=torch.float32,
                      device=a.device)
    if T == 0:
        return out
    fn = _build.entry("m2s_tri_records", _RECORDS_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        RECORDS_COUNT.kernel += 1
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), T, a.stride(0),
                a.stride(1), int(edges), int(normal), out.data_ptr(),
                stream)
    _build.check(rc, "m2s_tri_records")
    return out


def raycast_chunks(n_queries: int, n_tris: int, n_sms: int,
                   cta_queries: int = RAYCAST_CTA_QUERIES) -> int:
    """Triangle chunks per query tile for the raycast kernel (the normal
    kernel with ``cta_queries=NORMAL_CTA_QUERIES``): 1 when the query tiles
    fill RAYCAST_WAVES waves of ``n_sms`` SMs, else enough chunks to fill
    them, each of at least RAYCAST_MIN_CHUNK triangles."""
    ctas = -(-max(n_queries, 1) // cta_queries)
    want = RAYCAST_WAVES * n_sms * RAYCAST_CTAS_PER_SM
    if ctas >= want:
        return 1
    most = max(1, -(-n_tris // RAYCAST_MIN_CHUNK))
    return max(1, min(-(-want // ctas), most, RAYCAST_MAX_CHUNKS))


@functools.cache
def _check_raycast_shape() -> None:
    """Raise unless the built kernel has the shape :func:`raycast_chunks`
    and :func:`_chunk_len` assume."""
    out = (ctypes.c_int * 4)()
    fn = _build.entry("m2s_sdf_raycast_shape", _SHAPE_ARGTYPES)
    _build.check(fn(ctypes.addressof(out)), "m2s_sdf_raycast_shape")
    want = (RAYCAST_CTA_QUERIES, RAYCAST_TILE, RAYCAST_CTAS_PER_SM,
            NORMAL_CTA_QUERIES)
    if tuple(out) != want:
        raise RuntimeError(f"csrc/sdf.cu's raycast shape {tuple(out)} is not "
                           f"sdf.py's {want}")


def _chunk_len(n_tris: int, chunks: int) -> int:
    """Triangles per chunk: ⌈T / chunks⌉ rounded up to a whole tile."""
    per = -(-max(n_tris, 1) // chunks)
    return -(-per // RAYCAST_TILE) * RAYCAST_TILE


def _check(queries, ta, tb, tc):
    if queries.dtype != torch.float32 or queries.dim() != 2 or (
            queries.shape[1] != 3):
        raise ValueError(f"queries: want float32 (Q, 3), got {queries.dtype} "
                         f"{tuple(queries.shape)}")
    T = ta.shape[0] if ta.dim() == 2 else -1
    for name, t in (("ta", ta), ("tb", tb), ("tc", tc)):
        if t.dtype != torch.float32 or tuple(t.shape) != (T, 3):
            raise ValueError(f"{name}: want float32 (T, 3) like ta, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{queries.device}")
    for name, t in (("queries", queries), ("ta", ta), ("tb", tb),
                    ("tc", tc)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(queries.shape[0], T) > MAX_ROWS:
        raise ValueError(f"more than {MAX_ROWS} queries or triangles")


def _device_of(queries, name):
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {queries.device}")
    return queries.device.type


def raycast_raw(queries, ta, tb, tc, *, raycast_axes: int):
    """(min squared distance (Q,) f32, crossing counts (axes, Q) int32) of
    every query over all triangles; ``raycast_axes`` in 0..3 counts +X, +Y,
    +Z rays in that order. queries (Q, 3), ta/tb/tc (T, 3): float32,
    contiguous, one device. CUDA tensors pack the triangles'
    :func:`tri_records` and launch ``csrc/sdf.cu`` over them, with the
    triangles split into :func:`raycast_chunks` chunks for this card (every
    count gives the same bits); CPU tensors run :func:`raycast_raw_plain`."""
    _check(queries, ta, tb, tc)
    if raycast_axes not in (0, 1, 2, 3):
        raise ValueError(f"raycast_axes must be 0..3, got {raycast_axes}")
    if _device_of(queries, "raycast_raw") == "cpu":
        return raycast_raw_plain(queries, ta, tb, tc,
                                 raycast_axes=raycast_axes)
    Q, T = queries.shape[0], ta.shape[0]
    dev = queries.device
    if Q == 0:
        return (torch.empty((0,), dtype=torch.float32, device=dev),
                torch.empty((raycast_axes, 0), dtype=torch.int32, device=dev))
    _check_raycast_shape()
    chunks = raycast_chunks(
        Q, T, torch.cuda.get_device_properties(dev).multi_processor_count)
    rec = tri_records(ta, tb, tc)
    chunk = _chunk_len(T, chunks)
    if -(-T // chunk) > 1:
        d2min = torch.full((Q,), F32_MAX, dtype=torch.float32, device=dev)
        counts = torch.zeros((raycast_axes, Q), dtype=torch.int32,
                             device=dev)
    else:
        d2min = torch.empty((Q,), dtype=torch.float32, device=dev)
        counts = torch.empty((raycast_axes, Q), dtype=torch.int32,
                             device=dev)
    fn = _build.entry("m2s_sdf_raycast", _RAYCAST_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        RAYCAST_COUNT.kernel += 1
        rc = fn(queries.data_ptr(), Q, rec.data_ptr(), T, chunk,
                raycast_axes, d2min.data_ptr(), counts.data_ptr(), stream)
    _build.check(rc, "m2s_sdf_raycast")
    return d2min, counts


def normal_raw(queries, ta, tb, tc):
    """(min squared distance on the positive normal side (Q,), on the
    negative side (Q,)), float32, ``F32_MAX`` where a side has no triangle.
    Same inputs as :func:`raycast_raw`. CUDA tensors pack normal records
    and launch ``csrc/sdf.cu`` over them, split as :func:`raycast_raw` is
    (:func:`raycast_chunks` at NORMAL_CTA_QUERIES); CPU tensors run
    :func:`normal_raw_plain`."""
    _check(queries, ta, tb, tc)
    if _device_of(queries, "normal_raw") == "cpu":
        return normal_raw_plain(queries, ta, tb, tc)
    Q, T = queries.shape[0], ta.shape[0]
    dev = queries.device
    if Q == 0:
        empty = torch.empty((0,), dtype=torch.float32, device=dev)
        return empty, empty.clone()
    _check_raycast_shape()
    chunks = raycast_chunks(
        Q, T, torch.cuda.get_device_properties(dev).multi_processor_count,
        NORMAL_CTA_QUERIES)
    rec = tri_records(ta, tb, tc, normal=True)
    chunk = _chunk_len(T, chunks)
    if -(-T // chunk) > 1:
        pos2 = torch.full((Q,), F32_MAX, dtype=torch.float32, device=dev)
    else:
        pos2 = torch.empty((Q,), dtype=torch.float32, device=dev)
    neg2 = pos2.clone()
    fn = _build.entry("m2s_sdf_normal", _NORMAL_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        NORMAL_COUNT.kernel += 1
        rc = fn(queries.data_ptr(), Q, rec.data_ptr(), T, chunk,
                pos2.data_ptr(), neg2.data_ptr(), stream)
    _build.check(rc, "m2s_sdf_normal")
    return pos2, neg2


def sdf_raycast(queries, ta, tb, tc, *, raycast_axes: int = 3):
    """Signed distances with the raycast sign, (Q,) f32
    (``sdf_raycast_pallas``). ``raycast_axes=0``: unsigned distance only
    (grid mode, the sign comes from line parity); 1: +X parity
    (`default.rs:36`); 3: best-of-3 voting (`bvh.rs:133-139`)."""
    d2min, counts = raycast_raw(queries, ta, tb, tc,
                                raycast_axes=raycast_axes)
    dist = sqrt_f32(d2min)
    if raycast_axes == 0:
        return dist
    odd = counts % 2 == 1
    if raycast_axes == 1:
        inside = odd[0]
    else:
        inside = torch.sum(odd, dim=0, dtype=torch.int32) >= 2
    return torch.where(inside, -dist, dist)


def sdf_raycast_parts(queries, ta, tb, tc, *, raycast_axes: int = 3):
    """Pre-vote outputs (``sdf_raycast_parts_pallas``): (unsigned distance
    (Q,), crossing counts (Q, max(axes, 1)) int32), for reductions that sum
    counts over triangle shards before the vote."""
    d2min, counts = raycast_raw(queries, ta, tb, tc,
                                raycast_axes=max(raycast_axes, 1))
    return sqrt_f32(d2min), counts.t().contiguous()


def sdf_normal_champions(queries, ta, tb, tc):
    """Pre-combination champions (``sdf_normal_champions_pallas``): (min
    positive distance, min negative magnitude), each (Q,) f32."""
    pos2, neg2 = normal_raw(queries, ta, tb, tc)
    return (sqrt_f32(torch.clamp_max(pos2, F32_MAX)),
            sqrt_f32(torch.clamp_max(neg2, F32_MAX)))


def sdf_normal(queries, ta, tb, tc):
    """Signed distances with the normal sign, (Q,) f32
    (``sdf_normal_pallas``): the champions combined by the fuzzy
    prefer-positive ``compare_distances`` rule (`lib.rs:242-259`)."""
    return combine_champions(*sdf_normal_champions(queries, ta, tb, tc))
