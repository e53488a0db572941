"""CPT sweep: one directional closest-point propagation pass.

PyTorch counterpart of ``ops/kernels/pallas_sweep.py``. The state is four
x-first (nx, ny, nz) volumes: each cell's best and runner-up distinct
triangles as (distance, id) pairs, id -1 for none. :func:`sweep_axis` runs
one directional sweep along any axis in place. On a CUDA tensor it makes one
cooperative launch of the hand-written kernel ``csrc/sweep.cu``, which reads
each candidate triangle as its packed record (``sdf.tri_records``) by id; on
a CPU tensor it runs :func:`sweep_axis_plain`. Any other device raises.

:func:`sweep_oriented_plain` is the TPU function's computation in its own
layout (sweep axis first, each slot's triangle vertices carried beside its
id), held against the JAX package; :func:`sweep_axis_plain` is built from
it. The closest-point ladder :func:`_pt_dist2` / :func:`_pt_dist` (the
fused distance kernel's, ``sdf.closest_point_vw``) is shared with
``ops.cpt.seed_from_bins``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..geometry import sqrt_f32
from . import _build
from .sdf import RECORD_FIELDS, closest_point_vw, dist2, tri_records

PAD_COORD = 1.0e18

#: Kernel launches and plain-version calls of :func:`sweep_axis` (the
#: plain count includes direct calls of :func:`sweep_oriented_plain`).
COUNT = _build.LaunchCount()

#: Plane cells per tile side (``csrc/sweep.cu`` kTileR, kTileC): one
#: progress counter per tile.
SWEEP_TILE = 16

#: Axis-first orientation of the x-first volumes for a sweep along each
#: axis: the sweep axis, then the plane's rows and columns (its lower and
#: higher other axis). It is also the world component of each (``comp0``,
#: ``comp1``, ``comp2`` of :func:`sweep_oriented_plain`).
ORIENT = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: m2s_sweep_axis: d1 i1 d2 i2, records T, nx ny nz, axis reverse,
#: first_cell and cell_size (x, y, z), progress n_progress, stream.
_ARGTYPES = (_P,) * 5 + (_I,) * 6 + (_F,) * 6 + (_P, _I, _P)


class SweepTris(NamedTuple):
    """The triangles a sweep reads by id, with a PAD triangle (vertices at
    ``PAD_COORD``) at index T for id -1 (see :func:`sweep_tris`).

    tv: (T + 1, 9) float32 vertices [a | b | c], the plain version's;
    rec: (T + 1, 20) packed records of the same triangles, the kernel's.
    """

    tv: torch.Tensor
    rec: torch.Tensor


def sweep_tris(ta, tb, tc) -> SweepTris:
    """:class:`SweepTris` of the (T, 3) float32 soup ta/tb/tc, its records
    packed once here (``sdf.tri_records``). The PAD record's edges are 0,
    so its flags mark a vertex, as the ladder treats the PAD vertices."""
    pad = torch.full((1, 3), PAD_COORD, dtype=torch.float32, device=ta.device)
    a, b, c = (torch.cat([t, pad]) for t in (ta, tb, tc))
    return SweepTris(torch.cat([a, b, c], dim=1), tri_records(a, b, c))


def _pt_dist(cx, cy, cz, v):
    """Exact point-triangle distance; ``v[0..8]`` are the vertex planes.
    The root is the correctly rounded float32 one (taken in float64), as
    the kernel's ``sqrtf`` and XLA give."""
    return sqrt_f32(_pt_dist2(cx, cy, cz, v))


def _pt_dist2(cx, cy, cz, v):
    """Exact SQUARED point-triangle distance, operation for operation the
    JAX package's ``pallas_sweep._pt_dist2``: the division-free ladder with
    per-triangle reciprocals that the fused distance kernel also runs
    (``sdf.closest_point_vw``, ``sdf.dist2``)."""
    ax, ay, az = v[0], v[1], v[2]
    ab = (v[3] - ax, v[4] - ay, v[5] - az)
    ac = (v[6] - ax, v[7] - ay, v[8] - az)
    ap = (cx - ax, cy - ay, cz - az)
    return dist2(*ap, *closest_point_vw(*ap, *ab, *ac))


def _merge2(d1, v1, i1, d2, v2, i2, dc, vc, ic):
    """Two-slot distinct-triangle merge of one candidate set
    (``pallas_sweep._merge2``)."""
    same1 = ic == i1
    b1 = dc < d1
    nd1 = torch.where(b1, dc, d1)
    nv1 = torch.where(b1[None], vc, v1)
    ni1 = torch.where(b1, ic, i1)
    promote = b1 & ~same1
    cand2 = ~b1 & ~same1 & (dc < d2)
    nd2 = torch.where(promote, d1, torch.where(cand2, dc, d2))
    nv2 = torch.where(promote[None], v1, torch.where(cand2[None], vc, v2))
    ni2 = torch.where(promote, i1, torch.where(cand2, ic, i2))
    return nd1, nv1, ni1, nd2, nv2, ni2


def sweep_oriented_plain(d1, v1, i1, d2, v2, i2, reverse: bool, first_cell,
                         cell_size, *, comp0: int, comp1: int, comp2: int):
    """The TPU function ``pallas_sweep.sweep_oriented`` in plain PyTorch
    (any device), in its layout: d1/d2 (n0, n1, n2) f32, v1/v2 (n0, 9, n1,
    n2) f32 vertices of each slot's triangle, i1/i2 (n0, n1, n2) int32,
    sweep axis first; ``comp0/1/2`` the world coordinate along the sweep
    axis, plane rows and columns.

    Slices are visited in sweep order; each merges the 18 candidates of the
    previous (already updated) slice in the kernel's order. Updates the
    volumes in place and returns them.
    """
    COUNT.plain += 1
    n0, n1, n2 = d1.shape
    dev = d1.device
    fc = torch.as_tensor(first_cell, dtype=torch.float32).to(dev)
    cs = torch.as_tensor(cell_size, dtype=torch.float32).to(dev)

    def axis_coords(comp, n):
        return fc[comp] + torch.arange(n, dtype=torch.float32,
                                       device=dev) * cs[comp]

    coord_a = axis_coords(comp0, n0)
    coords = [None, None, None]
    coords[comp1] = axis_coords(comp1, n1)[:, None]
    coords[comp2] = axis_coords(comp2, n2)[None, :]

    pad_v = torch.full((9, n1, n2), PAD_COORD, dtype=torch.float32,
                       device=dev)
    pad_i = torch.full((n1, n2), -1, dtype=torch.int32, device=dev)
    order = range(n0 - 1, -1, -1) if reverse else range(n0)
    prev = None
    for s in order:
        coords[comp0] = coord_a[s]
        if prev is None:
            slots = ((pad_v, pad_i), (pad_v, pad_i))
        else:
            slots = ((v1[prev], i1[prev]), (v2[prev], i2[prev]))
        padded = [
            (F.pad(v, (1, 1, 1, 1), value=PAD_COORD),
             F.pad(i, (1, 1, 1, 1), value=-1))
            for v, i in slots
        ]
        cv, ci = [], []
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                for pv, pi in padded:
                    cv.append(pv[:, dy:dy + n1, dz:dz + n2])
                    ci.append(pi[dy:dy + n1, dz:dz + n2])
        cv = torch.stack(cv)  # (18, 9, n1, n2)
        ci = torch.stack(ci)
        dc = _pt_dist(*coords, cv.transpose(0, 1))  # (18, n1, n2)

        st = (d1[s], v1[s], i1[s], d2[s], v2[s], i2[s])
        for k in range(cv.shape[0]):
            st = _merge2(*st, dc[k], cv[k], ci[k])
        for dst, src in zip((d1, v1, i1, d2, v2, i2), st):
            dst[s].copy_(src)
        prev = s
    return d1, v1, i1, d2, v2, i2


def _check(d1, i1, d2, i2, tris, axis):
    shape = tuple(d1.shape)
    if d1.dim() != 3:
        raise ValueError(f"d1 must be (nx, ny, nz), got {shape}")
    for name, t, dtype in (("d1", d1, torch.float32), ("i1", i1, torch.int32),
                           ("d2", d2, torch.float32), ("i2", i2, torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != d1.device:
            raise ValueError(f"{name} is on {t.device}, d1 on {d1.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = tris.tv.shape[0] if tris.tv.dim() == 2 else 0
    for name, t, width in (("tv", tris.tv, 9),
                           ("rec", tris.rec, len(RECORD_FIELDS))):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n, width)
                or n < 1 or t.device != d1.device or not t.is_contiguous()):
            raise ValueError(f"tris.{name}: want contiguous float32 "
                             f"(T + 1, {width}) on {d1.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if axis not in ORIENT:
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")


def sweep_axis_plain(d1, i1, d2, i2, tris: SweepTris, reverse: bool,
                     first_cell, cell_size, *, axis: int):
    """Plain PyTorch version of :func:`sweep_axis` (any device), built from
    :func:`sweep_oriented_plain`: the volumes turned sweep-axis first, each
    slot's vertices gathered by id (``tris.tv``), one oriented sweep, the
    result copied back. Updates the volumes in place and returns them."""
    orient = ORIENT[axis]
    T = tris.tv.shape[0] - 1
    views = [t.permute(orient) for t in (d1, i1, d2, i2)]
    o_d1, o_i1, o_d2, o_i2 = (v.contiguous() for v in views)
    o_v1, o_v2 = (tris.tv[torch.where(i < 0, T, i).long()]
                  .permute(0, 3, 1, 2).contiguous() for i in (o_i1, o_i2))
    sweep_oriented_plain(o_d1, o_v1, o_i1, o_d2, o_v2, o_i2, reverse,
                         first_cell, cell_size, comp0=orient[0],
                         comp1=orient[1], comp2=orient[2])
    for view, src in zip(views, (o_d1, o_i1, o_d2, o_i2)):
        view.copy_(src)
    return d1, i1, d2, i2


def sweep_axis(d1, i1, d2, i2, tris: SweepTris, reverse: bool, first_cell,
               cell_size, *, axis: int):
    """One directional sweep along ``axis`` (0, 1, 2 = x, y, z) over the
    x-first state, in place.

    d1/d2 (nx, ny, nz) f32, i1/i2 (nx, ny, nz) int32, all contiguous on one
    device; ``tris`` from :func:`sweep_tris` on the same device.
    ``first_cell``/``cell_size``: the world (x, y, z) grid parameters, (3,)
    float32 (kept on the host, where reading them costs no device sync).
    ``reverse`` sweeps from the last slice to the first.

    Returns the volumes. CUDA tensors make one cooperative launch of
    ``csrc/sweep.cu``; CPU tensors run :func:`sweep_axis_plain`.
    """
    _check(d1, i1, d2, i2, tris, axis)
    if d1.device.type == "cpu":
        return sweep_axis_plain(d1, i1, d2, i2, tris, reverse, first_cell,
                                cell_size, axis=axis)
    if d1.device.type != "cuda":
        raise ValueError(f"sweep_axis: no kernel for {d1.device}")
    rec = tris.rec
    fc = [float(x) for x in torch.as_tensor(first_cell).tolist()]
    cs = [float(x) for x in torch.as_tensor(cell_size).tolist()]
    nx, ny, nz = d1.shape
    _, rows, cols = (d1.shape[k] for k in ORIENT[axis])
    n_tiles = -(-rows // SWEEP_TILE) * -(-cols // SWEEP_TILE)
    progress = torch.empty((n_tiles,), dtype=torch.int32, device=d1.device)
    fn = _build.entry("m2s_sweep_axis", _ARGTYPES)
    with torch.cuda.device(d1.device):
        stream = torch.cuda.current_stream(d1.device).cuda_stream
        COUNT.kernel += 1
        rc = fn(d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), i2.data_ptr(),
                rec.data_ptr(), rec.shape[0] - 1, nx, ny, nz, axis,
                int(bool(reverse)), *fc, *cs, progress.data_ptr(),
                progress.numel(), stream)
    _build.check(rc, "m2s_sweep_axis")
    return d1, i1, d2, i2
