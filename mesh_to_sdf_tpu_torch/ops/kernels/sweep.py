"""CPT sweep: one directional closest-point propagation pass.

PyTorch counterpart of ``ops/kernels/pallas_sweep.py``. :func:`sweep_oriented`
takes the TPU function's arguments and layout. On a CUDA tensor it launches
the hand-written kernel ``csrc/sweep.cu`` (one launch per slice, volumes
updated in place); on a CPU tensor it runs :func:`sweep_oriented_plain`, the
same computation in plain PyTorch. Any other device raises.

The closest-point ladder :func:`_pt_dist2` / :func:`_pt_dist` (the fused
distance kernel's, ``sdf.closest_point_vw``) is shared with
``ops.cpt.seed_from_bins``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..geometry import sqrt_f32
from . import _build
from .sdf import closest_point_vw, dist2

PAD_COORD = 1.0e18

#: Kernel launches and plain-version calls of :func:`sweep_oriented`.
COUNT = _build.LaunchCount()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: m2s_sweep_oriented: 6 volumes, n0 n1 n2 reverse, first_cell and
#: cell_size (x, y, z), comp0 comp1 comp2, stream.
_ARGTYPES = (_P,) * 6 + (_I,) * 4 + (_F,) * 6 + (_I,) * 3 + (_P,)


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


def _check(d1, v1, i1, d2, v2, i2, comps):
    if d1.dim() != 3:
        raise ValueError(f"d1 must be (n0, n1, n2), got {tuple(d1.shape)}")
    n0, n1, n2 = d1.shape
    for name, t, dtype, shape in (
        ("d1", d1, torch.float32, (n0, n1, n2)),
        ("v1", v1, torch.float32, (n0, 9, n1, n2)),
        ("i1", i1, torch.int32, (n0, n1, n2)),
        ("d2", d2, torch.float32, (n0, n1, n2)),
        ("v2", v2, torch.float32, (n0, 9, n1, n2)),
        ("i2", i2, torch.int32, (n0, n1, n2)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != d1.device:
            raise ValueError(f"{name} is on {t.device}, d1 on {d1.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sorted(comps) != [0, 1, 2]:
        raise ValueError(f"comp0/comp1/comp2 must permute (0, 1, 2): {comps}")


def sweep_oriented_plain(d1, v1, i1, d2, v2, i2, reverse: bool, first_cell,
                         cell_size, *, comp0: int, comp1: int, comp2: int):
    """Plain PyTorch version of :func:`sweep_oriented` (any device).

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


def sweep_oriented(d1, v1, i1, d2, v2, i2, reverse: bool, first_cell,
                   cell_size, *, comp0: int, comp1: int, comp2: int):
    """One directional sweep over volumes laid out sweep-axis first.

    d1/d2 (n0, n1, n2) f32, v1/v2 (n0, 9, n1, n2) f32, i1/i2 (n0, n1, n2)
    int32, all contiguous on one device. ``first_cell``/``cell_size``: the
    world (x, y, z) grid parameters, (3,) float32 (kept on the host, where
    reading them costs no device sync). ``comp0/1/2``: which world
    coordinate varies along the sweep axis / plane rows / plane columns.
    ``reverse`` sweeps from the last slice to the first.

    Updates the volumes in place and returns them. CUDA tensors launch
    ``csrc/sweep.cu``; CPU tensors run :func:`sweep_oriented_plain`.
    """
    _check(d1, v1, i1, d2, v2, i2, (comp0, comp1, comp2))
    if d1.device.type == "cpu":
        return sweep_oriented_plain(
            d1, v1, i1, d2, v2, i2, reverse, first_cell, cell_size,
            comp0=comp0, comp1=comp1, comp2=comp2,
        )
    if d1.device.type != "cuda":
        raise ValueError(f"sweep_oriented: no kernel for {d1.device}")
    fc = [float(x) for x in torch.as_tensor(first_cell).tolist()]
    cs = [float(x) for x in torch.as_tensor(cell_size).tolist()]
    n0, n1, n2 = d1.shape
    fn = _build.entry("m2s_sweep_oriented", _ARGTYPES)
    with torch.cuda.device(d1.device):
        stream = torch.cuda.current_stream(d1.device).cuda_stream
        COUNT.kernel += 1
        rc = fn(
            d1.data_ptr(), v1.data_ptr(), i1.data_ptr(), d2.data_ptr(),
            v2.data_ptr(), i2.data_ptr(), n0, n1, n2, int(bool(reverse)),
            *fc, *cs, comp0, comp1, comp2, stream,
        )
    _build.check(rc, "m2s_sweep_oriented")
    return d1, v1, i1, d2, v2, i2
