"""CPT sweep: one directional closest-point propagation pass.

PyTorch counterpart of ``ops/kernels/pallas_sweep.py``. :func:`sweep_oriented`
takes the TPU function's arguments and layout. On a CUDA tensor it launches
the hand-written kernel ``csrc/sweep.cu`` (one launch per slice, volumes
updated in place); on a CPU tensor it runs :func:`sweep_oriented_plain`, the
same computation in plain PyTorch. Any other device raises.

The closest-point ladder :func:`_pt_dist2` / :func:`_pt_dist` is shared with
``ops.cpt.seed_from_bins``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

PAD_COORD = 1.0e18

#: Kernel launches and plain-version calls of :func:`sweep_oriented`.
COUNT = _build.LaunchCount()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: m2s_sweep_oriented: 6 volumes, n0 n1 n2 reverse, first_cell and
#: cell_size (x, y, z), comp0 comp1 comp2, stream.
_ARGTYPES = (_P,) * 6 + (_I,) * 4 + (_F,) * 6 + (_I,) * 3 + (_P,)


def _pt_dist(cx, cy, cz, v):
    """Exact point-triangle distance; ``v[0..8]`` are the vertex planes.

    The square root is taken in float64 and rounded once to float32: that
    is the correctly rounded float32 root, as the kernel's ``sqrtf`` and
    XLA give, where PyTorch's vectorised float32 root on the CPU is off by
    one ulp in about 13% of cases.
    """
    return torch.sqrt(_pt_dist2(cx, cy, cz, v).double()).to(torch.float32)


def _rcp(x):
    return torch.where(x == 0.0, 0.0, 1.0 / torch.where(x == 0.0, 1.0, x))


def _pt_dist2(cx, cy, cz, v):
    """Exact SQUARED point-triangle distance, operation for operation the
    JAX package's ``pallas_sweep._pt_dist2`` (division-free ladder with
    per-triangle reciprocals; degenerate triangles fall back to segments or
    points)."""
    ax, ay, az = v[0], v[1], v[2]
    bx, by, bz = v[3], v[4], v[5]
    cx2, cy2, cz2 = v[6], v[7], v[8]
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx2 - ax, cy2 - ay, cz2 - az
    apx, apy, apz = cx - ax, cy - ay, cz - az

    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz
    A = abx * abx + aby * aby + abz * abz
    B_ = abx * acx + aby * acy + abz * acz
    C = acx * acx + acy * acy + acz * acz
    d3 = d1 - A
    d4 = d2 - B_
    d5 = d1 - B_
    d6 = d2 - C
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    t_ab = d1 * _rcp(A)
    t_ac = d2 * _rcp(C)
    t_bc = (d4 - d3) * _rcp(A - 2.0 * B_ + C)
    inv_den = _rcp(A * C - B_ * B_)

    w = torch.where
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

    eq_ab = (abx == 0.0) & (aby == 0.0) & (abz == 0.0)
    eq_ac = (acx == 0.0) & (acy == 0.0) & (acz == 0.0)
    eq_bc = (abx == acx) & (aby == acy) & (abz == acz)
    s_ab = torch.clamp(t_ab, 0.0, 1.0)
    s_ac = torch.clamp(t_ac, 0.0, 1.0)
    seg_ab = eq_bc | eq_ac
    v_ = w(seg_ab, s_ab, v_)
    w_ = w(seg_ab, 0.0, w_)
    v_ = w(eq_ab, 0.0, v_)
    w_ = w(eq_ab, s_ac, w_)
    alleq = eq_ab & eq_bc
    v_ = w(alleq, 0.0, v_)
    w_ = w(alleq, 0.0, w_)

    ap2 = apx * apx + apy * apy + apz * apz
    dd = ap2 + v_ * (v_ * A - 2.0 * d1 + 2.0 * w_ * B_) + w_ * (w_ * C - 2.0 * d2)
    return torch.clamp_min(dd, 0.0)


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
