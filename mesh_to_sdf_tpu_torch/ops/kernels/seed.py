"""CPT seed: every cell's best and runner-up distinct triangles from the
host-built seed bins (``ops.cpt.SeedBins``).

PyTorch counterpart of the JAX package's ``ops/cpt.seed_from_bins``, which
is XLA glue on the TPU. :func:`seed_from_bins` on CUDA tensors makes one
launch of the hand-written kernel ``csrc/seed.cu``, which reads each
candidate triangle as its packed record (``sweep.sweep_tris``) by id and
writes the four flat outputs once; on CPU tensors it runs
:func:`seed_from_bins_plain`, the eager computation that the tests hold
against the JAX package. Any other device raises.
"""
from __future__ import annotations

import ctypes

import torch

from ...types import F32_MAX
from . import _build
from .sdf import RECORD_FIELDS
from .sweep import PAD_COORD, SweepTris, _pt_dist, sweep_tris

#: Kernel launches and plain-version calls of :func:`seed_from_bins`.
COUNT = _build.LaunchCount()

#: Deepest merge tree the kernel takes (``csrc/seed.cu`` kMaxRounds): up to
#: 2^30 rows per cell.
MAX_SHIFT_ROUNDS = 30

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: m2s_seed_from_bins: entry rows_cell cell_row records, T K R, nx ny nz,
#: n_rounds, first_cell and cell_size (x, y, z), d1 i1 d2 i2, stream.
_ARGTYPES = ((_P,) * 4 + (_I, _I, _L) + (_I,) * 4 + (_F,) * 6 + (_P,) * 5)


def _combine_top2(d1a, i1a, d2a, i2a, d1b, i1b, d2b, i2b):
    """Merge two (best, runner-up-distinct) candidate pairs, branchless."""
    a_first = d1a <= d1b
    n_d1 = torch.where(a_first, d1a, d1b)
    n_i1 = torch.where(a_first, i1a, i1b)
    # Runner-up: best among {loser's d1, both d2} with a distinct id.
    cand_d = torch.stack([torch.where(a_first, d1b, d1a), d2a, d2b])
    cand_i = torch.stack([torch.where(a_first, i1b, i1a), i2a, i2b])
    cand_d = torch.where(cand_i == n_i1[None], F32_MAX, cand_d)
    b = torch.argmin(cand_d, dim=0, keepdim=True)
    n_d2 = torch.take_along_dim(cand_d, b, dim=0)[0]
    n_i2 = torch.take_along_dim(cand_i, b, dim=0)[0]
    return n_d1, n_i1, n_d2, n_i2


def seed_from_bins_plain(grid, ta, tb, tc, bins):
    """Plain PyTorch version of :func:`seed_from_bins` (any device): one
    dense (K, R) distance evaluation + log2(D) shifted merges + one row
    gather through the inverse map."""
    COUNT.plain += 1
    nx, ny, nz = grid.cell_count
    N = nx * ny * nz
    T = ta.shape[0]
    dev = ta.device
    entry = torch.as_tensor(bins.entry_tri, device=dev)  # (K, R)
    rows_cell = torch.as_tensor(bins.rows_cell, device=dev)  # (R,)

    tv = torch.cat([ta, tb, tc], dim=-1)  # (T, 9)
    tv = torch.cat([tv, torch.full((1, 9), PAD_COORD, dtype=torch.float32,
                                   device=dev)])
    v = tv[entry.long()].permute(2, 0, 1)  # (9, K, R)

    safe_cell = torch.clamp_max(rows_cell, N - 1)
    czi = safe_cell % nz
    cyi = torch.div(safe_cell, nz, rounding_mode="floor") % ny
    cxi = torch.div(safe_cell, ny * nz, rounding_mode="floor")
    fc = grid.first_cell.to(dev)
    cs = grid.cell_size.to(dev)
    cx = fc[0] + cxi.to(torch.float32) * cs[0]  # (R,) coordinate planes
    cy = fc[1] + cyi.to(torch.float32) * cs[1]
    cz = fc[2] + czi.to(torch.float32) * cs[2]

    d = _pt_dist(cx[None, :], cy[None, :], cz[None, :], v)  # (K, R)
    d = torch.where(entry == T, F32_MAX, d)

    # Per-row top-2 distinct (reduce over the K axis 0).
    b1 = torch.argmin(d, dim=0, keepdim=True)
    d1 = torch.take_along_dim(d, b1, dim=0)[0]
    i1 = torch.take_along_dim(entry, b1, dim=0)[0]
    masked = torch.where(entry == i1[None, :], F32_MAX, d)
    b2 = torch.argmin(masked, dim=0, keepdim=True)
    d2 = torch.take_along_dim(masked, b2, dim=0)[0]
    i2 = torch.take_along_dim(entry, b2, dim=0)[0]

    # Combine consecutive rows of the same cell (≤ 2^n_rounds rows/cell).
    for s_exp in range(bins.n_shift_rounds):
        s = 1 << s_exp
        same = torch.cat([rows_cell[s:] == rows_cell[:-s],
                          torch.zeros((s,), dtype=torch.bool, device=dev)])

        def sh(a, fill):
            return torch.cat([a[s:], torch.full((s,), fill, dtype=a.dtype,
                                                device=dev)])

        m_d1, m_i1, m_d2, m_i2 = _combine_top2(
            d1, i1, d2, i2, sh(d1, F32_MAX), sh(i1, T), sh(d2, F32_MAX),
            sh(i2, T),
        )
        d1 = torch.where(same, m_d1, d1)
        i1 = torch.where(same, m_i1, i1)
        d2 = torch.where(same, m_d2, d2)
        i2 = torch.where(same, m_i2, i2)

    # Empty slots: force the sentinel whenever the distance says "none".
    i1 = torch.where((i1 >= T) | (d1 >= F32_MAX), -1, i1)
    i2 = torch.where((i2 >= T) | (d2 >= F32_MAX), -1, i2)

    # Spread rows → cells as ONE row gather through the host-built inverse
    # map (each cell's first, fully combined, row). Ints ride along
    # bitcast to f32.
    cell_row = torch.as_tensor(bins.cell_row, device=dev)  # (N,)
    packed = torch.stack(
        [d1, i1.view(torch.float32), d2, i2.view(torch.float32)], dim=-1
    )  # (R, 4)
    hit = cell_row >= 0
    rows = packed[torch.clamp_min(cell_row, 0).long()]  # (N, 4)
    out_d1 = torch.where(hit, rows[:, 0], F32_MAX)
    out_i1 = torch.where(hit, rows[:, 1].contiguous().view(torch.int32), -1)
    out_d2 = torch.where(hit, rows[:, 2], F32_MAX)
    out_i2 = torch.where(hit, rows[:, 3].contiguous().view(torch.int32), -1)
    return out_d1, out_i1, out_d2, out_i2


def _check(grid, ta, tb, tc, entry, rows_cell, cell_row, n_rounds, tris):
    dev = ta.device
    T = ta.shape[0] if ta.dim() == 2 else -1
    for name, t in (("ta", ta), ("tb", tb), ("tc", tc)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (T, 3)
                or t.device != dev):
            raise ValueError(f"{name}: want float32 (T, 3) on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    N = 1
    for n in grid.cell_count:
        N *= int(n)
    if N >= 2**31 - 1:
        raise ValueError(f"seed_from_bins: {N} cells, more than int32 "
                         "cell indices hold")
    K, R = tuple(entry.shape) if entry.dim() == 2 else (0, 0)
    for name, t, shape in (("entry_tri", entry, (K, R)),
                           ("rows_cell", rows_cell, (R,)),
                           ("cell_row", cell_row, (N,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or min(K, R) < 1 or t.device != dev):
            raise ValueError(f"bins.{name}: want int32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 0 <= int(n_rounds) <= MAX_SHIFT_ROUNDS:
        raise ValueError(f"bins.n_shift_rounds must lie in [0, "
                         f"{MAX_SHIFT_ROUNDS}], got {n_rounds}")
    if tris is not None:
        rec = tris.rec
        if (rec.dtype != torch.float32
                or tuple(rec.shape) != (T + 1, len(RECORD_FIELDS))
                or rec.device != dev or not rec.is_contiguous()):
            raise ValueError(f"tris.rec: want contiguous float32 (T + 1, "
                             f"{len(RECORD_FIELDS)}) on {dev}, got "
                             f"{rec.dtype} {tuple(rec.shape)} on "
                             f"{rec.device}")


def seed_from_bins(grid, ta, tb, tc, bins, tris: SweepTris | None = None):
    """Exact per-cell seeds of ``grid`` from host-precomputed gather lists.

    ta/tb/tc: (T, 3) f32 triangle vertices on the working device; the bins'
    arrays may be numpy or tensors (int32). ``tris``: the triangles'
    :func:`sweep.sweep_tris` on that device, packed here when not given.
    ``grid.first_cell`` / ``cell_size`` are read on the host, as the sweep
    reads them. Returns flat (N,) (d1, i1, d2, i2): distances f32, triangle
    ids int32 (-1 = none). CUDA tensors make one launch of ``csrc/seed.cu``;
    CPU tensors run :func:`seed_from_bins_plain`.
    """
    dev = ta.device
    entry, rows_cell, cell_row = (torch.as_tensor(a, device=dev)
                                  for a in bins[:3])
    _check(grid, ta, tb, tc, entry, rows_cell, cell_row,
           bins.n_shift_rounds, tris)
    if dev.type == "cpu":
        return seed_from_bins_plain(grid, ta, tb, tc, bins)
    if dev.type != "cuda":
        raise ValueError(f"seed_from_bins: no kernel for {dev}")
    for name, t in (("entry_tri", entry), ("rows_cell", rows_cell),
                    ("cell_row", cell_row)):
        if not t.is_contiguous():
            raise ValueError(f"bins.{name} must be contiguous")
    if tris is None:
        tris = sweep_tris(ta, tb, tc)
    fc = [float(x) for x in torch.as_tensor(grid.first_cell).tolist()]
    cs = [float(x) for x in torch.as_tensor(grid.cell_size).tolist()]
    nx, ny, nz = (int(n) for n in grid.cell_count)
    N = nx * ny * nz
    out = (torch.empty((N,), dtype=torch.float32, device=dev),
           torch.empty((N,), dtype=torch.int32, device=dev),
           torch.empty((N,), dtype=torch.float32, device=dev),
           torch.empty((N,), dtype=torch.int32, device=dev))
    fn = _build.entry("m2s_seed_from_bins", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        COUNT.kernel += 1
        rc = fn(entry.data_ptr(), rows_cell.data_ptr(), cell_row.data_ptr(),
                tris.rec.data_ptr(), ta.shape[0], entry.shape[0],
                entry.shape[1], nx, ny, nz, int(bins.n_shift_rounds), *fc,
                *cs, *(t.data_ptr() for t in out), stream)
    _build.check(rc, "m2s_seed_from_bins")
    return out
