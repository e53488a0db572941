"""Line parity: the raycast sign of a grid.

PyTorch counterpart of ``ops/kernels/pallas_parity.py`` (the reference's
raycast phase, `mesh_to_sdf/src/generate/grid.rs:560-684`): one +axis ray per
boundary cell of each negative grid face; a cell is inside iff at least 2 of
its 3 axis parities are odd (`grid.rs:622-639`).

- :func:`build_line_bins` (host, numpy) routes each 32×32-line tile to the
  Morton-sorted 256-triangle blocks whose transverse AABB overlaps it.
- :func:`line_parity_counts_binned` counts crossings per (line, cell)
  through those bins (the CPT route); :func:`line_parity_counts` counts them
  against every triangle, with no host prep (the XLA and PALLAS grid
  routes). On a CUDA tensor each launches its hand-written kernel in
  ``csrc/parity.cu`` (a hit pass split over :func:`parity_chunks` chunks of
  triangle blocks, then a scan); on a CPU tensor it runs its plain version
  (:func:`line_parity_counts_binned_plain`,
  :func:`line_parity_counts_plain`). Any other device raises. All are exact
  (no K-distinct bucket limit), so the ``overflow`` they return is all
  zeros.
- :func:`vote` turns per-axis counts into an inside mask;
  :func:`grid_inside_mask` does it for the binned counts (the dense ones
  are voted in ``ops.raycast.grid_inside_mask``).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...grid import Grid
from ...utils.profiling import span, spanned
from ..raycast import face_origins, unrotate_axis
from . import _build

#: Transverse coordinate for padded lines — far enough that no triangle is hit.
PAD_LINE = 1.0e9
PAD_TRI = 1.0e18
#: Hit buckets at or above this are misses (the TPU kernel's sentinel).
_MISS = 3.0e38
#: Transverse tile edge: 32×32 lines per tile (one CUDA thread each).
LINE_TILE_EDGE = 32
#: Triangles per candidate block.
BIN_TB = 256

#: Kernel launches and plain-version calls of
#: :func:`line_parity_counts_binned`.
COUNT = _build.LaunchCount()
#: Kernel launches and plain-version calls of :func:`line_parity_counts`.
DENSE_COUNT = _build.LaunchCount()
#: Dense plain version: triangles per block and lines per chunk, so that
#: each (lines, block) pair temporary stays at 4M elements.
PLAIN_TRI_BLOCK = 256
PLAIN_LINE_CHUNK = 16384

#: The kernels' launch shape (``csrc/parity.cu``, checked against
#: ``m2s_line_parity_shape`` at the first launch): lines per CTA of the hit
#: pass, triangles per staged block (= BIN_TB) and the CTAs per SM its launch
#: bounds ask for.
PARITY_CTA_LINES = 512
PARITY_BLOCK = 256
PARITY_CTAS_PER_SM = 8
#: The planner splits the triangle blocks until the grid holds this many
#: waves of the card's resident CTAs; gridDim.y caps the chunk count.
PARITY_WAVES = 4
PARITY_MAX_CHUNKS = 65535

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: m2s_line_parity_binned: oy oz, ox inv_cs, rows tbl, n_blocks max_nb tb
#: t1 t2 n1 n2 n_cells chunk, counts, stream.
_ARGTYPES = (_P, _P, _F, _F, _P, _P) + (_I,) * 9 + (_P, _P)
#: m2s_line_parity_dense: oy oz, ox inv_cs, planes Tp L n_cells chunk,
#: counts, stream.
_DENSE_ARGTYPES = (_P, _P, _F, _F, _P, _L, _I, _I, _I, _P, _P)
_SHAPE_ARGTYPES = (_P,)


@dataclass(frozen=True)
class LineBins:
    """Per-(mesh, grid, axis) candidate structure for the parity kernel.

    rows: (B+1, 9·tb/128, 128) f32 — rotated planes (ax ay az abx aby abz
    acx acy acz) packed one row per block, extra all-pad row at index B.
    tbl: (n_tiles, max_nb) int32 candidate block ids, pad id = B.
    t1/t2: tile counts along the two transverse dims.
    """

    rows: torch.Tensor
    tbl: torch.Tensor
    n_blocks: int
    tb: int
    tile: int
    t1: int
    t2: int


def build_line_bins(grid: Grid, axis: int, ta, tb, tc, *,
                    tile: int = LINE_TILE_EDGE, block: int = BIN_TB,
                    device=None) -> LineBins:
    """Host-side candidate structure for +``axis`` line parity (numpy in,
    tensors on ``device`` out). Triangles are sorted by transverse Morton
    code so blocks are spatially tight; per 32×32-line tile the table keeps
    every block whose transverse AABB (ε-inflated, ≙ `geo.rs:20-21`)
    overlaps the tile's line footprint. Exact by construction: an excluded
    block cannot cross any of the tile's lines."""
    ta = np.asarray(ta, np.float32)
    tb_ = np.asarray(tb, np.float32)
    tc = np.asarray(tc, np.float32)
    T = len(ta)
    iy, iz = (axis + 1) % 3, (axis + 2) % 3
    # The line lattice layout comes from raycast.face_origins: rows/cols are
    # (y,z) for axis 0, (x,z) for axis 1, (x,y) for axis 2 — NOT the
    # rotated (iy, iz) pair. Footprints must follow the lattice; the plane
    # packing below keeps the kernel's (axis, iy, iz) rotation.
    cr = 1 if axis == 0 else 0
    cc = 2 if axis != 2 else 1

    lo_t = np.minimum(np.minimum(ta, tb_), tc)
    hi_t = np.maximum(np.maximum(ta, tb_), tc)
    cen_y = (lo_t[:, cr] + hi_t[:, cr]) * 0.5
    cen_z = (lo_t[:, cc] + hi_t[:, cc]) * 0.5

    # Transverse Morton sort (16-bit per axis is plenty at these tile sizes).
    def q16(v):
        lo, hi = float(v.min()), float(v.max())
        s = 65535.0 / (hi - lo) if hi > lo else 0.0
        return np.clip((v - lo) * s, 0, 65535).astype(np.uint64)

    def spread16(x):
        x = (x | (x << 8)) & np.uint64(0x00FF00FF)
        x = (x | (x << 4)) & np.uint64(0x0F0F0F0F)
        x = (x | (x << 2)) & np.uint64(0x33333333)
        x = (x | (x << 1)) & np.uint64(0x55555555)
        return x

    code = spread16(q16(cen_y)) | (spread16(q16(cen_z)) << np.uint64(1))
    order = np.argsort(code, kind="stable")
    ta, tb_, tc = ta[order], tb_[order], tc[order]
    lo_t, hi_t = lo_t[order], hi_t[order]

    ab = tb_ - ta
    ac = tc - ta
    pad = (-T) % block
    if pad:
        ta_p = np.concatenate([ta, np.full((pad, 3), PAD_TRI, np.float32)])
        ab_p = np.concatenate([ab, np.zeros((pad, 3), np.float32)])
        ac_p = np.concatenate([ac, np.zeros((pad, 3), np.float32)])
    else:
        ta_p, ab_p, ac_p = ta, ab, ac
    B = len(ta_p) // block

    # Packed rotated-plane rows: plane k occupies sub-rows
    # [k·block/128, (k+1)·block/128).
    rows = np.empty((B + 1, 9 * block), np.float32)
    planes = [
        (ta_p[:, axis], PAD_TRI), (ta_p[:, iy], PAD_TRI),
        (ta_p[:, iz], PAD_TRI),
        (ab_p[:, axis], 0.0), (ab_p[:, iy], 0.0), (ab_p[:, iz], 0.0),
        (ac_p[:, axis], 0.0), (ac_p[:, iy], 0.0), (ac_p[:, iz], 0.0),
    ]
    for k, (arr, padval) in enumerate(planes):
        rows[:B, k * block:(k + 1) * block] = arr.reshape(B, block)
        rows[B, k * block:(k + 1) * block] = padval

    # Block transverse AABBs over REAL triangles.
    blk_of = np.arange(T) // block
    blo_y = np.full((B,), np.inf, np.float32)
    bhi_y = np.full((B,), -np.inf, np.float32)
    blo_z = np.full((B,), np.inf, np.float32)
    bhi_z = np.full((B,), -np.inf, np.float32)
    np.minimum.at(blo_y, blk_of, lo_t[:, cr])
    np.maximum.at(bhi_y, blk_of, hi_t[:, cr])
    np.minimum.at(blo_z, blk_of, lo_t[:, cc])
    np.maximum.at(bhi_z, blk_of, hi_t[:, cc])

    # Tile footprints over the padded line lattice (lines at cell centers).
    first = grid.first_cell.detach().cpu().numpy()
    size = grid.cell_size.detach().cpu().numpy()
    n1 = int(grid.cell_count[cr])
    n2 = int(grid.cell_count[cc])
    t1 = -(-n1 // tile)
    t2 = -(-n2 // tile)
    fc_y = float(first[cr])
    fc_z = float(first[cc])
    cs_y = float(size[cr])
    cs_z = float(size[cc])
    ti = np.arange(t1)
    tj = np.arange(t2)
    y0 = fc_y + ti * tile * cs_y
    y1 = fc_y + np.minimum((ti + 1) * tile, n1) * cs_y - cs_y
    z0 = fc_z + tj * tile * cs_z
    z1 = fc_z + np.minimum((tj + 1) * tile, n2) * cs_z - cs_z
    if cs_y < 0:
        y0, y1 = y1, y0
    if cs_z < 0:
        z0, z1 = z1, z0

    eps = 1e-4  # ≙ the reference's AABB inflation (`geo.rs:20-21`)
    ov_y = (blo_y[None, :] - eps <= y1[:, None]) & (
        bhi_y[None, :] + eps >= y0[:, None]
    )  # (t1, B)
    ov_z = (blo_z[None, :] - eps <= z1[:, None]) & (
        bhi_z[None, :] + eps >= z0[:, None]
    )  # (t2, B)
    ov = ov_y[:, None, :] & ov_z[None, :, :]  # (t1, t2, B)
    ov = ov.reshape(t1 * t2, B)

    max_nb = max(int(ov.sum(axis=1).max()), 1)
    tbl = np.full((t1 * t2, max_nb), B, np.int32)
    for r in range(t1 * t2):
        ids = np.flatnonzero(ov[r])
        tbl[r, :len(ids)] = ids

    return LineBins(
        rows=torch.from_numpy(rows.reshape(B + 1, 9 * block // 128, 128)).to(
            device),
        tbl=torch.from_numpy(tbl).to(device),
        n_blocks=B, tb=block, tile=tile, t1=t1, t2=t2,
    )


def parity_chunks(n_groups: int, n_units: int, n_sms: int) -> int:
    """Chunks of the triangle blocks over gridDim.y for a hit pass of
    ``n_groups`` line groups (CTAs of PARITY_CTA_LINES lines) over
    ``n_units`` units (dense: 256-triangle blocks; binned: ``tbl`` slots,
    each one block). 1 when the line groups alone fill PARITY_WAVES waves of
    ``n_sms`` SMs at PARITY_CTAS_PER_SM CTAs each, else enough chunks to fill
    them, at most one per unit and at most PARITY_MAX_CHUNKS."""
    want = PARITY_WAVES * n_sms * PARITY_CTAS_PER_SM
    groups = max(n_groups, 1)
    if groups >= want:
        return 1
    return max(1, min(-(-want // groups), n_units, PARITY_MAX_CHUNKS))


def chunk_units(n_units: int, chunks: int) -> int:
    """Units per chunk: ⌈n_units / chunks⌉ (at least 1). Chunk c takes units
    [c·len, min((c+1)·len, n_units)); ⌈n_units / len⌉ ≤ ``chunks`` of them
    are launched. A unit (a block or a slot) is never split."""
    return max(1, -(-n_units // max(chunks, 1)))


@functools.cache
def launch_shape() -> dict:
    """What the card makes of the hit pass's launch shape: threads and
    lines per CTA, triangles per block, and the CTAs per SM that the binned
    and the dense hit pass can keep resident (needs the card). Raises
    unless the built kernels have the shape the planner assumes."""
    out = (ctypes.c_int * 6)()
    fn = _build.entry("m2s_line_parity_shape", _SHAPE_ARGTYPES)
    _build.check(fn(ctypes.addressof(out)), "m2s_line_parity_shape")
    want = (PARITY_CTA_LINES, PARITY_BLOCK, PARITY_CTAS_PER_SM)
    if tuple(out)[:3] != want:
        raise RuntimeError(f"csrc/parity.cu's launch shape {tuple(out)[:3]} "
                           f"is not parity.py's {want}")
    return {"threads": out[5], "cta_lines": out[0], "block": out[1],
            "min_ctas_per_sm": out[2], "binned_ctas_per_sm": out[3],
            "dense_ctas_per_sm": out[4]}


def binned_launch(bins: LineBins, n_sms: int) -> tuple[int, int, int]:
    """(line groups, chunks, slots per chunk) of the binned hit pass on a
    card of ``n_sms`` SMs: gridDim = (line groups, chunks)."""
    groups = bins.t1 * bins.t2 * (bins.tile ** 2 // PARITY_CTA_LINES)
    n_units = bins.tbl.shape[1]
    per = chunk_units(n_units, parity_chunks(groups, n_units, n_sms))
    return groups, -(-n_units // per), per


def dense_launch(n_lines: int, n_tris: int, n_sms: int
                 ) -> tuple[int, int, int]:
    """(line groups, chunks, blocks per chunk) of the dense hit pass."""
    groups = -(-n_lines // PARITY_CTA_LINES)
    n_units = -(-n_tris // PARITY_BLOCK)
    per = chunk_units(n_units, parity_chunks(groups, n_units, n_sms))
    return groups, -(-n_units // per) if n_units else 0, per


def _check(oy, oz, bins: LineBins, n1: int, n2: int, n_cells: int):
    L = n1 * n2
    for name, t in (("oy", oy), ("oz", oz)):
        if t.dtype != torch.float32 or tuple(t.shape) != (L,):
            raise ValueError(f"{name}: want float32 ({L},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    rows_shape = (bins.n_blocks + 1, 9 * bins.tb // 128, 128)
    if bins.rows.dtype != torch.float32 or tuple(bins.rows.shape) != rows_shape:
        raise ValueError(f"bins.rows: want float32 {rows_shape}, got "
                         f"{bins.rows.dtype} {tuple(bins.rows.shape)}")
    if bins.tbl.dtype != torch.int32 or bins.tbl.dim() != 2 or (
            bins.tbl.shape[0] != bins.t1 * bins.t2):
        raise ValueError(f"bins.tbl: want int32 ({bins.t1 * bins.t2}, nb), "
                         f"got {bins.tbl.dtype} {tuple(bins.tbl.shape)}")
    if (bins.t1 * bins.tile < n1 or bins.t2 * bins.tile < n2
            or bins.tile != LINE_TILE_EDGE):
        raise ValueError("bins do not tile the line lattice")
    for name, t in (("oz", oz), ("bins.rows", bins.rows),
                    ("bins.tbl", bins.tbl)):
        if t.device != oy.device:
            raise ValueError(f"{name} is on {t.device}, oy on {oy.device}")
    for name, t in (("oy", oy), ("oz", oz), ("bins.rows", bins.rows),
                    ("bins.tbl", bins.tbl)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_cells <= 0:
        raise ValueError(f"n_cells must be positive, got {n_cells}")


def _inv_cell_size(cell_size) -> torch.Tensor:
    """1/cell_size in float32, as the TPU wrapper computes it."""
    return 1.0 / torch.as_tensor(cell_size, dtype=torch.float32)


def _hit_cells(py, pz, ox, inv_cs, planes, n_cells: int):
    """(hit, cell) per (line, triangle) pair: the TPU kernels' hit test
    (``pallas_parity.py:85-110``) on broadcastable line coordinates and
    the 9 pre-rotated planes; ``cell`` is the histogram slot
    min(floor(t / cell_size), n_cells - 1), 0 where there is no hit."""
    ax, ay, az, abx, aby, abz, acx, acy, acz = planes
    apy = py - ay
    apz = pz - az
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
    apx = ox - ax
    p1x = apx - abx
    p2x = apx - acx
    num = w0 * apx + w1 * p1x + w2 * p2x
    den = w0 + w1 + w2
    t = -num / torch.where(den == 0.0, 1.0, den)
    hit = inside & (t > 0.0) & (den != 0.0)
    b = torch.floor(t * inv_cs)
    hit = hit & (b >= 0.0) & (b < _MISS)
    cell = torch.where(hit, torch.clamp(b, max=float(n_cells - 1)), 0.0)
    return hit, cell.long()


def _suffix_counts(hist):
    """counts[l, i] = Σ_{j ≥ i} hist[l, j]."""
    return hist.flip(1).cumsum(1, dtype=torch.int32).flip(1)


def line_parity_counts_binned_plain(oy, oz, ox, cell_size, bins: LineBins, *,
                                    n_cells: int, n1: int, n2: int):
    """Plain PyTorch version of :func:`line_parity_counts_binned` (any
    device): per candidate slot, every tile's hits are bucketed into a
    per-line histogram, which a reversed cumulative sum turns into suffix
    counts."""
    COUNT.plain += 1
    dev = oy.device
    tile, t1, t2 = bins.tile, bins.t1, bins.t2
    n_tiles, lt = t1 * t2, tile * tile

    def tile_layout(v):
        v = F.pad(v.reshape(n1, n2), (0, t2 * tile - n2, 0, t1 * tile - n1),
                  value=PAD_LINE)
        v = v.reshape(t1, tile, t2, tile).permute(0, 2, 1, 3)
        return v.reshape(n_tiles, lt, 1)

    py, pz = tile_layout(oy), tile_layout(oz)
    ox = torch.as_tensor(ox, dtype=torch.float32).to(dev)
    inv_cs = _inv_cell_size(cell_size).to(dev)
    planes = bins.rows.reshape(bins.n_blocks + 1, 9, 1, bins.tb)
    hist = torch.zeros((n_tiles * lt, n_cells), dtype=torch.int32, device=dev)
    for j in range(bins.tbl.shape[1]):
        p = planes[bins.tbl[:, j].long()]  # (n_tiles, 9, 1, tb)
        hit, cell = _hit_cells(py, pz, ox, inv_cs, p.unbind(1), n_cells)
        hist.scatter_add_(1, cell.reshape(n_tiles * lt, -1),
                          hit.to(torch.int32).reshape(n_tiles * lt, -1))
    counts = _suffix_counts(hist)
    counts = counts.reshape(t1, t2, tile, tile, n_cells).permute(0, 2, 1, 3, 4)
    counts = counts.reshape(t1 * tile, t2 * tile, n_cells)[:n1, :n2]
    counts = counts.reshape(n1 * n2, n_cells)
    return counts, torch.zeros((n1 * n2,), dtype=torch.int32, device=dev)


def line_parity_counts_binned(oy, oz, ox, cell_size, bins: LineBins, *,
                              n_cells: int, n1: int, n2: int):
    """Crossing counts per (line, cell) for +axis rays, through per-tile
    candidate blocks.

    oy/oz: (L,) f32 transverse coordinates of the line origins, row-major
    over the (n1, n2) lattice; ox: the axis coordinate of the cell-0 center;
    cell_size: the cell size along the ray axis (both scalars, kept on the
    host). Returns (counts (L, n_cells) int32, overflow (L,) int32), with
    counts[l, i] = #hits on line l with floor(t / cell_size) >= i. Exact, so
    overflow is zero. CUDA tensors launch ``csrc/parity.cu``; CPU tensors
    run :func:`line_parity_counts_binned_plain`.
    """
    _check(oy, oz, bins, n1, n2, n_cells)
    if oy.device.type == "cpu":
        return line_parity_counts_binned_plain(
            oy, oz, ox, cell_size, bins, n_cells=n_cells, n1=n1, n2=n2
        )
    if oy.device.type != "cuda":
        raise ValueError(f"line_parity_counts_binned: no kernel for "
                         f"{oy.device}")
    if bins.tb != PARITY_BLOCK:
        raise ValueError(f"bins.tb: the kernel stages blocks of "
                         f"{PARITY_BLOCK} triangles, got {bins.tb}")
    launch_shape()
    ox_f = float(torch.as_tensor(ox, dtype=torch.float32))
    inv_cs = float(_inv_cell_size(cell_size))
    L = n1 * n2
    counts = torch.zeros((L, n_cells), dtype=torch.int32, device=oy.device)
    _, _, per = binned_launch(bins, torch.cuda.get_device_properties(
        oy.device).multi_processor_count)
    fn = _build.entry("m2s_line_parity_binned", _ARGTYPES)
    with torch.cuda.device(oy.device):
        stream = torch.cuda.current_stream(oy.device).cuda_stream
        COUNT.kernel += 1
        rc = fn(
            oy.data_ptr(), oz.data_ptr(), ox_f, inv_cs, bins.rows.data_ptr(),
            bins.tbl.data_ptr(), bins.n_blocks, bins.tbl.shape[1], bins.tb,
            bins.t1, bins.t2, n1, n2, n_cells, per, counts.data_ptr(),
            stream,
        )
    _build.check(rc, "m2s_line_parity_binned")
    return counts, torch.zeros((L,), dtype=torch.int32, device=oy.device)


def rotate_planes(ta, tb, tc, axis: int):
    """The 9 pre-rotated planes (T,) of a soup for +``axis`` rays: component
    x ← axis, y ← (axis+1)%3, z ← (axis+2)%3 (`geo.rs:181-195`)."""
    ab = tb - ta
    ac = tc - ta
    ix, iy, iz = axis, (axis + 1) % 3, (axis + 2) % 3
    return (
        ta[:, ix], ta[:, iy], ta[:, iz],
        ab[:, ix], ab[:, iy], ab[:, iz],
        ac[:, ix], ac[:, iy], ac[:, iz],
    )


def _check_dense(oy, oz, tri_rot, n_cells: int):
    L = oy.shape[0] if oy.dim() == 1 else -1
    for name, t in (("oy", oy), ("oz", oz)):
        if t.dtype != torch.float32 or tuple(t.shape) != (L,):
            raise ValueError(f"{name}: want float32 (L,) like oy, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len(tri_rot) != 9:
        raise ValueError(f"tri_rot: want 9 planes, got {len(tri_rot)}")
    T = tri_rot[0].shape[0] if tri_rot[0].dim() == 1 else -1
    for k, t in enumerate(tri_rot):
        if t.dtype != torch.float32 or tuple(t.shape) != (T,):
            raise ValueError(f"tri_rot[{k}]: want float32 (T,), got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("oz", oz), ("tri_rot", tri_rot[0])):
        if t.device != oy.device:
            raise ValueError(f"{name} is on {t.device}, oy on {oy.device}")
    if n_cells <= 0:
        raise ValueError(f"n_cells must be positive, got {n_cells}")
    if max(L, T) >= 2**31:
        raise ValueError("more than 2^31 - 1 lines or triangles")


def line_parity_counts_plain(oy, oz, ox, cell_size, tri_rot, *,
                             n_cells: int):
    """Plain PyTorch version of :func:`line_parity_counts` (any device):
    per (line chunk, triangle block), hits are bucketed into a per-line
    histogram, which a reversed cumulative sum turns into suffix counts."""
    DENSE_COUNT.plain += 1
    dev = oy.device
    L, T = oy.shape[0], tri_rot[0].shape[0]
    ox = torch.as_tensor(ox, dtype=torch.float32).to(dev)
    inv_cs = _inv_cell_size(cell_size).to(dev)
    hist = torch.zeros((L, n_cells), dtype=torch.int32, device=dev)
    for ls in range(0, L, PLAIN_LINE_CHUNK):
        rows = slice(ls, ls + PLAIN_LINE_CHUNK)
        py, pz = oy[rows, None], oz[rows, None]
        for ts in range(0, T, PLAIN_TRI_BLOCK):
            planes = [p[None, ts:ts + PLAIN_TRI_BLOCK] for p in tri_rot]
            hit, cell = _hit_cells(py, pz, ox, inv_cs, planes, n_cells)
            hist[rows].scatter_add_(1, cell, hit.to(torch.int32))
    return _suffix_counts(hist), torch.zeros((L,), dtype=torch.int32,
                                             device=dev)


def line_parity_counts(oy, oz, ox, cell_size, tri_rot, *, n_cells: int):
    """Crossing counts per (line, cell) for +axis rays against every
    triangle (the TPU ``line_parity_counts``).

    oy/oz: (L,) f32 transverse coordinates of the line origins; ox: the axis
    coordinate of the cell-0 center; cell_size: the cell size along the ray
    axis (both scalars, kept on the host); tri_rot: the 9 pre-rotated planes
    (T,) f32 of :func:`rotate_planes`. Returns (counts (L, n_cells) int32,
    overflow (L,) int32), counts[l, i] = #hits on line l with
    floor(t / cell_size) >= i. Exact, so overflow is zero. CUDA tensors
    launch ``csrc/parity.cu``; CPU tensors run
    :func:`line_parity_counts_plain`.
    """
    _check_dense(oy, oz, tri_rot, n_cells)
    if oy.device.type == "cpu":
        return line_parity_counts_plain(oy, oz, ox, cell_size, tri_rot,
                                        n_cells=n_cells)
    if oy.device.type != "cuda":
        raise ValueError(f"line_parity_counts: no kernel for {oy.device}")
    launch_shape()
    ox_f = float(torch.as_tensor(ox, dtype=torch.float32))
    inv_cs = float(_inv_cell_size(cell_size))
    L, T = oy.shape[0], tri_rot[0].shape[0]
    # (9, Tp): whole blocks, the triangles past T all zero (they never pass
    # the edge test).
    planes = F.pad(torch.stack(tri_rot), (0, (-T) % PARITY_BLOCK))
    counts = torch.zeros((L, n_cells), dtype=torch.int32, device=oy.device)
    _, _, per = dense_launch(L, T, torch.cuda.get_device_properties(
        oy.device).multi_processor_count)
    fn = _build.entry("m2s_line_parity_dense", _DENSE_ARGTYPES)
    with torch.cuda.device(oy.device):
        stream = torch.cuda.current_stream(oy.device).cuda_stream
        DENSE_COUNT.kernel += 1
        rc = fn(oy.data_ptr(), oz.data_ptr(), ox_f, inv_cs,
                planes.data_ptr(), planes.shape[1], L, n_cells, per,
                counts.data_ptr(), stream)
    _build.check(rc, "m2s_line_parity_dense")
    return counts, torch.zeros((L,), dtype=torch.int32, device=oy.device)


def vote(grid: Grid, axes: int, device, axis_counts):
    """Inside mask from per-axis crossing counts: ``axis_counts(axis, oy,
    oz, lshape)`` returns (counts (L, n) int32, overflow (L,)) for the
    +axis lines of the face lattice. ≥2 odd axes of 3 (`grid.rs:622-639`),
    or the single +X parity for ``axes=1``."""
    votes = None
    total_ovf = torch.zeros((), dtype=torch.int32, device=device)
    for axis in range(axes):
        with span("grid.sign.axis"):
            origins, lshape = face_origins(grid, axis, device)
            iy, iz = (axis + 1) % 3, (axis + 2) % 3
            counts, ovf = axis_counts(axis, origins[:, iy].contiguous(),
                                      origins[:, iz].contiguous(), lshape)
            odd = counts % 2 == 1
            vote = unrotate_axis(odd, axis, lshape,
                                 grid.cell_count[axis]).to(torch.int32)
            votes = vote if votes is None else votes + vote
            total_ovf = total_ovf + ovf.sum(dtype=torch.int32)
    return votes >= (2 if axes >= 2 else 1), total_ovf


@spanned("grid.sign")
def grid_inside_mask(grid: Grid, line_bins, *, axes: int = 3):
    """Boolean (nx, ny, nz) inside mask via binned line parity on the device
    of ``line_bins`` (``grid_inside_mask_pallas`` with ``line_bins``).

    ``axes=3``: best-of-3 voting (`grid.rs:622-639`); ``axes=1``: single
    +X parity. Also returns the total overflow, which is zero: the counts
    are exact.
    """
    def axis_counts(axis, oy, oz, lshape):
        return line_parity_counts_binned(
            oy, oz, grid.first_cell[axis], grid.cell_size[axis],
            line_bins[axis], n_cells=grid.cell_count[axis], n1=lshape[0],
            n2=lshape[1])

    return vote(grid, axes, line_bins[0].rows.device, axis_counts)

