"""Block-culled distances: the per-mesh block index, phase A and the kernel.

PyTorch counterpart of ``ops/kernels/pallas_culled.py`` (the TPU completion
of the reference's R-tree branch-and-bound, `rtree.rs:96-126`,
`bvh_ext.rs:59-168`). Triangles are Morton-sorted into blocks of ``TB``
(256); phase A picks, per sub-tile of Morton-sorted queries, the candidate
blocks by lower bounds from the sub-tile center; the kernel evaluates each
query against its group's candidate blocks only.

- :func:`build_block_index` (host numpy, then one upload) builds the
  :class:`BlockIndex`.
- Phase A: :func:`_phase_a_topk` (the gather engine's front end) and
  :func:`select_blocks` (the union engine's per-tile table). Their
  hierarchical branch, :func:`_phase_a_hier`, launches ``csrc/phase_a.cu``
  on a CUDA tensor (one launch a pass) and runs
  :func:`_phase_a_hier_plain` on a CPU tensor; the flat branch
  (:func:`_phase_a_flat_lb`, B ≤ 2·c) is plain PyTorch on both. The plain
  versions are chunked where eager torch would build what XLA fuses away.
- :func:`culled_blocks` is the kernel's wrapper. One function serves both
  engines, the gather engine of ``culling.query_sdf_culled`` on one card
  and the union engine of the sharded path
  (``parallel.sharding.generate_sdf_sharded_culled``): per group of
  queries, the minimum squared distance over the triangles of the blocks
  its table row lists (pad id ``n_blocks``, sorted last) and, with
  anchors, the number of strict-interior Möller–Trumbore crossings of the
  segment from each query to its anchor. A union-engine
  group is a 1024-query tile (``_kernel_culled``, ``pallas_culled.py:516``);
  a gather-engine group is an ``st``-query sub-tile
  (``culling._culled_gather_signed_impl``'s body, ``culling.py:464-500``).
  On a CUDA tensor it launches ``csrc/culled.cu``; on a CPU tensor it runs
  :func:`culled_blocks_plain`. Any other device raises.
- :func:`culled_dist` is ``culled_dist_pallas``: one union-engine call on
  a table, with the root taken in float64 like ``sdf.sqrt_f32``.

The pair math is the TPU kernels' division-free ladder
(``sdf.closest_point_vw``/``sdf.dist2``) and the gather engine's crossing
test, operation for operation, so kernel and plain version agree exactly.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ...types import F32_MAX
from ...utils.profiling import spanned
from ..geometry import sqrt_f32
from . import _build
from .sdf import (RECORD_FIELDS, _rcp, closest_point_vw, dist2,
                  tri_records)

#: Queries per union-engine tile.
DEFAULT_QT = 1024
#: Queries per phase-A sub-tile (must divide DEFAULT_QT).
DEFAULT_ST = 128
#: Candidate-block capacity per sub-tile (union engine).
DEFAULT_NB_SUB = 48
#: Cap on distinct union slots per tile.
DEFAULT_NB_TABLE = 256
#: Triangles per Morton block (a multiple of 128).
TB = 256
#: Hierarchical phase A (coarse block AABBs → fine csphere bounds on the
#: nearest HIER_C blocks) from this block count up.
HIER_MIN_BLOCKS = 512
#: Fine-level candidate window per sub-tile.
HIER_C = 96
#: Vertex coordinate of the pad block's triangles (a far degenerate point).
PAD_COORD = 1.0e18

#: Kernel launches and plain-version calls of :func:`culled_blocks`.
COUNT = _build.LaunchCount()
#: Kernel launches and plain-version calls of :func:`_phase_a_hier`.
PHASE_A_COUNT = _build.LaunchCount()
#: Plain versions and phase A: elements per chunked pair temporary.
PLAIN_PAIRS = 1 << 22
#: Group sizes the kernel takes besides multiples of 128: a half-warp or a
#: warp owns a group (two queries per thread at 64); larger groups are
#: split into CTA-wide slices.
KERNEL_GROUPS = (16, 32, 64)
#: Most queries one kernel call takes (they are indexed in 64 bits, the
#: group count in 32).
MAX_QUERIES = 2**31 - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
#: m2s_culled_blocks: queries anchors, rows n_blocks tb, tbl n_groups
#: n_slots group, d2 counts, stream.
_ARGTYPES = (_P, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _P)
#: m2s_phase_a_hier: centers n_sub, lo hi n_blocks, csphere tb, c kg, lb
#: idx bound, stream.
_PHASE_A_ARGTYPES = (_P, _I, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P)
#: Shared memory one phase-A CTA may take (the H100's opt-in limit).
PHASE_A_SMEM_MAX = 232_448
#: Largest window + 1 the phase-A kernel sorts, and most blocks (ids in
#: 16 bits).
PHASE_A_MAX_WINDOW = 1024
PHASE_A_MAX_BLOCKS = 1 << 16


@dataclass(frozen=True)
class BlockIndex:
    """Per-mesh spatial block structure (host-built, device-resident).

    rows: (B+1, 9, tb) f32 — the Morton-ordered triangles, one row per
    block, planes [ax ay az abx aby abz acx acy acz]; the all-pad row at
    index B (a = PAD_COORD, zero edges). Its bytes are the JAX package's
    (B+1, 9·tb/128, 128) array. planes9: (9, B·tb) f32 vertex planes (ax ay
    az bx by bz cx cy cz, PAD_COORD tail). lo/hi: (B, 3) block AABBs over
    the real triangles. content_key: adler32 of the AABBs (the route
    cache's key, as the JAX package's, which the tests hold it equal to).
    The kernel reads the packed records of ``rows`` or ``gather_rows``
    (:func:`table_records`), packed on a table's first use and kept while
    the index keeps the table.
    """

    rows: torch.Tensor
    planes9: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    n_blocks: int
    tb: int
    content_key: int = 0

    @functools.cached_property
    def csphere(self) -> torch.Tensor:
        """(B·tb, 4) f32 rows [cx, cy, cz, r] of :func:`_csphere`: each
        triangle's centroid and circumradius, the fine bounds' table
        (phase A reads a block's tb rows). Built once per index."""
        cen, rad = _csphere(self)
        return torch.stack([cen[0], cen[1], cen[2], rad], dim=1)

    @functools.cached_property
    def gather_rows(self) -> torch.Tensor:
        """(B+1, 9, tb) rows of the gather engine: [a | b − a | c − a] from
        ``planes9`` with an all-PAD_COORD pad block (zero edges). Not
        bit-equal to ``rows``: planes9's b is itself a + ab
        (``culling.py:456-476``). Built once per index."""
        B, tb = self.n_blocks, self.tb
        p = torch.cat([
            self.planes9.reshape(9, B, tb),
            torch.full((9, 1, tb), PAD_COORD, dtype=torch.float32,
                       device=self.planes9.device),
        ], dim=1)
        a = p[0:3]
        return torch.cat([a, p[3:6] - a, p[6:9] - a]).permute(
            1, 0, 2).contiguous()


#: Packed records of each block table, by ``id`` of the table: (weak
#: reference to the table, its ``_version`` when packed, records). An entry
#: goes when its table does.
_TABLE_RECORDS: dict[int, tuple] = {}


def table_records(rows):
    """(n, tb, len(RECORD_FIELDS)) packed records of a block table ``rows``
    (n, 9, tb) [a | ab | ac], through :func:`sdf.tri_records`: packed on
    the table's first use and again only after it is written to, so a
    :class:`BlockIndex` table (``rows`` for the union engine, ``gather_rows``
    for the gather engine; an ulp apart) is packed once per mesh."""
    key = id(rows)
    hit = _TABLE_RECORDS.get(key)
    if hit is not None and hit[0]() is rows and hit[1] == rows._version:
        return hit[2]
    n, _, tb = rows.shape
    p = rows.permute(1, 0, 2).reshape(9, n * tb)
    rec = tri_records(p[0:3].t(), p[3:6].t(), p[6:9].t(),
                      edges=True).reshape(n, tb, len(RECORD_FIELDS))
    _TABLE_RECORDS[key] = (
        weakref.ref(rows, lambda _, k=key: _TABLE_RECORDS.pop(k, None)),
        rows._version, rec)
    return rec


def build_block_index(ta, tb, tc, *, block: int = TB,
                      device) -> BlockIndex:
    """Morton-sort triangles and pack ``block``-sized rows (host numpy, then
    one upload to ``device``); ≙ the reference's `RTree::bulk_load`
    (`rtree.rs:96-126`). A copy of ``pallas_culled.build_block_index``."""
    ta = np.asarray(ta, np.float32)
    tb = np.asarray(tb, np.float32)
    tc = np.asarray(tc, np.float32)
    T = len(ta)
    cent = (ta + tb + tc) / 3.0
    lo = cent.min(axis=0)
    hi = cent.max(axis=0)
    scale = np.where(hi > lo, 1024.0 / (hi - lo), 0.0)
    q = np.clip((cent - lo) * scale, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    order = np.argsort(code, kind="stable")
    ta, tb, tc = ta[order], tb[order], tc[order]

    # Edges from REAL vertices; pad rows get a = PAD with ZERO edges.
    ab_r = tb - ta
    ac_r = tc - ta
    pad = (-T) % block
    if pad:
        ta_p = np.concatenate([ta, np.full((pad, 3), PAD_COORD, np.float32)])
        ab_p = np.concatenate([ab_r, np.zeros((pad, 3), np.float32)])
        ac_p = np.concatenate([ac_r, np.zeros((pad, 3), np.float32)])
    else:
        ta_p, ab_p, ac_p = ta, ab_r, ac_r
    B = len(ta_p) // block

    tri_lo = np.minimum(np.minimum(ta, tb), tc)
    tri_hi = np.maximum(np.maximum(ta, tb), tc)
    blk_of = np.arange(T) // block
    lo_b = np.full((B, 3), np.inf, np.float32)
    hi_b = np.full((B, 3), -np.inf, np.float32)
    np.minimum.at(lo_b, blk_of, tri_lo)
    np.maximum.at(hi_b, blk_of, tri_hi)

    if block % 128:
        raise ValueError(f"block={block} must be a multiple of 128")
    rows = np.empty((B + 1, 9 * block), np.float32)
    for k, (arr, padval) in enumerate(
        [(ta_p[:, 0], PAD_COORD), (ta_p[:, 1], PAD_COORD),
         (ta_p[:, 2], PAD_COORD), (ab_p[:, 0], 0.0), (ab_p[:, 1], 0.0),
         (ab_p[:, 2], 0.0), (ac_p[:, 0], 0.0), (ac_p[:, 1], 0.0),
         (ac_p[:, 2], 0.0)]
    ):
        rows[:B, k * block:(k + 1) * block] = arr.reshape(B, block)
        rows[B, k * block:(k + 1) * block] = padval
    tb_p = ta_p + ab_p
    tc_p = ta_p + ac_p
    planes9 = np.stack([
        ta_p[:, 0], ta_p[:, 1], ta_p[:, 2],
        tb_p[:, 0], tb_p[:, 1], tb_p[:, 2],
        tc_p[:, 0], tc_p[:, 1], tc_p[:, 2],
    ])
    return BlockIndex(
        rows=torch.from_numpy(rows.reshape(B + 1, 9, block)).to(device),
        planes9=torch.from_numpy(np.ascontiguousarray(planes9)).to(device),
        lo=torch.from_numpy(lo_b).to(device),
        hi=torch.from_numpy(hi_b).to(device),
        n_blocks=B,
        tb=block,
        content_key=zlib.adler32(lo_b.tobytes() + hi_b.tobytes()),
    )


# ------------------------------------------------------------------ phase A
def _sq3(x, y, z):
    """x² + y² + z², in the order XLA reduces a length-3 axis."""
    return x * x + y * y + z * z


def _smallest(x, k: int):
    """(values, indices) of the ``k`` smallest entries of each row, ties
    lowest index first (``jax.lax.top_k`` of ``-x``)."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def _min_init(x):
    """Row minimum with ``initial=F32_MAX`` (an explicit F32_MAX column)."""
    col = torch.full((x.shape[0], 1), F32_MAX, dtype=x.dtype,
                     device=x.device)
    return torch.amin(torch.cat([x, col], dim=1), dim=1)


def _csphere(bi: BlockIndex):
    """Per-triangle centroid planes (3, B·tb) and circumradius (B·tb,):
    |c − centroid| − r ≤ d(c, tri)."""
    p9 = bi.planes9
    cen = (p9[0:3] + p9[3:6] + p9[6:9]) * (1.0 / 3.0)

    def r2(v):
        d = v - cen
        return _sq3(d[0], d[1], d[2])

    rad = sqrt_f32(torch.maximum(r2(p9[0:3]),
                                 torch.maximum(r2(p9[3:6]), r2(p9[6:9]))))
    return cen, rad


def _rows_per_chunk(n_rows: int, width: int) -> int:
    return max(1, min(n_rows, PLAIN_PAIRS // max(width, 1)))


def _kg_tail(lb_s, idx_s, lb_rest, kg: int):
    """The gather engine's pair from a ranked window: the first ``kg`` ids
    (int32) and the bound on every block past them,
    min(lb_s[:, kg], lb_rest)."""
    return (idx_s[:, :kg].to(torch.int32).contiguous(),
            torch.minimum(lb_s[:, kg], lb_rest))


def _phase_a_hier_plain(centers, bi: BlockIndex, *, c: int, kg=None):
    """Plain PyTorch version of :func:`_phase_a_hier` (any device). The
    (n_sub, B, 3) gap tensor and the (n_sub, c', tb) fine bounds are built
    chunk by chunk over sub-tiles."""
    PHASE_A_COUNT.plain += 1
    B, tb = bi.n_blocks, bi.tb
    n_sub = centers.shape[0]
    cc = min(c, B - 1)
    lb_rest = torch.empty((n_sub,), dtype=torch.float32, device=centers.device)
    idx_c = torch.empty((n_sub, cc), dtype=torch.int64, device=centers.device)
    step = _rows_per_chunk(n_sub, 3 * B)
    for s in range(0, n_sub, step):
        cs = centers[s:s + step, None, :]
        gap = torch.clamp_min(torch.maximum(bi.lo[None] - cs,
                                            cs - bi.hi[None]), 0.0)
        dbox = sqrt_f32(_sq3(gap[..., 0], gap[..., 1], gap[..., 2]))
        vals, idx = _smallest(dbox, cc + 1)
        lb_rest[s:s + step] = vals[:, cc]
        idx_c[s:s + step] = idx[:, :cc]

    table = bi.csphere.reshape(B, tb, 4)
    lbf = torch.empty((n_sub, cc), dtype=torch.float32, device=centers.device)
    step = _rows_per_chunk(n_sub, cc * tb)
    for s in range(0, n_sub, step):
        cs = centers[s:s + step]
        t = table[idx_c[s:s + step]]  # (chunk, cc, tb, 4)
        dx = cs[:, 0, None, None] - t[..., 0]
        dy = cs[:, 1, None, None] - t[..., 1]
        dz = cs[:, 2, None, None] - t[..., 2]
        d = sqrt_f32(_sq3(dx, dy, dz)) - t[..., 3]
        lbf[s:s + step] = torch.amin(torch.clamp_min(d, 0.0), dim=2)

    ord_ = torch.argsort(lbf, dim=1, stable=True)
    out = (torch.gather(lbf, 1, ord_), torch.gather(idx_c, 1, ord_), lb_rest)
    return out if kg is None else _kg_tail(*out, kg)


def phase_a_smem_bytes(n_blocks: int, c: int) -> int:
    """Shared memory of one phase-A CTA (``csrc/phase_a.cu`` smem_bytes):
    the window's and the ranking's sort buffers, a histogram, 4 B a
    block."""
    cc = min(c, n_blocks - 1)

    def pow2(n):
        return 1 << max(0, (n - 1).bit_length())

    return 8 * (pow2(cc + 1) + pow2(cc)) + 4 * 256 + 4 * n_blocks


def _check_phase_a(centers, bi: BlockIndex, c: int, kg):
    """Shapes for both versions; on a CUDA tensor also the kernel's
    limits."""
    B = bi.n_blocks
    cc = min(c, B - 1)
    if centers.dtype != torch.float32 or centers.dim() != 2 or (
            centers.shape[1] != 3):
        raise ValueError(f"centers: want float32 (n_sub, 3), got "
                         f"{centers.dtype} {tuple(centers.shape)}")
    if cc < 1 or (kg is not None and not 0 < kg < cc):
        raise ValueError(f"phase A: window {cc} of {B} blocks, kg={kg}: "
                         "want 1 <= kg < window")
    if centers.device.type != "cuda":
        return
    if B > PHASE_A_MAX_BLOCKS or cc >= PHASE_A_MAX_WINDOW or bi.tb % 32:
        raise ValueError(f"phase A: {B} blocks of {bi.tb}, window {cc}; the "
                         f"kernel takes up to {PHASE_A_MAX_BLOCKS} blocks of "
                         f"a multiple of 32 and windows below "
                         f"{PHASE_A_MAX_WINDOW}")
    if phase_a_smem_bytes(B, c) > PHASE_A_SMEM_MAX:
        raise ValueError(f"phase A: {B} blocks need "
                         f"{phase_a_smem_bytes(B, c)} B of shared memory a "
                         f"CTA, more than {PHASE_A_SMEM_MAX}")
    for name, t in (("centers", centers), ("lo", bi.lo), ("hi", bi.hi)):
        if t.device != centers.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {centers.device}")


def _phase_a_hier(centers, bi: BlockIndex, *, c: int, kg=None):
    """Coarse→fine phase A (``pallas_culled._phase_a_hier``): box distance
    from each center to every block AABB keeps the ``c`` nearest blocks;
    csphere bounds over only those blocks' triangles rank them (ties by
    coarse order). Returns (lb_c (n_sub, c') sorted ascending, their block
    ids (int64), the coarse bound on the nearest block outside the window
    (n_sub,)), c' = min(c, B−1); with ``kg``, the gather engine's pair
    :func:`_kg_tail` of it instead (idx (n_sub, kg) int32, lb_excl).

    CUDA tensors make one launch of ``csrc/phase_a.cu`` (with ``kg`` it
    writes only the pair); CPU tensors run :func:`_phase_a_hier_plain`,
    which the kernel equals bit for bit. Any other device raises."""
    _check_phase_a(centers, bi, c, kg)
    dev = centers.device
    if dev.type == "cpu":
        return _phase_a_hier_plain(centers, bi, c=c, kg=kg)
    if dev.type != "cuda":
        raise ValueError(f"phase A: no kernel for {dev}")
    n_sub = centers.shape[0]
    cc = min(c, bi.n_blocks - 1)
    width = cc if kg is None else kg
    lb = (torch.empty((n_sub, cc), dtype=torch.float32, device=dev)
          if kg is None else None)
    idx = torch.empty((n_sub, width), dtype=torch.int32, device=dev)
    bound = torch.empty((n_sub,), dtype=torch.float32, device=dev)
    table = bi.csphere
    fn = _build.entry("m2s_phase_a_hier", _PHASE_A_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        PHASE_A_COUNT.kernel += 1
        rc = fn(centers.data_ptr(), n_sub, bi.lo.data_ptr(),
                bi.hi.data_ptr(), bi.n_blocks, table.data_ptr(), bi.tb, c,
                0 if kg is None else kg,
                None if lb is None else lb.data_ptr(), idx.data_ptr(),
                bound.data_ptr(), stream)
    _build.check(rc, "m2s_phase_a_hier")
    if kg is None:
        return lb, idx.long(), bound
    return idx, bound


def _phase_a_flat_lb(centers, bi: BlockIndex):
    """Per-block csphere lower bounds from each center, (n_sub, B)
    (``pallas_culled._phase_a_flat_lb``), chunked over centers."""
    B = bi.n_blocks
    Tp = bi.planes9.shape[1]
    n_sub = centers.shape[0]
    cen = bi.csphere[:, :3].t()
    rad = bi.csphere[:, 3]
    lb = torch.empty((n_sub, B), dtype=torch.float32, device=centers.device)
    step = _rows_per_chunk(n_sub, Tp)
    for s in range(0, n_sub, step):
        c = centers[s:s + step]
        dx = c[:, 0, None] - cen[0][None, :]
        dy = c[:, 1, None] - cen[1][None, :]
        dz = c[:, 2, None] - cen[2][None, :]
        d = torch.clamp_min(sqrt_f32(_sq3(dx, dy, dz)) - rad[None, :], 0.0)
        lb[s:s + step] = torch.amin(d.reshape(-1, B, Tp // B), dim=2)
    return lb


@spanned("query.culled.phase_a")
def _phase_a_topk(centers, bi: BlockIndex, *, kg: int):
    """Per-sub-tile ``kg`` nearest blocks and the excluded lower bound
    (``pallas_culled._phase_a_topk``, the gather engine's front end).
    Returns (idx (n_sub, kg) int32, pad id B after the real blocks;
    lb_excl (n_sub,) f32)."""
    B = bi.n_blocks
    n_sub = centers.shape[0]
    dev = centers.device
    if B <= kg:
        idx = torch.arange(kg, dtype=torch.int32, device=dev)
        idx = torch.where(idx < B, idx, B)[None, :].expand(n_sub, kg)
        return idx.contiguous(), torch.full((n_sub,), F32_MAX,
                                            dtype=torch.float32, device=dev)
    c_win = max(kg + 1, HIER_C)
    if B > 2 * c_win:
        return _phase_a_hier(centers, bi, c=c_win, kg=kg)
    lb = _phase_a_flat_lb(centers, bi)
    m = min(B, c_win)
    lb_all, idx_all = _smallest(lb, min(B, m + 1))
    lb_rest = (lb_all[:, m] if m < B else torch.full(
        (n_sub,), F32_MAX, dtype=torch.float32, device=dev))
    return _kg_tail(lb_all[:, :m], idx_all[:, :m], lb_rest, kg)


def _sub_tiles(q_pad, st: int):
    """Sub-tile centers (n_sub, 3) and half-diagonals (n_sub,)."""
    subs = q_pad.reshape(-1, st, 3)
    smin = torch.amin(subs, dim=1)
    smax = torch.amax(subs, dim=1)
    h = (smax - smin) * 0.5
    return (smin + smax) * 0.5, sqrt_f32(_sq3(h[:, 0], h[:, 1], h[:, 2]))


def _union_table(idx, n_qt: int, B: int, nb_table: int):
    """Per-tile sorted union of its sub-tiles' selections, duplicates →
    pad id B (sorted last), truncated to ``nb_table`` slots."""
    ids, _ = torch.sort(idx.reshape(n_qt, -1), dim=1)
    dup = torch.cat([torch.zeros((n_qt, 1), dtype=torch.bool,
                                 device=ids.device),
                     ids[:, 1:] == ids[:, :-1]], dim=1)
    tbl, _ = torch.sort(torch.where(dup, B, ids), dim=1)
    return tbl[:, :nb_table]


def _in_union(tbl, B: int):
    """(n_qt, B+1) bool: block b is in tile t's table."""
    n_qt = tbl.shape[0]
    m = torch.zeros((n_qt, B + 1), dtype=torch.bool, device=tbl.device)
    m[torch.arange(n_qt, device=tbl.device)[:, None], tbl] = True
    return m


@spanned("query.culled.phase_a")
def select_blocks(q_pad, bi: BlockIndex, *, nb_sub: int = DEFAULT_NB_SUB,
                  st: int = DEFAULT_ST, qt: int = DEFAULT_QT,
                  nb_table: int = DEFAULT_NB_TABLE):
    """Phase A of the union engine (``pallas_culled.select_blocks``), the
    sharded path's.

    q_pad: (Qp, 3) Morton-sorted queries, Qp % qt == 0, qt % st == 0.
    Returns (tbl (Qp/qt, ≤(qt/st)·nb_sub) int32 — sorted, duplicates and
    unused slots = ``bi.n_blocks``; lb_excl (Qp/st,) f32 — per sub-tile,
    the lower bound on the distance from its center to any block NOT in
    its tile's union; centers (Qp/st, 3)).
    """
    Qp = q_pad.shape[0]
    n_qt = Qp // qt
    spt = qt // st
    B = bi.n_blocks
    dev = q_pad.device
    centers, r_s = _sub_tiles(q_pad, st)

    if B >= max(HIER_MIN_BLOCKS, 2 * HIER_C):
        lb_c, idx_c, lb_rest = _phase_a_hier(centers, bi, c=HIER_C)
        k_sel = min(nb_sub, HIER_C)
        idx = idx_c[:, :k_sel]
        dmin = lb_c[:, 0]
        n_within = torch.sum(lb_c <= (dmin + 2.0 * r_s)[:, None], dim=1)
        keep = (torch.arange(k_sel, device=dev)[None, :]
                < torch.clamp_min(n_within, 1)[:, None])
        tbl = _union_table(torch.where(keep, idx, B), n_qt, B, nb_table)
        tile_of = torch.arange(n_qt, device=dev).repeat_interleave(spt)
        m = _in_union(tbl, B)[tile_of[:, None], idx_c]
        lb_excl = torch.minimum(
            _min_init(torch.where(m, F32_MAX, lb_c)), lb_rest)
        return tbl.to(torch.int32).contiguous(), lb_excl, centers

    lb = _phase_a_flat_lb(centers, bi)
    k_sel = min(nb_sub, B)
    _, idx = _smallest(lb, k_sel)
    dmin = torch.amin(lb, dim=1)
    n_within = torch.sum(lb <= (dmin + 2.0 * r_s)[:, None], dim=1)
    keep = (torch.arange(k_sel, device=dev)[None, :]
            < torch.clamp_min(n_within, 1)[:, None])
    tbl = _union_table(torch.where(keep, idx, B), n_qt, B, nb_table)
    in_union = _in_union(tbl, B)[:, :B].repeat_interleave(spt, dim=0)
    lb_excl = _min_init(torch.where(in_union, F32_MAX, lb))
    return tbl.to(torch.int32).contiguous(), lb_excl, centers


# ------------------------------------------------------------------- kernel
def segment_crossings(ap, ab, ac, dq):
    """Strict-interior Möller–Trumbore crossing of the segment q → anchor
    (direction ``dq`` = anchor − q) with each triangle, bool per pair
    (``culling.py:479-498``, ``pallas_culled.py:567-591``)."""
    apx, apy, apz = ap
    abx, aby, abz = ab
    acx, acy, acz = ac
    dxx, dyy, dzz = dq
    pvx = dyy * acz - dzz * acy
    pvy = dzz * acx - dxx * acz
    pvz = dxx * acy - dyy * acx
    det = abx * pvx + aby * pvy + abz * pvz
    inv = _rcp(det)
    u = (apx * pvx + apy * pvy + apz * pvz) * inv
    qvx = apy * abz - apz * aby
    qvy = apz * abx - apx * abz
    qvz = apx * aby - apy * abx
    vv = (dxx * qvx + dyy * qvy + dzz * qvz) * inv
    tt = (acx * qvx + acy * qvy + acz * qvz) * inv
    return ((det != 0.0) & (u > 0.0) & (vv > 0.0) & (u + vv < 1.0)
            & (tt > 0.0) & (tt < 1.0))


def culled_blocks_plain(queries, rows, tbl, *, group: int, n_blocks: int,
                        anchors=None):
    """Plain PyTorch version of :func:`culled_blocks` (any device): per
    slot, the groups whose slot holds a real block, in chunks."""
    COUNT.plain += 1
    n_groups, n_slots = tbl.shape
    tb = rows.shape[2]
    dev = queries.device
    qg = queries.reshape(n_groups, group, 3)
    ag = None if anchors is None else anchors.reshape(n_groups, group, 3)
    d2 = torch.full((n_groups, group), F32_MAX, dtype=torch.float32,
                    device=dev)
    cnt = torch.zeros((n_groups, group), dtype=torch.int32, device=dev)
    step = _rows_per_chunk(n_groups, group * tb)
    for j in range(n_slots):
        live = torch.nonzero(tbl[:, j] != n_blocks).reshape(-1)
        if live.numel() == 0:
            break  # pads are sorted last in every row
        for s in range(0, live.numel(), step):
            g = live[s:s + step]
            blk = rows[tbl[g, j].long()]  # (c, 9, tb)
            planes = [blk[:, k, None, :] for k in range(9)]
            q = qg[g]
            ap = tuple(q[:, :, k, None] - planes[k] for k in range(3))
            ab, ac = planes[3:6], planes[6:9]
            dd = dist2(*ap, *closest_point_vw(*ap, *ab, *ac))
            d2[g] = torch.minimum(d2[g], torch.amin(dd, dim=2))
            if ag is not None:
                a = ag[g]
                dq = tuple(a[:, :, k, None] - q[:, :, k, None]
                           for k in range(3))
                cnt[g] += torch.sum(segment_crossings(ap, ab, ac, dq),
                                    dim=2, dtype=torch.int32)
    return d2.reshape(-1), (None if ag is None else cnt.reshape(-1))


def _check(queries, rows, tbl, group, n_blocks, anchors):
    if queries.dtype != torch.float32 or queries.dim() != 2 or (
            queries.shape[1] != 3):
        raise ValueError(f"queries: want float32 (Q, 3), got "
                         f"{queries.dtype} {tuple(queries.shape)}")
    if rows.dtype != torch.float32 or rows.dim() != 3 or (
            rows.shape[1] != 9) or rows.shape[2] % 128 or (
            rows.shape[0] != n_blocks + 1):
        raise ValueError(f"rows: want float32 ({n_blocks + 1}, 9, tb) with "
                         f"tb % 128 == 0, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if tbl.dtype != torch.int32 or tbl.dim() != 2:
        raise ValueError(f"tbl: want int32 (n_groups, n_slots), got "
                         f"{tbl.dtype} {tuple(tbl.shape)}")
    if group <= 0 or queries.shape[0] != tbl.shape[0] * group:
        raise ValueError(f"{queries.shape[0]} queries are not "
                         f"{tbl.shape[0]} groups of {group}")
    if queries.shape[0] > MAX_QUERIES:
        raise ValueError(f"more than {MAX_QUERIES} queries")
    named = [("queries", queries), ("rows", rows), ("tbl", tbl)]
    if anchors is not None:
        if anchors.dtype != torch.float32 or anchors.shape != queries.shape:
            raise ValueError(f"anchors: want float32 {tuple(queries.shape)},"
                             f" got {anchors.dtype} {tuple(anchors.shape)}")
        named.append(("anchors", anchors))
    for name, t in named:
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{queries.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@spanned("query.culled.kernel")
def culled_blocks(queries, rows, tbl, *, group: int, n_blocks: int,
                  anchors=None):
    """Per query, the min squared distance over the triangles of its
    group's candidate blocks, and with ``anchors`` the query→anchor
    segment crossings.

    queries: (n_groups·group, 3) f32; rows: (n_blocks+1, 9, tb) f32 [a | ab
    | ac], pad row last; tbl: (n_groups, n_slots) int32 block ids, pad
    ``n_blocks`` after the real ones; anchors: None or like queries.
    Returns (d² (Q,) f32, counts (Q,) int32 or None). CUDA tensors launch
    ``csrc/culled.cu`` (group 16, 32, 64 or a multiple of 128) over the
    packed records of ``rows`` (:func:`table_records`); CPU tensors run
    :func:`culled_blocks_plain`.
    """
    _check(queries, rows, tbl, group, n_blocks, anchors)
    if queries.device.type == "cpu":
        return culled_blocks_plain(queries, rows, tbl, group=group,
                                   n_blocks=n_blocks, anchors=anchors)
    if queries.device.type != "cuda":
        raise ValueError(f"culled_blocks: no kernel for {queries.device}")
    if group not in KERNEL_GROUPS and group % 128:
        raise ValueError(f"culled_blocks: the kernel takes groups of "
                         f"{KERNEL_GROUPS} or multiples of 128, got {group}")
    records = table_records(rows)
    Q = queries.shape[0]
    d2 = torch.empty((Q,), dtype=torch.float32, device=queries.device)
    cnt = (None if anchors is None else
           torch.empty((Q,), dtype=torch.int32, device=queries.device))
    fn = _build.entry("m2s_culled_blocks", _ARGTYPES)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        COUNT.kernel += 1
        rc = fn(queries.data_ptr(),
                None if anchors is None else anchors.data_ptr(),
                records.data_ptr(), n_blocks, rows.shape[2], tbl.data_ptr(),
                tbl.shape[0], tbl.shape[1], group, d2.data_ptr(),
                None if cnt is None else cnt.data_ptr(), stream)
    _build.check(rc, "m2s_culled_blocks")
    return d2, cnt


def culled_dist(queries_sorted, bi: BlockIndex, tbl, *, anchors=None,
                qt: int = DEFAULT_QT):
    """Min distance per (Morton-sorted, qt-padded) query via its tile's
    candidate blocks (``culled_dist_pallas``): distances, or (distances,
    crossing counts) with ``anchors``. Roots in float64."""
    d2, cnt = culled_blocks(queries_sorted, bi.rows, tbl, group=qt,
                            n_blocks=bi.n_blocks, anchors=anchors)
    if anchors is None:
        return sqrt_f32(d2)
    return sqrt_f32(d2), cnt
