"""Slab-streamed grid SDF: grids too large for one resident CPT state.

PyTorch counterpart of the JAX package's ``gridgen_streamed.py``, its TPU
branch on every device (on the CPU the kernels' plain versions run, so the
CPU computes what the card computes). The grid is cut into x-slabs of
``slab_nx`` slices, and one slab's CPT state (four x-first volumes, 16 B
per cell) is on the device at a time:

- host prep (:func:`_stream_prep`, cached by content and device): the
  subdivision to 8 cells, per-slab seed bins padded to one row count, and
  per-slab line bins (:func:`build_slab_line_bins`);
- pass 1, left to right: per slab the seed, one round of six sweeps
  (``cpt.closest_point_grid``, the sweep kernel), the previous slab's right
  edge merged into row 0, the ±x sweeps (:func:`_x_sweeps`); each right
  edge stays on the device;
- pass 2, right to left: the same per slab with both neighbours' edges,
  then the sign (three axes of slab-local binned line parity, or the
  nearest triangle's normal side) and the fetch of the signed slab.

Edges hold ids only: an edge is the four (ny, nz) slices (d1, i1, d2, i2) of
a slab's first or last row. Merging one re-evaluates its triangles by id
(``SweepTris.tv``, the PAD row for id -1) at the row's centres with the
exact projection (``ops.geometry.point_triangle_distance``), as the JAX
package's ``_merge_eval`` does on the 9 vertex floats it carries.

On CUDA the fetch runs one slab behind the compute (:class:`_Fetch`): each
signed slab is copied with ``non_blocking=True`` into one of two pinned host
buffers on a side stream, after an event on the compute stream, and a
worker thread moves it into the result while the next slab computes.

Every parity kernel of the port is exact (no bucket limit), so the JAX
route's re-sign of an overflowing slab (``_drain``'s XLA
``_slab_sign_raycast``) has nothing to do here and is not ported.

Spans (``utils.profiling``, open while a profiler runs): ``stream.entry``
around a call; ``stream.prep`` with ``stream.prep.key`` and, on a cache
miss, ``.subdivide``, ``.line_bins``, ``.seed_bins`` and ``.upload``;
``stream.pass_one`` and ``stream.pass_two``, in whose slab passes
``stream.seed``, ``stream.sweep`` (the six sweeps, the ±x sweeps) and
``stream.edges`` (the runner-up reset, both merges, the edge copies) open;
``stream.sign``; ``stream.fetch``. ``sync.stream.fetch.staging``,
``.drain`` and ``.synchronize`` mark the host's waits on the card in the
fetch; the sign's waits are the grid's (``sync.grid.centers.*``).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .grid import Grid
from .intake import cached, content_key, resolve_device
from .ops import cpt
from .ops.geometry import point_triangle_distance
from .ops.kernels import parity, sweep
from .topology import as_points
from .types import F32_MAX, SignMethod
from .utils.profiling import span, spanned, sync_span

#: Content-keyed prep cache (seed bins, line bins and the soup on the
#: device), per (mesh, grid, slab_nx, sign, device); at most two entries.
_STREAM_PREP_CACHE: dict = {}
_STREAM_PREP_CACHE_MAX = 2
#: The widest slab of the route's rule: one slab's CPT state takes 16 B a
#: cell, 268 MB at 64 × 512².
MAX_SLAB_NX = 64


class Edge(NamedTuple):
    """One (ny, nz) row of a slab's state: each cell's best and runner-up
    distinct triangles as (distance, id), id -1 for none."""

    d1: torch.Tensor
    i1: torch.Tensor
    d2: torch.Tensor
    i2: torch.Tensor


def _empty_edge(ny: int, nz: int, device) -> Edge:
    d = torch.full((ny, nz), F32_MAX, dtype=torch.float32, device=device)
    i = torch.full((ny, nz), -1, dtype=torch.int32, device=device)
    return Edge(d, i, d, i)


def slab_grids(grid: Grid, slab_nx: int) -> list:
    """The x-slabs of ``grid``, first cells ``fc + [i·slab_nx, 0, 0]·cs`` in
    numpy float32 as the JAX package computes them; the seeds, sweeps and
    parity of a slab all read these same values."""
    nx, ny, nz = grid.cell_count
    fc = grid.first_cell.numpy().astype(np.float32)
    cs = grid.cell_size.numpy().astype(np.float32)
    return [Grid.new(fc + np.asarray([i * slab_nx, 0, 0], np.float32) * cs,
                     cs, (slab_nx, ny, nz))
            for i in range(nx // slab_nx)]


def build_slab_line_bins(grid: Grid, slab_nx: int, n_slabs: int, oa, ob, oc,
                         *, device=None) -> list:
    """Per-slab parity candidate tables (numpy soup in, tensors on
    ``device`` out): a list of per-slab 3-tuples of ``parity.LineBins``.

    Axis 0 (x rays): the (y, z) line lattice is the same for every slab, so
    one table serves all. Axes 1 and 2 cover the slab's x-range: per-slab
    tables, padded to a common width with the pad block id ``n_blocks``
    (which the hit pass skips). The packed planes do not depend on the grid,
    so the slabs of an axis share one ``rows`` tensor.
    """
    slabs = slab_grids(grid, slab_nx)[:n_slabs]
    bins0 = parity.build_line_bins(slabs[0], 0, oa, ob, oc, device=device)
    per_axis = []
    for axis in (1, 2):
        host = [parity.build_line_bins(s, axis, oa, ob, oc) for s in slabs]
        width = max(b.tbl.shape[1] for b in host)
        rows = host[0].rows.to(device)
        per_axis.append([dataclasses.replace(
            b, rows=rows, tbl=F.pad(b.tbl, (0, width - b.tbl.shape[1]),
                                    value=b.n_blocks).to(device))
            for b in host])
    return [(bins0, a1, a2) for a1, a2 in zip(*per_axis)]


class _StreamPrep(NamedTuple):
    """Device-resident prep of one (mesh, grid, slab_nx, sign, device).

    tris: (3, T, 3) subdivided soup; sweep_tris: its packed records; slabs:
    per-slab Grids (:func:`slab_grids`); seeds: per-slab ``cpt.SeedBins``,
    padded to one row count and one shift-round count; line_bins: per-slab
    LineBins triples (RAYCAST only).
    """

    tris: torch.Tensor
    sweep_tris: sweep.SweepTris
    slabs: list
    seeds: list
    line_bins: Optional[list]


@spanned("stream.prep")
def _stream_prep(grid: Grid, slab_nx: int, v_np, faces, want_line_bins: bool,
                 device) -> _StreamPrep:
    """``v_np``: (V, 3) float32, ``faces``: (F, 3) integers as the caller
    gave them, both C-contiguous; the key hashes their buffers in place
    (``intake.content_key``: a hit copies and converts nothing)."""
    with span("stream.prep.key"):
        key = content_key(v_np, faces) + (
            tuple(grid.first_cell.tolist()), tuple(grid.cell_size.tolist()),
            tuple(grid.cell_count), slab_nx, want_line_bins, str(device),
        )
    return cached(_STREAM_PREP_CACHE, key, lambda: _build_stream_prep(
        grid, slab_nx, v_np, faces, want_line_bins, device),
        _STREAM_PREP_CACHE_MAX)


def _build_stream_prep(grid: Grid, slab_nx: int, v_np, faces,
                       want_line_bins: bool, device) -> _StreamPrep:
    """:func:`_stream_prep`'s value on a miss."""
    f_np = faces.astype(np.int64)
    _, ny, nz = grid.cell_count
    cs = float(np.max(np.abs(grid.cell_size.numpy())))
    with span("stream.prep.subdivide"):
        # Binned seeds cover the AABB ±pad exactly for any triangle size;
        # the 8-cell cap only bounds the rasterized seed volume.
        ra, rb, rc = cpt.subdivide_to_span(v_np, f_np, max_edge=8.0 * cs)
    slabs = slab_grids(grid, slab_nx)
    line_bins = None
    if want_line_bins:
        with span("stream.prep.line_bins"):
            line_bins = build_slab_line_bins(
                grid, slab_nx, len(slabs), v_np[f_np[:, 0]],
                v_np[f_np[:, 1]], v_np[f_np[:, 2]], device=device)

    with span("stream.prep.seed_bins"):
        # The pad comes from the whole grid, as the JAX package's does.
        pad = cpt.seed_pad_for(grid)
        host = [cpt.build_seed_bins(s, ra, rb, rc, k=8, pad=pad)
                for s in slabs]
    T, n_slab = len(ra), slab_nx * ny * nz
    r_max = max(b.entry_tri.shape[1] for b in host)
    n_rounds = max(b.n_shift_rounds for b in host)
    seeds = []
    with span("stream.prep.upload"):
        tris = torch.from_numpy(np.stack([ra, rb, rc])).to(device)
        while host:
            b = host.pop(0)  # free the host copy as each slab is uploaded
            r = b.entry_tri.shape[1]
            entry = np.full((b.entry_tri.shape[0], r_max), T, np.int32)
            entry[:, :r] = b.entry_tri
            rows = np.full((r_max,), n_slab, np.int32)
            rows[:r] = b.rows_cell
            seeds.append(cpt.SeedBins(
                torch.from_numpy(entry).to(device),
                torch.from_numpy(rows).to(device),
                torch.from_numpy(b.cell_row).to(device), n_rounds))
        return _StreamPrep(tris, sweep.sweep_tris(*tris), slabs, seeds,
                           line_bins)


def _row_centres(slab: Grid, position: int, device) -> torch.Tensor:
    """(ny, nz, 3) centres of slab row ``position`` (negative counts from
    the end), bit-equal to ``slab.all_cell_centers()[position]``: the same
    float32 ``fc + i·cs``, from host scalars (no host-to-device copy)."""
    nx, ny, nz = slab.cell_count
    fc = slab.first_cell.numpy()
    cs = slab.cell_size.numpy()
    x = float(fc[0] + np.float32(position % nx) * cs[0])
    y = torch.arange(ny, dtype=torch.float32, device=device) * float(cs[1])
    z = torch.arange(nz, dtype=torch.float32, device=device) * float(cs[2])
    y = y + float(fc[1])
    z = z + float(fc[2])
    return torch.stack([
        torch.full((ny, nz), x, dtype=torch.float32, device=device),
        y[:, None].expand(ny, nz), z[None, :].expand(ny, nz)], dim=-1)


def _merge(d1, i1, d2, i2, d, i):
    """Insert candidate (d, i), keeping the two best with distinct ids
    (the JAX package's ``cpt._merge`` without the vertex slots)."""
    same1 = i == i1
    b1 = d < d1
    promote = b1 & ~same1  # the old best becomes the runner-up
    cand2 = ~b1 & ~same1 & (d < d2)
    return (torch.where(b1, d, d1), torch.where(b1, i, i1),
            torch.where(promote, d1, torch.where(cand2, d, d2)),
            torch.where(promote, i1, torch.where(cand2, i, i2)))


def _merge_edge(state, edge: Edge, position: int, slab: Grid, tv):
    """Merge a neighbour's edge into row ``position`` of the state, in
    place: each edge slot's triangle is read by id from ``tv`` ((T + 1, 9),
    the PAD row last, for id -1) and evaluated exactly at the row's centres
    (the JAX package's ``_merge_edge`` / ``_merge_eval``)."""
    centres = _row_centres(slab, position, tv.device)
    T = tv.shape[0] - 1
    row = tuple(t[position] for t in state)
    for ids in (edge.i1, edge.i2):
        v = tv[torch.where(ids < 0, T, ids).long()]  # (ny, nz, 9)
        d = point_triangle_distance(centres, v[..., 0:3], v[..., 3:6],
                                    v[..., 6:9])
        row = _merge(*row, d, ids)
    for dst, src in zip(state, row):
        dst[position].copy_(src)
    return state


def _x_sweeps(state, tris: sweep.SweepTris, slab: Grid):
    """The ±x sweeps of a slab's state, in place: two sweep launches along
    x, forward then reverse (the JAX package's ``_x_sweeps_pallas``,
    ``parallel/grid_sharded.py``; the state is x-first, so no relayout)."""
    for rev in (False, True):
        sweep.sweep_axis(*state, tris, rev, slab.first_cell, slab.cell_size,
                         axis=0)
    return state


def _edge(state, position: int) -> Edge:
    return Edge(*(t[position].clone() for t in state))


def _slab_pass(prep: _StreamPrep, i: int, left: Edge, right: Edge):
    """CPT on slab ``i`` with the incoming edges (``_empty_edge`` for none):
    the seed, one round of six sweeps, the runner-up reset (as the JAX
    package's ``_state_from``), the left edge merged into row 0 and the
    right one into row -1, the ±x sweeps. Returns (state [d1, i1, d2, i2],
    right edge, left edge)."""
    slab = prep.slabs[i]
    ta, tb, tc = prep.tris
    with span("stream.seed"):
        seed = cpt.seed_from_bins(slab, ta, tb, tc, prep.seeds[i],
                                  prep.sweep_tris)
    with span("stream.sweep"):
        d1, i1 = cpt.closest_point_grid(slab, ta, tb, tc, seed=seed,
                                        rounds=1, tris=prep.sweep_tris)
    del seed
    with span("stream.edges"):
        state = [d1, i1, torch.full_like(d1, F32_MAX),
                 torch.full_like(i1, -1)]
        _merge_edge(state, left, 0, slab, prep.sweep_tris.tv)
        _merge_edge(state, right, -1, slab, prep.sweep_tris.tv)
    with span("stream.sweep"):
        _x_sweeps(state, prep.sweep_tris, slab)
    with span("stream.edges"):
        edges = _edge(state, -1), _edge(state, 0)
    return (state,) + edges


@spanned("stream.sign")
def _slab_sign(prep: _StreamPrep, i: int, state, sign: SignMethod):
    """The signed (slab_nx, ny, nz) distances of slab ``i``. RAYCAST: three
    axes of binned line parity over the slab's own lattice; the hit pass
    counts hits past the slab in its last cell, so each suffix count sees
    the whole mesh. NORMAL: the nearest triangle's normal side."""
    slab = prep.slabs[i]
    d1 = state[0]
    if sign == SignMethod.NORMAL:
        return cpt.normal_sign_from_idx(slab, *prep.tris, d1, state[1])
    inside, _ = parity.grid_inside_mask(slab, prep.line_bins[i], axes=3)
    return torch.where(inside, -d1, d1)


class _Fetch:
    """Moves signed slabs into the host result ``(nx, ny, nz)``.

    On the CPU a slab is copied in place. On CUDA the copy is enqueued on a
    side stream after an event on the compute stream, into one of two
    pinned buffers (a non-blocking copy into pageable memory would run
    synchronously), and ``worker`` moves the buffer into the result once
    the copy is done, while the compute stream goes on with the next slab.
    The source slab is kept for the side stream (``record_stream``).
    ``copies`` holds each slab's (ready, done) events, for timing. Each wait
    of the host on a slab's copy (for its staging buffer, or at the end) is
    marked ``sync.stream.fetch.*``.
    """

    def __init__(self, result, slab_nx: int, device, worker):
        self.result, self.slab_nx, self.worker = result, slab_nx, worker
        self.device = device
        self.cuda = device.type == "cuda"
        self.copies = []
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.stream = torch.cuda.Stream(device)
            shape = (slab_nx,) + tuple(result.shape[1:])
            self.staging = [torch.empty(shape, dtype=torch.float32,
                                        pin_memory=True) for _ in range(2)]
            self.drains = [None, None]

    @staticmethod
    def _drain(done, buf, rows):
        done.synchronize()
        rows.copy_(buf)

    def put(self, i: int, signed: torch.Tensor) -> None:
        rows = self.result[i * self.slab_nx:(i + 1) * self.slab_nx]
        if not self.cuda:
            rows.copy_(signed)
            return
        k = len(self.copies) % 2
        if self.drains[k] is not None:
            # The buffer's previous slab has left.
            with sync_span("sync.stream.fetch.staging", self.device):
                self.drains[k].result()
        ready = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        ready.record(self.compute)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            self.staging[k].copy_(signed, non_blocking=True)
            signed.record_stream(self.stream)
            done.record(self.stream)
        self.copies.append((ready, done))
        self.drains[k] = self.worker.submit(self._drain, done,
                                            self.staging[k], rows)

    def wait(self) -> None:
        """Until every slab is in the result and the compute stream has
        drained."""
        if not self.cuda:
            return
        for d in self.drains:
            if d is not None:
                with sync_span("sync.stream.fetch.drain", self.device):
                    d.result()
        with sync_span("sync.stream.fetch.synchronize", self.device):
            self.compute.synchronize()


def _result(out, shape) -> torch.Tensor:
    """The host result as a (nx, ny, nz) view of ``out`` (numpy array or
    CPU tensor, (N,) or (nx, ny, nz) float32, contiguous), or a new one."""
    n = int(np.prod(shape))
    if out is None:
        return torch.empty(shape, dtype=torch.float32)
    t = torch.from_numpy(out) if isinstance(out, np.ndarray) else out
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or t.device.type != "cpu" or not t.is_contiguous()
            or tuple(t.shape) not in ((n,), tuple(shape))):
        raise ValueError(f"out: want a contiguous float32 host array of "
                         f"({n},) or {tuple(shape)}")
    return t.view(shape)


def default_slab_nx(nx: int) -> int:
    """The route's slab width: the widest of at most ``MAX_SLAB_NX`` slices
    that divides nx (nx itself up to 64, 64 for a multiple of 64, 50 for
    100; a prime nx above 64 streams one slice at a time)."""
    return max(w for w in range(1, min(MAX_SLAB_NX, nx) + 1) if nx % w == 0)


def generate_grid_sdf_streamed(
    vertices,
    faces,
    grid: Grid,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    slab_nx: Optional[int] = None,
    out=None,
    device=None,
) -> torch.Tensor:
    """``generate_grid_sdf`` through the CPT route for grids too large for
    one resident CPT state, or whose flat index passes int32 (the JAX
    package's function of this name; ``generate_grid_sdf(..., out=)`` runs
    the same stream).

    ``vertices`` (V, 3) and ``faces`` (F, 3): arrays or tensors.
    ``slab_nx`` (default :func:`default_slab_nx`) must divide nx. Runs on
    ``device`` when given, else on the device of a ``vertices`` tensor,
    else on CUDA (a host without CUDA then raises). Returns the flat x-major
    float32 field as a CPU tensor; ``out``, a (nx·ny·nz,) or (nx, ny, nz)
    float32 numpy array or CPU tensor, receives it and is what the result
    views.
    """
    nx = grid.cell_count[0]
    if slab_nx is None:
        slab_nx = default_slab_nx(nx)
    if nx % slab_nx:
        raise ValueError(f"nx={nx} must be a multiple of slab_nx={slab_nx}")
    device = resolve_device(device, vertices)
    if hasattr(faces, "detach"):
        faces = faces.detach().cpu().numpy()
    return _stream(as_points(vertices), np.asarray(faces), grid, sign_method,
                   _result(out, grid.cell_count), slab_nx, device)


@spanned("stream.entry")
def _stream(vertices: np.ndarray, faces: np.ndarray, grid: Grid,
            sign_method: SignMethod, result: torch.Tensor, slab_nx: int,
            device) -> torch.Tensor:
    """The stream into ``result`` ((nx, ny, nz), checked by
    :func:`_result`), in slabs of ``slab_nx`` (which divides nx) on
    ``device``; returns its flat view. ``vertices`` (V, 3) float32 and
    ``faces`` (F, 3) integers are host arrays."""
    nx, ny, nz = grid.cell_count
    n_slabs = nx // slab_nx
    v_np = np.ascontiguousarray(vertices)
    faces = np.ascontiguousarray(faces).reshape(-1, 3)
    prep = _stream_prep(grid, slab_nx, v_np, faces,
                        sign_method == SignMethod.RAYCAST, device)
    empty = _empty_edge(ny, nz, device)

    # Pass 1, left to right: each slab's right edge, kept on the device.
    right_edges = []
    carry = empty
    with span("stream.pass_one"):
        for i in range(n_slabs):
            _, carry, _ = _slab_pass(prep, i, carry, empty)
            right_edges.append(carry)

    # Pass 2, right to left: the final state of each slab, signed and
    # fetched one slab behind the compute.
    carry = empty
    with span("stream.pass_two"), \
            ThreadPoolExecutor(max_workers=1) as worker:
        fetch = _Fetch(result, slab_nx, device, worker)
        for i in reversed(range(n_slabs)):
            left = right_edges[i - 1] if i > 0 else empty
            state, _, carry = _slab_pass(prep, i, left, carry)
            signed = _slab_sign(prep, i, state, sign_method)
            del state
            with span("stream.fetch"):
                fetch.put(i, signed)
            del signed
        with span("stream.fetch"):
            fetch.wait()
    return result.reshape(-1)
