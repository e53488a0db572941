"""`generate_grid_sdf` — signed distance field on a regular grid.

PyTorch counterpart of the JAX package's ``gridgen.py``. Routes:

- **CPT** (the reference flagship, `mesh_to_sdf/src/generate/grid.rs:265-378`):
  host prep (:func:`_cpt_prep`, cached by content: subdivision bound, seed
  bins, per-axis line bins), then on the inputs' device
  :func:`ops.cpt.seed_from_bins` (the seed kernel), six directional sweeps
  per round through the sweep kernel, and the sign: three axes of binned
  line parity through the parity kernel (RAYCAST) or the nearest triangle's
  normal side (NORMAL). O(cells + triangles); never undershoots, ≤2%
  far-field error.
- **PALLAS**: the fused distance kernels at every cell center
  (``ops.kernels.sdf``), exact.
- **XLA**: the brute-force engine at every cell center (``ops.brute``),
  exact.
- **CULLED** (also ``exact=True`` in place of AUTO or CPT): per 8³-cell
  tile the top-k triangles by exact distance (``ops.culling``), exact.
- **AUTO**: the JAX package's cost model (:func:`_auto_constants`, which
  :func:`calibrate_auto` can measure on the device): CPT when
  its fixed overhead plus O(cells) cost beats the dense O(cells·triangles)
  one, else the dense route of the device (PALLAS on CUDA, XLA elsewhere).

Given ``out``, a host buffer, the CPT route runs slab by slab
(:mod:`gridgen_streamed`) and writes the field into it, as the reference's
``Vec<f32>`` in host memory, with one slab's state on the device at a time.

The dense and culled routes take the RAYCAST sign from dense line parity
(``ops.raycast.grid_inside_mask``). Every parity kernel of the port is exact
(no bucket limit), so the JAX route's overflow re-sign (``_exact_resign``)
has nothing to do here.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from . import gridgen_streamed
from .grid import Grid
from .intake import (cached, content_key, dense_strategy, points_on_host,
                     prepare_triangles, resolve_device, resolve_strategy)
from .ops import brute, cpt, culling, raycast
from .ops.kernels import parity, sdf, sweep
from .topology import (Topology, as_points, expand_triangles,
                       gather_triangle_vertices)
from .types import F32_MAX, AccelerationMethod, SignMethod, Strategy
from .utils.profiling import span, spanned

#: AUTO cost model per device type: (dense-engine pairs/s, CPT fixed
#: overhead s, CPT cells/s). "cpu" keeps the JAX package's coarse numbers
#: (`gridgen.py:45-48`). "cuda" was measured by chip_smoke.py on one
#: NVIDIA H100 80GB HBM3 at a 700 W power limit, with the CPT sweep run in
#: place by one launch per directional sweep: the PALLAS grid route at 128³
#: on icosphere(5) gives the pairs/s (0.1544 s warm), the CPT route at 128³
#: and 256³ (0.0307 s, 0.0536 s warm) the overhead and cells/s.
#: Overridable by environment (M2S_AUTO_DENSE_PAIRS_PER_S /
#: M2S_AUTO_CPT_OVERHEAD_S / M2S_AUTO_CPT_CELLS_PER_S) or by a measurement
#: on the device (:func:`calibrate_auto`, opt-in via M2S_AUTO_CALIBRATE=1).
_AUTO_DEFAULTS = {
    "cuda": (2.7814e11, 0.0274, 6.3925e8),
    "cpu": (2.0e8, 0.05, 5.0e6),
}

#: The "cuda" defaults as module constants, as the JAX package keeps its
#: v5e ones (prefer :func:`_auto_constants`).
AUTO_DENSE_PAIRS_PER_S, AUTO_CPT_OVERHEAD_S, AUTO_CPT_CELLS_PER_S = (
    _AUTO_DEFAULTS["cuda"])
#: The calibration's workload: icosphere(CAL_LEVEL) (5 120 triangles), the
#: dense route at CAL_DENSE_CELLS³, the CPT route at both CAL_CPT_CELLS³.
CAL_LEVEL = 4
CAL_DENSE_CELLS = 48
CAL_CPT_CELLS = (48, 96)
#: In-process calibrations by device key (see :func:`calibrate_auto`).
_AUTO_CAL_CACHE: dict = {}

#: Cache of CPT host prep (subdivision, seed bins, line bins), held on the
#: device: repeated calls on the same mesh/grid skip the host rasterization
#: and the upload. Keyed by ``intake.content_key`` of the soup, the grid
#: and the device; tiny FIFO.
_CPT_PREP_CACHE: dict = {}
_CPT_PREP_CACHE_MAX = 4


def _auto_cal_path() -> str:
    root = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(root, "mesh_to_sdf_tpu_torch", "auto_cal.json")


def _device_key(device: torch.device) -> str:
    """``cuda:<device name>`` for a card, else the device type."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate_auto(force: bool = False, *, device=None):
    """One-shot measurement of the AUTO cost-model constants on ``device``
    (default CUDA).

    Times the dense route (PALLAS on CUDA, XLA elsewhere; pairs/s) on
    icosphere(4) at 48³ and the CPT route at 48³ and 96³, to split its fixed
    overhead from its per-cell throughput; each warm, after one call.
    Results persist to ``$XDG_CACHE_HOME/mesh_to_sdf_tpu_torch/
    auto_cal.json`` (default ``~/.cache``), keyed ``cuda:<device name>``,
    so the cost is paid once per machine. A measurement that fails raises.
    Returns (dense_pairs_per_s, cpt_overhead_s, cpt_cells_per_s).
    """
    import json
    import time

    from .utils.meshgen import icosphere

    device = resolve_device(device)
    key = _device_key(device)
    path = _auto_cal_path()
    if not force:
        if key in _AUTO_CAL_CACHE:
            return _AUTO_CAL_CACHE[key]
        try:
            with open(path) as f:
                disk = json.load(f)
        except (OSError, ValueError):
            disk = {}
        if key in disk:
            _AUTO_CAL_CACHE[key] = tuple(disk[key])
            return _AUTO_CAL_CACHE[key]

    v, f = icosphere(CAL_LEVEL)
    topo = Topology.triangle_list(f.reshape(-1))
    lo, hi = v.min(axis=0) - 0.3, v.max(axis=0) + 0.3

    def timed(strategy, cells):
        g = Grid.from_bounding_box(lo, hi, [cells] * 3)

        def run():
            generate_grid_sdf(v, topo, g, SignMethod.RAYCAST,
                              strategy=strategy, device=device)
            _sync(device)

        run()  # builds the kernels and the host prep
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0

    t_dense = timed(dense_strategy(device), CAL_DENSE_CELLS)
    dense_pairs = CAL_DENSE_CELLS**3 * len(f) / max(t_dense, 1e-6)
    cells_a, cells_b = (c**3 for c in CAL_CPT_CELLS)
    t_cpt_a = timed(Strategy.CPT, CAL_CPT_CELLS[0])
    t_cpt_b = timed(Strategy.CPT, CAL_CPT_CELLS[1])
    slope = max((t_cpt_b - t_cpt_a) / (cells_b - cells_a), 1e-12)
    out = (float(dense_pairs), float(max(t_cpt_a - cells_a * slope, 0.0)),
           float(1.0 / slope))
    _AUTO_CAL_CACHE[key] = out
    os.makedirs(os.path.dirname(path), exist_ok=True)
    disk = {}
    if os.path.exists(path):
        with open(path) as fh:
            disk = json.load(fh)
    disk[key] = list(out)
    with open(path, "w") as fh:
        json.dump(disk, fh)
    return out


def _auto_constants(device: torch.device):
    """(dense_pairs_per_s, cpt_overhead_s, cpt_cells_per_s) for this device:
    environment override > the opt-in calibration (M2S_AUTO_CALIBRATE=1,
    :func:`calibrate_auto`, which raises if it fails) > a calibration made
    in this process > per-device-type defaults."""
    base = _AUTO_DEFAULTS.get(device.type, _AUTO_DEFAULTS["cpu"])
    if os.environ.get("M2S_AUTO_CALIBRATE") == "1":
        base = calibrate_auto(device=device)
    elif _AUTO_CAL_CACHE:
        base = _AUTO_CAL_CACHE.get(_device_key(device), base)
    env = os.environ
    return (
        float(env.get("M2S_AUTO_DENSE_PAIRS_PER_S", base[0])),
        float(env.get("M2S_AUTO_CPT_OVERHEAD_S", base[1])),
        float(env.get("M2S_AUTO_CPT_CELLS_PER_S", base[2])),
    )


def _auto_route(n_tris: int, n_cells: int, device) -> Strategy:
    """The JAX AUTO rule (`gridgen.py:362-372`): the dense engine is
    O(cells·tris), CPT O(cells) plus a fixed overhead."""
    dense_pairs, cpt_overhead, cpt_cells = _auto_constants(device)
    dense_cost = n_cells * max(n_tris, 1) / dense_pairs
    cpt_cost = cpt_overhead + n_cells / cpt_cells
    return Strategy.CPT if cpt_cost < dense_cost else dense_strategy(device)


def _cpt_prep_key(grid: Grid, ha, hb, hc, device) -> tuple:
    """The :data:`_CPT_PREP_CACHE` key of the soup (ha, hb, hc) on ``grid``
    and ``device``."""
    return content_key(ha, hb, hc) + (
        tuple(grid.first_cell.tolist()),
        tuple(grid.cell_size.tolist()),
        tuple(int(c) for c in grid.cell_count),
        str(device),
    )


def _cached_cpt_prep(vertices, topology: Topology, grid: Grid, device):
    """The :data:`_CPT_PREP_CACHE` entry that a CPT-route call
    ``generate_grid_sdf(vertices, topology, grid)`` on ``device`` made or
    used, or None."""
    ha, hb, hc = gather_triangle_vertices(as_points(vertices), topology)
    return _CPT_PREP_CACHE.get(_cpt_prep_key(grid, ha, hb, hc, device))


@spanned("grid.prep")
def _cpt_prep(grid: Grid, ha, hb, hc, device):
    """(stacked soup (3,T,3), SeedBins, per-axis LineBins), all on
    ``device`` — cached by content. Line bins are built on the ORIGINAL
    soup: parity is subdivision-invariant."""
    with span("grid.prep.key"):
        key = _cpt_prep_key(grid, ha, hb, hc, device)
    return cached(_CPT_PREP_CACHE, key,
                  lambda: _build_cpt_prep(grid, ha, hb, hc, device),
                  _CPT_PREP_CACHE_MAX)


def _build_cpt_prep(grid: Grid, ha, hb, hc, device):
    """:func:`_cpt_prep`'s value on a miss."""
    max_edge = 8.0 * float(np.max(np.abs(
        grid.cell_size.detach().cpu().numpy())))
    tris_np = np.ascontiguousarray(np.stack([ha, hb, hc], axis=1))
    with span("grid.prep.subdivide"):
        edges = np.linalg.norm(tris_np - np.roll(tris_np, 1, axis=1), axis=2)
        if float(edges.max()) > max_edge:
            # Bound a giant triangle's rasterized seed volume
            # (surface-identical ⇒ distances/sign unchanged).
            ra, rb, rc = cpt.subdivide_to_span(
                tris_np.reshape(-1, 3),
                np.arange(3 * len(ha), dtype=np.int64).reshape(-1, 3),
                max_edge=max_edge,
            )
        else:
            ra, rb, rc = tris_np[:, 0], tris_np[:, 1], tris_np[:, 2]
    with span("grid.prep.seed_bins"):
        bins = cpt.build_seed_bins(grid, ra, rb, rc,
                                   pad=cpt.seed_pad_for(grid))
    with span("grid.prep.line_bins"):
        line_bins = tuple(
            parity.build_line_bins(grid, axis, tris_np[:, 0], tris_np[:, 1],
                                   tris_np[:, 2], device=device)
            for axis in range(3)
        )
    with span("grid.prep.upload"):
        return (
            torch.from_numpy(np.stack([ra, rb, rc])).to(device),
            cpt.SeedBins(
                torch.from_numpy(bins.entry_tri).to(device),
                torch.from_numpy(bins.rows_cell).to(device),
                torch.from_numpy(bins.cell_row).to(device),
                bins.n_shift_rounds,
            ),
            line_bins,
        )


def _cpt_grid_signed(grid: Grid, tris, bins, line_bins, *, sign,
                     raycast_axes: int, sweep_rounds: int):
    """CPT distance + sign for one grid, (nx, ny, nz)."""
    ra, rb, rc = tris[0], tris[1], tris[2]
    records = sweep.sweep_tris(ra, rb, rc)  # shared by the seed and sweeps
    seed = cpt.seed_from_bins(grid, ra, rb, rc, bins, records)
    dist3, idx3 = cpt.closest_point_grid(grid, ra, rb, rc, seed=seed,
                                         rounds=sweep_rounds, tris=records)
    if sign == SignMethod.NORMAL:
        # The nearest triangle's normal side — the reference Rtree
        # backend's semantics (`rtree.rs:96-126`).
        return cpt.normal_sign_from_idx(grid, ra, rb, rc, dist3, idx3)
    inside, _ = parity.grid_inside_mask(grid, line_bins, axes=raycast_axes)
    return torch.where(inside, -dist3, dist3)


def _dense_grid_signed(grid: Grid, vertices, topology, device, *, strategy,
                       sign, raycast_axes: int, tri_block: int,
                       query_chunk: int):
    """XLA, PALLAS or CULLED distance at every cell center, signed by the
    normal champions (NORMAL) or by dense line parity (RAYCAST);
    (nx, ny, nz)."""
    ta, tb, tc, valid, n_tris = prepare_triangles(vertices, topology,
                                                  tri_block, device)
    centers = grid.all_cell_centers(device).reshape(-1, 3)
    N = centers.shape[0]
    if strategy == Strategy.CULLED:
        dist = culling.grid_distance_culled(grid, ta, tb, tc, valid,
                                            sign=sign)
    elif strategy == Strategy.PALLAS:
        ra, rb, rc = ta[:n_tris], tb[:n_tris], tc[:n_tris]
        if sign == SignMethod.NORMAL:
            dist = sdf.sdf_normal(centers, ra, rb, rc)
        else:
            # Unsigned only; the sign comes from line parity below.
            dist = sdf.sdf_raycast(centers, ra, rb, rc, raycast_axes=0)
    else:
        chunk = min(query_chunk, N)
        pad = (-N) % chunk
        if pad:
            centers = torch.cat([centers, torch.zeros(
                (pad, 3), dtype=torch.float32, device=device)])
        dist = brute.sdf_brute(
            centers, ta, tb, tc, valid, sign_method=sign, raycast_axes=0,
            tri_block=tri_block, query_chunk=chunk)[:N]
    dist3 = dist.reshape(grid.cell_count)
    if sign == SignMethod.NORMAL:
        return dist3
    inside = raycast.grid_inside_mask(grid, ta, tb, tc, valid,
                                      axes=raycast_axes)
    return torch.where(inside, -dist3, dist3)


def _check_streamed(strategy: Strategy, raycast_axes: int) -> None:
    """Raise unless a call given ``out`` takes the streamed CPT route."""
    if strategy != Strategy.CPT:
        raise ValueError(f"out: only the CPT route streams into a host "
                         f"buffer, not {strategy.name}; pass "
                         f"strategy=Strategy.CPT")
    if raycast_axes != 3:
        raise ValueError("out: the streamed CPT route votes over 3 ray "
                         f"axes, not raycast_axes={raycast_axes}")


@spanned("grid.entry")
def generate_grid_sdf(
    vertices,
    topology: Optional[Topology],
    grid: Grid,
    sign_method: SignMethod = SignMethod.RAYCAST,
    *,
    strategy: Union[Strategy, AccelerationMethod, None] = None,
    raycast_axes: int = 3,
    tri_block: int = brute.DEFAULT_TRI_BLOCK,
    query_chunk: int = brute.DEFAULT_QUERY_CHUNK,
    flat: bool = True,
    exact: bool = False,
    device=None,
    out=None,
) -> torch.Tensor:
    """SDF at every cell center of ``grid``.

    Returns float32 distances on ``device`` when given, else on the device
    of ``vertices`` when they are a tensor, else on CUDA (a host without
    CUDA then raises), flattened in the reference's x-major/z-fastest
    layout (`grid.rs:122-124`) when ``flat=True``, else shaped (nx, ny,
    nz). Positive outside, negative inside (`grid.rs:199-232`).

    ``raycast_axes``: 3 (default) = best-of-3 axis parity voting
    (`grid.rs:622-639`); 1 = single +X parity. ``tri_block`` and
    ``query_chunk`` tile the XLA route.

    Routes: AUTO, CPT, PALLAS, XLA and CULLED, each with both sign methods.
    ``exact=True`` replaces AUTO's and CPT's approximate route by the exact
    CULLED one (`grid.rs:692-724`'s bar at any grid size).

    ``out``: a contiguous float32 numpy array or CPU tensor of nx·ny·nz
    cells, flat or (nx, ny, nz). The CPT route (asked for, or AUTO, which
    then takes it whatever the grid's size) computes the field slab by slab
    on ``device`` into ``out`` (:mod:`gridgen_streamed` in slabs of
    ``default_slab_nx(nx)``, so the device holds one slab's state) and
    returns a view of ``out``. Another route, ``exact=True``, or
    ``raycast_axes`` other than 3 raises ``ValueError``.
    """
    strategy, sign = resolve_strategy(
        strategy if strategy is not None else Strategy.AUTO, sign_method
    )
    if exact and strategy in (Strategy.AUTO, Strategy.CPT):
        strategy = Strategy.CULLED
    host_out = None
    if out is not None:
        if strategy == Strategy.AUTO:
            strategy = Strategy.CPT
        _check_streamed(strategy, raycast_axes)
        host_out = gridgen_streamed._result(out, grid.cell_count)
    device = resolve_device(device, vertices)
    with span("grid.soup"):
        v_host = points_on_host(vertices, "sync.grid.vertices")
        topo = (topology if topology is not None
                else Topology.triangle_list(None))
        if host_out is None:
            ha, hb, hc = gather_triangle_vertices(v_host, topo)
            n_tris = len(ha)
        else:
            faces = expand_triangles(len(v_host), topo)
            n_tris = len(faces)
    if n_tris == 0:
        if host_out is not None:
            field = host_out.fill_(F32_MAX)
        else:
            field = torch.full(grid.cell_count, F32_MAX,
                               dtype=torch.float32, device=device)
        return field.reshape(-1) if flat else field
    if strategy == Strategy.AUTO:
        strategy = _auto_route(n_tris, int(np.prod(grid.cell_count)),
                               device)

    if host_out is not None:
        field = gridgen_streamed._stream(
            v_host, faces, grid, sign, host_out,
            gridgen_streamed.default_slab_nx(grid.cell_count[0]), device)
        return field if flat else host_out

    if strategy == Strategy.CPT:
        tris, bins, line_bins = _cpt_prep(grid, ha, hb, hc, device)
        out = _cpt_grid_signed(
            grid, tris, bins, line_bins, sign=sign,
            raycast_axes=raycast_axes,
            # Coarse grids stress far-field propagation; a second round
            # costs O(cells) and is negligible exactly where it is needed.
            sweep_rounds=2 if max(grid.cell_count) <= 128 else 1,
        )
    else:
        out = _dense_grid_signed(
            grid, v_host, topo, device, strategy=strategy, sign=sign,
            raycast_axes=raycast_axes, tri_block=tri_block,
            query_chunk=query_chunk,
        )
    return out.reshape(-1) if flat else out
