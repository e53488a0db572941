"""``generate_grid_sdf(..., out=)`` on the CPU (the kernels' plain
versions): the CPT route slab by slab into a host buffer, held bit for bit
to ``gridgen_streamed.generate_grid_sdf_streamed`` and, on sampled cells,
to the CPT contract against the benchmark's plain reference
(``benchmark/reference/exact.py``, float64). Imports no JAX.

- Four slabs by the route's own rule (64 cells) need 256 cells along x:
  a 256 × 8 × 8 grid over icosphere(2), whose seed bins take several shift
  rounds, for the bit-equality.
- The contract: icosphere(3) (1 280 triangles, more than the grid's ~700
  surface cells, so the seed bins take several shift rounds, as a
  1.31M-triangle mesh does at 512³) on 16³ cells, through ``out=`` (one
  slab by the route's rule) and through the stream in four slabs of 4; and
  a rotated, scaled, shifted copy drawn from a seed in four slabs.
- An nx that 64 does not divide streams in the widest slabs that divide
  it, and meets the same contract.
- The prep caches of the stream and of the sharded grid key a mesh by its
  content: faces wound the other way miss.

The checks of ``out`` itself, shared by both entry points into the stream,
are ``tests/test_torch_streamed.py::test_out_of_the_wrong_kind_raises``.
"""
import numpy as np
import pytest
import torch

import mesh_to_sdf_tpu_torch as tm
from benchmark.reference import exact
from mesh_to_sdf_tpu_torch import gridgen, gridgen_streamed as gs, query
from mesh_to_sdf_tpu_torch.intake import upload_soup
from mesh_to_sdf_tpu_torch.ops.kernels import parity, seed, sweep
from mesh_to_sdf_tpu_torch.parallel import grid_sharded
from mesh_to_sdf_tpu_torch.topology import gather_triangle_vertices
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

BOX = ([-1.1] * 3, [1.1] * 3)
CPT = tm.Strategy.CPT
#: The CPT contract (BENCH.md): never under the exact distance, exact
#: within 1.5 cells of the surface (float32 rounding: 2e-4), at most 2 %
#: above it beyond, signs equal off the surface.
UNDERSHOOT_MAX = BAND_ERR_MAX = 2e-4
BAND_CELLS = 1.5
FAR_REL_MAX = 0.02
SURFACE_EPS = 1e-5
SAMPLES = 2048
SEED = 20261018


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clear_caches():
    gs._STREAM_PREP_CACHE.clear()
    gridgen._CPT_PREP_CACHE.clear()
    yield
    gs._STREAM_PREP_CACHE.clear()
    gridgen._CPT_PREP_CACHE.clear()


def _topo(f):
    return tm.Topology.triangle_list(f.reshape(-1))


def _bits(t):
    return torch.as_tensor(t).reshape(-1).view(torch.int32)


@pytest.fixture(scope="module")
def four_slabs():
    """(buffer, returned field, the stream's field, seed rounds) of the
    256 × 8 × 8 grid over icosphere(2)."""
    v, f = icosphere(2)
    grid = tm.Grid.from_bounding_box(*BOX, [256, 8, 8])
    buf = np.full(256 * 8 * 8, np.nan, np.float32)
    got = tm.generate_grid_sdf(v, _topo(f), grid, strategy=CPT, out=buf,
                               device="cpu")
    prep = next(iter(gs._STREAM_PREP_CACHE.values()))
    want = gs.generate_grid_sdf_streamed(v, f, grid, device="cpu")
    rounds = [s.n_shift_rounds for s in prep.seeds]
    gs._STREAM_PREP_CACHE.clear()
    return buf, got, want, rounds


def test_out_is_bit_equal_to_the_stream(four_slabs):
    buf, got, want, rounds = four_slabs
    assert len(rounds) == 4 and min(rounds) > 1
    assert torch.equal(_bits(got), _bits(want))
    assert got.shape == (256 * 8 * 8,)
    assert np.shares_memory(got.numpy(), buf)  # the caller's buffer
    assert np.isfinite(buf).all()


@pytest.mark.parametrize("sign", ["RAYCAST", "NORMAL"])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_out_takes_both_signs_and_buffer_kinds(sign, kind):
    """A (nx, ny, nz) CPU tensor or a flat numpy buffer; ``flat=False``
    gives the (nx, ny, nz) view."""
    v, f = icosphere(2)
    grid = tm.Grid.from_bounding_box(*BOX, [16, 8, 8])
    s = getattr(tm.SignMethod, sign)
    buf = (torch.empty(16, 8, 8) if kind == "tensor"
           else np.empty(16 * 8 * 8, np.float32))
    got = tm.generate_grid_sdf(v, _topo(f), grid, s, strategy=CPT, out=buf,
                               flat=False, device="cpu")
    want = gs.generate_grid_sdf_streamed(v, f, grid, s, device="cpu")
    assert got.shape == (16, 8, 8)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(torch.as_tensor(buf)), _bits(want))


def _rotated(v, rng):
    """``v`` under a rotation, a scale in [0.8, 0.95] and a shift of at
    most 0.05, all drawn from ``rng``."""
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1.0
    scale = rng.uniform(0.8, 0.95)
    shift = rng.uniform(-0.05, 0.05, 3)
    return (v.astype(np.float64) @ q.T * scale + shift).astype(np.float32)


def _contract(grid, v, f, field, rng):
    """The contract's numbers on ``SAMPLES`` cells drawn from ``rng``."""
    n = grid.total_cell_count
    idx = np.unique(rng.integers(0, n, SAMPLES))
    pts = grid.all_cell_centers().reshape(-1, 3)[torch.from_numpy(idx)]
    ref_s, ref_u = exact.signed_distance(pts, torch.from_numpy(v[f]))
    got = torch.as_tensor(field).reshape(-1)[torch.from_numpy(idx)].double()
    cs = float(np.max(np.abs(grid.cell_size.numpy())))
    err = got.abs() - ref_u
    band = ref_u <= BAND_CELLS * cs
    assert band.any() and (~band).any()
    flips = ((got < 0) != (ref_s < 0)) & (ref_u > SURFACE_EPS)
    return {"undershoot": float(torch.clamp_min(-err, 0).max()),
            "band_err": float(err[band].abs().max()),
            "far_rel": float((err[~band] / ref_u[~band]).max()),
            "sign_flips": int(flips.sum())}


@pytest.mark.parametrize("case", ["out", "four_slabs", "rotated"])
def test_meets_the_cpt_contract(case):
    rng = np.random.default_rng([SEED, ["out", "four_slabs",
                                        "rotated"].index(case)])
    v, f = icosphere(3)
    if case == "rotated":
        v = _rotated(v, rng)
    grid = tm.Grid.from_bounding_box(*BOX, [16, 16, 16])
    if case == "out":
        field = tm.generate_grid_sdf(v, _topo(f), grid, strategy=CPT,
                                     out=np.empty(16**3, np.float32),
                                     device="cpu")
    else:
        field = gs.generate_grid_sdf_streamed(v, f, grid, slab_nx=4,
                                              device="cpu")
    rounds = [s.n_shift_rounds for s in
              next(iter(gs._STREAM_PREP_CACHE.values())).seeds]
    assert len(rounds) == (1 if case == "out" else 4) and min(rounds) > 1
    got = _contract(grid, v, f, field, rng)
    assert got["undershoot"] <= UNDERSHOOT_MAX, got
    assert got["band_err"] <= BAND_ERR_MAX, got
    assert got["far_rel"] <= FAR_REL_MAX, got
    assert got["sign_flips"] == 0, got


GRID8 = tm.Grid.from_bounding_box(*BOX, [8, 8, 8])


@pytest.mark.parametrize("kwargs", [
    {"strategy": tm.Strategy.XLA},
    {"strategy": tm.Strategy.PALLAS},
    {"strategy": tm.Strategy.CULLED},
    {"strategy": CPT, "exact": True},
    {"strategy": CPT, "raycast_axes": 1},
], ids=["xla", "pallas", "culled", "exact", "one-axis"])
def test_out_off_the_cpt_route_raises(kwargs, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("streamed")

    monkeypatch.setattr(gs, "_stream", refuse)
    v, f = icosphere(1)
    with pytest.raises(ValueError, match="out"):
        tm.generate_grid_sdf(v, _topo(f), GRID8,
                             out=np.empty(512, np.float32), device="cpu",
                             **kwargs)


def test_out_with_auto_takes_the_stream(monkeypatch):
    """AUTO with ``out`` streams whatever the grid's size: here 8³ cells,
    for which AUTO alone picks a dense route on the CPU."""
    v, f = icosphere(1)
    assert gridgen._auto_route(len(f), 512, torch.device("cpu")) != CPT
    got = tm.generate_grid_sdf(v, _topo(f), GRID8,
                               out=np.empty(512, np.float32), device="cpu")
    want = gs.generate_grid_sdf_streamed(v, f, GRID8, device="cpu")
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("nx, width", [(100, 50), (72, 36), (67, 1)])
def test_out_streams_an_nx_off_the_slab_width(nx, width):
    """nx not a multiple of 64: the route's slabs are the widest divisor of
    nx up to 64 (one slice for a prime), and the field meets the
    contract."""
    rng = np.random.default_rng([SEED, nx])
    v, f = icosphere(2)
    # Cubic cells (the contract's) in a bar along x that holds the whole
    # mesh, a small sphere across the middle slabs' boundary.
    v = (v * 0.06 + np.float32([0.02, 0.0, 0.0])).astype(np.float32)
    half = 4 * 2.2 / nx
    grid = tm.Grid.from_bounding_box([-1.1, -half, -half],
                                     [1.1, half, half], [nx, 8, 8])
    assert gs.default_slab_nx(nx) == width
    field = tm.generate_grid_sdf(v, _topo(f), grid,
                                 out=np.empty(nx * 64, np.float32),
                                 device="cpu")
    (prep,) = gs._STREAM_PREP_CACHE.values()
    assert len(prep.slabs) == nx // width
    got = _contract(grid, v, f, field, rng)
    assert got["undershoot"] <= UNDERSHOOT_MAX, got
    assert got["band_err"] <= BAND_ERR_MAX, got
    assert got["far_rel"] <= FAR_REL_MAX, got
    assert got["sign_flips"] == 0, got


def test_out_with_an_empty_mesh_is_f32_max():
    buf = np.zeros(512, np.float32)
    got = tm.generate_grid_sdf(np.zeros((0, 3), np.float32),
                               tm.Topology.triangle_list(np.zeros(0, int)),
                               GRID8, strategy=CPT, out=buf, device="cpu")
    assert np.shares_memory(got.numpy(), buf)
    assert (buf == tm.F32_MAX).all()


def _counts():
    return {k.__name__: (k.COUNT.kernel, k.COUNT.plain)
            for k in (seed, sweep, parity)}


def test_without_out_the_grid_path_is_unchanged(monkeypatch):
    """No ``out``: the in-core CPT route, as the route's own pieces compose
    it (prep, then the seed, sweeps and sign), with the same plain calls
    and bit for bit the same field; the stream is never entered."""
    def refuse(*args, **kw):
        raise AssertionError("streamed")

    monkeypatch.setattr(gs, "_stream", refuse)
    v, f = icosphere(2)
    grid = tm.Grid.from_bounding_box(*BOX, [16, 16, 16])
    topo = _topo(f)
    ha, hb, hc = gather_triangle_vertices(v, topo)
    tris, bins, line_bins = gridgen._cpt_prep(grid, ha, hb, hc,
                                              torch.device("cpu"))
    before = _counts()
    want = gridgen._cpt_grid_signed(grid, tris, bins, line_bins,
                                    sign=tm.SignMethod.RAYCAST,
                                    raycast_axes=3, sweep_rounds=2)
    mid = _counts()
    got = tm.generate_grid_sdf(v, topo, grid, strategy=CPT, device="cpu")
    after = _counts()
    assert torch.equal(_bits(got), _bits(want))
    for k in before:
        assert (after[k][0] - mid[k][0], after[k][1] - mid[k][1]) == (
            mid[k][0] - before[k][0], mid[k][1] - before[k][1]), k
    assert after["mesh_to_sdf_tpu_torch.ops.kernels.sweep"][1] > mid[
        "mesh_to_sdf_tpu_torch.ops.kernels.sweep"][1]


def _stream_field(v, f, grid):
    return gs.generate_grid_sdf_streamed(v, f, grid, device="cpu")


def _cpt_field(v, f, grid):
    return tm.generate_grid_sdf(v, _topo(f), grid, strategy=CPT,
                                device="cpu")


def _culled_sign_grid(v, f, grid):
    ha, hb, hc = gather_triangle_vertices(v, _topo(f))
    ta, tb, tc, valid, _ = upload_soup(ha, hb, hc, 512, "cpu")
    sign_grid, _, _ = query._culled_structures(
        ha, hb, hc, ta, tb, tc, valid, torch.device("cpu"),
        block_index=False)
    return sign_grid.inside.to(torch.int32)


#: Per content-keyed cache: (what a call on (v, f, grid) returns, the
#: module and name of the function its miss calls once).
PREP_CACHES = {
    "stream": (_stream_field, gs.cpt, "subdivide_to_span"),
    "cpt": (_cpt_field, gridgen.cpt, "build_seed_bins"),
    "culled": (_culled_sign_grid, query.culling, "build_sign_grid"),
}


@pytest.mark.parametrize("cache", PREP_CACHES)
def test_prep_cache_keys_faces_by_content_and_dtype(cache, monkeypatch):
    """Each content-keyed cache (the stream's prep, the in-core CPT prep,
    CULLED's structures) keys the mesh by content: the same mesh in new
    buffers hits and gives the same result; a mesh wound the other way or
    with one vertex moved misses. The stream hashes the caller's arrays as
    given, so the same faces in another dtype miss there too."""
    run, module, name = PREP_CACHES[cache]
    for attr in ("_SIGN_GRID_CACHE", "_PARITY_BINS_CACHE"):
        monkeypatch.setattr(query, attr, {})
    v, f = icosphere(1)
    grid = tm.Grid.from_bounding_box(*BOX, [8, 8, 8])
    misses = []
    build = getattr(module, name)

    def counted(*args, **kwargs):
        misses.append(1)
        return build(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    first = run(v, f, grid)
    assert torch.equal(_bits(run(v.copy(), f.copy(), grid)), _bits(first))
    assert len(misses) == 1
    if cache == "stream":
        assert torch.equal(_bits(run(v, f.astype(np.int32), grid)),
                           _bits(first))
        assert len(misses) == 2
    n = len(misses)
    run(v, f[:, [0, 2, 1]], grid)  # each triangle wound the other way
    assert len(misses) == n + 1
    moved = v.copy()
    moved[0] *= np.float32(1.01)
    run(moved, f, grid)
    assert len(misses) == n + 2


def test_sharded_prep_cache_keys_faces_by_content(monkeypatch):
    """The sharded grid's per-rank prep takes the stream's content key: a
    mesh wound the other way misses, so the NORMAL sign follows it."""
    v, f = icosphere(1)
    grid = tm.Grid.from_bounding_box(*BOX, [8, 8, 8])
    misses = []
    subdivide = grid_sharded.cpt.subdivide_to_span

    def counted(*args, **kwargs):
        misses.append(1)
        return subdivide(*args, **kwargs)

    monkeypatch.setattr(grid_sharded.cpt, "subdivide_to_span", counted)
    grid_sharded._SHARDED_PREP_CACHE.clear()
    try:
        def prep(faces):
            return grid_sharded._slab_prep(grid, 1, 0, v,
                                           faces.astype(np.int64), False,
                                           torch.device("cpu"))

        first = prep(f)
        assert prep(f.copy()) is first and len(misses) == 1
        rewound = prep(f[:, [0, 2, 1]])
        assert len(misses) == 2
        assert not torch.equal(rewound.tris, first.tris)
    finally:
        grid_sharded._SHARDED_PREP_CACHE.clear()
