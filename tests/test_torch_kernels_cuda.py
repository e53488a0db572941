"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without an NVIDIA
GPU. The GPU machine has no JAX, which tests/conftest.py imports, so run
them there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: distances rtol=2e-4, atol=1e-5 (both sides round every
operation as written, so they agree far inside it); counts and signs exactly.
"""
import numpy as np
import pytest
import torch

import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch import gridgen, gridgen_streamed, query
from mesh_to_sdf_tpu_torch.intake import host_soup, upload_soup
from mesh_to_sdf_tpu_torch.models import sdf_layer
from mesh_to_sdf_tpu_torch.ops import autodiff, cpt, culling
from mesh_to_sdf_tpu_torch.ops.kernels import culled, parity, sdf, sweep
from mesh_to_sdf_tpu_torch.ops.kernels import seed as seed_k
from mesh_to_sdf_tpu_torch.ops.raycast import face_origins
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere, torus
from torch_static_widen import static_widen

pytestmark = pytest.mark.cuda

RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gridgen._CPT_PREP_CACHE.clear()
    yield torch.device("cuda")
    gridgen._CPT_PREP_CACHE.clear()


def _prep(mesh, shape, device):
    verts, faces = mesh
    grid = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, shape)
    v = verts[faces]
    return (grid,) + gridgen._cpt_prep(grid, v[:, 0], v[:, 1], v[:, 2],
                                       device)


def _sweep_inputs(mesh, shape, device):
    """(grid, SweepTris, x-first state) of a seeded CPT grid, built without
    the parity bins (so planes may be one cell wide)."""
    verts, faces = mesh
    grid = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, shape)
    v = verts[faces]
    bins = cpt.build_seed_bins(grid, v[:, 0], v[:, 1], v[:, 2],
                               pad=cpt.seed_pad_for(grid))
    tris = [torch.from_numpy(np.ascontiguousarray(v[:, k])).to(device)
            for k in range(3)]
    seed = cpt.seed_from_bins(grid, *tris, bins)
    return grid, sweep.sweep_tris(*tris), cpt.sweep_state(grid, seed)


def _same_state(got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


#: Grids whose sweep planes are 1 x N, N x 1, odd and several tiles wide.
SWEEP_SHAPES = {"1xN": [20, 1, 40], "Nx1": [20, 40, 1],
                "odd": [19, 21, 17], "tiles": [33, 48, 35]}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_sweep_kernel_matches_plain(cuda, shape, axis, reverse):
    """One directional sweep: distances and ids bit-equal to the plain
    version, in one launch, in place."""
    grid, tris, state = _sweep_inputs(icosphere(2), SWEEP_SHAPES[shape],
                                      cuda)
    args = (tris, reverse, grid.first_cell, grid.cell_size)
    before = sweep.COUNT.kernel
    work = [t.clone() for t in state]
    got = sweep.sweep_axis(*work, *args, axis=axis)
    want = sweep.sweep_axis_plain(*[t.clone() for t in state], *args,
                                  axis=axis)
    torch.cuda.synchronize()
    assert sweep.COUNT.kernel == before + 1
    assert all(g is w for g, w in zip(got, work))
    assert _same_state(got, want)


@pytest.mark.parametrize("rounds", [1, 2])
def test_closest_point_grid_cuda_matches_cpu(cuda, rounds):
    grid, tris, bins, _ = _prep(icosphere(2), [24, 20, 16], cuda)
    seed = cpt.seed_from_bins(grid, tris[0], tris[1], tris[2], bins)
    before = sweep.COUNT.kernel
    d_k, i_k = cpt.closest_point_grid(grid, tris[0], tris[1], tris[2],
                                      seed=seed, rounds=rounds)
    assert sweep.COUNT.kernel == before + 6 * rounds
    d_p, i_p = cpt.closest_point_grid(grid, *(t.cpu() for t in tris),
                                      seed=[s.cpu() for s in seed],
                                      rounds=rounds)
    assert _same_state((d_k.cpu(), i_k.cpu()), (d_p, i_p))


def _duplicated(mesh):
    """The mesh with every face twice and the first 100 three times, so
    cells hold triangles at equal distances: ties in best and runner-up."""
    verts, faces = mesh
    return verts, np.concatenate([faces, faces[::-1], faces[:100]])


def _seed_case(name):
    """(grid, soup (3 × (T, 3) numpy), SeedBins numpy) of a seed case."""
    if name == "slab":
        verts, faces = icosphere(3)
        grid = tm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [32, 20, 16])
        v = verts[faces]
        soup = [np.ascontiguousarray(v[:, k]) for k in range(3)]
        stacked = cpt.build_slab_seed_bins(grid, 4, *soup)
        slab = gridgen_streamed.slab_grids(grid, 8)[1]
        return slab, soup, cpt.SeedBins(
            stacked.entry_tri[1], stacked.rows_cell[1], stacked.cell_row[1],
            stacked.n_shift_rounds)
    mesh, lo, shape = {
        "cell": (icosphere(4), 1.1, [128] * 3),
        "coarse": (icosphere(3), 1.3, [24, 20, 16]),
        "ties": (_duplicated(icosphere(3)), 1.3, [50, 50, 50]),
        "ties-coarse": (_duplicated(icosphere(2)), 1.3, [12, 10, 8]),
        "empty": ((np.zeros((0, 3), np.float32),
                   np.zeros((0, 3), np.int64)), 1.0, [9, 7, 5]),
    }[name]
    verts, faces = mesh
    grid = tm.Grid.from_bounding_box([-lo] * 3, [lo] * 3, shape)
    v = verts[faces].reshape(-1, 3, 3)
    soup = [np.ascontiguousarray(v[:, k]) for k in range(3)]
    return grid, soup, cpt.build_seed_bins(grid, *soup,
                                           pad=cpt.seed_pad_for(grid))


@pytest.mark.parametrize("name", ["cell", "coarse", "ties", "ties-coarse",
                                  "slab", "empty"])
def test_seed_kernel_matches_plain(cuda, name):
    """The seed kernel: one launch, no plain call, its four outputs
    bit-equal (int bits) to the plain version's on the CPU; the cases give
    one shift round (as the 256³ cell), several (≥ 3 rows in a cell), ties
    in best and runner-up, a padded slab row and no triangles at all."""
    grid, soup, bins = _seed_case(name)
    if name in ("coarse", "ties-coarse"):
        assert bins.n_shift_rounds >= 2
    if name == "cell":
        assert bins.n_shift_rounds == 1
    tris = [torch.from_numpy(t).to(cuda) for t in soup]
    dev_bins = cpt.SeedBins(*(torch.from_numpy(a).to(cuda)
                              for a in bins[:3]), bins.n_shift_rounds)
    before = (seed_k.COUNT.kernel, seed_k.COUNT.plain)
    got = cpt.seed_from_bins(grid, *tris, dev_bins)
    torch.cuda.synchronize()
    assert (seed_k.COUNT.kernel, seed_k.COUNT.plain) == (before[0] + 1,
                                                         before[1])
    want = seed_k.seed_from_bins_plain(
        grid, *(torch.from_numpy(t) for t in soup), bins)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
    if name != "empty":
        assert int((want[3] >= 0).sum()) > 0
    # The records given by the caller (shared with the sweeps) give the
    # same bits.
    again = cpt.seed_from_bins(grid, *tris, dev_bins, sweep.sweep_tris(*tris))
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(again, got))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_parity_kernel_matches_plain(cuda, axis):
    grid, _, _, line_bins = _prep(torus(1.0, 0.35, 48, 24), [40, 72, 33],
                                  cuda)
    origins, lshape = face_origins(grid, axis, cuda)
    iy, iz = (axis + 1) % 3, (axis + 2) % 3
    args = (origins[:, iy].contiguous(), origins[:, iz].contiguous(),
            grid.first_cell[axis], grid.cell_size[axis], line_bins[axis])
    kw = dict(n_cells=grid.cell_count[axis], n1=lshape[0], n2=lshape[1])
    got, ovf = parity.line_parity_counts_binned(*args, **kw)
    want, _ = parity.line_parity_counts_binned_plain(*args, **kw)
    assert torch.equal(got, want)
    assert not ovf.any() and int(got[:, 0].sum()) > 0


def test_generate_grid_sdf_cuda_matches_cpu(cuda):
    verts, faces = icosphere(3)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    grid = tm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [32, 28, 24])
    sweep.COUNT.reset()
    parity.COUNT.reset()
    got = tm.generate_grid_sdf(torch.from_numpy(verts).to(cuda), topo, grid,
                               strategy=tm.Strategy.CPT)
    assert got.device.type == "cuda"
    assert sweep.COUNT.kernel > 0 and parity.COUNT.kernel > 0
    assert sweep.COUNT.plain == parity.COUNT.plain == 0
    want = tm.generate_grid_sdf(verts, topo, grid, strategy=tm.Strategy.CPT,
                                device="cpu")
    torch.testing.assert_close(got.cpu().abs(), want.abs(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(got.cpu() < 0, want < 0)


def _soup(mesh, device, n=None):
    verts, faces = mesh
    faces = faces[:n]
    return tuple(torch.from_numpy(np.ascontiguousarray(verts[faces[:, k]]))
                 .to(device) for k in range(3))


def _degenerate(device, n=64):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, 3)).astype(np.float32)
    b = a.copy()
    c = rng.standard_normal((n, 3)).astype(np.float32)
    b[n // 2:] = c[n // 2:]
    c[3 * n // 4:] = a[3 * n // 4:]
    b[3 * n // 4:] = a[3 * n // 4:]
    return tuple(torch.from_numpy(x).to(device) for x in (a, b, c))


def _queries(n, device):
    rng = np.random.default_rng(n)
    return torch.from_numpy(
        rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)).to(device)


SOUPS = {
    "icosphere3": lambda dev: _soup(icosphere(3), dev),
    "odd-T-321": lambda dev: _soup(icosphere(3), dev, 321),
    "degenerate": _degenerate,
}


@pytest.mark.parametrize("n_queries", [1, 1025, 4096])
@pytest.mark.parametrize("soup", SOUPS)
@pytest.mark.parametrize("axes", [0, 1, 3])
def test_sdf_raycast_kernel_matches_plain(cuda, soup, axes, n_queries):
    tris = SOUPS[soup](cuda)
    q = _queries(n_queries, cuda)
    before = sdf.RAYCAST_COUNT.kernel
    d_k, c_k = sdf.raycast_raw(q, *tris, raycast_axes=axes)
    d_p, c_p = sdf.raycast_raw_plain(q, *tris, raycast_axes=axes)
    torch.cuda.synchronize()
    assert sdf.RAYCAST_COUNT.kernel == before + 1
    torch.testing.assert_close(d_k, d_p, rtol=RTOL, atol=ATOL)
    assert torch.equal(c_k, c_p)


@pytest.mark.parametrize("n_queries", [1, 1025, 4096])
@pytest.mark.parametrize("soup", SOUPS)
def test_sdf_normal_kernel_matches_plain(cuda, soup, n_queries):
    tris = SOUPS[soup](cuda)
    q = _queries(n_queries, cuda)
    before = sdf.NORMAL_COUNT.kernel
    got = sdf.normal_raw(q, *tris)
    want = sdf.normal_raw_plain(q, *tris)
    torch.cuda.synchronize()
    assert sdf.NORMAL_COUNT.kernel == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sign", [tm.SignMethod.RAYCAST, tm.SignMethod.NORMAL])
def test_generate_sdf_cuda_matches_cpu(cuda, sign):
    verts, faces = icosphere(3)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    q = _queries(3000, cuda)
    got = tm.generate_sdf(verts, topo, q, sign_method=sign)  # AUTO → PALLAS
    assert got.device.type == "cuda" and got.shape == (3000,)
    want = tm.generate_sdf(verts, topo, q.cpu(), tm.Strategy.PALLAS,
                           sign_method=sign, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(torch.signbit(got.cpu()), torch.signbit(want))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_dense_parity_kernel_matches_plain(cuda, axis):
    grid, _, _, line_bins = _prep(torus(1.0, 0.35, 48, 24), [40, 72, 33],
                                  cuda)
    tris = _soup(torus(1.0, 0.35, 48, 24), cuda)
    origins, lshape = face_origins(grid, axis, cuda)
    iy, iz = (axis + 1) % 3, (axis + 2) % 3
    args = (origins[:, iy].contiguous(), origins[:, iz].contiguous(),
            grid.first_cell[axis], grid.cell_size[axis])
    n = grid.cell_count[axis]
    planes = parity.rotate_planes(*tris, axis)
    before = parity.DENSE_COUNT.kernel
    got, ovf = parity.line_parity_counts(*args, planes, n_cells=n)
    want, _ = parity.line_parity_counts_plain(*args, planes, n_cells=n)
    binned, _ = parity.line_parity_counts_binned(
        *args, line_bins[axis], n_cells=n, n1=lshape[0], n2=lshape[1])
    torch.cuda.synchronize()
    assert parity.DENSE_COUNT.kernel == before + 1
    assert torch.equal(got, want) and torch.equal(got, binned)
    assert not ovf.any() and int(got[:, 0].sum()) > 0


@pytest.mark.parametrize("strategy", [tm.Strategy.PALLAS, tm.Strategy.XLA])
def test_dense_grid_route_cuda_matches_cpu(cuda, strategy):
    verts, faces = icosphere(3)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    grid = tm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [24, 20, 16])
    got = tm.generate_grid_sdf(torch.from_numpy(verts).to(cuda), topo, grid,
                               strategy=strategy)
    want = tm.generate_grid_sdf(verts, topo, grid, strategy=strategy,
                                device="cpu")
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu().abs(), want.abs(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(got.cpu() < 0, want < 0)


def _bits_equal(x, y):
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("soup", list(SOUPS) + ["icosphere6"])
def test_tri_records_kernel_matches_plain(cuda, soup):
    """The packing kernel's records are bit-equal to the plain packing's."""
    tris = (_soup(icosphere(6), cuda) if soup == "icosphere6"
            else SOUPS[soup](cuda))
    before = sdf.RECORDS_COUNT.kernel
    got = sdf.tri_records(*tris)
    want = sdf.tri_records_plain(*tris)
    torch.cuda.synchronize()
    assert sdf.RECORDS_COUNT.kernel == before + 1
    assert _bits_equal(got, want)


def test_block_index_records_match_plain(cuda):
    """Both record tables of a block index (kernel-packed on the card)
    equal the plain packing of the same rows, pad block included."""
    verts, faces = icosphere(4)
    bi = culled.build_block_index(*[verts[faces[:-7, k]] for k in range(3)],
                                  device=cuda)
    for rows in (bi.rows, bi.gather_rows):
        rec = culled.table_records(rows)
        n, _, tb = rows.shape
        p = rows.permute(1, 0, 2).reshape(9, -1)
        want = sdf.tri_records_plain(p[0:3].t(), p[3:6].t(), p[6:9].t(),
                                     edges=True).reshape(
                                         n, tb, len(sdf.RECORD_FIELDS))
        assert _bits_equal(rec, want)


@pytest.mark.parametrize("n_queries", [1, 37, 4577])
def test_raycast_kernel_split_matches_plain(cuda, n_queries):
    """icosphere(6) (81 920 triangles) at query counts that leave the card
    idle, so the wrapper splits the triangles over many chunks; Q is not a
    multiple of a CTA's 256 queries. d² bit-equal, counts equal."""
    tris = _soup(icosphere(6), cuda)
    q = _queries(n_queries, cuda)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sdf.raycast_chunks(n_queries, tris[0].shape[0], n_sms) > 1
    d_k, c_k = sdf.raycast_raw(q, *tris, raycast_axes=3)
    d_p, c_p = sdf.raycast_raw_plain(q, *tris, raycast_axes=3)
    torch.cuda.synchronize()
    assert _bits_equal(d_k, d_p) and torch.equal(c_k, c_p)


@pytest.mark.parametrize("axes", [0, 1, 3])
def test_raycast_kernel_split_and_unsplit_equal(cuda, axes, monkeypatch):
    """Every chunk count gives the same bits: the rule's, 1 and 7."""
    tris = _soup(icosphere(6), cuda)
    q = _queries(3000, cuda)
    runs = [sdf.raycast_raw(q, *tris, raycast_axes=axes)]
    for k in (1, 7):
        monkeypatch.setattr(sdf, "raycast_chunks", lambda *a, k=k: k)
        runs.append(sdf.raycast_raw(q, *tris, raycast_axes=axes))
    torch.cuda.synchronize()
    for d, c in runs[1:]:
        assert _bits_equal(d, runs[0][0]) and torch.equal(c, runs[0][1])


@pytest.mark.parametrize("kernel", ["raycast", "normal"])
def test_sdf_kernels_index_past_2_31_floats(cuda, kernel):
    """Q = 715,827,883 + 200 queries: 3·Q floats pass 2^31, so the query
    index must be 64-bit. The last rows agree with the plain version."""
    n = 715_827_883 + 200
    q = torch.empty((n, 3), dtype=torch.float32, device=cuda)
    q.uniform_(-1.5, 1.5, generator=torch.Generator(cuda).manual_seed(0))
    tris = _soup(icosphere(0), cuda)
    tail = q[-1000:].contiguous()
    if kernel == "raycast":
        got = sdf.raycast_raw(q, *tris, raycast_axes=1)
        want = sdf.raycast_raw_plain(tail, *tris, raycast_axes=1)
        got = (got[0][-1000:], got[1][:, -1000:])
    else:
        got = tuple(g[-1000:] for g in sdf.normal_raw(q, *tris))
        want = sdf.normal_raw_plain(tail, *tris)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    if kernel == "raycast":
        assert torch.equal(got[1], want[1])
    else:
        torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)


#: Group shapes of the CULLED engines: (st or qt, kg or None, anchors).
CULLED_SHAPES = {
    "gather": (64, 32, True), "gather-st32": (32, 32, True),
    "widen": (16, 128, True), "union-anchors": (1024, None, True),
    "union": (1024, None, False), "union-qt128": (128, None, True),
}


def _culled_inputs(engine, device, n_queries=16384):
    """(queries, rows, tbl, group, n_blocks, anchors) as the
    CULLED engines give them to the kernel, on icosphere(6) (81 920
    triangles, 320 blocks): gather st=64 (and 32) kg=32, widen st=16
    kg=128, union qt=1024 with and without anchors, qt=128."""
    verts, faces = icosphere(6)
    tris = [verts[faces[:, k]] for k in range(3)]
    bi = culled.build_block_index(*tris, device=device)
    q = _queries(n_queries, device)
    q = q[culling._morton_order(q)]
    grid = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [128] * 3)
    group, kg, signed = CULLED_SHAPES[engine]
    anchors = culling._anchor_cells(q, grid)[1] if signed else None
    if kg is None:
        tbl, _, _ = culled.select_blocks(q, bi, nb_sub=48, st=64, qt=group,
                                         nb_table=256)
        return q, bi.rows, tbl, group, bi.n_blocks, anchors
    centers, _ = culled._sub_tiles(q, group)
    idx, _ = culled._phase_a_topk(centers, bi, kg=kg)
    return q, bi.gather_rows, idx, group, bi.n_blocks, anchors


def _hold_culled(q, rows, tbl, group, B, anchors):
    kw = dict(group=group, n_blocks=B, anchors=anchors)
    before = culled.COUNT.kernel
    d_k, c_k = culled.culled_blocks(q, rows, tbl, **kw)
    d_p, c_p = culled.culled_blocks_plain(q, rows, tbl, **kw)
    torch.cuda.synchronize()
    assert culled.COUNT.kernel == before + 1
    assert _bits_equal(d_k, d_p)
    if anchors is None:
        assert c_k is None and c_p is None
    else:
        assert torch.equal(c_k, c_p) and int(c_k.sum()) > 0


@pytest.mark.parametrize("engine", CULLED_SHAPES)
def test_culled_kernel_matches_plain(cuda, engine):
    """The block-culled kernel at each engine's group shape: d² and
    crossing counts equal to the plain version's (max abs err 0)."""
    _hold_culled(*_culled_inputs(engine, cuda))


@pytest.mark.parametrize("engine", ["widen", "gather-st32", "gather",
                                    "union-anchors"])
def test_culled_kernel_uneven_slot_lists(cuda, engine):
    """Groups of one CTA (and the two halves of a warp at st 16) with very
    different numbers of real blocks, from none to all slots: each team
    stops at its own first pad."""
    q, rows, tbl, group, B, anchors = _culled_inputs(engine, cuda)
    n_groups, n_slots = tbl.shape
    real = torch.tensor([0, n_slots, 1, n_slots // 2, 3, n_slots - 1, 9, 2],
                        device=cuda).clamp_max(n_slots)
    real = real.repeat(-(-n_groups // 8))[:n_groups]
    slot = torch.arange(n_slots, device=cuda)[None, :]
    tbl = torch.where(slot < real[:, None], tbl, B).to(torch.int32)
    _hold_culled(q, rows, tbl.contiguous(), group, B, anchors)


def _overlapping_soup(n_tris=81920):
    """Long random triangles across [-1, 1]^3: every block's AABB holds
    nearly the whole cube, so a centre inside it reads 0 for all of them
    (coarse ties) and lies inside many circumspheres (fine ties)."""
    v = np.random.default_rng(7).uniform(-1, 1, (n_tris, 3, 3))
    return tuple(np.ascontiguousarray(v[:, k], np.float32) for k in range(3))


def _near_surface(n, seed):
    """Points within ~0.01 of the unit sphere: fine bounds of 0 (inside the
    circumspheres of the nearest triangles)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * (1 + rng.normal(0, 0.005, (n, 1)))).astype(np.float32)


def _uniform(n, seed, half=1.3):
    return np.random.default_rng(seed).uniform(-half, half, (n, 3)).astype(
        np.float32)


#: Phase A's hierarchical branch: (triangles, queries, st, kg). The query
#: cells' passes on icosphere(6) (B = 320): main st 64 / kg 32 at the
#: uniform cell's 1M queries, widen st 16 / kg 128; near-surface centres
#: (fine ties); an overlapping soup (coarse ties); B = 301 (neither a power
#: of two nor a multiple of 32, a partial last block); icosphere(8)'s 5 120
#: blocks (dynamic shared memory as for any B).
PHASE_A_CASES = {
    "cell-main": (lambda: icosphere(6), lambda: _uniform(1_000_000, 1),
                  64, 32),
    "cell-widen": (lambda: icosphere(6), lambda: _uniform(53_248, 2),
                   16, 128),
    "near-surface-main": (lambda: icosphere(6),
                          lambda: _near_surface(500_000, 3), 64, 32),
    "near-surface-widen": (lambda: icosphere(6),
                           lambda: _near_surface(9_216, 4), 16, 128),
    "overlapping": (_overlapping_soup, lambda: _uniform(65_536, 5, 1.0),
                    64, 32),
    "odd-B-301": (lambda: (icosphere(6)[0], icosphere(6)[1][:76_956]),
                  lambda: _uniform(65_536, 6), 16, 128),
    "icosphere8": (lambda: icosphere(8), lambda: _uniform(65_536, 8),
                   64, 32),
}


def _phase_a_inputs(case, device):
    """(sub-tile centres of the Morton-sorted, padded queries, block index,
    kg) as the gather engine gives them to phase A."""
    make_mesh, make_q, st, kg = PHASE_A_CASES[case]
    mesh = make_mesh()
    tris = mesh if len(mesh) == 3 else tuple(
        mesh[0][mesh[1][:, k]] for k in range(3))
    bi = culled.build_block_index(*tris, device=device)
    q = torch.from_numpy(make_q()).to(device)
    q = q[culling._morton_order(q)]
    q = culling._edge_pad(q, (-q.shape[0]) % st)
    centers, _ = culled._sub_tiles(q, st)
    return centers, bi, kg


@pytest.mark.parametrize("case", PHASE_A_CASES)
def test_phase_a_kernel_matches_plain(cuda, case):
    """The phase-A kernel against ``_phase_a_hier_plain`` on the same card
    tensors, in both modes: the full triple (lb_c, idx_c, lb_rest) and the
    gather engine's pair through ``_phase_a_topk`` (idx_kg, lb_excl), bit
    for bit, one launch each and no plain call."""
    centers, bi, kg = _phase_a_inputs(case, cuda)
    c = max(kg + 1, culled.HIER_C)
    assert bi.n_blocks > 2 * c
    count = culled.PHASE_A_COUNT
    count.reset()
    got_full = culled._phase_a_hier(centers, bi, c=c)
    got = culled._phase_a_topk(centers, bi, kg=kg)
    torch.cuda.synchronize()
    assert (count.kernel, count.plain) == (2, 0)
    want_full = culled._phase_a_hier_plain(centers, bi, c=c)
    want = culled._kg_tail(*want_full, kg)
    for g, w in zip(got_full + got, want_full + want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _bits_equal(g, w)
    lb_c, _, lb_rest = want_full
    if case == "overlapping":  # more than c + 1 AABBs hold the centre
        assert int((lb_rest == 0).sum()) > centers.shape[0] // 2
    if case.startswith("near-surface"):  # several fine bounds of 0
        assert int(((lb_c == 0).sum(dim=1) > 1).sum()) > 0
    if case == "odd-B-301":
        assert bi.n_blocks == 301


@pytest.mark.parametrize("mesh", ["icosphere7", "icosphere6-hier"])
def test_select_blocks_hier_kernel_matches_plain(cuda, mesh, monkeypatch):
    """The union engine's ``select_blocks`` in its hierarchical branch (B ≥
    512: icosphere(7)'s 1 280 blocks; icosphere(6)'s 320 with
    HIER_MIN_BLOCKS lowered) through the kernel, one launch, against the
    same call with phase A's plain version: table, bounds and centres
    bit-equal."""
    level = 7 if mesh == "icosphere7" else 6
    if level == 6:
        monkeypatch.setattr(culled, "HIER_MIN_BLOCKS", 256)
    verts, faces = icosphere(level)
    bi = culled.build_block_index(*(verts[faces[:, k]] for k in range(3)),
                                  device=cuda)
    q = torch.from_numpy(_uniform(65_536, level)).to(cuda)
    q = q[culling._morton_order(q)]
    count = culled.PHASE_A_COUNT
    count.reset()
    got = culled.select_blocks(q, bi)
    torch.cuda.synchronize()
    assert (count.kernel, count.plain) == (1, 0)
    monkeypatch.setattr(culled, "_phase_a_hier", culled._phase_a_hier_plain)
    want = culled.select_blocks(q, bi)
    assert count.plain == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _bits_equal(g, w)


def test_culled_call_launches_phase_a_per_pass(cuda, monkeypatch):
    """One CULLED call (the uniform cell's traffic at 65 536 queries on
    icosphere(6)) launches phase A once for the main pass and once for the
    widen round, with no plain call, and answers bit for bit as the same
    call with phase A's plain version."""
    for cache in (query._SIGN_GRID_CACHE, query._PARITY_BINS_CACHE,
                  query._BLOCK_INDEX_CACHE, culling._ROUTE_CACHE):
        cache.clear()
    verts, faces = icosphere(6)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    q = torch.from_numpy(_uniform(65_536, 20)).to(cuda)

    def call():
        culling._ROUTE_CACHE.clear()
        out = tm.generate_sdf(verts, topo, q, tm.Strategy.CULLED,
                              sign_method=tm.SignMethod.RAYCAST, device=cuda)
        torch.cuda.synchronize()
        return out, dict(culling.LAST_CULLED_STATS)

    call()  # cold: the per-mesh structures
    count = culled.PHASE_A_COUNT
    count.reset()
    got, stats = call()
    assert culling.LAST_WIDEN_STATS["widened"] > 0
    assert (count.kernel, count.plain) == (2, 0)
    monkeypatch.setattr(culled, "_phase_a_hier", culled._phase_a_hier_plain)
    want, want_stats = call()
    assert count.plain == 2
    assert _bits_equal(got, want) and stats == want_stats
    culling._ROUTE_CACHE.clear()


@pytest.mark.parametrize("engine", ["gather", "union"])
def test_auto_takes_culled_on_cuda(cuda, engine):
    """gather: numpy inputs with no device run on the card; AUTO sends
    8 192 raycast queries on 81 920 triangles to CULLED through the kernel.
    union: the sharded path's pass (``_culled_blocks_signed_impl``) on the
    same mesh's cached structures, through the kernel; the queries it
    leaves unflagged. The answer matches PALLAS: distances within
    tolerance, signs apart on at most 1e-4 of the queries (at least 1: the
    TPU's own CULLED record, ROADMAP.md section 3)."""
    for cache in (query._SIGN_GRID_CACHE, query._PARITY_BINS_CACHE,
                  query._BLOCK_INDEX_CACHE, culling._ROUTE_CACHE):
        cache.clear()
    verts, faces = icosphere(6)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    q = np.random.default_rng(2).uniform(-1.3, 1.3, (8192, 3)).astype(
        np.float32)
    culled.COUNT.reset()
    if engine == "gather":
        got = tm.generate_sdf(verts, topo, q)
        assert got.device.type == "cuda" and got.shape == (8192,)
        assert culling.LAST_CULLED_STATS["engine"] == "gather"
        keep = torch.ones_like(got, dtype=torch.bool)
    else:
        ha, hb, hc = host_soup(verts, topo)
        ta, tb, tc, valid, _ = upload_soup(ha, hb, hc, 1024, cuda)
        sign_grid, _, bi = query._culled_structures(
            ha, hb, hc, ta, tb, tc, valid, cuda, block_index=True)
        got, flag, _ = culling._culled_blocks_signed_impl(
            torch.from_numpy(q).to(cuda), bi, sign_grid.inside,
            sign_grid.grid, qt=culled.DEFAULT_QT, st=32,
            nb_sub=culled.DEFAULT_NB_SUB, nb_table=culled.DEFAULT_NB_TABLE)
        keep = ~flag
        assert keep.any()
    assert culled.COUNT.kernel > 0 and culled.COUNT.plain == 0
    want = tm.generate_sdf(verts, topo, q, tm.Strategy.PALLAS)
    got, want = got[keep], want[keep]
    torch.testing.assert_close(got.abs(), want.abs(), rtol=RTOL, atol=ATOL)
    assert int((torch.signbit(got) != torch.signbit(want)).sum()) <= max(
        1, int(1e-4 * len(q)))
    culling._ROUTE_CACHE.clear()


def test_widen_on_the_flag_count_matches_static_size(cuda, monkeypatch):
    """The ``query_82k_raycast.uniform`` cell's shape (1M queries uniform
    in [-1.3, 1.3]^3 on icosphere(6)): the widen round on the first pass's
    flagged queries gives the static-size round's signed values and
    ``LAST_CULLED_STATS`` bit for bit (``torch_static_widen``), on at most
    6 % of the queries' rows against k_wide = Q / 3."""
    for cache in (query._SIGN_GRID_CACHE, query._PARITY_BINS_CACHE,
                  query._BLOCK_INDEX_CACHE, culling._ROUTE_CACHE):
        cache.clear()
    verts, faces = icosphere(6)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    Q = 1_000_000
    q = torch.from_numpy(np.random.default_rng(20261017).uniform(
        -1.3, 1.3, (Q, 3)).astype(np.float32)).to(cuda)

    def call():
        culling._ROUTE_CACHE.clear()
        out = tm.generate_sdf(verts, topo, q, tm.Strategy.CULLED,
                              sign_method=tm.SignMethod.RAYCAST, device=cuda)
        torch.cuda.synchronize()
        return out, dict(culling.LAST_CULLED_STATS)

    got, stats = call()
    widen = dict(culling.LAST_WIDEN_STATS)
    monkeypatch.setattr(culling, "_widen", static_widen)
    want, want_stats = call()
    assert _bits_equal(got, want)
    assert stats == want_stats and stats["engine"] == "gather"
    assert 0 < widen["widened"] == widen["flagged"] < widen["k_wide"]
    assert widen["k_wide"] == Q // 3
    assert widen["widened"] < widen["rows"] <= 0.06 * Q
    culling._ROUTE_CACHE.clear()


def test_numpy_inputs_run_on_the_card(cuda):
    verts, faces = icosphere(2)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    out = tm.generate_sdf(verts, topo, np.zeros((5, 3), np.float32))
    assert out.device.type == "cuda"
    grid = tm.Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [8, 8, 8])
    assert tm.generate_grid_sdf(verts, topo, grid).device.type == "cuda"


@pytest.mark.parametrize("soup", ["icosphere6", "degenerate"])
@pytest.mark.parametrize("n_queries", [1, 37, 4577])
def test_normal_kernel_split_matches_plain(cuda, soup, n_queries,
                                           monkeypatch):
    """Batches that leave the card idle split the triangles (icosphere(6),
    81 920 triangles, or 8 192 degenerate ones): pos2 and neg2 bit-equal to
    the plain version and to the same launch in 1 and in 7 chunks."""
    tris = (_soup(icosphere(6), cuda) if soup == "icosphere6"
            else _degenerate(cuda, 8192))
    q = _queries(n_queries, cuda)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sdf.raycast_chunks(n_queries, tris[0].shape[0], n_sms,
                              sdf.NORMAL_CTA_QUERIES) > 1
    got = sdf.normal_raw(q, *tris)
    want = sdf.normal_raw_plain(q, *tris)
    runs = []
    for k in (1, 7):
        monkeypatch.setattr(sdf, "raycast_chunks", lambda *a, k=k: k)
        runs.append(sdf.normal_raw(q, *tris))
    torch.cuda.synchronize()
    for other in [want] + runs:
        assert all(_bits_equal(g, w) for g, w in zip(got, other))


def _sheet_stack(n_sheets):
    """n_sheets parallel quads perpendicular to +X (the 20-sheet stack of
    tests/test_torch_parity.py::test_deep_stack_exact_where_jax_overflows)."""
    tris = []
    for i in range(n_sheets):
        x = 0.1 + 0.08 * i
        a, b, c, d = [x, -1, -1], [x, 1, -1], [x, 1, 1], [x, -1, 1]
        tris += [[a, b, c], [a, c, d]]
    t = np.asarray(tris, np.float32)
    return t[:, 0], t[:, 1], t[:, 2]


def _mesh_soup(mesh, drop=0):
    verts, faces = mesh
    faces = faces[:len(faces) - drop]
    return tuple(np.ascontiguousarray(verts[faces[:, k]]) for k in range(3))


#: (soup, grid): line lattices that are not whole line groups or tiles,
#: T not a multiple of a block, tiles far from the mesh whose `tbl` rows are
#: all pad, the deep stack, negative cell sizes.
PARITY_CASES = {
    "torus-40x72x33": (
        lambda: _mesh_soup(torus(1.0, 0.35, 48, 24), drop=5),
        lambda: tm.Grid.from_bounding_box([-1.6] * 3, [1.6] * 3,
                                          [40, 72, 33])),
    "all-pad-tiles-70x66x40": (
        lambda: _mesh_soup(icosphere(3)),
        lambda: tm.Grid.from_bounding_box([-1.2, -1.2, -1.2], [6.0, 5.0, 3.0],
                                          [70, 66, 40])),
    "deep-stack-16x4x4": (
        lambda: _sheet_stack(20),
        lambda: tm.Grid.from_bounding_box([0.0, -0.5, -0.5], [1.2, 0.5, 0.5],
                                          [16, 4, 4])),
    "negative-cells-33x20x28": (
        lambda: _mesh_soup(icosphere(3), drop=3),
        lambda: tm.Grid.from_bounding_box([1.5, -1.5, 1.4], [-1.5, 1.5, -1.4],
                                          [33, 20, 28])),
}


def _axis_inputs(grid, axis, device):
    origins, lshape = face_origins(grid, axis, device)
    iy, iz = (axis + 1) % 3, (axis + 2) % 3
    return ((origins[:, iy].contiguous(), origins[:, iz].contiguous(),
             grid.first_cell[axis], grid.cell_size[axis]),
            lshape, grid.cell_count[axis])


@pytest.mark.parametrize("chunks", [1, 2, 7, "planned"])
@pytest.mark.parametrize("case", PARITY_CASES)
def test_binned_parity_chunks_match_plain(cuda, case, chunks, monkeypatch):
    """The binned kernel split into 1, 2, 7 and the planned number of slot
    chunks: counts equal to the plain version's on all three axes."""
    soup_fn, grid_fn = PARITY_CASES[case]
    tris, grid = soup_fn(), grid_fn()
    if chunks != "planned":
        monkeypatch.setattr(parity, "parity_chunks", lambda *a, k=chunks: k)
    all_pad = 0
    for axis in range(3):
        args, lshape, n = _axis_inputs(grid, axis, cuda)
        bins = parity.build_line_bins(grid, axis, *tris, device=cuda)
        all_pad += int((bins.tbl == bins.n_blocks).all(dim=1).sum())
        kw = dict(n_cells=n, n1=lshape[0], n2=lshape[1])
        before = parity.COUNT.kernel
        got, ovf = parity.line_parity_counts_binned(*args, bins, **kw)
        want, _ = parity.line_parity_counts_binned_plain(*args, bins, **kw)
        torch.cuda.synchronize()
        assert parity.COUNT.kernel == before + 1
        assert torch.equal(got, want) and not ovf.any()
    if case.startswith("all-pad"):
        assert all_pad > 0


@pytest.mark.parametrize("chunks", [1, 2, 7, "planned"])
@pytest.mark.parametrize("case", PARITY_CASES)
def test_dense_parity_chunks_match_plain(cuda, case, chunks, monkeypatch):
    """The dense kernel split into 1, 2, 7 and the planned number of block
    chunks: counts equal to the plain version's on all three axes."""
    soup_fn, grid_fn = PARITY_CASES[case]
    tris = tuple(torch.from_numpy(t).to(cuda) for t in soup_fn())
    grid = grid_fn()
    if chunks != "planned":
        monkeypatch.setattr(parity, "parity_chunks", lambda *a, k=chunks: k)
    crossed = 0
    for axis in range(3):
        args, _, n = _axis_inputs(grid, axis, cuda)
        planes = parity.rotate_planes(*tris, axis)
        before = parity.DENSE_COUNT.kernel
        got, ovf = parity.line_parity_counts(*args, planes, n_cells=n)
        want, _ = parity.line_parity_counts_plain(*args, planes, n_cells=n)
        torch.cuda.synchronize()
        assert parity.DENSE_COUNT.kernel == before + 1
        assert torch.equal(got, want) and not ovf.any()
        crossed += int(got[:, 0].sum())
    assert crossed > 0


def test_parity_launch_shape(cuda):
    """The built kernels have the planner's launch shape, keep more than 4
    warps resident per SM, and a 128³ lattice fills many CTAs."""
    shape = parity.launch_shape()
    assert shape["cta_lines"] == parity.PARITY_CTA_LINES
    assert shape["block"] == parity.PARITY_BLOCK
    for key in ("binned_ctas_per_sm", "dense_ctas_per_sm"):
        assert shape[key] * shape["threads"] // 32 > 4
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    groups, chunks, _ = parity.dense_launch(128 * 128, 20480, n_sms)
    assert groups * chunks > n_sms


# ---------------------------------------------------- the training path
#: Gradients card vs CPU: the backward's index_add_ adds with atomics on the
#: card, so each vertex's float32 sum comes in another order there
#: (chip_smoke.py GRAD_RTOL, GRAD_ATOL_SCALE).
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-4


def _close_grads(got, want):
    atol = GRAD_ATOL_SCALE * float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=GRAD_RTOL, atol=atol)


@pytest.mark.parametrize("shape", [[24, 20, 16], [32, 32, 32]])
def test_window_seed_cuda_bit_equal_to_cpu(cuda, shape):
    verts, faces = icosphere(3)
    grid = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, shape)
    tris = [torch.from_numpy(np.ascontiguousarray(verts[faces[:, k]]))
            for k in range(3)]
    want = cpt._seed(grid, *tris, cpt.SEED_SPAN)
    got = cpt._seed(grid, *(t.to(cuda) for t in tris), cpt.SEED_SPAN)
    assert _same_state([g.cpu() for g in got], want)


@pytest.mark.parametrize("shape", [[24, 20, 16], [48, 48, 48]])
def test_cpt_grid_distance_cuda_matches_cpu(cuda, shape):
    """Forward through the sweep kernel (6 launches, no plain version),
    distances and ids equal to the CPU's; backward within the gradient
    tolerance."""
    verts, faces = icosphere(3)
    grid = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, shape)
    fn = autodiff.make_cpt_grid_distance(grid, faces, verts)
    v = torch.from_numpy(verts)
    d_p, i_p = fn.forward(v)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        d_p.shape).astype(np.float32))
    before = (sweep.COUNT.kernel, sweep.COUNT.plain)
    d_k, i_k = fn.forward(v.to(cuda))
    torch.cuda.synchronize()
    assert (sweep.COUNT.kernel, sweep.COUNT.plain) == (before[0] + 6,
                                                       before[1])
    assert _same_state((d_k.cpu(), i_k.cpu()), (d_p, i_p))
    _close_grads(fn.vjp(v.to(cuda), d_k, i_k, g.to(cuda)),
                 fn.vjp(v, d_p, i_p, g))


def test_cpt_engine_fit_on_cuda(cuda):
    """tests/test_cpt.py::test_differentiable_sdf_cpt_engine on the card."""
    verts, faces = icosphere(2)
    grid = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, [24] * 3)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    target = tm.generate_grid_sdf(verts * np.float32(1.15), topo, grid,
                                  tm.SignMethod.NORMAL).abs()
    model = sdf_layer.DifferentiableSDF(faces, grid, learning_rate=5e-2,
                                        engine="cpt", vertices_example=verts)
    state = model.init(verts)
    assert state.params.device.type == "cuda"
    losses = []
    for _ in range(6):
        state, loss = model.train_step(state, target.reshape(24, 24, 24))
        losses.append(float(loss))
    assert losses[-1] < 0.7 * losses[0], losses


@pytest.mark.parametrize("sign", [tm.SignMethod.RAYCAST,
                                  tm.SignMethod.NORMAL])
def test_sdf_grid_cuda_matches_cpu(cuda, sign):
    """The dense engine's grid: the RAYCAST sign through the dense parity
    kernel (one launch per axis); values and vertex gradients as the
    CPU's."""
    verts, faces = icosphere(2)
    grid = tm.Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [16, 12, 10])
    tri = torch.from_numpy(sdf_layer.pad_tri_idx(faces, 64))
    target = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (16, 12, 10)).astype(np.float32))

    def run(device):
        v = torch.from_numpy(verts).to(device).requires_grad_(True)
        out = sdf_layer.sdf_grid(v, tri.to(device), grid, sign, block=64)
        torch.sum((out - target.to(device)) ** 2).backward()
        return out.detach().cpu(), v.grad

    want, g_want = run("cpu")
    before = parity.DENSE_COUNT.kernel
    got, g_got = run(cuda)
    assert parity.DENSE_COUNT.kernel == before + (
        3 if sign == tm.SignMethod.RAYCAST else 0)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    _close_grads(g_got, g_want)


@pytest.mark.parametrize("sign", [tm.SignMethod.RAYCAST,
                                  tm.SignMethod.NORMAL])
def test_sdf_at_points_cuda_matches_cpu(cuda, sign):
    verts, faces = icosphere(3)
    tri = torch.from_numpy(sdf_layer.pad_tri_idx(faces, 512))
    q = np.random.default_rng(2).uniform(-1.3, 1.3, (3000, 3)).astype(
        np.float32)

    def run(device):
        v = torch.from_numpy(verts).to(device).requires_grad_(True)
        qq = torch.from_numpy(q).to(device).requires_grad_(True)
        out = sdf_layer.sdf_at_points(v, tri.to(device), qq, sign)
        torch.sum(out ** 2).backward()
        return out.detach().cpu(), v.grad, qq.grad

    want = run("cpu")
    got = run(cuda)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    _close_grads(got[1], want[1])
    _close_grads(got[2], want[2])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_kernel_matches_plain_on_a_512_plane_slab(cuda, axis, reverse):
    """A slab of the streamed grid at 512 wide: along x the plane has 1 024
    tiles, more than the card keeps resident, so each CTA owns several;
    along y and z the sweep walks 512 slices. Bit-equal to the plain
    version."""
    grid, tris, state = _sweep_inputs(icosphere(3), [8, 512, 512], cuda)
    args = (tris, reverse, grid.first_cell, grid.cell_size)
    work = [t.clone() for t in state]
    got = sweep.sweep_axis(*work, *args, axis=axis)
    want = sweep.sweep_axis_plain(*[t.clone() for t in state], *args,
                                  axis=axis)
    torch.cuda.synchronize()
    assert _same_state(got, want)


@pytest.mark.parametrize("sign", [tm.SignMethod.RAYCAST,
                                  tm.SignMethod.NORMAL])
def test_streamed_grid_cuda_matches_cpu(cuda, sign):
    """The slab-streamed grid on the card (every sweep and parity call a
    kernel launch, no plain version) against the same call on the CPU."""
    verts, faces = icosphere(3)
    grid = tm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [64, 32, 32])
    gridgen_streamed._STREAM_PREP_CACHE.clear()
    sweep.COUNT.reset()
    parity.COUNT.reset()
    got = gridgen_streamed.generate_grid_sdf_streamed(verts, faces, grid,
                                                      sign, slab_nx=16)
    n_slabs = 4
    assert sweep.COUNT.kernel == 2 * n_slabs * 8 and sweep.COUNT.plain == 0
    assert parity.COUNT.kernel == (
        3 * n_slabs if sign == tm.SignMethod.RAYCAST else 0)
    assert parity.COUNT.plain == 0
    assert got.device.type == "cpu" and got.shape == (64 * 32 * 32,)
    want = gridgen_streamed.generate_grid_sdf_streamed(
        verts, faces, grid, sign, slab_nx=16, device="cpu")
    gridgen_streamed._STREAM_PREP_CACHE.clear()
    torch.testing.assert_close(got.abs(), want.abs(), rtol=RTOL, atol=ATOL)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


# ------------------------------------------------------------------ render/
def _render_inputs():
    """(grid, distances, camera) of tests/test_torch_render.py's sizes: a
    24³ icosphere(3) grid (the port's CPU route) and 48×48 images."""
    from mesh_to_sdf_tpu_torch.render import Camera

    verts, faces = icosphere(3)
    grid = tm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [24] * 3)
    dist = tm.generate_grid_sdf(verts, tm.Topology.triangle_list(
        faces.reshape(-1)), grid, tm.SignMethod.RAYCAST, flat=False,
        device="cpu")
    return grid, dist, Camera.orbit(grid, width=48, height=48)


def _same_image(got, want):
    """Hit masks equal on ≥ 99.5 % of the pixels, within 2/255 where both
    hit (the CPU tests' tolerance against JAX)."""
    got, want = got.cpu().numpy(), want.numpy()
    hg, hw = got.sum(-1) > 0, want.sum(-1) > 0
    assert (hg == hw).mean() >= 0.995
    assert np.abs(got - want)[hg & hw].max(initial=0.0) <= 2.0 / 255.0


@pytest.mark.parametrize("mode", ["snap", "trilinear", "tetrahedral",
                                  "snap_stylized"])
def test_render_card_matches_cpu(cuda, mode):
    from mesh_to_sdf_tpu_torch.render import RaymarchMode, render

    grid, dist, cam = _render_inputs()
    want = render(dist, grid, cam, mode=RaymarchMode(mode))
    got = render(dist.to(cuda), grid, cam, mode=RaymarchMode(mode))
    assert got.device.type == "cuda"
    _same_image(got, want)


def test_render_voxels_card_matches_cpu(cuda):
    from mesh_to_sdf_tpu_torch.render import dda_trace, band_occupancy
    from mesh_to_sdf_tpu_torch.render import render_voxels

    grid, dist, cam = _render_inputs()
    _same_image(render_voxels(dist.to(cuda), grid, cam),
                render_voxels(dist, grid, cam))
    occ = band_occupancy(dist, grid)
    o, d = cam.rays("cpu")
    want = dda_trace(occ, grid, o, d)
    got = dda_trace(occ.to(cuda), grid, o.to(cuda), d.to(cuda))
    hit = got[0].cpu() & want[0]
    assert (got[0].cpu() == want[0]).float().mean() >= 0.995
    torch.testing.assert_close(got[1].cpu()[hit], want[1][hit], rtol=0,
                               atol=1e-5)
    assert torch.equal(got[2].cpu()[hit], want[2][hit])


def test_trace_mesh_card_matches_cpu(cuda):
    from mesh_to_sdf_tpu_torch.render import render_model, trace_mesh

    grid, _, cam = _render_inputs()
    verts, faces = icosphere(2)
    soup = [torch.from_numpy(np.ascontiguousarray(verts[faces[:, k]]))
            for k in range(3)]
    o, d = cam.rays("cpu")
    want = trace_mesh(o, d, *soup)
    got = trace_mesh(o.to(cuda), d.to(cuda), *[s.to(cuda) for s in soup])
    hit = got[4].cpu() & want[4]
    assert (got[4].cpu() == want[4]).float().mean() >= 0.995
    torch.testing.assert_close(got[0].cpu()[hit], want[0][hit], rtol=0,
                               atol=1e-5)
    assert torch.equal(got[1].cpu()[hit], want[1][hit])
    _same_image(render_model(verts, faces, cam, device=cuda),
                render_model(verts, faces, cam, device="cpu"))


def test_generate_cubemap_card_matches_cpu(cuda):
    from mesh_to_sdf_tpu_torch.render import generate_cubemap
    from mesh_to_sdf_tpu_torch.utils.meshgen import box

    v, f = box()
    colors = np.where((v[:, 0] > 0)[:, None], [1.0, 0.0, 0.0],
                      [0.0, 0.0, 1.0]).astype(np.float32)
    want = generate_cubemap(v, f, colors, res=32, device="cpu")
    got = generate_cubemap(v, f, colors, res=32, device=cuda)
    assert got.albedo.device.type == "cuda"
    same = ((got.albedo.cpu() - want.albedo).abs().amax(-1) <= 1e-5) & (
        (got.depth.cpu() == want.depth)
        | ((got.depth.cpu() - want.depth).abs() <= 1e-5))
    assert (~same).float().mean(dim=(1, 2)).max() <= 0.02
