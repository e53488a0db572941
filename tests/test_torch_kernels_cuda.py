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
from mesh_to_sdf_tpu_torch import gridgen, query
from mesh_to_sdf_tpu_torch.ops import cpt, culling
from mesh_to_sdf_tpu_torch.ops.kernels import culled, parity, sdf, sweep
from mesh_to_sdf_tpu_torch.ops.raycast import face_origins
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere, torus

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


def _oriented_state(grid, tris, bins, axis):
    seed = cpt.seed_from_bins(grid, tris[0], tris[1], tris[2], bins)
    state = cpt.sweep_state(grid, tris[0], tris[1], tris[2], seed)
    if axis:
        return cpt._relayout(state, cpt._PERM3[axis], cpt._PERM4[axis])
    return state


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_kernel_matches_plain(cuda, axis, reverse):
    grid, tris, bins, _ = _prep(icosphere(2), [20, 18, 16], cuda)
    state = _oriented_state(grid, tris, bins, axis)
    c0, c1, c2 = cpt._COMPS[axis]
    args = (reverse, grid.first_cell, grid.cell_size)
    kw = dict(comp0=c0, comp1=c1, comp2=c2)
    before = sweep.COUNT.kernel
    got = sweep.sweep_oriented(*[t.clone() for t in state], *args, **kw)
    want = sweep.sweep_oriented_plain(*[t.clone() for t in state], *args,
                                      **kw)
    torch.cuda.synchronize()
    assert sweep.COUNT.kernel == before + 1
    for k in (0, 3):
        torch.testing.assert_close(got[k], want[k], rtol=RTOL, atol=ATOL)
    assert float((got[2] == want[2]).float().mean()) > 0.99


def test_closest_point_grid_cuda_matches_cpu(cuda):
    grid, tris, bins, _ = _prep(icosphere(2), [24, 20, 16], cuda)
    seed = cpt.seed_from_bins(grid, tris[0], tris[1], tris[2], bins)
    d_k, _ = cpt.closest_point_grid(grid, tris[0], tris[1], tris[2],
                                    seed=seed, rounds=2)
    d_p, _ = cpt.closest_point_grid(grid, *(t.cpu() for t in tris),
                                    seed=[s.cpu() for s in seed], rounds=2)
    torch.testing.assert_close(d_k.cpu(), d_p, rtol=RTOL, atol=ATOL)


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


def _degenerate(device):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 3)).astype(np.float32)
    b = a.copy()
    c = rng.standard_normal((64, 3)).astype(np.float32)
    b[32:] = c[32:]
    c[48:] = a[48:]
    b[48:] = a[48:]
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


def _culled_inputs(engine, device, n_queries=16384):
    """(queries, rows, tbl, group, n_blocks, anchors) as the CULLED engines
    give them to the kernel, on icosphere(6) (81 920 triangles, 320
    blocks): gather st=64 kg=32, widen st=16 kg=128, union qt=1024 with and
    without anchors."""
    verts, faces = icosphere(6)
    tris = [verts[faces[:, k]] for k in range(3)]
    bi = culled.build_block_index(*tris, device=device)
    q = _queries(n_queries, device)
    q = q[culling._morton_order(q)]
    grid = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [128] * 3)
    if engine.startswith("union"):
        tbl, _, _ = culled.select_blocks(q, bi, nb_sub=48, st=64, qt=1024,
                                         nb_table=256)
        anchors = (culling._anchor_cells(q, grid)[1]
                   if engine == "union-anchors" else None)
        return q, bi.rows, tbl, 1024, bi.n_blocks, anchors
    st, kg = (64, 32) if engine == "gather" else (16, 128)
    centers, r_s = culled._sub_tiles(q, st)
    idx, _ = culled._phase_a_topk(centers, r_s, bi, kg=kg)
    return (q, bi.gather_rows, idx, st, bi.n_blocks,
            culling._anchor_cells(q, grid)[1])


@pytest.mark.parametrize("engine", ["gather", "widen", "union-anchors",
                                    "union"])
def test_culled_kernel_matches_plain(cuda, engine):
    """The block-culled kernel at each engine's group shape: d² and
    crossing counts equal to the plain version's (max abs err 0)."""
    q, rows, tbl, group, B, anchors = _culled_inputs(engine, cuda)
    kw = dict(group=group, n_blocks=B, anchors=anchors)
    before = culled.COUNT.kernel
    d_k, c_k = culled.culled_blocks(q, rows, tbl, **kw)
    d_p, c_p = culled.culled_blocks_plain(q, rows, tbl, **kw)
    torch.cuda.synchronize()
    assert culled.COUNT.kernel == before + 1
    assert torch.equal(d_k, d_p)
    if anchors is None:
        assert c_k is None and c_p is None
    else:
        assert torch.equal(c_k, c_p) and int(c_k.sum()) > 0


@pytest.mark.parametrize("engine", ["gather", "union"])
def test_auto_takes_culled_on_cuda(cuda, engine, monkeypatch):
    """Numpy inputs with no device run on the card; AUTO sends 8 192
    raycast queries on 81 920 triangles to CULLED through the kernel. The
    answer matches PALLAS: distances within tolerance, signs apart on at
    most 1e-4 of the queries (at least 1: the TPU's own CULLED record,
    ROADMAP.md section 3)."""
    monkeypatch.setenv("M2S_CULLED_ENGINE", engine)
    for cache in (query._SIGN_GRID_CACHE, query._PARITY_BINS_CACHE,
                  query._BLOCK_INDEX_CACHE, culling._ROUTE_CACHE):
        cache.clear()
    verts, faces = icosphere(6)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    q = np.random.default_rng(2).uniform(-1.3, 1.3, (8192, 3)).astype(
        np.float32)
    culled.COUNT.reset()
    got = tm.generate_sdf(verts, topo, q)
    assert got.device.type == "cuda" and got.shape == (8192,)
    assert culled.COUNT.kernel > 0 and culled.COUNT.plain == 0
    assert culling.LAST_CULLED_STATS["engine"] == engine
    want = tm.generate_sdf(verts, topo, q, tm.Strategy.PALLAS)
    torch.testing.assert_close(got.abs(), want.abs(), rtol=RTOL, atol=ATOL)
    assert int((torch.signbit(got) != torch.signbit(want)).sum()) <= max(
        1, int(1e-4 * len(q)))
    culling._ROUTE_CACHE.clear()


def test_numpy_inputs_run_on_the_card(cuda):
    verts, faces = icosphere(2)
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    out = tm.generate_sdf(verts, topo, np.zeros((5, 3), np.float32))
    assert out.device.type == "cuda"
    grid = tm.Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [8, 8, 8])
    assert tm.generate_grid_sdf(verts, topo, grid).device.type == "cuda"
