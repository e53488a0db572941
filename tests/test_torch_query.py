"""The port's ``generate_sdf`` against the JAX package's, route by route.

The same numpy mesh (``icosphere(2)``, 320 triangles) and queries (700,
not a multiple of 1024) go through both packages. The JAX package runs
``Strategy.PALLAS`` through the Pallas interpreter on the CPU by itself
(`query.py:205`); the port runs the fused kernels' plain versions there.
Each JAX result is computed once per module (its interpret-mode
compilation is the expensive part). Distances: rtol=2e-4, atol=1e-5;
signs and crossing counts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_to_sdf_tpu as jm
import mesh_to_sdf_tpu_torch as tm
from baselines import make_icosphere
from mesh_to_sdf_tpu.ops.kernels import pallas_sdf
from mesh_to_sdf_tpu_torch.ops.kernels import sdf
from torch_port_helpers import ATOL, RTOL, soup, to_jax, to_torch

MESH = make_icosphere(subdiv=2)
QUERIES = np.random.default_rng(7).uniform(-1.5, 1.5, (700, 3)).astype(
    np.float32)

#: (strategy, sign, raycast_axes) routes of generate_sdf held against JAX.
ROUTES = [
    ("XLA", "RAYCAST", 1), ("XLA", "RAYCAST", 3), ("XLA", "NORMAL", 3),
    ("PALLAS", "RAYCAST", 0), ("PALLAS", "RAYCAST", 1),
    ("PALLAS", "RAYCAST", 3), ("PALLAS", "NORMAL", 3),
    ("AUTO", "RAYCAST", 3), ("AUTO", "NORMAL", 3),
]


def _jax_sdf(route, faces=None, queries=QUERIES):
    strategy, sign, axes = route
    v, f = MESH
    f = f if faces is None else faces
    return np.asarray(jm.generate_sdf(
        v, jm.Topology.triangle_list(f.reshape(-1)), queries,
        jm.Strategy[strategy], sign_method=jm.SignMethod[sign],
        raycast_axes=axes))


def _port_sdf(route, faces=None, queries=QUERIES, **kw):
    strategy, sign, axes = route
    v, f = MESH
    f = f if faces is None else faces
    return tm.generate_sdf(
        v, tm.Topology.triangle_list(f.reshape(-1)), queries,
        tm.Strategy[strategy], sign_method=tm.SignMethod[sign],
        raycast_axes=axes, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_results():
    return {}


def _assert_same_sdf(got, want):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.signbit(got.numpy()), np.signbit(want))


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: "-".join(map(str, r)))
def test_generate_sdf_matches_jax(route, jax_results):
    if route not in jax_results:
        jax_results[route] = _jax_sdf(route)
    want = jax_results[route]
    counts = (sdf.RAYCAST_COUNT.plain, sdf.NORMAL_COUNT.plain)
    got = _port_sdf(route)
    _assert_same_sdf(got, want)
    if route[2] > 0 and route[1] == "RAYCAST":
        assert (want < 0).any() and (want > 0).any()
    # AUTO on the CPU is the brute-force engine, as in the JAX package.
    on_kernel = route[0] == "PALLAS"
    assert ((sdf.RAYCAST_COUNT.plain, sdf.NORMAL_COUNT.plain) != counts) \
        == on_kernel


@pytest.mark.parametrize("route", [("PALLAS", "RAYCAST", 3),
                                   ("PALLAS", "NORMAL", 3),
                                   ("XLA", "RAYCAST", 3)],
                         ids=lambda r: "-".join(map(str, r)))
def test_odd_triangle_count_matches_jax(route):
    """321 triangles: not a multiple of any block size of either package
    (cf. tests/test_pallas.py:136-157)."""
    faces = MESH[1][:321]
    q = QUERIES[:333]
    _assert_same_sdf(_port_sdf(route, faces, q), _jax_sdf(route, faces, q))


@pytest.mark.parametrize("axes", [1, 3])
def test_raycast_parts_match_jax(axes):
    tris = soup(*MESH)
    want_d, want_c = pallas_sdf.sdf_raycast_parts_pallas(
        jnp.asarray(QUERIES), *to_jax(*tris), raycast_axes=axes,
        interpret=True)
    got_d, got_c = sdf.sdf_raycast_parts(*to_torch(QUERIES, *tris),
                                         raycast_axes=axes)
    assert got_c.shape == (700, axes) and got_c.dtype == torch.int32
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c.sum() > 0


def test_normal_champions_match_jax():
    tris = soup(*MESH)
    want = pallas_sdf.sdf_normal_champions_pallas(
        jnp.asarray(QUERIES), *to_jax(*tris), interpret=True)
    got = sdf.sdf_normal_champions(*to_torch(QUERIES, *tris))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_degenerate_soup_matches_jax():
    """Segment and point triangles (tests/test_pallas.py:105-133)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 3)).astype(np.float32)
    b = a.copy()
    c = rng.standard_normal((64, 3)).astype(np.float32)
    b[32:] = c[32:]
    c[48:] = a[48:]
    b[48:] = a[48:]
    q = QUERIES[:100]
    want = pallas_sdf.sdf_raycast_pallas(*to_jax(q, a, b, c), raycast_axes=0,
                                         interpret=True)
    got = sdf.sdf_raycast(*to_torch(q, a, b, c), raycast_axes=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_empty_queries_and_devices():
    v, f = MESH
    topo = tm.Topology.triangle_list(f.reshape(-1))
    out = tm.generate_sdf(v, topo, np.zeros((0, 3), np.float32),
                          device="cpu")
    assert out.shape == (0,) and out.dtype == torch.float32
    out = tm.generate_sdf(torch.from_numpy(v), topo,
                          torch.zeros((0, 3)).to("meta"))
    assert out.shape == (0,) and out.device.type == "meta"
    # Tensor queries (flat buffer) give a tensor on their device.
    q = torch.from_numpy(QUERIES[:5].reshape(-1).copy())
    out = tm.generate_sdf(v, topo, q, tm.Strategy.PALLAS)
    assert out.shape == (5,) and out.device == torch.device("cpu")
    with pytest.raises(ValueError, match="not divisible by 3"):
        tm.generate_sdf(v, topo, torch.zeros(7))


def test_numpy_inputs_do_not_run_on_the_cpu():
    """With numpy inputs and no ``device`` the entry points run on CUDA:
    on a host without it they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA (the card case is in "
                    "test_torch_kernels_cuda.py)")
    v, f = MESH
    topo = tm.Topology.triangle_list(f.reshape(-1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.generate_sdf(v, topo, QUERIES[:4])
    grid = tm.Grid.from_bounding_box([-1.0] * 3, [1.0] * 3, [4, 4, 4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.generate_grid_sdf(v, topo, grid)
    # An explicit device wins over the inputs' device.
    out = tm.generate_sdf(torch.from_numpy(v), topo, QUERIES[:4],
                          device="cpu")
    assert out.device == torch.device("cpu")


def test_no_triangles_is_f32_max():
    """An empty soup takes the brute-force path on every strategy, as in the
    JAX package: every query is F32_MAX away, on the positive side."""
    topo = tm.Topology.triangle_strip([0, 1])
    for strategy in (tm.Strategy.PALLAS, tm.Strategy.XLA):
        out = tm.generate_sdf(np.zeros((2, 3), np.float32), topo,
                              QUERIES[:3], strategy, device="cpu")
        assert (out.numpy() == np.float32(tm.F32_MAX)).all()


@pytest.mark.parametrize("acceleration", [
    tm.Strategy.CULLED, tm.AccelerationMethod.rtree(),
    tm.AccelerationMethod.rtree_bvh(),
], ids=["CULLED", "rtree", "rtree_bvh"])
def test_culled_raises(acceleration):
    """CULLED and its presets no longer raise: they match the JAX package
    (320 triangles: both take CULLED's T ≤ 2k brute-force branch; the
    culled engines themselves are held against JAX in
    tests/test_torch_culling.py)."""
    v, f = MESH
    if isinstance(acceleration, tm.AccelerationMethod):
        j_acc = jm.AccelerationMethod(jm.Strategy.CULLED,
                                      jm.SignMethod[acceleration.sign_method
                                                    .name])
    else:
        j_acc = jm.Strategy.CULLED
    want = np.asarray(jm.generate_sdf(
        v, jm.Topology.triangle_list(f.reshape(-1)), QUERIES, j_acc))
    got = tm.generate_sdf(v, tm.Topology.triangle_list(f.reshape(-1)),
                          QUERIES, acceleration, device="cpu")
    _assert_same_sdf(got, want)


def test_kernel_wrappers_validate_inputs():
    tris = to_torch(*soup(*MESH))
    q = torch.from_numpy(QUERIES[:8].copy())
    with pytest.raises(ValueError, match="queries"):
        sdf.raycast_raw(q.double(), *tris, raycast_axes=1)
    with pytest.raises(ValueError, match="tb"):
        sdf.normal_raw(q, tris[0], tris[1][:5], tris[2])
    with pytest.raises(ValueError, match="contiguous"):
        sdf.raycast_raw(q.t().contiguous().t(), *tris, raycast_axes=1)
    with pytest.raises(ValueError, match="raycast_axes"):
        sdf.raycast_raw(q, *tris, raycast_axes=4)
    with pytest.raises(ValueError, match="no kernel"):
        sdf.normal_raw(q.to("meta"), *(t.to("meta") for t in tris))


def test_kernel_wrappers_row_limit():
    """The wrappers take up to MAX_ROWS queries (the kernels index them in
    64 bits, so 3·Q may pass 2^31) and refuse more. Meta tensors hold no
    data: the call stops at the size check or at the device check."""
    tris = tuple(t.to("meta") for t in to_torch(*soup(*MESH)))
    big = torch.empty((715_827_883, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sdf.raycast_raw(big, *tris, raycast_axes=1)
    too_big = torch.empty((sdf.MAX_ROWS + 1, 3), device="meta")
    with pytest.raises(ValueError, match="more than"):
        sdf.normal_raw(too_big, *tris)
    tris_big = (torch.empty((sdf.MAX_ROWS + 1, 3), device="meta"),) * 3
    with pytest.raises(ValueError, match="more than"):
        sdf.raycast_raw(big[:4], *tris_big, raycast_axes=0)
