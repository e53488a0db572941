"""The port's ``generate_grid_sdf`` against the JAX package, route by
route: CPT (raycast and normal sign), the dense PALLAS and XLA routes, and
the AUTO cost model that chooses between them.

The CPT reference is composed from the JAX TPU route's own pieces, with the
Pallas kernels in interpret mode (torch_port_helpers.jax_composed_grid_sdf);
the dense routes are held against JAX ``generate_grid_sdf`` with the same
strategy on the CPU. Distances: rtol=2e-4, atol=1e-5 (the frameworks fuse
the float32 ladder differently); signs: exactly equal. On cubic grids the
JAX package's CPU CPT route would run batched Jacobi sweeps, the TPU route
and the port Gauss-Seidel ones, so those are compared with the composed
reference only.
"""
import numpy as np
import pytest
import torch

from baselines import make_box, make_icosphere
import mesh_to_sdf_tpu as jm
from mesh_to_sdf_tpu import Grid as JGrid
from mesh_to_sdf_tpu import Strategy as JStrategy
from mesh_to_sdf_tpu import Topology as JTopology
from mesh_to_sdf_tpu import gridgen as jgridgen
from mesh_to_sdf_tpu.ops import cpt as jcpt
from mesh_to_sdf_tpu.utils.meshgen import torus
import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch import gridgen as tgridgen
from mesh_to_sdf_tpu_torch.ops import cpt as tcpt
from mesh_to_sdf_tpu_torch.ops.kernels import sweep
from torch_port_helpers import (assert_same_field, jax_composed_grid_sdf,
                                port_grid, port_grid_sdf, soup, to_jax,
                                to_torch)


@pytest.fixture(autouse=True)
def _clear_port_prep_cache():
    tgridgen._CPT_PREP_CACHE.clear()
    yield
    tgridgen._CPT_PREP_CACHE.clear()


TORUS = (lambda: torus(1.0, 0.35, n_major=32, n_minor=16),
         [-1.5, -0.6, -1.5], [1.5, 0.6, 1.5], (20, 16, 24))
CASES = {
    "icosphere-24": (lambda: make_icosphere(subdiv=2),
                     [-1.3] * 3, [1.3] * 3, (24, 24, 24)),
    # Box faces are longer than 8 cells: the prep subdivides them. Same
    # grid shape as above, so it shares the interpret-mode compilations.
    "box-24": (lambda: make_box(size=(1.8, 1.2, 1.5)),
               [-1.3] * 3, [1.3] * 3, (24, 24, 24)),
    "torus-20x16x24": TORUS,
}


@pytest.mark.parametrize("name", CASES)
def test_slice_matches_jax_composed(name):
    mesh_fn, lo, hi, shape = CASES[name]
    verts, faces = mesh_fn()
    jg = JGrid.from_bounding_box(lo, hi, list(shape))
    want = jax_composed_grid_sdf(jg, verts, faces)
    got = port_grid_sdf(verts, faces, port_grid(jg), flat=False)
    assert got.shape == shape and got.dtype == torch.float32
    assert_same_field(got.numpy(), want)
    assert (want < 0).any() and (want > 0).any()
    if name == "box-24":
        (tris, _, _), = tgridgen._CPT_PREP_CACHE.values()
        assert tris.shape[1] > len(faces)  # the prep subdivided the soup


def test_matches_jax_generate_grid_sdf_noncubic():
    """The JAX CPU route (sequential XLA sweeps, exact XLA parity) on a
    non-cubic grid, where its schedule is the TPU's Gauss-Seidel one."""
    mesh_fn, lo, hi, shape = TORUS
    verts, faces = mesh_fn()
    jg = JGrid.from_bounding_box(lo, hi, list(shape))
    want = np.asarray(jgridgen.generate_grid_sdf(
        verts, JTopology.triangle_list(faces.reshape(-1)), jg,
        strategy=JStrategy.CPT,
    ))
    got = port_grid_sdf(verts, faces, port_grid(jg))
    assert got.shape == (int(np.prod(shape)),)
    assert_same_field(got.numpy(), want)


def test_analytic_sphere():
    verts, faces = make_icosphere(subdiv=2)
    tg = tm.Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [16, 16, 16])
    sdf = port_grid_sdf(verts, faces, tg, flat=False).numpy()
    r = np.linalg.norm(tg.all_cell_centers().numpy(), axis=-1)
    assert np.abs(sdf - (r - 1.0)).max() < 0.05
    far = np.abs(r - 1.0) > 2 * 2.8 / 16
    np.testing.assert_array_equal(sdf[far] < 0, r[far] < 1.0)


def test_flat_layout_and_input_types():
    verts, faces = make_icosphere(subdiv=1)
    tg = tm.Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [9, 7, 8])
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    shaped = tm.generate_grid_sdf(verts, topo, tg, flat=False, device="cpu")
    flat = tm.generate_grid_sdf(torch.from_numpy(verts), topo, tg)
    assert shaped.shape == (9, 7, 8) and flat.shape == (9 * 7 * 8,)
    assert flat.device == shaped.device == torch.device("cpu")
    np.testing.assert_array_equal(flat.numpy(), shaped.reshape(-1).numpy())


def test_strategy_resolution(monkeypatch):
    verts, faces = make_icosphere(subdiv=1)
    tg = tm.Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [10, 10, 10])
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    cpu = {"device": "cpu"}
    cpt_out = tm.generate_grid_sdf(verts, topo, tg, strategy=tm.Strategy.CPT,
                                   **cpu)
    out = tm.generate_grid_sdf(
        verts, topo, tg,
        strategy=tm.AccelerationMethod(tm.Strategy.CPT, tm.SignMethod.RAYCAST),
        **cpu)
    np.testing.assert_array_equal(out.numpy(), cpt_out.numpy())
    assert len(tgridgen._CPT_PREP_CACHE) == 1  # host prep ran once
    # The cost model's constants come from the environment when set: a slow
    # dense engine sends AUTO to CPT.
    monkeypatch.setenv("M2S_AUTO_DENSE_PAIRS_PER_S", "1")
    out = tm.generate_grid_sdf(verts, topo, tg, **cpu)
    np.testing.assert_array_equal(out.numpy(), cpt_out.numpy())
    monkeypatch.delenv("M2S_AUTO_DENSE_PAIRS_PER_S")
    xla = tm.generate_grid_sdf(verts, topo, tg, strategy=tm.Strategy.XLA,
                               **cpu)
    np.testing.assert_array_equal(tm.generate_grid_sdf(verts, topo, tg, **cpu)
                                  .numpy(), xla.numpy())


def test_auto_takes_the_dense_route_on_small_grids():
    """JAX's AUTO compares the dense engine's O(cells·tris) cost with CPT's
    overhead + O(cells) (`gridgen.py:362-372`); with the "cpu" constants a
    10³ grid of 80 triangles is dense (exact) in both packages."""
    verts, faces = make_icosphere(subdiv=1)
    jg = JGrid.from_bounding_box([-1.2] * 3, [1.2] * 3, [10, 10, 10])
    want = np.asarray(jgridgen.generate_grid_sdf(
        verts, JTopology.triangle_list(faces.reshape(-1)), jg))
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    sweep.COUNT.reset()
    got = tm.generate_grid_sdf(verts, topo, port_grid(jg), device="cpu")
    assert sweep.COUNT.plain == 0 and sweep.COUNT.kernel == 0
    xla = tm.generate_grid_sdf(verts, topo, port_grid(jg),
                               strategy=tm.Strategy.XLA, device="cpu")
    np.testing.assert_array_equal(got.numpy(), xla.numpy())
    assert_same_field(got.numpy(), want)


@pytest.mark.parametrize("device,n_cells,n_tris,route", [
    ("cpu", 10 ** 3, 80, "XLA"), ("cpu", 256 ** 3, 20480, "CPT"),
    ("cuda", 10 ** 3, 80, "PALLAS"), ("cuda", 64 ** 3, 20480, "PALLAS"),
    ("cuda", 128 ** 3, 20480, "CPT"), ("cuda", 256 ** 3, 1280, "CPT"),
], ids=str)
def test_auto_cost_model(device, n_cells, n_tris, route):
    """The measured "cuda" constants send small problems to the fused
    kernels and large ones to CPT; the CPU keeps the JAX numbers."""
    got = tgridgen._auto_route(n_tris, n_cells, torch.device(device))
    assert got == tm.Strategy[route]


#: The XLA/PALLAS strategies, their AccelerationMethod presets and the
#: NORMAL sign, each held against the JAX package with the same arguments
#: (non-cubic grid: the JAX CPU CPT route then sweeps in the same order as
#: the port).
PORTED = [
    {"strategy": tm.Strategy.XLA},
    {"strategy": tm.Strategy.PALLAS},
    {"strategy": tm.AccelerationMethod.none()},
    {"strategy": tm.AccelerationMethod.bvh()},
    {"sign_method": tm.SignMethod.NORMAL},
    {"strategy": tm.AccelerationMethod(tm.Strategy.CPT,
                                       tm.SignMethod.NORMAL)},
]


def _to_jax_kwargs(kwargs):
    out = {}
    for k, v in kwargs.items():
        if isinstance(v, tm.AccelerationMethod):
            v = jm.AccelerationMethod(jm.Strategy[v.strategy.name],
                                      jm.SignMethod[v.sign_method.name])
        elif isinstance(v, (tm.Strategy, tm.SignMethod)):
            v = getattr(jm, type(v).__name__)[v.name]
        out[k] = v
    return out


@pytest.mark.parametrize("kwargs", PORTED,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_ported_routes_match_jax(kwargs):
    verts, faces = make_icosphere(subdiv=1)
    # Even counts: no ray runs through the mesh's vertices on the grid's
    # mid-planes, where the JAX CPU parity engine and the TPU kernel's
    # arithmetic (which the port follows) may break the tie differently.
    jg = JGrid.from_bounding_box([-1.2] * 3, [1.2] * 3, [10, 8, 6])
    want = np.asarray(jgridgen.generate_grid_sdf(
        verts, JTopology.triangle_list(faces.reshape(-1)), jg,
        **_to_jax_kwargs(kwargs)))
    got = tm.generate_grid_sdf(verts, tm.Topology.triangle_list(
        faces.reshape(-1)), port_grid(jg), device="cpu", **kwargs)
    assert got.shape == (10 * 8 * 6,)
    assert_same_field(got.numpy(), want)
    assert (want < 0).any() and (want > 0).any()


@pytest.mark.parametrize("sign", ["RAYCAST", "NORMAL"])
@pytest.mark.parametrize("strategy", ["XLA", "PALLAS"])
def test_dense_routes_match_jax(strategy, sign):
    """The JAX package's XLA and PALLAS grid routes at 16³ (PALLAS through
    the interpreter, the raycast sign from its exact XLA parity engine)."""
    verts, faces = make_icosphere(subdiv=2)
    jg = JGrid.from_bounding_box([-1.3] * 3, [1.3] * 3, [16, 16, 16])
    want = np.asarray(jgridgen.generate_grid_sdf(
        verts, JTopology.triangle_list(faces.reshape(-1)), jg,
        jm.SignMethod[sign], strategy=JStrategy[strategy], flat=False))
    got = tm.generate_grid_sdf(
        verts, tm.Topology.triangle_list(faces.reshape(-1)), port_grid(jg),
        tm.SignMethod[sign], strategy=tm.Strategy[strategy], flat=False,
        device="cpu")
    assert got.shape == (16, 16, 16)
    assert_same_field(got.numpy(), want)


def test_normal_sign_from_idx_matches_jax():
    verts, faces = make_icosphere(subdiv=2)
    tris = soup(verts, faces)
    jg = JGrid.from_bounding_box([-1.3] * 3, [1.3] * 3, [10, 9, 8])
    rng = np.random.default_rng(4)
    dist = rng.uniform(0.0, 1.0, jg.cell_count).astype(np.float32)
    idx = rng.integers(-1, len(faces), jg.cell_count).astype(np.int32)
    want = np.asarray(jcpt.normal_sign_from_idx(jg, *to_jax(*tris, dist,
                                                            idx)))
    got = tcpt.normal_sign_from_idx(port_grid(jg), *to_torch(*tris, dist,
                                                             idx))
    assert got.shape == jg.cell_count
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any() and (want > 0).any()


@pytest.mark.parametrize("kwargs", [
    {"strategy": tm.Strategy.CULLED},
    {"strategy": tm.AccelerationMethod.rtree()},
    {"strategy": tm.AccelerationMethod.rtree_bvh()},
    {"exact": True},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_routes_raise(kwargs):
    """The routes that raised before CULLED was ported now match the JAX
    package (12 box triangles: the candidate budget covers the soup, so
    both take the dense branch of ``grid_distance_culled``; the culled
    passes are held against JAX in tests/test_torch_culling.py)."""
    verts, faces = make_box()
    jg = JGrid.from_bounding_box([-1.0] * 3, [1.0] * 3, [4, 4, 4])
    want = np.asarray(jgridgen.generate_grid_sdf(
        verts, JTopology.triangle_list(faces.reshape(-1)), jg,
        **_to_jax_kwargs(kwargs)))
    got = tm.generate_grid_sdf(verts, tm.Topology.triangle_list(
        faces.reshape(-1)), port_grid(jg), device="cpu", **kwargs)
    assert_same_field(got.numpy(), want)
    assert (want < 0).any() and (want > 0).any()


def test_empty_mesh_is_f32_max():
    tg = tm.Grid.from_bounding_box([-1.0] * 3, [1.0] * 3, [3, 4, 5])
    topo = tm.Topology.triangle_list(np.zeros((0,), np.uint32))
    out = tm.generate_grid_sdf(np.zeros((0, 3), np.float32), topo, tg,
                               device="cpu")
    assert out.shape == (60,)
    assert (out.numpy() == np.float32(tm.F32_MAX)).all()
    strip = tm.Topology.triangle_strip([0, 1])
    out = tm.generate_grid_sdf(np.zeros((2, 3), np.float32), strip, tg,
                               flat=False, device="cpu")
    assert out.shape == (3, 4, 5)
    assert (out.numpy() == np.float32(tm.F32_MAX)).all()
