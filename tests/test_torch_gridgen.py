"""The port's whole grid path, ``generate_grid_sdf`` through CPT with the
raycast sign, against the JAX package.

The JAX reference is composed from the TPU route's own pieces, with the
Pallas kernels in interpret mode (torch_port_helpers.jax_composed_grid_sdf).
Distances: rtol=2e-4, atol=1e-5 (the frameworks fuse the float32 ladder
differently); signs: exactly equal. On cubic grids the JAX package's CPU
route would run batched Jacobi sweeps, the TPU route and the port
Gauss-Seidel ones, so those are compared with the composed reference only.
"""
import numpy as np
import pytest
import torch

from baselines import make_box, make_icosphere
from mesh_to_sdf_tpu import Grid as JGrid
from mesh_to_sdf_tpu import Strategy as JStrategy
from mesh_to_sdf_tpu import Topology as JTopology
from mesh_to_sdf_tpu import gridgen as jgridgen
from mesh_to_sdf_tpu.utils.meshgen import torus
import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch import gridgen as tgridgen
from torch_port_helpers import (assert_same_field, jax_composed_grid_sdf,
                                port_grid, port_grid_sdf)


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
    shaped = tm.generate_grid_sdf(verts, topo, tg, flat=False)
    flat = tm.generate_grid_sdf(torch.from_numpy(verts), topo, tg)
    assert shaped.shape == (9, 7, 8) and flat.shape == (9 * 7 * 8,)
    assert flat.device == shaped.device == torch.device("cpu")
    np.testing.assert_array_equal(flat.numpy(), shaped.reshape(-1).numpy())


def test_strategy_resolution():
    verts, faces = make_icosphere(subdiv=1)
    tg = tm.Grid.from_bounding_box([-1.2] * 3, [1.2] * 3, [10, 10, 10])
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    ref = tm.generate_grid_sdf(verts, topo, tg).numpy()
    for strategy in (tm.Strategy.AUTO, tm.Strategy.CPT,
                     tm.AccelerationMethod(tm.Strategy.CPT,
                                           tm.SignMethod.RAYCAST)):
        out = tm.generate_grid_sdf(verts, topo, tg, strategy=strategy)
        np.testing.assert_array_equal(out.numpy(), ref)
    assert len(tgridgen._CPT_PREP_CACHE) == 1  # host prep ran once


@pytest.mark.parametrize("kwargs", [
    {"strategy": tm.Strategy.XLA},
    {"strategy": tm.Strategy.PALLAS},
    {"strategy": tm.Strategy.CULLED},
    {"strategy": tm.AccelerationMethod.none()},
    {"strategy": tm.AccelerationMethod.bvh()},
    {"strategy": tm.AccelerationMethod.rtree()},
    {"strategy": tm.AccelerationMethod.rtree_bvh()},
    {"exact": True},
    {"sign_method": tm.SignMethod.NORMAL},
    {"strategy": tm.AccelerationMethod(tm.Strategy.CPT,
                                       tm.SignMethod.NORMAL)},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_routes_raise(kwargs):
    verts, faces = make_box()
    tg = tm.Grid.from_bounding_box([-1.0] * 3, [1.0] * 3, [4, 4, 4])
    topo = tm.Topology.triangle_list(faces.reshape(-1))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tm.generate_grid_sdf(verts, topo, tg, **kwargs)


def test_empty_mesh_is_f32_max():
    tg = tm.Grid.from_bounding_box([-1.0] * 3, [1.0] * 3, [3, 4, 5])
    topo = tm.Topology.triangle_list(np.zeros((0,), np.uint32))
    out = tm.generate_grid_sdf(np.zeros((0, 3), np.float32), topo, tg)
    assert out.shape == (60,)
    assert (out.numpy() == np.float32(tm.F32_MAX)).all()
    strip = tm.Topology.triangle_strip([0, 1])
    out = tm.generate_grid_sdf(np.zeros((2, 3), np.float32), strip, tg,
                               flat=False)
    assert out.shape == (3, 4, 5)
    assert (out.numpy() == np.float32(tm.F32_MAX)).all()
