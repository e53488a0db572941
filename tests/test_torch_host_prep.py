"""Host prep of the port (seed bins, line bins, subdivision, grid math) is
byte-equal to the JAX package's: the carried state of the grid path."""
import numpy as np
import pytest

from baselines import make_icosphere
from mesh_to_sdf_tpu import Grid as JGrid
from mesh_to_sdf_tpu import native as jnative
from mesh_to_sdf_tpu.grid import np_grid_cell_centers
from mesh_to_sdf_tpu.ops import cpt as jcpt
from mesh_to_sdf_tpu.ops import raycast as jraycast
from mesh_to_sdf_tpu.ops.kernels import pallas_parity
from mesh_to_sdf_tpu.utils.meshgen import box, torus
from mesh_to_sdf_tpu_torch import gridgen
from mesh_to_sdf_tpu_torch import native as tnative
from mesh_to_sdf_tpu_torch.ops import cpt as tcpt
from mesh_to_sdf_tpu_torch.ops import raycast as traycast
from mesh_to_sdf_tpu_torch.ops.kernels import parity as tparity
from torch_port_helpers import port_grid, soup


@pytest.fixture(autouse=True)
def _clear_port_prep_cache():
    gridgen._CPT_PREP_CACHE.clear()
    yield
    gridgen._CPT_PREP_CACHE.clear()


CASES = {
    "icosphere-16x16x12": (
        lambda: make_icosphere(subdiv=2),
        lambda: JGrid.from_bounding_box([-1.3] * 3, [1.3] * 3, [16, 16, 12]),
    ),
    "torus-13x11x9": (
        lambda: torus(1.0, 0.35, n_major=24, n_minor=12),
        lambda: JGrid.from_bounding_box([-1.5] * 3, [1.5] * 3, [13, 11, 9]),
    ),
    # Negative cell size on x and z (`grid.rs:25`).
    "icosphere-negative-cell-size": (
        lambda: make_icosphere(subdiv=2),
        lambda: JGrid.from_bounding_box([1.3, -1.3, 1.2], [-1.3, 1.3, -1.2],
                                        [12, 10, 14]),
    ),
}


def _case(name):
    mesh_fn, grid_fn = CASES[name]
    jg = grid_fn()
    return soup(*mesh_fn()), jg, port_grid(jg)


@pytest.mark.parametrize("name", CASES)
def test_grid_parameters_and_centers(name):
    _, jg, tg = _case(name)
    from mesh_to_sdf_tpu_torch import Grid

    lo, hi = (np.asarray(b, np.float32) for b in jg.bounding_box())
    rebuilt = Grid.from_bounding_box(lo, hi, jg.cell_count)
    # from_bounding_box runs the same float32 arithmetic in both packages.
    jg2 = JGrid.from_bounding_box(lo, hi, jg.cell_count)
    np.testing.assert_array_equal(rebuilt.first_cell.numpy(),
                                  np.asarray(jg2.first_cell))
    np.testing.assert_array_equal(rebuilt.cell_size.numpy(),
                                  np.asarray(jg2.cell_size))
    want = np_grid_cell_centers(np.asarray(jg.first_cell),
                                np.asarray(jg.cell_size), jg.cell_count)
    np.testing.assert_array_equal(tg.all_cell_centers().numpy(), want)
    np.testing.assert_array_equal(tg.all_cell_centers().numpy(),
                                  np.asarray(jg.all_cell_centers()))
    for b_t, b_j in zip(tg.bounding_box(), jg.bounding_box()):
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    cell = np.array([[1, 2, 3], [0, 0, 0]])
    np.testing.assert_array_equal(tg.cell_index(cell).numpy(),
                                  np.asarray(jg.cell_index(cell)))


@pytest.mark.parametrize("name", CASES)
def test_face_origins(name):
    _, jg, tg = _case(name)
    for axis in range(3):
        o_t, shape_t = traycast.face_origins(tg, axis)
        o_j, shape_j = jraycast.face_origins(jg, axis)
        assert tuple(shape_t) == tuple(shape_j)
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))


@pytest.mark.parametrize("mode", ["native", "numpy"])
@pytest.mark.parametrize("name", CASES)
def test_build_seed_bins_byte_equal(name, mode, monkeypatch):
    (ta, tb, tc), jg, tg = _case(name)
    if mode == "native":
        if not (tnative.available() and jnative.available()):
            pytest.skip("native library not built")
    else:
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    assert tcpt.seed_pad_for(tg) == jcpt.seed_pad_for(jg)
    pad = tcpt.seed_pad_for(tg)
    got = tcpt.build_seed_bins(tg, ta, tb, tc, pad=pad)
    want = jcpt.build_seed_bins(jg, ta, tb, tc, pad=pad)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.n_shift_rounds == want.n_shift_rounds


@pytest.mark.parametrize("name", CASES)
def test_build_line_bins_byte_equal(name):
    (ta, tb, tc), jg, tg = _case(name)
    for axis in range(3):
        got = tparity.build_line_bins(tg, axis, ta, tb, tc)
        want = pallas_parity.build_line_bins(jg, axis, ta, tb, tc)
        np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
        np.testing.assert_array_equal(got.tbl.numpy(), np.asarray(want.tbl))
        assert got.rows.dtype.itemsize == 4 and got.tbl.dtype.itemsize == 4
        assert (got.n_blocks, got.tb, got.tile, got.t1, got.t2) == (
            want.n_blocks, want.tb, want.tile, want.t1, want.t2)


def test_subdivide_to_span_byte_equal():
    verts, faces = box((1.0, 0.6, 0.8))
    for max_edge in (0.9, 0.3):
        got = tcpt.subdivide_to_span(verts, faces, max_edge=max_edge,
                                     return_parents=True)
        want = jcpt.subdivide_to_span(verts, faces, max_edge=max_edge,
                                      return_parents=True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(got[0]) > len(faces)


def test_seed_pad_for():
    for counts in ((16, 16, 16), (48, 12, 12), (49, 8, 8), (256,) * 3):
        jg = JGrid.from_bounding_box([-1.0] * 3, [1.0] * 3, counts)
        assert tcpt.seed_pad_for(port_grid(jg)) == jcpt.seed_pad_for(jg)
