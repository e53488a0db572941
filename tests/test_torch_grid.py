"""The port's Grid against the JAX package's Grid on the CPU.

Both round the same float32 operations in the same order, so every result
must be exactly equal (no tolerance), negative cell sizes included.
"""
import numpy as np
import pytest
import torch

from mesh_to_sdf_tpu import grid as jgrid_mod
from mesh_to_sdf_tpu_torch import grid as tgrid_mod
from torch_port_helpers import port_grid

#: (bbox min, bbox max, cell counts): cubes, uneven counts, a flat slab and
#: boxes with one or all cell sizes negative.
BOXES = {
    "unit-2x3x4": ([0.0] * 3, [1.0] * 3, [2, 3, 4]),
    "skewed-5x10x15": ([-1.3, 0.1, 2.0], [0.7, 3.3, 2.9], [5, 10, 15]),
    "slab-1x7x3": ([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5], [1, 7, 3]),
    "negative-x": ([1.5, -1.5, -1.0], [-1.5, 1.5, 1.0], [12, 10, 14]),
    "negative-all": ([1.5, 1.1, 1.4], [-1.5, -1.1, -1.4], [6, 9, 5]),
}


def _grids(name):
    lo, hi, counts = BOXES[name]
    jg = jgrid_mod.Grid.from_bounding_box(lo, hi, counts)
    tg = tgrid_mod.Grid.from_bounding_box(lo, hi, counts)
    return jg, tg


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", BOXES)
def test_parameters_and_counts_match(name):
    jg, tg = _grids(name)
    _eq(tg.first_cell, jg.first_cell)
    _eq(tg.cell_size, jg.cell_size)
    assert tg.cell_count == jg.cell_count
    assert tg.total_cell_count == jg.total_cell_count
    assert tgrid_mod.grid_shape(tg) == jgrid_mod.grid_shape(jg)


@pytest.mark.parametrize("name", BOXES)
def test_last_cell_matches(name):
    """Kept verbatim from the reference: first + count * size."""
    jg, tg = _grids(name)
    _eq(tg.last_cell(), jg.last_cell())
    # Also from Grid.new with the JAX grid's exact parameters.
    _eq(port_grid(jg).last_cell(), jg.last_cell())


@pytest.mark.parametrize("name", BOXES)
def test_cell_coordinates_match(name):
    jg, tg = _grids(name)
    idx = np.arange(jg.total_cell_count)
    got = tg.cell_coordinates(torch.from_numpy(idx))
    _eq(got, jg.cell_coordinates(idx))
    _eq(tg.cell_index(got), idx)


@pytest.mark.parametrize("name", BOXES)
def test_cell_center_matches(name):
    jg, tg = _grids(name)
    rng = np.random.default_rng(7)
    cells = np.stack([rng.integers(0, n, 50) for n in jg.cell_count], -1)
    got = tg.cell_center(torch.from_numpy(cells))
    _eq(got, jg.cell_center(cells))
    # Every cell center equals all_cell_centers at that cell.
    centers = tg.all_cell_centers()
    _eq(got, centers[cells[:, 0], cells[:, 1], cells[:, 2]])


@pytest.mark.parametrize("name", BOXES)
def test_snap_point_matches(name):
    """Points inside, outside and on cell faces snap to the same clamped
    cell with the same inside flag."""
    jg, tg = _grids(name)
    lo, hi, _ = BOXES[name]
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    rng = np.random.default_rng(11)
    span = hi - lo
    pts = rng.uniform(lo - 0.3 * span, hi + 0.3 * span,
                      (400, 3)).astype(np.float32)
    faces = np.asarray(jg.bounding_box()[0])[None] + np.asarray(
        jg.cell_size)[None] * rng.integers(0, 3, (20, 3))
    pts = np.concatenate([pts, faces.astype(np.float32)])
    cell_t, inside_t = tg.snap_point(torch.from_numpy(pts))
    cell_j, inside_j = jg.snap_point(pts)
    assert cell_t.dtype == torch.int32 and inside_t.dtype == torch.bool
    _eq(cell_t, cell_j)
    _eq(inside_t, inside_j)
    assert bool(inside_t.any()) and not bool(inside_t.all())


@pytest.mark.parametrize("name", BOXES)
def test_np_cell_centers_match(name):
    jg, tg = _grids(name)
    args = (np.asarray(tg.first_cell), np.asarray(tg.cell_size),
            tg.cell_count)
    _eq(tgrid_mod.np_grid_cell_centers(*args),
        jgrid_mod.np_grid_cell_centers(*args))
    _eq(tgrid_mod.np_grid_cell_centers(*args), tg.all_cell_centers())
