"""The port's binned line parity (plain PyTorch on the CPU) against the JAX
package's Pallas parity kernel in interpret mode.

Counts and signs must be exactly equal. The port's counts are exact (no
K-distinct bucket limit), so they equal the TPU kernel's wherever that one
reports no overflow, and stay right where it does overflow.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines import make_icosphere
from mesh_to_sdf_tpu import Grid as JGrid
from mesh_to_sdf_tpu.ops import raycast as jraycast
from mesh_to_sdf_tpu.ops.kernels import pallas_parity
from mesh_to_sdf_tpu.utils.meshgen import torus
from mesh_to_sdf_tpu_torch import gridgen
from mesh_to_sdf_tpu_torch.ops import raycast as traycast
from mesh_to_sdf_tpu_torch.ops.kernels import parity as tparity
from torch_port_helpers import port_grid, soup, to_jax


@pytest.fixture(autouse=True)
def _clear_port_prep_cache():
    gridgen._CPT_PREP_CACHE.clear()
    yield
    gridgen._CPT_PREP_CACHE.clear()


# The cases of tests/test_sweep_kernel.py::test_binned_parity_matches_dense,
# plus a grid with negative cell sizes.
CASES = {
    "icosphere-16x16x12": (
        lambda: make_icosphere(subdiv=2),
        lambda: JGrid.from_bounding_box([-1.6] * 3, [1.6] * 3, [16, 16, 12])),
    "torus-12x8x16": (
        lambda: torus(1.0, 0.35, n_major=24, n_minor=12),
        lambda: JGrid.from_bounding_box([-1.6] * 3, [1.6] * 3, [12, 8, 16])),
    "icosphere-multi-tile-40x72x33": (
        lambda: make_icosphere(subdiv=2),
        lambda: JGrid.from_bounding_box([-1.6] * 3, [1.6] * 3, [40, 72, 33])),
    "icosphere-slab-4x40x40": (
        lambda: make_icosphere(subdiv=2),
        lambda: JGrid.from_bounding_box([-1.4, -1.4, -1.4],
                                        [-0.9, 1.4, 1.4], [4, 40, 40])),
    "icosphere-negative-cell-size": (
        lambda: make_icosphere(subdiv=2),
        lambda: JGrid.from_bounding_box([1.5, -1.5, 1.4], [-1.5, 1.5, -1.4],
                                        [12, 10, 14])),
}


def _counts_both(jg, tris, axis):
    """(port counts, JAX counts, JAX overflow) for +axis lines."""
    ta, tb, tc = tris
    tg = port_grid(jg)
    n = jg.cell_count[axis]
    iy, iz = (axis + 1) % 3, (axis + 2) % 3

    origins_j, lshape = jraycast.face_origins(jg, axis)
    bins_j = pallas_parity.build_line_bins(jg, axis, ta, tb, tc)
    want, ovf = pallas_parity.line_parity_counts_binned(
        origins_j[:, iy], origins_j[:, iz], jg.first_cell[axis],
        jg.cell_size[axis], bins_j, n_cells=n, n1=lshape[0], n2=lshape[1],
        k_distinct=2 * pallas_parity.K_DISTINCT, interpret=True,
    )

    origins_t, _ = traycast.face_origins(tg, axis)
    bins_t = tparity.build_line_bins(tg, axis, ta, tb, tc)
    got, ovf_t = tparity.line_parity_counts_binned(
        origins_t[:, iy].contiguous(), origins_t[:, iz].contiguous(),
        tg.first_cell[axis], tg.cell_size[axis], bins_t, n_cells=n,
        n1=lshape[0], n2=lshape[1],
    )
    assert got.dtype == torch.int32 and ovf_t.dtype == torch.int32
    assert not ovf_t.any()
    return got.numpy(), np.asarray(want), np.asarray(ovf)


@pytest.mark.parametrize("name", CASES)
def test_binned_counts_match_jax(name):
    mesh_fn, grid_fn = CASES[name]
    tris = soup(*mesh_fn())
    jg = grid_fn()
    crossed = 0
    for axis in range(3):
        got, want, ovf = _counts_both(jg, tris, axis)
        assert int(ovf.sum()) == 0
        np.testing.assert_array_equal(got, want)
        crossed += int(got.sum())
    assert crossed > 0


def _sheet_stack(n_sheets):
    """n_sheets parallel quads perpendicular to +X at distinct x: a +X ray
    crosses n_sheets distinct hit buckets inside one triangle block."""
    tris = []
    for i in range(n_sheets):
        x = 0.1 + 0.08 * i
        a, b, c, d = [x, -1, -1], [x, 1, -1], [x, 1, 1], [x, -1, 1]
        tris += [[a, b, c], [a, c, d]]
    t = np.asarray(tris, np.float32)
    return t[:, 0], t[:, 1], t[:, 2]


def test_deep_stack_exact_where_jax_overflows():
    tris = _sheet_stack(20)  # > 2·K_DISTINCT = 16 distinct buckets
    jg = JGrid.from_bounding_box([0.0, -0.5, -0.5], [1.2, 0.5, 0.5],
                                 [16, 4, 4])
    got, want, ovf = _counts_both(jg, tris, axis=0)
    assert int(ovf.sum()) > 0, "the TPU kernel must overflow here"
    # Lines that overflowed lost crossings on the TPU; the port counts all.
    assert (got >= want).all() and (got > want).any()

    tg = port_grid(jg)
    bins = tuple(tparity.build_line_bins(tg, ax, *tris) for ax in range(3))
    inside, ovf_t = tparity.grid_inside_mask(tg, bins)
    assert int(ovf_t) == 0
    ta, tb, tc = to_jax(*tris)
    exact = jraycast.grid_inside_mask(
        jg, ta, tb, tc, jnp.ones((ta.shape[0],), bool), tri_block=24)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(exact))

    inside1, _ = tparity.grid_inside_mask(tg, bins, axes=1)
    exact1 = jraycast.grid_inside_mask(
        jg, ta, tb, tc, jnp.ones((ta.shape[0],), bool), tri_block=24, axes=1)
    np.testing.assert_array_equal(inside1.numpy(), np.asarray(exact1))


def test_parity_wrapper_validates_inputs():
    jg = JGrid.from_bounding_box([-1.0] * 3, [1.0] * 3, [8, 8, 8])
    tg = port_grid(jg)
    bins = tparity.build_line_bins(tg, 0, *soup(*make_icosphere(subdiv=1)))
    oy = torch.zeros(64)
    with pytest.raises(ValueError, match="oy"):
        tparity.line_parity_counts_binned(oy[:10], oy, 0.0, 0.25, bins,
                                          n_cells=8, n1=8, n2=8)
    with pytest.raises(ValueError, match="oz"):
        tparity.line_parity_counts_binned(oy, oy.double(), 0.0, 0.25, bins,
                                          n_cells=8, n1=8, n2=8)
    with pytest.raises(ValueError, match="tile"):
        tparity.line_parity_counts_binned(
            torch.zeros(40 * 8), torch.zeros(40 * 8), 0.0, 0.25, bins,
            n_cells=8, n1=40, n2=8)
    meta = tparity.LineBins(bins.rows.to("meta"), bins.tbl.to("meta"),
                            bins.n_blocks, bins.tb, bins.tile, bins.t1,
                            bins.t2)
    with pytest.raises(ValueError, match="no kernel"):
        tparity.line_parity_counts_binned(
            oy.to("meta"), oy.to("meta"), 0.0, 0.25, meta, n_cells=8, n1=8,
            n2=8)
