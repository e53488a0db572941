"""The port's dense line parity (plain PyTorch on the CPU) against the JAX
package: the Pallas ``line_parity_counts`` in interpret mode for the raw
counts, and the exact XLA engine ``raycast.grid_inside_mask`` for the inside
masks. Counts and masks must be exactly equal.
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
from mesh_to_sdf_tpu_torch.ops import raycast as traycast
from mesh_to_sdf_tpu_torch.ops.kernels import parity as tparity
from torch_port_helpers import port_grid, soup, to_jax, to_torch

MESHES = {
    "icosphere": lambda: make_icosphere(subdiv=2),
    "torus": lambda: torus(n_major=24, n_minor=12),
}


def _grid16(verts):
    """The grid of tests/test_pallas.py:171-194."""
    return JGrid.from_bounding_box(verts.min(0) - 0.2, verts.max(0) + 0.2,
                                   [16, 16, 16])


def _line_inputs(jg, axis):
    origins, _ = traycast.face_origins(port_grid(jg), axis)
    iy, iz = (axis + 1) % 3, (axis + 2) % 3
    return (origins[:, iy].contiguous(), origins[:, iz].contiguous(),
            port_grid(jg).first_cell[axis], port_grid(jg).cell_size[axis])


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_dense_counts_match_jax_kernel(axis):
    """Raw per-cell counts at 8³ (cf. tests/test_pallas.py:197-236)."""
    tris = soup(*make_icosphere(subdiv=1))
    jg = JGrid.from_bounding_box([-1.2] * 3, [1.2] * 3, [8, 8, 8])
    oy, oz, ox, cs = _line_inputs(jg, axis)
    want, ovf = pallas_parity.line_parity_counts(
        *to_jax(oy.numpy(), oz.numpy()), jg.first_cell[axis],
        jg.cell_size[axis],
        pallas_parity.rotate_planes(*to_jax(*tris), axis), n_cells=8,
        interpret=True)
    assert int(np.asarray(ovf).sum()) == 0
    planes = tparity.rotate_planes(*to_torch(*tris), axis)
    for p_t, p_j in zip(planes, pallas_parity.rotate_planes(
            *to_jax(*tris), axis)):
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    got, ovf_t = tparity.line_parity_counts(oy, oz, ox, cs, planes,
                                            n_cells=8)
    assert got.dtype == torch.int32 and got.shape == (64, 8)
    assert not ovf_t.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, 0].sum() > 0


@pytest.mark.parametrize("axes", [1, 3])
@pytest.mark.parametrize("mesh", MESHES)
def test_grid_inside_mask_matches_jax(mesh, axes):
    """The exact XLA engine at 16³; JAX's own test holds its Pallas kernel
    to exact equality with it there (tests/test_pallas.py:171-194)."""
    tris = soup(*MESHES[mesh]())
    jg = _grid16(MESHES[mesh]()[0])
    ta, tb, tc = to_jax(*tris)
    want = np.asarray(jraycast.grid_inside_mask(
        jg, ta, tb, tc, jnp.ones((ta.shape[0],), bool), tri_block=256,
        axes=axes))
    # Padding triangles (valid False) must not count.
    pad = np.zeros((5, 3), np.float32)
    padded = [torch.from_numpy(np.concatenate([t, pad])) for t in tris]
    valid = torch.arange(len(tris[0]) + 5) < len(tris[0])
    got = traycast.grid_inside_mask(port_grid(jg), *padded, valid, axes=axes)
    assert got.dtype == torch.bool and got.shape == (16, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("mesh", MESHES)
def test_dense_counts_equal_binned(mesh):
    """Both exact engines count the same crossings on the same grid."""
    tris = soup(*MESHES[mesh]())
    jg = JGrid.from_bounding_box([-1.6] * 3, [1.6] * 3, [12, 20, 9])
    tg = port_grid(jg)
    for axis in range(3):
        oy, oz, ox, cs = _line_inputs(jg, axis)
        _, lshape = traycast.face_origins(tg, axis)
        n = jg.cell_count[axis]
        dense, _ = tparity.line_parity_counts(
            oy, oz, ox, cs, tparity.rotate_planes(*to_torch(*tris), axis),
            n_cells=n)
        binned, _ = tparity.line_parity_counts_binned(
            oy, oz, ox, cs, tparity.build_line_bins(tg, axis, *tris),
            n_cells=n, n1=lshape[0], n2=lshape[1])
        np.testing.assert_array_equal(dense.numpy(), binned.numpy())
        assert dense.sum() > 0


def test_dense_mask_equals_binned_mask():
    tris = soup(*MESHES["torus"]())
    tg = port_grid(JGrid.from_bounding_box([-1.6] * 3, [1.6] * 3,
                                           [10, 14, 12]))
    bins = tuple(tparity.build_line_bins(tg, ax, *tris) for ax in range(3))
    binned, ovf = tparity.grid_inside_mask(tg, bins)
    assert int(ovf) == 0
    dense = traycast.grid_inside_mask(tg, *to_torch(*tris),
                                      torch.ones(len(tris[0]), dtype=torch.bool))
    np.testing.assert_array_equal(dense.numpy(), binned.numpy())


def test_dense_wrapper_validates_inputs():
    tris = to_torch(*soup(*make_icosphere(subdiv=1)))
    planes = tparity.rotate_planes(*tris, 0)
    oy = torch.zeros(64)
    with pytest.raises(ValueError, match="oz"):
        tparity.line_parity_counts(oy, oy[:10], 0.0, 0.25, planes, n_cells=8)
    with pytest.raises(ValueError, match="tri_rot"):
        tparity.line_parity_counts(oy, oy, 0.0, 0.25, planes[:8], n_cells=8)
    with pytest.raises(ValueError, match=r"tri_rot\[3\]"):
        tparity.line_parity_counts(
            oy, oy, 0.0, 0.25,
            planes[:3] + (planes[3].double(),) + planes[4:], n_cells=8)
    with pytest.raises(ValueError, match="n_cells"):
        tparity.line_parity_counts(oy, oy, 0.0, 0.25, planes, n_cells=0)
    with pytest.raises(ValueError, match="no kernel"):
        tparity.line_parity_counts(oy.to("meta"), oy.to("meta"), 0.0, 0.25,
                                   tuple(p.to("meta") for p in planes),
                                   n_cells=8)


@pytest.mark.parametrize("lines,tris,sms", [
    (16384, 1310720, 132), (16384, 20480, 132), (65536, 20480, 132),
    (1000, 1273, 132), (70000, 300, 8), (1, 1, 132), (5, 0, 132)])
def test_dense_launch_plan(lines, tris, sms):
    """Line groups of PARITY_CTA_LINES lines; chunks of whole 256-triangle
    blocks that cover every block once; one chunk when the lines fill the
    card; at most one chunk per block."""
    groups, chunks, per = tparity.dense_launch(lines, tris, sms)
    blocks = -(-tris // tparity.PARITY_BLOCK)
    assert groups == -(-lines // tparity.PARITY_CTA_LINES)
    assert chunks == (-(-blocks // per) if blocks else 0)
    assert chunks <= max(blocks, 1) and (chunks - 1) * per < max(blocks, 1)
    if groups >= tparity.PARITY_WAVES * sms * tparity.PARITY_CTAS_PER_SM:
        assert chunks <= 1


@pytest.mark.parametrize("mesh", MESHES)
def test_dense_chunks_add_up(mesh):
    """Counting each chunk's run of whole triangle blocks alone and adding
    the counts gives the unsplit counts: how the kernel's chunks combine."""
    ta, tb, tc = to_torch(*soup(*MESHES[mesh]()))
    ta, tb, tc = ta[:-3], tb[:-3], tc[:-3]  # T not a multiple of a block
    jg = JGrid.from_bounding_box([-1.6] * 3, [1.6] * 3, [12, 20, 9])
    B = tparity.PARITY_BLOCK
    for axis in range(3):
        oy, oz, ox, cs = _line_inputs(jg, axis)
        n = jg.cell_count[axis]
        planes = tparity.rotate_planes(ta, tb, tc, axis)
        whole, _ = tparity.line_parity_counts(oy, oz, ox, cs, planes,
                                              n_cells=n)
        _, chunks, per = tparity.dense_launch(oy.shape[0], ta.shape[0], 132)
        assert chunks > 1
        total = torch.zeros_like(whole)
        for k in range(chunks):
            part = tuple(p[k * per * B:(k + 1) * per * B] for p in planes)
            total += tparity.line_parity_counts(oy, oz, ox, cs, part,
                                                n_cells=n)[0]
        assert torch.equal(total, whole)
