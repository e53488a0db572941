"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without an NVIDIA
GPU. The GPU machine has no JAX, which tests/conftest.py imports, so run
them there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: distances rtol=2e-4, atol=1e-5 (both sides round every
operation as written, so they agree far inside it); counts and signs exactly.
"""
import pytest
import torch

import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch import gridgen
from mesh_to_sdf_tpu_torch.ops import cpt
from mesh_to_sdf_tpu_torch.ops.kernels import parity, sweep
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
    got = tm.generate_grid_sdf(torch.from_numpy(verts).to(cuda), topo, grid)
    assert got.device.type == "cuda"
    assert sweep.COUNT.kernel > 0 and parity.COUNT.kernel > 0
    assert sweep.COUNT.plain == parity.COUNT.plain == 0
    want = tm.generate_grid_sdf(verts, topo, grid)
    torch.testing.assert_close(got.cpu().abs(), want.abs(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(got.cpu() < 0, want < 0)
