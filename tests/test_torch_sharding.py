"""The port's sharded query path (``parallel.sharding``, ``parallel.mesh``)
against the JAX package, on four spawned gloo ranks on the CPU.

The ranks run once for the module (``torch_dist_ranks.sharding_cases``);
the JAX references run here, on a JAX mesh of the same shape over four of
the virtual CPU devices that conftest provides. JAX's sharded entry points
take their XLA branch on the CPU; the bounds are tests/test_sharding.py's
(atol/rtol 1e-5; the gradient atol 1e-5, rtol 1e-4) and, for CULLED,
tests/test_grid_sharded.py's (rtol 2e-4, atol 5e-5). Against the port's own
single-device PALLAS route the sharded result is bit-equal: the same
kernel (its plain version here) on the same triangles, plus pad rows that
never win.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_to_sdf_tpu as jm
import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu import parallel as jparallel
from mesh_to_sdf_tpu.models.sdf_layer import pad_tri_idx
from mesh_to_sdf_tpu.ops import autodiff as jautodiff
from mesh_to_sdf_tpu.ops.keyed import combine_champions
from mesh_to_sdf_tpu.parallel import mesh as jmesh
from mesh_to_sdf_tpu.parallel import sharding as jsharding
from mesh_to_sdf_tpu_torch import parallel as tparallel
from mesh_to_sdf_tpu_torch.parallel import sharding as tsharding
import torch_dist_ranks as R

SIGNS = ["raycast", "normal"]


@pytest.fixture(scope="module")
def inputs():
    return R.sharding_inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_ranks("sharding_cases", tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def jax_meshes():
    devices = jax.devices()[:R.WORLD]
    return {name: jmesh.make_sdf_mesh(cells=c, tris=t, devices=devices)
            for name, (c, t) in R.MESHES.items()}


def _topo(faces):
    return jm.Topology.triangle_list(np.asarray(faces).reshape(-1))


def test_public_names_match_the_jax_package():
    assert tparallel.__all__ == jparallel.__all__
    for name in tparallel.__all__:
        assert hasattr(tparallel, name)
    assert (tparallel.CELL_AXIS, tparallel.TRI_AXIS) == (
        jparallel.CELL_AXIS, jparallel.TRI_AXIS)


def test_mesh_layout_and_padding(ranks):
    """Row-major (cells, tris) coordinates, JAX's pad sizes, the gloo
    backend on the CPU, and a mesh that does not fit the world raises."""
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["backend"] == "gloo" for r in ranks)
    assert all(r["errors"]["mesh 3x1"] == "ValueError" for r in ranks)
    assert ranks[0]["pad"] == [112, 128, 2]


@pytest.mark.parametrize("sign", SIGNS)
@pytest.mark.parametrize("mesh_name", list(R.MESHES))
def test_sharded_matches_jax(ranks, inputs, jax_meshes, mesh_name, sign):
    want = np.asarray(jsharding.generate_sdf_sharded(
        inputs["verts"], inputs["faces"], inputs["queries"],
        jax_meshes[mesh_name], jm.SignMethod(sign), block=64))
    for r in ranks:  # every rank returns the whole result
        np.testing.assert_allclose(r["sharded"][mesh_name, sign], want,
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sign", SIGNS)
@pytest.mark.parametrize("mesh_name", list(R.MESHES))
def test_sharded_bit_equal_to_pallas(ranks, inputs, mesh_name, sign):
    want = tm.generate_sdf(inputs["verts"], _topo(inputs["faces"]),
                           inputs["queries"], tm.Strategy.PALLAS,
                           sign_method=tm.SignMethod(sign), device="cpu")
    for r in ranks:
        np.testing.assert_array_equal(r["sharded"][mesh_name, sign],
                                      want.numpy())


def test_sharded_grid_normal_matches_jax(ranks, inputs, jax_meshes):
    grid = jm.Grid.from_bounding_box(*R.GRID8)
    want = np.asarray(jsharding.generate_grid_sdf_sharded(
        inputs["verts"], inputs["faces"], grid, jax_meshes["cells2_tris2"],
        jm.SignMethod.NORMAL, block=64))
    np.testing.assert_allclose(ranks[0]["grid_normal"], want, atol=1e-5,
                               rtol=1e-5)


def test_sharded_gradient_matches_single_device(ranks, inputs):
    """The world's sum of the ranks' vertex gradients (cells 2 × tris 2)
    == JAX's single-device custom VJP."""
    tri_pad = pad_tri_idx(inputs["grad_faces"], 64)
    queries = jnp.asarray(inputs["grad_queries"])

    def single(v):
        mp, mn = jautodiff.signed_champion_distances(
            v, jnp.asarray(tri_pad), queries, 64)
        return jnp.sum(combine_champions(mp, mn))

    want = np.asarray(jax.grad(single)(jnp.asarray(inputs["grad_verts"])))
    assert np.abs(want).max() > 0.1
    for r in ranks:
        np.testing.assert_allclose(r["grad"], want, atol=1e-5, rtol=1e-4)
    # Each rank holds only its part before the sum.
    assert not any(np.allclose(r["grad_local"], want) for r in ranks)


def test_sharded_fit_step_descends(ranks, inputs, jax_meshes):
    """Ten Adam steps: the loss falls below 0.7× the first, the first loss
    is JAX's, and the vertices stay bit-identical on every rank."""
    losses = ranks[0]["losses"]
    assert losses[-1] < 0.7 * losses[0], losses
    assert all(r["losses"] == losses for r in ranks)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["fit_verts"], ranks[0]["fit_verts"])
    assert np.isfinite(ranks[0]["fit_verts"]).all()

    import optax
    from mesh_to_sdf_tpu.models.sdf_layer import sdf_grid

    grid = jm.Grid.from_bounding_box(*R.GRID8)
    faces = inputs["faces"]
    step, pad_target = jsharding.sharded_fit_step_fn(
        jax_meshes["cells2_tris2"], faces, grid, optax.adam(R.FIT_LR),
        jm.SignMethod.NORMAL, block=64)
    target = pad_target(np.asarray(sdf_grid(
        jnp.asarray(inputs["verts"]), jnp.asarray(pad_tri_idx(faces, 64)),
        grid, jm.SignMethod.NORMAL)).reshape(-1))
    v = jnp.asarray(inputs["fit_verts"])
    _, _, loss = step(v, optax.adam(R.FIT_LR).init(v), target)
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-5)


@pytest.mark.parametrize("case", ["culled", "culled_tiny"])
def test_sharded_culled_matches_exact(ranks, inputs, case):
    """Sharded CULLED (the union engine per query shard, then the flagged
    queries through the sharded brute path) == the exact engine, the
    starved capacity (st 32, nb_sub 1, nb_table 2) included."""
    n = ranks[0][case].shape[0]
    want = np.asarray(jm.generate_sdf(
        inputs["culled_verts"], _topo(inputs["culled_faces"]),
        inputs["culled_queries"][:n], jm.Strategy.XLA,
        sign_method=jm.SignMethod.RAYCAST))
    for r in ranks:
        np.testing.assert_allclose(r[case], want, rtol=2e-4, atol=5e-5)


def test_entry_points_need_a_card_unless_told(inputs):
    """Without ``device=`` and without tensor inputs an entry point runs on
    CUDA, and raises on a host without it; nothing falls back unasked."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    args = (inputs["verts"], inputs["faces"], inputs["queries"], None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsharding.generate_sdf_sharded(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsharding.generate_sdf_sharded_culled(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparallel.initialize_distributed()


def test_pad_rows_never_win_or_cross():
    """The pad triangle at _FAR: its squared distance is finite and larger
    than any real one, its records' crossing tests are all false."""
    from mesh_to_sdf_tpu_torch.ops.kernels import sdf

    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.uniform(-2, 2, (64, 3)).astype(np.float32))
    tri = torch.tensor([[-1, -1, -1]], dtype=torch.int32)
    v = torch.zeros((3, 3))
    ta, tb, tc = tsharding._pallas_safe_tris(v, tri)
    d2, counts = sdf.raycast_raw(q, ta, tb, tc, raycast_axes=3)
    assert torch.isfinite(d2).all() and (d2 > 1e36).all()
    assert (counts == 0).all()
    pos2, neg2 = sdf.normal_raw(q, ta, tb, tc)
    assert (torch.minimum(pos2, neg2) > 1e36).all()
