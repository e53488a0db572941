"""The port's x-slab-sharded CPT grid (``parallel.grid_sharded``) against the
JAX package, on four spawned gloo ranks on the CPU (cells = 4).

Mesh and grids as tests/test_grid_sharded.py: ``icosphere(2)`` on a
32×16×16 grid over [-1.3, 1.3]³ (slabs of 8×16×16), the torus on a thin
16×8×12 grid. The ranks run once for the module
(``torch_dist_ranks.grid_cases``). References, with their tolerances:

- JAX's ``generate_grid_sdf_sharded_cpt`` on a 4-device JAX mesh (its XLA
  branch on the CPU, other sweeps): atol 3e-3, RAYCAST signs equal, at most
  1 % of the NORMAL signs apart;
- the JAX TPU branch, composed here from its pieces with the Pallas sweeps
  in interpret mode, the four slabs' halo exchange done in turn:
  distances within torch_port_helpers.RTOL/ATOL;
- the exact brute-force field: the CPT contract (signs equal, never below
  the exact distance by more than 1e-5, at most 2 % above it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mesh_to_sdf_tpu as jm
from mesh_to_sdf_tpu.ops import cpt as jcpt
from mesh_to_sdf_tpu.parallel import grid_sharded as jgsh
from mesh_to_sdf_tpu.parallel import mesh as jmesh
from mesh_to_sdf_tpu_torch.ops import cpt as tcpt
from torch_port_helpers import ATOL, RTOL, jax_x_sweeps, port_grid
import torch_dist_ranks as R

SIGNS = ["raycast", "normal"]
#: tests/test_grid_sharded.py's bounds.
SHARD_ATOL = 3e-3
NORMAL_SIGN_BUDGET = 0.01


@pytest.fixture(scope="module")
def inputs():
    return R.grid_inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_ranks("grid_cases", tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_sdf_mesh(cells=R.WORLD, tris=1,
                               devices=jax.devices()[:R.WORLD])


def _grid(spec):
    return jm.Grid.from_bounding_box(*spec)


def _topo(faces):
    return jm.Topology.triangle_list(np.asarray(faces).reshape(-1))


@pytest.fixture(scope="module")
def brute(inputs):
    return np.asarray(jm.generate_grid_sdf(
        inputs["verts"], _topo(inputs["faces"]), _grid(inputs["grid"]),
        jm.SignMethod.RAYCAST, strategy=jm.Strategy.XLA))


def test_every_rank_returns_the_field(ranks):
    for key in ("raycast", "normal", "torus"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key])
    assert ranks[0]["raycast"].shape == (32 * 16 * 16,)


@pytest.mark.parametrize("sign", SIGNS)
def test_matches_jax_entry_point(ranks, inputs, jax_mesh, sign):
    want = np.asarray(jgsh.generate_grid_sdf_sharded_cpt(
        inputs["verts"], inputs["faces"], _grid(inputs["grid"]), jax_mesh,
        jm.SignMethod(sign)))
    got = ranks[0][sign]
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=SHARD_ATOL)
    apart = (np.signbit(got) != np.signbit(want)).mean()
    if sign == "raycast":
        assert apart == 0
    else:
        assert apart <= NORMAL_SIGN_BUDGET


def _jax_tpu_branch(v, f, jg, n_dev, halo_rounds):
    """The unsigned field of the JAX TPU branch of
    ``generate_grid_sdf_sharded_cpt`` (``use_pallas=True``): per slab the
    binned seed and ``closest_point_grid_pallas``, the state rebuilt from
    the ids, then per round every slab's left and right neighbour edges
    (the previous round's) merged and the ±x Pallas sweeps."""
    cs = float(np.max(np.abs(np.asarray(jg.cell_size))))
    ra, rb, rc = jcpt.subdivide_to_span(v, f, max_edge=8.0 * cs)
    ta, tb, tc = (jnp.asarray(a) for a in (ra, rb, rc))
    bins = jcpt.build_slab_seed_bins(jg, n_dev, ra, rb, rc)
    T = ta.shape[0]
    tv = jnp.concatenate([jnp.concatenate([ta, tb, tc], axis=-1),
                          jnp.full((1, 9), jcpt.PAD_COORD, jnp.float32)])
    slabs, states = [], []
    for i in range(n_dev):
        slab = jgsh._slab_grid(jg, n_dev, i)
        seed = jcpt.seed_from_bins(slab, ta, tb, tc, jcpt.SeedBins(
            bins.entry_tri[i], bins.rows_cell[i], bins.cell_row[i],
            bins.n_shift_rounds))
        dist, idx = jcpt.closest_point_grid_pallas.__wrapped__(
            slab, ta, tb, tc, seed=seed, interpret=True)
        verts = tv[jnp.where(idx < 0, T, idx)]
        states.append(jcpt.CptState(
            dist, verts, idx, jnp.full_like(dist, jm.F32_MAX),
            jnp.full_like(verts, jcpt.PAD_COORD), jnp.full_like(idx, -1)))
        slabs.append(slab)
    edge0 = jgsh._slice_state(states[0], 0)
    empty = jcpt.CptState(
        jnp.full_like(edge0.d1, jm.F32_MAX),
        jnp.full_like(edge0.v1, jcpt.PAD_COORD), jnp.full_like(edge0.i1, -1),
        jnp.full_like(edge0.d1, jm.F32_MAX),
        jnp.full_like(edge0.v1, jcpt.PAD_COORD), jnp.full_like(edge0.i1, -1))
    for _ in range(halo_rounds):
        lo = [jgsh._slice_state(s, 0) for s in states]
        hi = [jgsh._slice_state(s, -1) for s in states]
        new = []
        for i, (state, slab) in enumerate(zip(states, slabs)):
            centers = slab.all_cell_centers()
            state = jgsh._merge_boundary(state, hi[i - 1] if i else empty, 0,
                                         centers[0])
            state = jgsh._merge_boundary(
                state, lo[i + 1] if i + 1 < n_dev else empty, -1,
                centers[-1])
            new.append(jax_x_sweeps(state, slab))
        states = new
    return np.concatenate([np.asarray(s.d1) for s in states]).reshape(-1)


@pytest.fixture(scope="module")
def tpu_branch(inputs):
    return _jax_tpu_branch(inputs["verts"], inputs["faces"],
                           _grid(inputs["grid"]), R.WORLD, halo_rounds=2)


@pytest.mark.parametrize("sign", SIGNS)
def test_matches_composed_tpu_branch(ranks, tpu_branch, sign):
    np.testing.assert_allclose(np.abs(ranks[0][sign]), tpu_branch,
                               rtol=RTOL, atol=ATOL)


def test_brute_contract(ranks, brute):
    """Signs exact, never (materially) below the exact distance, the far
    field within 2 %."""
    got = ranks[0]["raycast"]
    assert (np.sign(got) == np.sign(brute)).all()
    assert np.all(np.abs(got) >= np.abs(brute) - 1e-5)
    rel = (np.abs(got) - np.abs(brute)) / np.maximum(np.abs(brute), 1e-6)
    assert rel.max() < 2e-2


def test_halo_rounds_sensitivity(ranks, brute):
    """More rounds never loosen the far field; both stay in the contract."""
    errs = []
    for rounds in (1, 3):
        got = ranks[0][f"halo{rounds}"]
        assert (np.sign(got) == np.sign(brute)).all()
        rel = (np.abs(got) - np.abs(brute)) / np.maximum(np.abs(brute), 1e-6)
        errs.append(rel.max())
        assert rel.max() < 3e-2, (rounds, rel.max())
    assert errs[1] <= errs[0] + 1e-6


def test_asymmetric_grid_torus(ranks, inputs):
    """A thin grid with a genus-1 mesh: signs equal to the exact field."""
    want = np.asarray(jm.generate_grid_sdf(
        inputs["torus_verts"], _topo(inputs["torus_faces"]),
        _grid(inputs["torus_grid"]), jm.SignMethod.RAYCAST,
        strategy=jm.Strategy.XLA))
    assert (np.sign(ranks[0]["torus"]) == np.sign(want)).all()


def test_uneven_slabs_raise(ranks):
    assert all(r["uneven"] == "ValueError" for r in ranks)


@pytest.mark.parametrize("n_slabs", [1, 2, 4, 8])
def test_build_slab_seed_bins_bit_equal(inputs, n_slabs):
    jg = _grid(inputs["grid"])
    cs = float(np.max(np.abs(np.asarray(jg.cell_size))))
    tris = jcpt.subdivide_to_span(inputs["verts"], inputs["faces"],
                                  max_edge=8.0 * cs)
    want = jcpt.build_slab_seed_bins(jg, n_slabs, *tris)
    got = tcpt.build_slab_seed_bins(port_grid(jg), n_slabs, *tris)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got.n_shift_rounds == want.n_shift_rounds
    with pytest.raises(ValueError, match="divide"):
        tcpt.build_slab_seed_bins(port_grid(jg), 3, *tris)


@pytest.mark.parametrize("which", ["grid", "torus_grid"])
@pytest.mark.parametrize("n_slabs", [2, 4])
def test_own_slab_seed_equals_stacked_row(inputs, which, n_slabs):
    """A rank builds only its own slab's bins (``cpt.slab_seed_bins``): the
    seed they give is bit-equal to the one from its row of the stacked,
    padded ``build_slab_seed_bins`` (which takes the most shift rounds of
    any slab)."""
    import torch

    from mesh_to_sdf_tpu_torch.gridgen_streamed import slab_grids

    verts, faces = ((inputs["verts"], inputs["faces"]) if which == "grid"
                    else (inputs["torus_verts"], inputs["torus_faces"]))
    g = port_grid(_grid(inputs[which]))
    cs = float(np.max(np.abs(g.cell_size.numpy())))
    tris = tcpt.subdivide_to_span(verts, faces, max_edge=8.0 * cs)
    t3 = [torch.from_numpy(a) for a in tris]
    stacked = tcpt.build_slab_seed_bins(g, n_slabs, *tris)
    slabs = slab_grids(g, g.cell_count[0] // n_slabs)
    for i, slab in enumerate(slabs):
        own = tcpt.slab_seed_bins(g, n_slabs, i, *tris)
        assert own.n_shift_rounds <= stacked.n_shift_rounds
        row = tcpt.SeedBins(stacked.entry_tri[i], stacked.rows_cell[i],
                            stacked.cell_row[i], stacked.n_shift_rounds)
        got = tcpt.seed_from_bins(slab, *t3, own)
        want = tcpt.seed_from_bins(slab, *t3, row)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
