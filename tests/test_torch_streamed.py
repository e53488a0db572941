"""The port's slab-streamed grid (``gridgen_streamed``) against the JAX
package, on the CPU (the kernels' plain versions).

Mesh and grid as tests/test_streamed.py: ``icosphere(2)`` on a 32×16×16 grid
over [-1.3, 1.3]³, ``slab_nx=8``. References, with their tolerances:

- the JAX TPU branch (``use_pallas=True``), composed here from the JAX
  package's own pieces with the Pallas kernels in interpret mode: distances
  within torch_port_helpers.RTOL/ATOL (the frameworks fuse the float32
  ladder differently), signs equal;
- JAX's ``generate_grid_sdf_streamed`` on the CPU (its XLA branch, other
  sweeps): atol 3e-3 and equal RAYCAST signs (tests/test_streamed.py's
  bounds), at most 1 % of the NORMAL signs apart;
- the port's in-core CPT route: the same bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines import make_icosphere
import mesh_to_sdf_tpu as jm
from mesh_to_sdf_tpu import gridgen_streamed as jgs
from mesh_to_sdf_tpu.grid import Grid as JGrid
from mesh_to_sdf_tpu.ops import cpt as jcpt
from mesh_to_sdf_tpu.ops.kernels import pallas_parity
import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch import gridgen_streamed as tgs
from torch_port_helpers import (ATOL, RTOL, assert_index_consistent,
                                assert_same_field, jax_x_sweeps, port_grid,
                                to_jax)

SLAB_NX = 8
SIGNS = ["RAYCAST", "NORMAL"]
#: tests/test_streamed.py's distance bound between the streamed grid and
#: another CPT schedule, and its NORMAL sign budget.
STREAM_ATOL = 3e-3
NORMAL_SIGN_BUDGET = 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small torch ops; one thread keeps them off the other test processes'
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clear_prep_cache():
    tgs._STREAM_PREP_CACHE.clear()
    yield
    tgs._STREAM_PREP_CACHE.clear()


@pytest.fixture(scope="module")
def case():
    v, f = make_icosphere(subdiv=2)
    jg = JGrid.from_bounding_box([-1.3] * 3, [1.3] * 3, [32, 16, 16])
    return v.astype(np.float32), f.astype(np.int64), jg


def _port(case, sign, **kw):
    v, f, jg = case
    kw.setdefault("slab_nx", SLAB_NX)
    kw.setdefault("device", "cpu")
    return tgs.generate_grid_sdf_streamed(v, f, port_grid(jg),
                                          getattr(tm.SignMethod, sign), **kw)


@pytest.fixture(scope="module")
def port_fields(case):
    return {sign: _port(case, sign).numpy() for sign in SIGNS}


def _jax_slab(jg, i):
    """Slab i's Grid as the JAX ``generate_grid_sdf_streamed`` builds it."""
    fc = jg.first_cell + jnp.asarray([i * SLAB_NX, 0, 0],
                                     jnp.float32) * jg.cell_size
    return JGrid(first_cell=fc, cell_size=jg.cell_size,
                 cell_count=(SLAB_NX,) + tuple(jg.cell_count[1:]))


def _jax_slab_pass(prep, slab, i, left, right):
    """``gridgen_streamed._slab_pass(use_pallas=True)`` of the JAX package,
    its Pallas kernels in interpret mode. Returns (state, hi, lo)."""
    ta, tb, tc = prep.tris[0], prep.tris[1], prep.tris[2]
    seed = jcpt.seed_from_bins(slab, ta, tb, tc, jcpt.SeedBins(
        *prep.seeds[i], prep.n_shift_rounds))
    dist, idx = jcpt.closest_point_grid_pallas.__wrapped__(
        slab, ta, tb, tc, seed=seed, interpret=True)
    state = jgs._state_from(dist, idx, ta, tb, tc)
    centers = slab.all_cell_centers()
    state = jgs._merge_edge(state, left, 0, centers[0])
    state = jgs._merge_edge(state, right, -1, centers[-1])
    state = jax_x_sweeps(state, slab)
    return (state, jcpt.CptState(*[a[-1] for a in state]),
            jcpt.CptState(*[a[0] for a in state]))


@pytest.fixture(scope="module")
def jax_composed(case):
    """The JAX TPU branch of ``generate_grid_sdf_streamed``, composed from
    its pieces: both passes once, each slab signed both ways."""
    v, f, jg = case
    nx, ny, nz = jg.cell_count
    n_slabs = nx // SLAB_NX
    prep = jgs._stream_prep(jg, SLAB_NX, v, f, want_line_bins=True)
    empty = jgs._empty_edge(ny, nz)
    right_edges, carry = [], empty
    for i in range(n_slabs):
        _, carry, _ = _jax_slab_pass(prep, _jax_slab(jg, i), i, carry, empty)
        right_edges.append(carry)
    out = {sign: np.empty((nx, ny, nz), np.float32) for sign in SIGNS}
    carry = empty
    orig = [jnp.asarray(v[f[:, k]]) for k in range(3)]
    for i in reversed(range(n_slabs)):
        slab = _jax_slab(jg, i)
        left = right_edges[i - 1] if i > 0 else empty
        state, _, carry = _jax_slab_pass(prep, slab, i, left, carry)
        inside, ovf = pallas_parity.grid_inside_mask_pallas(
            slab, *orig, line_bins=prep.line_bins[i], interpret=True)
        assert int(ovf) == 0
        rows = slice(i * SLAB_NX, (i + 1) * SLAB_NX)
        out["RAYCAST"][rows] = np.asarray(
            jnp.where(inside, -state.d1, state.d1))
        out["NORMAL"][rows] = np.asarray(jcpt.normal_sign_from_idx(
            slab, *prep.tris, state.d1, state.i1))
    return {sign: a.reshape(-1) for sign, a in out.items()}


@pytest.mark.parametrize("sign", SIGNS)
def test_matches_jax_tpu_branch(port_fields, jax_composed, sign):
    got, want = port_fields[sign], jax_composed[sign]
    assert got.shape == (32 * 16 * 16,)
    assert_same_field(got, want)
    assert (want < 0).any() and (want > 0).any()


@pytest.mark.parametrize("sign", SIGNS)
def test_matches_jax_generate_grid_sdf_streamed(case, port_fields, sign):
    """JAX's own entry point on the CPU: its XLA branch (scan sweeps, XLA
    parity)."""
    v, f, jg = case
    want = np.asarray(jgs.generate_grid_sdf_streamed(
        v, f, jg, getattr(jm.SignMethod, sign), slab_nx=SLAB_NX))
    got = port_fields[sign]
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=STREAM_ATOL)
    apart = (np.signbit(got) != np.signbit(want)).mean()
    if sign == "RAYCAST":
        assert apart == 0
    else:
        assert apart <= NORMAL_SIGN_BUDGET


@pytest.mark.parametrize("sign", SIGNS)
def test_matches_port_in_core_cpt(case, port_fields, sign):
    v, f, jg = case
    want = tm.generate_grid_sdf(
        v, tm.Topology.triangle_list(f.reshape(-1)), port_grid(jg),
        getattr(tm.SignMethod, sign), strategy=tm.Strategy.CPT,
        device="cpu").numpy()
    got = port_fields[sign]
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=STREAM_ATOL)
    apart = (np.signbit(got) != np.signbit(want)).mean()
    if sign == "RAYCAST":
        assert apart == 0
    else:
        assert apart <= NORMAL_SIGN_BUDGET


def test_first_slab_pass_matches_jax(case):
    """One slab pass with empty edges against the JAX composition: the best
    distance of the state and of both edges within the tolerance. The
    subdivided icosphere's triangles share vertices and edges, so ids tie
    and an ulp picks a different one (and then a different runner-up) in
    either framework; every id of the port must achieve its distance."""
    v, f, jg = case
    _, ny, nz = jg.cell_count
    jprep = jgs._stream_prep(jg, SLAB_NX, v, f, want_line_bins=False)
    jempty = jgs._empty_edge(ny, nz)
    want, w_hi, w_lo = _jax_slab_pass(jprep, _jax_slab(jg, 1), 1, jempty,
                                      jempty)
    prep = tgs._stream_prep(port_grid(jg), SLAB_NX, v, f, False,
                            torch.device("cpu"))
    empty = tgs._empty_edge(ny, nz, "cpu")
    got, hi, lo = tgs._slab_pass(prep, 1, empty, empty)
    for g, w in ((got, want), (hi, w_hi), (lo, w_lo)):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w.d1),
                                   rtol=RTOL, atol=ATOL)
    centers = prep.slabs[1].all_cell_centers().numpy().reshape(-1, 3)
    soup = prep.tris.numpy()
    d1, i1, d2, i2 = (t.numpy().reshape(-1) for t in got)
    assert (i1 >= 0).all() and (d2 >= d1).all() and (i2 != i1).all()
    assert_index_consistent(centers, *soup, i1, d1)
    has2 = i2 >= 0
    assert_index_consistent(centers[has2], *soup, i2[has2], d2[has2])
    for edge, position in ((hi, -1), (lo, 0)):
        for e, s in zip(edge, got):
            np.testing.assert_array_equal(e.numpy(), s[position].numpy())


@pytest.mark.parametrize("position", [0, -1])
def test_edge_merge_matches_jax(rng, position):
    """The id-only edge merge against the JAX merge on vertex slots, on a
    scattered soup (no ties), with empty (-1) slots on both sides."""
    T, ny, nz, nx = 40, 6, 7, 5
    tris = rng.uniform(-1, 1, (3, T, 3)).astype(np.float32)
    jslab = JGrid.from_bounding_box([-1.2] * 3, [1.2] * 3, [nx, ny, nz])
    slab = port_grid(jslab)

    def ids(p_empty):
        i = rng.integers(0, T, (ny, nz)).astype(np.int32)
        return np.where(rng.random((ny, nz)) < p_empty, -1, i)

    d_state = [rng.uniform(0, 1.5, (nx, ny, nz)).astype(np.float32)
               for _ in range(2)]
    i_state = [rng.integers(-1, T, (nx, ny, nz)).astype(np.int32)
               for _ in range(2)]
    e_ids = [ids(0.2), ids(0.5)]
    e_d = [np.zeros((ny, nz), np.float32)] * 2  # the merge recomputes them

    tv = np.concatenate([np.concatenate(list(tris), axis=-1),
                         np.full((1, 9), jcpt.PAD_COORD, np.float32)])

    def verts(i):
        return jnp.asarray(tv[np.where(i < 0, T, i)])

    jstate = jcpt.CptState(*to_jax(d_state[0]), verts(i_state[0]),
                           *to_jax(i_state[0], d_state[1]),
                           verts(i_state[1]), *to_jax(i_state[1]))
    jedge = jcpt.CptState(jnp.asarray(e_d[0]), verts(e_ids[0]),
                          jnp.asarray(e_ids[0]), jnp.asarray(e_d[1]),
                          verts(e_ids[1]), jnp.asarray(e_ids[1]))
    want = jgs._merge_edge(jstate, jedge, position,
                           jslab.all_cell_centers()[position])
    state = [torch.from_numpy(a.copy()) for a in
             (d_state[0], i_state[0], d_state[1], i_state[1])]
    edge = tgs.Edge(*(torch.from_numpy(a) for a in
                      (e_d[0], e_ids[0], e_d[1], e_ids[1])))
    tgs._merge_edge(state, edge, position, slab, torch.from_numpy(tv))
    for k, name in enumerate(("d1", "i1", "d2", "i2")):
        w = np.asarray(getattr(want, name))
        if k % 2:
            np.testing.assert_array_equal(state[k].numpy(), w)
        else:
            np.testing.assert_allclose(state[k].numpy(), w, rtol=RTOL,
                                       atol=ATOL)
    # The merge changed the row and nothing else.
    other = [p for p in range(nx) if p != position % nx]
    np.testing.assert_array_equal(state[1].numpy()[other],
                                  i_state[0][other])
    assert not np.array_equal(state[1].numpy()[position],
                              i_state[0][position])


@pytest.mark.parametrize("position", [0, -1])
def test_row_centres_bit_equal(case, position):
    _, _, jg = case
    for i, slab in enumerate(tgs.slab_grids(port_grid(jg), SLAB_NX)):
        got = tgs._row_centres(slab, position, "cpu").numpy()
        np.testing.assert_array_equal(
            got, slab.all_cell_centers()[position].numpy())
        np.testing.assert_array_equal(
            got, np.asarray(_jax_slab(jg, i).all_cell_centers()[position]))


def test_slab_first_cells_match_jax(case):
    _, _, jg = case
    slabs = tgs.slab_grids(port_grid(jg), SLAB_NX)
    assert len(slabs) == 4
    for i, slab in enumerate(slabs):
        assert slab.cell_count == (SLAB_NX, 16, 16)
        np.testing.assert_array_equal(slab.first_cell.numpy(),
                                      np.asarray(_jax_slab(jg, i).first_cell))
        np.testing.assert_array_equal(slab.cell_size.numpy(),
                                      np.asarray(jg.cell_size))


def test_prep_seeds_match_jax(case):
    """Per-slab seed bins padded to one row count, equal to the JAX
    package's, the soup subdivided the same way."""
    v, f, jg = case
    jprep = jgs._stream_prep(jg, SLAB_NX, v, f, want_line_bins=False)
    prep = tgs._stream_prep(port_grid(jg), SLAB_NX, v, f, False,
                            torch.device("cpu"))
    np.testing.assert_array_equal(prep.tris.numpy(), np.asarray(jprep.tris))
    assert len(prep.seeds) == len(jprep.seeds) == 4
    assert len({s.entry_tri.shape for s in prep.seeds}) == 1
    for got, want in zip(prep.seeds, jprep.seeds):
        assert got.n_shift_rounds == jprep.n_shift_rounds
        for g, w in zip(got[:3], want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_slab_line_bins_one_width_per_axis(case, axis):
    """One table width per axis; axis 0 shares one table; the tables equal
    the JAX package's build_slab_line_bins."""
    v, f, jg = case
    oa, ob, oc = (v[f[:, k]] for k in range(3))
    want = jgs.build_slab_line_bins(jg, SLAB_NX, 4, oa, ob, oc)
    got = tgs.build_slab_line_bins(port_grid(jg), SLAB_NX, 4, oa, ob, oc)
    assert len(got) == 4
    assert len({b[axis].tbl.shape for b in got}) == 1
    if axis == 0:
        assert all(b[0] is got[0][0] for b in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[axis].tbl.numpy(),
                                      np.asarray(w[axis].tbl))
        np.testing.assert_array_equal(g[axis].rows.numpy(),
                                      np.asarray(w[axis].rows))
        assert g[axis].n_blocks == w[axis].n_blocks


def test_bad_slab_raises(case):
    with pytest.raises(ValueError, match="multiple"):
        _port(case, "RAYCAST", slab_nx=5)


#: A small case for the tests of the entry point's plumbing.
SMALL_SHAPE, SMALL_SLAB = (16, 8, 8), 8


def _small(sign="RAYCAST", **kw):
    v, f = make_icosphere(subdiv=1)
    grid = tm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, SMALL_SHAPE)
    kw.setdefault("slab_nx", SMALL_SLAB)
    kw.setdefault("device", "cpu")
    return tgs.generate_grid_sdf_streamed(v, f, grid,
                                          getattr(tm.SignMethod, sign), **kw)


@pytest.fixture(scope="module")
def small_field():
    return _small().numpy()


@pytest.mark.parametrize("kind", ["numpy-flat", "numpy-3d", "tensor-flat",
                                  "tensor-3d"])
def test_out_receives_the_field(small_field, kind):
    n = int(np.prod(SMALL_SHAPE))
    want = small_field
    shape = (n,) if kind.endswith("flat") else SMALL_SHAPE
    buf = np.full(shape, np.nan, np.float32)
    out = buf if kind.startswith("numpy") else torch.from_numpy(buf)
    got = _small(out=out)
    np.testing.assert_array_equal(buf.reshape(-1), want)
    assert got.shape == (n,)
    assert got.data_ptr() == torch.from_numpy(buf).data_ptr()


def test_out_of_the_wrong_kind_raises():
    n = int(np.prod(SMALL_SHAPE))
    for out in (np.empty((100,), np.float32), np.empty((n,), np.float64),
                np.empty((2 * n,), np.float32)[::2],
                torch.empty((n,), dtype=torch.float32, device="meta")):
        with pytest.raises(ValueError, match="out"):
            _small(out=out)


def test_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    v, f = make_icosphere(subdiv=1)
    grid = tm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, SMALL_SHAPE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgs.generate_grid_sdf_streamed(v, f, grid, slab_nx=SMALL_SLAB)
    out = tgs.generate_grid_sdf_streamed(torch.from_numpy(v), f, grid,
                                         slab_nx=SMALL_SLAB)
    assert out.device == torch.device("cpu")


def test_prep_cache_keeps_two_entries():
    for sign in SIGNS:
        _small(sign)
    assert len(tgs._STREAM_PREP_CACHE) == 2
    first = next(iter(tgs._STREAM_PREP_CACHE.values()))
    _small("RAYCAST")  # a hit
    assert len(tgs._STREAM_PREP_CACHE) == 2
    assert next(iter(tgs._STREAM_PREP_CACHE.values())) is first
    _small("RAYCAST", slab_nx=16)
    assert len(tgs._STREAM_PREP_CACHE) == 2
    assert all(p is not first for p in tgs._STREAM_PREP_CACHE.values())
    assert all(k[-1] == "cpu" for k in tgs._STREAM_PREP_CACHE)


def test_default_slab_and_analytic_sphere():
    """slab_nx defaults to min(64, nx): here one slab, the whole grid."""
    v, f = make_icosphere(subdiv=2)
    grid = tm.Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [16, 16, 16])
    sdf = tgs.generate_grid_sdf_streamed(v, f, grid, device="cpu")
    (key,) = tgs._STREAM_PREP_CACHE
    assert len(tgs._STREAM_PREP_CACHE[key].slabs) == 1
    r = np.linalg.norm(grid.all_cell_centers().numpy(), axis=-1).reshape(-1)
    sdf = sdf.numpy()
    assert np.abs(sdf - (r - 1.0)).max() < 0.05
    far = np.abs(r - 1.0) > 2 * 2.8 / 16
    np.testing.assert_array_equal(sdf[far] < 0, r[far] < 1.0)
