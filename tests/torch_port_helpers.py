"""Helpers for the parity tests between the JAX package and its PyTorch port.

Both sides take the same numpy inputs: meshes and states are made with numpy
(from a seed or procedurally) and handed to each package in its own array
type. The port never imports JAX, so the bridge lives here.
"""
import jax.numpy as jnp
import numpy as np
import torch

import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu import gridgen as jgridgen
from mesh_to_sdf_tpu.grid import np_grid_cell_centers
from mesh_to_sdf_tpu.ops import cpt as jcpt
from mesh_to_sdf_tpu.ops import geometry
from mesh_to_sdf_tpu.ops.kernels import pallas_parity, pallas_sweep
from mesh_to_sdf_tpu_torch.ops import cpt as tcpt
from mesh_to_sdf_tpu_torch.ops import culling as tculling
from mesh_to_sdf_tpu_torch.ops.kernels import culled as tculled

#: Distance tolerance between the two packages: they fuse the float32
#: ladder differently, so results may differ by a few ulps (the reason given
#: in tests/test_sweep_kernel.py for the Pallas-vs-XLA comparison).
RTOL, ATOL = 2e-4, 1e-5


def port_grid(jgrid) -> tm.Grid:
    """The port's Grid with the JAX Grid's exact float32 parameters."""
    return tm.Grid.new(np.asarray(jgrid.first_cell, np.float32),
                       np.asarray(jgrid.cell_size, np.float32),
                       jgrid.cell_count)


def port_block_index(jbi, device="cpu"):
    """The port's BlockIndex holding the JAX package's arrays (through
    numpy), so a stage can be held against JAX from the same state."""
    B, tb = jbi.n_blocks, jbi.tb
    return tculled.BlockIndex(
        rows=torch.from_numpy(np.array(jbi.rows).reshape(B + 1, 9, tb))
        .to(device),
        planes9=torch.from_numpy(np.array(jbi.planes9)).to(device),
        lo=torch.from_numpy(np.array(jbi.lo)).to(device),
        hi=torch.from_numpy(np.array(jbi.hi)).to(device),
        n_blocks=B, tb=tb, content_key=jbi.content_key)


def port_sign_grid(jsg, device="cpu"):
    """The port's SignGrid holding the JAX package's mask and grid."""
    return tculling.SignGrid(
        inside=torch.from_numpy(np.array(jsg.inside)).to(device),
        grid=port_grid(jsg.grid))


def soup(verts, faces):
    """(ta, tb, tc) float32 numpy triangle soup."""
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces)
    return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def to_jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def reeval_distance(centers, ta, tb, tc, idx):
    """Exact distance from each point in ``centers`` (N, 3) to triangle
    ``idx`` (N,) of the soup, by the JAX package's geometry."""
    safe = np.maximum(np.asarray(idx).reshape(-1), 0)
    return np.asarray(geometry.point_triangle_distance(
        jnp.asarray(centers), jnp.asarray(ta[safe]), jnp.asarray(tb[safe]),
        jnp.asarray(tc[safe]),
    ))


def assert_index_consistent(centers, ta, tb, tc, idx, dist):
    """Indices may differ where distances tie; each index must achieve the
    reported distance when re-evaluated exactly."""
    d_re = reeval_distance(centers, ta, tb, tc, idx)
    np.testing.assert_allclose(d_re, np.asarray(dist).reshape(-1),
                               rtol=RTOL, atol=ATOL)


def grid_centers(jgrid):
    """(nx, ny, nz, 3) float32 cell centers of a JAX Grid, with numpy."""
    return np_grid_cell_centers(np.asarray(jgrid.first_cell),
                                np.asarray(jgrid.cell_size),
                                jgrid.cell_count)


def jax_seed(jgrid, tris):
    """(SeedBins, flat numpy (d1, i1, d2, i2)) from the JAX package."""
    bins = jcpt.build_seed_bins(jgrid, *tris, pad=jcpt.seed_pad_for(jgrid))
    seed = jcpt.seed_from_bins(jgrid, *to_jax(*tris), bins)
    return bins, tuple(np.asarray(a) for a in seed)


def check_closest_point_grid(jgrid, tris, rounds):
    """The port's Gauss-Seidel orchestration == ``closest_point_grid_pallas``
    (the TPU schedule, on cubic grids too, where the JAX package's CPU route
    would run batched Jacobi sweeps instead), from the same seed.

    The JAX side runs the unjitted body (``__wrapped__``): the same code,
    but each directional sweep compiles once per shape, so rounds 1 and 2
    share the interpret-mode compilations."""
    _, seed = jax_seed(jgrid, tris)
    want_d, want_i = jcpt.closest_point_grid_pallas.__wrapped__(
        jgrid, *to_jax(*tris), seed=to_jax(*seed), rounds=rounds,
        interpret=True,
    )
    got_d, got_i = tcpt.closest_point_grid(
        port_grid(jgrid), *to_torch(*tris), seed=to_torch(*seed),
        rounds=rounds,
    )
    assert got_d.shape == jgrid.cell_count and got_i.dtype == torch.int32
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=RTOL,
                               atol=ATOL)
    centers = grid_centers(jgrid).reshape(-1, 3)
    for idx in (got_i.numpy(), np.asarray(want_i)):
        assert (idx >= 0).all()
        assert_index_consistent(centers, *tris, idx, got_d.numpy())


def jax_composed_grid_sdf(jgrid, verts, faces):
    """The JAX TPU route's signed grid, composed from its own pieces with the
    Pallas kernels in interpret mode (``_cpt_grid_signed(on_tpu=True)`` has
    no interpret switch): ``_cpt_prep`` → ``seed_from_bins`` →
    ``closest_point_grid_pallas`` → ``grid_inside_mask_pallas`` with the
    line bins → ``where``."""
    ha, hb, hc = soup(verts, faces)
    tris, bins, line_bins = jgridgen._cpt_prep(jgrid, ha, hb, hc)
    seed = jcpt.seed_from_bins(jgrid, tris[0], tris[1], tris[2], bins)
    dist, _ = jcpt.closest_point_grid_pallas.__wrapped__(
        jgrid, tris[0], tris[1], tris[2], seed=seed,
        rounds=2 if max(jgrid.cell_count) <= 128 else 1, interpret=True,
    )
    inside, ovf = pallas_parity.grid_inside_mask_pallas(
        jgrid, *to_jax(ha, hb, hc), line_bins=line_bins, interpret=True)
    assert int(ovf) == 0
    return np.asarray(jnp.where(inside, -dist, dist))


def port_grid_sdf(verts, faces, grid, **kw):
    """The port's ``generate_grid_sdf`` with the raycast sign, through the
    CPT route unless ``strategy`` says otherwise."""
    kw.setdefault("strategy", tm.Strategy.CPT)
    return tm.generate_grid_sdf(
        torch.from_numpy(np.asarray(verts, np.float32)),
        tm.Topology.triangle_list(np.asarray(faces).reshape(-1)), grid,
        tm.SignMethod.RAYCAST, **kw,
    )


def assert_same_field(got, want):
    """Magnitudes within the distance tolerance, signs exactly equal."""
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def jax_x_sweeps(state, slab):
    """``parallel.grid_sharded._x_sweeps_pallas`` with the kernel in
    interpret mode (the TPU halo re-sweeps: +x, then -x)."""
    fc = jnp.asarray(slab.first_cell, jnp.float32)
    cs = jnp.asarray(slab.cell_size, jnp.float32)
    tup = (state.d1, jnp.transpose(state.v1, (0, 3, 1, 2)), state.i1,
           state.d2, jnp.transpose(state.v2, (0, 3, 1, 2)), state.i2)
    for rev in (False, True):
        tup = pallas_sweep.sweep_oriented(*tup, rev, fc, cs, comp0=0,
                                          comp1=1, comp2=2, interpret=True)
    return jcpt.CptState(tup[0], jnp.transpose(tup[1], (0, 2, 3, 1)), tup[2],
                         tup[3], jnp.transpose(tup[4], (0, 2, 3, 1)), tup[5])
