"""The port's CPT sweep (plain PyTorch on the CPU) against the JAX package's
Pallas sweep kernel in interpret mode, per direction and orchestrated.

Tolerances (torch_port_helpers): distances rtol=2e-4, atol=1e-5, because the
two frameworks fuse the float32 ladder differently; indices are compared by
re-evaluating the distance at the cell, because ties are common.

Each grid's six directional sweeps compile once in interpret mode (some
seconds each), which takes most of this file's time. The per-direction test
runs the shapes and static arguments of the 16×16×12 grid's own sweeps, so
it shares their compilations.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines import make_box, make_icosphere
from mesh_to_sdf_tpu import Grid as JGrid
from mesh_to_sdf_tpu.ops.kernels import pallas_sweep
from mesh_to_sdf_tpu_torch import F32_MAX, gridgen
from mesh_to_sdf_tpu_torch.ops import cpt as tcpt
from mesh_to_sdf_tpu_torch.ops.kernels import sweep as tsweep
from torch_port_helpers import (ATOL, RTOL, assert_index_consistent,
                                check_closest_point_grid, grid_centers,
                                jax_seed, port_grid, reeval_distance, soup,
                                to_jax, to_torch)


@pytest.fixture(autouse=True)
def _clear_port_prep_cache():
    gridgen._CPT_PREP_CACHE.clear()
    yield
    gridgen._CPT_PREP_CACHE.clear()


CASES = {
    "icosphere-16x16x12": (lambda: make_icosphere(subdiv=2),
                           [-1.3] * 3, [1.3] * 3, (16, 16, 12)),
    "box-10x14x12": (lambda: make_box(size=(1.6, 1.0, 0.8)),
                     [-1.3] * 3, [1.3] * 3, (10, 14, 12)),
    "icosphere-cubic-16": (lambda: make_icosphere(subdiv=2),
                           [-1.4] * 3, [1.4] * 3, (16, 16, 16)),
}

# Orientation of the x-first state for a sweep along each axis
# (cpt.closest_point_grid_pallas).
PERM3 = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}
PERM4 = {0: (0, 1, 2, 3), 1: (2, 1, 0, 3), 2: (3, 1, 0, 2)}
COMPS = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}


@functools.lru_cache(maxsize=None)
def _case(name):
    mesh_fn, lo, hi, shape = CASES[name]
    jg = JGrid.from_bounding_box(lo, hi, list(shape))
    return soup(*mesh_fn()), jg


@functools.lru_cache(maxsize=None)
def _jax_seed(name):
    tris, jg = _case(name)
    return jax_seed(jg, tris)


def test_pt_dist_ladder_matches_jax():
    rng = np.random.default_rng(7)
    n = 4096
    p = rng.normal(size=(3, n)).astype(np.float32)
    v = rng.normal(size=(9, n)).astype(np.float32)
    # Degenerate triangles: a == b, a == c, b == c, all equal.
    v[3:6, :64] = v[0:3, :64]
    v[6:9, 64:128] = v[0:3, 64:128]
    v[6:9, 128:192] = v[3:6, 128:192]
    v[3:9, 192:256] = np.tile(v[0:3, 192:256], (2, 1))
    got = tsweep._pt_dist2(*to_torch(*p), torch.from_numpy(v)).numpy()
    want = np.asarray(pallas_sweep._pt_dist2(*to_jax(*p), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    got = tsweep._pt_dist(*to_torch(*p), torch.from_numpy(v)).numpy()
    want = np.asarray(pallas_sweep._pt_dist(*to_jax(*p), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _random_state(rng, jg, tris):
    """x-first CPT state: random triangle ids (15% empty) with exact
    distances and vertex payloads, as the seed would hold them."""
    ta, tb, tc = tris
    T = len(ta)
    shape = jg.cell_count
    centers = grid_centers(jg).reshape(-1, 3)
    tv = np.concatenate([np.concatenate([ta, tb, tc], 1),
                         np.full((1, 9), tsweep.PAD_COORD, np.float32)])
    out = []
    for _ in range(2):
        ids = rng.integers(0, T, size=shape).astype(np.int32)
        ids[rng.random(shape) < 0.15] = -1
        d = reeval_distance(centers, ta, tb, tc, ids).reshape(shape)
        d = np.where(ids < 0, np.float32(F32_MAX), d).astype(np.float32)
        v = tv[np.where(ids < 0, T, ids)].transpose(0, 3, 1, 2)
        out += [d, np.ascontiguousarray(v), ids]
    return out  # d1, v1, i1, d2, v2, i2


def _scattered_soup(rng, n=48):
    """Small triangles at random places: unlike a closed mesh, no two
    triangles tie at a cell, so an ulp of difference between the frameworks
    cannot flip which one a slot keeps."""
    centers = rng.uniform(-1.2, 1.2, size=(n, 1, 3))
    tris = (centers + rng.normal(scale=0.15, size=(n, 3, 3))).astype(
        np.float32)
    return tris[:, 0], tris[:, 1], tris[:, 2]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_oriented_matches_jax(axis, reverse):
    """One directional sweep from a random state (numpy seed), per (axis,
    reverse): the shapes and static arguments of the 16×16×12 case's own
    sweeps."""
    _, jg = _case("icosphere-16x16x12")
    rng = np.random.default_rng(10 * axis + reverse)
    tris = _scattered_soup(rng)
    state = _random_state(rng, jg, tris)
    state = [np.ascontiguousarray(
        a.transpose(PERM4[axis] if a.ndim == 4 else PERM3[axis]))
        for a in state]
    c0, c1, c2 = COMPS[axis]
    fc = np.array(jg.first_cell, np.float32)
    cs = np.array(jg.cell_size, np.float32)
    want = pallas_sweep.sweep_oriented(
        *to_jax(*state), reverse, jnp.asarray(fc), jnp.asarray(cs),
        comp0=c0, comp1=c1, comp2=c2, interpret=True,
    )
    want = [np.asarray(a) for a in want]
    inputs = to_torch(*state)
    got = tsweep.sweep_oriented(*inputs, reverse, torch.from_numpy(fc),
                                torch.from_numpy(cs), comp0=c0, comp1=c1,
                                comp2=c2)
    assert all(g is t for g, t in zip(got, inputs))  # updated in place
    got = [t.numpy() for t in got]

    centers = np.ascontiguousarray(
        grid_centers(jg).transpose(PERM3[axis] + (3,))).reshape(-1, 3)
    ta, tb, tc = tris
    for d, i, dw, iw in ((got[0], got[2], want[0], want[2]),
                         (got[3], got[5], want[3], want[5])):
        np.testing.assert_allclose(d, dw, rtol=RTOL, atol=ATOL)
        differ = (i != iw).reshape(-1)
        assert differ.mean() < 0.05
        for idx in (i, iw):
            sel = differ & (idx.reshape(-1) >= 0)
            assert_index_consistent(centers[sel], ta, tb, tc,
                                    idx.reshape(-1)[sel],
                                    d.reshape(-1)[sel])
    # The vertex payload always belongs to the carried id.
    tv = np.concatenate([np.concatenate([ta, tb, tc], 1),
                         np.full((1, 9), tsweep.PAD_COORD, np.float32)])
    for v, i in ((got[1], got[2]), (got[4], got[5])):
        np.testing.assert_array_equal(
            v, tv[np.where(i < 0, len(ta), i)].transpose(0, 3, 1, 2))


@pytest.mark.parametrize("name", CASES)
def test_seed_from_bins_matches_jax(name):
    (ta, tb, tc), jg = _case(name)
    bins, want = _jax_seed(name)
    tg = port_grid(jg)
    got = tcpt.seed_from_bins(tg, *to_torch(ta, tb, tc), bins)
    got = [t.numpy() for t in got]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    centers = grid_centers(jg).reshape(-1, 3)
    for k in (0, 2):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
        seeded = got[k + 1] >= 0
        np.testing.assert_array_equal(seeded, want[k + 1] >= 0)
        assert_index_consistent(centers[seeded], ta, tb, tc,
                                got[k + 1][seeded], got[k][seeded])
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_closest_point_grid_matches_jax(name, rounds):
    tris, jg = _case(name)
    check_closest_point_grid(jg, tris, rounds)


def test_closest_point_grid_leaves_seed_unchanged():
    (ta, tb, tc), jg = _case("box-10x14x12")
    _, seed = _jax_seed("box-10x14x12")
    seed_t = to_torch(*(s.copy() for s in seed))
    tcpt.closest_point_grid(port_grid(jg), *to_torch(ta, tb, tc),
                            seed=seed_t)
    for got, want in zip(seed_t, seed):
        np.testing.assert_array_equal(got.numpy(), want)


def test_sweep_wrapper_validates_inputs():
    n0, n1, n2 = 3, 4, 5
    d = torch.zeros((n0, n1, n2))
    v = torch.zeros((n0, 9, n1, n2))
    i = torch.zeros((n0, n1, n2), dtype=torch.int32)
    fc, cs = torch.zeros(3), torch.ones(3)
    with pytest.raises(ValueError, match="i1"):
        tsweep.sweep_oriented(d, v, i.float(), d, v, i, False, fc, cs,
                              comp0=0, comp1=1, comp2=2)
    with pytest.raises(ValueError, match="v2"):
        tsweep.sweep_oriented(d, v, i, d, v[:, :8], i, False, fc, cs,
                              comp0=0, comp1=1, comp2=2)
    with pytest.raises(ValueError, match="contiguous"):
        tsweep.sweep_oriented(d, v, i, d.transpose(1, 2).contiguous()
                              .transpose(1, 2), v, i, False, fc, cs,
                              comp0=0, comp1=1, comp2=2)
    with pytest.raises(ValueError, match="permute"):
        tsweep.sweep_oriented(d, v, i, d, v, i, False, fc, cs,
                              comp0=0, comp1=0, comp2=2)
    meta = [t.to("meta") for t in (d, v, i, d, v, i)]
    with pytest.raises(ValueError, match="no kernel"):
        tsweep.sweep_oriented(*meta, False, fc, cs, comp0=0, comp1=1, comp2=2)


def test_plain_version_counts_its_calls():
    (ta, tb, tc), jg = _case("box-10x14x12")
    state = to_torch(*_random_state(np.random.default_rng(3), jg,
                                    (ta, tb, tc)))
    before = tsweep.COUNT.plain, tsweep.COUNT.kernel
    tsweep.sweep_oriented(*state, True, port_grid(jg).first_cell,
                          port_grid(jg).cell_size, comp0=0, comp1=1, comp2=2)
    assert (tsweep.COUNT.plain, tsweep.COUNT.kernel) == (
        before[0] + 1, before[1])
