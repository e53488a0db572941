"""The port's differentiable SDF ops (``ops.autodiff``, ``cpt._seed``,
``models.sdf_layer``'s ``sdf_at_points`` and ``sdf_grid``) against the JAX
package's, from the same numpy inputs, on the CPU.

Tolerances:
- ``cpt._seed``: bit-equal (both take the same float32 operations, and the
  min / max scatters do not depend on their order);
- distances: rtol=2e-4, atol=1e-5 (torch_port_helpers: XLA fuses the
  float32 ladder differently from eager ops, a few ulps);
- gradients against ``jax.grad`` of the dense reductions: rtol=1e-4,
  atol=1e-5 (the same argmin triangles, so they differ only by those ulps
  and by the order of the scatter-adds); queries are random points, so no
  two triangles tie for one of them;
- the CPT forward: squared distances at rtol=2e-4 and atol=32·2^-24
  (``LADDER_ATOL2``). Its sweeps re-evaluate every candidate with the TPU
  sweep kernel's division-free ladder (``pallas_sweep._pt_dist2``, which
  the port's sweep follows bit for bit), and that ladder gets d² by
  cancellation: its absolute error is a few dozen ulps of |p − a|² (≤ 1
  here), which within ~1e-3 of the surface is up to ~4e-5 in d. The JAX
  package's CPU route evaluates with the exact projection instead, so
  there the two differ by more than the distance tolerance (and the
  kernel's value may fall below the exact distance by that much);
- the CPT backward: both packages' backwards fed the SAME (dist, idx), so a
  tie that picks another triangle in one forward cannot move the gradient:
  rtol=1e-5, atol=1e-6;
- finite differences: rtol=5e-2 (as tests/test_cpt.py and
  tests/test_autodiff.py), central differences with eps=1e-3.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines import make_icosphere
from mesh_to_sdf_tpu import Grid as JGrid
from mesh_to_sdf_tpu import SignMethod as JSign
from mesh_to_sdf_tpu.models import sdf_layer as jlayer
from mesh_to_sdf_tpu.ops import autodiff as jautodiff
from mesh_to_sdf_tpu.ops import cpt as jcpt
from mesh_to_sdf_tpu.ops.keyed import combine_champions as jcombine
from mesh_to_sdf_tpu_torch import SignMethod
from mesh_to_sdf_tpu_torch.models import sdf_layer as tlayer
from mesh_to_sdf_tpu_torch.ops import autodiff as tautodiff
from mesh_to_sdf_tpu_torch.ops import cpt as tcpt
from mesh_to_sdf_tpu_torch.ops.keyed import combine_champions
from torch_port_helpers import ATOL, RTOL, port_grid, soup, to_jax, to_torch

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LADDER_ATOL2 = 32 * 2.0 ** -24

JSIGNS = {SignMethod.NORMAL: JSign.NORMAL, SignMethod.RAYCAST: JSign.RAYCAST}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker: the suite's xdist workers share the
    cores, and torch's pool stalls on its barriers when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(subdiv, block=64):
    v, f = make_icosphere(subdiv=subdiv)
    return v, f, jlayer.pad_tri_idx(f.astype(np.int32), block)


def _queries(n, lim, seed):
    return np.random.default_rng(seed).uniform(-lim, lim, (n, 3)).astype(
        np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _grads_torch(fn, *arrays):
    """(value, grads) of scalar ``fn`` at float32 leaves made of ``arrays``."""
    leaves = [torch.from_numpy(np.array(a, np.float32)).requires_grad_(True)
              for a in arrays]
    out = fn(*leaves)
    out.backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


# ------------------------------------------------------------ window seed
@pytest.mark.parametrize("shape", [(20, 20, 20), (13, 11, 9)])
def test_seed_bit_equal_to_jax(shape):
    tris = soup(*make_icosphere(subdiv=2))
    jg = JGrid.from_bounding_box([-1.3] * 3, [1.3] * 3, list(shape))
    want = jcpt._seed(jg, *to_jax(*tris), jcpt.SEED_SPAN)
    got = tcpt._seed(port_grid(jg), *to_torch(*tris), tcpt.SEED_SPAN)
    assert tcpt.SEED_SPAN == jcpt.SEED_SPAN
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.view(np.int32))


# ------------------------------------------------------ dense reductions
@pytest.mark.parametrize("block", [64, 512])
def test_unsigned_min_distance_matches_jax(block):
    v, _, tri = _mesh(1)
    q = _queries(40, 1.5, 1)
    w = np.random.default_rng(2).normal(size=40).astype(np.float32)

    def jloss(vv, qq):
        return jnp.sum(w * jautodiff.unsigned_min_distance(
            vv, jnp.asarray(tri), qq, block))

    def tloss(vv, qq):
        return torch.sum(torch.from_numpy(w) * tautodiff.unsigned_min_distance(
            vv, torch.from_numpy(tri), qq, block))

    got_d = tautodiff.unsigned_min_distance(*to_torch(v, tri, q), block)
    want_d = jautodiff.unsigned_min_distance(*to_jax(v, tri, q), block)
    _close(got_d, want_d)
    val, (gv, gq) = _grads_torch(tloss, v, q)
    jgv, jgq = jax.grad(jloss, argnums=(0, 1))(*to_jax(v, q))
    _close(val, jloss(*to_jax(v, q)))
    _close(gv, jgv, GRAD_RTOL, GRAD_ATOL)
    _close(gq, jgq, GRAD_RTOL, GRAD_ATOL)
    # d/dq of a distance has unit norm (eikonal).
    np.testing.assert_allclose(np.linalg.norm(gq / w[:, None], axis=-1), 1.0,
                               atol=1e-4)


@pytest.mark.parametrize("block", [64, 512])
def test_signed_champions_match_jax(block):
    v, _, tri = _mesh(1)
    q = _queries(40, 1.4, 3)

    def jloss(vv, qq):
        mp, mn = jautodiff.signed_champion_distances(vv, jnp.asarray(tri), qq,
                                                     block)
        return jnp.sum(jcombine(mp, mn))

    def tloss(vv, qq):
        mp, mn = tautodiff.signed_champion_distances(
            vv, torch.from_numpy(tri), qq, block)
        return torch.sum(combine_champions(mp, mn))

    got = tautodiff.signed_champion_distances(*to_torch(v, tri, q), block)
    want = jautodiff.signed_champion_distances(*to_jax(v, tri, q), block)
    for g, w in zip(got, want):
        _close(g, w)
    _, (gv, gq) = _grads_torch(tloss, v, q)
    jgv, jgq = jax.grad(jloss, argnums=(0, 1))(*to_jax(v, q))
    _close(gv, jgv, GRAD_RTOL, GRAD_ATOL)
    _close(gq, jgq, GRAD_RTOL, GRAD_ATOL)


def _fd(f, x, coords, eps=1e-3):
    """Central differences of scalar ``f`` (float64 result) at ``coords``."""
    out = []
    for i in coords:
        xp, xm = x.copy(), x.copy()
        xp[i] += eps
        xm[i] -= eps
        out.append((f(xp) - f(xm)) / (2 * eps))
    return np.array(out)


@pytest.mark.parametrize("sign", [SignMethod.NORMAL, SignMethod.RAYCAST])
def test_sdf_at_points_vertex_grads_fd(sign):
    """The port's own gradients against finite differences
    (tests/test_autodiff.py's checks, on icosphere(0))."""
    v, _, tri = _mesh(0)
    q = torch.from_numpy(_queries(5, 1.5, 4))
    w = torch.from_numpy(np.random.default_rng(5).normal(size=5).astype(
        np.float32))
    tri_t = torch.from_numpy(tri)

    def f(vv):
        return torch.sum(w * tlayer.sdf_at_points(vv, tri_t, q, sign,
                                                  block=64))

    _, (gv,) = _grads_torch(f, v)
    coords = [(i, k) for i in range(len(v)) for k in range(3)]
    fd = _fd(lambda x: float(f(torch.from_numpy(x.astype(np.float32)))),
             v.astype(np.float64), coords)
    np.testing.assert_allclose(gv.reshape(-1), fd, atol=3e-3, rtol=2e-2)


@pytest.mark.parametrize("sign", [SignMethod.NORMAL, SignMethod.RAYCAST])
def test_sdf_at_points_matches_jax(sign):
    v, _, tri = _mesh(1)
    q = _queries(64, 1.5, 6)

    def tf(vv, qq):
        return tlayer.sdf_at_points(vv, torch.from_numpy(tri), qq, sign,
                                    block=64)

    def jf(vv, qq):
        return jlayer.sdf_at_points(vv, jnp.asarray(tri), qq, JSIGNS[sign],
                                    block=64)

    got = tf(*to_torch(v, q))
    want = np.asarray(jf(*to_jax(v, q)))
    _close(got, want)
    np.testing.assert_array_equal(np.signbit(got.numpy()), np.signbit(want))
    _, (gv, gq) = _grads_torch(lambda a, b: torch.sum(tf(a, b) ** 2), v, q)
    jgv, jgq = jax.grad(lambda a, b: jnp.sum(jf(a, b) ** 2),
                        argnums=(0, 1))(*to_jax(v, q))
    _close(gv, jgv, GRAD_RTOL, GRAD_ATOL)
    _close(gq, jgq, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("sign", [SignMethod.NORMAL, SignMethod.RAYCAST])
def test_sdf_grid_matches_jax(sign):
    """Even cell counts: no parity line runs through the mid-plane, where
    the icosphere's vertices lie. The target is a random field, so the
    gradients weigh every cell."""
    v, _, tri = _mesh(1)
    jg = JGrid.from_bounding_box([-1.4] * 3, [1.4] * 3, [12, 10, 8])
    target = np.random.default_rng(7).uniform(-1, 1, (12, 10, 8)).astype(
        np.float32)

    def tf(vv):
        return tlayer.sdf_grid(vv, torch.from_numpy(tri), port_grid(jg), sign,
                               block=64)

    def jf(vv):
        return jlayer.sdf_grid(vv, jnp.asarray(tri), jg, JSIGNS[sign],
                               block=64)

    got = tf(*to_torch(v))
    want = np.asarray(jf(jnp.asarray(v)))
    assert got.shape == want.shape == (12, 10, 8)
    _close(got, want)
    np.testing.assert_array_equal(np.signbit(got.numpy()), np.signbit(want))
    _, (gv,) = _grads_torch(
        lambda a: torch.sum((tf(a) - torch.from_numpy(target)) ** 2), v)
    jgv = jax.grad(lambda a: jnp.sum((jf(a) - target) ** 2))(jnp.asarray(v))
    _close(gv, jgv, GRAD_RTOL, GRAD_ATOL)


# ---------------------------------------------------- CPT grid distance
CPT_GRID = ([-1.4] * 3, [1.4] * 3, [10, 12, 9])  # non-cubic: see below


@functools.lru_cache(maxsize=None)
def _cpt_case():
    """(v, faces, JAX Grid, JAX f, JAX (dist, idx)). The grid is not cubic:
    there the JAX package's CPU route (``use_pallas=False``) runs
    Gauss-Seidel sweeps, the port's orchestration; on cubic grids it runs
    batched Jacobi sweeps, whose far field may differ."""
    v, f = make_icosphere(subdiv=1)
    jg = JGrid.from_bounding_box(*CPT_GRID)
    jfn = jautodiff.make_cpt_grid_distance(jg, f, v, use_pallas=False)
    dist, idx = jfn.fwd(jnp.asarray(v))[1][1:]
    return v, f, jg, jfn, np.array(dist), np.array(idx)


def test_cpt_grid_distance_forward_matches_jax():
    v, f, jg, _, want_d, _ = _cpt_case()
    fn = tautodiff.make_cpt_grid_distance(port_grid(jg), f, v)
    d, idx = fn.forward(torch.from_numpy(v))
    assert d.shape == tuple(jg.cell_count) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0
    _close(d.double() ** 2, want_d.astype(np.float64) ** 2, RTOL,
           LADDER_ATOL2)
    torch.testing.assert_close(fn(torch.from_numpy(v)), d, rtol=0, atol=0)


def test_cpt_grid_backward_matches_jax_on_the_same_forward():
    v, f, jg, jfn, dist, idx = _cpt_case()
    g = np.random.default_rng(8).normal(size=dist.shape).astype(np.float32)
    (want,) = jfn.bwd((jnp.asarray(v), jnp.asarray(dist), jnp.asarray(idx)),
                      jnp.asarray(g))
    fn = tautodiff.make_cpt_grid_distance(port_grid(jg), f, v)
    got = fn.vjp(*to_torch(v, dist, idx, g))
    _close(got, want, 1e-5, 1e-6)
    # The autograd Function takes the same backward.
    vt = torch.from_numpy(v).requires_grad_(True)
    d = fn(vt)
    torch.sum(d * torch.from_numpy(g)).backward()
    _close(vt.grad, fn.vjp(vt.detach(), d.detach(), fn.forward(vt)[1],
                           torch.from_numpy(g)), 0, 0)


def test_cpt_grid_gradients_fd():
    """tests/test_cpt.py::test_cpt_grid_gradients_fd on the port."""
    v, f = make_icosphere(subdiv=1)
    g = port_grid(JGrid.from_bounding_box([-1.4] * 3, [1.4] * 3, [10] * 3))
    fn = tautodiff.make_cpt_grid_distance(g, f, v)

    def loss(vv):
        return torch.sum((fn(vv) - 0.3) ** 2)

    _, (gr,) = _grads_torch(loss, v)
    rng = np.random.default_rng(5)
    coords = [(int(rng.integers(0, len(v))), int(rng.integers(0, 3)))
              for _ in range(6)]
    fd = _fd(lambda x: float(loss(torch.from_numpy(x))), v.astype(np.float32),
             coords)
    checked = 0
    for (i, k), d in zip(coords, fd):
        if abs(d) < 0.2:
            continue  # fd unreliable near Voronoi boundaries
        np.testing.assert_allclose(gr[i, k], d, rtol=5e-2)
        checked += 1
    assert checked >= 3
