"""The port's ``models`` (DifferentiableSDF with ``torch.optim.Adam``, and
the fit-state checkpoint) against the JAX package's, on the CPU.

Tolerances:
- one Adam step against optax from the same state and gradient: the
  moments at rtol=1e-6, atol=1e-7 (the same float32 formula); the
  parameters at atol=2e-5·max|step|. optax takes the bias correction 1 − b2^t in
  float32, where 0.999 rounds up by 1.3e-5 relative in 1 − b2 (so 6.4e-6
  in its root), torch in float64: the step's size differs by about that
  fraction;
- checkpoints: leaves bit-equal in both directions; the loss of the next
  step after a resume in the other package at rtol=1e-5 (a forward of the
  same parameters, computed in two frameworks);
- fits: the JAX tests' own bounds (tests/test_models.py,
  tests/test_autodiff.py, tests/test_cpt.py), on the same meshes and grids.
  The CPT fit runs on a cubic grid, where the JAX package's CPU route takes
  batched Jacobi sweeps and the port Gauss-Seidel ones, so there it is held
  only to its own falling loss.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baselines import make_icosphere
from mesh_to_sdf_tpu import Grid as JGrid
from mesh_to_sdf_tpu import SignMethod as JSign
from mesh_to_sdf_tpu.models import checkpoint as jckpt
from mesh_to_sdf_tpu.models import sdf_layer as jlayer
import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch.models import checkpoint as tckpt
from mesh_to_sdf_tpu_torch.models import sdf_layer as tlayer
from torch_port_helpers import port_grid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker (see tests/test_torch_autodiff.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves_equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _jax_leaves(state):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(state)]


# ---------------------------------------------------------------- Adam
@pytest.mark.parametrize("count", [0, 3])
def test_adam_step_matches_optax(count):
    """One Adam step from the same state: fresh (count 0) and with moments
    (count 3, where the bias corrections differ from the first step's)."""
    rng = np.random.default_rng(count)
    v = rng.normal(size=(42, 3)).astype(np.float32)
    grad = rng.normal(size=(42, 3)).astype(np.float32)
    mu = rng.normal(size=(42, 3)).astype(np.float32) * 0.1 * (count > 0)
    nu = rng.uniform(0, 0.1, (42, 3)).astype(np.float32) * (count > 0)
    lr = 5e-2

    tx = optax.adam(lr)
    jstate = tx.init(jnp.asarray(v))
    jstate = (jstate[0]._replace(count=jnp.asarray(count, jnp.int32),
                                 mu=jnp.asarray(mu), nu=jnp.asarray(nu)),
              jstate[1])
    updates, jstate = tx.update(jnp.asarray(grad), jstate, jnp.asarray(v))
    want = [np.asarray(optax.apply_updates(jnp.asarray(v), updates))] + \
        _jax_leaves(jstate)

    model = tlayer.DifferentiableSDF(np.zeros((1, 3), np.int32),
                                     tm.Grid.new([0] * 3, [1] * 3, [1] * 3),
                                     learning_rate=lr)
    like = model.init(v, device="cpu")
    state = tckpt.fit_state_from_leaves(
        [v, np.asarray(count, np.int32), mu, nu], like)
    state.params.grad = torch.from_numpy(grad)
    state.opt_state.step()
    got = tckpt.fit_state_leaves(state)
    assert int(got[1]) == int(want[1]) == count + 1
    step = np.abs(want[0] - v).max()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-5 * step)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_fresh_state_leaves_match_optax_init():
    v, f = make_icosphere(subdiv=0)
    g = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, [4] * 3)
    state = tlayer.DifferentiableSDF(f, g).init(v, device="cpu")
    jstate = jlayer.DifferentiableSDF(
        f, JGrid.from_bounding_box([-1.5] * 3, [1.5] * 3, [4] * 3)).init(v)
    _leaves_equal(tckpt.fit_state_leaves(state), _jax_leaves(jstate))
    assert state.params.requires_grad and state.params.device.type == "cpu"


# ---------------------------------------------------------------- fits
def test_fit_reduces_loss():
    """tests/test_models.py::test_fit_reduces_loss on the port."""
    v, f = make_icosphere(subdiv=1)
    g = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, [10] * 3)
    tri = torch.from_numpy(tlayer.pad_tri_idx(f.astype(np.int32), 64))
    target = tlayer.sdf_grid(torch.from_numpy(v * 1.15), tri, g,
                             tm.SignMethod.NORMAL, block=64)
    model = tlayer.DifferentiableSDF(f.astype(np.int32), g,
                                     tm.SignMethod.NORMAL, learning_rate=5e-2,
                                     block=64)
    state = model.init(v, device="cpu")
    losses = []
    for _ in range(8):
        state, loss = model.train_step(state, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.6, losses


def test_fit_vertices_to_target_grid():
    """tests/test_autodiff.py::test_fit_vertices_to_target_grid on the
    port: inflate a small sphere toward a bigger target sphere. Blocks of
    128 triangles in place of 512 pad the 80 triangles less (the padding
    rows are masked; the result does not depend on the block)."""
    verts, faces = make_icosphere(subdiv=1, radius=0.7)
    grid = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, [12, 12, 12])
    target_verts, _ = make_icosphere(subdiv=1, radius=1.0)
    model = tlayer.DifferentiableSDF(faces.astype(np.int32), grid,
                                     tm.SignMethod.NORMAL, learning_rate=3e-2,
                                     block=128)
    target = tlayer.sdf_grid(torch.from_numpy(target_verts), model.tri_idx,
                             grid, tm.SignMethod.NORMAL, block=128)
    state = model.init(verts, device="cpu")
    with torch.no_grad():
        loss0 = float(model.loss(state.params, target))
    for _ in range(40):
        state, loss = model.train_step(state, target)
    assert float(loss) < loss0 * 0.2, (loss0, float(loss))
    radii = state.params.detach().norm(dim=1).numpy()
    assert abs(float(radii.mean()) - 1.0) < 0.1, radii.mean()


def test_differentiable_sdf_cpt_engine():
    """tests/test_cpt.py::test_differentiable_sdf_cpt_engine on the port."""
    v, f = make_icosphere(subdiv=1)
    g = tm.Grid.from_bounding_box([-1.5] * 3, [1.5] * 3, [10] * 3)
    target = np.abs(tm.generate_grid_sdf(
        v * 1.15, tm.Topology.triangle_list(f.reshape(-1)), g,
        tm.SignMethod.NORMAL, strategy=tm.Strategy.XLA, device="cpu",
    ).numpy().reshape(10, 10, 10))
    model = tlayer.DifferentiableSDF(
        f.astype(np.int32), g, tm.SignMethod.NORMAL, learning_rate=5e-2,
        engine="cpt", vertices_example=v)
    state = model.init(v, device="cpu")
    losses = []
    for _ in range(6):
        state, loss = model.train_step(state, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses


def test_cpt_engine_needs_vertices_example():
    v, f = make_icosphere(subdiv=0)
    with pytest.raises(ValueError, match="vertices_example"):
        tlayer.DifferentiableSDF(f, tm.Grid.new([0] * 3, [1] * 3, [2] * 3),
                                 engine="cpt")


# ---------------------------------------------------------- checkpoints
def _models(grid_shape=(8, 8, 8)):
    """(port model, JAX model, target) on icosphere(1) at 8³ cells."""
    v, f = make_icosphere(subdiv=1)
    jg = JGrid.from_bounding_box([-1.5] * 3, [1.5] * 3, list(grid_shape))
    tri = jlayer.pad_tri_idx(f.astype(np.int32), 64)
    target = np.asarray(jlayer.sdf_grid(jnp.asarray(v * 1.1),
                                        jnp.asarray(tri), jg, JSign.NORMAL,
                                        block=64))
    tmodel = tlayer.DifferentiableSDF(f.astype(np.int32), port_grid(jg),
                                      tm.SignMethod.NORMAL, block=64)
    jmodel = jlayer.DifferentiableSDF(f.astype(np.int32), jg, JSign.NORMAL,
                                      block=64)
    return v, tmodel, jmodel, target


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_models.py::test_checkpoint_roundtrip on the port."""
    v, model, _, target = _models()
    state = model.init(v, device="cpu")
    state, _ = model.train_step(state, target)
    path = tmp_path / "fit.ckpt"
    tckpt.save_fit_state(path, state, step=1)
    restored, step = tckpt.load_fit_state(path, model.init(v, device="cpu"))
    assert step == 1
    _leaves_equal(tckpt.fit_state_leaves(restored),
                  tckpt.fit_state_leaves(state))
    # Training continues identically from the restored state.
    s1, l1 = model.train_step(state, target)
    s2, l2 = model.train_step(restored, target)
    assert float(l1) == float(l2)
    torch.testing.assert_close(s1.params, s2.params, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tckpt.load_fit_state(path, {"wrong": np.zeros(3)})
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"\x81\xa5magic\xa3bad")
    with pytest.raises(ValueError, match="not a fit-state"):
        tckpt.load_fit_state(bad, restored)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    v, tmodel, jmodel, target = _models()
    jstate = jmodel.init(v)
    for _ in range(2):
        jstate, _ = jmodel.train_step(jstate, jnp.asarray(target))
    path = tmp_path / "jax.ckpt"
    jckpt.save_fit_state(path, jstate, step=2)
    state, step = tckpt.load_fit_state(path, tmodel.init(v, device="cpu"))
    assert step == 2
    _leaves_equal(tckpt.fit_state_leaves(state), _jax_leaves(jstate))
    _, jloss = jmodel.train_step(jstate, jnp.asarray(target))
    state, loss = tmodel.train_step(state, target)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(tckpt.fit_state_leaves(state)[1]) == 3


def test_port_checkpoint_resumes_in_jax(tmp_path):
    v, tmodel, jmodel, target = _models()
    state = tmodel.init(v, device="cpu")
    for _ in range(2):
        state, _ = tmodel.train_step(state, target)
    path = tmp_path / "port.ckpt"
    tckpt.save_fit_state(path, state, step=2)
    jstate, step = jckpt.load_fit_state(path, jmodel.init(v))
    assert step == 2
    _leaves_equal(_jax_leaves(jstate), tckpt.fit_state_leaves(state))
    jstate, jloss = jmodel.train_step(jstate, jnp.asarray(target))
    _, loss = tmodel.train_step(state, target)
    np.testing.assert_allclose(float(jloss), float(loss), rtol=1e-5)
    assert int(_jax_leaves(jstate)[1]) == 3
