"""Rank bodies for the port's multi-rank tests
(``tests/test_torch_sharding.py``, ``test_torch_grid_sharded.py``,
``test_torch_scaling.py``).

Each test file spawns ``WORLD`` CPU ranks once (:func:`run_ranks`): every
rank joins a gloo group over a file store under the test's ``tmp_path``,
runs one body of this module with one torch thread, and pickles its results
(numpy arrays, floats, exception names) for the test process to read. The
bodies import torch and the port only, never JAX: a spawned child imports
the module of the function it runs. The inputs are made here from seeds,
so the test process feeds the JAX package the same arrays.
"""
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from baselines import make_icosphere

WORLD = 4
#: Ranks' time limit: a hung collective fails the test instead of the run.
TIMEOUT_S = 240


def _entry(rank, body, world, store, out_dir, kwargs):
    torch.set_num_threads(1)
    from mesh_to_sdf_tpu_torch.parallel import mesh as pmesh

    pmesh.initialize_distributed(f"file://{store}", world, rank,
                                 device_type="cpu")
    try:
        result = globals()[body](**kwargs)
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(result, fh)


def run_ranks(body: str, tmp_path, world: int = WORLD, **kwargs) -> list:
    """Run ``body(**kwargs)`` on ``world`` spawned gloo ranks; returns each
    rank's result, in rank order."""
    out_dir = Path(tmp_path)
    ctx = mp.start_processes(
        _entry, args=(body, world, str(out_dir / "store"), str(out_dir),
                      kwargs),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{body}: ranks still running after "
                                   f"{TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    results = []
    for rank in range(world):
        with open(out_dir / f"rank{rank}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results


def _raises(fn, *args, **kwargs):
    """The name of the exception ``fn`` raised, or None."""
    try:
        fn(*args, **kwargs)
    except Exception as exc:  # recorded for the test process to check
        return type(exc).__name__
    return None


# ----------------------------------------------------------------- inputs
def sharding_inputs() -> dict:
    """tests/test_sharding.py's inputs: icosphere(1), 100 queries in
    [-1.5, 1.5]³; the gradient's icosphere(0) and 16 queries on a line;
    the fit step's two spheres; CULLED's icosphere(2) and queries."""
    rng = np.random.default_rng(20260816)
    v1, f1 = make_icosphere(subdiv=1)
    v0, f0 = make_icosphere(subdiv=0)
    v8, _ = make_icosphere(subdiv=1, radius=0.8)
    v2, f2 = make_icosphere(subdiv=2)
    return {
        "verts": v1, "faces": f1.astype(np.int32),
        "queries": rng.uniform(-1.5, 1.5, size=(100, 3)).astype(np.float32),
        "grad_verts": v0, "grad_faces": f0.astype(np.int32),
        "grad_queries": np.linspace(-1.2, 1.2, 16 * 3).reshape(16, 3)
        .astype(np.float32),
        "fit_verts": v8,
        "culled_verts": v2, "culled_faces": f2.astype(np.int64),
        "culled_queries": rng.uniform(-1.4, 1.4, (4096, 3))
        .astype(np.float32),
    }


#: (cells, tris) meshes of the 4-rank world.
MESHES = {"cells4": (4, 1), "cells2_tris2": (2, 2)}
GRID8 = ([-1.4] * 3, [1.4] * 3, [8, 8, 8])
FIT_STEPS = 10
FIT_LR = 2e-2


# ----------------------------------------------------------------- bodies
def sharding_cases() -> dict:
    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch.models.sdf_layer import pad_tri_idx
    from mesh_to_sdf_tpu_torch.models.sdf_layer import sdf_grid
    from mesh_to_sdf_tpu_torch.parallel import mesh as pmesh
    from mesh_to_sdf_tpu_torch.parallel import sharding

    x = sharding_inputs()
    out = {"sharded": {}, "errors": {}}
    meshes = {name: pmesh.make_sdf_mesh(c, t, device_type="cpu")
              for name, (c, t) in MESHES.items()}
    for name, m in meshes.items():
        for sign in tm.SignMethod:
            out["sharded"][name, sign.value] = sharding.generate_sdf_sharded(
                x["verts"], x["faces"], x["queries"], m, sign, block=64,
                device="cpu").numpy()
    grid = tm.Grid.from_bounding_box(*GRID8)
    out["grid_normal"] = sharding.generate_grid_sdf_sharded(
        x["verts"], x["faces"], grid, meshes["cells2_tris2"],
        tm.SignMethod.NORMAL, block=64, device="cpu").numpy()

    # The vertex gradient of sum(sdf) over the queries: each rank's part
    # of it, then the sum over the world.
    m = meshes["cells2_tris2"]
    fn = sharding.sharded_sdf_fn(m, tm.SignMethod.NORMAL, block=32)
    tri = sharding._pad_tri_idx(x["grad_faces"], m, 32)
    v = torch.from_numpy(x["grad_verts"]).requires_grad_(True)
    t_loc = torch.from_numpy(pmesh.local_rows(tri, m, pmesh.tri_sharding(m)))
    q_loc = torch.from_numpy(pmesh.local_rows(x["grad_queries"], m,
                                              pmesh.cell_sharding(m)))
    torch.sum(fn(v, t_loc, q_loc)).backward()
    out["grad_local"] = v.grad.numpy().copy()
    out["grad"] = pmesh._all_reduce_(v.grad).numpy()

    # Ten Adam steps toward the radius-1 sphere's NORMAL field.
    target = sdf_grid(
        torch.from_numpy(x["verts"]),
        torch.from_numpy(pad_tri_idx(x["faces"], 64)), grid,
        tm.SignMethod.NORMAL).reshape(-1)
    v = torch.from_numpy(x["fit_verts"].copy()).requires_grad_(True)
    opt = torch.optim.Adam([v], lr=FIT_LR)
    step, pad_target = sharding.sharded_fit_step_fn(
        m, x["faces"], grid, opt, tm.SignMethod.NORMAL, block=64)
    shard = pad_target(target)
    out["losses"] = [float(step(shard)) for _ in range(FIT_STEPS)]
    out["fit_verts"] = v.detach().numpy().copy()

    m4 = meshes["cells4"]
    args = (x["culled_verts"], x["culled_faces"])
    out["culled"] = sharding.generate_sdf_sharded_culled(
        *args, x["culled_queries"], m4, device="cpu").numpy()
    out["culled_tiny"] = sharding.generate_sdf_sharded_culled(
        *args, x["culled_queries"][:2048], m4, st=32, nb_sub=1, nb_table=2,
        device="cpu").numpy()

    out["errors"]["mesh 3x1"] = _raises(pmesh.make_sdf_mesh, 3, 1,
                                        device_type="cpu")
    out["coords"] = tuple(m.get_coordinate())
    out["pad"] = [pmesh.pad_for_axis(n, m, ax, mult) for n, ax, mult in (
        (100, pmesh.CELL_AXIS, 8), (20, pmesh.TRI_AXIS, 64),
        (1, pmesh.CELL_AXIS, 1))]
    out["backend"] = dist.get_backend(m.get_group(pmesh.CELL_AXIS))
    return out


def grid_inputs() -> dict:
    """tests/test_grid_sharded.py's inputs: icosphere(2) on a 32×16×16
    grid over [-1.3, 1.3]³; the torus on a thin 16×8×12 grid."""
    from mesh_to_sdf_tpu_torch.utils.meshgen import torus

    v, f = make_icosphere(subdiv=2)
    tv, tf = torus(1.0, 0.35, n_major=24, n_minor=12)
    return {"verts": v, "faces": f.astype(np.int64),
            "grid": ([-1.3] * 3, [1.3] * 3, [32, 16, 16]),
            "torus_verts": tv, "torus_faces": tf.astype(np.int64),
            "torus_grid": ([-1.6, -0.6, -1.6], [1.6, 0.6, 1.6], [16, 8, 12]),
            "uneven_grid": ([-1.3] * 3, [1.3] * 3, [30, 16, 16])}


def grid_cases() -> dict:
    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch.parallel import mesh as pmesh
    from mesh_to_sdf_tpu_torch.parallel.grid_sharded import (
        generate_grid_sdf_sharded_cpt)

    x = grid_inputs()
    m = pmesh.make_sdf_mesh(4, 1, device_type="cpu")
    grid = tm.Grid.from_bounding_box(*x["grid"])
    out = {}
    for sign in tm.SignMethod:
        out[sign.value] = generate_grid_sdf_sharded_cpt(
            x["verts"], x["faces"], grid, m, sign, device="cpu").numpy()
    for rounds in (1, 3):
        out[f"halo{rounds}"] = generate_grid_sdf_sharded_cpt(
            x["verts"], x["faces"], grid, m, halo_rounds=rounds,
            device="cpu").numpy()
    out["torus"] = generate_grid_sdf_sharded_cpt(
        x["torus_verts"], x["torus_faces"],
        tm.Grid.from_bounding_box(*x["torus_grid"]), m, device="cpu").numpy()
    out["uneven"] = _raises(generate_grid_sdf_sharded_cpt, x["verts"],
                            x["faces"], tm.Grid.from_bounding_box(
                                *x["uneven_grid"]), m, device="cpu")
    return out


SCALING = dict(base_nx=8, ny=16, nz=16, subdiv=1, repeats=2,
               device_counts=[1, 2, 4])


def scaling_cases() -> dict:
    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch.parallel import mesh as pmesh
    from mesh_to_sdf_tpu_torch.parallel.grid_sharded import (
        generate_grid_sdf_sharded_cpt)
    from mesh_to_sdf_tpu_torch.parallel.scaling import measure_weak_scaling
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

    out = {"report": measure_weak_scaling(**SCALING, device="cpu")}
    # The harness's n=2 workload, run directly on the first two ranks.
    verts, faces = icosphere(subdiv=1)
    grid = tm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [16, 16, 16])
    m2 = pmesh.make_sdf_mesh(2, 1, ranks=range(2), device_type="cpu")
    if dist.get_rank() < 2:
        out["two_ranks"] = generate_grid_sdf_sharded_cpt(
            verts, faces, grid, m2, tm.SignMethod.RAYCAST,
            device="cpu").numpy()
    dist.barrier()
    return out
