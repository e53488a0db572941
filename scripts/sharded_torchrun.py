#!/usr/bin/env python3
"""The sharded paths (``mesh_to_sdf_tpu_torch.parallel``) on several cards,
one process per card, NCCL:

    torchrun --nproc-per-node 4 scripts/sharded_torchrun.py

Every rank runs, on ``icosphere(5)``:

1. ``generate_grid_sdf_sharded_cpt`` at 256³ over [-1.1, 1.1]³ on cells =
   world (RAYCAST, 2 halo rounds): cold and warm times; rank 0 holds the
   field to the in-core CPT route on its card (signs equal and ≤ 2 % apart
   beyond 2 cells) and to the analytic sphere;
2. ``generate_sdf_sharded`` at 1M queries (``default_rng(0)``, [-1.3,
   1.3]³) on cells = world / 2 × tris = 2, both signs: rank 0 holds it
   bit-equal to ``generate_sdf(..., Strategy.PALLAS)`` on its card;
3. ``parallel.scaling.measure_weak_scaling`` at 1, 2, ... world ranks.

Rank 0 prints the card's name and power limit, the results, and a last
line of JSON. Any failed check raises, so the run exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch.ops.kernels import _build
    from mesh_to_sdf_tpu_torch.parallel import grid_sharded, scaling
    from mesh_to_sdf_tpu_torch.parallel import mesh as pmesh
    from mesh_to_sdf_tpu_torch.parallel import sharding
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

    pmesh.initialize_distributed()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    if rank == 0:
        _build.build()  # the other ranks wait on the build's file lock
    dist.barrier()
    out = {"world": world, "backend": dist.get_backend(),
           "device": torch.cuda.get_device_name(dev)}
    if rank == 0:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        print("\n".join(out["card"]), flush=True)

    verts, faces = icosphere(5)
    grid = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [256] * 3)
    mesh = pmesh.make_sdf_mesh(world, 1)

    def grid_call():
        dist.barrier()
        t0 = time.perf_counter()
        r = grid_sharded.generate_grid_sdf_sharded_cpt(verts, faces, grid,
                                                       mesh)
        torch.cuda.synchronize(dev)
        return r, time.perf_counter() - t0

    field, out["grid_cold_s"] = grid_call()
    out["grid_warm_s"] = [grid_call()[1] for _ in range(3)]
    if rank == 0:
        topo = tm.Topology.triangle_list(faces.reshape(-1))
        ref = tm.generate_grid_sdf(torch.from_numpy(verts).to(dev), topo,
                                   grid, tm.SignMethod.RAYCAST,
                                   strategy=tm.Strategy.CPT)
        r = grid.all_cell_centers(dev).reshape(-1, 3).norm(dim=-1)
        far = (r - 1.0).abs() > 2 * float(grid.cell_size[0])
        out["grid_signs_equal"] = bool(torch.equal((field < 0)[far],
                                                   (ref < 0)[far]))
        out["grid_max_rel"] = float(
            ((field.abs() - ref.abs()).abs() / ref.abs())[far].max())
        out["grid_sphere_err"] = float((field - (r - 1.0)).abs().max())
        if (not out["grid_signs_equal"] or out["grid_max_rel"] > 0.02
                or out["grid_sphere_err"] >= 0.05):
            raise AssertionError(f"sharded grid breaks the contract: {out}")
    del field

    q = np.random.default_rng(0).uniform(-1.3, 1.3, (1_000_000, 3)).astype(
        np.float32)
    mesh22 = pmesh.make_sdf_mesh(world // 2, 2)
    for sign in tm.SignMethod:
        times = []
        for _ in range(4):
            dist.barrier()
            t0 = time.perf_counter()
            got = sharding.generate_sdf_sharded(verts, faces.astype(np.int32),
                                                q, mesh22, sign)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        out[f"queries_{sign.value}_s"] = times
        if rank == 0:
            want = tm.generate_sdf(verts, tm.Topology.triangle_list(
                faces.reshape(-1)), q, tm.Strategy.PALLAS, sign_method=sign,
                device=dev)
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            out[f"queries_{sign.value}_bit_equal"] = same
            if not same:
                raise AssertionError(f"sharded {sign.value} != PALLAS")

    report = scaling.measure_weak_scaling(device=dev)
    if rank == 0:
        out["grid_warm_median_s"] = statistics.median(out["grid_warm_s"])
        out["weak_scaling"] = report
        print(scaling.format_report(report), flush=True)
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
