"""Weak-scaling efficiency harness (PyTorch counterpart of
``parallel/scaling.py``).

Grows the grid's x axis with the rank count so every rank owns a constant
slab of cells, and times the x-slab-sharded CPT pipeline
(:func:`parallel.grid_sharded.generate_grid_sdf_sharded_cpt`: binned seeds,
slab-local sweeps, the halo exchange, slab-local parity) on meshes of the
first n ranks of the world, so the measured overhead is the collectives'.

The numbers predict nothing on the CPU, or where several ranks share one
card (they share its SMs and memory, and gloo stages every collective
through the host): such reports carry ``non_predictive: true``. With one
card per rank (torchrun, NCCL) the same call gives the real number
(``scripts/sharded_torchrun.py`` prints it).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..grid import Grid
from ..types import SignMethod
from . import mesh as pmesh
from .grid_sharded import generate_grid_sdf_sharded_cpt
from .sharding import _rank_device

__all__ = ["measure_weak_scaling", "format_report"]


def _pow2_counts(n: int) -> list[int]:
    out, c = [], 1
    while c <= n:
        out.append(c)
        c *= 2
    if out[-1] != n:
        out.append(n)
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_weak_scaling(
    *,
    base_nx: int = 64,
    ny: int = 128,
    nz: int = 128,
    subdiv: int = 3,
    repeats: int = 3,
    device_counts: Optional[Sequence[int]] = None,
    sign_method: SignMethod = SignMethod.RAYCAST,
    device=None,
) -> dict:
    """Time the sharded grid pipeline at ``nx = base_nx × n`` for growing
    rank counts ``n`` (constant ``base_nx·ny·nz`` cells per rank). Every
    rank of the world calls it; the ranks outside a mesh wait. Rank 0's
    times (host clock, each call ending in a synchronize) are the report's,
    returned on every rank::

        {"platform": "cuda", "non_predictive": False,
         "cells_per_device": 1048576, "tris": ...,
         "sign_method": "raycast", "repeats": 3,
         "rows": [{"devices": n, "nx": nx, "median_ms": ..., "min_ms": ...,
                   "cells_per_s_per_device": ..., "efficiency_pct": ...}]}

    ``efficiency_pct`` = t(1)/t(n)·100 (weak scaling: ideal is flat time).
    """
    from ..utils.meshgen import icosphere

    device = _rank_device(device)
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = _pow2_counts(world)
    device_counts = [n for n in device_counts if n <= world]
    shared = (device.type == "cuda"
              and world > torch.cuda.device_count())

    verts, faces = icosphere(subdiv=subdiv)
    rows = []
    t1 = None
    for n in device_counts:
        dmesh = pmesh.make_sdf_mesh(cells=n, tris=1, ranks=range(n),
                                    device_type=device.type)
        nx = base_nx * n
        grid = Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [nx, ny, nz])
        times = []
        if dist.get_rank() < n:
            for rep in range(repeats + 1):  # the first call warms the prep
                dist.barrier(dmesh.get_group(pmesh.CELL_AXIS))
                t0 = time.perf_counter()
                generate_grid_sdf_sharded_cpt(verts, faces, grid, dmesh,
                                              sign_method, device=device)
                _sync(device)
                if rep:
                    times.append(time.perf_counter() - t0)
        dist.barrier()
        if dist.get_rank() != 0:
            continue
        med = float(np.median(times))
        if t1 is None:
            t1 = med
        rows.append({
            "devices": n,
            "nx": nx,
            "median_ms": round(med * 1e3, 2),
            "min_ms": round(min(times) * 1e3, 2),
            "cells_per_s_per_device": round(base_nx * ny * nz / med, 1),
            "efficiency_pct": round(100.0 * t1 / med, 1),
        })

    box = [rows]
    dist.broadcast_object_list(box, src=0)
    return {
        "platform": device.type,
        # On the CPU, or with ranks sharing a card, the numbers exercise the
        # collectives but do not predict one card per rank.
        "non_predictive": device.type != "cuda" or shared,
        "cells_per_device": base_nx * ny * nz,
        "tris": int(len(faces)),
        "sign_method": sign_method.value,
        "repeats": repeats,
        "rows": box[0],
    }


def format_report(report: dict) -> str:
    """One human line per rank count."""
    tag = (" (plumbing only — CPU or ranks sharing a card)"
           if report["non_predictive"] else "")
    lines = [
        f"weak scaling on {report['platform']}{tag}: "
        f"{report['cells_per_device']} cells/device, "
        f"{report['tris']} tris, sign={report['sign_method']}"
    ]
    for r in report["rows"]:
        lines.append(
            f"  {r['devices']:>3} dev  nx={r['nx']:>5}  "
            f"{r['median_ms']:>9.2f} ms/shard-step  "
            f"{r['cells_per_s_per_device']:>12.0f} cells/s/dev  "
            f"eff {r['efficiency_pct']:>5.1f}%"
        )
    return "\n".join(lines)
