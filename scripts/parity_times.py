#!/usr/bin/env python3
"""Device times of the two line-parity kernels of the PyTorch/CUDA port.

    python3 scripts/parity_times.py [--root DIR] [--reps N] [--out FILE]

Imports ``mesh_to_sdf_tpu_torch`` from DIR (default: this checkout), so a
second checkout (an older commit unpacked with ``git archive``) can be timed
on the same card in the same command: run it as parent, change, change,
parent. Builds that checkout's kernels, then times ``--reps`` calls after
one warm-up of each of:

- ``line_parity_counts_binned`` on ``icosphere(5)`` (20 480 triangles) at
  128³ and 256³ over [-1.1, 1.1]³, each of the three axes (the CPT route's
  bins, as ``gridgen._cpt_prep`` builds them);
- ``line_parity_counts`` at 128³ and 256³, +x, on the same mesh;
- ``line_parity_counts`` at the CULLED sign grid's shape: 128 x 128 lines
  of ``culling.build_sign_grid``'s grid on ``icosphere(8)`` (1 310 720
  triangles), each of the three axes.

Each shape gets two times per call: CUDA events around back-to-back calls
(which count the host's gaps between launches where the calls are short)
and CUDA events around replays of one call captured in a CUDA graph (no
host gaps). Prints one line per shape and, last, one JSON object with
every time (ms), the root, and the card's name and power limit. Needs a
CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Device time of one call of ``fn`` in ms: the call captured once in a
    CUDA graph and replayed ``reps`` times between two CUDA events. Unlike
    events around back-to-back calls it leaves out the host's gaps between
    launches, which dominate calls of ~0.1 ms."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("parity_times: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import mesh_to_sdf_tpu_torch as tm
    from mesh_to_sdf_tpu_torch import gridgen
    from mesh_to_sdf_tpu_torch.ops.kernels import _build, parity
    from mesh_to_sdf_tpu_torch.ops.raycast import face_origins
    from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere

    if Path(tm.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {tm.__file__}, not from {root}")
    t0 = time.perf_counter()
    _build.lib()
    print(f"{card}; root {root}; kernel build "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    dev = torch.device("cuda")
    times, graph = {}, {}

    def timed(key, fn, reps):
        """Events around ``reps`` back-to-back calls (host gaps between
        launches included), and ``reps`` replays of one captured call."""
        times[key] = cuda_ms(fn, reps)
        graph[key] = graph_ms(fn, reps)
        print(f"  {key}: {times[key]:.4f} ms (events), {graph[key]:.4f} ms "
              f"(graph replay)", flush=True)

    def lines(grid, axis):
        origins, lshape = face_origins(grid, axis, dev)
        iy, iz = (axis + 1) % 3, (axis + 2) % 3
        return (origins[:, iy].contiguous(), origins[:, iz].contiguous(),
                lshape)

    verts, faces = icosphere(5)
    soup = tuple(torch.from_numpy(np.ascontiguousarray(verts[faces[:, k]]))
                 .to(dev) for k in range(3))
    for cells in (128, 256):
        grid = tm.Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [cells] * 3)
        v = verts[faces]
        _, _, line_bins = gridgen._cpt_prep(grid, v[:, 0], v[:, 1], v[:, 2],
                                            dev)
        for axis in range(3):
            oy, oz, lshape = lines(grid, axis)
            kw = dict(n_cells=cells, n1=lshape[0], n2=lshape[1])
            a = (oy, oz, grid.first_cell[axis], grid.cell_size[axis],
                 line_bins[axis])
            timed(f"binned {cells}^3 axis {axis}",
                  lambda a=a, kw=kw: parity.line_parity_counts_binned(*a, **kw),
                  args.reps)
        oy, oz, _ = lines(grid, 0)
        planes = parity.rotate_planes(*soup, 0)
        a = (oy, oz, grid.first_cell[0], grid.cell_size[0], planes)
        timed(f"dense {cells}^3 axis 0",
              lambda a=a, cells=cells: parity.line_parity_counts(
                  *a, n_cells=cells), args.reps)

    # CULLED's sign grid: culling.build_sign_grid at res 128 on icosphere(8).
    verts8, faces8 = icosphere(8)
    soup8 = tuple(torch.from_numpy(np.ascontiguousarray(verts8[faces8[:, k]]))
                  .to(dev) for k in range(3))
    v8 = verts8[faces8].reshape(-1, 3)
    lo, hi = v8.min(0), v8.max(0)
    pad = (hi - lo) * 0.02 + 1e-6
    grid = tm.Grid.from_bounding_box(lo - pad, hi + pad, [128] * 3)
    for axis in range(3):
        oy, oz, _ = lines(grid, axis)
        a = (oy, oz, grid.first_cell[axis], grid.cell_size[axis],
             parity.rotate_planes(*soup8, axis))
        timed(f"dense sign grid 128x128 x {len(faces8)} axis {axis}",
              lambda a=a: parity.line_parity_counts(*a, n_cells=128),
              max(1, args.reps // 2))
    out = {"root": str(root), "card": card, "ms": times, "graph_ms": graph}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
