"""Command-line interface: generate / render / info / bench.

PyTorch counterpart of the JAX package's ``cli.py``, with its commands,
arguments, messages and JSON keys (the reference client's TODO for a CLI,
`README.md:173`): load a glTF scene (`ui.rs:66-99` → `sdf_program.rs:
597-677`), generate a grid SDF, save it (serde), render it offline. Every
command runs on CUDA unless ``--device`` names another device; without a
card it stops with an error.

Usage:
    python -m mesh_to_sdf_tpu_torch generate model.glb --cells 64 --sign raycast -o out.sdf
    python -m mesh_to_sdf_tpu_torch render out.sdf -o out.png [--mode trilinear]
    python -m mesh_to_sdf_tpu_torch render model.glb --cells 64 -o out.png
    python -m mesh_to_sdf_tpu_torch info out.sdf
    python -m mesh_to_sdf_tpu_torch bench --cells 128 --tris 20480
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_grid(vmin, vmax, cells: int, extent_scale: float):
    """Grid from a mesh bbox, scaled about its center — the client's bbox
    extent slider (`sdf_program.rs:679-722`, scale ∈ [1, 3])."""
    from .grid import Grid

    center = (vmin + vmax) * 0.5
    half = (vmax - vmin) * 0.5 * extent_scale
    return Grid.from_bounding_box(center - half, center + half, [cells] * 3)


def _load_mesh_arg(path):
    from .io import gltf

    try:
        verts, faces = gltf.load_mesh(path)
    except gltf.GltfError as e:
        # The reference surfaces load failures as UI alerts (`ui.rs:76-97`);
        # the CLI analog is a clean error exit.
        raise SystemExit(f"error: {e}") from e
    if len(faces) == 0:
        raise SystemExit(f"error: {path} contains no triangles")
    return verts, faces


def _device(args):
    """The device a command runs on: ``--device``, else CUDA (an error
    exit on a host without a card)."""
    from .query import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from e


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _init_distributed(args, device) -> int:
    """Join the process group (``--coordinator`` as the init method with
    ``--num-processes`` / ``--process-id``, else torchrun's environment,
    else a world of 1) and return its size."""
    import torch.distributed as dist

    from .parallel.mesh import initialize_distributed

    init = args.coordinator
    if init is not None and "://" not in init:
        init = f"tcp://{init}"
    initialize_distributed(init, args.num_processes, args.process_id,
                           device_type=device.type)
    return dist.get_world_size()


def cmd_generate(args) -> int:
    import torch.distributed as dist

    from . import SignMethod, Topology, generate_grid_sdf
    from .io import serde
    from .utils.profiling import PhaseTimer

    device = _device(args)
    n_dev = 1
    if args.distributed or args.devices > 1:
        # Multi-process wiring: every process runs the same command, one
        # rank each. Launch recipe (2 hosts):
        #   host0: generate in.glb -o out.bin --devices 2 --distributed \
        #            --coordinator host0:1234 --num-processes 2 --process-id 0
        #   host1: same with --process-id 1
        # (or torchrun, whose environment names the ranks).
        n_dev = _init_distributed(args, device)
        if args.devices > 1 and n_dev != args.devices:
            raise SystemExit(f"error: --devices {args.devices} but the "
                             f"process group has {n_dev} ranks")

    verts, faces = _load_mesh_arg(args.input)
    sign = SignMethod(args.sign)
    grid = _build_grid(
        verts.min(axis=0), verts.max(axis=0), args.cells, args.extent_scale
    )
    topo = Topology.triangle_list(faces.reshape(-1))

    timer = PhaseTimer()
    with timer.phase("generate"):
        if n_dev > 1:
            from .parallel.grid_sharded import generate_grid_sdf_sharded_cpt
            from .parallel.mesh import make_sdf_mesh

            mesh = make_sdf_mesh(cells=n_dev, device_type=device.type)
            dist_t = generate_grid_sdf_sharded_cpt(
                verts, faces, grid, mesh, sign,
                device=None if device.type == "cuda" else device,
            )
        else:
            dist_t = generate_grid_sdf(verts, topo, grid, sign,
                                       exact=args.exact, device=device)
        dist_np = dist_t.cpu().numpy()
    n = grid.total_cell_count
    secs = timer.times["generate"]
    if n_dev > 1 and dist.get_rank() != 0:
        return 0  # rank 0 reports and writes the file
    print(
        f"generated {args.cells}^3 grid ({n} cells, {len(faces)} tris, "
        f"{sign.value}{', exact' if args.exact else ''}"
        f"{f', {n_dev} devices' if n_dev > 1 else ''}) in {secs:.3f}s — "
        f"{n / secs:,.0f} cells/s",
        file=sys.stderr,
    )
    serde.save_to_file(
        args.output, serde.GridSdf(grid=grid, distances=dist_np),
        format=args.format,
    )
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def cmd_render(args) -> int:
    import torch

    from . import SignMethod, Topology, generate_grid_sdf
    from .io import serde
    from .render import Camera, RaymarchMode, render, save_png

    device = _device(args)
    view = getattr(args, "view", "sdf")
    material = None
    if view not in ("sdf", "voxels") and not args.input.endswith(
        (".glb", ".gltf")
    ):
        raise SystemExit(
            f"error: --view {view} renders the source mesh and needs a "
            ".glb/.gltf input, not a baked SDF"
        )
    if args.input.endswith((".glb", ".gltf")):
        if args.material:
            from .io import gltf as gltf_mod
            from .render import generate_cubemap

            try:
                scene = gltf_mod.load_scene(args.input, with_materials=True)
            except gltf_mod.GltfError as e:
                raise SystemExit(f"error: {e}") from e
            verts, faces = scene.merge()
            if len(faces) == 0:
                raise SystemExit(f"error: {args.input} contains no triangles")
            material = generate_cubemap(verts, faces, scene.merge_colors(),
                                        device=device)
        else:
            verts, faces = _load_mesh_arg(args.input)
        grid = _build_grid(
            verts.min(axis=0), verts.max(axis=0), args.cells, args.extent_scale
        )
        dist = generate_grid_sdf(
            verts,
            Topology.triangle_list(faces.reshape(-1)),
            grid,
            SignMethod(args.sign),
            flat=False,
            device=device,
        )
    else:
        if args.material:
            raise SystemExit(
                "error: --material needs a mesh input (.glb/.gltf), not a "
                "baked SDF"
            )
        sdf = serde.read_from_file(args.input)
        if not isinstance(sdf, serde.GridSdf):
            raise SystemExit("error: render needs a grid SDF (kind=grid)")
        grid = sdf.grid
        dist = torch.from_numpy(np.ascontiguousarray(
            sdf.distances, np.float32)).to(device).reshape(grid.cell_count)

    cam = Camera.orbit(
        grid,
        azimuth_deg=args.azimuth,
        elevation_deg=args.elevation,
        width=args.width,
        height=args.height,
    )
    if view == "model":
        # ≙ RenderMode::Model (`model_render_pass.rs:22-84`).
        from .render import render_model

        img = render_model(verts, faces, cam, shadows=not args.no_shadows,
                           device=device)
    elif view == "model+sdf":
        # ≙ RenderMode::ModelAndSdf (`sdf_program.rs:38-45`).
        from .render import render_model_and_sdf

        img = render_model_and_sdf(
            verts, faces, dist, grid, cam, iso=args.iso,
            mode=RaymarchMode(args.mode), shadows=not args.no_shadows,
            device=device,
        )
    elif view == "voxels":
        # ≙ RenderMode::Voxels (`draw_voxels.wgsl`, instanced iso-band
        # cubes) — exact DDA cube-cast, works on baked SDFs too.
        from .render import render_voxels

        img = render_voxels(
            dist, grid, cam, iso=args.iso,
            shadows=not args.no_shadows, material=material, device=device,
        )
    else:
        img = render(
            dist, grid, cam, iso=args.iso, mode=RaymarchMode(args.mode),
            shadows=not args.no_shadows, material=material, device=device,
        )
    save_png(args.output, img)
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    from .io import serde
    from .render import iso_limits

    if args.input.endswith((".glb", ".gltf")):
        verts, faces = _load_mesh_arg(args.input)
        print(
            json.dumps(
                {
                    "kind": "mesh",
                    "vertices": int(len(verts)),
                    "triangles": int(len(faces)),
                    "bbox_min": verts.min(axis=0).tolist(),
                    "bbox_max": verts.max(axis=0).tolist(),
                }
            )
        )
        return 0
    sdf = serde.read_from_file(args.input)
    if isinstance(sdf, serde.GridSdf):
        lo, hi = iso_limits(sdf.distances)
        g = sdf.grid
        print(
            json.dumps(
                {
                    "kind": "grid",
                    "cell_count": list(g.cell_count),
                    "first_cell": g.first_cell.tolist(),
                    "cell_size": g.cell_size.tolist(),
                    "iso_limits": [float(lo), float(hi)],
                    "inside_fraction": float((sdf.distances < 0).mean()),
                }
            )
        )
    else:
        print(
            json.dumps(
                {
                    "kind": "generic",
                    "points": int(len(sdf.distances)),
                    "iso_limits": [
                        float(sdf.distances.min()),
                        float(sdf.distances.max()),
                    ],
                }
            )
        )
    return 0


def cmd_bench(args) -> int:
    from . import Grid, SignMethod, Topology, generate_grid_sdf, generate_sdf
    from .utils.meshgen import icosphere

    device = _device(args)
    if args.scaling:
        # Weak-scaling efficiency across the ranks of the process group
        # (BASELINE north star: ≥80% at 1→N); one process per rank.
        _init_distributed(args, device)
        from .parallel.scaling import format_report, measure_weak_scaling

        report = measure_weak_scaling(
            base_nx=args.cells // 2,
            ny=args.cells, nz=args.cells,
            sign_method=SignMethod(args.sign),
            repeats=args.repeats,
            device=None if device.type == "cuda" else device,
        )
        print(format_report(report))
        print(json.dumps({"metric": "weak_scaling", **report}))
        return 0

    subdiv = max(1, int(np.ceil(np.log(max(args.tris, 20) / 20) / np.log(4))))
    verts, faces = icosphere(subdiv=subdiv)
    topo = Topology.triangle_list(faces.reshape(-1))
    sign = SignMethod(args.sign)

    if args.mode == "query":
        # Scattered-query throughput (BASELINE config 4; reference criterion
        # `benches/generate_sdf.rs`).
        rng = np.random.default_rng(0)
        q = rng.uniform(-1.2, 1.2, (args.queries, 3)).astype(np.float32)

        def run():
            generate_sdf(verts, topo, q, sign_method=sign, device=device)
            _sync(device)

        label = f"queries_per_s_{args.queries}q_{len(faces)}t_{sign.value}"
        n = args.queries
    else:
        grid = Grid.from_bounding_box([-1.1] * 3, [1.1] * 3, [args.cells] * 3)

        def run():
            generate_grid_sdf(verts, topo, grid, sign, device=device)
            _sync(device)

        label = f"grid_cells_per_s_{args.cells}^3_{sign.value}"
        n = grid.total_cell_count

    run()
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(
        json.dumps(
            {
                "metric": label,
                "value": round(n / best, 1),
                "unit": "queries/s" if args.mode == "query" else "cells/s",
                "tris": int(len(faces)),
                "seconds": round(best, 4),
            }
        )
    )
    return 0


def _device_arg(p) -> None:
    p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: cuda; an error without one)",
    )


def _distributed_args(p, what: str) -> None:
    p.add_argument(
        "--distributed", action="store_true",
        help=f"join a torch.distributed process group {what} (see "
             "--coordinator / --num-processes / --process-id, else "
             "torchrun's environment)",
    )
    p.add_argument("--coordinator", default=None,
                   help="rank 0's address host:port (or an init_method URL)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def main(argv=None) -> int:
    from .render.sampler import RaymarchMode

    p = argparse.ArgumentParser(
        prog="mesh_to_sdf_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="mesh → grid SDF file")
    g.add_argument("input")
    g.add_argument("-o", "--output", required=True)
    g.add_argument("--cells", type=int, default=64, help="grid resolution per axis")
    g.add_argument("--sign", choices=["raycast", "normal"], default="raycast")
    g.add_argument(
        "--extent-scale", type=float, default=1.1,
        help="bbox scale around the mesh (client slider range 1..3)",
    )
    g.add_argument(
        "--exact", action="store_true",
        help="guarantee grid == brute-at-centers (replaces the approximate "
             "CPT route with the exact tile-culled engine)",
    )
    g.add_argument(
        "--format", choices=["native", "reference"], default="native",
        help="output container: this framework's zero-copy format, or the "
             "Rust crate's rmp-serde V1 for interchange",
    )
    g.add_argument(
        "--devices", type=int, default=1,
        help="shard the grid across N ranks, one process each (x-slab CPT "
             "pipeline); the process group must have N ranks",
    )
    _distributed_args(g, "for multi-process runs")
    _device_arg(g)
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("render", help="SDF file or mesh → PNG")
    r.add_argument("input")
    r.add_argument("-o", "--output", required=True)
    r.add_argument("--cells", type=int, default=64)
    r.add_argument("--sign", choices=["raycast", "normal"], default="raycast")
    r.add_argument("--extent-scale", type=float, default=1.1)
    r.add_argument(
        "--mode", choices=[m.value for m in RaymarchMode],
        default="trilinear",
    )
    r.add_argument("--iso", type=float, default=0.0)
    r.add_argument("--width", type=int, default=512)
    r.add_argument("--height", type=int, default=512)
    r.add_argument("--azimuth", type=float, default=30.0)
    r.add_argument("--elevation", type=float, default=25.0)
    r.add_argument("--no-shadows", action="store_true")
    r.add_argument(
        "--material", action="store_true",
        help="project the mesh's glTF base-color materials onto the SDF via "
             "a 6-face cubemap (mesh inputs only)",
    )
    r.add_argument(
        "--view", choices=["sdf", "voxels", "model", "model+sdf"],
        default="sdf",
        help="what to draw (RenderMode, `sdf_program.rs:38-45`): the "
             "raymarched SDF, the source mesh (Blinn-Phong + shadows), or "
             "both composited by depth (mesh inputs only for model views)",
    )
    _device_arg(r)
    r.set_defaults(fn=cmd_render)

    i = sub.add_parser("info", help="describe a mesh or SDF file")
    i.add_argument("input")
    i.set_defaults(fn=cmd_info)

    b = sub.add_parser("bench", help="grid/query throughput")
    b.add_argument("--mode", choices=["grid", "query"], default="grid")
    b.add_argument("--cells", type=int, default=128)
    b.add_argument("--queries", type=int, default=1_000_000)
    b.add_argument("--tris", type=int, default=20480)
    b.add_argument("--sign", choices=["raycast", "normal"], default="raycast")
    b.add_argument("--repeats", type=int, default=3)
    b.add_argument(
        "--scaling", action="store_true",
        help="measure weak-scaling efficiency across the ranks of the "
             "process group (grid nx grows with the rank count; ≥80%% is "
             "the north star)",
    )
    _distributed_args(b, "before the scaling sweep")
    _device_arg(b)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
