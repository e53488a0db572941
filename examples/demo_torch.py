"""Demo of the PyTorch/CUDA port — the steps of examples/demo.py (the
reference's `examples/demo.rs:5-64`) on ``mesh_to_sdf_tpu_torch``: load a
GLB, one `generate_sdf` over scattered query points, one
`generate_grid_sdf`, a rendered PNG, and two vertex-gradient steps.

Run: python examples/demo_torch.py [scene.glb] [--device cuda|cpu]
     [--cells 32] [--size 400] [--out demo_render.png]
"""
import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import mesh_to_sdf_tpu_torch as m2s  # noqa: E402
from mesh_to_sdf_tpu_torch.io import gltf  # noqa: E402
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cells", type=int, default=32)
    p.add_argument("--fit-cells", type=int, default=12)
    p.add_argument("--size", type=int, default=400)
    p.add_argument("--out", default="demo_render.png")
    args = p.parse_args(argv)
    device = args.device

    if args.scene:
        vertices, faces = gltf.load_mesh(args.scene)
        print(f"loaded {args.scene}: {len(vertices)} verts, {len(faces)} tris")
    else:
        vertices, faces = icosphere(subdiv=3)
        print(f"procedural icosphere: {len(vertices)} verts, {len(faces)} tris")

    topo = m2s.Topology.triangle_list(faces.reshape(-1))

    # generate_sdf over scattered query points (demo.rs:24-37).
    rng = np.random.default_rng(0)
    queries = rng.uniform(vertices.min(), vertices.max(), (1000, 3)).astype(
        np.float32
    )
    sdf = m2s.generate_sdf(vertices, topo, queries, device=device).cpu().numpy()
    print(
        f"generate_sdf: {len(queries)} points, "
        f"{int((sdf < 0).sum())} inside, range [{sdf.min():.3f}, {sdf.max():.3f}]"
    )

    # generate_grid_sdf (demo.rs:39-63).
    lo, hi = vertices.min(axis=0) - 0.2, vertices.max(axis=0) + 0.2
    n = args.cells
    grid = m2s.Grid.from_bounding_box(lo, hi, [n, n, n])
    dist = m2s.generate_grid_sdf(vertices, topo, grid, m2s.SignMethod.RAYCAST,
                                 flat=False, device=device)
    print(
        f"generate_grid_sdf: {n}^3 cells, inside fraction "
        f"{float((dist < 0).float().mean()):.3f}"
    )

    # Offline render. When a GLB with materials was given, project its base
    # colors onto the SDF via the 6-face cubemap (`cubemap.rs:160-311`).
    from mesh_to_sdf_tpu_torch.render import (
        Camera, RaymarchMode, generate_cubemap, render, save_png,
    )

    material = None
    if args.scene:
        scene = gltf.load_scene(args.scene, with_materials=True)
        sv, sf = scene.merge()
        material = generate_cubemap(sv, sf, scene.merge_colors(),
                                    device=device)
        print("cubemap material projected (6 × "
              f"{material.resolution}² faces)")
    cam = Camera.orbit(grid, width=args.size, height=args.size)
    img = render(dist, grid, cam, mode=RaymarchMode.TRILINEAR,
                 material=material)
    out = pathlib.Path(args.out)
    save_png(out, img)
    print(f"wrote {out}")

    # d(SDF)/d(vertices) — two fit steps toward a scaled target.
    import torch

    from mesh_to_sdf_tpu_torch.models.sdf_layer import (
        DifferentiableSDF, pad_tri_idx, sdf_grid,
    )

    k = args.fit_cells
    small = m2s.Grid.from_bounding_box(lo, hi, [k, k, k])
    tri_idx = torch.from_numpy(pad_tri_idx(faces.astype(np.int32), 128))
    v_target = torch.from_numpy(vertices * 1.05).to(device)
    target = sdf_grid(v_target, tri_idx.to(device), small,
                      m2s.SignMethod.NORMAL, block=128)
    model = DifferentiableSDF(faces.astype(np.int32), small,
                              m2s.SignMethod.NORMAL, block=128)
    state = model.init(vertices, device=device)
    state, loss0 = model.train_step(state, target)
    state, loss1 = model.train_step(state, target)
    print(f"DifferentiableSDF: loss {float(loss0):.6f} -> {float(loss1):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
