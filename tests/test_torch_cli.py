"""The port's CLI (``mesh_to_sdf_tpu_torch.cli``, ``python -m
mesh_to_sdf_tpu_torch``) against the JAX package's, on the CPU
(``--device cpu``): the JAX tests/test_cli.py checks on the port, each also
held against the JAX CLI on the same GLB.

Tolerances: generated distances rtol=2e-4, atol=1e-5 with equal signs (the
packages' distance tolerance, tests/torch_port_helpers.py), the two-rank
``--devices 2`` file atol 3e-3 with equal signs; ``info`` JSON
equal; PNGs decoded: hit masks equal on ≥ 99.5 % of the pixels, within
2/255 where both hit.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from baselines import make_icosphere
from mesh_to_sdf_tpu import cli as jcli
from mesh_to_sdf_tpu.io import serde as jserde
from mesh_to_sdf_tpu_torch import cli
from mesh_to_sdf_tpu_torch.io import gltf, png, serde
from torch_port_helpers import ATOL, RTOL, assert_same_field

ROOT = Path(__file__).resolve().parent.parent
#: The sharded CPT grid's bound against the in-core field and JAX's sharded
#: entry point (tests/test_grid_sharded.py, tests/test_torch_grid_sharded.py).
SHARD_ATOL = 3e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker (see tests/test_torch_autodiff.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "ico.glb"
    v, f = make_icosphere(subdiv=2)
    gltf.save_glb(p, v, f)
    return p


def _run(args, device=True):
    return cli.main(args + (["--device", "cpu"] if device else []))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _same_png(path, jpath):
    got = png.decode(Path(path).read_bytes())
    want = png.decode(Path(jpath).read_bytes())
    assert got.shape == want.shape
    hg, hw = got.sum(-1) > 0, want.sum(-1) > 0
    assert (hg == hw).mean() >= 0.995
    diff = np.abs(got.astype(int) - want.astype(int))[hg & hw]
    assert diff.max(initial=0) <= 2
    return got


def test_generate_info_render(glb, tmp_path, capsys):
    sdf_path, jsdf_path = tmp_path / "out.sdf", tmp_path / "j.sdf"
    args = ["generate", str(glb), "--cells", "12", "--sign", "raycast"]
    assert _run(args + ["-o", str(sdf_path)]) == 0 and sdf_path.exists()
    assert jcli.main(args + ["-o", str(jsdf_path)]) == 0
    back = serde.read_from_file(sdf_path)
    assert isinstance(back, serde.GridSdf)
    assert back.grid.cell_count == (12, 12, 12)
    assert (back.distances < 0).any() and (back.distances > 0).any()
    assert_same_field(back.distances,
                      jserde.read_from_file(jsdf_path).distances)
    assert "generated 12^3 grid (1728 cells, 320 tris, raycast)" in (
        capsys.readouterr().err)

    for f in (sdf_path, jsdf_path):
        assert cli.main(["info", str(f)]) == 0
        info = _last_json(capsys)
        assert jcli.main(["info", str(f)]) == 0
        assert info == _last_json(capsys)
        assert info["kind"] == "grid"
        assert info["iso_limits"][0] < 0 < info["iso_limits"][1]

    out, jout = tmp_path / "out.png", tmp_path / "j.png"
    args = ["render", str(sdf_path), "--width", "48", "--height", "48",
            "--no-shadows"]
    assert _run(args + ["-o", str(out)]) == 0 and out.exists()
    assert jcli.main(args + ["-o", str(jout)]) == 0
    img = _same_png(out, jout)
    assert img.shape == (48, 48, 3) and img.sum() > 0


def test_info_mesh(glb, capsys):
    assert cli.main(["info", str(glb)]) == 0
    info = _last_json(capsys)
    assert info["kind"] == "mesh" and info["triangles"] == 320
    assert jcli.main(["info", str(glb)]) == 0
    assert info == _last_json(capsys)


def test_generate_normal_sign(glb, tmp_path):
    args = ["generate", str(glb), "--cells", "10", "--sign", "normal"]
    assert _run(args + ["-o", str(tmp_path / "n.sdf")]) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "j.sdf")]) == 0
    back = serde.read_from_file(tmp_path / "n.sdf")
    assert (back.distances < 0).any()
    assert_same_field(back.distances,
                      jserde.read_from_file(tmp_path / "j.sdf").distances)


def test_missing_file_errors():
    with pytest.raises(SystemExit):
        _run(["generate", "/nonexistent.glb", "-o", "/tmp/x.sdf"])


def test_no_cuda_is_an_error_not_a_fallback(glb, tmp_path):
    """Without ``--device`` the commands run on CUDA; a host without a card
    stops with an error instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for args in (["generate", str(glb), "-o", str(tmp_path / "x.sdf")],
                 ["bench", "--cells", "8", "--repeats", "1"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(args)
    assert not (tmp_path / "x.sdf").exists()


def test_splat_render():
    """The point-cloud view on a CLI-sized grid, equal to JAX's."""
    import mesh_to_sdf_tpu as jm
    from mesh_to_sdf_tpu.render import Camera as JCamera
    from mesh_to_sdf_tpu.render import render_sdf_points as jsplat
    from mesh_to_sdf_tpu_torch.render import Camera, render_sdf_points
    from torch_port_helpers import port_grid

    v, f = make_icosphere(subdiv=2)
    g = jm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [16] * 3)
    d = np.array(jm.generate_grid_sdf(
        v, jm.Topology.triangle_list(f.reshape(-1)), g, jm.SignMethod.RAYCAST))
    tg = port_grid(g)
    cam = Camera.orbit(tg, width=64, height=64)
    img = render_sdf_points(tg, torch.from_numpy(d), cam, point_size=2)
    assert img.shape == (64, 64, 3) and img.sum() > 0
    np.testing.assert_array_equal(img, jsplat(g, d, JCamera(**cam.__dict__),
                                              point_size=2))


def test_generate_exact_and_reference_format(glb, tmp_path):
    """--exact gives grid == brute-at-centers; --format reference writes a
    container the JAX package's rmp-serde reader reads back."""
    import mesh_to_sdf_tpu as m

    out, jout = tmp_path / "exact.bin", tmp_path / "jexact.bin"
    args = ["generate", str(glb), "--cells", "12", "--exact", "--format",
            "reference"]
    assert _run(args + ["-o", str(out)]) == 0
    assert jcli.main(args + ["-o", str(jout)]) == 0
    back = jserde.read_from_file(out)
    assert isinstance(back, jserde.GridSdf)
    assert back.grid.cell_count == (12, 12, 12)
    verts, faces = gltf.load_mesh(glb)
    want = np.asarray(m.generate_grid_sdf(
        verts, m.Topology.triangle_list(faces.reshape(-1)), back.grid,
        m.SignMethod.RAYCAST, strategy=m.Strategy.XLA))
    np.testing.assert_allclose(back.distances, want, rtol=RTOL, atol=ATOL)
    assert_same_field(back.distances, jserde.read_from_file(jout).distances)
    assert serde.read_from_file(out).grid.cell_count == (12, 12, 12)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_generate_distributed_args_accepted(glb, tmp_path):
    """--devices 2 with --coordinator: two processes (gloo on the CPU) run
    the x-slab sharded CPT pipeline; rank 0 writes the file, held to the
    JAX package's ``generate_grid_sdf_sharded_cpt`` on a 2-device mesh and
    to the port's in-core file at the sharded CPT contract's atol 3e-3 with
    equal signs (tests/test_torch_grid_sharded.py). The world's size must
    equal --devices."""
    import jax

    import mesh_to_sdf_tpu as jm
    from mesh_to_sdf_tpu.parallel import grid_sharded as jgsh
    from mesh_to_sdf_tpu.parallel import mesh as jmesh

    out = tmp_path / "dist.bin"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mesh_to_sdf_tpu_torch", "generate", str(glb),
         "-o", str(out), "--cells", "8", "--devices", "2", "--distributed",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(rank), "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err
    assert "2 devices" in results[0][1] and "wrote" in results[0][1]
    assert "wrote" not in results[1][1]  # rank 0 alone writes
    back = serde.read_from_file(out)
    assert back.distances.shape == (512,)
    single = tmp_path / "single.bin"
    assert _run(["generate", str(glb), "-o", str(single), "--cells", "8"]) == 0
    v, f = jcli._load_mesh_arg(str(glb))
    jgrid = jcli._build_grid(v.min(axis=0), v.max(axis=0), 8, 1.1)
    jax_want = np.asarray(jgsh.generate_grid_sdf_sharded_cpt(
        v, f, jgrid, jmesh.make_sdf_mesh(cells=2, devices=jax.devices()[:2]),
        jm.SignMethod.RAYCAST))
    for want in (jax_want, serde.read_from_file(single).distances):
        np.testing.assert_array_equal(np.signbit(back.distances),
                                      np.signbit(want))
        np.testing.assert_allclose(back.distances, want, atol=SHARD_ATOL)
    proc = subprocess.run(
        [sys.executable, "-m", "mesh_to_sdf_tpu_torch", "generate", str(glb),
         "-o", str(tmp_path / "x.bin"), "--cells", "8", "--devices", "2",
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "--devices 2 but the process group has 1 ranks" in proc.stderr


def _material_gltf(tmp_path):
    """icosphere(2) with a base-colour material and no texture."""
    import base64

    v, f = make_icosphere(subdiv=2)
    v = np.ascontiguousarray(v, np.float32)
    idx = np.ascontiguousarray(f.reshape(-1), np.uint32)
    blob = v.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode(),
                     "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": v.nbytes},
            {"buffer": 0, "byteOffset": v.nbytes, "byteLength": idx.nbytes}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(v),
             "type": "VEC3", "min": v.min(0).tolist(),
             "max": v.max(0).tolist()},
            {"bufferView": 1, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.3, 0.1, 1.0]}}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1, "material": 0}]}],
        "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}], "scene": 0,
    }
    p = tmp_path / "mat.gltf"
    p.write_text(json.dumps(doc))
    return p


def test_render_with_material_flag(tmp_path):
    """--material: a glTF with a base-colour material (no texture) →
    cubemap-textured render, as JAX's."""
    p = _material_gltf(tmp_path)
    out, jout = tmp_path / "mat.png", tmp_path / "jmat.png"
    args = ["render", str(p), "--cells", "12", "--material", "--width", "40",
            "--height", "40", "--no-shadows"]
    assert _run(args + ["-o", str(out)]) == 0
    assert jcli.main(args + ["-o", str(jout)]) == 0
    img = _same_png(out, jout)
    hit = img.sum(-1) > 0
    assert hit.any() and (img[hit][:, 0] > img[hit][:, 2]).all()
    with pytest.raises(SystemExit, match="needs a mesh input"):
        _run(["render", str(tmp_path / "x.sdf"), "-o", str(out),
              "--material"])


@pytest.mark.parametrize("view", [
    ["--mode", "snap"], ["--mode", "trilinear"], ["--mode", "tetrahedral"],
    ["--mode", "snap_stylized"], ["--view", "voxels"], ["--view", "model"],
    ["--view", "model+sdf"]], ids=lambda v: v[-1])
def test_render_views_match_jax(glb, tmp_path, view):
    """Every --mode and --view on a GLB, with shadows, against JAX's PNG."""
    out, jout = tmp_path / "v.png", tmp_path / "jv.png"
    args = ["render", str(glb), "--cells", "12", "--width", "32",
            "--height", "32", "--azimuth", "-20"] + view
    assert _run(args + ["-o", str(out)]) == 0
    if view[-1] == "model+sdf":
        _jax_model_and_sdf_png(glb, jout)
    else:
        assert jcli.main(args + ["-o", str(jout)]) == 0
    assert _same_png(out, jout).sum() > 0


def _jax_model_and_sdf_png(glb, path):
    """What the JAX CLI's ``render --view model+sdf`` computes, through the
    JAX API: the JAX CLI hands ``render_model_and_sdf`` a numpy grid, which
    its unjitted trace cannot index with traced cells (a fault of the JAX
    CLI that this test steps around; the port's CLI passes a tensor)."""
    import jax.numpy as jnp

    import mesh_to_sdf_tpu as jm
    from mesh_to_sdf_tpu.render import (Camera, render_model_and_sdf,
                                        save_png)

    verts, faces = gltf.load_mesh(glb)
    grid = jcli._build_grid(verts.min(axis=0), verts.max(axis=0), 12, 1.1)
    dist = jm.generate_grid_sdf(verts, jm.Topology.triangle_list(
        faces.reshape(-1)), grid, jm.SignMethod.RAYCAST, flat=False)
    cam = Camera.orbit(grid, azimuth_deg=-20.0, elevation_deg=25.0,
                       width=32, height=32)
    save_png(path, np.asarray(render_model_and_sdf(
        verts, faces, jnp.asarray(dist), grid, cam)))


def test_python_m_and_bench(glb, tmp_path):
    """``python -m mesh_to_sdf_tpu_torch`` runs the CLI; bench prints the
    JAX CLI's JSON keys and labels (grid, query, scaling)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")

    def run(*args):
        proc = subprocess.run([sys.executable, "-m", "mesh_to_sdf_tpu_torch",
                               *args], cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return json.loads(proc.stdout.strip().splitlines()[-1])

    assert run("info", str(glb))["triangles"] == 320
    grid = run("bench", "--cells", "8", "--tris", "80", "--repeats", "1",
               "--device", "cpu")
    assert grid["metric"] == "grid_cells_per_s_8^3_raycast"
    assert set(grid) == {"metric", "value", "unit", "tris", "seconds"}
    assert grid["unit"] == "cells/s" and grid["tris"] == 80
    query = run("bench", "--mode", "query", "--queries", "300", "--tris",
                "80", "--sign", "normal", "--repeats", "1", "--device", "cpu")
    assert query["metric"] == "queries_per_s_300q_80t_normal"
    assert query["unit"] == "queries/s" and query["value"] > 0
    scaling = run("bench", "--scaling", "--cells", "8", "--repeats", "1",
                  "--device", "cpu")
    assert scaling["metric"] == "weak_scaling"
    assert scaling["rows"][0]["devices"] == 1


def test_surface_imports_no_jax_and_no_pil(glb, tmp_path):
    """cli, render, utils.roofline, gridgen.calibrate_auto and __main__
    import with jax and PIL blocked, and the CLI's generate / render / info /
    bench paths run so."""
    code = f"""
import sys
for name in ("jax", "jaxlib", "PIL", "mesh_to_sdf_tpu"):
    sys.modules[name] = None
import runpy
import mesh_to_sdf_tpu_torch.render
import mesh_to_sdf_tpu_torch.utils.roofline
from mesh_to_sdf_tpu_torch import cli, gridgen
assert callable(gridgen.calibrate_auto)
glb, out = {str(glb)!r}, {str(tmp_path)!r}
for args in (["generate", glb, "--cells", "8", "-o", out + "/a.sdf"],
             ["render", out + "/a.sdf", "-o", out + "/a.png", "--width", "16",
              "--height", "16"],
             ["render", glb, "--view", "model+sdf", "--cells", "8", "-o",
              out + "/b.png", "--width", "16", "--height", "16"],
             ["bench", "--cells", "8", "--tris", "20", "--repeats", "1"]):
    assert cli.main(args + ["--device", "cpu"]) == 0
assert cli.main(["info", out + "/a.sdf"]) == 0
sys.argv = ["mesh_to_sdf_tpu_torch", "info", glb]
try:
    runpy.run_module("mesh_to_sdf_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "a.png").exists() and (tmp_path / "b.png").exists()


def test_demo_runs_on_cpu(tmp_path):
    """examples/demo_torch.py: the JAX demo's steps on the port, on the CPU
    at a small size."""
    out = tmp_path / "demo.png"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "demo_torch.py"), "--device",
         "cpu", "--cells", "16", "--fit-cells", "8", "--size", "32", "--out",
         str(out)], cwd=tmp_path, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "generate_grid_sdf: 16^3 cells" in proc.stdout
    assert "DifferentiableSDF: loss" in proc.stdout
    assert png.decode(out.read_bytes()).shape == (32, 32, 3)
