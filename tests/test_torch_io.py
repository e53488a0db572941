"""The port's host surface (``io.serde``, ``io.gltf``, ``native``,
``utils.baseline``) against the JAX package's, on procedural meshes.

Tolerances: containers and native outputs byte for byte; decoded arrays
exactly; the baseline's checksums as tests/test_native_baseline.py holds
them (rtol=1e-4 for queries, 2e-2 for grids, whose propagation differs in
the far field).
"""
import json
import struct

import numpy as np
import pytest
import torch

from mesh_to_sdf_tpu import Grid as JGrid
from mesh_to_sdf_tpu import native as jnative
from mesh_to_sdf_tpu.io import gltf as jgltf
from mesh_to_sdf_tpu.io import serde as jserde
import mesh_to_sdf_tpu_torch as tm
from mesh_to_sdf_tpu_torch import native
from mesh_to_sdf_tpu_torch.io import gltf, serde
from mesh_to_sdf_tpu_torch.utils import baseline
from mesh_to_sdf_tpu_torch.utils.meshgen import icosphere, torus

GOLDEN_DIR = __file__.rsplit("/", 1)[0] + "/golden"
LO, HI, COUNT = [-1, -1, -1], [1, 1, 1], [3, 4, 5]


def _grid_sdfs(kind):
    """(port SDF, JAX SDF) of the same data; the port's payload as numpy
    arrays or as torch tensors (a tensor that requires grad, as a fit's
    output does)."""
    rng = np.random.default_rng(11)
    d = np.linspace(-1, 1, 60).astype(np.float32)
    q = rng.uniform(-1, 1, (17, 3)).astype(np.float32)
    dq = rng.standard_normal(17).astype(np.float32)
    jg = JGrid.from_bounding_box(LO, HI, COUNT)
    tg = tm.Grid.from_bounding_box(LO, HI, COUNT)
    wrap = ((lambda a: torch.from_numpy(a).requires_grad_(True))
            if kind == "torch" else (lambda a: a))
    return {
        "grid": (serde.GridSdf(grid=tg, distances=wrap(d)),
                 jserde.GridSdf(grid=jg, distances=d)),
        "generic": (serde.GenericSdf(query_points=wrap(q),
                                     distances=wrap(dq)),
                    jserde.GenericSdf(query_points=q, distances=dq)),
    }


@pytest.mark.parametrize("fmt", ["native", "reference"])
@pytest.mark.parametrize("payload", ["grid", "generic"])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_serde_bytes_equal_jax(kind, payload, fmt, tmp_path):
    port, jax_sdf = _grid_sdfs(kind)[payload]
    dump = serde.dumps if fmt == "native" else serde.dumps_reference
    jdump = jserde.dumps if fmt == "native" else jserde.dumps_reference
    assert dump(port) == jdump(jax_sdf)
    path = tmp_path / "sdf.bin"
    serde.save_to_file(path, port, format=fmt)
    back = jserde.read_from_file(path)  # the JAX package reads the port's
    assert type(back).__name__ == type(jax_sdf).__name__
    np.testing.assert_array_equal(back.distances, jax_sdf.distances)


def test_serde_accepts_tensors_on_any_device_and_roundtrips():
    port, _ = _grid_sdfs("torch")["grid"]
    back = serde.loads(serde.dumps(port))
    assert isinstance(back, serde.GridSdf)
    assert back.grid.cell_count == (3, 4, 5)
    np.testing.assert_array_equal(back.distances,
                                  port.distances.detach().numpy())
    assert isinstance(back.grid, tm.Grid)
    torch.testing.assert_close(back.grid.first_cell, port.grid.first_cell)


@pytest.mark.parametrize("name", ["sdf_grid_v1.bin", "sdf_generic_v1.bin"])
def test_golden_files(name):
    back = serde.read_from_file(f"{GOLDEN_DIR}/{name}")
    want = jserde.read_from_file(f"{GOLDEN_DIR}/{name}")
    assert type(back).__name__ == type(want).__name__
    np.testing.assert_array_equal(back.distances, want.distances)
    if isinstance(back, serde.GridSdf):
        assert back.grid.cell_count == want.grid.cell_count == (3, 4, 5)
        np.testing.assert_array_equal(back.grid.first_cell.numpy(),
                                      np.asarray(want.grid.first_cell))
        np.testing.assert_array_equal(back.grid.cell_size.numpy(),
                                      np.asarray(want.grid.cell_size))
        np.testing.assert_allclose(back.distances,
                                   np.linspace(-1, 1, 60).astype(np.float32))
    else:
        np.testing.assert_array_equal(back.query_points, want.query_points)
        assert back.query_points.shape == (17, 3)


def test_serde_errors():
    """tests/test_serde.py's error cases on the port."""
    import msgpack

    with pytest.raises(serde.SerdeError):
        serde.loads(b"\x81\xa5magic\xa3bad")
    buf = msgpack.packb({"magic": "mesh_to_sdf_tpu", "version": 99, "sdf": {}},
                        use_bin_type=True)
    with pytest.raises(serde.SerdeError, match="version"):
        serde.loads(buf)
    good = serde.dumps(_grid_sdfs("numpy")["grid"][0])
    with pytest.raises(serde.SerdeError):
        serde.loads(good[: len(good) // 2])
    g = tm.Grid.from_bounding_box(LO, HI, COUNT)
    with pytest.raises(serde.SerdeError):
        serde.dumps(serde.GridSdf(grid=g, distances=np.zeros(10, np.float32)))
    with pytest.raises(serde.SerdeError):
        serde.loads(msgpack.packb({"V1": {"Nope": []}}, use_bin_type=True))
    with pytest.raises(serde.SerdeError, match="format"):
        serde.save_to_file("/dev/null", serde.GridSdf(
            grid=g, distances=np.zeros(60, np.float32)), format="bogus")


# -------------------------------------------------------------- native
@pytest.fixture
def needs_native():
    if not native.available():
        pytest.skip("native library not built")


@pytest.mark.parametrize("payload", ["grid", "generic"])
def test_native_codec_equals_python_codec(needs_native, payload):
    sdf, _ = _grid_sdfs("numpy")[payload]
    if payload == "grid":
        nat = native.pack_grid_sdf(sdf.grid.first_cell.numpy(),
                                   sdf.grid.cell_size.numpy(),
                                   np.asarray(sdf.grid.cell_count, np.uint32),
                                   sdf.distances)
    else:
        nat = native.pack_generic_sdf(sdf.query_points, sdf.distances)
    assert nat == serde.dumps(sdf)


def test_native_version_and_morton_match_jax(needs_native):
    assert native.version() == jnative._load().m2s_version()
    pts = np.random.default_rng(12).uniform(-2, 3, (5000, 3)).astype(
        np.float32)
    perm = native.morton_argsort(pts)
    np.testing.assert_array_equal(perm, jnative.morton_argsort(pts))
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(np.sort(perm), np.arange(len(pts)))
    # The codes along the permutation never decrease (21 bits per axis).
    lo, hi = pts.min(0), pts.max(0)
    cells = np.clip((pts - lo) * np.float32(2097151.0) / (hi - lo), 0,
                    2097151).astype(np.uint64)
    codes = np.zeros(len(pts), np.uint64)
    for bit in range(21):
        for axis in range(3):
            codes |= ((cells[:, axis] >> np.uint64(bit)) & np.uint64(1)) << \
                np.uint64(3 * bit + axis)
    assert (np.diff(codes[perm].astype(np.float64)) >= 0).all()


def test_native_raises_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    for call in (lambda: native.version(), lambda: native.glb_chunks(b""),
                 lambda: native.morton_argsort(np.zeros((1, 3)))):
        with pytest.raises(RuntimeError, match="make -C native"):
            call()


# ---------------------------------------------------------------- glTF
def test_glb_roundtrip_matches_jax(tmp_path):
    v, f = icosphere(2)
    p = tmp_path / "ico.glb"
    gltf.save_glb(p, v, f)
    jp = tmp_path / "ico_jax.glb"
    jgltf.save_glb(jp, v, f)
    assert p.read_bytes() == jp.read_bytes()
    v2, f2 = gltf.load_mesh(p)
    np.testing.assert_allclose(v2, v, rtol=1e-6)
    np.testing.assert_array_equal(f2, f.astype(np.uint32))


def test_gltf_json_with_data_uri(tmp_path):
    import base64

    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    buf = v.tobytes() + idx.tobytes() + b"\x00\x00"
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 6}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    p = tmp_path / "tri.gltf"
    p.write_text(json.dumps(doc))
    verts, faces = gltf.load_mesh(p)
    np.testing.assert_allclose(verts, v)
    np.testing.assert_array_equal(faces, [[0, 1, 2]])


def test_node_transform_and_triangulation():
    node = {"translation": [1, 2, 3], "scale": [2, 2, 2]}
    p = gltf._node_matrix(node) @ np.array([1.0, 0.0, 0.0, 1.0])
    np.testing.assert_allclose(p[:3], [3, 2, 3])
    strip = gltf._triangulate(np.arange(5, dtype=np.uint32),
                              gltf.MODE_TRIANGLE_STRIP)
    np.testing.assert_array_equal(strip, [[0, 1, 2], [2, 1, 3], [2, 3, 4]])
    fan = gltf._triangulate(np.arange(5, dtype=np.uint32),
                            gltf.MODE_TRIANGLE_FAN)
    np.testing.assert_array_equal(fan, [[0, 1, 2], [0, 2, 3], [0, 3, 4]])


def test_scene_instances_merge(tmp_path):
    v, f = torus(1.0, 0.3, 16, 8)
    p = tmp_path / "torus.glb"
    gltf.save_glb(p, v, f)
    scene = gltf.load_scene(p)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [5.0, 0.0, 0.0]
    scene.instances = [(0, T)]
    verts, _ = scene.merge()
    np.testing.assert_allclose(verts.mean(axis=0)[0], 5.0, atol=1e-2)


def test_malformed_gltf_files(tmp_path):
    bad = tmp_path / "bad.glb"
    bad.write_bytes(b"glTF" + struct.pack("<II", 2, 999) + b"junkjunk")
    with pytest.raises(gltf.GltfError):
        gltf.load_scene(bad)
    with pytest.raises(gltf.GltfError):
        gltf.load_scene(tmp_path / "missing.glb")
    notjson = tmp_path / "x.gltf"
    notjson.write_bytes(b"\x00\x01\x02")
    with pytest.raises(gltf.GltfError):
        gltf.load_scene(notjson)
    oor = tmp_path / "oor.glb"
    gltf.save_glb(oor, np.zeros((3, 3), np.float32),
                  np.array([[0, 1, 9]], np.uint32))
    with pytest.raises(gltf.GltfError, match="out of range"):
        gltf.load_mesh(oor)


def test_native_glb_framing_matches_the_python_parser(needs_native,
                                                      tmp_path):
    v, f = icosphere(1)
    p = tmp_path / "ico.glb"
    gltf.save_glb(p, v, f)
    raw = p.read_bytes()
    js, bn = native.glb_chunks(raw)
    assert (js, bn) == jnative.glb_chunks(raw)
    assert (json.loads(js), bn) == gltf._parse_glb(raw)
    assert json.loads(js)["asset"]["version"] == "2.0"
    with pytest.raises(ValueError):
        native.glb_chunks(b"nope")


def test_native_accessor_decode(needs_native):
    data = np.random.default_rng(1).standard_normal((10, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        native.accessor_to_f32(data.tobytes(), 0, 0, 10, 3, 5126), data)
    padded = np.zeros((10, 4), np.float32)  # stride 16: 12 data + 4 pad
    padded[:, :3] = data
    np.testing.assert_array_equal(
        native.accessor_to_f32(padded.tobytes(), 0, 16, 10, 3, 5126), data)
    idx = np.arange(12, dtype=np.uint16)
    np.testing.assert_array_equal(
        native.accessor_to_u32(idx.tobytes(), 0, 0, 12, 5123),
        idx.astype(np.uint32))
    with pytest.raises(ValueError):
        native.accessor_to_f32(data.tobytes(), 0, 0, 11, 3, 5126)


# ----------------------------------------------------- measured baseline
@pytest.fixture
def baseline_sphere():
    if not baseline.available(build=True):
        pytest.skip("baseline binary unavailable")
    v, f = icosphere(3)
    return v, f, (v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])


def test_baseline_query_mode_matches_port(baseline_sphere):
    v, f, tris = baseline_sphere
    q = np.random.default_rng(13).uniform(-1.3, 1.3, (2000, 3)).astype(
        np.float32)
    out = baseline.run_query(*tris, q)
    want = tm.generate_sdf(v, tm.Topology.triangle_list(f.reshape(-1)), q,
                           tm.Strategy.XLA, sign_method=tm.SignMethod.RAYCAST,
                           device="cpu")
    assert out["queries"] == len(q) and out["queries_per_s"] > 0
    np.testing.assert_allclose(out["checksum"], float(want.sum()), rtol=1e-4,
                               atol=1e-3)


def test_baseline_grid_mode_matches_port(baseline_sphere):
    v, f, tris = baseline_sphere
    grid = tm.Grid.from_bounding_box([-1.3] * 3, [1.3] * 3, [24] * 3)
    out = baseline.run_grid(*tris, grid)
    want = tm.generate_grid_sdf(v, tm.Topology.triangle_list(f.reshape(-1)),
                                grid, tm.SignMethod.RAYCAST,
                                strategy=tm.Strategy.XLA, device="cpu")
    assert out["cells"] == grid.total_cell_count
    np.testing.assert_allclose(out["checksum"], float(want.sum()), rtol=2e-2,
                               atol=1e-2)
