"""The port's cubemap material projection (``render.cubemap``), glTF material
ingestion and PNG decoding, against the JAX package's, on the CPU: the JAX
tests/test_cubemap.py checks on the port, each also held against the JAX
function on the same inputs.

Tolerances: albedo and depth 1e-5 away from edge-aligned texels (texels
whose ray runs along a triangle edge, where the strict edge test may go
either way by an ulp; counted, at most 2 % of a face); sampled albedo 1e-5;
material colours exactly as the JAX loader's; decoded PNG pixels equal to
PIL's.
"""
import base64
import io as _io
import json
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh_to_sdf_tpu.io import gltf as jgltf
from mesh_to_sdf_tpu.render import cubemap as jcube
from mesh_to_sdf_tpu_torch.io import gltf, png
from mesh_to_sdf_tpu_torch.render.cubemap import (
    Cubemap, generate_cubemap, sample_cubemap,
)
from mesh_to_sdf_tpu_torch.utils.meshgen import box

RED = np.array([1.0, 0.0, 0.0], np.float32)
BLUE = np.array([0.0, 0.0, 1.0], np.float32)
#: Share of a face's texels that may differ from JAX (edge-aligned rays).
EDGE_TEXELS = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker (see tests/test_torch_autodiff.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def colored_box():
    """Unit box: +x-side vertices red, everything else blue."""
    v, f = box()
    colors = np.where((v[:, 0] > 0)[:, None], RED, BLUE).astype(np.float32)
    return v, f, colors


def _hold_cubemap(cm, jcm):
    """Albedo and depth within 1e-5 of JAX's except on a few edge-aligned
    texels; centre and half-extent equal."""
    assert cm.center == jcm.center and cm.half == jcm.half
    alb, jalb = cm.albedo.numpy(), np.asarray(jcm.albedo)
    dep, jdep = cm.depth.numpy(), np.asarray(jcm.depth)
    assert alb.shape == jalb.shape and dep.shape == jdep.shape
    same = (np.abs(alb - jalb).max(-1) <= 1e-5) & (
        (dep == jdep) | (np.abs(dep - jdep) <= 1e-5))
    assert (~same).mean(axis=(1, 2)).max() <= EDGE_TEXELS, (~same).sum()
    return same


def test_cubemap_faces_and_depth(colored_box):
    v, f, colors = colored_box
    cm = generate_cubemap(v, f, colors, res=32, device="cpu")
    assert isinstance(cm, Cubemap) and cm.resolution == 32
    assert cm.albedo.shape == (6, 32, 32, 3)
    px = (16, 8)  # off the quad diagonals (the shared-edge blind spot)
    np.testing.assert_allclose(cm.albedo[1][px].numpy(), RED, atol=1e-5)
    np.testing.assert_allclose(cm.albedo[0][px].numpy(), BLUE, atol=1e-5)
    hx = float(np.max(v[:, 0]))
    assert abs(float(cm.depth[1][px]) - hx) < 1e-4
    assert abs(float(cm.depth[0][px]) + hx) < 1e-4
    assert cm.albedo[1].mean(dim=(0, 1))[0] > 0.7
    assert cm.albedo[0].mean(dim=(0, 1))[2] > 0.7
    same = _hold_cubemap(cm, jcube.generate_cubemap(v, f, colors, res=32))
    assert same[:, px[0], px[1]].all()


def test_cubemap_random_mesh_matches_jax():
    """A random soup with random colours, at a resolution that is not a
    multiple of the texel chunk, both extents of every axis."""
    rng = np.random.default_rng(21)
    v = rng.uniform(-1.0, 1.0, (60, 3)).astype(np.float32)
    f = rng.integers(0, 60, (90, 3))
    col = rng.uniform(0.0, 1.0, (60, 3)).astype(np.float32)
    cm = generate_cubemap(v, f, col, res=70, device="cpu")
    _hold_cubemap(cm, jcube.generate_cubemap(v, f, col, res=70))


def test_sample_cubemap_visibility(colored_box):
    v, f, colors = colored_box
    cm = generate_cubemap(v, f, colors, res=32, device="cpu")
    jcm = jcube.generate_cubemap(v, f, colors, res=32)
    hx = float(np.max(v[:, 0]))
    pos = np.array([[hx, 0.2, -0.4], [-hx, 0.2, -0.4]], np.float32)
    nrm = np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], np.float32)
    out = sample_cubemap(cm, torch.from_numpy(pos), torch.from_numpy(nrm))
    np.testing.assert_allclose(out[0].numpy(), RED, atol=0.05)
    np.testing.assert_allclose(out[1].numpy(), BLUE, atol=0.05)
    inside = sample_cubemap(cm, torch.zeros((1, 3)), torch.zeros((1, 3)))
    np.testing.assert_allclose(inside[0].numpy(), [0.6, 0.6, 0.6], atol=1e-5)
    # Random points and normals, sampling the JAX cubemap's own faces so
    # only the sampler is compared.
    rng = np.random.default_rng(4)
    p = rng.uniform(-0.6, 0.6, (500, 3)).astype(np.float32)
    n = rng.standard_normal((500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    same_faces = Cubemap(albedo=torch.from_numpy(np.array(jcm.albedo)),
                         depth=torch.from_numpy(np.array(jcm.depth)),
                         center=jcm.center, half=jcm.half)
    got = sample_cubemap(same_faces, torch.from_numpy(p),
                         torch.from_numpy(n)).numpy()
    want = np.asarray(jcube.sample_cubemap(jcm, jnp.asarray(p),
                                           jnp.asarray(n)))
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# glTF material ingestion
# ---------------------------------------------------------------------------
def _pil_png(rgb, shape=(4, 4, 3), mode=None):
    from PIL import Image

    img = Image.fromarray(np.broadcast_to(np.asarray(rgb, np.uint8),
                                          shape).copy(), mode=mode)
    buf = _io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _gltf_with_material(tmp_path, base_color, image=None):
    """Minimal single-triangle .gltf with a material, optionally textured
    with the encoded ``image`` bytes."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75]], np.float32)
    idx = np.array([0, 1, 2], np.uint32)
    blob = pos.tobytes() + uv.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(blob).decode(),
            "byteLength": len(blob),
        }],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 24},
            {"buffer": 0, "byteOffset": 60, "byteLength": 12},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 3,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5125, "count": 3,
             "type": "SCALAR"},
        ],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorFactor": list(base_color)},
        }],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
            "indices": 2,
            "material": 0,
        }]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    if image is not None:
        doc["images"] = [{
            "uri": "data:image/png;base64," + base64.b64encode(image).decode(),
        }]
        doc["textures"] = [{"source": 0}]
        doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
            "index": 0
        }
    p = tmp_path / "mat.gltf"
    p.write_text(json.dumps(doc))
    return p


def test_material_base_color_factor(tmp_path):
    p = _gltf_with_material(tmp_path, [0.2, 0.4, 0.8, 1.0])
    colors = gltf.load_scene(p, with_materials=True).merge_colors()
    assert colors.shape == (3, 3)
    np.testing.assert_allclose(colors, [[0.2, 0.4, 0.8]] * 3, atol=1e-6)
    np.testing.assert_array_equal(
        colors, jgltf.load_scene(p, with_materials=True).merge_colors())


@pytest.mark.parametrize("kind", ["rgb", "rgba", "grey", "grey-alpha",
                                  "palette"])
def test_material_texture_sampling(tmp_path, monkeypatch, kind):
    """A PNG texture of each 8-bit colour type (as PIL writes them) gives
    the JAX loader's colours (which decode through PIL), with PIL blocked
    for the port: the port decodes PNG itself."""
    from PIL import Image

    rgb = np.array([200, 100, 50], np.uint8)
    if kind == "rgb":
        image = _pil_png(rgb)
    elif kind == "rgba":
        image = _pil_png([200, 100, 50, 128], (4, 4, 4))
    elif kind == "grey":
        image = _pil_png(150, (4, 4))
    elif kind == "grey-alpha":
        image = _pil_png([150, 40], (4, 4, 2), mode="LA")
    else:
        buf = _io.BytesIO()
        Image.fromarray(np.broadcast_to(rgb, (4, 4, 3)).copy()).convert(
            "P").save(buf, format="PNG")
        image = buf.getvalue()
    p = _gltf_with_material(tmp_path, [1.0, 1.0, 1.0, 1.0], image=image)
    want = jgltf.load_scene(p, with_materials=True).merge_colors()
    monkeypatch.setitem(sys.modules, "PIL", None)
    colors = gltf.load_scene(p, with_materials=True).merge_colors()
    np.testing.assert_array_equal(colors, want)
    if kind == "rgb":
        np.testing.assert_allclose(
            colors, [(np.array([200, 100, 50]) / 255.0) ** 2.2] * 3,
            rtol=1e-3)


def test_materials_off_by_default(tmp_path):
    p = _gltf_with_material(tmp_path, [0.2, 0.4, 0.8, 1.0])
    scene = gltf.load_scene(p)
    assert scene.meshes[0].colors is None
    np.testing.assert_allclose(scene.merge_colors(), [[0.6] * 3] * 3)


def _encode_filtered(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG whose rows cycle through all five filter types
    (PNG specification §9), for the decoder's test."""
    h, w, c = img.shape
    x = img.astype(np.int32)
    rows = []
    for y in range(h):
        kind = y % 5
        cur = x[y].reshape(-1)
        up = x[y - 1].reshape(-1) if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) >> 1
        else:
            pp = left + up - ul
            pa, pb, pc = np.abs(pp - left), np.abs(pp - up), np.abs(pp - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(k, d):
        return (struct.pack(">I", len(d)) + k + d
                + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def _with_header_byte(data: bytes, field: int, value: int) -> bytes:
    """``data`` with byte ``field`` of its IHDR set to ``value`` (8: bit
    depth, 12: interlace method), the chunk's CRC made good again."""
    head = bytearray(data[16:29])
    head[field] = value
    return (data[:16] + bytes(head)
            + struct.pack(">I", zlib.crc32(b"IHDR" + head) & 0xFFFFFFFF)
            + data[33:])


def test_png_decoder_matches_pil(monkeypatch):
    """Every filter type, and PIL's own adaptive filtering of noise, decode
    to PIL's pixels; the encoder's files round-trip; other PNGs and other
    formats raise, without PIL a GltfError that names the format."""
    from PIL import Image

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (23, 17, 3), dtype=np.uint8)
    img[:, :8] //= 16  # smooth columns, where Sub/Up/Paeth predict
    data = _encode_filtered(img)
    np.testing.assert_array_equal(png.decode(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(_io.BytesIO(data))),
                                  img)
    noisy = _pil_png(img, img.shape)
    np.testing.assert_array_equal(png.decode(noisy), img)
    np.testing.assert_array_equal(png.decode(png.encode_rgb8(img)), img)
    for field, value, message in ((12, 1, "interlace 1"),
                                  (8, 16, "bit depth 16")):
        with pytest.raises(png.PngError, match=message):
            png.decode(_with_header_byte(png.encode_rgb8(img), field, value))
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "PIL", None)
        with pytest.raises(gltf.GltfError, match="JPEG.*needs PIL"):
            gltf._rgb8(buf.getvalue())
    # With PIL the other formats still decode.
    assert gltf._rgb8(buf.getvalue()).shape == (23, 17, 3)


def test_render_with_material(colored_box):
    """Raymarch an SDF with cubemap albedo: +x-facing pixels pick up the
    red face; the image matches JAX's on the same distances."""
    import mesh_to_sdf_tpu as m
    from mesh_to_sdf_tpu.render import Camera as JCamera
    from mesh_to_sdf_tpu.render import render as jrender
    from mesh_to_sdf_tpu_torch.render import Camera, render
    from torch_port_helpers import port_grid

    v, f, colors = colored_box
    jgrid = m.Grid.from_bounding_box([-1.4] * 3, [1.4] * 3, [24] * 3)
    dist = np.array(m.generate_grid_sdf(
        v, m.Topology.triangle_list(f.reshape(-1)), jgrid,
        m.SignMethod.RAYCAST, strategy=m.Strategy.XLA, flat=False,
    ))
    grid = port_grid(jgrid)
    cm = generate_cubemap(v, f, colors, res=32, device="cpu")
    cams = [Camera.orbit(grid, azimuth_deg=az, elevation_deg=0.0,
                         width=48, height=48)
            for az in (0.0, 90.0, 180.0, 270.0)]
    cam = max(cams, key=lambda c: abs(c.eye[0]))
    img = render(torch.from_numpy(dist), grid, cam, material=cm,
                 shadows=False).numpy()
    assert img.shape == (48, 48, 3)
    hit = img.sum(-1) > 0.01
    mean = img[hit].mean(axis=0)
    if cam.eye[0] > 0:
        assert mean[0] > mean[2] + 0.1, mean
    else:
        assert mean[2] > mean[0] + 0.1, mean
    want = np.asarray(jrender(jnp.asarray(dist), jgrid,
                              JCamera(**cam.__dict__),
                              material=jcube.generate_cubemap(v, f, colors,
                                                              res=32),
                              shadows=False))
    jhit = want.sum(-1) > 0.01
    assert (hit == jhit).mean() >= 0.995
    both = hit & jhit
    assert (np.abs(img - want)[both].max(-1) <= 2.0 / 255.0).mean() >= 0.98


def test_cubemap_odd_resolution(colored_box):
    """res² not a multiple of TEXEL_CHUNK (res=100) pads and slices back."""
    v, f, colors = colored_box
    cm = generate_cubemap(v, f, colors, res=100, device="cpu")
    assert cm.albedo.shape == (6, 100, 100, 3)
    assert cm.albedo[1].mean(dim=(0, 1))[0] > 0.7
