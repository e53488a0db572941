"""Self-contained glTF 2.0 / GLB scene ingestion (no external gltf library).

Capability parity with the reference client's vendored loader
(`mesh_to_sdf_client/src/gltf/*`, itself a fork of easy-gltf): load a .glb or
.gltf file, walk the node hierarchy with world transforms
(`gltf/scene/mod.rs:31-75`), extract triangle meshes, and merge every instance
into one vertex/index soup the way the client feeds `generate_grid_sdf`
(`sdf_program.rs:607-620`).

GPU texture/material plumbing (K11) is out of scope for SDF generation — the
offline renderer consumes per-vertex data only. Unsupported-but-harmless glTF
features (materials, animations, skins) are ignored; malformed files raise
``GltfError`` (the reference surfaces these as UI alerts, `ui.rs:76-97`).
"""
from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


class GltfError(ValueError):
    """Raised on malformed or unsupported glTF containers."""


_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}

#: glTF primitive.mode values we can triangulate.
MODE_TRIANGLES = 4
MODE_TRIANGLE_STRIP = 5
MODE_TRIANGLE_FAN = 6


@dataclass
class MeshData:
    """One triangulated primitive in model space."""

    positions: np.ndarray  # (V, 3) float32
    indices: np.ndarray  # (M, 3) uint32
    normals: Optional[np.ndarray] = None  # (V, 3) float32 or None
    #: Per-vertex albedo (V, 3) float32 — the material's baseColorFactor,
    #: times the baseColorTexture sampled at each vertex's UV when
    #: ``load_scene(..., with_materials=True)``. None = no material loaded.
    colors: Optional[np.ndarray] = None
    name: str = ""


@dataclass
class SceneData:
    """A flattened scene: meshes + world-transformed instances."""

    meshes: List[MeshData] = field(default_factory=list)
    #: (mesh_index, world_transform 4x4) per instance.
    instances: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    def merge(self) -> Tuple[np.ndarray, np.ndarray]:
        """Merge all instances into one world-space vertex/index soup —
        the client's model-merging step (`sdf_program.rs:607-620`)."""
        verts: List[np.ndarray] = []
        faces: List[np.ndarray] = []
        offset = 0
        for mesh_idx, world in self.instances:
            mesh = self.meshes[mesh_idx]
            v = mesh.positions
            vh = np.concatenate([v, np.ones((len(v), 1), np.float32)], axis=1)
            vw = (vh @ world.T)[:, :3].astype(np.float32)
            verts.append(vw)
            faces.append(mesh.indices.astype(np.uint32) + offset)
            offset += len(v)
        if not verts:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint32)
        return np.concatenate(verts), np.concatenate(faces)

    def merge_colors(self) -> np.ndarray:
        """Per-vertex albedo aligned with :meth:`merge`'s vertex order.

        Instances without material data get the client's grey-albedo
        fallback (`pbr/model.rs:54-60`).
        """
        cols: List[np.ndarray] = []
        for mesh_idx, _ in self.instances:
            mesh = self.meshes[mesh_idx]
            if mesh.colors is not None:
                cols.append(np.asarray(mesh.colors, np.float32))
            else:
                cols.append(
                    np.full((len(mesh.positions), 3), 0.6, np.float32)
                )
        if not cols:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(cols)

    def bounding_box(self) -> Tuple[np.ndarray, np.ndarray]:
        v, _ = self.merge()
        if len(v) == 0:
            raise GltfError("empty scene has no bounding box")
        return v.min(axis=0), v.max(axis=0)


# ----------------------------------------------------------------- container
def _parse_glb(data: bytes) -> Tuple[dict, Optional[bytes]]:
    """Split a .glb into (gltf json, binary chunk) (GLB 2.0 container spec)."""
    if len(data) < 12:
        raise GltfError("GLB too short")
    magic, version, length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise GltfError("bad GLB magic")
    if version != 2:
        raise GltfError(f"unsupported GLB version {version}")
    offset = 12
    gltf_json = None
    binary = None
    while offset + 8 <= min(length, len(data)):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        if len(chunk) < chunk_len:
            raise GltfError("truncated GLB chunk")
        if chunk_type == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # 'BIN'
            binary = bytes(chunk)
        offset += chunk_len
    if gltf_json is None:
        raise GltfError("GLB missing JSON chunk")
    return gltf_json, binary


def _load_buffers(gltf: dict, bin_chunk: Optional[bytes], base_dir: Path):
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise GltfError("buffer without uri and no GLB BIN chunk")
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            try:
                b64 = uri.split(",", 1)[1]
            except IndexError as e:
                raise GltfError("malformed data uri") from e
            buffers.append(base64.b64decode(b64))
        else:
            p = base_dir / uri
            if not p.exists():
                raise GltfError(f"external buffer not found: {uri}")
            buffers.append(p.read_bytes())
        if len(buffers[-1]) < buf.get("byteLength", 0):
            raise GltfError("buffer shorter than declared byteLength")
    return buffers


def _read_accessor(gltf: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    try:
        acc = gltf["accessors"][idx]
    except (KeyError, IndexError) as e:
        raise GltfError(f"missing accessor {idx}") from e
    if "sparse" in acc:
        raise GltfError("sparse accessors not supported")
    count = acc["count"]
    ncomp = _TYPE_COUNTS[acc["type"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    if "bufferView" not in acc:
        return np.zeros((count, ncomp), dtype)
    view = gltf["bufferViews"][acc["bufferView"]]
    buf = buffers[view["buffer"]]
    base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype.itemsize * ncomp
    item_bytes = dtype.itemsize * ncomp
    if base + (count - 1) * stride + item_bytes > len(buf):
        raise GltfError(f"accessor {idx} overruns its buffer")
    if stride == item_bytes:
        arr = np.frombuffer(buf, dtype, count * ncomp, base).reshape(count, ncomp)
    else:
        raw = np.frombuffer(
            buf, np.uint8, (count - 1) * stride + item_bytes, base
        )
        strided = np.lib.stride_tricks.as_strided(
            raw, shape=(count, item_bytes), strides=(stride, 1), writeable=False
        )
        arr = strided.reshape(-1).view(dtype).reshape(count, ncomp)
    return np.array(arr)  # own the memory


def _node_matrix(node: dict) -> np.ndarray:
    """Local transform: explicit matrix or TRS composition (glTF spec order
    M = T * R * S — same math as the reference scene graph)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    s = node.get("scale")
    r = node.get("rotation")
    t = node.get("translation")
    if s is not None:
        m = m @ np.diag([s[0], s[1], s[2], 1.0]).astype(np.float32)
    if r is not None:
        x, y, z, w = r
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )
        m = rot @ m
    if t is not None:
        trans = np.eye(4, dtype=np.float32)
        trans[:3, 3] = t
        m = trans @ m
    return m


def _triangulate(indices: np.ndarray, mode: int) -> np.ndarray:
    idx = indices.reshape(-1).astype(np.uint32)
    if mode == MODE_TRIANGLES:
        m = (idx.size // 3) * 3
        return idx[:m].reshape(-1, 3)
    if mode == MODE_TRIANGLE_STRIP:
        if idx.size < 3:
            return np.zeros((0, 3), np.uint32)
        a, b, c = idx[:-2].copy(), idx[1:-1].copy(), idx[2:]
        # glTF strips alternate winding; flip odd triangles.
        odd = np.arange(a.size) % 2 == 1
        a[odd], b[odd] = b[odd], a[odd]
        return np.stack([a, b, c], axis=-1)
    if mode == MODE_TRIANGLE_FAN:
        if idx.size < 3:
            return np.zeros((0, 3), np.uint32)
        return np.stack(
            [np.full(idx.size - 2, idx[0], np.uint32), idx[1:-1], idx[2:]],
            axis=-1,
        )
    raise GltfError(f"unsupported primitive mode {mode}")


# ----------------------------------------------------------------- materials
def _image_bytes(gltf: dict, buffers, img: dict, base_dir: Path) -> bytes:
    if "bufferView" in img:
        bv = gltf["bufferViews"][img["bufferView"]]
        buf = buffers[bv.get("buffer", 0)]
        off = bv.get("byteOffset", 0)
        return bytes(buf[off : off + bv["byteLength"]])
    uri = img.get("uri", "")
    if uri.startswith("data:"):
        import base64

        return base64.b64decode(uri.split(",", 1)[1])
    p = base_dir / uri
    if not p.exists():
        raise GltfError(f"image not found: {uri}")
    return p.read_bytes()


def _rgb8(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an encoded image: 8-bit PNGs by ``png``
    (alpha dropped, grey replicated, as PIL's ``convert("RGB")``); any
    other format through PIL, and without PIL a ``GltfError`` naming it."""
    from . import png

    if data.startswith(png.SIGNATURE):
        try:
            pixels = png.decode(data)
        except png.PngError as e:
            fmt = f"PNG ({e})"
        else:
            if pixels.shape[2] < 3:  # grey, grey + alpha
                return np.repeat(pixels[..., :1], 3, axis=2)
            return np.ascontiguousarray(pixels[..., :3])
    elif data.startswith(b"\xff\xd8"):
        fmt = "JPEG"
    else:
        fmt = f"unknown image format (first bytes {data[:8]!r})"
    try:
        import io as _io

        from PIL import Image
    except ImportError as e:
        raise GltfError(f"texture is {fmt}: decoding it needs PIL, which "
                        "is not installed") from e
    return np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"))


def _decode_image(gltf, buffers, img_idx: int, base_dir: Path, cache: dict):
    """Decode an image to linear-RGB float32 (H, W, 3). Cached per index."""
    if img_idx in cache:
        return cache[img_idx]
    data = _image_bytes(gltf, buffers, gltf["images"][img_idx], base_dir)
    srgb = np.asarray(_rgb8(data), np.float32) / 255.0
    linear = srgb**2.2  # sRGB decode (the GPU sampler does this in hardware)
    cache[img_idx] = linear
    return linear


def _sample_texture(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear sample with REPEAT wrap. img (H, W, 3); uv (V, 2) → (V, 3)."""
    h, w = img.shape[:2]
    x = (uv[:, 0] % 1.0) * w - 0.5
    y = (uv[:, 1] % 1.0) * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0 %= w
    y0 %= h
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h
    c00 = img[y0, x0]
    c10 = img[y0, x1]
    c01 = img[y1, x0]
    c11 = img[y1, x1]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    ).astype(np.float32)


def _primitive_colors(gltf, buffers, prim, attrs, n_verts: int,
                      base_dir: Path, img_cache: dict) -> np.ndarray:
    """Per-vertex linear albedo for one primitive: baseColorFactor ×
    baseColorTexture sampled at the vertex UVs (`pbr/model.rs:23-90`
    semantics, vertex-resolution approximation of the texture)."""
    factor = np.ones(3, np.float32)
    tex = None
    mat_idx = prim.get("material")
    if mat_idx is not None and mat_idx < len(gltf.get("materials", [])):
        pbr = gltf["materials"][mat_idx].get("pbrMetallicRoughness", {})
        factor = np.asarray(
            pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])[:3], np.float32
        )
        tex_info = pbr.get("baseColorTexture")
        if tex_info is not None:
            texture = gltf.get("textures", [])[tex_info["index"]]
            src = texture.get("source")
            uv_attr = f"TEXCOORD_{tex_info.get('texCoord', 0)}"
            if src is not None and uv_attr in attrs:
                img = _decode_image(gltf, buffers, src, base_dir, img_cache)
                uv = _read_accessor(gltf, buffers, attrs[uv_attr]).astype(
                    np.float32
                )
                tex = _sample_texture(img, uv[:, :2])
    colors = np.broadcast_to(factor, (n_verts, 3)).copy()
    if tex is not None:
        colors *= tex
    return colors.astype(np.float32)


# --------------------------------------------------------------------- public
def load_scene(path, *, with_materials: bool = False) -> SceneData:
    """Load a .glb/.gltf file into a flattened :class:`SceneData`.

    The analog of `gltf::load_scene` (`gltf/mod.rs:56-103`): every mesh
    primitive becomes a :class:`MeshData`; every node referencing a mesh
    becomes an instance with its world transform. ``with_materials=True``
    additionally resolves each primitive's base color (factor × texture
    sampled at the vertex UVs) into per-vertex albedo — the ingestion half
    of the client's cubemap material projection (`cubemap.rs:160-311`).
    """
    path = Path(path)
    if not path.exists():
        raise GltfError(f"no such file: {path}")
    raw = path.read_bytes()
    if raw[:4] == b"glTF":
        gltf, bin_chunk = _parse_glb(raw)
    else:
        try:
            gltf = json.loads(raw)
        except json.JSONDecodeError as e:
            raise GltfError(f"not a GLB or glTF file: {e}") from e
        bin_chunk = None
    buffers = _load_buffers(gltf, bin_chunk, path.parent)

    scene = SceneData()
    prim_map: Dict[Tuple[int, int], int] = {}  # (mesh, prim) -> MeshData idx
    img_cache: Dict[int, np.ndarray] = {}

    for mi, mesh in enumerate(gltf.get("meshes", [])):
        for pi, prim in enumerate(mesh.get("primitives", [])):
            mode = prim.get("mode", MODE_TRIANGLES)
            if mode not in (MODE_TRIANGLES, MODE_TRIANGLE_STRIP, MODE_TRIANGLE_FAN):
                continue  # points/lines contribute nothing to an SDF
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(
                np.float32
            )
            if pos.shape[1] != 3:
                raise GltfError("POSITION accessor is not VEC3")
            if "indices" in prim:
                idx = _read_accessor(gltf, buffers, prim["indices"])
            else:
                idx = np.arange(len(pos), dtype=np.uint32).reshape(-1, 1)
            tris = _triangulate(idx, mode)
            if tris.size and tris.max() >= len(pos):
                raise GltfError("index out of range")
            normals = None
            if "NORMAL" in attrs:
                normals = _read_accessor(gltf, buffers, attrs["NORMAL"]).astype(
                    np.float32
                )
            colors = None
            if with_materials:
                colors = _primitive_colors(
                    gltf, buffers, prim, attrs, len(pos), path.parent,
                    img_cache,
                )
            prim_map[(mi, pi)] = len(scene.meshes)
            scene.meshes.append(
                MeshData(
                    positions=pos,
                    indices=tris,
                    normals=normals,
                    colors=colors,
                    name=mesh.get("name", f"mesh{mi}p{pi}"),
                )
            )

    nodes = gltf.get("nodes", [])

    def walk(node_idx: int, parent: np.ndarray, seen: frozenset):
        if node_idx in seen:
            raise GltfError("node cycle detected")
        node = nodes[node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            mi = node["mesh"]
            for (m, p), data_idx in prim_map.items():
                if m == mi:
                    scene.instances.append((data_idx, world))
        for child in node.get("children", []):
            walk(child, world, seen | {node_idx})

    scenes = gltf.get("scenes", [])
    scene_idx = gltf.get("scene", 0 if scenes else None)
    roots: List[int] = []
    if scene_idx is not None and scene_idx < len(scenes):
        roots = scenes[scene_idx].get("nodes", [])
    elif nodes:
        # No scene: treat all un-parented nodes as roots.
        children = {c for n in nodes for c in n.get("children", [])}
        roots = [i for i in range(len(nodes)) if i not in children]
    for r in roots:
        walk(r, np.eye(4, dtype=np.float32), frozenset())

    # Meshes never referenced by a node still count once (matches easy-gltf's
    # behavior of surfacing every model).
    if not scene.instances and scene.meshes:
        for i in range(len(scene.meshes)):
            scene.instances.append((i, np.eye(4, dtype=np.float32)))
    return scene


def load_mesh(path) -> Tuple[np.ndarray, np.ndarray]:
    """Convenience: load + merge into (vertices (V,3) f32, faces (M,3) u32)."""
    return load_scene(path).merge()


# ------------------------------------------------------------------- writing
def save_glb(path, vertices: np.ndarray, faces: np.ndarray, name="mesh") -> None:
    """Write a minimal valid .glb (positions + u32 indices).

    Used for tests/fixtures and as the inverse of :func:`load_mesh` (the
    reference ships .glb assets; we generate ours procedurally).
    """
    v = np.ascontiguousarray(np.asarray(vertices, np.float32).reshape(-1, 3))
    f = np.ascontiguousarray(np.asarray(faces, np.uint32).reshape(-1, 3))
    vbytes = v.tobytes()
    fbytes = f.tobytes()
    pad_v = (-len(vbytes)) % 4
    bin_chunk = vbytes + b"\x00" * pad_v + fbytes
    gltf = {
        "asset": {"version": "2.0", "generator": "mesh_to_sdf_tpu"},
        "buffers": [{"byteLength": len(bin_chunk)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(vbytes)},
            {
                "buffer": 0,
                "byteOffset": len(vbytes) + pad_v,
                "byteLength": len(fbytes),
            },
        ],
        "accessors": [
            {
                "bufferView": 0,
                "componentType": 5126,
                "count": len(v),
                "type": "VEC3",
                "min": v.min(axis=0).tolist() if len(v) else [0, 0, 0],
                "max": v.max(axis=0).tolist() if len(v) else [0, 0, 0],
            },
            {
                "bufferView": 1,
                "componentType": 5125,
                "count": f.size,
                "type": "SCALAR",
            },
        ],
        "meshes": [
            {
                "name": name,
                "primitives": [
                    {"attributes": {"POSITION": 0}, "indices": 1, "mode": 4}
                ],
            }
        ],
        "nodes": [{"mesh": 0, "name": name}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    jbytes = json.dumps(gltf, separators=(",", ":")).encode()
    jbytes += b" " * ((-len(jbytes)) % 4)
    bin_padded = bin_chunk + b"\x00" * ((-len(bin_chunk)) % 4)
    total = 12 + 8 + len(jbytes) + 8 + len(bin_padded)
    out = bytearray()
    out += struct.pack("<III", 0x46546C67, 2, total)
    out += struct.pack("<II", len(jbytes), 0x4E4F534A) + jbytes
    out += struct.pack("<II", len(bin_padded), 0x004E4942) + bin_padded
    Path(path).write_bytes(bytes(out))
